// Standalone sanitizer harness for the port's native runtime.
//
// Exercises every C-ABI entry point of crowdmod_native.cpp in a bare
// process, so `-fsanitize=thread` and `-fsanitize=address,undefined` see
// only this code (inside a Python process the sanitizers' interceptors meet
// the interpreter's and its extensions' uninstrumented code).  Driven by
// crowdmod_tpu_torch/native/sanitize.py.
//
// Checks are lightweight correctness oracles (the bit-level parity oracles
// live in the port's native tests against the numpy twins); the point here
// is to push every threaded loop and every file-IO error path under the
// sanitizers.

#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <random>
#include <vector>

extern "C" {
void cm_transpose_nchwl_to_nlhwc(const float*, float*, int64_t, int64_t,
                                 int64_t, int64_t, int64_t);
void cm_gather_windows(const float*, int64_t, int64_t, int64_t, int64_t,
                       int64_t, const int64_t*, const int64_t*, int64_t,
                       int64_t, float*);
void cm_bin_frames(const double*, const double*, const double*, const double*,
                   const double*, const int64_t*, int64_t, int64_t, int64_t,
                   double, double, double, double, double, float*);
int cm_write_tensor(const char*, const float*, const int64_t*, int32_t);
int cm_tensor_ndim(const char*, int64_t*);
int cm_read_tensor(const char*, float*, int64_t);
}

namespace {

std::mt19937 rng(1234);

void check(bool ok, const char* what) {
  if (!ok) {
    std::fprintf(stderr, "FAIL: %s\n", what);
    std::exit(1);
  }
}

void test_transpose(int64_t n, int64_t c, int64_t h, int64_t w, int64_t l) {
  std::vector<float> src(n * c * h * w * l), dst(src.size(), -1.0f);
  for (size_t i = 0; i < src.size(); ++i) src[i] = static_cast<float>(i % 997);
  cm_transpose_nchwl_to_nlhwc(src.data(), dst.data(), n, c, h, w, l);
  // Spot-check a handful of elements against the index formula.
  std::uniform_int_distribution<int64_t> dn(0, n - 1), dc(0, c - 1),
      dh(0, h - 1), dw(0, w - 1), dl(0, l - 1);
  for (int k = 0; k < 64; ++k) {
    int64_t in = dn(rng), ic = dc(rng), ih = dh(rng), iw = dw(rng),
            il = dl(rng);
    float s = src[(((in * c + ic) * h + ih) * w + iw) * l + il];
    float d = dst[(((in * l + il) * h + ih) * w + iw) * c + ic];
    check(s == d, "transpose element mismatch");
  }
}

void test_gather(int64_t n, int64_t l, int64_t h, int64_t w, int64_t c,
                 int64_t nw, int64_t window) {
  std::vector<float> raw(n * l * h * w * c);
  for (size_t i = 0; i < raw.size(); ++i) raw[i] = static_cast<float>(i % 613);
  std::vector<int64_t> seq(nw), t0(nw);
  std::uniform_int_distribution<int64_t> ds(0, n - 1), dt(0, l - window);
  for (int64_t i = 0; i < nw; ++i) {
    seq[i] = ds(rng);
    t0[i] = dt(rng);
  }
  std::vector<float> out(nw * window * h * w * c, -1.0f);
  cm_gather_windows(raw.data(), n, l, h, w, c, seq.data(), t0.data(), nw,
                    window, out.data());
  int64_t frame = h * w * c;
  for (int64_t b = 0; b < nw; b += std::max<int64_t>(1, nw / 7)) {
    const float* src = raw.data() + seq[b] * l * frame + t0[b] * frame;
    check(std::memcmp(src, out.data() + b * window * frame,
                      sizeof(float) * window * frame) == 0,
          "gather window mismatch");
  }
}

void test_bin_frames(int64_t n_frames, int64_t rows, int64_t cols,
                     int64_t max_peds) {
  std::vector<int64_t> offsets(n_frames + 1, 0);
  std::uniform_int_distribution<int64_t> dp(0, max_peds);
  for (int64_t f = 0; f < n_frames; ++f)
    offsets[f + 1] = offsets[f] + dp(rng);  // some frames empty
  int64_t total = offsets[n_frames];
  std::vector<double> x(total), y(total), vx(total), vy(total), vn(total);
  const double dxy = 1.0, lu_x = 0.0, lu_y = rows - 1.0;
  // ~10% of points land outside the grid to hit the skip branch.
  std::uniform_real_distribution<double> px(-2.0, cols + 2.0),
      py(-2.0, rows + 2.0), pv(-1.5, 1.5);
  for (int64_t p = 0; p < total; ++p) {
    x[p] = px(rng);
    y[p] = py(rng);
    vx[p] = pv(rng);
    vy[p] = pv(rng);
    vn[p] = std::hypot(vx[p], vy[p]);
  }
  std::vector<float> out(n_frames * rows * cols * 4, -1.0f);
  cm_bin_frames(x.data(), y.data(), vx.data(), vy.data(), vn.data(),
                offsets.data(), n_frames, rows, cols, dxy, dxy, lu_x, lu_y,
                1e-6, out.data());
  // Mass conservation: sum of rho == number of in-grid pedestrians.
  double mass = 0.0;
  for (int64_t i = 0; i < n_frames * rows * cols; ++i) mass += out[i * 4];
  int64_t in_grid = 0;
  for (int64_t p = 0; p < total; ++p) {
    double di = std::fabs(std::floor((y[p] - (lu_y - 1.0)) / dxy));
    double dj = std::floor((x[p] - lu_x) / dxy);
    if (!(di < 0) && static_cast<int64_t>(di) < rows && !(dj < 0) &&
        static_cast<int64_t>(dj) < cols)
      ++in_grid;
  }
  check(std::llround(mass) == in_grid, "binning mass conservation");
}

void test_tensor_io(const char* dir) {
  char path[512];
  std::snprintf(path, sizeof(path), "%s/harness.cmb", dir);
  int64_t shape[3] = {7, 5, 3};
  std::vector<float> data(7 * 5 * 3);
  for (size_t i = 0; i < data.size(); ++i) data[i] = 0.5f * i;
  check(cm_write_tensor(path, data.data(), shape, 3) == 0, "write rc");
  int64_t shape_out[8];
  check(cm_tensor_ndim(path, shape_out) == 3, "ndim rc");
  check(shape_out[0] == 7 && shape_out[1] == 5 && shape_out[2] == 3,
        "shape roundtrip");
  std::vector<float> back(data.size(), -1.0f);
  check(cm_read_tensor(path, back.data(), data.size()) == 0, "read rc");
  check(std::memcmp(data.data(), back.data(),
                    sizeof(float) * data.size()) == 0,
        "payload roundtrip");
  // Error paths: missing file, bad magic, truncated header/payload.
  check(cm_tensor_ndim("/nonexistent/x.cmb", shape_out) == -1, "missing file");
  check(cm_read_tensor("/nonexistent/x.cmb", back.data(), 1) == -1,
        "missing file read");
  char bad[512];
  std::snprintf(bad, sizeof(bad), "%s/bad.cmb", dir);
  FILE* fp = std::fopen(bad, "wb");
  std::fwrite("NOPE", 1, 4, fp);
  std::fclose(fp);
  check(cm_tensor_ndim(bad, shape_out) == -2, "bad magic");
  fp = std::fopen(bad, "wb");  // valid magic, ndim out of range
  int32_t ndim = 99;
  std::fwrite("CMB1", 1, 4, fp);
  std::fwrite(&ndim, sizeof(ndim), 1, fp);
  std::fclose(fp);
  check(cm_tensor_ndim(bad, shape_out) == -2, "ndim range");
  check(cm_read_tensor(path, back.data(),
                       static_cast<int64_t>(data.size()) + 10) == -3,
        "short payload");
}

}  // namespace

int main(int argc, char** argv) {
  const char* dir = argc > 1 ? argv[1] : "/tmp";
  int reps = argc > 2 ? std::atoi(argv[2]) : 3;
  for (int r = 0; r < reps; ++r) {
    // Threaded paths at sizes above and below the thread count, plus the
    // single-item (serial) fallback.
    test_transpose(64, 4, 12, 36, 25);
    test_transpose(1, 3, 5, 7, 2);
    test_gather(8, 70, 12, 36, 3, 256, 8);
    test_gather(2, 9, 4, 4, 1, 1, 9);
    test_bin_frames(200, 12, 36, 120);
    test_bin_frames(1, 3, 3, 0);  // all-empty frame
    test_tensor_io(dir);
  }
  std::puts("sanitize_harness OK");
  return 0;
}
