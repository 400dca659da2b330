// crowdmod native runtime: host-side data-path functions of the PyTorch
// port (a copy of the JAX package's runtime; the port imports nothing of
// that package).
//
// The reference framework's data path is single-threaded Python/numpy.
// The hot host-side transforms live here:
//
//   * layout transpose  (N,C,H,W,L) -> (N,L,H,W,C)   [reference pickle layout
//     -> framework time-major/channels-last layout], threaded over N
//   * window gather     raw (N,L,H,W,C) + (seq,t0) index list -> packed
//     (B,window,H,W,C) batches, threaded over windows
//   * trajectory binning: pedestrian (x,y,vx,vy,|v|) lists -> (rows,cols,4)
//     macroprop grids (rho, mu_vx, mu_vy, sigma2_v), threaded over frames
//   * .cmb tensor IO: header + raw float32 payload, a pickle-free binary
//     cache format, the same bytes the JAX package reads and writes
//
// Exposed as a C ABI for ctypes (crowdmod_tpu_torch/native/__init__.py);
// built by crowdmod_tpu_torch/native/build.py with g++ -O3 -shared.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// Run fn(begin, end) over [0, total) split across worker threads.
template <typename Fn>
void parallel_for(int64_t total, Fn fn) {
  int nthreads = std::min<int64_t>(hardware_threads(), total);
  if (nthreads <= 1) {
    fn(0, total);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  int64_t chunk = (total + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = std::min<int64_t>(begin + chunk, total);
    if (begin >= end) break;
    pool.emplace_back([=] { fn(begin, end); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Layout transpose: (N, C, H, W, L) -> (N, L, H, W, C)
// ---------------------------------------------------------------------------
void cm_transpose_nchwl_to_nlhwc(const float* src, float* dst, int64_t n,
                                 int64_t c, int64_t h, int64_t w, int64_t l) {
  const int64_t src_n = c * h * w * l;
  const int64_t dst_n = l * h * w * c;
  parallel_for(n, [=](int64_t n0, int64_t n1) {
    for (int64_t in = n0; in < n1; ++in) {
      const float* s = src + in * src_n;
      float* d = dst + in * dst_n;
      for (int64_t ic = 0; ic < c; ++ic)
        for (int64_t ih = 0; ih < h; ++ih)
          for (int64_t iw = 0; iw < w; ++iw) {
            const float* sp = s + ((ic * h + ih) * w + iw) * l;
            float* dp = d + ((ih * w + iw) * c + ic);
            for (int64_t il = 0; il < l; ++il)
              dp[il * h * w * c] = sp[il];
          }
    }
  });
}

// ---------------------------------------------------------------------------
// Window gather: raw (N, L, H, W, C), windows given by (seq[i], t0[i]).
// out is (nw, window, H, W, C); one memcpy per (window-frame) row.
// ---------------------------------------------------------------------------
void cm_gather_windows(const float* raw, int64_t n, int64_t l, int64_t h,
                       int64_t w, int64_t c, const int64_t* seq,
                       const int64_t* t0, int64_t nw, int64_t window,
                       float* out) {
  (void)n;
  const int64_t frame = h * w * c;
  const int64_t seq_stride = l * frame;
  const int64_t win_stride = window * frame;
  parallel_for(nw, [=](int64_t b0, int64_t b1) {
    for (int64_t b = b0; b < b1; ++b) {
      const float* src = raw + seq[b] * seq_stride + t0[b] * frame;
      float* dst = out + b * win_stride;
      std::memcpy(dst, src, sizeof(float) * window * frame);
    }
  });
}

// ---------------------------------------------------------------------------
// Macroprop binning.  Per frame f, pedestrians are rows
// [offsets[f], offsets[f+1]) of the flat (x, y, vx, vy, vnorm) arrays.
// out is (n_frames, rows, cols, 4) = (rho, mu_vx, mu_vy, sigma2_v).
// Mirrors the ETL's bin_frame (crowdmod_tpu_torch/data/etl.py):
// i = |floor((y - (lu_y - 1)) / dy)|, j = floor((x - lu_x) / dx),
// mu = sum / (rho + eps), sigma2 = sum((|v| - E|v|)^2) / (rho + eps).
// ---------------------------------------------------------------------------
void cm_bin_frames(const double* x, const double* y, const double* vx,
                   const double* vy, const double* vnorm,
                   const int64_t* offsets, int64_t n_frames, int64_t rows,
                   int64_t cols, double dx, double dy, double lu_x,
                   double lu_y, double eps, float* out) {
  const int64_t cells = rows * cols;
  parallel_for(n_frames, [=](int64_t f0, int64_t f1) {
    std::vector<double> rho(cells), svx(cells), svy(cells), svn(cells),
        sdev(cells);
    std::vector<int32_t> cell_of;
    for (int64_t f = f0; f < f1; ++f) {
      std::fill(rho.begin(), rho.end(), 0.0);
      std::fill(svx.begin(), svx.end(), 0.0);
      std::fill(svy.begin(), svy.end(), 0.0);
      std::fill(svn.begin(), svn.end(), 0.0);
      std::fill(sdev.begin(), sdev.end(), 0.0);
      const int64_t p0 = offsets[f], p1 = offsets[f + 1];
      cell_of.assign(p1 - p0, -1);
      for (int64_t p = p0; p < p1; ++p) {
        double di = std::fabs(std::floor((y[p] - (lu_y - 1.0)) / dy));
        double dj = std::floor((x[p] - lu_x) / dx);
        int64_t i = static_cast<int64_t>(di);
        int64_t j = static_cast<int64_t>(dj);
        if (di < 0 || i >= rows || dj < 0 || j >= cols) continue;
        int64_t cell = i * cols + j;
        cell_of[p - p0] = static_cast<int32_t>(cell);
        rho[cell] += 1.0;
        svx[cell] += vx[p];
        svy[cell] += vy[p];
        svn[cell] += vnorm[p];
      }
      // Second pass: squared deviations of |v| from the cell mean.
      for (int64_t p = p0; p < p1; ++p) {
        int32_t cell = cell_of[p - p0];
        if (cell < 0) continue;
        double mean_vn = svn[cell] / (rho[cell] + eps);
        double d = vnorm[p] - mean_vn;
        sdev[cell] += d * d;
      }
      float* o = out + f * cells * 4;
      for (int64_t cidx = 0; cidx < cells; ++cidx) {
        double denom = rho[cidx] + eps;
        o[cidx * 4 + 0] = static_cast<float>(rho[cidx]);
        o[cidx * 4 + 1] = static_cast<float>(svx[cidx] / denom);
        o[cidx * 4 + 2] = static_cast<float>(svy[cidx] / denom);
        o[cidx * 4 + 3] = static_cast<float>(sdev[cidx] / denom);
      }
    }
  });
}

// ---------------------------------------------------------------------------
// .cmb binary tensor IO.
// Layout: magic "CMB1" | int32 ndim | int64 shape[ndim] | float32 payload.
// ---------------------------------------------------------------------------
int cm_write_tensor(const char* path, const float* data, const int64_t* shape,
                    int32_t ndim) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return -1;
  int64_t total = 1;
  for (int32_t i = 0; i < ndim; ++i) total *= shape[i];
  int ok = std::fwrite("CMB1", 1, 4, fp) == 4 &&
           std::fwrite(&ndim, sizeof(int32_t), 1, fp) == 1 &&
           std::fwrite(shape, sizeof(int64_t), ndim, fp) ==
               static_cast<size_t>(ndim) &&
           std::fwrite(data, sizeof(float), total, fp) ==
               static_cast<size_t>(total);
  std::fclose(fp);
  return ok ? 0 : -2;
}

// Reads the header; returns ndim or negative error. shape_out must hold >= 8.
int cm_tensor_ndim(const char* path, int64_t* shape_out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  char magic[4];
  int32_t ndim = 0;
  if (std::fread(magic, 1, 4, fp) != 4 || std::memcmp(magic, "CMB1", 4) != 0 ||
      std::fread(&ndim, sizeof(int32_t), 1, fp) != 1 || ndim <= 0 ||
      ndim > 8 ||
      std::fread(shape_out, sizeof(int64_t), ndim, fp) !=
          static_cast<size_t>(ndim)) {
    std::fclose(fp);
    return -2;
  }
  std::fclose(fp);
  return ndim;
}

int cm_read_tensor(const char* path, float* out, int64_t total) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  char magic[4];
  int32_t ndim = 0;
  int64_t shape[8];
  if (std::fread(magic, 1, 4, fp) != 4 ||
      std::fread(&ndim, sizeof(int32_t), 1, fp) != 1 || ndim <= 0 ||
      ndim > 8 ||
      std::fread(shape, sizeof(int64_t), ndim, fp) !=
          static_cast<size_t>(ndim)) {
    std::fclose(fp);
    return -2;
  }
  size_t got = std::fread(out, sizeof(float), total, fp);
  std::fclose(fp);
  return got == static_cast<size_t>(total) ? 0 : -3;
}

}  // extern "C"
