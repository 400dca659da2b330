// One whole UNet ResnetBlock3D forward (inference) for Hopper (sm_90a),
// channels-last (B, T, H, W, C):
//     h1  = conv1(silu(GN1(x))) + b1 + temb_proj          (f32, never rounded)
//     out = conv2(silu(GN2(h1))) + b2 + skip(x)            (input type)
// with GN over G groups (f32 moments, biased variance), 3x3x3 SAME convs,
// skip(x) = x when Cin == Cout and the 1x1 projection x @ Ws + b_skip
// otherwise.
//
// Replaces the TPU kernel crowdmod_tpu/ops/pallas/resblock.py
// (_fused_pallas, kernel _resblock_kernel).
//
// What bounds it on the H100: operations.  At the level-0 blocks of the
// UNet (8 x 12 x 36 volume, Cin in {32, 64, 96}, Cout = 32) the two convs
// do 27 * (Cin + Cout) * Cout * 2 flops a position against about
// (Cin + Cout) * 2 bytes in and out (bf16): hundreds of flops a byte.  The
// convs multiply on the CUDA cores in f32 here (common.cuh), far from the
// bf16 tensor-core bound; what the fusion saves is bytes and launches: the
// normalised activations never reach device memory.
//
// The TPU kernel holds a whole sample in VMEM.  Here it cannot: one
// level-0 sample with Cin = 96 is 1.3 MB as f32 and the 32-channel
// intermediate 442 KB, against 227 KB of shared memory a block; and GN2
// needs all of conv1's output of a sample before any of conv2 can start.
// So one call is three ordinary launches on one stream:
//   1. GN1 moments: a block per (sample, group), two passes (mean, then
//      squared deviations), as the GroupNorm kernel; it also zeroes GN2's
//      sums.
//   2. conv1 as an implicit GEMM (common.cuh) whose loader applies GN1 +
//      SiLU to each input element as the patch tile is staged, SAME zero
//      padding applied after the activation; the epilogue adds b1 + temb,
//      stores h1 as f32, and adds each tile's per-(sample, group) sum and
//      sum of squares into GN2's sums (a shuffle across the half-warps of
//      equal columns, shared-memory atomics, then one global atomic per
//      (sample, group, moment) a block).  GN2's variance is
//      E[h^2] - E[h]^2 from those sums, as the TPU kernel's; the atomics
//      make the summation order vary from run to run at f32 rounding level.
//   3. conv2 the same way with GN2 + SiLU on load, the 1x1 skip folded in
//      as Cin extra K rows (raw x at the centre tap times Ws) so it is part
//      of the same GEMM, and b2 (+ b_skip) and the identity skip added in
//      the epilogue.
// A block's 128 output positions may span two samples, never more: the
// volume must be at least 128 positions (the UNet routes only volumes of
// 1024 and more here).
//
// Interface: plain C, loaded with ctypes; launches on the given stream and
// returns cudaGetLastError() after each launch.

#include "common.cuh"

namespace crowdmod {
namespace {

constexpr int kMaxGroups = 32;

// GN + SiLU of the input under tap k, zero outside the volume.  stats holds
// (mean, rstd) per (sample, group).
template <typename T>
struct GnSiluLoad {
  const T* x;
  Geom g;
  int cin, cg, groups;
  const float* stats;
  const float* gamma;
  const float* beta;
  struct State {
    Tap tap;
    float ga, be;
    int grp;
  };
  __device__ State state(int k) const {
    const Tap t = split_k(k, cin);
    return State{t, gamma[t.c], beta[t.c], t.c / cg};
  }
  __device__ float operator()(const int4& r, const State& s) const {
    const long long p = tap_offset(r, s.tap.dt, s.tap.dh, s.tap.dw, g);
    if (p < 0) return 0.f;
    const float v = to_f(x[p * cin + s.tap.c]);
    const float2 st = *reinterpret_cast<const float2*>(stats + 2 * (r.x * groups + s.grp));
    return silu((v - st.x) * st.y * s.ga + s.be);
  }
};

// K rows [0, 27*c2): GN2 + SiLU of h1 under the tap, from GN2's sums.
// K rows [27*c2, 27*c2 + cin): the raw input at the centre (the 1x1 skip).
template <typename T>
struct Gn2SkipLoad {
  const float* h1;
  const T* x;
  Geom g;
  int c2, cin, cg, groups;
  const float* sums;
  const float* gamma;
  const float* beta;
  float inv_n, eps;
  struct State {
    Tap tap;
    float ga, be;
    int grp;
    bool skip;
  };
  __device__ State state(int k) const {
    if (k >= 27 * c2) return State{Tap{0, 0, 0, k - 27 * c2}, 0.f, 0.f, 0, true};
    const Tap t = split_k(k, c2);
    return State{t, gamma[t.c], beta[t.c], t.c / cg, false};
  }
  __device__ float operator()(const int4& r, const State& s) const {
    const long long p = tap_offset(r, s.tap.dt, s.tap.dh, s.tap.dw, g);
    if (p < 0) return 0.f;
    if (s.skip) return to_f(x[p * cin + s.tap.c]);
    const float2 q = *reinterpret_cast<const float2*>(sums + 2 * (r.x * groups + s.grp));
    const float mean = q.x * inv_n;
    const float rstd = rsqrtf(fmaxf(q.y * inv_n - mean * mean, 0.f) + eps);
    return silu((h1[p * c2 + s.tap.c] - mean) * rstd * s.ga + s.be);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const T* __restrict__ x, float* __restrict__ stats,
               float* __restrict__ sums2, int S, int C, int G, float eps) {
  __shared__ float scratch[kThreads / 32];
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = C / G;
  float mean, rstd;
  group_moments<T, V>(x + (long long)b * S * C + (long long)g * cg, S, C, cg,
                      eps, scratch, mean, rstd);
  if (threadIdx.x == 0) {
    const int i = 2 * (b * G + g);
    stats[i] = mean;
    stats[i + 1] = rstd;
    sums2[i] = 0.f;
    sums2[i + 1] = 0.f;
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
conv1_kernel(const T* __restrict__ x, const T* __restrict__ w1,
             const float* __restrict__ tvec, const float* __restrict__ stats,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             float* __restrict__ h1, float* __restrict__ sums2, Geom g,
             int cin, int cout, int groups) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) float a_s[kBK * kLdA];
  __shared__ __align__(16) float b_s[kBK * BN];
  __shared__ int4 rows[kBM];
  __shared__ float red[2 * kMaxGroups * 2];  // [sample - first][group][moment]
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  for (int i = threadIdx.x; i < 4 * groups; i += kThreads) red[i] = 0.f;
  stage_rows(rows, m0, g);
  __syncthreads();
  float acc[kTM][TN];
  const GnSiluLoad<T> load{x, g, cin, cin / groups, groups, stats, gamma, beta};
  gemm_mainloop<BN>(load, w1, 27 * cin, cout, n0, rows, a_s, b_s, acc);

  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  const int first = (int)(m0 / g.volume());
  float ps[2][TN], pq[2][TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) ps[0][j] = ps[1][j] = pq[0][j] = pq[1][j] = 0.f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int4 r = rows[tm * kTM + i];
    if (r.x < 0) break;
    const long long m = m0 + tm * kTM + i;
    const bool second = r.x != first;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn * TN + j;
      if (n >= cout) continue;
      const float v = acc[i][j] + tvec[(long long)r.x * cout + n];
      h1[m * cout + n] = v;
      if (second) {
        ps[1][j] += v;
        pq[1][j] = fmaf(v, v, pq[1][j]);
      } else {
        ps[0][j] += v;
        pq[0][j] = fmaf(v, v, pq[0][j]);
      }
    }
  }
  // Lanes l and l ^ 16 hold the same columns: combine, then one shared
  // atomic per (sample, column) from the lower half-warp.
#pragma unroll
  for (int j = 0; j < TN; ++j)
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      ps[l][j] += __shfl_xor_sync(0xffffffffu, ps[l][j], 16);
      pq[l][j] += __shfl_xor_sync(0xffffffffu, pq[l][j], 16);
    }
  const int cg = cout / groups;
  if ((threadIdx.x & 16) == 0) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn * TN + j;
      if (n >= cout) continue;
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        atomicAdd(&red[(l * groups + n / cg) * 2], ps[l][j]);
        atomicAdd(&red[(l * groups + n / cg) * 2 + 1], pq[l][j]);
      }
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < 4 * groups; q += kThreads) {
    const int b = first + q / (2 * groups);
    if (b < g.batch) atomicAdd(&sums2[2 * b * groups + q % (2 * groups)], red[q]);
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
conv2_kernel(const float* __restrict__ h1, const T* __restrict__ x,
             const T* __restrict__ w2, const float* __restrict__ bias2,
             const float* __restrict__ sums2, const float* __restrict__ gamma,
             const float* __restrict__ beta, T* __restrict__ out, Geom g,
             int cin, int cout, int groups, float eps, int has_skip) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) float a_s[kBK * kLdA];
  __shared__ __align__(16) float b_s[kBK * BN];
  __shared__ int4 rows[kBM];
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  stage_rows(rows, m0, g);
  __syncthreads();
  float acc[kTM][TN];
  const int cg = cout / groups;
  const Gn2SkipLoad<T> load{h1, x, g, cout, cin, cg, groups, sums2, gamma, beta,
                            1.f / ((float)g.volume() * cg), eps};
  gemm_mainloop<BN>(load, w2, 27 * cout + (has_skip ? cin : 0), cout, n0,
                    rows, a_s, b_s, acc);
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  const long long total = g.positions();
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + tm * kTM + i;
    if (m >= total) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn * TN + j;
      if (n >= cout) continue;
      float v = acc[i][j] + bias2[n];
      if (!has_skip) v += to_f(x[m * cin + n]);
      out[m * cout + n] = from_f<T>(v);
    }
  }
}

struct Args {
  const void *x, *w1, *w2;
  const float *tvec, *gamma1, *beta1, *gamma2, *beta2, *bias2;
  float *h1, *stats1, *sums2;
  void* out;
};

template <typename T, int BN>
int launch_convs(const Args& a, Geom g, int cin, int cout, int groups,
                 float eps, int has_skip, dim3 grid, cudaStream_t stream) {
  conv1_kernel<T, BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w1), a.tvec, a.stats1,
      a.gamma1, a.beta1, a.h1, a.sums2, g, cin, cout, groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conv2_kernel<T, BN><<<grid, kThreads, 0, stream>>>(
      a.h1, static_cast<const T*>(a.x), static_cast<const T*>(a.w2), a.bias2,
      a.sums2, a.gamma2, a.beta2, static_cast<T*>(a.out), g, cin, cout, groups,
      eps, has_skip);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, Geom g, int cin, int cout, int groups, float eps,
           int has_skip, cudaStream_t stream) {
  const dim3 mgrid(groups, g.batch);
  const T* x = static_cast<const T*>(a.x);
  if ((cin / groups) % 4 == 0)
    moments_kernel<T, 4><<<mgrid, kThreads, 0, stream>>>(x, a.stats1, a.sums2, g.volume(), cin, groups, eps);
  else
    moments_kernel<T, 1><<<mgrid, kThreads, 0, stream>>>(x, a.stats1, a.sums2, g.volume(), cin, groups, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long mtiles = (g.positions() + kBM - 1) / kBM;
  if (mtiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int bn = pick_bn(cout, mtiles);
  const dim3 grid((unsigned)mtiles, (cout + bn - 1) / bn);
  if (bn == 64) return launch_convs<T, 64>(a, g, cin, cout, groups, eps, has_skip, grid, stream);
  if (bn == 32) return launch_convs<T, 32>(a, g, cin, cout, groups, eps, has_skip, grid, stream);
  return launch_convs<T, 16>(a, g, cin, cout, groups, eps, has_skip, grid, stream);
}

}  // namespace
}  // namespace crowdmod

// dtype: 0 = float32, 1 = bfloat16.  x: (batch, t, h, w, cin); out:
// (batch, t, h, w, cout), both in dtype, contiguous.  w1: (27*cin, cout),
// rows (kd, kh, kw, ci); w2: (27*cout [+ cin], cout), the 1x1 skip weight
// (cin, cout) appended when has_skip; both in dtype.  float32: tvec
// (batch, cout) = b1 + temb_proj; gamma1/beta1 (cin,); gamma2/beta2 (cout,);
// bias2 (cout,) = b2 [+ b_skip]; scratch h1 (batch, t, h, w, cout), stats1
// and sums2 (batch, groups, 2).  Returns a cudaError_t value.
extern "C" int crowdmod_resblock(
    int dtype, const void* x, const void* tvec, const void* w1, const void* w2,
    const void* gamma1, const void* beta1, const void* gamma2,
    const void* beta2, const void* bias2, void* h1, void* stats1, void* sums2,
    void* out, int batch, int t, int h, int w, int cin, int cout, int groups,
    float eps, int has_skip, void* stream) {
  using namespace crowdmod;
  if (batch < 0 || t < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 ||
      groups < 1 || groups > kMaxGroups || cin % groups || cout % groups ||
      batch > 65535 || (!has_skip && cin != cout))
    return (int)cudaErrorInvalidValue;
  const Geom g{batch, t, h, w};
  if (g.volume() < kBM) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const Args a{x, w1, w2,
               static_cast<const float*>(tvec), static_cast<const float*>(gamma1),
               static_cast<const float*>(beta1), static_cast<const float*>(gamma2),
               static_cast<const float*>(beta2), static_cast<const float*>(bias2),
               static_cast<float*>(h1), static_cast<float*>(stats1),
               static_cast<float*>(sums2), out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, g, cin, cout, groups, eps, has_skip, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, g, cin, cout, groups, eps, has_skip, s);
  return (int)cudaErrorInvalidValue;
}
