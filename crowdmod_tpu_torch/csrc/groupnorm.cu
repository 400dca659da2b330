// Fused GroupNorm (+ optional SiLU) for Hopper (sm_90a), channels-last:
//     out = act((x - mean_bg) * rstd_bg * gamma_c + beta_c)
// over (B, S, C) with G groups of C/G channels, moments over the S positions
// and the group's channels, biased variance, float32 moments and affine,
// input type in and out (float or bf16).
//
// Replaces the TPU kernel crowdmod_tpu/ops/pallas/groupnorm.py (_gn_pallas,
// kernel _gn_kernel).
//
// What bounds it on the H100: bytes.  About 10 flops an element against 4
// (bf16) or 8 (f32) bytes in and out.  At the UNet's largest call (the
// final norm at batch 64: 64 x 3456 x 32 bf16, 14 MB in and 14 MB out) the
// bound is about 8.5 us.
//
// Design: one block per (sample, group), 256 threads, that streams its slice
// three times: the sum for the mean, the sum of squared deviations (the
// plain version's two-pass variance, so no cancellation and no atomics: the
// result does not depend on the run), then normalise, affine, SiLU and store.
// The TPU kernel held a whole sample in VMEM; here a sample at level 1 with
// C = 192 (432 x 192 x 4 B = 332 KB as f32) exceeds a block's 227 KB of
// shared memory, so the block streams instead.  The slice is 1/G of a sample
// and the G blocks of one sample are neighbours in the grid, so the second
// and third passes hit the 50 MB L2 rather than device memory: each byte
// comes from device memory about once.  Loads take four channels at a time
// (16 bytes in f32, 8 in bf16) when C/G % 4 == 0, one otherwise; the
// channels of one position in a group are contiguous, so a warp reads 32
// positions' groups.  Grid: B * G blocks (512 at batch 64).
//
// Interface: plain C, loaded with ctypes; launches on the given stream and
// returns cudaGetLastError().

#include "common.cuh"

namespace crowdmod {
namespace {

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
group_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ out, int S,
                  int C, int G, float eps, int act) {
  __shared__ float scratch[kThreads / 32];
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = C / G;
  const long long base = (long long)b * S * C + (long long)g * cg;
  float mean, rstd;
  group_moments<T, V>(x + base, S, C, cg, eps, scratch, mean, rstd);

  const int nv = cg / V;
  const long long items = (long long)S * nv;
  for (long long i = threadIdx.x; i < items; i += kThreads) {
    const long long off = base + (i / nv) * C + (i % nv) * V;
    const int c = g * cg + (int)(i % nv) * V;
    float v[V];
    if constexpr (V == 4) {
      load4(x + off, v);
    } else {
      v[0] = to_f(x[off]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float y = (v[e] - mean) * rstd * gamma[c + e] + beta[c + e];
      v[e] = act ? silu(y) : y;
    }
    if constexpr (V == 4) {
      store4(out + off, v);
    } else {
      out[off] = from_f<T>(v[0]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* gamma, const float* beta, void* out,
           int batch, int S, int C, int G, float eps, int act,
           cudaStream_t stream) {
  const dim3 grid(G, batch);
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if ((C / G) % 4 == 0)
    group_norm_kernel<T, 4><<<grid, kThreads, 0, stream>>>(xi, gamma, beta, o, S, C, G, eps, act);
  else
    group_norm_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xi, gamma, beta, o, S, C, G, eps, act);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace crowdmod

// dtype: 0 = float32, 1 = bfloat16.  x and out: (batch, S, C) contiguous,
// 16-byte aligned; gamma, beta: (C,) float32.  Returns a cudaError_t value.
extern "C" int crowdmod_group_norm(int dtype, const void* x, const void* gamma,
                                   const void* beta, void* out, int batch,
                                   int S, int C, int G, float eps, int act,
                                   void* stream) {
  if (batch < 0 || S < 0 || C < 1 || G < 1 || C % G != 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || S == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  if (dtype == 0)
    return crowdmod::launch<float>(x, ga, be, out, batch, S, C, G, eps, act, s);
  if (dtype == 1)
    return crowdmod::launch<__nv_bfloat16>(x, ga, be, out, batch, S, C, G, eps, act, s);
  return (int)cudaErrorInvalidValue;
}
