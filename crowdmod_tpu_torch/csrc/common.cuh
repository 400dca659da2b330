// Device code shared by the UNet kernels (groupnorm.cu, conv3d.cu,
// resblock.cu): typed loads and stores, block reductions, the per-(sample,
// group) GroupNorm moments, and the SIMT implicit-GEMM main loop of the
// stride-1 SAME 3x3x3 convolutions; on the host, the per-device grant of
// dynamic shared memory that every kernel file's launchers use.
//
// Layout everywhere: channels-last (B, T, H, W, C), contiguous, as the JAX
// package keeps its activations.  Arithmetic is float32 whatever the storage
// type (float or __nv_bfloat16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace crowdmod {

constexpr int kThreads = 256;

// Dynamic shared memory above 48 KB needs cudaFuncSetAttribute, which
// applies to the current device only: it is set once for each (kernel,
// device) pair and size, so a kernel launches on every card of a process
// (a replica on a second card would otherwise launch without it and fail
// with cudaErrorInvalidValue).
inline cudaError_t allow_dynamic_smem(const void* kernel, int bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex lock;
  static std::map<std::pair<const void*, int>, int> granted;
  std::lock_guard<std::mutex> guard(lock);
  int& have = granted[{kernel, device}];
  if (have >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Four consecutive elements as floats: one 16-byte load (float) or one
// 8-byte load (bf16).  The caller guarantees the alignment.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 q;
  *reinterpret_cast<__nv_bfloat162*>(&q.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&q.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = q;
}

// x * sigmoid(x), as jax.nn.silu and torch's F.silu.
__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sum over the kThreads threads of the block; every thread gets the total.
// `scratch` holds kThreads / 32 floats; the call ends with a barrier so the
// scratch may be reused at once.
__device__ __forceinline__ float block_sum(float x, float* scratch) {
  x = warp_sum(x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// Mean and 1/sqrt(var + eps) of one (sample, group) slice: the S rows of
// `x` (row stride C) and the cg channels from `x`, biased variance, two
// passes (mean, then the mean squared deviation) as the plain version.
// V = 4 reads four channels at once (cg % 4 == 0, 4-element aligned).
template <typename T, int V>
__device__ void group_moments(const T* __restrict__ x, int S, int C, int cg,
                              float eps, float* scratch, float& mean,
                              float& rstd) {
  const int nv = cg / V;
  const long long items = (long long)S * nv;
  float s = 0.f;
  for (long long i = threadIdx.x; i < items; i += kThreads) {
    const T* p = x + (i / nv) * C + (i % nv) * V;
    if constexpr (V == 4) {
      float v[4];
      load4(p, v);
      s += (v[0] + v[1]) + (v[2] + v[3]);
    } else {
      s += to_f(*p);
    }
  }
  const float n = (float)S * cg;
  mean = block_sum(s, scratch) / n;
  float q = 0.f;
  for (long long i = threadIdx.x; i < items; i += kThreads) {
    const T* p = x + (i / nv) * C + (i % nv) * V;
    if constexpr (V == 4) {
      float v[4];
      load4(p, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = v[e] - mean;
        q = fmaf(d, d, q);
      }
    } else {
      const float d = to_f(*p) - mean;
      q = fmaf(d, d, q);
    }
  }
  rstd = rsqrtf(block_sum(q, scratch) / n + eps);
}

// ---------------------------------------------------------------------------
// Implicit GEMM for the stride-1 SAME 3x3x3 convolutions
// ---------------------------------------------------------------------------
//
// out[m, n] = sum_k A[m, k] * Wmat[k, n], m over the B*T*H*W output
// positions, n over Cout, k over (kd, kh, kw, ci) with kd (time) slowest:
// the JAX kernel (3, 3, 3, Cin, Cout) reshaped to (27*Cin, Cout).  A is
// never stored: a loader builds each element from the input as the tile is
// staged (im2col on the fly), so a loader may also normalise it first.
//
// A block computes a kBM x BN tile with kThreads threads, each an 8 x BN/16
// register tile of f32 sums, over K in chunks of kBK staged in shared
// memory as f32 (A transposed, so each thread's 8 rows are two 16-byte
// reads).

constexpr int kBM = 128;
constexpr int kBK = 16;
constexpr int kTM = 8;
constexpr int kLdA = kBM + 4;  // 16-byte rows; 2-way conflicts on the store

struct Geom {
  int batch, t, h, w;
  __host__ __device__ long long positions() const {
    return (long long)batch * t * h * w;
  }
  __host__ __device__ int volume() const { return t * h * w; }
};

// Coordinates (b, t, h, w) of the block's kBM output positions; b = -1
// past the last one.
__device__ __forceinline__ void stage_rows(int4* rows, long long m0, const Geom& g) {
  const long long total = g.positions();
  for (int i = threadIdx.x; i < kBM; i += kThreads) {
    const long long m = m0 + i;
    if (m >= total) {
      rows[i] = make_int4(-1, 0, 0, 0);
      continue;
    }
    long long r = m;
    const int w = (int)(r % g.w); r /= g.w;
    const int h = (int)(r % g.h); r /= g.h;
    const int t = (int)(r % g.t);
    rows[i] = make_int4((int)(r / g.t), t, h, w);
  }
}

// Element offset of position (b, t, h, w) shifted by a tap, or -1 where the
// tap falls outside the volume (SAME zero padding).
__device__ __forceinline__ long long tap_offset(const int4& r, int dt, int dh,
                                                int dw, const Geom& g) {
  const int t = r.y + dt, h = r.z + dh, w = r.w + dw;
  if (r.x < 0 || (unsigned)t >= (unsigned)g.t || (unsigned)h >= (unsigned)g.h ||
      (unsigned)w >= (unsigned)g.w)
    return -1;
  return (((long long)r.x * g.t + t) * g.h + h) * g.w + w;
}

struct Tap {
  int dt, dh, dw, c;
};

__device__ __forceinline__ Tap split_k(int k, int cin) {
  const int tap = k / cin;
  return Tap{tap / 9 - 1, (tap / 3) % 3 - 1, tap % 3 - 1, k - tap * cin};
}

// Plain im2col: the input value under tap k of position r, 0 outside.
template <typename T>
struct Im2colLoad {
  const T* x;
  Geom g;
  int cin;
  using State = Tap;
  __device__ State state(int k) const { return split_k(k, cin); }
  __device__ float operator()(const int4& r, const State& s) const {
    const long long p = tap_offset(r, s.dt, s.dh, s.dw, g);
    return p < 0 ? 0.f : to_f(x[p * cin + s.c]);
  }
};

// Main loop: acc += A[m0.., :] @ Wmat[:, n0..] for this thread's rows
// (tm * kTM + i) and columns (tn * TN + j), tm = tid / 16, tn = tid % 16.
template <int BN, typename W, class Load>
__device__ __forceinline__ void gemm_mainloop(
    const Load& load, const W* __restrict__ wmat, int K, int N, int n0,
    const int4* rows, float* a_s, float* b_s, float (&acc)[kTM][BN / 16]) {
  constexpr int TN = BN / 16;
  const int tid = threadIdx.x;
  const int tm = tid >> 4, tn = tid & 15;
  const int lk = tid % kBK, lm = tid / kBK;  // A staging: 16 k x 16 rows
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int k = k0 + lk;
    if (k < K) {
      const typename Load::State s = load.state(k);
#pragma unroll
      for (int i = 0; i < kBM / (kThreads / kBK); ++i) {
        const int ml = lm + (kThreads / kBK) * i;
        a_s[lk * kLdA + ml] = load(rows[ml], s);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBM / (kThreads / kBK); ++i)
        a_s[lk * kLdA + lm + (kThreads / kBK) * i] = 0.f;
    }
    for (int idx = tid; idx < kBK * BN; idx += kThreads) {
      const int kk = idx / BN, nn = idx % BN;
      const int kg = k0 + kk, ng = n0 + nn;
      b_s[idx] = (kg < K && ng < N) ? to_f(wmat[(long long)kg * N + ng]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + kk * kLdA + tm * kTM);
      const float4 a1 = *reinterpret_cast<const float4*>(a_s + kk * kLdA + tm * kTM + 4);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = b_s[kk * BN + tn * TN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace crowdmod
