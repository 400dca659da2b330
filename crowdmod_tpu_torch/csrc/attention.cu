// Fused multi-head attention for Hopper (sm_90a):
//     out = softmax(scale * Q K^T) V      over (B, H, S, Dh) problems.
//
// Replaces the TPU kernel crowdmod_tpu/ops/pallas/attention.py
// (_attention_pallas, kernel _attn_kernel).  Same contract: logits and the
// softmax in f32, the weights cast to V's type before the product with V,
// that product accumulated in f32, the output written in the input type.
// Q K^T, the softmax and the product with V happen in this one kernel; the
// logits never reach device memory.
//
// What bounds it on the H100: bytes.  At the DiT4DFactorized serving shapes
// one call is thousands of tiny problems (batch 64: spatial 512 problems of
// 27x64x27, temporal 6912 problems of 1x64x2), about 4 flop per byte of
// Q, K, V and O, far below the card's ridge point; in f32 one spatial call
// moves about 14 MB and one temporal call about 10.6 MB.
//
// Design: a block of 8 warps takes whole problems: max(1, 8 / Sq) of them,
// so a spatial block holds one problem of 27 query rows and a temporal
// block 8 problems of 1 row; the grid has hundreds to thousands of blocks.
// The block first copies K and V of its problems to shared memory as f32,
// with coalesced reads (each is read from device memory once).  Then each
// warp takes one query row at a time: it stages the row in shared memory,
// each lane forms the logits of its keys (lane, lane+32, ...) as plain dot
// products in 16-byte shared reads (K rows padded to Dh+4 floats, so the
// lanes of a quarter-warp hit distinct banks; the query is a broadcast),
// two warp reductions give the max and the sum, each lane writes its keys'
// normalised weights rounded to V's type, and for the product with V each
// lane owns Dh/32 consecutive output elements, read from shared memory in
// one access a key.  No logit, weight or partial sum leaves the SM.
//
// Limits (checked by the Python wrapper, and again here): Dh in {32, 64};
// 1 <= Sk <= 256, the largest key count whose f32 K, V and per-warp rows
// fit the 227 KB of shared memory a block can have with room to spare
// (Sk = 256, Dh = 64: 145 KB).  The contract's largest problem, S = 216,
// fits.  The last dimension of each tensor must be contiguous; the other
// three strides are arguments, so the caller's (B, S, H, Dh) projections
// are read in place.
//
// Interface: plain C, loaded with ctypes; launches on the given stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxSk = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// w.astype(v.dtype): the weight rounded to V's storage type.
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T, int kDh>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int heads,
                 int sq, int sk, long long problems, int per_block,
                 float scale, Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int kDpl = kDh / 32;  // consecutive output elements a lane owns
  constexpr int kLdk = kDh + 4;   // padded K row, 16-byte aligned
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sk4 = (sk + 3) & ~3;
  const long long first = (long long)blockIdx.x * per_block;
  const int np = (int)min((long long)per_block, problems - first);
  float* k_sh = smem;                                  // [per_block][sk][kLdk]
  float* v_sh = k_sh + (size_t)per_block * sk * kLdk;  // [per_block][sk][kDh]
  float* q_sh = v_sh + (size_t)per_block * sk * kDh + warp * (kDh + sk4);
  float* p = q_sh + kDh;  // this warp's logits, then weights

  // Stage K and V of the block's problems as f32 (coalesced along Dh).
  for (int pi = 0; pi < np; ++pi) {
    const long long bh = first + pi;
    const long long b = bh / heads, h = bh % heads;
    const T* kg = k + b * ks.b + h * ks.h;
    const T* vg = v + b * vs.b + h * vs.h;
    float* kd = k_sh + (size_t)pi * sk * kLdk;
    float* vd = v_sh + (size_t)pi * sk * kDh;
    for (int idx = threadIdx.x; idx < sk * kDh; idx += kWarps * 32) {
      const int j = idx / kDh, d = idx % kDh;
      kd[j * kLdk + d] = load_f(kg + j * ks.s + d);
      vd[idx] = load_f(vg + j * vs.s + d);
    }
  }
  __syncthreads();

  for (int r = warp; r < np * sq; r += kWarps) {
    const int pi = r / sq;
    const long long s = r % sq;
    const long long bh = first + pi;
    const long long b = bh / heads, h = bh % heads;
    const T* qrow = q + b * qs.b + h * qs.h + s * qs.s;
    T* orow = o + b * os.b + h * os.h + s * os.s;
    const float* kp = k_sh + (size_t)pi * sk * kLdk;
    const float* vp = v_sh + (size_t)pi * sk * kDh;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) q_sh[lane + 32 * i] = load_f(qrow + lane + 32 * i);
    __syncwarp();

    // Pass 1: f32 logits, one key per lane (16-byte shared reads; the
    // query is a broadcast), and their max.
    const float4* q4 = reinterpret_cast<const float4*>(q_sh);
    float m = -INFINITY;
    for (int j = lane; j < sk; j += 32) {
      const float4* k4 = reinterpret_cast<const float4*>(kp + j * kLdk);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kDh / 4; ++d) {
        const float4 a = q4[d], c = k4[d];
        dot = fmaf(a.x, c.x, dot);
        dot = fmaf(a.y, c.y, dot);
        dot = fmaf(a.z, c.z, dot);
        dot = fmaf(a.w, c.w, dot);
      }
      const float logit = dot * scale;
      p[j] = logit;
      m = fmaxf(m, logit);
    }
    m = warp_max(m);

    // Pass 2: exp(logit - m), their sum, then the weights e / l rounded to
    // V's type (each lane rewrites its own keys).
    float l = 0.f;
    for (int j = lane; j < sk; j += 32) {
      const float e = expf(p[j] - m);
      p[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < sk; j += 32) p[j] = round_like(p[j] / l, v);
    __syncwarp();

    // Pass 3: f32 accumulation of w * V over the keys; the lane's kDpl
    // consecutive elements are one shared read.
    float acc[kDpl];
#pragma unroll
    for (int i = 0; i < kDpl; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < sk; ++j) {
      const float w = p[j];
      const float* vr = vp + j * kDh + kDpl * lane;
      if constexpr (kDpl == 2) {
        const float2 t = *reinterpret_cast<const float2*>(vr);
        acc[0] = fmaf(w, t.x, acc[0]);
        acc[1] = fmaf(w, t.y, acc[1]);
      } else {
        acc[0] = fmaf(w, vr[0], acc[0]);
      }
    }
#pragma unroll
    for (int i = 0; i < kDpl; ++i) store_f(orow + kDpl * lane + i, acc[i]);
    __syncwarp();  // the next row overwrites q_sh and p
  }
}

template <typename T, int kDh>
int launch(const void* q, const void* k, const void* v, void* o, int heads,
           int sq, int sk, long long problems, float scale,
           const long long* st, cudaStream_t stream) {
  const int per_block = sq >= kWarps ? 1 : kWarps / sq;
  const long long blocks = (problems + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * ((size_t)per_block * sk * (2 * kDh + 4) +
                                       kWarps * (kDh + ((sk + 3) & ~3)));
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<T, kDh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
  }
  attention_kernel<T, kDh><<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), heads, sq, sk, problems,
      per_block, scale, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]});
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v, void* o,
                int heads, int sq, int sk, long long problems, float scale,
                const long long* st, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, o, heads, sq, sk, problems, scale, st, stream);
    case 64: return launch<T, 64>(q, k, v, o, heads, sq, sk, problems, scale, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (b, h, s)
// for q, k, v and o in that order.  Returns a cudaError_t value.
extern "C" int crowdmod_attention(int dtype, const void* q, const void* k,
                                  const void* v, void* o, int batch, int heads,
                                  int sq, int sk, int dh, float scale,
                                  const long long* strides, void* stream) {
  if (sk < 1 || sk > kMaxSk || sq < 0 || batch < 0 || heads < 1)
    return (int)cudaErrorInvalidValue;
  const long long problems = (long long)batch * heads;
  if (problems == 0 || sq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(dh, q, k, v, o, heads, sq, sk, problems, scale, strides, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dh, q, k, v, o, heads, sq, sk, problems, scale, strides, s);
  return (int)cudaErrorInvalidValue;
}
