// Fused multi-head attention for Hopper (sm_90a):
//     out = softmax(scale * Q K^T) V      over (B, H, S, Dh) problems.
//
// Replaces the TPU kernel crowdmod_tpu/ops/pallas/attention.py
// (_attention_pallas, kernel _attn_kernel).  Same contract: logits and the
// softmax in f32, the weights normalised and then cast to V's type before
// the product with V, that product accumulated in f32, the output written
// in the input type.  Q K^T, the softmax and the product with V happen in
// this one kernel; the logits never reach device memory.
//
// What bounds it on the H100: bytes.  At the serving shapes one call is
// hundreds to thousands of tiny problems (batch 64: the DiT's spatial 512
// problems of 27x64x27 and temporal 6912 of 1x64x2, the UNet's level-2 256
// of 54x32x54), a few flops per byte of Q, K, V and O, far below the
// card's ridge point.  What keeps such a kernel from its bound is latency:
// serial work per row and loads that are too small.
//
// Two routes, picked by the wrapper's plan (ops/kernels/attention.py,
// attention_plan) and passed in as ints:
//
//   "mma" (bf16, Sq >= 16): the FlashAttention-2 register layout on the
//   tensor cores (mma.cuh).  A block takes whole (b, h) problems and copies
//   their Q, K and V rows into shared memory as bf16, in 16-byte cp.async
//   pieces read through the caller's strides; rows are padded by 8 elements
//   (conflict-free ldmatrix) and keys past Sk are zero-filled up to a
//   multiple of 16.  Each warp owns a 16-row query tile of one problem
//   (DiT: 2 tiles a problem, 4 problems a block; UNet: 4 tiles, 2
//   problems).  S = Q K^T is mma.sync m16n8k16 with f32 accumulators, K in
//   [key][d] layout being the col-major B operand as it stands; the scale,
//   a -inf mask on padded keys, and the row max and sum (shuffles inside
//   each quad of lanes) stay in registers.  The weights w = e / l are
//   normalised in f32 and then rounded to bf16, as the contract rounds them
//   (FlashAttention's deferred normalisation would round another number),
//   and repacked from the accumulator layout into A fragments in
//   registers; O = W V takes V through ldmatrix.trans and accumulates in
//   f32.  Up to 64 keys the logits of a row stay in registers and nothing
//   is recomputed; beyond, the keys go in blocks of 64 in two sweeps: the
//   row max and sum, rescaled online, then each block's logits again, its
//   normalised weights and their product with V.  The plan takes this route
//   only while a problem's Q, K and V fit in shared memory (FM-DiT's 432
//   tokens at Dh 64: 186,624 bytes); past that, bf16 takes "simt".
//
//   "simt" (f32, and bf16 with Sq < 16: the DiT's temporal attention, one
//   query against two keys, where a 16-row tile would be 15/16 waste): the
//   first design, in two forms.  Resident, while the block's K and V fit in
//   shared memory: a block of 8 warps takes max(1, 8 / Sq) problems, copies
//   K and V to shared memory as f32 in 16-byte loads where the rows allow
//   it, and each warp walks one query row at a time: f32 logits a lane a
//   key, two warp reductions, the weights rounded to V's type, each lane
//   Dh/32 output elements.  Streamed, past that (f32 at 432 keys and Dh 64
//   would need 243,968 bytes): a block takes one problem and 8 to 32 of its
//   query rows (up to 4 a warp, their running max, sum and output in
//   registers) and streams K and V through shared memory in blocks of 128
//   keys, in two sweeps as the mma route: the row max and sum, rescaled
//   online, then each block's logits again, the normalised weights rounded
//   to V's type, and their product with V.  Any Sk.  f32 stays exact (no
//   TF32).
//
// Limits (checked by the Python wrapper, and again here): Dh in {8, 16, 32,
// 64}, the mma route Dh in {16, 32, 64} (its k-slices are 16 deep; under
// Dh 32 a simt lane past Dh owns no output element: the UNet's attention
// at a base width of 16, 4 heads of 8); Sk >= 1; the plan's shared memory
// at most 227 KB.  The last
// dimension of each tensor must be contiguous; the other three strides are
// arguments, so the caller's (B, S, H, Dh) projections are read in place.
// The mma route needs 16-byte aligned rows (base address and strides).
//
// Interface: plain C, loaded with ctypes; launches on the given stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using crowdmod::bf16;

constexpr int kWarps = 8;       // simt route
constexpr int kMaxWarps = 16;   // mma route
constexpr int kKeyBlock = 64;   // keys whose logits a warp holds at once
constexpr int kStreamKeys = 128;  // simt, streamed: keys a block stages at once
constexpr int kStreamRows = 4;    // simt, streamed: query rows a warp holds
constexpr int kMaxSmem = 232448;  // 227 KB, a block's most

struct Strides {
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One warp's 16 query rows against the keys of one problem.  Fragment
// layout (mma m16n8k16): lane = 4 * g + t holds rows g and g + 8 of the
// tile and, in each 8-wide n tile, columns 2t and 2t + 1; element e of an
// accumulator is row g + 8 * (e / 2), column 2t + e % 2.
template <int kDh>
struct WarpTile {
  static constexpr int LD = kDh + 8;   // padded row, bf16 elements
  static constexpr int KS = kDh / 16;  // 16-deep slices of Dh
  static constexpr int DN = kDh / 8;   // 8-wide n tiles of the output
  static constexpr int NT = kKeyBlock / 8;

  unsigned q[KS][4];  // the query tile as A fragments
  float o[DN][4];     // the output tile, f32

  // s = scale * Q K^T for keys kb .. kb + 16 * ksteps - 1, -inf past sk
  // (and in the n tiles past them).
  __device__ __forceinline__ void logits(const bf16* ks, int kb, int ksteps, int sk,
                                         float scale, float (&s)[NT][4]) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (np >= ksteps) break;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned r[4];
        crowdmod::ldmatrix_x4(
            r, ks + (kb + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                   ((lane >> 3) & 1) * 8);
        crowdmod::mma_bf16_16816(s[2 * np], q[kk], r[0], r[1]);
        crowdmod::mma_bf16_16816(s[2 * np + 1], q[kk], r[2], r[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + nt * 8 + 2 * (lane & 3) + (e & 1);
        s[nt][e] = key < sk ? s[nt][e] * scale : -INFINITY;
      }
  }

  // Row maxima of s (rows g and g + 8), over the quad.
  __device__ __forceinline__ static void row_max(const float (&s)[NT][4], float (&m)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) x = fmaxf(x, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      m[i] = quad_max(x);
    }
  }

  // o += round_bf16(w) V for the keys kb .. kb + 16 * ksteps - 1, w in the
  // accumulator layout of logits().
  __device__ __forceinline__ void multiply_v(const bf16* vs, int kb, int ksteps,
                                             const float (&w)[NT][4]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (kk >= ksteps) break;
      const unsigned a[4] = {pack_bf16(w[2 * kk][0], w[2 * kk][1]),
                             pack_bf16(w[2 * kk][2], w[2 * kk][3]),
                             pack_bf16(w[2 * kk + 1][0], w[2 * kk + 1][1]),
                             pack_bf16(w[2 * kk + 1][2], w[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < DN; nd += 2) {
        unsigned r[4];
        crowdmod::ldmatrix_x4_trans(
            r, vs + (kb + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + nd * 8 +
                   (lane >> 4) * 8);
        crowdmod::mma_bf16_16816(o[nd], a, r[0], r[1]);
        crowdmod::mma_bf16_16816(o[nd + 1], a, r[2], r[3]);
      }
    }
  }
};

template <int kDh>
__global__ void __launch_bounds__(kMaxWarps * 32)
attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int heads, int sq,
                     int sk, long long problems, int per_block, int tiles, int skp,
                     float scale, Strides qs, Strides ks, Strides vs, Strides os) {
  using Tile = WarpTile<kDh>;
  constexpr int LD = Tile::LD, PIECES = kDh / 8, NT = Tile::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qrows = tiles * 16;
  bf16* q_sh = reinterpret_cast<bf16*>(smem_raw);  // [per_block][qrows][LD]
  bf16* k_sh = q_sh + per_block * qrows * LD;      // [per_block][skp][LD]
  bf16* v_sh = k_sh + per_block * skp * LD;
  const int nthreads = blockDim.x;
  const long long first = (long long)blockIdx.x * per_block;

  // Stage Q, K and V of the block's problems: 16-byte pieces, zero rows
  // past Sq and Sk (src-size 0) and for problems past the last.
  for (int pi = 0; pi < per_block; ++pi) {
    const long long bh = first + pi;
    const bool live = bh < problems;
    const long long b = live ? bh / heads : 0, h = live ? bh % heads : 0;
    const bf16* qg = q + b * qs.b + h * qs.h;
    const bf16* kg = k + b * ks.b + h * ks.h;
    const bf16* vg = v + b * vs.b + h * vs.h;
    for (int idx = threadIdx.x; idx < qrows * PIECES; idx += nthreads) {
      const int j = idx / PIECES, p = idx % PIECES;
      const bool ok = live && j < sq;
      crowdmod::cp_async16(q_sh + (pi * qrows + j) * LD + p * 8, ok ? qg + j * qs.s + p * 8 : q,
                           ok);
    }
    for (int idx = threadIdx.x; idx < skp * PIECES; idx += nthreads) {
      const int j = idx / PIECES, p = idx % PIECES;
      const bool ok = live && j < sk;
      crowdmod::cp_async16(k_sh + (pi * skp + j) * LD + p * 8, ok ? kg + j * ks.s + p * 8 : k,
                           ok);
      crowdmod::cp_async16(v_sh + (pi * skp + j) * LD + p * 8, ok ? vg + j * vs.s + p * 8 : v,
                           ok);
    }
  }
  crowdmod::cp_async_commit();
  crowdmod::cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nkb = (sk + kKeyBlock - 1) / kKeyBlock;
  for (int tile = threadIdx.x >> 5; tile < per_block * tiles; tile += nthreads >> 5) {
    const int pi = tile / tiles, qt = tile % tiles;
    const long long bh = first + pi;
    if (bh >= problems) break;  // tiles go by problem: the rest are past too
    const bf16* kp = k_sh + pi * skp * LD;
    const bf16* vp = v_sh + pi * skp * LD;
    Tile w;
#pragma unroll
    for (int kk = 0; kk < Tile::KS; ++kk)
      crowdmod::ldmatrix_x4(w.q[kk], q_sh + (pi * qrows + qt * 16 + (lane & 15)) * LD + kk * 16 +
                                         (lane >> 4) * 8);
#pragma unroll
    for (int nd = 0; nd < Tile::DN; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) w.o[nd][e] = 0.f;

    float s[NT][4], m[2], l[2];
    const auto ksteps = [&](int kb) { return (min(kKeyBlock, sk - kb) + 15) / 16; };
    if (nkb == 1) {
      // One key block: e = exp(s - m) stays in registers.
      w.logits(kp, 0, ksteps(0), sk, scale, s);
      Tile::row_max(s, m);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            s[nt][2 * i + c] = expf(s[nt][2 * i + c] - m[i]);
            x += s[nt][2 * i + c];
          }
        l[i] = quad_sum(x);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = s[nt][e] / l[e >> 1];
      w.multiply_v(vp, 0, ksteps(0), s);
    } else {
      // Sweep 1: the row max and sum over the key blocks, rescaled online.
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
      for (int kb = 0; kb < sk; kb += kKeyBlock) {
        w.logits(kp, kb, ksteps(kb), sk, scale, s);
        float bm[2];
        Tile::row_max(s, bm);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float mn = fmaxf(m[i], bm[i]);
          float x = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            x += expf(s[nt][2 * i] - mn) + expf(s[nt][2 * i + 1] - mn);
          l[i] = l[i] * expf(m[i] - mn) + quad_sum(x);
          m[i] = mn;
        }
      }
      // Sweep 2: each block's logits again, its normalised weights, W V.
      for (int kb = 0; kb < sk; kb += kKeyBlock) {
        w.logits(kp, kb, ksteps(kb), sk, scale, s);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = expf(s[nt][e] - m[e >> 1]) / l[e >> 1];
        w.multiply_v(vp, kb, ksteps(kb), s);
      }
    }

    const long long b = bh / heads, h = bh % heads;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = qt * 16 + g + 8 * i;
      if (j >= sq) continue;
      bf16* orow = o + b * os.b + h * os.h + j * os.s + 2 * t;
#pragma unroll
      for (int nd = 0; nd < Tile::DN; ++nd)
        *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8) =
            __floats2bfloat162_rn(w.o[nd][2 * i], w.o[nd][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32, and bf16 with Sq < 16: one warp a query row
// ---------------------------------------------------------------------------

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(bf16* p, float x) { *p = __float2bfloat16(x); }
// w.astype(v.dtype): the weight rounded to V's storage type.
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// 16 bytes (4 floats or 8 bf16) as floats into shared memory, 16-byte
// aligned at both ends.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void copy16(float* dst, const bf16* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
  const float2 c = __bfloat1622float2(p[2]), d = __bfloat1622float2(p[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
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
attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int heads, int sq, int sk,
                      long long problems, int per_block, int vec, float scale, Strides qs,
                      Strides ks, Strides vs, Strides os) {
  // Consecutive output elements a lane owns; under Dh 32, lanes past Dh
  // own none.
  constexpr int kDpl = kDh >= 32 ? kDh / 32 : 1;
  constexpr int kLdk = kDh + 4;          // padded K row, 16-byte aligned
  constexpr int kVec = 16 / sizeof(T);   // elements of one 16-byte load
  constexpr int kPieces = kDh / kVec;
  extern __shared__ float4 smem4[];
  __shared__ long long koff[kWarps], voff[kWarps];  // per_block <= kWarps
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool owner = kDh >= 32 || lane < kDh;
  const int sk4 = (sk + 3) & ~3;
  const long long first = (long long)blockIdx.x * per_block;
  const int np = (int)min((long long)per_block, problems - first);
  float* k_sh = smem;                                  // [per_block][sk][kLdk]
  float* v_sh = k_sh + (size_t)per_block * sk * kLdk;  // [per_block][sk][kDh]
  float* q_sh = v_sh + (size_t)per_block * sk * kDh + warp * (kDh + sk4);
  float* p = q_sh + kDh;  // this warp's logits, then weights

  if (threadIdx.x < np) {
    const long long bh = first + threadIdx.x;
    const long long b = bh / heads, h = bh % heads;
    koff[threadIdx.x] = b * ks.b + h * ks.h;
    voff[threadIdx.x] = b * vs.b + h * vs.h;
  }
  __syncthreads();
  // Stage K and V of the block's problems as f32, all problems' rows over
  // all threads: one 16-byte load a row piece where the rows allow it.
  if (vec) {
    for (int idx = threadIdx.x; idx < np * sk * kPieces; idx += kWarps * 32) {
      const int r = idx / kPieces, c = idx % kPieces * kVec;
      const int pi = r / sk, j = r % sk;
      copy16(k_sh + (size_t)r * kLdk + c, k + koff[pi] + j * ks.s + c);
      copy16(v_sh + (size_t)r * kDh + c, v + voff[pi] + j * vs.s + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < np * sk * kDh; idx += kWarps * 32) {
      const int r = idx / kDh, d = idx % kDh;
      const int pi = r / sk, j = r % sk;
      k_sh[(size_t)r * kLdk + d] = load_f(k + koff[pi] + j * ks.s + d);
      v_sh[(size_t)r * kDh + d] = load_f(v + voff[pi] + j * vs.s + d);
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
    if (owner) {
#pragma unroll
      for (int i = 0; i < kDpl; ++i) q_sh[lane + 32 * i] = load_f(qrow + lane + 32 * i);
    }
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
    if (owner) {
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
    }
    __syncwarp();  // the next row overwrites q_sh and p
  }
}


// Streamed: one problem and query_rows (8 to 32) of its rows a block; K and
// V pass through shared memory kStreamKeys at a time, twice for K.
template <typename T, int kDh>
__global__ void __launch_bounds__(kWarps * 32)
attention_simt_streamed_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o, int heads, int sq,
                               int sk, int query_rows, int vec, float scale, Strides qs,
                               Strides ks, Strides vs, Strides os) {
  constexpr int kDpl = kDh >= 32 ? kDh / 32 : 1;  // as the resident form's
  constexpr int kLdk = kDh + 4;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPieces = kDh / kVec;
  constexpr int kPerLane = kStreamKeys / 32;  // keys a lane takes of a block
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool owner = kDh >= 32 || lane < kDh;
  const int rows = query_rows / kWarps;  // this warp's rows: r0 + warp + 8 i
  const long long bh = blockIdx.x;
  const long long b = bh / heads, h = bh % heads;
  const int r0 = blockIdx.y * query_rows;
  float* k_sh = smem;                                    // [kStreamKeys][kLdk]
  float* v_sh = k_sh + kStreamKeys * kLdk;               // [kStreamKeys][kDh]
  float* q_sh = v_sh + kStreamKeys * kDh + warp * (rows * kDh + kStreamKeys);
  float* p = q_sh + rows * kDh;  // this warp's weights of one row and block
  const T* kg = k + b * ks.b + h * ks.h;
  const T* vg = v + b * vs.b + h * vs.h;

#pragma unroll
  for (int i = 0; i < kStreamRows; ++i) {
    const int s = r0 + warp + kWarps * i;
    if (owner && i < rows && s < sq) {
      const T* qrow = q + b * qs.b + h * qs.h + (long long)s * qs.s;
#pragma unroll
      for (int c = 0; c < kDpl; ++c) q_sh[i * kDh + lane + 32 * c] = load_f(qrow + lane + 32 * c);
    }
  }
  __syncwarp();

  // Keys kb .. kb + nk - 1 of K (and V) into shared memory, all threads.
  const auto stage = [&](int kb, int nk, bool with_v) {
    if (vec) {
      for (int idx = threadIdx.x; idx < nk * kPieces; idx += kWarps * 32) {
        const int j = idx / kPieces, c = idx % kPieces * kVec;
        copy16(k_sh + j * kLdk + c, kg + (long long)(kb + j) * ks.s + c);
        if (with_v) copy16(v_sh + j * kDh + c, vg + (long long)(kb + j) * vs.s + c);
      }
    } else {
      for (int idx = threadIdx.x; idx < nk * kDh; idx += kWarps * 32) {
        const int j = idx / kDh, d = idx % kDh;
        k_sh[j * kLdk + d] = load_f(kg + (long long)(kb + j) * ks.s + d);
        if (with_v) v_sh[j * kDh + d] = load_f(vg + (long long)(kb + j) * vs.s + d);
      }
    }
  };
  // f32 logit of query row i against staged key j (16-byte shared reads).
  const auto logit = [&](int i, int j) {
    const float4* q4 = reinterpret_cast<const float4*>(q_sh + i * kDh);
    const float4* k4 = reinterpret_cast<const float4*>(k_sh + j * kLdk);
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < kDh / 4; ++d) {
      const float4 a = q4[d], c = k4[d];
      dot = fmaf(a.x, c.x, dot);
      dot = fmaf(a.y, c.y, dot);
      dot = fmaf(a.z, c.z, dot);
      dot = fmaf(a.w, c.w, dot);
    }
    return dot * scale;
  };

  // Sweep 1: each row's max and sum over the key blocks, rescaled online.
  float m[kStreamRows], l[kStreamRows];
#pragma unroll
  for (int i = 0; i < kStreamRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int kb = 0; kb < sk; kb += kStreamKeys) {
    const int nk = min(kStreamKeys, sk - kb);
    __syncthreads();  // the last block's reads are done
    stage(kb, nk, false);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kStreamRows; ++i) {
      if (i >= rows || r0 + warp + kWarps * i >= sq) continue;
      float s[kPerLane], bm = -INFINITY;
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int j = lane + 32 * u;
        s[u] = j < nk ? logit(i, j) : -INFINITY;
        bm = fmaxf(bm, s[u]);
      }
      const float mn = fmaxf(m[i], warp_max(bm));
      float x = 0.f;
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) x += expf(s[u] - mn);
      l[i] = l[i] * expf(m[i] - mn) + warp_sum(x);
      m[i] = mn;
    }
  }

  // Sweep 2: each block's logits again, the weights e / l rounded to V's
  // type, and their f32 product with V (a lane Dh/32 output elements).
  float acc[kStreamRows][kDpl];
#pragma unroll
  for (int i = 0; i < kStreamRows; ++i)
#pragma unroll
    for (int c = 0; c < kDpl; ++c) acc[i][c] = 0.f;
  for (int kb = 0; kb < sk; kb += kStreamKeys) {
    const int nk = min(kStreamKeys, sk - kb);
    __syncthreads();
    stage(kb, nk, true);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kStreamRows; ++i) {
      if (i >= rows || r0 + warp + kWarps * i >= sq) continue;
      for (int j = lane; j < nk; j += 32) p[j] = round_like(expf(logit(i, j) - m[i]) / l[i], v);
      __syncwarp();
      if (owner) {
#pragma unroll 4
        for (int j = 0; j < nk; ++j) {
          const float w = p[j];
          const float* vr = v_sh + j * kDh + kDpl * lane;
          if constexpr (kDpl == 2) {
            const float2 t = *reinterpret_cast<const float2*>(vr);
            acc[i][0] = fmaf(w, t.x, acc[i][0]);
            acc[i][1] = fmaf(w, t.y, acc[i][1]);
          } else {
            acc[i][0] = fmaf(w, vr[0], acc[i][0]);
          }
        }
      }
      __syncwarp();  // the next row overwrites p
    }
  }

#pragma unroll
  for (int i = 0; i < kStreamRows; ++i) {
    const int s = r0 + warp + kWarps * i;
    if (!owner || i >= rows || s >= sq) continue;
    T* orow = o + b * os.b + h * os.h + (long long)s * os.s;
#pragma unroll
    for (int c = 0; c < kDpl; ++c) store_f(orow + kDpl * lane + c, acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Shared memory of a block of either route, in bytes, as the wrapper's
// attention_plan computes it; the simt route is streamed when its key block
// holds fewer than Sk keys.
long long smem_bytes(int route, int dh, int sq, int sk, int per_block, int keys_padded,
                     int query_rows, int key_block) {
  if (route == 1) {
    const long long tiles = (sq + 15) / 16;
    return 2LL * (dh + 8) * per_block * (tiles * 16 + 2LL * keys_padded);
  }
  if (key_block < sk)
    return 4LL * ((long long)key_block * (2 * dh + 4) +
                  kWarps * ((long long)(query_rows / kWarps) * dh + key_block));
  return 4LL * ((long long)per_block * sk * (2 * dh + 4) + kWarps * (dh + keys_padded));
}


Strides strides_at(const long long* st, int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

template <int kDh>
int launch_mma(const void* q, const void* k, const void* v, void* o, int heads, int sq, int sk,
               long long problems, int per_block, int warps, int skp, int smem, float scale,
               const long long* st, cudaStream_t stream) {
  const int tiles = (sq + 15) / 16;
  if (warps < 1 || warps > kMaxWarps || warps > per_block * tiles || skp < sk || skp % 16)
    return (int)cudaErrorInvalidValue;
  const auto kernel = attention_mma_kernel<kDh>;
  const cudaError_t attr =
      crowdmod::allow_dynamic_smem(reinterpret_cast<const void*>(kernel), kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = (problems + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, warps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), heads, sq, sk, problems, per_block, tiles, skp, scale,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 3));
  return (int)cudaGetLastError();
}

template <typename T, int kDh>
int launch_simt(const void* q, const void* k, const void* v, void* o, int heads, int sq, int sk,
                long long problems, int per_block, int warps, int smem, int vec, float scale,
                const long long* st, cudaStream_t stream) {
  if (warps != kWarps || per_block < 1 || per_block > kWarps) return (int)cudaErrorInvalidValue;
  const auto kernel = attention_simt_kernel<T, kDh>;
  if (smem > 48 * 1024) {  // the kernel's static shared memory rules out the most
    const cudaError_t err =
        crowdmod::allow_dynamic_smem(reinterpret_cast<const void*>(kernel), smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (problems + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), heads, sq, sk, problems, per_block, vec, scale, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3));
  return (int)cudaGetLastError();
}

template <typename T, int kDh>
int launch_simt_streamed(const void* q, const void* k, const void* v, void* o, int heads, int sq,
                         int sk, long long problems, int per_block, int warps, int query_rows,
                         int smem, int vec, float scale, const long long* st,
                         cudaStream_t stream) {
  if (warps != kWarps || per_block != 1 || query_rows % kWarps ||
      query_rows < kWarps || query_rows > kWarps * kStreamRows)
    return (int)cudaErrorInvalidValue;
  const auto kernel = attention_simt_streamed_kernel<T, kDh>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        crowdmod::allow_dynamic_smem(reinterpret_cast<const void*>(kernel), smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long chunks = (sq + query_rows - 1) / query_rows;
  if (problems > 0x7fffffffLL || chunks > 65535) return (int)cudaErrorInvalidConfiguration;
  kernel<<<dim3((unsigned)problems, (unsigned)chunks), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), heads, sq, sk, query_rows, vec, scale, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (b, h, s)
// for q, k, v and o in that order.  The plan (ops/kernels/attention.py,
// attention_plan): route 1 = "mma" (bf16 only), 0 = "simt"; problems a
// block, warps a block, keys padded (mma: Sk up to a multiple of 16; simt:
// of 4), the query rows of a problem a block covers (Sq, but for the
// streamed simt form), the keys a block holds in shared memory at once (the
// padded keys, or kStreamKeys: the streamed simt form) and the dynamic
// shared memory, which must be the plan's own.  vec:
// the simt route may copy K and V in 16-byte loads (rows 16-byte aligned);
// the mma route needs them so.  Returns a cudaError_t value.
extern "C" int crowdmod_attention(int dtype, const void* q, const void* k, const void* v,
                                  void* o, int batch, int heads, int sq, int sk, int dh,
                                  float scale, const long long* strides, int route,
                                  int per_block, int warps, int keys_padded, int query_rows,
                                  int key_block, int smem, int vec, void* stream) {
  const bool streamed = route == 0 && key_block < sk;
  if (sk < 1 || sq < 0 || batch < 0 || heads < 1 || per_block < 1 ||
      (route != 0 && route != 1) || (route == 1 && (dtype != 1 || sq < 16 || !vec)) ||
      (streamed ? key_block != kStreamKeys : (key_block != keys_padded || query_rows != sq)) ||
      smem > kMaxSmem ||
      smem != smem_bytes(route, dh, sq, sk, per_block, keys_padded, query_rows, key_block))
    return (int)cudaErrorInvalidValue;
  const long long problems = (long long)batch * heads;
  if (problems == 0 || sq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dh == 16)
      return launch_mma<16>(q, k, v, o, heads, sq, sk, problems, per_block, warps, keys_padded,
                            smem, scale, strides, s);
    if (dh == 32)
      return launch_mma<32>(q, k, v, o, heads, sq, sk, problems, per_block, warps, keys_padded,
                            smem, scale, strides, s);
    if (dh == 64)
      return launch_mma<64>(q, k, v, o, heads, sq, sk, problems, per_block, warps, keys_padded,
                            smem, scale, strides, s);
    return (int)cudaErrorInvalidValue;
  }
  if (keys_padded != ((sk + 3) & ~3)) return (int)cudaErrorInvalidValue;
#define CROWDMOD_SIMT(T, DH)                                                                    \
  return streamed ? launch_simt_streamed<T, DH>(q, k, v, o, heads, sq, sk, problems, per_block, \
                                                warps, query_rows, smem, vec, scale, strides, s) \
                  : launch_simt<T, DH>(q, k, v, o, heads, sq, sk, problems, per_block, warps,   \
                                       smem, vec, scale, strides, s)
  if (dtype == 0 && dh == 8) CROWDMOD_SIMT(float, 8);
  if (dtype == 0 && dh == 16) CROWDMOD_SIMT(float, 16);
  if (dtype == 0 && dh == 32) CROWDMOD_SIMT(float, 32);
  if (dtype == 0 && dh == 64) CROWDMOD_SIMT(float, 64);
  if (dtype == 1 && dh == 8) CROWDMOD_SIMT(bf16, 8);
  if (dtype == 1 && dh == 16) CROWDMOD_SIMT(bf16, 16);
  if (dtype == 1 && dh == 32) CROWDMOD_SIMT(bf16, 32);
  if (dtype == 1 && dh == 64) CROWDMOD_SIMT(bf16, 64);
#undef CROWDMOD_SIMT
  return (int)cudaErrorInvalidValue;
}
