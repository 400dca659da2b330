// Stride-1 SAME 3x3x3 convolution for Hopper (sm_90a), channels-last:
//     out[b, t, h, w, :] = bias + sum_{kd, kh, kw, ci} x[b, t+kd-1, h+kh-1,
//                          w+kw-1, ci] * K[kd, kh, kw, ci, :]
// over (B, T, H, W, Cin) -> (B, T, H, W, Cout), f32 accumulation, the bias
// added in f32 before the one rounding to the input type (float or bf16).
// Taps outside the volume read zero: the kernels read the unpadded input and
// test each tap's coordinates, so no padded copy is ever made.
//
// Two entry points, two TPU kernels replaced, both in
// crowdmod_tpu/ops/pallas/conv3d.py:
//
//   crowdmod_conv3d_im2col  <- conv3d_same_im2col (kernel _kernel)
//     An implicit GEMM, M = B*T*H*W positions, N = Cout, K = 27*Cin, with
//     the folded (27*Cin, Cout) weight.  The patch matrix never reaches
//     device memory: each K chunk of patches is copied from the input
//     straight into shared memory, as the TPU kernel builds it in VMEM.
//
//   crowdmod_conv3d_tapgemm <- conv3d_same_tapgemm (kernel _tap_kernel)
//     A block takes R whole output rows of W + 2 padded columns (R = 128 /
//     (W+2) in bf16: 3 rows at W = 36, 6 at 18, 11 at 9) and, for each of
//     the 9 (kd, kh) slabs, multiplies the slab's (R*(W+2)) x Cin rows by
//     the (Cin, 3*Cout_blk) weight with the three kw taps side by side in N;
//     then the shifted accumulate out[w] = Z[w, kw=0] + Z[w+1, kw=1] +
//     Z[w+2, kw=2] runs through shared memory in the epilogue.
//
// What bounds them on the H100.  At batch 64 the UNet's convs do 27*Cin*
// Cout*2 flops a position against (Cin + Cout)*2 bytes (bf16): 300-1,700
// flops a byte, above the card's ridge point, so levels 0 and 1 are bound
// by operations (the bf16 tensor-core rate).  Level 2 (M = 3,456) is bound
// by grid fill: 27 row tiles of 128 positions are a fifth of the 132 SMs.
//
// What the bf16 design does about it (mma.cuh):
//   - Products on the tensor cores: mma.sync m16n8k16 bf16 -> f32, from
//     ldmatrix fragments (B, the row-major weight, through .trans), 8 warps
//     on a BM x BN block tile.  The wrapper's plan picks the tile from the
//     table in launch_im2col_bf16 (BN = 128, 64 or 32 by Cout; BM = 256 for
//     the level-0 64-channel conv, else 128); tap-GEMM takes 128 x 96
//     (3 kw taps x 32 channels).  Registers are capped at 128 a thread so
//     two blocks share a multiprocessor.
//   - A ring of 2-4 K chunks, 32 or 64 deep, in dynamic shared memory
//     (above 48 KB by the attribute), staged by 16-byte cp.async.cg copies:
//     the next chunks are in flight while one is multiplied.  Rows are
//     padded by 8 elements, which puts the rows of an ldmatrix phase in
//     distinct bank groups (no swizzle needed).
//   - A chunk takes kc = 64, 32, 16 or 8 channels (dividing Cin) of one tap,
//     so each A row of a chunk is one contiguous run of channels of one
//     input position, copied as 16-byte pieces by neighbouring threads.  A
//     tap outside the volume is a cp.async with src-size 0, a zero fill,
//     with no branch in the math.  Cin % 8 != 0 (the first conv, Cin = 3)
//     takes element loads into the same tiles over the flat K, 27*Cin for
//     im2col and 9*Cin (all slabs at once) for tap-GEMM, padded with zeros.
//   - Split-K where the grid is thin: the wrapper's plan splits the 27 taps
//     in 9 (by kd, kh) when the tiles alone are under one wave (every
//     level-2 shape: 27 tiles become 243 blocks); each split writes
//     f32 partial tiles to a workspace and a second launch sums them in
//     split order, adds the bias and rounds once: no atomics, so the output
//     is the same bits every run.
//   - The epilogue adds the f32 bias to the accumulators, rounds once and
//     stores pairs of bf16.
// At level 0 the 64->64 conv reaches about 160 TFLOP/s, a sixth of the
// bf16 peak and half of cuDNN's rate.  mma.sync landed rather than wgmma
// (64-row warpgroup tiles read from swizzled shared memory, the card's
// full-rate path): a wgmma version of the 64-deep tiles was built and
// checked, and it was barely faster, because this main loop is bound by
// staging, not by the multiply: each input row is gathered from L2 once
// per tap, 27 times a block.  A halo tile in shared memory (each input row
// read once per block, the taps gathered by ldmatrix row addresses) is the
// design after this one, and wgmma after that.
//
// float32 keeps exact f32 arithmetic on the CUDA cores (the tolerance of
// the f32 checks rules out TF32 at K = 27*256): the SIMT im2col loop of
// common.cuh, a narrow kernel for Cout <= 4 (the final 32->3 conv: a thread
// per output position, its sums in registers, the weight in shared memory)
// in place of a 16-wide tile with 3 live columns, and a SIMT tap-GEMM block
// of 160 rows x 16 channels.
//
// Interface: plain C, loaded with ctypes; launches on the given stream and
// returns cudaGetLastError().

#include "common.cuh"
#include "mma.cuh"

namespace crowdmod {
namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// A chunk of a flat K (Cin % 8 != 0): column kk of the tile is k = k0 + kk,
// element loads, zero past K.  TAPS = 27: im2col's K, (kd, kh, kw, ci);
// TAPS = 9: a tap-GEMM block's K over all its slabs, (kd, kh, ci), with the
// row's own column shift (dw = 0).
template <int BM, int BK, int TAPS>
__device__ __forceinline__ void stage_a_flat(bf16* as, const bf16* __restrict__ x,
                                             const int4* rows, const Geom& g, int cin,
                                             int k0) {
  constexpr int LDA = BK + 8;
  const int kk = threadIdx.x % BK, k = k0 + kk;
  const bool live = k < TAPS * cin;
  const int tap = live ? k / cin : 0, c = k - tap * cin;
  const int dt = TAPS == 27 ? tap / 9 - 1 : tap / 3 - 1;
  const int dh = TAPS == 27 ? tap / 3 % 3 - 1 : tap % 3 - 1;
  const int dw = TAPS == 27 ? tap % 3 - 1 : 0;
#pragma unroll 4
  for (int i = 0; i < BM / (kThreads / BK); ++i) {
    const int r = threadIdx.x / BK + i * (kThreads / BK);
    const long long p = live ? tap_offset(rows[r], dt, dh, dw, g) : -1;
    as[r * LDA + kk] = p >= 0 ? x[p * cin + c] : __float2bfloat16(0.f);
  }
}

template <class Tile>
__global__ void __launch_bounds__(kThreads, kMmaMinBlocks)
conv3d_im2col_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wmat,
                         const float* __restrict__ bias, bf16* __restrict__ out,
                         float* __restrict__ partial, Geom g, int cin, int cout, int kc) {
  constexpr int BM = Tile::BM, BN = Tile::BN, BK = Tile::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ int4 rows[BM];
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
#pragma unroll
  for (int q = 0; q < BM / kBM; ++q) stage_rows(rows + q * kBM, m0 + q * kBM, g);
  __syncthreads();
  const bool bvec = cout % 8 == 0;
  const auto col = [=](int n) { return n0 + n < cout ? n0 + n : -1; };
  float acc[Tile::MI][Tile::NI][4];
  if (kc > 0) {
    // Split blockIdx.z of gridDim.z takes the taps [lo, hi); kc channels of
    // one tap a chunk.
    const int lo = blockIdx.z * 27 / gridDim.z, hi = (blockIdx.z + 1) * 27 / gridDim.z;
    const int cpt = cin / kc;
    Tile::mainloop(
        smem, (hi - lo) * cpt,
        [&](int i, bf16* st) {
          const int chunk = lo * cpt + i, tap = chunk / cpt, c0 = (chunk - tap * cpt) * kc;
          stage_a_rows<BM, BK>(st, x, rows, g, cin, tap / 9 - 1, tap / 3 % 3 - 1,
                               tap % 3 - 1, c0, kc, true);
          stage_b<BN, BK>(st + Tile::A_ELEMS, wmat, (long long)tap * cin + c0, kc, cout,
                          bvec, col);
        },
        [&](int) { return (kc + 15) / 16; }, acc);
  } else {
    const int K = 27 * cin;
    Tile::mainloop(
        smem, (K + BK - 1) / BK,
        [&](int i, bf16* st) {
          const int k0 = i * BK;
          stage_a_flat<BM, BK, 27>(st, x, rows, g, cin, k0);
          stage_b<BN, BK>(st + Tile::A_ELEMS, wmat, k0, min(BK, K - k0), cout, bvec, col);
        },
        [&](int i) { return (min(BK, K - i * BK) + 15) / 16; }, acc);
  }

  const long long total = g.positions();
  const bool pairs = (cout & 1) == 0;
  if (gridDim.z == 1) {
    Tile::for_each_pair(acc, [&](int r, int c, float v0, float v1) {
      const long long m = m0 + r;
      const int n = n0 + c;
      if (m >= total || n >= cout) return;
      bf16* o = out + m * cout + n;
      v0 += bias ? bias[n] : 0.f;
      if (n + 1 < cout) {
        v1 += bias ? bias[n + 1] : 0.f;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16(v0);
          o[1] = __float2bfloat16(v1);
        }
      } else {
        o[0] = __float2bfloat16(v0);
      }
    });
  } else {
    float* ws = partial + (long long)blockIdx.z * total * cout;
    Tile::for_each_pair(acc, [&](int r, int c, float v0, float v1) {
      const long long m = m0 + r;
      const int n = n0 + c;
      if (m >= total || n >= cout) return;
      float* o = ws + m * cout + n;
      if (n + 1 < cout && pairs) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = v0;
        if (n + 1 < cout) o[1] = v1;
      }
    });
  }
}

// out = bias + sum over the splits of the f32 partials, in split order, one
// rounding; V = 4 elements a step where Cout % 4 == 0.
template <int V>
__global__ void __launch_bounds__(kThreads)
splitk_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ bias,
                     bf16* __restrict__ out, long long elems, int cout, int splits) {
  const long long stride = (long long)gridDim.x * kThreads * V;
  for (long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * V; i < elems;
       i += stride) {
    float s[V];
    if constexpr (V == 4) {
      const float4 q = *reinterpret_cast<const float4*>(partial + i);
      s[0] = q.x; s[1] = q.y; s[2] = q.z; s[3] = q.w;
      for (int k = 1; k < splits; ++k) {
        const float4 p = *reinterpret_cast<const float4*>(partial + k * elems + i);
        s[0] += p.x; s[1] += p.y; s[2] += p.z; s[3] += p.w;
      }
    } else {
      s[0] = partial[i];
      for (int k = 1; k < splits; ++k) s[0] += partial[k * elems + i];
    }
    const int n = (int)(i % cout);
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] += bias ? bias[n + v] : 0.f;
    if constexpr (V == 4) {
      store4(out + i, s);
    } else {
      out[i] = __float2bfloat16(s[0]);
    }
  }
}

constexpr int kTapCB = 32;  // output channels of a bf16 tap-GEMM block

template <class Tile>
__global__ void __launch_bounds__(kThreads, kMmaMinBlocks)
conv3d_tapgemm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wtap,
                          const float* __restrict__ bias, bf16* __restrict__ out, Geom g,
                          int cin, int cout, int kc, int rows_per_block) {
  constexpr int BM = Tile::BM, BK = Tile::BK;
  static_assert(Tile::BN == 3 * kTapCB, "three kw taps of kTapCB channels");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ int4 rows[BM];
  const int wp = g.w + 2;
  const long long nrows = (long long)g.batch * g.t * g.h;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const int nr = (int)min((long long)rows_per_block, nrows - r0);
  const int c0 = blockIdx.y * kTapCB;
  // GEMM row m is padded column m % wp of output row m / wp: input position
  // (b, t, h, m % wp - 1), shifted by (dt, dh, 0) for each slab.
  for (int m = threadIdx.x; m < BM; m += kThreads) {
    int4 v = make_int4(-1, 0, 0, 0);
    if (m < nr * wp) {
      long long q = r0 + m / wp;
      const int h = (int)(q % g.h); q /= g.h;
      const int t = (int)(q % g.t);
      v = make_int4((int)(q / g.t), t, h, m % wp - 1);
    }
    rows[m] = v;
  }
  __syncthreads();
  const bool bvec = cout % 8 == 0;
  // Tile column n: kw tap n / 32, output channel c0 + n % 32.
  const auto col = [=](int n) {
    const int co = c0 + n % kTapCB;
    return co < cout ? n / kTapCB * cout + co : -1;
  };
  float acc[Tile::MI][Tile::NI][4];
  if (kc > 0) {
    // kc channels of one slab a chunk, 16-byte copies.
    const int cpt = cin / kc;
    Tile::mainloop(
        smem, 9 * cpt,
        [&](int i, bf16* st) {
          const int slab = i / cpt, ci = (i - slab * cpt) * kc;
          stage_a_rows<BM, BK>(st, x, rows, g, cin, slab / 3 - 1, slab % 3 - 1, 0, ci, kc,
                               true);
          stage_b<3 * kTapCB, BK>(st + Tile::A_ELEMS, wtap, (long long)slab * cin + ci, kc,
                                  3 * cout, bvec, col);
        },
        [&](int) { return (kc + 15) / 16; }, acc);
  } else {
    // Cin % 8 != 0: the 9 slabs' K = 9 * Cin rows of the tap-packed weight
    // taken flat, element loads (the first conv: one chunk, not nine).
    const int K = 9 * cin;
    Tile::mainloop(
        smem, (K + BK - 1) / BK,
        [&](int i, bf16* st) {
          const int k0 = i * BK;
          stage_a_flat<BM, BK, 9>(st, x, rows, g, cin, k0);
          stage_b<3 * kTapCB, BK>(st + Tile::A_ELEMS, wtap, k0, min(BK, K - k0), 3 * cout,
                                  bvec, col);
        },
        [&](int i) { return (min(BK, K - i * BK) + 15) / 16; }, acc);
  }

  // Shifted accumulate of the three kw column groups, through shared memory.
  constexpr int LDZ = 3 * kTapCB + 4;
  static_assert(BM * LDZ * 4 <= Tile::SMEM_BYTES, "Z fits the ring");
  float* z = reinterpret_cast<float*>(smem_raw);
  Tile::for_each_pair(acc, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(z + r * LDZ + c) = make_float2(v0, v1);
  });
  __syncthreads();
  for (int idx = threadIdx.x; idx < nr * g.w * kTapCB; idx += kThreads) {
    const int j = idx % kTapCB, w = (idx / kTapCB) % g.w, r = idx / (kTapCB * g.w);
    const int co = c0 + j;
    if (co >= cout) continue;
    const float* zr = z + (r * wp + w) * LDZ + j;
    const float v = zr[0] + zr[LDZ + kTapCB] + zr[2 * LDZ + 2 * kTapCB] +
                    (bias ? bias[co] : 0.f);
    out[((r0 + r) * g.w + w) * cout + co] = __float2bfloat16(v);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

template <int BN>
__global__ void __launch_bounds__(kThreads)
conv3d_im2col_f32_kernel(const float* __restrict__ x, const float* __restrict__ wmat,
                         const float* __restrict__ bias, float* __restrict__ out, Geom g,
                         int cin, int cout) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) float a_s[kBK * kLdA];
  __shared__ __align__(16) float b_s[kBK * BN];
  __shared__ int4 rows[kBM];
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  stage_rows(rows, m0, g);
  __syncthreads();
  float acc[kTM][TN];
  gemm_mainloop<BN>(Im2colLoad<float>{x, g, cin}, wmat, 27 * cin, cout, n0, rows, a_s, b_s,
                    acc);
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  const long long total = g.positions();
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + tm * kTM + i;
    if (m >= total) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn * TN + j;
      if (n < cout) out[m * cout + n] = acc[i][j] + (bias ? bias[n] : 0.f);
    }
  }
}

// Cout <= 4 (the final conv): a thread per output position, its four sums
// in registers, summed over k = (kd, kh, kw, ci) in order as the loop above
// sums them; the weight rows of `taps_per_pass` taps at a time in shared
// memory, read as broadcasts; four input channels a load (Cin % 4 == 0).
constexpr int kNarrowWeights = 6144;  // floats of weight in shared memory

__global__ void __launch_bounds__(kThreads)
conv3d_narrow_f32_kernel(const float* __restrict__ x, const float* __restrict__ wmat,
                         const float* __restrict__ bias, float* __restrict__ out, Geom g,
                         int cin, int cout) {
  __shared__ __align__(16) float w_s[kNarrowWeights];
  const long long total = g.positions();
  const long long m = (long long)blockIdx.x * kThreads + threadIdx.x;
  int4 row = make_int4(-1, 0, 0, 0);
  if (m < total) {
    long long r = m;
    const int w = (int)(r % g.w); r /= g.w;
    const int h = (int)(r % g.h); r /= g.h;
    const int t = (int)(r % g.t);
    row = make_int4((int)(r / g.t), t, h, w);
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int taps_per_pass = min(27, kNarrowWeights / (cin * 4));
  for (int tap0 = 0; tap0 < 27; tap0 += taps_per_pass) {
    const int nt = min(taps_per_pass, 27 - tap0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt * cin * 4; i += kThreads) {
      const int k = i / 4, n = i % 4;
      w_s[i] = n < cout ? wmat[((long long)tap0 * cin + k) * cout + n] : 0.f;
    }
    __syncthreads();
    for (int tp = 0; tp < nt; ++tp) {
      const int tap = tap0 + tp;
      const long long p = tap_offset(row, tap / 9 - 1, tap / 3 % 3 - 1, tap % 3 - 1, g);
      if (p < 0) continue;
      const float* xr = x + p * cin;
      const float4* wr = reinterpret_cast<const float4*>(w_s + tp * cin * 4);
      for (int c = 0; c < cin; c += 4) {
        const float4 q = *reinterpret_cast<const float4*>(xr + c);
        const float xv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 b = wr[c + v];
          acc[0] = fmaf(xv[v], b.x, acc[0]);
          acc[1] = fmaf(xv[v], b.y, acc[1]);
          acc[2] = fmaf(xv[v], b.z, acc[2]);
          acc[3] = fmaf(xv[v], b.w, acc[3]);
        }
      }
    }
  }
  if (m >= total) return;
#pragma unroll
  for (int n = 0; n < 4; ++n)
    if (n < cout) out[m * cout + n] = acc[n] + (bias ? bias[n] : 0.f);
}

constexpr int kTapM = 160;  // GEMM rows of an f32 tap-GEMM block: R * (W + 2)
constexpr int kTapC = 16;   // output channels of an f32 tap-GEMM block
constexpr int kTapN = 3 * kTapC;

__global__ void __launch_bounds__(kThreads)
conv3d_tapgemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ wtap,
                          const float* __restrict__ bias, float* __restrict__ out, Geom g,
                          int cin, int cout, int rows_per_block) {
  // Main loop: xs [kBK][kTapM] and ws [kBK][kTapN]; epilogue: z
  // [kTapM][kTapN], over the same memory.
  __shared__ __align__(16) float smem[kTapM * kTapN];
  __shared__ int4 rowinfo[kTapM];
  float* xs = smem;
  float* ws = smem + kBK * kTapM;
  const int wp = g.w + 2;
  const long long nrows = (long long)g.batch * g.t * g.h;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const int nr = (int)min((long long)rows_per_block, nrows - r0);
  const int mt = nr * wp;  // live GEMM rows of this block
  const int c0 = blockIdx.y * kTapC;
  for (int r = threadIdx.x; r < rows_per_block; r += kThreads) {
    long long q = r0 + r;
    const int h = (int)(q % g.h); q /= g.h;
    const int t = (int)(q % g.t);
    rowinfo[r] = make_int4(r < nr ? (int)(q / g.t) : -1, t, h, 0);
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const int tmi = tid >> 4, tni = tid & 15;
  const int lk = tid % kBK, lm = tid / kBK;
  float acc[kTapM / 16][kTapN / 16];
#pragma unroll
  for (int i = 0; i < kTapM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kTapN / 16; ++j) acc[i][j] = 0.f;

  for (int slab = 0; slab < 9; ++slab) {
    const int dt = slab / 3 - 1, dh = slab % 3 - 1;
    for (int ci0 = 0; ci0 < cin; ci0 += kBK) {
      const int ci = ci0 + lk;
#pragma unroll
      for (int i = 0; i < kTapM / 16; ++i) {
        const int m = lm + 16 * i;
        float v = 0.f;
        if (ci < cin && m < mt) {
          const int4 r = rowinfo[m / wp];
          const long long p = tap_offset(r, dt, dh, m % wp - 1, g);
          if (p >= 0) v = x[p * cin + ci];
        }
        xs[lk * kTapM + m] = v;
      }
      for (int idx = tid; idx < kBK * kTapN; idx += kThreads) {
        const int kk = idx / kTapN, n = idx % kTapN;
        const int c = ci0 + kk, co = c0 + n % kTapC, tap = n / kTapC;
        ws[idx] = (c < cin && co < cout)
                      ? wtap[((long long)slab * cin + c) * 3 * cout + tap * cout + co]
                      : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[kTapM / 16], b[kTapN / 16];
#pragma unroll
        for (int i = 0; i < kTapM / 16; ++i) a[i] = xs[kk * kTapM + tmi + 16 * i];
#pragma unroll
        for (int j = 0; j < kTapN / 16; ++j) b[j] = ws[kk * kTapN + tni + 16 * j];
#pragma unroll
        for (int i = 0; i < kTapM / 16; ++i)
#pragma unroll
          for (int j = 0; j < kTapN / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // Shifted accumulate of the three kw column groups, through shared memory.
  float* z = smem;
#pragma unroll
  for (int i = 0; i < kTapM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kTapN / 16; ++j)
      z[(tmi + 16 * i) * kTapN + tni + 16 * j] = acc[i][j];
  __syncthreads();
  for (int idx = tid; idx < nr * g.w * kTapC; idx += kThreads) {
    const int j = idx % kTapC, w = (idx / kTapC) % g.w, r = idx / (kTapC * g.w);
    const int co = c0 + j;
    if (co >= cout) continue;
    const float* zr = z + (r * wp + w) * kTapN + j;
    out[((r0 + r) * g.w + w) * cout + co] =
        zr[0] + zr[kTapN + kTapC] + zr[2 * kTapN + 2 * kTapC] + (bias ? bias[co] : 0.f);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

constexpr long long kMaxGridX = 0x7fffffffLL;

// Dynamic shared memory above 48 KB needs the attribute, once per kernel
// and device (allow_dynamic_smem).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return allow_dynamic_smem(reinterpret_cast<const void*>(kernel), bytes);
}

template <class Tile>
int launch_im2col_mma(const void* x, const void* w, const float* bias, void* out,
                      void* workspace, Geom g, int cin, int cout, int kc, int splits,
                      cudaStream_t stream) {
  const auto kernel = conv3d_im2col_mma_kernel<Tile>;
  const cudaError_t attr = allow_smem(kernel, Tile::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const long long mtiles = (g.positions() + Tile::BM - 1) / Tile::BM;
  if (mtiles > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)mtiles, (cout + Tile::BN - 1) / Tile::BN, splits);
  float* partial = static_cast<float*>(workspace);
  bf16* o = static_cast<bf16*>(out);
  kernel<<<grid, kThreads, Tile::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias, o, partial, g, cin,
      cout, kc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long elems = g.positions() * cout;
  const int v = cout % 4 == 0 ? 4 : 1;
  const long long want = (elems / v + kThreads - 1) / kThreads;
  const long long blocks = want < kMaxGridX ? want : kMaxGridX;
  if (v == 4)
    splitk_reduce_kernel<4><<<(unsigned)blocks, kThreads, 0, stream>>>(partial, bias, o,
                                                                       elems, cout, splits);
  else
    splitk_reduce_kernel<1><<<(unsigned)blocks, kThreads, 0, stream>>>(partial, bias, o,
                                                                       elems, cout, splits);
  return (int)cudaGetLastError();
}

// kc = 0 (flat K, element loads) takes any Cin; otherwise 8, 16, 32 or 64
// channels, at most the chunk depth bk, dividing a Cin that is a multiple
// of 8.
bool bad_kc(int cin, int bk, int kc) {
  if (kc == 0) return false;
  return cin % 8 != 0 || (kc != 8 && kc != 16 && kc != 32 && kc != 64) || kc > bk ||
         cin % kc != 0;
}

// The bf16 im2col tiles, X(BM, BN, BK, warps along M, warps along N,
// stages); ops/kernels/conv3d.py's IM2COL_TILES names the same (BM, BN, BK).
#define CROWDMOD_IM2COL_TILES(X) \
  X(128, 32, 32, 4, 2, 4)        \
  X(128, 64, 32, 4, 2, 4)        \
  X(128, 64, 64, 4, 2, 3)        \
  X(256, 64, 64, 4, 2, 2)        \
  X(128, 128, 64, 2, 4, 3)

int launch_im2col_bf16(const void* x, const void* w, const float* bias, void* out,
                       void* workspace, Geom g, int cin, int cout, int bm, int bn, int bk,
                       int kc, int splits, cudaStream_t stream) {
  if (bad_kc(cin, bk, kc) || (splits != 1 && splits != 9) ||
      (splits > 1 && (kc == 0 || workspace == nullptr)))
    return (int)cudaErrorInvalidValue;
#define CROWDMOD_LAUNCH(BM, BN, BK, WM, WN, STAGES)                 \
  if (bm == BM && bn == BN && bk == BK)                             \
    return launch_im2col_mma<MmaTile<BM, BN, BK, WM, WN, STAGES>>(  \
        x, w, bias, out, workspace, g, cin, cout, kc, splits, stream);
  CROWDMOD_IM2COL_TILES(CROWDMOD_LAUNCH)
#undef CROWDMOD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

int launch_im2col_f32(const void* x, const void* w, const float* bias, void* out, Geom g,
                      int cin, int cout, int bm, int bn, int bk, int kc, int splits,
                      cudaStream_t stream) {
  if (bk != kBK || kc != 0 || splits != 1) return (int)cudaErrorInvalidValue;
  const float* xi = static_cast<const float*>(x);
  const float* wi = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  const long long positions = g.positions();
  if ((positions + kBM - 1) / kBM > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  if (bn == 4) {
    if (bm != kThreads || cout > 4 || cin % 4 || cin * 4 > kNarrowWeights)
      return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((positions + kThreads - 1) / kThreads));
    conv3d_narrow_f32_kernel<<<grid, kThreads, 0, stream>>>(xi, wi, bias, o, g, cin, cout);
    return (int)cudaGetLastError();
  }
  if (bm != kBM) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((positions + kBM - 1) / kBM), (cout + bn - 1) / bn);
  if (bn == 64)
    conv3d_im2col_f32_kernel<64><<<grid, kThreads, 0, stream>>>(xi, wi, bias, o, g, cin, cout);
  else if (bn == 32)
    conv3d_im2col_f32_kernel<32><<<grid, kThreads, 0, stream>>>(xi, wi, bias, o, g, cin, cout);
  else if (bn == 16)
    conv3d_im2col_f32_kernel<16><<<grid, kThreads, 0, stream>>>(xi, wi, bias, o, g, cin, cout);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <class Tile>
int launch_tapgemm_mma(const void* x, const void* w, const float* bias, void* out, Geom g,
                       int cin, int cout, int kc, cudaStream_t stream) {
  const int rpb = Tile::BM / (g.w + 2);
  if (rpb < 1) return (int)cudaErrorInvalidValue;
  const auto kernel = conv3d_tapgemm_mma_kernel<Tile>;
  const cudaError_t attr = allow_smem(kernel, Tile::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = ((long long)g.batch * g.t * g.h + rpb - 1) / rpb;
  if (blocks > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (cout + kTapCB - 1) / kTapCB);
  kernel<<<grid, kThreads, Tile::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias, static_cast<bf16*>(out),
      g, cin, cout, kc, rpb);
  return (int)cudaGetLastError();
}

// The bf16 tap-GEMM tiles by K chunk: 128 rows x (3 kw taps x 32 channels).
template <int BK>
using TapTile = MmaTile<128, 3 * kTapCB, BK, 4, 2, BK == 32 ? 4 : 3>;

int launch_tapgemm_bf16(const void* x, const void* w, const float* bias, void* out, Geom g,
                        int cin, int cout, int bk, int kc, cudaStream_t stream) {
  if (bad_kc(cin, bk, kc)) return (int)cudaErrorInvalidValue;
  if (bk == 32) return launch_tapgemm_mma<TapTile<32>>(x, w, bias, out, g, cin, cout, kc, stream);
  if (bk == 64) return launch_tapgemm_mma<TapTile<64>>(x, w, bias, out, g, cin, cout, kc, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_tapgemm_f32(const void* x, const void* w, const float* bias, void* out, Geom g,
                       int cin, int cout, int bk, int kc, cudaStream_t stream) {
  const int rpb = kTapM / (g.w + 2);
  if (rpb < 1 || bk != kBK || kc != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)g.batch * g.t * g.h + rpb - 1) / rpb;
  if (blocks > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (cout + kTapC - 1) / kTapC);
  conv3d_tapgemm_f32_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias,
      static_cast<float*>(out), g, cin, cout, rpb);
  return (int)cudaGetLastError();
}

bool bad_shape(int batch, int t, int h, int w, int cin, int cout) {
  return batch < 0 || t < 0 || h < 0 || w < 0 || cin < 1 || cout < 1;
}

}  // namespace
}  // namespace crowdmod

// dtype: 0 = float32, 1 = bfloat16.  x: (batch, t, h, w, cin) contiguous;
// w: the folded (27*cin, cout) weight, rows (kd, kh, kw, ci); bias: (cout,)
// float32 or null; out: (batch, t, h, w, cout).  The tile plan: bm x bn, a
// block's output positions x channels, and bk, its K chunk (bf16: one of
// the tiles listed in launch_im2col_bf16; float32: 128 x 64, 32 or 16 by 16,
// or 256 x 4 for the narrow kernel, cout <= 4); kc, the channels of
// one tap a K chunk takes (0: the flat K; float32 takes only 0); splits, 1
// or 9 (bf16 with kc > 0 only), with workspace a float32 (splits,
// batch*t*h*w, cout) buffer when splits > 1.  Returns a cudaError_t value.
extern "C" int crowdmod_conv3d_im2col(int dtype, const void* x, const void* w,
                                      const void* bias, void* out, void* workspace,
                                      int batch, int t, int h, int wd, int cin, int cout,
                                      int bm, int bn, int bk, int kc, int splits,
                                      void* stream) {
  if (crowdmod::bad_shape(batch, t, h, wd, cin, cout)) return (int)cudaErrorInvalidValue;
  const crowdmod::Geom g{batch, t, h, wd};
  if (g.positions() == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0)
    return crowdmod::launch_im2col_f32(x, w, b, out, g, cin, cout, bm, bn, bk, kc, splits, s);
  if (dtype == 1)
    return crowdmod::launch_im2col_bf16(x, w, b, out, workspace, g, cin, cout, bm, bn, bk, kc,
                                        splits, s);
  return (int)cudaErrorInvalidValue;
}

// As above, with w the tap-packed (9, cin, 3*cout) weight: slab kd*3 + kh,
// column kw*cout + co.  bk: the K chunk (bf16: 32 or 64; float32: 16); kc
// as above; bf16 takes w + 2 <= 128, float32 w + 2 <= 160.
extern "C" int crowdmod_conv3d_tapgemm(int dtype, const void* x, const void* w,
                                       const void* bias, void* out, int batch, int t, int h,
                                       int wd, int cin, int cout, int bk, int kc,
                                       void* stream) {
  if (crowdmod::bad_shape(batch, t, h, wd, cin, cout)) return (int)cudaErrorInvalidValue;
  const crowdmod::Geom g{batch, t, h, wd};
  if (g.positions() == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) return crowdmod::launch_tapgemm_f32(x, w, b, out, g, cin, cout, bk, kc, s);
  if (dtype == 1) return crowdmod::launch_tapgemm_bf16(x, w, b, out, g, cin, cout, bk, kc, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a bf16 block, in bytes: impl 0 is im2col's tile
// bm x bn x bk, impl 1 tap-GEMM's 128 x 96 x bk; -1 for a tile not built.
extern "C" int crowdmod_conv3d_smem_bytes(int impl, int bm, int bn, int bk) {
  using namespace crowdmod;
#define CROWDMOD_SMEM(BM, BN, BK, WM, WN, STAGES)          \
  if (impl == 0 && bm == BM && bn == BN && bk == BK)       \
    return MmaTile<BM, BN, BK, WM, WN, STAGES>::SMEM_BYTES;
  CROWDMOD_IM2COL_TILES(CROWDMOD_SMEM)
#undef CROWDMOD_SMEM
  if (impl != 1 || bm != 128 || bn != 3 * kTapCB) return -1;
  return bk == 32 ? TapTile<32>::SMEM_BYTES : bk == 64 ? TapTile<64>::SMEM_BYTES : -1;
}
