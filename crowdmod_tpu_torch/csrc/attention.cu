// Fused multi-head attention for Hopper (sm_90a):
//     out = softmax(scale * Q K^T) V      over (B, H, S, Dh) problems.
//
// Replaces the TPU kernel crowdmod_tpu/ops/pallas/attention.py
// (_attention_pallas, kernel _attn_kernel).  Same contract: logits and the
// softmax in f32, the weights normalised and then cast to V's type before
// the product with V, that product accumulated in f32, the output written
// in the input type.  Q K^T, the softmax and the product with V happen in
// this one kernel; the logits never reach device memory.  Every sum runs
// in a fixed order, so a second call gives the same bits.
//
// What bounds it on the H100: bytes, and up to 64 keys the latency of a
// call.  At the serving shapes one call is hundreds to thousands of tiny
// problems (batch 64: the DiT's spatial 512 problems of 27x64x27 and
// temporal 6912 of 1x64x2, the UNet's level-2 256 of 54x32x54), a few
// flops per byte of Q, K, V and O, far below the card's ridge point, and
// 3.5 to 7 MB a call: 1-2 us at 3.35 TB/s.  The routes that took these
// shapes before (a block copying all its problems by cp.async, then
// computing with expf and IEEE divisions, then storing) ran 7-10 us at
// batch 64 and as long at batch 1: one block's serial chain, not bytes.
//
// Five routes, picked by the wrapper's plan (ops/kernels/attention.py,
// attention_plan) and passed in as ints:
//
//   "row" (bf16, at most kRowKeys = 8 keys and 8 queries: the DiT's
//   temporal attention, one query against two keys; ETHUCY's 6 tokens).  A
//   16-row tensor-core tile would be 15/16 waste at one query, and a lane a
//   key (the simt route) leaves 30 of 32 lanes idle at two keys and stages
//   K and V through shared memory as f32.  Here a group of Dh / 8 lanes
//   takes a query row: each lane loads its 16 bytes of the query row and of
//   every key and value row straight into registers, all of them issued
//   before the first product, so a lane has up to 17 loads in flight and
//   nothing waits on shared memory.  The arithmetic is the simt route's,
//   operation for operation, so the output is its bits: a logit sums the
//   products in the order of Dh (each lane adds its eight onto the running
//   sum it takes from the lane before by a shuffle: Dh / 8 steps a key, the
//   keys' chains side by side), then the softmax in f32 (expf, the simt
//   route's order of the sum, IEEE division), the weights rounded to bf16,
//   the output accumulated in f32 and stored as one 16-byte write a lane.
//   At these shapes the contract's two roundings to bf16 (the weights, the
//   output), not the kernel, set the error against an f32 reference: up to
//   about 0.026 where |out| reaches 4, over the checks' 2e-2, so a weight
//   rounded the other way than the simt route rounds it can tip a case
//   over; keeping the simt route's bits keeps every case where it stood.  Several
//   rows a warp (8 at Dh 32, 4 at Dh 64), 4 warps a block: the grid covers
//   the card several times over.
//
//   "tile" (bf16, up to 64 keys at Dh 16, 32 and 64: the DiT's spatial
//   attention, the UNet's level 2, the geometries' 15 to 56 tokens).  A
//   persistent grid, two CTAs a multiprocessor, each walking its share of
//   the work items (a problem's query rows, up to 64, against all its
//   keys).  Lane 0 of a producer warp keeps a stage a team full by TMA
//   (each team owns its stages, see the kernel): Q, K and V of an item through 4-D tensor maps over the
//   caller's strides (the packed projections read in place) into 128-,
//   64- or 32-byte swizzled boxes, under the stage's mbarrier; TMA's zero
//   fill pads the keys to a multiple of 16 and the queries to whole tiles,
//   so no thread copies or clears anything, and the padded keys get a -inf
//   logit.  8 // tiles teams of tiles consumer warps (a warp a 16-row query
//   tile) take the items in turn, so the other teams' loads fly while one
//   team computes.  The products are mma.sync m16n8k16 (mma.cuh)
//   fed by ldmatrix of the swizzled boxes: S = Q K^T with K in [key][d]
//   rows as the col-major B operand, the row max and sum over each quad of
//   lanes, exp2 of base-2 logits, the weights e * (1 / l) rounded to bf16
//   in the accumulator layout, which is the A layout of W V, V through
//   ldmatrix.trans.  mma.sync and not wgmma: a 16-row tile wastes at most
//   15 rows where wgmma's 64-row tile would compute 37 of 64 rows for
//   nothing at 27 queries and 58 at 6, each warp runs its tile alone with
//   no warpgroup barrier, and at about 95 MFLOP a call the tensor cores'
//   rate is not the limit.  A warp releases its stage once its last
//   ldmatrix has read it, writes its output tile into its own swizzled
//   staging box and stores it by TMA (rows past Sq clipped by the map),
//   then goes on to its next item while the store drains.
//
//   "wgmma" (bf16, Sq >= 16, Dh 32 or 64, 65 to 448 keys: FM-DiT's joint
//   attention over 216, 336 or 432 tokens).  Past 64 keys the mma route
//   below recomputes every logit block in a second sweep and copies a
//   whole problem before its first product; at FM-DiT's 216 tokens it took
//   3x SDPA's time.  Here a CTA takes one problem, so its K and V cross
//   device memory once: one warpgroup up to 224 keys, two past that, each
//   holding half of them.  Thread 0 issues the copies by TMA through 4-D
//   tensor maps (as the tile route's): query tile 0, K, V, query tile 1,
//   each under an mbarrier, into 128- (Dh 64) or 64-byte (Dh 32) swizzled
//   boxes; the query tiles cycle through two slots.  Per 64-row query tile:
//   S = Q K^T by one wgmma m64nNk16 a k16 step, N the warpgroup's NK keys
//   (at most 224: 112 f32 a thread), Q as register A fragments (ldmatrix of
//   its box), K as the K-major B operand as it stands; the logits stay in
//   registers, so the softmax is one pass and nothing is recomputed.  Two
//   warpgroups exchange each row's max and sum (rescaled to the common max,
//   added in warpgroup order: the same bits in both) through shared memory.
//   The weights are normalised in f32 and rounded to bf16 as the contract
//   rounds them, and go as register A fragments into O = W V (wgmma
//   m64nDHk16, V the MN-major B operand); the next tile's S is issued under
//   it.  Two warpgroups split the output's columns: each adds the other's
//   partial of its half and stores it.  (A cluster of two one-warpgroup
//   CTAs exchanging through distributed shared memory instead took 1.7x as
//   long at 432 keys: its cluster barriers.)
//
//   "mma" (bf16, Sq >= 16, past 64 keys where the wgmma route does not
//   apply: Dh 16, or Dh 32 past 448 keys while a problem fits shared
//   memory): the FlashAttention-2 register layout on the tensor cores
//   (mma.cuh).  A block takes whole (b, h) problems and copies their Q, K
//   and V rows into shared memory as bf16, in 16-byte cp.async pieces read
//   through the caller's strides; rows are padded by 8 elements
//   (conflict-free ldmatrix) and keys past Sk are zero-filled up to a
//   multiple of 16.  Each warp owns a 16-row query tile of one problem.
//   The keys go in blocks of 64 in two sweeps: the row max and sum,
//   rescaled online, then each block's logits again, its normalised
//   weights (rounded to bf16, in registers as A fragments) and their
//   product with V (ldmatrix.trans).  The plan takes this route only while
//   a problem's Q, K and V fit in shared memory; past that, bf16 takes
//   "simt".
//
//   "simt" (f32, Dh 8, and the bf16 problems no route above takes): the
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
// 64}, the wgmma route Dh in {32, 64}, the row, tile and mma routes Dh in
// {16, 32, 64} (their k-slices are 16 deep and their loads 16 bytes; under
// Dh 32 a simt lane past Dh owns no output element: the UNet's attention
// at a base width of 16, 4 heads of 8); Sk >= 1; the plan's shared memory
// at most 227 KB.  The last dimension of each tensor must be contiguous;
// the other three strides are arguments, so the caller's (B, S, H, Dh)
// projections are read in place.  Every route but simt needs 16-byte
// aligned rows (base address and strides).
//
// Interface: plain C, loaded with ctypes; launches on the given stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
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
  extern __shared__ __align__(1024) unsigned char smem_raw[];
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

    // Sweep 1: the row max and sum over the key blocks, rescaled online.
    float s[NT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const auto ksteps = [&](int kb) { return (min(kKeyBlock, sk - kb) + 15) / 16; };
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
// bf16, more than 64 keys: warpgroups on wgmma, K and V staged by TMA
// ---------------------------------------------------------------------------

constexpr int kWgTile = 64;  // query rows a warpgroup's tile
constexpr int kKeyBox = 32;  // keys a TMA box of K or V

struct WgArgs {
  bf16* o;
  Strides os;
  int heads, sq, sk;
  int tiles;        // 64-row query tiles of a problem
  int s_dim[3];     // q, k, v: the map dimension (1 or 2) of S; H is the other
  float scale_log2;  // scale * log2(e): logits in base-2 units
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One (b, h) problem a CTA of KS warpgroups (1 or 2), warpgroup w holding
// the logits of NK keys (w NK .. w NK + NK - 1) of a 64-row query tile in
// registers; the warpgroups walk the problem's query tiles together and,
// with two, exchange each row's max and sum, then half of their partial
// outputs, through shared memory.  Thread 0 issues the copies by TMA: query
// tile 0, K, V, query tile 1, each under an mbarrier; tile t + 2 into tile
// t's slot once tile t's fragments are loaded.
template <int DH, int NK, int KS>
__global__ void __launch_bounds__(128 * KS, KS == 1 ? 2 : 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const WgArgs a) {
  using namespace crowdmod::hopper;
  constexpr int RB = DH * 2;         // bytes of a row of Q, K or V
  constexpr int QBOX = kWgTile * RB;  // a query tile
  constexpr int KBOX = kKeyBox * RB;  // a box of keys
  constexpr int NB = KS * NK / kKeyBox;  // key boxes of K (and V)
  constexpr int NC = NK / 32;        // 32-key chunks of the logits
  constexpr int KD = DH / 16;        // k16 steps of Q K^T
  constexpr int KV = NK / 16;        // k16 steps of W V
  constexpr int ON = DH / 2;         // f32 output values a thread
  constexpr int XO = ON / 2;         // of them, the half handed over (KS 2)
  constexpr uint32_t SBO = 8 * RB;   // eight rows
  static_assert(DH == 32 || DH == 64, "head dims 32 and 64");
  static_assert(NK % 32 == 0 && NK <= 224 && (KS == 1 || KS == 2), "keys a warpgroup holds");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = base;               // NB boxes of K
  unsigned char* vs = ks + NB * KBOX;     // NB boxes of V
  unsigned char* qs = vs + NB * KBOX;     // 2 query tiles
  // KS 2: each warpgroup's half for the other (XO values a thread), then
  // the row statistics [wg][thread][(max, sum) x 2 rows].
  float* xo = reinterpret_cast<float*>(qs + 2 * QBOX);
  float* red = xo + (KS == 2 ? 2 * XO * 128 : 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + (KS == 2 ? 2 * 128 * 4 : 0));
  uint64_t* k_full = bars;
  uint64_t* v_full = bars + 1;
  uint64_t* q_full = bars + 2;  // 2 slots

  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid & 31;
  const int key0 = wg * NK;  // this warpgroup's first key
  // Coordinates (d, S or H, H or S, B) of row s0 of tensor i's map.
  const auto load = [&](const CUtensorMap* map, int i, void* dst, uint64_t* bar, int s0) {
    if (a.s_dim[i] == 1)
      tma_load_4d(dst, map, bar, 0, s0, h, b);
    else
      tma_load_4d(dst, map, bar, 0, h, s0, b);
  };
  const auto load_q = [&](int t) {
    mbar_arrive_expect_tx(&q_full[t & 1], QBOX);
    load(&qmap, 0, qs + (t & 1) * QBOX, &q_full[t & 1], t * kWgTile);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    load_q(0);
    mbar_arrive_expect_tx(k_full, NB * KBOX);
    for (int j = 0; j < NB; ++j) load(&kmap, 1, ks + j * KBOX, k_full, j * kKeyBox);
    mbar_arrive_expect_tx(v_full, NB * KBOX);
    for (int j = 0; j < NB; ++j) load(&vmap, 2, vs + j * KBOX, v_full, j * kKeyBox);
    if (a.tiles > 1) load_q(1);
  }

  const uint32_t k_addr = smem_u32(ks) + key0 * RB, v_addr = smem_u32(vs) + key0 * RB;
  float s[NK / 2];  // the logits: 32-key chunk c at s[16 c], m64n32's layout
  float o[ON];
  const auto fence_s = [&]() {
#pragma unroll
    for (int e = 0; e < NK / 2; ++e) fence_operand(s[e]);
  };
  const auto fence_o = [&]() {
#pragma unroll
    for (int e = 0; e < ON; ++e) fence_operand(o[e]);
  };

  // S = Q K^T of tile t: the query tile as register A fragments (ldmatrix
  // of the swizzled box), K as the K-major B operand, all NK keys an
  // instruction a k16 step; issued, not waited for.  Then the tile's slot
  // takes tile t + 2.
  const auto issue_s = [&](int t) {
    mbar_wait(&q_full[t & 1], (t >> 1) & 1);
    uint32_t qf[KD][4];
    const uint32_t q_addr = smem_u32(qs + (t & 1) * QBOX);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldsm_x4(qf[kk], q_addr + swizzle_chunk<RB>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int e = 0; e < NK / 2; ++e) s[e] = 0.f;
    fence_s();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      wgmma_m64nNk16_rs_kmajor<NK>(s, qf[kk], desc_sw<RB>(k_addr + kk * 32, 16, SBO));
    wgmma_commit();
    __syncthreads();  // every warp's fragments of tile t are loaded
    if (threadIdx.x == 0 && t + 2 < a.tiles) load_q(t + 2);
  };

  // Each tile: its S has been issued; the softmax; W V issued, then the
  // next tile's S issued under it; W V's wait, then (KS 2) the exchange,
  // and the stores, while the next S runs.
  mbar_wait(k_full, 0);
  issue_s(0);
  for (int tile = 0; tile < a.tiles; ++tile) {
    wgmma_wait<0>();
    fence_s();

    // The softmax in f32, in registers: logits in base-2 units, -inf past
    // the keys (only the chunks that reach past them test); each row's max
    // and sum over four partial chains and its quad of lanes.  Rows 16
    // warp + lane / 4 and + 8.
    const int live = a.sk - key0;  // this warpgroup's keys before the end
    float mp[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mp[i][j] = -INFINITY;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float* sc = s + 16 * c;
      if (32 * c + 32 <= live) {
#pragma unroll
        for (int e = 0; e < 16; ++e) sc[e] *= a.scale_log2;
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int key = 32 * c + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
          sc[e] = key < live ? sc[e] * a.scale_log2 : -INFINITY;
        }
      }
#pragma unroll
      for (int e = 0; e < 16; ++e)
        mp[(e >> 1) & 1][e >> 2] = fmaxf(mp[(e >> 1) & 1][e >> 2], sc[e]);
    }
    float m[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      m[i] = quad_max(fmaxf(fmaxf(mp[i][0], mp[i][1]), fmaxf(mp[i][2], mp[i][3])));
    float lp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int e = 0; e < NK / 2; ++e) {
      const float x = ex2(s[e] - m[(e >> 1) & 1]);
      s[e] = x;
      lp[(e >> 1) & 1][(e >> 2) & 3] += x;
    }
    float l[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = quad_sum((lp[i][0] + lp[i][1]) + (lp[i][2] + lp[i][3]));
    // Each row's weights e / l in f32: with two warpgroups, the max m over
    // both, l = l0 2^(m0 - m) + l1 2^(m1 - m) in warpgroup order (the same
    // bits in both), and this warpgroup's e scaled by 2^(m_w - m) / l.
    float r[2];
    if constexpr (KS == 2) {
      reinterpret_cast<float4*>(red)[wg * 128 + tid] = make_float4(m[0], l[0], m[1], l[1]);
      __syncthreads();
      const float4 s0 = reinterpret_cast<const float4*>(red)[tid];
      const float4 s1 = reinterpret_cast<const float4*>(red)[128 + tid];
      const float m0[2] = {s0.x, s0.z}, l0[2] = {s0.y, s0.w};
      const float m1[2] = {s1.x, s1.z}, l1[2] = {s1.y, s1.w};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mx = fmaxf(m0[i], m1[i]);
        const float tot = l0[i] * ex2(m0[i] - mx) + l1[i] * ex2(m1[i] - mx);
        r[i] = ex2(m[i] - mx) * __frcp_rn(tot);
      }
    } else {
      r[0] = __frcp_rn(l[0]);
      r[1] = __frcp_rn(l[1]);
    }

    // O = W V: the weights rounded to bf16 as register A fragments (the
    // accumulator layout of S is the A layout of 16 keys), all packed
    // before the first product so no instruction between two wgmmas
    // writes a register one of them reads; V as the MN-major B operand,
    // 16 keys an instruction.
    uint32_t wf[KV][4];
#pragma unroll
    for (int kk = 0; kk < KV; ++kk) {
      const float* w = s + 8 * kk;
      wf[kk][0] = pack_bf16(w[0] * r[0], w[1] * r[0]);
      wf[kk][1] = pack_bf16(w[2] * r[1], w[3] * r[1]);
      wf[kk][2] = pack_bf16(w[4] * r[0], w[5] * r[0]);
      wf[kk][3] = pack_bf16(w[6] * r[1], w[7] * r[1]);
    }
    if (tile == 0) mbar_wait(v_full, 0);
#pragma unroll
    for (int e = 0; e < ON; ++e) o[e] = 0.f;
    fence_o();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KV; ++kk) {
      const uint64_t dv = desc_sw<RB>(v_addr + 16 * kk * RB, 8192, SBO);
      if constexpr (DH == 64)
        wgmma_m64n64k16_rs(o, wf[kk], dv);
      else
        wgmma_m64n32k16_rs<1>(o, wf[kk], dv);
    }
    wgmma_commit();
    if (tile + 1 < a.tiles) {
      issue_s(tile + 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_o();

    // The stores: with two warpgroups, warpgroup w stores half w of the
    // columns after adding the other's partial of that half (own + other:
    // the same bits whichever adds).  o[4 j + e] is column 8 j + 2 (lane %
    // 4) + (e & 1): half 0 is o[0 .. XO), half 1 o[XO .. ON).
    // (Selects, not o[wg * XO + e]: an index the compiler cannot fold
    // would put o in local memory.)
    int j0 = 0, j1 = DH / 8;
    if constexpr (KS == 2) {
#pragma unroll
      for (int e = 0; e < XO; ++e) xo[(wg * XO + e) * 128 + tid] = wg ? o[e] : o[XO + e];
      __syncthreads();
#pragma unroll
      for (int e = 0; e < XO; ++e) {
        const float other = xo[((wg ^ 1) * XO + e) * 128 + tid];
        if (wg)
          o[XO + e] += other;
        else
          o[e] += other;
      }
      j0 = wg * DH / 16;
      j1 = j0 + DH / 16;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = tile * kWgTile + warp * 16 + (lane >> 2) + 8 * half;
      if (row >= a.sq) continue;
      bf16* orow = a.o + b * a.os.b + h * a.os.h + row * a.os.s + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        if (j >= j0 && j < j1)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, up to 64 keys: persistent CTAs, a TMA ring, mma.sync tiles
// ---------------------------------------------------------------------------

constexpr int kTileConsumers = 8;                       // consumer warps a CTA, at most
constexpr int kTileThreads = 32 * (1 + kTileConsumers);  // and the producer warp
constexpr int kTileKeys = 64;                           // keys a work item, at most
constexpr int kTileRows = 64;                           // query rows a work item, at most

struct TileArgs {
  int heads, sq, sk;
  int items, chunks;  // work items: problems x chunks of `rows` query rows
  int rows;           // query rows of an item's Q box: tiles x 16
  int keys;           // rows of its K and V boxes: Sk up to a multiple of 16
  int tiles, teams, stages;
  int s_dim[4];       // q, k, v, o: the map dimension (1 or 2) of S
  float scale_log2;   // scale * log2(e)
};

// CTA c walks the work items c, c + grid, c + 2 grid, ...: its k-th in
// stage k % stages of a ring in shared memory, computed by team k % teams
// (`tiles` consumer warps, one a 16-row query tile).  Lane 0 of warp 0
// keeps the ring full: Q, K and V of an item by TMA under the stage's
// `full` barrier, once the team that used the stage last has arrived on
// its `empty` one.  Each consumer warp writes its output tile into its own
// swizzled staging box and stores it by TMA (rows past Sq clipped by the
// map), then goes on to its next item while the store drains.  `stages` is
// a multiple of `teams`, so stage s serves team s % teams alone, which
// waits for each of its phases in turn: a wait on a phase's parity is then
// unambiguous.  Were a stage shared by teams, a team could wait on it while
// the load of the item before its own (another team's) was still in flight
// (TMA loads land in any order), see that phase's parity as its own and
// read the other item's rows, or wait on a phase that never comes.
template <int DH>
__global__ void __launch_bounds__(kTileThreads, 2)
attention_tile_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap, const TileArgs a) {
  using namespace crowdmod::hopper;
  constexpr int RB = 2 * DH;     // bytes of a row of Q, K, V or O
  constexpr int KS = DH / 16;    // k16 slices of Dh
  constexpr int DN = DH / 8;     // 8-wide n tiles of the output
  constexpr int NT = kTileKeys / 8;
  static_assert(DH == 16 || DH == 32 || DH == 64, "head dims 16, 32 and 64");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int stage_bytes = (a.rows + 2 * a.keys) * RB;
  const int consumers = a.teams * a.tiles;
  unsigned char* staging = ring + a.stages * stage_bytes;  // 16 rows a consumer warp
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + consumers * 16 * RB);
  uint64_t* empty = full + a.stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grid = gridDim.x;
  // Coordinates (d, S or H, H or S, B) of row s0 of tensor i's map.
  const auto coords = [&](int i, int s0, int h, int b, int (&c)[4]) {
    c[0] = 0;
    c[1] = a.s_dim[i] == 1 ? s0 : h;
    c[2] = a.s_dim[i] == 1 ? h : s0;
    c[3] = b;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], a.tiles);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 0) {
    if (lane == 0) {
      prefetch_tensor_map(&qmap);
      prefetch_tensor_map(&kmap);
      prefetch_tensor_map(&vmap);
      prefetch_tensor_map(&omap);
      int k = 0;
      for (int item = blockIdx.x; item < a.items; item += grid, ++k) {
        const int s = k % a.stages;
        if (k >= a.stages) mbar_wait(&empty[s], (k / a.stages - 1) & 1);
        const int p = item / a.chunks, ch = item % a.chunks;
        const int b = p / a.heads, h = p % a.heads;
        unsigned char* st = ring + s * stage_bytes;
        int c[4];
        mbar_arrive_expect_tx(&full[s], stage_bytes);
        coords(0, ch * a.rows, h, b, c);
        tma_load_4d(st, &qmap, &full[s], c[0], c[1], c[2], c[3]);
        coords(1, 0, h, b, c);
        tma_load_4d(st + a.rows * RB, &kmap, &full[s], c[0], c[1], c[2], c[3]);
        coords(2, 0, h, b, c);
        tma_load_4d(st + (a.rows + a.keys) * RB, &vmap, &full[s], c[0], c[1], c[2], c[3]);
      }
    }
    return;
  }

  const int cw = warp - 1;
  if (cw >= consumers) return;
  const int team = cw / a.tiles, qt = cw % a.tiles;
  const int g = lane >> 2, t = lane & 3;
  const int ksteps = a.keys / 16;
  unsigned char* stg = staging + cw * 16 * RB;
  int k = team;
  for (int item = blockIdx.x + team * grid; item < a.items; item += a.teams * grid, k += a.teams) {
    const int s = k % a.stages;
    mbar_wait(&full[s], (k / a.stages) & 1);
    const uint32_t qa = smem_u32(ring + s * stage_bytes);
    const uint32_t ka = qa + a.rows * RB, va = ka + a.keys * RB;

    // S = Q K^T: the query tile as A fragments, K in [key][d] rows as the
    // col-major B operand as it stands (ldmatrix of the swizzled boxes).
    uint32_t qf[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldsm_x4(qf[kk], qa + swizzle_chunk<RB>(qt * 16 + (lane & 15), 2 * kk + (lane >> 4)));
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (np >= ksteps) break;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t r[4];
        ldsm_x4(r, ka + swizzle_chunk<RB>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                          2 * kk + ((lane >> 3) & 1)));
        crowdmod::mma_bf16_16816(sc[2 * np], qf[kk], r[0], r[1]);
        crowdmod::mma_bf16_16816(sc[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }

    // The softmax in f32, in registers: logits in base-2 units, -inf on the
    // keys TMA padded with zeros; rows g and g + 8, each over its quad.
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= 2 * ksteps) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = nt * 8 + 2 * t + (e & 1);
        const float x = key < a.sk ? sc[nt][e] * a.scale_log2 : -INFINITY;
        sc[nt][e] = x;
        m[e >> 1] = fmaxf(m[e >> 1], x);
      }
    }
    float l[2] = {0.f, 0.f};
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= 2 * ksteps) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = ex2(sc[nt][e] - m[e >> 1]);
        sc[nt][e] = x;
        l[e >> 1] += x;
      }
    }
    const float r0 = __frcp_rn(quad_sum(l[0])), r1 = __frcp_rn(quad_sum(l[1]));

    // O = W V: the weights e / l rounded to bf16 as A fragments (two n
    // tiles of S are the A layout of 16 keys), V through ldmatrix.trans.
    float o[DN][4];
#pragma unroll
    for (int nd = 0; nd < DN; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (kk >= ksteps) break;
      const uint32_t w[4] = {pack_bf16(sc[2 * kk][0] * r0, sc[2 * kk][1] * r0),
                             pack_bf16(sc[2 * kk][2] * r1, sc[2 * kk][3] * r1),
                             pack_bf16(sc[2 * kk + 1][0] * r0, sc[2 * kk + 1][1] * r0),
                             pack_bf16(sc[2 * kk + 1][2] * r1, sc[2 * kk + 1][3] * r1)};
#pragma unroll
      for (int nd = 0; nd < DN; nd += 2) {
        uint32_t r[4];
        ldsm_x4_trans(r, va + swizzle_chunk<RB>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                nd + (lane >> 4)));
        crowdmod::mma_bf16_16816(o[nd], w, r[0], r[1]);
        crowdmod::mma_bf16_16816(o[nd + 1], w, r[2], r[3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the stage is read: the producer may refill it

    // The store: the tile into the warp's staging box (the map's swizzle),
    // then one TMA store, rows past Sq clipped.
    const int p = item / a.chunks;
    const int row0 = (item % a.chunks) * a.rows + qt * 16;
    if (row0 < a.sq) {
      if (lane == 0) bulk_wait_read<0>();  // the last store has read the box
      __syncwarp();
#pragma unroll
      for (int nd = 0; nd < DN; ++nd)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<__nv_bfloat162*>(stg + swizzle_chunk<RB>(g + 8 * i, nd) + 4 * t) =
              __floats2bfloat162_rn(o[nd][2 * i], o[nd][2 * i + 1]);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        int c[4];
        coords(3, row0, p % a.heads, p / a.heads, c);
        tma_store_4d(&omap, stg, c[0], c[1], c[2], c[3]);
        bulk_commit();
      }
    }
  }
  if (lane == 0) bulk_wait_read<0>();  // the CTA's shared memory outlives its stores' reads
}

// ---------------------------------------------------------------------------
// bf16, a few keys: a group of Dh / 8 lanes a query row
// ---------------------------------------------------------------------------

constexpr int kRowKeys = 8;  // keys the row route holds in registers
static_assert(kRowKeys == 8, "the row route's sum of the keys is written out for 8");

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Lane i of a group holds elements 8 i .. 8 i + 7 of its row of Q, of each
// of the SK keys and of each value, every one a 16-byte load straight into
// registers, all of them issued before the first product.  The arithmetic
// is the simt route's, operation for operation, so the two give the same
// bits: a logit is the products summed in the order of Dh (each lane adds
// its eight onto the running sum it takes from the lane before, by
// shuffles; SK a template argument, so the keys' chains interleave with no
// branch between them), then times the scale; exp of the logit less the
// row's max; the sum over the keys in the simt route's butterfly order; the
// weights e / l rounded to bf16; the products with V added in key order.
template <int DH, int SK>
__global__ void __launch_bounds__(256)
attention_row_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int heads, int sq,
                     long long rows, float scale, Strides qs, Strides ks, Strides vs,
                     Strides os) {
  constexpr int L = DH / 8;     // lanes a query row
  constexpr int RPW = 32 / L;   // query rows a warp
  static_assert(SK >= 1 && SK <= kRowKeys, "keys the row route holds");
  const int lane = threadIdx.x & 31, sub = lane % L;
  const long long r0 =
      ((long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) * RPW + lane / L;
  const bool live = r0 < rows;
  const long long r = live ? r0 : rows - 1;  // past the end: a live row's loads, no store
  const long long bh = r / sq, s = r % sq;
  const long long b = bh / heads, h = bh % heads;
  const uint4 qv = *reinterpret_cast<const uint4*>(q + b * qs.b + h * qs.h + s * qs.s + 8 * sub);
  const bf16* kr = k + b * ks.b + h * ks.h + 8 * sub;
  const bf16* vr = v + b * vs.b + h * vs.h + 8 * sub;
  uint4 kv[SK], vv[SK];
#pragma unroll
  for (int j = 0; j < SK; ++j) {
    kv[j] = *reinterpret_cast<const uint4*>(kr + j * ks.s);
    vv[j] = *reinterpret_cast<const uint4*>(vr + j * vs.s);
  }
  float qf[8], kf[SK][8], d[SK];
  unpack8(qv, qf);
#pragma unroll
  for (int j = 0; j < SK; ++j) {
    unpack8(kv[j], kf[j]);
    d[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int j = 0; j < SK; ++j) {
      float t = d[j];
#pragma unroll
      for (int c = 0; c < 8; ++c) t = fmaf(qf[c], kf[j][c], t);
      d[j] = __shfl_sync(0xffffffffu, t, i, L);  // lane i's running sum
    }
  float e[kRowKeys], m = -INFINITY;
#pragma unroll
  for (int j = 0; j < SK; ++j) {
    e[j] = __fmul_rn(d[j], scale);  // never contracted with the subtraction below
    m = fmaxf(m, e[j]);
  }
#pragma unroll
  for (int j = 0; j < kRowKeys; ++j) e[j] = j < SK ? expf(e[j] - m) : 0.f;
  // The simt route's warp sum of a lane a key (lanes past Sk add zeros):
  // offsets 16 and 8 add zeros, then 4, 2, 1.
  const float l = ((e[0] + e[4]) + (e[2] + e[6])) + ((e[1] + e[5]) + (e[3] + e[7]));
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < SK; ++j) {
    const float w = __bfloat162float(__float2bfloat16(__fdiv_rn(e[j], l)));
    float vf[8];
    unpack8(vv[j], vf);
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = fmaf(w, vf[c], acc[c]);
  }
  if (live) {
    uint4 out;
    uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
    *reinterpret_cast<uint4*>(o + b * os.b + h * os.h + s * os.s + 8 * sub) = out;
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

// Shared memory of a block of each route, in bytes, as the wrapper's
// attention_plan computes it; the simt route is streamed when its key block
// holds fewer than Sk keys.
long long smem_bytes(int route, int dh, int sq, int sk, int per_block, int warps,
                     int keys_padded, int query_rows, int key_block, int stages) {
  if (route == 4) return 0;  // row: registers only
  if (route == 3)  // tile: 1024 of alignment, the ring, a staging box a consumer, barriers
    return 1024 + 2LL * dh * (stages * (query_rows + 2LL * keys_padded) + 16LL * (warps - 1)) +
           16LL * stages;
  if (route == 2) {  // wgmma: K and V, 2 query tiles, the two warpgroups' exchange
    const long long split = keys_padded == 2 * key_block;
    return 1024 + 2LL * keys_padded * 2 * dh + 2LL * 2 * kWgTile * dh +
           (split ? 4LL * 2 * (dh / 4) * 128 + 4LL * 2 * 128 * 4 : 0) + 8 * 4;
  }
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

// A 4-D map of a (B, H, S, Dh) view with element strides st = (b, h, s):
// dims (Dh, S, H, B) or, where H's stride is the smaller, (Dh, H, S, B), a
// box of `rows` rows of S swizzled by the row's bytes (128, 64 or 32);
// *s_dim says which.
cudaError_t qkv_map(CUtensorMap* map, const void* p, const long long* st, int batch, int heads,
                    int len, int dh, int rows, int* s_dim) {
  const bool s_inner = st[2] <= st[1];
  *s_dim = s_inner ? 1 : 2;
  const uint64_t dims[4] = {(uint64_t)dh, (uint64_t)(s_inner ? len : heads),
                            (uint64_t)(s_inner ? heads : len), (uint64_t)batch};
  const uint64_t strides[3] = {2ull * (s_inner ? st[2] : st[1]),
                               2ull * (s_inner ? st[1] : st[2]), 2ull * st[0]};
  const uint32_t box[4] = {(uint32_t)dh, s_inner ? (uint32_t)rows : 1u,
                           s_inner ? 1u : (uint32_t)rows, 1u};
  return crowdmod::hopper::bf16_tensor_map(
      map, p, 4, dims, strides, box,
      dh == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : dh == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                 : CU_TENSOR_MAP_SWIZZLE_32B);
}

template <int DH, int NK, int KS>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int batch, int heads,
                 int sq, int sk, float scale, const long long* st, int smem,
                 cudaStream_t stream) {
  WgArgs a{};
  a.o = static_cast<bf16*>(o);
  a.os = strides_at(st, 3);
  a.heads = heads;
  a.sq = sq;
  a.sk = sk;
  a.tiles = (sq + kWgTile - 1) / kWgTile;
  a.scale_log2 = scale * 1.4426950408889634f;
  const long long problems = (long long)batch * heads;
  if (problems > 0x7fffffffLL || sk > KS * NK || sk <= (KS - 1) * NK)
    return (int)cudaErrorInvalidConfiguration;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = qkv_map(&maps[i], ptrs[i], st + 3 * i, batch, heads,
                                    i == 0 ? sq : sk, DH, i == 0 ? kWgTile : kKeyBox,
                                    &a.s_dim[i]);
    if (err != cudaSuccess) return (int)err;
  }
  const auto kernel = attention_wgmma_kernel<DH, NK, KS>;
  const cudaError_t attr =
      crowdmod::allow_dynamic_smem(reinterpret_cast<const void*>(kernel), smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<(unsigned)problems, 128 * KS, smem, stream>>>(maps[0], maps[1], maps[2], a);
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

template <int DH>
int launch_tile(const void* q, const void* k, const void* v, void* o, int batch, int heads,
                int sq, int sk, int teams, int warps, int keys, int rows, int stages,
                int blocks, int smem, float scale, const long long* st, cudaStream_t stream) {
  TileArgs a{};
  a.heads = heads;
  a.sq = sq;
  a.sk = sk;
  a.rows = rows;
  a.keys = keys;
  a.tiles = rows / 16;
  a.teams = teams;
  a.stages = stages;
  a.chunks = (sq + rows - 1) / rows;
  a.scale_log2 = scale * 1.4426950408889634f;
  const long long items = (long long)batch * heads * a.chunks;
  if (rows % 16 || rows < 16 || rows > kTileRows || rows >= sq + 16 || keys % 16 || keys < sk || keys >= sk + 16 ||
      keys > kTileKeys || teams < 1 || warps != 1 + teams * a.tiles ||
      warps > 1 + kTileConsumers || stages < 1 || stages % teams || items > 0x7fffffffLL ||
      blocks < 1 ||
      blocks > items)
    return (int)cudaErrorInvalidValue;
  a.items = (int)items;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = qkv_map(&maps[i], ptrs[i], st + 3 * i, batch, heads,
                                    i == 1 || i == 2 ? sk : sq, DH,
                                    i == 0 ? rows : i == 3 ? 16 : keys, &a.s_dim[i]);
    if (err != cudaSuccess) return (int)err;
  }
  const auto kernel = attention_tile_kernel<DH>;
  const cudaError_t attr =
      crowdmod::allow_dynamic_smem(reinterpret_cast<const void*>(kernel), smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<(unsigned)blocks, 32 * warps, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], a);
  return (int)cudaGetLastError();
}

template <int DH, int SK>
void launch_row_keys(const void* q, const void* k, const void* v, void* o, int heads, int sq,
                     long long rows, int warps, int blocks, float scale, const long long* st,
                     cudaStream_t stream) {
  attention_row_kernel<DH, SK><<<(unsigned)blocks, 32 * warps, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), heads, sq, rows, scale, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3));
}

template <int DH>
int launch_row(const void* q, const void* k, const void* v, void* o, int heads, int sq, int sk,
               long long problems, int per_block, int warps, int blocks, float scale,
               const long long* st, cudaStream_t stream) {
  const long long rows = problems * sq;
  if (sk > kRowKeys || warps < 1 || warps > 8 || per_block != warps * 32 / (DH / 8) ||
      blocks != (rows + per_block - 1) / per_block)
    return (int)cudaErrorInvalidValue;
  switch (sk) {
#define CROWDMOD_ROW(SK)                                                                   \
  case SK:                                                                                 \
    launch_row_keys<DH, SK>(q, k, v, o, heads, sq, rows, warps, blocks, scale, st, stream); \
    break;
    CROWDMOD_ROW(1)
    CROWDMOD_ROW(2)
    CROWDMOD_ROW(3)
    CROWDMOD_ROW(4)
    CROWDMOD_ROW(5)
    CROWDMOD_ROW(6)
    CROWDMOD_ROW(7)
    CROWDMOD_ROW(8)
#undef CROWDMOD_ROW
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The built wgmma kernels, X(DH, NK, KS): head dim, keys a warpgroup holds,
// warpgroups splitting a problem's keys; ops/kernels/attention.py's
// WGMMA_TILES names the same (NK, KS).
#define CROWDMOD_WGMMA_TILES(X) \
  X(64, 128, 1)                 \
  X(64, 160, 1)                 \
  X(64, 192, 1)                 \
  X(64, 224, 1)                 \
  X(64, 128, 2)                 \
  X(64, 160, 2)                 \
  X(64, 192, 2)                 \
  X(64, 224, 2)                 \
  X(32, 128, 1)                 \
  X(32, 160, 1)                 \
  X(32, 192, 1)                 \
  X(32, 224, 1)                 \
  X(32, 128, 2)                 \
  X(32, 160, 2)                 \
  X(32, 192, 2)                 \
  X(32, 224, 2)

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (b, h, s)
// for q, k, v and o in that order.  The plan (ops/kernels/attention.py,
// attention_plan): route 4 = "row", 3 = "tile", 2 = "wgmma" and 1 = "mma"
// (bf16 only), 0 = "simt"; problems a block (tile: the teams, problems in
// flight a CTA; row: query rows a block), warps a block (tile: the
// producer and teams x tiles consumers), keys padded (tile, mma: Sk up to
// a multiple of 16; wgmma: the keys the block's warpgroups hold, KS x NK;
// simt: of 4; row: Sk), the query rows a block covers (Sq, but for the
// streamed simt form; tile: an item's Q box), the keys a block holds at
// once (wgmma: NK, a warpgroup's; the padded keys, or kStreamKeys: the
// streamed simt form), the dynamic shared memory, which must be the plan's
// own, the ring's stages (tile; 1 elsewhere) and the grid (tile: the
// persistent CTAs; elsewhere the count the route implies).  vec: the simt
// route may copy K and V in 16-byte loads (rows 16-byte aligned); the
// others need them so.  Returns a cudaError_t value.
extern "C" int crowdmod_attention(int dtype, const void* q, const void* k, const void* v,
                                  void* o, int batch, int heads, int sq, int sk, int dh,
                                  float scale, const long long* strides, int route,
                                  int per_block, int warps, int keys_padded, int query_rows,
                                  int key_block, int smem, int vec, int stages, int blocks,
                                  void* stream) {
  const bool streamed = route == 0 && key_block < sk;
  const bool wg = route == 2;
  const long long problems = (long long)batch * heads;
  const long long implied =  // the grid of the non-persistent routes
      route == 1 || (route == 0 && !streamed) ? (problems + per_block - 1) / per_block
      : route == 0 && query_rows > 0 ? problems * ((sq + query_rows - 1) / query_rows)
                                     : problems;
  if (sk < 1 || sq < 0 || batch < 0 || heads < 1 || per_block < 1 || (sq > 0 && query_rows < 1) ||
      route < 0 || route > 4 ||
      (route >= 1 && (dtype != 1 || !vec)) || (route >= 1 && route <= 2 && sq < 16) ||
      (route == 1 && sk <= kKeyBlock) || (route == 3 ? stages < 1 : stages != 1) ||
      (route < 3 && blocks != implied) || (route >= 3 && key_block != keys_padded) ||
      (route == 4 && (keys_padded != sk || query_rows != sq)) || smem > kMaxSmem ||
      smem != smem_bytes(route, dh, sq, sk, per_block, warps, keys_padded, query_rows, key_block,
                         stages))
    return (int)cudaErrorInvalidValue;
  if (problems == 0 || sq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route >= 3) {
#define CROWDMOD_SHORT(DH)                                                                     \
  if (dh == DH)                                                                                \
    return route == 4 ? launch_row<DH>(q, k, v, o, heads, sq, sk, problems, per_block, warps,  \
                                       blocks, scale, strides, s)                              \
                      : launch_tile<DH>(q, k, v, o, batch, heads, sq, sk, per_block, warps,     \
                                        keys_padded, query_rows, stages, blocks, smem, scale,   \
                                        strides, s);
    CROWDMOD_SHORT(16)
    CROWDMOD_SHORT(32)
    CROWDMOD_SHORT(64)
#undef CROWDMOD_SHORT
    return (int)cudaErrorInvalidValue;
  }
  if (wg ? (per_block != 1 || query_rows != sq ||
            (keys_padded != key_block && keys_padded != 2 * key_block) ||
            warps != 4 * keys_padded / key_block)
         : streamed ? key_block != kStreamKeys
                    : (key_block != keys_padded || query_rows != sq))
    return (int)cudaErrorInvalidValue;
  if (wg) {
#define CROWDMOD_WGMMA(DH, NK, KS)                                                          \
  if (dh == DH && key_block == NK && keys_padded == KS * NK)                                \
    return launch_wgmma<DH, NK, KS>(q, k, v, o, batch, heads, sq, sk, scale, strides, smem, s);
    CROWDMOD_WGMMA_TILES(CROWDMOD_WGMMA)
#undef CROWDMOD_WGMMA
    return (int)cudaErrorInvalidValue;
  }
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
