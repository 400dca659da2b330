// One whole UNet ResnetBlock3D forward (inference) for Hopper (sm_90a),
// channels-last (B, T, H, W, C):
//     h1  = conv1(silu(GN1(x))) + b1 + temb_proj
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
// (Cin + Cout) * 2 bytes in and out (bf16): hundreds of flops a byte, so
// the bound is the bf16 tensor-core rate.
//
// The TPU kernel holds a whole sample in VMEM.  Here it cannot: one
// level-0 sample with Cin = 96 is 663 KB in bf16, against 227 KB of shared
// memory a block; and GN2 needs all of conv1's output of a sample before
// any of conv2 can start.  So one call is a few ordinary launches on one
// stream, and every sum runs in a fixed order: no atomics, so the output is
// the same bits on every run (the free-running Sparsity chain depends on
// it).
//
// bf16 (served), five launches, the multiplies on the tensor cores:
//   1. GN1's moments: one pass over x into per-chunk partial sums
//      (moment_partials_kernel), summed in chunk order by their consumer.
//   2. act1: a1 = bf16(silu(GN1(x))), one elementwise pass of 16-byte
//      vectors (a thread's 8 channels fixed, their parameters in registers),
//      so each activation is computed once and not once per tap (the
//      oracle rounds the GN output to the input type there too).
//   3. conv1 over a1 on the halo box (resblock_conv_kernel, below: the
//      design of conv3d.cu's conv3d_halo_kernel, TMA and wgmma, persistent
//      blocks); the epilogue adds b1 + temb_proj, rounds to bf16 and stores
//      h1 (where the oracle rounds it), and writes each tile's sums and sums
//      of squares of the rounded values by group to a workspace (batch,
//      tiles a sample, n_tiles, G, 2): registers, quad and warp shuffles,
//      then shared memory in warp order, plain stores.
//   4. act2: each block first sums its sample's partials in tile order into
//      (mean, rstd), variance E[h^2] - E[h]^2 as the TPU kernel's; then
//      a2 = bf16(silu(GN2(h1))), written over h1.
//   5. conv2: the same kernel over a2 (K = 27 * Cout), then Cin more K
//      rows of raw x at the centre, an interior box a chunk, times Ws (the
//      1x1 skip in the same GEMM); the epilogue adds b2 (+ b_skip) or the
//      identity x, rounds once.
// Until commit ed2c182 the convs were mma.cuh's mma.sync tile over rows
// gathered by cp.async (each input row staged 27 times a block): 0.862 ms
// at dec_0_0 (96->32, batch 64), 17x its bound: the staging design the
// standalone convs (conv3d.cu) left behind.  Applying each GN + SiLU to the
// conv's boxes as they land instead of steps 2 and 4 (three launches) was
// twice as slow: the producer warpgroup's pass over each box held back the
// consumers.
//
// float32 (the check path) stays exact on the CUDA cores (common.cuh's
// gemm_mainloop), four launches: GN1 moments; conv1 with GN1 + SiLU applied
// to each element as it is staged, h1 stored as f32; GN2 moments over h1,
// two passes as GN1's (the twin's arithmetic: a one-pass variance moved the
// f32 output far enough from the twin's to flip the sign of a near-zero rho
// in the Sparsity chain); conv2 with GN2 + SiLU on load and the skip as
// extra K rows.
//
// The volume must be at least 128 positions (the wrapper's MIN_VOLUME; the
// UNet routes only volumes of 1024 and more here): the f32 tiles' rows
// then span two samples at most, and a bf16 tile (whole rows of W + 2
// padded columns) lies in one sample.
//
// Interface: plain C, loaded with ctypes; launches on the given stream and
// returns cudaGetLastError() after each launch.

#include "common.cuh"
#include "hopper.cuh"

#include <map>
#include <mutex>

namespace crowdmod {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxGroups = 32;
constexpr int kMaxChannels = 1024;  // bf16: the GN passes stage a value a channel

// ---------------------------------------------------------------------------
// GN moments and the fixed-order GN2 partials
// ---------------------------------------------------------------------------

// (mean, rstd) of each (sample, group) into stats: GN1, and f32's GN2.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const T* __restrict__ x, float* __restrict__ stats, int S, int C, int G,
               float eps) {
  __shared__ float scratch[kThreads / 32];
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = C / G;
  float mean, rstd;
  group_moments<T, V>(x + (long long)b * S * C + (long long)g * cg, S, C, cg, eps, scratch,
                      mean, rstd);
  if (threadIdx.x == 0) {
    stats[2 * (b * G + g)] = mean;
    stats[2 * (b * G + g) + 1] = rstd;
  }
}

// GN2's (mean, rstd) of sample b, group g from conv1's partials: part is
// (batch, tiles a sample, n_tiles, G, 2), each tile's sums of the rounded
// h1 over its rows; summed in tile order, then channel-tile order.
__device__ float2 partial_stats(const float* __restrict__ part, int b, int g, int vol,
                                int groups, int cg, int tiles, int n_tiles, float eps) {
  float s = 0.f, q = 0.f;
  const float* p = part + ((long long)b * tiles * n_tiles * groups + g) * 2;
  for (int i = 0; i < tiles * n_tiles; ++i, p += 2 * groups) {
    s += p[0];
    q += p[1];
  }
  const float n = (float)vol * cg;
  const float mean = s / n;
  return make_float2(mean, rsqrtf(fmaxf(q / n - mean * mean, 0.f) + eps));
}

// ---------------------------------------------------------------------------
// bf16: activations once, convs on the halo box (TMA, wgmma)
// ---------------------------------------------------------------------------

// GN1's partial sums in one pass over x (bf16): a block takes kMomentRows
// positions of sample blockIdx.y; thread i holds one 16-byte vector of 8
// channels (i % (C / 8)) of every (kThreads / (C / 8))-th row, so a block's
// loads are contiguous, and sums each channel and its square over its rows
// in registers.  Then, in a fixed order, each channel's sums over the
// threads that hold it (a thread a channel), and each group's over its
// channels, into part (batch, chunks, 1, G, 2): the layout of conv1's GN2
// partials, which partial_stats sums in chunk order.  (The f32 path's
// two-pass group_moments read each group's channels of every row twice,
// a few bytes of each 16.)
constexpr int kMomentRows = 1024;

__global__ void __launch_bounds__(kThreads)
moment_partials_kernel(const bf16* __restrict__ x, float* __restrict__ part, int vol, int C,
                       int G) {
  __shared__ float sums[kThreads][8][2];
  __shared__ float chan[kMaxChannels][2];
  const int nv = C / 8, rpp = kThreads / nv, cg = C / G;
  const int v = threadIdx.x % nv, r0 = threadIdx.x / nv;
  const long long first = (long long)blockIdx.y * vol + (long long)blockIdx.x * kMomentRows;
  const int rows = min(kMomentRows, vol - (int)blockIdx.x * kMomentRows);
  float s[8], q[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = q[e] = 0.f;
  if (r0 < rpp) {
#pragma unroll 4
    for (int r = r0; r < rows; r += rpp) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + (first + r) * C + 8 * v);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        s[2 * e] += f.x;
        q[2 * e] = fmaf(f.x, f.x, q[2 * e]);
        s[2 * e + 1] += f.y;
        q[2 * e + 1] = fmaf(f.y, f.y, q[2 * e + 1]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sums[threadIdx.x][e][0] = s[e];
    sums[threadIdx.x][e][1] = q[e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {  // over the rows' threads, in order
    float cs = 0.f, cq = 0.f;
    for (int r = 0; r < rpp; ++r) {
      cs += sums[r * nv + c / 8][c % 8][0];
      cq += sums[r * nv + c / 8][c % 8][1];
    }
    chan[c][0] = cs;
    chan[c][1] = cq;
  }
  __syncthreads();
  if (threadIdx.x < 2 * G) {
    const int g = threadIdx.x >> 1, moment = threadIdx.x & 1;
    float t = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) t += chan[c][moment];
    part[((long long)blockIdx.y * gridDim.x + blockIdx.x) * 2 * G + threadIdx.x] = t;
  }
}

// x * sigmoid(x) by the fast intrinsics: within a few f32 ulps of silu(),
// and the result is rounded to bf16.
__device__ __forceinline__ float silu_fast(float x) { return __fdividef(x, 1.f + __expf(-x)); }

// out = bf16(silu(GN(in))) over sample blockIdx.y (C % 8 == 0, C <=
// kMaxChannels), (mean, rstd) from stats (B, G, 2) or, when part is set,
// summed from the partials first.  As moment_partials_kernel, thread i
// holds one 16-byte vector of 8 channels (i % (C / 8)) of every
// (kThreads / (C / 8))-th row of the block's rows, so its channels' (mean,
// rstd, gamma, beta) stay in registers and a block's loads and stores are
// contiguous.  in and out may be one buffer.
__global__ void __launch_bounds__(kThreads)
gn_silu_kernel(const bf16* in, bf16* out, const float* __restrict__ stats,
               const float* __restrict__ part, const float* __restrict__ gamma,
               const float* __restrict__ beta, int vol, int C, int groups, float eps, int tiles,
               int n_tiles) {
  __shared__ float2 st[kMaxGroups];
  const int b = blockIdx.y, cg = C / groups;
  if (threadIdx.x < groups)
    st[threadIdx.x] =
        part ? partial_stats(part, b, threadIdx.x, vol, groups, cg, tiles, n_tiles, eps)
             : reinterpret_cast<const float2*>(stats)[b * groups + threadIdx.x];
  __syncthreads();
  const int nv = C / 8, rpp = kThreads / nv;
  const int v = threadIdx.x % nv, r0 = threadIdx.x / nv;
  if (r0 >= rpp) return;
  float mean[8], scale[8], shift[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = 8 * v + e;
    const float2 g = st[c / cg];
    mean[e] = g.x;
    scale[e] = g.y * gamma[c];
    shift[e] = beta[c];
  }
  const long long base = (long long)b * vol * C + 8 * v;
#pragma unroll 2
  for (int r = blockIdx.x * rpp + r0; r < vol; r += gridDim.x * rpp) {
    const uint4 raw = *reinterpret_cast<const uint4*>(in + base + (long long)r * C);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 res;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      o[e] = __floats2bfloat162_rn(silu_fast((f.x - mean[2 * e]) * scale[2 * e] + shift[2 * e]),
                                   silu_fast((f.y - mean[2 * e + 1]) * scale[2 * e + 1] +
                                             shift[2 * e + 1]));
    }
    *reinterpret_cast<uint4*>(out + base + (long long)r * C) = res;
  }
}

// The two convs on conv3d.cu's halo-box design (conv3d_halo_kernel, im2col
// form): a persistent block a multiprocessor walks the work items (output
// tile, channel tile); for each chunk of KC input channels the producer
// warpgroup loads the tile's halo box (tb + 2, hb + 2, W + 2, KC) of the
// activation by one 5-D TMA copy (zero outside the volume: the SAME
// padding of silu(GN(.)), which is 0 there) and the weight rows of each of
// the 27 taps by TMA into a ring of stages under mbarriers (one producer
// thread in a ninth warp); two consumer warpgroups run wgmma m64n32k16 with A from registers (ldmatrix at the
// tap's constant row offset in the swizzled box) and B the stage's
// MN-major 64-byte swizzled atoms of 32 output channels.  Cout is 32 at the
// UNet's level-0 blocks, so N is one 32-channel atom (NA = 1; two for
// Cout <= 64, channel tiles past that) and each weight stage serves MT
// 64-row tiles of each consumer warpgroup.  conv2 then takes the skip's
// K rows: each chunk of x's channels as an interior box (tb, hb, W) at
// the centre, against the 1x1 weight appended to w2.  A tile is whole
// rows of one sample (bb = 1: the least volume, 128, exceeds a tile's
// GEMM rows of W + 2 columns), so conv1's GN2 partials are a tile's own.
constexpr int kConsumers = 256;    // two warpgroups multiply
constexpr int kHaloThreads = 288;  // and one warp's thread stages (224 registers a thread)
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;
constexpr int kAtomCols = 32;  // output channels of a B atom (64-byte rows)

struct ConvArgs {
  const bf16* x;        // conv2: the block's input, for the identity skip
  const bf16* temb;     // conv1: (B, Cout) temb_proj
  const float* b1;      // conv1: (Cout,)
  const float* bias;    // conv2: (Cout,) b2 [+ b_skip]
  bf16* out;            // conv1: h1; conv2: the block's output
  float* part;          // conv1: GN2 partials (B, tiles a sample, n_tiles, G, 2)
  int batch, t, h, wd;
  int cin;              // channels of the conv's input (conv1 Cin, conv2 Cout)
  int skip_cin;         // conv2 with the 1x1 skip: Cin (its K rows), else 0
  int xc;               // channels of x (the identity skip reads it)
  int cout, groups;
  int tb, hb, tiles_t, tiles_h;
  int mtiles, ntiles;
  int chunks, skip_chunks;  // halo boxes and interior boxes an item
  int stages, nbox, box_bytes;
  int colsum_offset, bar_offset;
};

// Dynamic shared memory of a resblock conv block: the boxes, the weight
// ring, conv1's column sums (8 warps x NA * 32 columns x 2 moments, f32),
// the barriers, 1024 of alignment.
__host__ __device__ inline int res_box_bytes(int kc, int npos) {
  return (npos * kc * 2 + 1023) / 1024 * 1024;
}
__host__ __device__ inline int res_colsum_offset(int na, int kc, int npos, int stages,
                                                 int nbox) {
  return nbox * res_box_bytes(kc, npos) + stages * na * kc * 64;
}
__host__ __device__ inline int res_bar_offset(bool conv1, int na, int kc, int npos, int stages,
                                              int nbox) {
  return res_colsum_offset(na, kc, npos, stages, nbox) +
         (conv1 ? 8 * na * kAtomCols * 2 * 4 : 0);
}
__host__ __device__ inline int res_smem_bytes(bool conv1, int na, int kc, int npos, int stages,
                                              int nbox) {
  return 1024 + res_bar_offset(conv1, na, kc, npos, stages, nbox) + 8 * (4 + 2 * kMaxStages);
}

// MT: 64-row tiles a consumer warpgroup takes (a block's M is 128 MT); NA:
// 32-column atoms of N; KC: channels a chunk; CONV1: conv1's epilogue
// (+ b1 + temb_proj, h1 and the GN2 partials), else conv2's (+ bias, [+ x],
// out).  One producer thread issues every copy: per chunk its box, then its
// weight stages.
template <int MT, int NA, int KC, bool CONV1>
__global__ void __launch_bounds__(kHaloThreads, 1)
resblock_conv_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap smap, const ConvArgs a) {
  using namespace hopper;
  constexpr int RB = KC * 2;        // bytes of a box position
  constexpr int KS = KC / 16;       // k16 steps a stage
  constexpr int ATOM = KC * 64;     // one 32-column atom of a stage
  constexpr int STAGE = NA * ATOM;
  static_assert(KC == 16 || KC == 32 || KC == 64, "chunks of 16-64 channels");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* boxes = base;
  unsigned char* ring = base + a.nbox * a.box_bytes;
  float* colsum = reinterpret_cast<float*>(base + a.colsum_offset);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + a.bar_offset);
  uint64_t* box_full = bars;
  uint64_t* box_empty = bars + 2;
  uint64_t* b_full = bars + 4;
  uint64_t* b_empty = bars + 4 + kMaxStages;

  const int ph = a.hb + 2, pw = a.wd + 2;
  const int plane = ph * pw;
  const int npos = (a.tb + 2) * plane;
  const int rows = a.tb * a.hb * pw;  // live GEMM rows of a tile
  const int items = a.mtiles * a.ntiles;
  const int per_item = 27 * a.chunks + a.skip_chunks;  // stages an item
  struct Item {
    int b, t0, h0, n0, m;
  };
  const auto work = [&](int w) {
    Item k;
    k.m = w % a.mtiles;
    k.n0 = w / a.mtiles * NA * kAtomCols;
    k.h0 = k.m % a.tiles_h * a.hb;
    k.t0 = k.m / a.tiles_h % a.tiles_t * a.tb;
    k.b = k.m / (a.tiles_h * a.tiles_t);
    return k;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&box_full[i], 1);
      mbar_init(&box_empty[i], kConsumers);
    }
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(&b_full[i], 1);
      mbar_init(&b_empty[i], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer (one thread): per work item, each chunk's box, then its
    // weight stages (27 taps; one for a skip chunk), boxes and stages
    // cycling across items.
    if (threadIdx.x != kConsumers) return;
    int bc = 0, it = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const Item k = work(w);
      for (int c = 0; c < a.chunks + a.skip_chunks; ++c, ++bc) {
        const bool skip = c >= a.chunks;
        const int slot = bc % a.nbox;
        unsigned char* box = boxes + slot * a.box_bytes;
        mbar_wait(&box_empty[slot], ((bc / a.nbox) & 1) ^ 1);
        if (!skip) {
          mbar_arrive_expect_tx(&box_full[slot], npos * RB);
          tma_load_5d(box, &amap, &box_full[slot], c * KC, -1, k.h0 - 1, k.t0 - 1, k.b);
        } else {
          mbar_arrive_expect_tx(&box_full[slot], a.tb * a.hb * a.wd * RB);
          tma_load_5d(box, &smap, &box_full[slot], (c - a.chunks) * KC, 0, k.h0, k.t0, k.b);
        }
        for (int j = 0; j < (skip ? 1 : 27); ++j, ++it) {
          const int s = it % a.stages;
          unsigned char* st = ring + s * STAGE;
          mbar_wait(&b_empty[s], ((it / a.stages) & 1) ^ 1);
          const int row0 = skip ? 27 * a.cin + (c - a.chunks) * KC : j * a.cin + c * KC;
          mbar_arrive_expect_tx(&b_full[s], STAGE);
#pragma unroll
          for (int at = 0; at < NA; ++at)
            tma_load_2d(st + at * ATOM, &wmap, &b_full[s], k.n0 + at * kAtomCols, row0);
        }
      }
    }
    return;
  }

  // Consumers.
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  // The box position under each of this lane's ldmatrix rows at tap offset
  // 0 (halo box) and in the interior box (the skip's centre rows): GEMM
  // row m is padded column m % pw of tile row m / pw.  Rows past the tile
  // read an interior position, every tap of which lies in the box; the
  // two pad columns read a neighbour (their sums are dropped).
  int center[MT], inner[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = (wg * MT + mt) * 64 + warp * 16 + (lane & 15);
    const int r = m / pw, hh = r % a.hb, tt = r / a.hb;
    const bool live = m < rows;
    center[mt] = live ? ((tt + 1) * ph + hh + 1) * pw + m % pw : plane + pw + 1;
    inner[mt] = live ? r * a.wd + min(max(m % pw - 1, 0), a.wd - 1) : 0;
  }
  float acc[MT][NA][16];
  const auto fence_acc = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int at = 0; at < NA; ++at)
#pragma unroll
        for (int e = 0; e < 16; ++e) fence_operand(acc[mt][at][e]);
  };
  const int tr = lane >> 2, tc = 2 * (lane & 3);

  int bc = 0, gi = 0;  // boxes and stages consumed by earlier items
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Item k = work(w);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int at = 0; at < NA; ++at)
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[mt][at][e] = 0.f;

    // Stage i of the item: chunk i / 27, tap i % 27 for the halo chunks,
    // then one stage a skip chunk.  load_a reads its A fragments from the
    // box (waiting for the box at a chunk's first stage, releasing it after
    // the last); mma waits for its weights and issues its wgmma group.
    const auto load_a = [&](int i, uint32_t (&af)[MT][KS][4]) {
      const bool skip = i >= 27 * a.chunks;
      const int c = skip ? a.chunks + i - 27 * a.chunks : i / 27;
      const int j = skip ? 13 : i - 27 * c;
      const int slot = (bc + c) % a.nbox;
      if (skip || j == 0) mbar_wait(&box_full[slot], ((bc + c) / a.nbox) & 1);
      const uint32_t box = smem_u32(boxes + slot * a.box_bytes);
      const int off = (j / 9 - 1) * plane + (j / 3 % 3 - 1) * pw + (j % 3 - 1);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int q = 2 * ks + (lane >> 4);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // The two pad columns of a tile's first and last rows reach one
          // position past the box; their sums are dropped.
          const int p = skip ? inner[mt] : min(max(center[mt] + off, 0), npos - 1);
          ldsm_x4(af[mt][ks], box + swizzle_chunk<RB>(p, q));
        }
      }
      if (skip || j == 26) mbar_arrive(&box_empty[slot]);
    };
    const auto mma = [&](int i, const uint32_t (&af)[MT][KS][4]) {
      const int s = (gi + i) % a.stages;
      mbar_wait(&b_full[s], ((gi + i) / a.stages) & 1);
      const uint32_t st = smem_u32(ring + s * STAGE);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int at = 0; at < NA; ++at)
            wgmma_m64n32k16_rs<1>(acc[mt][at], af[mt][ks],
                                  desc_sw<64>(st + at * ATOM + ks * 1024, ATOM, 512));
      wgmma_commit();
    };
    // Two sets of A fragments: stage i + 1's loaded while stage i's wgmma
    // group runs; a set is reloaded only after wait_group 1 has retired the
    // group that read it, and a weight stage is released once its group
    // has retired (conv3d.cu's im2col loop).  The accumulators are fenced
    // only where no group is in flight.
    uint32_t af0[MT][KS][4], af1[MT][KS][4];
    fence_acc();
    load_a(0, af0);
    for (int i = 0; i < per_item; i += 2) {
      mma(i, af0);
      wgmma_wait<1>();
      if (i > 0) mbar_arrive(&b_empty[(gi + i - 1) % a.stages]);
      if (i + 1 >= per_item) break;
      load_a(i + 1, af1);
      mma(i + 1, af1);
      wgmma_wait<1>();
      mbar_arrive(&b_empty[(gi + i) % a.stages]);
      if (i + 2 < per_item) load_a(i + 2, af0);
    }
    wgmma_wait<0>();
    fence_acc();
    mbar_arrive(&b_empty[(gi + per_item - 1) % a.stages]);
    bc += a.chunks + a.skip_chunks;
    gi += per_item;

    // Epilogue.  Output position of GEMM row m, or -1 (a pad column, a row
    // past the tile or past the volume).
    const auto out_pos = [&](int m) -> long long {
      const int wp = m % pw;
      if (m >= rows || wp == 0 || wp > a.wd) return -1;
      const int r = m / pw, hh = r % a.hb, tt = r / a.hb;
      const int t = k.t0 + tt, h = k.h0 + hh;
      if (t >= a.t || h >= a.h) return -1;
      return (((long long)k.b * a.t + t) * a.h + h) * a.wd + wp - 1;
    };
    if constexpr (CONV1) {
      // h1 = bf16(acc + (b1 + temb_proj[b])), and the sums of the rounded
      // values by column: a thread's rows, its quad's eight row groups
      // (shuffles), the eight warps in order (shared memory), then each
      // group's columns in order.
      float cs[NA][4][2][2];
#pragma unroll
      for (int at = 0; at < NA; ++at)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cs[at][j][e >> 1][e & 1] = 0.f;
      const bf16* tp = a.temb + (long long)k.b * a.cout;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long pos = out_pos((wg * MT + mt) * 64 + warp * 16 + tr + 8 * half);
          if (pos < 0) continue;
#pragma unroll
          for (int at = 0; at < NA; ++at)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int n = k.n0 + at * kAtomCols + 8 * j + tc;
              if (n >= a.cout) continue;
              // b1 + temb_proj in f32 (the f32 path's tvec), then the sum.
              const float2 tf = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(tp + n));
              const __nv_bfloat162 hv =
                  __floats2bfloat162_rn(acc[mt][at][4 * j + 2 * half] + (tf.x + a.b1[n]),
                                        acc[mt][at][4 * j + 2 * half + 1] + (tf.y + a.b1[n + 1]));
              *reinterpret_cast<__nv_bfloat162*>(a.out + pos * a.cout + n) = hv;
              const float2 f = __bfloat1622float2(hv);
              cs[at][j][0][0] += f.x;
              cs[at][j][0][1] = fmaf(f.x, f.x, cs[at][j][0][1]);
              cs[at][j][1][0] += f.y;
              cs[at][j][1][1] = fmaf(f.y, f.y, cs[at][j][1][1]);
            }
        }
#pragma unroll
      for (int at = 0; at < NA; ++at)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = cs[at][j][e >> 1][e & 1];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            cs[at][j][e >> 1][e & 1] = v;
          }
      named_barrier(1, kConsumers);  // the previous item's sums are read
      if (lane < 4) {
#pragma unroll
        for (int at = 0; at < NA; ++at)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              colsum[((wg * 4 + warp) * NA * kAtomCols + at * kAtomCols + 8 * j + 2 * lane +
                      (e >> 1)) * 2 + (e & 1)] = cs[at][j][e >> 1][e & 1];
      }
      named_barrier(1, kConsumers);
      const int cg = a.cout / a.groups, nb = NA * kAtomCols;
      const int tiles = a.tiles_t * a.tiles_h, nt = k.n0 / nb;
      for (int q = threadIdx.x; q < 2 * a.groups; q += kConsumers) {
        const int g = q >> 1, moment = q & 1;
        const int lo = max(g * cg, k.n0), hi = min(min((g + 1) * cg, k.n0 + nb), a.cout);
        float sum = 0.f;
        for (int wv = 0; wv < 8; ++wv)
          for (int c = lo; c < hi; ++c) sum += colsum[(wv * nb + c - k.n0) * 2 + moment];
        a.part[(((long long)k.b * tiles + k.m % tiles) * a.ntiles + nt) * 2 * a.groups + q] =
            sum;
      }
    } else {
      // out = bf16(acc + bias [+ x]), one rounding; a 64-row tile's x values
      // (the identity skip) are all loaded before its stores.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        long long pos[2];
        __nv_bfloat162 xv[2][NA][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          pos[half] = out_pos((wg * MT + mt) * 64 + warp * 16 + tr + 8 * half);
#pragma unroll
          for (int at = 0; at < NA; ++at)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int n = k.n0 + at * kAtomCols + 8 * j + tc;
              xv[half][at][j] = a.skip_cin == 0 && pos[half] >= 0 && n < a.cout
                                    ? *reinterpret_cast<const __nv_bfloat162*>(
                                          a.x + pos[half] * a.xc + n)
                                    : __floats2bfloat162_rn(0.f, 0.f);
            }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (pos[half] < 0) continue;
#pragma unroll
          for (int at = 0; at < NA; ++at)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int n = k.n0 + at * kAtomCols + 8 * j + tc;
              if (n >= a.cout) continue;
              float v0 = acc[mt][at][4 * j + 2 * half] + a.bias[n];
              float v1 = acc[mt][at][4 * j + 2 * half + 1] + a.bias[n + 1];
              if (a.skip_cin == 0) {
                const float2 x2 = __bfloat1622float2(xv[half][at][j]);
                v0 += x2.x;
                v1 += x2.y;
              }
              *reinterpret_cast<__nv_bfloat162*>(a.out + pos[half] * a.cout + n) =
                  __floats2bfloat162_rn(v0, v1);
            }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

// GN + SiLU of the input under tap k, zero outside the volume.  stats holds
// (mean, rstd) per (sample, group).
struct GnSiluLoad {
  const float* x;
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
    const float v = x[p * cin + s.tap.c];
    const float2 st = *reinterpret_cast<const float2*>(stats + 2 * (r.x * groups + s.grp));
    return silu((v - st.x) * st.y * s.ga + s.be);
  }
};

// K rows [0, 27*c2): GN2 + SiLU of h1 under the tap, from GN2's (mean,
// rstd).  K rows [27*c2, 27*c2 + cin): the raw input at the centre (the
// 1x1 skip).
struct Gn2SkipLoad {
  GnSiluLoad gn;  // over h1, c2 channels
  const float* x;
  int cin;
  using State = GnSiluLoad::State;
  __device__ State state(int k) const {
    if (k >= 27 * gn.cin) return State{Tap{0, 0, 0, k - 27 * gn.cin}, 0.f, 0.f, -1};
    return gn.state(k);
  }
  __device__ float operator()(const int4& r, const State& s) const {
    if (s.grp >= 0) return gn(r, s);
    const long long p = tap_offset(r, 0, 0, 0, gn.g);
    return p < 0 ? 0.f : x[p * cin + s.tap.c];
  }
};

template <int BN>
__global__ void __launch_bounds__(kThreads)
conv1_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ tvec, const float* __restrict__ stats,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 float* __restrict__ h1, Geom g, int cin, int cout, int groups) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) float a_s[kBK * kLdA];
  __shared__ __align__(16) float b_s[kBK * BN];
  __shared__ int4 rows[kBM];
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  stage_rows(rows, m0, g);
  __syncthreads();
  float acc[kTM][TN];
  const GnSiluLoad load{x, g, cin, cin / groups, groups, stats, gamma, beta};
  gemm_mainloop<BN>(load, w1, 27 * cin, cout, n0, rows, a_s, b_s, acc);

  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int4 r = rows[tm * kTM + i];
    if (r.x < 0) break;
    const long long m = m0 + tm * kTM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn * TN + j;
      if (n < cout) h1[m * cout + n] = acc[i][j] + tvec[(long long)r.x * cout + n];
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
conv2_f32_kernel(const float* __restrict__ h1, const float* __restrict__ x,
                 const float* __restrict__ w2, const float* __restrict__ bias2,
                 const float* __restrict__ stats2, const float* __restrict__ gamma,
                 const float* __restrict__ beta, float* __restrict__ out, Geom g, int cin,
                 int cout, int groups, int has_skip) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) float a_s[kBK * kLdA];
  __shared__ __align__(16) float b_s[kBK * BN];
  __shared__ int4 rows[kBM];
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  stage_rows(rows, m0, g);
  __syncthreads();
  float acc[kTM][TN];
  const Gn2SkipLoad load{
      GnSiluLoad{h1, g, cout, cout / groups, groups, stats2, gamma, beta}, x, cin};
  gemm_mainloop<BN>(load, w2, 27 * cout + (has_skip ? cin : 0), cout, n0, rows, a_s, b_s,
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
      if (n >= cout) continue;
      float v = acc[i][j] + bias2[n];
      if (!has_skip) v += x[m * cin + n];
      out[m * cout + n] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *x, *w1, *w2;
  const float *tvec, *b1, *gamma1, *beta1, *gamma2, *beta2, *bias2;
  void *a1, *h1;
  float *stats1, *rest;  // f32: GN1's (mean, rstd), GN2's; bf16: GN1's partials, GN2's
  void* out;
};

template <typename T>
cudaError_t launch_moments(const T* x, float* stats, Geom g, int cin, int groups, float eps,
                           cudaStream_t stream) {
  const dim3 grid(groups, g.batch);
  if ((cin / groups) % 4 == 0)
    moments_kernel<T, 4><<<grid, kThreads, 0, stream>>>(x, stats, g.volume(), cin, groups, eps);
  else
    moments_kernel<T, 1><<<grid, kThreads, 0, stream>>>(x, stats, g.volume(), cin, groups, eps);
  return cudaGetLastError();
}

template <int BN>
int launch_f32_tile(const Args& a, Geom g, int cin, int cout, int groups, float eps,
                    int has_skip, cudaStream_t stream) {
  const float* x = static_cast<const float*>(a.x);
  float* h1 = static_cast<float*>(a.h1);
  cudaError_t err = launch_moments(x, a.stats1, g, cin, groups, eps, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((g.positions() + kBM - 1) / kBM), (cout + BN - 1) / BN);
  conv1_f32_kernel<BN><<<grid, kThreads, 0, stream>>>(
      x, static_cast<const float*>(a.w1), a.tvec, a.stats1, a.gamma1, a.beta1, h1, g, cin,
      cout, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_moments(static_cast<const float*>(h1), a.rest, g, cout, groups, eps, stream);
  if (err != cudaSuccess) return (int)err;
  conv2_f32_kernel<BN><<<grid, kThreads, 0, stream>>>(
      h1, x, static_cast<const float*>(a.w2), a.bias2, a.rest, a.gamma2, a.beta2,
      static_cast<float*>(a.out), g, cin, cout, groups, has_skip);
  return (int)cudaGetLastError();
}

int launch_f32(const Args& a, Geom g, int cin, int cout, int groups, float eps, int has_skip,
               int bm, int bn, int bk, cudaStream_t stream) {
  if (bm != kBM || bk != kBK) return (int)cudaErrorInvalidValue;
  if (bn == 64) return launch_f32_tile<64>(a, g, cin, cout, groups, eps, has_skip, stream);
  if (bn == 32) return launch_f32_tile<32>(a, g, cin, cout, groups, eps, has_skip, stream);
  if (bn == 16) return launch_f32_tile<16>(a, g, cin, cout, groups, eps, has_skip, stream);
  return (int)cudaErrorInvalidValue;
}

// Blocks a sample for the elementwise GN + SiLU passes: enough to fill the
// card at small batches, a grid-stride loop at large ones.
dim3 act_grid(long long vectors, int batch) {
  const long long want = (vectors + kThreads - 1) / kThreads;
  const long long cap = 1024 / batch > 1 ? 1024 / batch : 1;
  return dim3((unsigned)(want < cap ? want : cap), batch);
}

// Multiprocessors of the current device, asked once a device.
cudaError_t multiprocessors(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex lock;
  static std::map<int, int> known;
  std::lock_guard<std::mutex> guard(lock);
  int& n = known[device];
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *sms = n;
  return cudaSuccess;
}

// A bf16 call's halo plan (ops/kernels/resblock.py, ResblockPlan.halo):
// the output tile (tb t slices x hb rows x all of W), and each conv's
// channel chunk, weight stages and boxes in flight.
struct HaloPlan {
  int tb, hb, kc1, stages1, nbox1, kc2, stages2, nbox2;
};

CUtensorMapSwizzle box_swizzle(int kc) {
  return kc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                  : kc == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A 5-D map of a (B, T, H, W, C) bf16 tensor, boxes of (kc, bw, bh, bt, 1).
cudaError_t volume_map(CUtensorMap* map, const void* p, const Geom& g, int c, int kc, int bw,
                       int bh, int bt) {
  const uint64_t e = 2;
  const uint64_t dims[5] = {(uint64_t)c, (uint64_t)g.w, (uint64_t)g.h, (uint64_t)g.t,
                            (uint64_t)g.batch};
  const uint64_t strides[4] = {dims[0] * e, dims[0] * dims[1] * e,
                               dims[0] * dims[1] * dims[2] * e,
                               dims[0] * dims[1] * dims[2] * dims[3] * e};
  const uint32_t box[5] = {(uint32_t)kc, (uint32_t)bw, (uint32_t)bh, (uint32_t)bt, 1u};
  return hopper::bf16_tensor_map(map, p, 5, dims, strides, box, box_swizzle(kc));
}

template <int MT, int NA, int KC, bool CONV1>
int launch_conv(ConvArgs a, const void* act, const void* w, int w_rows, const void* skip_x,
                int stages, int nbox, cudaStream_t stream) {
  const Geom g{a.batch, a.t, a.h, a.wd};
  const int pw = a.wd + 2, npos = (a.tb + 2) * (a.hb + 2) * pw;
  a.tiles_t = (a.t + a.tb - 1) / a.tb;
  a.tiles_h = (a.h + a.hb - 1) / a.hb;
  a.chunks = (a.cin + KC - 1) / KC;
  a.skip_chunks = (a.skip_cin + KC - 1) / KC;
  a.stages = stages;
  a.nbox = nbox;
  a.box_bytes = res_box_bytes(KC, npos);
  a.colsum_offset = res_colsum_offset(NA, KC, npos, stages, nbox);
  a.bar_offset = res_bar_offset(CONV1, NA, KC, npos, stages, nbox);
  const int smem = res_smem_bytes(CONV1, NA, KC, npos, stages, nbox);
  const long long mtiles = (long long)a.batch * a.tiles_t * a.tiles_h;
  a.ntiles = (a.cout + NA * kAtomCols - 1) / (NA * kAtomCols);
  if (a.tb < 1 || a.hb < 1 || a.tb * a.hb * pw > 128 * MT || pw > 256 || a.hb + 2 > 256 ||
      a.tb + 2 > 256 || stages < 2 || stages > kMaxStages || nbox < 1 || nbox > 2 ||
      smem > kSmemLimit || mtiles * a.ntiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  a.mtiles = (int)mtiles;
  int sms = 0;
  cudaError_t err = multiprocessors(&sms);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap amap, wmap, smap;
  err = volume_map(&amap, act, g, a.cin, KC, pw, a.hb + 2, a.tb + 2);
  if (err != cudaSuccess) return (int)err;
  smap = amap;
  if (a.skip_cin > 0) {
    err = volume_map(&smap, skip_x, g, a.skip_cin, KC, a.wd, a.hb, a.tb);
    if (err != cudaSuccess) return (int)err;
  }
  const uint64_t wdims[2] = {(uint64_t)a.cout, (uint64_t)w_rows};
  const uint64_t wstrides[1] = {(uint64_t)a.cout * 2};
  const uint32_t wbox[2] = {(uint32_t)kAtomCols, (uint32_t)KC};
  err = hopper::bf16_tensor_map(&wmap, w, 2, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return (int)err;
  const auto kernel = resblock_conv_kernel<MT, NA, KC, CONV1>;
  err = allow_dynamic_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return (int)err;
  const long long items = mtiles * a.ntiles;
  kernel<<<(unsigned)(items < sms ? items : sms), kHaloThreads, smem, stream>>>(amap, wmap, smap,
                                                                                 a);
  return (int)cudaGetLastError();
}

// The built conv kernels, X(MT, NA, KC): (bm, bn) = (128 MT, 32 NA);
// ops/kernels/resblock.py's HALO_BLOCKS names the same.
#define CROWDMOD_RES_TILES(X) \
  X(1, 1, 16)                 \
  X(1, 1, 32)                 \
  X(1, 1, 64)                 \
  X(2, 1, 16)                 \
  X(2, 1, 32)                 \
  X(2, 1, 64)                 \
  X(4, 1, 16)                 \
  X(4, 1, 32)                 \
  X(1, 2, 16)                 \
  X(1, 2, 32)                 \
  X(1, 2, 64)                 \
  X(2, 2, 16)                 \
  X(2, 2, 32)                 \
  X(2, 2, 64)

template <bool CONV1>
int launch_conv_tile(const ConvArgs& a, int bm, int bn, int kc, const void* act, const void* w,
                     int w_rows, const void* skip_x, int stages, int nbox,
                     cudaStream_t stream) {
#define CROWDMOD_LAUNCH(MT, NA, KC)                                                      \
  if (bm == 128 * MT && bn == 32 * NA && kc == KC)                                       \
    return launch_conv<MT, NA, KC, CONV1>(a, act, w, w_rows, skip_x, stages, nbox, stream);
  CROWDMOD_RES_TILES(CROWDMOD_LAUNCH)
#undef CROWDMOD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Five launches: GN1's partial moments, a1 = silu(GN1(x)), conv1 (h1 and
// the GN2 partials), a2 = silu(GN2(h1)) over h1, conv2 (+ skip).
int launch_bf16(const Args& a, Geom g, int cin, int cout, int groups, float eps, int has_skip,
                int bm, int bn, const HaloPlan& p, cudaStream_t stream) {
  if (cin % 8 || cout % 8 || cin > kMaxChannels || cout > kMaxChannels)
    return (int)cudaErrorInvalidValue;
  const bf16* x = static_cast<const bf16*>(a.x);
  bf16* a1 = static_cast<bf16*>(a.a1);
  bf16* h1 = static_cast<bf16*>(a.h1);
  const int vol = g.volume();
  const int tiles = ((g.t + p.tb - 1) / p.tb) * ((g.h + p.hb - 1) / p.hb);
  const int n_tiles = (cout + bn - 1) / bn;
  const int chunks = (vol + kMomentRows - 1) / kMomentRows;
  float* part1 = a.stats1;  // GN1's partials (batch, chunks, 1, G, 2)
  moment_partials_kernel<<<dim3(chunks, g.batch), kThreads, 0, stream>>>(x, part1, vol, cin,
                                                                         groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_silu_kernel<<<act_grid((long long)vol * cin / 8, g.batch), kThreads, 0, stream>>>(
      x, a1, nullptr, part1, a.gamma1, a.beta1, vol, cin, groups, eps, chunks, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ConvArgs c{};
  c.batch = g.batch;
  c.t = g.t;
  c.h = g.h;
  c.wd = g.w;
  c.cout = cout;
  c.groups = groups;
  c.tb = p.tb;
  c.hb = p.hb;
  ConvArgs c1 = c;
  c1.temb = static_cast<const bf16*>(static_cast<const void*>(a.tvec));
  c1.b1 = a.b1;
  c1.out = h1;
  c1.part = a.rest;
  c1.cin = cin;
  int rc = launch_conv_tile<true>(c1, bm, bn, p.kc1, a1, a.w1, 27 * cin, nullptr, p.stages1,
                                  p.nbox1, stream);
  if (rc != 0) return rc;
  gn_silu_kernel<<<act_grid((long long)vol * cout / 8, g.batch), kThreads, 0, stream>>>(
      h1, h1, nullptr, a.rest, a.gamma2, a.beta2, vol, cout, groups, eps, tiles, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ConvArgs c2 = c;
  c2.x = x;
  c2.xc = cin;
  c2.bias = a.bias2;
  c2.out = static_cast<bf16*>(a.out);
  c2.cin = cout;
  c2.skip_cin = has_skip ? cin : 0;
  return launch_conv_tile<false>(c2, bm, bn, p.kc2, h1, a.w2, 27 * cout + c2.skip_cin, x,
                                 p.stages2, p.nbox2, stream);
}

}  // namespace
}  // namespace crowdmod

// dtype: 0 = float32, 1 = bfloat16.  x: (batch, t, h, w, cin); out:
// (batch, t, h, w, cout), both in dtype, contiguous.  w1: (27*cin, cout),
// rows (kd, kh, kw, ci); w2: (27*cout [+ cin], cout), the 1x1 skip weight
// (cin, cout) appended when has_skip; both in dtype.  tvec: float32, the
// f32 (batch, cout) b1 + temb_proj and b1 null; bfloat16, temb_proj (batch,
// cout) in bf16 and b1 (cout,) f32, added in conv1's epilogue; gamma1/beta1
// (cin,); gamma2/beta2 (cout,); bias2 (cout,) = b2 [+ b_skip].  Scratch: a1 (batch*t*h*w, cin) bf16 (bf16
// only, else null); h1 (batch*t*h*w, cout) in dtype; ws float32: GN1's
// (mean, rstd) (batch, groups, 2), then GN2's, the same shape; bf16: GN1's
// partials (batch, chunks of kMomentRows positions, 1, groups, 2), then
// GN2's (batch, tiles a sample, n_tiles, groups, 2).  The
// plan (ops/kernels/resblock.py, resblock_plan): float32, the SIMT tile of
// bm = 128 rows x bn = 64, 32 or 16 columns, K chunks of bk = 16, halo
// null; bf16, a halo block of bm = 128 MT rows x bn = 32 NA columns of
// CROWDMOD_RES_TILES and halo the 8 ints of HaloPlan (tb, hb, kc1,
// stages1, nbox1, kc2, stages2, nbox2), bk 0.  Returns a cudaError_t value.
extern "C" int crowdmod_resblock(
    int dtype, const void* x, const void* tvec, const void* b1, const void* w1, const void* w2,
    const void* gamma1, const void* beta1, const void* gamma2, const void* beta2,
    const void* bias2, void* a1, void* h1, void* ws, void* out, int batch, int t, int h, int w,
    int cin, int cout, int groups, float eps, int has_skip, int bm, int bn, int bk,
    const int* halo, void* stream) {
  using namespace crowdmod;
  if (batch < 0 || t < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 || groups < 1 ||
      groups > kMaxGroups || cin % groups || cout % groups || batch > 65535 ||
      (!has_skip && cin != cout) || bm < kBM || bn < 1)
    return (int)cudaErrorInvalidValue;
  const Geom g{batch, t, h, w};
  if (g.volume() < kBM) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  if ((g.positions() + kBM - 1) / kBM > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  float* wsf = static_cast<float*>(ws);
  // GN1's (mean, rstd) (f32) or partials (bf16), then GN2's.
  const long long gn1 = 2LL * batch * groups *
                        (dtype == 1 ? (g.volume() + kMomentRows - 1) / kMomentRows : 1);
  const Args a{x, w1, w2,
               static_cast<const float*>(tvec), static_cast<const float*>(b1),
               static_cast<const float*>(gamma1),
               static_cast<const float*>(beta1), static_cast<const float*>(gamma2),
               static_cast<const float*>(beta2), static_cast<const float*>(bias2),
               a1, h1, wsf, wsf + gn1, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && halo == nullptr)
    return launch_f32(a, g, cin, cout, groups, eps, has_skip, bm, bn, bk, s);
  if (dtype == 1 && halo != nullptr && a1 != nullptr && b1 != nullptr) {
    const HaloPlan p{halo[0], halo[1], halo[2], halo[3], halo[4], halo[5], halo[6], halo[7]};
    return launch_bf16(a, g, cin, cout, groups, eps, has_skip, bm, bn, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a bf16 conv block of the plan, in bytes (conv1:
// 1 for conv1's, 0 for conv2's; w: the input's width; na: 32-column atoms;
// kc, tb, hb, stages, nbox as HaloPlan's).
extern "C" int crowdmod_resblock_smem_bytes(int conv1, int w, int na, int kc, int tb, int hb,
                                            int stages, int nbox) {
  return crowdmod::res_smem_bytes(conv1 != 0, na, kc, (tb + 2) * (hb + 2) * (w + 2), stages,
                                  nbox);
}
