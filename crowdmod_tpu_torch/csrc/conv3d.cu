// Stride-1 SAME 3x3x3 convolution for Hopper (sm_90a), channels-last:
//     out[b, t, h, w, :] = bias + sum_{kd, kh, kw, ci} x[b, t+kd-1, h+kh-1,
//                          w+kw-1, ci] * K[kd, kh, kw, ci, :]
// over (B, T, H, W, Cin) -> (B, T, H, W, Cout), f32 accumulation, the bias
// added in f32 before the one rounding to the input type (float or bf16).
// Taps outside the volume read zero; no padded copy of the input is made.
//
// Two entry points, two TPU kernels replaced, both in
// crowdmod_tpu/ops/pallas/conv3d.py:
//
//   crowdmod_conv3d_im2col  <- conv3d_same_im2col (kernel _kernel)
//     An implicit GEMM, N = Cout, K = 27*Cin, with the folded (27*Cin, Cout)
//     weight: the patch matrix never reaches device memory.
//
//   crowdmod_conv3d_tapgemm <- conv3d_same_tapgemm (kernel _tap_kernel)
//     For each of the 9 (kd, kh) slabs, the slab's rows times the (Cin,
//     3*Cout) tap-packed weight, the three kw taps side by side in N; then
//     the shifted accumulate out[w] = Z[w, kw=0] + Z[w+1, kw=1] +
//     Z[w+2, kw=2] through shared memory.
//
// What bounds them on the H100.  At batch 64 the UNet's convs do 27*Cin*
// Cout*2 flops a position against (Cin + Cout)*2 bytes (bf16): 300-1,700
// flops a byte, above the card's ridge point, so they are bound by the
// bf16 tensor-core rate, which only wgmma reaches.  An mma.sync design that
// gathers each K chunk's A rows from L2 by cp.async, with per-row tap
// arithmetic (commit cdc7807), is bound instead by that staging: each input
// row crosses into shared memory 27 times a block (im2col) or 9 (tap-GEMM),
// and a wgmma build over the same staging was barely faster.
//
// bf16: the halo tile (conv3d_halo_kernel, both entry points).
//   - An output tile is whole rows: bb samples x tb t slices x hb rows of H
//     x all of W (the plan, ops/kernels/conv3d.py, picks it).  For each
//     chunk of kc input channels (64; 32 or 16 where Cin % 64 != 0; 8 for
//     Cin <= 8) the block loads the tile's halo box (bb, tb+2, hb+2, W+2,
//     kc) once, by one 5-D TMA copy of the unpadded input at (c0, -1, h0-1,
//     t0-1, b0): TMA fills what lies outside the volume with zeros, so SAME
//     padding costs no branch and no padded copy.  Each input row crosses
//     into shared memory (tb+2)(hb+2)/(tb*hb) times a tile (3.3 at level
//     0), not 27.
//   - In the box's flat coordinates every tap is a constant offset of
//     dt*(hb+2)(W+2) + dh*(W+2) + dw positions.  The GEMM's M runs over the
//     padded positions of the tile's rows (W + 2 a row; the two pad columns
//     are computed and dropped, 2/38 at W = 36).  im2col walks the 27 tap
//     offsets against its weight; tap-GEMM the 9 slab offsets, then its
//     shifted accumulate through an f32 Z tile in shared memory.
//   - Products by wgmma m64n64k16 with f32 accumulators in registers: two
//     consumer warpgroups each take MT 64-row tiles of M.  A comes from
//     registers, loaded by ldmatrix at the shifted box rows (a descriptor
//     cannot start at an arbitrary row of a swizzle pattern; per-lane
//     ldmatrix addresses can).  The box is loaded 128-, 64- or 32-byte
//     swizzled (by kc) and each lane XORs its 16-byte chunk with its row, so
//     the eight rows of an ldmatrix phase hit eight bank groups.  With
//     kc = 8 a weight stage packs four taps of 8 channels, each k16 step
//     two taps (the two halves of the ldmatrix lanes), so the first conv
//     (Cin = 3) takes 7 stages, not 27.
//   - B, the weight rows of a stage (one tap's kc channels, or the four
//     packed taps), comes by TMA into a ring of 128-byte swizzled stages of
//     64-column atoms under mbarriers (full: the copy landed; empty: both
//     warpgroups are done with it); one producer warpgroup issues the
//     copies.  tap-GEMM's N is three atoms, one a kw tap, of 64 output
//     channels, or, where 3 Cout <= 128, one or two atoms over the weight's
//     own 3 Cout columns (Cout = 3 then multiplies 64 columns, not 192).
//   - Where TMA cannot stride (16-byte rows: Cin % 8 != 0, the first conv's
//     6-byte positions; Cout % 8 != 0 for the weight), the producer fills
//     the same layouts by element loads: the box zero-padded to 8
//     channels, the weight's live column chunks into a ring cleared once.
//   - Persistent blocks: one a multiprocessor (registers allow one) walks
//     the work items (tile, channel tile, split), so the producer loads the
//     next item's box and weights while the consumers finish the current
//     item's products and epilogue; where Cin takes several chunks, two
//     boxes let the next chunk's load run under this one's products.  In
//     im2col a warpgroup loads the next stage's A fragments while the
//     current wgmma group runs (wait_group 1); tap-GEMM's warpgroups wait
//     for each group and interleave with each other instead.
//   - The epilogue adds the f32 bias and rounds once (tap-GEMM: 8, 4 or 1
//     channels a thread).  Where the tiles alone leave the card idle (level
//     2, and every level at batch 1) the plan splits the taps in 2, 3 or 9
//     runs: each split writes f32 partial tiles and a second launch sums
//     them in split order.  No atomics: a second call gives the same bits.
// At level 0 64->64 im2col runs at about 270 TFLOP/s, tap-GEMM at about
// 280 (chip_smoke.py phase 2): near the rate its shared memory allows, since
// every stage reads the A rows by ldmatrix and wgmma reads the weight stage
// once for each of its four 64-row tiles, about as many bytes as the
// tensor cores take cycles.
//
// float32 keeps exact f32 arithmetic on the CUDA cores (the tolerance of
// the f32 checks rules out TF32 at K = 27*256).  Cout <= 4 (the UNet's final
// 32->3 conv, which runs in f32 on every forward) takes the narrow kernel:
// the block's f32 halo box, all channels, staged once by cp.async, and the
// whole (27, Cin, Cout) weight in shared memory, where a global-memory loop
// read its 27 taps x 32 channels with no reuse; it keeps that loop's order
// of sums, so its bits.  The other f32 shapes (the f32 checks only) keep
// the SIMT im2col loop of common.cuh and a SIMT tap-GEMM block of 160 rows
// x 16 channels.
//
// Interface: plain C, loaded with ctypes; launches on the given stream and
// returns cudaGetLastError().

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace crowdmod {
namespace {

using namespace hopper;

// ---------------------------------------------------------------------------
// bf16: the halo tile, TMA and wgmma
// ---------------------------------------------------------------------------

constexpr int kConsumers = 256;      // two warpgroups multiply
constexpr int kHaloThreads = 384;    // and one warpgroup stages
constexpr int kProducers = kHaloThreads - kConsumers;
constexpr int kMaxStages = 4;        // weight chunks in flight, at most
constexpr int kSmemLimit = 232448;   // dynamic shared memory a block may use

struct HaloArgs {
  const bf16* x;
  const bf16* w;
  const float* bias;
  bf16* out;
  float* partial;       // split k: (splits, positions, cout) f32 partials
  int batch, t, h, wd, cin, cout;
  int bb, tb, hb;       // the output tile: samples x t slices x h rows (all of W)
  int tiles_t, tiles_h; // tiles along t and h
  int mtiles, ntiles;   // output tiles, and channel tiles of bn (tap-GEMM: 64)
  int splits;           // tap splits; a work item is (tile, channel tile, split)
  int chunks;           // channel chunks of kc
  int stages, nbox;     // weight stages and halo boxes in flight
  int box_bytes;        // one halo box, rounded up to 1024
  int z_offset;         // tap-GEMM's Z tile, after the boxes and stages
  int bar_offset;       // the barriers, after the Z tile
  int x_tma, w_tma;     // 1: TMA; 0: the producer's element loads
};

// Dynamic shared memory of a halo block: the boxes, the weight ring,
// tap-GEMM's f32 Z tile (bm x (bn + 4)), the barriers, 1024 of alignment.
__host__ __device__ inline int halo_z_offset(int bn, int kc, int npos, int stages, int nbox) {
  const int box = (npos * kc * 2 + 1023) / 1024 * 1024;
  return nbox * box + stages * (bn / 64) * (kc == 8 ? 32 : kc) * 128;
}
__host__ __device__ inline int halo_bar_offset(int tap, int bm, int bn, int kc, int npos,
                                               int stages, int nbox) {
  return halo_z_offset(bn, kc, npos, stages, nbox) + (tap ? bm * (bn + 4) * 4 : 0);
}
__host__ __device__ inline int halo_smem_bytes(int tap, int bm, int bn, int kc, int npos,
                                               int stages, int nbox) {
  return 1024 + halo_bar_offset(tap, bm, bn, kc, npos, stages, nbox) + 8 * (4 + 2 * kMaxStages);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element loads of a halo box (Cin % 8 != 0) by the producer warpgroup:
// position p of the box, chunk q of 8 channels from c0, zero outside the
// volume and past Cin; the same swizzled layout TMA writes.  Four items'
// loads are issued before their stores.
template <int KC>
__device__ void fill_box(unsigned char* box, const HaloArgs& a, int c0, int b0, int t0, int h0,
                         int pt, int ph, int pw, int npos, int tid) {
  constexpr int Q = KC / 8, U = 4;
  const int items = npos * Q;
  for (int i0 = tid; i0 < items; i0 += U * kProducers) {
    float v[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kProducers, p = i / Q, q = i % Q;
      int r = p;
      const int w = r % pw - 1;
      r /= pw;
      const int hh = r % ph + h0 - 1;
      r /= ph;
      const int tt = r % pt + t0 - 1, b = r / pt + b0;
      const bool live = i < items && b < a.batch && (unsigned)tt < (unsigned)a.t &&
                        (unsigned)hh < (unsigned)a.h && (unsigned)w < (unsigned)a.wd;
      const bf16* src = a.x + ((((long long)b * a.t + tt) * a.h + hh) * a.wd + w) * a.cin;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int ch = c0 + q * 8 + e;
        v[u][e] = live && ch < a.cin ? __bfloat162float(src[ch]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kProducers;
      if (i < items)
        *reinterpret_cast<uint4*>(box + swizzle_chunk<KC * 2>(i / Q, i % Q)) =
            make_uint4(pack_bf16(v[u][0], v[u][1]), pack_bf16(v[u][2], v[u][3]),
                       pack_bf16(v[u][4], v[u][5]), pack_bf16(v[u][6], v[u][7]));
    }
  }
}

// Stage geometry of a channel chunk of KC: one tap's KC rows of the weight
// a stage, or, for KC = 8 (Cin <= 8, the first conv), four taps of 8 rows:
// a stage of 32 rows, each 16-step of K two taps (lanes 0-15 of an
// ldmatrix address one tap's rows, lanes 16-31 the next's), so the 27 taps
// take 7 stages, not 27.
template <int KC>
struct Chunk {
  static constexpr bool kPacked = KC == 8;
  static constexpr int kTaps = kPacked ? 4 : 1;       // taps a stage
  static constexpr int kRows = kPacked ? 32 : KC;     // weight rows a stage
  static constexpr int kSteps = kRows / 16;           // k16 steps a stage
  static constexpr int kAtom = kRows * 128;           // one 64-column atom
};

// The producer's element loads of a weight stage (Cout % 8 != 0): the taps
// j0 .. j0 + kTaps (zero from `hi`) of channels c0 .. c0 + KC (zero past
// Cin), atom `at` of 64 columns, in the layout TMA writes.  Only the
// 16-byte column chunks that reach a live column are written: the others
// stay the zeros the ring was cleared to.
template <int NA, int KC, bool TAP>
__device__ void fill_weights(unsigned char* st, const HaloArgs& a, int j0, int hi, int c0,
                             int n0, int tid) {
  using C = Chunk<KC>;
  constexpr bool kSplitKw = TAP && NA == 3;  // an atom a kw tap (else compact)
  const int ld = TAP ? 3 * a.cout : a.cout;
  const int ncols = kSplitKw ? a.cout : ld;  // the columns an atom indexes
#pragma unroll
  for (int at = 0; at < NA; ++at) {
    const int col0 = kSplitKw ? n0 : n0 + at * 64;  // the atom's first column
    const int live = min(max((ncols - col0 + 7) / 8, 0), 8);
    for (int i = tid; i < C::kRows * live; i += kProducers) {
      const int q = i % live, k = i / live;
      const int j = C::kPacked ? j0 + k / 8 : j0;
      const int ci = C::kPacked ? k % 8 : c0 + k;
      const int co0 = col0 + q * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j < hi && ci < a.cin) {
        const bf16* row = a.w + ((long long)j * a.cin + ci) * ld + (kSplitKw ? at * a.cout : 0);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (co0 + e < ncols) v[e] = __bfloat162float(row[co0 + e]);
      }
      *reinterpret_cast<uint4*>(st + at * C::kAtom + swizzle_chunk<128>(k, q)) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                     pack_bf16(v[6], v[7]));
    }
  }
}

// One work item of a persistent block: output tile, channel tile, split.
struct Work {
  int b0, t0, h0, n0, lo, hi, z;
};

// tap-GEMM's epilogue: out[w] = Z[w, kw 0] + Z[w + 1, kw 1] + Z[w + 2,
// kw 2] (+ bias, one rounding; or the f32 partial of a split) for the
// item's tile rows and its `cb` output channels, V channels a thread
// (16- or 8-byte Z reads and stores where V divides Cout).
template <int V, class OutPos>
__device__ __forceinline__ void shifted_accumulate(const HaloArgs& a, const Work& k,
                                                   const float* z, int ldz, int kwcol, int cb,
                                                   int pw, float* ws, const OutPos& out_pos) {
  const int orows = a.bb * a.tb * a.hb, nv = (cb + V - 1) / V;
  for (int idx = threadIdx.x; idx < orows * a.wd * nv; idx += kConsumers) {
    const int co = idx % nv * V, w = idx / nv % a.wd, r = idx / (nv * a.wd);
    const int n = k.n0 + co;
    if (n >= a.cout) continue;
    const long long pos = out_pos(r, w);
    if (pos < 0) continue;
    const float* zr = z + (r * pw + w) * ldz + co;
    float v[V];
    if constexpr (V == 1) {
      v[0] = zr[0] + zr[ldz + kwcol] + zr[2 * ldz + 2 * kwcol];
    } else {
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 z0 = *reinterpret_cast<const float4*>(zr + e);
        const float4 z1 = *reinterpret_cast<const float4*>(zr + ldz + kwcol + e);
        const float4 z2 = *reinterpret_cast<const float4*>(zr + 2 * ldz + 2 * kwcol + e);
        v[e] = z0.x + z1.x + z2.x;
        v[e + 1] = z0.y + z1.y + z2.y;
        v[e + 2] = z0.z + z1.z + z2.z;
        v[e + 3] = z0.w + z1.w + z2.w;
      }
    }
    if (ws != nullptr) {
      float* o = ws + pos * a.cout + n;
      if constexpr (V == 1) {
        o[0] = v[0];
      } else {
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(o + e) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
      }
      continue;
    }
    if (a.bias) {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] += a.bias[n + e];
    }
    bf16* o = a.out + pos * a.cout + n;
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(o) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    } else {
      o[0] = __float2bfloat16(v[0]);
    }
  }
}

// MT: 64-row tiles of M a consumer warpgroup takes (the block's M is
// 2 * MT * 64); NA: 64-column atoms of N (tap-GEMM: 3, one a kw tap, of the
// block's 64 output channels; or, where 3 Cout <= 128, 1 or 2 atoms over
// the weight's own 3 Cout columns, kw * Cout + co: the compact form, which
// does not pad Cout = 3 to 3 x 64 columns); KC: channels a chunk (8: the
// packed stages of Chunk).  A block runs on each multiprocessor and walks the work items
// blockIdx.x, + gridDim.x, ...: the producer loads the next item's box and
// weights while the consumers finish the current one and its epilogue.
template <int MT, int NA, int KC, bool TAP>
__global__ void __launch_bounds__(kHaloThreads, 1)
conv3d_halo_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, const HaloArgs a) {
  using C = Chunk<KC>;
  constexpr int RB = KC * 2;            // bytes of a box position
  constexpr int KS = C::kSteps;
  constexpr int STAGE = NA * C::kAtom;
  constexpr int NTAPS = TAP ? 9 : 27;
  constexpr bool kSplitKw = TAP && NA == 3;
  static_assert(KC == 8 || KC == 16 || KC == 32 || KC == 64, "chunks of 8-64 channels");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* boxes = base;
  unsigned char* ring = base + a.nbox * a.box_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + a.bar_offset);
  uint64_t* box_full = bars;
  uint64_t* box_empty = bars + 2;
  uint64_t* b_full = bars + 4;
  uint64_t* b_empty = bars + 4 + kMaxStages;

  const int pt = a.tb + 2, ph = a.hb + 2, pw = a.wd + 2;
  const int plane = ph * pw;
  const int npos = a.bb * pt * plane;
  const int rows = a.bb * a.tb * a.hb * pw;  // live GEMM rows of a tile
  const int items = a.mtiles * a.ntiles * a.splits;
  const auto work = [&](int w) {
    Work k;
    const int m = w % a.mtiles, rest = w / a.mtiles;
    k.h0 = m % a.tiles_h * a.hb;
    k.t0 = m / a.tiles_h % a.tiles_t * a.tb;
    k.b0 = m / (a.tiles_h * a.tiles_t) * a.bb;
    k.n0 = rest % a.ntiles * (kSplitKw ? 64 : 64 * NA);
    k.z = rest / a.ntiles;
    k.lo = k.z * NTAPS / a.splits;
    k.hi = (k.z + 1) * NTAPS / a.splits;
    return k;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&box_full[i], kProducers);
      mbar_init(&box_empty[i], kConsumers);
    }
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(&b_full[i], kProducers);
      mbar_init(&b_empty[i], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer: per work item and chunk, its halo box, then its weight
    // stages, the boxes and stages cycling across items.
    const int tid = threadIdx.x - kConsumers;
    if (!a.w_tma)  // clear the ring once: fill_weights writes only live columns
      for (int i = tid; i < a.stages * STAGE / 16; i += kProducers)
        reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
    int cc = 0, it = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const Work k = work(w);
      const int per_chunk = (k.hi - k.lo + C::kTaps - 1) / C::kTaps;
      for (int c = 0; c < a.chunks; ++c, ++cc) {
        const int slot = cc % a.nbox;
        unsigned char* box = boxes + slot * a.box_bytes;
        mbar_wait(&box_empty[slot], ((cc / a.nbox) & 1) ^ 1);
        if (a.x_tma) {
          if (tid == 0) {
            mbar_arrive_expect_tx(&box_full[slot], npos * RB);
            tma_load_5d(box, &xmap, &box_full[slot], c * KC, -1, k.h0 - 1, k.t0 - 1, k.b0);
          } else {
            mbar_arrive(&box_full[slot]);
          }
        } else {
          fill_box<KC>(box, a, c * KC, k.b0, k.t0, k.h0, pt, ph, pw, npos, tid);
          mbar_arrive(&box_full[slot]);  // read by ldmatrix: no proxy fence
        }
        for (int g = 0; g < per_chunk; ++g, ++it) {
          const int s = it % a.stages, j0 = k.lo + g * C::kTaps;
          unsigned char* st = ring + s * STAGE;
          mbar_wait(&b_empty[s], ((it / a.stages) & 1) ^ 1);
          if (a.w_tma) {
            if (tid == 0) {
              // Packed taps past the last lie past the weight's end: zeros.
              mbar_arrive_expect_tx(&b_full[s], STAGE);
#pragma unroll
              for (int at = 0; at < NA; ++at)
#pragma unroll
                for (int q = 0; q < C::kTaps; ++q)
                  tma_load_2d(st + at * C::kAtom + q * (C::kAtom / C::kTaps), &wmap, &b_full[s],
                              kSplitKw ? at * a.cout + k.n0 : k.n0 + at * 64,
                              (j0 + q) * a.cin + c * KC);
            } else {
              mbar_arrive(&b_full[s]);
            }
          } else {
            fill_weights<NA, KC, TAP>(st, a, j0, k.hi, c * KC, k.n0, tid);
            fence_proxy_async();  // read by wgmma, the async proxy
            mbar_arrive(&b_full[s]);
          }
        }
      }
    }
    return;
  }

  // Consumers.
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
  // The box position under each of this lane's ldmatrix rows at tap offset
  // 0: GEMM row m is padded column m % pw of tile row m / pw.  Rows past
  // the tile read an interior position, every tap of which lies in the box.
  int center[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = (wg * MT + mt) * 64 + warp * 16 + (lane & 15);
    int r = m / pw;
    const int hh = r % a.hb;
    r /= a.hb;
    center[mt] = m < rows ? ((r / a.tb * pt + r % a.tb + 1) * ph + hh + 1) * pw + m % pw
                          : (ph + 1) * pw + 1;
  }
  const auto tap_shift = [&](int j) {
    return TAP ? (j / 3 - 1) * plane + (j % 3 - 1) * pw
               : (j / 9 - 1) * plane + (j / 3 % 3 - 1) * pw + (j % 3 - 1);
  };
  float acc[MT][NA][32];
  const auto fence_acc = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int at = 0; at < NA; ++at)
#pragma unroll
        for (int e = 0; e < 32; ++e) fence_operand(acc[mt][at][e]);
  };
  const long long positions = (long long)a.batch * a.t * a.h * a.wd;
  const int tr = lane >> 2, tc = 2 * (lane & 3);
  float* z = reinterpret_cast<float*>(base + a.z_offset);
  constexpr int LDZ = NA * 64 + 4;

  int cc = 0, gi = 0;  // chunks and stages consumed by earlier items
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Work k = work(w);
    const int per_chunk = (k.hi - k.lo + C::kTaps - 1) / C::kTaps;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int at = 0; at < NA; ++at)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[mt][at][e] = 0.f;

    // Stage i of the item: chunk i / per_chunk, taps lo + kTaps * (i %
    // per_chunk).  load_a reads its A fragments from the box (waiting for
    // the box at a chunk's first stage, releasing it after the last); mma
    // waits for its weights and issues its wgmma group.
    const int n_it = a.chunks * per_chunk;
    const auto load_a = [&](int i, uint32_t (&af)[MT][KS][4]) {
      const int c = i / per_chunk, g = i - c * per_chunk, slot = (cc + c) % a.nbox;
      if (g == 0) mbar_wait(&box_full[slot], ((cc + c) / a.nbox) & 1);
      const uint32_t box = smem_u32(boxes + slot * a.box_bytes);
      const int j0 = k.lo + g * C::kTaps;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        // Packed: lanes 0-15 take tap j0 + 2 ks, lanes 16-31 the next (a
        // tap past the last reads any row: its weights are zero).
        const int j = C::kPacked ? j0 + 2 * ks + (lane >> 4) : j0;
        const int q = C::kPacked ? 0 : 2 * ks + (lane >> 4);
        const int off = j < k.hi ? tap_shift(j) : 0;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // The two pad columns of a tile's first and last rows reach one
          // position past the box; their sums are dropped.
          const int p = min(max(center[mt] + off, 0), npos - 1);
          ldsm_x4(af[mt][ks], box + swizzle_chunk<RB>(p, q));
        }
      }
      if (g == per_chunk - 1) mbar_arrive(&box_empty[slot]);
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
            wgmma_m64n64k16_rs(acc[mt][at], af[mt][ks],
                               desc_sw128(st + at * C::kAtom + ks * 2048, C::kAtom, 1024));
      wgmma_commit();
    };
    // im2col: two sets of A fragments, stage i + 1's loaded while stage
    // i's wgmma group runs; a set is reloaded only after wait_group 1 has
    // retired the group that read it, and a weight stage is released once
    // its group has retired.  tap-GEMM (three groups of N a stage) waits
    // for each group: its two warpgroups interleave, and chip_smoke's A/B
    // had it 5-11% faster so.  The accumulators are fenced only where no
    // group is in flight (an instruction that defines them inside the
    // pipeline makes ptxas serialise every wgmma).
    uint32_t af0[MT][KS][4];
    fence_acc();
    if constexpr (TAP) {
      for (int i = 0; i < n_it; ++i) {
        load_a(i, af0);
        mma(i, af0);
        wgmma_wait<0>();
        fence_acc();
        mbar_arrive(&b_empty[(gi + i) % a.stages]);
      }
    } else {
      uint32_t af1[MT][KS][4];
      load_a(0, af0);
      for (int i = 0; i < n_it; i += 2) {
        mma(i, af0);
        wgmma_wait<1>();
        if (i > 0) mbar_arrive(&b_empty[(gi + i - 1) % a.stages]);
        if (i + 1 >= n_it) break;
        load_a(i + 1, af1);
        mma(i + 1, af1);
        wgmma_wait<1>();
        mbar_arrive(&b_empty[(gi + i) % a.stages]);
        if (i + 2 < n_it) load_a(i + 2, af0);
      }
      wgmma_wait<0>();
      fence_acc();
      mbar_arrive(&b_empty[(gi + n_it - 1) % a.stages]);
    }
    cc += a.chunks;
    gi += n_it;

    float* ws = a.partial == nullptr ? nullptr : a.partial + k.z * positions * a.cout;
    // Output position of tile row r (of bb * tb * hb) at column w, or -1.
    const auto out_pos = [&](int r, int w) -> long long {
      const int hh = r % a.hb;
      r /= a.hb;
      const int tt = k.t0 + r % a.tb, b = k.b0 + r / a.tb, h = k.h0 + hh;
      if (b >= a.batch || tt >= a.t || h >= a.h) return -1;
      return (((long long)b * a.t + tt) * a.h + h) * a.wd + w;
    };

    if constexpr (!TAP) {
      const bool pairs = (a.cout & 1) == 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = (wg * MT + mt) * 64 + warp * 16 + tr + 8 * half;
          const int wp = m % pw;
          if (m >= rows || wp == 0 || wp > a.wd) continue;
          const long long pos = out_pos(m / pw, wp - 1);
          if (pos < 0) continue;
#pragma unroll
          for (int at = 0; at < NA; ++at)
#pragma unroll
            for (int jn = 0; jn < 8; ++jn) {
              const int n = k.n0 + at * 64 + jn * 8 + tc;
              if (n >= a.cout) continue;
              float v0 = acc[mt][at][jn * 4 + 2 * half];
              float v1 = acc[mt][at][jn * 4 + 2 * half + 1];
              if (ws != nullptr) {
                float* o = ws + pos * a.cout + n;
                o[0] = v0;
                if (n + 1 < a.cout) o[1] = v1;
                continue;
              }
              bf16* o = a.out + pos * a.cout + n;
              v0 += a.bias ? a.bias[n] : 0.f;
              if (n + 1 < a.cout) {
                v1 += a.bias ? a.bias[n + 1] : 0.f;
                if (pairs) {
                  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
                } else {
                  o[0] = __float2bfloat16(v0);
                  o[1] = __float2bfloat16(v1);
                }
              } else {
                o[0] = __float2bfloat16(v0);
              }
            }
        }
    } else {
      // Shifted accumulate of the three kw column groups through the Z
      // tile; the first barrier waits until every consumer has read the
      // previous item's Z.
      named_barrier(1, kConsumers);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = (wg * MT + mt) * 64 + warp * 16 + tr + 8 * half;
#pragma unroll
          for (int at = 0; at < NA; ++at)
#pragma unroll
            for (int jn = 0; jn < 8; ++jn)
              *reinterpret_cast<float2*>(z + m * LDZ + at * 64 + jn * 8 + tc) = make_float2(
                  acc[mt][at][jn * 4 + 2 * half], acc[mt][at][jn * 4 + 2 * half + 1]);
        }
      named_barrier(1, kConsumers);
      // Z column of (kw, co): kw * 64 + co, or kw * Cout + co (compact).
      const int kwcol = kSplitKw ? 64 : a.cout;
      const int cb = kSplitKw ? 64 : a.cout;  // output channels a work item
      if (a.cout % 8 == 0)
        shifted_accumulate<8>(a, k, z, LDZ, kwcol, cb, pw, ws, out_pos);
      else if (a.cout % 4 == 0)
        shifted_accumulate<4>(a, k, z, LDZ, kwcol, cb, pw, ws, out_pos);
      else
        shifted_accumulate<1>(a, k, z, LDZ, kwcol, cb, pw, ws, out_pos);
    }
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

// Cout <= 4 (the final conv): a block owns tb x hb output rows of one
// sample, all of W, a thread an output position (the threads stride over
// the tile).  The block's whole halo box (tb + 2, hb + 2, W + 2, all Cin
// channels) is staged once by 16-byte cp.async copies (zero outside the
// volume), as float4 chunks of 4 channels [ci / 4][slot] with slot p + p / 8
// (a pad every 8 positions spreads the threads' reads over the banks), and
// the weight as a float4 (Cout values, zero padded) a (tap, ci); both are
// read from shared memory, the weight as broadcasts.  Each output sums its
// 27 taps in order, each over its channels in order, one fmaf chain an
// output channel, as commit cdc7807's global-memory loop did: the same
// bits, so the f32 paths' chains (whose Sparsity sign flips make them
// sensitive to the last bit) do not move.  It is bound by its shared-memory
// reads: a float4 of input and four of weight for 4 x Cout FMAs.
__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Shared memory of a narrow block, in bytes.
__host__ __device__ inline int narrow_smem_bytes(int cin, int tb, int hb, int w) {
  const int npos = (tb + 2) * (hb + 2) * (w + 2);
  return (27 * cin + cin / 4 * (npos + npos / 8 + 1)) * 16;
}

template <int CO>
__global__ void __launch_bounds__(kThreads)
conv3d_narrow_f32_kernel(const float* __restrict__ x, const float* __restrict__ wmat,
                         const float* __restrict__ bias, float* __restrict__ out, Geom g,
                         int cin, int tb, int hb, int tiles_t, int tiles_h) {
  extern __shared__ __align__(16) float4 nsm[];
  const int ph = hb + 2, pw = g.w + 2;
  const int npos = (tb + 2) * ph * pw, slots = npos + npos / 8 + 1;
  float4* w_s = nsm;
  float4* box = nsm + 27 * cin;
  int bx = blockIdx.x;
  const int h0 = bx % tiles_h * hb;
  bx /= tiles_h;
  const int t0 = bx % tiles_t * tb, b = bx / tiles_t;
  const int tid = threadIdx.x;
  for (int i = tid; i < cin / 4 * npos; i += kThreads) {
    const int c4 = i / npos, p = i - c4 * npos;
    int r = p;
    const int w = r % pw - 1;
    r /= pw;
    const int hh = r % ph + h0 - 1, tt = r / ph + t0 - 1;
    const bool ok = (unsigned)w < (unsigned)g.w && (unsigned)hh < (unsigned)g.h &&
                    (unsigned)tt < (unsigned)g.t;
    const float* src =
        ok ? x + ((((long long)b * g.t + tt) * g.h + hh) * g.w + w) * cin + 4 * c4 : x;
    cp_async16(box + c4 * slots + p + (p >> 3), src, ok);
  }
  cp_async_commit();
  for (int i = tid; i < 27 * cin; i += kThreads) {
    float v[4];
#pragma unroll
    for (int co = 0; co < 4; ++co) v[co] = co < CO ? wmat[(long long)i * CO + co] : 0.f;
    w_s[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int q = tid; q < tb * hb * g.w; q += kThreads) {
    const int w = q % g.w, r = q / g.w, hh = r % hb, tt = r / hb;
    if (t0 + tt >= g.t || h0 + hh >= g.h) continue;
    float acc[CO];
#pragma unroll
    for (int co = 0; co < CO; ++co) acc[co] = 0.f;
    for (int tap = 0; tap < 27; ++tap) {
      const int p = ((tt + tap / 9) * ph + hh + tap / 3 % 3) * pw + w + tap % 3;
      const float4* xs = box + p + (p >> 3);
      const float4* wt = w_s + tap * cin;
#pragma unroll 4
      for (int c4 = 0; c4 < cin / 4; ++c4) {
        const float4 xq = xs[c4 * slots];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 wv = wt[4 * c4 + v];
#pragma unroll
          for (int co = 0; co < CO; ++co) acc[co] = fmaf(lane4(xq, v), lane4(wv, co), acc[co]);
        }
      }
    }
    const long long m = (((long long)b * g.t + t0 + tt) * g.h + h0 + hh) * g.w + w;
#pragma unroll
    for (int co = 0; co < CO; ++co) out[m * CO + co] = acc[co] + (bias ? bias[co] : 0.f);
  }
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

// A call's plan (ops/kernels/conv3d.py, ConvPlan.args): block rows bm and
// columns bn, channel chunk kc, the output tile (bb samples, tb t slices,
// hb h rows), stages, halo boxes and splits.
struct Plan {
  int bm, bn, kc, bb, tb, hb, stages, nbox, splits;
};

int launch_splitk_reduce(const float* partial, const float* bias, bf16* out, long long elems,
                         int cout, int splits, cudaStream_t stream) {
  const int v = cout % 4 == 0 ? 4 : 1;
  const long long want = (elems / v + kThreads - 1) / kThreads;
  const long long blocks = want < kMaxGridX ? want : kMaxGridX;
  if (v == 4)
    splitk_reduce_kernel<4><<<(unsigned)blocks, kThreads, 0, stream>>>(partial, bias, out, elems,
                                                                       cout, splits);
  else
    splitk_reduce_kernel<1><<<(unsigned)blocks, kThreads, 0, stream>>>(partial, bias, out, elems,
                                                                       cout, splits);
  return (int)cudaGetLastError();
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

template <int MT, int NA, int KC, bool TAP>
int launch_halo(HaloArgs a, const Plan& p, cudaStream_t stream) {
  const int pt = p.tb + 2, ph = p.hb + 2, pw = a.wd + 2;
  const int npos = p.bb * pt * ph * pw;
  a.bb = p.bb;
  a.tb = p.tb;
  a.hb = p.hb;
  a.tiles_t = (a.t + p.tb - 1) / p.tb;
  a.tiles_h = (a.h + p.hb - 1) / p.hb;
  a.chunks = (a.cin + KC - 1) / KC;
  a.stages = p.stages;
  a.nbox = p.nbox;
  a.box_bytes = (npos * KC * 2 + 1023) / 1024 * 1024;
  a.z_offset = halo_z_offset(p.bn, KC, npos, p.stages, p.nbox);
  a.bar_offset = halo_bar_offset(TAP, p.bm, p.bn, KC, npos, p.stages, p.nbox);
  a.x_tma = a.cin % 8 == 0;
  a.w_tma = a.cout % 8 == 0;
  const int smem = halo_smem_bytes(TAP, p.bm, p.bn, KC, npos, p.stages, p.nbox);
  const long long mtiles = (long long)((a.batch + p.bb - 1) / p.bb) * a.tiles_t * a.tiles_h;
  a.ntiles = TAP ? (NA == 3 ? (a.cout + 63) / 64 : 1) : (a.cout + p.bn - 1) / p.bn;
  a.splits = p.splits;
  const long long items = mtiles * a.ntiles * p.splits;
  if (p.bb < 1 || p.tb < 1 || p.hb < 1 || p.bb * p.tb * p.hb * pw > p.bm || pw > 256 ||
      ph > 256 || pt > 256 || p.bb > 256 || p.stages < 2 || p.stages > kMaxStages ||
      p.nbox < 1 || p.nbox > 2 || smem > kSmemLimit || items > kMaxGridX ||
      (Chunk<KC>::kPacked && (p.splits != 1 || a.cin > KC)) ||
      (TAP && NA < 3 && 3 * a.cout > 64 * NA))
    return (int)cudaErrorInvalidValue;
  a.mtiles = (int)mtiles;
  int sms = 0;
  const cudaError_t count = multiprocessors(&sms);
  if (count != cudaSuccess) return (int)count;

  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  if (a.x_tma) {
    const uint64_t e = 2;  // bytes a bf16
    const uint64_t dims[5] = {(uint64_t)a.cin, (uint64_t)a.wd, (uint64_t)a.h, (uint64_t)a.t,
                              (uint64_t)a.batch};
    const uint64_t strides[4] = {dims[0] * e, dims[0] * dims[1] * e,
                                 dims[0] * dims[1] * dims[2] * e,
                                 dims[0] * dims[1] * dims[2] * dims[3] * e};
    const uint32_t box[5] = {(uint32_t)KC, (uint32_t)pw, (uint32_t)ph, (uint32_t)pt,
                             (uint32_t)p.bb};
    const CUtensorMapSwizzle sw = KC == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : KC == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                  : KC == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                             : CU_TENSOR_MAP_SWIZZLE_NONE;
    const cudaError_t err = bf16_tensor_map(&xmap, a.x, 5, dims, strides, box, sw);
    if (err != cudaSuccess) return (int)err;
  }
  if (a.w_tma) {
    const uint64_t ld = TAP ? 3 * (uint64_t)a.cout : (uint64_t)a.cout;
    const uint64_t dims[2] = {ld, (uint64_t)(TAP ? 9 : 27) * a.cin};
    const uint64_t strides[1] = {ld * 2};
    const uint32_t box[2] = {64, (uint32_t)(Chunk<KC>::kRows / Chunk<KC>::kTaps)};
    const cudaError_t err =
        bf16_tensor_map(&wmap, a.w, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return (int)err;
  }
  const auto kernel = conv3d_halo_kernel<MT, NA, KC, TAP>;
  const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return (int)attr;
  // One persistent block a multiprocessor, or one an item where fewer.
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  kernel<<<grid, kHaloThreads, smem, stream>>>(xmap, wmap, a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  return launch_splitk_reduce(a.partial, a.bias, a.out,
                              (long long)a.batch * a.t * a.h * a.wd * a.cout, a.cout, p.splits,
                              stream);
}

// The built halo kernels, X(MT, NA, KC, TAP): (bm, bn) = (128 MT, 64 NA);
// ops/kernels/conv3d.py's HALO_TILES names the same (impl, bm, bn, kc).
#define CROWDMOD_HALO_TILES(X) \
  X(2, 1, 64, false)           \
  X(2, 1, 32, false)           \
  X(2, 1, 16, false)           \
  X(2, 1, 8, false)            \
  X(1, 1, 64, false)           \
  X(1, 1, 32, false)           \
  X(1, 1, 16, false)           \
  X(1, 1, 8, false)            \
  X(1, 3, 64, true)            \
  X(1, 3, 32, true)            \
  X(1, 3, 16, true)            \
  X(1, 3, 8, true)             \
  X(1, 2, 64, true)            \
  X(1, 2, 32, true)            \
  X(1, 2, 16, true)            \
  X(1, 2, 8, true)             \
  X(1, 1, 64, true)            \
  X(1, 1, 32, true)            \
  X(1, 1, 16, true)            \
  X(1, 1, 8, true)

int launch_halo_bf16(bool tap, const HaloArgs& a, const Plan& p, cudaStream_t stream) {
  if (p.splits < 1 || p.splits > 9 || (p.splits > 1 && a.partial == nullptr))
    return (int)cudaErrorInvalidValue;
#define CROWDMOD_LAUNCH(MT, NA, KC, TAP)                              \
  if (tap == TAP && p.bm == 128 * MT && p.bn == 64 * NA && p.kc == KC) \
    return launch_halo<MT, NA, KC, TAP>(a, p, stream);
  CROWDMOD_HALO_TILES(CROWDMOD_LAUNCH)
#undef CROWDMOD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

int launch_im2col_f32(const float* x, const float* w, const float* bias, float* out, Geom g,
                      int cin, int cout, const Plan& p, cudaStream_t stream) {
  if (p.splits != 1) return (int)cudaErrorInvalidValue;
  const long long positions = g.positions();
  if (p.bn == 4) {
    const int smem = narrow_smem_bytes(cin, p.tb, p.hb, g.w);
    const int tiles_t = (g.t + p.tb - 1) / p.tb, tiles_h = (g.h + p.hb - 1) / p.hb;
    const long long blocks = (long long)g.batch * tiles_t * tiles_h;
    if (cout > 4 || cin % 4 || p.kc != 4 || p.tb < 1 || p.hb < 1 || smem > kSmemLimit ||
        blocks > kMaxGridX)
      return (int)cudaErrorInvalidValue;
#define CROWDMOD_NARROW(CO)                                                                   \
  if (cout == CO) {                                                                           \
    const auto kernel = conv3d_narrow_f32_kernel<CO>;                                         \
    const cudaError_t attr = allow_smem(kernel, smem);                                        \
    if (attr != cudaSuccess) return (int)attr;                                                \
    kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(x, w, bias, out, g, cin, p.tb, p.hb, \
                                                         tiles_t, tiles_h);                   \
    return (int)cudaGetLastError();                                                           \
  }
    CROWDMOD_NARROW(1)
    CROWDMOD_NARROW(2)
    CROWDMOD_NARROW(3)
    CROWDMOD_NARROW(4)
#undef CROWDMOD_NARROW
    return (int)cudaErrorInvalidValue;
  }
  if (p.bm != kBM || p.kc != kBK) return (int)cudaErrorInvalidValue;
  if ((positions + kBM - 1) / kBM > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((positions + kBM - 1) / kBM), (cout + p.bn - 1) / p.bn);
  if (p.bn == 64)
    conv3d_im2col_f32_kernel<64><<<grid, kThreads, 0, stream>>>(x, w, bias, out, g, cin, cout);
  else if (p.bn == 32)
    conv3d_im2col_f32_kernel<32><<<grid, kThreads, 0, stream>>>(x, w, bias, out, g, cin, cout);
  else if (p.bn == 16)
    conv3d_im2col_f32_kernel<16><<<grid, kThreads, 0, stream>>>(x, w, bias, out, g, cin, cout);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int launch_tapgemm_f32(const float* x, const float* w, const float* bias, float* out, Geom g,
                       int cin, int cout, const Plan& p, cudaStream_t stream) {
  const int rpb = kTapM / (g.w + 2);
  if (rpb < 1 || p.bm != kTapM || p.bn != kTapN || p.kc != kBK || p.splits != 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)g.batch * g.t * g.h + rpb - 1) / rpb;
  if (blocks > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (cout + kTapC - 1) / kTapC);
  conv3d_tapgemm_f32_kernel<<<grid, kThreads, 0, stream>>>(x, w, bias, out, g, cin, cout, rpb);
  return (int)cudaGetLastError();
}

int launch(bool tap, int dtype, const void* x, const void* w, const void* bias, void* out,
           void* workspace, int batch, int t, int h, int wd, int cin, int cout, const Plan& p,
           void* stream) {
  if (batch < 0 || t < 0 || h < 0 || wd < 0 || cin < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  const Geom g{batch, t, h, wd};
  if (g.positions() == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    float* of = static_cast<float*>(out);
    return tap ? launch_tapgemm_f32(xf, wf, b, of, g, cin, cout, p, s)
               : launch_im2col_f32(xf, wf, b, of, g, cin, cout, p, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  HaloArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.bias = b;
  a.out = static_cast<bf16*>(out);
  a.partial = p.splits > 1 ? static_cast<float*>(workspace) : nullptr;
  a.batch = batch;
  a.t = t;
  a.h = h;
  a.wd = wd;
  a.cin = cin;
  a.cout = cout;
  return launch_halo_bf16(tap, a, p, s);
}

}  // namespace
}  // namespace crowdmod

// dtype: 0 = float32, 1 = bfloat16.  x: (batch, t, h, w, cin) contiguous;
// w: the folded (27*cin, cout) weight, rows (kd, kh, kw, ci); bias: (cout,)
// float32 or null; out: (batch, t, h, w, cout); workspace: a float32
// (splits, batch*t*h*w, cout) buffer when splits > 1, else null.  The plan
// (ops/kernels/conv3d.py ConvPlan.args): bf16 takes one of the halo tiles
// (bm, bn, kc) of CROWDMOD_HALO_TILES with the output tile (bb, tb, hb),
// 2-4 stages, 1-2 boxes, 1-9 splits; float32 takes the SIMT tile (bm
// 128, bn 64, 32 or 16, kc 16) or, for cout <= 4, the narrow kernel (bn 4,
// kc 4, the tile tb x hb).  Returns a cudaError_t value.
extern "C" int crowdmod_conv3d_im2col(int dtype, const void* x, const void* w, const void* bias,
                                      void* out, void* workspace, int batch, int t, int h,
                                      int wd, int cin, int cout, int bm, int bn, int kc, int bb,
                                      int tb, int hb, int stages, int nbox, int splits,
                                      void* stream) {
  return crowdmod::launch(false, dtype, x, w, bias, out, workspace, batch, t, h, wd, cin, cout,
                          {bm, bn, kc, bb, tb, hb, stages, nbox, splits}, stream);
}

// As above, with w the tap-packed (9, cin, 3*cout) weight: slab kd*3 + kh,
// column kw*cout + co.  bf16 takes bm 128, bn 192 (3 kw taps x 64
// channels); float32 the SIMT block (bm 160, bn 48, kc 16), w + 2 <= 160.
extern "C" int crowdmod_conv3d_tapgemm(int dtype, const void* x, const void* w, const void* bias,
                                       void* out, void* workspace, int batch, int t, int h,
                                       int wd, int cin, int cout, int bm, int bn, int kc, int bb,
                                       int tb, int hb, int stages, int nbox, int splits,
                                       void* stream) {
  return crowdmod::launch(true, dtype, x, w, bias, out, workspace, batch, t, h, wd, cin, cout,
                          {bm, bn, kc, bb, tb, hb, stages, nbox, splits}, stream);
}

// Dynamic shared memory of a block of the plan, in bytes (impl 0: im2col,
// 1: tap-GEMM; w and cin: the input's width and channels); 0 for the SIMT
// kernels, whose shared memory is static.
extern "C" int crowdmod_conv3d_smem_bytes(int impl, int dtype, int wd, int cin, int bm, int bn,
                                          int kc, int bb, int tb, int hb, int stages, int nbox) {
  using namespace crowdmod;
  if (dtype == 1)
    return halo_smem_bytes(impl, bm, bn, kc, bb * (tb + 2) * (hb + 2) * (wd + 2), stages, nbox);
  if (impl == 0 && bn == 4) return narrow_smem_bytes(cin, tb, hb, wd);
  return 0;
}
