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
//   1. GN1 moments: a block per (sample, group), two passes (mean, then
//      squared deviations), as the GroupNorm kernel.
//   2. act1: a1 = bf16(silu(GN1(x))), one elementwise pass of 16-byte
//      vectors, so each activation is computed once and not once per tap
//      (the oracle rounds the GN output to the input type there too).
//   3. conv1: the im2col implicit GEMM of mma.cuh (MmaTile mainloop, a
//      cp.async ring of K chunks of 32 channels of one tap, mma.sync bf16
//      -> f32) over a1; the epilogue adds b1 + temb_proj, rounds to bf16 and
//      stores h1 as bf16 (where the oracle rounds it), and writes each
//      tile's per-(sample slot, group) sum and sum of squares of the rounded
//      values to a workspace (m_tiles, n_tiles, 2, G, 2): registers, quad and
//      warp shuffles, then shared memory in warp order, plain stores.
//   4. act2: each block first sums its sample's partials in tile order into
//      (mean, rstd), variance E[h^2] - E[h]^2 as the TPU kernel's; then
//      a2 = bf16(silu(GN2(h1))), written over h1.
//   5. conv2: the same mainloop over a2 (K = 27 * Cout), then Cin more K
//      rows of raw x at the centre tap times Ws (the 1x1 skip in the same
//      GEMM); the epilogue adds b2 (+ b_skip) or the identity x, rounds once.
//
// float32 (the check path) stays exact on the CUDA cores (common.cuh's
// gemm_mainloop), four launches: GN1 moments; conv1 with GN1 + SiLU applied
// to each element as it is staged, h1 stored as f32; GN2 moments over h1,
// two passes as GN1's (the twin's arithmetic: a one-pass variance moved the
// f32 output far enough from the twin's to flip the sign of a near-zero rho
// in the Sparsity chain); conv2 with GN2 + SiLU on load and the skip as
// extra K rows.
//
// A tile's rows may span two samples, never more: the volume must be at
// least the tile's rows (the wrapper's MIN_VOLUME; the UNet routes only
// volumes of 1024 and more here).  Rows of the second sample go to slot 1.
//
// Interface: plain C, loaded with ctypes; launches on the given stream and
// returns cudaGetLastError() after each launch.

#include "common.cuh"
#include "mma.cuh"

namespace crowdmod {
namespace {

constexpr int kMaxGroups = 32;

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

// A tile's GN2 partials from its column sums: colsum[w][slot][column][moment]
// holds, for each of NW row groups of the tile in order, the sums over its
// rows of the tile's BN columns.  part[(slot * G + g) * 2 + moment] = the
// sum over the row groups in order, then over g's columns in [n0, n0 + BN)
// in order (0 where g has none).  Ends with no barrier.
template <int NW, int BN>
__device__ void group_partials(const float* colsum, int n0, int cout, int groups,
                               float* __restrict__ part) {
  const int cg = cout / groups;
  for (int q = threadIdx.x; q < 4 * groups; q += kThreads) {
    const int slot = q / (2 * groups), g = q / 2 % groups, moment = q & 1;
    const int lo = max(g * cg, n0), hi = min(min((g + 1) * cg, n0 + BN), cout);
    float s = 0.f;
    for (int w = 0; w < NW; ++w)
      for (int c = lo; c < hi; ++c) s += colsum[((w * 2 + slot) * BN + c - n0) * 2 + moment];
    part[q] = s;
  }
}

// GN2's (mean, rstd) of sample b, group g: the partials of every row tile
// that holds sample b's rows, in tile order, each tile's N tiles in order.
__device__ float2 partial_stats(const float* __restrict__ part, int b, int g, int vol,
                                int groups, int cg, int bm, int n_tiles, float eps) {
  const long long lo = (long long)b * vol, hi = lo + vol;
  float s = 0.f, q = 0.f;
  for (long long t = lo / bm; t <= (hi - 1) / bm; ++t) {
    const int slot = b - (int)(t * bm / vol);
    for (int nt = 0; nt < n_tiles; ++nt) {
      const float* p = part + (t * n_tiles + nt) * 4 * groups + 2 * (slot * groups + g);
      s += p[0];
      q += p[1];
    }
  }
  const float n = (float)vol * cg;
  const float mean = s / n;
  return make_float2(mean, rsqrtf(fmaxf(q / n - mean * mean, 0.f) + eps));
}

// ---------------------------------------------------------------------------
// bf16: activations once, convs on the tensor cores
// ---------------------------------------------------------------------------

// out = bf16(silu(GN(in))) over sample blockIdx.y, 8 channels a step (C %
// 8 == 0), (mean, rstd) from stats (B, G, 2) or, when part is set, summed
// from the GN2 partials first.  in and out may be one buffer.
__global__ void __launch_bounds__(kThreads)
gn_silu_kernel(const bf16* in, bf16* out, const float* __restrict__ stats,
               const float* __restrict__ part, const float* __restrict__ gamma,
               const float* __restrict__ beta, int vol, int C, int groups, float eps, int bm,
               int n_tiles) {
  __shared__ float2 st[kMaxGroups];
  const int b = blockIdx.y, cg = C / groups;
  if (threadIdx.x < groups)
    st[threadIdx.x] =
        part ? partial_stats(part, b, threadIdx.x, vol, groups, cg, bm, n_tiles, eps)
             : reinterpret_cast<const float2*>(stats)[b * groups + threadIdx.x];
  __syncthreads();
  const long long base = (long long)b * vol * C, nvec = (long long)vol * C / 8;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nvec;
       i += (long long)gridDim.x * kThreads) {
    const int c0 = (int)(i * 8 % C);
    const uint4 raw = *reinterpret_cast<const uint4*>(in + base + i * 8);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 res;
    __nv_bfloat162* r = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(h[e]);
      const int c = c0 + 2 * e;
      const float2 s0 = st[c / cg], s1 = st[(c + 1) / cg];
      r[e] = __floats2bfloat162_rn(silu((v.x - s0.x) * s0.y * gamma[c] + beta[c]),
                                   silu((v.y - s1.x) * s1.y * gamma[c + 1] + beta[c + 1]));
    }
    *reinterpret_cast<uint4*>(out + base + i * 8) = res;
  }
}

// The bf16 tile: 128 positions x 32 channels, K chunks of 32 (Cin = 96 is
// no multiple of 64), 4 x 2 warps, a ring of 4 chunks; ops/kernels/
// resblock.py's resblock_plan names the same (BM, BN, BK).
using ResTile = MmaTile<128, 32, 32, 4, 2, 4>;

// conv1: h1 = bf16(a1 (*) w1 + tvec[sample]) over one BM x BN tile, and the
// tile's GN2 partials of the rounded h1.
template <class Tile>
__global__ void __launch_bounds__(kThreads, kMmaMinBlocks)
conv1_mma_kernel(const bf16* __restrict__ a1, const bf16* __restrict__ w1,
                 const float* __restrict__ tvec, bf16* __restrict__ h1,
                 float* __restrict__ part, Geom g, int cin, int cout, int groups) {
  constexpr int BM = Tile::BM, BN = Tile::BN, BK = Tile::BK, MI = Tile::MI, NI = Tile::NI;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ int4 rows[BM];
  __shared__ float colsum[Tile::WM * 2 * BN * 2];
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
#pragma unroll
  for (int q = 0; q < BM / kBM; ++q) stage_rows(rows + q * kBM, m0 + q * kBM, g);
  __syncthreads();
  const auto col = [=](int n) { return n0 + n < cout ? n0 + n : -1; };
  const int cpt = (cin + BK - 1) / BK;  // K chunks a tap
  float acc[MI][NI][4];
  Tile::mainloop(
      smem, 27 * cpt,
      [&](int i, bf16* st) {
        const int tap = i / cpt, c0 = (i - tap * cpt) * BK, live = min(BK, cin - c0);
        stage_a_rows<BM, BK>(st, a1, rows, g, cin, tap / 9 - 1, tap / 3 % 3 - 1, tap % 3 - 1,
                             c0, live, true);
        stage_b<BN, BK>(st + Tile::A_ELEMS, w1, (long long)tap * cin + c0, live, cout, true,
                        col);
      },
      [&](int i) { return (min(BK, cin - i % cpt * BK) + 15) / 16; }, acc);

  // Epilogue: round, store, and sum the rounded values by (slot, column).
  const int lane = threadIdx.x & 31, wr = Tile::warp_row(), wc = Tile::warp_col();
  const int first = rows[0].x;
  float cs[2][NI][2][2];  // [slot][n tile][column of the pair][moment]
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) cs[s][ni][e >> 1][e & 1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wr + mi * 16 + half * 8 + (lane >> 2);
      const int4 rw = rows[r];
      if (rw.x < 0) continue;
      const long long m = m0 + r;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wc + ni * 8 + 2 * (lane & 3);
        if (n >= cout) continue;
        const float* tv = tvec + (long long)rw.x * cout + n;
        const __nv_bfloat162 hv = __floats2bfloat162_rn(acc[mi][ni][2 * half] + tv[0],
                                                        acc[mi][ni][2 * half + 1] + tv[1]);
        *reinterpret_cast<__nv_bfloat162*>(h1 + m * cout + n) = hv;
        const float2 f = __bfloat1622float2(hv);
        if (rw.x != first) {
          cs[1][ni][0][0] += f.x;
          cs[1][ni][0][1] = fmaf(f.x, f.x, cs[1][ni][0][1]);
          cs[1][ni][1][0] += f.y;
          cs[1][ni][1][1] = fmaf(f.y, f.y, cs[1][ni][1][1]);
        } else {
          cs[0][ni][0][0] += f.x;
          cs[0][ni][0][1] = fmaf(f.x, f.x, cs[0][ni][0][1]);
          cs[0][ni][1][0] += f.y;
          cs[0][ni][1][1] = fmaf(f.y, f.y, cs[0][ni][1][1]);
        }
      }
    }
  // Lanes 4k + t hold the same columns: sum over k, then lanes 0-3 write
  // the warp's column sums.
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = cs[s][ni][e >> 1][e & 1];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        cs[s][ni][e >> 1][e & 1] = v;
      }
  if (lane < 4) {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          colsum[(((wr / Tile::TM) * 2 + s) * BN + wc + ni * 8 + 2 * lane + (e >> 1)) * 2 +
                 (e & 1)] = cs[s][ni][e >> 1][e & 1];
  }
  __syncthreads();
  group_partials<Tile::WM, BN>(
      colsum, n0, cout, groups,
      part + ((long long)blockIdx.x * gridDim.y + blockIdx.y) * 4 * groups);
}

// conv2: out = a2 (*) w2 [+ x @ Ws] + bias2 [+ x], rounded once.
template <class Tile>
__global__ void __launch_bounds__(kThreads, kMmaMinBlocks)
conv2_mma_kernel(const bf16* __restrict__ a2, const bf16* __restrict__ x,
                 const bf16* __restrict__ w2, const float* __restrict__ bias2,
                 bf16* __restrict__ out, Geom g, int cin, int cout, int has_skip) {
  constexpr int BM = Tile::BM, BN = Tile::BN, BK = Tile::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ int4 rows[BM];
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
#pragma unroll
  for (int q = 0; q < BM / kBM; ++q) stage_rows(rows + q * kBM, m0 + q * kBM, g);
  __syncthreads();
  const auto col = [=](int n) { return n0 + n < cout ? n0 + n : -1; };
  const int cpt = (cout + BK - 1) / BK, conv_chunks = 27 * cpt;
  const int skip_chunks = has_skip ? (cin + BK - 1) / BK : 0;
  // Chunk i: channels [c0, c0 + live) of a2 under a tap, or of x at the
  // centre (the skip's K rows 27 * cout + c).
  const auto chunk = [&](int i, int& tap, int& c0, int& live) {
    if (i < conv_chunks) {
      tap = i / cpt;
      c0 = (i - tap * cpt) * BK;
      live = min(BK, cout - c0);
    } else {
      tap = -1;
      c0 = (i - conv_chunks) * BK;
      live = min(BK, cin - c0);
    }
  };
  float acc[Tile::MI][Tile::NI][4];
  Tile::mainloop(
      smem, conv_chunks + skip_chunks,
      [&](int i, bf16* st) {
        int tap, c0, live;
        chunk(i, tap, c0, live);
        if (tap >= 0) {
          stage_a_rows<BM, BK>(st, a2, rows, g, cout, tap / 9 - 1, tap / 3 % 3 - 1,
                               tap % 3 - 1, c0, live, true);
          stage_b<BN, BK>(st + Tile::A_ELEMS, w2, (long long)tap * cout + c0, live, cout, true,
                          col);
        } else {
          stage_a_rows<BM, BK>(st, x, rows, g, cin, 0, 0, 0, c0, live, true);
          stage_b<BN, BK>(st + Tile::A_ELEMS, w2, 27LL * cout + c0, live, cout, true, col);
        }
      },
      [&](int i) {
        int tap, c0, live;
        chunk(i, tap, c0, live);
        return (live + 15) / 16;
      },
      acc);
  const long long total = g.positions();
  Tile::for_each_pair(acc, [&](int r, int c, float v0, float v1) {
    const long long m = m0 + r;
    const int n = n0 + c;
    if (m >= total || n >= cout) return;
    v0 += bias2[n];
    v1 += bias2[n + 1];
    if (!has_skip) {
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(x + m * cin + n));
      v0 += xv.x;
      v1 += xv.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + m * cout + n) = __floats2bfloat162_rn(v0, v1);
  });
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
  const float *tvec, *gamma1, *beta1, *gamma2, *beta2, *bias2;
  void *a1, *h1;
  float *stats1, *rest;  // GN1's (mean, rstd), then f32: GN2's; bf16: its partials
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

template <class Tile>
int launch_bf16_tile(const Args& a, Geom g, int cin, int cout, int groups, float eps,
                     int has_skip, cudaStream_t stream) {
  const cudaError_t attr1 = allow_dynamic_smem(
      reinterpret_cast<const void*>(conv1_mma_kernel<Tile>), Tile::SMEM_BYTES);
  const cudaError_t attr2 = allow_dynamic_smem(
      reinterpret_cast<const void*>(conv2_mma_kernel<Tile>), Tile::SMEM_BYTES);
  if (attr1 != cudaSuccess) return (int)attr1;
  if (attr2 != cudaSuccess) return (int)attr2;
  const bf16* x = static_cast<const bf16*>(a.x);
  bf16* a1 = static_cast<bf16*>(a.a1);
  bf16* h1 = static_cast<bf16*>(a.h1);
  const int vol = g.volume();
  const dim3 grid((unsigned)((g.positions() + Tile::BM - 1) / Tile::BM),
                  (cout + Tile::BN - 1) / Tile::BN);
  cudaError_t err = launch_moments(x, a.stats1, g, cin, groups, eps, stream);
  if (err != cudaSuccess) return (int)err;
  gn_silu_kernel<<<act_grid((long long)vol * cin / 8, g.batch), kThreads, 0, stream>>>(
      x, a1, a.stats1, nullptr, a.gamma1, a.beta1, vol, cin, groups, eps, Tile::BM, grid.y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conv1_mma_kernel<Tile><<<grid, kThreads, Tile::SMEM_BYTES, stream>>>(
      a1, static_cast<const bf16*>(a.w1), a.tvec, h1, a.rest, g, cin, cout, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_silu_kernel<<<act_grid((long long)vol * cout / 8, g.batch), kThreads, 0, stream>>>(
      h1, h1, nullptr, a.rest, a.gamma2, a.beta2, vol, cout, groups, eps, Tile::BM, grid.y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conv2_mma_kernel<Tile><<<grid, kThreads, Tile::SMEM_BYTES, stream>>>(
      h1, x, static_cast<const bf16*>(a.w2), a.bias2, static_cast<bf16*>(a.out), g, cin, cout,
      has_skip);
  return (int)cudaGetLastError();
}

int launch_bf16(const Args& a, Geom g, int cin, int cout, int groups, float eps, int has_skip,
                int bm, int bn, int bk, cudaStream_t stream) {
  if (cin % 8 || cout % 8 || bm != ResTile::BM || bn != ResTile::BN || bk != ResTile::BK)
    return (int)cudaErrorInvalidValue;
  return launch_bf16_tile<ResTile>(a, g, cin, cout, groups, eps, has_skip, stream);
}

}  // namespace
}  // namespace crowdmod

// dtype: 0 = float32, 1 = bfloat16.  x: (batch, t, h, w, cin); out:
// (batch, t, h, w, cout), both in dtype, contiguous.  w1: (27*cin, cout),
// rows (kd, kh, kw, ci); w2: (27*cout [+ cin], cout), the 1x1 skip weight
// (cin, cout) appended when has_skip; both in dtype.  float32: tvec
// (batch, cout) = b1 + temb_proj; gamma1/beta1 (cin,); gamma2/beta2 (cout,);
// bias2 (cout,) = b2 [+ b_skip].  Scratch: a1 (batch*t*h*w, cin) bf16 (bf16
// only, else null); h1 (batch*t*h*w, cout) in dtype; ws float32: GN1's
// (mean, rstd) (batch, groups, 2), then float32: GN2's, the same shape;
// bf16: the GN2 partials (m_tiles, n_tiles, 2, groups, 2).  The plan (ops/kernels/resblock.py,
// resblock_plan): a tile of bm rows x bn columns and K chunks of bk
// (bf16: 128 x 32 by 32, ResTile; float32: 128 x 64, 32 or 16 by 16).  Returns a cudaError_t value.
extern "C" int crowdmod_resblock(
    int dtype, const void* x, const void* tvec, const void* w1, const void* w2,
    const void* gamma1, const void* beta1, const void* gamma2, const void* beta2,
    const void* bias2, void* a1, void* h1, void* ws, void* out, int batch, int t, int h, int w,
    int cin, int cout, int groups, float eps, int has_skip, int bm, int bn, int bk,
    void* stream) {
  using namespace crowdmod;
  if (batch < 0 || t < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 || groups < 1 ||
      groups > kMaxGroups || cin % groups || cout % groups || batch > 65535 ||
      (!has_skip && cin != cout) || bm < kBM || bn < 1)
    return (int)cudaErrorInvalidValue;
  const Geom g{batch, t, h, w};
  if (g.volume() < bm) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  if ((g.positions() + bm - 1) / bm > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  float* wsf = static_cast<float*>(ws);
  const Args a{x, w1, w2,
               static_cast<const float*>(tvec), static_cast<const float*>(gamma1),
               static_cast<const float*>(beta1), static_cast<const float*>(gamma2),
               static_cast<const float*>(beta2), static_cast<const float*>(bias2),
               a1, h1, wsf, wsf + 2 * batch * groups, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(a, g, cin, cout, groups, eps, has_skip, bm, bn, bk, s);
  if (dtype == 1 && a1 != nullptr)
    return launch_bf16(a, g, cin, cout, groups, eps, has_skip, bm, bn, bk, s);
  return (int)cudaErrorInvalidValue;
}
