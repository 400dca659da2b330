// bf16 tensor-core building blocks for sm_90a: 16-byte cp.async copies into
// a ring of shared-memory stages, ldmatrix fragment loads and the warp-level
// mma.sync.m16n8k16 product with f32 accumulators.  Used by conv3d.cu and
// resblock.cu (the MmaTile main loop) and attention.cu (the primitives).
//
// A block of kThreads (8 warps) computes a BM x BN tile over K in chunks of
// BK (32 or 64).  A stage holds the A chunk as BM rows of BK bf16 (row-
// major, m by k) and the B chunk as BK rows of BN bf16 (row-major, k by n,
// read with ldmatrix.trans), each row padded by 8 elements: the row strides
// ((BK + 8) * 2 and (BN + 8) * 2 bytes, an odd number of 16-byte units for
// BK = 32, 64 and BN = 32, 64, 96, 128) put the eight rows an ldmatrix
// phase reads in eight distinct bank groups, so fragment loads are free of
// conflicts without a swizzle.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace crowdmod {

using bf16 = __nv_bfloat16;

// Blocks a multiprocessor keeps resident: __launch_bounds__ then caps the
// registers at 128 a thread, so two 8-warp blocks hide each other's
// barrier and copy waits.
constexpr int kMmaMinBlocks = 2;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; live = false writes 16 zero bytes
// and reads nothing (src-size 0), which is how padding reaches the tile.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 inputs, f32 sums.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tile geometry: a BM x BN block tile, K chunks of BK, a ring of STAGES
// chunks; WM x WN warps, each a (BM/WM) x (BN/WN) tile of MI x NI mma tiles
// of 16 x 8.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct MmaTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static_assert(WM * WN * 32 == kThreads, "8 warps");
  static_assert(BK == 32 || BK == 64, "K chunks of 32 or 64");
  static constexpr int LDA = BK + 8, LDB = BN + 8;
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;  // bf16 elements
  static constexpr int SMEM_BYTES = STAGES * STAGE * 2;
  static constexpr int TM = BM / WM, TN = BN / WN;
  static constexpr int MI = TM / 16, NI = TN / 8;
  static_assert(TM % 16 == 0 && TN % 16 == 0, "whole x4 fragment loads");

  __device__ static int warp_row() { return (threadIdx.x >> 5) / WN * TM; }
  __device__ static int warp_col() { return (threadIdx.x >> 5) % WN * TN; }

  // acc += A_stage @ B_stage over the first `ksteps` 16-deep slices of the
  // chunk (the rest is zero padding).
  __device__ static void multiply(const bf16* s, int ksteps, float (&acc)[MI][NI][4]) {
    const bf16* as = s;
    const bf16* bs = s + A_ELEMS;
    const int lane = threadIdx.x & 31;
    const int r0 = warp_row(), c0 = warp_col();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      if (ks >= ksteps) break;
      unsigned a[MI][4], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(a[mi], as + (r0 + mi * 16 + (lane & 15)) * LDA + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int ni = 0; ni < NI; ni += 2) {
        unsigned r[4];
        ldmatrix_x4_trans(r, bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB +
                                 c0 + ni * 8 + (lane >> 4) * 8);
        b[ni][0] = r[0];
        b[ni][1] = r[1];
        b[ni + 1][0] = r[2];
        b[ni + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16_16816(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }

  // The ring: stage(i, slot) issues chunk i's copies into a slot (cp.async
  // or plain stores), ksteps(i) is its live depth in 16s.  Chunks i + 1 ..
  // i + STAGES - 1 are in flight while chunk i is multiplied.  Ends with every copy landed and a
  // barrier, so the caller may reuse the shared memory.
  template <class Stage, class Ksteps>
  __device__ static void mainloop(bf16* smem, int nchunks, Stage stage, Ksteps ksteps,
                                  float (&acc)[MI][NI][4]) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < nchunks) stage(i, smem + i * STAGE);
      cp_async_commit();
    }
    for (int i = 0; i < nchunks; ++i) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // chunk i landed; slot (i - 1) % STAGES is free
      const int next = i + STAGES - 1;
      if (next < nchunks) stage(next, smem + (next % STAGES) * STAGE);
      cp_async_commit();
      multiply(smem + (i % STAGES) * STAGE, ksteps(i), acc);
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // Visit every accumulator pair: f(row, col, v0, v1) for the two adjacent
  // columns col, col + 1 of tile row `row` (both relative to the tile).
  template <class F>
  __device__ static void for_each_pair(const float (&acc)[MI][NI][4], F f) {
    const int lane = threadIdx.x & 31;
    const int r0 = warp_row() + (lane >> 2), c0 = warp_col() + 2 * (lane & 3);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        f(r0 + mi * 16, c0 + ni * 8, acc[mi][ni][0], acc[mi][ni][1]);
        f(r0 + mi * 16 + 8, c0 + ni * 8, acc[mi][ni][2], acc[mi][ni][3]);
      }
  }
};

// A chunk of a shifted-row operand: tile row r reads `live` channels from
// c0 of input position rows[r] shifted by (dt, dh, dw), zero outside the
// volume or past `live`.  vec: 16-byte cp.async pieces, neighbouring
// threads on neighbouring pieces of a row (cin % 8 == 0 and live % 8 == 0);
// otherwise element loads and plain stores.
template <int BM, int BK>
__device__ __forceinline__ void stage_a_rows(bf16* as, const bf16* __restrict__ x,
                                             const int4* rows, const Geom& g, int cin,
                                             int dt, int dh, int dw, int c0, int live,
                                             bool vec) {
  constexpr int LDA = BK + 8, PIECES = BK / 8;
  if (vec) {
    const int piece = threadIdx.x % PIECES;
#pragma unroll
    for (int i = 0; i < BM / (kThreads / PIECES); ++i) {
      const int r = threadIdx.x / PIECES + i * (kThreads / PIECES);
      const long long p = tap_offset(rows[r], dt, dh, dw, g);
      const bool ok = p >= 0 && piece * 8 < live;
      cp_async16(as + r * LDA + piece * 8, ok ? x + p * cin + c0 + piece * 8 : x, ok);
    }
  } else {
    const int kk = threadIdx.x % BK;
#pragma unroll 4
    for (int i = 0; i < BM / (kThreads / BK); ++i) {
      const int r = threadIdx.x / BK + i * (kThreads / BK);
      const long long p = kk < live ? tap_offset(rows[r], dt, dh, dw, g) : -1;
      as[r * LDA + kk] = p >= 0 ? x[p * cin + c0 + kk] : __float2bfloat16(0.f);
    }
  }
}

// A B chunk: rows k0 .. k0 + live - 1 of a row-major weight with row stride
// ld; tile column n reads weight column col(n), or zero where col(n) < 0 or
// past `live`.  vec: 16-byte cp.async pieces (col(n) of a piece of 8 is
// contiguous and 8-aligned, or negative for the whole piece).
template <int BN, int BK, class Col>
__device__ __forceinline__ void stage_b(bf16* bs, const bf16* __restrict__ w, long long k0,
                                        int live, int ld, bool vec, Col col) {
  constexpr int LDB = BN + 8;
  if (vec) {
    for (int idx = threadIdx.x; idx < BK * BN / 8; idx += kThreads) {
      const int kk = idx / (BN / 8), n = idx % (BN / 8) * 8;
      const int c = col(n);
      const bool ok = kk < live && c >= 0;
      cp_async16(bs + kk * LDB + n, ok ? w + (k0 + kk) * ld + c : w, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < BK * BN; idx += kThreads) {
      const int kk = idx / BN, n = idx % BN;
      const int c = col(n);
      bs[kk * LDB + n] = (kk < live && c >= 0) ? w[(k0 + kk) * ld + c] : __float2bfloat16(0.f);
    }
  }
}

}  // namespace crowdmod
