// Stride-1 SAME 3x3x3 convolution for Hopper (sm_90a), channels-last:
//     out[b, t, h, w, :] = bias + sum_{kd, kh, kw, ci} x[b, t+kd-1, h+kh-1,
//                          w+kw-1, ci] * K[kd, kh, kw, ci, :]
// over (B, T, H, W, Cin) -> (B, T, H, W, Cout), f32 accumulation, the bias
// added in f32 before the one rounding to the input type (float or bf16).
// Taps outside the volume read zero: both kernels read the unpadded input
// and test each tap's coordinates, so no padded copy is ever made.
//
// Two kernels, two TPU kernels replaced, both in
// crowdmod_tpu/ops/pallas/conv3d.py:
//
//   crowdmod_conv3d_im2col  <- conv3d_same_im2col (kernel _kernel)
//     An implicit GEMM, M = B*T*H*W positions, N = Cout, K = 27*Cin, with
//     the folded (27*Cin, Cout) weight.  A block computes a 128-position x
//     BN-channel tile (BN = 64, 32 or 16 by Cout and grid size); each
//     16-deep K chunk of patches is built from the input as it is staged in
//     shared memory (common.cuh), so the patch matrix never reaches device
//     memory, as on the TPU.  Cin = 3 and Cout = 3 (the first and final
//     convs) are K and N edges of the same loop.
//
//   crowdmod_conv3d_tapgemm <- conv3d_same_tapgemm (kernel _tap_kernel)
//     For each (kd, kh), a slab of W+2 input columns (the columns either
//     side of the row read zero) times the (Cin, 3*Cout) weight with the
//     three kw taps side by side in N, summed over the 9 slabs into an f32
//     (W+2, 3*Cout) tile; then the shifted accumulate out[w] = Z[w, kw=0] +
//     Z[w+1, kw=1] + Z[w+2, kw=2].  A block takes R whole output rows (R =
//     160 / (W+2): 4 rows at W = 36, 8 at 18, 14 at 9) and 16 output
//     channels (48 GEMM columns), so the shifted accumulate stays inside the
//     block, through shared memory.
//
// What bounds them on the H100: operations.  At batch 64 the UNet's convs
// do 27*Cin*Cout*2 flops a position against (Cin + Cout) * 2 bytes (bf16):
// hundreds of flops a byte, above the card's ridge point.  These first
// kernels multiply on the CUDA cores in f32 (bf16 inputs are widened as
// they are staged), not on the tensor cores, so they are far from the bf16
// tensor-core bound; register tiles of 8 x (BN/16) sums a thread (im2col)
// and 10 x 3 (tap-GEMM) with operands from shared memory keep the FMA units
// fed.  wgmma on bf16 tiles is the later design.
//
// Interface: plain C, loaded with ctypes; launches on the given stream and
// returns cudaGetLastError().

#include "common.cuh"

namespace crowdmod {
namespace {

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
conv3d_im2col_kernel(const T* __restrict__ x, const T* __restrict__ wmat,
                     const float* __restrict__ bias, T* __restrict__ out,
                     Geom g, int cin, int cout) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) float a_s[kBK * kLdA];
  __shared__ __align__(16) float b_s[kBK * BN];
  __shared__ int4 rows[kBM];
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  stage_rows(rows, m0, g);
  __syncthreads();
  float acc[kTM][TN];
  gemm_mainloop<BN>(Im2colLoad<T>{x, g, cin}, wmat, 27 * cin, cout, n0, rows,
                    a_s, b_s, acc);
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  const long long total = g.positions();
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + tm * kTM + i;
    if (m >= total) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn * TN + j;
      if (n < cout)
        out[m * cout + n] = from_f<T>(acc[i][j] + (bias ? bias[n] : 0.f));
    }
  }
}

constexpr int kTapM = 160;  // GEMM rows of a tap-GEMM block: R * (W + 2)
constexpr int kTapC = 16;   // output channels of a block
constexpr int kTapN = 3 * kTapC;

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3d_tapgemm_kernel(const T* __restrict__ x, const T* __restrict__ wtap,
                      const float* __restrict__ bias, T* __restrict__ out,
                      Geom g, int cin, int cout, int rows_per_block) {
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
          if (p >= 0) v = to_f(x[p * cin + ci]);
        }
        xs[lk * kTapM + m] = v;
      }
      for (int idx = tid; idx < kBK * kTapN; idx += kThreads) {
        const int kk = idx / kTapN, n = idx % kTapN;
        const int c = ci0 + kk, co = c0 + n % kTapC, tap = n / kTapC;
        ws[idx] = (c < cin && co < cout)
                      ? to_f(wtap[((long long)slab * cin + c) * 3 * cout + tap * cout + co])
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
    const float v = zr[0] + zr[kTapN + kTapC] + zr[2 * kTapN + 2 * kTapC] +
                    (bias ? bias[co] : 0.f);
    out[((r0 + r) * g.w + w) * cout + co] = from_f<T>(v);
  }
}

template <typename T>
int launch_im2col(const void* x, const void* w, const float* bias, void* out,
                  Geom g, int cin, int cout, cudaStream_t stream) {
  const long long mtiles = (g.positions() + kBM - 1) / kBM;
  if (mtiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int bn = pick_bn(cout, mtiles);
  const dim3 grid((unsigned)mtiles, (cout + bn - 1) / bn);
  const T* xi = static_cast<const T*>(x);
  const T* wi = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  if (bn == 64)
    conv3d_im2col_kernel<T, 64><<<grid, kThreads, 0, stream>>>(xi, wi, bias, o, g, cin, cout);
  else if (bn == 32)
    conv3d_im2col_kernel<T, 32><<<grid, kThreads, 0, stream>>>(xi, wi, bias, o, g, cin, cout);
  else
    conv3d_im2col_kernel<T, 16><<<grid, kThreads, 0, stream>>>(xi, wi, bias, o, g, cin, cout);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tapgemm(const void* x, const void* w, const float* bias, void* out,
                   Geom g, int cin, int cout, cudaStream_t stream) {
  const int rpb = kTapM / (g.w + 2);
  if (rpb < 1) return (int)cudaErrorInvalidValue;
  const long long nrows = (long long)g.batch * g.t * g.h;
  const long long blocks = (nrows + rpb - 1) / rpb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (cout + kTapC - 1) / kTapC);
  conv3d_tapgemm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(out), g, cin, cout, rpb);
  return (int)cudaGetLastError();
}

bool bad_shape(int batch, int t, int h, int w, int cin, int cout) {
  return batch < 0 || t < 0 || h < 0 || w < 0 || cin < 1 || cout < 1;
}

}  // namespace
}  // namespace crowdmod

// dtype: 0 = float32, 1 = bfloat16.  x: (batch, t, h, w, cin) contiguous;
// w: the folded (27*cin, cout) weight, rows (kd, kh, kw, ci); bias: (cout,)
// float32 or null; out: (batch, t, h, w, cout).  Returns a cudaError_t value.
extern "C" int crowdmod_conv3d_im2col(int dtype, const void* x, const void* w,
                                      const void* bias, void* out, int batch,
                                      int t, int h, int wd, int cin, int cout,
                                      void* stream) {
  if (crowdmod::bad_shape(batch, t, h, wd, cin, cout)) return (int)cudaErrorInvalidValue;
  const crowdmod::Geom g{batch, t, h, wd};
  if (g.positions() == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) return crowdmod::launch_im2col<float>(x, w, b, out, g, cin, cout, s);
  if (dtype == 1) return crowdmod::launch_im2col<__nv_bfloat16>(x, w, b, out, g, cin, cout, s);
  return (int)cudaErrorInvalidValue;
}

// As above, with w the tap-packed (9, cin, 3*cout) weight: slab kd*3 + kh,
// column kw*cout + co.  Takes w + 2 <= 160.
extern "C" int crowdmod_conv3d_tapgemm(int dtype, const void* x, const void* w,
                                       const void* bias, void* out, int batch,
                                       int t, int h, int wd, int cin, int cout,
                                       void* stream) {
  if (crowdmod::bad_shape(batch, t, h, wd, cin, cout)) return (int)cudaErrorInvalidValue;
  const crowdmod::Geom g{batch, t, h, wd};
  if (g.positions() == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) return crowdmod::launch_tapgemm<float>(x, w, b, out, g, cin, cout, s);
  if (dtype == 1) return crowdmod::launch_tapgemm<__nv_bfloat16>(x, w, b, out, g, cin, cout, s);
  return (int)cudaErrorInvalidValue;
}
