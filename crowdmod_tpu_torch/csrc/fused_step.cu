// Fused DDPM ancestral update for Hopper (sm_90a):
//     x' = a * (x - b * eps) + sigma * z
//     x' = x' - (lambda * sigma) * sign(x')     on channel rho only (Sparsity)
// with a = 1/sqrt(alpha_t), b = beta_t / sqrt(1 - alpha_bar_t),
// sigma = sqrt(beta_t): the per-step scalars, read from a float32 (3,)
// device buffer (a row of the sampler's table, as the TPU kernel reads them
// from SMEM), so a step needs no host float; lambda is a host float and
// lambda * sigma a float32 product.
//
// Replaces the TPU kernel crowdmod_tpu/ops/pallas/fused_step.py
// (fused_ancestral_update, kernel _step_kernel).
//
// What bounds it on the H100: bytes.  One elementwise pass reads x, eps and z
// and writes x' (16 bytes an element, under one flop a byte); at batch 64 on
// the 12x36 ATC grid, 3 future frames and 3 channels, that is about 4 MB a
// call, about 1.2 us at 3.35 TB/s, so a launch costs as much as the work.
// A pass this small needs every byte in flight at once, so the design is one
// vector pass: a thread takes 16-byte float4 vectors of x, eps and z with
// read-only, L1-non-allocating loads, all three issued before any
// arithmetic, and writes x' with a streaming 16-byte store; the grid is one
// wave of blocks (ancestral_update_plan, in the wrapper), grid-stride beyond
// it.  The channel of a vector's first lane is worked out once per vector
// (a 32-bit index unless n >= 2^31), and the rho lanes from it.  A scalar
// head (up to 3 elements before the first 16-byte boundary) and tail (n - head
// not a multiple of 4) take the same arithmetic one element at a time; when
// the four pointers do not share one offset modulo 16 the plan makes every
// element scalar.
//
// Each product and sum is rounded on its own (__fmul_rn, __fsub_rn,
// __fadd_rn never fuse into an FMA), in the order of the plain PyTorch
// version, so the kernel matches it bit for bit.  sign(0) is 0, as in
// torch.sign and jnp.sign.  The channel of element i is i % channels (the
// last dimension is the channel), as the Pallas kernel's lane % channels.
// z is zero at t = 0; that is the sampler's business, not this kernel's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Coefs {
  float a, b, sigma, lam_sigma;
};

// The three scalars of the step from `coeffs`, and lambda * sigma; every
// thread reads the same 12 bytes (one cached line).
__device__ __forceinline__ Coefs load_coefs(const float* __restrict__ coeffs, float lam) {
  const float sigma = __ldg(coeffs + 2);
  return Coefs{__ldg(coeffs), __ldg(coeffs + 1), sigma, __fmul_rn(lam, sigma)};
}

__device__ __forceinline__ float step(float x, float e, float z, const Coefs& c) {
  return __fadd_rn(__fmul_rn(c.a, __fsub_rn(x, __fmul_rn(c.b, e))), __fmul_rn(c.sigma, z));
}

__device__ __forceinline__ float guide(float r, const Coefs& c) {
  const float sgn = r > 0.f ? 1.f : (r < 0.f ? -1.f : 0.f);
  return __fsub_rn(r, __fmul_rn(c.lam_sigma, sgn));
}

__device__ __forceinline__ float4 load_nc(const float* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// Elements [0, head) and [head + 4 * vectors, n) one at a time; the vectors
// in between as float4 (x + head 16-byte aligned, and eps, z, out alike).
// I: unsigned for n < 2^31 (no index overflows 2^32), long long beyond.
template <typename I>
__global__ void ancestral_update_kernel(const float* __restrict__ x,
                                        const float* __restrict__ eps,
                                        const float* __restrict__ z,
                                        const float* __restrict__ coeffs,
                                        float* __restrict__ out, I n, I head,
                                        I vectors, int channels, int rho, float lam,
                                        int sparsity) {
  const Coefs c = load_coefs(coeffs, lam);
  const I stride = (I)gridDim.x * blockDim.x;
  const I tid = (I)blockIdx.x * blockDim.x + threadIdx.x;
  for (I v = tid; v < vectors; v += stride) {
    const I i = head + 4 * v;
    const float4 xv = load_nc(x + i), ev = load_nc(eps + i), zv = load_nc(z + i);
    float r[4] = {step(xv.x, ev.x, zv.x, c), step(xv.y, ev.y, zv.y, c),
                  step(xv.z, ev.z, zv.z, c), step(xv.w, ev.w, zv.w, c)};
    if (sparsity) {
      // Lanes whose channel is rho: d, d + channels, ... below 4, where d is
      // rho's distance past the first lane's channel.
      int d = rho - (int)(i % channels);
      if (d < 0) d += channels;
      unsigned lanes = 0;
      for (int l = d; l < 4; l += channels) lanes |= 1u << l;
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (lanes >> l & 1u) r[l] = guide(r[l], c);
    }
    __stcs(reinterpret_cast<float4*>(out + i), make_float4(r[0], r[1], r[2], r[3]));
  }
  const I tail0 = head + 4 * vectors;
  const I scalars = head + (n - tail0);
  for (I j = tid; j < scalars; j += stride) {
    const I i = j < head ? j : tail0 + (j - head);
    float r = step(__ldg(x + i), __ldg(eps + i), __ldg(z + i), c);
    if (sparsity && (int)(i % channels) == rho) r = guide(r, c);
    out[i] = r;
  }
}

}  // namespace

// x, eps, z and out are float32 device buffers of n contiguous elements,
// coeffs one of 3 (a, b, sigma), 4-byte aligned.  The
// plan (ancestral_update_plan): `head` scalar elements, then `vectors`
// float4 vectors (x + head, eps + head, z + head and out + head 16-byte
// aligned), then the rest scalar; `blocks` of `threads`; index64 = 1 when
// n >= 2^31.  Returns a cudaError_t value.
extern "C" int crowdmod_ancestral_update(const void* x, const void* eps,
                                         const void* z, const void* coeffs,
                                         void* out, long long n, int channels,
                                         int rho, float lam, int sparsity, long long head,
                                         long long vectors, int blocks,
                                         int threads, int index64,
                                         void* stream) {
  if (n < 0 || channels < 1 || rho < 0 || rho >= channels || head < 0 ||
      vectors < 0 || head + 4 * vectors > n || blocks < 1 || threads < 32 ||
      threads > 1024 || threads % 32 || index64 != (n >= (1LL << 31)))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {x, eps, z, out};
  for (const void* p : ptrs) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    if (addr % 4 || (vectors > 0 && (addr + 4 * head) % 16))
      return (int)cudaErrorInvalidValue;
  }
  if (coeffs == nullptr || reinterpret_cast<uintptr_t>(coeffs) % 4)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const float* cf = static_cast<const float*>(coeffs);
  const float* xf = static_cast<const float*>(x);
  const float* ef = static_cast<const float*>(eps);
  const float* zf = static_cast<const float*>(z);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (index64)
    ancestral_update_kernel<long long><<<blocks, threads, 0, s>>>(
        xf, ef, zf, cf, of, n, head, vectors, channels, rho, lam, sparsity);
  else
    ancestral_update_kernel<unsigned><<<blocks, threads, 0, s>>>(
        xf, ef, zf, cf, of, (unsigned)n, (unsigned)head, (unsigned)vectors, channels, rho,
        lam, sparsity);
  return (int)cudaGetLastError();
}
