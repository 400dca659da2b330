// Fused DDPM ancestral update for Hopper (sm_90a):
//     x' = a * (x - b * eps) + sigma * z
//     x' = x' - (lambda * sigma) * sign(x')     on channel rho only (Sparsity)
// with a = 1/sqrt(alpha_t), b = beta_t / sqrt(1 - alpha_bar_t),
// sigma = sqrt(beta_t), per-step scalars passed as floats from the host
// schedule.
//
// Replaces the TPU kernel crowdmod_tpu/ops/pallas/fused_step.py
// (fused_ancestral_update, kernel _step_kernel).
//
// What bounds it on the H100: bytes.  One elementwise pass reads x, eps and z
// and writes x' (16 bytes an element, under one flop a byte); at batch 64 on
// the 12x36 ATC grid, 3 future frames and 3 channels, that is about 4 MB a
// call, about 1.2 us at 3.35 TB/s, so a launch costs as much as the work.
// The design does what the bound asks: one read of each input and one write,
// no intermediate in device memory, consecutive threads on consecutive
// elements.
//
// Each product and sum is rounded on its own (__fmul_rn, __fsub_rn,
// __fadd_rn never fuse into an FMA), in the order of the plain PyTorch
// version, so the kernel matches it bit for bit.  sign(0) is 0, as in
// torch.sign and jnp.sign.  The channel of element i is i % channels (the
// last dimension is the channel), as the Pallas kernel's lane % channels.
// z is zero at t = 0; that is the sampler's business, not this kernel's.

#include <cuda_runtime.h>

namespace {

__global__ void ancestral_update_kernel(const float* __restrict__ x,
                                        const float* __restrict__ eps,
                                        const float* __restrict__ z,
                                        float* __restrict__ out, long long n,
                                        int channels, int rho, float a,
                                        float b, float sigma, float lam_sigma,
                                        int sparsity) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float r = __fadd_rn(__fmul_rn(a, __fsub_rn(x[i], __fmul_rn(b, eps[i]))),
                        __fmul_rn(sigma, z[i]));
    if (sparsity && (int)(i % channels) == rho) {
      const float sgn = r > 0.f ? 1.f : (r < 0.f ? -1.f : 0.f);
      r = __fsub_rn(r, __fmul_rn(lam_sigma, sgn));
    }
    out[i] = r;
  }
}

}  // namespace

// All pointers are float32 device buffers of n contiguous elements.
// Returns a cudaError_t value.
extern "C" int crowdmod_ancestral_update(const void* x, const void* eps,
                                         const void* z, void* out, long long n,
                                         int channels, int rho, float a,
                                         float b, float sigma, float lam_sigma,
                                         int sparsity, void* stream) {
  if (n < 0 || channels < 1 || rho < 0 || rho >= channels)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  constexpr int kThreads = 256;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond this
  ancestral_update_kernel<<<(unsigned)blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(eps),
      static_cast<const float*>(z), static_cast<float*>(out), n, channels, rho,
      a, b, sigma, lam_sigma, sparsity);
  return (int)cudaGetLastError();
}
