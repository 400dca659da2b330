// Fused GroupNorm (+ optional SiLU) for Hopper (sm_90a), channels-last:
//     out = act((x - mean_bg) * rstd_bg * gamma_c + beta_c)
// over (B, S, C) with G groups of C/G channels, moments over the S positions
// and the group's channels, biased variance, float32 moments and affine,
// input type in and out (float or bf16).
//
// Replaces the TPU kernel crowdmod_tpu/ops/pallas/groupnorm.py (_gn_pallas,
// kernel _gn_kernel).
//
// What bounds it on the H100: bytes.  About 10 flops an element against 4
// (bf16) or 8 (f32) bytes in and out.  At the UNet's largest call (the
// final norm at batch 64: 64 x 3456 x 32 bf16, 14 MB in and 14 MB out) the
// bound is about 8.5 us.
//
// Two routes; the wrapper's group_norm_plan picks one from the shape and
// passes it here as ints, and each launch is one kernel.
//
// "cluster", bf16 (the TPU kernel's shape: a whole sample on chip, read
// once).  A sample is held by a cluster of k CTAs (k = 1, 2, 4, 8), each of which
// copies its contiguous run of ceil(S / k) positions x C channels from
// device memory into shared memory with 16-byte cp.async pieces, once.  The
// mean, the mean squared deviation (the plain version's two passes, so no
// cancellation) and the output all read that copy.  Sums run in f32 in a
// fixed order: a thread always sees the same 16-byte window of channels
// (the CTA's thread count is a multiple of the windows a row), sums it lane
// by lane over its vectors, folds the lanes into group partials, then warp
// (xor butterfly), then CTA (warps in order), then cluster: each CTA
// publishes its G partials in its own shared memory and, after a cluster
// barrier, every thread reads its groups' partials of all k CTAs through
// distributed shared memory in rank order, so every CTA holds the
// bitwise-same moments (a cluster of one skips the cluster barriers).  No
// atomics, so the output does not depend on the run.  The output pass stores
// 16-byte vectors; a last cluster barrier keeps every CTA alive until the
// others have read its partials.
//
// "stream" (float32; and bf16 samples no cluster holds, or calls so small
// that a block's three passes stay latency-bound, where it beats the
// cluster's chain of two CTA- and cluster-wide reductions): one block per
// (sample, group), 256 threads, that streams its slice three times from
// device memory (the mean, the squared deviations, then normalise and
// store), the G blocks of a sample neighbours in the grid so that the second
// and third passes mostly hit the 50 MB L2.  Grid: B * G blocks.  float32
// keeps this route everywhere: the free-running f32 sampler chains are held
// against the plain version with its rounding, and a cluster sum order
// (f32 or f64) moved them past their tolerance through one Sparsity sign.
//
// Interface: plain C, loaded with ctypes; launches on the given stream and
// returns cudaGetLastError() (a refused cluster launch shows only there).

#include <cooperative_groups.h>

#include "common.cuh"

namespace coop = cooperative_groups;

namespace crowdmod {
namespace {

// ---------------------------------------------------------------------------
// Route "stream"
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
group_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ out, int S,
                  int C, int G, float eps, int act) {
  __shared__ float scratch[kThreads / 32];
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = C / G;
  const long long base = (long long)b * S * C + (long long)g * cg;
  float mean, rstd;
  group_moments<T, V>(x + base, S, C, cg, eps, scratch, mean, rstd);

  const int nv = cg / V;
  const long long items = (long long)S * nv;
  for (long long i = threadIdx.x; i < items; i += kThreads) {
    const long long off = base + (i / nv) * C + (i % nv) * V;
    const int c = g * cg + (int)(i % nv) * V;
    float v[V];
    if constexpr (V == 4) {
      load4(x + off, v);
    } else {
      v[0] = to_f(x[off]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float y = (v[e] - mean) * rstd * gamma[c + e] + beta[c + e];
      v[e] = act ? silu(y) : y;
    }
    if constexpr (V == 4) {
      store4(out + off, v);
    } else {
      out[off] = from_f<T>(v[0]);
    }
  }
}

template <typename T>
int launch_stream(const void* x, const float* gamma, const float* beta, void* out,
                  int batch, int S, int C, int G, float eps, int act,
                  cudaStream_t stream) {
  const dim3 grid(G, batch);
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if ((C / G) % 4 == 0)
    group_norm_kernel<T, 4><<<grid, kThreads, 0, stream>>>(xi, gamma, beta, o, S, C, G, eps, act);
  else
    group_norm_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xi, gamma, beta, o, S, C, G, eps, act);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Route "cluster"
// ---------------------------------------------------------------------------

constexpr int kMaxGroups = 8;
constexpr int kMaxClusterThreads = 1024;
// A CTA's dynamic shared memory (gamma, beta and its run of positions):
// 227 KB less 3 KB kept for the kernel's static reduction scratch
// (group_norm_plan's MAX_CHUNK).
constexpr int kMaxChunkBytes = 232448 - 3072;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

using bf16 = __nv_bfloat16;
constexpr int kVec = 8;  // bf16 channels in a 16-byte vector

// The 16 bytes at p (shared memory) as 8 floats, and back as 8 bf16.
__device__ __forceinline__ void load16(const bf16* p, float (&v)[kVec]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(bf16* p, const float (&v)[kVec]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

struct ClusterScratch {
  float warp_part[2][kMaxClusterThreads / 32][kMaxGroups];  // [pass][warp][group]
  float published[2][kMaxGroups];  // this CTA's sums, read by the cluster
};

// Sums of the lane sums s[e] by group: over the CTA (warp by warp: xor
// butterfly, then warps in order) and over the cluster (CTAs in rank
// order).  Every thread of every CTA gets the bitwise-same total of each of
// its lanes' groups in tot[e].  `pass` (0: mean, 1: variance) picks the
// scratch, so the second pass never overwrites what a slow reader of the
// first still needs.  A cluster of one takes its totals from its warps.
template <int V>
__device__ __forceinline__ void group_totals(
    const float (&s)[V], const int (&grp)[V], int G, int pass, ClusterScratch& sc,
    coop::cluster_group& cluster, float (&tot)[V]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    float a = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) a += grp[e] == g ? s[e] : 0.f;
    a = warp_sum(a);
    if (lane == 0) sc.warp_part[pass][warp][g] = a;
  }
  __syncthreads();
  const unsigned k = cluster.num_blocks();
  if (k > 1) {
    if (threadIdx.x < G) {
      float a = 0.f;
      for (int w = 0; w < warps; ++w) a += sc.warp_part[pass][w][threadIdx.x];
      sc.published[pass][threadIdx.x] = a;
    }
    cluster.sync();  // every CTA's sums are published
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (e > 0 && grp[e] == grp[e - 1]) {
      tot[e] = tot[e - 1];
      continue;
    }
    float a = 0.f;
    if (k > 1) {
      for (unsigned r = 0; r < k; ++r)
        a += *cluster.map_shared_rank(&sc.published[pass][grp[e]], r);
    } else {
      for (int w = 0; w < warps; ++w) a += sc.warp_part[pass][w][grp[e]];
    }
    tot[e] = a;
  }
}

// Grid (k, batch), clusters of (k, 1, 1): CTA `rank` of sample blockIdx.y
// holds positions [rank * rows_per_cta, ...) of it in shared memory, after
// gamma and beta (C floats each).  blockDim.x is a multiple of 32 and of the
// C / V windows of a row.  Every pass maps vector i to thread i % blockDim.x,
// as the copy does, so a thread reads only vectors it copied itself: its own
// cp.async waits order them, with no barrier of the CTA.
__global__ void __launch_bounds__(kMaxClusterThreads)
group_norm_cluster_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                          const float* __restrict__ beta, bf16* __restrict__ out, int S,
                          int C, int G, int rows_per_cta, float eps, int act) {
  constexpr int V = kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ ClusterScratch sc;
  float* gamma_s = reinterpret_cast<float*>(smem_raw);
  float* beta_s = gamma_s + C;
  bf16* chunk = reinterpret_cast<bf16*>(beta_s + C);
  coop::cluster_group cluster = coop::this_cluster();

  const int row0 = (int)cluster.block_rank() * rows_per_cta;
  const int rows = max(0, min(rows_per_cta, S - row0));
  const int windows = C / V;
  const int nvec = rows * windows;
  const long long base = ((long long)blockIdx.y * S + row0) * C;

  // Two commit groups: gamma, beta and the first half of the rounds of
  // vectors, then the rest, so the sum starts while the second half lands.
  const int half = ((nvec + blockDim.x - 1) / blockDim.x + 1) / 2 * blockDim.x;
  for (int i = threadIdx.x; i < C / 4; i += blockDim.x) {
    cp_async16(gamma_s + 4 * i, gamma + 4 * i);
    cp_async16(beta_s + 4 * i, beta + 4 * i);
  }
  for (int i = threadIdx.x; i < min(nvec, half); i += blockDim.x)
    cp_async16(chunk + (long long)i * V, x + base + (long long)i * V);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = half + threadIdx.x; i < nvec; i += blockDim.x)
    cp_async16(chunk + (long long)i * V, x + base + (long long)i * V);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // The thread's window: channels c0 .. c0 + V - 1 of every row it visits.
  const int c0 = (threadIdx.x % windows) * V;
  const int per_group = C / G;
  int grp[V];
#pragma unroll
  for (int e = 0; e < V; ++e) grp[e] = (c0 + e) / per_group;
  const float n = (float)S * per_group;

  float s[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = 0.f;
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    if (i == half + (int)threadIdx.x) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    float v[V];
    load16(chunk + (long long)i * V, v);
#pragma unroll
    for (int e = 0; e < V; ++e) s[e] += v[e];
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  float mean[V];
  group_totals<V>(s, grp, G, 0, sc, cluster, mean);  // its barrier publishes gamma, beta
#pragma unroll
  for (int e = 0; e < V; ++e) {
    mean[e] = e > 0 && grp[e] == grp[e - 1] ? mean[e - 1] : mean[e] / n;
    s[e] = 0.f;
  }

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[V];
    load16(chunk + (long long)i * V, v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = v[e] - mean[e];
      s[e] = fmaf(d, d, s[e]);
    }
  }
  float rstd[V];
  group_totals<V>(s, grp, G, 1, sc, cluster, rstd);
  // Past this point no CTA reads another's shared memory: arrive now, wait
  // before exit, so the barrier's latency hides behind the output pass.
  const bool clustered = cluster.num_blocks() > 1;
  if (clustered) cluster_arrive();
#pragma unroll
  for (int e = 0; e < V; ++e)
    rstd[e] = e > 0 && grp[e] == grp[e - 1] ? rstd[e - 1] : rsqrtf(rstd[e] / n + eps);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[V];
    load16(chunk + (long long)i * V, v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float y = (v[e] - mean[e]) * rstd[e] * gamma_s[c0 + e] + beta_s[c0 + e];
      // The bf16 output rounds far above the fast intrinsics' error.
      v[e] = act ? __fdividef(y, 1.f + __expf(-y)) : y;
    }
    store16(out + base + (long long)i * V, v);
  }
  if (clustered) cluster_wait();
}

int launch_cluster(const void* x, const float* gamma, const float* beta, void* out,
                   int batch, int S, int C, int G, float eps, int act, int k,
                   int threads, int smem, cudaStream_t stream) {
  constexpr int V = kVec;
  const int rows = (S + k - 1) / k;
  if (C % V || G > kMaxGroups || (k != 1 && k != 2 && k != 4 && k != 8) ||
      threads < 32 || threads > kMaxClusterThreads || threads % 32 ||
      threads % (C / V) || smem != 8 * C + rows * C * (int)sizeof(bf16) ||
      smem > kMaxChunkBytes)
    return (int)cudaErrorInvalidValue;
  const auto kernel = group_norm_cluster_kernel;
  const cudaError_t attr =
      allow_dynamic_smem(reinterpret_cast<const void*>(kernel), kMaxChunkBytes);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, batch, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = k;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(x), gamma,
                                             beta, static_cast<bf16*>(out), S, C, G, rows, eps,
                                             act);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace crowdmod

// dtype: 0 = float32, 1 = bfloat16.  x and out: (batch, S, C) contiguous,
// 16-byte aligned; gamma, beta: (C,) float32.  route: 0 = "stream" (k = 1,
// threads = 256, smem = 0), 1 = "cluster", bf16 only (k CTAs a sample of `threads`
// threads and `smem` bytes of dynamic shared memory, which must be
// 8 * C + ceil(S / k) * C * sizeof(element)).  Returns a cudaError_t value.
extern "C" int crowdmod_group_norm(int dtype, const void* x, const void* gamma,
                                   const void* beta, void* out, int batch,
                                   int S, int C, int G, float eps, int act,
                                   int route, int k, int threads, int smem,
                                   void* stream) {
  if (batch < 0 || S < 0 || C < 1 || G < 1 || C % G != 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (route == 0 && (k != 1 || threads != crowdmod::kThreads || smem != 0))
    return (int)cudaErrorInvalidValue;
  if (route != 0 && route != 1) return (int)cudaErrorInvalidValue;
  if (batch == 0 || S == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  if (dtype == 0 && route == 0)
    return crowdmod::launch_stream<float>(x, ga, be, out, batch, S, C, G, eps, act, s);
  if (dtype == 1)
    return route == 0
               ? crowdmod::launch_stream<__nv_bfloat16>(x, ga, be, out, batch, S, C, G, eps,
                                                        act, s)
               : crowdmod::launch_cluster(x, ga, be, out, batch, S, C, G, eps, act, k,
                                          threads, smem, s);
  return (int)cudaErrorInvalidValue;
}
