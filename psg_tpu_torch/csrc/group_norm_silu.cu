// GroupNorm (+ optional SiLU) over channels-last [B, S, C].
//
// Replaces the TPU kernel psg_tpu/ops/fused_norm.py::fused_group_norm_silu
// (pallas_call at :83, body _gn_silu_kernel at :28).
//
// Bound on the H100: memory.  The work is one read of x and one write of y
// (a few operations per element against the card's ~295 operations per
// byte), so the least time is bytes / 3.35 TB/s.
//
// Two paths; the rule depends on the shape only (S, C, the dtype):
// - Cluster path, one launch, where a sample fits a cluster: a sample's
//   rows split over kClusterCtas = 8 CTAs (the portable cluster size) leave
//   at most kClusterCtaBytes = 128 KB for each.  In bf16 that holds for
//   every UNet site (the largest, 27^2 x 640, is 117 KB a CTA) and the
//   VAE's 27^2 and 54^2 x 128 sites; grid (8, B), one cluster per sample.
//   Each CTA copies its rows into shared memory once (16-byte cp.async),
//   takes per-group sums, exchanges them through distributed shared memory
//   and adds the 8 in rank order to the mean; then the squared deviations
//   from shared memory, exchanged the same way, to rstd; then it normalizes
//   from shared memory and stores with 16-byte stores.  x is read once and
//   y written once.
// - Split path, two launches, for samples that do not fit (in bf16 the
//   VAE's 54^2 x 256, 108^2 and 215^2 sites, e.g. 215^2 x 64 = 5.9 MB a
//   sample): blocks of kChunkBytes = 64 KB of rows take exact two-pass
//   (mean, M2) of their chunk from shared memory into one workspace; the
//   normalize launch starts copying its chunk back into shared memory
//   (mostly from L2), merges its sample's chunks per group in a fixed order
//   meanwhile (Chan et al.'s pairwise update, a strided walk per lane then a
//   shuffle tree), and normalizes the chunk.
// Both paths:
// - Statistics are two-pass (sum -> mean, then the sum of squared
//   deviations), never E[x^2] - mean^2, so a large-mean input keeps its
//   variance.
// - Every sum is taken in a fixed order, with no atomics: repeat runs are
//   bit-equal.
// - A thread owns one vector of W channels (16 bytes where C allows) and a
//   fixed set of rows; its W column sums are reduced per group by one warp.
//   Blocks aim at 512 threads on the cluster path (its 8 CTAs a sample are
//   all the parallelism there is) and 256 on the split path (more blocks
//   resident beside their 64 KB chunks).
// - Statistics and the affine/SiLU epilogue run in fp32; x and y are fp32 or
//   bf16, scale and bias fp32.  SiLU's sigmoid is one tanh.approx for a bf16
//   output (see silu_f32()), exp and a fast divide for fp32.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxGroups = 32;
constexpr int kMaxThreads = 1024;
constexpr int kClusterThreads = 512;  // threads a block aims at, cluster path
constexpr int kSplitThreads = 256;    // ... split path (more blocks resident)
constexpr int kClusterCtas = 8;
constexpr size_t kClusterCtaBytes = 128 * 1024;
constexpr size_t kChunkBytes = 64 * 1024;

template <typename T, int W>
struct alignas(sizeof(T) * W) Pack {
  T v[W];
};

// Thread t owns column vector t % V (channels W*(t % V) ..) and rows
// t / V + k * RP; threads past V * RP idle in the row loops.  The host picks
// RP so that V * RP is at most `target` (a multiple of 32) threads, rounded
// up to whole warps; a block recovers RP as blockDim.x / V.
struct Layout {
  int V, RP, threads;
};

inline Layout layout(int C, int W, int target) {
  Layout l;
  l.V = C / W;
  l.RP = l.V >= target ? 1 : target / l.V;
  l.threads = (l.V * l.RP + 31) / 32 * 32;
  return l;
}

__device__ inline Layout block_layout(int C, int W) {
  Layout l;
  l.V = C / W;
  l.RP = blockDim.x / l.V;
  l.threads = blockDim.x;
  return l;
}

// Shared memory of one block: its rows of x, the column sums and the
// per-group results.
struct Smem {
  unsigned char* x;
  float *colsum, *gsum, *gm2, *mean, *rstd;
};

__host__ __device__ inline size_t data_bytes(size_t rows, int C, size_t elem) {
  return (rows * C * elem + 15) / 16 * 16;
}

inline size_t smem_bytes(size_t rows, int C, const Layout& l, size_t elem) {
  return data_bytes(rows, C, elem) + sizeof(float) * ((size_t)l.RP * C + 4 * kMaxGroups);
}

__device__ inline Smem carve(unsigned char* base, size_t rows, int C, int W, size_t elem) {
  Smem s;
  s.x = base;
  s.colsum = reinterpret_cast<float*>(base + data_bytes(rows, C, elem));
  s.gsum = s.colsum + (size_t)block_layout(C, W).RP * C;
  s.gm2 = s.gsum + kMaxGroups;
  s.mean = s.gm2 + kMaxGroups;
  s.rstd = s.mean + kMaxGroups;
  return s;
}

// Start copying n contiguous elements from global to shared memory: by
// 16-byte cp.async where both ends allow, else element by element at once.
// copy_wait() completes it.
template <typename T>
__device__ void copy_start(T* dst, const T* src, size_t n) {
  const size_t bytes = n * sizeof(T);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (bytes & 15) == 0) {
    const char* s = reinterpret_cast<const char*>(src);
    char* d = reinterpret_cast<char*>(dst);
    for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x)
      psg::cp_async16(d + 16 * i, s + 16 * i, true);
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

__device__ __forceinline__ void copy_wait() {
  psg::cp_async_wait_all();
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// out[g] = sum of f(i, x) over the rows [0, rows) of xs ([rows][C]) and the
// channels of group g, i being the element's index in its thread's vector.
// Fixed order: each thread over its rows, then one warp per group.
template <typename T, int W, typename F>
__device__ void group_totals(const T* xs, int rows, int C, int gs, int G, float* colsum,
                             float* out, F f) {
  const Layout l = block_layout(C, W);
  const int cv = threadIdx.x % l.V, rl = threadIdx.x / l.V;
  if (rl < l.RP) {
    float acc[W];
#pragma unroll
    for (int i = 0; i < W; ++i) acc[i] = 0.f;
    for (int r = rl; r < rows; r += l.RP) {
      const Pack<T, W> p = *reinterpret_cast<const Pack<T, W>*>(xs + (size_t)r * C + cv * W);
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] += f(i, psg::to_f32(p.v[i]));
    }
#pragma unroll
    for (int i = 0; i < W; ++i) colsum[rl * C + cv * W + i] = acc[i];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int g = warp; g < G; g += nwarps) {
    float s = 0.f;
    for (int i = lane; i < l.RP * gs; i += 32) s += colsum[(i / gs) * C + g * gs + i % gs];
    s = warp_sum(s);
    if (lane == 0) out[g] = s;
  }
  __syncthreads();
}

// The per-group means of this thread's W channels.
template <int W>
__device__ __forceinline__ void thread_stats(const float* per_group, int C, int gs,
                                             float (&v)[W]) {
  const int cv = threadIdx.x % (C / W);
#pragma unroll
  for (int i = 0; i < W; ++i) v[i] = per_group[(cv * W + i) / gs];
}

// SiLU in fp32.  For a bf16 output the sigmoid is (1 + tanh(v / 2)) / 2 by
// one tanh.approx (error about 5e-4 of the sigmoid, far below a bf16 step):
// the normalize pass is bound by the special-function unit, and exp plus a
// reciprocal would take two of its operations an element.
template <typename T>
__device__ __forceinline__ float silu_f32(float v) {
  if constexpr (sizeof(T) == 2) {
    float t;
    asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * v));
    return v * fmaf(0.5f, t, 0.5f);
  } else {
    return __fdividef(v, 1.f + __expf(-v));
  }
}

// y rows [0, rows) from x rows [0, rows): (x - mean) * rstd * scale + bias,
// then SiLU.  x may be shared or global memory.
template <typename T, int W>
__device__ void normalize_rows(const T* __restrict__ x, T* __restrict__ y, int rows, int C,
                               int gs, const Smem& s,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias, int silu) {
  const Layout l = block_layout(C, W);
  const int cv = threadIdx.x % l.V, rl = threadIdx.x / l.V;
  float mu[W], a[W], c[W], bb[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int ch = cv * W + i, g = ch / gs;
    mu[i] = s.mean[g];
    a[i] = s.rstd[g];
    c[i] = scale[ch];
    bb[i] = bias[ch];
  }
  // no early return: the cluster kernel's barrier follows (idle threads
  // have rl >= RP and skip the loop)
#pragma unroll 4
  for (int r = rl; r < rows && rl < l.RP; r += l.RP) {
    const size_t off = (size_t)r * C + cv * W;
    const Pack<T, W> p = *reinterpret_cast<const Pack<T, W>*>(x + off);
    Pack<T, W> o;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      float v = (psg::to_f32(p.v[i]) - mu[i]) * a[i] * c[i] + bb[i];
      if (silu) v = silu_f32<T>(v);
      o.v[i] = psg::from_f32<T>(v);
    }
    *reinterpret_cast<Pack<T, W>*>(y + off) = o;
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// grid (ncta, B), cluster (ncta, 1, 1): the CTAs of one cluster split one
// sample's rows, rows_per_cta each.
template <typename T, int W>
__global__ void __launch_bounds__(kMaxThreads)
gn_cluster(const T* __restrict__ x, const float* __restrict__ scale,
           const float* __restrict__ bias, T* __restrict__ y, int S, int C, int G,
           int rows_per_cta, float eps, int silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank(), ncta = cluster.num_blocks();
  const int b = blockIdx.y, gs = C / G;
  const int r0 = rank * rows_per_cta;
  const int rows = max(0, min(S, r0 + rows_per_cta) - r0);
  const Smem s = carve(smem, rows_per_cta, C, W, sizeof(T));
  T* xs = reinterpret_cast<T*>(s.x);
  const size_t base = ((size_t)b * S + r0) * C;
  const float n = float(S) * gs;

  copy_start(xs, x + base, (size_t)rows * C);
  copy_wait();
  group_totals<T, W>(xs, rows, C, gs, G, s.colsum, s.gsum, [](int, float v) { return v; });
  cluster.sync();
  if (threadIdx.x < G) {
    float t = 0.f;
    for (int r = 0; r < ncta; ++r) t += cluster.map_shared_rank(s.gsum, r)[threadIdx.x];
    s.mean[threadIdx.x] = t / n;
  }
  __syncthreads();
  float mu[W];
  thread_stats<W>(s.mean, C, gs, mu);
  group_totals<T, W>(xs, rows, C, gs, G, s.colsum, s.gm2, [&](int i, float v) {
    const float d = v - mu[i];
    return d * d;
  });
  cluster.sync();
  if (threadIdx.x < G) {
    float t = 0.f;
    for (int r = 0; r < ncta; ++r) t += cluster.map_shared_rank(s.gm2, r)[threadIdx.x];
    s.rstd[threadIdx.x] = rsqrtf(t / n + eps);
  }
  cluster_arrive();  // this CTA reads no other CTA's shared memory from here on
  __syncthreads();
  normalize_rows<T, W>(xs, y + base, rows, C, gs, s, scale, bias, silu);
  cluster_wait();    // ... and leaves only when no other CTA reads its own
}

// Split path, launch 1.  grid (nchunks, B): per-chunk (mean, M2) per group.
template <typename T, int W>
__global__ void __launch_bounds__(kMaxThreads)
gn_chunk_stats(const T* __restrict__ x, float* __restrict__ part, int S, int C, int G,
               int rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = blockIdx.x, b = blockIdx.y, nchunks = gridDim.x, gs = C / G;
  const int r0 = chunk * rows_per_chunk;
  const int rows = min(S, r0 + rows_per_chunk) - r0;
  const Smem s = carve(smem, rows_per_chunk, C, W, sizeof(T));
  T* xs = reinterpret_cast<T*>(s.x);
  const float n = float(rows) * gs;

  copy_start(xs, x + ((size_t)b * S + r0) * C, (size_t)rows * C);
  copy_wait();
  group_totals<T, W>(xs, rows, C, gs, G, s.colsum, s.gsum, [](int, float v) { return v; });
  if (threadIdx.x < G) s.mean[threadIdx.x] = s.gsum[threadIdx.x] / n;
  __syncthreads();
  float mu[W];
  thread_stats<W>(s.mean, C, gs, mu);
  group_totals<T, W>(xs, rows, C, gs, G, s.colsum, s.gm2, [&](int i, float v) {
    const float d = v - mu[i];
    return d * d;
  });
  if (threadIdx.x < G) {  // part: [B][G][nchunks][2]
    float* o = part + (((size_t)b * G + threadIdx.x) * nchunks + chunk) * 2;
    o[0] = s.mean[threadIdx.x];
    o[1] = s.gm2[threadIdx.x];
  }
}

// Chan et al.'s merge of a partial (nb, mb, m2b) into (n, mean, m2).
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb,
                                           float mb, float m2b) {
  if (nb == 0.f) return;
  const float nab = n + nb;
  const float delta = mb - mean;
  const float wb = nb / nab;
  mean += delta * wb;
  m2 += m2b + delta * delta * n * wb;
  n = nab;
}

// Split path, launch 2.  grid (nchunks, B): start copying this chunk into
// shared memory, merge the sample's chunk statistics meanwhile (one warp
// per group, the same order in every block), then normalize the chunk.
template <typename T, int W>
__global__ void __launch_bounds__(kMaxThreads)
gn_chunk_apply(const T* __restrict__ x, const float* __restrict__ part,
               const float* __restrict__ scale, const float* __restrict__ bias,
               T* __restrict__ y, int S, int C, int G, int rows_per_chunk, float eps,
               int silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = blockIdx.x, b = blockIdx.y, nchunks = gridDim.x, gs = C / G;
  const int r0 = chunk * rows_per_chunk;
  const int rows = min(S, r0 + rows_per_chunk) - r0;
  const Smem s = carve(smem, rows_per_chunk, C, W, sizeof(T));
  T* xs = reinterpret_cast<T*>(s.x);
  const size_t base = ((size_t)b * S + r0) * C;
  copy_start(xs, x + base, (size_t)rows * C);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int g = warp; g < G; g += nwarps) {
    const float* p = part + ((size_t)b * G + g) * nchunks * 2;
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int k = lane; k < nchunks; k += 32) {
      const int krows = min(S, (k + 1) * rows_per_chunk) - k * rows_per_chunk;
      chan_merge(n, mean, m2, float(krows) * gs, p[2 * k], p[2 * k + 1]);
    }
    for (int off = 16; off > 0; off >>= 1) {  // lane 0 ends with all lanes merged
      const float nb = __shfl_down_sync(0xffffffffu, n, off);
      const float mb = __shfl_down_sync(0xffffffffu, mean, off);
      const float m2b = __shfl_down_sync(0xffffffffu, m2, off);
      chan_merge(n, mean, m2, nb, mb, m2b);
    }
    if (lane == 0) {
      s.mean[g] = mean;
      s.rstd[g] = rsqrtf(m2 / n + eps);
    }
  }
  copy_wait();  // also publishes the statistics
  normalize_rows<T, W>(xs, y + base, rows, C, gs, s, scale, bias, silu);
}

struct Plan {
  int W, threads, rows, nblocks;  // rows per CTA (cluster) or chunk (split)
  bool cluster;
  size_t smem, workspace;         // workspace: bytes of fp32 (mean, M2) partials
};

// xaddr: x's address; W is the widest vector that divides C and keeps
// every vector of x aligned.
bool make_plan(int B, int S, int C, int G, int dtype, uintptr_t xaddr, Plan* p) {
  const size_t elem = dtype == psg::kFloat32 ? 4 : 2;
  p->W = 1;
  for (int w = 16 / (int)elem; w > 1; w /= 2)
    if (C % w == 0 && xaddr % (w * elem) == 0) {
      p->W = w;
      break;
    }
  const int cluster_rows = (S + kClusterCtas - 1) / kClusterCtas;
  p->cluster = (size_t)cluster_rows * C * elem <= kClusterCtaBytes;
  const Layout l = layout(C, p->W, p->cluster ? kClusterThreads : kSplitThreads);
  if (l.threads > kMaxThreads) return false;
  p->threads = l.threads;
  if (p->cluster) {
    p->rows = cluster_rows;
    p->nblocks = kClusterCtas;
    p->workspace = 0;
  } else {
    const size_t row_bytes = (size_t)C * elem;
    p->rows = row_bytes >= kChunkBytes ? 1 : (int)(kChunkBytes / row_bytes);
    p->nblocks = (S + p->rows - 1) / p->rows;
    p->workspace = sizeof(float) * 2 * (size_t)B * p->nblocks * G;
  }
  p->smem = smem_bytes(p->rows, C, l, elem);
  return p->smem <= psg::kSmemLimit;
}

template <typename T, int W>
cudaError_t launch_w(const Plan& p, const void* x, const float* scale, const float* bias,
                     void* y, float* part, int B, int S, int C, int G, float eps, int silu,
                     cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  cudaError_t err;
  if (p.cluster) {
    err = psg::allow_smem(gn_cluster<T, W>, p.smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.nblocks, B);
    cfg.blockDim = dim3(p.threads);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.nblocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, gn_cluster<T, W>, xt, scale, bias, yt, S, C, G, p.rows,
                              eps, silu);
  }
  err = psg::allow_smem(gn_chunk_stats<T, W>, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.nblocks, B);
  gn_chunk_stats<T, W><<<grid, p.threads, p.smem, stream>>>(xt, part, S, C, G, p.rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = psg::allow_smem(gn_chunk_apply<T, W>, p.smem);
  if (err != cudaSuccess) return err;
  gn_chunk_apply<T, W><<<grid, p.threads, p.smem, stream>>>(xt, part, scale, bias, yt, S, C,
                                                            G, p.rows, eps, silu);
  return cudaGetLastError();
}

}  // namespace

// Bytes of fp32 workspace one call needs (0 on the one-launch cluster
// path), or -1 if the kernel does not take this shape.
extern "C" long long psg_group_norm_silu_workspace_bytes(int B, int S, int C, int G,
                                                         int dtype) {
  Plan p;
  if (B < 1 || S < 1 || G < 1 || G > kMaxGroups || C % G != 0 ||
      !make_plan(B, S, C, G, dtype, 0, &p))
    return -1;
  return (long long)p.workspace;
}

// part: the workspace of psg_group_norm_silu_workspace_bytes (null when 0).
extern "C" int psg_group_norm_silu(const void* x, const float* scale, const float* bias,
                                   void* y, float* part, int B, int S, int C, int G,
                                   float eps, int silu, int dtype, void* stream) {
  Plan p;
  if (B < 1 || B > 65535 || S < 1 || G < 1 || G > kMaxGroups || C % G != 0 ||
      (dtype != psg::kFloat32 && dtype != psg::kBFloat16) ||
      !make_plan(B, S, C, G, dtype, reinterpret_cast<uintptr_t>(x), &p) ||
      (p.workspace > 0 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == psg::kFloat32) {
    switch (p.W) {
      case 4: return launch_w<float, 4>(p, x, scale, bias, y, part, B, S, C, G, eps, silu, s);
      case 2: return launch_w<float, 2>(p, x, scale, bias, y, part, B, S, C, G, eps, silu, s);
      default: return launch_w<float, 1>(p, x, scale, bias, y, part, B, S, C, G, eps, silu, s);
    }
  }
  switch (p.W) {
    case 8: return launch_w<__nv_bfloat16, 8>(p, x, scale, bias, y, part, B, S, C, G, eps, silu, s);
    case 4: return launch_w<__nv_bfloat16, 4>(p, x, scale, bias, y, part, B, S, C, G, eps, silu, s);
    case 2: return launch_w<__nv_bfloat16, 2>(p, x, scale, bias, y, part, B, S, C, G, eps, silu, s);
    default: return launch_w<__nv_bfloat16, 1>(p, x, scale, bias, y, part, B, S, C, G, eps, silu, s);
  }
}
