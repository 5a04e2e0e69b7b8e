// GroupNorm (+ optional SiLU) over channels-last [B, S, C].
//
// Replaces the TPU kernel psg_tpu/ops/fused_norm.py::fused_group_norm_silu
// (pallas_call at :83, body _gn_silu_kernel at :28).
//
// Bound on the H100: memory.  The work is one read of x and one write of y
// (a few operations per element against the card's ~295 operations per
// byte), so the least time is bytes / 3.35 TB/s.
//
// Design:
// - The TPU kernel held one whole sample in VMEM per grid step (grid=(B,)).
//   At the VAE's 215^2 x 64 a sample is 11.8 MB of fp32 and one block per
//   sample would leave most of the 132 SMs idle, so the reduction is split:
//   pass 1 runs one block per (row-chunk, sample) and writes each group's
//   partial (mean, M2) for its chunk; a combine pass runs one warp per
//   (sample, group), merges that group's partials in a fixed order (Chan et
//   al.'s pairwise update: a strided walk per lane, then a shuffle tree) and
//   writes (mean, rstd); pass 2 runs pass 1's grid and normalizes its chunk.
//   Pass 2 re-reads x, mostly from L2.
// - Statistics are two-pass within a chunk (sum -> mean, then sum of squared
//   deviations) and Chan-combined across chunks, never E[x^2] - mean^2, so a
//   large-mean input does not lose its variance to cancellation.
// - Every sum is taken in a fixed order (no atomics): results are
//   deterministic from run to run.
// - Statistics and the affine/SiLU epilogue run in fp32; x and y are fp32 or
//   bf16, scale and bias fp32.
#include "common.cuh"

namespace {

constexpr int kMaxGroups = 32;

// Block: G * (256 / G) threads; thread t owns group t % G and walks the
// chunk's rows with stride blockDim / G.
template <typename T>
__global__ void gn_partial_stats(const T* __restrict__ x, float* __restrict__ part,
                                 int S, int C, int G, int rows_per_chunk) {
  __shared__ float red[256];
  __shared__ float gmean[kMaxGroups];
  const int chunk = blockIdx.x, b = blockIdx.y, nchunks = gridDim.x;
  const int gs = C / G;
  const int lanes = blockDim.x / G;
  const int g = threadIdx.x % G, lane = threadIdx.x / G;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);
  const T* xb = x + (size_t)b * S * C + (size_t)g * gs;

  float s = 0.f;
  for (int r = r0 + lane; r < r1; r += lanes) {
    const T* p = xb + (size_t)r * C;
    for (int j = 0; j < gs; ++j) s += psg::to_f32(p[j]);
  }
  red[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < G) {
    float t = 0.f;
    for (int l = 0; l < lanes; ++l) t += red[l * G + threadIdx.x];
    gmean[threadIdx.x] = t / (float(r1 - r0) * gs);
  }
  __syncthreads();
  const float m = gmean[g];
  float q = 0.f;
  for (int r = r0 + lane; r < r1; r += lanes) {
    const T* p = xb + (size_t)r * C;
    for (int j = 0; j < gs; ++j) {
      const float d = psg::to_f32(p[j]) - m;
      q += d * d;
    }
  }
  red[threadIdx.x] = q;  // every read of red above finished before the last barrier
  __syncthreads();
  if (threadIdx.x < G) {
    float t = 0.f;
    for (int l = 0; l < lanes; ++l) t += red[l * G + threadIdx.x];
    float* o = part + (((size_t)b * nchunks + chunk) * G + threadIdx.x) * 2;
    o[0] = gmean[threadIdx.x];
    o[1] = t;
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

// Block: 32 * G threads, warp g merges group g of sample blockIdx.x.
__global__ void gn_combine(const float* __restrict__ part, float* __restrict__ stats,
                           int S, int G, int gs, int rows_per_chunk, int nchunks,
                           float eps) {
  const int b = blockIdx.x, g = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* p = part + ((size_t)b * nchunks * G + g) * 2;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int k = lane; k < nchunks; k += 32) {
    const int rows = min(S, (k + 1) * rows_per_chunk) - k * rows_per_chunk;
    chan_merge(n, mean, m2, float(rows) * gs, p[(size_t)k * G * 2],
               p[(size_t)k * G * 2 + 1]);
  }
  // lane 0 ends with all 32 lanes merged; the order is fixed
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, off);
    const float mb = __shfl_down_sync(0xffffffffu, mean, off);
    const float m2b = __shfl_down_sync(0xffffffffu, m2, off);
    chan_merge(n, mean, m2, nb, mb, m2b);
  }
  if (lane == 0) {
    stats[((size_t)b * G + g) * 2] = mean;
    stats[((size_t)b * G + g) * 2 + 1] = rsqrtf(m2 / n + eps);
  }
}

template <typename T>
__global__ void gn_apply(const T* __restrict__ x, const float* __restrict__ stats,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         T* __restrict__ y, int S, int C, int G, int rows_per_chunk,
                         int silu) {
  __shared__ float s_mean[kMaxGroups], s_rstd[kMaxGroups];
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int gs = C / G;
  if (threadIdx.x < G) {
    s_mean[threadIdx.x] = stats[((size_t)b * G + threadIdx.x) * 2];
    s_rstd[threadIdx.x] = stats[((size_t)b * G + threadIdx.x) * 2 + 1];
  }
  __syncthreads();
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);
  const size_t base = ((size_t)b * S + r0) * C;
  const int count = (r1 - r0) * C;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int c = i % C;
    const int g = c / gs;
    float v = (psg::to_f32(x[base + i]) - s_mean[g]) * s_rstd[g] * scale[c] + bias[c];
    if (silu) v = v / (1.f + __expf(-v));
    y[base + i] = psg::from_f32<T>(v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* bias, void* y,
                   float* part, float* stats, int B, int S, int C, int G,
                   int rows_per_chunk, float eps, int silu, cudaStream_t stream) {
  const int nchunks = (S + rows_per_chunk - 1) / rows_per_chunk;
  const dim3 grid(nchunks, B);
  const int threads = G * (256 / G);
  gn_partial_stats<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), part, S, C, G, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_combine<<<B, 32 * G, 0, stream>>>(part, stats, S, G, C / G, rows_per_chunk, nchunks,
                                       eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply<T><<<grid, 256, 0, stream>>>(static_cast<const T*>(x), stats, scale, bias,
                                        static_cast<T*>(y), S, C, G, rows_per_chunk, silu);
  return cudaGetLastError();
}

}  // namespace

// part: fp32 workspace of B * ceil(S / rows_per_chunk) * G * 2 values;
// stats: fp32 workspace of B * G * 2 values (mean, rstd).
extern "C" int psg_group_norm_silu(const void* x, const float* scale, const float* bias,
                                   void* y, float* part, float* stats, int B, int S, int C,
                                   int G, int rows_per_chunk, float eps, int silu, int dtype,
                                   void* stream) {
  if (B < 1 || B > 65535 || S < 1 || G < 1 || G > kMaxGroups || C % G != 0 ||
      rows_per_chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == psg::kFloat32)
    err = launch<float>(x, scale, bias, y, part, stats, B, S, C, G, rows_per_chunk, eps,
                        silu, s);
  else if (dtype == psg::kBFloat16)
    err = launch<__nv_bfloat16>(x, scale, bias, y, part, stats, B, S, C, G, rows_per_chunk,
                                eps, silu, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
