// The VAE decoder's pixel-query / text-key attention block, fused:
//
//   q   = xn . Wq + bq                                  (the 1x1 Q conv)
//   s_h = (q_h * scale) . k_h^T + key_bias              per head h
//   p_h = softmax(s_h), max subtracted PER HEAD, fp32
//   o_h = p_h . v_h
//   out = o . Wp + bp + residual                        (the 1x1 proj conv)
//
// Replaces the TPU kernel psg_tpu/ops/spatial_xattn.py::fused_spatial_xattn
// (_pallas_impl at :112, pallas_call at :117, body _kernel at :57).
//
// Shapes on the model's path: xn, residual, out [B, L, C] with L = 108^2
// (C = 64) or 215^2 (C = 32), 8 heads of dim C/8, S <= 256 text keys;
// K and V arrive head-split as [B, 8, S, C/8] fp32 (the wrapper applies the
// reference's compat_reshape permutation there), key_bias [B, S] fp32 or
// null, Wq/Wp [C, C] ([in, out]) and bq/bp [C] fp32.  xn, residual and out
// are fp32 or bf16.
//
// Bound on the H100: operations.  Per pixel the block does 2C^2 + 2SC
// multiply-adds and 8S exponentials against 3C activation elements of
// traffic, far above the card's bytes-to-operations balance; the score
// tensor [B, 8, L, S] never exists in memory.
//
// Design (simple first; CUDA cores, no tensor cores yet):
// - One thread per pixel, 128 pixels per block, grid (L / 128, B).  Each
//   block loads Wq, Wp, the biases and its sample's K, V and key bias into
//   shared memory once; that is why C is limited to 64 here (2C^2 + 2SC fp32
//   values must fit in 227 KB).  All threads of a warp read the same shared
//   word at a time, so every shared load is a broadcast.
// - C is a template parameter, so q, o and the per-head accumulators stay in
//   registers.  Each width is a fully unrolled kernel per dtype, and nvcc's
//   time grows with C^2, so only the widths the decoder's C <= 64 sites take
//   are built: 8, 16, 32 and 64 (width scales 1, 1/2 and 1/4).
// - Each head runs its own online softmax over the S keys.  That keeps the
//   per-head max of the reference (a global row max let a cold head's exp()
//   underflow to zeros; see spatial_xattn.py:29-41), and the denominator is
//   >= 1 by construction.
// - The TPU kernel's 128-lane key padding and block-diagonal K/V layout were
//   TPU tiling, not semantics, and are gone.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kHeads = 8;
constexpr int kThreads = 128;

inline size_t smem_floats(int C, int S) { return 2 * (size_t)C * C + 2 * (size_t)S * C + S; }

template <int N>
__device__ __forceinline__ void axpy_smem(float (&acc)[N], float a, const float* w) {
  // acc[n] += a * w[n] for a 16-byte aligned shared row
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int n = 0; n < N; n += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + n);
      acc[n] += a * w4.x;
      acc[n + 1] += a * w4.y;
      acc[n + 2] += a * w4.z;
      acc[n + 3] += a * w4.w;
    }
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] += a * w[n];
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
spatial_xattn_kernel(const T* __restrict__ xn, const T* __restrict__ res,
                     const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ key_bias, const float* __restrict__ wq,
                     const float* __restrict__ bq, const float* __restrict__ wp,
                     const float* __restrict__ bp, T* __restrict__ out, int L, int S,
                     float scale) {
  constexpr int HD = C / kHeads;
  extern __shared__ __align__(16) float sm[];
  float* s_wq = sm;              // [C][C]
  float* s_wp = s_wq + C * C;    // [C][C]
  float* s_k = s_wp + C * C;     // [8][S][HD]
  float* s_v = s_k + S * C;      // [8][S][HD]
  float* s_bias = s_v + S * C;   // [S]

  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < C * C; i += kThreads) {
    s_wq[i] = wq[i];
    s_wp[i] = wp[i];
  }
  const float* kb = k + (size_t)b * S * C;
  const float* vb = v + (size_t)b * S * C;
  for (int i = threadIdx.x; i < S * C; i += kThreads) {
    s_k[i] = kb[i];
    s_v[i] = vb[i];
  }
  for (int i = threadIdx.x; i < S; i += kThreads)
    s_bias[i] = key_bias ? key_bias[(size_t)b * S + i] : 0.f;
  __syncthreads();

  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= L) return;
  const size_t row = ((size_t)b * L + pix) * C;

  float q[C];
#pragma unroll
  for (int c = 0; c < C; ++c) q[c] = bq[c];
  for (int i = 0; i < C; ++i) axpy_smem(q, psg::to_f32(xn[row + i]), s_wq + i * C);
#pragma unroll
  for (int c = 0; c < C; ++c) q[c] *= scale;

  float o[C];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    const float* kh = s_k + h * S * HD;
    const float* vh = s_v + h * S * HD;
    float acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.f;
    float m = -CUDART_INF_F, l = 0.f;
    for (int j = 0; j < S; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot += q[h * HD + d] * kh[j * HD + d];
      const float s = dot + s_bias[j];
      if (s > m) {  // new running max: rescale what was accumulated
        const float corr = __expf(m - s);
        l *= corr;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] *= corr;
        m = s;
      }
      const float p = __expf(s - m);
      l += p;
      axpy_smem(acc, p, vh + j * HD);
    }
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[h * HD + d] = acc[d] * inv;
  }

  float y[C];
#pragma unroll
  for (int c = 0; c < C; ++c) y[c] = bp[c] + psg::to_f32(res[row + c]);
#pragma unroll  // o[] stays in registers only under a constant index
  for (int i = 0; i < C; ++i) axpy_smem(y, o[i], s_wp + i * C);
#pragma unroll
  for (int c = 0; c < C; ++c) out[row + c] = psg::from_f32<T>(y[c]);
}

template <typename T, int C>
cudaError_t launch_c(const void* xn, const void* res, const float* k, const float* v,
                     const float* key_bias, const float* wq, const float* bq,
                     const float* wp, const float* bp, void* out, int B, int L, int S,
                     float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(C, S) * sizeof(float);
  cudaError_t err = psg::allow_smem(spatial_xattn_kernel<T, C>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kThreads - 1) / kThreads, B);
  spatial_xattn_kernel<T, C><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xn), static_cast<const T*>(res), k, v, key_bias, wq, bq, wp,
      bp, static_cast<T*>(out), L, S, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int C, const void* xn, const void* res, const float* k, const float* v,
                   const float* key_bias, const float* wq, const float* bq,
                   const float* wp, const float* bp, void* out, int B, int L, int S,
                   float scale, cudaStream_t stream) {
#define PSG_CASE(CC)                                                                    \
  case CC:                                                                              \
    return launch_c<T, CC>(xn, res, k, v, key_bias, wq, bq, wp, bp, out, B, L, S, scale, \
                           stream);
  switch (C) {
    PSG_CASE(8)
    PSG_CASE(16)
    PSG_CASE(32)
    PSG_CASE(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef PSG_CASE
}

}  // namespace

extern "C" size_t psg_spatial_xattn_smem_bytes(int C, int S) {
  return smem_floats(C, S) * sizeof(float);
}

extern "C" int psg_spatial_xattn(const void* xn, const void* res, const float* k,
                                 const float* v, const float* key_bias, const float* wq,
                                 const float* bq, const float* wp, const float* bp,
                                 void* out, int B, int L, int S, int C, float scale,
                                 int dtype, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == psg::kFloat32)
    err = launch<float>(C, xn, res, k, v, key_bias, wq, bq, wp, bp, out, B, L, S, scale, s);
  else if (dtype == psg::kBFloat16)
    err = launch<__nv_bfloat16>(C, xn, res, k, v, key_bias, wq, bq, wp, bp, out, B, L, S,
                                scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
