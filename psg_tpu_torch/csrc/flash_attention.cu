// Short-KV attention: o = softmax(q k^T * scale + key_bias) v.
//
// Replaces the TPU kernel psg_tpu/ops/flash_attention.py::flash_sdpa
// (_flash_impl at :61, pallas_call at :92, body _attn_kernel at :34).
//
// Shapes on the model's path: q [B,H,Lq,D], k/v [B,H,Lk,D] with Lk <= 196
// and D in {4..16, 32, 64, 160, 320}; key_bias [B, Lk] fp32 (the
// [B,1,1,Lk] additive mask) or null.  q, k, v, o are fp32 or bf16;
// scores, softmax and the accumulator are fp32.
//
// Bound on the H100: at these short key lengths the FLOPs per byte are low
// (4 * Lk operations per query element read), so the least time is mostly
// set by the bytes of q, k, v and o; the UNet's hd-160/320 self-attention
// sits near the balance point.
//
// Design (simple first; no tensor cores yet):
// - The TPU kernel kept the whole K/V of one (batch, head) resident and took
//   one plain softmax.  At hd 320 and Lk 128, K+V in fp32 are 320 KB, above
//   a block's 227 KB of shared memory, so this kernel streams key tiles of
//   kBK keys with an online (running max / running sum) softmax instead.
// - One block per (query tile of kBQ rows, batch*head).  Q, the current K/V
//   tile, the score tile and the output accumulator live in shared memory in
//   fp32, sized from D at launch: any D whose tiles fit in 227 KB works.
// - The ragged edges are masked in the kernel (keys past Lk never enter the
//   softmax; rows past Lq are never stored); nothing is padded in memory.
// - The key bias is added in fp32 after the scale, as the reference does.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kBQ = 32;       // query rows per block
constexpr int kBK = 32;       // keys per tile
constexpr int kThreads = 128;

struct Smem {
  static size_t floats(int D) {
    const int ldk = D | 1;  // odd stride: conflict-free column reads of K
    return (size_t)kBQ * D          // Q
           + (size_t)kBK * ldk      // K tile
           + (size_t)kBK * D        // V tile
           + (size_t)kBQ * (kBK + 1)  // scores / probabilities
           + (size_t)kBQ * D        // output accumulator
           + 3 * kBQ;               // running max, running sum, rescale
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ key_bias, T* __restrict__ o, int H, int Lq, int Lk,
             int D, float scale) {
  extern __shared__ float sm[];
  const int ldk = D | 1;
  float* Qs = sm;
  float* Ks = Qs + kBQ * D;
  float* Vs = Ks + kBK * ldk;
  float* Ss = Vs + kBK * D;
  float* Os = Ss + kBQ * (kBK + 1);
  float* m_run = Os + kBQ * D;
  float* l_run = m_run + kBQ;
  float* alpha = l_run + kBQ;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + ((size_t)bh * Lq + q0) * D;
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;
  const float* biasb = key_bias ? key_bias + (size_t)b * Lk : nullptr;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    Qs[i] = (q0 + r < Lq) ? psg::to_f32(qb[i]) : 0.f;
    Os[i] = 0.f;
  }
  if (tid < kBQ) {
    m_run[tid] = -CUDART_INF_F;
    l_run[tid] = 0.f;
  }

  // score mapping: thread owns key column sj and rows sr0 + 4*i, i < 8
  const int sj = tid % kBK, sr0 = tid / kBK;
  // softmax mapping: 4 threads per row, 8 columns each
  const int xr = tid / 4, xpart = tid % 4;
  // P.V mapping: thread owns rows pr0 + 8*i (i < 4) and columns pd0 + 16*n
  const int pr0 = tid / 16, pd0 = tid % 16;

  for (int k0 = 0; k0 < Lk; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and Q/O initialised)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const bool ok = k0 + j < Lk;
      Ks[j * ldk + d] = ok ? psg::to_f32(kb[(size_t)k0 * D + i]) : 0.f;
      Vs[i] = ok ? psg::to_f32(vb[(size_t)k0 * D + i]) : 0.f;
    }
    __syncthreads();

    {  // S = Q K^T * scale + bias for this tile
      float acc[kBQ / 4];
#pragma unroll
      for (int i = 0; i < kBQ / 4; ++i) acc[i] = 0.f;
      const float* kr = Ks + sj * ldk;
      for (int d = 0; d < D; ++d) {
        const float kv = kr[d];
#pragma unroll
        for (int i = 0; i < kBQ / 4; ++i) acc[i] += Qs[(sr0 + 4 * i) * D + d] * kv;
      }
      const int key = k0 + sj;
      const bool ok = key < Lk;
      const float bias = (ok && biasb) ? biasb[key] : 0.f;
#pragma unroll
      for (int i = 0; i < kBQ / 4; ++i)
        Ss[(sr0 + 4 * i) * (kBK + 1) + sj] = ok ? acc[i] * scale + bias : -CUDART_INF_F;
    }
    __syncthreads();

    {  // online softmax update, one row per 4 threads
      float* srow = Ss + xr * (kBK + 1) + xpart * 8;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < 8; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_run[xr];
      const float m_new = fmaxf(m_old, mx);  // finite: every tile holds a key < Lk
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = __expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (xpart == 0) {
        const float a = __expf(m_old - m_new);  // 0 on the first tile
        alpha[xr] = a;
        l_run[xr] = l_run[xr] * a + sum;
        m_run[xr] = m_new;
      }
    }
    __syncthreads();

    // O = O * alpha + P V
    for (int d = pd0; d < D; d += 16) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < kBK; ++j) {
        const float vv = Vs[j * D + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += Ss[(pr0 + 8 * i) * (kBK + 1) + j] * vv;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = pr0 + 8 * i;
        Os[r * D + d] = Os[r * D + d] * alpha[r] + acc[i];
      }
    }
  }
  __syncthreads();

  T* ob = o + ((size_t)bh * Lq + q0) * D;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    if (q0 + r < Lq) ob[i] = psg::from_f32<T>(Os[i] / l_run[r]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* key_bias,
                   void* o, int B, int H, int Lq, int Lk, int D, float scale,
                   cudaStream_t stream) {
  const size_t smem = Smem::floats(D) * sizeof(float);
  cudaError_t err = psg::allow_smem(flash_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kBQ - 1) / kBQ, B * H);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      key_bias, static_cast<T*>(o), H, Lq, Lk, D, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t psg_flash_attention_smem_bytes(int D) {
  return Smem::floats(D) * sizeof(float);
}

extern "C" int psg_flash_attention(const void* q, const void* k, const void* v,
                                   const float* key_bias, void* o, int B, int H, int Lq,
                                   int Lk, int D, float scale, int dtype, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == psg::kFloat32)
    err = launch<float>(q, k, v, key_bias, o, B, H, Lq, Lk, D, scale, s);
  else if (dtype == psg::kBFloat16)
    err = launch<__nv_bfloat16>(q, k, v, key_bias, o, B, H, Lq, Lk, D, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
