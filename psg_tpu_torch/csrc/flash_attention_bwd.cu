// Attention backward: dq, dk, dv of o = softmax(q k^T * scale + key_bias) v
// from q, k, v, o, dO, the forward's row logsumexp and the key bias.
//
// The TPU kernel psg_tpu/ops/flash_attention.py::flash_sdpa (pallas_call
// at :92) has no VJP: the JAX package differentiates its XLA reference.
// This kernel takes the place of the plain recomputation that FlashSDPA's
// backward ran before, which built the [B, H, Lq, Lk] fp32 scores (0.54 GB
// a call at the SD-1.5 UNet's 27^2 self-attention).
//
// Algorithm (FlashAttention-2):
//   Delta_i = rowsum(dO_i * O_i), from the stored O and dO;
//   s = qk * scale, then + bias, each rounded in fp32, exactly as the
//   forward computes it; P = exp((s - c) - lse), with c the sample's
//   largest key bias (see flash_attention.cu: the forward's lse is taken
//   relative to c, which keeps a sample whose keys are all masked exact);
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Delta),
//   dQ = dS K * scale,  dK = dS^T Q * scale.
// Two kernels, no atomics, so the sums are deterministic: the dQ kernel
// (a CTA per 64 query rows, key tiles streamed) writes Delta first and
// recomputes S and dP; the dK/dV kernel (a CTA per 64 keys, query tiles
// streamed) reads Delta.  S and dP are computed twice, 7 products against
// the 5 a kernel with fp32 atomics on dQ would do.
//
// Bound on the H100: 5 products of 2 Lq Lk D operations each (4 Lq Lk D is
// the forward's two), 5.4e10 of them at SD 27^2 self-attention (B32 H8,
// Lk 729, hd 40): 0.055 ms at 989 TFLOP/s; the bytes (q, k, v, o, dO read,
// dq, dk, dv written, 119 MB) take 0.036 ms.
//
// bf16: tensor cores, mma.sync m16n8k16 (bf16 in, fp32 accumulate).  A warp
// owns 16 rows (query rows in the dQ kernel, keys in the dK/dV kernel) and
// DC output columns; S and dP are computed over the whole padded D (a
// compile-time depth of 16..80, 160 or 320, so their loops unroll), so a D
// wider than one column block (DC <= 80 for dQ, <= 64 for dK/dV, to keep
// the accumulators in registers) recomputes them for each block.  P and dS
// are rounded to bf16 for the products that take them.  Tiles stream
// through a ring of up to 2 stages in shared memory by cp.async (element
// loads where rows are not 16-byte aligned, D % 8 != 0).
//
// fp32 (BERT and CLIP under bf16 training, whose projections return fp32,
// and the parity runs): CUDA cores, the same two kernels on blocks of 32
// rows (dK/dV: 16 past hd 256), tiles in shared memory read as float4, each
// thread a 2 x 4 micro-tile of S and dP.
#include "common.cuh"

#include <math_constants.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

struct Strides {  // element strides of batch, head and row; the last dim is contiguous
  long long b, h, l;
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;       // [B, H, Lq]
  const float* key_bias;  // [B, Lk] or null
  void *dq, *dk, *dv;
  float* delta;           // [B, H, Lq] scratch
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int H, Lq, Lk, D;
  float scale;
};

// s = qk * scale + bias as the forward rounds it, and P = exp((s - c) - lse).
__device__ __forceinline__ float prob(float qk, float scale, float bias, float c, float lse) {
  const float s = __fadd_rn(__fmul_rn(qk, scale), bias);
  return __expf(__fsub_rn(__fsub_rn(s, c), lse));
}

// Delta of rows [row0, row0 + n): one warp, lanes over D.
template <typename T>
__device__ void warp_delta(float* out, int n, int row0, int Lq, const T* og, long long so,
                           const T* dog, long long sdo, int D) {
  const int lane = threadIdx.x % 32;
#pragma unroll 4
  for (int r = 0; r < n; ++r) {
    float acc = 0.f;
    if (row0 + r < Lq)
      for (int d = lane; d < D; d += 32)
        acc += psg::to_f32(dog[(long long)(row0 + r) * sdo + d]) *
               psg::to_f32(og[(long long)(row0 + r) * so + d]);
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[r] = acc;
  }
  __syncwarp();
}

// Column blocks of a padded width dp: the fewest blocks of at most max_dc
// columns (a multiple of 16 each).
void column_blocks(int dp, int max_dc, int* dc, int* splits) {
  *splits = (dp + max_dc - 1) / max_dc;
  *dc = ((dp + *splits - 1) / *splits + 15) / 16 * 16;
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kT = 32;         // streamed rows a tile (keys for dQ, queries for dK/dV)
constexpr int kThreads = 128;  // 16 x 8: ty = tid / 8 owns rows, tx = tid % 8 columns

// Shared-memory rows are D rounded up to 4 (zero-filled) plus 4: float4
// reads, and 8 rows read by 8 lanes land on distinct banks.
inline __host__ __device__ int row_pitch(int D) { return (D + 3) / 4 * 4 + 4; }

size_t smem_dq(int D) {  // 32 rows, key tiles of kT
  return sizeof(float) * ((size_t)5 * 32 * row_pitch(D) + 32 * (kT + 1) + 2 * 32);
}

size_t smem_dkdv(int R, int D) {  // R keys, query tiles of kT
  return sizeof(float) * ((size_t)(4 * R + 2 * kT) * row_pitch(D) + 2 * kT * (R + 1) + 2 * kT);
}

// keys a dK/dV block: 32 where it fits, else 16; 0 if neither does
int keys_for(int D) {
  if (smem_dq(D) > psg::kSmemLimit) return 0;
  for (int R : {32, 16})
    if (smem_dkdv(R, D) <= psg::kSmemLimit) return R;
  return 0;
}

// rows [0, n) of a strided operand into shared rows of pitch ld, zero past
// `nvalid` rows and past column D (up to the pitch's padding); by float4
// where rows are 16-byte aligned (1.5-1.7x faster on the H100 at BERT's and
// CLIP's shapes than element loads)
__device__ __forceinline__ void load_rows(float* dst, int ld, int n, const float* src,
                                          long long sl, int row0, int nvalid, int D) {
  const int w = ld - 4;
  if ((D & 3) == 0 && (sl & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int w4 = w / 4;  // D == w: whole float4s, no padding columns
    for (int i = threadIdx.x; i < n * w4; i += blockDim.x) {
      const int r = i / w4, c = (i - r * w4) * 4;
      *reinterpret_cast<float4*>(dst + r * ld + c) =
          row0 + r < nvalid
              ? *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * sl + c)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  for (int i = threadIdx.x; i < n * w; i += blockDim.x) {
    const int r = i / w, d = i % w;
    dst[r * ld + d] = (row0 + r < nvalid && d < D) ? src[(long long)(row0 + r) * sl + d] : 0.f;
  }
}

// Two score tiles over the padded depth, acc_s = X Y^T and acc_p = X2 Y2^T:
// a thread holds rows RP ty + i of X and X2 against rows tx + 8j of Y and Y2.
template <int RP, int KP>
__device__ __forceinline__ void score_tiles(float (&acc_s)[RP][KP], float (&acc_p)[RP][KP],
                                            const float* X, const float* X2, const float* Y,
                                            const float* Y2, int ld, int dpad) {
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int j = 0; j < KP; ++j) acc_s[i][j] = acc_p[i][j] = 0.f;
  for (int d = 0; d < dpad; d += 4) {
    float4 x[RP], x2[RP];
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      x[i] = *reinterpret_cast<const float4*>(X + (RP * ty + i) * ld + d);
      x2[i] = *reinterpret_cast<const float4*>(X2 + (RP * ty + i) * ld + d);
    }
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      const float4 y = *reinterpret_cast<const float4*>(Y + (tx + 8 * j) * ld + d);
      const float4 y2 = *reinterpret_cast<const float4*>(Y2 + (tx + 8 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        acc_s[i][j] += x[i].x * y.x + x[i].y * y.y + x[i].z * y.z + x[i].w * y.w;
        acc_p[i][j] += x2[i].x * y2.x + x2[i].y * y2.y + x2[i].z * y2.z + x2[i].w * y2.w;
      }
    }
  }
}

// out[row][:] += sum over the tile's kT rows m of C[m * cs + row * rs] *
// Y[m][:], for rows RP ty + i and the float4 column groups 4 tx + 32 n.
template <int RP>
__device__ __forceinline__ void accumulate(float* out, const float* C, int cs, int rs,
                                           const float* Y, int ld, int dpad) {
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  for (int c = 4 * tx; c < dpad; c += 32) {
    float4 acc[RP];
#pragma unroll
    for (int i = 0; i < RP; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int m = 0; m < kT; ++m) {
      const float4 y = *reinterpret_cast<const float4*>(Y + m * ld + c);
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const float w = C[m * cs + (RP * ty + i) * rs];
        acc[i].x += w * y.x;
        acc[i].y += w * y.y;
        acc[i].z += w * y.z;
        acc[i].w += w * y.w;
      }
    }
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      float4* o = reinterpret_cast<float4*>(out + (RP * ty + i) * ld + c);
      const float4 v = *o;
      *o = make_float4(v.x + acc[i].x, v.y + acc[i].y, v.z + acc[i].z, v.w + acc[i].w);
    }
  }
}

// grid (ceil(Lq / 32), B*H): 32 query rows, key tiles of kT.  Writes Delta.
__global__ void __launch_bounds__(kThreads) bwd_dq_f32(const Args a) {
  constexpr int R = 32, RP = 2, KP = kT / 8;
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[kThreads / 32];
  const int D = a.D, Lq = a.Lq, Lk = a.Lk, ld = row_pitch(D), dpad = ld - 4;
  float* Qs = sm;                   // [R][ld]
  float* dOs = Qs + R * ld;         // [R][ld]
  float* dQs = dOs + R * ld;        // [R][ld]
  float* Ks = dQs + R * ld;         // [kT][ld]
  float* Vs = Ks + kT * ld;         // [kT][ld]
  float* dSs = Vs + kT * ld;        // [R][kT + 1]
  float* dl = dSs + R * (kT + 1);   // [R] Delta
  float* ls = dl + R;               // [R] lse

  const int tid = threadIdx.x, warp = tid / 32, ty = tid / 8, tx = tid % 8;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int q0 = blockIdx.x * R;
  const float* qg = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* kg = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* vg = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* og = static_cast<const float*>(a.o) + b * a.so.b + h * a.so.h;
  const float* dog = static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const float* biasb = a.key_bias ? a.key_bias + (size_t)b * Lk : nullptr;
  const size_t row_base = ((size_t)b * a.H + h) * Lq;
  const float c = psg::block_max_bias(biasb, Lk, red);

  load_rows(Qs, ld, R, qg, a.sq.l, q0, Lq, D);
  load_rows(dOs, ld, R, dog, a.sdo.l, q0, Lq, D);
  for (int i = tid; i < R * ld; i += kThreads) dQs[i] = 0.f;
  warp_delta(dl + warp * (R / 4), R / 4, q0 + warp * (R / 4), Lq, og, a.so.l, dog, a.sdo.l,
             D);
  __syncthreads();
  if (tid < R) {
    ls[tid] = q0 + tid < Lq ? a.lse[row_base + q0 + tid] : 0.f;
    if (q0 + tid < Lq) a.delta[row_base + q0 + tid] = dl[tid];
  }

  for (int k0 = 0; k0 < Lk; k0 += kT) {
    __syncthreads();
    load_rows(Ks, ld, kT, kg, a.sk.l, k0, Lk, D);
    load_rows(Vs, ld, kT, vg, a.sv.l, k0, Lk, D);
    __syncthreads();
    float acc_s[RP][KP], acc_p[RP][KP];
    score_tiles<RP, KP>(acc_s, acc_p, Qs, dOs, Ks, Vs, ld, dpad);
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      const int key = k0 + tx + 8 * j;
      const float bias = (key < Lk && biasb) ? biasb[key] : 0.f;
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const int r = RP * ty + i;
        const float p = key < Lk ? prob(acc_s[i][j], a.scale, bias, c, ls[r]) : 0.f;
        dSs[r * (kT + 1) + tx + 8 * j] = p * (acc_p[i][j] - dl[r]);
      }
    }
    __syncthreads();
    // dQ[r][:] += sum_m dS[r][m] K[m][:]
    accumulate<RP>(dQs, dSs, 1, kT + 1, Ks, ld, dpad);
  }
  __syncthreads();
  float* dqg = static_cast<float*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (q0 + r < Lq) dqg[(long long)(q0 + r) * a.sdq.l + d] = dQs[r * ld + d] * a.scale;
  }
}

// grid (ceil(Lk / R), B*H): R keys, query tiles of kT.
template <int R>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_f32(const Args a) {
  constexpr int QP = kT / 16, KP = R / 8, RP = R / 16;
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[kThreads / 32];
  const int D = a.D, Lq = a.Lq, Lk = a.Lk, ld = row_pitch(D), dpad = ld - 4;
  float* Ks = sm;                   // [R][ld]
  float* Vs = Ks + R * ld;          // [R][ld]
  float* dKs = Vs + R * ld;         // [R][ld]
  float* dVs = dKs + R * ld;        // [R][ld]
  float* Qs = dVs + R * ld;         // [kT][ld]
  float* dOs = Qs + kT * ld;        // [kT][ld]
  float* Ps = dOs + kT * ld;        // [kT][R + 1]
  float* dSs = Ps + kT * (R + 1);   // [kT][R + 1]
  float* ls = dSs + kT * (R + 1);   // [kT] lse
  float* dl = ls + kT;              // [kT] Delta

  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int k0 = blockIdx.x * R;
  const float* qg = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* kg = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* vg = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* dog = static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const float* biasb = a.key_bias ? a.key_bias + (size_t)b * Lk : nullptr;
  const size_t row_base = ((size_t)b * a.H + h) * Lq;
  const float c = psg::block_max_bias(biasb, Lk, red);

  load_rows(Ks, ld, R, kg, a.sk.l, k0, Lk, D);
  load_rows(Vs, ld, R, vg, a.sv.l, k0, Lk, D);
  for (int i = tid; i < 2 * R * ld; i += kThreads) dKs[i] = 0.f;  // dK and dV
  float bias[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j) {
    const int key = k0 + tx + 8 * j;
    bias[j] = (key < Lk && biasb) ? biasb[key] : 0.f;
  }

  for (int q0 = 0; q0 < Lq; q0 += kT) {
    __syncthreads();
    load_rows(Qs, ld, kT, qg, a.sq.l, q0, Lq, D);
    load_rows(dOs, ld, kT, dog, a.sdo.l, q0, Lq, D);
    if (tid < kT) {
      const bool ok = q0 + tid < Lq;
      ls[tid] = ok ? a.lse[row_base + q0 + tid] : 0.f;
      dl[tid] = ok ? a.delta[row_base + q0 + tid] : 0.f;
    }
    __syncthreads();
    // S and dP of queries QP ty + i against keys tx + 8j
    float acc_s[QP][KP], acc_p[QP][KP];
    score_tiles<QP, KP>(acc_s, acc_p, Qs, dOs, Ks, Vs, ld, dpad);
#pragma unroll
    for (int i = 0; i < QP; ++i) {
      const int r = QP * ty + i;
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        const float p = q0 + r < Lq ? prob(acc_s[i][j], a.scale, bias[j], c, ls[r]) : 0.f;
        Ps[r * (R + 1) + tx + 8 * j] = p;
        dSs[r * (R + 1) + tx + 8 * j] = p * (acc_p[i][j] - dl[r]);
      }
    }
    __syncthreads();
    // dV[k][:] += sum_m P[m][k] dO[m][:], dK[k][:] += sum_m dS[m][k] Q[m][:]
    accumulate<RP>(dVs, Ps, R + 1, 1, dOs, ld, dpad);
    accumulate<RP>(dKs, dSs, R + 1, 1, Qs, ld, dpad);
  }
  __syncthreads();
  float* dkg = static_cast<float*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  float* dvg = static_cast<float*>(a.dv) + b * a.sdv.b + h * a.sdv.h;
  for (int i = tid; i < R * D; i += kThreads) {
    const int j = i / D, d = i % D;
    if (k0 + j < Lk) {
      dkg[(long long)(k0 + j) * a.sdk.l + d] = dKs[j * ld + d] * a.scale;
      dvg[(long long)(k0 + j) * a.sdv.l + d] = dVs[j * ld + d];
    }
  }
}

template <int R>
cudaError_t launch_dkdv(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_dkdv(R, a.D);
  cudaError_t err = psg::allow_smem(bwd_dkdv_f32<R>, smem);
  if (err != cudaSuccess) return err;
  bwd_dkdv_f32<R><<<dim3((a.Lk + R - 1) / R, B * a.H), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int R = keys_for(a.D);
  if (R == 0) return cudaErrorInvalidValue;
  const size_t s1 = smem_dq(a.D);
  cudaError_t err = psg::allow_smem(bwd_dq_f32, s1);
  if (err != cudaSuccess) return err;
  bwd_dq_f32<<<dim3((a.Lq + 31) / 32, B * a.H), kThreads, s1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return R == 32 ? launch_dkdv<32>(a, B, stream) : launch_dkdv<16>(a, B, stream);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync)
// ---------------------------------------------------------------------------

namespace tc {

// rows a CTA (a warp per 16): 64, or 128 at the padded depth 160, where
// twice the warps on each streamed tile measured 1.6x faster on the H100
// (and slower at hd 40)
inline int rows_for(int dp) { return dp == 160 ? 128 : 64; }
constexpr int kTile = 64;      // streamed rows a tile
constexpr int kPad = 8;        // bf16 elements of row padding: conflict-free ldmatrix
constexpr int kMaxDcDq = 80;   // dQ columns a CTA
constexpr int kMaxDcDkdv = 64; // dK and dV columns a CTA

using psg::ldmatrix_x4;
using psg::ldmatrix_x4_trans;
using psg::mma;
using psg::pack_bf16;

struct Plan {
  int dp, dc, splits, wp, stages, rows;  // wp: columns loaded, splits * dc >= dp
  size_t smem;
};

size_t smem_dq(int wp, int st, int Lk, bool bias, int rows) {
  const int ntiles = (Lk + kTile - 1) / kTile;
  return sizeof(bf16) * (size_t)2 * (rows + st * kTile) * (wp + kPad) +
         sizeof(float) * (rows + (bias ? ntiles * kTile : 0));
}

size_t smem_dkdv(int wp, int st, int rows) {
  return sizeof(bf16) * (size_t)2 * (rows + st * kTile) * (wp + kPad) +
         sizeof(float) * 2 * st * kTile;
}

// The depth S and dP are computed over, a compile-time constant of each
// kernel: D rounded up to 16 up to 80, else 160 or 320 (the head dims
// between are padded with zeros).
inline int padded_depth(int D) {
  const int dp = (D + 15) / 16 * 16;
  return dp <= 80 ? dp : dp <= 160 ? 160 : 320;
}

bool make_plan(int Lk, int D, bool dq, bool bias, Plan* p) {
  p->dp = padded_depth(D);
  column_blocks(p->dp, dq ? kMaxDcDq : kMaxDcDkdv, &p->dc, &p->splits);
  p->wp = p->dc * p->splits;
  p->rows = rows_for(p->dp);
  for (int st = 2; st >= 1; --st) {
    p->stages = st;
    p->smem = dq ? smem_dq(p->wp, st, Lk, bias, p->rows) : smem_dkdv(p->wp, st, p->rows);
    if (p->smem <= psg::kSmemLimit) return true;
  }
  return false;
}

__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n == 0)
    psg::cp_async_wait<0>();
  else
    psg::cp_async_wait<1>();
}

// rows [0, nrows) x columns [0, ncols) of a shared-memory tile with row
// stride ld, from src + (row0 + r) * sl + c; zero where row0 + r >= nvalid
// or c >= D.  ncols is a multiple of 16.  With `vec` (rows 16-byte
// aligned) by cp.async, else element by element.
__device__ __forceinline__ void load_tile(bf16* dst, int ld, int nrows, int ncols,
                                          const bf16* src, long long sl, int row0,
                                          int nvalid, int D, bool vec) {
  if (vec) {
    const int cpr = ncols / 8;
    for (int i = threadIdx.x; i < nrows * cpr; i += blockDim.x) {
      const int r = i / cpr, col = (i % cpr) * 8;
      const bool ok = row0 + r < nvalid && col < D;
      psg::cp_async16(dst + r * ld + col, ok ? src + (long long)(row0 + r) * sl + col : src,
                      ok);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * ncols; i += blockDim.x) {
      const int r = i / ncols, c = i % ncols;
      const bool ok = row0 + r < nvalid && c < D;
      dst[r * ld + c] = ok ? src[(long long)(row0 + r) * sl + c] : __float2bfloat16(0.f);
    }
  }
}

// Fragment addresses (bytes, shared space) of a row-major tile with row
// stride ld, for a warp: the A operand of its 16 rows from `row`; the B
// operand of S = X Y^T (Y's rows are the N dimension); the B operand of
// O = P Y (Y's rows are the K dimension, read transposed).
__device__ __forceinline__ uint32_t a_addr(const bf16* t, int ld, int row) {
  const int lane = threadIdx.x % 32, lrow = lane & 7, lmat = lane >> 3;
  return psg::smem_addr(t + (row + lrow + (lmat & 1) * 8) * ld + (lmat >> 1) * 8);
}
__device__ __forceinline__ uint32_t bt_addr(const bf16* t, int ld) {
  const int lane = threadIdx.x % 32, lrow = lane & 7, lmat = lane >> 3;
  return psg::smem_addr(t + (lrow + (lmat >> 1) * 8) * ld + (lmat & 1) * 8);
}
__device__ __forceinline__ uint32_t bn_addr(const bf16* t, int ld) {
  const int lane = threadIdx.x % 32, lrow = lane & 7, lmat = lane >> 3;
  return psg::smem_addr(t + (lrow + (lmat & 1) * 8) * ld + (lmat >> 1) * 8);
}

// acc1 = X1 Y1^T and acc2 = X2 Y2^T for a warp's 16 rows and a 64-row tile
// (8 blocks of 8 columns), over 16 NK columns.  Unrolled and unguarded:
// rows of a ragged tile are zero in shared memory and masked by index.
template <int NK>
__device__ __forceinline__ void two_products(float (&acc1)[8][4], float (&acc2)[8][4],
                                             uint32_t x1, uint32_t y1, uint32_t x2,
                                             uint32_t y2, int ld) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[j][e] = acc2[j][e] = 0.f;
  // unrolled by at most 5 steps of 16, which keeps the deep hd-160/320
  // bodies out of spilling
  constexpr int kU = NK > 10 ? 5 : NK;
#pragma unroll 1
  for (int k0 = 0; k0 < NK; k0 += kU) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int kk = (k0 + u) * 16;
      uint32_t f1[4], f2[4];
      ldmatrix_x4(f1, x1 + kk * 2);
      ldmatrix_x4(f2, x2 + kk * 2);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, y1 + (jp * 16 * ld + kk) * 2);
        mma(acc1[2 * jp], f1, b[0], b[1]);
        mma(acc1[2 * jp + 1], f1, b[2], b[3]);
        ldmatrix_x4(b, y2 + (jp * 16 * ld + kk) * 2);
        mma(acc2[2 * jp], f2, b[0], b[1]);
        mma(acc2[2 * jp + 1], f2, b[2], b[3]);
      }
    }
  }
}

// acc += P Y[:, c0 .. c0 + DC) with P the warp's 16 x 64 fp32 values
// (rounded to bf16) and Y a 64-row tile read transposed from `y`.
template <int DC>
__device__ __forceinline__ void product_pv(float (&acc)[DC / 8][4], const float (&p)[8][4],
                                           uint32_t y, int ld, int c0) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    uint32_t pf[4];
    pf[0] = pack_bf16(p[2 * jj][0], p[2 * jj][1]);
    pf[1] = pack_bf16(p[2 * jj][2], p[2 * jj][3]);
    pf[2] = pack_bf16(p[2 * jj + 1][0], p[2 * jj + 1][1]);
    pf[3] = pack_bf16(p[2 * jj + 1][2], p[2 * jj + 1][3]);
#pragma unroll
    for (int cp = 0; cp < DC / 16; ++cp) {
      uint32_t f[4];
      ldmatrix_x4_trans(f, y + (jj * 16 * ld + c0 + cp * 16) * 2);
      mma(acc[2 * cp], pf, f[0], f[1]);
      mma(acc[2 * cp + 1], pf, f[2], f[3]);
    }
  }
}

// Store a warp's 16 x DC accumulator (times `mul`) to rows row0 + g (+ 8)
// and columns c0 + ... of a strided bf16 operand, below `nrows` and D.
template <int DC>
__device__ __forceinline__ void store_rows(bf16* dst, long long sl, const float (&acc)[DC / 8][4],
                                           float mul, int row0, int nrows, int c0, int D) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  const bool pairs = (D & 1) == 0;
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
    const int col = c0 + n * 8 + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= nrows || col >= D) continue;
      const float v0 = acc[n][2 * r] * mul, v1 = acc[n][2 * r + 1] * mul;
      bf16* p = dst + (long long)row * sl + col;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
      } else {
        p[0] = __float2bfloat16(v0);
        if (col + 1 < D) p[1] = __float2bfloat16(v1);
      }
    }
  }
}

// grid (ceil(Lq / 64), splits, B*H): 64 query rows, key tiles streamed;
// columns c0 .. c0 + DC of dQ.  Writes Delta (column block 0).
template <int DC, int NK, int ROWS>
__global__ void __launch_bounds__(2 * ROWS) bwd_dq_bf16(const Args a, int wp, int stages,
                                                        int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[2 * ROWS / 32];
  const int D = a.D, Lq = a.Lq, Lk = a.Lk;
  const int ld = wp + kPad, ntiles = (Lk + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z / a.H, h = blockIdx.z % a.H;
  const int q0 = blockIdx.x * ROWS, c0 = blockIdx.y * DC;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);     // [ROWS][ld]
  bf16* dOs = Qs + ROWS * ld;                        // [ROWS][ld]
  bf16* Ks = dOs + ROWS * ld;                        // [stages][64][ld]
  bf16* Vs = Ks + stages * kTile * ld;               // [stages][64][ld]
  float* dl = reinterpret_cast<float*>(Vs + stages * kTile * ld);  // [ROWS] Delta
  float* Bs = dl + ROWS;                             // [ntiles * 64] key bias
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h;
  const bf16* og = static_cast<const bf16*>(a.o) + b * a.so.b + h * a.so.h;
  const bf16* dog = static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const float* biasb = a.key_bias ? a.key_bias + (size_t)b * Lk : nullptr;
  const size_t row_base = ((size_t)b * a.H + h) * Lq;

  load_tile(Qs, ld, ROWS, wp, qg, a.sq.l, q0, Lq, D, vec);
  load_tile(dOs, ld, ROWS, wp, dog, a.sdo.l, q0, Lq, D, vec);
  auto load_kv = [&](int t) {
    const int s = t % stages;
    load_tile(Ks + s * kTile * ld, ld, kTile, wp, kg, a.sk.l, t * kTile, Lk, D, vec);
    load_tile(Vs + s * kTile * ld, ld, kTile, wp, vg, a.sv.l, t * kTile, Lk, D, vec);
  };
  for (int t = 0; t < stages; ++t) {  // group t holds tile t (and Q, dO with tile 0)
    if (t < ntiles) load_kv(t);
    psg::cp_async_commit();
  }
  if (biasb)
    for (int j = threadIdx.x; j < ntiles * kTile; j += blockDim.x)
      Bs[j] = j < Lk ? biasb[j] : 0.f;
  const float c = psg::block_max_bias(biasb, Lk, red);
  const int row0 = q0 + warp * 16;
  warp_delta(dl + warp * 16, 16, row0, Lq, og, a.so.l, dog, a.sdo.l, D);
  if (blockIdx.y == 0 && lane < 16 && row0 + lane < Lq)
    a.delta[row_base + row0 + lane] = dl[warp * 16 + lane];
  float delta[2], lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    delta[r] = dl[warp * 16 + g + 8 * r];
    lse[r] = row < Lq ? a.lse[row_base + row] : 0.f;
  }
  const bool active = row0 < Lq;

  float dq[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const uint32_t qa = a_addr(Qs, ld, warp * 16), doa = a_addr(dOs, ld, warp * 16);

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_upto(stages - 1);
    __syncthreads();
    const int s = t % stages, k0 = t * kTile;
    const int nk = Lk - k0 < kTile ? Lk - k0 : kTile;
    if (active) {
      const bf16* Kt = Ks + s * kTile * ld;
      const bf16* Vt = Vs + s * kTile * ld;
      float sacc[8][4], pacc[8][4];
      two_products<NK>(sacc, pacc, qa, bt_addr(Kt, ld), doa, bt_addr(Vt, ld), ld);
      // dS = P * (dP - Delta), in sacc; zero past Lk
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = j * 8 + 2 * tq;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kj + (e & 1);
          const float p = key < nk ? prob(sacc[j][e], a.scale, biasb ? Bs[k0 + key] : 0.f, c,
                                          lse[e >> 1])
                                   : 0.f;
          sacc[j][e] = p * (pacc[j][e] - delta[e >> 1]);
        }
      }
      product_pv<DC>(dq, sacc, bn_addr(Kt, ld), ld, c0);
    }
    if (t + stages < ntiles) {
      __syncthreads();
      load_kv(t + stages);
    }
    psg::cp_async_commit();
  }
  if (active)
    store_rows<DC>(static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h, a.sdq.l, dq, a.scale,
                   row0, Lq, c0, D);
}

// grid (ceil(Lk / 64), splits, B*H): 64 keys, query tiles streamed;
// columns c0 .. c0 + DC of dK and dV.
template <int DC, int NK, int ROWS>
__global__ void __launch_bounds__(2 * ROWS) bwd_dkdv_bf16(const Args a, int wp, int stages,
                                                          int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[2 * ROWS / 32];
  const int D = a.D, Lq = a.Lq, Lk = a.Lk;
  const int ld = wp + kPad, ntiles = (Lq + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z / a.H, h = blockIdx.z % a.H;
  const int k0 = blockIdx.x * ROWS, c0 = blockIdx.y * DC;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);     // [ROWS][ld]
  bf16* Vs = Ks + ROWS * ld;                         // [ROWS][ld]
  bf16* Qs = Vs + ROWS * ld;                         // [stages][64][ld]
  bf16* dOs = Qs + stages * kTile * ld;              // [stages][64][ld]
  float* Ls = reinterpret_cast<float*>(dOs + stages * kTile * ld);  // [stages][64] lse
  float* Dl = Ls + stages * kTile;                   // [stages][64] Delta
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h;
  const bf16* dog = static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const float* biasb = a.key_bias ? a.key_bias + (size_t)b * Lk : nullptr;
  const size_t row_base = ((size_t)b * a.H + h) * Lq;
  const float* lseg = a.lse + row_base;
  const float* deltag = a.delta + row_base;

  load_tile(Ks, ld, ROWS, wp, kg, a.sk.l, k0, Lk, D, vec);
  load_tile(Vs, ld, ROWS, wp, vg, a.sv.l, k0, Lk, D, vec);
  auto load_q = [&](int t) {
    const int s = t % stages, r0 = t * kTile;
    load_tile(Qs + s * kTile * ld, ld, kTile, wp, qg, a.sq.l, r0, Lq, D, vec);
    load_tile(dOs + s * kTile * ld, ld, kTile, wp, dog, a.sdo.l, r0, Lq, D, vec);
    if (threadIdx.x < kTile) {
      const int r = r0 + threadIdx.x;
      const bool ok = r < Lq;
      psg::cp_async4(Ls + s * kTile + threadIdx.x, ok ? lseg + r : lseg, ok);
      psg::cp_async4(Dl + s * kTile + threadIdx.x, ok ? deltag + r : deltag, ok);
    }
  };
  for (int t = 0; t < stages; ++t) {  // group t holds tile t (and K, V with tile 0)
    if (t < ntiles) load_q(t);
    psg::cp_async_commit();
  }
  const float c = psg::block_max_bias(biasb, Lk, red);
  const int key0 = k0 + warp * 16;  // this warp's keys key0 .. + 15
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + g + 8 * r;
    bias[r] = biasb && key < Lk ? biasb[key] : 0.f;
  }
  const bool active = key0 < Lk;

  float dk[DC / 8][4], dv[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const uint32_t ka = a_addr(Ks, ld, warp * 16), va = a_addr(Vs, ld, warp * 16);

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_upto(stages - 1);
    __syncthreads();
    const int s = t % stages, q0 = t * kTile;
    const int nq = Lq - q0 < kTile ? Lq - q0 : kTile;
    if (active) {
      const bf16* Qt = Qs + s * kTile * ld;
      const bf16* dOt = dOs + s * kTile * ld;
      const float* Lt = Ls + s * kTile;
      const float* Dt = Dl + s * kTile;
      // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys, columns
      // the tile's queries
      float pt[8][4], dst[8][4];
      two_products<NK>(pt, dst, ka, bt_addr(Qt, ld), va, bt_addr(dOt, ld), ld);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qj = j * 8 + 2 * tq;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = qj + (e & 1);
          const float p = qr < nq ? prob(pt[j][e], a.scale, bias[e >> 1], c, Lt[qr]) : 0.f;
          pt[j][e] = p;
          dst[j][e] = p * (dst[j][e] - Dt[qr]);
        }
      }
      product_pv<DC>(dv, pt, bn_addr(dOt, ld), ld, c0);
      product_pv<DC>(dk, dst, bn_addr(Qt, ld), ld, c0);
    }
    if (t + stages < ntiles) {
      __syncthreads();
      load_q(t + stages);
    }
    psg::cp_async_commit();
  }
  if (active) {
    store_rows<DC>(static_cast<bf16*>(a.dk) + b * a.sdk.b + h * a.sdk.h, a.sdk.l, dk, a.scale,
                   key0, Lk, c0, D);
    store_rows<DC>(static_cast<bf16*>(a.dv) + b * a.sdv.b + h * a.sdv.h, a.sdv.l, dv, 1.f,
                   key0, Lk, c0, D);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int DC, int NK, int ROWS = 64>
cudaError_t launch_dq(const Args& a, const Plan& p, int B, int vec, cudaStream_t stream) {
  cudaError_t err = psg::allow_smem(bwd_dq_bf16<DC, NK, ROWS>, p.smem);
  if (err != cudaSuccess) return err;
  bwd_dq_bf16<DC, NK, ROWS><<<dim3((a.Lq + ROWS - 1) / ROWS, p.splits, B * a.H), 2 * ROWS,
                              p.smem, stream>>>(a, p.wp, p.stages, vec);
  return cudaGetLastError();
}

template <int DC, int NK, int ROWS = 64>
cudaError_t launch_dkdv(const Args& a, const Plan& p, int B, int vec, cudaStream_t stream) {
  cudaError_t err = psg::allow_smem(bwd_dkdv_bf16<DC, NK, ROWS>, p.smem);
  if (err != cudaSuccess) return err;
  bwd_dkdv_bf16<DC, NK, ROWS><<<dim3((a.Lk + ROWS - 1) / ROWS, p.splits, B * a.H), 2 * ROWS,
                                p.smem, stream>>>(a, p.wp, p.stages, vec);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  Plan pq, pk;
  if (!make_plan(a.Lk, a.D, true, a.key_bias != nullptr, &pq) ||
      !make_plan(a.Lk, a.D, false, false, &pk))
    return cudaErrorInvalidValue;
  bool vec = a.D % 8 == 0;
  const void* ptrs[5] = {a.q, a.k, a.v, a.o, a.dout};
  for (const void* p : ptrs) vec = vec && aligned16(p);
  const Strides ops[4] = {a.sq, a.sk, a.sv, a.sdo};
  for (const Strides& s : ops) vec = vec && s.b % 8 == 0 && s.h % 8 == 0 && s.l % 8 == 0;
  // (column block, depth) of each padded depth: see padded_depth and kMaxDc*
  cudaError_t err;
  switch (pq.dp) {
    case 16: err = launch_dq<16, 1>(a, pq, B, vec, stream); break;
    case 32: err = launch_dq<32, 2>(a, pq, B, vec, stream); break;
    case 48: err = launch_dq<48, 3>(a, pq, B, vec, stream); break;
    case 64: err = launch_dq<64, 4>(a, pq, B, vec, stream); break;
    case 80: err = launch_dq<80, 5>(a, pq, B, vec, stream); break;
    case 160: err = launch_dq<80, 10, 128>(a, pq, B, vec, stream); break;
    default: err = launch_dq<80, 20>(a, pq, B, vec, stream); break;
  }
  if (err != cudaSuccess) return err;
  switch (pk.dp) {
    case 16: return launch_dkdv<16, 1>(a, pk, B, vec, stream);
    case 32: return launch_dkdv<32, 2>(a, pk, B, vec, stream);
    case 48: return launch_dkdv<48, 3>(a, pk, B, vec, stream);
    case 64: return launch_dkdv<64, 4>(a, pk, B, vec, stream);
    case 80: return launch_dkdv<48, 5>(a, pk, B, vec, stream);
    case 160: return launch_dkdv<64, 10, 128>(a, pk, B, vec, stream);
    default: return launch_dkdv<64, 20>(a, pk, B, vec, stream);
  }
}

}  // namespace tc

}  // namespace

// Shared memory of the larger of the two launches (with a key bias), or 0
// if the kernels do not take this shape (bf16: D > 320 or a key-bias row
// too long; fp32: D too wide for a 16-row block).
extern "C" size_t psg_flash_attention_bwd_smem_bytes(int Lk, int D, int dtype) {
  if (D < 1 || D > 320) return 0;
  if (dtype == psg::kFloat32) {
    const int R = f32::keys_for(D);
    if (R == 0) return 0;
    const size_t s1 = f32::smem_dq(D), s2 = f32::smem_dkdv(R, D);
    return s1 > s2 ? s1 : s2;
  }
  tc::Plan pq, pk;
  if (!tc::make_plan(Lk, D, true, true, &pq) || !tc::make_plan(Lk, D, false, false, &pk))
    return 0;
  return pq.smem > pk.smem ? pq.smem : pk.smem;
}

// strides: 24 element strides, (batch, head, row) of q, k, v, o, dout, dq,
// dk and dv.  lse and delta: [B, H, Lq] fp32 (delta is written).
extern "C" int psg_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* lse,
                                       const float* key_bias, void* dq, void* dk, void* dv,
                                       float* delta, const long long* strides, int B, int H,
                                       int Lq, int Lk, int D, float scale, int dtype,
                                       void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || D > 320 || (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.key_bias = key_bias;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.delta = delta;
  Strides* s[8] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 8; ++i) *s[i] = Strides{strides[3 * i], strides[3 * i + 1],
                                              strides[3 * i + 2]};
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.D = D;
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == psg::kFloat32)
    err = f32::launch(a, B, st);
  else if (dtype == psg::kBFloat16)
    err = tc::launch(a, B, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
