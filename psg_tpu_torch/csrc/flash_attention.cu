// Short-KV attention: o = softmax(q k^T * scale + key_bias) v.
//
// Replaces the TPU kernel psg_tpu/ops/flash_attention.py::flash_sdpa
// (_flash_impl at :61, pallas_call at :92, body _attn_kernel at :34).
//
// Shapes on the model's path: q [B,H,Lq,D], k/v [B,H,Lk,D] with Lk <= 196
// and D in {4..16, 32, 64, 160, 320}; key_bias [B, Lk] fp32 (the
// [B,1,1,Lk] additive mask) or null.  q, k, v and o are strided: each is
// addressed by its batch, head and row strides in elements, and its last
// dimension is contiguous.  So q/k/v can be head views of a projection and o
// can be written in [B, Lq, H, D] memory order, with no copies around the
// call.
//
// Bound on the H100: at these short key lengths the work is 4 * Lk
// operations per query element read, below the card's ~295 bf16 operations
// per byte, so the least time is set by the bytes of q, k, v and o; the
// UNet's hd-160/320 self-attention sits near the balance point.
//
// bf16 (the model's path): tensor cores.
// - mma.sync.m16n8k16 bf16 -> fp32 for S = Q K^T and O += P V.  One warp
//   owns 16 query rows and DC output columns; scores, softmax, row sums and
//   the accumulator are fp32, P is rounded to bf16 for the second product
//   (as the reference does, flash_attention.py:47), and O is divided by the
//   row sum in fp32 at the end.
// - K/V residency: key tiles of 64 rows, with their slice of the key bias,
//   stream through a ring of up to 4 stages in shared memory, loaded with
//   cp.async, under an online (running max / running sum) softmax.  At
//   every main-path shape the ring holds the whole of K/V (Lk <= 196 is 4
//   tiles), so every load is in flight from the start and the TPU kernel's
//   one-shot residency falls out as the common case; a longer Lk still
//   runs, through the ring.  Streaming was chosen over a one-shot softmax
//   because one-shot needs a warp's whole 16 x Lk score row in registers
//   (104 a thread at Lk 196) on top of the accumulator.
// - A CTA holds up to 8 warps of query rows (128 rows), so fewer CTAs
//   re-read the same K/V from L2, and never fewer than 4 warps: at Lq 16
//   the three without rows still issue the loads, which at hd 320 are
//   most of the work.
// - Filling the card at small Lq: the output columns are split across CTAs
//   (DC in {16, 32, 64, 80}; each split recomputes S, which is cheap at
//   Lk <= 196), so the 7^2 and 4^2 hd-320 sites launch 128 CTAs, and a
//   warp's accumulator is DC / 2 fp32 registers a thread (40 at DC 80).
//   ptxas shows no spills.  Measured on the H100, none of a DC of 160 (no
//   split at hd 160), a key split inside the CTA (warp pairs on alternate
//   tiles, so S is computed once) or loading the next step's fragments
//   during the products paid over the mix of main-path shapes.
// - A D that is not a multiple of 16 is zero-filled in shared memory, never
//   padded in device memory; ragged Lq and Lk are masked in the kernel.
//   Operands whose rows are not 16-byte aligned (D % 8 != 0, as in the tiny
//   configs) take element loads instead of cp.async.
//
// fp32 (parity runs only): PR 1's CUDA-core body under the same strided
// contract.  fp32 on tensor cores would be TF32 and miss the fp32
// tolerance.
#include "common.cuh"

#include <math_constants.h>

namespace {

using bf16 = __nv_bfloat16;

struct Strides {  // element strides of batch, head and row; the last dim is contiguous
  long long b, h, l;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* key_bias;  // [B, Lk] or null
  void* o;
  Strides sq, sk, sv, so;
  int H, Lq, Lk, D;
  float scale;
};

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kBQ = 32;       // query rows per block
constexpr int kBK = 32;       // keys per tile
constexpr int kThreads = 128;

size_t smem_bytes(int D) {
  const int ldk = D | 1;  // odd stride: conflict-free column reads of K
  return sizeof(float) * ((size_t)kBQ * D          // Q
                          + (size_t)kBK * ldk      // K tile
                          + (size_t)kBK * D        // V tile
                          + (size_t)kBQ * (kBK + 1)  // scores / probabilities
                          + (size_t)kBQ * D        // output accumulator
                          + 3 * kBQ);              // running max, running sum, rescale
}

__global__ void __launch_bounds__(kThreads) flash_f32(const Args a) {
  extern __shared__ float sm[];
  const int D = a.D, Lq = a.Lq, Lk = a.Lk;
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
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int q0 = blockIdx.x * kBQ;
  const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* biasb = a.key_bias ? a.key_bias + (size_t)b * Lk : nullptr;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[i] = (q0 + r < Lq) ? qb[(q0 + r) * a.sq.l + d] : 0.f;
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
      Ks[j * ldk + d] = ok ? kb[(k0 + j) * a.sk.l + d] : 0.f;
      Vs[i] = ok ? vb[(k0 + j) * a.sv.l + d] : 0.f;
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
        Ss[(sr0 + 4 * i) * (kBK + 1) + sj] = ok ? acc[i] * a.scale + bias : -CUDART_INF_F;
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
        const float al = __expf(m_old - m_new);  // 0 on the first tile
        alpha[xr] = al;
        l_run[xr] = l_run[xr] * al + sum;
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

  float* ob = static_cast<float*>(a.o) + b * a.so.b + h * a.so.h;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (q0 + r < Lq) ob[(q0 + r) * a.so.l + d] = Os[i] / l_run[r];
  }
}

cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.D);
  cudaError_t err = psg::allow_smem(flash_f32, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, B * a.H);
  flash_f32<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kRows = 16;       // query rows per warp: one m16 tile
constexpr int kBK = 64;         // keys per tile
constexpr int kMaxWarps = 8;    // warps (16-row query tiles) per CTA
constexpr int kMinWarps = 4;    // warps that load, whatever Lq
constexpr int kMaxStages = 4;   // K/V tiles resident at once
constexpr int kMaxSplits = 4;   // column splits of O, so D <= 4 * 80
constexpr int kPad = 8;         // bf16 elements of row padding: conflict-free ldmatrix
constexpr int kWarpsPerSm = 4;  // warps a call should give each SM

using psg::ldmatrix_x4;
using psg::ldmatrix_x4_trans;
using psg::mma;
using psg::num_sms;
using psg::pack_bf16;

struct Plan {
  int dc, nw, splits, qblocks, stages;
  size_t smem;
};

// The launch shape for one call, from its sizes only; false if D > 320.
bool make_plan(int B, int H, int Lq, int Lk, int D, Plan* p) {
  const int dp = (D + 15) / 16 * 16;
  const int rt = (Lq + kRows - 1) / kRows;
  const long long bh = (long long)B * H;
  // the widest column split that still gives kWarpsPerSm warps an SM, else
  // the one that gives the most
  static const int kWidths[] = {80, 64, 32, 16};
  p->dc = 0;
  for (int dc : kWidths) {
    const int splits = (D + dc - 1) / dc;
    if (dc > dp || splits > kMaxSplits) continue;
    p->dc = dc;
    p->splits = splits;
    if ((long long)rt * splits * bh >= (long long)kWarpsPerSm * num_sms()) break;
  }
  if (p->dc == 0) return false;
  const size_t tile_bytes =
      sizeof(bf16) * kBK * ((dp + kPad) + (p->dc + kPad)) + sizeof(float) * kBK;
  const int ntiles = (Lk + kBK - 1) / kBK;
  // as many query rows a CTA as fit beside at least one K/V tile
  for (int nw = rt < kMaxWarps ? rt : kMaxWarps; nw >= 1; nw /= 2) {
    const size_t q_bytes = sizeof(bf16) * nw * kRows * (dp + kPad);
    const int qblocks = (rt + nw - 1) / nw;
    // more CTAs than SMs: keep two CTAs' shared memory within one SM
    const long long ctas = (long long)qblocks * p->splits * bh;
    size_t budget = ctas > num_sms() ? psg::kSmemLimit / 2 - 1024 : psg::kSmemLimit;
    if (q_bytes + tile_bytes > budget) budget = psg::kSmemLimit;
    if (q_bytes + tile_bytes > budget) continue;
    int stages = (int)((budget - q_bytes) / tile_bytes);
    stages = stages < kMaxStages ? stages : kMaxStages;
    p->nw = nw;
    p->qblocks = qblocks;
    p->stages = stages < ntiles ? stages : ntiles;
    p->smem = q_bytes + p->stages * tile_bytes;
    return true;
  }
  return false;
}

// Wait until at most n cp.async groups are pending (n < kMaxStages).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: psg::cp_async_wait<0>(); break;
    case 1: psg::cp_async_wait<1>(); break;
    case 2: psg::cp_async_wait<2>(); break;
    default: psg::cp_async_wait<3>(); break;
  }
}

// rows [0, nrows) x columns [0, ncols) of a shared-memory tile with row
// stride ld, from src + (row0 + r) * sl + col0 + c; zero where
// row0 + r >= nvalid or col0 + c >= D.  ncols is a multiple of 16.  With
// `vec` (rows 16-byte aligned, D % 8 == 0) by cp.async, each thread
// stepping through (row, 16-byte chunk) pairs without a division; else
// element by element.
__device__ __forceinline__ void load_tile(bf16* dst, int ld, int nrows, int ncols,
                                          const bf16* src, long long sl, int row0,
                                          int nvalid, int col0, int D, bool vec) {
  if (vec) {
    const int cpr = ncols / 8;  // chunks per row, < blockDim
    const int dr = blockDim.x / cpr, dc = blockDim.x - dr * cpr;
    int r = threadIdx.x / cpr, c = threadIdx.x - r * cpr;
    while (r < nrows) {
      const int col = c * 8;
      const bool ok = row0 + r < nvalid && col0 + col < D;
      psg::cp_async16(dst + r * ld + col, ok ? src + (row0 + r) * sl + col0 + col : src,
                      ok);
      r += dr;
      c += dc;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
  } else {
    for (int i = threadIdx.x; i < nrows * ncols; i += blockDim.x) {
      const int r = i / ncols, c = i % ncols;
      const bool ok = row0 + r < nvalid && col0 + c < D;
      dst[r * ld + c] = ok ? src[(row0 + r) * sl + col0 + c] : __float2bfloat16(0.f);
    }
  }
}

// grid (qblocks, splits, B*H); block max(nw, kMinWarps) warps, all of
// which load.  Warp w < nw owns query rows q0 + 16w .. +15 and output
// columns c0 .. c0 + DC - 1; warps past nw (Lq < 64) only load.
template <int DC>
__global__ void __launch_bounds__(kMaxWarps * 32)
flash_bf16(const Args a, int nw, int stages, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D, Lq = a.Lq, Lk = a.Lk;
  const int dp = (D + 15) / 16 * 16, ldq = dp + kPad, ldv = DC + kPad;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.z / a.H, h = blockIdx.z % a.H;
  const int q0 = blockIdx.x * nw * kRows, c0 = blockIdx.y * DC;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [nw*16][ldq]
  bf16* Ks = Qs + nw * kRows * ldq;             // [stages][kBK][ldq]
  bf16* Vs = Ks + stages * kBK * ldq;           // [stages][kBK][ldv]
  float* Bs = reinterpret_cast<float*>(Vs + stages * kBK * ldv);  // [stages][kBK]
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* biasb = a.key_bias ? a.key_bias + (size_t)b * Lk : nullptr;
  const int ntiles = (Lk + kBK - 1) / kBK;

  auto load_kv = [&](int t) {
    const int s = t % stages;
    load_tile(Ks + s * kBK * ldq, ldq, kBK, dp, kg, a.sk.l, t * kBK, Lk, 0, D, vec);
    load_tile(Vs + s * kBK * ldv, ldv, kBK, DC, vg, a.sv.l, t * kBK, Lk, c0, D, vec);
    if (biasb && threadIdx.x < kBK) {  // keys past Lk are masked by index
      const int key = t * kBK + threadIdx.x;
      psg::cp_async4(Bs + s * kBK + threadIdx.x, key < Lk ? biasb + key : biasb, key < Lk);
    }
  };
  // group t holds tile t (and Q, with tile 0)
  load_tile(Qs, ldq, nw * kRows, dp, qg, a.sq.l, q0, Lq, 0, D, vec);
  for (int t = 0; t < stages; ++t) {
    load_kv(t);
    psg::cp_async_commit();
  }

  const int row0 = q0 + warp * kRows;
  const bool active = warp < nw && row0 < Lq;
  const int g = lane >> 2, tq = lane & 3;          // mma fragment coordinates
  const int lrow = lane & 7, lmat = lane >> 3;     // ldmatrix: row and matrix
  // A (Q): matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15), row-major
  const uint32_t qaddr =
      psg::smem_addr(Qs + (warp * kRows + lrow + (lmat & 1) * 8) * ldq + (lmat >> 1) * 8);

  float oacc[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_upto(stages - 1);  // groups committed: stages + t
    __syncthreads();
    const int s = t % stages, k0 = t * kBK;
    const int nk = Lk - k0 < kBK ? Lk - k0 : kBK;  // keys of this tile below Lk
    if (active) {
      const bf16* Kt = Ks + s * kBK * ldq;
      const bf16* Vt = Vs + s * kBK * ldv;
      // B (K^T): matrices (keys 0-7 | 8-15) x (d 0-7 | 8-15) of each 16-key pair
      const uint32_t kaddr =
          psg::smem_addr(Kt + (lrow + (lmat >> 1) * 8) * ldq + (lmat & 1) * 8);
      // B (V): transposed matrices (keys 0-7 | 8-15) x (cols 0-7 | 8-15)
      const uint32_t vaddr =
          psg::smem_addr(Vt + (lrow + (lmat & 1) * 8) * ldv + (lmat >> 1) * 8);

      float sacc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
      for (int kk = 0; kk < dp; kk += 16) {
        uint32_t af[4];
        ldmatrix_x4(af, qaddr + kk * 2);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp * 16 < nk) {
            uint32_t bfr[4];
            ldmatrix_x4(bfr, kaddr + (jp * 16 * ldq + kk) * 2);
            mma(sacc[2 * jp], af, bfr[0], bfr[1]);
            mma(sacc[2 * jp + 1], af, bfr[2], bfr[3]);
          }
        }
      }

      // scale, bias, mask; thread holds rows g (e < 2) and g + 8 (e >= 2)
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
      const float* Bt = Bs + s * kBK;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = j * 8 + 2 * tq;  // this thread's two keys in the tile
        const float2 bias =
            biasb ? *reinterpret_cast<const float2*>(Bt + kj) : make_float2(0.f, 0.f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sv = k0 + kj + (e & 1) < Lk
                               ? sacc[j][e] * a.scale + ((e & 1) ? bias.y : bias.x)
                               : -CUDART_INF_F;
          sacc[j][e] = sv;
          mx[e >> 1] = fmaxf(mx[e >> 1], sv);
        }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);  // finite: the tile holds a key < Lk
        alpha[r] = __expf(m_run[r] - m_new);         // 0 on the first tile
        m_run[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(sacc[j][e] - m_run[e >> 1]);
          sacc[j][e] = p;
          rs[e >> 1] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
      for (int n = 0; n < DC / 8; ++n) {
        oacc[n][0] *= alpha[0];
        oacc[n][1] *= alpha[0];
        oacc[n][2] *= alpha[1];
        oacc[n][3] *= alpha[1];
      }

      // O += P V, P rounded to bf16: the score accumulators of key tiles
      // 2jj and 2jj+1 are the A fragment of the 16-key step jj
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj * 16 < nk) {
          uint32_t pf[4];
          pf[0] = pack_bf16(sacc[2 * jj][0], sacc[2 * jj][1]);
          pf[1] = pack_bf16(sacc[2 * jj][2], sacc[2 * jj][3]);
          pf[2] = pack_bf16(sacc[2 * jj + 1][0], sacc[2 * jj + 1][1]);
          pf[3] = pack_bf16(sacc[2 * jj + 1][2], sacc[2 * jj + 1][3]);
#pragma unroll
          for (int cp = 0; cp < DC / 16; ++cp) {
            uint32_t vf[4];
            ldmatrix_x4_trans(vf, vaddr + (jj * 16 * ldv + cp * 16) * 2);
            mma(oacc[2 * cp], pf, vf[0], vf[1]);
            mma(oacc[2 * cp + 1], pf, vf[2], vf[3]);
          }
        }
      }
    }
    if (t + stages < ntiles) {
      __syncthreads();  // every warp is done with stage s
      load_kv(t + stages);
    }
    psg::cp_async_commit();
  }

  if (!active) return;
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_run[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* og = static_cast<bf16*>(a.o) + b * a.so.b + h * a.so.h;
  const bool pairs = (D & 1) == 0;  // o's rows are then 4-byte aligned
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
    const int col = c0 + n * 8 + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= Lq || col >= D) continue;
      const float v0 = oacc[n][2 * r] / l[r], v1 = oacc[n][2 * r + 1] / l[r];
      bf16* p = og + row * a.so.l + col;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
      } else {
        p[0] = __float2bfloat16(v0);
        if (col + 1 < D) p[1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int DC>
cudaError_t launch_dc(const Args& a, const Plan& p, int B, int vec, cudaStream_t stream) {
  cudaError_t err = psg::allow_smem(flash_bf16<DC>, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.qblocks, p.splits, B * a.H);
  const int threads = 32 * (p.nw > kMinWarps ? p.nw : kMinWarps);
  flash_bf16<DC><<<grid, threads, p.smem, stream>>>(a, p.nw, p.stages, vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  Plan p;
  if (!make_plan(B, a.H, a.Lq, a.Lk, a.D, &p)) return cudaErrorInvalidValue;
  bool vec = a.D % 8 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v);
  const Strides operands[3] = {a.sq, a.sk, a.sv};
  for (const Strides& s : operands) vec = vec && s.b % 8 == 0 && s.h % 8 == 0 && s.l % 8 == 0;
  switch (p.dc) {
    case 80: return launch_dc<80>(a, p, B, vec, stream);
    case 64: return launch_dc<64>(a, p, B, vec, stream);
    case 32: return launch_dc<32>(a, p, B, vec, stream);
    default: return launch_dc<16>(a, p, B, vec, stream);
  }
}

}  // namespace tc

}  // namespace

// Shared memory one launch needs, or 0 if the kernel does not take this
// shape (bf16: D > 320).
extern "C" size_t psg_flash_attention_smem_bytes(int B, int H, int Lq, int Lk, int D,
                                                 int dtype) {
  if (dtype == psg::kFloat32) return f32::smem_bytes(D);
  tc::Plan p;
  return tc::make_plan(B, H, Lq, Lk, D, &p) ? p.smem : 0;
}

// strides: 12 element strides, (batch, head, row) of q, k, v and o.
extern "C" int psg_flash_attention(const void* q, const void* k, const void* v,
                                   const float* key_bias, void* o,
                                   const long long* strides, int B, int H, int Lq, int Lk,
                                   int D, float scale, int dtype, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.key_bias = key_bias;
  a.o = o;
  Strides* s[4] = {&a.sq, &a.sk, &a.sv, &a.so};
  for (int i = 0; i < 4; ++i) *s[i] = Strides{strides[3 * i], strides[3 * i + 1],
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
