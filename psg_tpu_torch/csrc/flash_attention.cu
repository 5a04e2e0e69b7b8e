// Attention forward: o = softmax(q k^T * scale + key_bias) v, and, when
// asked, each row's logsumexp for the backward (flash_attention_bwd.cu).
//
// Replaces the TPU kernel psg_tpu/ops/flash_attention.py::flash_sdpa
// (_flash_impl at :61, pallas_call at :92, body _attn_kernel at :34).
//
// Shapes on the model's path: q [B,H,Lq,D], k/v [B,H,Lk,D] with D in
// {4..16, 32, 40, 64, 80, 160, 320} and Lk up to 729 (the SD-1.5 UNet's
// 27^2 self-attention); key_bias [B, Lk] fp32 (the [B,1,1,Lk] additive
// mask) or null.  q, k, v and o are strided: each is addressed by its
// batch, head and row strides in elements, and its last dimension is
// contiguous, so q/k/v can be head views of a projection and o is written
// in [B, Lq, H, D] memory order, with no copies around the call.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): 4 Lq Lk D operations
// against the bytes of q, k, v and o.  SD 27^2 self-attention (B32 H8,
// Lk 729, hd 40) is 2.2e10 operations, 0.022 ms, over its 0.018 ms of
// bytes, and its 1.4e8 exponentials take about 0.04 ms of the
// special-function units; the serving UNet's 14^2 hd-160 case (B8 H4) is
// 0.0024 ms of operations; the 7^2 and 4^2 hd-320 cases are bound by
// their bytes.
//
// bf16 (the model's path): Hopper warpgroup products.
// - A consumer warpgroup owns 64 query rows; a CTA holds one or two.  Both
//   products run on wgmma: S = Q K^T (m64n64k16, Q and K from shared
//   memory) and O += P V (m64nDCk16, P from registers, the S accumulator
//   rounded to bf16 in place, V from shared memory read transposed).
//   Scores, softmax, row sums and the accumulator are fp32; P is rounded
//   to bf16 for the second product (as the reference does,
//   flash_attention.py:47); O is divided by the row sum at the end.
// - Head dims: operands sit in shared memory in wgmma's no-swizzle layout,
//   8-column chunks of 64 rows x 16 bytes, so any D that is a multiple of 8
//   needs no swizzle mode (80-byte rows of hd 40 fit none).  A D that is
//   not a multiple of 16 is zero-filled there (40 -> 48); device memory is
//   never padded.
// - Copies: where rows are 16-byte aligned (D % 8 == 0, strides multiples
//   of 8), K/V tiles come by TMA into a ring of 2 stages, one mbarrier a
//   stage, under the online softmax, so any Lk streams through it (4
//   stages measured slower at the SD shapes on the H100).  Each box is one
//   8-column chunk of 64 rows of a 4-D tensor map whose inner extent is the
//   true D, so no box reads past D into the next head; rows past Lk are
//   zero-filled by the hardware; chunks wholly past D are zeroed once.
//   Other operands (D % 8 != 0, the tiny configs) take element loads, one
//   tile at a time.
// - No product sits in a branch (ptxas serializes wgmma there): every
//   warpgroup computes, rows past Lq included, and every tile takes all
//   four 16-key steps of P V (P is 0 past Lk, and so are V's rows).  A
//   warpgroup waits for each product before its softmax; issuing S for
//   the next tile first (two score accumulators) measured slower on the
//   H100, so the overlap is left to the warpgroups of the SM.
// - The three faults of the Ampere-era design at long keys: S is computed
//   once for each (query tile, key tile) pair wherever D <= 160, since the
//   output width DC is the whole padded D there (the mma.sync design split
//   hd 40 into two column blocks and recomputed all of S for each); the
//   ring streams any number of key tiles instead of holding K/V whole; and
//   the row logsumexp is written for the backward.
// - A column split remains only for D > 160, which on the model's path is
//   the psg UNet's hd-320 sites at 7^2 and 4^2 with Lk <= 128: a 64 x 320
//   fp32 accumulator (160 registers a thread) does not fit beside S, so
//   each of two CTAs owns 160 output columns and computes S for itself.
// - The logsumexp: lse = (m - c) + log(l) for row max m and row sum l,
//   where c is the sample's largest key bias (0 without a bias).  Taken
//   relative to c it stays exact where every key of a sample is masked at
//   -1e9: there the scores are -1e9 (qk * scale is absorbed), a plain
//   m + log(l) would round log(l) away, and exp(s - lse) would lose the
//   1/l of the softmax.  The backward rebuilds P = exp((s - c) - lse).
// - s = qk * scale, then + bias, each rounded in fp32 (no fused
//   multiply-add), as the plain version and the backward compute it.
//
// fp32 (parity runs and BERT/CLIP under bf16 training, whose projections
// return fp32): a CUDA-core body under the same strided contract.  Asked
// for the logsumexp, an instance of it writes lse and rounds s as above;
// the instance for calls that take no gradient lets the compiler fuse
// qk * scale + bias (measured 1-3.5% faster on the H100).  fp32 on tensor cores would be TF32 and miss the
// fp32 tolerance.
#include "common.cuh"
#include "wgmma.cuh"

#include <cuda.h>
#include <math_constants.h>

#include <cstring>
#include <initializer_list>

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
  float* lse;             // [B, H, Lq] or null
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

// kLse: write each row's logsumexp, and round s = qk * scale, then + bias,
// each in fp32 as the backward recomputes it; without it the compiler may
// fuse the two.
template <bool kLse>
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
  float bias_max = 0.f;
  if constexpr (kLse) {
    __shared__ float red[kThreads / 32];
    bias_max = psg::block_max_bias(biasb, Lk, red);
  }

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
      for (int i = 0; i < kBQ / 4; ++i) {
        float s;
        if constexpr (kLse)
          s = __fadd_rn(__fmul_rn(acc[i], a.scale), bias);
        else
          s = acc[i] * a.scale + bias;
        Ss[(sr0 + 4 * i) * (kBK + 1) + sj] = ok ? s : -CUDART_INF_F;
      }
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
  if constexpr (kLse)
    if (tid < kBQ && q0 + tid < Lq)
      a.lse[((size_t)b * a.H + h) * Lq + q0 + tid] =
          (m_run[tid] - bias_max) + logf(l_run[tid]);
}

template <bool kLse>
cudaError_t launch_body(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.D);
  cudaError_t err = psg::allow_smem(flash_f32<kLse>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kBQ - 1) / kBQ, B * a.H);
  flash_f32<kLse><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  return a.lse ? launch_body<true>(a, B, stream) : launch_body<false>(a, B, stream);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: warpgroup products (wgmma), TMA ring
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBM = 64;         // query rows a warpgroup
constexpr int kBN = 64;         // keys a tile
constexpr int kMaxWG = 2;       // consumer warpgroups a CTA
constexpr int kMaxStages = 2;   // K/V tiles in flight (more measured no faster)
constexpr int kMaxDC = 160;     // output columns a CTA
constexpr int kChunk = kBN * 8; // bf16 elements of one 8-column chunk of a 64-row tile

struct Plan {
  int dc, splits, nwg, qblocks, stages;
  size_t smem;
};

// The depth S = Q K^T is computed over: D rounded up to 16, or 320 where
// the output columns are split (D > 160), so that it is a compile-time
// constant of each kernel.
inline int padded_depth(int D) { return D > kMaxDC ? 2 * kMaxDC : (D + 15) / 16 * 16; }

// Shared memory: Q [dp/8][rows][8], K ring [stages][dp/8][64][8], V ring
// [stages][dc/8][64][8], the sample's key-bias row, the mbarriers, and 128
// bytes to align the base.
size_t smem_for(int dp, int dc, int nwg, int stages, int ntiles, bool bias) {
  return 128 + sizeof(bf16) * ((size_t)dp * nwg * kBM + (size_t)stages * (dp + dc) * kBN) +
         (bias ? sizeof(float) * ntiles * kBN : 0) + sizeof(uint64_t) * (kMaxStages + 1);
}

// The launch shape for one call, from its sizes only; false if it does not
// fit (D > 320, or a key-bias row too long for shared memory).
bool make_plan(int B, int H, int Lq, int Lk, int D, bool bias, bool tma, Plan* p) {
  if (D > 2 * kMaxDC) return false;
  const int dp = padded_depth(D);
  p->splits = dp / kMaxDC > 1 ? dp / kMaxDC : 1;
  p->dc = p->splits == 1 ? dp : kMaxDC;
  const int rt = (Lq + kBM - 1) / kBM;
  const int ntiles = (Lk + kBN - 1) / kBN;
  const long long bh = (long long)B * H;
  // two warpgroups a CTA where that still gives every SM two CTAs
  p->nwg = (rt >= 2 && (long long)((rt + 1) / 2) * p->splits * bh >= 2LL * psg::num_sms())
               ? kMaxWG : 1;
  p->qblocks = (rt + p->nwg - 1) / p->nwg;
  const int want = !tma ? 1 : (ntiles < kMaxStages ? ntiles : kMaxStages);
  // the most stages that leave room for two CTAs an SM, else for one
  for (size_t budget : {psg::kSmemLimit / 2 - 1024, psg::kSmemLimit}) {
    for (int st = want; st >= 1; --st) {
      const size_t smem = smem_for(dp, p->dc, p->nwg, st, ntiles, bias);
      if (smem <= budget && (st >= 2 || want == 1 || budget == psg::kSmemLimit)) {
        p->stages = st;
        p->smem = smem;
        return true;
      }
    }
  }
  return false;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Writes of the generic proxy (st.shared) made visible to the async proxy
// (wgmma's and TMA's reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One box of a 4-D tensor map (D, L, H, B) into shared memory, completing
// on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Element loads of rows [row0, row0 + nrows) x columns [col0, col0 +
// 8 nchunks) of a strided operand into the chunked layout [chunk][row][8],
// zero past `nvalid` rows and past column D.
__device__ __forceinline__ void load_chunked(bf16* dst, int nrows, int nchunks,
                                             const bf16* src, long long sl, int row0,
                                             int nvalid, int col0, int D) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < nrows * nchunks * 8; i += blockDim.x) {
    const int c = i / (nrows * 8), r = (i / 8) % nrows, col = col0 + c * 8 + i % 8;
    dst[i] = (row0 + r < nvalid && col < D) ? src[(long long)(row0 + r) * sl + col] : zero;
  }
}

// grid (qblocks, splits, B*H); block nwg warpgroups.  Warpgroup w owns query
// rows q0 + 64w .. + 63 and output columns c0 .. c0 + DC - 1; S is computed
// over 16 NK columns (padded_depth).  Every warpgroup issues every product,
// rows past Lq included, so no wgmma sits in a branch (ptxas would
// serialize them).
template <int DC, int NK>
__global__ void __launch_bounds__(kMaxWG * 128, DC <= 80 ? 2 : 1)
flash_bf16_wgmma(const Args a, const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                 int nwg, int stages, int tma) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[kMaxWG * 4];
  const int D = a.D, Lq = a.Lq, Lk = a.Lk;
  constexpr int dp = NK * 16, nck = dp / 8, ncv = DC / 8;
  const int rows = nwg * kBM, ntiles = (Lk + kBN - 1) / kBN;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z / a.H, h = blockIdx.z % a.H;
  const int q0 = blockIdx.x * rows, c0 = blockIdx.y * DC;
  const float* biasb = a.key_bias ? a.key_bias + (size_t)b * Lk : nullptr;

  bf16* Qs = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 127) &
                                     ~uintptr_t(127));
  bf16* Ks = Qs + nck * rows * 8;
  bf16* Vs = Ks + stages * nck * kChunk;
  float* Bs = reinterpret_cast<float*>(Vs + stages * ncv * kChunk);
  uint64_t* bars = reinterpret_cast<uint64_t*>(Bs + (biasb ? ntiles * kBN : 0));
  const uint32_t qbar = psg::smem_addr(bars + kMaxStages);

  // chunks holding a column below D: the only ones TMA fills
  const int kvalid = (D + 7) / 8 < nck ? (D + 7) / 8 : nck;
  const int vcols = D - c0 < DC ? D - c0 : DC;
  const int vvalid = (vcols + 7) / 8;
  int qwgs = 0;  // warpgroups with a query row below Lq
  for (int w = 0; w < nwg; ++w) qwgs += q0 + w * kBM < Lq;

  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h;
  auto issue_kv = [&](int t) {  // one thread, TMA path
    const int s = t % stages;
    const uint32_t bar = psg::smem_addr(bars + s);
    mbar_expect_tx(bar, (kvalid + vvalid) * kChunk * sizeof(bf16));
    for (int c = 0; c < kvalid; ++c)
      tma_load(psg::smem_addr(Ks + (s * nck + c) * kChunk), &mk, 8 * c, t * kBN, h, b, bar);
    for (int c = 0; c < vvalid; ++c)
      tma_load(psg::smem_addr(Vs + (s * ncv + c) * kChunk), &mv, c0 + 8 * c, t * kBN, h, b,
               bar);
  };

  if (biasb)
    for (int j = tid; j < ntiles * kBN; j += blockDim.x) Bs[j] = j < Lk ? biasb[j] : 0.f;
  if (tma) {
    const bf16 zero = __float2bfloat16(0.f);
    // chunks wholly past D: zero once, never loaded
    for (int i = tid; i < (nck - kvalid) * rows * 8; i += blockDim.x)
      Qs[kvalid * rows * 8 + i] = zero;
    for (int s = 0; s < stages; ++s) {
      for (int i = tid; i < (nck - kvalid) * kChunk; i += blockDim.x)
        Ks[(s * nck + kvalid) * kChunk + i] = zero;
      for (int i = tid; i < (ncv - vvalid) * kChunk; i += blockDim.x)
        Vs[(s * ncv + vvalid) * kChunk + i] = zero;
    }
    fence_proxy_async();
    if (tid == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(psg::smem_addr(bars + s), 1);
      mbar_init(qbar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  const float bias_max = a.lse ? psg::block_max_bias(biasb ? Bs : nullptr, Lk, red) : 0.f;
  __syncthreads();
  if (tma && tid == 0) {
    mbar_expect_tx(qbar, qwgs * kvalid * kChunk * sizeof(bf16));
    for (int w = 0; w < qwgs; ++w)
      for (int c = 0; c < kvalid; ++c)
        tma_load(psg::smem_addr(Qs + (c * rows + w * kBM) * 8), &mq, 8 * c, q0 + w * kBM, h,
                 b, qbar);
    for (int t = 0; t < stages && t < ntiles; ++t) issue_kv(t);
  }

  const int row0 = q0 + wg * kBM;
  const bool active = row0 < Lq;
  // descriptors: Q's K-direction chunks are rows * 16 bytes apart, K's and
  // V's 1024; 8-row groups 128 bytes apart (V: 8-key groups 128, 8-column
  // chunks 1024)
  const uint32_t q_base = psg::smem_addr(Qs + wg * kBM * 8);
  const uint32_t q_lbo = rows * 16;

  float sacc[32], oacc[DC / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) oacc[i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int s = tma ? t % stages : 0, k0 = t * kBN;
    if (tma) {
      if (t == 0) mbar_wait(qbar, 0);
      mbar_wait(psg::smem_addr(bars + s), (t / stages) & 1);
    } else {
      __syncthreads();  // the previous tile is consumed
      if (t == 0)
        load_chunked(Qs, rows, nck, static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h,
                     a.sq.l, q0, Lq, 0, D);
      load_chunked(Ks, kBN, nck, kg, a.sk.l, k0, Lk, 0, D);
      load_chunked(Vs, kBN, ncv, vg, a.sv.l, k0, Lk, c0, D);
      fence_proxy_async();
      __syncthreads();
    }
    const int nk = Lk - k0 < kBN ? Lk - k0 : kBN;  // keys of this tile below Lk
    const uint32_t k_base = psg::smem_addr(Ks + s * nck * kChunk);
    const uint32_t v_base = psg::smem_addr(Vs + s * ncv * kChunk);
    psg::wgmma_fence_regs(sacc);
    psg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      psg::wgmma_ss_m64n64(sacc, psg::wgmma_desc(q_base + 2 * kk * q_lbo, q_lbo, 128),
                           psg::wgmma_desc(k_base + 2 * kk * 1024, 1024, 128), kk > 0);
    psg::wgmma_commit();
    psg::wgmma_wait<0>();
    psg::wgmma_fence_regs(sacc);

    // scale, bias; sacc[4j + e] is row g + 8 (e >> 1) of this warp's 16,
    // key 8j + 2tq + (e & 1) of the tile
    if (biasb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bias = *reinterpret_cast<const float2*>(Bs + k0 + j * 8 + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[4 * j + e] = __fadd_rn(__fmul_rn(sacc[4 * j + e], a.scale),
                                      (e & 1) ? bias.y : bias.x);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = __fmul_rn(sacc[i], a.scale);
    }
    if (nk < kBN) {  // the last tile: keys past Lk
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if ((i >> 2) * 8 + 2 * tq + (i & 1) >= nk) sacc[i] = -CUDART_INF_F;
    }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
    // exp(x - m) as 2^((x - m) log2 e) on the SFU.  The difference comes
    // first: folding m into an FFMA (x log2 e - m log2 e) loses x - m where
    // the scores are near -1e9 (a sample whose keys are all masked)
    constexpr float kLog2e = 1.4426950408889634f;
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);  // finite: the tile holds a key < Lk
      alpha[r] = psg::ex2((m_run[r] - m_new) * kLog2e);  // 0 on the first tile
      m_run[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = psg::ex2((sacc[i] - m_run[(i >> 1) & 1]) * kLog2e);
      sacc[i] = p;
      rs[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];

    // O += P V, P rounded to bf16: the score accumulators of key blocks
    // 2jj and 2jj + 1 are the A fragment of the 16-key step jj (P is 0
    // past Lk, and so are V's rows there)
    uint32_t pf[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      pf[jj][0] = psg::pack_bf16(sacc[8 * jj + 0], sacc[8 * jj + 1]);
      pf[jj][1] = psg::pack_bf16(sacc[8 * jj + 2], sacc[8 * jj + 3]);
      pf[jj][2] = psg::pack_bf16(sacc[8 * jj + 4], sacc[8 * jj + 5]);
      pf[jj][3] = psg::pack_bf16(sacc[8 * jj + 6], sacc[8 * jj + 7]);
    }
    psg::wgmma_fence_regs(oacc);
    psg::wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      psg::wgmma_rs_tb<DC>(oacc, pf[jj], psg::wgmma_desc(v_base + jj * 256, 128, 1024), 1);
    psg::wgmma_commit();
    psg::wgmma_wait<0>();
    psg::wgmma_fence_regs(oacc);
    if (tma) {
      __syncthreads();  // every warpgroup is done with stage s
      if (tid == 0 && t + stages < ntiles) issue_kv(t + stages);
    }
  }

  if (!active) return;
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_run[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const int wrow = row0 + warp * 16 + g;  // rows wrow and wrow + 8
  if (a.lse && blockIdx.y == 0 && tq == 0) {
    float* lse = a.lse + ((size_t)b * a.H + h) * Lq;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (wrow + 8 * r < Lq) lse[wrow + 8 * r] = (m_run[r] - bias_max) + logf(l[r]);
  }
  bf16* og = static_cast<bf16*>(a.o) + b * a.so.b + h * a.so.h;
  const bool pairs = (D & 1) == 0;  // o's rows are then 4-byte aligned
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
    const int col = c0 + j * 8 + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + 8 * r;
      if (row >= Lq || col >= D) continue;
      const float v0 = oacc[4 * j + 2 * r] * inv[r], v1 = oacc[4 * j + 2 * r + 1] * inv[r];
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (D, L, H, B) map of one operand with 8-column x 64-row boxes; extents
// past D or L read as zero.  Size-1 dimensions get a 16-byte stride (never
// stepped).
bool make_map(CUtensorMap* map, const void* base, const Strides& s, int B, int H, int L,
              int D) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const long long st[3] = {s.l, s.h, s.b};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = dims[i + 1] == 1 ? 16 : (cuuint64_t)st[i] * sizeof(bf16);
  const cuuint32_t box[4] = {8, kBN, 1, 1}, elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// TMA takes an operand whose rows are 16-byte aligned: D % 8 == 0 and every
// stride of a dimension longer than 1 a multiple of 8 elements.
bool tma_ok(const Args& a, int B) {
  if (a.D % 8 != 0 || !aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v)) return false;
  const Strides ops[3] = {a.sq, a.sk, a.sv};
  const int len[3] = {a.Lq, a.Lk, a.Lk};
  for (int i = 0; i < 3; ++i) {
    if (len[i] > 1 && ops[i].l % 8) return false;
    if (a.H > 1 && ops[i].h % 8) return false;
    if (B > 1 && ops[i].b % 8) return false;
  }
  return true;
}

template <int DC, int NK = DC / 16>
cudaError_t launch_dc(const Args& a, const Plan& p, int B, bool tma, cudaStream_t stream) {
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  if (tma && !(make_map(&maps[0], a.q, a.sq, B, a.H, a.Lq, a.D) &&
               make_map(&maps[1], a.k, a.sk, B, a.H, a.Lk, a.D) &&
               make_map(&maps[2], a.v, a.sv, B, a.H, a.Lk, a.D)))
    return cudaErrorInvalidValue;
  cudaError_t err = psg::allow_smem(flash_bf16_wgmma<DC, NK>, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.qblocks, p.splits, B * a.H);
  flash_bf16_wgmma<DC, NK><<<grid, p.nwg * 128, p.smem, stream>>>(a, maps[0], maps[1], maps[2],
                                                                  p.nwg, p.stages, tma);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const bool tma = tma_ok(a, B);
  Plan p;
  if (!make_plan(B, a.H, a.Lq, a.Lk, a.D, a.key_bias != nullptr, tma, &p))
    return cudaErrorInvalidValue;
  switch (p.dc) {
    case 16: return launch_dc<16>(a, p, B, tma, stream);
    case 32: return launch_dc<32>(a, p, B, tma, stream);
    case 48: return launch_dc<48>(a, p, B, tma, stream);
    case 64: return launch_dc<64>(a, p, B, tma, stream);
    case 80: return launch_dc<80>(a, p, B, tma, stream);
    case 96: return launch_dc<96>(a, p, B, tma, stream);
    case 112: return launch_dc<112>(a, p, B, tma, stream);
    case 128: return launch_dc<128>(a, p, B, tma, stream);
    case 144: return launch_dc<144>(a, p, B, tma, stream);
    default:  // 160 columns of a depth of 160, or of 320 (split)
      return p.splits == 1 ? launch_dc<160>(a, p, B, tma, stream)
                           : launch_dc<160, 2 * kMaxDC / 16>(a, p, B, tma, stream);
  }
}

}  // namespace tc

}  // namespace

// Shared memory one launch needs (with TMA and a key bias), or 0 if the
// kernel does not take this shape (bf16: D > 320, or a key-bias row too
// long).
extern "C" size_t psg_flash_attention_smem_bytes(int B, int H, int Lq, int Lk, int D,
                                                 int dtype) {
  if (dtype == psg::kFloat32) return f32::smem_bytes(D);
  tc::Plan p;
  return tc::make_plan(B, H, Lq, Lk, D, true, true, &p) ? p.smem : 0;
}

// strides: 12 element strides, (batch, head, row) of q, k, v and o.  lse:
// [B, H, Lq] fp32 or null.
extern "C" int psg_flash_attention(const void* q, const void* k, const void* v,
                                   const float* key_bias, void* o, float* lse,
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
  a.lse = lse;
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
