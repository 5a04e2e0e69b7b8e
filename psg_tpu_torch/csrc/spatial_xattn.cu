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
// (C = 64) or 215^2 (C = 32), 8 heads of dim hd = C/8, S <= 256 text keys.
// K and V are the text projections [B, S, C] fp32; head h, key j, dim d is
// read at j*C + h*hd + d, or under compat_reshape (the reference's raw
// [B,S,C] -> [B,H,hd,S] reshape) at (h*hd + d)*S + j.  key_bias [B, S] fp32
// or null; Wq/Wp [C, C] ([in, out], any strides) in xn's dtype; bq/bp [C]
// fp32.  xn, residual and out are bf16 (the model's path) or fp32.
//
// Bound on the H100.  Per pixel the block moves 3C activation elements and
// does 2C^2 + 2 hd S' multiply-adds a head and 8 S' exponentials, S' the
// keys whose probability is not exactly 0.  With every key live (S' = 128)
// the exponentials rule: 16 a clock an SM on the special-function unit is
// 4.2e12/s.  With the serving path's prompts (S' = 9-17) the bytes rule.
//
// bf16 (the model's path): tensor cores.
// - One warp owns 16 pixel rows at a time.  A CTA's 8 warps (12 at C = 64;
//   fewer where S leaves less shared memory beside K and V) walk the row
//   tiles of one sample, and the grid is one wave of CTAs split evenly over
//   the samples.
//   Each warp keeps its next tiles of xn and the residual in flight in a
//   ring of shared memory (cp.async, 16 bytes a lane, rows past L
//   zero-filled), so the copies run under the previous tile's products.
// - All four products are mma.sync with fp32 accumulation: q = xn Wq and
//   out = o Wp as m16n8k16 (C = 8 zero-padded to 16 in shared memory), the
//   scores as m16n8k8 against K, P V as m16n8k16.  A head's scores take the
//   n8 block of q that holds its hd columns, the other heads' columns masked
//   to zero in the A fragment; P V runs against the same block of V and
//   keeps only the head's columns.  So hd 1-8 needs no padded copy of K or V.
//   q * scale goes back into the staged xn tile as bf16, and each head's o
//   over its own q columns, which frees the registers of both.
// - Softmax over the whole row at once: a head's scores for 16 rows and up
//   to 128 keys (NS 16-key steps, 64 fp32 registers a thread at most) take
//   the max, the exponentials (ex2, log2(e) folded into the scores) and the
//   sum in one pass, with no running rescale.  NS is the fewest of 1, 2, 4
//   and 8 steps that holds the sample's live keys, and a pass takes 8 / NS
//   heads (4 at most) together, so a 13-key prompt runs a 16-key body four
//   heads abreast.  Past 128 live keys (S <= 256) a second pass merges with
//   one rescale.  The loop over head groups is not unrolled: eight copies of
//   the body overflowed the instruction cache.
// - Dead keys are skipped exactly.  Warp 0 compacts its sample's live keys
//   (bias > kDeadBias) into shared memory with warp ballots, and scores and
//   P V run over those only, padded to 16 with bias -inf (probability 0).  A
//   dead key's probability is exp(-1e9 - max) = 0.0 in fp32 whenever the
//   sample has a live key, so skipping it changes no sum.  A sample with no
//   live key keeps the reference's softmax over all S keys; where its logits
//   pass +-32, fp32 rounds -1e9 + s to steps of 64 in the reference and of
//   128 log2 units here, so such rows agree only as far as that rounding.
//   No host sync.
// - Rounding as the reference rounds (spatial_xattn.py:73-90): Wq and Wp are
//   bf16, and q * scale, P (normalised) and o are rounded to bf16 before
//   their products.  K and V stay fp32 in the reference, so here each is a
//   pair of bf16 values, hi + lo (16 mantissa bits), and every product with
//   them is two MMAs.
// - Measured on the H100 (PERF.md): the head phase is bound by its own
//   dependency chains at 4 warps a scheduler, not by the exponentials; each
//   CTA's set-up (the live keys, then K and V) costs two or three dependent
//   round trips to memory, on lines every CTA of a sample reads at once.
//
// fp32 (parity runs only): CUDA cores, one thread a pixel with a per-head
// online softmax.  fp32 on tensor cores would be TF32 and miss the
// fp32 tolerance.
#include "common.cuh"

#include <math_constants.h>

#include <type_traits>

namespace {

constexpr int kHeads = 8;
constexpr float kDeadBias = -1e8f;  // a key with bias <= this is masked

struct Args {
  const void* xn;
  const void* res;
  void* out;
  const float* k;
  const float* v;
  long long kss, ksc;     // element strides of key and channel in a sample's K / V
  const float* key_bias;  // [B, S] or null
  const void* wq;
  const void* wp;
  long long wq_i, wq_o, wp_i, wp_o;  // element strides of input and output channel
  const float* bq;
  const float* bp;
  int L, S;
  float scale;
};

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 128;

inline size_t smem_bytes(int C, int S) {
  return sizeof(float) * (2 * (size_t)C * C + 2 * (size_t)S * C + S);
}

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

// One thread a pixel, 128 pixels a block, grid (L / 128, B).  Each block
// loads Wq, Wp, the biases and its sample's K, V and key bias into shared
// memory once; C is a template parameter, so q, o and the per-head
// accumulators stay in registers.
template <int C>
__global__ void __launch_bounds__(kThreads) spatial_xattn_f32(const Args a) {
  constexpr int HD = C / kHeads;
  extern __shared__ __align__(16) float sm[];
  const int L = a.L, S = a.S;
  float* s_wq = sm;              // [C][C]
  float* s_wp = s_wq + C * C;    // [C][C]
  float* s_k = s_wp + C * C;     // [8][S][HD]
  float* s_v = s_k + S * C;      // [8][S][HD]
  float* s_bias = s_v + S * C;   // [S]

  const int b = blockIdx.y;
  const float* wq = static_cast<const float*>(a.wq);
  const float* wp = static_cast<const float*>(a.wp);
  for (int i = threadIdx.x; i < C * C; i += kThreads) {
    const int ci = i / C, co = i % C;
    s_wq[i] = wq[ci * a.wq_i + co * a.wq_o];
    s_wp[i] = wp[ci * a.wp_i + co * a.wp_o];
  }
  const float* kb = a.k + (size_t)b * S * C;
  const float* vb = a.v + (size_t)b * S * C;
  for (int i = threadIdx.x; i < S * C; i += kThreads) {
    const int h = i / (S * HD), j = (i / HD) % S, d = i % HD;
    const long long off = j * a.kss + (h * HD + d) * a.ksc;
    s_k[i] = kb[off];
    s_v[i] = vb[off];
  }
  for (int i = threadIdx.x; i < S; i += kThreads)
    s_bias[i] = a.key_bias ? a.key_bias[(size_t)b * S + i] : 0.f;
  __syncthreads();

  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= L) return;
  const size_t row = ((size_t)b * L + pix) * C;
  const float* xn = static_cast<const float*>(a.xn);
  const float* res = static_cast<const float*>(a.res);

  float q[C];
#pragma unroll
  for (int c = 0; c < C; ++c) q[c] = a.bq[c];
  for (int i = 0; i < C; ++i) axpy_smem(q, xn[row + i], s_wq + i * C);
#pragma unroll
  for (int c = 0; c < C; ++c) q[c] *= a.scale;

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
  for (int c = 0; c < C; ++c) y[c] = a.bp[c] + res[row + c];
#pragma unroll  // o[] stays in registers only under a constant index
  for (int i = 0; i < C; ++i) axpy_smem(y, o[i], s_wp + i * C);
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int c = 0; c < C; ++c) out[row + c] = y[c];
}

template <int C>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(C, a.S);
  cudaError_t err = psg::allow_smem(spatial_xattn_f32<C>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + kThreads - 1) / kThreads, B);
  spatial_xattn_f32<C><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 16;        // pixel rows of a tile: one m16 fragment
constexpr int kMaxKeys = 256;
constexpr int kMaxSteps = 8;     // 16-key steps a softmax pass holds in registers
constexpr float kLog2e = 1.4426950408889634f;

template <int C>
struct Shape {
  static constexpr int HD = C / kHeads;           // head dim: 1, 2, 4 or 8
  static constexpr int CP = C < 16 ? 16 : C;      // channels padded to the MMA depth
  static constexpr int LD = CP + 8;               // shared row stride in bf16: conflict-free ldmatrix
  static constexpr int NB = CP / 8;               // n8 column blocks of a row tile
  static constexpr int STAGES = C >= 64 ? 2 : 3;  // row tiles a warp has staged or in flight
  // warps a CTA at most, each on its own row tiles: as many as shared
  // memory holds beside K and V at S = 128 (C = 64), or two CTAs an SM
  // (C <= 32); the launch takes fewer where S leaves less room
  static constexpr int WARPS = C >= 64 ? 12 : 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MIN_CTAS = C <= 32 ? 2 : 1;
  static constexpr int TILE = kRows * LD;               // bf16 elements of a staged tile
  static constexpr int WARP_BUF = 2 * STAGES * TILE;     // xn and residual, each stage
};

// Shared memory of a CTA of `warps` warps.
template <int C>
size_t smem_bytes(int S, int warps) {
  using Sh = Shape<C>;
  const size_t nk = (S + 15) / 16 * 16;
  return sizeof(bf16) * (2 * Sh::CP * Sh::LD               // Wq^T, Wp^T
                         + 4 * nk * Sh::LD                 // K, V: hi, lo
                         + (size_t)warps * Sh::WARP_BUF)   // each warp's tiles
         + sizeof(float) * (nk + 2 * Sh::CP)               // key bias, bq, bp
         + sizeof(int) * (nk + 1);                         // live keys, count
}

// x as hi + lo, two bf16 values that carry its 16 leading mantissa bits.
__device__ __forceinline__ void split_bf16(float x, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16(x);
  *hi = h;
  *lo = __float2bfloat16(x - __bfloat162float(h));
}

// HU heads' attention output for a warp's 16 rows, over the live keys in
// passes of up to NS 16-key steps whose scores stay in registers.  The heads
// go through each phase together, so their chains interleave.  qa[u] is the
// A fragment of q * scale with only head u's columns kept; kv[u] is this
// lane's ldmatrix address of key 0 in the head's column block of K (V lies
// v_off bytes further); s_bias holds the live keys' bias in log2 units, -inf
// past them, so a padded key's probability is exactly 0.  oh[u] gets the
// accumulator of the head's n8 column block; only the head's own columns in
// it are meaningful.
template <int LD, int NS, int HU>
__device__ __forceinline__ void head_attention(float (&oh)[HU][4], const uint32_t (&qa)[HU][2],
                                               const uint32_t (&kv)[HU], uint32_t v_off,
                                               const float* s_bias, int nk, int tq) {
  constexpr int NACC = NS >= 4 ? 2 : 1;  // P.V accumulators a head: short MMA chains
  float m_run[HU][2] = {}, l_run[HU][2] = {};
  // more than one pass only with NS = kMaxSteps (the caller picks NS to hold nk)
  const int c_end = NS == kMaxSteps ? nk : 1;
  for (int c0 = 0; c0 < c_end; c0 += NS * 16) {
    const int steps = (nk - c0) / 16;  // 16-key steps of this pass, if fewer than NS
    // scores: element e of block j is row g + 8 (e >> 1), key c0 + 8 j + 2 tq + (e & 1)
    float sc[HU][2 * NS][4];
#pragma unroll
    for (int jp = 0; jp < NS; ++jp) {
      if (jp < steps) {
        const float* bias = s_bias + c0 + jp * 16 + 2 * tq;
        const float2 b0 = *reinterpret_cast<const float2*>(bias);
        const float2 b1 = *reinterpret_cast<const float2*>(bias + 8);
#pragma unroll
        for (int u = 0; u < HU; ++u) {
          uint32_t kf[4];  // K hi keys 0-7, hi 8-15, lo 0-7, lo 8-15
          psg::ldmatrix_x4(kf, kv[u] + (c0 + jp * 16) * LD * 2);
          float lo0[4] = {0.f, 0.f, 0.f, 0.f}, lo1[4] = {0.f, 0.f, 0.f, 0.f};
          psg::mma_k8(lo0, qa[u][0], qa[u][1], kf[2]);
          psg::mma_k8(lo1, qa[u][0], qa[u][1], kf[3]);
          psg::mma_k8(lo0, qa[u][0], qa[u][1], kf[0]);  // hi on top of lo
          psg::mma_k8(lo1, qa[u][0], qa[u][1], kf[1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // to log2 units with the bias
            sc[u][2 * jp][e] = fmaf(lo0[e], kLog2e, (e & 1) ? b0.y : b0.x);
            sc[u][2 * jp + 1][e] = fmaf(lo1[e], kLog2e, (e & 1) ? b1.y : b1.x);
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < HU; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[u][2 * jp][e] = sc[u][2 * jp + 1][e] = -CUDART_INF_F;
      }
    }
    // this pass's row max (rows g: e < 2, g + 8: e >= 2), finite: it holds a
    // live key; four partial maxima a row keep the chains short
    float m[HU][2];
#pragma unroll
    for (int u = 0; u < HU; ++u) {
      float mx[2][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) mx[0][k] = mx[1][k] = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 2 * NS; ++j) {
        mx[0][j % 4] = fmaxf(mx[0][j % 4], fmaxf(sc[u][j][0], sc[u][j][1]));
        mx[1][j % 4] = fmaxf(mx[1][j % 4], fmaxf(sc[u][j][2], sc[u][j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        m[u][r] = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x *= 2)
#pragma unroll
      for (int u = 0; u < HU; ++u)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          m[u][r] = fmaxf(m[u][r], __shfl_xor_sync(0xffffffffu, m[u][r], x));
    // exponentials and row sums (2^-inf = 0 for padded keys)
    float l[HU][2];
#pragma unroll
    for (int u = 0; u < HU; ++u) {
      float ls[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < 2 * NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[u][j][e] = psg::ex2(sc[u][j][e] - m[u][e >> 1]);
          ls[j & 1][e] += sc[u][j][e];
        }
      }
      l[u][0] = (ls[0][0] + ls[0][1]) + (ls[1][0] + ls[1][1]);
      l[u][1] = (ls[0][2] + ls[0][3]) + (ls[1][2] + ls[1][3]);
    }
#pragma unroll
    for (int x = 1; x <= 2; x *= 2)
#pragma unroll
      for (int u = 0; u < HU; ++u)
#pragma unroll
        for (int r = 0; r < 2; ++r) l[u][r] += __shfl_xor_sync(0xffffffffu, l[u][r], x);
    // P, normalised over this pass and rounded to bf16, times V (hi + lo):
    // the scores of key blocks 2 jj and 2 jj + 1 are the A fragment of step jj
    float ov[HU][NACC][4];
#pragma unroll
    for (int u = 0; u < HU; ++u)
#pragma unroll
      for (int a = 0; a < NACC; ++a) ov[u][a][0] = ov[u][a][1] = ov[u][a][2] = ov[u][a][3] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      if (jj < steps) {
#pragma unroll
        for (int u = 0; u < HU; ++u) {
          const float i0 = __fdividef(1.f, l[u][0]), i1 = __fdividef(1.f, l[u][1]);  // l >= 1
          uint32_t pf[4];
          pf[0] = psg::pack_bf16(sc[u][2 * jj][0] * i0, sc[u][2 * jj][1] * i0);
          pf[1] = psg::pack_bf16(sc[u][2 * jj][2] * i1, sc[u][2 * jj][3] * i1);
          pf[2] = psg::pack_bf16(sc[u][2 * jj + 1][0] * i0, sc[u][2 * jj + 1][1] * i0);
          pf[3] = psg::pack_bf16(sc[u][2 * jj + 1][2] * i1, sc[u][2 * jj + 1][3] * i1);
          uint32_t vf[4];  // V hi keys 0-7, hi 8-15, lo 0-7, lo 8-15, transposed
          psg::ldmatrix_x4_trans(vf, kv[u] + v_off + (c0 + jj * 16) * LD * 2);
          psg::mma(ov[u][(2 * jj) % NACC], pf, vf[0], vf[1]);
          psg::mma(ov[u][(2 * jj + 1) % NACC], pf, vf[2], vf[3]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < HU; ++u) {
#pragma unroll
      for (int a = 1; a < NACC; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) ov[u][0][e] += ov[u][a][e];
      if (c0 == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) oh[u][e] = ov[u][0][e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m_run[u][r] = m[u][r];
          l_run[u][r] = l[u][r];
        }
      } else {  // merge with the earlier passes: one rescale
        float w_old[2], w_new[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m_run[u][r], m[u][r]);
          const float l_old = l_run[u][r] * psg::ex2(m_run[u][r] - m_new);
          const float l_add = l[u][r] * psg::ex2(m[u][r] - m_new);
          const float l_new = l_old + l_add;  // >= 1
          w_old[r] = l_old / l_new;
          w_new[r] = l_add / l_new;
          m_run[u][r] = m_new;
          l_run[u][r] = l_new;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          oh[u][e] = oh[u][e] * w_old[e >> 1] + ov[u][0][e] * w_new[e >> 1];
      }
    }
  }
}

// The attention output of a warp's 16 rows, every head: q * scale in bf16
// in qs ([16][LD] in shared memory, head h's columns at h*hd) is replaced by
// o rounded to bf16.  Each lane reads and writes only its own fragment's
// elements, and a head's q is read before its o is written.  HU heads at a
// time, the loop over them not unrolled: more copies of the head body
// overflow the instruction cache.
template <int C, int NS>
__device__ __forceinline__ void all_heads(bf16* qs, uint32_t kv_addr, uint32_t v_off,
                                          const float* s_bias, int nk, int g, int tq) {
  constexpr int HD = Shape<C>::HD, LD = Shape<C>::LD;
  constexpr int HU = 8 / NS < 4 ? 8 / NS : 4;  // heads a pass: 64 score registers at most
#pragma unroll 1
  for (int h0 = 0; h0 < kHeads; h0 += HU) {
    uint32_t qa[HU][2], kv[HU];
    bool mine[HU][2];
#pragma unroll
    for (int u = 0; u < HU; ++u) {
      const int h = h0 + u, blk = h * HD / 8;  // the n8 column block that holds head h
      const int col = blk * 8 + 2 * tq;
      mine[u][0] = col / HD == h;
      mine[u][1] = (col + 1) / HD == h;
      const uint32_t keep = (mine[u][0] ? 0x0000ffffu : 0u) | (mine[u][1] ? 0xffff0000u : 0u);
      qa[u][0] = *reinterpret_cast<const uint32_t*>(qs + g * LD + col) & keep;
      qa[u][1] = *reinterpret_cast<const uint32_t*>(qs + (g + 8) * LD + col) & keep;
      kv[u] = kv_addr + blk * 16;
    }
    float oh[HU][4];
    head_attention<LD, NS, HU>(oh, qa, kv, v_off, s_bias, nk, tq);
#pragma unroll
    for (int u = 0; u < HU; ++u) {
      const int col = (h0 + u) * HD / 8 * 8 + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bf16* p = qs + (g + 8 * r) * LD + col;
        if (mine[u][0] && mine[u][1])
          *reinterpret_cast<__nv_bfloat162*>(p) =
              __floats2bfloat162_rn(oh[u][2 * r], oh[u][2 * r + 1]);
        else if (mine[u][0])
          p[0] = __float2bfloat16(oh[u][2 * r]);
        else if (mine[u][1])
          p[1] = __float2bfloat16(oh[u][2 * r + 1]);
      }
    }
  }
}

// grid (CTAs a sample, B), up to Shape<C>::THREADS threads.
template <int C>
__global__ void __launch_bounds__(Shape<C>::THREADS, Shape<C>::MIN_CTAS)
    spatial_xattn_tc(const Args a) {
  using Sh = Shape<C>;
  constexpr int CP = Sh::CP, LD = Sh::LD, NB = Sh::NB, STAGES = Sh::STAGES;
  constexpr int TILE = Sh::TILE;
  constexpr int kChunks = C / 8;  // 16-byte pieces of an activation row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = a.L, S = a.S;
  const int nk_max = (S + 15) / 16 * 16;
  bf16* s_wq = reinterpret_cast<bf16*>(smem_raw);  // [CP][LD]: Wq^T, row = output channel
  bf16* s_wp = s_wq + CP * LD;                     // [CP][LD]: Wp^T
  bf16* s_kv = s_wp + CP * LD;                     // [4][nk_max][LD]: K hi, K lo, V hi, V lo
  bf16* s_warps = s_kv + 4 * nk_max * LD;          // [warp][WARP_BUF]
  const int warps = blockDim.x / 32;
  float* s_bias = reinterpret_cast<float*>(s_warps + warps * Sh::WARP_BUF);  // [nk_max]
  float* s_bq = s_bias + nk_max;                   // [CP]
  float* s_bp = s_bq + CP;                         // [CP]
  int* s_idx = reinterpret_cast<int*>(s_bp + CP);  // [nk_max]: live keys in order
  int* s_nlive = s_idx + nk_max;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;       // mma fragment coordinates
  const int lrow = lane & 7, lmat = lane >> 3;  // ldmatrix: row and matrix
  const int b = blockIdx.y;
  const bf16* xn = static_cast<const bf16*>(a.xn) + (size_t)b * L * C;
  const bf16* res = static_cast<const bf16*>(a.res) + (size_t)b * L * C;
  bf16* out = static_cast<bf16*>(a.out) + (size_t)b * L * C;
  const int ntiles = (L + kRows - 1) / kRows;
  const int tstride = gridDim.x * warps;
  bf16* ring = s_warps + warp * Sh::WARP_BUF;  // [stage][xn, residual][16][LD]

  // stage `slot` <- row tile t of xn and of the residual, rows past L zero
  auto load_tile = [&](int t, int slot) {
    if (t >= ntiles) return;
    bf16* dst = ring + slot * 2 * TILE;
    for (int i = lane; i < kRows * kChunks; i += 32) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const int row = t * kRows + r;
      const bool ok = row < L;
      const size_t off = ok ? (size_t)row * C + c : 0;
      psg::cp_async16(dst + r * LD + c, xn + off, ok);
      psg::cp_async16(dst + TILE + r * LD + c, res + off, ok);
    }
  };

  if constexpr (C < CP) {  // the padded columns of the warp's tiles stay zero
    for (int r = lane; r < 2 * STAGES * kRows; r += 32)
      for (int c = C; c < CP; c += 8)
        *reinterpret_cast<uint4*>(ring + r * LD + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  // the first tiles' copies run under the set-up below
  int t = blockIdx.x * warps + warp;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    load_tile(t + s * tstride, s);
    psg::cp_async_commit();
  }

  // warp 0: the sample's live keys in order, by warp ballots, with their
  // bias in log2 units (-inf up to the next 16).  The other warps: Wq^T and
  // Wp^T, zero-padded to CP, and the biases.
  if (warp == 0) {
    const float* kbias = a.key_bias ? a.key_bias + (size_t)b * S : nullptr;
    float bv[kMaxKeys / 32];
#pragma unroll
    for (int i = 0; i < kMaxKeys / 32; ++i) {  // every load in flight at once
      const int j = i * 32 + lane;
      bv[i] = kbias && j < S ? kbias[j] : 0.f;
    }
    int n = 0;
#pragma unroll
    for (int i = 0; i < kMaxKeys / 32; ++i) {
      const int j = i * 32 + lane;
      const bool live = j < S && bv[i] > kDeadBias;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int at = n + __popc(mask & ((1u << lane) - 1u));
        s_idx[at] = j;
        s_bias[at] = bv[i] * kLog2e;
      }
      n += __popc(mask);
    }
    if (n == 0) {  // every key masked: the reference's softmax over all S keys
#pragma unroll
      for (int i = 0; i < kMaxKeys / 32; ++i) {
        const int j = i * 32 + lane;
        if (j < S) {
          s_idx[j] = j;
          s_bias[j] = bv[i] * kLog2e;
        }
      }
      n = S;
    }
    for (int j = n + lane; j < (n + 15) / 16 * 16; j += 32) s_bias[j] = -CUDART_INF_F;
    if (lane == 0) *s_nlive = n;
  } else {
    const bf16* wq = static_cast<const bf16*>(a.wq);
    const bf16* wp = static_cast<const bf16*>(a.wp);
#pragma unroll 8
    for (int i = threadIdx.x - 32; i < CP * CP; i += blockDim.x - 32) {
      const int co = i / CP, ci = i % CP;
      const bool ok = co < C && ci < C;
      s_wq[co * LD + ci] = ok ? wq[ci * a.wq_i + co * a.wq_o] : __float2bfloat16(0.f);
      s_wp[co * LD + ci] = ok ? wp[ci * a.wp_i + co * a.wp_o] : __float2bfloat16(0.f);
    }
    for (int i = threadIdx.x - 32; i < CP; i += blockDim.x - 32) {
      s_bq[i] = i < C ? a.bq[i] : 0.f;
      s_bp[i] = i < C ? a.bp[i] : 0.f;
    }
  }
  __syncthreads();
  const int nk = (*s_nlive + 15) / 16 * 16;
  {  // the live keys' K and V as hi + lo, zero rows up to nk
    const int n_live = *s_nlive;
    const float* kg = a.k + (size_t)b * S * C;
    const float* vg = a.v + (size_t)b * S * C;
    bf16* k_hi = s_kv;
    bf16* k_lo = k_hi + nk_max * LD;
    bf16* v_hi = k_lo + nk_max * LD;
    bf16* v_lo = v_hi + nk_max * LD;
#pragma unroll 8
    for (int i = threadIdx.x; i < nk * C; i += blockDim.x) {
      const int j = i / C, c = i % C;
      float kx = 0.f, vx = 0.f;
      if (j < n_live) {
        const long long off = s_idx[j] * a.kss + c * a.ksc;
        kx = kg[off];
        vx = vg[off];
      }
      split_bf16(kx, k_hi + j * LD + c, k_lo + j * LD + c);
      split_bf16(vx, v_hi + j * LD + c, v_lo + j * LD + c);
    }
  }
  __syncthreads();

  // ldmatrix lane addresses.  A of a [16][LD] tile: (rows 0-7 | 8-15) x
  // (k 0-7 | 8-15).  B of Wq^T / Wp^T: (n block 0 | 1) x (k 0-7 | 8-15).
  // K, V: (hi | lo) x (keys 0-7 | 8-15) of a head's column block.
  const uint32_t a_off = ((lrow + (lmat & 1) * 8) * LD + (lmat >> 1) * 8) * 2;
  const uint32_t wq_addr = psg::smem_addr(s_wq + (lrow + (lmat >> 1) * 8) * LD + (lmat & 1) * 8);
  const uint32_t wp_addr = wq_addr + CP * LD * 2;
  const uint32_t kv_addr =
      psg::smem_addr(s_kv + (lmat >> 1) * nk_max * LD + ((lmat & 1) * 8 + lrow) * LD);
  const uint32_t v_off = 2 * nk_max * LD * 2;

  for (int it = 0; t < ntiles; ++it, t += tstride) {
    load_tile(t + (STAGES - 1) * tstride, (it + STAGES - 1) % STAGES);
    psg::cp_async_commit();
    psg::cp_async_wait<STAGES - 1>();  // this tile's group is done
    __syncwarp();
    bf16* xs = ring + (it % STAGES) * 2 * TILE;
    bf16* rs = xs + TILE;

    // q = xn Wq + bq, then q * scale in bf16 over the staged xn
    float acc[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < CP / 16; ++ks) {
      uint32_t af[4];
      psg::ldmatrix_x4(af, psg::smem_addr(xs) + a_off + ks * 32);
#pragma unroll
      for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
        uint32_t wf[4];
        psg::ldmatrix_x4(wf, wq_addr + (nb2 * 16 * LD + ks * 16) * 2);
        psg::mma(acc[2 * nb2], af, wf[0], wf[1]);
        psg::mma(acc[2 * nb2 + 1], af, wf[2], wf[3]);
      }
    }
    __syncwarp();  // every lane has its xn fragments
#pragma unroll
    for (int nb = 0; nb < C / 8; ++nb) {
      const int col = nb * 8 + 2 * tq;
      const float b0 = s_bq[col], b1 = s_bq[col + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<__nv_bfloat162*>(xs + (g + 8 * r) * LD + col) = __floats2bfloat162_rn(
            (acc[nb][2 * r] + b0) * a.scale, (acc[nb][2 * r + 1] + b1) * a.scale);
    }
    __syncwarp();

    // registers for the fewest 16-key steps that hold every live key (8 at most)
    if (nk <= 16)
      all_heads<C, 1>(xs, kv_addr, v_off, s_bias, nk, g, tq);
    else if (nk <= 32)
      all_heads<C, 2>(xs, kv_addr, v_off, s_bias, nk, g, tq);
    else if (nk <= 64)
      all_heads<C, 4>(xs, kv_addr, v_off, s_bias, nk, g, tq);
    else
      all_heads<C, kMaxSteps>(xs, kv_addr, v_off, s_bias, nk, g, tq);
    __syncwarp();

    // out = o Wp + bp + residual
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < CP / 16; ++ks) {
      uint32_t af[4];
      psg::ldmatrix_x4(af, psg::smem_addr(xs) + a_off + ks * 32);
#pragma unroll
      for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
        uint32_t wf[4];
        psg::ldmatrix_x4(wf, wp_addr + (nb2 * 16 * LD + ks * 16) * 2);
        psg::mma(acc[2 * nb2], af, wf[0], wf[1]);
        psg::mma(acc[2 * nb2 + 1], af, wf[2], wf[3]);
      }
    }
    // written over the staged residual, then stored 16 bytes a lane
#pragma unroll
    for (int nb = 0; nb < C / 8; ++nb) {
      const int col = nb * 8 + 2 * tq;
      const float b0 = s_bp[col], b1 = s_bp[col + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(rs + (g + 8 * r) * LD + col);
        const float2 rv = __bfloat1622float2(*p);
        *p = __floats2bfloat162_rn(acc[nb][2 * r] + b0 + rv.x, acc[nb][2 * r + 1] + b1 + rv.y);
      }
    }
    __syncwarp();
    for (int i = lane; i < kRows * kChunks; i += 32) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const int row = t * kRows + r;
      if (row < L)
        *reinterpret_cast<uint4*>(out + (size_t)row * C + c) =
            *reinterpret_cast<const uint4*>(rs + r * LD + c);
    }
    __syncwarp();  // the slot is free for the next copy
  }
}

template <int C>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  int warps = Shape<C>::WARPS;
  while (warps > 1 && smem_bytes<C>(a.S, warps) > psg::kSmemLimit) --warps;
  const size_t smem = smem_bytes<C>(a.S, warps);
  cudaError_t err = psg::allow_smem(spatial_xattn_tc<C>, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, spatial_xattn_tc<C>, 32 * warps,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // one wave of CTAs, split evenly over the samples; no CTA without a tile
  const int tiles = (a.L + kRows - 1) / kRows;
  const int need = (tiles + warps - 1) / warps;
  const int fit = (per_sm * psg::num_sms() + B - 1) / B;
  const dim3 grid(fit < need ? fit : need, B);
  spatial_xattn_tc<C><<<grid, 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

template <typename Launch>
cudaError_t dispatch(int C, Launch&& launch) {
  switch (C) {
    case 8: return launch(std::integral_constant<int, 8>());
    case 16: return launch(std::integral_constant<int, 16>());
    case 32: return launch(std::integral_constant<int, 32>());
    case 64: return launch(std::integral_constant<int, 64>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Only the widths the decoder's C <= 64 sites take are built (8, 16, 32,
// 64): width scales 1, 1/2 and 1/4.
extern "C" int psg_spatial_xattn(const void* xn, const void* res, const float* k,
                                 const float* v, const float* key_bias, const void* wq,
                                 const float* bq, const void* wp, const float* bp, void* out,
                                 long long wq_i, long long wq_o, long long wp_i,
                                 long long wp_o, int B, int L, int S, int C, int compat,
                                 float scale, int dtype, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || S < 1 || S > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.xn = xn;
  a.res = res;
  a.out = out;
  a.k = k;
  a.v = v;
  a.kss = compat ? 1 : C;
  a.ksc = compat ? S : 1;
  a.key_bias = key_bias;
  a.wq = wq;
  a.wp = wp;
  a.wq_i = wq_i;
  a.wq_o = wq_o;
  a.wp_i = wp_i;
  a.wp_o = wp_o;
  a.bq = bq;
  a.bp = bp;
  a.L = L;
  a.S = S;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == psg::kFloat32)
    err = dispatch(C, [&](auto c) { return f32::launch<decltype(c)::value>(a, B, s); });
  else if (dtype == psg::kBFloat16)
    err = dispatch(C, [&](auto c) { return tc::launch<decltype(c)::value>(a, B, s); });
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
