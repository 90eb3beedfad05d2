// Flash attention backward for Hopper (sm_90a) on the CUDA cores: dQ, dK
// and dV of the forward bodies' function (flash_attention.cu and its two
// tensor-core twins), for every shape and option they take -- bf16 and
// f32, hd 1-256, GQA with H % KV == 0, causal, window, q_offset, ragged
// tails and softcap.  A training sequence past attn_block_q runs the
// forward kernel and then a backward body, through
// dispatch.FlashAttentionFunction; this one takes what the tensor-core
// backward (flash_attention_bwd_wgmma.cu) does not: head dims that are not
// multiples of 8, and f32 at hd 136-256 (three bf16 planes of every tile
// do not fit that body's shared memory there).
//
// Replaces the gradient the reference takes by autodiff of its jnp
// recurrence _blockwise_attn (repro/models/attention.py:162; the Pallas
// kernel flash_attention_kernel, kernel.py:106, has no backward).  With
//   s_qk = softcap?(scale * q . k),  scale = 1 / sqrt(hd),
//   p_qk = exp(s_qk - m_q) / l_q  over the keys the forward's mask lets through
//          (k < Skv, causal k <= q_offset + q, window q_offset + q - k < window;
//          m_q the row's max score, l_q its sum of exp(s - m_q)),
//   D_q  = sum_d dO[q, d] O[q, d]  (= sum_k p_qk dP_qk),
// it computes
//   dV[k] = sum_{g, q} p_qk dO[q],            dP_qk = dO[q] . v[k],
//   dS_qk = p_qk (dP_qk - D_q) (1 - t_qk^2)   (t = s / softcap; 1 without),
//   dQ[q] = scale sum_k dS_qk k[k],  dK[k] = scale sum_{g, q} dS_qk q[q],
// where dK and dV of KV head kv sum over the G = H / KV query heads
// kv * G .. kv * G + G - 1 in the kernel, in f32, rounded once.  A query
// row that sees no key has output 0 in the forward kernels, a constant, so
// its p is 0 here too.
//
// Layouts (contiguous, the model's native ones, read in place):
//   q, o, dO, dQ   (B, Sq, H, hd)    bf16 or f32 (gradients in q's dtype)
//   k, v, dK, dV   (B, Skv, KV, hd)
//   m, l, D        (3, B * H * Sq) f32 scratch the wrapper allocates
//
// Bound: the larger of bytes (q, k, v, o, dO read once, dQ, dK, dV written
// once) over 3.35 TB/s and operations over the peak of f32-accurate
// arithmetic on the operands' type: the backward's four products a
// visible pair (S again, dP, dV, dK over 8 hd flops in the dK/dV pass) and
// dQ's S, dP and dQ (6 hd) plus the statistics' S (2 hd) are 16 hd flops a
// pair, where a fused backward that keeps dS needs 10 hd (2.5x the
// forward's 4 hd).
//
// Design (simple first: three launches, f32 FMAs on the CUDA cores):
//   1. fa_bwd_stats_kernel, one block per (b * H + h, 64-row query tile):
//      the forward's online softmax again, without the PV product, for
//      each row's max m and sum l, and D = rowsum(dO * O); the forward
//      bodies are left as they are and write no statistics.  m and l stay
//      apart, so p = exp(s - m) / l rounds as a softmax does (one
//      lse = m + log l would put that sum's rounding into every p of the
//      row);
//   2. fa_bwd_dkdv_kernel, one block per (b * KV + kv, key tile): K and V
//      of the tile stay in shared memory; the block walks the G heads of
//      the group and the 64-row query tiles that reach the tile (clipped by
//      causality and the window), recomputes S^T and dP^T for the tile from
//      the statistics, and sums dV and dK in registers.  The key tile is
//      4096 / HDMAX keys (64 at hd <= 64, 32 at <= 128, 16 at <= 256), so
//      the two f32 accumulators stay at 32 registers a thread: a 64-key
//      tile at hd 256 would need 128;
//   3. fa_bwd_dq_kernel, one block per (b * H + h, 64-row query tile):
//      walks the key tiles the rows can see, recomputes S and dP, puts dS
//      through shared memory and sums dQ in registers (64 a thread at hd
//      256).
//   A 16 x 16 thread grid in each: a thread owns a few rows and columns of
//   a tile's score block and head dims tx + 16 e of its accumulators.
//   Each tile's terms are summed apart and then added to the running sum
//   (two-level summation): one f32 chain over a long row's keys or
//   queries drifts further from f64 than the plain backward's blocked sums
//   do (tests/test_torch_flash_attention_bwd.py emulates dQ both ways);
//   shared rows have an odd stride (hd + 1), so column reads do not
//   conflict.  Masked entries contribute p = 0 explicitly, never
//   exp(NEG_INF - m).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kBQ = 64;               // query rows of a tile
constexpr int kRows = kBQ / kTY;      // query rows a thread owns in the stats and dQ passes
constexpr int kStatsBKV = 64;         // key rows of the stats pass's K tile
constexpr float kNegInf = -1.0e30f;
constexpr int kUnsupported = -1;

// Keys of a dK/dV or dQ tile for a head-dim bucket: 64 * 64 / HDMAX.
template <int HDMAX>
struct Tile {
  static constexpr int kBKV = 64 * 64 / HDMAX;
  static constexpr int kDims = HDMAX / kTX;   // accumulator dims a thread owns
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(int qp, int kp, int Skv, int causal, int window) {
  return kp < Skv && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// The forward's score from the raw dot product; *t gets tanh's value (for
// the softcap's derivative 1 - t^2), 0 without a softcap.
__device__ __forceinline__ float score(float dot, float scale, float softcap, float* t) {
  const float x = dot * scale;
  if (softcap > 0.f) {
    *t = tanhf(x / softcap);
    return *t * softcap;
  }
  *t = 0.f;
  return x;
}

// Rows [0, n) of a (rows, hd) tile of a (.., S, heads, hd) tensor into
// shared memory (row stride ld, f32), zeros past n.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* __restrict__ src, size_t row0, int rows, int n,
                                      int heads, int head, int hd) {
  for (int i = threadIdx.x; i < rows * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i % hd;
    dst[r * ld + d] = r < n ? to_f32(src[((row0 + r) * heads + head) * hd + d]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// 1. Row statistics: max m and sum l under the forward's masks, D = dO . O
// ---------------------------------------------------------------------------

template <typename T, int HDMAX>
__global__ void __launch_bounds__(kThreads)
fa_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
                    const T* __restrict__ dout, float* __restrict__ rowmax, float* __restrict__ rowsum,
                    float* __restrict__ delta, int Sq,
                    int Skv, int H, int KV, int hd, int causal, int window, int q_offset, float softcap) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* sQ = smem;                   // (kBQ, ld)
  float* sK = sQ + kBQ * ld;          // (kStatsBKV, ld)

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int nq = min(kBQ, Sq - q0);
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));

  stage(sQ, ld, q, static_cast<size_t>(b) * Sq + q0, kBQ, nq, H, h, hd);

  const int n_kv = (Skv + kStatsBKV - 1) / kStatsBKV;
  const int hi = causal ? min((q_offset + q0 + nq - 1) / kStatsBKV + 1, n_kv) : n_kv;
  const int lo = window > 0 ? max(q_offset + q0 - window + 1, 0) / kStatsBKV : 0;

  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * kStatsBKV;
    __syncthreads();
    stage(sK, ld, k, static_cast<size_t>(b) * Skv + k0, kStatsBKV, min(kStatsBKV, Skv - k0), KV, kvh, hd);
    __syncthreads();
    float s[kRows][kStatsBKV / kTX];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kStatsBKV / kTX; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[kRows], kv[kStatsBKV / kTX];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty * kRows + i) * ld + d];
#pragma unroll
      for (int j = 0; j < kStatsBKV / kTX; ++j) kv[j] = sK[(tx + j * kTX) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kStatsBKV / kTX; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q_offset + q0 + ty * kRows + i;
      bool ok[kStatsBKV / kTX];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kStatsBKV / kTX; ++j) {
        float t;
        const float x = score(s[i][j], scale, softcap, &t);
        ok[j] = visible(qp, k0 + tx + j * kTX, Skv, causal, window);
        s[i][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kStatsBKV / kTX; ++j) sum += ok[j] ? expf(s[i][j] - m_new) : 0.f;
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(sum);
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    float dd = 0.f;
    if (r < nq) {
      const size_t row = ((static_cast<size_t>(b) * Sq + q0 + r) * H + h) * hd;
      for (int d = tx; d < hd; d += kTX) dd = fmaf(to_f32(dout[row + d]), to_f32(o[row + d]), dd);
    }
    dd = half_warp_sum(dd);
    if (r < nq && tx == 0) {
      // A row that sees no key (l = 0) never reads its statistics.
      rowmax[static_cast<size_t>(bh) * Sq + q0 + r] = m[i];
      rowsum[static_cast<size_t>(bh) * Sq + q0 + r] = l[i] > 0.f ? l[i] : 1.f;
      delta[static_cast<size_t>(bh) * Sq + q0 + r] = dd;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV: one block per (b * KV + kv, key tile), summed over the group
// ---------------------------------------------------------------------------

template <typename T, int HDMAX>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ rowmax,
                   const float* __restrict__ rowsum, const float* __restrict__ delta,
                   T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H, int KV, int hd, int causal,
                   int window, int q_offset, float softcap) {
  constexpr int kBKV = Tile<HDMAX>::kBKV;
  constexpr int kRK = kBKV / kTY;              // key rows a thread owns
  constexpr int kCQ = kBQ / kTX;               // query columns a thread owns
  constexpr int kDims = Tile<HDMAX>::kDims;
  constexpr int kPS = kBQ + 1;                 // row stride of the P / dS tiles
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* sK = smem;                            // (kBKV, ld)
  float* sV = sK + kBKV * ld;                  // (kBKV, ld)
  float* sQ = sV + kBKV * ld;                  // (kBQ, ld)
  float* sO = sQ + kBQ * ld;                   // (kBQ, ld) dO
  float* sP = sO + kBQ * ld;                   // (kBKV, kPS)
  float* sS = sP + kBKV * kPS;                 // (kBKV, kPS) dS
  float* sM = sS + kBKV * kPS;                 // (kBQ) m
  float* sL = sM + kBQ;                        // (kBQ) l
  float* sD = sL + kBQ;                        // (kBQ) D

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int k0 = blockIdx.x * kBKV;
  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y % KV;
  const int G = H / KV;
  const int nk = min(kBKV, Skv - k0);
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));

  stage(sK, ld, k, static_cast<size_t>(b) * Skv + k0, kBKV, nk, KV, kvh, hd);
  stage(sV, ld, v, static_cast<size_t>(b) * Skv + k0, kBKV, nk, KV, kvh, hd);

  // The query rows that see a key of this tile: [q_begin, q_end).
  const int q_begin = causal ? max(k0 - q_offset, 0) : 0;
  const int q_end = window > 0 ? min(Sq, k0 + nk - 1 + window - q_offset) : Sq;

  float acc_k[kRK][kDims], acc_v[kRK][kDims];
#pragma unroll
  for (int i = 0; i < kRK; ++i)
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t bh = static_cast<size_t>(b) * H + h;
    for (int q0 = (q_begin / kBQ) * kBQ; q0 < q_end; q0 += kBQ) {
      const int nq = min(kBQ, Sq - q0);
      __syncthreads();                         // the previous tile's readers are done
      stage(sQ, ld, q, static_cast<size_t>(b) * Sq + q0, kBQ, nq, H, h, hd);
      stage(sO, ld, dout, static_cast<size_t>(b) * Sq + q0, kBQ, nq, H, h, hd);
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        sM[r] = r < nq ? rowmax[bh * Sq + q0 + r] : 0.f;
        sL[r] = r < nq ? rowsum[bh * Sq + q0 + r] : 1.f;
        sD[r] = r < nq ? delta[bh * Sq + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[kRK][kCQ], dp[kRK][kCQ];
#pragma unroll
      for (int i = 0; i < kRK; ++i)
#pragma unroll
        for (int j = 0; j < kCQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < hd; ++d) {
        float kv[kRK], vv[kRK], qv[kCQ], ov[kCQ];
#pragma unroll
        for (int i = 0; i < kRK; ++i) {
          kv[i] = sK[(ty * kRK + i) * ld + d];
          vv[i] = sV[(ty * kRK + i) * ld + d];
        }
#pragma unroll
        for (int j = 0; j < kCQ; ++j) {
          qv[j] = sQ[(tx + j * kTX) * ld + d];
          ov[j] = sO[(tx + j * kTX) * ld + d];
        }
#pragma unroll
        for (int i = 0; i < kRK; ++i)
#pragma unroll
          for (int j = 0; j < kCQ; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kRK; ++i) {
        const int kr = ty * kRK + i;
#pragma unroll
        for (int j = 0; j < kCQ; ++j) {
          const int qc = tx + j * kTX;
          float t;
          const float x = score(s[i][j], scale, softcap, &t);
          const bool ok = qc < nq && visible(q_offset + q0 + qc, k0 + kr, Skv, causal, window);
          const float p = ok ? expf(x - sM[qc]) / sL[qc] : 0.f;
          sP[kr * kPS + qc] = p;
          sS[kr * kPS + qc] = p * (dp[i][j] - sD[qc]) * (1.f - t * t);
        }
      }
      __syncthreads();

      float part_k[kRK][kDims], part_v[kRK][kDims];
#pragma unroll
      for (int i = 0; i < kRK; ++i)
#pragma unroll
        for (int e = 0; e < kDims; ++e) part_k[i][e] = part_v[i][e] = 0.f;
#pragma unroll 2
      for (int c = 0; c < nq; ++c) {
        float p[kRK], ds[kRK];
#pragma unroll
        for (int i = 0; i < kRK; ++i) {
          p[i] = sP[(ty * kRK + i) * kPS + c];
          ds[i] = sS[(ty * kRK + i) * kPS + c];
        }
#pragma unroll
        for (int e = 0; e < kDims; ++e) {
          const int d = tx + e * kTX;
          if (d < hd) {
            const float ov = sO[c * ld + d];
            const float qv = sQ[c * ld + d];
#pragma unroll
            for (int i = 0; i < kRK; ++i) {
              part_v[i][e] = fmaf(p[i], ov, part_v[i][e]);
              part_k[i][e] = fmaf(ds[i], qv, part_k[i][e]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRK; ++i)
#pragma unroll
        for (int e = 0; e < kDims; ++e) {
          acc_k[i][e] += part_k[i][e];
          acc_v[i][e] += part_v[i][e];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kRK; ++i) {
    const int kr = ty * kRK + i;
    if (kr < nk) {
      const size_t row = ((static_cast<size_t>(b) * Skv + k0 + kr) * KV + kvh) * hd;
#pragma unroll
      for (int e = 0; e < kDims; ++e) {
        const int d = tx + e * kTX;
        if (d < hd) {
          dk[row + d] = from_f32<T>(acc_k[i][e] * scale);
          dv[row + d] = from_f32<T>(acc_v[i][e]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: one block per (b * H + h, 64-row query tile)
// ---------------------------------------------------------------------------

template <typename T, int HDMAX>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ rowmax, const float* __restrict__ rowsum,
                 const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv, int H, int KV, int hd, int causal, int window,
                 int q_offset, float softcap) {
  constexpr int kBKV = Tile<HDMAX>::kBKV;
  constexpr int kCK = kBKV / kTX;              // key columns a thread owns
  constexpr int kDims = Tile<HDMAX>::kDims;
  constexpr int kSS = kBKV + 1;                // row stride of the dS tile
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* sQ = smem;                            // (kBQ, ld)
  float* sO = sQ + kBQ * ld;                   // (kBQ, ld) dO
  float* sK = sO + kBQ * ld;                   // (kBKV, ld)
  float* sV = sK + kBKV * ld;                  // (kBKV, ld)
  float* sS = sV + kBKV * ld;                  // (kBQ, kSS) dS
  float* sM = sS + kBQ * kSS;                  // (kBQ) m
  float* sL = sM + kBQ;                        // (kBQ) l
  float* sD = sL + kBQ;                        // (kBQ) D

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int nq = min(kBQ, Sq - q0);
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));

  stage(sQ, ld, q, static_cast<size_t>(b) * Sq + q0, kBQ, nq, H, h, hd);
  stage(sO, ld, dout, static_cast<size_t>(b) * Sq + q0, kBQ, nq, H, h, hd);
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    sM[r] = r < nq ? rowmax[static_cast<size_t>(bh) * Sq + q0 + r] : 0.f;
    sL[r] = r < nq ? rowsum[static_cast<size_t>(bh) * Sq + q0 + r] : 1.f;
    sD[r] = r < nq ? delta[static_cast<size_t>(bh) * Sq + q0 + r] : 0.f;
  }

  const int n_kv = (Skv + kBKV - 1) / kBKV;
  const int hi = causal ? min((q_offset + q0 + nq - 1) / kBKV + 1, n_kv) : n_kv;
  const int lo = window > 0 ? max(q_offset + q0 - window + 1, 0) / kBKV : 0;

  float acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[i][e] = 0.f;

  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * kBKV;
    const int nk = min(kBKV, Skv - k0);
    __syncthreads();                           // the previous tile's readers are done
    stage(sK, ld, k, static_cast<size_t>(b) * Skv + k0, kBKV, nk, KV, kvh, hd);
    stage(sV, ld, v, static_cast<size_t>(b) * Skv + k0, kBKV, nk, KV, kvh, hd);
    __syncthreads();

    float s[kRows][kCK], dp[kRows][kCK];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < hd; ++d) {
      float qv[kRows], ov[kRows], kv[kCK], vv[kCK];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = sQ[(ty * kRows + i) * ld + d];
        ov[i] = sO[(ty * kRows + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < kCK; ++j) {
        kv[j] = sK[(tx + j * kTX) * ld + d];
        vv[j] = sV[(tx + j * kTX) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCK; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCK; ++j) {
        const int kc = tx + j * kTX;
        float t;
        const float x = score(s[i][j], scale, softcap, &t);
        const bool ok = r < nq && visible(q_offset + q0 + r, k0 + kc, Skv, causal, window);
        const float p = ok ? expf(x - sM[r]) / sL[r] : 0.f;
        sS[r * kSS + kc] = p * (dp[i][j] - sD[r]) * (1.f - t * t);
      }
    }
    __syncwarp();                              // dS rows of this ty were written by its own half warp

    float part[kRows][kDims];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int e = 0; e < kDims; ++e) part[i][e] = 0.f;
#pragma unroll 2
    for (int c = 0; c < nk; ++c) {
      float ds[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) ds[i] = sS[(ty * kRows + i) * kSS + c];
#pragma unroll
      for (int e = 0; e < kDims; ++e) {
        const int d = tx + e * kTX;
        if (d < hd) {
          const float kk = sK[c * ld + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) part[i][e] = fmaf(ds[i], kk, part[i][e]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[i][e] += part[i][e];
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (r < nq) {
      T* row = dq + ((static_cast<size_t>(b) * Sq + q0 + r) * H + h) * hd;
#pragma unroll
      for (int e = 0; e < kDims; ++e) {
        const int d = tx + e * kTX;
        if (d < hd) row[d] = from_f32<T>(acc[i][e] * scale);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *rowmax, *rowsum, *delta;
  int B, Sq, Skv, H, KV, hd, causal, window, q_offset;
  float softcap;
  cudaStream_t stream;
};

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename T, int HDMAX>
int launch(const Args& a) {
  constexpr int kBKV = Tile<HDMAX>::kBKV;
  const size_t ld = static_cast<size_t>(a.hd) + 1;
  const size_t stats_smem = sizeof(float) * (kBQ + kStatsBKV) * ld;
  const size_t dkdv_smem = sizeof(float) * ((2 * kBKV + 2 * kBQ) * ld + 2 * kBKV * (kBQ + 1) + 3 * kBQ);
  const size_t dq_smem = sizeof(float) * ((2 * kBQ + 2 * kBKV) * ld + kBQ * (kBKV + 1) + 3 * kBQ);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  int err;

  auto* stats = fa_bwd_stats_kernel<T, HDMAX>;
  if ((err = set_smem(stats, stats_smem)) != 0) return err;
  stats<<<dim3((a.Sq + kBQ - 1) / kBQ, a.B * a.H), kThreads, stats_smem, a.stream>>>(
      q, k, o, dout, a.rowmax, a.rowsum, a.delta, a.Sq, a.Skv, a.H, a.KV, a.hd, a.causal, a.window, a.q_offset, a.softcap);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;

  auto* dkdv = fa_bwd_dkdv_kernel<T, HDMAX>;
  if ((err = set_smem(dkdv, dkdv_smem)) != 0) return err;
  dkdv<<<dim3((a.Skv + kBKV - 1) / kBKV, a.B * a.KV), kThreads, dkdv_smem, a.stream>>>(
      q, k, v, dout, a.rowmax, a.rowsum, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Sq, a.Skv, a.H, a.KV, a.hd,
      a.causal, a.window, a.q_offset, a.softcap);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;

  auto* dqk = fa_bwd_dq_kernel<T, HDMAX>;
  if ((err = set_smem(dqk, dq_smem)) != 0) return err;
  dqk<<<dim3((a.Sq + kBQ - 1) / kBQ, a.B * a.H), kThreads, dq_smem, a.stream>>>(
      q, k, v, dout, a.rowmax, a.rowsum, a.delta, static_cast<T*>(a.dq), a.Sq, a.Skv, a.H, a.KV, a.hd, a.causal, a.window,
      a.q_offset, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a) {
  if (a.hd <= 64) return launch<T, 64>(a);
  if (a.hd <= 128) return launch<T, 128>(a);
  return launch<T, 256>(a);
}

}  // namespace

// dtype 1 = bf16, 2 = f32 (q, k, v, o, dout and the three gradients alike);
// stats is (3, B * H * Sq) f32 scratch (row max, row sum, D).  Three launches on `stream`
// (statistics, dK/dV, dQ); no synchronisation, no allocation.  Returns 0,
// a cudaError_t, or -1 for arguments the kernels do not take.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                          const void* dout, void* dq, void* dk, void* dv, float* stats, int B, int Sq, int Skv, int H, int KV, int hd, int dtype,
                                          int causal, int window, int q_offset, float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H <= 0 || H % KV != 0 || hd <= 0 || hd > 256 ||
      q_offset < 0 || window < 0 || B * H > 65535)
    return kUnsupported;
  const size_t rows = static_cast<size_t>(B) * H * Sq;
  const Args a{q, k, v, o, dout, dq, dk, dv, stats, stats + rows, stats + 2 * rows, B, Sq, Skv, H, KV, hd, causal, window, q_offset,
               softcap, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 1:
      return launch_hd<__nv_bfloat16>(a);
    case 2:
      return launch_hd<float>(a);
    default:
      return kUnsupported;
  }
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  if (code == kUnsupported) return "unsupported shape or dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
