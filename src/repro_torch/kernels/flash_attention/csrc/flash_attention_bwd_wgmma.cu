// Flash attention backward for Hopper (sm_90a) on the tensor cores: dQ, dK
// and dV of the bf16 forward body (flash_attention_wgmma.cu) at hd 64, 128
// and 256 -- causal, window, q_offset, ragged tails, softcap and GQA with
// H % KV == 0.  A bf16 training sequence past attn_block_q runs that
// forward and then this backward, through dispatch.FlashAttentionFunction;
// f32, and bf16 at other head dims, keep flash_attention_bwd.cu.
//
// Replaces the gradient the reference takes by autodiff of its jnp
// recurrence _blockwise_attn (repro/models/attention.py:162; the Pallas
// kernel flash_attention_kernel, kernel.py:106, has no backward).  With
//   x_qk  = softcap?(scale * q . k) * log2(e),  scale = 1 / sqrt(hd),
//   p_qk  = exp2(x_qk - m_q) / l_q  over the keys the forward's mask lets through,
//   D_q   = sum_d dO[q, d] O[q, d],
// it computes
//   dV[k] = sum_{g, q} p_qk dO[q],            dP_qk = dO[q] . v[k],
//   dS_qk = p_qk (dP_qk - D_q) (1 - t_qk^2)   (t = tanh(scale q . k / softcap); 1 without),
//   dQ[q] = scale sum_k dS_qk k[k],  dK[k] = scale sum_{g, q} dS_qk q[q],
// dK and dV of KV head kv summed over its G = H / KV query heads in f32
// inside one CTA, rounded once.
//
// Row statistics: m and l are the forward's own.  The wgmma forward, asked
// for them, writes each row's final max m (log2 units: the scaled, capped
// score times log2(e), as its online softmax keeps it; -inf for a row that
// sees no key) and its sum l = sum exp2(x - m) (clamped to 1e-20, the
// value it divides by) into an f32 (2, B * H * Sq) tensor.  This kernel
// forms x with the forward's arithmetic -- one FFMA x = s * scale2 - m
// without a softcap, tanhf(s * scale / softcap) * softcap * log2(e) - m
// with one, exp2 on the SFU -- so p is the forward's p up to the order of
// the hd-long dot product's sums.  m and l stay apart: one lse = m + log2 l
// would put its rounding into every p of the row.
//
// Layouts (contiguous, the model's native ones, read in place by TMA):
//   q, o, dO, dQ   (B, Sq, H, hd)    bf16
//   k, v, dK, dV   (B, Skv, KV, hd)  bf16; query head h reads KV head h / G
//   m, l           (2, B * H * Sq)   f32 from the forward
//   row records    (B * H, 3, Sq padded to 128) f32 scratch: m, 1 / l, D
//
// Bound: bytes (q, k, v, o, dO read once, dQ, dK, dV written once) over
// 3.35 TB/s against the function's least work, 10 hd flops a visible
// (query, key) pair (S, dP, dV, dK, dQ: 2 hd each) at 989 TFLOP/s (a bf16
// product summed in f32 is exact).  At the training shape (B 4, H 16, hd
// 64, S 1024, causal) that is 67.1 MB, 20.0 us, against 21.5 GFLOP,
// 21.7 us.  The products this body issues: S and dP twice each (once in
// each kernel) and dV, dK and dQ as hi + lo pairs, 2 + 2 + 4 + 4 (dK/dV
// kernel) + 2 + 2 + 4 (dQ kernel) = 20 hd a pair, plus the masked halves
// of the tiles on the causal diagonal.
//
// Design -- what it does about the three faults of the CUDA-core backward
// (flash_attention_bwd.cu):
//   * products on the CUDA cores in f32 FMAs (14 % of the CUDA-core peak):
//     every product here is a wgmma, bf16 in, f32 accumulate.  S^T = K Q^T
//     and dP^T = V dO^T (dK/dV kernel), S = Q K^T and dP = dO V^T (dQ
//     kernel) take both operands from shared memory, K-major; P^T and dS^T
//     (dS) go from their accumulators straight into register-A fragments,
//     and dV += P^T dO, dK += dS^T Q, dQ += dS K read dO, Q and K as the
//     transposed (MN-major) B operand, as the forward reads V;
//   * S three times and dP twice: the forward writes m and l, so no
//     statistics pass; D = rowsum(dO o O) is bytes, computed in the dQ
//     kernel's prologue; two launches, S and dP once in each (dQ is summed
//     in its own kernel so that no sum needs atomics);
//   * no statistics from the forward: above.
//   Accuracy: P and dS are f32 values; each product takes them as bf16 hi
//   + lo (lo = bf16(x - hi)), two wgmmas into one f32 accumulator, so they
//   keep ~16 bits.  P or dS rounded once to bf16 misses the bar by ~50-200x
//   (tests/test_torch_flash_attention_bwd.py; SDPA's backward, which does
//   that, misses it by as much).  Deterministic: no atomics; each output
//   element is summed in one fixed order.
//   Latency, not the tensor cores' rate, bounds a warpgroup here: its tile
//   is a chain (products, wait, exp2 and splits, products, wait), so the
//   design keeps as many warpgroups on an SM as the registers allow.
//   There is no producer warpgroup: one thread issues every TMA copy, so
//   ptxas sizes a CTA by its consumer warpgroups alone.  Per head dim and
//   kernel (Cfg): at hd 64 both kernels run one warpgroup a CTA -- the dK/dV
//   kernel three CTAs an SM at 168 registers (dK and dV, 64; then S^T and
//   dP^T, 64, each register turning into a fragment word as P and dS are
//   formed in one pass), the dQ kernel four at ~124 -- over 64-row tiles;
//   at hd 128 and 256 two warpgroups a CTA share the streamed tiles (32
//   rows), and at hd 256 they share 64 resident rows, each keeping half of
//   the accumulator's columns (computing the rows' S and dP twice), as the
//   forward's kSplit does.
//   dQ kernel: one CTA per (b * H + h, query tile), heaviest causal tiles
//   first; Q, dO, m, 1 / l and D stay; K and V come through a TMA ring.  It
//   writes each row's m, 1 / l and D (the row records) for the next kernel.
//   dK/dV kernel: one CTA per (b * KV + kv, key tile), heaviest first; K
//   and V stay in shared memory; the CTA walks the group's heads and the
//   query tiles that reach its keys (clipped by causality and the window,
//   as the CUDA-core body clips them), Q, dO and the tile's row records
//   through the ring, so no thread waits on a global load in the loop.
//   Only tiles that cross the causal diagonal, the window's edge or Skv run
//   the per-element mask; masked entries get p = 0 explicitly.  With one
//   warpgroup a slot is refilled as soon as its products end; with two,
//   one tile late, so the refilling thread seldom waits on the other.

#include <math.h>

#include "wgmma_common.cuh"

namespace {

enum Kernel { kDq, kDkdv };

// Per head dim and kernel: kWG consumer warpgroups a CTA and kCtas CTAs an
// SM (kCtas 3 holds a thread to 168 registers); kBN rows of a streamed tile
// (keys in the dQ kernel, queries in the dK/dV kernel); kSplit warpgroups
// sharing 64 resident rows, each keeping hd / kSplit accumulator columns;
// kStages streamed tiles in the ring.  Shared memory in the comments.
template <int HD, int K>
struct Cfg {
  static constexpr int kWG = 2, kCtas = 1, kBN = HD == 64 ? 64 : 32, kSplit = HD == 256 ? 2 : 1;
  static constexpr int kStages = HD == 256 ? 3 : 4;  // hd 128: 131 KB, hd 256: 164 KB
};
template <>
struct Cfg<64, kDq> {
  static constexpr int kWG = 1, kCtas = 4, kBN = 64, kSplit = 1, kStages = 2;  // 50 KB
};
template <>
struct Cfg<64, kDkdv> {
  static constexpr int kWG = 1, kCtas = 3, kBN = 64, kSplit = 1, kStages = 3;  // 67 KB
};

// Row records: the dQ kernel writes each row's m, 1 / l and D (m = 1 / l =
// 0 for a row that sees no key, and for the padding past Sq) as f32 (B * H,
// 3, Sq padded to kRecPad); the dK/dV kernel loads a query tile's with TMA.
constexpr int kRecPad = 128;

__host__ __device__ constexpr int rec_pad(int sq) { return (sq + kRecPad - 1) / kRecPad * kRecPad; }

template <int HD, int K>
struct Geo {
  static constexpr int kWG = Cfg<HD, K>::kWG;
  static constexpr int kSplit = Cfg<HD, K>::kSplit;
  static constexpr int kThreads = kWG * 128;
  static constexpr int kR = 64 * kWG / kSplit;           // resident rows of a CTA
  static constexpr int kOD = HD / kSplit;                // accumulator columns of a warpgroup
  static constexpr int kBN = Cfg<HD, K>::kBN;
  static constexpr int kStages = Cfg<HD, K>::kStages;
  static constexpr uint32_t kResBytes = kR * HD * 2;     // one resident tile
  static constexpr uint32_t kTileBytes = kBN * HD * 2;   // one streamed tile
  static constexpr uint32_t kChunkR = kR * 128;          // a 64-column chunk of a resident tile
  static constexpr uint32_t kChunkN = kBN * 128;         // ... of a streamed tile
  // A stage: two streamed tiles, and in the dK/dV kernel the tile's row
  // records (3 x kBN f32) in a 1024-byte slot that keeps the next stage aligned.
  static constexpr uint32_t kRecBytes = K == kDkdv ? 3 * kBN * 4 : 0;
  static constexpr uint32_t kStageBytes = 2 * kTileBytes + (K == kDkdv ? 1024 : 0);
  static constexpr uint32_t kBarOff = 2 * kResBytes + kStages * kStageBytes;  // full, empty, res
  static constexpr uint32_t kStatOff = kBarOff + 8 * (2 * kStages + 1);
  static constexpr uint32_t kStatBytes = K == kDq ? 3 * kR * 4 : 0;  // dQ: m, 1 / l, D of the resident rows
  // 1024 bytes of slack align the tiles to the 128-byte swizzle's 1024-byte atom.
  static constexpr uint32_t kBytes = 1024 + kStatOff + kStatBytes;
};


// One TMA box of a rank-2 map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}



// An accumulator pair (x[idx], x[idx + 1]) as bf16 hi and lo fragment words:
// hi = bf16(x), lo = bf16(x - hi), both rounded to nearest.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
  const float2 back = __bfloat1622float2(h2);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf16(a - back.x, b - back.y);
}

// An m64 x kBN accumulator as register-A fragments of kBN / 16 k-slabs:
// fragment word f of slab kk = (row r, block 2kk), (r + 8, 2kk), (r, 2kk +
// 1), (r + 8, 2kk + 1), as the forward forms P's.
template <int kBN>
__device__ __forceinline__ void to_fragments(const float (&x)[kBN / 2], uint32_t (&hi)[kBN / 16][4],
                                             uint32_t (&lo)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int idx = 4 * (2 * kk + (f >> 1)) + 2 * (f & 1);
      split_pair(x[idx], x[idx + 1], hi[kk][f], lo[kk][f]);
    }
}

// acc += (hi + lo) B over kBN / 16 k-slabs: B is a streamed tile read
// MN-major from sB, the first of its 64-column chunks this warpgroup
// takes (rows = the product's k, columns = its N of kOD).
template <int kBN, int kOD>
__device__ __forceinline__ void issue_rs(float (&acc)[kOD / 2], const uint32_t (&hi)[kBN / 16][4],
                                         const uint32_t (&lo)[kBN / 16][4], uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t db = sw128_desc(sB + kk * 16 * 128, kBN * 128, 1024);
    Wgmma<kOD>::rs(acc, hi[kk], db);
    Wgmma<kOD>::rs(acc, lo[kk], db);
  }
  wgmma_commit();
}

// acc = A B^T over HD, A = 64 resident rows (K-major, chunks kChunkA apart),
// B = a streamed tile of kBN rows (K-major, chunks kBN * 128 apart).
template <int HD, int kBN, uint32_t kChunkA>
__device__ __forceinline__ void issue_ss(float (&acc)[kBN / 2], uint32_t sA, uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t da = sw128_desc(sA + (kk / 4) * kChunkA + (kk % 4) * 32, 16, 1024);
    const uint64_t db = sw128_desc(sB + (kk / 4) * (kBN * 128) + (kk % 4) * 32, 16, 1024);
    Wgmma<kBN>::ss(acc, da, db, kk > 0 ? 1 : 0);
  }
  wgmma_commit();
}

struct Params {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* m;      // (B * H * Sq) log2 units
  const float* l;      // (B * H * Sq)
  float* rec;          // (B * H, 3, Sq padded to kRecPad): row records, written by the dQ kernel
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int Sq, Skv, H, KV, causal, window, q_offset;
  float softcap;
};

// p of one accumulator element from its raw score s and its query's m and
// 1 / l, with the forward's score arithmetic; dfac gets dS's factor
// 1 - t^2 (1 without a softcap).  The caller masks.
template <bool kSoftcap>
__device__ __forceinline__ float prob(float s, float m, float il, float scale2, float scale, float softcap,
                                      float& dfac) {
  if constexpr (kSoftcap) {
    const float t = tanhf(s * scale / softcap);
    dfac = 1.f - t * t;
    return exp2_approx(t * softcap * kLog2e - m) * il;
  } else {
    dfac = 1.f;
    return exp2_approx(fmaf(s, scale2, -m)) * il;
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int Skv, int causal, int window) {
  return kp < Skv && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// ---------------------------------------------------------------------------
// dQ (and D): one CTA per (b * H + h, query tile of kR rows)
// ---------------------------------------------------------------------------

template <int HD, bool kSoftcap>
__global__ void __launch_bounds__(Geo<HD, kDq>::kThreads, Cfg<HD, kDq>::kCtas)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                       const Params a) {
  using G = Geo<HD, kDq>;
  constexpr int kBN = G::kBN, kR = G::kR, kOD = G::kOD, kStages = G::kStages, kWG = G::kWG;
  constexpr int kChunks = HD / 64;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sQ = smem_u32(base);
  const uint32_t sDO = sQ + G::kResBytes;
  const uint32_t sRing = sDO + G::kResBytes;  // stage st: K at sRing + st kStageBytes, V after it
  const uint32_t bars = sQ + G::kBarOff;      // full[kStages], empty[kStages], res
  const uint32_t resbar = bars + 16 * kStages;
  float* sM = reinterpret_cast<float*>(base + G::kStatOff);  // (kR) m, then 1 / l, then D
  float* sIL = sM + kR;
  float* sD = sIL + kR;

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kR;
  const int nq = min(kR, a.Sq - q0);
  const int n_kv = (a.Skv + kBN - 1) / kBN;
  const int hi = a.causal ? min((a.q_offset + q0 + nq - 1) / kBN + 1, n_kv) : n_kv;
  const int lo = a.window > 0 ? min(max(a.q_offset + q0 - a.window + 1, 0) / kBN, hi - 1) : 0;
  const int n_tiles = hi - lo;  // >= 1

  auto issue_kv = [&](int j, int st) {
    const uint32_t sK = sRing + st * G::kStageBytes;
    const uint32_t full = bars + 8 * st;
    mbar_expect_tx(full, 2 * G::kTileBytes);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load(sK + c * G::kChunkN, &tk, 64 * c, kvh, (lo + j) * kBN, b, full);
      tma_load(sK + G::kTileBytes + c * G::kChunkN, &tv, 64 * c, kvh, (lo + j) * kBN, b, full);
    }
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);                  // full: the issuing thread's expect_tx
      mbar_init(bars + 8 * (kStages + st), kWG);     // empty: an arrival per warpgroup
    }
    mbar_init(resbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(resbar, 2 * G::kResBytes);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load(sQ + c * G::kChunkR, &tq, 64 * c, h, q0, b, resbar);
      tma_load(sDO + c * G::kChunkR, &tdo, 64 * c, h, q0, b, resbar);
    }
    for (int j = 0; j < min(kStages, n_tiles); ++j) issue_kv(j, j);
  }

  // D = rowsum(dO o O) for the CTA's rows (kT threads a row); m, 1 / l and
  // D of the rows into shared memory and into the row records for the dK/dV
  // kernel.  A row that sees no key (m = -inf) and a row past Sq get m = 0,
  // 1 / l = 0: p = 0.
  {
    constexpr int kT = G::kThreads / kR;
    constexpr int kCols = HD / kT;
    const int r = threadIdx.x / kT;
    const int part = threadIdx.x % kT;
    const int q = q0 + r;
    float dd = 0.f;
    if (q < a.Sq) {
      const size_t off = ((static_cast<size_t>(b) * a.Sq + q) * a.H + h) * HD + part * kCols;
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(a.o + off);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(a.dout + off);
#pragma unroll 8
      for (int c = 0; c < kCols / 2; ++c) {
        const float2 x = __bfloat1622float2(o2[c]);
        const float2 y = __bfloat1622float2(d2[c]);
        dd = fmaf(x.x, y.x, dd);
        dd = fmaf(x.y, y.y, dd);
      }
    }
#pragma unroll
    for (int off = 1; off < kT; off <<= 1) dd += __shfl_xor_sync(0xffffffffu, dd, off);
    if (part == 0) {
      float mm = 0.f, il = 0.f;
      if (q < a.Sq) {
        const size_t row = static_cast<size_t>(bh) * a.Sq + q;
        mm = a.m[row];
        il = 1.f / a.l[row];
        if (mm == -INFINITY) mm = il = 0.f;
      }
      sM[r] = mm;
      sIL[r] = il;
      sD[r] = dd;
      const int pad = rec_pad(a.Sq);  // q < pad: kR divides kRecPad
      float* rec = a.rec + static_cast<size_t>(bh) * 3 * pad + q;
      rec[0] = mm;
      rec[pad] = il;
      rec[2 * pad] = dd;
    }
  }
  __syncthreads();

  // Warpgroup wg: rows 64 rg .. + 63 of the CTA, dQ columns kOD dh .. + kOD
  // - 1.  Thread (warp, lane) holds fragment rows r0 and r0 + 8, columns 8 i
  // + col2 + {0, 1} of each 8-column block i.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int rg = wg / G::kSplit;
  const int dh = wg % G::kSplit;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = 64 * rg + 16 * (tid / 32) + lane / 4;
  const int col2 = 2 * (lane % 4);
  const int qa = a.q_offset + q0 + 64 * rg;  // first query position of the warpgroup
  const int qb = qa + 63;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const float scale2 = scale * kLog2e;
  float rm[2], ril[2], rd[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rm[e] = sM[r0 + 8 * e];
    ril[e] = sIL[r0 + 8 * e];
    rd[e] = sD[r0 + 8 * e];
  }

  float dq[kOD / 2];
#pragma unroll
  for (int i = 0; i < kOD / 2; ++i) dq[i] = 0.f;
  float s[kBN / 2], dp[kBN / 2];
  uint32_t f_hi[kBN / 16][4], f_lo[kBN / 16][4];
  const uint32_t sQw = sQ + 64 * 128 * rg;
  const uint32_t sDOw = sDO + 64 * 128 * rg;

  mbar_wait(resbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t sK = sRing + st * G::kStageBytes;
    const uint32_t sV = sK + G::kTileBytes;
    mbar_wait(bars + 8 * st, (j / kStages) & 1);
    wgmma_fence();
    issue_ss<HD, kBN, G::kChunkR>(s, sQw, sK);
    issue_ss<HD, kBN, G::kChunkR>(dp, sDOw, sV);
    if constexpr (kWG > 1) {
      // Refill the slot tile j - 1 used, once every warpgroup is done with
      // it: one tile late, so the refilling thread seldom waits.
      if (threadIdx.x == 0 && j >= 1 && j - 1 + kStages < n_tiles) {
        const int ps = (j - 1) % kStages;
        mbar_wait(bars + 8 * (kStages + ps), ((j - 1) / kStages) & 1);
        issue_kv(j - 1 + kStages, ps);
      }
      __syncwarp();
    }
    wgmma_wait<0>();
    pin(s);
    pin(dp);

    const int k0 = (lo + j) * kBN;
    const bool edge = k0 + kBN > a.Skv || (a.causal && k0 + kBN - 1 > qa) || (a.window > 0 && qb - k0 >= a.window);
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * i + e;
        const int r = e >> 1;
        float dfac;
        float p = prob<kSoftcap>(s[x], rm[r], ril[r], scale2, scale, a.softcap, dfac);
        if (edge && !visible(a.q_offset + q0 + r0 + 8 * r, k0 + 8 * i + col2 + (e & 1), a.Skv, a.causal, a.window))
          p = 0.f;
        dp[x] = p * (dp[x] - rd[r]) * dfac;
      }
    to_fragments<kBN>(dp, f_hi, f_lo);
    wgmma_fence();
    issue_rs<kBN, kOD>(dq, f_hi, f_lo, sK + dh * (kOD / 64) * G::kChunkN);
    wgmma_wait<0>();
    pin(dq);
    pin(f_hi);
    pin(f_lo);
    if (tid == 0) mbar_arrive(bars + 8 * (kStages + st));
    if constexpr (kWG == 1) {
      // One warpgroup: the slot is free now.
      if (threadIdx.x == 0 && j + kStages < n_tiles) issue_kv(j + kStages, st);
      __syncwarp();
    }
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = q0 + r0 + 8 * e;
    if (q < a.Sq) {
      __nv_bfloat16* row = a.dq + ((static_cast<size_t>(b) * a.Sq + q) * a.H + h) * HD + kOD * dh + col2;
#pragma unroll
      for (int i = 0; i < kOD / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * i) =
            __floats2bfloat162_rn(dq[4 * i + 2 * e] * scale, dq[4 * i + 2 * e + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dK and dV: one CTA per (b * KV + kv, key tile of kR rows), summed over the group
// ---------------------------------------------------------------------------

template <int HD, bool kSoftcap>
__global__ void __launch_bounds__(Geo<HD, kDkdv>::kThreads, Cfg<HD, kDkdv>::kCtas)
fa_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap trec, const Params a) {
  using G = Geo<HD, kDkdv>;
  constexpr int kBN = G::kBN, kR = G::kR, kOD = G::kOD, kStages = G::kStages, kWG = G::kWG;
  constexpr int kChunks = HD / 64;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sK = smem_u32(base);
  const uint32_t sV = sK + G::kResBytes;
  const uint32_t sRing = sV + G::kResBytes;  // stage st: Q at sRing + st kStageBytes, dO, the records
  const uint32_t bars = sK + G::kBarOff;     // full[kStages], empty[kStages], res
  const uint32_t resbar = bars + 16 * kStages;

  const int b = blockIdx.x / a.KV;
  const int kvh = blockIdx.x % a.KV;
  const int grp = a.H / a.KV;
  const int k0 = blockIdx.y * kR;  // causal: the lowest keys, the most work, first
  const int nk = min(kR, a.Skv - k0);
  // The query rows that see a key of this tile: [q_begin, q_end), walked in
  // query tiles t_lo .. t_lo + n_qt - 1 for each head of the group.
  const int q_begin = a.causal ? max(k0 - a.q_offset, 0) : 0;
  const int q_end = a.window > 0 ? min(a.Sq, k0 + nk - 1 + a.window - a.q_offset) : a.Sq;
  const int t_lo = q_begin / kBN;
  const int n_qt = q_end > q_begin ? (q_end + kBN - 1) / kBN - t_lo : 0;
  const int n_tiles = grp * n_qt;

  auto issue_q = [&](int t, int st) {
    const int h = kvh * grp + t / n_qt;
    const int q0 = (t_lo + t % n_qt) * kBN;
    const uint32_t sQ = sRing + st * G::kStageBytes;
    const uint32_t full = bars + 8 * st;
    mbar_expect_tx(full, 2 * G::kTileBytes + G::kRecBytes);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load(sQ + c * G::kChunkN, &tq, 64 * c, h, q0, b, full);
      tma_load(sQ + G::kTileBytes + c * G::kChunkN, &tdo, 64 * c, h, q0, b, full);
    }
    tma_load_2d(sQ + 2 * G::kTileBytes, &trec, q0, 3 * (b * a.H + h), full);
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (kStages + st), kWG);
    }
    mbar_init(resbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(resbar, 2 * G::kResBytes);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load(sK + c * G::kChunkR, &tk, 64 * c, kvh, k0, b, resbar);
      tma_load(sV + c * G::kChunkR, &tv, 64 * c, kvh, k0, b, resbar);
    }
    for (int t = 0; t < min(kStages, n_tiles); ++t) issue_q(t, t);
  }
  __syncthreads();

  // Warpgroup wg: keys 64 rg .. + 63 of the CTA, dK / dV columns kOD dh ..
  // + kOD - 1.  Thread (warp, lane) holds fragment rows (keys) r0 and r0 +
  // 8, columns (queries) 8 i + col2 + {0, 1} of each 8-column block i.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int rg = wg / G::kSplit;
  const int dh = wg % G::kSplit;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;
  const int col2 = 2 * (lane % 4);
  const int ka = k0 + 64 * rg;  // first key of the warpgroup
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const float scale2 = scale * kLog2e;

  float dk[kOD / 2], dv[kOD / 2];
#pragma unroll
  for (int i = 0; i < kOD / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[kBN / 2], dp[kBN / 2];
  uint32_t p_hi[kBN / 16][4], p_lo[kBN / 16][4], d_hi[kBN / 16][4], d_lo[kBN / 16][4];
  const uint32_t sKw = sK + 64 * 128 * rg;
  const uint32_t sVw = sV + 64 * 128 * rg;

  mbar_wait(resbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const int q0 = (t_lo + t % n_qt) * kBN;
    const uint32_t sQ = sRing + st * G::kStageBytes;
    const uint32_t sDO = sQ + G::kTileBytes;
    const float* sst = reinterpret_cast<const float*>(base + (sQ + 2 * G::kTileBytes - smem_u32(base)));
    mbar_wait(bars + 8 * st, (t / kStages) & 1);
    wgmma_fence();
    issue_ss<HD, kBN, G::kChunkR>(s, sKw, sQ);    // S^T = K Q^T
    issue_ss<HD, kBN, G::kChunkR>(dp, sVw, sDO);  // dP^T = V dO^T
    if constexpr (kWG > 1) {
      // Refill the slot tile t - 1 used, once every warpgroup is done with
      // it: one tile late, so the refilling thread seldom waits.
      if (threadIdx.x == 0 && t >= 1 && t - 1 + kStages < n_tiles) {
        const int ps = (t - 1) % kStages;
        mbar_wait(bars + 8 * (kStages + ps), ((t - 1) / kStages) & 1);
        issue_q(t - 1 + kStages, ps);
      }
      __syncwarp();
    }
    const int qp0 = a.q_offset + q0;
    const bool edge = ka + 64 > a.Skv || (a.causal && ka + 63 > qp0) ||
                      (a.window > 0 && qp0 + kBN - 1 - ka >= a.window);
    wgmma_wait<0>();
    pin(s);
    pin(dp);

    // P^T and dS^T in one pass, straight into fragments: element pair (4 i +
    // 2 w, + 1) is word 2 (i % 2) + w of slab i / 2 (to_fragments' order),
    // so each accumulator register dies as its fragment word is made.
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const float2 mm = *reinterpret_cast<const float2*>(sst + 8 * i + col2);
      const float2 il = *reinterpret_cast<const float2*>(sst + kBN + 8 * i + col2);
      const float2 dd = *reinterpret_cast<const float2*>(sst + 2 * kBN + 8 * i + col2);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        float p[2], ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int x = 4 * i + 2 * w + c;
          float dfac;
          p[c] = prob<kSoftcap>(s[x], c ? mm.y : mm.x, c ? il.y : il.x, scale2, scale, a.softcap, dfac);
          if (edge && !visible(qp0 + 8 * i + col2 + c, ka + r0 + 8 * w, a.Skv, a.causal, a.window)) p[c] = 0.f;
          ds[c] = p[c] * (dp[x] - (c ? dd.y : dd.x)) * dfac;
        }
        split_pair(p[0], p[1], p_hi[i / 2][2 * (i % 2) + w], p_lo[i / 2][2 * (i % 2) + w]);
        split_pair(ds[0], ds[1], d_hi[i / 2][2 * (i % 2) + w], d_lo[i / 2][2 * (i % 2) + w]);
      }
    }
    wgmma_fence();
    issue_rs<kBN, kOD>(dv, p_hi, p_lo, sDO + dh * (kOD / 64) * G::kChunkN);  // dV += P^T dO
    issue_rs<kBN, kOD>(dk, d_hi, d_lo, sQ + dh * (kOD / 64) * G::kChunkN);   // dK += dS^T Q
    wgmma_wait<0>();
    pin(dk);
    pin(dv);
    pin(p_hi);
    pin(p_lo);
    pin(d_hi);
    pin(d_lo);
    if (tid == 0) mbar_arrive(bars + 8 * (kStages + st));
    if constexpr (kWG == 1) {
      // One warpgroup: the slot is free now.
      if (threadIdx.x == 0 && t + kStages < n_tiles) issue_q(t + kStages, st);
      __syncwarp();
    }
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = ka + r0 + 8 * e;
    if (key < a.Skv) {
      const size_t off = ((static_cast<size_t>(b) * a.Skv + key) * a.KV + kvh) * HD + kOD * dh + col2;
#pragma unroll
      for (int i = 0; i < kOD / 8; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(a.dk + off + 8 * i) =
            __floats2bfloat162_rn(dk[4 * i + 2 * e] * scale, dk[4 * i + 2 * e + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(a.dv + off + 8 * i) =
            __floats2bfloat162_rn(dv[4 * i + 2 * e], dv[4 * i + 2 * e + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: the two launches (tensor maps encoded as wgmma_common.cuh does)
// ---------------------------------------------------------------------------

// The row records (B * H * 3 rows of `pad` f32), boxes of `cols` x 3 rows.
int encode_rec(EncodeTiled fn, CUtensorMap* map, const float* ptr, int rows, int pad, int cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(pad), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pad) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(cols), 3};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

struct Args {
  const void *q, *k, *v, *dout;
  Params p;
  int B;
  cudaStream_t stream;
};

template <typename Kern, typename... Maps>
int launch_one(Kern kernel, dim3 grid, int threads, uint32_t smem, const Params& p, cudaStream_t stream,
               const Maps&... maps) {
  const cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(smem));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  kernel<<<grid, threads, smem, stream>>>(maps..., p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const Args& a) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  using Q = Geo<HD, kDq>;
  using KV = Geo<HD, kDkdv>;
  const Params& p = a.p;
  const int n_q = (p.Sq + Q::kR - 1) / Q::kR;
  const int n_k = (p.Skv + KV::kR - 1) / KV::kR;
  if (n_q > 65535 || n_k > 65535) return kUnsupported;
  const bool cap = p.softcap > 0.f;
  // The dQ kernel: Q and dO resident (kR rows), K and V streamed (kBN); it
  // writes D, which the dK/dV kernel, launched after it, reads.
  CUtensorMap tq, tdo, tk, tv;
  int err = encode(fn, &tq, a.q, a.B, p.Sq, p.H, HD, Q::kR);
  if (err == 0) err = encode(fn, &tdo, a.dout, a.B, p.Sq, p.H, HD, Q::kR);
  if (err == 0) err = encode(fn, &tk, a.k, a.B, p.Skv, p.KV, HD, Q::kBN);
  if (err == 0) err = encode(fn, &tv, a.v, a.B, p.Skv, p.KV, HD, Q::kBN);
  if (err != 0) return err;
  err = launch_one(cap ? fa_bwd_dq_wgmma_kernel<HD, true> : fa_bwd_dq_wgmma_kernel<HD, false>,
                   dim3(a.B * p.H, n_q), Q::kThreads, Q::kBytes, p, a.stream, tq, tdo, tk, tv);
  if (err != 0) return err;
  // The dK/dV kernel: K and V resident (kR rows), Q, dO and the row
  // records streamed (kBN).
  CUtensorMap trec;
  err = encode(fn, &tq, a.q, a.B, p.Sq, p.H, HD, KV::kBN);
  if (err == 0) err = encode(fn, &tdo, a.dout, a.B, p.Sq, p.H, HD, KV::kBN);
  if (err == 0) err = encode(fn, &tk, a.k, a.B, p.Skv, p.KV, HD, KV::kR);
  if (err == 0) err = encode(fn, &tv, a.v, a.B, p.Skv, p.KV, HD, KV::kR);
  if (err == 0) err = encode_rec(fn, &trec, p.rec, 3 * a.B * p.H, rec_pad(p.Sq), KV::kBN);
  if (err != 0) return err;
  return launch_one(cap ? fa_bwd_dkdv_wgmma_kernel<HD, true> : fa_bwd_dkdv_wgmma_kernel<HD, false>,
                    dim3(a.B * p.KV, n_k), KV::kThreads, KV::kBytes, p, a.stream, tq, tdo, tk, tv, trec);
}

}  // namespace

// f32 elements of the row-record scratch a call needs.
extern "C" long long flash_attention_bwd_wgmma_scratch(int B, int H, int Sq) {
  return 3LL * B * H * rec_pad(Sq);
}

// bf16 q, k, v, o, dout and the three gradients; hd 64, 128 or 256; stats
// is the forward's (2, B * H * Sq) f32 m and l, rec f32 scratch of
// flash_attention_bwd_wgmma_scratch(B, H, Sq) elements; q, k, v, dout and
// rec 16-byte aligned.  Two launches on `stream` (dQ with the row records,
// then dK/dV); no synchronisation, no allocation.  Returns 0, a
// cudaError_t, -1 for arguments the body does not take, -2 / -3 when no
// cuTensorMapEncodeTiled is found / it refuses a map.
extern "C" int flash_attention_bwd_wgmma_launch(const void* q, const void* k, const void* v, const void* o,
                                                const void* dout, const float* stats, float* rec, void* dq,
                                                void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, int hd,
                                                int causal, int window, int q_offset, float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H <= 0 || H % KV != 0 || q_offset < 0 || window < 0 ||
      B * H > 65535)
    return kUnsupported;
  const size_t rows = static_cast<size_t>(B) * H * Sq;
  const Params p{static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), stats, stats + rows,
                 rec, static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv), Sq, Skv, H, KV, causal, window, q_offset, softcap};
  const Args a{q, k, v, dout, p, B, static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 64:
      return launch<64>(a);
    case 128:
      return launch<128>(a);
    case 256:
      return launch<256>(a);
    default:
      return kUnsupported;
  }
}

extern "C" const char* flash_attention_bwd_wgmma_error_string(int code) {
  if (code == kUnsupported) return "unsupported shape or dtype";
  if (code == kNoEncoder) return "no cuTensorMapEncodeTiled entry point";
  if (code == kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
