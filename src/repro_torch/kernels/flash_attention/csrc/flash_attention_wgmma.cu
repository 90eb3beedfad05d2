// Flash attention forward for Hopper (sm_90a) on the tensor cores: the bf16
// body of the long-prompt prefill, at every head dim that is a multiple of 8
// up to 256.  It is built at widths 64, 128 and 256 (HD) and a call runs at
// the first width >= hd: the Q/K/V tensor maps carry the true hd as their
// innermost extent, so TMA zero-fills each box's columns past it (as it
// zero-fills the ragged key tail), zero columns add exactly 0 to every Q
// K^T, the scale is the true hd's and only the true hd columns of O are
// stored.  hd 32 runs at 64, kimi-k2's 112 at 128 (two 64-column boxes, the
// second with 48 valid columns); a multiple of 8 keeps every row's stride a
// multiple of 16 bytes, as TMA requires.  The padded products cost what
// the width's do (hd 32 what hd 64 does); the CUDA-core body, which ran
// these head dims before, fed f32 FMAs from shared memory at ~10x SDPA's
// time.
//
// Replaces the Pallas TPU kernel flash_attention_kernel
// (repro/kernels/flash_attention/kernel.py:106, body _flash_kernel) for bf16
// operands, as flash_attention.cu's CUDA-core body does for the rest.  It
// computes
//   out[b, q, h, :] = sum_k softmax_k(s_qk) v[b, k, h / G, :],
//   s_qk = softcap?(q . k / sqrt(hd)),
// over the keys k < Skv with (causal) k <= q_offset + q and (window > 0)
// q_offset + q - k < window, and out = acc / max(l, 1e-20) (zeros for a
// query that sees no key).
//
// Layouts (contiguous, the model's native ones, read in place by TMA):
//   q, out   (B, Sq, H, hd)    bf16
//   k, v     (B, Skv, KV, hd)  bf16; query head h reads KV head h / (H / KV)
//
// Bound: bytes or bf16 tensor-core operations, whichever is larger: q, k, v
// read once and out written once over 3.35 TB/s, against 4 * hd flops per
// visible (query, key) pair over 989 TFLOP/s (a bf16 product accumulated in
// f32 is exact, so the function's floor is the bf16 rate).  At the long
// prefill's shape (B 2, H 16, hd 64, S 1000, causal) the bytes bound it;
// at gemma3's local layer (hd 256, S 2048, window 1024) the operations do.
// The CUDA-core body ran both products as f32 FMAs fed from shared memory
// (8 loads per 16 FMAs) and left the tensor cores idle; this body moves
// every product onto them and keeps the loads off the critical path.
//
// Design:
//   * a CTA covers (b * H + h, a query tile) with two consumer warpgroups
//     and one producer warpgroup: at hd 64 and 128 each consumer owns 64
//     query rows (a 128-row tile); at hd 256 both own the same 64 rows and
//     each keeps half of O's columns, computing the rows' S twice (a whole
//     64 x 256 f32 O is 128 registers a thread, past what a 384-thread CTA
//     gives: ptxas holds a wgmma kernel to 65536 registers over whole
//     warpgroups, 168 a thread here, and did not lift that for setmaxnreg);
//   * query tiles are launched heaviest causal work first (grid y reversed),
//     so the causal tail does not leave SMs idle;
//   * one producer lane loads Q once and K/V tiles of 64 rows into a ring
//     of kStages stages with TMA,
//     through rank-4 tensor maps over the native layouts: no copy or pad in
//     Python, GQA reads KV head h / G in place, ragged tails are zero-filled
//     out of bounds.  Rows wider than the 128-byte swizzle (hd 128, 256) go
//     as 64-column chunks, each its own box and its own k-slab of the
//     products.  full / empty mbarriers let loads run ahead of the products;
//   * S = Q K^T is wgmma m64 n kBKV k16, both operands from shared memory
//     (K-major, 128-byte swizzle), bf16 in, f32 accumulate;
//   * within a warpgroup the tiles overlap: tile j's S is issued together
//     with tile j - 1's P V, and tile j's softmax runs while that P V is on
//     the tensor cores; across the two warpgroups a pair of mbarriers
//     hands the tensor cores back and forth (ping-pong), so one's softmax
//     runs under the other's products;
//   * mask, softcap and the online softmax work on the accumulator fragment
//     in registers, in log2 units (exp2 on the SFU, the scale folded into
//     one FFMA a score; softcap is a template flag, so the common kernel has
//     no tanh); a row's max and sum reduce over the 4 lanes that share it.
//     Only tiles that cross the causal diagonal, the window's edge or Skv
//     run the per-element mask (a masked score is -inf, its p exactly 0);
//     the CTA walks only [lo, hi), clipped as kernel.py:53-62 clips it;
//   * P V keeps p to ~16 significant bits: P_hi = bf16(p), P_lo =
//     bf16(p - P_hi), two register-A wgmmas (m64 n kOD k16) into one f32
//     accumulator with V as the MN-major B operand (transpose bit), exact
//     products and f32 sums -- the TPU kernel multiplies f32 p by v, and
//     the output must stay within one bf16 ulp of that f32 value;
//   * the epilogue divides by max(l, 1e-20), rounds once to bf16 and stores
//     a lane's two neighbouring columns at a time;
//   * asked for them (a non-null `stats`, the kStats instance: the serving
//     call passes null and runs the kernel as it was), the epilogue also
//     writes each row's final max m and sum l for the backward
//     (flash_attention_bwd_wgmma.cu), f32 (2, B * H * Sq), row b * H * Sq +
//     h * Sq + q: m in log2 units, as the online softmax keeps it (the
//     scaled score times log2(e), or the capped one's; -inf for a row that
//     sees no key), l = sum exp2(x - m) clamped to 1e-20, the value the
//     output is divided by.

#include <math.h>

#include "wgmma_common.cuh"

namespace {

// Two consumer warpgroups beside one producer warpgroup: a CTA of 384
// threads gets at most 168 registers a thread (ptxas sizes a wgmma kernel by
// whole warpgroups, and it kept that budget when the producer handed
// registers over with setmaxnreg).  K/V tiles of kBKV key rows.
constexpr int kConsumers = 2;
constexpr int kBKV = 64;

// kSplit: consumers that share 64 query rows, each keeping hd / kSplit
// columns of O (at hd 256 a whole O is 128 registers a thread, so the two
// each keep half and both compute the rows' S); kStages: K/V tiles in the
// ring.  Shared memory (Q + kStages K/V tiles) stays under 227 KB.
template <int HD>
struct Cfg;
template <>
struct Cfg<64> {
  static constexpr int kSplit = 1, kStages = 4;   // 81 KB
};
template <>
struct Cfg<128> {
  static constexpr int kSplit = 1, kStages = 3;   // 129 KB
};
template <>
struct Cfg<256> {
  static constexpr int kSplit = 2, kStages = 3;   // 225 KB
};

template <int HD>
struct Smem {
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kBQ = 64 * kConsumers / Cfg<HD>::kSplit;  // query rows of a CTA
  static constexpr int kOD = HD / Cfg<HD>::kSplit;                        // O columns of a consumer
  static constexpr uint32_t kQBytes = kBQ * HD * 2;
  static constexpr uint32_t kTileBytes = kBKV * HD * 2;  // one K or V tile
  static constexpr uint32_t kBarBytes = 8 * (2 * Cfg<HD>::kStages + 3);  // full, empty, q, turn[2]
  // 1024 bytes of slack align the tiles to the 128-byte swizzle's 1024-byte atom.
  static constexpr uint32_t kBytes = 1024 + kQBytes + Cfg<HD>::kStages * 2 * kTileBytes + kBarBytes;
};


// O += P_hi V + P_lo V over the tile's kBKV / 16 key slabs, for OD columns
// of V from sV on: the MN-major B operand, its 64-column chunks kBKV * 128
// bytes apart.
template <int OD>
__device__ __forceinline__ void issue_pv(float (&o)[OD / 2], const uint32_t (&a_hi)[kBKV / 16][4],
                                         const uint32_t (&a_lo)[kBKV / 16][4], uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < kBKV / 16; ++kk) {
    const uint64_t dv = sw128_desc(sV + kk * 16 * 128, kBKV * 128, 1024);
    Wgmma<OD>::rs(o, a_hi[kk], dv);
    Wgmma<OD>::rs(o, a_lo[kk], dv);
  }
  wgmma_commit();
}

// A consumer warpgroup's view of its 64 query rows.
struct TileRows {
  uint32_t sQ;          // its 64 rows of the Q tile in shared memory
  uint32_t my_turn, other_turn;  // ping-pong mbarriers: wait on mine, then hand the tensor cores over
  int tid;              // thread within the warpgroup
  int qa, qb;           // first and last query position
  int row0, col2;       // this thread's first row, first column of each 8-column block
  int q_offset, Skv, causal, window;
  float softcap, scale, scale2;  // scale2 = scale * log2(e)
};

// One K/V tile of a consumer warpgroup: S = Q K^T (issued with the previous
// tile's P V unless kFirst), the online softmax in log2 units, O moved to
// the new row max, and this tile's P as A fragments for the next P V.
// Returns with no wgmma in flight: the previous tile's V may be released.
template <int HD, bool kSoftcap, bool kFirst>
__device__ __forceinline__ void attend_tile(float (&o)[Smem<HD>::kOD / 2], float (&m)[2], float (&l)[2],
                                            uint32_t (&a_hi)[kBKV / 16][4], uint32_t (&a_lo)[kBKV / 16][4],
                                            const TileRows& t, uint32_t sK,
                                            uint32_t sV_prev, int k0, uint32_t& turn_phase) {
  constexpr uint32_t kChunkQ = Smem<HD>::kBQ * 128;  // bytes of a 64-column chunk of the Q tile
  constexpr uint32_t kChunkKV = kBKV * 128;          // ... of a K or V tile
  float s[kBKV / 2];
  mbar_wait(t.my_turn, turn_phase);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t da = sw128_desc(t.sQ + (kk / 4) * kChunkQ + (kk % 4) * 32, 16, 1024);
    const uint64_t db = sw128_desc(sK + (kk / 4) * kChunkKV + (kk % 4) * 32, 16, 1024);
    Wgmma<kBKV>::ss(s, da, db, kk > 0 ? 1 : 0);
  }
  wgmma_commit();
  if constexpr (!kFirst) issue_pv<Smem<HD>::kOD>(o, a_hi, a_lo, sV_prev);
  if (t.tid == 0) mbar_arrive(t.other_turn);
  turn_phase ^= 1;
  if constexpr (kFirst) {
    wgmma_wait<0>();
  } else {
    wgmma_wait<1>();
  }
  pin(s);

  // Softcap (log2 units after it), then the mask on edge tiles only: those
  // crossing Skv, the causal diagonal or the window's edge, or wholly
  // outside the rows' reach.  A masked score is -inf, so its p is exp2(-inf)
  // = 0 exactly (never exp(NEG_INF - NEG_INF) = 1: a row that has seen no
  // key yet subtracts 0, not its -inf max).
  if constexpr (kSoftcap) {
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) s[i] = tanhf(s[i] * t.scale / t.softcap) * t.softcap * kLog2e;
  }
  const bool edge = k0 + kBKV > t.Skv || (t.causal && k0 + kBKV - 1 > t.qa) || (t.window > 0 && t.qb - k0 >= t.window);
  if (edge) {
#pragma unroll
    for (int i = 0; i < kBKV / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * i + t.col2 + (e & 1);
        const int qp = t.q_offset + t.row0 + 8 * (e >> 1);
        const bool ok = kp < t.Skv && (!t.causal || kp <= qp) && (t.window <= 0 || qp - kp < t.window);
        if (!ok) s[4 * i + e] = -INFINITY;
      }
  }
  // Row max of the raw scores (or of the capped log2 ones), over the 4
  // lanes that share a row; without softcap the scale is folded into one
  // FFMA a score: p = exp2(s * scale2 - max * scale2).
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kBKV / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
  const float mul = kSoftcap ? 1.f : t.scale2;
  float corr[2];
  float sub[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * mul);  // -inf while the row has seen no key
    corr[r] = m_new == -INFINITY ? 1.f : exp2_approx(m[r] - m_new);
    sub[r] = m_new == -INFINITY ? 0.f : m_new;
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < kBKV / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(fmaf(s[4 * i + e], mul, -sub[e >> 1]));
      l[e >> 1] += p;
      s[4 * i + e] = p;
    }

  // The previous tile's P V is done; O moves to this tile's row max.
  wgmma_wait<0>();
  pin(o);
  pin(a_hi);
  pin(a_lo);
#pragma unroll
  for (int i = 0; i < Smem<HD>::kOD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * i + e] *= corr[e >> 1];

  // P as A fragments: f = (row r, block 2kk), (r + 8, 2kk), (r, 2kk + 1), (r + 8, 2kk + 1).
#pragma unroll
  for (int kk = 0; kk < kBKV / 16; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int idx = 4 * (2 * kk + (f >> 1)) + 2 * (f & 1);
      const __nv_bfloat162 hi2 = __floats2bfloat162_rn(s[idx], s[idx + 1]);
      const float2 back = __bfloat1622float2(hi2);
      a_hi[kk][f] = *reinterpret_cast<const uint32_t*>(&hi2);
      a_lo[kk][f] = pack_bf16(s[idx] - back.x, s[idx + 1] - back.y);
    }
}

template <int HD, bool kSoftcap, bool kStats>
__global__ void __launch_bounds__(Smem<HD>::kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                             float* __restrict__ stats, int Sq, int Skv, int H, int KV, int hd, int scale_hd,
                             int causal, int window, int q_offset, float softcap) {
  constexpr int kStages = Cfg<HD>::kStages;
  constexpr int kBQ = Smem<HD>::kBQ;
  constexpr int kChunks = HD / 64;
  constexpr uint32_t kTile = Smem<HD>::kTileBytes;
  constexpr uint32_t kChunkQ = kBQ * 128;    // bytes of a 64-column chunk of the Q tile
  constexpr uint32_t kChunkKV = kBKV * 128;  // ... of a K or V tile

  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + Smem<HD>::kQBytes;     // stage s: K at sKV + 2 s kTile, V after it
  const uint32_t bars = sKV + kStages * 2 * kTile;  // full[kStages], empty[kStages], q
  const uint32_t qbar = bars + 16 * kStages;
  // full[st] at bars + 8 st, empty[st] at bars + 8 (kStages + st).

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kBQ;
  const int nq = min(kBQ, Sq - q0);
  // The KV tiles any query of this CTA can see: [lo, hi), at least one (a
  // CTA that sees no key walks one tile, wholly masked, and writes zeros).
  const int n_kv = (Skv + kBKV - 1) / kBKV;
  const int hi = causal ? min((q_offset + q0 + nq - 1) / kBKV + 1, n_kv) : n_kv;
  const int lo = window > 0 ? min(max(q_offset + q0 - window + 1, 0) / kBKV, hi - 1) : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);                      // full: the producer's expect_tx
      mbar_init(bars + 8 * (kStages + st), kConsumers);  // empty: an arrival per consumer warpgroup
    }
    mbar_init(qbar, 1);
    mbar_init(qbar + 8, 1);   // turn[0]: consumer 0 may issue
    mbar_init(qbar + 16, 1);  // turn[1]: consumer 1 may issue
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);  // warp-uniform
  if (wg == kConsumers) {
    // Producer warpgroup: one lane issues every copy.
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(qbar, Smem<HD>::kQBytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) tma_load(sQ + c * kChunkQ, &tq, 64 * c, h, q0, b, qbar);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = lo; j < hi; ++j) {
        mbar_wait(bars + 8 * (kStages + stage), phase ^ 1);
        const uint32_t sK = sKV + 2 * stage * kTile;
        const uint32_t full = bars + 8 * stage;
        mbar_expect_tx(full, 2 * kTile);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          tma_load(sK + c * kChunkKV, &tk, 64 * c, kvh, j * kBKV, b, full);
          tma_load(sK + kTile + c * kChunkKV, &tv, 64 * c, kvh, j * kBKV, b, full);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // Consumer warpgroup `wg`: query rows q0 + 64 rg .. + 63 and O columns
    // kOD dh .. + kOD - 1, rg = wg / kSplit, dh = wg % kSplit.  Thread
    // (warp, lane) holds rows r and r + 8 of the fragments, r = 16 warp +
    // lane / 4, columns 8 i + 2 (lane % 4) + {0, 1} of each 8-column block i.
    constexpr int kOD = Smem<HD>::kOD;
    const int rg = wg / Cfg<HD>::kSplit;
    const int dh = wg % Cfg<HD>::kSplit;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int row0 = q0 + 64 * rg + 16 * (tid / 32) + lane / 4;  // rows row0 and row0 + 8
    const int col2 = 2 * (lane % 4);
    const int qa = q_offset + q0 + 64 * rg;  // first query position of the warpgroup
    const int qb = qa + 63;                  // last
    const float scale = 1.0f / sqrtf(static_cast<float>(scale_hd));  // the true head dim's, not the body's width
    const float scale2 = scale * kLog2e;     // scores are kept in log2 units

    float o[kOD / 2];
    float m[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
    float l[2] = {0.f, 0.f};          // this thread's share of the row sum
#pragma unroll
    for (int i = 0; i < kOD / 2; ++i) o[i] = 0.f;
    // P of the last computed tile as wgmma A fragments (bf16 hi and lo
    // parts): k-slab kk holds its columns 16 kk .. 16 kk + 15.
    uint32_t a_hi[kBKV / 16][4];
    uint32_t a_lo[kBKV / 16][4];

    mbar_wait(qbar, 0);
    const uint32_t vcol = dh * (kOD / 64) * kChunkKV;  // this consumer's first V chunk
    const TileRows rows{64 * 128 * rg + sQ, qbar + 8 + 8 * wg, qbar + 8 + 8 * (1 - wg), tid, qa, qb, row0, col2,
                        q_offset, Skv, causal, window, softcap, scale, scale2};
    // The two consumers take turns at the tensor cores (ping-pong): each
    // waits for its turn, issues its products and hands the turn over, so
    // one warpgroup's softmax runs under the other's products.  Consumer 1
    // opens the first turn for consumer 0.
    uint32_t turn_phase = 0;
    if (wg == 1 && tid == 0) mbar_arrive(rows.other_turn);
    // Every warpgroup walks the CTA's tiles [lo, hi) (bounds from blockIdx
    // only, and no wgmma under a branch); a tile outside a warpgroup's
    // rows' reach is masked whole.  Tile lo's S is computed alone; from then
    // on tile j's S is issued with tile j - 1's P V, and tile j's softmax
    // runs while that P V is on the tensor cores.
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(bars + 8 * stage, phase);
    attend_tile<HD, kSoftcap, true>(o, m, l, a_hi, a_lo, rows, sKV + 2 * stage * kTile, 0, lo * kBKV, turn_phase);
    int pstage = stage;  // stage whose V the pending P multiplies
    for (int j = lo + 1; j < hi; ++j) {
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      mbar_wait(bars + 8 * stage, phase);
      attend_tile<HD, kSoftcap, false>(o, m, l, a_hi, a_lo, rows, sKV + 2 * stage * kTile,
                                       sKV + (2 * pstage + 1) * kTile + vcol, j * kBKV, turn_phase);
      if (tid == 0) mbar_arrive(bars + 8 * (kStages + pstage));
      pstage = stage;
    }
    mbar_wait(rows.my_turn, turn_phase);
    wgmma_fence();
    issue_pv<kOD>(o, a_hi, a_lo, sKV + (2 * pstage + 1) * kTile + vcol);
    if (tid == 0) mbar_arrive(rows.other_turn);
    wgmma_wait<0>();
    pin(o);
    pin(a_hi);
    pin(a_lo);
    if (tid == 0) mbar_arrive(bars + 8 * (kStages + pstage));

    // Epilogue: the row sums over the 4 lanes of a row, one rounding to bf16.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-20f);
    }
    if constexpr (kStats) {
      // m is the same in the 4 lanes of a row; one lane of the first
      // column half writes the row's m and l.
      if (dh == 0 && col2 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          if (row < Sq) {
            const size_t at = static_cast<size_t>(bh) * Sq + row;
            stats[at] = m[r];
            stats[static_cast<size_t>(gridDim.x) * Sq + at] = l[r];
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < Sq) {
        __nv_bfloat16* orow = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * hd + kOD * dh + col2;
#pragma unroll
        for (int i = 0; i < kOD / 8; ++i) {
          if (kOD * dh + 8 * i >= hd) break;  // the zero-filled columns past hd are not stored
          const __nv_bfloat162 v2 =
              __floats2bfloat162_rn(o[4 * i + 2 * r] / l[r], o[4 * i + 2 * r + 1] / l[r]);
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) = v2;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: the launch (tensor maps encoded as wgmma_common.cuh does)
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* stats;
  int B, Sq, Skv, H, KV, hd, scale_hd, causal, window, q_offset;
  float softcap;
  cudaStream_t stream;
};

template <int HD>
int launch(const Args& a) {
  EncodeTiled fn;
  if (const int e = tensor_map_encoder(&fn)) return e;
  constexpr int kBQ = Smem<HD>::kBQ;
  CUtensorMap tq, tk, tv;
  // The maps' innermost extent is the true hd: TMA zero-fills the box's
  // columns past it, and zeros add exactly 0 to every product.
  int err = encode(fn, &tq, a.q, a.B, a.Sq, a.H, a.hd, kBQ);
  if (err == 0) err = encode(fn, &tk, a.k, a.B, a.Skv, a.KV, a.hd, kBKV);
  if (err == 0) err = encode(fn, &tv, a.v, a.B, a.Skv, a.KV, a.hd, kBKV);
  if (err != 0) return err;
  const int n_qt = (a.Sq + kBQ - 1) / kBQ;
  if (n_qt > 65535) return kUnsupported;
  auto* kernel = a.stats != nullptr
                     ? (a.softcap > 0.f ? flash_attention_wgmma_kernel<HD, true, true>
                                        : flash_attention_wgmma_kernel<HD, false, true>)
                     : (a.softcap > 0.f ? flash_attention_wgmma_kernel<HD, true, false>
                                        : flash_attention_wgmma_kernel<HD, false, false>);
  cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(Smem<HD>::kBytes));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid(a.B * a.H, n_qt);
  kernel<<<grid, Smem<HD>::kThreads, Smem<HD>::kBytes, a.stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.out), a.stats, a.Sq, a.Skv, a.H, a.KV, a.hd, a.scale_hd, a.causal,
      a.window, a.q_offset, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v, out at width hd, a multiple of 8 up to 256 (run at the next
// body width, 64, 128 or 256, zero-filled past hd); scale_hd <= hd is the
// true head dim the scale is taken at (the wrapper zero-fills a head dim
// that is not a multiple of 8 up to one); every pointer 16-byte aligned;
// stats null, or f32 (2, B * H * Sq) for each row's m and l.  Returns 0, a
// cudaError_t from the launch, -1 for arguments the body does not take, -2
// / -3 when no cuTensorMapEncodeTiled is found / it refuses a map, -4 when
// no context can be made current on the calling thread.
// Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* out, float* stats,
                                            int B, int Sq, int Skv, int H, int KV, int hd, int scale_hd, int causal,
                                            int window, int q_offset, float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H <= 0 || H % KV != 0 || q_offset < 0 || window < 0)
    return kUnsupported;
  if (hd <= 0 || hd % 8 != 0 || hd > 256 || scale_hd <= 0 || scale_hd > hd) return kUnsupported;
  const Args a{q, k, v, out, stats, B, Sq, Skv, H, KV, hd, scale_hd, causal, window, q_offset, softcap,
               static_cast<cudaStream_t>(stream)};
  return hd <= 64 ? launch<64>(a) : hd <= 128 ? launch<128>(a) : launch<256>(a);
}

extern "C" const char* flash_attention_wgmma_error_string(int code) {
  if (code == kUnsupported) return "unsupported shape or dtype";
  if (code == kNoEncoder) return "no cuTensorMapEncodeTiled entry point";
  if (code == kEncodeFailed) return g_encode_msg;
  if (code == kNoContext) return "no CUDA context could be made current on the calling thread";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
