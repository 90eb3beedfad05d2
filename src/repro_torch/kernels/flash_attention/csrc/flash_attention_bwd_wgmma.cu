// Flash attention backward for Hopper (sm_90a) on the tensor cores: dQ, dK
// and dV of the forward bodies' function -- causal, window, q_offset,
// ragged tails, softcap and GQA with H % KV == 0 -- in two arithmetic
// modes over one body:
//   * bf16 (flash_attention_bwd_wgmma_launch): bf16 operands at every head
//     dim up to 256, after the wgmma forward (flash_attention_wgmma.cu),
//     whose row statistics it reads;
//   * f32 (flash_attention_bwd_bf16x6_launch): f32 operands at every head
//     dim up to 256, each split into three bf16 planes (six products a
//     product, bf16x6.cuh); up to hd 128 after the bf16x6 forward
//     (flash_attention_bf16x6.cu), whose row statistics it reads, past it
//     with statistics of its own and the gradients in 64-column slabs.
// A training sequence past attn_block_q runs a forward body and then this
// backward, through dispatch.FlashAttentionFunction.  A head dim that is
// not a multiple of 8 arrives zero-filled to one by the wrapper
// (cuda_kernel.py), with the true hd as scale_hd; no route reaches the
// CUDA-core backward (flash_attention_bwd.cu) any more.
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
// Head dims: the body is built at widths 64, 128 and 256 (HD); a call runs
// at the first width >= hd.  The tensor maps carry hd as their innermost
// extent, so TMA zero-fills a box's columns past it; zero columns add
// exactly 0 to every Q K^T and dO V^T, the scale is scale_hd's (the true
// head dim; hd itself when the wrapper did not pad), and only the hd
// columns of dQ, dK and dV are stored.  hd 112 runs as two 64-column
// boxes, the second with 48 valid columns.
//
// Row statistics: m (log2 units: the scaled, capped score times log2(e);
// -inf for a row that sees no key) and l = sum exp2(x - m) (clamped to
// 1e-20), f32 (2, B * H * Sq).  In bf16 they are the wgmma forward's own,
// written when it is asked for them.  In f32 up to hd 128 they are the
// bf16x6 forward's, formed from the same six-product S with the arithmetic
// of fa_bwd_stats_bf16x6_kernel, element for element; so the backward runs
// no statistics kernel (three device kernels a call: the split, dQ,
// dK/dV).  The serving forward (3xTF32) keeps ~22 of f32's 24 bits; on the
// training path its O and statistics put the f32 path's gradients at 3.86x
// naive attention's f32 error, so the training path's forward is bf16x6.
// Past hd 128 no forward writes f32 statistics (three planes of every tile
// do not fit its shared memory), and fa_bwd_stats_bf16x6_kernel forms them
// after the split (four device kernels).  Each p is formed with that
// arithmetic -- one FFMA x = s * scale2 - m without a softcap, tanhf(s *
// scale / softcap) * softcap * log2(e) - m with one, exp2 on the SFU -- and
// m and l stay apart: one lse = m + log2 l would put its rounding into
// every p.
//
// Layouts (contiguous, the model's native ones, read in place by TMA):
//   q, o, dO, dQ   (B, Sq, H, hd)    bf16 or f32
//   k, v, dK, dV   (B, Skv, KV, hd); query head h reads KV head h / G
//   row records    (B * H, 3, Sq padded to 128) f32 scratch: m, 1 / l, D
//   f32 only: q, k, v, dO as bf16 planes (3 B, S, heads, hd) -- plane p of
//   batch b at batch b + p B -- and the statistics, in one scratch buffer.
//
// Bound: bytes (q, k, v, o, dO read once, dQ, dK, dV written once) over
// 3.35 TB/s against the function's least work, 10 hd flops a visible
// (query, key) pair (S, dP, dV, dK, dQ: 2 hd each), at 989 TFLOP/s for bf16
// (a bf16 product summed in f32 is exact) and at the f32-accurate
// tensor-core rate for f32 (chip_smoke.py's PEAK_OPS["tf32x3"], 165
// TFLOP/s, which six bf16 products an f32 one also give: 989 / 6).  At the
// training shape (B 4, H 16, hd 64, S 1024, causal), bf16: 67.1 MB, 20.0 us,
// against 21.5 GFLOP, 21.7 us; f32: 134 MB against 130 us of operations.
// The products this body issues, a visible pair: bf16 -- S and dP twice
// each (once in each kernel), dV, dK and dQ as hi + lo pairs: 20 hd; f32 up
// to hd 128 -- S and dP twice, dV, dK and dQ once, each as six bf16
// products: 72 hd; f32 past hd 128 -- S once more in the statistics
// kernel, and S and dP once a 128-column slice in each slab kernel: 132 hd
// at width 256.  The f32 split writes 1.5x the operands' f32 bytes as
// planes and reads them back.
//
// Design -- what it does about the faults of the CUDA-core backward
// (flash_attention_bwd.cu: f32 FMAs fed a scalar from shared memory for
// about every FMA, a statistics pass, 16 hd flops a pair):
//   * every product is a wgmma, bf16 in, f32 accumulate.  S^T = K Q^T and
//     dP^T = V dO^T (dK/dV kernel), S = Q K^T and dP = dO V^T (dQ kernel)
//     take both operands from shared memory, K-major; P^T and dS^T (dS) go
//     from their accumulators straight into register-A fragments, and dV
//     += P^T dO, dK += dS^T Q, dQ += dS K read dO, Q and K as the
//     transposed (MN-major) B operand, as the forward reads V;
//   * bf16: the forward writes m and l, so there is no statistics pass;
//     D = rowsum(dO * O) is bytes, computed in the dQ kernel's prologue;
//     two launches, S and dP once in each (dQ is summed in its own kernel
//     so that no sum needs atomics);
//   * f32 at f32 accuracy on the tensor cores (kP = 3): a pre-pass splits
//     each f32 operand x of q, k, v, dO into bf16 planes hi = bf16(x), mid
//     = bf16(x - hi), lo = bf16(x - hi - mid) (both differences exact), and
//     each product a b runs as the six wgmmas mid mid + hi lo + lo hi + hi
//     mid + mid hi + hi hi, accumulated in f32; P and dS, formed in f32
//     registers, are split the same way into three fragment planes.  The
//     dropped terms (mid lo, lo mid, lo lo and the split's residual) are of
//     order 2**-24 relative: plain f32's.  Three products (hi hi, hi mid,
//     mid hi) drop hi lo, lo hi and mid mid, of order 2**-16, ~250x f32's
//     error, and 3xTF32 keeps ~22 bits (tests/test_torch_flash_attention
//     _bwd.py shows both miss the f32 bars); six bf16 products cost what
//     3xTF32's three TF32 ones do, at 989 / 6 TFLOP/s;
//   * the tensor core's own accumulation: inside a wgmma the f32 sum is not
//     rounded as the CUDA cores' FADD is.  So, within a product, the five
//     small plane pairs go in first over every k-slab, while the sum is
//     ~2**-8 of its final size, and hi hi last; and each tile's dV, dK and
//     dQ terms start a fresh accumulator that the CUDA cores add into the
//     running f32 sum (two-level summation, as flash_attention_bwd.cu sums
//     tiles): the tensor core never adds into a sum many tiles long.
//   Accuracy in bf16: P and dS are f32 values; each product takes them as
//   bf16 hi + lo (lo = bf16(x - hi)), two wgmmas into one f32 accumulator,
//   so they keep ~16 bits.  P or dS rounded once to bf16 misses the bar by
//   ~50-200x (tests/test_torch_flash_attention_bwd.py; SDPA's backward,
//   which does that, misses it by as much).  Deterministic: no atomics;
//   each output element is summed in one fixed order.
//   Latency, not the tensor cores' rate, bounds a bf16 warpgroup: its tile
//   is a chain (products, wait, exp2 and splits, products, wait), so the
//   design keeps as many warpgroups on an SM as the registers allow; the
//   f32 tile does six times the products for the same chain.
//   There is no producer warpgroup: one thread issues every TMA copy, so
//   ptxas sizes a CTA by its consumer warpgroups alone.  Per head dim,
//   kernel and mode (Cfg): bf16 at hd 64 runs one warpgroup a CTA -- the
//   dK/dV kernel three CTAs an SM at 168 registers (dK and dV, 64; then S^T
//   and dP^T, 64, each register turning into a fragment word as P and dS
//   are formed in one pass), the dQ kernel four at ~124 -- over 64-row
//   tiles; at hd 128 and 256 two warpgroups a CTA share the streamed tiles
//   (32 rows), and at hd 256 they share 64 resident rows, each keeping half
//   of the accumulator's columns (computing the rows' S and dP twice), as
//   the forward's kSplit does.  f32: three planes of every tile fill shared
//   memory at one CTA an SM; two warpgroups share the streamed tiles at hd
//   64, and at hd 128 the dK/dV kernel's two share 64 resident keys, each
//   keeping half of dK and dV's columns; past hd 128 nothing stays
//   resident (the slab kernels, below).
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

#include <type_traits>

#include "wgmma_common.cuh"
#include "bf16x6.cuh"

namespace {

enum Kernel { kDq, kDkdv };

// Per head dim, kernel and mode (kP: bf16 planes an operand has, 1 in bf16,
// 3 in f32): kWG consumer warpgroups a CTA and kCtas CTAs an SM (kCtas 3
// holds a thread to 168 registers); kBN rows of a streamed tile (keys in
// the dQ kernel, queries in the dK/dV kernel); kSplit warpgroups sharing 64
// resident rows, each keeping hd / kSplit accumulator columns; kStages
// streamed tiles in the ring.  Shared memory in the comments.
template <int HD, int K, int kP>
struct Cfg {
  static constexpr int kWG = 2, kCtas = 1, kBN = HD == 64 ? 64 : 32, kSplit = HD == 256 ? 2 : 1;
  static constexpr int kStages = HD == 256 ? 3 : 4;  // hd 128: 131 KB, hd 256: 164 KB
};
template <>
struct Cfg<64, kDq, 1> {
  static constexpr int kWG = 1, kCtas = 4, kBN = 64, kSplit = 1, kStages = 2;  // 50 KB
};
template <>
struct Cfg<64, kDkdv, 1> {
  static constexpr int kWG = 1, kCtas = 3, kBN = 64, kSplit = 1, kStages = 3;  // 67 KB
};
template <int K>
struct Cfg<64, K, 3> {
  static constexpr int kWG = 2, kCtas = 1, kBN = 64, kSplit = 1, kStages = 2;  // 195 KB
};
template <>
struct Cfg<128, kDq, 3> {
  static constexpr int kWG = 1, kCtas = 1, kBN = 32, kSplit = 1, kStages = 2;  // 194 KB
};
template <>
struct Cfg<128, kDkdv, 3> {
  static constexpr int kWG = 2, kCtas = 1, kBN = 32, kSplit = 2, kStages = 2;  // 195 KB
};
// f32 at hd 256: only the statistics kernel takes this geometry (Q's planes
// resident, K's streamed); the gradients run the slab kernels below.
template <>
struct Cfg<256, kDq, 3> {
  static constexpr int kWG = 1, kCtas = 1, kBN = 32, kSplit = 1, kStages = 2;
};

// Row records: the dQ kernel writes each row's m, 1 / l and D (m = 1 / l =
// 0 for a row that sees no key, and for the padding past Sq) as f32 (B * H,
// 3, Sq padded to kRecPad); the dK/dV kernel loads a query tile's with TMA.
constexpr int kRecPad = 128;

__host__ __device__ constexpr int rec_pad(int sq) { return (sq + kRecPad - 1) / kRecPad * kRecPad; }

template <int HD, int K, int kP>
struct Geo {
  using C = Cfg<HD, K, kP>;
  static constexpr int kWG = C::kWG;
  static constexpr int kSplit = C::kSplit;
  static constexpr int kThreads = kWG * 128;
  static constexpr int kR = 64 * kWG / kSplit;           // resident rows of a CTA
  static constexpr int kOD = HD / kSplit;                // accumulator columns of a warpgroup
  static constexpr int kBN = C::kBN;
  static constexpr int kStages = C::kStages;
  static constexpr uint32_t kResBytes = kR * HD * 2;     // one plane of a resident tile
  static constexpr uint32_t kTileBytes = kBN * HD * 2;   // one plane of a streamed tile
  static constexpr uint32_t kChunkR = kR * 128;          // a 64-column chunk of a resident plane
  static constexpr uint32_t kChunkN = kBN * 128;         // ... of a streamed plane
  // A stage: two streamed tiles of kP planes, and in the dK/dV kernel the
  // tile's row records (3 x kBN f32) in a 1024-byte slot that keeps the
  // next stage aligned.
  static constexpr uint32_t kRecBytes = K == kDkdv ? 3 * kBN * 4 : 0;
  static constexpr uint32_t kStageBytes = 2 * kP * kTileBytes + (K == kDkdv ? 1024 : 0);
  static constexpr uint32_t kBarOff = 2 * kP * kResBytes + kStages * kStageBytes;  // full, empty, res
  static constexpr uint32_t kStatOff = kBarOff + 8 * (2 * kStages + 1);
  static constexpr uint32_t kStatBytes = K == kDq ? 3 * kR * 4 : 0;  // dQ: m, 1 / l, D of the resident rows
  // 1024 bytes of slack align the tiles to the 128-byte swizzle's 1024-byte atom.
  static constexpr uint32_t kBytes = 1024 + kStatOff + kStatBytes;
};

// The f32 statistics kernel (width 256 only: below it the bf16x6 forward
// writes the statistics): 64 query rows, Q's planes resident, K's through a
// ring of two.
template <int HD>
struct StatsGeo {
  using G = Geo<HD, kDq, 3>;
  static constexpr int kStages = 2;
  static constexpr uint32_t kStageBytes = 3 * G::kTileBytes;
  static constexpr uint32_t kBarOff = 3 * G::kResBytes + kStages * kStageBytes;
  static constexpr uint32_t kBytes = 1024 + kBarOff + 8 * (2 * kStages + 1);  // 193 KB
};


struct Params {
  const void* o;       // (B, Sq, H, hd), the operands' type (bf16 or f32)
  const void* dout;
  const float* m;      // (B * H * Sq) log2 units
  const float* l;      // (B * H * Sq)
  float* rec;          // (B * H, 3, Sq padded to kRecPad): row records, written by the dQ kernel
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, H, KV, hd;
  int scale_hd;        // the true head dim, for the scale (hd is the width the operands are laid out at)
  int causal, window, q_offset;
  float softcap;
};

// ---------------------------------------------------------------------------
// f32: the row statistics
// ---------------------------------------------------------------------------

// Each row's m and l from S in six bf16 products, as the bf16x6 forward
// forms them below width 256 (online over key tiles [lo, hi) of kBN
// keys): one CTA per (b * H + h, query tile of kR rows).  stats as the
// wgmma forward writes it.
template <int HD, bool kSoftcap>
__global__ void __launch_bounds__(Geo<HD, kDq, 3>::kThreads, 1)
fa_bwd_stats_bf16x6_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                           const Params a, float* __restrict__ stats) {
  using G = Geo<HD, kDq, 3>;
  using SG = StatsGeo<HD>;
  static_assert(G::kSplit == 1, "one warpgroup a row");
  constexpr int kBN = G::kBN, kR = G::kR, kWG = G::kWG, kStages = SG::kStages;
  constexpr int kChunks = HD / 64;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sQ = smem_u32(base);
  const uint32_t sRing = sQ + 3 * G::kResBytes;  // stage st: the K tile's planes
  const uint32_t bars = sQ + SG::kBarOff;        // full[kStages], empty[kStages], res
  const uint32_t resbar = bars + 16 * kStages;

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kR;
  const int nq = min(kR, a.Sq - q0);
  const int n_kv = (a.Skv + kBN - 1) / kBN;
  const int hi = a.causal ? min((a.q_offset + q0 + nq - 1) / kBN + 1, n_kv) : n_kv;
  const int lo = a.window > 0 ? min(max(a.q_offset + q0 - a.window + 1, 0) / kBN, hi - 1) : 0;
  const int n_tiles = hi - lo;  // >= 1

  auto issue_k = [&](int j, int st) {
    const uint32_t sK = sRing + st * SG::kStageBytes;
    const uint32_t full = bars + 8 * st;
    mbar_expect_tx(full, SG::kStageBytes);
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        tma_load(sK + p * G::kTileBytes + c * G::kChunkN, &tk, 64 * c, kvh, (lo + j) * kBN, b + p * a.B, full);
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (kStages + st), kWG);
    }
    mbar_init(resbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(resbar, 3 * G::kResBytes);
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        tma_load(sQ + p * G::kResBytes + c * G::kChunkR, &tq, 64 * c, h, q0, b + p * a.B, resbar);
    for (int j = 0; j < min(kStages, n_tiles); ++j) issue_k(j, j);
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = 64 * wg + 16 * (tid / 32) + lane / 4;
  const int col2 = 2 * (lane % 4);
  const int qa = a.q_offset + q0 + 64 * wg;
  const int qb = qa + 63;
  const float scale = 1.0f / sqrtf(static_cast<float>(a.scale_hd));
  const float scale2 = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float s[kBN / 2];

  mbar_wait(resbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t sK = sRing + st * SG::kStageBytes;
    mbar_wait(bars + 8 * st, (j / kStages) & 1);
    wgmma_fence();
    issue_ss<HD, kBN, G::kChunkR, 3, G::kResBytes, G::kTileBytes>(s, sQ + 64 * 128 * wg, sK);
    if constexpr (kWG > 1) {
      if (threadIdx.x == 0 && j >= 1 && j - 1 + kStages < n_tiles) {
        const int ps = (j - 1) % kStages;
        mbar_wait(bars + 8 * (kStages + ps), ((j - 1) / kStages) & 1);
        issue_k(j - 1 + kStages, ps);
      }
      __syncwarp();
    }
    wgmma_wait<0>();
    pin(s);
    if (tid == 0) mbar_arrive(bars + 8 * (kStages + st));
    if constexpr (kWG == 1) {
      if (threadIdx.x == 0 && j + kStages < n_tiles) issue_k(j + kStages, st);
      __syncwarp();
    }

    const int k0 = (lo + j) * kBN;
    const bool edge = k0 + kBN > a.Skv || (a.causal && k0 + kBN - 1 > qa) || (a.window > 0 && qb - k0 >= a.window);
    uint32_t vis = 0xffffffffu;  // bit x: element x is visible
    if (edge) {
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(a.q_offset + q0 + r0 + 8 * (e >> 1), k0 + 8 * i + col2 + (e & 1), a.Skv, a.causal, a.window))
            vis &= ~(1u << (4 * i + e));
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int x = 0; x < kBN / 2; ++x)
      if ((vis >> x) & 1u) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], logit2<kSoftcap>(s[x], scale2, scale, a.softcap));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      if (m_new != -INFINITY) l[r] *= exp2_approx(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int x = 0; x < kBN / 2; ++x) {
      float dfac;
      if ((vis >> x) & 1u) l[(x >> 1) & 1] += prob<kSoftcap>(s[x], m[(x >> 1) & 1], 1.f, scale2, scale, a.softcap, dfac);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + r0 + 8 * r;
    if (col2 == 0 && row < a.Sq) {
      const size_t at = static_cast<size_t>(bh) * a.Sq + row;
      stats[at] = m[r];
      stats[static_cast<size_t>(gridDim.x) * a.Sq + at] = fmaxf(l[r], 1e-20f);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ (and D): one CTA per (b * H + h, query tile of kR rows)
// ---------------------------------------------------------------------------

template <int HD, bool kSoftcap, int kP>
__global__ void __launch_bounds__(Geo<HD, kDq, kP>::kThreads, Cfg<HD, kDq, kP>::kCtas)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                       const Params a) {
  static_assert(kP == 1 || HD <= 128, "f32 past hd 128 runs the slab kernels");
  using G = Geo<HD, kDq, kP>;
  using T = std::conditional_t<kP == 3, float, __nv_bfloat16>;  // o, dO and the gradients
  constexpr int kBN = G::kBN, kR = G::kR, kOD = G::kOD, kStages = G::kStages, kWG = G::kWG;
  constexpr int kChunks = HD / 64;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sQ = smem_u32(base);            // kP planes kResBytes apart
  const uint32_t sDO = sQ + kP * G::kResBytes;
  const uint32_t sRing = sDO + kP * G::kResBytes;  // stage st: K's planes at sRing + st kStageBytes, V's after them
  const uint32_t bars = sQ + G::kBarOff;           // full[kStages], empty[kStages], res
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
    mbar_expect_tx(full, 2 * kP * G::kTileBytes);
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load(sK + p * G::kTileBytes + c * G::kChunkN, &tk, 64 * c, kvh, (lo + j) * kBN, b + p * a.B, full);
        tma_load(sK + (kP + p) * G::kTileBytes + c * G::kChunkN, &tv, 64 * c, kvh, (lo + j) * kBN, b + p * a.B,
                 full);
      }
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);                  // full: the issuing thread's expect_tx
      mbar_init(bars + 8 * (kStages + st), kWG);     // empty: an arrival per warpgroup
    }
    mbar_init(resbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(resbar, 2 * kP * G::kResBytes);
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load(sQ + p * G::kResBytes + c * G::kChunkR, &tq, 64 * c, h, q0, b + p * a.B, resbar);
        tma_load(sDO + p * G::kResBytes + c * G::kChunkR, &tdo, 64 * c, h, q0, b + p * a.B, resbar);
      }
    for (int j = 0; j < min(kStages, n_tiles); ++j) issue_kv(j, j);
  }

  // D = rowsum(dO o O) for the CTA's rows (kT threads a row, over the true
  // hd columns, in the operands' type); m, 1 / l and D of the rows into
  // shared memory and into the row records for the dK/dV kernel.  A row
  // that sees no key (m = -inf) and a row past Sq get m = 0, 1 / l = 0: p = 0.
  {
    constexpr int kT = G::kThreads / kR;
    constexpr int kCols = HD / kT;
    const int r = threadIdx.x / kT;
    const int part = threadIdx.x % kT;
    const int q = q0 + r;
    const int n = min(kCols, a.hd - part * kCols);  // this thread's columns; <= 0 past hd
    float dd = 0.f;
    if (q < a.Sq && n > 0) {
      const size_t off = ((static_cast<size_t>(b) * a.Sq + q) * a.H + h) * a.hd + part * kCols;
      const T* o = static_cast<const T*>(a.o) + off;
      const T* d = static_cast<const T*>(a.dout) + off;
#pragma unroll 8
      for (int c = 0; c < n; c += 2) {
        const float2 x = load2(o + c);
        const float2 y = load2(d + c);
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
  const float scale = 1.0f / sqrtf(static_cast<float>(a.scale_hd));  // the true head dim's
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
  uint32_t f[kFrag<kP>][kBN / 16][4];
  const uint32_t sQw = sQ + 64 * 128 * rg;
  const uint32_t sDOw = sDO + 64 * 128 * rg;

  mbar_wait(resbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t sK = sRing + st * G::kStageBytes;
    const uint32_t sV = sK + kP * G::kTileBytes;
    mbar_wait(bars + 8 * st, (j / kStages) & 1);
    wgmma_fence();
    issue_ss<HD, kBN, G::kChunkR, kP, G::kResBytes, G::kTileBytes>(s, sQw, sK);
    issue_ss<HD, kBN, G::kChunkR, kP, G::kResBytes, G::kTileBytes>(dp, sDOw, sV);
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
    to_fragments<kBN>(dp, f);
    const uint32_t sKd = sK + dh * (kOD / 64) * G::kChunkN;
    if constexpr (kP == 1) {
      wgmma_fence();
      issue_rs<kBN, kOD, kP, G::kTileBytes>(dq, f, sKd);
      wgmma_wait<0>();
      pin(dq);
      pin(f);
    } else {
      // The tile's dQ terms in a fresh accumulator, added on the CUDA cores.
      float t[kOD / 2];
#pragma unroll
      for (int i = 0; i < kOD / 2; ++i) t[i] = 0.f;
      wgmma_fence();
      issue_rs<kBN, kOD, kP, G::kTileBytes>(t, f, sKd);
      wgmma_wait<0>();
      pin(t);
      pin(f);
#pragma unroll
      for (int i = 0; i < kOD / 2; ++i) dq[i] += t[i];
    }
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
      T* row = static_cast<T*>(a.dq) + ((static_cast<size_t>(b) * a.Sq + q) * a.H + h) * a.hd + kOD * dh + col2;
#pragma unroll
      for (int i = 0; i < kOD / 8; ++i) {
        if (kOD * dh + 8 * i >= a.hd) break;  // the zero-filled columns past hd are not stored
        store2(row + 8 * i, dq[4 * i + 2 * e] * scale, dq[4 * i + 2 * e + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dK and dV: one CTA per (b * KV + kv, key tile of kR rows), summed over the group
// ---------------------------------------------------------------------------

template <int HD, bool kSoftcap, int kP>
__global__ void __launch_bounds__(Geo<HD, kDkdv, kP>::kThreads, Cfg<HD, kDkdv, kP>::kCtas)
fa_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap trec, const Params a) {
  static_assert(kP == 1 || HD <= 128, "f32 past hd 128 runs the slab kernels");
  using G = Geo<HD, kDkdv, kP>;
  using T = std::conditional_t<kP == 3, float, __nv_bfloat16>;
  constexpr int kBN = G::kBN, kR = G::kR, kOD = G::kOD, kStages = G::kStages, kWG = G::kWG;
  constexpr int kChunks = HD / 64;
  constexpr int kF = kFrag<kP>;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sK = smem_u32(base);          // kP planes kResBytes apart
  const uint32_t sV = sK + kP * G::kResBytes;
  const uint32_t sRing = sV + kP * G::kResBytes;  // stage st: Q's planes, dO's, the records
  const uint32_t bars = sK + G::kBarOff;          // full[kStages], empty[kStages], res
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
    mbar_expect_tx(full, 2 * kP * G::kTileBytes + G::kRecBytes);
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load(sQ + p * G::kTileBytes + c * G::kChunkN, &tq, 64 * c, h, q0, b + p * a.B, full);
        tma_load(sQ + (kP + p) * G::kTileBytes + c * G::kChunkN, &tdo, 64 * c, h, q0, b + p * a.B, full);
      }
    tma_load_2d(sQ + 2 * kP * G::kTileBytes, &trec, q0, 3 * (b * a.H + h), full);
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (kStages + st), kWG);
    }
    mbar_init(resbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(resbar, 2 * kP * G::kResBytes);
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load(sK + p * G::kResBytes + c * G::kChunkR, &tk, 64 * c, kvh, k0, b + p * a.B, resbar);
        tma_load(sV + p * G::kResBytes + c * G::kChunkR, &tv, 64 * c, kvh, k0, b + p * a.B, resbar);
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
  const float scale = 1.0f / sqrtf(static_cast<float>(a.scale_hd));  // the true head dim's
  const float scale2 = scale * kLog2e;

  float dk[kOD / 2], dv[kOD / 2];
#pragma unroll
  for (int i = 0; i < kOD / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[kBN / 2], dp[kBN / 2];
  uint32_t pf[kF][kBN / 16][4], df[kF][kBN / 16][4];
  const uint32_t sKw = sK + 64 * 128 * rg;
  const uint32_t sVw = sV + 64 * 128 * rg;

  mbar_wait(resbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const int q0 = (t_lo + t % n_qt) * kBN;
    const uint32_t sQ = sRing + st * G::kStageBytes;
    const uint32_t sDO = sQ + kP * G::kTileBytes;
    const float* sst = reinterpret_cast<const float*>(base + (sQ + 2 * kP * G::kTileBytes - smem_u32(base)));
    mbar_wait(bars + 8 * st, (t / kStages) & 1);
    wgmma_fence();
    issue_ss<HD, kBN, G::kChunkR, kP, G::kResBytes, G::kTileBytes>(s, sKw, sQ);    // S^T = K Q^T
    issue_ss<HD, kBN, G::kChunkR, kP, G::kResBytes, G::kTileBytes>(dp, sVw, sDO);  // dP^T = V dO^T
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
    // so each accumulator register dies as its fragment words are made.
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
        split_into(p[0], p[1], pf, i / 2, 2 * (i % 2) + w);
        split_into(ds[0], ds[1], df, i / 2, 2 * (i % 2) + w);
      }
    }
    const uint32_t col = dh * (kOD / 64) * G::kChunkN;
    if constexpr (kP == 1) {
      wgmma_fence();
      issue_rs<kBN, kOD, kP, G::kTileBytes>(dv, pf, sDO + col);  // dV += P^T dO
      issue_rs<kBN, kOD, kP, G::kTileBytes>(dk, df, sQ + col);   // dK += dS^T Q
      wgmma_wait<0>();
      pin(dk);
      pin(dv);
      pin(pf);
      pin(df);
    } else {
      // Each product's tile terms in a fresh accumulator, added on the CUDA
      // cores; one accumulator for both, in turn, to spare registers.
      float tt[kOD / 2];
#pragma unroll
      for (int i = 0; i < kOD / 2; ++i) tt[i] = 0.f;
      wgmma_fence();
      issue_rs<kBN, kOD, kP, G::kTileBytes>(tt, pf, sDO + col);  // P^T dO
      wgmma_wait<0>();
      pin(tt);
      pin(pf);  // P's fragments may die here, before dS's product
#pragma unroll
      for (int i = 0; i < kOD / 2; ++i) {
        dv[i] += tt[i];
        tt[i] = 0.f;
      }
      wgmma_fence();
      issue_rs<kBN, kOD, kP, G::kTileBytes>(tt, df, sQ + col);   // dS^T Q
      wgmma_wait<0>();
      pin(tt);
      pin(df);
#pragma unroll
      for (int i = 0; i < kOD / 2; ++i) dk[i] += tt[i];
    }
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
      const size_t off = ((static_cast<size_t>(b) * a.Skv + key) * a.KV + kvh) * a.hd + kOD * dh + col2;
#pragma unroll
      for (int i = 0; i < kOD / 8; ++i) {
        if (kOD * dh + 8 * i >= a.hd) break;  // the zero-filled columns past hd are not stored
        store2(static_cast<T*>(a.dk) + off + 8 * i, dk[4 * i + 2 * e] * scale, dk[4 * i + 2 * e + 1] * scale);
        store2(static_cast<T*>(a.dv) + off + 8 * i, dv[4 * i + 2 * e], dv[4 * i + 2 * e + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 at hd 136-256: the slab kernels (run at width 256)
// ---------------------------------------------------------------------------

// Three bf16 planes of a 64-row tile at width 256 take 96 KB, so neither
// gradient kernel can keep its rows' two operands resident beside a ring.
// Both stream every operand in 64-column slabs instead: a stage holds one
// slab (its three planes) of the CTA's 64 rows of two tensors (A1, A2) and
// of a streamed tile's kBN rows of two more (B1, B2).  S and dP are summed
// slab by slab, each slab's six products in a fresh accumulator that the
// CUDA cores add into the tile's f32 sum.  A CTA keeps 128 of the 256
// gradient columns (its slice, blockIdx.z), so each tile's S and dP are
// formed once a slice; a tile's four slabs are streamed with the slice's two
// last, so that they are still in the ring for the gradient products.  One
// warpgroup a CTA, one CTA an SM (220 KB); the warpgroup's thread 0 issues
// every copy, refilling a stage as soon as its products are waited on.
//   dQ:    rows = 64 queries, A1 = Q, A2 = dO; B1 = K, B2 = V (kBN keys);
//          dQ[:, slice] += dS K[:, slice].
//   dK/dV: rows = 64 keys, A1 = K, A2 = V; B1 = Q, B2 = dO (kBN queries)
//          and the tile's row records; dV[:, slice] += P^T dO[:, slice],
//          dK[:, slice] += dS^T Q[:, slice].
struct SlabGeo {
  static constexpr int kHD = 256, kSlabs = kHD / 64, kSliceCols = 128, kSlices = kHD / kSliceCols;
  static constexpr int kBN = 32, kStages = 3, kThreads = 128;
  static constexpr uint32_t kPlaneA = 64 * 128;   // one plane of a 64-row slab
  static constexpr uint32_t kPlaneB = kBN * 128;  // ... of a kBN-row slab
  static constexpr uint32_t kA2 = 3 * kPlaneA;    // A2's planes, after A1's
  static constexpr uint32_t kB1 = 6 * kPlaneA;
  static constexpr uint32_t kB2 = kB1 + 3 * kPlaneB;
  static constexpr uint32_t kRec = kB2 + 3 * kPlaneB;  // dK/dV: the tile's row records (3 x kBN f32)
  static constexpr uint32_t kLoadBytes = 6 * kPlaneA + 6 * kPlaneB;
  static constexpr uint32_t kStageBytes = kRec + 1024;
  static constexpr uint32_t kBarOff = kStages * kStageBytes;  // full[kStages]
  static constexpr uint32_t kStatOff = kBarOff + 8 * kStages;
  static constexpr uint32_t kBytes = 1024 + kStatOff + 3 * 64 * 4;  // 220.8 KB
  static_assert(kSlices == 2 && kSlabs == 4, "the stream order below takes two slices of two slabs");
};

// The slab a tile's stream position takes: the other slice's two first,
// then this slice's.
__device__ __forceinline__ int slab_at(int slice, int pos) { return (2 * slice + 2 + pos) % 4; }

// S (or S^T) and dP (dP^T) of one tile, summed over its four slabs; the
// stages of positions 0 and 1 are refilled once their products are done,
// with stream index n + kStages (issue(n) loads stream index n).
template <typename Issue>
__device__ __forceinline__ void slab_scores(float (&s)[SlabGeo::kBN / 2], float (&dp)[SlabGeo::kBN / 2], int n0,
                                            int total, uint32_t sbase, uint32_t bars, Issue&& issue) {
  using G = SlabGeo;
  constexpr int kN = G::kBN / 2;
  float sp[kN], dpp[kN];
#pragma unroll
  for (int pos = 0; pos < 4; ++pos) {
    const int n = n0 + pos;
    const int st = n % G::kStages;
    const uint32_t sb = sbase + st * G::kStageBytes;
    mbar_wait(bars + 8 * st, (n / G::kStages) & 1);
    wgmma_fence();
    issue_ss<64, G::kBN, G::kPlaneA, 3, G::kPlaneA, G::kPlaneB>(sp, sb, sb + G::kB1);
    issue_ss<64, G::kBN, G::kPlaneA, 3, G::kPlaneA, G::kPlaneB>(dpp, sb + G::kA2, sb + G::kB2);
    wgmma_wait<0>();
    pin(sp);
    pin(dpp);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      s[i] = pos == 0 ? sp[i] : s[i] + sp[i];
      dp[i] = pos == 0 ? dpp[i] : dp[i] + dpp[i];
    }
    if (pos < 2) {
      if (threadIdx.x == 0 && n + G::kStages < total) issue(n + G::kStages);
      __syncwarp();
    }
  }
}

// acc[32 half ..] += the tile's terms of one 64-column slab: a register-A
// fragment over kBN k-rows times B (MN-major at sB), in a fresh accumulator.
__device__ __forceinline__ void slab_product(float (&acc)[64], int half, const uint32_t (&f)[3][SlabGeo::kBN / 16][4],
                                             uint32_t sB) {
  float t[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) t[i] = 0.f;
  wgmma_fence();
  issue_rs<SlabGeo::kBN, 64, 3, SlabGeo::kPlaneB>(t, f, sB);
  wgmma_wait<0>();
  pin(t);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[32 * half + i] += t[i];
}

template <bool kSoftcap>
__global__ void __launch_bounds__(SlabGeo::kThreads, 1)
fa_bwd_dq_slab_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                      const Params a) {
  using G = SlabGeo;
  constexpr int kBN = G::kBN, kStages = G::kStages;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_u32(base);
  const uint32_t bars = sbase + G::kBarOff;
  float* sM = reinterpret_cast<float*>(base + G::kStatOff);  // (64) m, then 1 / l, then D
  float* sIL = sM + 64;
  float* sD = sIL + 64;

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * 64;
  const int nq = min(64, a.Sq - q0);
  const int slice = blockIdx.z;
  const int n_kv = (a.Skv + kBN - 1) / kBN;
  const int hi = a.causal ? min((a.q_offset + q0 + nq - 1) / kBN + 1, n_kv) : n_kv;
  const int lo = a.window > 0 ? min(max(a.q_offset + q0 - a.window + 1, 0) / kBN, hi - 1) : 0;
  const int n_tiles = hi - lo;  // >= 1
  const int total = 4 * n_tiles;

  auto issue = [&](int n) {
    const int st = n % kStages;
    const int c = 64 * slab_at(slice, n % 4);
    const int kr = (lo + n / 4) * kBN;
    const uint32_t sb = sbase + st * G::kStageBytes;
    const uint32_t full = bars + 8 * st;
    mbar_expect_tx(full, G::kLoadBytes);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      tma_load(sb + p * G::kPlaneA, &tq, c, h, q0, b + p * a.B, full);
      tma_load(sb + G::kA2 + p * G::kPlaneA, &tdo, c, h, q0, b + p * a.B, full);
      tma_load(sb + G::kB1 + p * G::kPlaneB, &tk, c, kvh, kr, b + p * a.B, full);
      tma_load(sb + G::kB2 + p * G::kPlaneB, &tv, c, kvh, kr, b + p * a.B, full);
    }
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int n = 0; n < min(kStages, total); ++n) issue(n);
  }

  // D = rowsum(dO o O) for the CTA's 64 rows (two threads a row), m and 1 /
  // l as the dQ kernel forms them; slice 0 writes the row records for the
  // dK/dV kernel.
  {
    constexpr int kCols = G::kHD / 2;
    const int r = threadIdx.x / 2;
    const int part = threadIdx.x % 2;
    const int q = q0 + r;
    const int n = min(kCols, a.hd - part * kCols);
    float dd = 0.f;
    if (q < a.Sq && n > 0) {
      const size_t off = ((static_cast<size_t>(b) * a.Sq + q) * a.H + h) * a.hd + part * kCols;
      const float* o = static_cast<const float*>(a.o) + off;
      const float* d = static_cast<const float*>(a.dout) + off;
#pragma unroll 8
      for (int c = 0; c < n; c += 2) {
        const float2 x = load2(o + c);
        const float2 y = load2(d + c);
        dd = fmaf(x.x, y.x, dd);
        dd = fmaf(x.y, y.y, dd);
      }
    }
    dd += __shfl_xor_sync(0xffffffffu, dd, 1);
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
      if (slice == 0) {
        const int pad = rec_pad(a.Sq);  // q < pad: 64 divides kRecPad
        float* rec = a.rec + static_cast<size_t>(bh) * 3 * pad + q;
        rec[0] = mm;
        rec[pad] = il;
        rec[2 * pad] = dd;
      }
    }
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;
  const int col2 = 2 * (lane % 4);
  const int qa = a.q_offset + q0;
  const int qb = qa + 63;
  const float scale = 1.0f / sqrtf(static_cast<float>(a.scale_hd));
  const float scale2 = scale * kLog2e;
  float rm[2], ril[2], rd[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rm[e] = sM[r0 + 8 * e];
    ril[e] = sIL[r0 + 8 * e];
    rd[e] = sD[r0 + 8 * e];
  }

  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  float s[kBN / 2], dp[kBN / 2];
  uint32_t f[3][kBN / 16][4];

  for (int j = 0; j < n_tiles; ++j) {
    slab_scores(s, dp, 4 * j, total, sbase, bars, issue);
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
        if (edge && !visible(qa + r0 + 8 * r, k0 + 8 * i + col2 + (e & 1), a.Skv, a.causal, a.window)) p = 0.f;
        dp[x] = p * (dp[x] - rd[r]) * dfac;
      }
    to_fragments<kBN>(dp, f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = 4 * j + 2 + half;
      slab_product(dq, half, f, sbase + (n % kStages) * G::kStageBytes + G::kB1);  // dS K[:, slab]
    }
    pin(f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = 4 * j + 2 + half;
      if (threadIdx.x == 0 && n + kStages < total) issue(n + kStages);
      __syncwarp();
    }
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = q0 + r0 + 8 * e;
    if (q < a.Sq) {
      float* row = static_cast<float*>(a.dq) + ((static_cast<size_t>(b) * a.Sq + q) * a.H + h) * a.hd +
                   G::kSliceCols * slice + col2;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (G::kSliceCols * slice + 8 * i >= a.hd) break;  // the zero-filled columns past hd are not stored
        store2(row + 8 * i, dq[4 * i + 2 * e] * scale, dq[4 * i + 2 * e + 1] * scale);
      }
    }
  }
}

template <bool kSoftcap>
__global__ void __launch_bounds__(SlabGeo::kThreads, 1)
fa_bwd_dkdv_slab_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap trec, const Params a) {
  using G = SlabGeo;
  constexpr int kBN = G::kBN, kStages = G::kStages;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_u32(base);
  const uint32_t bars = sbase + G::kBarOff;

  const int b = blockIdx.x / a.KV;
  const int kvh = blockIdx.x % a.KV;
  const int grp = a.H / a.KV;
  const int k0 = blockIdx.y * 64;
  const int nk = min(64, a.Skv - k0);
  const int slice = blockIdx.z;
  // The query rows that see a key of this tile, walked in query tiles of
  // kBN rows for each head of the group, as the dK/dV kernel walks them.
  const int q_begin = a.causal ? max(k0 - a.q_offset, 0) : 0;
  const int q_end = a.window > 0 ? min(a.Sq, k0 + nk - 1 + a.window - a.q_offset) : a.Sq;
  const int t_lo = q_begin / kBN;
  const int n_qt = q_end > q_begin ? (q_end + kBN - 1) / kBN - t_lo : 0;
  const int n_tiles = grp * n_qt;
  const int total = 4 * n_tiles;

  auto issue = [&](int n) {
    const int st = n % kStages;
    const int t = n / 4;
    const int h = kvh * grp + t / n_qt;
    const int q0 = (t_lo + t % n_qt) * kBN;
    const int c = 64 * slab_at(slice, n % 4);
    const uint32_t sb = sbase + st * G::kStageBytes;
    const uint32_t full = bars + 8 * st;
    mbar_expect_tx(full, G::kLoadBytes + 3 * kBN * 4);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      tma_load(sb + p * G::kPlaneA, &tk, c, kvh, k0, b + p * a.B, full);
      tma_load(sb + G::kA2 + p * G::kPlaneA, &tv, c, kvh, k0, b + p * a.B, full);
      tma_load(sb + G::kB1 + p * G::kPlaneB, &tq, c, h, q0, b + p * a.B, full);
      tma_load(sb + G::kB2 + p * G::kPlaneB, &tdo, c, h, q0, b + p * a.B, full);
    }
    tma_load_2d(sb + G::kRec, &trec, q0, 3 * (b * a.H + h), full);
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int n = 0; n < min(kStages, total); ++n) issue(n);
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;
  const int col2 = 2 * (lane % 4);
  const float scale = 1.0f / sqrtf(static_cast<float>(a.scale_hd));
  const float scale2 = scale * kLog2e;

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  float s[kBN / 2], dp[kBN / 2];
  uint32_t pf[3][kBN / 16][4], df[3][kBN / 16][4];

  for (int t = 0; t < n_tiles; ++t) {
    slab_scores(s, dp, 4 * t, total, sbase, bars, issue);  // S^T = K Q^T, dP^T = V dO^T
    const int q0 = (t_lo + t % n_qt) * kBN;
    const int qp0 = a.q_offset + q0;
    const bool edge = k0 + 64 > a.Skv || (a.causal && k0 + 63 > qp0) || (a.window > 0 && qp0 + kBN - 1 - k0 >= a.window);
    const uint32_t s2 = sbase + ((4 * t + 2) % kStages) * G::kStageBytes;  // the slice's first slab
    const uint32_t s3 = sbase + ((4 * t + 3) % kStages) * G::kStageBytes;  // ... and second
    const float* sst = reinterpret_cast<const float*>(base + (s3 + G::kRec - sbase));
    // P^T and dS^T straight into fragments, as the dK/dV kernel forms them.
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
          if (edge && !visible(qp0 + 8 * i + col2 + c, k0 + r0 + 8 * w, a.Skv, a.causal, a.window)) p[c] = 0.f;
          ds[c] = p[c] * (dp[x] - (c ? dd.y : dd.x)) * dfac;
        }
        split_into(p[0], p[1], pf, i / 2, 2 * (i % 2) + w);
        split_into(ds[0], ds[1], df, i / 2, 2 * (i % 2) + w);
      }
    }
    slab_product(dv, 0, pf, s2 + G::kB2);  // P^T dO[:, slab]
    slab_product(dv, 1, pf, s3 + G::kB2);
    pin(pf);
    slab_product(dk, 0, df, s2 + G::kB1);  // dS^T Q[:, slab]
    slab_product(dk, 1, df, s3 + G::kB1);
    pin(df);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = 4 * t + 2 + half;
      if (threadIdx.x == 0 && n + kStages < total) issue(n + kStages);
      __syncwarp();
    }
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = k0 + r0 + 8 * e;
    if (key < a.Skv) {
      const size_t off = ((static_cast<size_t>(b) * a.Skv + key) * a.KV + kvh) * a.hd + G::kSliceCols * slice + col2;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (G::kSliceCols * slice + 8 * i >= a.hd) break;  // the zero-filled columns past hd are not stored
        store2(static_cast<float*>(a.dk) + off + 8 * i, dk[4 * i + 2 * e] * scale, dk[4 * i + 2 * e + 1] * scale);
        store2(static_cast<float*>(a.dv) + off + 8 * i, dv[4 * i + 2 * e], dv[4 * i + 2 * e + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: the launches (tensor maps encoded as wgmma_common.cuh does)
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
  return r == CUDA_SUCCESS ? 0 : refused(r, 2, dims, strides, box, ptr);
}

// q, k, v and dout as the body reads them: the bf16 tensors, or the f32
// ones' bf16 planes (batch b of plane p at batch b + p B).
struct Args {
  const void *q, *k, *v, *dout;
  Params p;
  cudaStream_t stream;
};

// The dQ kernel, then the dK/dV kernel.
template <int HD, int kP>
int launch(const Args& a) {
  EncodeTiled fn;
  if (const int e = tensor_map_encoder(&fn)) return e;
  using Q = Geo<HD, kDq, kP>;
  using KV = Geo<HD, kDkdv, kP>;
  const Params& p = a.p;
  const int nb = kP * p.B;  // the maps' batch extent: every plane
  const int n_q = (p.Sq + Q::kR - 1) / Q::kR;
  const int n_k = (p.Skv + KV::kR - 1) / KV::kR;
  if (n_q > 65535 || n_k > 65535) return kUnsupported;
  const bool cap = p.softcap > 0.f;
  // The dQ kernel: Q and dO resident (kR rows), K and V streamed (kBN); it
  // writes D, which the dK/dV kernel, launched after it, reads.
  CUtensorMap tq, tdo, tk, tv;
  int err = encode(fn, &tq, a.q, nb, p.Sq, p.H, p.hd, Q::kR);
  if (err == 0) err = encode(fn, &tdo, a.dout, nb, p.Sq, p.H, p.hd, Q::kR);
  if (err == 0) err = encode(fn, &tk, a.k, nb, p.Skv, p.KV, p.hd, Q::kBN);
  if (err == 0) err = encode(fn, &tv, a.v, nb, p.Skv, p.KV, p.hd, Q::kBN);
  if (err != 0) return err;
  err = launch_one(cap ? fa_bwd_dq_wgmma_kernel<HD, true, kP> : fa_bwd_dq_wgmma_kernel<HD, false, kP>,
                   dim3(p.B * p.H, n_q), Q::kThreads, Q::kBytes, a.stream, tq, tdo, tk, tv, p);
  if (err != 0) return err;
  // The dK/dV kernel: K and V resident (kR rows), Q, dO and the row
  // records streamed (kBN).
  CUtensorMap trec;
  err = encode(fn, &tq, a.q, nb, p.Sq, p.H, p.hd, KV::kBN);
  if (err == 0) err = encode(fn, &tdo, a.dout, nb, p.Sq, p.H, p.hd, KV::kBN);
  if (err == 0) err = encode(fn, &tk, a.k, nb, p.Skv, p.KV, p.hd, KV::kR);
  if (err == 0) err = encode(fn, &tv, a.v, nb, p.Skv, p.KV, p.hd, KV::kR);
  if (err == 0) err = encode_rec(fn, &trec, p.rec, 3 * p.B * p.H, rec_pad(p.Sq), KV::kBN);
  if (err != 0) return err;
  return launch_one(cap ? fa_bwd_dkdv_wgmma_kernel<HD, true, kP> : fa_bwd_dkdv_wgmma_kernel<HD, false, kP>,
                    dim3(p.B * p.KV, n_k), KV::kThreads, KV::kBytes, a.stream, tq, tdo, tk, tv, trec, p);
}

// The f32 body's scratch, in bytes, 256-byte aligned parts: q, k, v and dO
// as three bf16 planes each, then the statistics (2, B * H * Sq) and the
// row records, f32.
struct Scratch {
  size_t q, k, v, dout, stats, rec, bytes;
};

Scratch scratch_layout(int B, int Sq, int Skv, int H, int KV, int hd) {
  auto up = [](size_t x) { return (x + 255) / 256 * 256; };
  const size_t nq = static_cast<size_t>(B) * Sq * H * hd;
  const size_t nk = static_cast<size_t>(B) * Skv * KV * hd;
  Scratch s{};
  s.q = 0;
  s.k = s.q + up(3 * nq * 2);
  s.v = s.k + up(3 * nk * 2);
  s.dout = s.v + up(3 * nk * 2);
  s.stats = s.dout + up(3 * nq * 2);
  s.rec = s.stats + up(2 * static_cast<size_t>(B) * H * Sq * 4);
  s.bytes = s.rec + up(3 * static_cast<size_t>(B) * H * rec_pad(Sq) * 4);
  return s;
}

// f32 at width 256: the dQ slab kernel (with the row records), then the
// dK/dV slab kernel, each over both 128-column slices.
int launch_slab(const Args& a) {
  using G = SlabGeo;
  EncodeTiled fn;
  if (const int e = tensor_map_encoder(&fn)) return e;
  const Params& p = a.p;
  const int nb = 3 * p.B;
  const int n_q = (p.Sq + 63) / 64;
  const int n_k = (p.Skv + 63) / 64;
  if (n_q > 65535 || n_k > 65535) return kUnsupported;
  const bool cap = p.softcap > 0.f;
  CUtensorMap tq, tdo, tk, tv, trec;
  int err = encode(fn, &tq, a.q, nb, p.Sq, p.H, p.hd, 64);
  if (err == 0) err = encode(fn, &tdo, a.dout, nb, p.Sq, p.H, p.hd, 64);
  if (err == 0) err = encode(fn, &tk, a.k, nb, p.Skv, p.KV, p.hd, G::kBN);
  if (err == 0) err = encode(fn, &tv, a.v, nb, p.Skv, p.KV, p.hd, G::kBN);
  if (err != 0) return err;
  err = launch_one(cap ? fa_bwd_dq_slab_kernel<true> : fa_bwd_dq_slab_kernel<false>, dim3(p.B * p.H, n_q, G::kSlices),
                   G::kThreads, G::kBytes, a.stream, tq, tdo, tk, tv, p);
  if (err != 0) return err;
  err = encode(fn, &tq, a.q, nb, p.Sq, p.H, p.hd, G::kBN);
  if (err == 0) err = encode(fn, &tdo, a.dout, nb, p.Sq, p.H, p.hd, G::kBN);
  if (err == 0) err = encode(fn, &tk, a.k, nb, p.Skv, p.KV, p.hd, 64);
  if (err == 0) err = encode(fn, &tv, a.v, nb, p.Skv, p.KV, p.hd, 64);
  if (err == 0) err = encode_rec(fn, &trec, p.rec, 3 * p.B * p.H, rec_pad(p.Sq), G::kBN);
  if (err != 0) return err;
  return launch_one(cap ? fa_bwd_dkdv_slab_kernel<true> : fa_bwd_dkdv_slab_kernel<false>,
                    dim3(p.B * p.KV, n_k, G::kSlices), G::kThreads, G::kBytes, a.stream, tq, tdo, tk, tv, trec, p);
}

// The f32 body: the split of q, k, v and dO into planes, then the
// gradients: below width 256 on the bf16x6 forward's statistics
// (`fwd_stats`, f32 (2, B * H * Sq)) by launch<HD, 3>, three device kernels
// in all; at width 256 (fwd_stats null) the statistics kernel, then the
// slab kernels, four.
template <int HD>
int launch_f32(const float* q, const float* k, const float* v, const float* dout, const float* fwd_stats,
               uint8_t* scratch, Params p, cudaStream_t stream) {
  EncodeTiled fn;
  if (const int e = tensor_map_encoder(&fn)) return e;
  const Scratch sc = scratch_layout(p.B, p.Sq, p.Skv, p.H, p.KV, p.hd);
  auto* pq = reinterpret_cast<__nv_bfloat16*>(scratch + sc.q);
  auto* pk = reinterpret_cast<__nv_bfloat16*>(scratch + sc.k);
  auto* pv = reinterpret_cast<__nv_bfloat16*>(scratch + sc.v);
  auto* pdo = reinterpret_cast<__nv_bfloat16*>(scratch + sc.dout);
  float* stats = fwd_stats != nullptr ? const_cast<float*>(fwd_stats) : reinterpret_cast<float*>(scratch + sc.stats);
  p.m = stats;
  p.l = stats + static_cast<size_t>(p.B) * p.H * p.Sq;
  p.rec = reinterpret_cast<float*>(scratch + sc.rec);

  const long long nq = static_cast<long long>(p.B) * p.Sq * p.H * p.hd;
  const long long nk = static_cast<long long>(p.B) * p.Skv * p.KV * p.hd;
  int err = launch_split(SplitArgs{{q, k, v, dout}, {pq, pk, pv, pdo}, {nq, nk, nk, nq}}, 4, stream);
  if (err != 0) return err;

  if constexpr (HD == 256) {
    using Q = Geo<HD, kDq, 3>;
    const int n_q = (p.Sq + Q::kR - 1) / Q::kR;
    if (n_q > 65535) return kUnsupported;
    CUtensorMap tq, tk;
    err = encode(fn, &tq, pq, 3 * p.B, p.Sq, p.H, p.hd, Q::kR);
    if (err == 0) err = encode(fn, &tk, pk, 3 * p.B, p.Skv, p.KV, p.hd, Q::kBN);
    if (err != 0) return err;
    err = launch_one(p.softcap > 0.f ? fa_bwd_stats_bf16x6_kernel<HD, true> : fa_bwd_stats_bf16x6_kernel<HD, false>,
                     dim3(p.B * p.H, n_q), Q::kThreads, StatsGeo<HD>::kBytes, stream, tq, tk, p, stats);
    if (err != 0) return err;
    return launch_slab(Args{pq, pk, pv, pdo, p, stream});
  } else {
    return launch<HD, 3>(Args{pq, pk, pv, pdo, p, stream});
  }
}

bool bad_shape(int B, int Sq, int Skv, int H, int KV, int hd, int scale_hd, int q_offset, int window, int max_hd) {
  return B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H <= 0 || H % KV != 0 || q_offset < 0 || window < 0 ||
         B * H > 65535 || hd <= 0 || hd % 8 != 0 || hd > max_hd || scale_hd <= 0 || scale_hd > hd;
}

}  // namespace

// f32 elements of the row-record scratch a bf16 call needs.
extern "C" long long flash_attention_bwd_wgmma_scratch(int B, int H, int Sq) {
  return 3LL * B * H * rec_pad(Sq);
}

// bf16 q, k, v, o, dout and the three gradients, laid out at width hd, a
// multiple of 8 up to 256 (run at the next body width, zero-filled past
// hd); scale_hd <= hd is the true head dim the scale is taken at (hd pads
// it with zero columns); stats is the forward's (2, B * H * Sq) f32 m and
// l, rec f32 scratch of flash_attention_bwd_wgmma_scratch(B, H, Sq)
// elements; q, k, v, dout and rec 16-byte aligned.  Two launches on
// `stream` (dQ with the row records, then dK/dV); no synchronisation, no
// allocation.  Returns 0, a cudaError_t, -1 for arguments the body does not
// take, -2 / -3 when no cuTensorMapEncodeTiled is found / it refuses a map,
// -4 when no context can be made current on the calling thread.
extern "C" int flash_attention_bwd_wgmma_launch(const void* q, const void* k, const void* v, const void* o,
                                                const void* dout, const float* stats, float* rec, void* dq,
                                                void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, int hd,
                                                int scale_hd, int causal, int window, int q_offset, float softcap,
                                                void* stream) {
  if (bad_shape(B, Sq, Skv, H, KV, hd, scale_hd, q_offset, window, 256) || stats == nullptr) return kUnsupported;
  const size_t rows = static_cast<size_t>(B) * H * Sq;
  const Params p{o, dout, stats, stats + rows, rec, dq, dk, dv, B, Sq, Skv, H, KV, hd, scale_hd, causal, window,
                 q_offset, softcap};
  const Args a{q, k, v, dout, p, static_cast<cudaStream_t>(stream)};
  return hd <= 64 ? launch<64, 1>(a) : hd <= 128 ? launch<128, 1>(a) : launch<256, 1>(a);
}

// Bytes of scratch an f32 call needs.
extern "C" long long flash_attention_bwd_bf16x6_scratch(int B, int Sq, int Skv, int H, int KV, int hd) {
  return static_cast<long long>(scratch_layout(B, Sq, Skv, H, KV, hd).bytes);
}

// f32 q, k, v, o, dout and the three gradients at width hd, a multiple of 8
// up to 256 (run at width 64, 128 or 256, zero-filled past hd), scale_hd
// as above; stats the bf16x6 forward's (2, B * H * Sq) f32 m and l up to hd
// 128, null past it (the body forms its own); scratch of
// flash_attention_bwd_bf16x6_scratch(...) bytes, 256-byte aligned; every
// pointer 16-byte aligned.  Three launches on `stream` up to hd 128 (the
// split, dQ with the row records, dK/dV), four past it (the statistics
// after the split; the slab kernels); no synchronisation, no allocation.
// Returns as flash_attention_bwd_wgmma_launch.
extern "C" int flash_attention_bwd_bf16x6_launch(const float* q, const float* k, const float* v, const float* o,
                                                 const float* dout, const float* stats, void* scratch, float* dq,
                                                 float* dk, float* dv, int B, int Sq, int Skv, int H, int KV, int hd,
                                                 int scale_hd, int causal, int window, int q_offset, float softcap,
                                                 void* stream) {
  if (bad_shape(B, Sq, Skv, H, KV, hd, scale_hd, q_offset, window, 256) || (stats != nullptr) != (hd <= 128))
    return kUnsupported;
  const Params p{o, dout, nullptr, nullptr, nullptr, dq, dk, dv, B, Sq, Skv, H, KV, hd, scale_hd, causal, window,
                 q_offset, softcap};
  auto* s = static_cast<uint8_t*>(scratch);
  const auto st = static_cast<cudaStream_t>(stream);
  return hd <= 64    ? launch_f32<64>(q, k, v, dout, stats, s, p, st)
         : hd <= 128 ? launch_f32<128>(q, k, v, dout, stats, s, p, st)
                     : launch_f32<256>(q, k, v, dout, stats, s, p, st);
}

extern "C" const char* flash_attention_bwd_wgmma_error_string(int code) {
  if (code == kUnsupported) return "unsupported shape or dtype";
  if (code == kNoEncoder) return "no cuTensorMapEncodeTiled entry point";
  if (code == kEncodeFailed) return g_encode_msg;
  if (code == kNoContext) return "no CUDA context could be made current on the calling thread";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
