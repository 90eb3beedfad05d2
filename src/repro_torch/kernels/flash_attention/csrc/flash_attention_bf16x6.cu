// Flash attention forward for Hopper (sm_90a) on the bf16 tensor cores at
// f32 accuracy ("bf16x6"): the f32 body of the differentiated path.  When a
// gradient is wanted, dispatch.FlashAttentionFunction runs f32 at head dims
// up to 128 here (a head dim that is not a multiple of 8 zero-filled up to
// one by the wrapper), and the backward (flash_attention_bwd_wgmma.cu, f32
// mode) reads the row statistics it writes instead of forming its own.  A
// forward that wants no gradient (serving) keeps flash_attention_tf32x3.cu.
//
// Replaces the Pallas TPU kernel flash_attention_kernel
// (repro/kernels/flash_attention/kernel.py:106, body _flash_kernel) for f32
// operands on the training path.  It computes
//   out[b, q, h, :] = sum_k p_qk v[b, k, h / G, :] / l_q,
//   x_qk = softcap?(scale * q . k) * log2(e),  scale = 1 / sqrt(scale_hd),
//   m_q = max_k x_qk,  p_qk = exp2(x_qk - m_q),  l_q = max(sum_k p_qk, 1e-20),
// over the keys k < Skv with (causal) k <= q_offset + q and (window > 0)
// q_offset + q - k < window (zeros for a query that sees no key), and
// writes m (log2 units; -inf for a row that sees no key) and l, f32 (2, B
// * H * Sq), row b * H * Sq + h * Sq + q, as the wgmma forward writes them.
//
// Why: the 3xTF32 body keeps ~22 of f32's 24 bits (hi + lo TF32 parts, lo
// lo dropped), and on the training path that error reaches every gradient
// through O and the statistics: the f32 fine-tuning path sat at 3.86x
// naive attention's f32 distance from f64 on its worst gradient leaf.  The
// six-product split (bf16x6.cuh) keeps ~24 bits; its m and l come from the
// backward's own arithmetic, so the backward forms every p exactly as this
// body did and runs no statistics kernel.
//
// Arithmetic: a pre-pass (bf16x6_split_kernel) splits q, k and v into three
// bf16 planes each; S = Q K^T is six bf16 wgmmas (small plane pairs first
// over every k-slab, hi hi last) into a fresh accumulator per tile, exactly
// as the backward's statistics kernel forms it; each p is formed with the
// backward's arithmetic -- one FFMA x = s * scale2 - m without a softcap,
// tanhf(s * scale / softcap) * softcap * log2(e) - m with one, exp2 on the
// SFU -- and m and l stay apart (one lse = m + log2 l would put its rounding
// into every p).  P, formed in f32 registers, is split into three register-A
// fragment planes, and P V is six products into a fresh accumulator that
// the CUDA cores add into O after O moves to the tile's row max (the tensor
// core never adds into a sum many tiles long).  Six products, not three:
// three (hi hi, hi mid, mid hi) drop terms of order 2**-16, ~250x f32's
// error (tests/test_torch_flash_attention_bf16x6_fwd.py shows they miss the
// f32 bar).
//
// Layouts: q, out (B, Sq, H, hd) f32; k, v (B, Skv, KV, hd) f32; query head
// h reads KV head h / (H / KV); the planes (3 B, S, heads, hd) bf16 in
// scratch (plane p of batch b at batch b + p B), read by TMA through
// rank-4 maps whose innermost extent is hd, so a box's columns past hd are
// zero-filled (hd 40 runs at width 64, hd 112 at 128).
//
// Bound: bytes (q, k, v read once, out and the statistics written once)
// over 3.35 TB/s against 4 hd flops a visible (query, key) pair at the
// f32-accurate tensor-core rate, 989 / 6 TFLOP/s (six bf16 products an f32
// one; the same as 3xTF32's 494.7 / 3).  The body issues 24 hd flops a
// pair on the bf16 tensor cores; the split writes 1.5x the operands' f32
// bytes as planes and reads them back.
//
// Design: one CTA per (b * H + h, query tile of kR = 128 rows, heaviest
// causal tiles first), two warpgroups of 64 rows each; Q's three planes
// stay in shared memory, K's and V's come through a TMA ring of kStages
// tiles of kBN keys (hd 64: kBN 64, three stages, 193 KB; hd 128: kBN 32,
// two stages, 193 KB); thread 0 issues every copy and refills a slot once
// both warpgroups have arrived on its empty barrier, one tile late.  Every
// wgmma is issued under control flow that depends on blockIdx alone; only
// tiles that cross the causal diagonal, the window's edge or Skv run the
// per-element mask, and masked entries get p = 0 explicitly.  Registers:
// O (hd / 2), P V's fresh accumulator (hd / 2), S (kBN / 2) and P's three
// fragment planes (3 kBN / 8) a thread, 172 live at hd 128; ptxas gives
// 230 there and 168 at hd 64, no spills, under a 256-thread CTA's 255.

#include <math.h>

#include "wgmma_common.cuh"
#include "bf16x6.cuh"

namespace {

template <int HD>
struct FwdGeo {
  static_assert(HD == 64 || HD == 128, "the bf16x6 forward is built at widths 64 and 128");
  static constexpr int kWG = 2;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kR = 64 * kWG;                    // query rows of a CTA
  static constexpr int kBN = HD == 64 ? 64 : 32;         // keys of a streamed tile
  static constexpr int kStages = HD == 64 ? 3 : 2;
  static constexpr uint32_t kResBytes = kR * HD * 2;     // one plane of the Q tile
  static constexpr uint32_t kTileBytes = kBN * HD * 2;   // one plane of a K or V tile
  static constexpr uint32_t kChunkR = kR * 128;          // a 64-column chunk of a Q plane
  static constexpr uint32_t kChunkN = kBN * 128;         // ... of a K or V plane
  static constexpr uint32_t kStageBytes = 6 * kTileBytes;  // K's three planes, then V's
  static constexpr uint32_t kBarOff = 3 * kResBytes + kStages * kStageBytes;  // full, empty, res
  // 1024 bytes of slack align the tiles to the 128-byte swizzle's 1024-byte atom.
  static constexpr uint32_t kBytes = 1024 + kBarOff + 8 * (2 * kStages + 1);
};

struct FwdParams {
  float* out;          // (B, Sq, H, hd)
  float* stats;        // (2, B * H * Sq): m (log2 units), then l
  int B, Sq, Skv, H, KV, hd;
  int scale_hd;        // the true head dim, for the scale
  int causal, window, q_offset;
  float softcap;
};

template <int HD, bool kSoftcap>
__global__ void __launch_bounds__(FwdGeo<HD>::kThreads, 1)
flash_attention_bf16x6_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv, const FwdParams a) {
  using G = FwdGeo<HD>;
  constexpr int kBN = G::kBN, kR = G::kR, kStages = G::kStages, kWG = G::kWG;
  constexpr int kChunks = HD / 64;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sQ = smem_u32(base);              // three planes kResBytes apart
  const uint32_t sRing = sQ + 3 * G::kResBytes;    // stage st: K's planes, then V's
  const uint32_t bars = sQ + G::kBarOff;           // full[kStages], empty[kStages], res
  const uint32_t resbar = bars + 16 * kStages;

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
  const int n_tiles = hi - lo;  // >= 1: a CTA that sees no key walks one tile, masked whole

  auto issue_kv = [&](int j, int st) {
    const uint32_t sK = sRing + st * G::kStageBytes;
    const uint32_t full = bars + 8 * st;
    mbar_expect_tx(full, G::kStageBytes);
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load(sK + p * G::kTileBytes + c * G::kChunkN, &tk, 64 * c, kvh, (lo + j) * kBN, b + p * a.B, full);
        tma_load(sK + (3 + p) * G::kTileBytes + c * G::kChunkN, &tv, 64 * c, kvh, (lo + j) * kBN, b + p * a.B,
                 full);
      }
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);               // full: the issuing thread's expect_tx
      mbar_init(bars + 8 * (kStages + st), kWG);  // empty: an arrival per warpgroup
    }
    mbar_init(resbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(resbar, 3 * G::kResBytes);
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        tma_load(sQ + p * G::kResBytes + c * G::kChunkR, &tq, 64 * c, h, q0, b + p * a.B, resbar);
    for (int j = 0; j < min(kStages, n_tiles); ++j) issue_kv(j, j);
  }
  __syncthreads();

  // Warpgroup wg: query rows 64 wg .. + 63 of the CTA.  Thread (warp, lane)
  // holds fragment rows r0 and r0 + 8, columns 8 i + col2 + {0, 1} of each
  // 8-column block i.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = 64 * wg + 16 * (tid / 32) + lane / 4;
  const int col2 = 2 * (lane % 4);
  const int qa = a.q_offset + q0 + 64 * wg;  // first query position of the warpgroup
  const int qb = qa + 63;
  const float scale = 1.0f / sqrtf(static_cast<float>(a.scale_hd));  // the true head dim's
  const float scale2 = scale * kLog2e;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's share of the row sum
  float s[kBN / 2];
  uint32_t pf[3][kBN / 16][4];
  const uint32_t sQw = sQ + 64 * 128 * wg;

  mbar_wait(resbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t sK = sRing + st * G::kStageBytes;
    const uint32_t sV = sK + 3 * G::kTileBytes;
    mbar_wait(bars + 8 * st, (j / kStages) & 1);
    wgmma_fence();
    issue_ss<HD, kBN, G::kChunkR, 3, G::kResBytes, G::kTileBytes>(s, sQw, sK);
    // Refill the slot tile j - 1 used, once both warpgroups are done with
    // it: one tile late, so the refilling thread seldom waits.
    if (threadIdx.x == 0 && j >= 1 && j - 1 + kStages < n_tiles) {
      const int ps = (j - 1) % kStages;
      mbar_wait(bars + 8 * (kStages + ps), ((j - 1) / kStages) & 1);
      issue_kv(j - 1 + kStages, ps);
    }
    __syncwarp();
    wgmma_wait<0>();
    pin(s);

    // The online softmax with the backward statistics kernel's arithmetic,
    // element for element: the row max of the visible logits, l moved to
    // it, then p = exp2(x - m) of each visible element (0 for the rest)
    // added into l in the accumulator's order.
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
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = 1.f;
      if (m_new != -INFINITY) {
        corr[r] = exp2_approx(m[r] - m_new);
        l[r] *= corr[r];
      }
      m[r] = m_new;
    }
#pragma unroll
    for (int x = 0; x < kBN / 2; ++x) {
      float dfac;
      const float p = (vis >> x) & 1u ? prob<kSoftcap>(s[x], m[(x >> 1) & 1], 1.f, scale2, scale, a.softcap, dfac)
                                      : 0.f;
      l[(x >> 1) & 1] += p;
      s[x] = p;
    }
    to_fragments<kBN>(s, pf);

    // This tile's P V in a fresh accumulator; O moves to the new row max on
    // the CUDA cores and takes it.
    float t[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) t[i] = 0.f;
    wgmma_fence();
    issue_rs<kBN, HD, 3, G::kTileBytes>(t, pf, sV);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    wgmma_wait<0>();
    pin(t);
    pin(pf);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] += t[i];
    if (tid == 0) mbar_arrive(bars + 8 * (kStages + st));
  }

  // Epilogue: the row sums over the 4 lanes of a row; the statistics; O / l.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-20f);
    const int row = q0 + r0 + 8 * r;
    if (row < a.Sq) {
      if (col2 == 0) {
        const size_t at = static_cast<size_t>(bh) * a.Sq + row;
        a.stats[at] = m[r];
        a.stats[static_cast<size_t>(gridDim.x) * a.Sq + at] = l[r];
      }
      float* orow = a.out + ((static_cast<size_t>(b) * a.Sq + row) * a.H + h) * a.hd + col2;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        if (8 * i >= a.hd) break;  // the zero-filled columns past hd are not stored
        store2(orow + 8 * i, o[4 * i + 2 * r] / l[r], o[4 * i + 2 * r + 1] / l[r]);
      }
    }
  }
}

// The forward's scratch, in bytes, 256-byte aligned parts: q, k and v as
// three bf16 planes each.
struct FwdScratch {
  size_t q, k, v, bytes;
};

FwdScratch fwd_scratch_layout(int B, int Sq, int Skv, int H, int KV, int hd) {
  auto up = [](size_t x) { return (x + 255) / 256 * 256; };
  const size_t nq = static_cast<size_t>(B) * Sq * H * hd;
  const size_t nk = static_cast<size_t>(B) * Skv * KV * hd;
  FwdScratch s{};
  s.q = 0;
  s.k = s.q + up(3 * nq * 2);
  s.v = s.k + up(3 * nk * 2);
  s.bytes = s.v + up(3 * nk * 2);
  return s;
}

// The split of q, k and v into planes, then the attention kernel.
template <int HD>
int launch_fwd(const float* q, const float* k, const float* v, uint8_t* scratch, const FwdParams& p,
               cudaStream_t stream) {
  using G = FwdGeo<HD>;
  EncodeTiled fn;
  if (const int e = tensor_map_encoder(&fn)) return e;
  const FwdScratch sc = fwd_scratch_layout(p.B, p.Sq, p.Skv, p.H, p.KV, p.hd);
  auto* pq = reinterpret_cast<__nv_bfloat16*>(scratch + sc.q);
  auto* pk = reinterpret_cast<__nv_bfloat16*>(scratch + sc.k);
  auto* pv = reinterpret_cast<__nv_bfloat16*>(scratch + sc.v);
  const long long nq = static_cast<long long>(p.B) * p.Sq * p.H * p.hd;
  const long long nk = static_cast<long long>(p.B) * p.Skv * p.KV * p.hd;
  int err = launch_split(SplitArgs{{q, k, v, nullptr}, {pq, pk, pv, nullptr}, {nq, nk, nk, 0}}, 3, stream);
  if (err != 0) return err;
  const int n_q = (p.Sq + G::kR - 1) / G::kR;
  if (n_q > 65535) return kUnsupported;
  CUtensorMap tq, tk, tv;
  err = encode(fn, &tq, pq, 3 * p.B, p.Sq, p.H, p.hd, G::kR);
  if (err == 0) err = encode(fn, &tk, pk, 3 * p.B, p.Skv, p.KV, p.hd, G::kBN);
  if (err == 0) err = encode(fn, &tv, pv, 3 * p.B, p.Skv, p.KV, p.hd, G::kBN);
  if (err != 0) return err;
  return launch_one(p.softcap > 0.f ? flash_attention_bf16x6_kernel<HD, true> : flash_attention_bf16x6_kernel<HD, false>,
                    dim3(p.B * p.H, n_q), G::kThreads, G::kBytes, stream, tq, tk, tv, p);
}

}  // namespace

// Bytes of scratch a call needs.
extern "C" long long flash_attention_bf16x6_scratch(int B, int Sq, int Skv, int H, int KV, int hd) {
  return static_cast<long long>(fwd_scratch_layout(B, Sq, Skv, H, KV, hd).bytes);
}

// f32 q, k, v, out at width hd, a multiple of 8 up to 128 (run at width 64
// or 128, zero-filled past hd); scale_hd <= hd is the true head dim the
// scale is taken at (hd pads it with zero columns); stats f32 (2, B * H *
// Sq) for each row's m and l (required); scratch of
// flash_attention_bf16x6_scratch(...) bytes, 256-byte aligned; every pointer
// 16-byte aligned.  Two launches on `stream` (the split, the attention); no
// synchronisation, no allocation.  Returns 0, a cudaError_t, -1 for
// arguments the body does not take, -2 / -3 when no cuTensorMapEncodeTiled
// is found / it refuses a map, -4 when no context can be made current on
// the calling thread.
extern "C" int flash_attention_bf16x6_launch(const float* q, const float* k, const float* v, float* out,
                                             float* stats, void* scratch, int B, int Sq, int Skv, int H, int KV,
                                             int hd, int scale_hd, int causal, int window, int q_offset,
                                             float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H <= 0 || H % KV != 0 || q_offset < 0 || window < 0 ||
      B * H > 65535 || hd <= 0 || hd % 8 != 0 || hd > 128 || scale_hd <= 0 || scale_hd > hd || stats == nullptr)
    return kUnsupported;
  const FwdParams p{out, stats, B, Sq, Skv, H, KV, hd, scale_hd, causal, window, q_offset, softcap};
  auto* s = static_cast<uint8_t*>(scratch);
  const auto st = static_cast<cudaStream_t>(stream);
  return hd <= 64 ? launch_fwd<64>(q, k, v, s, p, st) : launch_fwd<128>(q, k, v, s, p, st);
}

extern "C" const char* flash_attention_bf16x6_error_string(int code) {
  if (code == kUnsupported) return "unsupported shape or dtype";
  if (code == kNoEncoder) return "no cuTensorMapEncodeTiled entry point";
  if (code == kEncodeFailed) return g_encode_msg;
  if (code == kNoContext) return "no CUDA context could be made current on the calling thread";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
