// Flash attention forward for Hopper (sm_90a) on the tensor cores: the bf16
// body of the long-prompt prefill (hd 64, 128 and 256).
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
//     a lane's two neighbouring columns at a time.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kUnsupported = -1;
constexpr int kNoEncoder = -2;     // no cuTensorMapEncodeTiled entry point
constexpr int kEncodeFailed = -3;  // cuTensorMapEncodeTiled refused a tensor map
// A wait on a barrier that never completes would hang the card; past this
// many cycles (seconds) the kernel traps instead, and the launch reports it.
constexpr long long kHangCycles = 20000000000LL;
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the phase of parity `parity` to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

// One TMA box of a rank-4 map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands: SBO
// = 1024 bytes between 8-row groups, LBO unused (1).  MN-major (V): LBO =
// bytes between 64-column chunks, SBO = 1024 bytes between 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous window between issue and wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16.  ss (S = Q K^T, N 64): A
// and B from shared memory, both K-major (scale_d 0 overwrites the
// accumulator).  rs (O += P V, N 64 or 128): A from registers, B MN-major
// from shared memory (transpose bit set), accumulating.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
struct Wgmma;
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int s) { wgmma_ss_n64(d, a, b, s); }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n64(d, a, b); }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n128(d, a, b); }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

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

template <int HD, bool kSoftcap>
__global__ void __launch_bounds__(Smem<HD>::kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out, int Sq,
                             int Skv, int H, int KV, int causal, int window, int q_offset, float softcap) {
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
    const float scale = 1.0f / sqrtf(static_cast<float>(HD));
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
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < Sq) {
        __nv_bfloat16* orow = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * HD + kOD * dh + col2;
#pragma unroll
        for (int i = 0; i < kOD / 8; ++i) {
          const __nv_bfloat162 v2 =
              __floats2bfloat162_rn(o[4 * i + 2 * r] / l[r], o[4 * i + 2 * r + 1] / l[r]);
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) = v2;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps encoded through cudaGetDriverEntryPointByVersion
// (the library links only the CUDA runtime), then the launch.
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return (err == cudaSuccess && status == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                         : nullptr;
  }();
  return fn;
}

// (B, S, heads, hd) bf16, boxes of 64 columns x 1 head x `rows` positions.
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B, int S, int heads, int hd, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2, static_cast<cuuint64_t>(heads) * hd * 2,
                                 static_cast<cuuint64_t>(S) * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Sq, Skv, H, KV, causal, window, q_offset;
  float softcap;
  cudaStream_t stream;
};

template <int HD>
int launch(const Args& a) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  constexpr int kBQ = Smem<HD>::kBQ;
  CUtensorMap tq, tk, tv;
  int err = encode(fn, &tq, a.q, a.B, a.Sq, a.H, HD, kBQ);
  if (err == 0) err = encode(fn, &tk, a.k, a.B, a.Skv, a.KV, HD, kBKV);
  if (err == 0) err = encode(fn, &tv, a.v, a.B, a.Skv, a.KV, HD, kBKV);
  if (err != 0) return err;
  const int n_qt = (a.Sq + kBQ - 1) / kBQ;
  if (n_qt > 65535) return kUnsupported;
  auto* kernel = a.softcap > 0.f ? flash_attention_wgmma_kernel<HD, true> : flash_attention_wgmma_kernel<HD, false>;
  cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(Smem<HD>::kBytes));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid(a.B * a.H, n_qt);
  kernel<<<grid, Smem<HD>::kThreads, Smem<HD>::kBytes, a.stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.out), a.Sq, a.Skv, a.H, a.KV, a.causal, a.window, a.q_offset,
      a.softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v, out; hd 64, 128 or 256; every pointer 16-byte aligned.
// Returns 0, a cudaError_t from the launch, -1 for arguments the body does
// not take, -2 / -3 when no cuTensorMapEncodeTiled is found / it refuses a
// map.  Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                                            int Skv, int H, int KV, int hd, int causal, int window, int q_offset,
                                            float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H <= 0 || H % KV != 0 || q_offset < 0 || window < 0)
    return kUnsupported;
  const Args a{q, k, v, out, B, Sq, Skv, H, KV, causal, window, q_offset, softcap,
               static_cast<cudaStream_t>(stream)};
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

extern "C" const char* flash_attention_wgmma_error_string(int code) {
  if (code == kUnsupported) return "unsupported shape or dtype";
  if (code == kNoEncoder) return "no cuTensorMapEncodeTiled entry point";
  if (code == kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
