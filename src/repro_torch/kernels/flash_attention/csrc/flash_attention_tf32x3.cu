// Flash attention forward for Hopper (sm_90a) on the tensor cores at f32
// accuracy: the f32 body of the long-prompt prefill, for head dims that are
// multiples of 8 up to 256 (cuda_kernel.body_for picks it; bf16 at hd 64 /
// 128 / 256 takes flash_attention_wgmma.cu, the rest flash_attention.cu).
//
// Replaces the Pallas TPU kernel flash_attention_kernel
// (repro/kernels/flash_attention/kernel.py:106, body _flash_kernel) for f32
// operands.  It computes
//   out[b, q, h, :] = sum_k softmax_k(s_qk) v[b, k, h / G, :],
//   s_qk = softcap?(q . k / sqrt(hd)),
// over the keys k < Skv with (causal) k <= q_offset + q and (window > 0)
// q_offset + q - k < window, and out = acc / max(l, 1e-20) (zeros for a
// query that sees no key).
//
// Layouts (contiguous, the model's native ones, read in place):
//   q, out   (B, Sq, H, hd)    f32, 16-byte aligned
//   k, v     (B, Skv, KV, hd)  f32; query head h reads KV head h / (H / KV)
//
// Arithmetic: error-compensated TF32 (3xTF32).  One TF32 product keeps 11
// significant bits of each operand, which misses the f32 bar (atol 2e-5) by
// ~50x.  Every f32 operand is split as hi = rna_tf32(x), lo =
// rna_tf32(x - hi), and each product a * b runs as three tensor-core
// products lo_a hi_b + hi_a lo_b + hi_a hi_b, accumulated in f32: only the
// lo * lo term (~2**-22 relative) is dropped, so the error stays that of
// plain f32 (~7e-7 at the long prefill's shape, against ~1e-3 for one TF32
// product).  Both S = Q K^T and O += P V take it; P is split like any other
// operand.
//
// Bound: bytes or f32-accurate tensor-core operations, whichever is larger:
// q, k, v read once and out written once over 3.35 TB/s, against 4 * hd
// flops per visible (query, key) pair over the 3xTF32 rate (494.7 / 3
// TFLOP/s).  At the long prefill's shape (B 2, H 16, hd 64, S 1000, causal)
// that is 24.9 us of operations against 9.78 us of bytes.  The CUDA-core
// body ran these products as scalar f32 FMAs fed from shared memory.
//
// Design (mma.sync, not wgmma: wgmma takes tf32 operands K-major only, and
// V (keys, hd) is MN-major in the P V product):
//   * a CTA of 4 warps (8 at hd 256) covers (b * H + h, a query tile); each
//     warp owns 16 query rows, whose S and O fragments it keeps in
//     registers (mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32); query tiles
//     are launched heaviest causal work first (grid y reversed);
//   * K/V tiles (32 keys at hd <= 64, 16 above) go through a ring of two
//     stages in shared memory (one at hd 256, whose 8 warps keep the SM
//     busy instead), filled by cp.async 16 bytes a thread, rows past Sq or
//     Skv zero-filled; the next tile loads while the current one is
//     multiplied.  cp.async, not TMA, because the tiles are laid out for
//     the fragments, not as boxes of the tensor;
//   * K and V are split once a tile, not once a warp: each thread waits
//     for its own chunks of the next tile, splits them into the layout the
//     fragments read -- K row n as [hi, hi, lo, lo] of each column pair,
//     V row pair p as [hi, hi, lo, lo] of each column -- in place (a
//     thread's raw chunks land inside what it writes), and one barrier a
//     tile publishes the split tile and retires the one before it.  So
//     every B fragment of both terms is one conflict-free 16-byte read.
//     A thread reads all its chunks before it writes any back, or the
//     compiler, unable to rule out aliasing, serialises the round trips;
//   * the rounding is integer arithmetic on the bits ((x + 0x1000) &
//     ~0x1fff, cvt.rna.tf32.f32's result), at the integer rate rather than
//     the conversion unit's; at hd 64 Q's split fragments stay in registers
//     for the whole sweep, above it Q is read (8 bytes a lane) and split
//     every tile; P is split in registers;
//   * the reduction axes are permuted so that no fragment is shuffled: in
//     Q K^T, A's columns t and t + 4 of k-step kk hold head dims 8 kk + 2t
//     and 8 kk + 2t + 1; in P V, they hold keys 2t and 2t + 1, which is
//     where S's accumulator layout already has them, so P goes from the S
//     fragment to the A fragment in registers, and V's B fragment holds
//     rows 2t and 2t + 1 (one row pair);
//   * S's small terms accumulate apart from hi * hi and are added at the
//     end of the tile, which shortens the chains of dependent products;
//   * mask, softcap and the online softmax on the fragment in registers, as
//     flash_attention.cu computes them (scale, tanh cap, expf): a row's max
//     reduces over the 4 lanes that share it, the sum stays a per-lane part
//     until the epilogue.  Only tiles that cross Skv, the causal diagonal
//     or the window's edge for the warp's rows run the per-element mask;
//     a masked entry contributes p = 0 explicitly, never exp(NEG_INF -
//     NEG_INF) = 1.  The CTA walks only the KV tiles [lo, hi) its rows can
//     see, clipped as kernel.py:53-62 clips them;
//   * the epilogue divides by max(l, 1e-20) and stores a lane's two
//     neighbouring columns at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnsupported = -1;
constexpr float kNegInf = -1.0e30f;

// The tile configuration of a head-dim bucket (HDMAX bounds the O fragment;
// hd <= HDMAX is a runtime value):
//   kWarps      warps of a CTA, 16 query rows each (kBQ = 16 kWarps rows);
//   kBKV        keys of a K/V tile;
//   kStages     K/V tiles in shared memory (2: the next one loads while the
//               current one is multiplied);
//   kMinBlocks  CTAs an SM, as shared memory and registers allow;
//   kQRegs      Q's split fragments live in registers for the whole sweep
//               (else Q is read and split from shared memory every tile).
// Chosen by timing variants at the long prefill's shape on the H100: a
// register cap that would fit a third CTA an SM made the body spill and run
// slower; at hd 256 two stages leave room for one 4-warp CTA an SM, so it
// takes 8 warps and one stage instead.
template <int HDMAX>
struct Cfg;
template <>
struct Cfg<64> {
  static constexpr int kWarps = 4, kBKV = 32, kStages = 2, kMinBlocks = 2;
  static constexpr bool kQRegs = true;
};
template <>
struct Cfg<128> {
  static constexpr int kWarps = 4, kBKV = 16, kStages = 2, kMinBlocks = 2;
  static constexpr bool kQRegs = false;
};
template <>
struct Cfg<256> {
  static constexpr int kWarps = 8, kBKV = 16, kStages = 1, kMinBlocks = 1;
  static constexpr bool kQRegs = false;
};

// Shared-memory layouts (strides in floats), each read by one 8- or
// 16-byte load a lane with no bank conflict:
//   Q  (kBQ, ld_q) raw: rows g and columns 2t, 2t + 1 (8 bytes a lane; a
//      half warp spans all 32 banks when ld_q = 8 mod 32);
//   K  (kBKV, ld_k): row n holds, for each column pair m, [hi(2m),
//      hi(2m + 1), lo(2m), lo(2m + 1)] at 4m, so one 16-byte load gives a
//      lane both B registers of both terms (a quarter warp: rows g, g + 1,
//      pairs 4 kk + t; ld_k = 16 mod 32);
//   V  (kBKV / 2, ld_v): row pair p holds, for each column n, [hi(2p, n),
//      hi(2p + 1, n), lo(2p, n), lo(2p + 1, n)] at 4n, so one 16-byte load
//      gives the P V product's B registers, rows 2t and 2t + 1 of k-step jj
//      (pair 4 jj + t), column 8 dt + g (ld_v = 8 mod 32).
__host__ __device__ __forceinline__ int padded(int hd) { return (hd + 31) / 32 * 32; }
__host__ __device__ __forceinline__ int ld_q(int hd) { return padded(hd) + 8; }
__host__ __device__ __forceinline__ int ld_k(int hd) { return 2 * padded(hd) + 16; }
__host__ __device__ __forceinline__ int ld_v(int hd) { return 4 * padded(hd) + 8; }

// kStages stages of (K, V), each holding hi and lo, then Q's tile.
__host__ __device__ __forceinline__ int stage_floats(int bkv, int hd) { return bkv * ld_k(hd) + bkv / 2 * ld_v(hd); }
template <int HDMAX>
size_t smem_bytes(int hd) {
  using C = Cfg<HDMAX>;
  return sizeof(float) *
         (static_cast<size_t>(C::kStages) * stage_floats(C::kBKV, hd) + static_cast<size_t>(16 * C::kWarps) * ld_q(hd));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zero-filled when
// !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero: cvt.rna.tf32.f32's bits, in two integer operations.
__device__ __forceinline__ uint32_t rna_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }
// x = hi + lo + O(2**-22 x), hi and lo TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}
// The A fragment of Q's k-step kk for rows r0, r0 + 8 (head dims 8 kk + 2t,
// + 1), split.
__device__ __forceinline__ void q_fragment(const float* sQ, int ldq, int r0, int kk, int t, uint32_t (&a_hi)[4],
                                           uint32_t (&a_lo)[4]) {
  const float2 qr0 = *reinterpret_cast<const float2*>(sQ + r0 * ldq + 8 * kk + 2 * t);
  const float2 qr8 = *reinterpret_cast<const float2*>(sQ + (r0 + 8) * ldq + 8 * kk + 2 * t);
  split(qr0.x, a_hi[0], a_lo[0]);
  split(qr8.x, a_hi[1], a_lo[1]);
  split(qr0.y, a_hi[2], a_lo[2]);
  split(qr8.y, a_hi[3], a_lo[3]);
}

// d += a b, one m16n8k8 TF32 product accumulated in f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int HDMAX>
__global__ void __launch_bounds__(32 * Cfg<HDMAX>::kWarps, Cfg<HDMAX>::kMinBlocks)
flash_attention_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                              float* __restrict__ out, int Sq, int Skv, int H, int KV, int hd, int scale_hd,
                              int causal, int window, int q_offset, float softcap) {
  using C = Cfg<HDMAX>;
  constexpr int kThreads = 32 * C::kWarps;
  constexpr int kBQ = 16 * C::kWarps;   // query rows of a CTA
  constexpr int kBKV = C::kBKV;
  constexpr int kNT = kBKV / 8;         // 8-key column blocks of S (and k-steps of P V)
  // A thread moves at most kPerK 16-byte chunks of a K tile and kPerV
  // chunks of a V tile's row pairs (two rows each).
  constexpr int kPerK = kBKV * HDMAX / 4 / kThreads;
  constexpr int kPerV = kPerK / 2;
  static_assert(kBKV / 2 * HDMAX / 4 % kThreads == 0, "a tile's chunks must spread evenly over the threads");
  constexpr int kDT = HDMAX / 8;        // 8-column blocks of O (and k-steps of Q K^T)
  extern __shared__ __align__(16) float smem[];
  const int ldq = ld_q(hd);
  const int ldk = ld_k(hd);
  const int ldv = ld_v(hd);
  const int v_at = kBKV * ldk;          // V after K in a stage
  const int stage = stage_floats(kBKV, hd);
  float* sKV = smem;                    // stage st at sKV + st * stage: K (kBKV, ldk), V (kBKV / 2, ldv)
  float* sQ = sKV + C::kStages * stage;  // (kBQ, ldq), raw f32

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;              // fragment row (and B column) of this lane
  const int t = lane & 3;               // fragment column pair of this lane
  const int bh = blockIdx.x;            // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kBQ;
  const int nq = min(kBQ, Sq - q0);
  const int chunks = hd / 4;            // 16-byte pieces of a row
  const float scale = 1.0f / sqrtf(static_cast<float>(scale_hd));  // the true head dim's

  for (int i = tid; i < kBQ * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = i % chunks;
    const bool ok = r < nq;
    cp_async16(smem_u32(sQ + r * ldq + 4 * c),
               q + ((static_cast<size_t>(b) * Sq + q0 + (ok ? r : 0)) * H + h) * hd + 4 * c, ok);
  }

  // The KV tiles any query of this CTA can see: [lo, hi).
  const int n_kv = (Skv + kBKV - 1) / kBKV;
  const int hi = causal ? min((q_offset + q0 + nq - 1) / kBKV + 1, n_kv) : n_kv;
  const int lo = window > 0 ? max(q_offset + q0 - window + 1, 0) / kBKV : 0;

  // A thread loads, and later splits, the same chunks of every tile: K
  // row kr[u], columns kc[u] .. + 3, landing in the first half of the 32
  // bytes their split takes (K row kr[u] at 2 kc[u]); V rows 2 vp[u] and
  // 2 vp[u] + 1, columns vc[u] .. + 3, landing in the first half of the 64
  // bytes their split takes (V row pair vp[u] at 4 vc[u]).  A thread's raw
  // chunks lie inside what it writes, so it splits them with no barrier.
  // -1: no chunk at this hd.
  int kr[kPerK], kc[kPerK], vp[kPerV], vc[kPerV];
#pragma unroll
  for (int u = 0; u < kPerK; ++u) {
    const int i = tid + u * kThreads;
    kr[u] = i < kBKV * chunks ? i / chunks : -1;
    kc[u] = 4 * (i % chunks);
  }
#pragma unroll
  for (int u = 0; u < kPerV; ++u) {
    const int i = tid + u * kThreads;
    vp[u] = i < kBKV / 2 * chunks ? i / chunks : -1;
    vc[u] = 4 * (i % chunks);
  }
  auto load_kv = [&](int j, int st) {
    const int k0 = j * kBKV;
    float* sK = sKV + st * stage;
    float* sV = sK + v_at;
    // Rows past Skv are zeros: masked to p = 0, and 0 * 0 adds nothing.
    auto src = [&](int row, int col) {
      return ((static_cast<size_t>(b) * Skv + (row < Skv ? row : 0)) * KV + kvh) * hd + col;
    };
#pragma unroll
    for (int u = 0; u < kPerK; ++u)
      if (kr[u] >= 0) cp_async16(smem_u32(sK + kr[u] * ldk + 2 * kc[u]), k + src(k0 + kr[u], kc[u]), k0 + kr[u] < Skv);
#pragma unroll
    for (int u = 0; u < kPerV; ++u) {
      if (vp[u] >= 0) {
        const int r = k0 + 2 * vp[u];
        float* dst = sV + vp[u] * ldv + 4 * vc[u];
        cp_async16(smem_u32(dst), v + src(r, vc[u]), r < Skv);
        cp_async16(smem_u32(dst + 4), v + src(r + 1, vc[u]), r + 1 < Skv);
      }
    }
    cp_async_commit();
  };
  // All of the thread's chunks are read before any is written back, so the
  // reads overlap (a write may alias a later read as far as the compiler
  // knows, and would otherwise serialise them).
  auto split_kv = [&](int st) {
    float* sK = sKV + st * stage;
    float* sV = sK + v_at;
    float4 xk[kPerK], xv[kPerV][2];
#pragma unroll
    for (int u = 0; u < kPerK; ++u)
      if (kr[u] >= 0) xk[u] = *reinterpret_cast<const float4*>(sK + kr[u] * ldk + 2 * kc[u]);
#pragma unroll
    for (int u = 0; u < kPerV; ++u) {
      if (vp[u] >= 0) {
        xv[u][0] = *reinterpret_cast<const float4*>(sV + vp[u] * ldv + 4 * vc[u]);
        xv[u][1] = *reinterpret_cast<const float4*>(sV + vp[u] * ldv + 4 * vc[u] + 4);
      }
    }
#pragma unroll
    for (int u = 0; u < kPerK; ++u) {
      if (kr[u] >= 0) {
        uint4 h, l;
        split4(xk[u], h, l);
        uint4* dst = reinterpret_cast<uint4*>(sK + kr[u] * ldk + 2 * kc[u]);
        dst[0] = make_uint4(h.x, h.y, l.x, l.y);
        dst[1] = make_uint4(h.z, h.w, l.z, l.w);
      }
    }
#pragma unroll
    for (int u = 0; u < kPerV; ++u) {
      if (vp[u] >= 0) {
        uint4 h0, l0, h1, l1;  // rows 2 vp and 2 vp + 1
        split4(xv[u][0], h0, l0);
        split4(xv[u][1], h1, l1);
        uint4* dst = reinterpret_cast<uint4*>(sV + vp[u] * ldv + 4 * vc[u]);
        dst[0] = make_uint4(h0.x, h1.x, l0.x, l1.x);
        dst[1] = make_uint4(h0.y, h1.y, l0.y, l1.y);
        dst[2] = make_uint4(h0.z, h1.z, l0.z, l1.z);
        dst[3] = make_uint4(h0.w, h1.w, l0.w, l1.w);
      }
    }
  };

  // Warp `warp` owns tile rows r0 = 16 warp + g and r0 + 8 of every fragment.
  const int r0 = 16 * warp + g;
  const int qa = q_offset + q0 + 16 * warp;  // first query position of the warp's rows
  const int qp0 = q_offset + q0 + r0;        // this lane's two query positions: qp0, qp0 + 8
  float o[kDT][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};                   // this lane's share of the row sums
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

  if (lo < hi) load_kv(lo, 0);
  cp_async_commit();
  cp_async_wait_all();                       // this thread's chunks of Q and of tile lo
  if (lo < hi) split_kv(0);
  constexpr int kQR = C::kQRegs ? kDT : 1;
  uint32_t q_hi[kQR][4];
  uint32_t q_lo[kQR][4];
  if constexpr (C::kQRegs) {
    __syncthreads();                         // Q's rows were loaded by every thread
#pragma unroll
    for (int kk = 0; kk < kDT; ++kk)
      if (8 * kk < hd) q_fragment(sQ, ldq, r0, kk, t, q_hi[kk], q_lo[kk]);
  }
  for (int j = lo; j < hi; ++j) {
    const int st = C::kStages == 2 ? (j - lo) & 1 : 0;
    // Every thread has split its chunks of tile j, and (two stages) no warp
    // still reads the stage tile j + 1 goes to.
    __syncthreads();
    if (C::kStages == 2 && j + 1 < hi) load_kv(j + 1, st ^ 1);
    const float* sK = sKV + st * stage;
    const float* sV = sK + v_at;
    const int k0 = j * kBKV;

    // S = Q K^T.  k-step kk: A column t holds head dim 8 kk + 2t, column
    // t + 4 head dim 8 kk + 2t + 1, and B's rows t and t + 4 the same.
    // The small terms go to an accumulator of their own, added to the big
    // one at the end, which shortens the chains of dependent products.
    float s[kNT][4];
    float s_sm[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = s_sm[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDT; ++kk) {
      if (8 * kk < hd) {
        uint32_t a_hi[4], a_lo[4];
        if constexpr (C::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a_hi[e] = q_hi[kk][e];
            a_lo[e] = q_lo[kk][e];
          }
        } else {
          q_fragment(sQ, ldq, r0, kk, t, a_hi, a_lo);
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          // (hi, hi, lo, lo) of key 8 nt + g, head dims 8 kk + 2t and + 1.
          const uint4 kb = *reinterpret_cast<const uint4*>(sK + (8 * nt + g) * ldk + 16 * kk + 4 * t);
          mma_tf32(s_sm[nt], a_lo, kb.x, kb.y);
          mma_tf32(s_sm[nt], a_hi, kb.z, kb.w);
          mma_tf32(s[nt], a_hi, kb.x, kb.y);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += s_sm[nt][e];

    // Scale and softcap, then the mask on edge tiles only: those crossing
    // Skv, the causal diagonal or the window's edge for the warp's rows.
    // Entry (nt, e) is row r0 + 8 (e >> 1), key k0 + 8 nt + 2t + (e & 1).
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[nt][e] = x;
      }
    uint32_t ok_bits = 0xffffffffu;   // bit 4 nt + e: entry (nt, e) is visible
    const bool edge = k0 + kBKV > Skv || (causal && k0 + kBKV - 1 > qa) || (window > 0 && qa + 15 - k0 >= window);
    if (edge) {
      ok_bits = 0u;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * nt + 2 * t + (e & 1);
          const int qp = qp0 + 8 * (e >> 1);
          const bool ok = kp < Skv && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
          ok_bits |= static_cast<uint32_t>(ok) << (4 * nt + e);
          if (!ok) s[nt][e] = kNegInf;
        }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    float m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
      const float corr = expf(m[r] - m_new[r]);
      m[r] = m_new[r];
      l[r] *= corr;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        o[dt][2 * r] *= corr;
        o[dt][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (ok_bits >> (4 * nt + e)) & 1u ? expf(s[nt][e] - m_new[e >> 1]) : 0.f;
        l[e >> 1] += p;
        s[nt][e] = p;
      }

    // O += P V.  k-step jj: A column t holds key 8 jj + 2t, column t + 4
    // key 8 jj + 2t + 1 -- S's accumulator entries (jj, 0..3) as they are;
    // B's rows t and t + 4 are V's rows 8 jj + 2t and 8 jj + 2t + 1.
#pragma unroll
    for (int jj = 0; jj < kNT; ++jj) {
      uint32_t a_hi[4], a_lo[4];
      split(s[jj][0], a_hi[0], a_lo[0]);
      split(s[jj][2], a_hi[1], a_lo[1]);
      split(s[jj][1], a_hi[2], a_lo[2]);
      split(s[jj][3], a_hi[3], a_lo[3]);
      // (hi, hi, lo, lo) of V rows 8 jj + 2t and + 1 (pair 4 jj + t), column 8 dt + g.
      const float* v0 = sV + (4 * jj + t) * ldv + 4 * g;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        if (8 * dt < hd) {
          const uint4 vb = *reinterpret_cast<const uint4*>(v0 + 32 * dt);
          mma_tf32(o[dt], a_lo, vb.x, vb.y);
          mma_tf32(o[dt], a_hi, vb.z, vb.w);
          mma_tf32(o[dt], a_hi, vb.x, vb.y);
        }
      }
    }
    if (j + 1 < hi) {
      if constexpr (C::kStages == 1) {
        __syncthreads();                     // every warp is done with the one stage
        load_kv(j + 1, 0);
      }
      cp_async_wait_all();                   // this thread's chunks of tile j + 1
      split_kv(C::kStages == 2 ? st ^ 1 : 0);
    }
  }

  // Epilogue: the row sums over the 4 lanes of a row, then out = O / l.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + 8 * r;
    if (row < nq) {
      const float denom = fmaxf(l[r], 1e-20f);
      float* orow = out + ((static_cast<size_t>(b) * Sq + q0 + row) * H + h) * hd + 2 * t;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        if (8 * dt < hd) {
          *reinterpret_cast<float2*>(orow + 8 * dt) = make_float2(o[dt][2 * r] / denom, o[dt][2 * r + 1] / denom);
        }
      }
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Sq, Skv, H, KV, hd, scale_hd, causal, window, q_offset;
  float softcap;
  cudaStream_t stream;
};

template <int HDMAX>
int launch(const Args& a) {
  using C = Cfg<HDMAX>;
  const size_t smem = smem_bytes<HDMAX>(a.hd);
  auto* kernel = flash_attention_tf32x3_kernel<HDMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (a.Sq + 16 * C::kWarps - 1) / (16 * C::kWarps);
  if (n_qt > 65535) return kUnsupported;
  const dim3 grid(a.B * a.H, n_qt);
  kernel<<<grid, 32 * C::kWarps, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<float*>(a.out), a.Sq, a.Skv, a.H, a.KV, a.hd, a.scale_hd, a.causal, a.window, a.q_offset,
      a.softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 q, k, v, out at width hd, a multiple of 8 in [8, 256]; scale_hd <= hd
// is the true head dim the scale is taken at (the wrapper zero-fills a head
// dim that is not a multiple of 8 up to one); every pointer 16-byte
// aligned.  Returns 0, a cudaError_t from the launch, or -1 for arguments
// the body does not take.  Launches on `stream`, does not synchronise,
// allocates nothing.
extern "C" int flash_attention_tf32x3_launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                                             int Skv, int H, int KV, int hd, int scale_hd, int causal, int window,
                                             int q_offset, float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H <= 0 || H % KV != 0 || hd < 8 || hd > 256 || hd % 8 != 0 ||
      q_offset < 0 || window < 0 || scale_hd <= 0 || scale_hd > hd)
    return kUnsupported;
  const Args a{q, k, v, out, B, Sq, Skv, H, KV, hd, scale_hd, causal, window, q_offset, softcap,
               static_cast<cudaStream_t>(stream)};
  if (hd <= 64) return launch<64>(a);
  if (hd <= 128) return launch<128>(a);
  return launch<256>(a);
}

extern "C" const char* flash_attention_tf32x3_error_string(int code) {
  if (code == kUnsupported) return "unsupported shape or dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
