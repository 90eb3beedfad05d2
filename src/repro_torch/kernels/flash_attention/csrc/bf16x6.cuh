// Pieces shared by the f32-accurate tensor-core flash-attention bodies that
// run each f32 product as six bf16 wgmmas ("bf16x6"): the forward
// (flash_attention_bf16x6.cu) and the backward
// (flash_attention_bwd_wgmma.cu, whose bf16 mode uses the same products
// with one plane).  An f32 operand x is split into three bf16 planes, hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (both differences
// exact in f32), and a product a b runs as the six plane pairs mid mid, hi
// lo, lo hi, hi mid, mid hi, then hi hi, into one f32 accumulator: the
// dropped pairs (mid lo, lo mid, lo lo) and the split's residual are of
// order 2**-24 relative, plain f32's error.  Three pairs (hi hi, hi mid,
// mid hi) drop terms of order 2**-16, ~250x f32's error
// (tests/test_torch_flash_attention_bwd.py and
// tests/test_torch_flash_attention_bf16x6_fwd.py show that they miss the
// f32 bars).  The small pairs go first because inside a wgmma the f32 sum
// is not rounded as the CUDA cores' FADD is: they are added while the sum
// is ~2**-8 of its final size.
//
// Here: the split kernel, the fragment planes of an accumulator, the ss and
// rs products over planes, the score and p arithmetic both bodies share,
// and the host's launch helpers.  Include after wgmma_common.cuh; each
// source includes it into its own anonymous namespace.

#pragma once

#include <math.h>

#include "wgmma_common.cuh"

namespace {

// One TMA box of a rank-2 map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

template <int F, int N>
__device__ __forceinline__ void pin(uint32_t (&r)[F][N][4]) {
#pragma unroll
  for (int p = 0; p < F; ++p) pin(r[p]);
}

// Fragment planes of P and dS: bf16 hi + lo in bf16, hi + mid + lo in f32.
template <int kP>
constexpr int kFrag = kP == 3 ? 3 : 2;

// The plane pairs (A plane, B plane) of a six-product f32 product, small
// first: mid mid, hi lo, lo hi, hi mid, mid hi; hi hi (0, 0) goes last.
__host__ __device__ constexpr int pair_a(int t) { return t == 0 ? 1 : t == 2 ? 2 : t == 4 ? 1 : 0; }
__host__ __device__ constexpr int pair_b(int t) { return t == 0 ? 1 : t == 1 ? 2 : t == 3 ? 1 : 0; }

// An accumulator pair (a, b) as fragment word j of k-slab kk of each of the
// F planes: plane 0 = bf16(x), each next plane bf16 of what the planes
// before it leave (x - hi exact in f32, as is x - hi - mid), rounded to
// nearest.
template <int F, int S>
__device__ __forceinline__ void split_into(float a, float b, uint32_t (&f)[F][S][4], int kk, int j) {
#pragma unroll
  for (int p = 0; p < F; ++p) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
    f[p][kk][j] = *reinterpret_cast<const uint32_t*>(&h2);
    if (p + 1 < F) {
      const float2 back = __bfloat1622float2(h2);
      a -= back.x;
      b -= back.y;
    }
  }
}

// An m64 x kBN accumulator as register-A fragments of kBN / 16 k-slabs:
// fragment word f of slab kk = (row r, block 2kk), (r + 8, 2kk), (r, 2kk +
// 1), (r + 8, 2kk + 1), as the forward forms P's.
template <int kBN, int F>
__device__ __forceinline__ void to_fragments(const float (&x)[kBN / 2], uint32_t (&f)[F][kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int idx = 4 * (2 * kk + (w >> 1)) + 2 * (w & 1);
      split_into(x[idx], x[idx + 1], f, kk, w);
    }
}

// The products of a register-A fragment over kBN / 16 k-slabs with B, a
// streamed tile read MN-major from sB (its planes kPlaneB bytes apart),
// from the first of its 64-column chunks this warpgroup takes (rows = the
// product's k, columns = its N of kOD).  bf16 (kP 1): acc += (hi + lo) B.
// f32 (kP 3): acc = the six plane pairs, small ones first over every
// k-slab, then hi hi; acc is a fresh tile sum (scale_d 0 on the first).
template <int kBN, int kOD, int kP, uint32_t kPlaneB>
__device__ __forceinline__ void issue_rs(float (&acc)[kOD / 2], const uint32_t (&f)[kFrag<kP>][kBN / 16][4],
                                         uint32_t sB) {
  auto desc = [&](int kk, int pb) { return sw128_desc(sB + pb * kPlaneB + kk * 16 * 128, kBN * 128, 1024); };
  if constexpr (kP == 1) {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t db = desc(kk, 0);
      Wgmma<kOD>::rs(acc, f[0][kk], db);
      Wgmma<kOD>::rs(acc, f[1][kk], db);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int t = 0; t < 5; ++t) Wgmma<kOD>::rs(acc, f[pair_a(t)][kk], desc(kk, pair_b(t)), kk > 0 || t > 0);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) Wgmma<kOD>::rs(acc, f[0][kk], desc(kk, 0), 1);
  }
  wgmma_commit();
}

// acc = A B^T over HD, A = 64 resident rows (K-major, chunks kChunkA apart,
// planes kPlaneA apart), B = a streamed tile of kBN rows (K-major, chunks
// kBN * 128 apart, planes kPlaneB apart).  bf16: one product a k-slab.
// f32: the five small plane pairs over every k-slab, then hi hi.
template <int HD, int kBN, uint32_t kChunkA, int kP, uint32_t kPlaneA, uint32_t kPlaneB>
__device__ __forceinline__ void issue_ss(float (&acc)[kBN / 2], uint32_t sA, uint32_t sB) {
  auto one = [&](int kk, int pa, int pb, int scale_d) {
    const uint64_t da = sw128_desc(sA + pa * kPlaneA + (kk / 4) * kChunkA + (kk % 4) * 32, 16, 1024);
    const uint64_t db = sw128_desc(sB + pb * kPlaneB + (kk / 4) * (kBN * 128) + (kk % 4) * 32, 16, 1024);
    Wgmma<kBN>::ss(acc, da, db, scale_d);
  };
  if constexpr (kP == 3) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int t = 0; t < 5; ++t) one(kk, pair_a(t), pair_b(t), kk > 0 || t > 0);
  }
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) one(kk, 0, 0, kP == 3 || kk > 0);
  wgmma_commit();
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }

// The scaled, capped score in log2 units, as the forward keeps it.
template <bool kSoftcap>
__device__ __forceinline__ float logit2(float s, float scale2, float scale, float softcap) {
  if constexpr (kSoftcap) {
    return tanhf(s * scale / softcap) * softcap * kLog2e;
  } else {
    return s * scale2;
  }
}

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
// f32: the split into bf16 planes
// ---------------------------------------------------------------------------

// Up to four f32 tensors of n elements (n a multiple of 8), each into three
// bf16 planes at dst, dst + n, dst + 2 n: hi, mid, lo.  A thread splits 8
// elements: two 16-byte loads, a 16-byte store a plane.
struct SplitArgs {
  const float* src[4];
  __nv_bfloat16* dst[4];
  long long n[4];
};

__global__ void __launch_bounds__(256) bf16x6_split_kernel(const SplitArgs a) {
  // Constant indices: a parameter array indexed by blockIdx.y would be
  // copied to local memory by every thread.
  const int t = blockIdx.y;
  const long long n8 = (t == 0 ? a.n[0] : t == 1 ? a.n[1] : t == 2 ? a.n[2] : a.n[3]) / 8;
  const float4* src = reinterpret_cast<const float4*>(t == 0 ? a.src[0] : t == 1 ? a.src[1] : t == 2 ? a.src[2]
                                                                                                     : a.src[3]);
  uint4* dst = reinterpret_cast<uint4*>(t == 0 ? a.dst[0] : t == 1 ? a.dst[1] : t == 2 ? a.dst[2] : a.dst[3]);
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x; i < n8;
       i += static_cast<long long>(gridDim.x) * 256) {
    const float4 x = src[2 * i];
    const float4 y = src[2 * i + 1];
    uint32_t w[3][1][4];
    split_into(x.x, x.y, w, 0, 0);
    split_into(x.z, x.w, w, 0, 1);
    split_into(y.x, y.y, w, 0, 2);
    split_into(y.z, y.w, w, 0, 3);
#pragma unroll
    for (int p = 0; p < 3; ++p) dst[p * n8 + i] = make_uint4(w[p][0][0], w[p][0][1], w[p][0][2], w[p][0][3]);
  }
}


template <typename Kern, typename... Args>
int launch_one(Kern kernel, dim3 grid, int threads, uint32_t smem, cudaStream_t stream, const Args&... args) {
  const cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(smem));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The split of `count` (up to four) f32 tensors into their planes, one
// launch on `stream`.
int launch_split(const SplitArgs& sa, int count, cudaStream_t stream) {
  long long most = 0;
  for (int t = 0; t < count; ++t) most = sa.n[t] > most ? sa.n[t] : most;
  const long long blocks = (most / 8 + 255) / 256;
  bf16x6_split_kernel<<<dim3(static_cast<unsigned>(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16),
                         count), 256, 0, stream>>>(sa);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
