// Flash decode for Hopper (sm_90a): length-masked online-softmax attention
// of one query token against a KV cache, with inline int8 dequantization,
// over a rotating contiguous cache or a shared block pool (paged).
//
// Replaces two Pallas TPU kernels of repro/kernels/decode_attention/kernel.py:
//   * flash_decode_kernel (kernel.py:120) -- the contiguous cache;
//   * paged_flash_decode_kernel (kernel.py:241) -- the block pool walked
//     through a per-request block table.
// Both compute the same function:
//   out[b, h, g, :] = sum_p softmax_p(s_p) v_p,  s_p = softcap?(q . k_p / sqrt(hd))
// over the valid prefix p < n_valid[b] of the request's logical cache, with
//   out = acc / max(l, 1e-20)   (n_valid == 0 gives zeros).
//
// Layouts (all contiguous, the model's native layouts -- no copies):
//   q, out       (B, KV, G, hd)   query / output dtype: bf16 or f32
//   contiguous:  k, v (B, C, KV, hd), scales (B, C, KV); row p of request b
//                is cache row (b * C + p)
//   paged:       k, v (N, bs, KV, hd), scales (N, bs, KV); table (B, J)
//                int32; row p of request b is pool row
//                (table[b, p / bs] * bs + p % bs), and p < min(n_valid, J*bs)
//   k, v         int8 codes, bf16 or f32; scales bf16, int8 caches only
//   n_valid      (B,) int32
//
// Bound: HBM bytes.  A decode step does ~4 flops per cache byte it reads
// (B * n_valid * KV * hd * 2 * elem bytes of K/V, plus the scales), far
// below the ~20 flop/byte where the card's f32 rate would take over.  The
// TPU kernels DMA a whole (C, hd) panel or a whole table block per grid
// step; this one reads only the n_valid rows (O(valid) bytes), and masks
// the ragged tail itself, so no padding copy or gather of the cache is
// ever made.
//
// Design (simple first; speed is later work):
//   * one block per (b, kv-head) and per tile of <= 4 query heads of its
//     GQA group; 8 warps.  The TPU's sequential grid axis over KV blocks
//     (with (acc, m, l) carried in VMEM scratch, and the paged table and
//     n_valid in SMEM scalar prefetch) becomes a loop inside the block:
//     Hopper blocks run in no order and carry nothing between them;
//   * the paged block reads its own table row and turns each logical row
//     into a pool row itself, one table lookup per row;
//   * each lane holds hd/32 consecutive elements of q (f32 registers);
//   * warps stride over the valid positions; per position a lane loads its
//     slice of k and v, dequantizes int8 with the row's bf16 scale, and the
//     warp reduces q . k with shuffles;
//   * each warp keeps its own running (m, l, acc) online softmax;
//   * the warps' states are merged through shared memory and written in
//     the output dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroupTile = 4;
constexpr int kMaxGroup = 16;
constexpr float kNegInf = -1.0e30f;
constexpr int kUnsupported = -1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Everything a launch needs; block_table is null for the contiguous cache.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* k_scale;
  const void* v_scale;
  const int* block_table;  // (B, J), paged only
  const int* n_valid;
  void* out;
  int B, C, KV, G;         // C: cache rows (contiguous) or block size (paged)
  int J;                   // table width (paged only)
  float softcap;
  cudaStream_t stream;
};

template <typename QT, typename KT, int HD, bool kPaged>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v,
                    const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale,
                    const int* __restrict__ block_table,
                    const int* __restrict__ n_valid, QT* __restrict__ out,
                    int C, int KV, int G, int J, float softcap) {
  constexpr int EPL = HD / 32;  // elements of a row per lane
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  const int bh = blockIdx.x;  // b * KV + h
  const int b = bh / KV;
  const int h = bh % KV;
  const int g0 = blockIdx.y * kGroupTile;
  const int ng = min(kGroupTile, G - g0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rows = kPaged ? J * C : C;  // rows the request can address
  const int nv = max(0, min(n_valid[b], rows));
  const int* bt_row = kPaged ? block_table + static_cast<size_t>(b) * J : nullptr;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));

  float qr[kGroupTile][EPL];
  float acc[kGroupTile][EPL];
  float m[kGroupTile];
  float l[kGroupTile];
#pragma unroll
  for (int g = 0; g < kGroupTile; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = g < ng ? to_f32(q[(static_cast<size_t>(bh) * G + g0 + g) * HD + lane * EPL + e])
                        : 0.f;
    }
  }

  for (int p = warp; p < nv; p += kWarps) {
    // Logical row p -> physical row of the (rows, KV, hd) buffer.
    const size_t prow = kPaged ? static_cast<size_t>(bt_row[p / C]) * C + p % C
                               : static_cast<size_t>(b) * C + p;
    const size_t row = prow * KV + h;
    const KT* kr = k + row * HD + lane * EPL;
    const KT* vr = v + row * HD + lane * EPL;
    float kf[EPL];
    float vf[EPL];
    float ks = 1.f;
    float vs = 1.f;
    if (kQuant) {
      ks = __bfloat162float(k_scale[row]);
      vs = __bfloat162float(v_scale[row]);
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kf[e] = to_f32(kr[e]);
      vf[e] = to_f32(vr[e]);
      if (kQuant) {
        kf[e] *= ks;
        vf[e] *= vs;
      }
    }
#pragma unroll
    for (int g = 0; g < kGroupTile; ++g) {
      if (g < ng) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part += qr[g][e] * kf[e];
        float s = warp_sum(part) * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        const float m_new = fmaxf(m[g], s);
        const float corr = expf(m[g] - m_new);
        const float pr = expf(s - m_new);
        l[g] = l[g] * corr + pr;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * corr + pr * vf[e];
        m[g] = m_new;
      }
    }
  }

  // Merge the warps' partial states: M = max_w m_w, then
  // out = sum_w acc_w e^(m_w - M) / max(sum_w l_w e^(m_w - M), 1e-20).
  __shared__ float sm_m[kWarps][kGroupTile];
  __shared__ float sm_l[kWarps][kGroupTile];
  __shared__ float sm_acc[kWarps][kGroupTile][HD];
#pragma unroll
  for (int g = 0; g < kGroupTile; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f;
    float asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * f;
      asum += sm_acc[w][g][d] * f;
    }
    out[(static_cast<size_t>(bh) * G + g0 + g) * HD + d] = from_f32<QT>(asum / fmaxf(lsum, 1e-20f));
  }
}

template <typename QT, typename KT, int HD>
int launch(const Args& a) {
  const dim3 grid(a.B * a.KV, (a.G + kGroupTile - 1) / kGroupTile);
  const auto* ks = static_cast<const __nv_bfloat16*>(a.k_scale);
  const auto* vs = static_cast<const __nv_bfloat16*>(a.v_scale);
  if (a.block_table != nullptr) {
    flash_decode_kernel<QT, KT, HD, true><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const QT*>(a.q), static_cast<const KT*>(a.k), static_cast<const KT*>(a.v), ks, vs,
        a.block_table, a.n_valid, static_cast<QT*>(a.out), a.C, a.KV, a.G, a.J, a.softcap);
  } else {
    flash_decode_kernel<QT, KT, HD, false><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const QT*>(a.q), static_cast<const KT*>(a.k), static_cast<const KT*>(a.v), ks, vs,
        nullptr, a.n_valid, static_cast<QT*>(a.out), a.C, a.KV, a.G, 0, a.softcap);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_hd(int HD, const Args& a) {
  switch (HD) {
    case 64:
      return launch<QT, KT, 64>(a);
    case 128:
      return launch<QT, KT, 128>(a);
    case 256:
      return launch<QT, KT, 256>(a);
    default:
      return kUnsupported;
  }
}

template <typename QT>
int launch_cache(int cache_type, int HD, const Args& a) {
  switch (cache_type) {
    case 0:
      return launch_hd<QT, int8_t>(HD, a);
    case 1:
      return launch_hd<QT, __nv_bfloat16>(HD, a);
    case 2:
      return launch_hd<QT, float>(HD, a);
    default:
      return kUnsupported;
  }
}

int dispatch(const Args& a, int HD, int cache_type, int q_type) {
  if (a.B <= 0 || a.C <= 0 || a.KV <= 0 || a.G <= 0 || a.G > kMaxGroup) return kUnsupported;
  if (cache_type == 0 && (a.k_scale == nullptr || a.v_scale == nullptr)) return kUnsupported;
  switch (q_type) {
    case 1:
      return launch_cache<__nv_bfloat16>(cache_type, HD, a);
    case 2:
      return launch_cache<float>(cache_type, HD, a);
    default:
      return kUnsupported;
  }
}

}  // namespace

// Type codes: cache_type 0 = int8 (+ bf16 scales), 1 = bf16, 2 = f32;
// q_type 1 = bf16, 2 = f32.  Each returns 0, a cudaError_t from the
// launch, or -1 for arguments the kernel does not take.  Each launches on
// `stream`, does not synchronise and allocates nothing.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* n_valid, void* out, int B, int C, int KV,
                                   int G, int HD, int cache_type, int q_type, float softcap,
                                   void* stream) {
  const Args a{q, k, v, k_scale, v_scale, nullptr, static_cast<const int*>(n_valid), out,
               B, C, KV, G, 0, softcap, static_cast<cudaStream_t>(stream)};
  return dispatch(a, HD, cache_type, q_type);
}

// Paged: k, v (N, bs, KV, hd) pool, table (B, J) int32 of pool block ids,
// each in [0, N) (the kernel does not check them).
extern "C" int paged_flash_decode_launch(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* block_table, const void* n_valid,
                                         void* out, int B, int bs, int J, int KV, int G, int HD,
                                         int cache_type, int q_type, float softcap,
                                         void* stream) {
  if (J <= 0 || block_table == nullptr) return kUnsupported;
  const Args a{q, k, v, k_scale, v_scale, static_cast<const int*>(block_table),
               static_cast<const int*>(n_valid), out, B, bs, KV, G, J, softcap,
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, HD, cache_type, q_type);
}

extern "C" const char* flash_decode_error_string(int code) {
  if (code == kUnsupported) return "unsupported shape or dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
