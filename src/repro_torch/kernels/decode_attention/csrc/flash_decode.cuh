// The split-KV decode body (split_decode_kernel) and the merge
// (merge_splits_kernel) with their launch templates, shared by the two
// translation units of the decode library: flash_decode.cu instantiates them
// at head dims 64, 128 and 256, flash_decode_hd112.cu at 112 (kimi-k2,
// 7168 / 64 heads).  Each unit compiles its own head dims, so adding one
// leaves the others' code as it was.  flash_decode.cu says what the body
// computes and why it is built this way.

#pragma once


#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// The launch arguments, shared by both translation units (host code only).
namespace flash_decode_host {

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
  float* part_acc;         // (B * KV * G, nsplit, hd), nsplit > 1 only
  float* part_ml;          // (B * KV * G, nsplit, 2)
  int B, KV, G;
  int rows;                // logical rows a request addresses: C, or J * bs
  int bs, J;               // paged only: block size and table width
  int nsplit, rows_per_split;
  float softcap;
  cudaStream_t stream;
};

// hd 112, built in flash_decode_hd112.cu: 0, a cudaError_t, or -1.
int launch_hd112(const Args& a, int cache_type, int q_type);

}  // namespace flash_decode_host

namespace {

using flash_decode_host::Args;

constexpr int kMaxGroup = 16;
constexpr float kNegInf = -1.0e30f;
constexpr int kUnsupported = -1;

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

// ---------------------------------------------------------------------------
// The split body (both caches) and the merge
// ---------------------------------------------------------------------------

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kTableWindow = 128;  // table entries a paged block stages at once

// 16 bytes of a cache row as f32 (exact): 16 int8 codes, 8 bf16 or 4 f32 values.
template <typename KT>
__device__ __forceinline__ void unpack16(const uint4& raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (std::is_same<KT, int8_t>::value) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      f[e] = static_cast<float>(static_cast<int8_t>((w[e / 4] >> (8 * (e % 4))) & 0xFFu));
  } else if constexpr (std::is_same<KT, __nv_bfloat16>::value) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[2 * e] = __uint_as_float(w[e] << 16);             // the lower-addressed value
      f[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = __uint_as_float(w[e]);
  }
}

constexpr int pow2_ceil(int x) { return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2); }

template <typename KT, int HD>
struct SplitShape {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(KT));  // elements a 16-byte load
  static_assert(HD % kVec == 0, "a row must be whole 16-byte loads");
  static constexpr int kNV = HD / kVec;                           // loads a row
  // Lanes a row: the power of two at or above kNV, at most 32, so that the
  // shuffle trees stay within a row's lanes.  Where kNV is not a power of
  // two (hd 112: 7, 14 or 28 loads), the lanes past kNV are idle (kRagged):
  // they load nothing, hold zeros and store nothing.
  static constexpr int kLPR = pow2_ceil(kNV) < 32 ? pow2_ceil(kNV) : 32;
  static constexpr int kVPL = (kNV + kLPR - 1) / kLPR;            // loads a lane per row
  static constexpr bool kRagged = kNV % kLPR != 0;
  static constexpr int kLive = kRagged ? kNV : kLPR;              // lanes a row that hold data
  static_assert(!kRagged || kVPL == 1, "a ragged row is read in one pass of its lanes");
  static constexpr int kEPL = kVPL * kVec;                        // elements a lane
  static constexpr int kRPW = 32 / kLPR;                          // rows a warp per step
  static constexpr int kGroups = kSplitWarps * kRPW;              // rows a block per step
  static constexpr int kUWant = 64 / kGroups < 1 ? 1 : 64 / kGroups;
  static constexpr int kUMax = 8 / kVPL;
  static constexpr int kU = kUWant < kUMax ? kUWant : kUMax;      // steps in flight
  static constexpr int kStepRows = kGroups * kU;                  // rows a block per step
  // A step's rows span at most kStepRows / bs + 1 table entries (kStepRows at bs 1).
  static_assert(kStepRows < kTableWindow, "a step must fit in the staged table window");
};

// GT: query heads of a block's group tile (1, 2 or 4).  kPaged: rows come
// through block_table (B, J) over blocks of bs rows; else row p of request
// b is cache row b * rows + p.
template <typename QT, typename KT, int HD, int GT, bool kPaged>
__global__ void __launch_bounds__(kSplitThreads)
split_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
                    const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ block_table,
                    const int* __restrict__ n_valid, QT* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml, int rows, int bs, int J,
                    int KV, int G, int rows_per_split, float softcap) {
  using S = SplitShape<KT, HD>;
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  const int bh = blockIdx.x;  // b * KV + h
  const int b = bh / KV;
  const int h = bh % KV;
  const int g0 = blockIdx.y * GT;
  const int ng = min(GT, G - g0);
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % S::kLPR;                   // lane within its row group
  const int group = warp * S::kRPW + lane / S::kLPR;
  const int nv = max(0, min(n_valid[b], rows));
  const int r_begin = split * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, nv);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));

  // Lane `sub` holds the row's 16-byte pieces sub, sub + kLPR, ...: element
  // (t, e) of a lane is row element (sub + t * kLPR) * kVec + e.
  float qr[GT][S::kEPL];
  float acc[GT][S::kEPL];
  float m[GT];
  float l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int t = 0; t < S::kVPL; ++t)
#pragma unroll
      for (int e = 0; e < S::kVec; ++e) {
        const int d = (sub + t * S::kLPR) * S::kVec + e;
        acc[g][t * S::kVec + e] = 0.f;
        // The power-of-two head dims keep their code; a ragged row's idle
        // lanes (sub >= kNV) hold zeros and read nothing.
        if constexpr (S::kRagged)
          qr[g][t * S::kVec + e] =
              g < ng && sub < S::kNV ? to_f32(q[(static_cast<size_t>(bh) * G + g0 + g) * HD + d]) : 0.f;
        else
          qr[g][t * S::kVec + e] =
              g < ng ? to_f32(q[(static_cast<size_t>(bh) * G + g0 + g) * HD + d]) : 0.f;
      }
  }

  // Paged: table entries [jb0, jb_end) of request b, staged in shared memory.
  __shared__ int sm_blk[kPaged ? kTableWindow : 1];
  int jb0 = 0;
  int jb_end = 0;
  for (int base = r_begin; base < r_end; base += S::kStepRows) {
    if constexpr (kPaged) {
      // Block-uniform: every thread sees the same base, r_end and window.
      if ((min(base + S::kStepRows, r_end) - 1) / bs >= jb_end) {
        __syncthreads();  // the last step's reads of the window are done
        jb0 = base / bs;
        jb_end = min(jb0 + kTableWindow, J);
        for (int i = threadIdx.x; i < jb_end - jb0; i += kSplitThreads)
          sm_blk[i] = block_table[static_cast<size_t>(b) * J + jb0 + i];
        __syncthreads();
      }
    }
    uint4 kraw[S::kU][S::kVPL];
    uint4 vraw[S::kU][S::kVPL];
    float ks[S::kU];
    float vs[S::kU];
    bool valid[S::kU];
    // Every load of the kU rows is issued before any of them is used.
#pragma unroll
    for (int u = 0; u < S::kU; ++u) {
      const int p = base + u * S::kGroups + group;
      valid[u] = p < r_end;
      const int pv = valid[u] ? p : base;  // an address inside the window; not read
      size_t crow;                         // the logical row's cache row
      if constexpr (kPaged)
        crow = static_cast<size_t>(sm_blk[pv / bs - jb0]) * bs + pv % bs;
      else
        crow = static_cast<size_t>(b) * rows + pv;
      const size_t row = crow * KV + h;
      const uint4* kr = reinterpret_cast<const uint4*>(k + row * HD);
      const uint4* vr = reinterpret_cast<const uint4*>(v + row * HD);
#pragma unroll
      for (int t = 0; t < S::kVPL; ++t) {
        if constexpr (S::kRagged) {
          const bool ld = valid[u] && sub < S::kNV;
          kraw[u][t] = ld ? __ldg(kr + sub + t * S::kLPR) : make_uint4(0, 0, 0, 0);
          vraw[u][t] = ld ? __ldg(vr + sub + t * S::kLPR) : make_uint4(0, 0, 0, 0);
        } else {
          kraw[u][t] = valid[u] ? __ldg(kr + sub + t * S::kLPR) : make_uint4(0, 0, 0, 0);
          vraw[u][t] = valid[u] ? __ldg(vr + sub + t * S::kLPR) : make_uint4(0, 0, 0, 0);
        }
      }
      ks[u] = 1.f;
      vs[u] = 1.f;
      if (kQuant && valid[u]) {
        ks[u] = __bfloat162float(k_scale[row]);
        vs[u] = __bfloat162float(v_scale[row]);
      }
    }

    // Scores of the kU rows: every lane of every group takes part in the
    // shuffles, so rows past r_end are scored (on zeros) and dropped below.
    float s[S::kU][GT];
#pragma unroll
    for (int u = 0; u < S::kU; ++u) {
      float kf[S::kEPL];
#pragma unroll
      for (int t = 0; t < S::kVPL; ++t) unpack16<KT>(kraw[u][t], kf + t * S::kVec);
      if (kQuant) {
#pragma unroll
        for (int e = 0; e < S::kEPL; ++e) kf[e] *= ks[u];
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < S::kEPL; ++e) part += qr[g][e] * kf[e];
#pragma unroll
        for (int o = S::kLPR / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        float x = part * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[u][g] = x;
      }
    }

    // One online-softmax update for the kU rows.
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < S::kU; ++u)
        if (valid[u]) mx = fmaxf(mx, s[u][g]);
      const float corr = expf(m[g] - mx);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < S::kEPL; ++e) acc[g][e] *= corr;
      m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < S::kU; ++u) {
      if (!valid[u]) continue;
      float vf[S::kEPL];
#pragma unroll
      for (int t = 0; t < S::kVPL; ++t) unpack16<KT>(vraw[u][t], vf + t * S::kVec);
      if (kQuant) {
#pragma unroll
        for (int e = 0; e < S::kEPL; ++e) vf[e] *= vs[u];
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float p = expf(s[u][g] - m[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < S::kEPL; ++e) acc[g][e] += p * vf[e];
      }
    }
  }

  // Merge the row groups of a warp (lanes with the same `sub` hold the same
  // elements), then the warps through shared memory.
#pragma unroll
  for (int o = S::kLPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mx = fmaxf(m[g], mo);
      const float a = expf(m[g] - mx);
      const float c = expf(mo - mx);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < S::kEPL; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], o) * c;
      m[g] = mx;
    }
  }
  __shared__ float sm_m[kSplitWarps][GT];
  __shared__ float sm_l[kSplitWarps][GT];
  __shared__ float sm_acc[kSplitWarps][GT][HD];
  if (lane < S::kLive) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int t = 0; t < S::kVPL; ++t)
#pragma unroll
        for (int e = 0; e < S::kVec; ++e)
          sm_acc[warp][g][(sub + t * S::kLPR) * S::kVec + e] = acc[g][t * S::kVec + e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * HD; i += kSplitThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f;
    float asum = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * f;
      asum += sm_acc[w][g][d] * f;
    }
    const size_t orow = static_cast<size_t>(bh) * G + g0 + g;
    if (nsplit == 1) {
      out[orow * HD + d] = from_f32<QT>(asum / fmaxf(lsum, 1e-20f));
    } else {
      const size_t prow = orow * nsplit + split;
      part_acc[prow * HD + d] = asum;
      if (d == 0) {
        part_ml[prow * 2] = mx;
        part_ml[prow * 2 + 1] = lsum;
      }
    }
  }
}

// One block of HD threads per output row (b, h, g): combine its splits.
template <typename QT, int HD>
__global__ void __launch_bounds__(HD)
merge_splits_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                    QT* __restrict__ out, int nsplit) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + row * nsplit * 2;
  float mx = kNegInf;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, ml[2 * s]);
  float lsum = 0.f;
  float asum = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float f = expf(ml[2 * s] - mx);
    lsum += ml[2 * s + 1] * f;
    asum += part_acc[(row * nsplit + s) * HD + d] * f;
  }
  out[row * HD + d] = from_f32<QT>(asum / fmaxf(lsum, 1e-20f));
}

template <typename QT, typename KT, int HD>
struct SplitLaunch {
  template <int GT, bool kPaged>
  static int run_tile(const Args& a) {
    const dim3 grid(a.B * a.KV, (a.G + GT - 1) / GT, a.nsplit);
    split_decode_kernel<QT, KT, HD, GT, kPaged><<<grid, kSplitThreads, 0, a.stream>>>(
        static_cast<const QT*>(a.q), static_cast<const KT*>(a.k), static_cast<const KT*>(a.v),
        static_cast<const __nv_bfloat16*>(a.k_scale), static_cast<const __nv_bfloat16*>(a.v_scale),
        a.block_table, a.n_valid, static_cast<QT*>(a.out), a.part_acc, a.part_ml, a.rows, a.bs, a.J,
        a.KV, a.G, a.rows_per_split, a.softcap);
    return static_cast<int>(cudaGetLastError());
  }
  template <bool kPaged>
  static int run_cache(const Args& a) {
    // The group tile (cuda_kernel.group_tile): G itself for G 1 and 2, else 4.
    return a.G == 1 ? run_tile<1, kPaged>(a) : a.G == 2 ? run_tile<2, kPaged>(a) : run_tile<4, kPaged>(a);
  }
  static int run(const Args& a) {
    if (a.nsplit < 1 || a.rows_per_split < 1 || a.nsplit > 65535 ||
        static_cast<long long>(a.nsplit) * a.rows_per_split < a.rows ||
        (a.nsplit > 1 && (a.part_acc == nullptr || a.part_ml == nullptr)))
      return kUnsupported;
    int err = a.block_table != nullptr ? run_cache<true>(a) : run_cache<false>(a);
    if (err != 0 || a.nsplit == 1) return err;
    merge_splits_kernel<QT, HD><<<a.B * a.KV * a.G, HD, 0, a.stream>>>(
        a.part_acc, a.part_ml, static_cast<QT*>(a.out), a.nsplit);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace
