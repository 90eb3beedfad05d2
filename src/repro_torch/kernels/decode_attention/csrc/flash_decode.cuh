// The split-KV decode body (split_decode_kernel), the one-call merge
// (merge_splits_kernel) and context-parallel decode's cross-rank merge
// (merge_ranks_kernel) with their launch templates, shared by the three
// translation units of the decode library: flash_decode.cu instantiates them
// at head dims 64, 128 and 256, flash_decode_hd112.cu at 112 (kimi-k2,
// 7168 / 64 heads), flash_decode_partials.cu the body's partial entry point
// (with its fold, fold_splits) at all four.  Each unit compiles its own
// instantiations, so adding one leaves the others' code as it was.
// flash_decode.cu says what the body computes and why it is built this way,
// and how the partial entry point and the cross-rank merge of
// context-parallel decode use them.

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
  void* out;               // null for the partial entry point
  float* part_acc;         // (B * KV * G, nsplit, hd) at nsplit > 1; the partial entry point's entry (.., 1, hd)
  float* part_ml;          // (B * KV * G, nsplit, 2); the entry's (.., 1, 2), then the fold's scratch
  int B, KV, G;
  int rows;                // logical rows a request addresses: C, or J * bs
  int bs, J;               // paged only: block size and table width
  int nsplit, rows_per_split;
  float softcap;
  cudaStream_t stream;
};

// A merge of gathered partials: nrank ranks' (rows, nsplit) entries, rank
// r's at part_acc / part_ml + r * rank_stride floats.
struct MergeArgs {
  const float* part_acc;
  const float* part_ml;
  void* out;               // (rows, hd) in the query's type
  int rows, nsplit, nrank;
  long long rank_stride;
  cudaStream_t stream;
};

// hd 112, built in flash_decode_hd112.cu: 0, a cudaError_t, or -1.
int launch_hd112(const Args& a, int cache_type, int q_type);
int merge_hd112(const MergeArgs& m, int q_type);

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

// Context-parallel decode's fold (the partial entry point over several
// splits), run by the split blocks of one (b * KV + h, g tile) row once each
// has written its partial to sp_acc / sp_ml: the block that arrives last
// folds the row's nsplit partials, read back from L2, into the rank's one
// unnormalised entry
//   M = max m_s,  l = sum l_s e^(m_s - M),  acc = sum acc_s e^(m_s - M),  m = M,
// the sums in split order: the one-call merge's arithmetic without its
// division, so that a world of one merges to the one-call merge's bits.  A
// row with no valid row folds to m = -1e30, l = 0, acc = 0.
//
// A block publishes its partial by a barrier, then one thread's
// acquire-release atomic on the row's arrival counter (arrive, on
// fold_arrivals); the last block's atomic acquires the others' partials
// (and drops the SM's L1), and its barrier orders its threads' plain loads
// after it.  That block resets the counter to 0, so the next call on the
// stream (or a CUDA graph's replay) finds it so.  The max is taken across
// the block's threads (exact in any order), each split's weight
// e^(m_s - M) once into shared memory, a chunk of kFoldChunk splits at a
// time; each thread sums its kE elements, issuing kU splits' loads before
// using any: unpredicated loads (a dead element reads a live one's address
// and is not stored), kU splits at a time and the chunk's last few one at a
// time.  Not inlined, so that its registers leave the body's allocation as
// it was.
constexpr int kFoldChunk = kSplitThreads;

// The fold's arrival counters, one a (b * KV + h, g tile) row of a call:
// zero at the module's load, and left zero by every call, so the partial
// calls on a device run on one stream at a time.  Module memory, so that
// the kernel's parameters (which every instantiation of the body shares)
// stay as they were.
constexpr int kFoldArrivals = 1 << 18;
__device__ unsigned int fold_arrivals[kFoldArrivals];

// The old count of *counter, adding 1, acquire-release at GPU scope.
__device__ __forceinline__ unsigned int arrive(unsigned int* counter) {
  unsigned int old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;" : "=r"(old) : "l"(counter) : "memory");
  return old;
}

template <int HD, int GT>
__device__ __noinline__ void fold_splits(const float* sp_acc, const float* sp_ml, float* e_acc, float* e_ml,
                                         size_t orow0, int ng, int nsplit) {
  constexpr int kE = (GT * HD + kSplitThreads - 1) / kSplitThreads;  // elements a thread
  constexpr int kU = 32 / kE < 1 ? 1 : 32 / kE > 8 ? 8 : 32 / kE;   // split loads in flight an element
  __shared__ unsigned int sm_last;
  __shared__ float sm_max[kSplitWarps][GT];
  __shared__ float sm_w[GT][kFoldChunk];
  __shared__ float sm_l[GT][kFoldChunk];
  const unsigned int tile = blockIdx.x * gridDim.y + blockIdx.y;
  __syncthreads();  // the block's partial is written before its arrival is counted
  if (threadIdx.x == 0) {
    const bool last = arrive(fold_arrivals + tile) == static_cast<unsigned int>(nsplit) - 1u;
    if (last) fold_arrivals[tile] = 0u;
    sm_last = last;
  }
  __syncthreads();
  if (!sm_last) return;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Head g's partials; a head past ng reads head ng - 1's and is not stored.
  auto ml_of = [&](int g, int s) { return sp_ml + ((orow0 + min(g, ng - 1)) * nsplit + s) * 2; };
  float mx[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) mx[g] = kNegInf;
  for (int s = threadIdx.x; s < nsplit; s += kSplitThreads) {
    float m[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) m[g] = *ml_of(g, s);
#pragma unroll
    for (int g = 0; g < GT; ++g) mx[g] = fmaxf(mx[g], m[g]);
  }
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
    if (lane == 0) sm_max[warp][g] = mx[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    mx[g] = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mx[g] = fmaxf(mx[g], sm_max[w][g]);
  }
  // Element j of this thread: i = threadIdx.x + j * kSplitThreads, head
  // i / HD, column i % HD; dead past ng * HD (it reads the last live one).
  int live[kE];
  int hj[kE];
  int cj[kE];
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const int i = threadIdx.x + j * kSplitThreads;
    live[j] = i < ng * HD;
    const int ic = min(i, ng * HD - 1);
    hj[j] = ic / HD;
    cj[j] = ic % HD;
  }
  float asum[kE];
  float lsum[kE];
#pragma unroll
  for (int j = 0; j < kE; ++j) asum[j] = lsum[j] = 0.f;
  for (int c0 = 0; c0 < nsplit; c0 += kFoldChunk) {
    const int cn = min(kFoldChunk, nsplit - c0);
    if (c0 > 0) __syncthreads();  // the last chunk's weights are read
    if (threadIdx.x < cn) {
      float m[GT];
      float l[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float* p = ml_of(g, c0 + threadIdx.x);
        m[g] = p[0];
        l[g] = p[1];
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        sm_w[g][threadIdx.x] = expf(m[g] - mx[g]);
        sm_l[g][threadIdx.x] = l[g];
      }
    }
    __syncthreads();
    const float* pj[kE];
#pragma unroll
    for (int j = 0; j < kE; ++j) pj[j] = sp_acc + ((orow0 + hj[j]) * nsplit + c0) * HD + cj[j];
    // Splits [s0, s0 + N) of the chunk: every load, then the sums in split order.
    auto take = [&](auto width, int s0) {
      constexpr int kN = decltype(width)::value;
      float a[kE][kN];
#pragma unroll
      for (int j = 0; j < kE; ++j)
#pragma unroll
        for (int u = 0; u < kN; ++u) a[j][u] = pj[j][static_cast<size_t>(s0 + u) * HD];
#pragma unroll
      for (int j = 0; j < kE; ++j)
#pragma unroll
        for (int u = 0; u < kN; ++u) {
          const float w = sm_w[hj[j]][s0 + u];
          lsum[j] += sm_l[hj[j]][s0 + u] * w;
          asum[j] += a[j][u] * w;
        }
    };
    int s0 = 0;
    for (; s0 + kU <= cn; s0 += kU) take(std::integral_constant<int, kU>(), s0);
    for (; s0 < cn; ++s0) take(std::integral_constant<int, 1>(), s0);
  }
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    if (live[j]) {
      const size_t orow = orow0 + hj[j];
      e_acc[orow * HD + cj[j]] = asum[j];
      if (cj[j] == 0) {
        float m = kNegInf;
#pragma unroll
        for (int w = 0; w < kSplitWarps; ++w) m = fmaxf(m, sm_max[w][hj[j]]);
        e_ml[orow * 2] = m;
        e_ml[orow * 2 + 1] = lsum[j];
      }
    }
  }
}

// GT: query heads of a block's group tile (1, 2 or 4).  kPaged: rows come
// through block_table (B, J) over blocks of bs rows; else row p of request
// b is cache row b * rows + p.  kPartials: context-parallel decode's partial
// entry point (built in flash_decode_partials.cu, so that the other
// instantiations keep their code and registers): the rank's one
// unnormalised entry a row in part_acc / part_ml, written by the block
// itself at nsplit 1, else folded from the splits' partials (fold_splits),
// which go to the scratch that follows part_ml.
template <typename QT, typename KT, int HD, int GT, bool kPaged, bool kPartials>
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
  // Where the splits' partials go: part_acc / part_ml, or the fold's
  // scratch after the entries' (m, l): (rows, nsplit, hd) sums, then
  // (rows, nsplit, 2) (m, l).
  const size_t n_rows = static_cast<size_t>(gridDim.x) * G;
  float* const sp_acc = kPartials && nsplit > 1 ? part_ml + n_rows * 2 : part_acc;
  float* const sp_ml = kPartials && nsplit > 1 ? sp_acc + n_rows * nsplit * HD : part_ml;
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
    if (!kPartials && nsplit == 1) {
      out[orow * HD + d] = from_f32<QT>(asum / fmaxf(lsum, 1e-20f));
    } else {
      const size_t prow = orow * nsplit + split;
      sp_acc[prow * HD + d] = asum;
      if (d == 0) {
        sp_ml[prow * 2] = mx;
        sp_ml[prow * 2 + 1] = lsum;
      }
    }
  }
  if constexpr (kPartials) {
    if (nsplit > 1)
      fold_splits<HD, GT>(sp_acc, sp_ml, part_acc, part_ml, static_cast<size_t>(bh) * G + g0, ng, nsplit);
  }
}

// One block of HD threads per output row (b, h, g): combine one call's
// nsplit splits' partials.
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

// Context-parallel decode's cross-rank merge: output row `row` (b, h, g)
// from the nrank x nsplit entries the ranks' all-gather delivers, rank-major
// (entry e = r * nsplit + s; rank r's at part_acc / part_ml + r *
// rank_stride floats), in the query's type.  One warp a block serves
// kMergeCols of the row's hd columns (grid (rows, ceil(hd / kMergeCols)):
// 128 blocks at jamba-v0.1's attention layer, 32 rows of hd 128), so the
// rows spread over the card; each block recomputes the row's max and
// weights, which are cheap.  The lanes read the (m, l) pairs together and
// reduce the max across the warp (exact in any order); each entry's weight
// e^(m_e - M) is computed once into shared memory, kMergeChunk entries at a
// time; each lane then issues kMergeU entries' acc loads before it uses any
// (unpredicated; the chunk's last few one at a time) and adds them in entry
// order:
//   out = sum acc_e e^(m_e - M) / max(sum l_e e^(m_e - M), 1e-20),
// so that one entry (a world of one) gives the one-call merge's bits.
constexpr int kMergeCols = 32;
constexpr int kMergeChunk = 256;
constexpr int kMergeU = 16;

template <typename QT, int HD>
__global__ void __launch_bounds__(kMergeCols)
merge_ranks_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml, QT* __restrict__ out,
                   int nsplit, int nrank, long long rank_stride) {
  const size_t row = blockIdx.x;
  const int lane = threadIdx.x;
  const int d = blockIdx.y * kMergeCols + lane;
  const int dc = min(d, HD - 1);  // a lane past hd reads the last column and stores nothing
  const int n = nrank * nsplit;
  // Entry e's (m, l) and acc row.
  auto at = [&](int e, int width, const float* base) {
    const int r = e / nsplit;
    return base + r * rank_stride + (row * nsplit + (e - r * nsplit)) * width;
  };
  float mx = kNegInf;
  for (int e = lane; e < n; e += kMergeCols) mx = fmaxf(mx, __ldg(at(e, 2, part_ml)));
#pragma unroll
  for (int o = kMergeCols / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  __shared__ float sm_w[kMergeChunk];
  __shared__ float sm_l[kMergeChunk];
  float lsum = 0.f;
  float asum = 0.f;
  for (int c0 = 0; c0 < n; c0 += kMergeChunk) {
    const int cn = min(kMergeChunk, n - c0);
    __syncwarp();  // the last chunk's weights are read
    for (int e = lane; e < cn; e += kMergeCols) {
      const float* p = at(c0 + e, 2, part_ml);
      sm_w[e] = expf(__ldg(p) - mx);
      sm_l[e] = __ldg(p + 1);
    }
    __syncwarp();
    // Entries [e0, e0 + N) of the chunk: every load, then the sums in entry order.
    auto take = [&](auto width, int e0) {
      constexpr int kN = decltype(width)::value;
      float a[kN];
#pragma unroll
      for (int u = 0; u < kN; ++u) a[u] = __ldg(at(c0 + e0 + u, HD, part_acc) + dc);
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        const float w = sm_w[e0 + u];
        lsum += sm_l[e0 + u] * w;
        asum += a[u] * w;
      }
    };
    int e0 = 0;
    for (; e0 + kMergeU <= cn; e0 += kMergeU) take(std::integral_constant<int, kMergeU>(), e0);
    for (; e0 < cn; ++e0) take(std::integral_constant<int, 1>(), e0);
  }
  if (d < HD) out[row * HD + d] = from_f32<QT>(asum / fmaxf(lsum, 1e-20f));
}

template <typename QT, typename KT, int HD, bool kPartials = false>
struct SplitLaunch {
  template <int GT, bool kPaged>
  static int run_tile(const Args& a) {
    const dim3 grid(a.B * a.KV, (a.G + GT - 1) / GT, a.nsplit);
    split_decode_kernel<QT, KT, HD, GT, kPaged, kPartials><<<grid, kSplitThreads, 0, a.stream>>>(
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
        ((kPartials || a.nsplit > 1) && (a.part_acc == nullptr || a.part_ml == nullptr)) ||
        (kPartials && (a.block_table != nullptr ||
                       (a.nsplit > 1 && static_cast<long long>(a.B) * a.KV * a.G > kFoldArrivals))))
      return kUnsupported;
    if constexpr (kPartials) {
      // The rank's entry: the split kernel alone, with its fold, over a contiguous cache.
      return run_cache<false>(a);
    } else {
      int err = a.block_table != nullptr ? run_cache<true>(a) : run_cache<false>(a);
      if (err != 0 || a.nsplit == 1) return err;
      merge_splits_kernel<QT, HD><<<a.B * a.KV * a.G, HD, 0, a.stream>>>(
          a.part_acc, a.part_ml, static_cast<QT*>(a.out), a.nsplit);
      return static_cast<int>(cudaGetLastError());
    }
  }
};

template <typename QT, int HD>
int run_merge(const flash_decode_host::MergeArgs& m) {
  const dim3 grid(m.rows, (HD + kMergeCols - 1) / kMergeCols);
  merge_ranks_kernel<QT, HD><<<grid, kMergeCols, 0, m.stream>>>(m.part_acc, m.part_ml, static_cast<QT*>(m.out),
                                                               m.nsplit, m.nrank, m.rank_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
