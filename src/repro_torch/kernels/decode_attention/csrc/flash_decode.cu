// Flash decode for Hopper (sm_90a): length-masked online-softmax attention
// of one query token against a KV cache, with inline int8 dequantization.
// One split-KV body serves both caches; they differ only in where logical
// row p of request b lies:
//   contiguous:  a rotating (B, C, KV, hd) cache, row p at (b * C + p);
//   paged:       a shared (N, bs, KV, hd) block pool walked through a (B, J)
//                int32 table, row p at (table[b, p / bs] * bs + p % bs).
//
// Replaces two Pallas TPU kernels of repro/kernels/decode_attention/kernel.py:
//   * flash_decode_kernel (kernel.py:120) -- the contiguous cache;
//   * paged_flash_decode_kernel (kernel.py:241) -- the block pool;
// both as split_decode_kernel<..., kPaged> + merge_splits_kernel below.
// Both compute
//   out[b, h, g, :] = sum_p softmax_p(s_p) v_p,  s_p = softcap?(q . k_p / sqrt(hd))
// over the valid prefix p < min(n_valid[b], rows) of the request's logical
// cache (rows = C, or J * bs), with out = acc / max(l, 1e-20) (n_valid == 0
// gives zeros).  A contiguous cache and a pool whose table holds the same
// rows in the same logical order take the same arithmetic in the same order,
// so at the same plan they give the same bits.
//
// Layouts (all contiguous, the model's native layouts -- no copies):
//   q, out       (B, KV, G, hd)   query / output dtype: bf16 or f32
//   k, v         int8 codes, bf16 or f32; scales (rows as k, KV) bf16, int8 only
//   n_valid      (B,) int32
//
// Bound: HBM bytes.  A decode step does ~4 flops per cache byte it reads
// (B * n_valid * KV * hd * 2 * elem bytes of K/V, plus the scales), far
// below the ~20 flop/byte where the card's f32 rate would take over.  The
// TPU kernels DMA a whole (C, hd) panel or a whole table block per grid
// step; this one reads only the n_valid rows (O(valid) bytes) and masks the
// ragged tail itself, so no padding copy or gather of the cache is made.
//
// Design (split-KV; what a bytes-bound kernel needs is many loads in flight
// across the whole card, and few dependent steps a row):
//   * the grid is (B * KV, G tiles, nsplit): split s of a request walks
//     logical rows [s * rows_per_split, (s + 1) * rows_per_split) clipped to
//     n_valid, so a long cache spreads over about one wave of blocks
//     (nsplit is planned on the host, cuda_kernel.split_plan, the same for
//     both caches);
//   * 4 warps; a row is read by the fewest lanes that cover it with 16-byte
//     loads (hd 64 bf16: 8 lanes, 4 rows a warp; int8: 4 lanes), and each
//     lane issues the loads of kU rows (K and V) before the first reduction,
//     so a block pays one memory latency per kU * rows-a-step rows, not one
//     a row; q . k reduces over a row's lanes with log2(lanes) shuffles;
//   * a block serves a tile of the request's GQA group (G itself for G 1
//     and 2, else 4 heads), so every row it loads serves all the tile's heads;
//   * each row group keeps its own online softmax and takes its kU rows in
//     one update (one max, kU + 1 exps); the groups merge with shuffles,
//     the warps through shared memory;
//   * paged: the block stages its split's table entries in shared memory
//     (a window of kTableWindow entries, restaged only when a step walks
//     past it), so a row's address costs no dependent global load;
//   * nsplit == 1 writes the output; otherwise each split writes its f32
//     (m, l, acc) partial to scratch and merge_splits_kernel, launched
//     right after on the same stream, combines them:
//       M = max m_s,  out = sum acc_s e^(m_s - M) / max(sum l_s e^(m_s - M), 1e-20);
//     a split that sees no row has m = -1e30, l = 0, acc = 0 and adds nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

template <typename KT, int HD>
struct SplitShape {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(KT));  // elements a 16-byte load
  static constexpr int kNV = HD / kVec;                           // loads a row
  static constexpr int kLPR = kNV < 32 ? kNV : 32;                // lanes a row
  static constexpr int kVPL = kNV / kLPR;                         // loads a lane per row
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
        kraw[u][t] = valid[u] ? __ldg(kr + sub + t * S::kLPR) : make_uint4(0, 0, 0, 0);
        vraw[u][t] = valid[u] ? __ldg(vr + sub + t * S::kLPR) : make_uint4(0, 0, 0, 0);
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
  if (lane < S::kLPR) {
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

// ---------------------------------------------------------------------------
// Type dispatch shared by both entry points
// ---------------------------------------------------------------------------

template <typename QT, typename KT>
int launch_hd(int HD, const Args& a) {
  switch (HD) {
    case 64:
      return SplitLaunch<QT, KT, 64>::run(a);
    case 128:
      return SplitLaunch<QT, KT, 128>::run(a);
    case 256:
      return SplitLaunch<QT, KT, 256>::run(a);
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
  if (a.B <= 0 || a.rows <= 0 || a.KV <= 0 || a.G <= 0 || a.G > kMaxGroup) return kUnsupported;
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
// q_type 1 = bf16, 2 = f32.  Each returns 0, a cudaError_t from a launch,
// or -1 for arguments the kernels do not take.  Each launches on `stream`,
// does not synchronise and allocates nothing.
//
// Both take nsplit splits of rows_per_split logical rows each
// (nsplit * rows_per_split >= the rows a request addresses).  nsplit == 1
// launches one kernel and takes no scratch; nsplit > 1 launches the split
// kernel and the merge, with part_acc (B * KV * G * nsplit * hd f32) and
// part_ml (B * KV * G * nsplit * 2 f32) as scratch.
//
// Contiguous: k, v (B, C, KV, hd).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* n_valid, void* out, void* part_acc, void* part_ml,
                                   int B, int C, int KV, int G, int HD, int cache_type, int q_type,
                                   int nsplit, int rows_per_split, float softcap, void* stream) {
  const Args a{q, k, v, k_scale, v_scale, nullptr, static_cast<const int*>(n_valid), out,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml), B, KV, G, C, 0, 0,
               nsplit, rows_per_split, softcap, static_cast<cudaStream_t>(stream)};
  return dispatch(a, HD, cache_type, q_type);
}

// Paged: k, v (N, bs, KV, hd) pool, table (B, J) int32 of pool block ids,
// each in [0, N) (the kernel does not check them); J * bs logical rows.
extern "C" int paged_flash_decode_launch(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* block_table, const void* n_valid, void* out,
                                         void* part_acc, void* part_ml, int B, int bs, int J, int KV,
                                         int G, int HD, int cache_type, int q_type, int nsplit,
                                         int rows_per_split, float softcap, void* stream) {
  if (J <= 0 || bs <= 0 || block_table == nullptr || static_cast<long long>(J) * bs > 0x7fffffffLL)
    return kUnsupported;
  const Args a{q, k, v, k_scale, v_scale, static_cast<const int*>(block_table),
               static_cast<const int*>(n_valid), out, static_cast<float*>(part_acc),
               static_cast<float*>(part_ml), B, KV, G, J * bs, bs, J, nsplit, rows_per_split,
               softcap, static_cast<cudaStream_t>(stream)};
  return dispatch(a, HD, cache_type, q_type);
}

extern "C" const char* flash_decode_error_string(int code) {
  if (code == kUnsupported) return "unsupported shape or dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
