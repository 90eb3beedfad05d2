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
//   * 4 warps; a row is read by the fewest lanes, a power of two, that cover
//     it with 16-byte loads (hd 64 bf16: 8 lanes, 4 rows a warp; int8: 4
//     lanes; hd 112 bf16: 14 loads on 16 lanes, two of them idle), and each
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
//
// The body and the merge live in flash_decode.cuh; this unit builds them at
// hd 64, 128 and 256, flash_decode_hd112.cu at hd 112.

#include "flash_decode.cuh"

namespace {

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
  if (HD == 112) return flash_decode_host::launch_hd112(a, cache_type, q_type);
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
