// Context-parallel decode's partial entry point: the split-KV body of
// flash_decode.cuh over a rank's contiguous (B, C_r, KV, hd) rows of a KV
// sequence split over ranks, writing the rank's one f32 entry a row (the
// unnormalised sums, m and l), and launching no merge: the ranks' entries
// are all-gathered and merged by merge_decode_partials_launch
// (flash_decode.cu).  Over several splits, each split block writes its
// partial to scratch and the row's last block to finish folds them into the
// entry (fold_splits, flash_decode.cuh), in the same launch.  Its
// instantiations (kPartials) live in this unit of their own, at hd 64, 112,
// 128 and 256, so that the decode kernels of flash_decode.cu and
// flash_decode_hd112.cu keep their code and registers.
//
// Replaces, for a rank's rows, the same Pallas TPU kernel as flash_decode.cu
// (repro/kernels/decode_attention/kernel.py:120 flash_decode_kernel), whose
// caller the reference's GSPMD program partitions over the KV sequence.
// Bound: HBM bytes, as flash decode (the rank's valid rows read once); the
// entries written are B * KV * G * (hd + 2) f32.  The splits' partials
// (B * KV * G * nsplit * (hd + 2) f32) are written and read back once
// through L2, which holds them.

#include "flash_decode.cuh"

namespace {

template <typename QT, typename KT>
int partials_hd(int HD, const Args& a) {
  switch (HD) {
    case 64:
      return SplitLaunch<QT, KT, 64, true>::run(a);
    case 112:
      return SplitLaunch<QT, KT, 112, true>::run(a);
    case 128:
      return SplitLaunch<QT, KT, 128, true>::run(a);
    case 256:
      return SplitLaunch<QT, KT, 256, true>::run(a);
    default:
      return kUnsupported;
  }
}

template <typename QT>
int partials_cache(int cache_type, int HD, const Args& a) {
  switch (cache_type) {
    case 0:
      return partials_hd<QT, int8_t>(HD, a);
    case 1:
      return partials_hd<QT, __nv_bfloat16>(HD, a);
    case 2:
      return partials_hd<QT, float>(HD, a);
    default:
      return kUnsupported;
  }
}

}  // namespace

// Type codes as flash_decode_launch's.  part_acc (B * KV * G * hd f32) and
// part_ml (B * KV * G * 2 f32) are the output.  At nsplit > 1 the
// B * KV * G * nsplit * (hd + 2) f32 after part_ml are the fold's scratch
// (the splits' partials), and B * KV * G is at most kFoldArrivals (2^18).
// 0, a cudaError_t from the launch, or -1 for arguments the kernel does not
// take.
extern "C" int flash_decode_partials_launch(const void* q, const void* k, const void* v,
                                            const void* k_scale, const void* v_scale,
                                            const void* n_valid, void* part_acc, void* part_ml,
                                            int B, int C, int KV, int G, int HD, int cache_type,
                                            int q_type, int nsplit, int rows_per_split, float softcap,
                                            void* stream) {
  if (B <= 0 || C <= 0 || KV <= 0 || G <= 0 || G > kMaxGroup) return kUnsupported;
  if (cache_type == 0 && (k_scale == nullptr || v_scale == nullptr)) return kUnsupported;
  const Args a{q, k, v, k_scale, v_scale, nullptr, static_cast<const int*>(n_valid), nullptr,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml), B, KV, G, C, 0, 0,
               nsplit, rows_per_split, softcap, static_cast<cudaStream_t>(stream)};
  switch (q_type) {
    case 1:
      return partials_cache<__nv_bfloat16>(cache_type, HD, a);
    case 2:
      return partials_cache<float>(cache_type, HD, a);
    default:
      return kUnsupported;
  }
}
