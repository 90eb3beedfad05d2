// Flash decode at head dim 112 (kimi-k2-1t-a32b: d_model 7168 over 64
// heads), contiguous and paged, and the cross-rank merge of context-parallel
// decode: the split-KV body and the merges of
// flash_decode.cuh instantiated at HD = 112, in a translation unit of its
// own so that the power-of-two head dims of flash_decode.cu keep their code.
//
// Replaces, at this head dim, the same Pallas TPU kernels as flash_decode.cu
// (repro/kernels/decode_attention/kernel.py:120 flash_decode_kernel and :241
// paged_flash_decode_kernel), which take any head dim.
//
// A row of 112 elements is 7 (int8), 14 (bf16) or 28 (f32) 16-byte loads:
// not a power of two, while the body's shuffle trees reduce over a
// power-of-two group of lanes.  So a row takes the next power of two of
// lanes (8, 16 or 32: hd 128's geometry, and its registers), and the lanes
// past the row are idle (SplitShape::kRagged): they load nothing, hold
// zeros in q . k and in the output sums, and store nothing.  Each row still
// reads exactly its 112, 224 or 448 bytes, so the bytes bound is hd 112's;
// the scale is 1 / sqrt(112).

#include "flash_decode.cuh"

namespace flash_decode_host {

int launch_hd112(const Args& a, int cache_type, int q_type) {
  if (q_type != 1 && q_type != 2) return kUnsupported;
  const bool bf16_q = q_type == 1;
  switch (cache_type) {
    case 0:
      return bf16_q ? SplitLaunch<__nv_bfloat16, int8_t, 112>::run(a) : SplitLaunch<float, int8_t, 112>::run(a);
    case 1:
      return bf16_q ? SplitLaunch<__nv_bfloat16, __nv_bfloat16, 112>::run(a)
                    : SplitLaunch<float, __nv_bfloat16, 112>::run(a);
    case 2:
      return bf16_q ? SplitLaunch<__nv_bfloat16, float, 112>::run(a) : SplitLaunch<float, float, 112>::run(a);
    default:
      return kUnsupported;
  }
}

int merge_hd112(const MergeArgs& m, int q_type) {
  if (q_type == 1) return run_merge<__nv_bfloat16, 112>(m);
  if (q_type == 2) return run_merge<float, 112>(m);
  return kUnsupported;
}

}  // namespace flash_decode_host
