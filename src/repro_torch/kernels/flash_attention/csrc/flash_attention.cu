// Flash attention forward for Hopper (sm_90a) on the CUDA cores: causal /
// sliding-window / full attention of a whole query sequence with an online
// softmax, as the prefill of prompts longer than ``attn_block_q`` runs it.
// This is the body for what neither tensor-core body takes: head dims that
// are not a multiple of 8 (TMA and the tensor-core fragments need one), in
// bf16 or f32 (flash_attention_wgmma.cu takes bf16 at the multiples of 8,
// flash_attention_tf32x3.cu f32).  cuda_kernel.body_for picks.
//
// Replaces the Pallas TPU kernel flash_attention_kernel
// (repro/kernels/flash_attention/kernel.py:106, body _flash_kernel), and on
// the model path the jnp recurrence _blockwise_attn it stands for
// (repro/models/attention.py:162).  It computes
//   out[b, q, h, :] = sum_k softmax_k(s_qk) v[b, k, h / G, :],
//   s_qk = softcap?(q . k / sqrt(hd)),
// over the keys k < Skv with (causal) k <= q_offset + q and (window > 0)
// q_offset + q - k < window, and out = acc / max(l, 1e-20) (zeros for a
// query that sees no key).
//
// Layouts (all contiguous, the model's native ones -- no copies):
//   q, out   (B, Sq, H, hd)    bf16 or f32 (out in q's dtype)
//   k, v     (B, Skv, KV, hd)  same dtype; query head h reads KV head
//            h / (H / KV) in place, so GQA never materializes a repeat
//
// Bound: the larger of bytes (q, k, v read once, out written once, over
// 3.35 TB/s) and operations (4 * hd flops per visible (query, key) pair)
// over the peak of f32-accurate arithmetic on the operands' type.  For bf16
// operands that is the bf16 tensor-core rate (989 TFLOP/s), because a bf16
// product accumulated in f32 is exact.  For f32 operands it is the 3xTF32
// rate (494.7 / 3 TFLOP/s): one TF32 product keeps ~11 bits (errors ~1e-3,
// 50x the f32 bar of 2e-5), but splitting each operand as hi + lo and
// summing hi*hi + hi*lo + lo*hi in f32 keeps plain f32's error (~1e-6).
// This body's f32 FMAs are its choice, not the function's floor, which is
// why head dims that are multiples of 8 have tensor-core bodies of their
// own.
//
// Design (simple first):
//   * one block of 256 threads per (b * H + h, 64-row query tile); the
//     TPU's BlockSpec delivered the whole (Skv, hd) K/V panel to VMEM per
//     grid step, here K and V are staged 64 rows at a time through shared
//     memory (upcast to f32), with Q's tile beside them, in dynamic shared
//     memory (hd 256: 214 KB, past the 48 KB static limit);
//   * the block walks only the KV tiles in [lo, hi), clipped to the causal
//     and window-reachable range as kernel.py:53-62 clips them; the ragged
//     last tile and the ragged last query tile are masked here (k < Skv,
//     q < Sq), so the caller pads nothing;
//   * a 16 x 16 thread grid: thread (ty, tx) owns query rows 4ty..4ty+3,
//     key columns tx + 16j (j < 4) of the score tile and head dims tx + 16e
//     of the accumulator; row max and row sum reduce over the 16 threads of
//     a half warp with shuffles; P goes through shared memory to the PV
//     product;
//   * f32 throughout (both products with fmaf), as the TPU kernel; a
//     masked entry contributes p = 0 explicitly, never exp(NEG_INF -
//     NEG_INF) = 1 (a tile whose first block is wholly masked by the window
//     would otherwise add ones).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;             // query rows of a tile
constexpr int kBKV = 64;            // key rows of a staged K/V tile
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBQ / kTY;    // query rows per thread
constexpr int kCols = kBKV / kTX;   // key columns per thread
constexpr int kPStride = kBKV + 1;  // padded row of the P tile
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

// Reductions over the 16 lanes of a half warp (the threads of one ty).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int hd) {
  const size_t ld = static_cast<size_t>(hd) + 1;
  return sizeof(float) * ((kBQ + 2 * kBKV) * ld + kBQ * kPStride);
}

// HDMAX bounds the accumulator registers; hd <= HDMAX is a runtime value.
template <typename T, int HDMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, int Sq, int Skv, int H, int KV, int hd, int causal,
                       int window, int q_offset, float softcap) {
  constexpr int kDims = HDMAX / kTX;  // accumulator dims per thread
  extern __shared__ float smem[];
  const int ld = hd + 1;              // odd row stride: conflict-free column reads
  float* sQ = smem;                   // (kBQ, ld)
  float* sK = sQ + kBQ * ld;          // (kBKV, ld)
  float* sV = sK + kBKV * ld;         // (kBKV, ld)
  float* sP = sV + kBKV * ld;         // (kBQ, kPStride)

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;          // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int nq = min(kBQ, Sq - q0);   // valid query rows of this tile
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i % hd;
    sQ[r * ld + d] =
        r < nq ? to_f32(q[((static_cast<size_t>(b) * Sq + q0 + r) * H + h) * hd + d]) : 0.f;
  }

  // The KV tiles any query of this tile can see: [lo, hi).
  const int n_kv = (Skv + kBKV - 1) / kBKV;
  const int hi = causal ? min((q_offset + q0 + nq - 1) / kBKV + 1, n_kv) : n_kv;
  const int lo = window > 0 ? max(q_offset + q0 - window + 1, 0) / kBKV : 0;

  float m[kRows];
  float l[kRows];
  float acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[i][e] = 0.f;
  }

  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * kBKV;
    const int nk = min(kBKV, Skv - k0);
    __syncthreads();                  // the previous tile's readers are done
    for (int i = tid; i < kBKV * hd; i += kThreads) {
      const int r = i / hd;
      const int d = i % hd;
      const size_t g = ((static_cast<size_t>(b) * Skv + k0 + r) * KV + kvh) * hd + d;
      // Rows past Skv are zeros: masked to p = 0, and 0 * 0 adds nothing.
      sK[r * ld + d] = r < nk ? to_f32(k[g]) : 0.f;
      sV[r * ld + d] = r < nk ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[kRows];
      float kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty * kRows + i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sK[(tx + j * kTX) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Mask, softcap and the online-softmax update, row by row.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q_offset + q0 + ty * kRows + i;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + j * kTX;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        ok[j] = kp < Skv && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
        s[i][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty * kRows + i) * kPStride + tx + j * kTX] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[i][e] *= corr;
    }
    __syncwarp();                     // P rows of this ty were written by its own half warp

#pragma unroll 2
    for (int c = 0; c < nk; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = sP[(ty * kRows + i) * kPStride + c];
#pragma unroll
      for (int e = 0; e < kDims; ++e) {
        const int d = tx + e * kTX;
        if (d < hd) {
          const float vv = sV[c * ld + d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][e] = fmaf(p[i], vv, acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (r < nq) {
      const float denom = fmaxf(l[i], 1e-20f);
      T* orow = out + ((static_cast<size_t>(b) * Sq + q0 + r) * H + h) * hd;
#pragma unroll
      for (int e = 0; e < kDims; ++e) {
        const int d = tx + e * kTX;
        if (d < hd) orow[d] = from_f32<T>(acc[i][e] / denom);
      }
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Sq, Skv, H, KV, hd, causal, window, q_offset;
  float softcap;
  cudaStream_t stream;
};

template <typename T, int HDMAX>
int launch(const Args& a) {
  const size_t smem = smem_bytes(a.hd);
  auto* kernel = flash_attention_simt_kernel<T, HDMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.Sq, a.Skv, a.H, a.KV, a.hd, a.causal, a.window, a.q_offset,
      a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a) {
  if (a.hd <= 64) return launch<T, 64>(a);
  if (a.hd <= 128) return launch<T, 128>(a);
  return launch<T, 256>(a);
}

}  // namespace

// dtype 1 = bf16, 2 = f32 (q, k, v and out alike).  Returns 0, a
// cudaError_t from the launch, or -1 for arguments the kernel does not
// take.  Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int B,
                                      int Sq, int Skv, int H, int KV, int hd, int dtype, int causal,
                                      int window, int q_offset, float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H <= 0 || H % KV != 0 || hd <= 0 || hd > 256 ||
      q_offset < 0 || window < 0 || B * H > 65535)
    return kUnsupported;
  const Args a{q, k, v, out, B, Sq, Skv, H, KV, hd, causal, window, q_offset, softcap,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 1:
      return launch_hd<__nv_bfloat16>(a);
    case 2:
      return launch_hd<float>(a);
    default:
      return kUnsupported;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code == kUnsupported) return "unsupported shape or dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
