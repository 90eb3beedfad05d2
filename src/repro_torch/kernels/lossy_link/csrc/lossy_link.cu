// Split-point link kernels for Hopper (sm_90a): the fused lossy-link egress
// and the Gilbert-Elliott (GE) burst mask of the DI round's emulated link.
//
// Replaces two Pallas TPU kernels of repro/kernels/lossy_link/kernel.py:
//   * lossy_link_egress_kernel (kernel.py:140, body _egress_kernel :32) --
//     per element of the (T, D) split activation: clip to [s_min, s_max],
//     round to an n-bit code, dequantize, keep if u >= p, scale by comp;
//   * burst_mask_kernel (kernel.py:94, body _burst_mask_kernel :57) -- one
//     two-state Markov chain per row: stationary initial state, keep a
//     packet if u_loss >= loss_{good,bad}, then step the state on u_tr.
// The uniforms are drawn outside (threefry, bit-equal to jax.random) and
// streamed in, as the TPU kernels take them, so both kernels are held to
// their plain PyTorch versions bit for bit.
//
// Egress.  Bound: HBM bytes (~12 flops per 10-14 bytes of x, u and out).
// One element a thread in a grid-stride loop; s_min / s_max are read per
// element (they stay in L1/L2: D floats).  The arithmetic is f32 in the
// reference's order, written with __fsub_rn / __fdiv_rn / __fmul_rn /
// __fadd_rn, which nvcc never contracts into an FMA (the build keeps its
// default -fmad=true), and rintf (round half to even, as jnp.round and
// torch.round).  The scalars (levels, p, comp, the range floor) are fixed on
// the host as the reference fixes them.
//
// Burst mask.  Bound: the N-step dependent chain of each row, not bytes
// (R = 1 in every DI round: one chain of ~164 packets).  The per-packet
// decisions do not depend on the state, so a block first stages a tile of
// kRows rows x kChunk packets with all its threads, coalesced along the
// packets, as four flag bits a packet in shared memory (keep if good, keep
// if bad, next state if good, next state if bad); then one thread a row
// walks its chunk with the state in a register, choosing bits; then all
// threads store the tile as f32 0/1.  The TPU kernel advances a block of
// rows in lockstep down a fori_loop over the packet axis; a faster design
// would compose the per-packet maps {G,B} -> {G,B} as an associative scan
// across a warp (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnsupported = -1;
constexpr int kEgressThreads = 256;
constexpr int kEgressMaxBlocks = 132 * 16;
constexpr int kBurstThreads = 256;
constexpr int kRows = 32;        // chains a block walks: one warp of walkers
constexpr int kChunk = 256;      // packets staged per pass
constexpr int kChunkPitch = kChunk + 4;  // row pitch in bytes: walkers hit distinct banks

struct EgressConsts {
  float levels, p, comp, rng_floor;
};

struct BurstConsts {
  float pi_b, p_gb, p_bg, loss_good, loss_bad;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, int64_t i, float v) { p[i] = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kEgressThreads)
    egress_kernel(const T* __restrict__ x, const float* __restrict__ u,
                  const float* __restrict__ s_min, const float* __restrict__ s_max,
                  T* __restrict__ out, int64_t n, int D, EgressConsts c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int col = static_cast<int>(i % D);
    const float lo = s_min[col];
    const float hi = s_max[col];
    const float rng = fmaxf(__fsub_rn(hi, lo), c.rng_floor);
    const float clipped = fminf(fmaxf(to_f32(x[i]), lo), hi);
    const float code = rintf(__fmul_rn(__fdiv_rn(__fsub_rn(clipped, lo), rng), c.levels));
    const float deq = __fadd_rn(__fmul_rn(__fdiv_rn(code, c.levels), rng), lo);
    put(out, i, u[i] >= c.p ? __fmul_rn(deq, c.comp) : 0.0f);
  }
}

__global__ void __launch_bounds__(kBurstThreads)
    burst_mask_kernel(const float* __restrict__ u_init, const float* __restrict__ u_loss,
                      const float* __restrict__ u_tr, float* __restrict__ out, int R, int N,
                      BurstConsts c) {
  __shared__ uint8_t flags[kRows * kChunkPitch];
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, R - row0);
  const int tid = threadIdx.x;
  bool bad = tid < rows && u_init[row0 + tid] < c.pi_b;
  for (int t0 = 0; t0 < N; t0 += kChunk) {
    const int cols = min(kChunk, N - t0);
    for (int k = tid; k < rows * kChunk; k += kBurstThreads) {
      const int r = k / kChunk;
      const int t = k % kChunk;
      if (t < cols) {
        const int64_t g = static_cast<int64_t>(row0 + r) * N + t0 + t;
        const float ul = u_loss[g];
        const float ut = u_tr[g];
        flags[r * kChunkPitch + t] = static_cast<uint8_t>(
            (ul >= c.loss_good) | ((ul >= c.loss_bad) << 1) | ((ut < c.p_gb) << 2) | ((ut >= c.p_bg) << 3));
      }
    }
    __syncthreads();
    if (tid < rows) {
      uint8_t* f = flags + tid * kChunkPitch;
      for (int t = 0; t < cols; ++t) {
        const unsigned bits = f[t];
        const unsigned keep = bad ? (bits >> 1) & 1u : bits & 1u;
        bad = bad ? (bits >> 3) & 1u : (bits >> 2) & 1u;
        f[t] = static_cast<uint8_t>(bits | (keep << 4));
      }
    }
    __syncthreads();
    for (int k = tid; k < rows * kChunk; k += kBurstThreads) {
      const int r = k / kChunk;
      const int t = k % kChunk;
      if (t < cols) {
        out[static_cast<int64_t>(row0 + r) * N + t0 + t] = (flags[r * kChunkPitch + t] >> 4) & 1 ? 1.0f : 0.0f;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_egress(const void* x, const void* u, const void* s_min, const void* s_max, void* out,
                  int64_t n, int D, EgressConsts c, cudaStream_t stream) {
  const int64_t want = (n + kEgressThreads - 1) / kEgressThreads;
  const int blocks = static_cast<int>(want < kEgressMaxBlocks ? want : kEgressMaxBlocks);
  egress_kernel<T><<<blocks, kEgressThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(u), static_cast<const float*>(s_min),
      static_cast<const float*>(s_max), static_cast<T*>(out), n, D, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Egress: x, out (T, D) of x_type (1 = bf16, 2 = f32); u (T, D) f32;
// s_min, s_max (D,) f32; all contiguous.  Burst mask: u_init (R,), u_loss,
// u_tr, out (R, N) f32, contiguous.  Each returns 0, a cudaError_t from the
// launch, or -1 for arguments the kernel does not take; each launches on
// `stream`, does not synchronise and allocates nothing.
extern "C" int lossy_link_egress_launch(const void* x, const void* u, const void* s_min,
                                        const void* s_max, void* out, long long T, int D,
                                        int x_type, float levels, float p, float comp,
                                        float rng_floor, void* stream) {
  if (T <= 0 || D <= 0) return kUnsupported;
  const EgressConsts c{levels, p, comp, rng_floor};
  const int64_t n = static_cast<int64_t>(T) * D;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_type) {
    case 1:
      return launch_egress<__nv_bfloat16>(x, u, s_min, s_max, out, n, D, c, s);
    case 2:
      return launch_egress<float>(x, u, s_min, s_max, out, n, D, c, s);
    default:
      return kUnsupported;
  }
}

extern "C" int burst_mask_launch(const void* u_init, const void* u_loss, const void* u_tr, void* out,
                                 int R, int N, float pi_b, float p_gb, float p_bg, float loss_good,
                                 float loss_bad, void* stream) {
  if (R <= 0 || N <= 0) return kUnsupported;
  const BurstConsts c{pi_b, p_gb, p_bg, loss_good, loss_bad};
  const int blocks = (R + kRows - 1) / kRows;
  burst_mask_kernel<<<blocks, kBurstThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u_init), static_cast<const float*>(u_loss),
      static_cast<const float*>(u_tr), static_cast<float*>(out), R, N, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lossy_link_error_string(int code) {
  if (code == kUnsupported) return "unsupported shape or dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
