// Linear-recurrence scan for Hopper (sm_90a): all prefix states of
//   h[b, t, d] = a[b, t, d] * h[b, t - 1, d] + b[b, t, d],   h[b, -1, d] = h0[b, d],
// the state update of a selective SSM (Mamba) or an mLSTM over a flattened
// state dim D = d_inner * d_state, in f32.
//
// Replaces the Pallas TPU kernel ssm_scan_kernel
// (repro/kernels/ssm_scan/kernel.py:55, body _scan_kernel) and the vmap of
// it in ssm_scan/ops.py: the batch moves into the grid.
//
// Layouts (contiguous):  a, b (B, T, D) bf16 or f32 (the same dtype),
// h0 (B, D) bf16 or f32, out (B, T, D) f32.
//
// Bound: bytes.  Each step reads a and b and writes h: one FMA per 8-12
// bytes, far below the card's f32 rate per byte.
//
// Design: the TPU kernel carries h in a VMEM scratch tile across a
// sequential T grid axis (kernel.py:31-47, :80-88); a GPU grid runs in no
// order and carries nothing between blocks.  Here one thread owns one
// (b, d) lane and loops over all of T with h in a register; a warp covers
// 32 consecutive d, so every step's loads and stores are coalesced.  Each
// step is one fused multiply-add rounded once (__fmaf_rn), as XLA contracts
// the reference's a * h + b, so the kernel equals the reference and the
// port's plain version bit for bit.  A chunked two-pass scan (parallel
// over T) is the later work for speed at small B * D.
//
// ssm_scan_bwd_kernel, the gradient of the same function.  It replaces no
// Pallas kernel: the reference differentiates the Mamba layer's
// lax.associative_scan by autodiff (repro/models/mamba.py:75-126
// _chunked_selective_scan).  With g[t] the total adjoint of h[t]:
//   g[T-1] = dy[T-1],  g[t] = a[t+1] * g[t+1] + dy[t],
//   db[t] = g[t],  da[t] = g[t] * h[t-1]  (h[-1] = h0),  dh0 = a[0] * g[0],
// B6's own recurrence run in reverse with a shifted by one.  Layouts: a
// (B, T, D) bf16 or f32, dy and out (B, T, D) f32 (out = the forward's
// states), h0 (B, D) bf16 or f32; da, db (B, T, D) f32, dh0 (B, D) f32.
// Bound: bytes, 20 an element (a, dy and out read; da and db written).
// Design: the forward's layout and rounding rule.  One thread owns one
// (b, d) lane and walks t from T-1 down to 0 in place (no flipped copies),
// keeping g and a[t+1] in registers and reading h[t-1] from out; a warp
// covers 32 consecutive d, so every access is coalesced.  The g step is one
// __fmaf_rn and each product one __fmul_rn, so the kernel equals the plain
// reverse scan (torch_ref.ssm_scan_bwd_ref) bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnsupported = -1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename AT, typename HT>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const AT* __restrict__ a, const AT* __restrict__ b, const HT* __restrict__ h0,
                float* __restrict__ out, int T, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (d >= D) return;
  float h = to_f32(h0[static_cast<size_t>(bi) * D + d]);
  size_t i = static_cast<size_t>(bi) * T * D + d;
#pragma unroll 8
  for (int t = 0; t < T; ++t, i += D) {
    h = __fmaf_rn(to_f32(a[i]), h, to_f32(b[i]));
    out[i] = h;
  }
}

template <typename AT, typename HT>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const AT* __restrict__ a, const float* __restrict__ dy, const float* __restrict__ out,
                    const HT* __restrict__ h0, float* __restrict__ da, float* __restrict__ db,
                    float* __restrict__ dh0, int T, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (d >= D) return;
  const size_t lane = static_cast<size_t>(bi) * D + d;
  float g = 0.0f, a_next = 0.0f;
  size_t i = static_cast<size_t>(bi) * T * D + static_cast<size_t>(T - 1) * D + d;
#pragma unroll 8
  for (int t = T - 1; t >= 0; --t, i -= D) {
    g = __fmaf_rn(a_next, g, dy[i]);
    const float h_prev = t > 0 ? out[i - D] : to_f32(h0[lane]);
    db[i] = g;
    da[i] = __fmul_rn(g, h_prev);
    a_next = to_f32(a[i]);
  }
  dh0[lane] = __fmul_rn(a_next, g);
}

template <typename AT, typename HT>
int launch(const void* a, const void* b, const void* h0, void* out, int B, int T, int D,
           cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  ssm_scan_kernel<AT, HT><<<grid, kThreads, 0, stream>>>(
      static_cast<const AT*>(a), static_cast<const AT*>(b), static_cast<const HT*>(h0),
      static_cast<float*>(out), T, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename AT>
int launch_h(int h_type, const void* a, const void* b, const void* h0, void* out, int B, int T,
             int D, cudaStream_t stream) {
  switch (h_type) {
    case 1:
      return launch<AT, __nv_bfloat16>(a, b, h0, out, B, T, D, stream);
    case 2:
      return launch<AT, float>(a, b, h0, out, B, T, D, stream);
    default:
      return kUnsupported;
  }
}

template <typename AT, typename HT>
int launch_bwd(const void* a, const void* dy, const void* out, const void* h0, void* da, void* db, void* dh0,
               int B, int T, int D, cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  ssm_scan_bwd_kernel<AT, HT><<<grid, kThreads, 0, stream>>>(
      static_cast<const AT*>(a), static_cast<const float*>(dy), static_cast<const float*>(out),
      static_cast<const HT*>(h0), static_cast<float*>(da), static_cast<float*>(db), static_cast<float*>(dh0), T, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename AT>
int launch_bwd_h(int h_type, const void* a, const void* dy, const void* out, const void* h0, void* da, void* db,
                 void* dh0, int B, int T, int D, cudaStream_t stream) {
  switch (h_type) {
    case 1:
      return launch_bwd<AT, __nv_bfloat16>(a, dy, out, h0, da, db, dh0, B, T, D, stream);
    case 2:
      return launch_bwd<AT, float>(a, dy, out, h0, da, db, dh0, B, T, D, stream);
    default:
      return kUnsupported;
  }
}

}  // namespace

// Type codes 1 = bf16, 2 = f32: ab_type for a and b, h_type for h0.
// Returns 0, a cudaError_t from the launch, or -1 for arguments the kernel
// does not take.  Launches on `stream`, does not synchronise, allocates
// nothing.
extern "C" int ssm_scan_launch(const void* a, const void* b, const void* h0, void* out, int B,
                               int T, int D, int ab_type, int h_type, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || B > 65535) return kUnsupported;
  auto s = static_cast<cudaStream_t>(stream);
  switch (ab_type) {
    case 1:
      return launch_h<__nv_bfloat16>(h_type, a, b, h0, out, B, T, D, s);
    case 2:
      return launch_h<float>(h_type, a, b, h0, out, B, T, D, s);
    default:
      return kUnsupported;
  }
}

// The backward: a_type for a (1 = bf16, 2 = f32), h_type for h0; dy and out
// are f32.  Same return codes and stream rule as ssm_scan_launch.
extern "C" int ssm_scan_bwd_launch(const void* a, const void* dy, const void* out, const void* h0, void* da,
                                   void* db, void* dh0, int B, int T, int D, int a_type, int h_type,
                                   void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || B > 65535) return kUnsupported;
  auto s = static_cast<cudaStream_t>(stream);
  switch (a_type) {
    case 1:
      return launch_bwd_h<__nv_bfloat16>(h_type, a, dy, out, h0, da, db, dh0, B, T, D, s);
    case 2:
      return launch_bwd_h<float>(h_type, a, dy, out, h0, da, db, dh0, B, T, D, s);
    default:
      return kUnsupported;
  }
}

extern "C" const char* ssm_scan_error_string(int code) {
  if (code == kUnsupported) return "unsupported shape or dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
