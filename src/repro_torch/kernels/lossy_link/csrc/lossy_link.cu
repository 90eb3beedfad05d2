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
// The egress draws its own uniforms from the key, in registers, bit-equal
// to jax.random.uniform(key, (T, D)) (the op the reference calls before its
// kernel, repro/kernels/lossy_link/ops.py); the burst mask takes its
// uniforms drawn outside (threefry, bit-equal to jax.random), as the TPU
// kernel takes them.  Both are held to their plain PyTorch versions bit for
// bit.
//
// Egress.  Element i of the (T, D) flattening takes u from one Threefry-2x32
// block of its own linear index: (w0, w1) = threefry2x32(key, (i >> 32,
// i & 0xffffffff)), bits = w0 ^ w1, u = float((bits >> 9) | 0x3f800000) - 1
// -- jax's partitionable scheme, repro_torch/prng.py:random_bits and
// uniform, with prng.py's rotations, key schedule and round injections.  So
// the (T, D) uniform tensor is never written or read, and the ~150 eager
// int64 launches that drew it are gone: the launch reads the key's two
// words from the device (no host sync), x, s_min, s_max, and writes out.
// Bound: HBM bytes (x read and out written, 4-8 bytes an element) against
// ~90 32-bit operations an element (the threefry block and the egress's
// 14), both far under the launch's own floor at the DI round's (4, 1024).
// One element a thread in a grid-stride loop; s_min / s_max are read per
// element (they stay in L1/L2: D floats).  The arithmetic is f32 in the
// reference's order, written with __fsub_rn / __fdiv_rn / __fmul_rn /
// __fadd_rn, which nvcc never contracts into an FMA (the build keeps its
// default -fmad=true), and rintf (round half to even, as jnp.round and
// torch.round).  The scalars (levels, p, comp, the range floor) are fixed on
// the host as the reference fixes them.
//
// Burst mask.  Bound: the dependent chain of each row, not bytes (R = 1 in
// every DI round: one chain of ~164 packets, 2 KB).  The TPU kernel
// advances a block of rows in lockstep down a fori_loop over the packet
// axis, one dependent step a packet.  Here a packet's state step depends
// only on u_tr: bad' = bad ? u_tr >= p_bg : u_tr < p_gb, so each step is
// one of the four maps {G,B} -> {G,B}, and composing maps is associative
// and exact.  One warp walks a row, a tile of kBurstTile packets at a time:
//   1. the warp stages the tile, coalesced along the packets, as four flag
//      bits a packet in shared memory (keep if good, keep if bad, next
//      state if good, next state if bad);
//   2. each lane folds its contiguous chunk of ceil(tile / 32) packets into
//      one map (2 bits: the image of G, the image of B);
//   3. an inclusive scan of the lanes' maps with __shfl_up_sync (5 steps),
//      applied to the state entering the tile, gives each lane the state
//      entering its chunk, and lane 31's gives the state entering the next
//      tile;
//   4. each lane walks its chunk again, from that state and from registers,
//      choosing keep bits;
//   5. the warp stores the tile as f32 0/1, coalesced.
// A tile's chain of up to 256 dependent steps becomes ceil(cols / 32) + 5 +
// ceil(cols / 32) (6 + 5 + 6 at N 164).  The comparisons and f32 thresholds
// are those of the reference's scan, so the masks are bit for bit the same.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnsupported = -1;
constexpr int kEgressThreads = 256;
constexpr int kEgressMaxBlocks = 132 * 16;
constexpr int kBurstWarps = 4;           // rows (chains) a block: one warp each
constexpr int kBurstTile = 256;          // packets a warp stages per pass
constexpr int kBurstPerLane = kBurstTile / 32;  // loads a lane per array, and its chunk at most
constexpr unsigned kIdentity = 0x2u;     // the map G -> G, B -> B
constexpr unsigned kFullMask = 0xffffffffu;

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

// Threefry-2x32, 20 rounds (repro_torch/prng.py:threefry2x32).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, kRot[i % 2][r]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x0, x1);
}

// jax.random.uniform's value at linear index i of a draw under key
// (k0, k1), partitionable scheme: the top 23 bits of one threefry block of
// i's (high, low) words become the mantissa of a float in [1, 2), minus 1.
__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1, int64_t i) {
  const uint2 w = threefry2x32(k0, k1, static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32),
                               static_cast<uint32_t>(i));
  return __fsub_rn(__uint_as_float(((w.x ^ w.y) >> 9) | 0x3F800000u), 1.0f);
}

template <typename T>
__global__ void __launch_bounds__(kEgressThreads)
    egress_kernel(const int64_t* __restrict__ key, const T* __restrict__ x,
                  const float* __restrict__ s_min, const float* __restrict__ s_max,
                  T* __restrict__ out, int64_t n, int D, EgressConsts c) {
  // A key is two uint32 words held in int64 (repro_torch/prng.py).
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float u = uniform_at(k0, k1, i);
    const int col = static_cast<int>(i % D);
    const float lo = s_min[col];
    const float hi = s_max[col];
    const float rng = fmaxf(__fsub_rn(hi, lo), c.rng_floor);
    const float clipped = fminf(fmaxf(to_f32(x[i]), lo), hi);
    const float code = rintf(__fmul_rn(__fdiv_rn(__fsub_rn(clipped, lo), rng), c.levels));
    const float deq = __fadd_rn(__fmul_rn(__fdiv_rn(code, c.levels), rng), lo);
    put(out, i, u >= c.p ? __fmul_rn(deq, c.comp) : 0.0f);
  }
}

// A map {G,B} -> {G,B} in 2 bits: bit 0 is the image of G, bit 1 the image
// of B (1 = bad).  then(f, g) is f followed by g.
__device__ __forceinline__ unsigned then(unsigned f, unsigned g) {
  return ((g >> (f & 1u)) & 1u) | (((g >> ((f >> 1) & 1u)) & 1u) << 1);
}

__global__ void __launch_bounds__(kBurstWarps * 32)
    burst_mask_kernel(const float* __restrict__ u_init, const float* __restrict__ u_loss,
                      const float* __restrict__ u_tr, float* __restrict__ out, int R, int N,
                      BurstConsts c) {
  __shared__ uint8_t flags[kBurstWarps][kBurstTile];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kBurstWarps + warp;
  if (row >= R) return;  // warp-uniform; the warps never sync with each other
  uint8_t* f = flags[warp];
  const float* ul = u_loss + static_cast<int64_t>(row) * N;
  const float* ut = u_tr + static_cast<int64_t>(row) * N;
  float* dst = out + static_cast<int64_t>(row) * N;
  unsigned bad = u_init[row] < c.pi_b ? 1u : 0u;  // the state entering the tile
  for (int t0 = 0; t0 < N; t0 += kBurstTile) {
    const int cols = min(kBurstTile, N - t0);
    const int chunk = (cols + 31) / 32;
    const int lo = min(lane * chunk, cols);  // the lane's chunk is [lo, lo + n)
    const int n = min(chunk, cols - lo);
    // Every load of the tile is issued before any is used.
    float l[kBurstPerLane];
    float tr[kBurstPerLane];
#pragma unroll
    for (int i = 0; i < kBurstPerLane; ++i) {
      const int t = lane + 32 * i;
      l[i] = t < cols ? ul[t0 + t] : 0.f;
      tr[i] = t < cols ? ut[t0 + t] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBurstPerLane; ++i) {
      const int t = lane + 32 * i;
      if (t < cols)
        f[t] = static_cast<uint8_t>((l[i] >= c.loss_good) | ((l[i] >= c.loss_bad) << 1) |
                                    ((tr[i] < c.p_gb) << 2) | ((tr[i] >= c.p_bg) << 3));
    }
    __syncwarp();
    // The chunk into registers, then folded into one map.  Keep the reads
    // out of the fold's loop: read inside it, the kernel took 3.42 us a
    // call on the H100 against 2.04 (R 1 x N 164, PERF.md section 6).
    unsigned bits[kBurstPerLane];
#pragma unroll
    for (int i = 0; i < kBurstPerLane; ++i) bits[i] = i < n ? f[lo + i] : 0u;
    unsigned m = kIdentity;
#pragma unroll
    for (int i = 0; i < kBurstPerLane; ++i)
      if (i < n) m = then(m, (bits[i] >> 2) & 3u);
    // Inclusive scan: lane l ends with lanes 0..l's maps in order.
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned prev = __shfl_up_sync(kFullMask, m, o);
      if (lane >= o) m = then(prev, m);
    }
    const unsigned up = __shfl_up_sync(kFullMask, m, 1);
    const unsigned last = __shfl_sync(kFullMask, m, 31);
    unsigned s = ((lane == 0 ? kIdentity : up) >> bad) & 1u;
#pragma unroll
    for (int i = 0; i < kBurstPerLane; ++i) {
      if (i < n) {
        const unsigned keep = s ? (bits[i] >> 1) & 1u : bits[i] & 1u;
        s = s ? (bits[i] >> 3) & 1u : (bits[i] >> 2) & 1u;
        f[lo + i] = static_cast<uint8_t>(keep);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kBurstPerLane; ++i) {
      const int t = lane + 32 * i;
      if (t < cols) dst[t0 + t] = f[t] ? 1.0f : 0.0f;
    }
    __syncwarp();  // the next tile's staging overwrites f
    bad = (last >> bad) & 1u;
  }
}

template <typename T>
int launch_egress(const void* key, const void* x, const void* s_min, const void* s_max, void* out,
                  int64_t n, int D, EgressConsts c, cudaStream_t stream) {
  const int64_t want = (n + kEgressThreads - 1) / kEgressThreads;
  const int blocks = static_cast<int>(want < kEgressMaxBlocks ? want : kEgressMaxBlocks);
  egress_kernel<T><<<blocks, kEgressThreads, 0, stream>>>(
      static_cast<const int64_t*>(key), static_cast<const T*>(x), static_cast<const float*>(s_min),
      static_cast<const float*>(s_max), static_cast<T*>(out), n, D, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Egress: key (2,) int64 (two uint32 words); x, out (T, D) of x_type (1 =
// bf16, 2 = f32); s_min, s_max (D,) f32; all contiguous.  Burst mask: u_init (R,), u_loss,
// u_tr, out (R, N) f32, contiguous.  Each returns 0, a cudaError_t from the
// launch, or -1 for arguments the kernel does not take; each launches on
// `stream`, does not synchronise and allocates nothing.
extern "C" int lossy_link_egress_launch(const void* key, const void* x, const void* s_min,
                                        const void* s_max, void* out, long long T, int D,
                                        int x_type, float levels, float p, float comp,
                                        float rng_floor, void* stream) {
  if (T <= 0 || D <= 0) return kUnsupported;
  const EgressConsts c{levels, p, comp, rng_floor};
  const int64_t n = static_cast<int64_t>(T) * D;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_type) {
    case 1:
      return launch_egress<__nv_bfloat16>(key, x, s_min, s_max, out, n, D, c, s);
    case 2:
      return launch_egress<float>(key, x, s_min, s_max, out, n, D, c, s);
    default:
      return kUnsupported;
  }
}

extern "C" int burst_mask_launch(const void* u_init, const void* u_loss, const void* u_tr, void* out,
                                 int R, int N, float pi_b, float p_gb, float p_bg, float loss_good,
                                 float loss_bad, void* stream) {
  if (R <= 0 || N <= 0) return kUnsupported;
  const BurstConsts c{pi_b, p_gb, p_bg, loss_good, loss_bad};
  const int blocks = (R + kBurstWarps - 1) / kBurstWarps;
  const int threads = 32 * (R < kBurstWarps ? R : kBurstWarps);
  burst_mask_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u_init), static_cast<const float*>(u_loss),
      static_cast<const float*>(u_tr), static_cast<float*>(out), R, N, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lossy_link_error_string(int code) {
  if (code == kUnsupported) return "unsupported shape or dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
