// Shared helpers for the MWU kernels: launch geometry, correctly rounded
// arithmetic, a fixed-order block reduction, and the chunked sweep and
// cooperative launch of the one-launch reductions.
//
// Every kernel here is a bandwidth-bound sweep over one or two vectors.
// The TPU kernels carried their running reductions across a sequential
// grid in SMEM; on Hopper blocks run in no order, so each block writes a
// partial state and the partials are folded in block-index order: by a
// one-block combine kernel (axpy_reduce) or, in the one-launch reductions
// (softmax_weights, linesearch_probe, newton_search), after a grid barrier
// on a co-resident grid. The fold order depends only on the vector lengths
// and the card (the number of partial blocks is a function of n and of the
// grid a card holds), so a run is repeatable bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace rt {

constexpr int kThreads = 256;          // threads per block, every kernel
constexpr int kWarps = kThreads / 32;
// Most blocks per SM of a cooperative (co-resident) grid (coop_blocks). A
// fold holds kFoldSlots partials a thread in registers, so a one-launch
// reduction takes at most kMaxPartials blocks, and its partials' scratch
// holds that many (rt_max_partials tells the wrappers).
constexpr int kCoopBlocksPerSM = 2;
constexpr int kFoldSlots = 2;
constexpr int kMaxPartials = kFoldSlots * kThreads;

// Grid-stride launch size for a sweep over n elements: enough blocks to
// fill 132 SMs at 8 resident blocks each, fewer for short vectors.
inline int sweep_blocks(int64_t n, int max_blocks) {
  int64_t b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > max_blocks) b = max_blocks;
  return (int)b;
}

// y + alpha*dy rounded twice, as the plain version computes it: nvcc
// would otherwise contract the pair into one FMA and differ by an ulp.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
// The same for the sums of the reductions, so that two kernels sharing
// them (linesearch_probe and newton_search) round alike whatever nvcc
// would contract in each.
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }

template <typename T>
__device__ __forceinline__ T neg_inf() { return -INFINITY; }
template <typename T>
__device__ __forceinline__ T pos_inf() { return INFINITY; }

// Fixed-order reduction of one State per thread over the block. State
// provides shfl_down(state, offset), combine(a, b) and an identity. The
// result is valid in thread 0.
template <typename State>
__device__ State block_reduce(State s) {
  __shared__ State warp_part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // warp 0 of a previous call may still read warp_part
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = combine(s, shfl_down(s, off));
  if (lane == 0) warp_part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? warp_part[lane] : State::identity();
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = combine(s, shfl_down(s, off));
  }
  return s;
}

// block_reduce's result in every thread.
template <typename State>
__device__ State block_all_reduce(State s) {
  __shared__ State all;
  s = block_reduce(s);
  if (threadIdx.x == 0) all = s;
  __syncthreads();
  return all;
}

// The log-sum-exp reductions fold a block's (or the grid's) states in two
// phases: the max first, by plain comparisons, then each state rescaled
// to it by one exp and the rescaled sums added up. A tree of online
// combines would instead put one exp on every level of the tree.
template <typename T>
struct Max {
  T m;
  __device__ static Max identity() { return {neg_inf<T>()}; }
};

template <typename T>
__device__ __forceinline__ Max<T> combine(Max<T> a, Max<T> b) {
  return {a.m > b.m ? a.m : b.m};
}

template <typename T>
__device__ __forceinline__ Max<T> shfl_down(Max<T> a, int off) {
  return {__shfl_down_sync(0xffffffffu, a.m, off)};
}

// exp(m - mx), the factor that rescales a sum kept at max m to max mx;
// 0 when every state is empty (mx = -inf).
template <typename T>
__device__ __forceinline__ T rescale(T m, T mx) {
  return mx == neg_inf<T>() ? T(0) : exp_(sub_rn(m, mx));
}

// Fold nb partial states (written by the sweep's blocks) in one block, in
// an order fixed by nb: thread i folds partials i, i+256, ... in order,
// then the block reduction folds the threads.
template <typename State>
__device__ State fold_partials(const State* part, int nb) {
  State s = State::identity();
  for (int i = threadIdx.x; i < nb; i += kThreads) s = combine(s, part[i]);
  return block_reduce(s);
}

// The chunks of the one-launch reductions. A vector of n elements is cut
// into tiles of kTile elements; block b of nb takes tiles b, b + nb, ...
// In a tile, thread t takes kSize elements through kLoads 16-byte loads:
// load l covers elements l*kThreads*kVec + t*kVec + [0, kVec), so a warp's
// load is 512 contiguous bytes. Past n an element is absent; a pointer off
// 16-byte alignment takes the same elements with scalar loads.
template <typename T>
struct Chunk {
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kLoads = 4;
  static constexpr int kSize = kVec * kLoads;
  static constexpr int64_t kTile = (int64_t)kThreads * kSize;
  __device__ static int64_t index(int64_t tile, int j) {
    return tile * kTile + (int64_t)(j / kVec) * (kThreads * kVec) + (int64_t)threadIdx.x * kVec + j % kVec;
  }
};

template <typename T>
__host__ __device__ inline int64_t tiles(int64_t n) { return (n + Chunk<T>::kTile - 1) / Chunk<T>::kTile; }

// Whether element i of a vector of n takes part in a masked reduction: it
// lies before n and its byte of `keep` is nonzero (keep null: every element
// before n). The mask is read in the sweep's own stream, one byte an
// element, so a kept element's arithmetic is the unmasked kernel's.
__device__ __forceinline__ bool kept(const uint8_t* __restrict__ keep, int64_t i, int64_t n) {
  return i < n && (keep == nullptr || __ldg(keep + i) != 0);
}

__device__ __forceinline__ bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}
__device__ __forceinline__ void load16(const double* p, double* o) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  o[0] = q.x; o[1] = q.y;
}
__device__ __forceinline__ void store16(float* p, const float* o) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store16(double* p, const double* o) {
  *reinterpret_cast<double2*>(p) = make_double2(o[0], o[1]);
}

// This thread's chunk of tile `tile` of x[0, n); absent elements read 0.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ x, int64_t n, int64_t tile, bool vec,
                                           T (&out)[Chunk<T>::kSize]) {
  using C = Chunk<T>;
#pragma unroll
  for (int l = 0; l < C::kLoads; ++l) {
    const int64_t i0 = C::index(tile, l * C::kVec);
    if (vec && i0 + C::kVec <= n) {
      load16(x + i0, out + l * C::kVec);
    } else {
#pragma unroll
      for (int e = 0; e < C::kVec; ++e) out[l * C::kVec + e] = i0 + e < n ? __ldg(x + i0 + e) : T(0);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* __restrict__ x, int64_t n, int64_t tile, bool vec,
                                            const T (&in)[Chunk<T>::kSize]) {
  using C = Chunk<T>;
#pragma unroll
  for (int l = 0; l < C::kLoads; ++l) {
    const int64_t i0 = C::index(tile, l * C::kVec);
    if (vec && i0 + C::kVec <= n) {
      store16(x + i0, in + l * C::kVec);
    } else {
#pragma unroll
      for (int e = 0; e < C::kVec; ++e)
        if (i0 + e < n) x[i0 + e] = in[l * C::kVec + e];
    }
  }
}

// The most blocks of a co-resident grid of `kernel` on the current device:
// the blocks an SM holds by the occupancy calculator, at most
// kCoopBlocksPerSM, times the SMs, at most kMaxPartials. Kept per device.
template <typename Params>
inline cudaError_t coop_blocks(void (*kernel)(Params), int& blocks) {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < kDevices && (blocks = known[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return rc;
  if ((rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)kernel, kThreads, 0)) != cudaSuccess)
    return rc;
  per_sm = per_sm < kCoopBlocksPerSM ? per_sm : kCoopBlocksPerSM;
  blocks = sms * per_sm < kMaxPartials ? sms * per_sm : kMaxPartials;
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (dev < kDevices) known[dev].store(blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

// Launch kernel(params) on a co-resident grid (cooperative launch), with
// `smem` bytes of dynamic shared memory a block, so that it may wait at a
// grid barrier; a grid that cannot be co-resident is refused with
// cudaErrorCooperativeLaunchTooLarge, never run.
template <typename Params>
inline int launch_cooperative(void (*kernel)(Params), int blocks, const Params& params, cudaStream_t stream,
                              size_t smem = 0) {
  void* args[] = {const_cast<Params*>(&params)};
  const cudaError_t rc = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(kThreads), args, smem,
                                                     stream);
  if (rc != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next entry point does not report it
    return (int)rc;
  }
  return (int)cudaGetLastError();
}

}  // namespace rt

// A C entry point returns cudaGetLastError() of its launches; 0 is success.
#define RT_RETURN_LAUNCH_STATUS() return (int)cudaGetLastError()
