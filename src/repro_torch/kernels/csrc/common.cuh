// Shared helpers for the MWU kernels: launch geometry, correctly rounded
// arithmetic, and a fixed-order block reduction.
//
// Every kernel here is a bandwidth-bound sweep over one or two vectors.
// The TPU kernels carried their running reductions across a sequential
// grid in SMEM; on Hopper blocks run in no order, so each block writes a
// partial state and a one-block combine kernel folds the partials. The
// fold order depends only on the vector length (the number of partial
// blocks is a function of n), so a run is repeatable bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rt {

constexpr int kThreads = 256;          // threads per block, every kernel
constexpr int kWarps = kThreads / 32;

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

// Fold nb partial states (written by the sweep's blocks) in one block, in
// an order fixed by nb: thread i folds partials i, i+256, ... in order,
// then the block reduction folds the threads.
template <typename State>
__device__ State fold_partials(const State* part, int nb) {
  State s = State::identity();
  for (int i = threadIdx.x; i < nb; i += kThreads) s = combine(s, part[i]);
  return block_reduce(s);
}

}  // namespace rt

// A C entry point returns cudaGetLastError() of its launches; 0 is success.
#define RT_RETURN_LAUNCH_STATUS() return (int)cudaGetLastError()
