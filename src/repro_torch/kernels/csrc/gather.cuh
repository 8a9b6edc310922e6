// The incidence gather's body, shared by the lone gather
// (incidence_gather.cu) and the step direction's gather source
// (step_direction.cu): g = w[u] + w[v] for a tile of edges, times the edge
// factor where the operator has one.
//
// A tile is kEdgeTile = 2,048 consecutive edges, 256 a warp; in it a thread
// takes kEdgeSlots = 8 edges 32 apart (slot j of lane l: the warp's edge
// j * 32 + l), so every load and store of a stream is one warp instruction
// over 32 consecutive edges, and every lookup instruction looks up 32
// consecutive edges' vertices: a sorted side (users ascending, erdos edges
// by u) then falls in a sector or two of w, as in the kernel before, where
// lanes each holding four consecutive edges (16-byte index loads, tried
// first) spread one lookup instruction over 128 edges and raised the L2's
// sector traffic at phase 6's bucket (tools/gather_ab.py). A thread issues
// its eight edges' index loads (and the factor's), then all sixteen
// lookups, before the first add: eight edges in flight where one edge a
// thread left two dependent loads. A grid is two waves of resident
// blocks, so that the tiles' tail balances. The edge streams (and the lone
// gather's g) are read and written with the evict-first hints (__ldcs,
// __stcs), so that they do not push w out of the L2. An absent edge (past
// E) looks up w[0] and is never stored or folded. The arithmetic is the
// plain version's: one rounded add (add_rn), times the factor in one
// rounded multiply (mul_rn).
#pragma once

#include "common.cuh"

namespace rt {

constexpr int kEdgeSlots = 8;  // a thread's edges a tile
constexpr int64_t kEdgeTile = (int64_t)kThreads * kEdgeSlots;
// Grids of kEdgeWaves waves of resident blocks, each block a tile at a time
// (tools/gather_ab.py --sweep: two waves balance the tiles' tail better
// than one, at both shapes).
constexpr int kEdgeWaves = 2;

// Edge of slot j of this thread in tile t.
__device__ __forceinline__ int64_t edge_slot(int64_t tile, int j) {
  return tile * kEdgeTile + (int64_t)(threadIdx.x >> 5) * (32 * kEdgeSlots) + j * 32 + (threadIdx.x & 31);
}

__host__ __device__ inline int64_t edge_tiles(int64_t E) { return (E + kEdgeTile - 1) / kEdgeTile; }

// Loads and stores of kStream with the evict-first hints (__ldcs, __stcs),
// else with the read-only path and plain stores (vectors the next kernels
// read again).
template <bool kStream, typename V>
__device__ __forceinline__ V ld(const V* p) {
  if constexpr (kStream) {
    return __ldcs(p);
  } else {
    return __ldg(p);
  }
}
template <bool kStream, typename V>
__device__ __forceinline__ void st(V* p, V x) {
  if constexpr (kStream) {
    __stcs(p, x);
  } else {
    *p = x;
  }
}

// g of this thread's kEdgeSlots edges of tile `tile` (slot j: edge
// edge_slot(tile, j)) of the E edges (u[e], v[e]) over the vector w, times
// the edge factor of mask (one byte an edge) and weights, either null,
// where kFactor. The factor is the plain version's (Incidence._w):
// weights[e] (1 without weights) where the mask's byte is nonzero (every
// edge without a mask), else 0, so that g * factor rounds as the plain
// chain's multiply does, NaN and signed zero included. An absent edge's
// slot is w[0] + w[0] (times 1). The kernels pass every pointer as a
// __restrict__ argument: with the pointers in a struct nvcc gave the f64
// gather 32 registers, too few for its sixteen lookups in flight, and it
// ran 0.0436 ms at phase 6's bucket against 0.0407 with 44 registers
// (tools/gather_ab.py, NVIDIA H100 80GB HBM3).
template <typename T, bool kFactor>
__device__ __forceinline__ void gather_tile(const int32_t* __restrict__ u, const int32_t* __restrict__ v,
                                            const T* __restrict__ w, const uint8_t* __restrict__ mask,
                                            const T* __restrict__ weights, int64_t E, int64_t tile,
                                            T (&g)[kEdgeSlots]) {
  int32_t iu[kEdgeSlots], iv[kEdgeSlots];
  T f[kEdgeSlots];
#pragma unroll
  for (int j = 0; j < kEdgeSlots; ++j) {
    const int64_t e = edge_slot(tile, j);
    const bool in = e < E;
    iu[j] = in ? ld<true>(u + e) : 0;
    iv[j] = in ? ld<true>(v + e) : 0;
    if (kFactor) {
      f[j] = in && weights != nullptr ? ld<true>(weights + e) : T(1);
      if (in && mask != nullptr && ld<true>(mask + e) == 0) f[j] = T(0);
    }
  }
  T a[kEdgeSlots], b[kEdgeSlots];
#pragma unroll
  for (int j = 0; j < kEdgeSlots; ++j) {
    a[j] = __ldg(w + iu[j]);
    b[j] = __ldg(w + iv[j]);
  }
#pragma unroll
  for (int j = 0; j < kEdgeSlots; ++j) {
    g[j] = add_rn(a[j], b[j]);
    if (kFactor) g[j] = mul_rn(g[j], f[j]);
  }
}

// Blocks of kEdgeWaves waves of `kernel` (the SMs times the blocks an SM
// holds, by the occupancy calculator, twice), kept per device in `known`.
template <typename Kernel>
inline cudaError_t wave_blocks(Kernel kernel, std::atomic<int> (&known)[64], int& blocks) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 64 && (blocks = known[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return rc;
  if ((rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)kernel, kThreads, 0)) != cudaSuccess)
    return rc;
  blocks = kEdgeWaves * sms * (per_sm < 1 ? 1 : per_sm);
  if (dev < 64) known[dev].store(blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace rt
