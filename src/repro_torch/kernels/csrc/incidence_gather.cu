// Incidence gather: g[e] = w[u[e]] + w[v[e]]  (the product M^T w), times
// the edge factor f[e] of a masked or weighted operator where it has one.
//
// Replaces src/repro/kernels/incidence_gather/kernel.py:
// incidence_gather_pallas (body _gather_kernel), and the multiply by
// Incidence._w that src/repro/core/operators.py's rmatvec applies after it.
//
// Bound on the H100: bytes. Each edge reads two int32 indices and writes
// one value, 8 + sizeof(T) bytes an edge (16 at f64); w (n values) is read
// once from device memory and then served from the 50 MB L2 for graphs up
// to ~6M f64 vertices. At the main path's E = 98.6M, n = 498k in f64 that
// is 1.58 GB, 0.47 ms at 3.35 TB/s. The edge factor adds one mask byte and
// one weight an edge, where the operator has them. Beside the bytes, the
// lookups' L2 traffic: a lookup brings a 32-byte sector for the 8 bytes it
// uses wherever it misses the L1 (tools/gather_ab.py counts them).
//
// Design (gather.cuh, after tools/gather_ab.py's split of the kernel before
// it): the edges in tiles of 2,048, each thread eight edges 32 apart, so
// that every instruction covers 32 consecutive edges, their index loads and
// then all sixteen lookups in flight before the adds; the streams with
// evict-first hints; two waves of resident blocks, a tile a block at a
// time (tools/gather_ab.py --sweep chose eight edges a thread, the hints
// and two waves over 4 and 16 edges, no hints and one wave). At
// phase 6's bucket the lookups' 32-byte sectors from the L2 (97 MB of the
// scattered side's against 75 MB of streams) set the floor. The TPU
// kernel kept w resident in VMEM and capped the vertex count at 3M; here
// the L2 plays that role and there is no cap. The result is one rounded
// add (times f: one rounded multiply), bit-equal to the plain version.
// Indices are not range-checked on the device: the graph layer validates
// them once on the host.
#include "gather.cuh"

namespace rt {

template <typename T, bool kFactor>
__global__ void __launch_bounds__(kThreads)
    incidence_gather_kernel(const int32_t* __restrict__ u, const int32_t* __restrict__ v, const T* __restrict__ w,
                            const uint8_t* __restrict__ mask, const T* __restrict__ weights, T* __restrict__ g,
                            int64_t E) {
  const int64_t tiles = edge_tiles(E);
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    T o[kEdgeSlots];
    gather_tile<T, kFactor>(u, v, w, mask, weights, E, t, o);
#pragma unroll
    for (int j = 0; j < kEdgeSlots; ++j) {
      const int64_t e = edge_slot(t, j);
      if (e < E) st<true>(g + e, o[j]);
    }
  }
}

template <typename T, bool kFactor>
int launch_gather(const int32_t* u, const int32_t* v, const T* w, const uint8_t* mask, const T* weights, T* g,
                  int64_t E, cudaStream_t stream) {
  static std::atomic<int> known[64];
  int blocks = 0;
  const cudaError_t rc = wave_blocks(incidence_gather_kernel<T, kFactor>, known, blocks);
  if (rc != cudaSuccess) return (int)rc;
  const int64_t tiles = edge_tiles(E);
  if (tiles == 0) return 0;
  incidence_gather_kernel<T, kFactor>
      <<<(int)(tiles < blocks ? tiles : blocks), kThreads, 0, stream>>>(u, v, w, mask, weights, g, E);
  RT_RETURN_LAUNCH_STATUS();
}

template <typename T>
int incidence_gather(const int32_t* u, const int32_t* v, const T* w, const uint8_t* mask, const T* weights, T* g,
                     int64_t E, cudaStream_t stream) {
  return mask || weights ? launch_gather<T, true>(u, v, w, mask, weights, g, E, stream)
                         : launch_gather<T, false>(u, v, w, mask, weights, g, E, stream);
}

}  // namespace rt

extern "C" int rt_incidence_gather_f32(const int32_t* u, const int32_t* v, const float* w, const uint8_t* mask,
                                       const float* weights, float* g, int64_t E, void* stream) {
  return rt::incidence_gather<float>(u, v, w, mask, weights, g, E, (cudaStream_t)stream);
}

extern "C" int rt_incidence_gather_f64(const int32_t* u, const int32_t* v, const double* w, const uint8_t* mask,
                                       const double* weights, double* g, int64_t E, void* stream) {
  return rt::incidence_gather<double>(u, v, w, mask, weights, g, E, (cudaStream_t)stream);
}

extern "C" const char* rt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
