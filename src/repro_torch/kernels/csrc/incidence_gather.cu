// Incidence gather: g[e] = w[u[e]] + w[v[e]]  (the product M^T w).
//
// Replaces src/repro/kernels/incidence_gather/kernel.py:
// incidence_gather_pallas (body _gather_kernel).
//
// Bound on the H100: bytes. Each edge reads two int32 indices and writes
// one value, 8 + sizeof(T) bytes an edge (16 at f64); w (n values) is read
// once from device memory and then served from the 50 MB L2 for graphs up
// to ~6M f64 vertices. At the main path's E = 98.6M, n = 498k in f64 that
// is 1.58 GB, 0.47 ms at 3.35 TB/s.
//
// Design: one thread per edge in a grid-stride loop; consecutive threads
// read consecutive indices, so the index and output streams are coalesced
// and only the w lookups are scattered (into L2). The TPU kernel kept w
// resident in VMEM and capped the vertex count at 3M; here the L2 plays
// that role and there is no cap. The result is one rounded add, bit-equal
// to the plain version. Indices are not range-checked on the device: the
// graph layer validates them once on the host.
#include "common.cuh"

namespace rt {

template <typename T>
__global__ void incidence_gather_kernel(const int32_t* __restrict__ u, const int32_t* __restrict__ v,
                                        const T* __restrict__ w, T* __restrict__ g, int64_t E) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < E; e += stride) {
    g[e] = add_rn(__ldg(w + __ldg(u + e)), __ldg(w + __ldg(v + e)));
  }
}

template <typename T>
int incidence_gather(const int32_t* u, const int32_t* v, const T* w, T* g, int64_t E, cudaStream_t stream) {
  const int blocks = sweep_blocks(E, 132 * 16);
  incidence_gather_kernel<T><<<blocks, kThreads, 0, stream>>>(u, v, w, g, E);
  RT_RETURN_LAUNCH_STATUS();
}

}  // namespace rt

extern "C" int rt_incidence_gather_f32(const int32_t* u, const int32_t* v, const float* w, float* g, int64_t E,
                                       void* stream) {
  return rt::incidence_gather<float>(u, v, w, g, E, (cudaStream_t)stream);
}

extern "C" int rt_incidence_gather_f64(const int32_t* u, const int32_t* v, const double* w, double* g, int64_t E,
                                       void* stream) {
  return rt::incidence_gather<double>(u, v, w, g, E, (cudaStream_t)stream);
}

extern "C" const char* rt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
