// Fused update: out = y + alpha*dy together with red = [min out, max out].
//
// Replaces src/repro/kernels/axpy_reduce/kernel.py:
// axpy_reduce_pallas (body _axpy_kernel).
//
// Bound on the H100: bytes. Read y and dy, write out: 3*sizeof(T)*n. At
// the main path's x update, E = 98.6M in f64, that is 2.37 GB, 0.71 ms at
// 3.35 TB/s; the min and max cost no extra pass.
//
// Design: one grid-stride sweep writes out and keeps a per-thread
// (min, max); each block writes one partial and one block folds them in a
// fixed order. out is rounded twice (no FMA), bit-equal to the plain
// y + alpha*dy. min and max start at +inf and -inf, which need no guard.
#include "common.cuh"

namespace rt {

template <typename T>
struct MinMax {
  T mn, mx;
  __device__ static MinMax identity() { return {pos_inf<T>(), neg_inf<T>()}; }
};

template <typename T>
__device__ __forceinline__ MinMax<T> combine(MinMax<T> a, MinMax<T> b) {
  return {a.mn < b.mn ? a.mn : b.mn, a.mx > b.mx ? a.mx : b.mx};
}

template <typename T>
__device__ __forceinline__ MinMax<T> shfl_down(MinMax<T> a, int off) {
  return {__shfl_down_sync(0xffffffffu, a.mn, off), __shfl_down_sync(0xffffffffu, a.mx, off)};
}

template <typename T>
__global__ void axpy_partials_kernel(const T* __restrict__ y, const T* __restrict__ dy, T alpha, int64_t n,
                                     T* __restrict__ out, MinMax<T>* __restrict__ part) {
  MinMax<T> st = MinMax<T>::identity();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const T o = add_rn(__ldg(y + i), mul_rn(alpha, __ldg(dy + i)));
    out[i] = o;
    st.mn = o < st.mn ? o : st.mn;
    st.mx = o > st.mx ? o : st.mx;
  }
  const MinMax<T> r = block_reduce(st);
  if (threadIdx.x == 0) part[blockIdx.x] = r;
}

template <typename T>
__global__ void axpy_combine_kernel(const MinMax<T>* __restrict__ part, int nb, T* __restrict__ red) {
  const MinMax<T> r = fold_partials(part, nb);
  if (threadIdx.x == 0) {
    red[0] = r.mn;
    red[1] = r.mx;
  }
}

// part: scratch of 2*nb values; red: [min, max].
template <typename T>
int axpy_reduce(const T* y, const T* dy, double alpha, int64_t n, int nb, T* out, T* part, T* red,
                cudaStream_t stream) {
  MinMax<T>* p = reinterpret_cast<MinMax<T>*>(part);
  axpy_partials_kernel<T><<<nb, kThreads, 0, stream>>>(y, dy, (T)alpha, n, out, p);
  axpy_combine_kernel<T><<<1, kThreads, 0, stream>>>(p, nb, red);
  RT_RETURN_LAUNCH_STATUS();
}

}  // namespace rt

extern "C" int rt_axpy_reduce_f32(const float* y, const float* dy, double alpha, int64_t n, int nb, float* out,
                                  float* part, float* red, void* stream) {
  return rt::axpy_reduce<float>(y, dy, alpha, n, nb, out, part, red, (cudaStream_t)stream);
}

extern "C" int rt_axpy_reduce_f64(const double* y, const double* dy, double alpha, int64_t n, int nb, double* out,
                                  double* part, double* red, void* stream) {
  return rt::axpy_reduce<double>(y, dy, alpha, n, nb, out, part, red, (cudaStream_t)stream);
}
