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
// (min, max), kUnroll elements a thread in flight; each block writes one
// partial and one block folds them in a fixed order. out is rounded twice
// (no FMA), bit-equal to the plain y + alpha*dy. min and max start at +inf
// and -inf, which need no guard, and are written widened to double
// (exact), so that the MWU loop can point red into its lane record. alpha is a host double or, in the
// device form, a double in device memory (the Newton search's step), read
// by every thread and rounded to T as the host form rounds it: the two
// forms give the same bits. out may be y itself (an update in place: each
// element is read and written by one thread), so y and out are not
// declared __restrict__.
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
__device__ __forceinline__ void axpy_one(T yv, T dv, T alpha, T* o, MinMax<T>& st) {
  const T v = add_rn(yv, mul_rn(alpha, dv));
  *o = v;
  st.mn = v < st.mn ? v : st.mn;
  st.mx = v > st.mx ? v : st.mx;
}

// A thread takes kUnroll elements a step, all loaded before any is stored:
// y and out may alias, so the compiler may not move a load of y past a
// store to out, and the loads of a step are what keeps bytes in flight.
constexpr int kUnroll = 4;

template <typename T>
__global__ void axpy_partials_kernel(const T* y, const T* __restrict__ dy, T alpha_host,
                                     const double* __restrict__ alpha_dev, int64_t n, T* out,
                                     MinMax<T>* __restrict__ part) {
  const T alpha = alpha_dev ? (T)__ldg(alpha_dev) : alpha_host;
  MinMax<T> st = MinMax<T>::identity();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    T yv[kUnroll], dv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      yv[u] = y[i + u * stride];
      dv[u] = __ldg(dy + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) axpy_one(yv[u], dv[u], alpha, out + i + u * stride, st);
  }
  for (; i < n; i += stride) axpy_one(y[i], __ldg(dy + i), alpha, out + i, st);
  const MinMax<T> r = block_reduce(st);
  if (threadIdx.x == 0) part[blockIdx.x] = r;
}

template <typename T>
__global__ void axpy_combine_kernel(const MinMax<T>* __restrict__ part, int nb, double* __restrict__ red) {
  const MinMax<T> r = fold_partials(part, nb);
  if (threadIdx.x == 0) {
    red[0] = (double)r.mn;
    red[1] = (double)r.mx;
  }
}

// part: scratch of 2*nb values; red: [min, max] in double; alpha_dev: null
// (the host form, alpha) or the step in device memory.
template <typename T>
int axpy_reduce(const T* y, const T* dy, double alpha, const double* alpha_dev, int64_t n, int nb, T* out, T* part,
                double* red, cudaStream_t stream) {
  MinMax<T>* p = reinterpret_cast<MinMax<T>*>(part);
  axpy_partials_kernel<T><<<nb, kThreads, 0, stream>>>(y, dy, (T)alpha, alpha_dev, n, out, p);
  axpy_combine_kernel<T><<<1, kThreads, 0, stream>>>(p, nb, red);
  RT_RETURN_LAUNCH_STATUS();
}

}  // namespace rt

extern "C" int rt_axpy_reduce_f32(const float* y, const float* dy, double alpha, const double* alpha_dev, int64_t n,
                                  int nb, float* out, float* part, double* red, void* stream) {
  return rt::axpy_reduce<float>(y, dy, alpha, alpha_dev, n, nb, out, part, red, (cudaStream_t)stream);
}

extern "C" int rt_axpy_reduce_f64(const double* y, const double* dy, double alpha, const double* alpha_dev,
                                  int64_t n, int nb, double* out, double* part, double* red, void* stream) {
  return rt::axpy_reduce<double>(y, dy, alpha, alpha_dev, n, nb, out, part, red, (cudaStream_t)stream);
}
