// Softmax weights: with a = se*v (se = sign*eta),
//   lse = logsumexp(a),  w = exp(a - lse).
//
// Replaces src/repro/kernels/softmax_weights/kernel.py:
// softmax_weights_pallas (bodies _reduce_kernel and _normalize_kernel).
//
// Bound on the H100: bytes. v is read twice by necessity (lse must be
// known before any w is written) and w is written once: 3*sizeof(T)*n.
// The least traffic is 2*sizeof(T)*n (read v once, write w once), which
// the bound in chip_smoke.py counts. At the main path's n = 498k f64 that
// is 8 MB, 2.4 us; there the three launches' fixed cost dominates.
//
// Design: three launches on one stream. (1) A grid-stride sweep keeps an
// online (max m, scaled sum s) per thread, reduces it over the block and
// writes one partial per block. (2) One block folds the partials in a
// fixed order into [m, lse]. (3) A second sweep writes w. The TPU kernel's
// finite -1e30 padding sentinel is replaced by -inf with a guard in the
// combine: two empty states give (-inf, 0), never exp(-inf - -inf) = NaN.
#include "common.cuh"

namespace rt {

template <typename T>
struct MaxSum {
  T m, s;
  __device__ static MaxSum identity() { return {neg_inf<T>(), T(0)}; }
};

template <typename T>
__device__ __forceinline__ MaxSum<T> combine(MaxSum<T> a, MaxSum<T> b) {
  const T m = a.m > b.m ? a.m : b.m;
  if (m == neg_inf<T>()) return a;  // both empty
  return {m, a.s * exp_(a.m - m) + b.s * exp_(b.m - m)};
}

template <typename T>
__device__ __forceinline__ MaxSum<T> shfl_down(MaxSum<T> a, int off) {
  return {__shfl_down_sync(0xffffffffu, a.m, off), __shfl_down_sync(0xffffffffu, a.s, off)};
}

template <typename T>
__global__ void softmax_partials_kernel(const T* __restrict__ v, T se, int64_t n, MaxSum<T>* __restrict__ part) {
  T m = neg_inf<T>(), s = T(0);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const T a = mul_rn(__ldg(v + i), se);
    if (a > m) {
      s = s * exp_(m - a) + T(1);
      m = a;
    } else {
      s += exp_(a - m);
    }
  }
  const MaxSum<T> r = block_reduce(MaxSum<T>{m, s});
  if (threadIdx.x == 0) part[blockIdx.x] = r;
}

template <typename T>
__global__ void softmax_combine_kernel(const MaxSum<T>* __restrict__ part, int nb, T* __restrict__ stats) {
  const MaxSum<T> r = fold_partials(part, nb);
  if (threadIdx.x == 0) {
    stats[0] = r.m;
    stats[1] = r.m + log_(r.s);
  }
}

template <typename T>
__global__ void softmax_normalize_kernel(const T* __restrict__ v, T se, int64_t n, const T* __restrict__ stats,
                                         T* __restrict__ w) {
  const T lse = stats[1];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    w[i] = exp_(mul_rn(__ldg(v + i), se) - lse);
  }
}

// part: scratch of 2*nb values; stats: [m, lse]; w: n values.
template <typename T>
int softmax_weights(const T* v, double se, int64_t n, int nb, T* part, T* stats, T* w, cudaStream_t stream) {
  MaxSum<T>* p = reinterpret_cast<MaxSum<T>*>(part);
  softmax_partials_kernel<T><<<nb, kThreads, 0, stream>>>(v, (T)se, n, p);
  softmax_combine_kernel<T><<<1, kThreads, 0, stream>>>(p, nb, stats);
  softmax_normalize_kernel<T><<<sweep_blocks(n, 132 * 8), kThreads, 0, stream>>>(v, (T)se, n, stats, w);
  RT_RETURN_LAUNCH_STATUS();
}

}  // namespace rt

extern "C" int rt_softmax_weights_f32(const float* v, double se, int64_t n, int nb, float* part, float* stats,
                                      float* w, void* stream) {
  return rt::softmax_weights<float>(v, se, n, nb, part, stats, w, (cudaStream_t)stream);
}

extern "C" int rt_softmax_weights_f64(const double* v, double se, int64_t n, int nb, double* part, double* stats,
                                      double* w, void* stream) {
  return rt::softmax_weights<double>(v, se, n, nb, part, stats, w, (cudaStream_t)stream);
}
