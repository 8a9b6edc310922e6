// Line-search probe: with v = y + alpha*dy and a = se*v (se = sign*eta),
//   lse = logsumexp(a),  slope = sum softmax(a)_i * dy_i,  mn = min v,
// written as out = [lse, slope, mn].
//
// Replaces src/repro/kernels/linesearch_probe/kernel.py:
// linesearch_probe_pallas (body _probe_kernel).
//
// Bound on the H100: bytes. One read of y and dy, 2*sizeof(T)*n bytes, and
// three values written. At the main path's n = 498k f64 that is 8 MB,
// 2.4 us: a probe there costs about as much as its two launches and the
// host read of its result that the step-size search makes after it.
//
// Design: one grid-stride sweep in which each thread keeps the
// flash-style state (m, s, t) of the TPU kernel plus the running min,
// one exp per element (the rescale exp is taken only when the max moves).
// Each block writes its partial state; one block folds the partials in a
// fixed order and writes out. v is rounded as the plain version rounds
// it (no FMA), so mn is exact against it. The -inf sentinel is guarded in
// the combine, as in softmax_weights.cu.
#include "common.cuh"

namespace rt {

template <typename T>
struct ProbeState {
  T m, s, t, mn;
  __device__ static ProbeState identity() { return {neg_inf<T>(), T(0), T(0), pos_inf<T>()}; }
};

template <typename T>
__device__ __forceinline__ ProbeState<T> combine(ProbeState<T> a, ProbeState<T> b) {
  const T mn = a.mn < b.mn ? a.mn : b.mn;
  const T m = a.m > b.m ? a.m : b.m;
  if (m == neg_inf<T>()) return {m, T(0), T(0), mn};  // both empty
  const T ca = exp_(a.m - m), cb = exp_(b.m - m);
  return {m, a.s * ca + b.s * cb, a.t * ca + b.t * cb, mn};
}

template <typename T>
__device__ __forceinline__ ProbeState<T> shfl_down(ProbeState<T> a, int off) {
  return {__shfl_down_sync(0xffffffffu, a.m, off), __shfl_down_sync(0xffffffffu, a.s, off),
          __shfl_down_sync(0xffffffffu, a.t, off), __shfl_down_sync(0xffffffffu, a.mn, off)};
}

template <typename T>
__global__ void probe_partials_kernel(const T* __restrict__ y, const T* __restrict__ dy, T alpha, T se, int64_t n,
                                      ProbeState<T>* __restrict__ part) {
  ProbeState<T> st = ProbeState<T>::identity();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const T d = __ldg(dy + i);
    const T v = add_rn(__ldg(y + i), mul_rn(alpha, d));
    const T a = mul_rn(v, se);
    if (a > st.m) {
      const T c = exp_(st.m - a);
      st.s = st.s * c + T(1);
      st.t = st.t * c + d;
      st.m = a;
    } else {
      const T e = exp_(a - st.m);
      st.s += e;
      st.t += e * d;
    }
    st.mn = v < st.mn ? v : st.mn;
  }
  const ProbeState<T> r = block_reduce(st);
  if (threadIdx.x == 0) part[blockIdx.x] = r;
}

template <typename T>
__global__ void probe_combine_kernel(const ProbeState<T>* __restrict__ part, int nb, T* __restrict__ out) {
  const ProbeState<T> r = fold_partials(part, nb);
  if (threadIdx.x == 0) {
    out[0] = r.m + log_(r.s);
    out[1] = r.t / r.s;
    out[2] = r.mn;
  }
}

// part: scratch of 4*nb values; out: 3 values.
template <typename T>
int linesearch_probe(const T* y, const T* dy, double alpha, double se, int64_t n, int nb, T* part, T* out,
                     cudaStream_t stream) {
  ProbeState<T>* p = reinterpret_cast<ProbeState<T>*>(part);
  probe_partials_kernel<T><<<nb, kThreads, 0, stream>>>(y, dy, (T)alpha, (T)se, n, p);
  probe_combine_kernel<T><<<1, kThreads, 0, stream>>>(p, nb, out);
  RT_RETURN_LAUNCH_STATUS();
}

}  // namespace rt

extern "C" int rt_linesearch_probe_f32(const float* y, const float* dy, double alpha, double se, int64_t n, int nb,
                                       float* part, float* out, void* stream) {
  return rt::linesearch_probe<float>(y, dy, alpha, se, n, nb, part, out, (cudaStream_t)stream);
}

extern "C" int rt_linesearch_probe_f64(const double* y, const double* dy, double alpha, double se, int64_t n, int nb,
                                       double* part, double* out, void* stream) {
  return rt::linesearch_probe<double>(y, dy, alpha, se, n, nb, part, out, (cudaStream_t)stream);
}
