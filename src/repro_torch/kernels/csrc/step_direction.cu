// Step direction of the MWU iteration (paper Alg. 2 line 7), with its max:
//
//   ratio = h > tiny ? g / max(h, tiny) : inf
//   d     = (scale * max(1 - ratio, 0)) * x,     dmax = max(d)
//
// g comes from one of two sources, two template variants of one kernel:
// (gather) g = w[u[e]] + w[v[e]], the incidence gather computed in
// registers and never written; (read) g read from memory, for operators
// whose transposed product is not a plain gather.
//
// Replaces src/repro/kernels/incidence_gather/kernel.py:
// incidence_gather_pallas (body _gather_kernel) on the packing side of the
// iteration, together with the vector work around it that the reference
// fuses into one XLA program (src/repro/core/mwu.py, the ratio, d and
// max_d lines of _iteration).
//
// Bound on the H100: bytes. Per edge u, v, h, x read and d written: 32
// bytes at f64 (w, n values, read once and then served from the L2); the
// read variant reads g instead of u and v, the same 32 bytes. At the bmatch
// shape (E = 98.6M) that is 3.16 GB, 0.94 ms at 3.35 TB/s.
//
// Design: a grid-stride sweep, four elements a thread in flight; each
// block folds its threads' max into one partial, and the last block to
// finish (an atomic ticket) folds the partials in block-index order, so one
// launch gives d and max(d). The ticket decides who folds, never the
// order; a max is exact anyway. d is bit-equal to the plain version's
// eager chain: the same operations in the same order, each rounded
// (div_rn, sub_rn, mul_rn), and torch's NaN semantics (a NaN g or x gives a
// NaN d; max propagates NaN).
#include "common.cuh"

namespace rt {

template <typename T>
struct NanMax {
  T m;
  __device__ static NanMax identity() { return {neg_inf<T>()}; }
};

template <typename T>
__device__ __forceinline__ NanMax<T> combine(NanMax<T> a, NanMax<T> b) {
  return {(a.m > b.m || a.m != a.m) ? a.m : b.m};
}

template <typename T>
__device__ __forceinline__ NanMax<T> shfl_down(NanMax<T> a, int off) {
  return {__shfl_down_sync(0xffffffffu, a.m, off)};
}

template <typename T>
struct DirParams {
  const int32_t* u;  // gather variant
  const int32_t* v;
  const T* w;
  const T* g;        // read variant
  const T* h;
  const T* x;
  T scale, tiny;
  int64_t E;
  T* d;
  NanMax<T>* part;   // one partial a block
  unsigned* ticket;  // 0 between launches
  T* dmax;
};

template <typename T, bool kGather>
__device__ __forceinline__ T direction(const DirParams<T>& p, int64_t e) {
  const T g = kGather ? add_rn(__ldg(p.w + __ldg(p.u + e)), __ldg(p.w + __ldg(p.v + e))) : __ldg(p.g + e);
  const T h = __ldg(p.h + e);
  const T ratio = h > p.tiny ? div_rn(g, h) : pos_inf<T>();  // h > tiny: max(h, tiny) = h
  const T t = sub_rn(T(1), ratio);
  const T c = t < T(0) ? T(0) : t;  // clamp(min=0); NaN stays NaN
  return mul_rn(mul_rn(p.scale, c), __ldg(p.x + e));
}

template <typename T, bool kGather>
__global__ void __launch_bounds__(kThreads) step_direction_kernel(DirParams<T> p) {
  constexpr int kUnroll = 4;
  NanMax<T> st = NanMax<T>::identity();
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (; e + (kUnroll - 1) * stride < p.E; e += kUnroll * stride) {
    T d[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) d[k] = direction<T, kGather>(p, e + k * stride);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      p.d[e + k * stride] = d[k];
      st = combine(st, NanMax<T>{d[k]});
    }
  }
  for (; e < p.E; e += stride) {
    const T d = direction<T, kGather>(p, e);
    p.d[e] = d;
    st = combine(st, NanMax<T>{d});
  }
  const NanMax<T> r = block_reduce(st);
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    p.part[blockIdx.x] = r;
    __threadfence();
    s_last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  NanMax<T> f = NanMax<T>::identity();
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) f = combine(f, NanMax<T>{__ldcg(&p.part[i].m)});
  f = block_reduce(f);
  if (threadIdx.x == 0) {
    p.dmax[0] = f.m;
    *p.ticket = 0;
  }
}

// u, v, w (gather) or g (read: u null); part: nb values; ticket: one zeroed
// counter, left at 0.
template <typename T>
int step_direction(const int32_t* u, const int32_t* v, const T* w, const T* g, const T* h, const T* x, double scale,
                   double tiny, int64_t E, int nb, T* d, T* part, unsigned* ticket, T* dmax, cudaStream_t stream) {
  const DirParams<T> p{u, v, w, g, h, x, (T)scale, (T)tiny, E, d, reinterpret_cast<NanMax<T>*>(part), ticket, dmax};
  if (u) {
    step_direction_kernel<T, true><<<nb, kThreads, 0, stream>>>(p);
  } else {
    step_direction_kernel<T, false><<<nb, kThreads, 0, stream>>>(p);
  }
  RT_RETURN_LAUNCH_STATUS();
}

}  // namespace rt

extern "C" int rt_step_direction_f32(const int32_t* u, const int32_t* v, const float* w, const float* g, const float* h,
                                     const float* x, double scale, double tiny, int64_t E, int nb, float* d,
                                     float* part, unsigned* ticket, float* dmax, void* stream) {
  return rt::step_direction<float>(u, v, w, g, h, x, scale, tiny, E, nb, d, part, ticket, dmax, (cudaStream_t)stream);
}

extern "C" int rt_step_direction_f64(const int32_t* u, const int32_t* v, const double* w, const double* g,
                                     const double* h, const double* x, double scale, double tiny, int64_t E, int nb,
                                     double* d, double* part, unsigned* ticket, double* dmax, void* stream) {
  return rt::step_direction<double>(u, v, w, g, h, x, scale, tiny, E, nb, d, part, ticket, dmax,
                                    (cudaStream_t)stream);
}
