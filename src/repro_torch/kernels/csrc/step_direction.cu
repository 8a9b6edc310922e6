// Step direction of the MWU iteration (paper Alg. 2 line 7), with its max:
//
//   ratio = h > tiny ? g / max(h, tiny) : inf
//   d     = (scale * max(1 - ratio, 0)) * x,     dmax = max(d)
//
// g comes from one of two sources, template variants of one kernel:
// (gather) g = w[u[e]] + w[v[e]], the incidence gather computed in
// registers and never written (gather.cuh), times the edge factor f[e] of
// a masked or weighted operator where it has one (f = mask ? (weights ?
// weights[e] : 1) : 0, one byte of mask and one weight an edge); (read) g
// read from memory, for operators whose transposed product is not a gather.
//
// Replaces src/repro/kernels/incidence_gather/kernel.py:
// incidence_gather_pallas (body _gather_kernel) on the packing side of the
// iteration, together with the vector work around it that the reference
// fuses into one XLA program (src/repro/core/mwu.py, the ratio, d and
// max_d lines of _iteration).
//
// Bound on the H100: bytes. Per edge u, v, h, x read and d written: 32
// bytes at f64 (w, n values, read once and then served from the L2); the
// read variant reads g instead of u and v, the same 32 bytes; the mask
// adds one byte an edge, the weights one value. At the bmatch shape (E =
// 98.6M) that is 3.16 GB, 0.94 ms at 3.35 TB/s; a served match lane's
// masked pass at phase 6's bucket (E = 4.19M) 138 MB and w's 8 MB.
//
// Design: the lone gather's sweep (gather.cuh: tiles of 2,048 edges, eight
// a thread 32 apart, every lookup in flight before the adds, the edge
// streams evict-first (h, x and d not: the next kernels read x and d), two
// waves of resident blocks); each
// block folds its threads' max into one partial, and the last block to
// finish (an atomic ticket) folds the partials in block-index order, so one
// launch gives d and max(d). The ticket decides who folds, never the
// order; a max is exact anyway. d is bit-equal to the plain version's
// eager chain: the same operations in the same order, each rounded
// (div_rn, sub_rn, mul_rn), and torch's NaN semantics (a NaN g or x gives a
// NaN d; max propagates NaN). With an edge factor g is the plain chain's
// (w[u] + w[v]) * f, one rounded add and one rounded multiply: a masked
// lane needs no gather, ones, where or multiply of its own before this pass.
#include "gather.cuh"

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
  const uint8_t* mask;  // the edge factor (kFactor): either may be null
  const T* weights;
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

template <typename T>
__device__ __forceinline__ T direction(const DirParams<T>& p, T g, T h, T x) {
  const T ratio = h > p.tiny ? div_rn(g, h) : pos_inf<T>();  // h > tiny: max(h, tiny) = h
  const T t = sub_rn(T(1), ratio);
  const T c = t < T(0) ? T(0) : t;  // clamp(min=0); NaN stays NaN
  return mul_rn(mul_rn(p.scale, c), x);
}

template <typename T, bool kGather, bool kFactor>
__global__ void __launch_bounds__(kThreads) step_direction_kernel(DirParams<T> p) {
  const int64_t E = p.E;
  const T* __restrict__ gin = p.g;
  const T* __restrict__ hin = p.h;
  const T* __restrict__ xin = p.x;
  T* __restrict__ dout = p.d;
  NanMax<T> st = NanMax<T>::identity();
  const int64_t tiles = edge_tiles(E);
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    T g[kEdgeSlots], h[kEdgeSlots], x[kEdgeSlots];
#pragma unroll
    for (int j = 0; j < kEdgeSlots; ++j) {  // issued with the gather's index loads
      const int64_t e = edge_slot(t, j);
      const bool in = e < E;
      if (!kGather) g[j] = in ? ld<false>(gin + e) : T(0);
      h[j] = in ? ld<false>(hin + e) : T(0);
      x[j] = in ? ld<false>(xin + e) : T(0);
    }
    if (kGather) gather_tile<T, kFactor>(p.u, p.v, p.w, p.mask, p.weights, E, t, g);
#pragma unroll
    for (int j = 0; j < kEdgeSlots; ++j) {
      const int64_t e = edge_slot(t, j);
      if (e < E) {
        const T d = direction(p, g[j], h[j], x[j]);
        dout[e] = d;  // plain store: the step images' products read d next
        st = combine(st, NanMax<T>{d});
      }
    }
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

// Two waves of resident blocks (wave_blocks), at most nb (the partials'
// room) and the tiles' count.
template <typename T, bool kGather, bool kFactor>
int launch_direction(const DirParams<T>& p, int nb, cudaStream_t stream) {
  static std::atomic<int> known[64];
  int blocks = 0;
  const cudaError_t rc = wave_blocks(step_direction_kernel<T, kGather, kFactor>, known, blocks);
  if (rc != cudaSuccess) return (int)rc;
  const int64_t tiles = edge_tiles(p.E);
  blocks = blocks < nb ? blocks : nb;
  blocks = tiles < blocks ? (int)tiles : blocks;
  step_direction_kernel<T, kGather, kFactor><<<blocks < 1 ? 1 : blocks, kThreads, 0, stream>>>(p);
  RT_RETURN_LAUNCH_STATUS();
}

// u, v, w (gather, with the edge factor's mask and weights where either is
// not null) or g (read: u null); part: nb values; ticket: one zeroed
// counter, left at 0.
template <typename T>
int step_direction(const int32_t* u, const int32_t* v, const T* w, const uint8_t* mask, const T* weights, const T* g,
                   const T* h, const T* x, double scale, double tiny, int64_t E, int nb, T* d, T* part,
                   unsigned* ticket, T* dmax, cudaStream_t stream) {
  const DirParams<T> p{u, v, w, mask, weights, g, h, x, (T)scale, (T)tiny, E, d,
                       reinterpret_cast<NanMax<T>*>(part), ticket, dmax};
  if (u && (mask || weights)) return launch_direction<T, true, true>(p, nb, stream);
  if (u) return launch_direction<T, true, false>(p, nb, stream);
  return launch_direction<T, false, false>(p, nb, stream);
}

}  // namespace rt

extern "C" int rt_step_direction_f32(const int32_t* u, const int32_t* v, const float* w, const uint8_t* mask,
                                     const float* weights, const float* g, const float* h, const float* x,
                                     double scale, double tiny, int64_t E, int nb, float* d, float* part,
                                     unsigned* ticket, float* dmax, void* stream) {
  return rt::step_direction<float>(u, v, w, mask, weights, g, h, x, scale, tiny, E, nb, d, part, ticket, dmax,
                                   (cudaStream_t)stream);
}

extern "C" int rt_step_direction_f64(const int32_t* u, const int32_t* v, const double* w, const uint8_t* mask,
                                     const double* weights, const double* g, const double* h, const double* x,
                                     double scale, double tiny, int64_t E, int nb, double* d, double* part,
                                     unsigned* ticket, double* dmax, void* stream) {
  return rt::step_direction<double>(u, v, w, mask, weights, g, h, x, scale, tiny, E, nb, d, part, ticket, dmax,
                                    (cudaStream_t)stream);
}
