// Softmax weights: with a = se*v (se = sign*eta),
//   lse = logsumexp(a),  w = exp(a - lse),
// written as stats = [max a, lse] and w. With a row mask `keep` (one byte
// a row, or null) a row whose byte is 0 counts as a = -inf: it is left out
// of lse and its weight is exactly 0 (core/smoothing.py's `where`).
//
// Replaces src/repro/kernels/softmax_weights/kernel.py:
// softmax_weights_pallas (bodies _reduce_kernel and _normalize_kernel).
//
// Bound on the H100: bytes. Read v once and write w once: 2*sizeof(T)*n,
// and the mask once, n more bytes (v and the mask are read a second time,
// once lse is known, from L2). At the main path's n = 498k f64 that is
// 8 MB, 2.4 us.
//
// Design: one launch on a cooperative (co-resident) grid of at most
// kCoopBlocksPerSM blocks an SM. Each thread takes chunks of 8 (f64) or
// 16 (f32) elements by 16-byte loads (csrc/common.cuh, Chunk), finds the
// chunk's max and takes one exp per element with no branch; its chunks
// combine into an online state (max m, scaled sum s), one exp each. A
// block folds its threads in two phases (the max, then the sums rescaled
// to it by one exp a thread) into one partial; after a grid barrier every
// block folds all partials the same way, in block-index order (thread i
// holds partials i and i + 256, then the block reduction), so that every
// block holds the same lse and no second barrier is needed. Block 0 writes stats and each block writes
// w over its own tiles, reading v again from L2. The TPU kernel's finite
// -1e30 padding sentinel is replaced by -inf with a guard in the combine:
// two empty states give (-inf, 0), never exp(-inf - -inf) = NaN.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace rt {

template <typename T>
struct MaxSum {
  T m, s;
  __device__ static MaxSum identity() { return {neg_inf<T>(), T(0)}; }
};

template <typename T>
__device__ __forceinline__ MaxSum<T> combine(MaxSum<T> a, MaxSum<T> b) {
  const bool a_hi = a.m >= b.m;
  const MaxSum<T> hi = a_hi ? a : b, lo = a_hi ? b : a;
  if (hi.m == neg_inf<T>()) return {hi.m, T(0)};  // both empty
  return {hi.m, fma_rn(lo.s, exp_(sub_rn(lo.m, hi.m)), hi.s)};
}

template <typename T>
struct Sum {
  T s;
  __device__ static Sum identity() { return {T(0)}; }
};

template <typename T>
__device__ __forceinline__ Sum<T> combine(Sum<T> a, Sum<T> b) {
  return {add_rn(a.s, b.s)};
}

template <typename T>
__device__ __forceinline__ Sum<T> shfl_down(Sum<T> a, int off) {
  return {__shfl_down_sync(0xffffffffu, a.s, off)};
}

template <typename T>
struct SoftmaxParams {
  const T* v;
  const uint8_t* keep;  // null: every row
  T se;
  int64_t n;
  MaxSum<T>* part;  // one partial a block
  T* stats;         // [m, lse]
  T* w;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kCoopBlocksPerSM) softmax_kernel(SoftmaxParams<T> p) {
  using C = Chunk<T>;
  cg::grid_group grid = cg::this_grid();
  const bool vec = aligned16(p.v) && aligned16(p.w);
  const int64_t nt = tiles<T>(p.n);
  const int nb = (int)gridDim.x;

  MaxSum<T> st = MaxSum<T>::identity();
  for (int64_t k = blockIdx.x; k < nt; k += nb) {
    T a[C::kSize];
    load_chunk(p.v, p.n, k, vec, a);
    T m = neg_inf<T>();
#pragma unroll
    for (int j = 0; j < C::kSize; ++j) {
      a[j] = kept(p.keep, C::index(k, j), p.n) ? mul_rn(a[j], p.se) : neg_inf<T>();
      m = a[j] > m ? a[j] : m;
    }
    if (m == neg_inf<T>()) continue;  // the chunk lies past n
    T s = T(0);
#pragma unroll
    for (int j = 0; j < C::kSize; ++j) s = add_rn(s, exp_(sub_rn(a[j], m)));
    st = combine(st, MaxSum<T>{m, s});
  }
  // the block's partial: its max, then the threads' sums rescaled to it
  const T bm = block_all_reduce(Max<T>{st.m}).m;
  const Sum<T> bs = block_reduce(Sum<T>{mul_rn(st.s, rescale(st.m, bm))});
  if (threadIdx.x == 0) {
    __stcg(&p.part[blockIdx.x].m, bm);
    __stcg(&p.part[blockIdx.x].s, bs.s);
  }
  grid.sync();

  // every block folds all partials the same way (read at L2: other SMs
  // wrote them): the max, then the sums rescaled to it
  MaxSum<T> q[kFoldSlots];
  Max<T> mx = Max<T>::identity();
#pragma unroll
  for (int k = 0; k < kFoldSlots; ++k) {
    const int j = threadIdx.x + k * kThreads;
    q[k] = j < nb ? MaxSum<T>{__ldcg(&p.part[j].m), __ldcg(&p.part[j].s)} : MaxSum<T>::identity();
    mx = combine(mx, Max<T>{q[k].m});
  }
  const T m = block_all_reduce(mx).m;
  Sum<T> f = Sum<T>::identity();
#pragma unroll
  for (int k = 0; k < kFoldSlots; ++k) f = combine(f, Sum<T>{mul_rn(q[k].s, rescale(q[k].m, m))});
  f = block_reduce(f);
  __shared__ T s_lse;
  if (threadIdx.x == 0) {
    s_lse = add_rn(m, log_(f.s));
    if (blockIdx.x == 0) {
      p.stats[0] = m;
      p.stats[1] = s_lse;
    }
  }
  __syncthreads();
  const T lse = s_lse;
  for (int64_t k = blockIdx.x; k < nt; k += nb) {
    T x[C::kSize];
    load_chunk(p.v, p.n, k, vec, x);
#pragma unroll
    for (int j = 0; j < C::kSize; ++j) x[j] = exp_(sub_rn(mul_rn(x[j], p.se), lse));
    if (p.keep != nullptr) {  // the rows left out weigh exactly 0
#pragma unroll
      for (int j = 0; j < C::kSize; ++j) x[j] = kept(p.keep, C::index(k, j), p.n) ? x[j] : T(0);
    }
    store_chunk(p.w, p.n, k, vec, x);
  }
}

// part: scratch of 2*kMaxPartials values; stats: [m, lse]; w: n values;
// keep: n bytes or null.
template <typename T>
int softmax_weights(const T* v, const uint8_t* keep, double se, int64_t n, T* part, T* stats, T* w,
                    cudaStream_t stream) {
  int nb_max = 0;
  if (const cudaError_t rc = coop_blocks(softmax_kernel<T>, nb_max)) return (int)rc;
  const int64_t nt = tiles<T>(n);
  const int blocks = (int)(nt < nb_max ? nt : nb_max);
  const SoftmaxParams<T> p{v, keep, (T)se, n, reinterpret_cast<MaxSum<T>*>(part), stats, w};
  return launch_cooperative(softmax_kernel<T>, blocks, p, stream);
}

}  // namespace rt

extern "C" int rt_softmax_weights_f32(const float* v, const uint8_t* keep, double se, int64_t n, float* part,
                                      float* stats, float* w, void* stream) {
  return rt::softmax_weights<float>(v, keep, se, n, part, stats, w, (cudaStream_t)stream);
}

extern "C" int rt_softmax_weights_f64(const double* v, const uint8_t* keep, double se, int64_t n, double* part,
                                      double* stats, double* w, void* stream) {
  return rt::softmax_weights<double>(v, keep, se, n, part, stats, w, (cudaStream_t)stream);
}
