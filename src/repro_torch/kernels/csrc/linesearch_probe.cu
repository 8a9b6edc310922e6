// Line-search probe: with v = y + alpha*dy and a = se*v (se = sign*eta),
//   lse = logsumexp(a),  slope = sum softmax(a)_i * dy_i,  mn = min v.
// One launch evaluates both sides of a step-size probe, the packing side
// (y, dy, se = +eta) and the covering side (z, dz, se = -eta), into
// out = [lse_y, slope_y, min_y, lse_z, slope_z, min_z]; with nz = 0 it is
// the one-sided probe and writes out[0:3] only. Each side may carry a row
// mask (ky, kz: one byte a row, or null): a row whose byte is 0 counts as
// a = -inf and is left out of min v, so lse, slope and min run over the
// kept rows (core/stepsize.py's masked make_probe_fn), and a kept row's
// arithmetic is the unmasked sweep's.
//
// newton_search and binary_search run a whole step-size search of
// core/stepsize.py on the card in one launch over these probes: the
// warm-started Newton search (newton_step: the alpha = 0 sweep, the Newton
// loop, the back-off and the completion refinement; newton_control.cuh)
// or the binary search of Alg. 3 (binary_search_step: the alpha = 0 sweep,
// the exponential phases, the bisection, the completion test and
// refinement; binary_control.cuh), and write [alpha, probes, completes]
// in double. In the step form a search also takes the MWU iteration's
// max(d) and the lane's previous step (alpha_prev, the warm start) from
// device memory, and writes the step the iteration takes and whether it
// is terminal: [alpha, probes, completes, step, bad], with bad = max(d) <=
// 0 or alpha < 1 (core/mwu.py) and step = bad ? 0 : alpha; alpha_prev
// becomes alpha when the step is taken. The host then reads nothing of the
// search before the updates, which read the step from memory
// (axpy_reduce.cu).
//
// Replaces src/repro/kernels/linesearch_probe/kernel.py:
// linesearch_probe_pallas (body _probe_kernel), with newton_search the
// lax.while_loops of src/repro/core/stepsize.py:261 (newton_step) over it,
// and with binary_search those of :180 (binary_search_step, :205,219,243)
// and of _refine_completion (:174).
//
// Bound on the H100: bytes. One read of y, dy, z and dz,
// 2*sizeof(T)*(ny + nz) bytes (and ny + nz bytes of masks), and six values
// written. At the main path's shape (ny = 498k, nz = 1, f64) that is 8 MB,
// 2.4 us; a search reads them again at every probe, from the 50 MB L2.
//
// Design. The blocks split over the two sides in proportion to their
// tiles, at least one block a side (probe_split). Each thread takes a
// chunk of 8 (f64) or 16 (f32) elements by 16-byte loads (one tile a
// block at the main path's shape), finds the chunk's max and takes one
// exp per element with no branch; a thread's chunks combine with one exp
// each. A block folds its threads into one partial in two phases, as the
// partials are folded: the max first (comparisons only), then every state
// rescaled to it by one exp and the sums added up, in a fixed tree, so
// that no chain of dependent exps sits on the critical path. The searches
// and the lone probe are one kernel, templated over the search's
// controller, on a cooperative (co-resident) grid: a probe is the sweep, a
// grid barrier and the fold of each side's partials in block-index order.
// A lone probe is its one-probe case: block 0 folds and writes out. In a
// search every block folds, so that each holds the probe's six values, bit
// for bit as a lone probe writes them, and runs the search's control logic
// (in thread 0, in double, as the host loop runs it in Python floats) to
// the same next alpha: no second barrier is needed. The partials alternate
// between two buffers, so that no block overwrites a partial that another
// block still folds. v is rounded as the plain version rounds it (no FMA),
// so min is exact against it.
#include <cooperative_groups.h>

#include "common.cuh"
#include "binary_control.cuh"
#include "newton_control.cuh"

namespace cg = cooperative_groups;

namespace rt {

template <typename T>
struct ProbeState {
  T m, s, t, mn;  // max of a, sum of exp(a - m), sum of exp(a - m) * dy, min of v
  __device__ static ProbeState identity() { return {neg_inf<T>(), T(0), T(0), pos_inf<T>()}; }
};

template <typename T>
__device__ __forceinline__ ProbeState<T> combine(ProbeState<T> a, ProbeState<T> b) {
  const T mn = a.mn < b.mn ? a.mn : b.mn;
  const bool a_hi = a.m >= b.m;
  const ProbeState<T> hi = a_hi ? a : b, lo = a_hi ? b : a;
  if (hi.m == neg_inf<T>()) return {hi.m, T(0), T(0), mn};  // both empty
  const T c = exp_(sub_rn(lo.m, hi.m));
  return {hi.m, fma_rn(lo.s, c, hi.s), fma_rn(lo.t, c, hi.t), mn};
}

// Sums of states rescaled to one max, and the min of v.
template <typename T>
struct SumMin {
  T s, t, mn;
  __device__ static SumMin identity() { return {T(0), T(0), pos_inf<T>()}; }
};

template <typename T>
__device__ __forceinline__ SumMin<T> combine(SumMin<T> a, SumMin<T> b) {
  return {add_rn(a.s, b.s), add_rn(a.t, b.t), a.mn < b.mn ? a.mn : b.mn};
}

template <typename T>
__device__ __forceinline__ SumMin<T> shfl_down(SumMin<T> a, int off) {
  return {__shfl_down_sync(0xffffffffu, a.s, off), __shfl_down_sync(0xffffffffu, a.t, off),
          __shfl_down_sync(0xffffffffu, a.mn, off)};
}

// The two sides' values, folded side by side in one block reduction.
template <typename S>
struct Pair {
  S y, z;
  __device__ static Pair identity() { return {S::identity(), S::identity()}; }
};

template <typename S>
__device__ __forceinline__ Pair<S> combine(Pair<S> a, Pair<S> b) {
  return {combine(a.y, b.y), combine(a.z, b.z)};
}

template <typename S>
__device__ __forceinline__ Pair<S> shfl_down(Pair<S> a, int off) {
  return {shfl_down(a.y, off), shfl_down(a.z, off)};
}

// Partials are written and read at L2 (st.cg / ld.cg): another SM wrote
// them, and a block's L1 may hold an older partial of the same slot.
template <typename T>
__device__ __forceinline__ ProbeState<T> load_cg(const ProbeState<T>* p) {
  return {__ldcg(&p->m), __ldcg(&p->s), __ldcg(&p->t), __ldcg(&p->mn)};
}

template <typename T>
__device__ __forceinline__ void store_cg(ProbeState<T>* p, const ProbeState<T>& s) {
  __stcg(&p->m, s.m);
  __stcg(&p->s, s.s);
  __stcg(&p->t, s.t);
  __stcg(&p->mn, s.mn);
}

// This thread's state over tiles b, b + nb, ... of one side (the rows
// that `keep` keeps).
template <typename T>
__device__ ProbeState<T> probe_sweep(const T* __restrict__ y, const T* __restrict__ dy,
                                     const uint8_t* __restrict__ keep, int64_t n, T alpha, T se, int64_t b,
                                     int64_t nb) {
  using C = Chunk<T>;
  const bool vec = aligned16(y) && aligned16(dy);
  const int64_t nt = tiles<T>(n);
  ProbeState<T> st = ProbeState<T>::identity();
  for (int64_t k = b; k < nt; k += nb) {
    T yv[C::kSize], dv[C::kSize], a[C::kSize];
    load_chunk(y, n, k, vec, yv);
    load_chunk(dy, n, k, vec, dv);  // 0 past n
    T m = neg_inf<T>(), mn = pos_inf<T>();
#pragma unroll
    for (int j = 0; j < C::kSize; ++j) {
      const bool in = kept(keep, C::index(k, j), n);
      const T v = add_rn(yv[j], mul_rn(alpha, dv[j]));
      a[j] = in ? mul_rn(v, se) : neg_inf<T>();
      mn = in && v < mn ? v : mn;
      m = a[j] > m ? a[j] : m;
    }
    st.mn = mn < st.mn ? mn : st.mn;
    if (m == neg_inf<T>()) continue;  // the chunk lies past n
    T s = T(0), t = T(0);
#pragma unroll
    for (int j = 0; j < C::kSize; ++j) {
      const T e = exp_(sub_rn(a[j], m));
      s = add_rn(s, e);
      t = fma_rn(e, dv[j], t);
    }
    st = combine(st, ProbeState<T>{m, s, t, st.mn});
  }
  return st;
}

template <typename T>
struct ProbeArgs {
  const T *y, *dy, *z, *dz;
  const uint8_t *ky, *kz;  // row masks, or null
  int64_t ny, nz;
  T se_y, se_z;
  int gy, gz;  // blocks on each side: y takes blocks [0, gy), z [gy, gy + gz)
};

// This block's partial state, valid in thread 0: the block's max, then
// each thread's sums rescaled to it (one exp) and added up.
template <typename T>
__device__ __forceinline__ ProbeState<T> block_partial(const ProbeArgs<T>& p, T alpha) {
  const int b = (int)blockIdx.x;
  const ProbeState<T> st = b < p.gy ? probe_sweep(p.y, p.dy, p.ky, p.ny, alpha, p.se_y, b, p.gy)
                                    : probe_sweep(p.z, p.dz, p.kz, p.nz, alpha, p.se_z, b - p.gy, p.gz);
  const T m = block_all_reduce(Max<T>{st.m}).m;
  const T c = rescale(st.m, m);
  const SumMin<T> r = block_reduce(SumMin<T>{mul_rn(st.s, c), mul_rn(st.t, c), st.mn});
  return {m, r.s, r.t, r.mn};
}

// Both sides' [lse, slope, min] from the partials, valid in thread 0: the
// max of each side's partials, then the partials rescaled to it and added
// up, each in block-index order (thread i holds partials i and i + 256,
// then the block reduction). Every partial is read once, at L2.
template <typename T>
__device__ void fold_probe(const ProbeState<T>* part, int gy, int gz, T (&r)[6]) {
  ProbeState<T> qy[kFoldSlots], qz[kFoldSlots];
  Pair<Max<T>> mx = Pair<Max<T>>::identity();
#pragma unroll
  for (int k = 0; k < kFoldSlots; ++k) {
    const int j = threadIdx.x + k * kThreads;
    qy[k] = j < gy ? load_cg(part + j) : ProbeState<T>::identity();
    qz[k] = j < gz ? load_cg(part + gy + j) : ProbeState<T>::identity();
    mx = combine(mx, Pair<Max<T>>{{qy[k].m}, {qz[k].m}});
  }
  mx = block_all_reduce(mx);
  Pair<SumMin<T>> sm = Pair<SumMin<T>>::identity();
#pragma unroll
  for (int k = 0; k < kFoldSlots; ++k) {
    const T cy = rescale(qy[k].m, mx.y.m), cz = rescale(qz[k].m, mx.z.m);
    sm = combine(sm, Pair<SumMin<T>>{{mul_rn(qy[k].s, cy), mul_rn(qy[k].t, cy), qy[k].mn},
                                     {mul_rn(qz[k].s, cz), mul_rn(qz[k].t, cz), qz[k].mn}});
  }
  sm = block_reduce(sm);
  r[0] = add_rn(mx.y.m, log_(sm.y.s));
  r[1] = div_rn(sm.y.t, sm.y.s);
  r[2] = sm.y.mn;
  r[3] = add_rn(mx.z.m, log_(sm.z.s));
  r[4] = div_rn(sm.z.t, sm.z.s);
  r[5] = sm.z.mn;
}

// -- the searches -------------------------------------------------------------

template <typename T>
struct SearchParams {
  ProbeArgs<T> p;
  SearchArgs s;
  ProbeState<T>* part;  // partials: two buffers of gy + gz (one for a lone probe)
  double* out;          // a search's [alpha, probes, completes], + [step, bad] in the step form
  T* probe_out;         // a lone probe's [lse, slope, min] a side; null in a search
  double alpha;         // a lone probe's alpha
  const T* dmax;        // the step form's max(d); null otherwise
  double* alpha_prev;   // the step form's warm start, updated when the step is taken
};

// The search's arguments, the warm start read from device memory in the
// step form. Every block reads it before its first grid barrier, and block
// 0 writes it after the last, so no block reads the updated value.
template <typename T>
__device__ __forceinline__ SearchArgs search_args(const SearchParams<T>& prm) {
  SearchArgs a = prm.s;
  if (prm.alpha_prev) {
    a.alpha0 = *prm.alpha_prev;
    a.has_alpha0 = 1;
  }
  return a;
}

template <typename T, typename Control>
__global__ void __launch_bounds__(kThreads, kCoopBlocksPerSM) search_kernel(SearchParams<T> prm) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double s_alpha;
  __shared__ bool s_more;
  Control ctl(search_args(prm));
  if (threadIdx.x == 0) s_alpha = prm.probe_out ? prm.alpha : 0.0;  // a search first sweeps at alpha = 0
  __syncthreads();
  for (int k = 0;; ++k) {
    ProbeState<T>* part = prm.part + (k & 1) * gridDim.x;
    const ProbeState<T> r = block_partial(prm.p, (T)s_alpha);
    if (threadIdx.x == 0) store_cg(part + blockIdx.x, r);
    grid.sync();
    if (prm.probe_out && blockIdx.x != 0) return;
    T v[6];
    fold_probe(part, prm.p.gy, prm.p.gz, v);
    if (prm.probe_out) {
      if (threadIdx.x == 0)
        for (int j = 0; j < (prm.p.nz > 0 ? 6 : 3); ++j) prm.probe_out[j] = v[j];
      return;
    }
    if (threadIdx.x == 0) {
      const double w[6] = {(double)v[0], (double)v[1], (double)v[2], (double)v[3], (double)v[4], (double)v[5]};
      double next = 0.0;
      s_more = ctl.step(w, &next);
      s_alpha = next;
    }
    __syncthreads();
    if (!s_more) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    prm.out[0] = ctl.a;
    prm.out[1] = (double)ctl.probes();
    prm.out[2] = ctl.completes ? 1.0 : 0.0;
    if (prm.dmax) {  // the step form: the iteration's decision (core/mwu.py, Alg. 2 lines 8 and 12)
      const bool bad = *prm.dmax <= T(0) || ctl.a < 1.0;
      prm.out[3] = bad ? 0.0 : ctl.a;
      prm.out[4] = bad ? 1.0 : 0.0;
      if (!bad) *prm.alpha_prev = ctl.a;
    }
  }
}

// -- host side ---------------------------------------------------------------

struct Split {
  int gy, gz;
};

// Blocks of a probe on each side: one a tile while both sides fit in
// nb_max blocks (coop_blocks), else nb_max blocks in proportion to the
// tiles, at least one for a side that has elements.
template <typename T>
inline Split probe_split(int64_t ny, int64_t nz, int nb_max) {
  const int64_t ty = tiles<T>(ny), tz = tiles<T>(nz);
  if (ty + tz <= nb_max) return {(int)ty, (int)tz};
  if (ty == 0 || tz == 0) return {ty ? nb_max : 0, tz ? nb_max : 0};
  int64_t gy = llround((double)nb_max * (double)ty / (double)(ty + tz));
  gy = gy < 1 ? 1 : gy > nb_max - 1 ? nb_max - 1 : gy;
  return {(int)gy, nb_max - (int)gy};
}

template <typename T>
inline ProbeArgs<T> probe_args(const T* y, const T* dy, const uint8_t* ky, int64_t ny, double se_y, const T* z,
                               const T* dz, const uint8_t* kz, int64_t nz, double se_z, int nb_max) {
  const Split s = probe_split<T>(ny, nz, nb_max);
  return {y, dy, z, dz, ky, kz, ny, nz, (T)se_y, (T)se_z, s.gy, s.gz};
}

// A search and a lone probe launch the same kernel body on the same grid,
// so that a probe inside a search gives the lone probe's bits. The lone
// probe is the Newton instantiation's one-probe case. Both instantiations
// hold kCoopBlocksPerSM blocks an SM (__launch_bounds__), and coop_blocks,
// whose count is kept per params type, gives them one grid.
template <typename T, typename Control>
int launch_search(const T* y, const T* dy, const uint8_t* ky, int64_t ny, double se_y, const T* z, const T* dz,
                  const uint8_t* kz, int64_t nz, double se_z, const SearchArgs& args, T* part, double* out,
                  T* probe_out, double alpha, const T* dmax, double* alpha_prev, cudaStream_t stream) {
  int nb_max = 0;
  if (const cudaError_t rc = coop_blocks(search_kernel<T, Control>, nb_max)) return (int)rc;
  const SearchParams<T> prm{probe_args(y, dy, ky, ny, se_y, z, dz, kz, nz, se_z, nb_max), args,
                            reinterpret_cast<ProbeState<T>*>(part), out, probe_out, alpha, dmax, alpha_prev};
  return launch_cooperative(search_kernel<T, Control>, prm.p.gy + prm.p.gz, prm, stream);
}

// part: scratch of 4*kMaxPartials values; out: 6 values (3 when nz = 0);
// ky, kz: ny and nz bytes, or null.
template <typename T>
int linesearch_probe2(const T* y, const T* dy, const uint8_t* ky, int64_t ny, double se_y, const T* z, const T* dz,
                      const uint8_t* kz, int64_t nz, double se_z, double alpha, T* part, T* out,
                      cudaStream_t stream) {
  return launch_search<T, NewtonControl>(y, dy, ky, ny, se_y, z, dz, kz, nz, se_z, SearchArgs{}, part, nullptr,
                                        out, alpha, (const T*)nullptr, nullptr, stream);
}

// part: scratch of 8*kMaxPartials values; out: 3 doubles, or 5 in the step
// form (dmax and alpha_prev given; alpha0 is then read from alpha_prev).
// Control: NewtonControl (newton_search) or BinaryControl (binary_search).
template <typename T, typename Control>
int run_search(const T* y, const T* dy, const uint8_t* ky, int64_t ny, const T* z, const T* dz, const uint8_t* kz,
           int64_t nz, double eta, double ls_eps, double alpha0, int has_alpha0, double tiny, T* part, double* out,
           const T* dmax, double* alpha_prev, cudaStream_t stream) {
  if ((dmax == nullptr) != (alpha_prev == nullptr)) return (int)cudaErrorInvalidValue;
  return launch_search<T, Control>(y, dy, ky, ny, eta, z, dz, kz, nz, -eta,
                                   SearchArgs{eta, ls_eps, tiny, alpha0, has_alpha0}, part, out, (T*)nullptr, 0.0,
                                   dmax, alpha_prev, stream);
}

}  // namespace rt

// Partials of a one-launch reduction (softmax_weights, linesearch_probe and
// the searches) at most: the wrappers size their scratch by it.
extern "C" int rt_max_partials() { return rt::kMaxPartials; }

extern "C" int rt_linesearch_probe2_f32(const float* y, const float* dy, const uint8_t* ky, int64_t ny, double se_y,
                                        const float* z, const float* dz, const uint8_t* kz, int64_t nz, double se_z,
                                        double alpha, float* part, float* out, void* stream) {
  return rt::linesearch_probe2<float>(y, dy, ky, ny, se_y, z, dz, kz, nz, se_z, alpha, part, out,
                                      (cudaStream_t)stream);
}

extern "C" int rt_linesearch_probe2_f64(const double* y, const double* dy, const uint8_t* ky, int64_t ny,
                                        double se_y, const double* z, const double* dz, const uint8_t* kz, int64_t nz,
                                        double se_z, double alpha, double* part, double* out, void* stream) {
  return rt::linesearch_probe2<double>(y, dy, ky, ny, se_y, z, dz, kz, nz, se_z, alpha, part, out,
                                       (cudaStream_t)stream);
}

#define RT_SEARCH_ENTRY(NAME, CONTROL, T, SUFFIX)                                                            \
  extern "C" int NAME##_##SUFFIX(const T* y, const T* dy, const uint8_t* ky, int64_t ny, const T* z, const T* dz,    \
                                 const uint8_t* kz, int64_t nz, double eta, double ls_eps, double alpha0,            \
                                 int has_alpha0, double tiny, T* part, double* out, const T* dmax,                   \
                                 double* alpha_prev, void* stream) {                                                 \
    return rt::run_search<T, rt::CONTROL>(y, dy, ky, ny, z, dz, kz, nz, eta, ls_eps, alpha0, has_alpha0, tiny,       \
                                          part, out, dmax, alpha_prev, (cudaStream_t)stream);                        \
  }

RT_SEARCH_ENTRY(rt_newton_search, NewtonControl, float, f32)
RT_SEARCH_ENTRY(rt_newton_search, NewtonControl, double, f64)
RT_SEARCH_ENTRY(rt_binary_search, BinaryControl, float, f32)
RT_SEARCH_ENTRY(rt_binary_search, BinaryControl, double, f64)
