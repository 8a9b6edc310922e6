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
// 2.4 us. A search sweeps them once a probe; what sets its time is the
// chain of dependent steps in a sweep, not bytes (tools/search_ab.py).
//
// Design. The blocks split over the two sides in proportion to their
// tiles, at least one block a side (search_plan.cuh). Each thread takes a
// chunk of 8 (f64) or 16 (f32) elements by 16-byte loads (one tile a
// block at the main path's shape), finds the chunk's max and takes one
// exp per element with no branch; a thread's chunks combine with one exp
// each (none for the first). When no block sweeps more than kHeldTiles
// tiles (the plan's held path), each block keeps its tiles of the inputs
// in shared memory from the first sweep on, and each thread its row mask
// as bits in registers, so that later sweeps read no device memory;
// otherwise every sweep reads them again (streamed). A block folds its
// threads into one partial in two phases, as the partials are folded: the
// max first (comparisons only, exact in any order: a warp's butterfly,
// then the warps' maxima through shared memory), then every state
// rescaled to it by one exp and the sums added up in a fixed tree (each
// warp's shuffles, then warp 0 over the warps), two block barriers in
// all. The searches and the lone probe are one kernel, templated over the
// search's controller, on a cooperative (co-resident) grid: a probe is the
// sweep, the partials' exchange and their fold in block-index order. Every
// block stores its partial as 64-bit words tagged with the sweep's
// generation; block 0's threads take them as they arrive (a word is read
// whole, so a partial whose words all carry the generation is this
// sweep's: no count of arrivals, no fence), fold them, run the search's
// control logic (in thread 0, in double, as the host loop runs it in
// Python floats, its state in shared memory so that it takes no
// registers) and hand the next alpha off in one 16-byte store of two
// tagged words that the other blocks poll; a lone probe is the one-probe
// case, for which the others do not wait. Block 0 alone reads the
// partials, so no block waits behind the grid's reads of the same lines.
// The probe's six values are those of a lone probe, bit for bit. v is
// rounded as the plain version rounds it (no FMA), so min is exact
// against it.
#include <type_traits>

#include "common.cuh"
#include "binary_control.cuh"
#include "newton_control.cuh"
#include "search_plan.cuh"

namespace rt {

static_assert(kPlanThreads == kThreads && kChunkBytes == 16 * Chunk<double>::kLoads, "search_plan.cuh's geometry");

// -- stamps of the timing instantiation (tools/search_ab.py) ------------------
//
// search_kernel<T, Control, true> writes, in thread 0 of every block and for
// each of the first kStampSweeps sweeps, the SM's clock64 and the global
// timer at each point of the sweep below: stamps[((k * kMaxPartials + b) *
// 2 + {0: clock64, 1: globaltimer}) * kStampSlots + point]. The wrappers'
// entry points launch the <..., false> instantiation, in which every stamp
// is compiled out.
enum StampPoint {
  kSweepStart,    // the sweep's alpha known to the block
  kLoaded,        // the first tile's inputs in registers
  kSwept,         // the thread's chunks reduced (the exps)
  kBlockReduced,  // the block's partial (its block reduction)
  kArrived,       // the partial stored (and the arrival sent)
  kReleased,      // block 0: every partial of the sweep stored; the others: the hand-off taken
  kFoldLoaded,    // the fold's partials in registers
  kFolded,        // the probe's six values (the block reduction, log, div)
  kDecided,       // the controller's next alpha
  kSweepEnd,      // next alpha and "more" handed off and broadcast to the block
  kStampSlots
};
constexpr int kStampSweeps = 64;

template <bool kOn>
struct Stamps {
  long long* buf;
  // Record point p of sweep k once `dep` is ready (its store waits for it,
  // and a warp runs its instructions in order, so the clock is read after).
  template <typename V>
  __device__ __forceinline__ void at(int k, int p, V dep) const {
    if (!kOn || threadIdx.x != 0 || k >= kStampSweeps) return;
    long long* row = buf + ((int64_t)k * kMaxPartials + blockIdx.x) * 2 * kStampSlots;
    *reinterpret_cast<volatile V*>(row + p) = dep;
    long long c, g;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(c)::"memory");
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g)::"memory");
    row[p] = c;
    row[kStampSlots + p] = g;
  }
};

// Scratch of a search or a lone probe, in values of T a partial: the
// partials' tagged slots (8 values of T a slot), then the SearchSync.
constexpr int kScratchStates = 9;

// -- the probe's states -------------------------------------------------------

template <typename T>
struct ProbeState {
  T m, s, t, mn;  // max of a, sum of exp(a - m), sum of exp(a - m) * dy, min of v
  __device__ static ProbeState identity() { return {neg_inf<T>(), T(0), T(0), pos_inf<T>()}; }
};

// The online combine of two states. An empty state (m = -inf, sums 0)
// adds fma(0, exp(-inf), s) = s: it is left out with no exp, the same bits.
template <typename T>
__device__ __forceinline__ ProbeState<T> combine(ProbeState<T> a, ProbeState<T> b) {
  const T mn = a.mn < b.mn ? a.mn : b.mn;
  const bool a_hi = a.m >= b.m;
  const ProbeState<T> hi = a_hi ? a : b, lo = a_hi ? b : a;
  if (hi.m == neg_inf<T>()) return {hi.m, T(0), T(0), mn};  // both empty
  if (lo.m == neg_inf<T>()) return {hi.m, hi.s, hi.t, mn};
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

// The block's max of N values a thread, in every thread (a warp's
// butterfly, then the warps' maxima: comparisons, exact in any order);
// then `sums(mx, r)` gives each thread's N sums rescaled to it, and they
// are added up in block_reduce's fixed tree (each warp's shuffles, warp 0
// over the warps), valid in thread 0. Two block barriers.
template <int N, typename T, typename Sums>
__device__ __forceinline__ void block_lse(T (&mx)[N], Sums sums, SumMin<T> (&r)[N]) {
  __shared__ T s_max[N][kWarps];
  __shared__ SumMin<T> s_sum[N][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T o = __shfl_xor_sync(0xffffffffu, mx[i], off);
      mx[i] = o > mx[i] ? o : mx[i];
    }
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) s_max[i][warp] = mx[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T m = s_max[i][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = s_max[i][w] > m ? s_max[i][w] : m;
    mx[i] = m;
  }
  sums(mx, r);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = combine(r[i], shfl_down(r[i], off));
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) s_sum[i][warp] = r[i];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = lane < kWarps ? s_sum[i][lane] : SumMin<T>::identity();
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = combine(r[i], shfl_down(r[i], off));
  }
}

// A partial is exchanged as tagged 64-bit words: each 32-bit piece of its
// four values in the low half of a word whose high half is the sweep's
// generation (f64: 8 words, f32: 4). A word is written and read whole, so
// a block that finds every word of a partial tagged with the generation
// it waits for holds that sweep's partial: no count of arrivals, no
// fence. The words bypass L1 (volatile), since another SM writes them.
template <typename T>
struct Tagged {
  static constexpr int kWords = 4 * (int)sizeof(T) / 4;
};

__device__ __forceinline__ void st_words(unsigned long long* p, unsigned long long a, unsigned long long b) {
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(a), "l"(b) : "memory");
}
__device__ __forceinline__ void ld_words(const unsigned long long* p, unsigned long long& a, unsigned long long& b) {
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];" : "=l"(a), "=l"(b) : "l"(p) : "memory");
}

__device__ __forceinline__ void pieces(double x, uint32_t* out) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(x);
  out[0] = (uint32_t)b;
  out[1] = (uint32_t)(b >> 32);
}
__device__ __forceinline__ void pieces(float x, uint32_t* out) { out[0] = __float_as_uint(x); }
__device__ __forceinline__ void unpiece(const uint32_t* in, double& x) {
  x = __longlong_as_double((long long)(((unsigned long long)in[1] << 32) | in[0]));
}
__device__ __forceinline__ void unpiece(const uint32_t* in, float& x) { x = __uint_as_float(in[0]); }

// Write partial s of generation g into its slot.
template <typename T>
__device__ __forceinline__ void put_partial(unsigned long long* slot, const ProbeState<T>& s, unsigned g) {
  constexpr int kW = Tagged<T>::kWords, kP = kW / 4;
  uint32_t w[kW];
  pieces(s.m, w);
  pieces(s.s, w + kP);
  pieces(s.t, w + 2 * kP);
  pieces(s.mn, w + 3 * kP);
  const unsigned long long tag = (unsigned long long)g << 32;
#pragma unroll
  for (int i = 0; i < kW; i += 2) st_words(slot + i, tag | w[i], tag | w[i + 1]);
}

// Wait for the partial of generation g in its slot, and return it.
template <typename T>
__device__ __forceinline__ ProbeState<T> take_partial(const unsigned long long* slot, unsigned g) {
  constexpr int kW = Tagged<T>::kWords, kP = kW / 4;
  unsigned long long w[kW];
  bool fresh;
  do {
#pragma unroll
    for (int i = 0; i < kW; i += 2) ld_words(slot + i, w[i], w[i + 1]);
    fresh = true;
#pragma unroll
    for (int i = 0; i < kW; ++i) fresh = fresh && (unsigned)(w[i] >> 32) == g;
  } while (!fresh);
  uint32_t p[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) p[i] = (uint32_t)w[i];
  ProbeState<T> s;
  unpiece(p, s.m);
  unpiece(p + kP, s.s);
  unpiece(p + 2 * kP, s.t);
  unpiece(p + 3 * kP, s.mn);
  return s;
}

// -- the sweep ----------------------------------------------------------------

template <typename T>
struct ProbeArgs {
  const T *y, *dy, *z, *dz;
  const uint8_t *ky, *kz;  // row masks, or null
  int64_t ny, nz;
  T se_y, se_z;
  int gy, gz;  // blocks on each side: y takes blocks [0, gy), z [gy, gy + gz)
  int held;    // the plan's path: 1 held in shared memory, 0 streamed
};

// The side a block sweeps: tiles b, b + nb, ... of (x, dx, keep).
template <typename T>
struct Side {
  const T *x, *dx;
  const uint8_t* keep;
  int64_t n;
  T se;
  int64_t b, nb;
};

template <typename T>
__device__ __forceinline__ Side<T> block_side(const ProbeArgs<T>& p) {
  const int b = (int)blockIdx.x;
  return b < p.gy ? Side<T>{p.y, p.dy, p.ky, p.ny, p.se_y, b, p.gy}
                  : Side<T>{p.z, p.dz, p.kz, p.nz, p.se_z, b - p.gy, p.gz};
}

// Bit j: element j of this thread's chunk of tile k takes part (kept()).
template <typename T>
__device__ __forceinline__ uint32_t keep_bits(const Side<T>& s, int64_t k) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < Chunk<T>::kSize; ++j) bits |= (uint32_t)kept(s.keep, Chunk<T>::index(k, j), s.n) << j;
  return bits;
}

// One chunk into this thread's state: its max, one exp an element.
template <typename T>
__device__ __forceinline__ void sweep_chunk(ProbeState<T>& st, const T (&yv)[Chunk<T>::kSize],
                                            const T (&dv)[Chunk<T>::kSize], uint32_t bits, T alpha, T se) {
  using C = Chunk<T>;
  T a[C::kSize];
  T m = neg_inf<T>(), mn = pos_inf<T>();
#pragma unroll
  for (int j = 0; j < C::kSize; ++j) {
    const bool in = (bits >> j) & 1u;
    const T v = add_rn(yv[j], mul_rn(alpha, dv[j]));
    a[j] = in ? mul_rn(v, se) : neg_inf<T>();
    mn = in && v < mn ? v : mn;
    m = a[j] > m ? a[j] : m;
  }
  st.mn = mn < st.mn ? mn : st.mn;
  if (m == neg_inf<T>()) return;  // no element of the chunk takes part
  T s = T(0), t = T(0);
#pragma unroll
  for (int j = 0; j < C::kSize; ++j) {
    const T e = exp_(sub_rn(a[j], m));
    s = add_rn(s, e);
    t = fma_rn(e, dv[j], t);
  }
  st = combine(st, ProbeState<T>{m, s, t, st.mn});
}

// On the held path a block keeps its tiles of x and dx in dynamic shared
// memory, each tile in its own layout (thread t's 16-byte pieces side by
// side, so a warp's accesses are free of bank conflicts), and each
// thread its chunks' mask bits in registers: tile b + r*nb at
// s_held[2r] (x) and s_held[2r + 1] (dx).
extern __shared__ __align__(16) unsigned char s_held[];

template <typename T>
__device__ __forceinline__ T* held_tile(int i) {
  return reinterpret_cast<T*>(s_held) + (int64_t)i * Chunk<T>::kTile;
}

template <typename T>
__device__ __forceinline__ void load_held(const T* tile, T (&out)[Chunk<T>::kSize]) {
  using C = Chunk<T>;
#pragma unroll
  for (int l = 0; l < C::kLoads; ++l) {
    const T* p = tile + l * kThreads * C::kVec + threadIdx.x * C::kVec;
    if constexpr (sizeof(T) == 8) {
      const double2 q = *reinterpret_cast<const double2*>(p);
      out[l * C::kVec] = q.x;
      out[l * C::kVec + 1] = q.y;
    } else {
      const float4 q = *reinterpret_cast<const float4*>(p);
      out[l * C::kVec] = q.x;
      out[l * C::kVec + 1] = q.y;
      out[l * C::kVec + 2] = q.z;
      out[l * C::kVec + 3] = q.w;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_held(T* tile, const T (&in)[Chunk<T>::kSize]) {
  using C = Chunk<T>;
#pragma unroll
  for (int l = 0; l < C::kLoads; ++l) store16(tile + l * kThreads * C::kVec + threadIdx.x * C::kVec, in + l * C::kVec);
}

// This thread's state over its block's tiles: read from device memory at
// every sweep (streamed), or on the held path read at the first sweep
// (`load`) into shared memory (and the mask bits into `keep`) and swept
// from there. The same tiles in the same order, so the same bits.
template <typename T, bool kStamp>
__device__ __forceinline__ ProbeState<T> thread_sweep(const Side<T>& s, bool held, bool load,
                                                      uint32_t (&keep)[kHeldTiles], T alpha,
                                                      const Stamps<kStamp>& stamp, int sweep) {
  using C = Chunk<T>;
  const bool vec = aligned16(s.x) && aligned16(s.dx);
  const int64_t nt = tiles<T>(s.n);
  ProbeState<T> st = ProbeState<T>::identity();
  if (held) {
#pragma unroll
    for (int r = 0; r < kHeldTiles; ++r) {
      const int64_t k = s.b + r * s.nb;
      if (k >= nt) break;
      T yv[C::kSize], dv[C::kSize];
      T *ty = held_tile<T>(2 * r), *td = held_tile<T>(2 * r + 1);
      if (load) {
        load_chunk(s.x, s.n, k, vec, yv);
        load_chunk(s.dx, s.n, k, vec, dv);  // 0 past n
        keep[r] = keep_bits(s, k);
        store_held(ty, yv);
        store_held(td, dv);
      } else {
        load_held(ty, yv);
        load_held(td, dv);
      }
      if (kStamp && r == 0) stamp.at(sweep, kLoaded, add_rn(yv[C::kSize - 1], dv[C::kSize - 1]));
      sweep_chunk(st, yv, dv, keep[r], alpha, s.se);
    }
    return st;
  }
  for (int64_t k = s.b; k < nt; k += s.nb) {
    T yv[C::kSize], dv[C::kSize];
    load_chunk(s.x, s.n, k, vec, yv);
    load_chunk(s.dx, s.n, k, vec, dv);  // 0 past n
    const uint32_t bits = keep_bits(s, k);
    if (kStamp && k == s.b) stamp.at(sweep, kLoaded, add_rn(yv[C::kSize - 1], dv[C::kSize - 1]));
    sweep_chunk(st, yv, dv, bits, alpha, s.se);
  }
  return st;
}

// This block's partial state, valid in thread 0: the block's max, then
// each thread's sums rescaled to it (one exp) and added up.
template <typename T>
__device__ __forceinline__ ProbeState<T> block_partial(const ProbeState<T>& st) {
  T m[1] = {st.m};
  SumMin<T> r[1];
  block_lse<1>(m, [&](const T (&mx)[1], SumMin<T> (&o)[1]) {
    const T c = rescale(st.m, mx[0]);
    o[0] = {mul_rn(st.s, c), mul_rn(st.t, c), st.mn};
  }, r);
  return {m[0], r[0].s, r[0].t, r[0].mn};
}

// A side's fold when it has one partial (or none): the partial rescaled to
// its own max and added to 0, as the block reduction adds it to the empty
// slots (0 + x is never -0, and x + 0 is then x): the same bits, no
// reduction.
template <typename T>
__device__ __forceinline__ SumMin<T> fold_alone(const ProbeState<T>& q) {
  const T c = rescale(q.m, q.m);
  return combine(SumMin<T>::identity(), SumMin<T>{mul_rn(q.s, c), mul_rn(q.t, c), q.mn});
}

// Both sides' [lse, slope, min] from the partials, valid in thread 0: the
// max of each side's partials, then the partials rescaled to it and added
// up, each in block-index order (thread i takes partials i and i + 256 of
// generation g as they arrive, then the block reduction); the
// second slot only where a side has more than 256 partials (an empty
// slot adds exp(-inf) * 0 = 0 to a sum that is not -0: the same bits).
// The block reduction takes only the sides of more than one partial.
template <typename T, bool kStamp>
__device__ void fold_probe(const unsigned long long* part, unsigned g, int gy, int gz, T (&r)[6],
                           const Stamps<kStamp>& stamp, int sweep) {
  constexpr int kW = Tagged<T>::kWords;
  const int slots = gy > kThreads || gz > kThreads ? kFoldSlots : 1;
  ProbeState<T> qy[kFoldSlots], qz[kFoldSlots];
  T mx[2] = {neg_inf<T>(), neg_inf<T>()};
#pragma unroll
  for (int k = 0; k < kFoldSlots; ++k) {
    const int j = threadIdx.x + k * kThreads;
    qy[k] = k < slots && j < gy ? take_partial<T>(part + j * kW, g) : ProbeState<T>::identity();
    qz[k] = k < slots && j < gz ? take_partial<T>(part + (gy + j) * kW, g) : ProbeState<T>::identity();
    mx[0] = qy[k].m > mx[0] ? qy[k].m : mx[0];
    mx[1] = qz[k].m > mx[1] ? qz[k].m : mx[1];
  }
  __syncthreads();  // every partial in
  stamp.at(sweep, kReleased, 0);
  stamp.at(sweep, kFoldLoaded, add_rn(qy[0].s, qz[0].s));
  auto side_sums = [&](const ProbeState<T>(&q)[kFoldSlots], T m) {
    SumMin<T> o = SumMin<T>::identity();
#pragma unroll
    for (int k = 0; k < kFoldSlots; ++k) {
      if (k >= slots) break;
      const T c = rescale(q[k].m, m);
      o = combine(o, SumMin<T>{mul_rn(q[k].s, c), mul_rn(q[k].t, c), q[k].mn});
    }
    return o;
  };
  SumMin<T> sm[2];
  if (gy > 1 && gz > 1) {
    block_lse<2>(mx, [&](const T (&m)[2], SumMin<T> (&o)[2]) {
      o[0] = side_sums(qy, m[0]);
      o[1] = side_sums(qz, m[1]);
    }, sm);
  } else if (gy > 1 || gz > 1) {
    const int i = gy > 1 ? 0 : 1;  // the side to reduce; the other's one partial is in thread 0
    T m[1] = {mx[i]};
    SumMin<T> o[1];
    block_lse<1>(m, [&](const T (&mm)[1], SumMin<T> (&oo)[1]) {
      oo[0] = i == 0 ? side_sums(qy, mm[0]) : side_sums(qz, mm[0]);
    }, o);
    mx[i] = m[0];
    sm[i] = o[0];
    sm[1 - i] = i == 0 ? fold_alone(qz[0]) : fold_alone(qy[0]);
  } else {
    sm[0] = fold_alone(qy[0]);
    sm[1] = fold_alone(qz[0]);
  }
  if (threadIdx.x != 0) return;
  r[0] = add_rn(mx[0], log_(sm[0].s));
  r[1] = div_rn(sm[0].t, sm[0].s);
  r[2] = sm[0].mn;
  r[3] = add_rn(mx[1], log_(sm[1].s));
  r[4] = div_rn(sm[1].t, sm[1].s);
  r[5] = sm[1].mn;
}

// -- the searches -------------------------------------------------------------

// The scratch of a launch: kMaxPartials slots of tagged words for the
// partials (put_partial), then the SearchSync (zeroed once by the
// wrapper). gen: the generation of the last sweep of the last launch on
// this scratch, which every block reads when the launch starts; sweep k
// of this launch is generation gen + k + 1, the tag of its partials and of
// block 0's hand-off after it, and block 0 stores the last one. A hand-off
// writes the next alpha as two tagged words, each with the generation (31
// bits) and "more" (the low bit) in its high half and half of alpha in its
// low half, so that a block that finds both tagged with the generation it
// waits for holds the hand-off's alpha and "more", from one 16-byte load.
struct SearchSync {
  unsigned long long word[2];
  unsigned gen;
};
// The slots take 8 values of T a partial (8 words f64, 4 f32), the SearchSync a ninth.
static_assert(kScratchStates == 9 && sizeof(SearchSync) <= kMaxPartials * sizeof(float), "the search's scratch");

template <typename T>
__device__ __forceinline__ SearchSync* search_sync(T* part) {
  return reinterpret_cast<SearchSync*>(reinterpret_cast<unsigned long long*>(part) + kMaxPartials * Tagged<T>::kWords);
}

// Block 0's hand-off of generation g.
__device__ __forceinline__ void hand_off(SearchSync* sync, unsigned g, double alpha, bool more) {
  const unsigned long long tag = (unsigned long long)((g << 1) | (more ? 1u : 0u)) << 32;
  const unsigned long long bits = (unsigned long long)__double_as_longlong(alpha);
  st_words(sync->word, tag | (bits & 0xffffffffull), tag | (bits >> 32));
  *reinterpret_cast<volatile unsigned*>(&sync->gen) = g;
}

// Wait for block 0's hand-off of generation g: its alpha, and "more".
__device__ __forceinline__ bool take_hand_off(const SearchSync* sync, unsigned g, double* alpha) {
  const unsigned long long want = (unsigned long long)(g & 0x7fffffffu);
  unsigned long long w0, w1;
  do {
    ld_words(sync->word, w0, w1);
  } while ((w0 >> 33) != want || (w1 >> 33) != want);
  *alpha = __longlong_as_double((long long)((w1 << 32) | (w0 & 0xffffffffull)));
  return ((w0 >> 32) & 1ull) != 0;
}

template <typename T>
struct SearchParams {
  ProbeArgs<T> p;
  SearchArgs s;
  T* part;              // scratch: the partials' tagged slots, then the SearchSync
  double* out;          // a search's [alpha, probes, completes], + [step, bad] in the step form
  T* probe_out;         // a lone probe's [lse, slope, min] a side; null in a search
  double alpha;         // a lone probe's alpha
  const T* dmax;        // the step form's max(d); null otherwise
  double* alpha_prev;   // the step form's warm start, updated when the step is taken
  long long* stamps;    // the timing instantiation's stamps; null otherwise
};

// The search's arguments, with the step form's warm start (read from
// device memory by block 0 alone, which also writes it when the search
// ends).
__device__ __forceinline__ SearchArgs search_args(SearchArgs a, bool step_form, double warm) {
  if (step_form) {
    a.alpha0 = warm;
    a.has_alpha0 = 1;
  }
  return a;
}

// The lone probe's "controller": search_kernel<T, LoneProbe, false> is the
// one-probe case of the same body, compiled without the search's paths.
struct LoneProbe {};

template <typename T, typename Control, bool kStamp>
__global__ void __launch_bounds__(kThreads, kCoopBlocksPerSM) search_kernel(SearchParams<T> prm) {
  constexpr bool kLone = std::is_same<Control, LoneProbe>::value;
  const Stamps<kStamp> stamp{prm.stamps};
  unsigned long long* part = reinterpret_cast<unsigned long long*>(prm.part);
  SearchSync* sync = search_sync(prm.part);
  const bool folds = blockIdx.x == 0;
  __shared__ double s_alpha;
  __shared__ bool s_more;
  // the controller, run by block 0's thread 0 only: in shared memory, not registers
  __shared__ alignas(Control) unsigned char s_ctl[sizeof(Control)];
  Control& ctl = *reinterpret_cast<Control*>(s_ctl);
  // Loads at launch, used from the end of the first sweep on, so that no
  // barrier waits for them: the last launch's generation (block 0 stores a
  // new one only after every block's first partial), in the threads that
  // tag or take partials and hand-offs, and block 0's warm start.
  unsigned gen = 0;
  double warm = 0.0;
  if (threadIdx.x == 0 || folds) gen = *reinterpret_cast<volatile unsigned*>(&sync->gen);
  if (threadIdx.x == 0) {
    s_alpha = kLone ? prm.alpha : 0.0;  // a search first sweeps at alpha = 0
    if (!kLone && folds && prm.alpha_prev) warm = *prm.alpha_prev;
  }
  __syncthreads();
  const Side<T> side = block_side(prm.p);
  uint32_t keep[kHeldTiles];
  for (int k = 0;; ++k) {
    const unsigned g = gen + (unsigned)k + 1u;  // this sweep's generation
    const T alpha = (T)s_alpha;
    stamp.at(k, kSweepStart, alpha);
    const ProbeState<T> st = thread_sweep(side, !kLone && prm.p.held != 0, k == 0, keep, alpha, stamp, k);
    stamp.at(k, kSwept, st.s);
    const ProbeState<T> r = block_partial(st);
    stamp.at(k, kBlockReduced, r.s);
    if (threadIdx.x == 0) put_partial(part + blockIdx.x * Tagged<T>::kWords, r, g);
    stamp.at(k, kArrived, 0);
    if (!folds) {
      if (kLone) return;
      if (threadIdx.x == 0) {  // wait for block 0's hand-off
        double next;
        s_more = take_hand_off(sync, g, &next);
        s_alpha = next;
        stamp.at(k, kReleased, 0);
      }
      __syncthreads();
      stamp.at(k, kSweepEnd, 0);
      if (!s_more) return;
      continue;
    }
    // block 0: fold this sweep's partials as they arrive, and decide
    T v[6];
    fold_probe<T>(part, g, prm.p.gy, prm.p.gz, v, stamp, k);
    stamp.at(k, kFolded, v[5]);
    if constexpr (kLone) {
      if (threadIdx.x == 0) {
#pragma unroll
        for (int j = 0; j < 6; ++j)
          if (j < (prm.p.nz > 0 ? 6 : 3)) prm.probe_out[j] = v[j];
        *reinterpret_cast<volatile unsigned*>(&sync->gen) = g;
      }
      return;
    } else if (threadIdx.x == 0) {
      if (k == 0) ctl = Control(search_args(prm.s, prm.alpha_prev != nullptr, warm));
      const double w[6] = {(double)v[0], (double)v[1], (double)v[2], (double)v[3], (double)v[4], (double)v[5]};
      double next = 0.0;
      s_more = ctl.step(w, &next);
      s_alpha = next;
      stamp.at(k, kDecided, next);
      hand_off(sync, g, next, s_more);
    }
    __syncthreads();
    stamp.at(k, kSweepEnd, 0);
    if (!s_more) break;
  }
  if constexpr (!kLone) {
    if (threadIdx.x == 0) {  // block 0
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
}

// -- host side ---------------------------------------------------------------

// The search's co-resident grid on the current device (coop_blocks, kept
// per params type, so every instantiation takes one grid) and its plan.
template <typename T>
inline cudaError_t plan_for(int64_t ny, int64_t nz, SearchPlan& plan) {
  int nb_max = 0;
  if (const cudaError_t rc = coop_blocks(search_kernel<T, NewtonControl, false>, nb_max)) return rc;
  plan = search_plan(ny, nz, (int)sizeof(T), nb_max);
  return cudaSuccess;
}

// Let the kernel take the held path's dynamic shared memory (kHeldTiles
// tiles of x and dx a block), once a device. The carve-out is left to
// the CUDA runtime: a streamed launch keeps a large L1.
template <typename T, typename Control, bool kStamp>
inline cudaError_t allow_held() {
  auto* kernel = search_kernel<T, Control, kStamp>;
  constexpr int kDevices = 64;
  static std::atomic<bool> done[kDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess || (dev < kDevices && done[dev].load(std::memory_order_relaxed))) return rc;
  const int bytes = kHeldTiles * kThreads * 2 * kChunkBytes;
  if ((rc = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)))
    return rc;
  if (dev < kDevices) done[dev].store(true, std::memory_order_relaxed);
  return cudaSuccess;
}

// A search and a lone probe launch the same kernel body on the same grid
// and plan, so that a probe inside a search gives the lone probe's bits
// (the lone probe, which sweeps once, takes the streamed path: the held
// path's sweeps give the same bits). Every instantiation holds
// kCoopBlocksPerSM blocks an SM (__launch_bounds__); the timing one
// (kStamp) sweeps the same tiles. `stream_only` (timing only) takes the
// streamed path whatever the plan.
template <typename T, typename Control, bool kStamp = false>
int launch_search(const T* y, const T* dy, const uint8_t* ky, int64_t ny, double se_y, const T* z, const T* dz,
                  const uint8_t* kz, int64_t nz, double se_z, const SearchArgs& args, T* part, double* out,
                  T* probe_out, double alpha, const T* dmax, double* alpha_prev, cudaStream_t stream,
                  long long* stamps = nullptr, bool stream_only = false) {
  SearchPlan plan;
  if (const cudaError_t rc = plan_for<T>(ny, nz, plan)) return (int)rc;
  const bool held = plan.held && !stream_only && !probe_out;
  const ProbeArgs<T> p{y, dy, z, dz, ky, kz, ny, nz, (T)se_y, (T)se_z, plan.gy, plan.gz, held};
  const SearchParams<T> prm{p, args, part, out, probe_out, alpha, dmax,
                            alpha_prev, stamps};
  const size_t smem = held ? (size_t)plan.tiles * 2 * Chunk<T>::kTile * sizeof(T) : 0;
  if (smem)
    if (const cudaError_t rc = allow_held<T, Control, kStamp>()) return (int)rc;
  return launch_cooperative(search_kernel<T, Control, kStamp>, plan.gy + plan.gz, prm, stream, smem);
}

// part: scratch of kScratchStates*kMaxPartials values, zeroed once; out: 6
// values (3 when nz = 0); ky, kz: ny and nz bytes, or null.
template <typename T>
int linesearch_probe2(const T* y, const T* dy, const uint8_t* ky, int64_t ny, double se_y, const T* z, const T* dz,
                      const uint8_t* kz, int64_t nz, double se_z, double alpha, T* part, T* out,
                      cudaStream_t stream) {
  return launch_search<T, LoneProbe>(y, dy, ky, ny, se_y, z, dz, kz, nz, se_z, SearchArgs{}, part, nullptr, out,
                                    alpha, (const T*)nullptr, nullptr, stream);
}

// part: scratch of kScratchStates*kMaxPartials values, zeroed once; out: 3
// doubles, or 5 in the step form (dmax and alpha_prev given; alpha0 is then
// read from alpha_prev).
// Control: NewtonControl (newton_search) or BinaryControl (binary_search).
template <typename T, typename Control, bool kStamp = false>
int run_search(const T* y, const T* dy, const uint8_t* ky, int64_t ny, const T* z, const T* dz, const uint8_t* kz,
               int64_t nz, double eta, double ls_eps, double alpha0, int has_alpha0, double tiny, T* part,
               double* out, const T* dmax, double* alpha_prev, cudaStream_t stream, long long* stamps = nullptr,
               bool stream_only = false) {
  if ((dmax == nullptr) != (alpha_prev == nullptr)) return (int)cudaErrorInvalidValue;
  return launch_search<T, Control, kStamp>(y, dy, ky, ny, eta, z, dz, kz, nz, -eta,
                                           SearchArgs{eta, ls_eps, tiny, alpha0, has_alpha0}, part, out, (T*)nullptr,
                                           0.0, dmax, alpha_prev, stream, stamps, stream_only);
}

// The SM clock against the global timer, for the stamps: in one thread,
// the smallest step of %globaltimer seen in `spins` reads, then the clock64
// and globaltimer ticks over a span of span_ns: out = [step_ns, clock
// ticks, ns].
__global__ void clock_probe_kernel(long long* out, int spins, long long span_ns) {
  long long g0, g, c0, c1, step = 1ll << 62;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0)::"memory");
  for (int i = 0; i < spins; ++i) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g)::"memory");
    if (g != g0) {
      step = g - g0 < step ? g - g0 : step;
      g0 = g;
    }
  }
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0)::"memory");
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c0)::"memory");
  do {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g)::"memory");
  } while (g - g0 < span_ns);
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c1)::"memory");
  out[0] = step;
  out[1] = c1 - c0;
  out[2] = g - g0;
}

}  // namespace rt

// Partials of a one-launch reduction (softmax_weights, linesearch_probe and
// the searches) at most: the wrappers size their scratch by it.
extern "C" int rt_max_partials() { return rt::kMaxPartials; }

// Values of T a partial that a search's or a lone probe's scratch holds.
extern "C" int rt_search_scratch_states() { return rt::kScratchStates; }

// The search's plan on the current device for sides of ny and nz elements
// of elem_bytes each: out = [gy, gz, most tiles a block, held].
extern "C" int rt_search_plan(int64_t ny, int64_t nz, int elem_bytes, int* out) {
  rt::SearchPlan plan;
  const cudaError_t rc = elem_bytes == 8 ? rt::plan_for<double>(ny, nz, plan) : rt::plan_for<float>(ny, nz, plan);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = plan.gy;
  out[1] = plan.gz;
  out[2] = plan.tiles;
  out[3] = plan.held;
  return 0;
}

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

// For tools/search_ab.py only: the search of rule `binary` (0 Newton, 1
// binary), with `stream_only` forcing the streamed path, and with the
// timing instantiation's stamps written into `stamps` (kStampSweeps *
// kMaxPartials * 2 * kStampSlots values) when it is not null.
#define RT_TIMED_SEARCH(CONTROL, T)                                                                           \
  (stamps ? rt::run_search<T, rt::CONTROL, true>(y, dy, ky, ny, z, dz, kz, nz, eta, ls_eps, alpha0, has_alpha0, \
                                                 tiny, part, out, dmax, alpha_prev, (cudaStream_t)stream, stamps, \
                                                 stream_only != 0)                                                \
          : rt::run_search<T, rt::CONTROL, false>(y, dy, ky, ny, z, dz, kz, nz, eta, ls_eps, alpha0, has_alpha0,  \
                                                  tiny, part, out, dmax, alpha_prev, (cudaStream_t)stream,        \
                                                  nullptr, stream_only != 0))
#define RT_SEARCH_AB_ENTRY(T, SUFFIX)                                                                         \
  extern "C" int rt_search_ab_##SUFFIX(int binary, int stream_only, const T* y, const T* dy, const uint8_t* ky,   \
                                       int64_t ny, const T* z, const T* dz, const uint8_t* kz, int64_t nz,         \
                                       double eta, double ls_eps, double alpha0, int has_alpha0, double tiny,      \
                                       T* part, double* out, const T* dmax, double* alpha_prev, long long* stamps, \
                                       void* stream) {                                                             \
    return binary ? RT_TIMED_SEARCH(BinaryControl, T) : RT_TIMED_SEARCH(NewtonControl, T);                        \
  }

RT_SEARCH_AB_ENTRY(float, f32)
RT_SEARCH_AB_ENTRY(double, f64)

extern "C" int rt_search_stamp_layout(int* out) {
  out[0] = rt::kStampSweeps;
  out[1] = rt::kStampSlots;
  return 0;
}

extern "C" int rt_clock_probe(long long* out, int spins, long long span_ns, void* stream) {
  rt::clock_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(out, spins, span_ns);
  RT_RETURN_LAUNCH_STATUS();
}
