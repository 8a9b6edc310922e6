// Incidence scatter, a deterministic CSR segmented sum (the product M x):
//
//   out[r] = base[r] + sum_{i in seg_A(r)} wt_A[i] * x[src_A[i]]
//                    + sum_{i in seg_B(r)} wt_B[i] * x[src_B[i]]
//
// The two sides A and B are the u and the v endpoints of an edge list,
// each grouped by row in CSR form once per operator (kernels/
// incidence_scatter/csr.py). src absent: entry i reads x[i]; wt absent:
// weight 1; base absent: 0; side B absent: one side. A side whose entries
// read x through a permutation may be cut into slabs of x: its CSR rows
// are then (slab, row) pairs, slab-major, over the rows [lo, lo + span)
// that it touches, and a row's value is its slabs' sums added in an order
// fixed by their count (scatter_fold_kernel).
//
// Replaces the reference's XLA scatter-add (src/repro/core/operators.py:
// Incidence.matvec and the other scatter products); it is not a Pallas
// kernel. On the card the port summed with index_add_, whose float
// atomics add in another order each run, so no two solves repeated.
//
// Bound on the H100: bytes. x read once (8 bytes an entry at f64), the
// v side's permutation (4 bytes an entry) and out (8 bytes a row). At the
// bmatch shape (E = 98.6M, n = 498k, u sorted so its side has no
// permutation) that is 1.19 GB, 0.35 ms at 3.35 TB/s. The v side's x reads
// are scattered: each takes 8 bytes of a 32-byte sector from device
// memory: 3.7 ms for the v side at that shape on the H100, against 0.55
// ms for the same segments read in order (tools/scatter_ab.py). Cut into
// slabs of x that fit the L2 (csr.py: SLAB_COLS values a slab), each
// sector is fetched from memory about once and the scattered reads are
// served from the L2: 1.6 ms.
//
// Design: merge-path over the offsets (Merrill and Garland's CSR SpMV).
// Each side's row ends and entries form one merge list of rows + nnz
// items, cut into tiles of kScatterTile items, one block a tile, so a hot
// row of 10^5 entries and a run of empty rows cost the same per tile. The
// tiles' splits (rows consumed before each tile) depend on the CSR alone
// and are computed once with it (csr.py, MERGE_TILE = kScatterTile). A
// block stages its tile's row ends and entry values in shared memory, each
// thread with all its loads in flight at once, and each thread takes
// kScatterItems merge items from its own split, summing in entry order
// and writing each row it closes. The row open at a thread's start gets
// the threads before it by a segmented scan over the block; the row open
// at the tile's end is the tile's carry. A second pass gives each row its
// value: the carries of the tiles its entries span, in tile order, then
// the tile that closes it (and, for a side in slabs, its slabs folded by
// one warp), for each side, added to base. Every sum is taken in an order
// fixed by the CSR and the constants here: no atomics, no data-dependent
// grid, and add_rn / mul_rn so that nvcc cannot contract differently
// between builds. Two launches on one input give the same bits.
#include "common.cuh"

namespace rt {

constexpr int kScatterItems = 8;                           // merge items a thread
constexpr int kScatterTile = kThreads * kScatterItems;     // merge items a block

template <typename T>
struct ScatterSide {
  const int64_t* off;    // rows + 1; null: the side is absent
  const int64_t* split;  // tiles + 1: CSR rows consumed before each tile (and rows)
  const int32_t* src;    // nnz; null: entry i reads x[i]
  const T* wt;           // nnz; null: weight 1
  int64_t nnz;
  int64_t lo, span;      // the output rows [lo, lo + span) that the side touches
  int64_t slabs;         // CSR row k * span + r is output row lo + r over slab k
  int64_t rows;          // CSR rows: slabs * span
  int64_t tiles;         // merge tiles: ceil((rows + nnz) / kScatterTile)
  T* rowsum;             // rows: each CSR row's sum over the tile that closes it
  T* carry;              // tiles: the sum of the CSR row open at the tile's end, over that tile
  T* fold;               // span (slabs > 1): each output row's sum over its slabs
};

template <typename T>
struct ScatterParams {
  const T* x;
  const T* base;  // rows; null: 0
  T* out;         // rows
  int64_t n;      // rows
  ScatterSide<T> side[2];
};

__host__ __device__ inline int64_t scatter_tiles(int64_t n, int64_t nnz) {
  return (n + nnz + kScatterTile - 1) / kScatterTile;
}

// A segmented sum state: f says a row was closed in the span; v is the sum
// of the span's entries after the last row it closed.
template <typename T>
struct Seg {
  int f;
  T v;
};

// a, then b
template <typename T>
__device__ __forceinline__ Seg<T> seg_combine(Seg<T> a, Seg<T> b) {
  return {a.f | b.f, b.f ? b.v : add_rn(a.v, b.v)};
}

// Exclusive segmented scan over the block's threads in thread order, with
// the block's total in `total`; a fixed tree (warp shuffles, then the
// warps' totals in warp 0).
template <typename T>
__device__ Seg<T> block_seg_scan(Seg<T> s, Seg<T>& total) {
  __shared__ Seg<T> warp_tot[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Seg<T> o{__shfl_up_sync(0xffffffffu, s.f, off), __shfl_up_sync(0xffffffffu, s.v, off)};
    if (lane >= off) s = seg_combine(o, s);
  }
  Seg<T> ex{__shfl_up_sync(0xffffffffu, s.f, 1), __shfl_up_sync(0xffffffffu, s.v, 1)};
  if (lane == 0) ex = Seg<T>{0, T(0)};
  if (lane == 31) warp_tot[warp] = s;
  __syncthreads();
  if (warp == 0) {
    Seg<T> w = lane < kWarps ? warp_tot[lane] : Seg<T>{0, T(0)};
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const Seg<T> o{__shfl_up_sync(0xffffffffu, w.f, off), __shfl_up_sync(0xffffffffu, w.v, off)};
      if (lane >= off) w = seg_combine(o, w);
    }
    if (lane < kWarps) warp_tot[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  if (warp > 0) ex = lane == 0 ? warp_tot[warp - 1] : seg_combine(warp_tot[warp - 1], ex);
  total = warp_tot[kWarps - 1];
  return ex;
}

// Pass 1: one block a merge tile; blocks [0, side[0].tiles) take side A,
// the rest side B.
template <typename T>
__global__ void __launch_bounds__(kThreads) scatter_tiles_kernel(ScatterParams<T> p) {
  // row ends i0 .. i1 as entries past j0, at most kScatterTile (the row
  // open at the tile's end, and rows past n, end beyond every entry here)
  __shared__ int32_t s_end[kScatterTile + 1];
  __shared__ T s_val[kScatterTile];  // entry values j0 .. j1 - 1

  int64_t tile = blockIdx.x;
  const int which = tile < p.side[0].tiles ? 0 : 1;
  const ScatterSide<T> sd = p.side[which];
  if (which) tile -= p.side[0].tiles;
  const int64_t n = sd.rows, L = n + sd.nnz;
  const int64_t d0 = tile * kScatterTile;
  const int64_t d1 = d0 + kScatterTile < L ? d0 + kScatterTile : L;
  const int64_t i0 = __ldg(sd.split + tile), i1 = __ldg(sd.split + tile + 1);
  const int64_t j0 = d0 - i0, j1 = d1 - i1;
  const int n_ends = (int)(i1 - i0), n_vals = (int)(j1 - j0);
  for (int k = threadIdx.x; k <= n_ends; k += kThreads) {
    const int64_t e = i0 + k < n ? __ldg(sd.off + i0 + k + 1) - j0 : kScatterTile;
    s_end[k] = (int32_t)(e < kScatterTile ? e : kScatterTile);
  }
  // each thread's entries k = t, t + kThreads, ...: all index loads, then
  // all value loads, in flight together
  int64_t at[kScatterItems];
#pragma unroll
  for (int it = 0; it < kScatterItems; ++it) {
    const int k = threadIdx.x + it * kThreads;
    at[it] = k < n_vals ? (sd.src ? (int64_t)__ldg(sd.src + j0 + k) : j0 + k) : 0;
  }
  T val[kScatterItems];
#pragma unroll
  for (int it = 0; it < kScatterItems; ++it) {
    const int k = threadIdx.x + it * kThreads;
    val[it] = k < n_vals ? __ldg(p.x + at[it]) : T(0);
  }
  if (sd.wt) {
#pragma unroll
    for (int it = 0; it < kScatterItems; ++it) {
      const int k = threadIdx.x + it * kThreads;
      if (k < n_vals) val[it] = mul_rn(__ldg(sd.wt + j0 + k), val[it]);
    }
  }
#pragma unroll
  for (int it = 0; it < kScatterItems; ++it) {
    const int k = threadIdx.x + it * kThreads;
    if (k < n_vals) s_val[k] = val[it];
  }
  __syncthreads();

  // this thread's split inside the tile, then its merge items in order
  const int tile_len = (int)(d1 - d0);
  const int dl = threadIdx.x * kScatterItems < tile_len ? threadIdx.x * kScatterItems : tile_len;
  int lo = dl - n_vals > 0 ? dl - n_vals : 0, hi = dl < n_ends ? dl : n_ends;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] <= dl - mid - 1) lo = mid + 1; else hi = mid;
  }
  int li = lo, lj = dl - lo;
  T acc = T(0), first_sum = T(0);
  int64_t first_row = -1;
#pragma unroll
  for (int k = 0; k < kScatterItems; ++k) {
    if (dl + k < tile_len) {
      if (lj < s_end[li]) {
        acc = add_rn(acc, s_val[lj]);
        ++lj;
      } else {
        if (first_row < 0) {
          first_row = i0 + li;
          first_sum = acc;
        } else {
          sd.rowsum[i0 + li] = acc;
        }
        acc = T(0);
        ++li;
      }
    }
  }

  // the row open at this thread's start: the sums of the threads before it
  Seg<T> total;
  const Seg<T> excl = block_seg_scan(Seg<T>{first_row >= 0, acc}, total);
  if (first_row >= 0) sd.rowsum[first_row] = add_rn(excl.v, first_sum);
  if (threadIdx.x == 0) sd.carry[tile] = total.v;
}

// The row's sum on one side: the carries of the tiles its entries span
// before the tile that closes it, in tile order, then that tile's sum.
template <typename T>
__device__ __forceinline__ T row_sum(const ScatterSide<T>& sd, int64_t r) {
  const int64_t ts = (r + __ldg(sd.off + r)) / kScatterTile;
  const int64_t te = (r + __ldg(sd.off + r + 1)) / kScatterTile;
  if (ts == te) return sd.rowsum[r];
  T acc = sd.carry[ts];
  for (int64_t t = ts + 1; t < te; ++t) acc = add_rn(acc, sd.carry[t]);
  return add_rn(acc, sd.rowsum[r]);
}

// Pass 2a, for the sides cut into slabs: one warp an output row; lane l
// adds the slabs l, l + 32, ... in order, then a fixed shuffle tree adds
// the lanes.
template <typename T>
__global__ void scatter_fold_kernel(ScatterParams<T> p) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  const int64_t span0 = p.side[0].slabs > 1 ? p.side[0].span : 0;
  const int64_t total = span0 + (p.side[1].slabs > 1 ? p.side[1].span : 0);
  for (int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); w < total; w += warps) {
    const ScatterSide<T>& sd = w < span0 ? p.side[0] : p.side[1];
    const int64_t r = w < span0 ? w : w - span0;
    T acc = T(0);
    for (int64_t k = lane; k < sd.slabs; k += 32) acc = add_rn(acc, row_sum(sd, k * sd.span + r));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc = add_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    if (lane == 0) sd.fold[r] = acc;
  }
}

// A side's value at output row r: its one CSR row, or its slabs' fold;
// 0 outside the rows it touches.
template <typename T>
__device__ __forceinline__ T side_value(const ScatterSide<T>& sd, int64_t r) {
  const int64_t q = r - sd.lo;
  if (q < 0 || q >= sd.span) return T(0);
  return sd.slabs > 1 ? sd.fold[q] : row_sum(sd, q);
}

// Pass 2b: one thread a row.
template <typename T>
__global__ void scatter_rows_kernel(ScatterParams<T> p) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < p.n; r += stride) {
    T o = p.base ? __ldg(p.base + r) : T(0);
    o = add_rn(o, side_value(p.side[0], r));
    if (p.side[1].off) o = add_rn(o, side_value(p.side[1], r));
    p.out[r] = o;
  }
}

// Values of scratch a side takes: rowsum, carry, fold.
__host__ inline int64_t side_scratch(int64_t span, int64_t slabs, int64_t nnz) {
  return slabs * span + scatter_tiles(slabs * span, nnz) + (slabs > 1 ? span : 0);
}

template <typename T>
int incidence_scatter(const T* x, const T* base, T* out, int64_t n, const ScatterSide<T> (&sides)[2], T* scratch,
                      cudaStream_t stream) {
  if (n <= 0) return 0;
  ScatterParams<T> p{x, base, out, n, {sides[0], sides[1]}};
  bool slabbed = false;
  for (ScatterSide<T>& sd : p.side) {
    if (!sd.off) {
      sd = ScatterSide<T>{};
      continue;
    }
    if (sd.lo < 0 || sd.span < 0 || sd.lo + sd.span > n || sd.slabs < 1) return (int)cudaErrorInvalidValue;
    sd.rows = sd.slabs * sd.span;
    sd.tiles = scatter_tiles(sd.rows, sd.nnz);
    sd.rowsum = scratch;
    sd.carry = scratch + sd.rows;
    sd.fold = sd.slabs > 1 ? sd.carry + sd.tiles : nullptr;
    scratch += side_scratch(sd.span, sd.slabs, sd.nnz);
    slabbed = slabbed || sd.slabs > 1;
  }
  const int64_t blocks = p.side[0].tiles + p.side[1].tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (blocks > 0) scatter_tiles_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  if (slabbed) {
    const int64_t spans = (p.side[0].slabs > 1 ? p.side[0].span : 0) + (p.side[1].slabs > 1 ? p.side[1].span : 0);
    scatter_fold_kernel<T><<<sweep_blocks(spans * 32, 132 * 8), kThreads, 0, stream>>>(p);
  }
  scatter_rows_kernel<T><<<sweep_blocks(n, 132 * 8), kThreads, 0, stream>>>(p);
  RT_RETURN_LAUNCH_STATUS();
}

template <typename T>
int incidence_scatter_c(const T* x, const T* base, T* out, int64_t n, const int64_t* off_a, const int64_t* split_a,
                        const int32_t* src_a, const T* wt_a, int64_t nnz_a, int64_t lo_a, int64_t span_a,
                        int64_t slabs_a, const int64_t* off_b, const int64_t* split_b, const int32_t* src_b,
                        const T* wt_b, int64_t nnz_b, int64_t lo_b, int64_t span_b, int64_t slabs_b, T* scratch,
                        void* stream) {
  ScatterSide<T> sides[2] = {};
  sides[0] = ScatterSide<T>{off_a, split_a, src_a, wt_a, nnz_a, lo_a, span_a, slabs_a};
  sides[1] = ScatterSide<T>{off_b, split_b, src_b, wt_b, nnz_b, lo_b, span_b, slabs_b};
  return incidence_scatter<T>(x, base, out, n, sides, scratch, (cudaStream_t)stream);
}

}  // namespace rt

extern "C" int rt_incidence_scatter_tile() { return rt::kScatterTile; }

// Values of scratch that a side of the given layout takes.
extern "C" int64_t rt_incidence_scatter_scratch(int64_t span, int64_t slabs, int64_t nnz) {
  return rt::side_scratch(span, slabs, nnz);
}

#define RT_SCATTER_ENTRY(NAME, T)                                                                                    \
  extern "C" int NAME(const T* x, const T* base, T* out, int64_t n, const int64_t* off_a, const int64_t* split_a,   \
                      const int32_t* src_a, const T* wt_a, int64_t nnz_a, int64_t lo_a, int64_t span_a,             \
                      int64_t slabs_a, const int64_t* off_b, const int64_t* split_b, const int32_t* src_b,          \
                      const T* wt_b, int64_t nnz_b, int64_t lo_b, int64_t span_b, int64_t slabs_b, T* scratch,      \
                      void* stream) {                                                                                \
    return rt::incidence_scatter_c<T>(x, base, out, n, off_a, split_a, src_a, wt_a, nnz_a, lo_a, span_a, slabs_a,   \
                                      off_b, split_b, src_b, wt_b, nnz_b, lo_b, span_b, slabs_b, scratch, stream);  \
  }

RT_SCATTER_ENTRY(rt_incidence_scatter_f32, float)
RT_SCATTER_ENTRY(rt_incidence_scatter_f64, double)
