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
// fixed by their count (fold_slabs).
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
// are scattered: each takes 8 bytes of a 32-byte sector. Cut into slabs of
// x that fit the L2 (csr.py: SLAB_COLS values a slab), each sector is
// fetched from device memory about once and the scattered reads are served
// from the L2 (tools/scatter_ab.py times the layouts).
//
// Design: merge-path over the offsets (Merrill and Garland's CSR SpMV).
// Each side's row ends and entries form one merge list of rows + nnz
// items, cut into tiles of kScatterTile items, so a hot row of 10^5
// entries and a run of empty rows cost the same per tile. The tiles'
// splits (rows consumed before each tile) depend on the CSR alone and are
// computed once with it (csr.py, MERGE_TILE = kScatterTile), and so is the
// order in which the tiles are taken (csr.py, dispatch_order): there, slab
// k's tiles of the side that reads x in order sit next to the slabbed
// side's slab-k tiles, so the slab is fetched from device memory once for
// both sides and the slabbed side reads it from the L2.
//
// One cooperative launch a product, in three phases split by grid
// barriers. (1) The co-resident blocks walk the dispatch order, block b
// taking positions b, b + G, ... (G blocks), so that the blocks work on
// neighbouring tiles at any time. A block stages a tile in shared memory
// (its row ends, and each entry's value wt * x, all of a thread's loads in
// flight at once) while the index loads of its next tile, and the splits
// and ids of the tiles after it, are in flight in registers; the other
// blocks of its SM hide the staging's one round trip to memory. x is read
// with an L2 eviction priority above the index stream's (load_x). A tile's
// values sit at slot k + k / 8, so the merge's threads, about 8 entries
// apart, read distinct banks. In a tile each thread takes kScatterItems
// merge items from its own split, summing in entry order and writing each
// row it closes; the row open at a thread's start gets the threads before
// it by a segmented scan over the block; the row open at the tile's end is
// the tile's carry. (2) For a side in slabs, one warp an output row adds
// the row's slabs. (3) One thread a row adds, for each side, the carries
// of the tiles the row's entries span, in tile order, then the tile that
// closes it (or the slabs' fold), to base. A tile's sums depend on the
// CSR alone, whichever block takes it and in whatever order, and every
// sum is taken in an order fixed by the CSR and the constants here: no
// atomics, no block waits on another but at the grid barriers, and add_rn
// / mul_rn so that nvcc cannot contract differently between builds. Two
// launches on one input give the same bits.
#include <cooperative_groups.h>

#include "common.cuh"

namespace rt {

namespace cg = cooperative_groups;

constexpr int kScatterItems = 8;                        // merge items a thread
constexpr int kScatterTile = kThreads * kScatterItems;  // merge items a tile
constexpr int kScatterBlocksPerSM = 3;                  // co-resident blocks an SM, at most
// a tile's row ends in shared memory: at most kScatterTile + 1, padded to
// 16 bytes
constexpr int kTileEnds = kScatterTile + 4;
// a tile's values in shared memory: entry k at slot k + k / 8, so that the
// merge's threads, about 8 entries apart, read distinct banks
constexpr int kTileVals = kScatterTile + kScatterTile / 8;
__device__ __forceinline__ int val_slot(int k) { return k + (k >> 3); }

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
  const T* base;         // rows; null: 0
  T* out;                // rows
  int64_t n;             // rows
  const int32_t* order;  // tiles: the merge tiles in dispatch order; t < side[0].tiles names A's tile t, else B's
  int64_t tiles;         // side[0].tiles + side[1].tiles
  int64_t spans;         // output rows folded from slabs, both sides
  ScatterSide<T> side[2];
};

__host__ __device__ inline int64_t scatter_tiles(int64_t n, int64_t nnz) {
  return (n + nnz + kScatterTile - 1) / kScatterTile;
}

// -- loads with cache hints -------------------------------------------------

// L2 eviction priorities: x is kept (evict_last), so that a slab that one
// side's tiles fetched is still there when the other side's tiles of the
// slab read it; the index stream, read once, goes first (evict_first).
__device__ __forceinline__ uint64_t evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// An x value: evict_last in the L2, not allocated in L1 (the reads are
// scattered; L1 would keep nothing of use).
__device__ __forceinline__ double load_x(const double* a) {
  double v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.f64 %0, [%1], %2;" : "=d"(v) : "l"(a), "l"(evict_last()));
  return v;
}
__device__ __forceinline__ float load_x(const float* a) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(a), "l"(evict_last()));
  return v;
}

// An entry's x index: evict_first in the L2.
__device__ __forceinline__ int32_t load_index(const int32_t* a) {
  int32_t v;
  asm volatile("ld.global.nc.L2::cache_hint.s32 %0, [%1], %2;" : "=r"(v) : "l"(a), "l"(evict_first()));
  return v;
}

// -- the block's segmented scan ----------------------------------------------

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

// -- phase 1: the merge tiles ------------------------------------------------

// A tile's place in its side's merge list; side -1: no tile (past the end
// of this block's share of the order).
struct Tile {
  int side;
  int64_t tile;    // in its side
  int64_t i0, j0;  // CSR rows and entries consumed before it
  int n_ends;      // row ends in it
  int n_vals;      // entries in it
  int len;         // merge items in it
};

// A tile's splits: the CSR rows consumed before it and before the next.
struct Splits {
  int64_t i0, i1;
};

// The tile at position pos of the order; -1 past its end.
template <typename T>
__device__ __forceinline__ int32_t tile_at(const ScatterParams<T>& p, int64_t pos) {
  return pos < p.tiles ? __ldg(p.order + pos) : -1;
}

template <typename T>
__device__ __forceinline__ Splits splits_of(const ScatterParams<T>& p, int32_t id) {
  if (id < 0 || id >= p.tiles) return {0, 0};
  const int b = id >= p.side[0].tiles;
  const int64_t* split = p.side[b].split + (id - (b ? p.side[0].tiles : 0));
  return {__ldg(split), __ldg(split + 1)};
}

template <typename T>
__device__ __forceinline__ Tile tile_of(const ScatterParams<T>& p, int32_t id, Splits s) {
  if (id < 0 || id >= p.tiles) return Tile{-1, 0, 0, 0, 0, 0, 0};
  const int b = id >= p.side[0].tiles;
  const ScatterSide<T>& sd = p.side[b];
  const int64_t tile = id - (b ? p.side[0].tiles : 0);
  const int64_t L = sd.rows + sd.nnz, d0 = tile * kScatterTile;
  const int64_t d1 = d0 + kScatterTile < L ? d0 + kScatterTile : L;
  return Tile{b, tile, s.i0, d0 - s.i0, (int)(s.i1 - s.i0), (int)((d1 - s.i1) - (d0 - s.i0)), (int)(d1 - d0)};
}

// The x index that each of this thread's entries k = t, t + kThreads, ...
// of the tile reads, -1 past its entries: the tile's index loads, issued
// during the previous tile's merge.
template <typename T>
__device__ __forceinline__ void load_src(const ScatterParams<T>& p, const Tile& t, int32_t (&at)[kScatterItems]) {
  const int32_t* src = t.side >= 0 ? p.side[t.side].src : nullptr;
#pragma unroll
  for (int it = 0; it < kScatterItems; ++it) {
    const int k = threadIdx.x + it * kThreads;
    at[it] = t.side < 0 || k >= t.n_vals ? -1 : src ? load_index(src + t.j0 + k) : (int32_t)(t.j0 + k);
  }
}

// Stage a tile in shared memory: its row ends as entries of the tile (at
// most kScatterTile; rows past the side's end lie beyond every entry), and
// each entry's value wt * x. Each thread has all its loads in flight at
// once.
template <typename T>
__device__ __forceinline__ void stage_tile(const ScatterParams<T>& p, const Tile& t,
                                           const int32_t (&at)[kScatterItems], int32_t* s_end, T* s_val) {
  const ScatterSide<T>& sd = p.side[t.side];
  T val[kScatterItems];
#pragma unroll
  for (int it = 0; it < kScatterItems; ++it) val[it] = at[it] >= 0 ? load_x(p.x + at[it]) : T(0);
  if (sd.wt) {
#pragma unroll
    for (int it = 0; it < kScatterItems; ++it) {
      const int k = threadIdx.x + it * kThreads;
      if (k < t.n_vals) val[it] = mul_rn(__ldg(sd.wt + t.j0 + k), val[it]);
    }
  }
  for (int k = threadIdx.x; k <= t.n_ends; k += kThreads) {
    const int64_t e = t.i0 + k < sd.rows ? __ldg(sd.off + t.i0 + k + 1) - t.j0 : kScatterTile;
    s_end[k] = (int32_t)(e < kScatterTile ? e : kScatterTile);
  }
#pragma unroll
  for (int it = 0; it < kScatterItems; ++it) {
    const int k = threadIdx.x + it * kThreads;
    if (k < t.n_vals) s_val[val_slot(k)] = val[it];
  }
}

// Merge a staged tile: each CSR row it closes gets its sum over the tile,
// and the tile's carry the sum of the row open at its end.
template <typename T>
__device__ __forceinline__ void merge_tile(const ScatterParams<T>& p, const Tile& t, const int32_t* s_end,
                                           const T* s_val) {
  const ScatterSide<T>& sd = p.side[t.side];
  // this thread's split inside the tile, then its merge items in order
  const int dl = threadIdx.x * kScatterItems < t.len ? threadIdx.x * kScatterItems : t.len;
  int lo = dl - t.n_vals > 0 ? dl - t.n_vals : 0, hi = dl < t.n_ends ? dl : t.n_ends;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] <= dl - mid - 1) lo = mid + 1; else hi = mid;
  }
  int li = lo, lj = dl - lo;
  T acc = T(0), first_sum = T(0);
  int64_t first_row = -1;
#pragma unroll
  for (int k = 0; k < kScatterItems; ++k) {
    if (dl + k < t.len) {
      if (lj < s_end[li]) {
        acc = add_rn(acc, s_val[val_slot(lj)]);
        ++lj;
      } else {
        if (first_row < 0) {
          first_row = t.i0 + li;
          first_sum = acc;
        } else {
          sd.rowsum[t.i0 + li] = acc;
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
  if (threadIdx.x == 0) sd.carry[t.tile] = total.v;
}

// -- phases 2 and 3: the rows ------------------------------------------------

// The row's sum on one side: the carries of the tiles its entries span
// before the tile that closes it, in tile order, then that tile's sum.
// Phase 1 wrote them in this launch, so they are read through the L2, not
// the read-only cache.
template <typename T>
__device__ __forceinline__ T row_sum(const ScatterSide<T>& sd, int64_t r) {
  const int64_t ts = (r + __ldg(sd.off + r)) / kScatterTile;
  const int64_t te = (r + __ldg(sd.off + r + 1)) / kScatterTile;
  if (ts == te) return __ldcg(sd.rowsum + r);
  T acc = __ldcg(sd.carry + ts);
  for (int64_t t = ts + 1; t < te; ++t) acc = add_rn(acc, __ldcg(sd.carry + t));
  return add_rn(acc, __ldcg(sd.rowsum + r));
}

// Phase 2, for the sides cut into slabs: one warp an output row; lane l
// adds the slabs l, l + 32, ... in order, then a fixed shuffle tree adds
// the lanes.
template <typename T>
__device__ void fold_slabs(const ScatterParams<T>& p) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  const int64_t span0 = p.side[0].slabs > 1 ? p.side[0].span : 0;
  for (int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); w < p.spans; w += warps) {
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
  return sd.slabs > 1 ? __ldcg(sd.fold + q) : row_sum(sd, q);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kScatterBlocksPerSM) incidence_scatter_kernel(ScatterParams<T> p) {
  __shared__ int32_t s_end[kTileEnds];
  __shared__ T s_val[kTileVals];
  cg::grid_group grid = cg::this_grid();
  const int64_t G = gridDim.x;

  // Phase 1. At the top of an iteration at position pos: tile t's index
  // loads, the splits of the tile at pos + G and the id of the one at
  // pos + 2G in flight.
  int64_t pos = blockIdx.x;
  const int32_t id = tile_at(p, pos);
  Tile t = tile_of(p, id, splits_of(p, id));
  int32_t id_n = tile_at(p, pos + G), id_nn = tile_at(p, pos + 2 * G);
  Splits s_n = splits_of(p, id_n);
  int32_t at[kScatterItems];
  load_src(p, t, at);
  for (; t.side >= 0; pos += G) {
    stage_tile(p, t, at, s_end, s_val);
    const Tile tn = tile_of(p, id_n, s_n);
    load_src(p, tn, at);
    s_n = splits_of(p, id_nn);
    id_n = id_nn;
    id_nn = tile_at(p, pos + 3 * G);
    __syncthreads();
    merge_tile(p, t, s_end, s_val);
    t = tn;
  }
  grid.sync();

  // phase 2
  if (p.spans > 0) {
    fold_slabs(p);
    grid.sync();
  }

  // phase 3: one thread a row
  for (int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x; r < p.n; r += G * kThreads) {
    T o = p.base ? __ldg(p.base + r) : T(0);
    o = add_rn(o, side_value(p.side[0], r));
    if (p.side[1].off) o = add_rn(o, side_value(p.side[1], r));
    p.out[r] = o;
  }
}

// -- host side ---------------------------------------------------------------

// Values of scratch a side takes: rowsum, carry, fold.
__host__ inline int64_t side_scratch(int64_t span, int64_t slabs, int64_t nnz) {
  return slabs * span + scatter_tiles(slabs * span, nnz) + (slabs > 1 ? span : 0);
}

// The most blocks of a co-resident grid of the kernel on the current
// device: the blocks an SM holds by the occupancy calculator, at most
// kScatterBlocksPerSM, times the SMs. Kept per device.
template <typename T>
inline cudaError_t scatter_blocks(int& blocks) {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < kDevices && (blocks = known[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)incidence_scatter_kernel<T>, kThreads, 0);
  if (rc != cudaSuccess) return rc;
  blocks = sms * (per_sm < kScatterBlocksPerSM ? per_sm : kScatterBlocksPerSM);
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (dev < kDevices) known[dev].store(blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

template <typename T>
int incidence_scatter(const T* x, const T* base, T* out, int64_t n, const ScatterSide<T> (&sides)[2],
                      const int32_t* order, T* scratch, cudaStream_t stream) {
  if (n <= 0) return 0;
  ScatterParams<T> p{x, base, out, n, order, 0, 0, {sides[0], sides[1]}};
  for (ScatterSide<T>& sd : p.side) {
    if (!sd.off) {
      sd = ScatterSide<T>{};
      continue;
    }
    // x indices are int32 in the kernel
    if (sd.lo < 0 || sd.span < 0 || sd.lo + sd.span > n || sd.slabs < 1 || sd.nnz > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    sd.rows = sd.slabs * sd.span;
    sd.tiles = scatter_tiles(sd.rows, sd.nnz);
    sd.rowsum = scratch;
    sd.carry = scratch + sd.rows;
    sd.fold = sd.slabs > 1 ? sd.carry + sd.tiles : nullptr;
    scratch += side_scratch(sd.span, sd.slabs, sd.nnz);
    p.tiles += sd.tiles;
    p.spans += sd.slabs > 1 ? sd.span : 0;
  }
  if (p.tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t rc = scatter_blocks<T>(blocks);
  if (rc != cudaSuccess) return (int)rc;
  // no more blocks than the widest phase has work for: tiles, warps of the
  // fold, or rows
  int64_t need = p.tiles;
  const int64_t fold_blocks = (p.spans + kWarps - 1) / kWarps, row_blocks = (n + kThreads - 1) / kThreads;
  need = need > fold_blocks ? need : fold_blocks;
  need = need > row_blocks ? need : row_blocks;
  if (need < blocks) blocks = (int)need;
  return launch_cooperative(incidence_scatter_kernel<T>, blocks, p, stream);
}

template <typename T>
int incidence_scatter_c(const T* x, const T* base, T* out, int64_t n, const int64_t* off_a, const int64_t* split_a,
                        const int32_t* src_a, const T* wt_a, int64_t nnz_a, int64_t lo_a, int64_t span_a,
                        int64_t slabs_a, const int64_t* off_b, const int64_t* split_b, const int32_t* src_b,
                        const T* wt_b, int64_t nnz_b, int64_t lo_b, int64_t span_b, int64_t slabs_b,
                        const int32_t* order, T* scratch, void* stream) {
  ScatterSide<T> sides[2] = {};
  sides[0] = ScatterSide<T>{off_a, split_a, src_a, wt_a, nnz_a, lo_a, span_a, slabs_a};
  sides[1] = ScatterSide<T>{off_b, split_b, src_b, wt_b, nnz_b, lo_b, span_b, slabs_b};
  return incidence_scatter<T>(x, base, out, n, sides, order, scratch, (cudaStream_t)stream);
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
                      const T* wt_b, int64_t nnz_b, int64_t lo_b, int64_t span_b, int64_t slabs_b,                  \
                      const int32_t* order, T* scratch, void* stream) {                                             \
    return rt::incidence_scatter_c<T>(x, base, out, n, off_a, split_a, src_a, wt_a, nnz_a, lo_a, span_a, slabs_a,   \
                                      off_b, split_b, src_b, wt_b, nnz_b, lo_b, span_b, slabs_b, order, scratch,    \
                                      stream);                                                                       \
  }

RT_SCATTER_ENTRY(rt_incidence_scatter_f32, float)
RT_SCATTER_ENTRY(rt_incidence_scatter_f64, double)
