// Variants of the incidence gather for tools/gather_ab.py, which builds
// this file into one library with the port's kernels (one CUDA runtime in
// the process) and times them beside the port's gather.
//
//   0 parent     the gather of commit 6424a8f (csrc/incidence_gather.cu
//                before its redesign), as it was: one edge a thread a trip,
//                sweep_blocks(E, 132 * 16) blocks of 256 threads
//   1 streams    the same loop with no lookup: u and v read, g written
//                (g = u + v as T)
//   2 sorted     the u side's lookup only: g = w[u] + v
//   3 scattered  the v side's lookup only: g = u + w[v]
//   4 l2         no index stream: each thread sums w at E / threads
//                hashed vertices and writes one value, so the time is the
//                lookups' alone (E lookups of 32-byte sectors from the L2
//                where w misses the L1): the card's rate for them
//   5 vec16      the first redesign, since replaced: one wave of resident
//                blocks, tiles of 2,048 edges, each thread two groups of
//                four consecutive edges, u and v in 16-byte loads, the
//                sixteen lookups before the adds, evict-first streams (no
//                edge factor here)
//
// rt_gather_ab_sweep runs the port's body (csrc/gather.cuh's layout: lanes
// take edges 32 apart) with its parameters free: kSlots edges a thread a
// tile, the edge streams with or without the evict-first hints, and a grid
// of `waves` waves of resident blocks (tools/gather_ab.py --sweep).
//
// Variants 1-3 split the parent's time: the index and output streams, and
// each side's lookups into w on top of them. Variant 0 is both sides.
//
// rt_gather_ab_direction is the step direction of commit 6424a8f
// (csrc/step_direction.cu before the gather's redesign), as it was: a
// grid-stride sweep, four elements a thread in flight, partial_blocks(E)
// blocks, the gather (u not null) or read source.
#include "common.cuh"

namespace rt_ab {

using rt::add_rn;
using rt::kThreads;

template <typename T, int kVariant>
__global__ void gather_variant(const int32_t* __restrict__ u, const int32_t* __restrict__ v, const T* __restrict__ w,
                               T* __restrict__ g, int64_t E) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < E; e += stride) {
    const int32_t a = __ldg(u + e), b = __ldg(v + e);
    if (kVariant == 0) g[e] = add_rn(__ldg(w + a), __ldg(w + b));
    if (kVariant == 1) g[e] = add_rn((T)a, (T)b);
    if (kVariant == 2) g[e] = add_rn(__ldg(w + a), (T)b);
    if (kVariant == 3) g[e] = add_rn((T)a, __ldg(w + b));
  }
}

// A vertex of [0, n) for edge e: a multiplicative hash scaled by a high multiply.
__device__ __forceinline__ int64_t hashed(int64_t e, int64_t n) {
  return (int64_t)(((uint64_t)((uint32_t)e * 2654435761u) * (uint64_t)n) >> 32);
}

template <typename T>
__global__ void l2_lookups(const T* __restrict__ w, int64_t n, T* __restrict__ g, int64_t E) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  T acc[4] = {T(0), T(0), T(0), T(0)};
  int64_t e = t;
  for (; e + 3 * stride < E; e += 4 * stride) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] += __ldg(w + hashed(e + k * stride, n));
  }
  for (; e < E; e += stride) acc[0] += __ldg(w + hashed(e, n));
  g[t] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// The first redesign (variant 5).
constexpr int kGroups = 2;
constexpr int64_t kVecTile = (int64_t)kThreads * 4 * kGroups;

__device__ __forceinline__ int64_t vec_group(int64_t tile, int l) {
  return tile * kVecTile + (int64_t)l * (kThreads * 4) + (int64_t)threadIdx.x * 4;
}

__device__ __forceinline__ void vec_load(const int32_t* __restrict__ p, int64_t i0, int64_t n, bool vec, int32_t* o) {
  if (vec && i0 + 4 <= n) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(p + i0));
    o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = i0 + k < n ? __ldcs(p + i0 + k) : 0;
  }
}

__device__ __forceinline__ void vec_store(float* __restrict__ p, int64_t i0, int64_t n, bool vec, const float* o) {
  if (vec && i0 + 4 <= n) {
    __stcs(reinterpret_cast<float4*>(p + i0), make_float4(o[0], o[1], o[2], o[3]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k < n) __stcs(p + i0 + k, o[k]);
  }
}
__device__ __forceinline__ void vec_store(double* __restrict__ p, int64_t i0, int64_t n, bool vec, const double* o) {
  if (vec && i0 + 4 <= n) {
    __stcs(reinterpret_cast<double2*>(p + i0), make_double2(o[0], o[1]));
    __stcs(reinterpret_cast<double2*>(p + i0 + 2), make_double2(o[2], o[3]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k < n) __stcs(p + i0 + k, o[k]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) vec16_gather(const int32_t* __restrict__ u, const int32_t* __restrict__ v,
                                                         const T* __restrict__ w, T* __restrict__ g, int64_t E) {
  const bool vec = ((((uintptr_t)u) | ((uintptr_t)v) | ((uintptr_t)g)) & 15) == 0;
  const int64_t tiles = (E + kVecTile - 1) / kVecTile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    int32_t iu[4 * kGroups], iv[4 * kGroups];
#pragma unroll
    for (int l = 0; l < kGroups; ++l) {
      vec_load(u, vec_group(t, l), E, vec, iu + 4 * l);
      vec_load(v, vec_group(t, l), E, vec, iv + 4 * l);
    }
    T a[4 * kGroups], b[4 * kGroups], o[4 * kGroups];
#pragma unroll
    for (int j = 0; j < 4 * kGroups; ++j) {
      a[j] = __ldg(w + iu[j]);
      b[j] = __ldg(w + iv[j]);
    }
#pragma unroll
    for (int j = 0; j < 4 * kGroups; ++j) o[j] = add_rn(a[j], b[j]);
#pragma unroll
    for (int l = 0; l < kGroups; ++l) vec_store(g, vec_group(t, l), E, vec, o + 4 * l);
  }
}

template <typename T>
int vec16_launch(const int32_t* u, const int32_t* v, const T* w, T* g, int64_t E, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)vec16_gather<T>, kThreads, 0);
  const int64_t tiles = (E + kVecTile - 1) / kVecTile;
  const int64_t wave = (int64_t)sms * (per_sm < 1 ? 1 : per_sm);
  if (tiles > 0) vec16_gather<T><<<(int)(tiles < wave ? tiles : wave), kThreads, 0, stream>>>(u, v, w, g, E);
  return (int)cudaGetLastError();
}

// The port's body with its parameters free (rt_gather_ab_sweep).
template <typename T, int kSlots, bool kHints>
__global__ void __launch_bounds__(kThreads) sweep_gather(const int32_t* __restrict__ u,
                                                         const int32_t* __restrict__ v, const T* __restrict__ w,
                                                         T* __restrict__ g, int64_t E) {
  constexpr int64_t kTile = (int64_t)kThreads * kSlots;
  const int64_t tiles = (E + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t base = t * kTile + (int64_t)(threadIdx.x >> 5) * (32 * kSlots) + (threadIdx.x & 31);
    int32_t iu[kSlots], iv[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int64_t e = base + j * 32;
      iu[j] = e < E ? (kHints ? __ldcs(u + e) : __ldg(u + e)) : 0;
      iv[j] = e < E ? (kHints ? __ldcs(v + e) : __ldg(v + e)) : 0;
    }
    T a[kSlots], b[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      a[j] = __ldg(w + iu[j]);
      b[j] = __ldg(w + iv[j]);
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int64_t e = base + j * 32;
      if (e < E) {
        if (kHints) {
          __stcs(g + e, add_rn(a[j], b[j]));
        } else {
          g[e] = add_rn(a[j], b[j]);
        }
      }
    }
  }
}

template <typename T, int kSlots, bool kHints>
int sweep_launch(const int32_t* u, const int32_t* v, const T* w, T* g, int64_t E, int waves, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)sweep_gather<T, kSlots, kHints>, kThreads, 0);
  const int64_t tiles = (E + (int64_t)kThreads * kSlots - 1) / ((int64_t)kThreads * kSlots);
  const int64_t grid = (int64_t)waves * sms * (per_sm < 1 ? 1 : per_sm);
  if (tiles > 0)
    sweep_gather<T, kSlots, kHints><<<(int)(tiles < grid ? tiles : grid), kThreads, 0, stream>>>(u, v, w, g, E);
  return (int)cudaGetLastError();
}

template <typename T>
int sweep(int slots, int hints, int waves, const int32_t* u, const int32_t* v, const T* w, T* g, int64_t E,
          cudaStream_t stream) {
  switch (slots * 2 + (hints != 0)) {
    case 8: return sweep_launch<T, 4, false>(u, v, w, g, E, waves, stream);
    case 9: return sweep_launch<T, 4, true>(u, v, w, g, E, waves, stream);
    case 16: return sweep_launch<T, 8, false>(u, v, w, g, E, waves, stream);
    case 17: return sweep_launch<T, 8, true>(u, v, w, g, E, waves, stream);
    case 32: return sweep_launch<T, 16, false>(u, v, w, g, E, waves, stream);
    case 33: return sweep_launch<T, 16, true>(u, v, w, g, E, waves, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
struct NanMax {
  T m;
  __device__ static NanMax identity() { return {rt::neg_inf<T>()}; }
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
  const int32_t* u;
  const int32_t* v;
  const T* w;
  const T* g;
  const T* h;
  const T* x;
  T scale, tiny;
  int64_t E;
  T* d;
  NanMax<T>* part;
  unsigned* ticket;
  T* dmax;
};

template <typename T, bool kGather>
__device__ __forceinline__ T direction(const DirParams<T>& p, int64_t e) {
  const T g = kGather ? add_rn(__ldg(p.w + __ldg(p.u + e)), __ldg(p.w + __ldg(p.v + e))) : __ldg(p.g + e);
  const T h = __ldg(p.h + e);
  const T ratio = h > p.tiny ? rt::div_rn(g, h) : rt::pos_inf<T>();
  const T t = rt::sub_rn(T(1), ratio);
  const T c = t < T(0) ? T(0) : t;
  return rt::mul_rn(rt::mul_rn(p.scale, c), __ldg(p.x + e));
}

template <typename T, bool kGather>
__global__ void __launch_bounds__(kThreads) parent_direction(DirParams<T> p) {
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
  const NanMax<T> r = rt::block_reduce(st);
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
  f = rt::block_reduce(f);
  if (threadIdx.x == 0) {
    p.dmax[0] = f.m;
    *p.ticket = 0;
  }
}

template <typename T>
int direction_launch(const int32_t* u, const int32_t* v, const T* w, const T* g, const T* h, const T* x, double scale,
                     double tiny, int64_t E, int nb, T* d, T* part, unsigned* ticket, T* dmax, cudaStream_t stream) {
  const DirParams<T> p{u, v, w, g, h, x, (T)scale, (T)tiny, E, d, reinterpret_cast<NanMax<T>*>(part), ticket, dmax};
  if (u) {
    parent_direction<T, true><<<nb, kThreads, 0, stream>>>(p);
  } else {
    parent_direction<T, false><<<nb, kThreads, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int variant, const int32_t* u, const int32_t* v, const T* w, int64_t n, T* g, int64_t E,
           cudaStream_t stream) {
  const int blocks = rt::sweep_blocks(E, 132 * 16);
  switch (variant) {
    case 0: gather_variant<T, 0><<<blocks, kThreads, 0, stream>>>(u, v, w, g, E); break;
    case 1: gather_variant<T, 1><<<blocks, kThreads, 0, stream>>>(u, v, w, g, E); break;
    case 2: gather_variant<T, 2><<<blocks, kThreads, 0, stream>>>(u, v, w, g, E); break;
    case 3: gather_variant<T, 3><<<blocks, kThreads, 0, stream>>>(u, v, w, g, E); break;
    case 4: l2_lookups<T><<<blocks, kThreads, 0, stream>>>(w, n, g, E); break;
    case 5: return vec16_launch<T>(u, v, w, g, E, stream);
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace rt_ab

// variant (above); f64: 1 for double, 0 for float; w of n values; g of E
// values (variant 4: of the grid's threads, sweep_blocks(E, 132 * 16) * 256)
extern "C" int rt_gather_ab(int variant, int f64, const int32_t* u, const int32_t* v, const void* w, int64_t n, void* g,
                            int64_t E, void* stream) {
  if (f64) return rt_ab::launch<double>(variant, u, v, (const double*)w, n, (double*)g, E, (cudaStream_t)stream);
  return rt_ab::launch<float>(variant, u, v, (const float*)w, n, (float*)g, E, (cudaStream_t)stream);
}

// The parent's step direction: u, v, w (gather) or g (read: u null), as
// rt_step_direction took them before the edge factor.
extern "C" int rt_gather_ab_direction(int f64, const int32_t* u, const int32_t* v, const void* w, const void* g,
                                      const void* h, const void* x, double scale, double tiny, int64_t E, int nb,
                                      void* d, void* part, unsigned* ticket, void* dmax, void* stream) {
  if (f64)
    return rt_ab::direction_launch<double>(u, v, (const double*)w, (const double*)g, (const double*)h,
                                           (const double*)x, scale, tiny, E, nb, (double*)d, (double*)part, ticket,
                                           (double*)dmax, (cudaStream_t)stream);
  return rt_ab::direction_launch<float>(u, v, (const float*)w, (const float*)g, (const float*)h, (const float*)x,
                                        scale, tiny, E, nb, (float*)d, (float*)part, ticket, (float*)dmax,
                                        (cudaStream_t)stream);
}

// The port's gather body with kSlots (4, 8 or 16) edges a thread, the edge
// streams' hints on (1) or off (0), and `waves` waves of resident blocks.
extern "C" int rt_gather_ab_sweep(int f64, int slots, int hints, int waves, const int32_t* u, const int32_t* v,
                                  const void* w, void* g, int64_t E, void* stream) {
  if (f64)
    return rt_ab::sweep<double>(slots, hints, waves, u, v, (const double*)w, (double*)g, E, (cudaStream_t)stream);
  return rt_ab::sweep<float>(slots, hints, waves, u, v, (const float*)w, (float*)g, E, (cudaStream_t)stream);
}
