// Flash attention: out = softmax(q k^T / sqrt(D) + mask) v, streamed over
// key tiles with a running (max m, sum l, accumulator acc) in f32 per query
// row (FlashAttention, arXiv:2205.14135).
//
// Replaces src/repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas (body _flash_kernel), and the head fold and
// padding of its wrapper flash_attention/ops.py.
//
// Layout. q and o are (B, S, Hq, D), k and v (B, S, Hkv, D), with any
// strides whose rows are 16-byte aligned and whose head dim is contiguous.
// Query head h reads kv head h / (Hq / Hkv): the GQA fold makes no copy.
// Keys at or past S are masked here, so nothing is padded.
//
// Numerics, as the TPU kernel: scores in f32, scale applied after the dot;
// a masked score is the finite -1e30, so a row whose first key tile is
// wholly masked gathers junk that c = exp(m_old - m_new) zeroes once a
// visible key arrives, and no exp(-inf - -inf) can occur; p is cast to v's
// dtype before the PV product, which accumulates in f32; the output is
// acc / max(l, 1e-30) in q's dtype. Key tiles wholly above the diagonal or
// outside the window band are not visited.
//
// Bound on the H100: operations. 4*D flops per scored (query, key) pair
// over 989 TFLOP/s (bf16 tensor cores) or 67 TFLOP/s (f32 FMA); at
// hubert-xlarge's shape (B 16, S 1500, 16 heads, D 80, bidirectional) that
// is 0.19 ms a layer, against 0.07 ms for reading q, k, v and writing o.
//
// Design, a first version that is right and simple:
//  * bf16: a block of 4 warps takes 64 query rows, 16 a warp. Key and value
//    tiles of 64 rows are staged in shared memory (rows padded by 16 bytes
//    against bank conflicts) and both products run on mma.sync m16n8k16
//    (bf16 in, f32 accumulate). The score accumulators are re-packed in
//    registers as the A operand of the PV product (FlashAttention-2).
//  * f32: a block of 128 threads takes 32 query rows, 4 threads a row,
//    with 16-key tiles in shared memory and scalar FMA.
// Not used yet: wgmma, TMA or cp.async double buffering, warp
// specialisation.
#include <cuda_bf16.h>

#include "common.cuh"

namespace rt {
namespace flash {

constexpr float kMasked = -1e30f;
constexpr int kBlockThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, Hq, Hkv;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;  // element strides
  int causal, window;  // window <= 0: none
  float scale;
};

// Key tiles [t0, t1) holding a key that some query row in [q_first, q_last] sees.
__device__ __forceinline__ void key_tiles(const Params& p, int q_first, int q_last, int bk, int& t0, int& t1) {
  const int k_end = p.causal ? min(p.S, q_last + 1) : p.S;
  const int k_begin = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  t0 = k_begin / bk;
  t1 = (k_end + bk - 1) / bk;
}

__device__ __forceinline__ bool visible(const Params& p, int q, int key) {
  return key < p.S && (!p.causal || key <= q) && (p.window <= 0 || key > q - p.window);
}

// Every (query, key) pair of the tile is visible: no mask to apply.
__device__ __forceinline__ bool tile_open(const Params& p, int q_first, int q_last, int k0, int bk) {
  const int k_last = k0 + bk - 1;
  return k_last < p.S && (!p.causal || k_last <= q_first) && (p.window <= 0 || k0 > q_last - p.window);
}

// Copy rows [r0, r0 + ROWS) of a (S, D) slice with the given row stride into
// shared memory with row pitch LD, as 16-byte vectors; rows past S are zero
// (their keys are masked, and a zero value row keeps p * v finite).
template <int D, int ROWS, int LD, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t row_stride, int r0, int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kBlockThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- bf16 ----

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row major) * b (16x8, column major), bf16 in, f32 accumulate.
// Fragments (g = lane / 4, t = lane % 4): a = {(g, 2t..2t+1), (g+8, 2t..),
// (g, 2t+8..), (g+8, 2t+8..)}; b = {(2t..2t+1, g), (2t+8..2t+9, g)};
// d = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(kBlockThreads) flash_bf16_kernel(const Params p) {
  constexpr int BQ = 64, BK = 64, LD = D + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal rows start first
  const int b = blockIdx.y / p.Hq, h = blockIdx.y % p.Hq, hk = h / (p.Hq / p.Hkv);
  const int q_last = min(q0 + BQ, p.S) - 1;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // The query tile passes through ks once and stays in registers as A fragments.
  load_tile<D, BQ, LD>(ks, qg, p.q_ss, q0, p.S);
  __syncthreads();
  const int r = warp * 16 + g;  // this thread's rows in the tile: r and r + 8
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* q_lo = ks + r * LD + kk * 16 + 2 * t;
    qf[kk][0] = lds32(q_lo);
    qf[kk][1] = lds32(q_lo + 8 * LD);
    qf[kk][2] = lds32(q_lo + 8);
    qf[kk][3] = lds32(q_lo + 8 * LD + 8);
  }

  const int row[2] = {q0 + r, q0 + r + 8};
  float acc[D / 8][4] = {};
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  int t0, t1;
  key_tiles(p, q0, q_last, BK, t0, t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile (and with q)
    load_tile<D, BK, LD>(ks, kg, p.k_ss, k0, p.S);
    load_tile<D, BK, LD>(vs, vg, p.v_ss, k0, p.S);
    __syncthreads();

    float s[BK / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_16816(s[n], qf[kk], lds32(kr), lds32(kr + 8));
      }
    }

    const bool open = tile_open(p, q0, q_last, k0, BK);
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[n][i] * p.scale;
        if (!open && !visible(p, row[i >> 1], k0 + n * 8 + 2 * t + (i & 1))) x = kMasked;
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float c[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float m_new = fmaxf(m[j], quad_max(mx[j]));
      c[j] = expf(m[j] - m_new);
      m[j] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = expf(s[n][i] - m[i >> 1]);
        ps[i >> 1] += s[n][i];
      }
    }
    // l is this thread's share of the row sum; the quad's shares are summed at the end
    l[0] = l[0] * c[0] + ps[0];
    l[1] = l[1] * c[1] + ps[1];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= c[0];
      acc[nd][1] *= c[0];
      acc[nd][2] *= c[1];
      acc[nd][3] *= c[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]), pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr = vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const __nv_bfloat16* vc = vr + nd * 8;
        mma_16816(acc[nd], a, pack(vc[0], vc[LD]), pack(vc[8 * LD], vc[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float den = fmaxf(quad_sum(l[j]), 1e-30f);
    if (row[j] >= p.S) continue;
    __nv_bfloat16* orow = og + (int64_t)row[j] * p.o_ss + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(orow + nd * 8) = pack(acc[nd][2 * j] / den, acc[nd][2 * j + 1] / den);
    }
  }
}

// ----------------------------------------------------------------- f32 ----

template <int D>
__global__ void __launch_bounds__(kBlockThreads) flash_f32_kernel(const Params p) {
  // pitch D + 4: 16-byte aligned rows, and the 8 rows a warp reads at one
  // column fall in 8 different banks
  constexpr int BQ = 32, BK = 16, LD = D + 4, LP = BK + 1;
  __shared__ __align__(16) float qs[BQ * LD];
  __shared__ __align__(16) float ks[BK * LD];
  __shared__ __align__(16) float vs[BK * LD];
  __shared__ float ps[BQ * LP];

  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;  // row of the tile, quarter of the row
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / p.Hq, h = blockIdx.y % p.Hq, hk = h / (p.Hq / p.Hkv);
  const int q_last = min(q0 + BQ, p.S) - 1;
  const int row = q0 + r;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  load_tile<D, BQ, LD>(qs, qg, p.q_ss, q0, p.S);
  float acc[D / 4] = {};  // columns c, c + 4, c + 8, ...
  float m = kMasked, l = 0.f;
  int t0, t1;
  key_tiles(p, q0, q_last, BK, t0, t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<D, BK, LD>(ks, kg, p.k_ss, k0, p.S);
    load_tile<D, BK, LD>(vs, vg, p.v_ss, k0, p.S);
    __syncthreads();

    float s[BK / 4] = {};  // keys c, c + 4, c + 8, c + 12
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * LD + d];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) s[i] = fmaf(qd, ks[(c + 4 * i) * LD + d], s[i]);
    }
    const bool open = tile_open(p, q0, q_last, k0, BK);
    float mx = kMasked;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      float x = s[i] * p.scale;
      if (!open && !visible(p, row, k0 + c + 4 * i)) x = kMasked;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m, quad_max(mx));
    const float corr = expf(m - m_new);
    m = m_new;
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const float e = expf(s[i] - m);
      psum += e;
      ps[r * LP + c + 4 * i] = e;
    }
    l = l * corr + psum;  // this thread's share; the quad's shares are summed at the end
    __syncwarp();  // a row's four threads are in one warp
#pragma unroll
    for (int j = 0; j < D / 4; ++j) {
      float a = acc[j] * corr;
#pragma unroll
      for (int key = 0; key < BK; ++key) a = fmaf(ps[r * LP + key], vs[key * LD + c + 4 * j], a);
      acc[j] = a;
    }
  }

  const float den = fmaxf(quad_sum(l), 1e-30f);
  if (row < p.S) {
    float* orow = og + (int64_t)row * p.o_ss + c;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) orow[4 * j] = acc[j] / den;
  }
}

template <int D>
int launch(const Params& p, bool bf16, cudaStream_t stream) {
  if (bf16) {
    flash_bf16_kernel<D><<<dim3((p.S + 63) / 64, p.B * p.Hq), kBlockThreads, 0, stream>>>(p);
  } else {
    flash_f32_kernel<D><<<dim3((p.S + 31) / 32, p.B * p.Hq), kBlockThreads, 0, stream>>>(p);
  }
  RT_RETURN_LAUNCH_STATUS();
}

int flash_attention(const Params& p, int D, bool bf16, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(p, bf16, stream);
    case 32: return launch<32>(p, bf16, stream);
    case 64: return launch<64>(p, bf16, stream);
    case 80: return launch<80>(p, bf16, stream);
    case 128: return launch<128>(p, bf16, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, void* o, int B, int S, int Hq, int Hkv, int D,
                   const int64_t* st, int causal, int window) {
  return Params{q, k, v, o, B, S, Hq, Hkv,
                st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
                causal, window, (float)(1.0 / sqrt((double)D))};
}

}  // namespace flash
}  // namespace rt

// Strides are in elements, (batch, sequence, head) for each of q, k, v, o.
#define RT_FLASH_ENTRY(SUFFIX, BF16)                                                                          \
  extern "C" int rt_flash_attention_##SUFFIX(                                                                 \
      const void* q, const void* k, const void* v, void* o, int B, int S, int Hq, int Hkv, int D,             \
      int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,         \
      int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal, int window,             \
      void* stream) {                                                                                           \
    const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};            \
    return rt::flash::flash_attention(rt::flash::make_params(q, k, v, o, B, S, Hq, Hkv, D, st, causal, window), \
                                      D, BF16, (cudaStream_t)stream);                                          \
  }

RT_FLASH_ENTRY(bf16, true)
RT_FLASH_ENTRY(f32, false)
