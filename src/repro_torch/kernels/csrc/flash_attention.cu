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
// dtype (bf16) or split into TF32 parts (f32, below) before the PV product,
// which accumulates in f32, and l sums p before that; the output is
// acc / max(l, 1e-30) in q's dtype.
// Key tiles wholly above the diagonal or outside the window band are not
// visited. Both bodies take the softmax in base 2: the scores are scaled by
// scale * log2(e) after the dot and exponentiated with ex2.approx, which is
// exp() of the scaled scores up to float rounding; a masked score is -1e30
// after that scaling.
//
// Bound on the H100: operations. 4*D flops per scored (query, key) pair
// over 989 TFLOP/s (bf16 tensor cores); at hubert-xlarge's shape (B 16,
// S 1500, 16 heads, D 80, bidirectional) that is 0.19 ms a layer, against
// 0.07 ms for reading q, k, v and writing o. The f32 body does each product
// three times on the TF32 tensor cores (below): 3 * 4*D flops a pair over
// 495 TFLOP/s, 1.117 ms at that shape in f32 (against 2.751 ms for the same
// flops once over the 67 TFLOP/s of f32 FMA).
//
// Design:
//  * bf16, for Hopper (sm_90a), after FlashAttention-3 (arXiv:2407.08608):
//    warp-specialised on a persistent grid. A producer thread loads Q and K
//    and V tiles into a ring of shared-memory stages with the TMA
//    (cp.async.bulk.tensor, 4-D tensor maps over the strided layout, rows
//    past S zero-filled), completion reported on mbarriers; two consumer
//    warpgroups of 64 query rows run both products on wgmma (QK^T with Q
//    and K in shared memory; PV with P from registers, re-packed from the
//    score accumulators) and the online softmax, and hand each stage back
//    once their products are done with it. Inside a warpgroup, tile i's
//    softmax runs while tile i-1's PV is in flight; the two warpgroups take
//    turns on the tensor cores (ping-pong). setmaxnreg moves registers from
//    the producer to the consumers. Details at the kernel.
//  * f32, on the Ampere-style tensor-core path that sm_90a still runs: a
//    block of 4 warps takes 64 query rows, 16 a warp, on a flat grid (any
//    B * Hq); K and V tiles stream through a two-stage cp.async ring in
//    shared memory; both products run on mma.sync m16n8k8 tf32 in 3xTF32
//    (three products of split operands, f32 accumulators), which holds the
//    f32 bar where one TF32 pass does not. Details at the kernel.
#include <cuda.h>
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
  int section_heads;  // bf16: query heads of an L2 section of the work order (a multiple of Hq / Hkv)
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- bf16 ----
//
// A persistent grid, one block an SM. A work tile is BQ = 128 query rows of
// one (batch, head) and their key tiles of BK = 128 keys; the blocks deal
// the work tiles among themselves (round_tile, work_tile). Three
// warpgroups: warpgroup 0 is the producer (one thread issues the TMA loads,
// the others leave), warpgroups 1 and 2 are consumers of 64 query rows
// each. Q has one buffer; K and V tiles pass through a ring of STAGES
// shared-memory stages that runs on across work tiles, so the producer loads
// the next work tile's first keys while the consumers finish the last
// ones. Each buffer has a full mbarrier (completed by the TMA's byte count)
// and an empty one (each consumer warp arrives when its products no longer
// read it), K and V apart, so a K tile is refilled as soon as QK^T is done
// with it.
//
// Shared-memory layout. A tile of R rows is stored as NB column boxes of R
// rows x W columns (SW = 2W bytes a row), each box swizzled by the TMA with
// the SW-byte pattern that wgmma reads: W = 64 from D 64 up (128-byte
// swizzle), 32 at D 32 (64-byte), 16 at D 16 (32-byte). At D 80 the second
// box's columns 80-127 are zero-filled and never read: the products stop at
// column 80. Of the three layouts measured at D 80 on the H100 (PERF.md,
// tools/flash_ab.py) this is the fastest: wgmma reads the 128-byte swizzle
// fastest, ahead of five 16-column boxes (32-byte) and three 32-column
// boxes (64-byte).
//   * QK^T: A = Q and B = K are K-major (the head dim is contiguous): k step
//     kk reads columns 16kk..16kk+15, box 16kk / W at byte (16kk % W) * 2 of
//     the row; 8-row groups are 8 * SW bytes apart (the descriptor's SBO).
//   * PV: A = P from registers, B = V is MN-major (keys x head dim, the head
//     dim contiguous: the transpose bit is set). k step kk reads keys
//     16kk..16kk+15, 16 * SW bytes down the boxes; the head dim's boxes are
//     R * SW bytes apart (LBO), 8-key groups 8 * SW bytes (SBO).

template <int D>
struct Bf16Tile {
  // Two consumer warpgroups of 64 query rows each. Three (192 rows, 1.5x the
  // flops per byte of K and V) leave 160 registers a consumer thread, and
  // d 80 then spills.
  static constexpr int NC = 2;
  static constexpr int BQ = 64 * NC;              // query rows of a work tile
  static constexpr int THREADS = 128 * (1 + NC);  // + the producer warpgroup
  static constexpr int EMPTY_ARRIVALS = 4 * NC;   // one arrival per consumer warp
  // setmaxnreg: the producer gives up registers that the consumers take (24 * 128 + 240 * 256 <= 65,536)
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  static constexpr int SW = D >= 64 ? 128 : D >= 32 ? 64 : 32;  // swizzle bytes = bytes of a box row
  static constexpr int W = SW / 2;                                // head-dim columns of a box
  static constexpr int NB = (D + W - 1) / W;                      // boxes a tile
  static constexpr int BK = 128;                                  // keys of a key tile
  // a tile row holds NB * W >= D columns; those past D are zero-filled by the TMA and never read
  static constexpr int Q_BYTES = BQ * NB * W * 2, KV_BYTES = BK * NB * W * 2;
  static constexpr int STAGES = (220 * 1024 - Q_BYTES) / (2 * KV_BYTES) >= 4   ? 4
                                : (220 * 1024 - Q_BYTES) / (2 * KV_BYTES) >= 3 ? 3
                                                                                : 2;
  static constexpr int BARRIERS = 2 + 4 * STAGES;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's 1024-byte period
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARRIERS;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;  // wgmma descriptor swizzle mode
  static_assert(D % 16 == 0, "head dim must be a multiple of 16 (a wgmma k step)");
  static_assert(SMEM <= 227 * 1024, "tiles exceed the shared memory of a block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA: the box at coordinates (c0, c1, c2, c3) of a 4-D tensor map into
// shared memory at dst; completion is counted in bytes on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Order every use of r after the last volatile asm (a wgmma wait), and every
// write of r before the next: wgmma's registers are read and written
// asynchronously, which the compiler cannot see.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets (16-byte units), swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (layout << 62);
}

#define RT_F8(d, i)                                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])

// Accumulator layout of m64nNk16 (the same for d and, 16 columns at a time,
// for the register A operand): in warp w, lane (g = lane / 4, t = lane % 4)
// holds d[4j + i] = (row 16w + g + 8 (i / 2), column 8j + 2t + i % 2).

// d[64 x N] (+)= A[64 x 16] * B[16 x N], A and B K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : RT_F8(d, 0), RT_F8(d, 8), RT_F8(d, 16), RT_F8(d, 24), RT_F8(d, 32), RT_F8(d, 40), RT_F8(d, 48), RT_F8(d, 56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x N] += A[64 x 16] * B[16 x N], A from registers, B MN-major (transposed) in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : RT_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : RT_F8(d, 0), RT_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RT_F8(d, 0), RT_F8(d, 8), RT_F8(d, 16), RT_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : RT_F8(d, 0), RT_F8(d, 8), RT_F8(d, 16), RT_F8(d, 24), RT_F8(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RT_F8(d, 0), RT_F8(d, 8), RT_F8(d, 16), RT_F8(d, 24), RT_F8(d, 32), RT_F8(d, 40), RT_F8(d, 48), RT_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef RT_F8

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kSchedBarrier = 1;  // named barriers 1 and 2: the consumers' turns (0 is __syncthreads)

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// One tile of the online softmax for this thread's two rows (s[e] in row
// (e / 2) % 2): scores in (raw, or already scaled and then scale_log2 = 1),
// unnormalised probabilities p = exp2(s * scale_log2 - m) out; m and l
// (this thread's share of the row sum, of p before any rounding) are
// updated and c gets the factors that rescale the older sums.
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N], float (&m)[2], float (&l)[2], float (&c)[2],
                                               float scale_log2) {
  float mx[2] = {s[0], s[2]};
#pragma unroll
  for (int e = 0; e < N; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // scale_log2 > 0, so the max of the scaled scores is the scaled max
    const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
    c[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float pe = exp2_approx(fmaf(s[e], scale_log2, neg_m[(e >> 1) & 1]));
    s[e] = pe;
    ps[(e >> 1) & 1] += pe;
  }
  l[0] = l[0] * c[0] + ps[0];
  l[1] = l[1] * c[1] + ps[1];
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&c)[2]) {
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] *= c[(e >> 1) & 1];
}

// Probabilities (accumulator layout, N / 2 keys) -> bf16 A fragments of PV, 16 keys each.
template <int N>
__device__ __forceinline__ void pack_probs(uint32_t (&pf)[N / 8][4], const float (&s)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) pf[kk][j] = pack(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// One work tile: 128 query rows of one (batch, head) and their key tiles [t0, t1).
struct WorkTile {
  int q0, b, h, hk, t0, t1;
};

// Work tile w. The (batch, head)s are cut into sections of section_heads
// (launch_bf16 chooses them), taken one after the other, so that the tiles
// in flight share their K and V through the L2; within a section the
// longest causal rows come first (all its heads' last query tiles, then the
// ones before), as FlashAttention-3's LPT scheduler orders them.
template <int BQ, int BK>
__device__ __forceinline__ WorkTile work_tile(const Params& p, int w) {
  const int n_qt = (p.S + BQ - 1) / BQ;
  const int section = w / (p.section_heads * n_qt);
  const int first = section * p.section_heads;
  const int heads = min(p.section_heads, p.B * p.Hq - first);
  const int r = w - first * n_qt;
  const int bh = first + r % heads;
  WorkTile t;
  t.q0 = (n_qt - 1 - r / heads) * BQ;
  t.b = bh / p.Hq;
  t.h = bh % p.Hq;
  t.hk = t.h / (p.Hq / p.Hkv);
  key_tiles(p, t.q0, min(t.q0 + BQ, p.S) - 1, BK, t.t0, t.t1);
  return t;
}

// The persistent grid's blocks deal the work tiles in rounds, snaking
// (forward in even rounds, backward in odd ones) so that the long causal
// tiles at the front spread evenly: block `block` takes tile round_tile(r)
// in round r, if it is < n_work.
__device__ __forceinline__ int round_tile(int r, int block, int blocks) {
  return r * blocks + ((r & 1) ? blocks - 1 - block : block);
}

template <int D>
__global__ void __launch_bounds__(Bf16Tile<D>::THREADS, 1)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const Params p, int n_work) {
  using T = Bf16Tile<D>;
  constexpr int SW = T::SW, W = T::W, NB = T::NB, STAGES = T::STAGES, BQ = T::BQ, BK = T::BK, NC = T::NC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + T::Q_BYTES;  // stage s at k_s + s * KV_BYTES
  const uint32_t v_s = k_s + STAGES * T::KV_BYTES;
  // mbarriers: Q full and empty, then per stage K full, V full, K empty, V empty
  const uint32_t bars = v_s + STAGES * T::KV_BYTES;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8 * (2 + s); };
  auto v_full = [&](int s) { return bars + 8 * (2 + STAGES + s); };
  auto k_empty = [&](int s) { return bars + 8 * (2 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bars + 8 * (2 + 3 * STAGES + s); };
  const int block = blockIdx.x, blocks = gridDim.x;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, T::EMPTY_ARRIVALS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), T::EMPTY_ARRIVALS);
      mbar_init(v_empty(s), T::EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform, as the compiler can see
  if (wg == 0) {  // producer: one thread keeps the TMA loads of every work tile in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    int it = 0;  // position in the K/V ring, over all work tiles
    for (int r = 0, item = 0; r * blocks < n_work; ++r) {
      const int w = round_tile(r, block, blocks);
      if (w >= n_work) continue;
      const WorkTile wt = work_tile<BQ, BK>(p, w);
      mbar_wait(q_empty, (item++ & 1) ^ 1);  // a fresh barrier passes parity 1 at once
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int c = 0; c < NB; ++c) tma_load_4d(q_s + c * BQ * SW, &tq, q_full, c * W, wt.h, wt.q0, wt.b);
      for (int t = wt.t0; t < wt.t1; ++t, ++it) {
        const int s = it % STAGES;
        const uint32_t phase = (it / STAGES) & 1;
        mbar_wait(k_empty(s), phase ^ 1);
        mbar_expect_tx(k_full(s), T::KV_BYTES);
        for (int c = 0; c < NB; ++c)
          tma_load_4d(k_s + s * T::KV_BYTES + c * BK * SW, &tk, k_full(s), c * W, wt.hk, t * BK, wt.b);
        mbar_wait(v_empty(s), phase ^ 1);
        mbar_expect_tx(v_full(s), T::KV_BYTES);
        for (int c = 0; c < NB; ++c)
          tma_load_4d(v_s + s * T::KV_BYTES + c * BK * SW, &tv, v_full(s), c * W, wt.hk, t * BK, wt.b);
      }
    }
    return;
  }

  // Consumer warpgroup: 64 query rows of each work tile. Both warpgroups
  // walk all of the tile's key tiles: a key tile that one of them sees
  // wholly masked adds exp(-1e30 - m) = 0, or junk that a later visible key
  // clears.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane / 4, tq4 = lane % 4;
  const float scale_log2 = p.scale * 1.4426950408889634f;  // softmax in base 2: exp(x) = exp2(x log2 e)
  const uint32_t q_wg = q_s + cw * 64 * SW;                 // this warpgroup's 64 rows of every Q box

  // Ping-pong (FlashAttention-3): the two warpgroups take turns to issue
  // their products, so that one's softmax runs while the other's products
  // hold the tensor cores. Warpgroup 0 takes the first turn.
  const int my_turn = kSchedBarrier + cw, their_turn = kSchedBarrier + (cw + 1) % NC;
  if (cw == NC - 1) named_arrive(their_turn, 256);

  float acc[D / 2], s_acc[BK / 2], m[2], l[2], c[2];
  uint32_t pf[BK / 16][4];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s_acc[i] = 0.f;

  int it = 0;  // position in the K/V ring, over all work tiles
  for (int r = 0, item = 0; r * blocks < n_work; ++r) {
    const int w = round_tile(r, block, blocks);
    if (w >= n_work) continue;
    const bool last_tile = (r + 1) * blocks >= n_work || round_tile(r + 1, block, blocks) >= n_work;
    const WorkTile wt = work_tile<BQ, BK>(p, w);
    const int wq_first = wt.q0 + 64 * cw, wq_last = min(wq_first + 63, p.S - 1);
    const int row[2] = {wq_first + 16 * warp + g, wq_first + 16 * warp + g + 8};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    m[0] = m[1] = kMasked;
    l[0] = l[1] = 0.f;

    auto stage = [&](int i) { return (it + i) % STAGES; };
    auto parity = [&](int i) { return (uint32_t)(((it + i) / STAGES) & 1); };
    auto issue_qk = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = kk * 16 / W, within = (kk * 16 % W) * 2;
        const uint64_t da = gmma_desc(q_wg + col * BQ * SW + within, 16, 8 * SW, T::LAYOUT);
        const uint64_t db = gmma_desc(k_s + s * T::KV_BYTES + col * BK * SW + within, 16, 8 * SW, T::LAYOUT);
        wgmma_ss<BK>(s_acc, da, db, kk > 0);
      }
    };
    auto issue_pv = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(acc, pf[kk], gmma_desc(v_s + s * T::KV_BYTES + kk * 16 * SW, BK * SW, 8 * SW, T::LAYOUT));
    };
    auto softmax = [&](int t) {
      const int k0 = t * BK;
      const bool open = tile_open(p, wq_first, wq_last, k0, BK);
      if (!open) {
        // An edge tile is scaled first and masked after, so that a masked
        // score is exactly -1e30 whatever the scale.
#pragma unroll
        for (int e = 0; e < BK / 2; ++e)
          s_acc[e] = visible(p, row[(e >> 1) & 1], k0 + 8 * (e >> 2) + 2 * tq4 + (e & 1)) ? s_acc[e] * scale_log2
                                                                                             : kMasked;
      }
      online_softmax(s_acc, m, l, c, open ? scale_log2 : 1.f);
    };

    // Key tile t0: its scores and softmax. Then tile i's QK^T and tile
    // i-1's PV are issued together, and tile i's softmax runs while PV is in
    // flight. Q goes back to the producer after the last QK^T.
    const int n = wt.t1 - wt.t0;
    mbar_wait(q_full, item++ & 1);
    mbar_wait(k_full(stage(0)), parity(0));
    named_sync(my_turn, 256);
    wgmma_fence();
    issue_qk(stage(0));
    wgmma_commit();
    named_arrive(their_turn, 256);
    wgmma_wait<0>();
    fence_regs(s_acc);
    if (lane == 0) {
      mbar_arrive(k_empty(stage(0)));
      if (n == 1) mbar_arrive(q_empty);
    }
    softmax(wt.t0);
    pack_probs(pf, s_acc);

    for (int i = 1; i < n; ++i) {
      const int s = stage(i), sp = stage(i - 1);
      mbar_wait(k_full(s), parity(i));
      named_sync(my_turn, 256);
      fence_regs(s_acc);
      fence_regs(acc);
      wgmma_fence();
      issue_qk(s);
      wgmma_commit();
      mbar_wait(v_full(sp), parity(i - 1));
      issue_pv(sp);
      wgmma_commit();
      named_arrive(their_turn, 256);
      wgmma_wait<1>();  // QK^T done, PV in flight
      fence_regs(s_acc);
      if (lane == 0) {
        mbar_arrive(k_empty(s));
        if (i == n - 1) mbar_arrive(q_empty);
      }
      softmax(wt.t0 + i);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pf);
      if (lane == 0) mbar_arrive(v_empty(sp));
      rescale(acc, c);
      pack_probs(pf, s_acc);
    }

    const int sl = stage(n - 1);
    mbar_wait(v_full(sl), parity(n - 1));
    named_sync(my_turn, 256);
    fence_regs(acc);
    wgmma_fence();
    issue_pv(sl);
    wgmma_commit();
    // every turn is handed on except the last warpgroup's very last: warpgroup 0 has no turn left to take
    if (cw != NC - 1 || !last_tile) named_arrive(their_turn, 256);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pf);
    if (lane == 0) mbar_arrive(v_empty(sl));
    it += n;

    // rows past S are not written (predicated stores: no divergent branch
    // between this warpgroup's products, which would serialize them)
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + wt.b * p.o_sb + wt.h * p.o_sh;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float den = fmaxf(quad_sum(l[rr]), 1e-30f);
      const bool in_range = row[rr] < p.S;
      uint32_t* orow = reinterpret_cast<uint32_t*>(og + (int64_t)min(row[rr], p.S - 1) * p.o_ss + 2 * tq4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const uint32_t out = pack(acc[4 * j + 2 * rr] / den, acc[4 * j + 2 * rr + 1] / den);
        if (in_range) orow[4 * j] = out;
      }
    }
  }
}

// ----------------------------------------------------------------- f32 ----
//
// A flat grid of blocks, one per (query tile of BQ = 64 rows, batch * head):
// block w takes (batch, head) w / n_qt and, within a head, the query tiles
// from the last (longest causal rows) to the first. Four warps of 16 query
// rows each (the m of m16n8k8). K and V tiles of BK keys pass through a ring
// of STAGES shared-memory stages filled by cp.async (16 bytes a copy, rows
// past S zero-filled), so that tile i + 1 loads while tile i computes.
//
// Products in 3xTF32. One pass of TF32 (10 mantissa bits) misses the f32
// bar of 3e-5 elementwise, and three passes hold it as plain f32 does:
// tests/test_torch_flash_attention.py (test_tf32_split_plan) emulates the
// rounding on the test sweep (d 32, S 16 to 130) against the reference's
// Pallas kernel, where max |err| / (1 + |ref|) is 3.7e-4 to 8.2e-4 for one
// pass and 3.5e-7 to 5.5e-7 for three. So every operand x is split as
// big = rna(x), small = rna(x - big), rna being cvt.rna.tf32.f32's rounding
// (split_tf32), and every product a * b is small_a * big_b + big_a * small_b
// + big_a * big_b, accumulated in f32 into the same registers in that order
// (small_a * small_b, ~2^-22 of the product, is dropped).
//
// Fragments (g = lane / 4, t = lane % 4) of m16n8k8 tf32: A = {(g, t),
// (g+8, t), (g, t+4), (g+8, t+4)}; B = {(k t, n g), (k t+4, n g)};
// C = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}. A product's k and n
// indices may map to keys and head-dim columns in any order, as long as
// both operands (and, for n, the output) agree; the orders below make every
// fragment a contiguous load.
//   * QK^T: A = Q, split once per block: in registers up to D 80; at D 128
//     (64 registers more for O) in shared memory in fragment order, each
//     thread reading back its own float4s. Head-dim order: k step 2u + h
//     takes columns 16u + 4t + 2h (k index t) and 16u + 4t + 2h + 1 (t + 4),
//     so one 16-byte load of K row g (B's n index) gives both k steps.
//   * PV: A = P straight from the score accumulators. C gives a thread keys
//     2t and 2t+1 of each 8, where A wants columns t and t+4; the keys are
//     permuted instead of moved: A column t is key 2t and column t+4 key
//     2t+1, so a = {c0, c2, c1, c3} with no shuffle, and B reads V rows 2t
//     and 2t+1. Head-dim order: n-tile 2u + h's column c is 16u + 2c + h,
//     so one 8-byte load of a V row gives n-tiles 2u and 2u + 1, and a
//     thread's outputs are 4 contiguous columns (one 16-byte store a row).
// Row pitches (floats), so that each load hits 32 distinct banks in every
// wavefront: K's 16-byte loads go a quarter warp at a time (rows g and
// g + 1, 4 threads a row), so LDK = 16 mod 32 puts row g + 1 in the other
// half of the banks; V's 8-byte loads go a half warp at a time (rows 2t,
// 4 threads a row), so LDV = 4 mod 16 puts rows 0, 2, 4 and 6 in banks 8
// apart. Both are multiples of 4, as cp.async's 16-byte copies need.

template <int D>
struct F32Tile {
  static constexpr int BQ = 64;                 // query rows of a block, 16 a warp
  static constexpr bool Q_IN_REGS = D <= 80;    // else Q's split fragments sit in shared memory
  // keys of a tile: 32 up to D 80 (64 leave too few registers at D 80 with
  // Q's fragments in them, and spill); 16 at D 128, where Q's fragments take
  // 64 KB of shared memory and two blocks must still fit an SM's 228 KB
  static constexpr int BK = D <= 80 ? 32 : 16;
  static constexpr int STAGES = 2;
  static constexpr int LDK = D + (48 - D % 32) % 32;  // K's row pitch in floats: 16 mod 32
  static constexpr int LDV = D + 4;                   // V's: 4 mod 16
  static constexpr int K_FLOATS = BK * LDK, V_FLOATS = BK * LDV;  // one stage
  static constexpr int QF_FLOAT4S = Q_IN_REGS ? 0 : 2 * (D / 8) * kBlockThreads;  // big and small, k step, thread
  static constexpr int SMEM = 4 * (STAGES * (K_FLOATS + V_FLOATS) + 4 * QF_FLOAT4S);
  static constexpr int MIN_BLOCKS = 2;          // blocks an SM, for __launch_bounds__
  static_assert(D % 16 == 0, "head dim must be a multiple of 16 (two m16n8k8 k steps)");
  static_assert(BK * D / 4 % kBlockThreads == 0, "a K or V tile is a whole number of 16-byte copies a thread");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 228 * 1024, "two blocks must fit an SM's shared memory");
};

// x rounded to TF32 (10 mantissa bits, ties away from zero), as the 32-bit
// pattern that mma.sync reads: the bits of cvt.rna.tf32.f32, computed with
// two integer operations (half a TF32 ulp added to the magnitude, the 13
// low bits cleared). The cvt instruction runs on a slower conversion
// pipe, and the split runs on every K, V and P element a warp reads.
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x as big + small, both TF32: the operand split of 3xTF32 (both products).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(__fsub_rn(x, __uint_as_float(big)));
}

struct FragA {  // an A fragment of m16n8k8, split
  uint32_t big[4], small[4];
};

struct FragB {  // a B fragment, split
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void split_a(FragA& f, float x0, float x1, float x2, float x3) {
  split_tf32(x0, f.big[0], f.small[0]);
  split_tf32(x1, f.big[1], f.small[1]);
  split_tf32(x2, f.big[2], f.small[2]);
  split_tf32(x3, f.big[3], f.small[3]);
}

__device__ __forceinline__ void split_b(FragB& f, float x0, float x1) {
  split_tf32(x0, f.big[0], f.small[0]);
  split_tf32(x1, f.big[1], f.small[1]);
}

// d[0..3] += a (16x8, row major) * b (8x8, column major), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// n-tile j of d (d[4j..4j+3]) += a * b[j] for G n-tiles, in 3xTF32. Each
// pass runs over the whole group before the next, so G independent
// products separate two passes on the same accumulator.
template <int G>
__device__ __forceinline__ void mma_3xtf32(float* d, const FragA& a, const FragB (&b)[G]) {
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32(d + 4 * j, a.small, b[j].big);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32(d + 4 * j, a.big, b[j].small);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32(d + 4 * j, a.big, b[j].big);
}

// 16 bytes from global to shared memory, asynchronously; zeros when !fill
// (src is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// No (query, key) pair of the key tile at k0 is visible to rows [q_first, q_last].
__device__ __forceinline__ bool tile_dead(const Params& p, int q_first, int q_last, int k0, int bk) {
  return q_first >= p.S || k0 >= p.S || (p.causal && k0 > q_last) || (p.window > 0 && k0 + bk - 1 <= q_first - p.window);
}

template <int D>
__global__ void __launch_bounds__(kBlockThreads, F32Tile<D>::MIN_BLOCKS) flash_f32_kernel(const Params p) {
  using T = F32Tile<D>;
  constexpr int BQ = T::BQ, BK = T::BK, LDK = T::LDK, LDV = T::LDV, STAGES = T::STAGES;
  constexpr int NK = D / 8;   // k steps of QK^T, n-tiles of PV
  constexpr int NT = BK / 8;  // n-tiles of QK^T, k steps of PV
  constexpr int GK = NT < 4 ? NT : 4;  // n-tiles of QK^T that share one load of K fragments
  extern __shared__ float4 f32_smem[];
  float* ks = reinterpret_cast<float*>(f32_smem);  // stage s at ks + s * K_FLOATS
  float* vs = ks + STAGES * T::K_FLOATS;           // stage s at vs + s * V_FLOATS
  float4* qf = reinterpret_cast<float4*>(vs + STAGES * T::V_FLOATS);  // D 128: [k step][big, small][thread]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_qt = (p.S + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x % n_qt)) * BQ;
  const int b = bh / p.Hq, h = bh % p.Hq, hk = h / (p.Hq / p.Hkv);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  int t0, t1;
  key_tiles(p, q0, min(q0 + BQ, p.S) - 1, BK, t0, t1);
  const int n = t1 - t0;
  // key tile t0 + i into stage i % STAGES; rows past S zero-filled (their
  // keys are masked, and a zero value row keeps p * v finite)
  auto load_kv = [&](int i) {
    float* kd = ks + (i % STAGES) * T::K_FLOATS;
    float* vd = vs + (i % STAGES) * T::V_FLOATS;
    const int k0 = (t0 + i) * BK;
#pragma unroll
    for (int it = 0; it < BK * D / 4 / kBlockThreads; ++it) {
      const int c = it * kBlockThreads + threadIdx.x, r = c / (D / 4), col = (c % (D / 4)) * 4;
      const bool in = k0 + r < p.S;
      const int64_t key = in ? k0 + r : 0;
      cp_async16(kd + r * LDK + col, kg + key * p.k_ss + col, in);
      cp_async16(vd + r * LDV + col, vg + key * p.v_ss + col, in);
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) load_kv(i);
    cp_async_commit();
  }

  // This warp's rows: row[0] = wq_first + g and row[1] = row[0] + 8. Q's
  // fragments come straight from global memory (once a block), rows past S
  // as zeros, and are split once. Head-dim order: k step 2u + h takes
  // columns 16u + 4t + 2h (A column t) and 16u + 4t + 2h + 1 (column t + 4).
  const int wq_first = q0 + 16 * warp, wq_last = min(wq_first + 15, p.S - 1);
  const int row[2] = {wq_first + g, wq_first + g + 8};
  FragA qa[T::Q_IN_REGS ? NK : 1];
#pragma unroll
  for (int u = 0; u < NK / 2; ++u) {
    float4 x[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      x[r] = row[r] < p.S ? __ldg(reinterpret_cast<const float4*>(qg + (int64_t)row[r] * p.q_ss + 16 * u + 4 * t))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = 2 * u + h;
      FragA& f = qa[T::Q_IN_REGS ? kk : 0];
      if (h == 0) split_a(f, x[0].x, x[1].x, x[0].y, x[1].y);
      else split_a(f, x[0].z, x[1].z, x[0].w, x[1].w);
      if constexpr (!T::Q_IN_REGS) {
        qf[(2 * kk) * kBlockThreads + threadIdx.x] = *reinterpret_cast<const float4*>(f.big);
        qf[(2 * kk + 1) * kBlockThreads + threadIdx.x] = *reinterpret_cast<const float4*>(f.small);
      }
    }
  }

  auto q_frag = [&](int kk) -> FragA {
    if constexpr (T::Q_IN_REGS) {
      return qa[kk];
    } else {
      FragA f;
      *reinterpret_cast<float4*>(f.big) = qf[(2 * kk) * kBlockThreads + threadIdx.x];
      *reinterpret_cast<float4*>(f.small) = qf[(2 * kk + 1) * kBlockThreads + threadIdx.x];
      return f;
    }
  };

  const float scale_log2 = p.scale * 1.4426950408889634f;  // softmax in base 2: exp(x) = exp2(x log2 e)
  float acc[D / 2] = {};  // accumulator layout: n-tile nd in acc[4nd..4nd+3]
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile i have landed
    __syncthreads();              // everyone's have; and everyone is done with tile i - 1
    if (i + STAGES - 1 < n) load_kv(i + STAGES - 1);  // into tile i - 1's stage
    cp_async_commit();
    const int k0 = (t0 + i) * BK;
    // a tile that no row of this warp sees adds exactly nothing (exp(-1e30 -
    // m) = 0, or junk that a later visible key clears): skip its products
    if (tile_dead(p, wq_first, wq_last, k0, BK)) continue;
    const float* kt = ks + (i % STAGES) * T::K_FLOATS;
    const float* vt = vs + (i % STAGES) * T::V_FLOATS;

    // QK^T: one 16-byte load gives key 8j + g's B fragments of k steps 2u and 2u + 1
    float s[BK / 2] = {};
#pragma unroll
    for (int u = 0; u < NK / 2; ++u) {
      const FragA a0 = q_frag(2 * u), a1 = q_frag(2 * u + 1);
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += GK) {
        float4 kv[GK];
        FragB bk[GK];
#pragma unroll
        for (int j = 0; j < GK; ++j) kv[j] = *reinterpret_cast<const float4*>(kt + (8 * (j0 + j) + g) * LDK + 16 * u + 4 * t);
#pragma unroll
        for (int j = 0; j < GK; ++j) split_b(bk[j], kv[j].x, kv[j].y);
        mma_3xtf32<GK>(s + 4 * j0, a0, bk);
#pragma unroll
        for (int j = 0; j < GK; ++j) split_b(bk[j], kv[j].z, kv[j].w);
        mma_3xtf32<GK>(s + 4 * j0, a1, bk);
      }
    }

    // the softmax of the bf16 body: an edge tile is scaled first and masked
    // after, so that a masked score is exactly -1e30; l sums p before its split
    const bool open = tile_open(p, wq_first, wq_last, k0, BK);
    if (!open) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e)
        s[e] = visible(p, row[(e >> 1) & 1], k0 + 8 * (e >> 2) + 2 * t + (e & 1)) ? s[e] * scale_log2 : kMasked;
    }
    float c[2];
    online_softmax(s, m, l, c, open ? scale_log2 : 1.f);
    rescale(acc, c);

    // PV: keys 8j..8j+7, A column t is key 2t and column t + 4 key 2t + 1.
    // Head-dim order: n-tile 2u + h's column c is 16u + 2c + h, so one
    // 8-byte load gives a key's B fragments of n-tiles 2u and 2u + 1.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragA pa;
      split_a(pa, s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]);
      const float* vr = vt + (8 * j + 2 * t) * LDV + 2 * g;
#pragma unroll
      for (int u = 0; u < NK / 2; ++u) {
        const float2 v0 = *reinterpret_cast<const float2*>(vr + 16 * u);        // key 2t
        const float2 v1 = *reinterpret_cast<const float2*>(vr + LDV + 16 * u);  // key 2t + 1
        FragB bv[2];
        split_b(bv[0], v0.x, v1.x);
        split_b(bv[1], v0.y, v1.y);
        mma_3xtf32<2>(acc + 8 * u, pa, bv);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (the last commits are empty)

  // n-tiles 2u and 2u + 1 hold this thread's columns 16u + 4t .. 16u + 4t + 3 of each row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row[r] >= p.S) continue;
    float* orow = og + (int64_t)row[r] * p.o_ss + 4 * t;
#pragma unroll
    for (int u = 0; u < NK / 2; ++u) {
      const float* a0 = acc + 8 * u + 2 * r;  // n-tile 2u, columns 2t and 2t + 1
      const float* a1 = a0 + 4;               // n-tile 2u + 1
      *reinterpret_cast<float4*>(orow + 16 * u) = make_float4(a0[0] / den, a1[0] / den, a0[1] / den, a1[1] / den);
    }
  }
}

// ---------------------------------------------------------------- host ----

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: its entry
// point comes from cudaGetDriverEntryPoint, so the library links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// A 4-D map of a (B, S, H, D) bf16 tensor, dims innermost first (D, H, S, B)
// with the tensor's own strides, read in boxes of W columns x rows rows of
// one head; rows past S read as zero.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, int64_t sb, int64_t ss, int64_t sh,
              int W, int rows, int swizzle_bytes) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};  // bytes, dims 1-3
  const cuuint32_t box[4] = {(cuuint32_t)W, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// More than 48 KB of dynamic shared memory needs an opt-in, once per device
// and kernel; `done` is the caller's flags, one a device.
inline cudaError_t opt_in_smem(const void* kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int D>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using T = Bf16Tile<D>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, p.B, p.S, p.Hq, D, p.q_sb, p.q_ss, p.q_sh, T::W, T::BQ, T::SW) ||
      !make_map(&tk, p.k, p.B, p.S, p.Hkv, D, p.k_sb, p.k_ss, p.k_sh, T::W, T::BK, T::SW) ||
      !make_map(&tv, p.v, p.B, p.S, p.Hkv, D, p.v_sb, p.v_ss, p.v_sh, T::W, T::BK, T::SW)) {
    return (int)cudaErrorInvalidValue;
  }
  static bool opted_in[64] = {};
  cudaError_t err = opt_in_smem((const void*)flash_bf16_kernel<D>, T::SMEM, opted_in);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // a persistent grid: one block per SM (at most), each walking many work tiles
  const int64_t n_work = (int64_t)((p.S + T::BQ - 1) / T::BQ) * p.B * p.Hq;
  if (n_work >= (1 << 30)) return (int)cudaErrorInvalidConfiguration;  // round indices stay in int
  int sms = 0, l2_bytes = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&l2_bytes, cudaDevAttrL2CacheSize, dev);
  if (err != cudaSuccess) return (int)err;
  // L2 sections of the work order, in kv heads (each with its query heads). Bidirectional tiles all
  // take the same time, so the narrowest section, one kv head, keeps the tiles in flight on the fewest
  // K and V; causal and window tiles differ in length, and the widest section whose K and V fit in
  // half the L2 lets the longest-first order balance the blocks.
  const int group = p.Hq / p.Hkv;
  const int64_t kv_head_bytes = (int64_t)p.S * D * 2 * 2;
  const int64_t kv_heads = p.causal || p.window > 0 ? l2_bytes / 2 / kv_head_bytes : 1;
  Params ps = p;
  ps.section_heads = (int)(kv_heads < 1 ? group : kv_heads * group < (int64_t)p.B * p.Hq ? kv_heads * group : p.B * p.Hq);
  const int blocks = (int)(n_work < sms ? n_work : sms);
  flash_bf16_kernel<D><<<blocks, T::THREADS, T::SMEM, stream>>>(tq, tk, tv, ps, (int)n_work);
  RT_RETURN_LAUNCH_STATUS();
}

// A flat grid: one block per (query tile, batch * head), on blockIdx.x.
template <int D>
int launch_f32(const Params& p, cudaStream_t stream) {
  using T = F32Tile<D>;
  static bool opted_in[64] = {};
  const cudaError_t err = opt_in_smem((const void*)flash_f32_kernel<D>, T::SMEM, opted_in);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)((p.S + T::BQ - 1) / T::BQ) * p.B * p.Hq;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;  // a grid's x axis
  flash_f32_kernel<D><<<(unsigned)blocks, kBlockThreads, T::SMEM, stream>>>(p);
  RT_RETURN_LAUNCH_STATUS();
}

template <int D>
int launch(const Params& p, bool bf16, cudaStream_t stream) {
  return bf16 ? launch_bf16<D>(p, stream) : launch_f32<D>(p, stream);
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

// The bf16 body's tile choices at head dim D, for reports: {swizzle bytes,
// box columns, boxes a row, stages, query rows a block, keys a tile, dynamic
// shared memory bytes, threads a block}.
int bf16_config(int D, int* out) {
  auto fill = [out](auto t) {
    using T = decltype(t);
    const int v[8] = {T::SW, T::W, T::NB, T::STAGES, T::BQ, T::BK, T::SMEM, T::THREADS};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return 0;
  };
  switch (D) {
    case 16: return fill(Bf16Tile<16>{});
    case 32: return fill(Bf16Tile<32>{});
    case 64: return fill(Bf16Tile<64>{});
    case 80: return fill(Bf16Tile<80>{});
    case 128: return fill(Bf16Tile<128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, void* o, int B, int S, int Hq, int Hkv, int D,
                   const int64_t* st, int causal, int window) {
  return Params{q, k, v, o, B, S, Hq, Hkv,
                st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
                causal, window, (float)(1.0 / sqrt((double)D)), 0};
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

extern "C" int rt_flash_bf16_config(int D, int* out) { return rt::flash::bf16_config(D, out); }
