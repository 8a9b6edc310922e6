// The host-side plan of the step-size search kernel (linesearch_probe.cu):
// how many blocks of its co-resident grid sweep each side of a probe, and
// whether a block keeps its tiles' inputs in shared memory from the first
// sweep on (held) or reads them from device memory at every sweep
// (streamed). It uses no CUDA type, so tests/test_torch_search_plan.py
// compiles it with the host's C++ compiler and holds it against a Python
// statement of the same rule.
#pragma once

#include <math.h>
#include <stdint.h>

namespace rt {

constexpr int kPlanThreads = 256;  // threads a block (common.cuh's kThreads)
constexpr int kChunkBytes = 64;    // a thread's chunk of a tile: four 16-byte loads (common.cuh's Chunk)
// Most tiles a block holds in shared memory: a tile of x and one of dx
// take 2 * 16 KB, so three take 96 KB a block, two blocks an SM.
constexpr int kHeldTiles = 3;

// Tiles of a vector of n elements of elem_bytes each.
inline int64_t plan_tiles(int64_t n, int elem_bytes) {
  const int64_t tile = (int64_t)kPlanThreads * (kChunkBytes / elem_bytes);
  return (n + tile - 1) / tile;
}

struct SearchPlan {
  int gy, gz;  // blocks on each side: y takes blocks [0, gy), z [gy, gy + gz)
  int tiles;   // most tiles a block sweeps
  int held;    // 1: every block holds its tiles in shared memory; 0: streamed
};

// One block a tile while both sides fit in nb_max blocks, else nb_max
// blocks in proportion to the tiles, at least one for a side that has
// elements. Held when no block sweeps more than kHeldTiles tiles.
inline SearchPlan search_plan(int64_t ny, int64_t nz, int elem_bytes, int nb_max) {
  const int64_t ty = plan_tiles(ny, elem_bytes), tz = plan_tiles(nz, elem_bytes);
  int64_t gy, gz;
  if (ty + tz <= nb_max) {
    gy = ty;
    gz = tz;
  } else if (ty == 0 || tz == 0) {
    gy = ty ? nb_max : 0;
    gz = tz ? nb_max : 0;
  } else {
    gy = llround((double)nb_max * (double)ty / (double)(ty + tz));
    gy = gy < 1 ? 1 : gy > nb_max - 1 ? nb_max - 1 : gy;
    gz = nb_max - gy;
  }
  const int64_t per_y = gy ? (ty + gy - 1) / gy : 0, per_z = gz ? (tz + gz - 1) / gz : 0;
  const int64_t per = per_y > per_z ? per_y : per_z;
  return {(int)gy, (int)gz, (int)per, per <= kHeldTiles ? 1 : 0};
}

}  // namespace rt
