// Pieces shared by the compose kernels of the 3D Gaussian (compose.cu) and
// of the surfel (surfel_compose.cu): one CUDA block a tile, one thread a
// pixel, and the tile's run of blocks [lo, hi) found in the sorted tile
// ids by two warps.  The kernels walk that run themselves: the 3D
// Gaussian's with its loads issued kAhead blocks ahead and its logti and
// T-floor modes, the surfel's over ten rows a block.
//
// In an anonymous namespace, as each file had them, so every name and
// instance is the one each file compiled before.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// The first position of seg[0..nb) (non-decreasing) whose value is >= key,
// by one whole warp: 32 probes a round.
__device__ int warp_lower_bound(const int* __restrict__ seg, int nb, int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = nb;  // seg[< lo] < key <= seg[>= hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int pos = lo + lane * step;
    // the probes below key are a prefix of the lanes
    const int k = __popc(__ballot_sync(kFullMask, pos < hi && seg[pos] < key));
    const int next_hi = lo + k * step;  // probe k: at or above key, where it exists
    if (k > 0) lo += (k - 1) * step + 1;
    if (next_hi < hi) hi = next_hi;
  }
  return lo + __popc(__ballot_sync(kFullMask, lo + lane < hi && seg[lo + lane] < key));
}

// The tile's run of blocks [range[0], range[1]), found by warps 0 and 1.
__device__ void tile_range(const int* __restrict__ seg, int nb, int* range) {
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int r = warp_lower_bound(seg, nb, (int)blockIdx.x + warp);
    if ((threadIdx.x & 31) == 0) range[warp] = r;
  }
  __syncthreads();
}

// Threads a tile's block: whole warps, and at least the two that search.
int threads_for(int ts) {
  const int t = (ts * ts + 31) / 32 * 32;
  return t < 64 ? 64 : t;
}

}  // namespace
