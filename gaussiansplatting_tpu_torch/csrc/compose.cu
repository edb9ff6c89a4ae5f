// Compose, forward and backward, for Hopper (sm_90a): the blend's per-block
// summaries into the image, and the image's cotangent back into the
// summaries' cotangent.
//
// Replaces no Pallas kernel: the JAX package composes with XLA ops
// (gaussiansplatting_tpu/ops/rasterize.py _compose_tiles: a float32 cumsum
// over every block, segment sums, a gather), and the port ran torch ops
// until this file: a float64 transposed scan over every block for the
// incoming log T, and torch.segment_reduce over T + 1 segments, the last of
// which held every padding block of the capacity (one CUDA thread per
// column walked it, ~9 ms of a 36 ms garden frame).  Python wrappers and
// plain PyTorch versions: gaussiansplatting_tpu_torch/ops/compose.py (the
// contract is documented there); the autograd Function: ops/rasterize.py
// _Compose.
//
// One CUDA block per tile, one thread per pixel (P2 = ts * ts, 256 at
// ts = 16).  Two warps find the tile's run of blocks [lo, hi) in the sorted
// tile ids ``seg`` by a 32-way search (~4 dependent loads each); a tile
// with no blocks writes the background.  Each thread walks its tile's
// blocks in order, and no thread reads a padding block.  The incoming log
// T is a float64 running sum of the blocks' S_b, rounded to float32 once
// per block (so within a rounding of the exact per-tile sum), t_in = expf
// of it; the colour sum t_in * C_b and the tile's S are float32, in block
// order, each product and sum rounded as the plain version rounds it.
// Every sum is in a fixed order and nothing is atomic: a second launch on
// the same inputs gives the same bits.
//
// What bounds it on the H100: HBM.  Each live block's 4 x P2 floats are
// read once (4 KB; ~30k blocks, 120 MB, in a garden frame at 2^23 pairs:
// 36 us at 3.35 TB/s) and the image written once.  The loads of kAhead
// blocks are issued before any is used, so a thread has 4 * kAhead loads
// in flight and the float64 chain, a few cycles a block, never waits on
// one load at a time.  The backward walks the tile twice: front to back
// for each block's incoming log T (parked in the cotangent's row 3, where
// the second walk reads it back) and the tile's S, then back to front for
// the suffix, reading C_b and writing the four cotangent rows.
//
// Padding blocks (seg == T): the forward never reads them; the backward
// and the logti mode leave their rows unwritten.  Every blend backward
// leaves a block with no live lane without reading its cotangent
// (blend_bwd.cu: nv <= 0 returns before g is read, in every design), and
// the T-floor forward reads such a block's logti only to decide a block it
// then writes as zeros.  So no capacity-sized buffer is cleared.
//
// No kernel name here may hold "blend_fwd_win" or "blend_bwd_win": the
// benchmark's blend rooflines match those substrings.

#include <cuda_runtime.h>

#include "tile_walk.cuh"

namespace {

// blocks whose loads a thread has in flight: 8, and 4 in the backward's
// two-pass instance, which spilled at 8 (its bound of 64 registers comes
// from __launch_bounds__(1024), for tiles of up to 32 x 32)
constexpr int kAhead = 8;
constexpr int kAheadTwo = 4;

// kLogti: write each block's incoming log T (logti [NB, P2]) and no image.
// kTwo: the T-floor composition, t_in from out's S_b, C_b and S from out2.
template <bool kLogti, bool kTwo>
__global__ void __launch_bounds__(1024) compose_fwd_kernel(
    const float* __restrict__ out, const float* __restrict__ out2,
    const int* __restrict__ seg, int nb, int ts, int tiles_x, int width,
    int rows, float bg, float* __restrict__ img, float* __restrict__ logti) {
  __shared__ int range[2];
  tile_range(seg, nb, range);
  const int lo = range[0], hi = range[1];
  const int p2 = ts * ts;
  const int p = threadIdx.x;
  if (p >= p2) return;
  const float* src = kTwo ? out2 : out;
  double acc = 0.0;  // the incoming log T
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, S = 0.f;
  for (int b0 = lo; b0 < hi; b0 += kAhead) {
    float s1[kAhead], s2[kAhead], r0[kAhead], r1[kAhead], r2[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      s1[j] = s2[j] = r0[j] = r1[j] = r2[j] = 0.f;
      if (b0 + j >= hi) continue;
      const size_t at = (size_t)(b0 + j) * 4 * p2 + p;
      s1[j] = out[at + 3 * p2];
      if (!kLogti) {
        r0[j] = src[at];
        r1[j] = src[at + p2];
        r2[j] = src[at + 2 * p2];
        s2[j] = kTwo ? src[at + 3 * p2] : s1[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (b0 + j >= hi) continue;
      const float lt = __double2float_rn(acc);
      if (kLogti) {
        logti[(size_t)(b0 + j) * p2 + p] = lt;
      } else {
        const float tin = expf(lt);
        c0 = __fadd_rn(c0, __fmul_rn(tin, r0[j]));
        c1 = __fadd_rn(c1, __fmul_rn(tin, r1[j]));
        c2 = __fadd_rn(c2, __fmul_rn(tin, r2[j]));
        S = __fadd_rn(S, s2[j]);
      }
      acc += (double)s1[j];
    }
  }
  if (kLogti) return;
  const int y = (int)blockIdx.x / tiles_x * ts + p / ts;
  const int x = (int)blockIdx.x % tiles_x * ts + p % ts;
  if (y < rows && x < width) {
    const float e = __fmul_rn(expf(S), bg);
    float* o = img + ((size_t)y * width + x) * 3;
    o[0] = __fadd_rn(c0, e);
    o[1] = __fadd_rn(c1, e);
    o[2] = __fadd_rn(c2, e);
  }
}

// The cotangent of out (d1) and, with kTwo, of out2 (d2), [NB, 4, P2], from
// the image's g [rows, width, 3]:
//   dC_b = t_in g,  dS2_b = bg exp(S) sum_c g_c,
//   dS1_b = sum over the tile's later blocks b' of t_in_b' <g, C_b'>,
// the last a float64 walk back to front, exactly 0 where every later term
// is.  Without kTwo, d1's row 3 is dS1 + dS2; with it, d1's colour rows are
// zero and its row 3 dS1, d2 holds dC and dS2.
template <bool kTwo>
__global__ void __launch_bounds__(1024) compose_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ out,
    const float* __restrict__ out2, const int* __restrict__ seg, int nb, int ts,
    int tiles_x, int width, int rows, float bg, float* __restrict__ d1,
    float* __restrict__ d2) {
  __shared__ int range[2];
  tile_range(seg, nb, range);
  const int lo = range[0], hi = range[1];
  const int p2 = ts * ts;
  const int p = threadIdx.x;
  if (p >= p2 || lo == hi) return;
  const float* src = kTwo ? out2 : out;
  float* dc = kTwo ? d2 : d1;
  constexpr int A = kTwo ? kAheadTwo : kAhead;
  const int y = (int)blockIdx.x / tiles_x * ts + p / ts;
  const int x = (int)blockIdx.x % tiles_x * ts + p % ts;
  float g0 = 0.f, g1 = 0.f, g2 = 0.f;  // 0 on pixels cropped from the image
  if (y < rows && x < width) {
    const float* gp = g + ((size_t)y * width + x) * 3;
    g0 = gp[0];
    g1 = gp[1];
    g2 = gp[2];
  }

  // front to back: each block's incoming log T, parked in d1's row 3, and S
  double acc = 0.0;
  float S = 0.f;
  for (int b0 = lo; b0 < hi; b0 += A) {
    float s1[A], s2[A];
#pragma unroll
    for (int j = 0; j < A; ++j) {
      s1[j] = s2[j] = 0.f;
      if (b0 + j >= hi) continue;
      const size_t at = (size_t)(b0 + j) * 4 * p2 + 3 * p2 + p;
      s1[j] = out[at];
      s2[j] = kTwo ? out2[at] : s1[j];
    }
#pragma unroll
    for (int j = 0; j < A; ++j) {
      if (b0 + j >= hi) continue;
      d1[(size_t)(b0 + j) * 4 * p2 + 3 * p2 + p] = __double2float_rn(acc);
      S = __fadd_rn(S, s2[j]);
      acc += (double)s1[j];
    }
  }
  const float gsum = __fadd_rn(__fadd_rn(__fmul_rn(g0, bg), __fmul_rn(g1, bg)),
                               __fmul_rn(g2, bg));
  const float ds2 = __fmul_rn(gsum, expf(S));

  // back to front: the suffix, and every cotangent row
  double suffix = 0.0;
  for (int b1 = hi; b1 > lo; b1 -= A) {  // blocks b1 - 1 - j
    float lt[A], r0[A], r1[A], r2[A];
#pragma unroll
    for (int j = 0; j < A; ++j) {
      lt[j] = r0[j] = r1[j] = r2[j] = 0.f;
      if (b1 - 1 - j < lo) continue;
      const size_t at = (size_t)(b1 - 1 - j) * 4 * p2 + p;
      lt[j] = d1[at + 3 * p2];
      r0[j] = src[at];
      r1[j] = src[at + p2];
      r2[j] = src[at + 2 * p2];
    }
#pragma unroll
    for (int j = 0; j < A; ++j) {
      if (b1 - 1 - j < lo) continue;
      const size_t at = (size_t)(b1 - 1 - j) * 4 * p2 + p;
      const float tin = expf(lt[j]);
      dc[at] = __fmul_rn(g0, tin);
      dc[at + p2] = __fmul_rn(g1, tin);
      dc[at + 2 * p2] = __fmul_rn(g2, tin);
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(g0, r0[j]), __fmul_rn(g1, r1[j])),
                                  __fmul_rn(g2, r2[j]));
      const float term = __fmul_rn(dot, tin);
      const float ds1 = __double2float_rn(suffix);
      if (kTwo) {
        d1[at] = d1[at + p2] = d1[at + 2 * p2] = 0.f;
        d1[at + 3 * p2] = ds1;
        d2[at + 3 * p2] = ds2;
      } else {
        d1[at + 3 * p2] = __fadd_rn(ds1, ds2);
      }
      suffix += (double)term;
    }
  }
}

}  // namespace

// The image [rows, width, 3] (logti null) or each live block's incoming log
// T into logti [NB, P2] (img null); out2 null: C_b and S from out.
extern "C" int gs_compose_fwd(const float* out, const float* out2, const int* seg, int nb,
                              int ts, int tiles_x, int num_tiles, int width, int rows,
                              float bg, float* img, float* logti, void* stream) {
  if (num_tiles <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int threads = threads_for(ts);
  if (logti != nullptr)
    compose_fwd_kernel<true, false><<<num_tiles, threads, 0, s>>>(
        out, nullptr, seg, nb, ts, tiles_x, width, rows, bg, nullptr, logti);
  else if (out2 != nullptr)
    compose_fwd_kernel<false, true><<<num_tiles, threads, 0, s>>>(
        out, out2, seg, nb, ts, tiles_x, width, rows, bg, img, nullptr);
  else
    compose_fwd_kernel<false, false><<<num_tiles, threads, 0, s>>>(
        out, nullptr, seg, nb, ts, tiles_x, width, rows, bg, img, nullptr);
  return (int)cudaGetLastError();
}

// The cotangents d1 of out and, given out2, d2 of out2 [NB, 4, P2] from the
// image's cotangent g [rows, width, 3].
extern "C" int gs_compose_bwd(const float* g, const float* out, const float* out2,
                              const int* seg, int nb, int ts, int tiles_x, int num_tiles,
                              int width, int rows, float bg, float* d1, float* d2,
                              void* stream) {
  if (num_tiles <= 0 || nb <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int threads = threads_for(ts);
  if (out2 != nullptr)
    compose_bwd_kernel<true><<<num_tiles, threads, 0, s>>>(
        g, out, out2, seg, nb, ts, tiles_x, width, rows, bg, d1, d2);
  else
    compose_bwd_kernel<false><<<num_tiles, threads, 0, s>>>(
        g, out, nullptr, seg, nb, ts, tiles_x, width, rows, bg, d1, nullptr);
  return (int)cudaGetLastError();
}
