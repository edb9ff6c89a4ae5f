// Compose of the surfel blend's per-block sums, forward and backward, for
// Hopper (sm_90a): the blocks of a tile into the frame's maps (the image
// and the seven aux channels of ops/surfel_compose.py), and the maps'
// cotangents back into the sums' cotangent.
//
// Replaces no Pallas kernel: the JAX package has no surfel.  Python
// wrappers and plain PyTorch versions: gaussiansplatting_tpu_torch/ops/
// surfel_compose.py (the contract is documented there); the autograd
// Function: ops/rasterize._ComposeSurfels.
//
// compose.cu's design with nine rows carried as colour: one CUDA block a
// tile, one thread a pixel; two warps find the tile's run of blocks [lo,
// hi) in the sorted tile ids by a 32-way search (tile_walk.cuh, shared
// with compose.cu); each thread walks its
// tile's blocks in order with the incoming log T a float64 running sum of
// the blocks' S_b, rounded to float32 once a block, t_in = expf of it, and
// every other sum float32 in block order, rounded as the plain version
// rounds it.  The backward walks the tile twice: front to back for each
// block's incoming log T (parked in the cotangent's row 3) and the tile's
// S, then back to front for the float64 suffix of t_in <g, row_b>, writing
// the ten cotangent rows.  No atomics; padding blocks are never read, and
// the backward leaves their rows unwritten (the surfel blend's backward
// returns before it reads a block with no live lane).
//
// What bounds it on the H100: HBM.  Each live block's 10 x P2 floats are
// read once forward (10 KB), twice backward and written once.
//
// No kernel name here may hold "blend_fwd_win" or "blend_bwd_win".

#include <cuda_runtime.h>

#include "tile_walk.cuh"

namespace {

constexpr int kRows = 10;   // rows of a block's sums
constexpr int kAux = 7;     // aux channels
// rows 0-2, 4-9 are scaled by t_in: their order in the image and aux
__device__ __constant__ int kLin[9] = {0, 1, 2, 4, 5, 6, 7, 8, 9};

__global__ void __launch_bounds__(1024) surfel_compose_fwd_kernel(
    const float* __restrict__ out, const int* __restrict__ seg, int nb, int ts, int tiles_x,
    int width, int rows, float bg, float* __restrict__ img, float* __restrict__ aux) {
  __shared__ int range[2];
  tile_range(seg, nb, range);
  const int lo = range[0], hi = range[1];
  const int p2 = ts * ts;
  const int p = threadIdx.x;
  if (p >= p2) return;
  double acc = 0.0;
  float lin[9], S = 0.f;
#pragma unroll
  for (int c = 0; c < 9; ++c) lin[c] = 0.f;
  for (int b = lo; b < hi; ++b) {
    const float* o = out + (size_t)b * kRows * p2 + p;
    const float s = o[3 * p2];
    const float tin = expf(__double2float_rn(acc));
#pragma unroll
    for (int c = 0; c < 9; ++c) lin[c] = __fadd_rn(lin[c], __fmul_rn(tin, o[kLin[c] * p2]));
    S = __fadd_rn(S, s);
    acc += (double)s;
  }
  const int y = (int)blockIdx.x / tiles_x * ts + p / ts;
  const int x = (int)blockIdx.x % tiles_x * ts + p % ts;
  if (y < rows && x < width) {
    const float trans = expf(S);
    const float e = __fmul_rn(trans, bg);
    const size_t at = (size_t)y * width + x;
    for (int c = 0; c < 3; ++c) img[at * 3 + c] = __fadd_rn(lin[c], e);
    for (int c = 0; c < 6; ++c) aux[at * kAux + c] = lin[3 + c];
    aux[at * kAux + 6] = trans;
  }
}

__global__ void __launch_bounds__(1024) surfel_compose_bwd_kernel(
    const float* __restrict__ g_img, const float* __restrict__ g_aux,
    const float* __restrict__ out, const int* __restrict__ seg, int nb, int ts, int tiles_x,
    int width, int rows, float bg, float* __restrict__ d_out) {
  __shared__ int range[2];
  tile_range(seg, nb, range);
  const int lo = range[0], hi = range[1];
  const int p2 = ts * ts;
  const int p = threadIdx.x;
  if (p >= p2 || lo == hi) return;
  const int y = (int)blockIdx.x / tiles_x * ts + p / ts;
  const int x = (int)blockIdx.x % tiles_x * ts + p % ts;
  float gl[9], gt = 0.f;  // 0 on pixels cropped from the maps
#pragma unroll
  for (int c = 0; c < 9; ++c) gl[c] = 0.f;
  if (y < rows && x < width) {
    const size_t at = (size_t)y * width + x;
    for (int c = 0; c < 3; ++c) gl[c] = g_img[at * 3 + c];
    for (int c = 0; c < 6; ++c) gl[3 + c] = g_aux[at * kAux + c];
    gt = __fadd_rn(g_aux[at * kAux + 6],
                   __fmul_rn(bg, __fadd_rn(__fadd_rn(gl[0], gl[1]), gl[2])));
  }
  // front to back: each block's incoming log T, parked in row 3, and S
  double acc = 0.0;
  float S = 0.f;
  for (int b = lo; b < hi; ++b) {
    const size_t at = (size_t)b * kRows * p2 + 3 * p2 + p;
    const float s = out[at];
    d_out[at] = __double2float_rn(acc);
    S = __fadd_rn(S, s);
    acc += (double)s;
  }
  const float ds2 = __fmul_rn(gt, expf(S));
  // back to front: the suffix, and every cotangent row
  double suffix = 0.0;
  for (int b = hi - 1; b >= lo; --b) {
    const float* o = out + (size_t)b * kRows * p2 + p;
    float* d = d_out + (size_t)b * kRows * p2 + p;
    const float tin = expf(d[3 * p2]);
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      d[kLin[c] * p2] = __fmul_rn(tin, gl[c]);
      dot = __fadd_rn(dot, __fmul_rn(gl[c], o[kLin[c] * p2]));
    }
    d[3 * p2] = __fadd_rn(__double2float_rn(suffix), ds2);
    suffix += (double)__fmul_rn(dot, tin);
  }
}

}  // namespace

// The image [rows, width, 3] and aux [rows, width, 7] from out [NB, 10, P2].
extern "C" int gs_surfel_compose_fwd(const float* out, const int* seg, int nb, int ts,
                                     int tiles_x, int num_tiles, int width, int rows, float bg,
                                     float* img, float* aux, void* stream) {
  if (num_tiles <= 0) return 0;
  surfel_compose_fwd_kernel<<<num_tiles, threads_for(ts), 0, (cudaStream_t)stream>>>(
      out, seg, nb, ts, tiles_x, width, rows, bg, img, aux);
  return (int)cudaGetLastError();
}

// d_out [NB, 10, P2] from the cotangents of the image and aux.
extern "C" int gs_surfel_compose_bwd(const float* g_img, const float* g_aux, const float* out,
                                     const int* seg, int nb, int ts, int tiles_x,
                                     int num_tiles, int width, int rows, float bg,
                                     float* d_out, void* stream) {
  if (num_tiles <= 0 || nb <= 0) return 0;
  surfel_compose_bwd_kernel<<<num_tiles, threads_for(ts), 0, (cudaStream_t)stream>>>(
      g_img, g_aux, out, seg, nb, ts, tiles_x, width, rows, bg, d_out);
  return (int)cudaGetLastError();
}
