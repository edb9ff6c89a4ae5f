// Windowed block blend, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in gaussiansplatting_tpu/ops/pallas_blend.py:
//   gs_blend_fwd_win     _fwd_kernel_win (:601, windowed_blend_fwd), and
//                        _fwd_kernel (:161, block_blend_cols) on the
//                        t_floor_exact path's first pass: its aligned block b
//                        is window b here;
//   gs_blend_fwd_win_tf  _fwd_kernel_tf (:249, block_blend_cols_tf), the
//                        exact T-floor second pass.
// Python wrappers and plain PyTorch versions:
// gaussiansplatting_tpu_torch/ops/blend.py (the contract is documented there).
//
// Design: one CUDA block per pair block b, one thread per tile pixel
// (p = y*ts + x, offset (x + 0.5 - ts/2, y + 0.5 - ts/2) from the tile
// centre).  The block stages the live lanes of its window
// [block_src[b], block_src[b] + block_valid[b]) of the tile-sorted table into
// shared memory (coalesced along each table row), then every thread walks the
// lanes front to back carrying its running log-transmittance S:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  a_raw = op exp(power),
//   kept iff power in [power_floor, 0] and a_raw >= alpha_floor,
//   alpha = min(a_raw, alpha_cap),  w = alpha exp(S),  C += w rgb,
//   S += log1p(-alpha).
// Each output element has exactly one writer: no atomics, deterministic.
// Dead blocks (block_valid == 0) still write zeros and gid -1, because the
// outputs come from torch.empty and the compose step reads every block.
//
// The T-floor pass (kTFloor) takes each pixel's incoming global log T,
// logti[b, p], from the unmasked first pass and stops the pixel's loop at
// the first kept lane where S + logti <= log_thr: the reference's per-pixel
// loop exit (tiled_shaders.metal:334).  S only decreases, so every later
// lane would be masked too and the break is exact; it is also the work the
// exit saves.  A block whose pixels all arrive at or below the floor writes
// C = 0, S = 0 and stages nothing.  Both passes are instances of one
// template, so their alpha and S come from the same rounded device code and
// the second pass's in-block S is consistent with the first pass's, from
// which logti was summed.  The T-floor pass writes no gid.
//
// The power is evaluated with explicitly rounded operations (__fmul_rn etc.,
// never contracted into FMAs) in the same order as the plain version, so the
// power window and alpha-floor masks agree with it bit for bit on the card;
// only the prefix and colour sums are taken in another order.
//
// What bounds it on the H100: about 256 pixels x 1.7M pairs per 800x608
// frame of the 100k-Gaussian scene, i.e. ~4e8 pair-pixel evaluations, each
// one exp for alpha and, where the pair is kept, a log1p and an exp for the
// transmittance: special-function-unit throughput, not HBM (the table is
// read once, ~40 B per pair).  Lanes outside the power window skip the
// special functions entirely.  Tensor cores (wgmma) for the quadratic form
// and TMA staging of the windows are later tuning work.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 9;  // mx, my, conic a, b, c, opacity, r, g, b

template <bool kTFloor>
__global__ void blend_fwd_win_kernel(
    const float* __restrict__ table, long long ep,
    const int* __restrict__ block_src, const int* __restrict__ block_valid,
    const int* __restrict__ block_tile, const float* __restrict__ logti,
    int block, int ts, int tiles_x, int row0, float power_floor,
    float alpha_cap, float alpha_floor, float log_thr,
    float* __restrict__ out, float* __restrict__ gid_out) {
  extern __shared__ float cols[];  // [kCols][block]
  const int b = blockIdx.x;
  const int p2 = ts * ts;
  float* out_b = out + (size_t)b * 4 * p2;
  float* gid_b = kTFloor ? nullptr : gid_out + (size_t)b * block;
  int nv = min(block_valid[b], block);
  if (kTFloor) {
    // does any pixel of the tile arrive above the floor?  (each thread
    // checks its pixels; the block-wide OR is uniform, so the early return
    // below is taken by all threads or none)
    bool open = false;
    for (int p = threadIdx.x; p < p2; p += blockDim.x)
      open |= logti[(size_t)b * p2 + p] > log_thr;
    if (!__syncthreads_or(open)) nv = 0;
  }

  if (nv <= 0) {
    for (int i = threadIdx.x; i < 4 * p2; i += blockDim.x) out_b[i] = 0.f;
    if (!kTFloor)
      for (int i = threadIdx.x; i < block; i += blockDim.x) gid_b[i] = -1.f;
    return;
  }

  const float half = 0.5f * (float)ts;
  const int tile = block_tile[b];
  const float tcx = (float)(tile % tiles_x) * (float)ts + half;
  const float tcy = (float)(tile / tiles_x + row0) * (float)ts + half;
  const long long src = block_src[b];

  float* s_mx = cols;
  float* s_my = cols + block;
  float* s_ca = cols + 2 * block;
  float* s_cb = cols + 3 * block;
  float* s_cc = cols + 4 * block;
  float* s_op = cols + 5 * block;
  float* s_r = cols + 6 * block;
  float* s_g = cols + 7 * block;
  float* s_b = cols + 8 * block;

  for (int t = threadIdx.x; t < block; t += blockDim.x) {
    if (t < nv) {
      const float* col = table + src + t;
      const float ca = col[3 * ep], cb = col[4 * ep], cc = col[5 * ep];
      const float mag = __fadd_rn(__fadd_rn(fabsf(ca), fabsf(cb)), fabsf(cc));
      if (!kTFloor) gid_b[t] = col[0];
      s_mx[t] = __fsub_rn(col[ep], tcx);
      s_my[t] = __fsub_rn(col[2 * ep], tcy);
      s_ca[t] = ca;
      s_cb[t] = cb;
      s_cc[t] = cc;
      s_op[t] = mag >= 1e-4f ? col[6 * ep] : 0.f;
      s_r[t] = col[7 * ep];
      s_g[t] = col[8 * ep];
      s_b[t] = col[9 * ep];
    } else if (!kTFloor) {
      gid_b[t] = -1.f;
    }
  }
  __syncthreads();

  for (int p = threadIdx.x; p < p2; p += blockDim.x) {
    const float px = __fsub_rn((float)(p % ts) + 0.5f, half);
    const float py = __fsub_rn((float)(p / ts) + 0.5f, half);
    const float lt = kTFloor ? logti[(size_t)b * p2 + p] : 0.f;
    float S = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    for (int k = 0; k < nv; ++k) {
      const float op = s_op[k];
      if (op == 0.f) continue;  // a_raw = 0 is below any alpha floor > 0
      const float dx = __fsub_rn(px, s_mx[k]);
      const float dy = __fsub_rn(py, s_my[k]);
      const float qa = __fmul_rn(__fmul_rn(s_ca[k], dx), dx);
      const float qc = __fmul_rn(__fmul_rn(s_cc[k], dy), dy);
      const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)),
                                    __fmul_rn(s_cb[k], __fmul_rn(dx, dy)));
      if (!(power <= 0.f && power >= power_floor)) continue;
      const float a_raw = __fmul_rn(op, expf(power));
      if (!(a_raw >= alpha_floor)) continue;
      if (kTFloor && !(__fadd_rn(S, lt) > log_thr)) break;  // terminated
      const float alpha = fminf(a_raw, alpha_cap);
      const float w = alpha * expf(S);
      c0 += w * s_r[k];
      c1 += w * s_g[k];
      c2 += w * s_b[k];
      S += log1pf(-alpha);
    }
    out_b[p] = c0;
    out_b[p2 + p] = c1;
    out_b[2 * p2 + p] = c2;
    out_b[3 * p2 + p] = S;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// table [>=10, ep] f32 row-major; block_src/valid/tile [nb] i32;
// out [nb, 4, ts*ts] f32; gid [nb, block] f32.  Needs ts*ts <= 1024 threads
// and 9*block floats of shared memory (block <= 1024 keeps it under 48 KB).
extern "C" int gs_blend_fwd_win(const float* table, long long ep,
                                const int* block_src, const int* block_valid,
                                const int* block_tile, int nb, int block,
                                int ts, int tiles_x, int row0,
                                float power_floor, float alpha_cap,
                                float alpha_floor, float* out, float* gid,
                                void* stream) {
  const size_t smem = (size_t)kCols * block * sizeof(float);
  blend_fwd_win_kernel<false><<<nb, ts * ts, smem, (cudaStream_t)stream>>>(
      table, ep, block_src, block_valid, block_tile, nullptr, block, ts,
      tiles_x, row0, power_floor, alpha_cap, alpha_floor, 0.f, out, gid);
  return (int)cudaGetLastError();
}

// The T-floor pass: as gs_blend_fwd_win plus logti [nb, ts*ts] f32 and
// log_thr = log(transmittance_floor); writes out only.
extern "C" int gs_blend_fwd_win_tf(const float* table, long long ep,
                                   const int* block_src,
                                   const int* block_valid,
                                   const int* block_tile, const float* logti,
                                   int nb, int block, int ts, int tiles_x,
                                   int row0, float power_floor,
                                   float alpha_cap, float alpha_floor,
                                   float log_thr, float* out, void* stream) {
  const size_t smem = (size_t)kCols * block * sizeof(float);
  blend_fwd_win_kernel<true><<<nb, ts * ts, smem, (cudaStream_t)stream>>>(
      table, ep, block_src, block_valid, block_tile, logti, block, ts, tiles_x,
      row0, power_floor, alpha_cap, alpha_floor, log_thr, out, nullptr);
  return (int)cudaGetLastError();
}
