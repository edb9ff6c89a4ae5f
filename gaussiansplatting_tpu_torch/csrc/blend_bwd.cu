// Windowed block blend, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _bwd_kernel_win
// (gaussiansplatting_tpu/ops/pallas_blend.py:671), reached through
// windowed_blend_bwd.  Python wrapper and plain PyTorch version:
// gaussiansplatting_tpu_torch/ops/blend.py (the contract is documented there).
//
// Design: one CUDA block per pair block b, one thread per tile pixel, the
// window's nine columns staged in shared memory exactly as blend_fwd.cu does.
// Each thread replays its pixel twice:
//   pass 1, front to back: the forward blend, to the pixel's total
//     log-transmittance S (nothing else is kept);
//   pass 2, back to front: S steps back over each kept lane
//     (S -= log1p(-alpha), so T = exp(S) is the transmittance in front of
//     it), and the suffix sum_{j>k} e_j w_j is carried forward, so per lane
//       e = sum_ch g_ch c_ch,  dl = suffix + g_S,
//       dalpha = e T - dl / (1 - alpha),  dpow = dalpha * a_raw
//     (the alpha cap passes the gradient through, as in the TPU kernel).
// Nothing per lane is stored per pixel: pass 2 recomputes the power and the
// masks with the same explicitly rounded operations as pass 1 and as
// blend_fwd.cu, so every mask agrees bit for bit with the forward and with
// the plain version.
//
// Per lane the nine outputs are sums over the tile's pixels of
//   (dpow dx, dpow dy, dpow dx^2, dpow dx dy, dpow dy^2, dpow, g_r w, g_g w,
//    g_b w),
// finished per lane as d mx = a s_x + b s_y, d my = b s_x + c s_y,
// d a = -s_xx / 2, d b = -s_xy, d c = -s_yy / 2, d op = s_p / op and the
// three colour sums (the VPU form of the TPU kernel, pallas_blend.py:762-799).
// The cross-pixel sum is atomic-free and in a fixed order: a shuffle tree in
// each warp, one partial per (warp, column, lane) in shared memory, then a
// sum over the warps in warp order.  A second launch on the same inputs gives
// the same bits.  Lanes that no pixel of a warp keeps skip the shuffles.
// Dead blocks and lanes past block_valid write zeros (outputs come from
// torch.empty).
//
// What bounds it on the H100: the same ~4e8 pair-pixel evaluations as the
// forward, twice, plus per kept lane an exp, a log1p and a division, and the
// 45-shuffle warp reduction per (warp, lane) that any pixel kept: special-
// function and shuffle throughput, not HBM (the table and g are read once).
// Shared memory is 9*B floats of columns + 8*9*B floats of partials
// (41.5 KB at B = 128).

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 9;  // mx, my, conic a, b, c, opacity, r, g, b
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  // fixed tree: lane 0 ends with ((v0 + v16) + (v8 + v24)) + ... every time
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  return v;
}

__global__ void blend_bwd_win_kernel(
    const float* __restrict__ table, long long ep,
    const int* __restrict__ block_src, const int* __restrict__ block_valid,
    const int* __restrict__ block_tile, const float* __restrict__ g, int nb,
    int block, int ts, int tiles_x, int row0, float power_floor,
    float alpha_cap, float alpha_floor, float* __restrict__ dcols) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int p2 = ts * ts;
  const int nwarps = blockDim.x >> 5;
  const size_t plane = (size_t)nb * block;  // one output column, [nb, block]
  float* out_b = dcols + (size_t)b * block;
  const int nv = min(block_valid[b], block);

  if (nv <= 0) {
    for (int i = threadIdx.x; i < kCols * block; i += blockDim.x)
      out_b[(size_t)(i / block) * plane + i % block] = 0.f;
    return;
  }

  const float half = 0.5f * (float)ts;
  const int tile = block_tile[b];
  const float tcx = (float)(tile % tiles_x) * (float)ts + half;
  const float tcy = (float)(tile / tiles_x + row0) * (float)ts + half;
  const long long src = block_src[b];

  float* s_mx = smem;
  float* s_my = smem + block;
  float* s_ca = smem + 2 * block;
  float* s_cb = smem + 3 * block;
  float* s_cc = smem + 4 * block;
  float* s_op = smem + 5 * block;
  float* s_r = smem + 6 * block;
  float* s_g = smem + 7 * block;
  float* s_b = smem + 8 * block;
  float* part = smem + kCols * block;  // [nwarps][kCols][block]

  for (int t = threadIdx.x; t < nv; t += blockDim.x) {
    const float* col = table + src + t;
    const float ca = col[3 * ep], cb = col[4 * ep], cc = col[5 * ep];
    const float mag = __fadd_rn(__fadd_rn(fabsf(ca), fabsf(cb)), fabsf(cc));
    s_mx[t] = __fsub_rn(col[ep], tcx);
    s_my[t] = __fsub_rn(col[2 * ep], tcy);
    s_ca[t] = ca;
    s_cb[t] = cb;
    s_cc[t] = cc;
    s_op[t] = mag >= 1e-4f ? col[6 * ep] : 0.f;
    s_r[t] = col[7 * ep];
    s_g[t] = col[8 * ep];
    s_b[t] = col[9 * ep];
  }
  __syncthreads();

  // Threads past the tile's pixels (none when ts*ts is a multiple of 32)
  // keep nothing but still take part in the warp shuffles.
  const int p = threadIdx.x;
  const bool pix = p < p2;
  const float px = __fsub_rn((float)(p % ts) + 0.5f, half);
  const float py = __fsub_rn((float)(p / ts) + 0.5f, half);
  float g0 = 0.f, g1 = 0.f, g2 = 0.f, gs = 0.f;
  if (pix) {
    const float* g_b = g + (size_t)b * 4 * p2;
    g0 = g_b[p];
    g1 = g_b[p2 + p];
    g2 = g_b[2 * p2 + p];
    gs = g_b[3 * p2 + p];
  }

  // pass 1: front to back, the pixel's total log-transmittance
  float S = 0.f;
  for (int k = 0; pix && k < nv; ++k) {
    const float op = s_op[k];
    if (op == 0.f) continue;
    const float dx = __fsub_rn(px, s_mx[k]);
    const float dy = __fsub_rn(py, s_my[k]);
    const float qa = __fmul_rn(__fmul_rn(s_ca[k], dx), dx);
    const float qc = __fmul_rn(__fmul_rn(s_cc[k], dy), dy);
    const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)),
                                  __fmul_rn(s_cb[k], __fmul_rn(dx, dy)));
    if (!(power <= 0.f && power >= power_floor)) continue;
    const float a_raw = __fmul_rn(op, expf(power));
    if (!(a_raw >= alpha_floor)) continue;
    S += log1pf(-fminf(a_raw, alpha_cap));
  }

  // pass 2: back to front, the chain rule and the per-lane pixel sums
  const int warp = threadIdx.x >> 5;
  const int wlane = threadIdx.x & 31;
  float suffix = 0.f;  // sum_{j > k} e_j w_j
  for (int k = nv - 1; k >= 0; --k) {
    float v[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] = 0.f;
    const float op = s_op[k];
    bool kept = false;
    if (pix && op != 0.f) {
      const float dx = __fsub_rn(px, s_mx[k]);
      const float dy = __fsub_rn(py, s_my[k]);
      const float qa = __fmul_rn(__fmul_rn(s_ca[k], dx), dx);
      const float qc = __fmul_rn(__fmul_rn(s_cc[k], dy), dy);
      const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)),
                                    __fmul_rn(s_cb[k], __fmul_rn(dx, dy)));
      if (power <= 0.f && power >= power_floor) {
        const float a_raw = __fmul_rn(op, expf(power));
        if (a_raw >= alpha_floor) {
          kept = true;
          const float alpha = fminf(a_raw, alpha_cap);
          S -= log1pf(-alpha);
          const float T = expf(S);
          const float w = alpha * T;
          const float e = g0 * s_r[k] + g1 * s_g[k] + g2 * s_b[k];
          const float dl = suffix + gs;
          const float dpow = (e * T - dl / (1.f - alpha)) * a_raw;
          const float pdx = dpow * dx;
          const float pdy = dpow * dy;
          v[0] = pdx;
          v[1] = pdy;
          v[2] = pdx * dx;
          v[3] = pdx * dy;
          v[4] = pdy * dy;
          v[5] = dpow;
          v[6] = g0 * w;
          v[7] = g1 * w;
          v[8] = g2 * w;
          suffix += e * w;
        }
      }
    }
    if (__any_sync(kFullMask, kept)) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = warp_sum(v[c]);
    }
    if (wlane == 0) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) part[(warp * kCols + c) * block + k] = v[c];
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < block; k += blockDim.x) {
    float o[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[c] = 0.f;
    if (k < nv) {
      float s[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float acc = 0.f;
        for (int w = 0; w < nwarps; ++w) acc += part[(w * kCols + c) * block + k];
        s[c] = acc;
      }
      const float ca = s_ca[k], cb = s_cb[k], cc = s_cc[k], op = s_op[k];
      o[0] = ca * s[0] + cb * s[1];
      o[1] = cb * s[0] + cc * s[1];
      o[2] = -0.5f * s[2];
      o[3] = -s[3];
      o[4] = -0.5f * s[4];
      o[5] = op > 0.f ? s[5] / op : 0.f;
      o[6] = s[6];
      o[7] = s[7];
      o[8] = s[8];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) out_b[(size_t)c * plane + k] = o[c];
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// table [>=10, ep] f32 row-major; block_src/valid/tile [nb] i32;
// g [nb, 4, ts*ts] f32 (rows 0-2 dC, row 3 dS); dcols [9, nb, block] f32.
// One thread per pixel rounded up to whole warps (ts*ts <= 1024) and
// (1 + warps) * 9 * block floats of shared memory, which the wrapper keeps
// within the 227 KB a Hopper block can have.
extern "C" int gs_blend_bwd_win(const float* table, long long ep,
                                const int* block_src, const int* block_valid,
                                const int* block_tile, const float* g, int nb,
                                int block, int ts, int tiles_x, int row0,
                                float power_floor, float alpha_cap,
                                float alpha_floor, float* dcols,
                                void* stream) {
  const int threads = (ts * ts + 31) / 32 * 32;
  const size_t smem = (size_t)(1 + threads / 32) * kCols * block * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blend_bwd_win_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  blend_bwd_win_kernel<<<nb, threads, smem, (cudaStream_t)stream>>>(
      table, ep, block_src, block_valid, block_tile, g, nb, block, ts, tiles_x,
      row0, power_floor, alpha_cap, alpha_floor, dcols);
  return (int)cudaGetLastError();
}
