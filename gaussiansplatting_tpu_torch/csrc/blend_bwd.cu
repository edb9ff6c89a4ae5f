// Windowed block blend, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in gaussiansplatting_tpu/ops/pallas_blend.py:
//   gs_blend_bwd_win     _bwd_kernel_win (:671, windowed_blend_bwd), and
//                        _bwd_kernel (:188, the VJP of block_blend_cols) on
//                        the t_floor_exact path's first pass, whose
//                        cotangent reaches S_b alone (colour rows zero);
//   gs_blend_bwd_win_tf  _bwd_kernel_tf (:281, the VJP of
//                        block_blend_cols_tf), the exact T-floor pass;
//   gs_blend_bwd_win_packed  _bwd_kernel_win's packed branch (the bf16
//                        payload mode, with or without pack_positions).
// Python wrappers and plain PyTorch versions:
// gaussiansplatting_tpu_torch/ops/blend.py (the contract is documented there).
//
// The chain rule, per pixel, walking its kept lanes back to front: S steps
// back over each kept lane (S -= log1p(-alpha), so T = exp(S) is the
// transmittance in front of it) and the suffix sum_{j>k} e_j w_j is carried
// forward, so per lane
//   e = sum_ch g_ch c_ch,  dl = suffix + g_S,
//   dalpha = e T - dl / (1 - alpha),  dpow = dalpha * a_raw
// (the alpha cap passes the gradient through, as in the TPU kernel).  Per
// lane the nine outputs are sums over the tile's pixels of
//   (dpow dx, dpow dy, dpow dx^2, dpow dx dy, dpow dy^2, dpow, g_r w, g_g w,
//    g_b w),
// finished per lane as d mx = a s_x + b s_y, d my = b s_x + c s_y,
// d a = -s_xx / 2, d b = -s_xy, d c = -s_yy / 2, d op = s_p / op and the
// three colour sums (the VPU form of the TPU kernel, pallas_blend.py:762-799).
// The power and the masks use the same explicitly rounded operations as
// blend_fwd.cu and the plain version, so every mask agrees with them bit for
// bit.  Every cross-pixel sum is atomic-free and in a fixed order, so a
// second launch on the same inputs gives the same bits.  Dead blocks and
// lanes past block_valid write zeros (outputs come from torch.empty).
//
// What bounds it on the H100: the ~4.3e8 (pixel, lane) power tests of the
// forward (~11 flops each) and, per kept pair, an exp, a reciprocal and ~35
// flops, plus the cross-pixel sums; instruction issue, not HBM (the table, g, s_b and
// the nine outputs, ~245 MB, 0.07 ms at 3.35 TB/s).  The T-floor pass keeps
// far fewer pairs for about as many bytes, so HBM bounds it.
//
// gs_blend_bwd_win and gs_blend_bwd_win_tf (blend_bwd_win_hopper): one CUDA
// block per pair block, kPixels = 2 pixels per thread (a column strip,
// blend_common.cuh: 128 threads at ts = 16) and the lanes staged as the
// forward stages them.  It starts each pixel from the forward's own S_b
// (s_b, row 3 of its out), the rounded sequential log1pf sum that a replay
// of the forward would recompute, so there is one walk, back to front, and
// it carries T back by division, T_before
// = T_after / (1 - alpha), with the IEEE reciprocal that dl / (1 - alpha)
// needs too: no log1pf and no expf per kept pair (about 1 ulp per kept
// lane where the log walk loses ulp(|S|)).  Only a pixel with S_b < -60,
// where expf(S_b) nears the denormals, walks back in log space until S
// rises above -60, then switches.  Lanes go in batches of four: a thread
// sums its 2 pixels' nine terms per lane in registers, then the warp sums
// the batch's 4 x 9 values with two halving exchanges (each thread keeps
// half of the lanes and adds its partner's half: 18 + 9 shuffles) and a
// butterfly over the last 8 threads (27 shuffles), 13.5 shuffles per
// (warp, lane) against 45 for a shuffle tree per column; one thread per lane
// then holds the warp's sums, and the warps'
// partials are summed in warp order from shared memory.  A batch that no
// pixel of the warp keeps skips the exchange, and a warp skips a lane whose
// padded ellipse box misses its 16 x 4 pixel rectangle (as the forward
// does).  Shared memory: 48 * B bytes of lanes + warps * 9 * B floats of
// partials (24 KB at B = 128).
//
// The T-floor pass (kTFloor) holds the termination mask constant, as
// _bwd_kernel_tf does, without replaying it: it takes the T-floor forward's
// masked S_b and each pixel's stop lane (one past its last surviving lane;
// the survivors are a prefix of the pixel's kept lanes), walks back from the
// lane before it, so g_S and every other term reach surviving lanes only,
// and logti gets no cotangent.  A warp skips the batches at or past its
// largest stop lane, lanes at or past the block's largest are zero for
// every pixel, and a block in which nothing survives writes zeros and
// stages nothing.
//
// gs_blend_bwd_win_packed, the bf16 payload mode (kPack 1, or 2 with
// tile-relative positions; _bwd_kernel_win's packed branch, pallas_blend.py
// :721, 751, 807-818): the Hopper design over the packed table, lanes
// unpacked when staged.  The TPU kernel takes T from the bf16 prefix of l
// (T_k = exp(Q_k - l_k), as the packed forward) and the suffix as a bf16
// matmul of e w (_tri_dot(..., low_precision), :721, 751): dl_k = g_S +
// sum_{j>k} bf16(e_j w_j).  What bounds it on the H100 is instruction
// issue on the kept path, which runs for the whole warp if any thread keeps
// the pair.  So it carries T back by multiplication: each pixel starts from
// the packed forward's q_b (its Q over the block) and E = exp(q_b); per kept
// pair one __frcp_rn(1 - alpha) gives both T_k = E / (1 - alpha_k) =
// exp(Q_k - l_k) and dl / (1 - alpha), then E = T_k exp(d_k) = exp(Q_{k-1}),
// d = l - bf16(l) from blend_common.cuh's log1m_bf16 (the forward's l and
// rounding) and exp(d) its cubic: no expf and no IEEE division per kept
// pair.  Where Q < -60 (kLogWalk), as #2 below S_b, the pixel walks back in
// log space, T = expf(Q - l), Q -= bf16(l), until Q rises above it, and E
// is carried from its last T.  It adds round_bf16(e w) to the suffix and
// writes the nine cotangents per lane as five bf16-pair rows (dmx, dmy),
// (da, db), (dc, dop), (dr, dg), (db, 0) (:807-818), round to nearest
// even.  kPixels = 2 as the float32 instance (1 and 4 timed slower here
// too).  log1pf, the plain version's bits, which the rounding of l needs,
// is now most of what the kept path costs beyond the float32 instance's; 5
// output rows in place of 9.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

constexpr int kCols = 9;  // mx, my, conic a, b, c, opacity, r, g, b
constexpr int kBatch = 4;  // lanes per warp exchange
constexpr int kPixels = 2;  // pixels per thread (both instances)
// Below this log-transmittance expf(S) loses precision (it reaches the
// denormals at S < -87), so a pixel whose S_b lies below it walks back in
// log space until S rises above it
constexpr float kLogWalk = -60.f;
using blend::kFullMask;

// Sums v[i][c] (lane i of a batch of four, column c) over the warp's 32
// threads in a fixed order.  Two halving exchanges: across xor 16 a thread
// keeps lanes {2 h4, 2 h4 + 1} (h4 = bit 4 of its warp lane) and adds its
// partner's values of them; across xor 8 it keeps lane 2 h4 + h3.  Then a
// butterfly over xor 4, 2, 1 sums the 8 threads holding that lane.  Returns
// in s the nine sums of lane (threadIdx.x & 31) >> 3 of the batch, with the
// same bits in each of the 8 threads (every add pairs the same two values).
__device__ __forceinline__ void warp_sum_batch(const float (&v)[kBatch][kCols],
                                               float (&s)[kCols]) {
  const int wl = threadIdx.x & 31;
  const bool h4 = wl & 16, h3 = wl & 8;
  float u[2][kCols];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float send = h4 ? v[i][c] : v[2 + i][c];
      const float keep = h4 ? v[2 + i][c] : v[i][c];
      u[i][c] = keep + __shfl_xor_sync(kFullMask, send, 16);
    }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const float send = h3 ? u[0][c] : u[1][c];
    const float keep = h3 ? u[1][c] : u[0][c];
    s[c] = keep + __shfl_xor_sync(kFullMask, send, 8);
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[c] += __shfl_xor_sync(kFullMask, s[c], off);
}

// The per-lane finish of the nine pixel sums s (see the header) for the
// lane's conic (ca, cb, cc) and opacity op.
__device__ __forceinline__ void finish_lane(const float (&s)[kCols], float ca,
                                            float cb, float cc, float op,
                                            float (&o)[kCols]) {
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

// kPack: the table's payload layout (blend_common.cuh); a packed instance
// takes the packed forward's q_b in s_b and writes 5 packed rows.
template <bool kTFloor, int kPack = 0>
__global__ void __launch_bounds__(512) blend_bwd_win_hopper(
    const float* __restrict__ table, long long ep,
    const int* __restrict__ block_src, const int* __restrict__ block_valid,
    const int* __restrict__ block_tile, const float* __restrict__ g,
    const float* __restrict__ s_b, const int* __restrict__ stop, int nb,
    int block, int ts, int tiles_x, int row0, float power_floor,
    float alpha_cap, float alpha_floor, float* __restrict__ dcols) {
  constexpr int P = kPixels;
  constexpr int kOut = kPack ? 5 : kCols;  // output rows
  extern __shared__ float4 lane_smem[];
  __shared__ int warp_stop[32];
  blend::Lane* lanes = reinterpret_cast<blend::Lane*>(lane_smem);        // [block]
  float* part = reinterpret_cast<float*>(lanes + block);      // [warps][kCols][block]
  const int b = blockIdx.x;
  const int p2 = ts * ts;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int wlane = threadIdx.x & 31;
  const size_t plane = (size_t)nb * block;  // one output column, [nb, block]
  float* out_b = dcols + (size_t)b * block;
  int nv = min(block_valid[b], block);
  const float half = 0.5f * (float)ts;
  const blend::Strip<P> st = blend::thread_strip<P>(ts, half);
  // T-floor: each pixel's stop lane (one past its last surviving lane), the
  // warp's largest, and the block's largest, past which every lane's
  // cotangents are zero (read from every warp's, no atomics)
  int pstop[P];
  int wstop = nv;
#pragma unroll
  for (int j = 0; j < P; ++j) pstop[j] = nv;
  if (kTFloor) {
    int tstop = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      pstop[j] = st.on(j, ts) ? stop[(size_t)b * p2 + (st.y0 + j) * ts + st.x] : 0;
      tstop = max(tstop, pstop[j]);
    }
    wstop = __reduce_max_sync(kFullMask, tstop);
    if (wlane == 0) warp_stop[warp] = wstop;
    __syncthreads();
    int kmax = 0;
    for (int w = 0; w < nwarps; ++w) kmax = max(kmax, warp_stop[w]);
    nv = min(nv, kmax);  // uniform across the block
  }
  if (nv <= 0) {
    for (int i = threadIdx.x; i < kOut * block; i += blockDim.x)
      out_b[(size_t)(i / block) * plane + i % block] = 0.f;
    return;
  }

  const int tile = block_tile[b];
  blend::stage_lanes<kPack>(lanes, table, ep, block_src[b], nv,
                            (float)(tile % tiles_x) * (float)ts + half,
                            (float)(tile / tiles_x + row0) * (float)ts + half,
                            power_floor, alpha_floor);

  const float4 rect = blend::warp_rect<P>(st, ts, half);
  // per pixel: the cotangent, the suffix sum_{j > k} e_j w_j and the
  // transmittance behind the current lane, Tn = exp(S_b) at the start
  // (while S < kLogWalk, S walks back instead and Tn is unused); packed, S
  // is Q, from q_b, and Tn is exp(Q) over the lanes up to the current one
  float g0[P], g1[P], g2[P], gS[P], S[P], Tn[P], suffix[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    g0[j] = g1[j] = g2[j] = gS[j] = S[j] = Tn[j] = suffix[j] = 0.f;
    if (st.on(j, ts)) {
      const int p = (st.y0 + j) * ts + st.x;
      const float* g_b = g + (size_t)b * 4 * p2 + p;
      g0[j] = g_b[0];
      g1[j] = g_b[p2];
      g2[j] = g_b[2 * p2];
      gS[j] = g_b[3 * p2];
      S[j] = s_b[(size_t)b * p2 + p];
      Tn[j] = S[j] < kLogWalk ? 0.f : expf(S[j]);
    }
  }
  __syncthreads();

  for (int kb = (nv - 1) / kBatch; kb >= 0; --kb) {
    float v[kBatch][kCols];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[i][c] = 0.f;
    bool kept = false;
    // T-floor: a batch at or past every stop lane of the warp is all zero
    // (uniform across the warp; it still writes its zero partials)
    const bool live_batch = !kTFloor || kb * kBatch < wstop;
#pragma unroll
    for (int i = kBatch - 1; i >= 0; --i) {
      const int k = kb * kBatch + i;
      if (!live_batch || k >= nv) continue;
      const float4 q0 = lanes[k].q0;
      if (blend::culled(rect, q0)) continue;
      const float4 q1 = lanes[k].q1;
      if (q1.w == 0.f) continue;
      const float4 q2 = lanes[k].q2;
      const float dx = __fsub_rn(st.px, q0.x);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (kTFloor && k >= pstop[j]) continue;  // past the pixel's survivors
        const float dy = __fsub_rn(st.py[j], q0.y);
        const float power = blend::power_of(dx, dy, q1.x, q1.y, q1.z);
        if (!(st.on(j, ts) && power <= 0.f && power >= power_floor)) continue;
        const float a_raw = __fmul_rn(q1.w, expf(power));
        if (!(a_raw >= alpha_floor)) continue;
        kept = true;
        const float alpha = fminf(a_raw, alpha_cap);
        if (kPack) {
          const blend::Log1m lm = blend::log1m_bf16(alpha);
          const float dl = suffix[j] + gS[j];
          const float inv = __frcp_rn(1.f - alpha);
          float T;  // T_k = exp(Q_k - l_k)
          if (S[j] < kLogWalk) {  // Q_k inclusive, walked back in log space
            T = expf(__fsub_rn(S[j], lm.l));
            S[j] = __fsub_rn(S[j], lm.lb);
          } else {
            T = Tn[j] * inv;  // exp(Q_k) / (1 - alpha_k)
          }
          Tn[j] = T * blend::exp_small(lm.d);  // exp(Q_{k-1})
          const float dl_1ma = dl * inv;  // dl / (1 - alpha)
          const float w = alpha * T;
          const float e = g0[j] * q2.x + g1[j] * q2.y + g2[j] * q2.z;
          const float dpow = (e * T - dl_1ma) * a_raw;
          const float pdx = dpow * dx;
          const float pdy = dpow * dy;
          v[i][0] += pdx;
          v[i][1] += pdy;
          v[i][2] += pdx * dx;
          v[i][3] += pdx * dy;
          v[i][4] += pdy * dy;
          v[i][5] += dpow;
          v[i][6] += g0[j] * w;
          v[i][7] += g1[j] * w;
          v[i][8] += g2[j] * w;
          suffix[j] += blend::round_bf16(e * w);
          continue;
        }
        const float inv = __frcp_rn(1.f - alpha);
        float T;  // the transmittance in front of the lane
        if (S[j] < kLogWalk) {
          S[j] -= log1pf(-alpha);
          T = expf(S[j]);
        } else {
          T = Tn[j] * inv;
        }
        Tn[j] = T;
        const float w = alpha * T;
        const float e = g0[j] * q2.x + g1[j] * q2.y + g2[j] * q2.z;
        const float dl = suffix[j] + gS[j];
        const float dpow = (e * T - dl * inv) * a_raw;
        const float pdx = dpow * dx;
        const float pdy = dpow * dy;
        v[i][0] += pdx;
        v[i][1] += pdy;
        v[i][2] += pdx * dx;
        v[i][3] += pdx * dy;
        v[i][4] += pdy * dy;
        v[i][5] += dpow;
        v[i][6] += g0[j] * w;
        v[i][7] += g1[j] * w;
        v[i][8] += g2[j] * w;
        suffix[j] += e * w;
      }
    }
    float s[kCols];
    if (__any_sync(kFullMask, kept)) {
      warp_sum_batch(v, s);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[c] = 0.f;
    }
    const int k = kb * kBatch + (wlane >> 3);
    if ((wlane & 7) == 0 && k < nv) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) part[(warp * kCols + c) * block + k] = s[c];
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
      const float4 q1 = lanes[k].q1;
      finish_lane(s, q1.x, q1.y, q1.z, q1.w, o);
    }
    if (kPack) {
#pragma unroll
      for (int c = 0; c < 5; ++c)
        out_b[(size_t)c * plane + k] = blend::pack2(o[2 * c], c < 4 ? o[2 * c + 1] : 0.f);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) out_b[(size_t)c * plane + k] = o[c];
    }
  }
}

// tfloor: the T-floor instance; pack: the payload layout (kPack)
int launch_hopper(bool tfloor, int pack, const float* table, long long ep,
                  const int* block_src, const int* block_valid,
                  const int* block_tile, const float* g, const float* s_b,
                  const int* stop, int nb, int block, int ts, int tiles_x,
                  int row0, float power_floor, float alpha_cap,
                  float alpha_floor, float* dcols, void* stream) {
  const auto kernel = tfloor      ? blend_bwd_win_hopper<true>
                      : pack == 1 ? blend_bwd_win_hopper<false, 1>
                      : pack == 2 ? blend_bwd_win_hopper<false, 2>
                                  : blend_bwd_win_hopper<false>;
  const int threads = (ts * ((ts + kPixels - 1) / kPixels) + 31) / 32 * 32;
  const size_t smem = (size_t)block * sizeof(blend::Lane) +
                      (size_t)(threads / 32) * kCols * block * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<nb, threads, smem, (cudaStream_t)stream>>>(
      table, ep, block_src, block_valid, block_tile, g, s_b, stop, nb, block,
      ts, tiles_x, row0, power_floor, alpha_cap, alpha_floor, dcols);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// table [>=10, ep] f32 row-major; block_src/valid/tile [nb] i32;
// g [nb, 4, ts*ts] f32 (rows 0-2 dC, row 3 dS); s_b [nb, ts*ts] f32, the
// forward's S_b (row 3 of its out); dcols [9, nb, block] f32.
// ts * ceil(ts / 2) threads rounded up to whole warps (at most 512: ts <=
// 32), 48 * block bytes + warps * 9 * block floats of shared memory, which
// the wrapper keeps within the 227 KB a Hopper block can have.
extern "C" int gs_blend_bwd_win(const float* table, long long ep,
                                const int* block_src, const int* block_valid,
                                const int* block_tile, const float* g,
                                const float* s_b, int nb, int block, int ts,
                                int tiles_x, int row0, float power_floor,
                                float alpha_cap, float alpha_floor,
                                float* dcols, void* stream) {
  return launch_hopper(false, 0, table, ep, block_src, block_valid, block_tile,
                       g, s_b, nullptr, nb, block, ts, tiles_x, row0, power_floor,
                       alpha_cap, alpha_floor, dcols, stream);
}

// The T-floor pass: as gs_blend_bwd_win, where s_b is the T-floor forward's
// masked S_b and stop [nb, ts*ts] i32 its stop lanes (one past each pixel's
// last surviving lane).
extern "C" int gs_blend_bwd_win_tf(const float* table, long long ep,
                                   const int* block_src,
                                   const int* block_valid,
                                   const int* block_tile, const float* g,
                                   const float* s_b, const int* stop, int nb,
                                   int block, int ts, int tiles_x, int row0,
                                   float power_floor, float alpha_cap,
                                   float alpha_floor, float* dcols,
                                   void* stream) {
  return launch_hopper(true, 0, table, ep, block_src, block_valid, block_tile,
                       g, s_b, stop, nb, block, ts, tiles_x, row0, power_floor,
                       alpha_cap, alpha_floor, dcols, stream);
}

// The bf16 payload mode: as gs_blend_bwd_win over the packed table (table
// [>=7, ep], or [>=6, ep] with pack_pos != 0), given the packed forward's
// q_b [nb, ts*ts] in place of s_b; dcols [5, nb, block] f32, the nine
// cotangents as bf16 pairs (dmx, dmy), (da, db), (dc, dop), (dr, dg),
// (db, 0).
extern "C" int gs_blend_bwd_win_packed(const float* table, long long ep,
                                       const int* block_src,
                                       const int* block_valid,
                                       const int* block_tile, const float* g,
                                       const float* q_b, int nb, int block, int ts,
                                       int tiles_x, int row0, int pack_pos,
                                       float power_floor, float alpha_cap,
                                       float alpha_floor, float* dcols,
                                       void* stream) {
  return launch_hopper(false, pack_pos ? 2 : 1, table, ep, block_src,
                       block_valid, block_tile, g, q_b, nullptr, nb, block, ts, tiles_x,
                       row0, power_floor, alpha_cap, alpha_floor, dcols, stream);
}
