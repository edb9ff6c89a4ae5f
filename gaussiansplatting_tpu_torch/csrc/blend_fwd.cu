// Windowed block blend, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in gaussiansplatting_tpu/ops/pallas_blend.py:
//   gs_blend_fwd_win     _fwd_kernel_win (:601, windowed_blend_fwd), and
//                        _fwd_kernel (:161, block_blend_cols) on the
//                        t_floor_exact path's first pass: its aligned block b
//                        is window b here;
//   gs_blend_fwd_win_tf  _fwd_kernel_tf (:249, block_blend_cols_tf), the
//                        exact T-floor second pass;
//   gs_blend_fwd_win_packed  _fwd_kernel_win's packed branch (cfg_consts[5],
//                        [6]: the bf16 payload mode, with or without
//                        pack_positions).
// Python wrappers and plain PyTorch versions:
// gaussiansplatting_tpu_torch/ops/blend.py (the contract is documented there).
//
// Every instance evaluates the power with explicitly rounded operations
// (__fmul_rn etc., never contracted into FMAs) in the same order as the
// plain version, so the power window and alpha-floor masks agree with it
// bit for bit on the card; only the prefix and colour sums are taken in
// another order.  Each output element has exactly one writer: no atomics,
// deterministic.  Dead blocks (block_valid == 0) still write zeros and gid
// -1, because the outputs come from torch.empty and compose reads every
// block.
//
// What bounds it on the H100: ~4.3e8 (pixel, lane) power tests per 800x608
// frame of the 100k-Gaussian scene (~11 flops each) and, per kept pair, an
// exp for alpha, a log1p for S and ~14 flops: instruction issue, not HBM
// (~150 MB in and out, 0.045 ms at 3.35 TB/s).  The T-floor pass tests far
// fewer pairs (pixels stop at the floor) and moves about as many bytes, so
// HBM bounds it.
//
// gs_blend_fwd_win and gs_blend_fwd_win_tf (blend_fwd_win_hopper): one
// CUDA block per pair block b and kPixels = 4
// pixels per thread (a column strip, blend_common.cuh), so 64 threads at
// ts = 16; the T-floor instance takes kPixelsTF = 2 (128 threads, a warp
// covers 16 x 4 pixels), which timed faster there than 4 or 1: its warps
// run until their last pixel stops, and most of its blocks do little
// besides read logti and write zeros.  The live lanes are staged once as 48-byte records (three float4:
// mean and cull extents, conic and opacity, colour), so a thread reads each
// lane with three broadcast shared loads and uses it for its 4 pixels.  The
// transmittance is carried by multiplication (w = alpha T; T *= 1 - alpha)
// instead of an expf(S) per kept pair; S is still the sequential log1pf sum,
// bit for bit the plain version's row 3, which the backward walks back from
// and the T-floor pass compares.  A warp skips a lane whose padded ellipse
// box (blend_common.cuh, cull_extent) misses the warp's 16 x 8 pixel
// rectangle: a test per warp and lane in place of 4 power evaluations per
// thread, which never drops a pixel the power test would keep.
//
// The T-floor pass (kTFloor) takes each pixel's incoming log T, logti[b, p],
// from the unmasked first pass and stops the pixel at the first kept lane
// where S + logti <= log_thr: the reference's per-pixel loop exit
// (tiled_shaders.metal:334).  S only decreases, so every later lane would
// be masked too and stopping is exact; it is also the work the exit saves.
// The test is on the sequential S bits, so S_b and the set of surviving
// lanes are the same whatever the pixels per thread.  A thread with 2
// pixels cannot break for one of them: each pixel carries a done flag (set
// before the loop where logti is already at or below the floor), and the
// warp leaves the lane loop once every pixel of it is done (__all_sync).
// A block whose pixels all arrive at or below the floor writes C = 0,
// S = 0 and stages nothing.  The T-floor pass writes no gid; it writes each
// pixel's stop lane, one past its last surviving lane (0 where none
// survives), which the backward starts its walk from.
//
// gs_blend_fwd_win_packed, the bf16 payload mode (kPack 1, or 2 with
// tile-relative positions; _fwd_kernel_win's packed branch, pallas_blend.py
// :605-606, 647, 661): the Hopper design over the 8-row packed table, each
// lane unpacked once when it is staged (blend_common.cuh), so the power
// tests cost what they cost unpacked.  The TPU kernel takes the in-block
// log T prefix as a bf16 matmul (_tri_dot(..., low_precision), :647): T_k =
// exp(Q_k - l_k), Q_k the float32 sum of the bf16-rounded l_j over j <= k.
// What bounds it on the H100 is the float32 instance's instruction issue
// plus, per kept pair, l and its rounding; a kept path runs for the whole
// warp if any thread keeps the pair, so each instruction on it counts
// several times.  So T is carried by multiplication, as in the float32
// instance, and keeps the TPU kernel's numbers: E = exp(Q_{k-1}) starts at
// 1, T_k = E exp(-d_k) with d = l - bf16(l) (exact, |d| <= 0.018) and exp(-d)
// the cubic of blend_common.cuh (within an ulp), then E = T_k (1 - alpha_k)
// = exp(Q_k): no expf per kept pair.  l = log1pf(-alpha) and its rounding
// come from blend_common.cuh's log1m_bf16, the plain version's bits, which
// the backward shares: Q still adds bf16(l), so q_b [nb, ts*ts], each
// pixel's Q over the block, which the packed backward walks back from, and
// S (row 3, the unrounded log1pf sum, :661) keep their bits.  E runs into
// the denormals only where T does (Q < -87).  kPixels = 4 as the float32
// instance: 1 and 2 timed slower here too.  The log1pf, which the float32
// instance pays for S as well, is most of what the kept path costs; 7 (6)
// table rows are read per lane instead of 10.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

constexpr int kPixels = 4;    // pixels per thread
constexpr int kPixelsTF = 2;  // ... of the T-floor instance

// No __launch_bounds__: with (256) ptxas fits the plain instance in 48
// registers and spills 12 bytes; without, it takes 56 and spills nothing.
// kPack: the table's payload layout (blend_common.cuh); packed instances
// write q_out, the float32 instance none.
template <bool kTFloor, int kPack = 0>
__global__ void blend_fwd_win_hopper(
    const float* __restrict__ table, long long ep,
    const int* __restrict__ block_src, const int* __restrict__ block_valid,
    const int* __restrict__ block_tile, const float* __restrict__ logti,
    int block, int ts, int tiles_x, int row0, float power_floor,
    float alpha_cap, float alpha_floor, float log_thr,
    float* __restrict__ out, float* __restrict__ gid_out,
    int* __restrict__ stop_out, float* __restrict__ q_out) {
  constexpr int P = kTFloor ? kPixelsTF : kPixels;
  extern __shared__ float4 lane_smem[];
  blend::Lane* lanes = reinterpret_cast<blend::Lane*>(lane_smem);  // [block]
  const int b = blockIdx.x;
  const int p2 = ts * ts;
  float* out_b = out + (size_t)b * 4 * p2;
  int nv = min(block_valid[b], block);
  if (!kTFloor) {
    float* gid_b = gid_out + (size_t)b * block;
    for (int t = threadIdx.x; t < block; t += blockDim.x)
      gid_b[t] = t < nv ? table[(long long)block_src[b] + t] : -1.f;
  }

  const float half = 0.5f * (float)ts;
  const blend::Strip<P> st = blend::thread_strip<P>(ts, half);
  // T-floor: each pixel's incoming log T, and done where it arrives at or
  // below the floor (its first kept lane would stop it before anything is
  // added) or lies off the tile
  float lt[P];
  bool done[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    lt[j] = 0.f;
    done[j] = !st.on(j, ts);
  }
  if (kTFloor) {
    bool open = false;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (!st.on(j, ts)) continue;
      lt[j] = logti[(size_t)b * p2 + (st.y0 + j) * ts + st.x];
      done[j] = !(lt[j] > log_thr);
      open |= !done[j];
    }
    if (!__syncthreads_or(open)) nv = 0;  // uniform: all threads or none
  }
  if (nv <= 0) {
    for (int i = threadIdx.x; i < 4 * p2; i += blockDim.x) out_b[i] = 0.f;
    if (kTFloor)
      for (int p = threadIdx.x; p < p2; p += blockDim.x) stop_out[(size_t)b * p2 + p] = 0;
    if (kPack)
      for (int p = threadIdx.x; p < p2; p += blockDim.x) q_out[(size_t)b * p2 + p] = 0.f;
    return;
  }

  const int tile = block_tile[b];
  blend::stage_lanes<kPack>(lanes, table, ep, block_src[b], nv,
                     (float)(tile % tiles_x) * (float)ts + half,
                     (float)(tile / tiles_x + row0) * (float)ts + half,
                     power_floor, alpha_floor);
  __syncthreads();

  const float4 rect = blend::warp_rect<P>(st, ts, half);
  // T carries the transmittance (float32 instance) or exp(Q) over the
  // lanes before the current one (packed instances); Q the float32 sum of
  // the bf16-rounded log1p(-alpha) (packed instances)
  float T[P], Q[P], S[P], c0[P], c1[P], c2[P];
  int stop[P];
#pragma unroll
  for (int j = 0; j < P; ++j)
    T[j] = 1.f, Q[j] = S[j] = c0[j] = c1[j] = c2[j] = 0.f, stop[j] = 0;

  for (int k = 0; k < nv; ++k) {
    if (kTFloor) {
      bool all = true;
#pragma unroll
      for (int j = 0; j < P; ++j) all &= done[j];
      if (__all_sync(blend::kFullMask, all)) break;  // the warp's pixels all stopped
    }
    const float4 q0 = lanes[k].q0;
    if (blend::culled(rect, q0)) continue;
    const float4 q1 = lanes[k].q1;
    if (q1.w == 0.f) continue;  // a_raw = 0 is below any alpha floor > 0
    const float4 q2 = lanes[k].q2;
    const float dx = __fsub_rn(st.px, q0.x);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (kTFloor && done[j]) continue;
      const float dy = __fsub_rn(st.py[j], q0.y);
      const float power = blend::power_of(dx, dy, q1.x, q1.y, q1.z);
      if (!(st.on(j, ts) && power <= 0.f && power >= power_floor)) continue;
      const float a_raw = __fmul_rn(q1.w, expf(power));
      if (!(a_raw >= alpha_floor)) continue;
      if (kTFloor && !(__fadd_rn(S[j], lt[j]) > log_thr)) {  // terminated
        done[j] = true;
        continue;
      }
      const float alpha = fminf(a_raw, alpha_cap);
      if (kPack) {
        const blend::Log1m lm = blend::log1m_bf16(alpha);
        Q[j] = __fadd_rn(Q[j], lm.lb);
        // T_k = exp(Q_k - l_k) = exp(Q_{k-1}) exp(-d_k)
        const float t = T[j] * blend::exp_small(-lm.d);
        const float w = alpha * t;
        c0[j] += w * q2.x;
        c1[j] += w * q2.y;
        c2[j] += w * q2.z;
        T[j] = t * (1.f - alpha);  // exp(Q_k)
        S[j] += lm.l;
        continue;
      }
      const float w = alpha * T[j];
      c0[j] += w * q2.x;
      c1[j] += w * q2.y;
      c2[j] += w * q2.z;
      T[j] *= 1.f - alpha;
      S[j] += log1pf(-alpha);
      if (kTFloor) stop[j] = k + 1;
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (!st.on(j, ts)) continue;
    const int p = (st.y0 + j) * ts + st.x;
    out_b[p] = c0[j];
    out_b[p2 + p] = c1[j];
    out_b[2 * p2 + p] = c2[j];
    out_b[3 * p2 + p] = S[j];
    if (kTFloor) stop_out[(size_t)b * p2 + p] = stop[j];
    if (kPack) q_out[(size_t)b * p2 + p] = Q[j];
  }
}

int hopper_threads(int ts, int p) { return (ts * ((ts + p - 1) / p) + 31) / 32 * 32; }

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// table [>=10, ep] f32 row-major; block_src/valid/tile [nb] i32;
// out [nb, 4, ts*ts] f32; gid [nb, block] f32.  ts * ceil(ts / 4) threads,
// rounded up to whole warps (at most 256: ts <= 32), and 48 * block bytes
// of shared memory (block <= 1024 keeps it within 48 KB).
extern "C" int gs_blend_fwd_win(const float* table, long long ep,
                                const int* block_src, const int* block_valid,
                                const int* block_tile, int nb, int block,
                                int ts, int tiles_x, int row0,
                                float power_floor, float alpha_cap,
                                float alpha_floor, float* out, float* gid,
                                void* stream) {
  const size_t smem = (size_t)block * sizeof(blend::Lane);
  blend_fwd_win_hopper<false><<<nb, hopper_threads(ts, kPixels), smem, (cudaStream_t)stream>>>(
      table, ep, block_src, block_valid, block_tile, nullptr, block, ts, tiles_x,
      row0, power_floor, alpha_cap, alpha_floor, 0.f, out, gid, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// The T-floor pass: as gs_blend_fwd_win plus logti [nb, ts*ts] f32 and
// log_thr = log(transmittance_floor); writes out and stop [nb, ts*ts] i32
// (each pixel's stop lane), no gid.  ts * ceil(ts / 2) threads, rounded up
// to whole warps.
extern "C" int gs_blend_fwd_win_tf(const float* table, long long ep,
                                   const int* block_src,
                                   const int* block_valid,
                                   const int* block_tile, const float* logti,
                                   int nb, int block, int ts, int tiles_x,
                                   int row0, float power_floor,
                                   float alpha_cap, float alpha_floor,
                                   float log_thr, float* out, int* stop,
                                   void* stream) {
  const size_t smem = (size_t)block * sizeof(blend::Lane);
  blend_fwd_win_hopper<true><<<nb, hopper_threads(ts, kPixelsTF), smem, (cudaStream_t)stream>>>(
      table, ep, block_src, block_valid, block_tile, logti, block, ts, tiles_x,
      row0, power_floor, alpha_cap, alpha_floor, log_thr, out, nullptr, stop, nullptr);
  return (int)cudaGetLastError();
}

// The bf16 payload mode: as gs_blend_fwd_win over the packed table (table
// [>=7, ep], or [>=6, ep] with pack_pos != 0, the tile-relative positions),
// plus q_b [nb, ts*ts] f32, each pixel's float32 sum of the bf16-rounded
// log1p(-alpha) over the block.
extern "C" int gs_blend_fwd_win_packed(const float* table, long long ep,
                                       const int* block_src,
                                       const int* block_valid,
                                       const int* block_tile, int nb, int block,
                                       int ts, int tiles_x, int row0, int pack_pos,
                                       float power_floor, float alpha_cap,
                                       float alpha_floor, float* out, float* gid,
                                       float* q_b, void* stream) {
  const size_t smem = (size_t)block * sizeof(blend::Lane);
  const auto kernel = pack_pos ? blend_fwd_win_hopper<false, 2> : blend_fwd_win_hopper<false, 1>;
  kernel<<<nb, hopper_threads(ts, kPixels), smem, (cudaStream_t)stream>>>(
      table, ep, block_src, block_valid, block_tile, nullptr, block, ts, tiles_x,
      row0, power_floor, alpha_cap, alpha_floor, 0.f, out, gid, nullptr, q_b);
  return (int)cudaGetLastError();
}
