// Windowed block blend of 2D Gaussian surfels, forward and backward, for
// Hopper (sm_90a): the ray-splat intersection of 2D Gaussian Splatting
// (Huang et al. 2024, eqs. 8-12) over the windows of ops/pairs.py.
//
// Replaces no Pallas kernel: the JAX package has no surfel.  Python
// wrappers and plain PyTorch versions: gaussiansplatting_tpu_torch/ops/
// surfel_blend.py (the contract is documented there); the autograd
// Function: ops/rasterize._BlendSurfels.
//
// The design of the 3D Gaussian's Hopper blend (blend_fwd.cu, blend_bwd.cu,
// whose pieces of blend_common.cuh it reuses: the thread's column strip of
// pixels, the warp's pixel rectangle and its cull test): one CUDA block a
// pair block, kPixels = 2 pixels a thread (128 threads at ts = 16, a warp
// covering 16 x 4 pixels), the window's live lanes staged once in shared
// memory as 96-byte records (T's nine floats, the opacity, the colour, the
// normal, the projected centre and the lane's cull box), read by broadcast.
// A warp skips a lane whose box misses its rectangle: the bounding box of
// the image of the disc u^2 + v^2 <= -2 thr (thr = max(power_floor,
// log(alpha_floor / op)), lowered by 1e-3 + 1e-4 |thr|: no pixel outside
// it keeps the lane) from its dual conic, joined with the low-pass disc of
// radius sqrt(-thr) around the centre, grown by 1% + 0.5 px.
//
// Per (pixel, lane) test, each operation rounded on its own (__fmul_rn,
// __fsub_rn, __fdiv_rn: never contracted into an FMA) in the plain
// version's order, so the masks agree with it:
//   h_u = x T_2 - T_0, h_v = y T_2 - T_1, c = h_u x h_v, (u, v) = (c0, c1) / c2,
//   rho3 = u^2 + v^2 (+inf at c2 = 0), rho2 = 2 |(x, y) - c|^2,
//   power = -rho / 2 (rho3 where rho3 <= rho2, else rho2), a = op exp(power),
// kept iff power >= power_floor and a >= alpha_floor; alpha = min(a, cap).
// The forward carries T by multiplication (w = alpha T; T *= 1 - alpha)
// and S as the sequential log1pf sum, which the backward walks back from;
// it sums, per pixel, w c (3), S, w z, w n (3), w m and w m^2 (m = f / (f
// - n) (1 - n / z), 2DGS's depth mapped between its planes 0.2 and 100).
//
// The backward walks each pixel's kept lanes back to front from the
// forward's S_b, T_before = T_after / (1 - alpha) with one IEEE reciprocal
// (a log-space walk below S = -60, as blend_bwd.cu), carrying the suffix
// sum_{j > k} e_j w_j, e = <g_C, c> + g_D z + <g_N, n> + g_M1 m + g_M2 m^2:
//   dalpha = e T - (suffix + g_S) / (1 - alpha) (the cap passes it through),
//   dpow = dalpha a, dz = w (g_D + (g_M1 + 2 g_M2 m) dm/dz),
// then into (u, v) and c (the intersection), or into the centre c =
// (T02, T12) / T22 (the low-pass), and T's nine entries.  Per lane it sums
// over the tile's pixels sixteen columns: T's nine, the opacity
// (dalpha exp(power)), the colour (g_C w) and the normal (g_N w).  Lanes
// go in batches of four: a thread sums its pixels' terms in registers, the
// warp sums the batch by two halving exchanges and a butterfly over eight
// threads, and the warps' partials are summed in warp order from shared
// memory.  No atomics: a second launch gives the same bits.  Dead blocks
// and lanes past block_valid write zeros.
//
// What bounds it on the H100: instruction issue.  A test is ~40 float32
// operations (the conic's ~11) and a division; a kept pair adds an exp, a
// log1p (forward) or a reciprocal, and ~25 (forward) or ~120 (backward)
// operations; HBM moves the [17, EP] table's live columns, the [NB, 10,
// P2] sums and, backward, their cotangent and the [16, NB, B] columns.
//
// No kernel name here may hold "blend_fwd_win" or "blend_bwd_win": the
// benchmark's 3D Gaussian blend rooflines match those substrings.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

constexpr int kPixels = 2;   // pixels per thread, both ways
constexpr int kOut = 10;     // rows of out
constexpr int kCols = 16;    // column cotangents a lane
constexpr int kBatch = 4;    // lanes per warp exchange
constexpr float kLogWalk = -60.f;
constexpr float kNear = 0.2f, kFar = 100.0f;
using blend::kFullMask;

// A staged lane, 96 bytes: q0 = cull box (centre x, y, half width,
// height) in pixels; q1 = T00 T01 T02 T10; q2 = T11 T12 T20 T21;
// q3 = T22, op, centre x, y; q4 = rgb, 0; q5 = normal, 0.
struct __align__(16) Lane {
  float4 q0, q1, q2, q3, q4, q5;
};

__device__ __forceinline__ void stage(Lane* lanes, const float* table, long long ep,
                                      long long src, int nv, float power_floor,
                                      float alpha_floor) {
  const float inf = __int_as_float(0x7f800000);
  for (int t = threadIdx.x; t < nv; t += blockDim.x) {
    const float* col = table + src + t;
    float T[9];
    for (int j = 0; j < 9; ++j) T[j] = col[(1 + j) * ep];
    const float op = col[10 * ep];
    const float t22 = T[8];
    const float cx = __fdiv_rn(T[2], t22), cy = __fdiv_rn(T[5], t22);
    float4 box;
    float thr = op > 0.f ? fmaxf(power_floor, logf(alpha_floor / op)) : 0.f;
    thr -= 1e-3f + 1e-4f * fabsf(thr);
    if (!(op > 0.f) || thr >= 0.f || !(t22 > 0.f)) {
      box = make_float4(0.f, 0.f, -inf, -inf);  // never kept: always culled
    } else {
      const float r2 = -2.f * thr, lp = sqrtf(-thr);
      const float d22 = r2 * (T[6] * T[6] + T[7] * T[7]) - t22 * t22;
      if (!(d22 < 0.f)) {
        box = make_float4(0.f, 0.f, inf, inf);  // never culled
      } else {
        float lo[2], hi[2];
        for (int i = 0; i < 2; ++i) {
          const float* ti = T + 3 * i;
          const float cen = (r2 * (ti[0] * T[6] + ti[1] * T[7]) - ti[2] * t22) / d22;
          const float dii = r2 * (ti[0] * ti[0] + ti[1] * ti[1]) - ti[2] * ti[2];
          const float ext = sqrtf(fmaxf(cen * cen - dii / d22, 0.f));
          const float c = i == 0 ? cx : cy;
          lo[i] = fminf(cen - ext, c - lp);
          hi[i] = fmaxf(cen + ext, c + lp);
        }
        box = make_float4(0.5f * (lo[0] + hi[0]), 0.5f * (lo[1] + hi[1]),
                          0.505f * (hi[0] - lo[0]) + 0.5f, 0.505f * (hi[1] - lo[1]) + 0.5f);
      }
    }
    lanes[t].q0 = box;
    lanes[t].q1 = make_float4(T[0], T[1], T[2], T[3]);
    lanes[t].q2 = make_float4(T[4], T[5], T[6], T[7]);
    lanes[t].q3 = make_float4(t22, op, cx, cy);
    lanes[t].q4 = make_float4(col[11 * ep], col[12 * ep], col[13 * ep], 0.f);
    lanes[t].q5 = make_float4(col[14 * ep], col[15 * ep], col[16 * ep], 0.f);
  }
}

// One (pixel, lane) test: the intersection, the power and the mask.
struct Hit {
  float hu[3], hv[3], c2, u, v, power, e, a_raw, z;
  bool hit, kept;
};

__device__ __forceinline__ Hit test(float x, float y, const Lane& L, float power_floor,
                                    float alpha_floor) {
  Hit h;
  const float t00 = L.q1.x, t01 = L.q1.y, t02 = L.q1.z, t10 = L.q1.w;
  const float t11 = L.q2.x, t12 = L.q2.y, t20 = L.q2.z, t21 = L.q2.w, t22 = L.q3.x;
  h.hu[0] = __fsub_rn(__fmul_rn(x, t20), t00);
  h.hu[1] = __fsub_rn(__fmul_rn(x, t21), t01);
  h.hu[2] = __fsub_rn(__fmul_rn(x, t22), t02);
  h.hv[0] = __fsub_rn(__fmul_rn(y, t20), t10);
  h.hv[1] = __fsub_rn(__fmul_rn(y, t21), t11);
  h.hv[2] = __fsub_rn(__fmul_rn(y, t22), t12);
  const float c0 = __fsub_rn(__fmul_rn(h.hu[1], h.hv[2]), __fmul_rn(h.hu[2], h.hv[1]));
  const float c1 = __fsub_rn(__fmul_rn(h.hu[2], h.hv[0]), __fmul_rn(h.hu[0], h.hv[2]));
  h.c2 = __fsub_rn(__fmul_rn(h.hu[0], h.hv[1]), __fmul_rn(h.hu[1], h.hv[0]));
  float rho3 = __int_as_float(0x7f800000);
  h.u = h.v = 0.f;
  if (h.c2 != 0.f) {
    h.u = __fdiv_rn(c0, h.c2);
    h.v = __fdiv_rn(c1, h.c2);
    rho3 = __fadd_rn(__fmul_rn(h.u, h.u), __fmul_rn(h.v, h.v));
  }
  const float dx = __fsub_rn(x, L.q3.z), dy = __fsub_rn(y, L.q3.w);
  const float rho2 = __fmul_rn(2.f, __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  h.hit = rho3 <= rho2;
  h.power = __fmul_rn(-0.5f, h.hit ? rho3 : rho2);
  h.e = expf(h.power);
  h.a_raw = __fmul_rn(L.q3.y, h.e);
  h.kept = h.power >= power_floor && h.a_raw >= alpha_floor;
  h.z = h.hit ? __fadd_rn(__fadd_rn(__fmul_rn(t20, h.u), __fmul_rn(t21, h.v)), t22) : t22;
  return h;
}

__device__ __forceinline__ float depth_map(float z) {
  return (kFar / (kFar - kNear)) * (1.f - kNear / z);
}

// The warp's pixel rectangle in absolute pixels.
template <int P>
__device__ __forceinline__ float4 abs_rect(const blend::Strip<P>& st, int ts, float half,
                                           float tcx, float tcy) {
  float4 r = blend::warp_rect<P>(st, ts, half);
  r.x += tcx;
  r.y += tcy;
  return r;
}

__global__ void surfel_blend_fwd_kernel(
    const float* __restrict__ table, long long ep, const int* __restrict__ block_src,
    const int* __restrict__ block_valid, const int* __restrict__ block_tile, int block, int ts,
    int tiles_x, int row0, float power_floor, float alpha_cap, float alpha_floor,
    float* __restrict__ out, float* __restrict__ gid_out) {
  constexpr int P = kPixels;
  extern __shared__ float4 lane_smem[];
  Lane* lanes = reinterpret_cast<Lane*>(lane_smem);
  const int b = blockIdx.x;
  const int p2 = ts * ts;
  float* out_b = out + (size_t)b * kOut * p2;
  const int nv = min(block_valid[b], block);
  float* gid_b = gid_out + (size_t)b * block;
  for (int t = threadIdx.x; t < block; t += blockDim.x)
    gid_b[t] = t < nv ? table[(long long)block_src[b] + t] : -1.f;
  if (nv <= 0) {
    for (int i = threadIdx.x; i < kOut * p2; i += blockDim.x) out_b[i] = 0.f;
    return;
  }
  const float half = 0.5f * (float)ts;
  const blend::Strip<P> st = blend::thread_strip<P>(ts, half);
  const int tile = block_tile[b];
  const float tcx = (float)(tile % tiles_x) * (float)ts + half;
  const float tcy = (float)(tile / tiles_x + row0) * (float)ts + half;
  stage(lanes, table, ep, block_src[b], nv, power_floor, alpha_floor);
  __syncthreads();
  const float4 rect = abs_rect<P>(st, ts, half, tcx, tcy);
  const float x = __fadd_rn(st.px, tcx);
  float y[P], T[P], acc[P][kOut];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    y[j] = __fadd_rn(st.py[j], tcy);
    T[j] = 1.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[j][c] = 0.f;
  }
  for (int k = 0; k < nv; ++k) {
    const float4 q0 = lanes[k].q0;
    if (blend::culled(rect, q0)) continue;
    const Lane& L = lanes[k];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (!st.on(j, ts)) continue;
      const Hit h = test(x, y[j], L, power_floor, alpha_floor);
      if (!h.kept) continue;
      const float alpha = fminf(h.a_raw, alpha_cap);
      const float w = alpha * T[j];
      const float m = depth_map(h.z);
      const float4 q4 = L.q4, q5 = L.q5;
      acc[j][0] += w * q4.x;
      acc[j][1] += w * q4.y;
      acc[j][2] += w * q4.z;
      acc[j][3] += log1pf(-alpha);
      acc[j][4] += w * h.z;
      acc[j][5] += w * q5.x;
      acc[j][6] += w * q5.y;
      acc[j][7] += w * q5.z;
      acc[j][8] += w * m;
      acc[j][9] += w * m * m;
      T[j] *= 1.f - alpha;
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (!st.on(j, ts)) continue;
    const int p = (st.y0 + j) * ts + st.x;
#pragma unroll
    for (int c = 0; c < kOut; ++c) out_b[c * p2 + p] = acc[j][c];
  }
}

// Sums v[i][c] (lane i of a batch of four, column c) over the warp's 32
// threads in a fixed order (blend_bwd.cu's exchange at sixteen columns):
// returns in s the sums of lane (threadIdx.x & 31) >> 3 of the batch.
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

__global__ void __launch_bounds__(512) surfel_blend_bwd_kernel(
    const float* __restrict__ table, long long ep, const int* __restrict__ block_src,
    const int* __restrict__ block_valid, const int* __restrict__ block_tile,
    const float* __restrict__ g, const float* __restrict__ s_b, int nb, int block, int ts,
    int tiles_x, int row0, float power_floor, float alpha_cap, float alpha_floor,
    float* __restrict__ dcols) {
  constexpr int P = kPixels;
  extern __shared__ float4 lane_smem[];
  Lane* lanes = reinterpret_cast<Lane*>(lane_smem);
  float* part = reinterpret_cast<float*>(lanes + block);  // [warps][kCols][block]
  const int b = blockIdx.x;
  const int p2 = ts * ts;
  const int warp = threadIdx.x >> 5;
  const int wlane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const size_t plane = (size_t)nb * block;
  float* out_b = dcols + (size_t)b * block;
  const int nv = min(block_valid[b], block);
  if (nv <= 0) {
    for (int i = threadIdx.x; i < kCols * block; i += blockDim.x)
      out_b[(size_t)(i / block) * plane + i % block] = 0.f;
    return;
  }
  const float half = 0.5f * (float)ts;
  const blend::Strip<P> st = blend::thread_strip<P>(ts, half);
  const int tile = block_tile[b];
  const float tcx = (float)(tile % tiles_x) * (float)ts + half;
  const float tcy = (float)(tile / tiles_x + row0) * (float)ts + half;
  stage(lanes, table, ep, block_src[b], nv, power_floor, alpha_floor);
  const float4 rect = abs_rect<P>(st, ts, half, tcx, tcy);
  const float x = __fadd_rn(st.px, tcx);
  const float km = kFar / (kFar - kNear);
  float y[P], gg[P][kOut], S[P], Tn[P], suffix[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    y[j] = __fadd_rn(st.py[j], tcy);
    S[j] = Tn[j] = suffix[j] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) gg[j][c] = 0.f;
    if (st.on(j, ts)) {
      const int p = (st.y0 + j) * ts + st.x;
      const float* g_b = g + (size_t)b * kOut * p2 + p;
#pragma unroll
      for (int c = 0; c < kOut; ++c) gg[j][c] = g_b[c * p2];
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
    bool any = false;
#pragma unroll
    for (int i = kBatch - 1; i >= 0; --i) {
      const int k = kb * kBatch + i;
      if (k >= nv) continue;
      const float4 q0 = lanes[k].q0;
      if (blend::culled(rect, q0)) continue;
      const Lane& L = lanes[k];
      const float t20 = L.q2.z, t21 = L.q2.w, t22 = L.q3.x, op = L.q3.y;
      const float4 q4 = L.q4, q5 = L.q5;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (!st.on(j, ts)) continue;
        const Hit h = test(x, y[j], L, power_floor, alpha_floor);
        if (!h.kept) continue;
        any = true;
        const float alpha = fminf(h.a_raw, alpha_cap);
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
        const float m = depth_map(h.z);
        const float* gj = gg[j];
        const float e = gj[0] * q4.x + gj[1] * q4.y + gj[2] * q4.z + gj[4] * h.z +
                        gj[5] * q5.x + gj[6] * q5.y + gj[7] * q5.z + gj[8] * m +
                        gj[9] * m * m;
        const float dl = suffix[j] + gj[3];
        const float dalpha = e * T - dl * inv;
        const float dpow = dalpha * h.a_raw;
        const float dm = km * kNear / (h.z * h.z);
        const float dz = w * (gj[4] + (gj[8] + 2.f * gj[9] * m) * dm);
        suffix[j] += e * w;
        float* vi = v[i];
        vi[9] += dalpha * h.e;
        vi[10] += gj[0] * w;
        vi[11] += gj[1] * w;
        vi[12] += gj[2] * w;
        vi[13] += gj[5] * w;
        vi[14] += gj[6] * w;
        vi[15] += gj[7] * w;
        if (h.hit) {
          // power = -(u^2 + v^2) / 2, z = T20 u + T21 v + T22
          const float gu = dz * t20 - dpow * h.u;
          const float gv = dz * t21 - dpow * h.v;
          vi[6] += dz * h.u;
          vi[7] += dz * h.v;
          vi[8] += dz;
          // (u, v) = (c0, c1) / c2, c = h_u x h_v
          const float ic = 1.f / h.c2;
          const float gc0 = gu * ic, gc1 = gv * ic, gc2 = -(gu * h.u + gv * h.v) * ic;
          // d h_u = h_v x gc, d h_v = gc x h_u
          const float du0 = h.hv[1] * gc2 - h.hv[2] * gc1;
          const float du1 = h.hv[2] * gc0 - h.hv[0] * gc2;
          const float du2 = h.hv[0] * gc1 - h.hv[1] * gc0;
          const float dv0 = gc1 * h.hu[2] - gc2 * h.hu[1];
          const float dv1 = gc2 * h.hu[0] - gc0 * h.hu[2];
          const float dv2 = gc0 * h.hu[1] - gc1 * h.hu[0];
          // h_u = x T_2 - T_0, h_v = y T_2 - T_1
          vi[0] -= du0;
          vi[1] -= du1;
          vi[2] -= du2;
          vi[3] -= dv0;
          vi[4] -= dv1;
          vi[5] -= dv2;
          vi[6] += x * du0 + y[j] * dv0;
          vi[7] += x * du1 + y[j] * dv1;
          vi[8] += x * du2 + y[j] * dv2;
        } else {
          // power = -((x - cx)^2 + (y - cy)^2), c = (T02, T12) / T22, z = T22
          const float gcx = 2.f * dpow * (x - L.q3.z);
          const float gcy = 2.f * dpow * (y[j] - L.q3.w);
          const float it = 1.f / t22;
          vi[2] += gcx * it;
          vi[5] += gcy * it;
          vi[8] += dz - (gcx * L.q3.z + gcy * L.q3.w) * it;
        }
      }
    }
    float s[kCols];
    if (__any_sync(kFullMask, any)) {
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
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float acc = 0.f;
      if (k < nv)
        for (int w = 0; w < nwarps; ++w) acc += part[(w * kCols + c) * block + k];
      out_b[(size_t)c * plane + k] = acc;
    }
  }
}

int threads_for(int ts) { return (ts * ((ts + kPixels - 1) / kPixels) + 31) / 32 * 32; }

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// table [>=17, ep] f32; block_src/valid/tile [nb] i32; out [nb, 10, ts*ts]
// f32; gid [nb, block] f32.  ts * ceil(ts / 2) threads rounded up to whole
// warps, 96 * block bytes of shared memory.
extern "C" int gs_surfel_blend_fwd(const float* table, long long ep, const int* block_src,
                                   const int* block_valid, const int* block_tile, int nb,
                                   int block, int ts, int tiles_x, int row0, float power_floor,
                                   float alpha_cap, float alpha_floor, float* out, float* gid,
                                   void* stream) {
  const size_t smem = (size_t)block * sizeof(Lane);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        surfel_blend_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  surfel_blend_fwd_kernel<<<nb, threads_for(ts), smem, (cudaStream_t)stream>>>(
      table, ep, block_src, block_valid, block_tile, block, ts, tiles_x, row0, power_floor,
      alpha_cap, alpha_floor, out, gid);
  return (int)cudaGetLastError();
}

// g [nb, 10, ts*ts] f32, the cotangent of out; s_b [nb, ts*ts] f32, out's
// row 3; dcols [16, nb, block] f32.  96 * block bytes + warps * 16 * block
// floats of shared memory.
extern "C" int gs_surfel_blend_bwd(const float* table, long long ep, const int* block_src,
                                   const int* block_valid, const int* block_tile,
                                   const float* g, const float* s_b, int nb, int block, int ts,
                                   int tiles_x, int row0, float power_floor, float alpha_cap,
                                   float alpha_floor, float* dcols, void* stream) {
  const int threads = threads_for(ts);
  const size_t smem = (size_t)block * sizeof(Lane) +
                      (size_t)(threads / 32) * kCols * block * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        surfel_blend_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  surfel_blend_bwd_kernel<<<nb, threads, smem, (cudaStream_t)stream>>>(
      table, ep, block_src, block_valid, block_tile, g, s_b, nb, block, ts, tiles_x, row0,
      power_floor, alpha_cap, alpha_floor, dcols);
  return (int)cudaGetLastError();
}
