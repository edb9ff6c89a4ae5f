// Pieces shared by the Hopper designs of the windowed blend, forward
// (blend_fwd.cu, gs_blend_fwd_win) and backward (blend_bwd.cu,
// gs_blend_bwd_win): the staged lane record, the explicitly rounded power,
// the thread's pixels, the conservative per-warp cull and the bf16 payload
// mode's packing (ops/packing.py).
//
// Pixel layout: thread t owns the P pixels (x, y0 + j), j < P, of one column
// strip, x = t % ts, y0 = (t / ts) * P, p = y * ts + x.  A warp of 32
// threads at ts = 16 therefore covers a compact 16 x (2P) rectangle of the
// tile, which is what the cull tests against.  Threads past the tile (when
// ts * ceil(ts / P) is not a multiple of 32) own no pixel.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace blend {

constexpr unsigned kFullMask = 0xffffffffu;

// One live lane of a window in shared memory, 48 bytes, read as three
// broadcast float4 loads:
//   q0 = (mx, my, ex, ey)     mean relative to the tile centre, cull extents
//   q1 = (conic a, b, c, op)  op = 0 on a degenerate conic
//   q2 = (r, g, b, 0)
struct __align__(16) Lane {
  float4 q0, q1, q2;
};

// power = -0.5 (a dx^2 + c dy^2) - b dx dy, each operation rounded on its
// own (never contracted into an FMA) in the plain version's order, so every
// mask built on it agrees with ops/blend.py bit for bit.
__device__ __forceinline__ float power_of(float dx, float dy, float ca, float cb,
                                          float cc) {
  const float qa = __fmul_rn(__fmul_rn(ca, dx), dx);
  const float qc = __fmul_rn(__fmul_rn(cc, dy), dy);
  return __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)),
                   __fmul_rn(cb, __fmul_rn(dx, dy)));
}

// Half-extents (ex, ey) of the box outside which no pixel can keep the lane.
// A pixel is kept only if power >= power_floor and op * exp(power) >=
// alpha_floor, i.e. power >= thr; for a positive definite conic Q that is the
// ellipse d^T Q d <= -2 thr, whose box is sqrt(-2 thr c / det) by
// sqrt(-2 thr a / det).  The pads make the box hold every pixel that the
// rounded power_of keeps: thr is lowered by 1e-3 + 1e-4 |thr| (power_of's
// error is below 1e-5 |thr| there while b^2 <= 0.9 ac, since
// |b dx dy| <= rho (a dx^2 + c dy^2) / 2 with rho^2 = b^2 / ac), the box
// grows by 0.1% + 0.01 px.  +inf (never cull) where the conic is not that
// far from singular; -inf (always cull) where op is 0 or too small for any
// pixel to reach alpha_floor.
__device__ __forceinline__ float2 cull_extent(float ca, float cb, float cc,
                                              float op, float power_floor,
                                              float alpha_floor) {
  const float inf = __int_as_float(0x7f800000);
  if (op == 0.f) return make_float2(-inf, -inf);
  float thr = fmaxf(power_floor, logf(alpha_floor / op));
  thr -= 1e-3f + 1e-4f * fabsf(thr);
  if (thr >= 0.f) return make_float2(-inf, -inf);
  const float det = ca * cc - cb * cb;
  if (!(ca > 0.f && cc > 0.f && det > 0.1f * ca * cc)) return make_float2(inf, inf);
  const float r = -2.f * thr;
  return make_float2(sqrtf(r * cc / det) * 1.001f + 0.01f,
                     sqrtf(r * ca / det) * 1.001f + 0.01f);
}

// The bf16 payload mode: float32 x rounded to bf16 (round to nearest, ties
// to even) in integer arithmetic on its bits, as ops/packing.py and the JAX
// package round, so the plain version and the kernels agree bit for bit.
__device__ __forceinline__ unsigned rne_bits(float x) {
  const unsigned u = __float_as_uint(x);
  return (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
}
__device__ __forceinline__ float round_bf16(float x) { return __uint_as_float(rne_bits(x)); }
// bf16(a) << 16 | bf16(b) in a float32-typed word, and its inverse
__device__ __forceinline__ float pack2(float a, float b) {
  return __uint_as_float(rne_bits(a) | (rne_bits(b) >> 16));
}
__device__ __forceinline__ float2 unpack2(float p) {
  const unsigned u = __float_as_uint(p);
  return make_float2(__uint_as_float(u & 0xffff0000u), __uint_as_float(u << 16));
}

// Payload layouts of the table (kPack): 0, float32 rows gid, sx, sy, conic
// a, b, c, opacity, r, g, b; 1, packed rows gid, sx, sy, (a, b), (c, op),
// (r, g), (b, 0); 2, packed with tile-relative positions, gid, (mx, my),
// (a, b), (c, op), (r, g), (b, 0) (ops/pairs.py, pallas_blend.py:504-542).
//
// Stages lanes [0, nv) of the window starting at table column src; lanes
// [nv, block) are never read.  Coalesced along each table row.  A packed
// lane is unpacked here, and its degenerate-conic test and cull box are
// taken on the unpacked values.
template <int kPack = 0>
__device__ __forceinline__ void stage_lanes(Lane* lanes, const float* table,
                                            long long ep, long long src, int nv,
                                            float tcx, float tcy,
                                            float power_floor,
                                            float alpha_floor) {
  for (int t = threadIdx.x; t < nv; t += blockDim.x) {
    const float* col = table + src + t;
    float mx, my, ca, cb, cc, op_raw, r, g, bl;
    if (kPack == 0) {
      mx = __fsub_rn(col[ep], tcx);
      my = __fsub_rn(col[2 * ep], tcy);
      ca = col[3 * ep], cb = col[4 * ep], cc = col[5 * ep], op_raw = col[6 * ep];
      r = col[7 * ep], g = col[8 * ep], bl = col[9 * ep];
    } else {
      const int d = kPack == 2 ? 2 : 3;  // first packed data row
      if (kPack == 2) {
        const float2 m = unpack2(col[ep]);
        mx = m.x, my = m.y;
      } else {
        mx = __fsub_rn(col[ep], tcx);
        my = __fsub_rn(col[2 * ep], tcy);
      }
      const float2 ab = unpack2(col[d * ep]), cop = unpack2(col[(d + 1) * ep]);
      const float2 rg = unpack2(col[(d + 2) * ep]), b0 = unpack2(col[(d + 3) * ep]);
      ca = ab.x, cb = ab.y, cc = cop.x, op_raw = cop.y;
      r = rg.x, g = rg.y, bl = b0.x;
    }
    const float mag = __fadd_rn(__fadd_rn(fabsf(ca), fabsf(cb)), fabsf(cc));
    const float op = mag >= 1e-4f ? op_raw : 0.f;
    const float2 ext = cull_extent(ca, cb, cc, op, power_floor, alpha_floor);
    lanes[t].q0 = make_float4(mx, my, ext.x, ext.y);
    lanes[t].q1 = make_float4(ca, cb, cc, op);
    lanes[t].q2 = make_float4(r, g, bl, 0.f);
  }
}

// The thread's column strip: x, its first row y0 and the pixel offsets
// from the tile centre.
template <int P>
struct Strip {
  int x, y0;
  float px, py[P];
  __device__ __forceinline__ bool on(int j, int ts) const { return y0 + j < ts; }
};

template <int P>
__device__ __forceinline__ Strip<P> thread_strip(int ts, float half) {
  Strip<P> s;
  const int rows = (ts + P - 1) / P;
  const bool any = (int)threadIdx.x < ts * rows;
  s.x = any ? (int)threadIdx.x % ts : 0;
  s.y0 = any ? (int)threadIdx.x / ts * P : ts;  // no pixel: every on() false
  s.px = __fsub_rn((float)s.x + 0.5f, half);
#pragma unroll
  for (int j = 0; j < P; ++j) s.py[j] = __fsub_rn((float)(s.y0 + j) + 0.5f, half);
  return s;
}

// The warp's pixel rectangle as (centre x, centre y, half width, half
// height) in tile-centred offsets; a warp without pixels gets -inf half
// sizes, so the cull skips every lane for it.  Every thread of the warp
// must call it.
template <int P>
__device__ __forceinline__ float4 warp_rect(const Strip<P>& s, int ts, float half) {
  const bool any = s.y0 < ts;
  const int ylast = min(s.y0 + P, ts) - 1;
  const int xmin = __reduce_min_sync(kFullMask, any ? s.x : INT_MAX);
  const int xmax = __reduce_max_sync(kFullMask, any ? s.x : INT_MIN);
  const int ymin = __reduce_min_sync(kFullMask, any ? s.y0 : INT_MAX);
  const int ymax = __reduce_max_sync(kFullMask, any ? ylast : INT_MIN);
  if (xmin > xmax) {
    const float ninf = -__int_as_float(0x7f800000);
    return make_float4(0.f, 0.f, ninf, ninf);
  }
  return make_float4(0.5f * (float)(xmin + xmax) + 0.5f - half,
                     0.5f * (float)(ymin + ymax) + 0.5f - half,
                     0.5f * (float)(xmax - xmin), 0.5f * (float)(ymax - ymin));
}

// True when the lane's box misses the warp's rectangle (uniform across the
// warp, so a `continue` on it does not diverge).
__device__ __forceinline__ bool culled(const float4& rect, const float4& q0) {
  return !(fabsf(rect.x - q0.x) <= rect.z + q0.z &&
           fabsf(rect.y - q0.y) <= rect.w + q0.w);
}

}  // namespace blend
