// Projection, forward and backward, for Hopper (sm_90a): each Gaussian's
// parameter fields into the row the depth presort carries, and the row's
// cotangent back into the fields' gradients.
//
// Replaces no Pallas kernel: the JAX package leaves projection to XLA
// (gaussiansplatting_tpu/ops/projection.py project, core/transforms.py).
// The port ran the same ops eagerly until this file: two [N, 4] x [4, 4]
// GEMMs, a batched 3x3 M @ M^T, two batched einsums, some 60 elementwise
// passes and two torch.cat's, each saving an intermediate for autograd and
// run again backwards.  Python wrappers and the plain PyTorch version:
// gaussiansplatting_tpu_torch/ops/projection.py (project_fwd, project_bwd,
// rows_plain; the contract is documented there); the autograd Function:
// ops/projection._Project.
//
// One thread a Gaussian, both ways.  A row needs nothing from any other row
// (9-16 FMAs a matrix entry, no reduction across Gaussians), so a thread
// reads its Gaussian's fields once, keeps every intermediate in registers
// and writes its outputs once; nothing lies in device memory between the
// parameter fields and the presort's row.  The backward recomputes the
// forward's intermediates from the same fields (cheaper than saving ~60
// floats a row and reading them back) and writes exactly 0 on every row
// the forward culled.  No atomics, one order of operations a thread: a
// second launch gives the same bits.
//
// What bounds it on the H100: HBM.  The forward reads 57 bytes a row
// (means, log-scales, quaternion, raw opacity, alive, colour; 8 more with
// vs_dummy) and writes 64 (the [N, 15] row and the [N] depth key): ~182 MB
// at 1.5M rows, 0.054 ms at 3.35 TB/s; the backward reads the 57 bytes and
// the row's cotangent (60) and writes 56 of gradients.  The arithmetic,
// ~300 float32 operations a row forward and ~600 backward, is ~10x below
// the H100's float32 rate at those bytes.  The row is 15 floats, so a
// warp's stores of one column are 60 bytes apart; the block stages its
// rows (and, backward, the cotangent's) in shared memory and moves them as
// one contiguous run (stride 15 is odd: no bank conflicts).
//
// Precision.  Sigma3D enters only through the 2x3 product P = J W M (M =
// R diag(scale), J W the clamped EWA Jacobian with the view rotation), so
// cov2D = P P^T + lowpass I: a = |p0|^2 + lp, b = p0.p1, c = |p1|^2 + lp,
// and its determinant by Lagrange's identity, |p0 x p1|^2 + lp (|p0|^2 +
// |p1|^2) + lp^2, with the matching cross products in its gradient.  The
// plain form's a c - b b of a thin splat (axis ratio up to 20, so cov2D's
// condition up to ~400) cancels: float32 loses ~cond ulps of det there, and
// the conic and its gradient with it (2.8e-5 and 5e-5 relative norm against
// float64 on such a scene, where this form keeps ~sqrt(cond) ulps).  The
// radius takes disc = ((a - c) / 2)^2 + b^2, the same quantity as the plain
// form's mid^2 - det without its cancellation.  Every cull test, clamp and
// bound is the plain form's, in its order, with RasterConfig's constants.
//
// No kernel name here may hold "blend_fwd_win" or "blend_bwd_win": the
// benchmark's blend rooflines match those substrings.

#include <cuda_runtime.h>

#include "projection_common.cuh"

namespace {

constexpr int kRow = 15;          // floats in a presort row
constexpr float kDiscFloor = 0.1f;

// RasterConfig's constants and the image's tile grid, by value.
struct Consts {
  float z_cull, ndc_cull, max_log_scale, aspect_clamp, jacobian_clamp, lowpass,
      min_det, max_radius, raw_opacity_clamp, pair_min_opacity;
  int max_tiles, width, height, tile_size, tiles_x, tiles_y;
};

// The camera: view rows 0-2, viewproj rows 0, 1 and 3, the focal lengths.
struct Cam {
  float v[12], p[12], fx, fy;
};

// One Gaussian's parameter fields.
struct In {
  float m[3], ls[3], q[4], r;
  bool alive;
};

// Everything the forward computes of a row, kept for the backward.
struct Geo {
  bool ok, emit, clamped, qok;
  float vx, vy, vz, w, ndc0, ndc1, sx, sy;
  float s[3], maxs, mins, factor, sc[3];
  float nq, qn[4], R[9], M[9];
  float z, limx, limy, ux, uy, j00, j02, j11, j12;
  float t0[3], t1[3], p0[3], p1[3], x[3];  // x = p0 x p1
  float a, b, c, det, inv, radius, opacity, e;
  int tmin_x, tmin_y, tmax_x, tmax_y, span;
};

__device__ __forceinline__ float dot3(const float* u, const float* v) {
  return u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
}

__device__ __forceinline__ void cross3(const float* u, const float* v, float* out) {
  out[0] = u[1] * v[2] - u[2] * v[1];
  out[1] = u[2] * v[0] - u[0] * v[2];
  out[2] = u[0] * v[1] - u[1] * v[0];
}

// ops/projection.project for one Gaussian, in its order.
__device__ __forceinline__ Geo geometry(const In& in, const Cam& cam, const Consts& k) {
  Geo g;
  bool ok = in.alive;
  for (int j = 0; j < 3; ++j)
    ok = ok && finitef(in.m[j]) && finitef(in.ls[j]) && fabsf(in.m[j]) <= kMaxCoord;

  const float* m = in.m;
  g.vx = cam.v[0] * m[0] + cam.v[1] * m[1] + cam.v[2] * m[2] + cam.v[3];
  g.vy = cam.v[4] * m[0] + cam.v[5] * m[1] + cam.v[6] * m[2] + cam.v[7];
  g.vz = cam.v[8] * m[0] + cam.v[9] * m[1] + cam.v[10] * m[2] + cam.v[11];
  const float cx = cam.p[0] * m[0] + cam.p[1] * m[1] + cam.p[2] * m[2] + cam.p[3];
  const float cy = cam.p[4] * m[0] + cam.p[5] * m[1] + cam.p[6] * m[2] + cam.p[7];
  g.w = cam.p[8] * m[0] + cam.p[9] * m[1] + cam.p[10] * m[2] + cam.p[11];
  ok = ok && g.w > k.z_cull && g.vz > k.z_cull;
  const float sw = ok ? g.w : 1.0f;
  g.ndc0 = cx / sw;
  g.ndc1 = cy / sw;
  ok = ok && fabsf(g.ndc0) <= k.ndc_cull && fabsf(g.ndc1) <= k.ndc_cull;
  g.sx = (g.ndc0 * 0.5f + 0.5f) * (float)k.width;
  g.sy = (g.ndc1 * 0.5f + 0.5f) * (float)k.height;

  for (int j = 0; j < 3; ++j)
    g.s[j] = expf(clampf(in.ls[j], -k.max_log_scale, k.max_log_scale));
  g.maxs = fmaxf(fmaxf(g.s[0], g.s[1]), g.s[2]);
  g.mins = fminf(fminf(g.s[0], g.s[1]), g.s[2]);
  const float target = k.aspect_clamp * g.mins;
  g.clamped = g.maxs > target;
  g.factor = g.clamped ? target / g.maxs : 1.0f;
  for (int j = 0; j < 3; ++j) g.sc[j] = g.s[j] * g.factor;

  const float* q = in.q;
  g.nq = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  g.qok = g.nq > kQuatEps;
  const float qd = fmaxf(g.nq, kQuatEps);
  for (int j = 0; j < 4; ++j) g.qn[j] = g.qok ? q[j] / qd : (j == 0 ? 1.0f : 0.0f);
  const float qw = g.qn[0], qx = g.qn[1], qy = g.qn[2], qz = g.qn[3];
  g.R[0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  g.R[1] = 2.0f * (qx * qy - qw * qz);
  g.R[2] = 2.0f * (qx * qz + qw * qy);
  g.R[3] = 2.0f * (qx * qy + qw * qz);
  g.R[4] = 1.0f - 2.0f * (qx * qx + qz * qz);
  g.R[5] = 2.0f * (qy * qz - qw * qx);
  g.R[6] = 2.0f * (qx * qz - qw * qy);
  g.R[7] = 2.0f * (qy * qz + qw * qx);
  g.R[8] = 1.0f - 2.0f * (qx * qx + qy * qy);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) g.M[3 * i + j] = g.R[3 * i + j] * g.sc[j];

  // the EWA Jacobian, z guarded by the cull so far
  g.z = ok ? g.vz : 1.0f;
  g.limx = k.jacobian_clamp * cam.fx / g.z;
  g.limy = k.jacobian_clamp * cam.fy / g.z;
  g.ux = g.vx / g.z;
  g.uy = g.vy / g.z;
  const float txtz = clampf(g.ux, -g.limx, g.limx);
  const float tytz = clampf(g.uy, -g.limy, g.limy);
  g.j00 = cam.fx / g.z;
  g.j02 = -cam.fx * txtz / g.z;
  g.j11 = cam.fy / g.z;
  g.j12 = -cam.fy * tytz / g.z;
  for (int j = 0; j < 3; ++j) {
    g.t0[j] = g.j00 * cam.v[j] + g.j02 * cam.v[8 + j];
    g.t1[j] = g.j11 * cam.v[4 + j] + g.j12 * cam.v[8 + j];
  }
  // P = (J W) M, row by row: p[j] = sum_i t[i] M[i][j]
  for (int j = 0; j < 3; ++j) {
    g.p0[j] = g.t0[0] * g.M[j] + g.t0[1] * g.M[3 + j] + g.t0[2] * g.M[6 + j];
    g.p1[j] = g.t1[0] * g.M[j] + g.t1[1] * g.M[3 + j] + g.t1[2] * g.M[6 + j];
  }
  const float pp0 = dot3(g.p0, g.p0), pp1 = dot3(g.p1, g.p1);
  cross3(g.p0, g.p1, g.x);
  const float lp = k.lowpass;
  g.a = pp0 + lp;
  g.b = dot3(g.p0, g.p1);
  g.c = pp1 + lp;
  g.det = dot3(g.x, g.x) + lp * (pp0 + pp1) + lp * lp;
  const bool det_ok = g.det >= k.min_det;
  g.inv = det_ok ? 1.0f / g.det : 0.0f;
  ok = ok && det_ok;

  const float hd = 0.5f * (g.a - g.c);
  const float disc = hd * hd + g.b * g.b;
  const float lam1 = 0.5f * (g.a + g.c) + sqrtf(disc != disc ? disc : fmaxf(disc, kDiscFloor));
  const float r3 = ceilf(3.0f * sqrtf(lam1));
  g.radius = r3 != r3 ? r3 : fminf(r3, k.max_radius);
  ok = ok && g.radius > 0.0f;

  // pixel rect -> tile rect; float -> int truncates toward zero
  const int min_x = max(__float2int_rz(g.sx - g.radius), 0);
  const int min_y = max(__float2int_rz(g.sy - g.radius), 0);
  const int max_x = min(__float2int_rz(g.sx + g.radius), k.width - 1);
  const int max_y = min(__float2int_rz(g.sy + g.radius), k.height - 1);
  ok = ok && min_x <= max_x && min_y <= max_y;
  g.tmin_x = floordiv(min_x, k.tile_size);
  g.tmin_y = floordiv(min_y, k.tile_size);
  g.tmax_x = min(floordiv(max_x, k.tile_size), k.tiles_x - 1);
  g.tmax_y = min(floordiv(max_y, k.tile_size), k.tiles_y - 1);
  g.span = ok ? (g.tmax_x - g.tmin_x + 1) * (g.tmax_y - g.tmin_y + 1) : 0;
  ok = ok && g.span <= k.max_tiles;

  const float xo = clampf(in.r, -k.raw_opacity_clamp, k.raw_opacity_clamp);
  g.e = expf(-xo);
  g.opacity = 1.0f / (1.0f + g.e);
  g.ok = ok;
  g.emit = ok && g.opacity >= k.pair_min_opacity;
  return g;
}

// The presort's row: [depth, tile_min (2), tile_max (2), n_tiles,
// screen_pos + vs (2), conic (3), opacity, dead-zone colour (3)], culled
// rows zeroed but for vs.
__device__ __forceinline__ void fwd_row(const Geo& g, const float* col, const float* vs,
                                        float* row) {
  const bool ok = g.ok;
  row[0] = ok ? g.vz : 0.0f;
  row[1] = ok ? (float)g.tmin_x : 0.0f;
  row[2] = ok ? (float)g.tmin_y : 0.0f;
  row[3] = ok ? (float)g.tmax_x : 0.0f;
  row[4] = ok ? (float)g.tmax_y : 0.0f;
  row[5] = g.emit ? (float)g.span : 0.0f;
  row[6] = ok ? g.sx : 0.0f;
  row[7] = ok ? g.sy : 0.0f;
  if (vs) {
    row[6] += vs[0];
    row[7] += vs[1];
  }
  row[8] = ok ? g.c * g.inv : 0.0f;
  row[9] = ok ? -g.b * g.inv : 0.0f;
  row[10] = ok ? g.a * g.inv : 0.0f;
  row[11] = ok ? g.opacity : 0.0f;
  for (int j = 0; j < 3; ++j) row[12 + j] = clampf(ok ? col[j] : 0.0f, 0.0f, 1.0f);
}

// The gradients of one row.
struct Grad {
  float m[3], ls[3], q[4], r, col[3];
};

// Autograd's vector-Jacobian product of rows_plain for one row, given the
// cotangent gr of its nine data columns (cols 6-14); all 0 where culled.
__device__ __forceinline__ Grad bwd_row(const In& in, const Geo& g, const Cam& cam,
                                        const Consts& k, const float* col, const float* gr) {
  Grad d;
  for (int j = 0; j < 3; ++j) d.m[j] = d.ls[j] = d.col[j] = 0.0f;
  for (int j = 0; j < 4; ++j) d.q[j] = 0.0f;
  d.r = 0.0f;
  if (!g.ok) return d;

  // the dead zone: clamp(colour, 0, 1) passes no gradient outside (0.01, 0.99)
  for (int j = 0; j < 3; ++j) {
    const float c = clampf(col[j], 0.0f, 1.0f);
    d.col[j] = (c > kDeadLo && c < kDeadHi) ? gr[6 + j] : 0.0f;
  }
  // sigmoid(clamp(r)) = 1 / (1 + exp(-x)): dx = g o^2 exp(-x)
  const float roc = k.raw_opacity_clamp;
  d.r = (in.r >= -roc && in.r <= roc) ? gr[5] * g.opacity * g.opacity * g.e : 0.0f;

  // the conic (c, -b, a) / det
  const float da = gr[4] * g.inv, db = -gr[3] * g.inv, dc = gr[2] * g.inv;
  const float ddet = -(gr[2] * g.c - gr[3] * g.b + gr[4] * g.a) * g.inv * g.inv;
  // a, b, c and det of P's rows: d det / d p0 = 2 (p1 x (p0 x p1) + lp p0),
  // d det / d p1 = 2 ((p0 x p1) x p0 + lp p1)
  float u[3], v[3], dp0[3], dp1[3];
  cross3(g.p1, g.x, u);
  cross3(g.x, g.p0, v);
  const float lp = k.lowpass;
  for (int j = 0; j < 3; ++j) {
    dp0[j] = 2.0f * da * g.p0[j] + db * g.p1[j] + 2.0f * ddet * (u[j] + lp * g.p0[j]);
    dp1[j] = 2.0f * dc * g.p1[j] + db * g.p0[j] + 2.0f * ddet * (v[j] + lp * g.p1[j]);
  }
  // p = t M: dM[i][j] = t0[i] dp0[j] + t1[i] dp1[j], dt[i] = sum_j M[i][j] dp[j]
  float dM[9], dt0[3], dt1[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) dM[3 * i + j] = g.t0[i] * dp0[j] + g.t1[i] * dp1[j];
    dt0[i] = dot3(g.M + 3 * i, dp0);
    dt1[i] = dot3(g.M + 3 * i, dp1);
  }

  // the Jacobian: t0 = j00 W0 + j02 W2, t1 = j11 W1 + j12 W2
  const float dj00 = dot3(dt0, cam.v), dj02 = dot3(dt0, cam.v + 8);
  const float dj11 = dot3(dt1, cam.v + 4), dj12 = dot3(dt1, cam.v + 8);
  float dz = -(dj00 * g.j00 + dj11 * g.j11 + dj02 * g.j02 + dj12 * g.j12) / g.z;
  const float dtx = dj02 * -cam.fx / g.z, dty = dj12 * -cam.fy / g.z;
  // torch.clamp(u, -lim, lim)'s backward: u inside [-lim, lim] (inclusive)
  // takes it, the bound that binds otherwise, and lim = jc f / z carries it
  // into z
  const float dux = (g.ux >= -g.limx && g.ux <= g.limx) ? dtx : 0.0f;
  const float duy = (g.uy >= -g.limy && g.uy <= g.limy) ? dty : 0.0f;
  const float dlimx = ((g.ux > g.limx || g.limx < -g.limx) ? dtx : 0.0f) -
                      ((g.ux < -g.limx && -g.limx < g.limx) ? dtx : 0.0f);
  const float dlimy = ((g.uy > g.limy || g.limy < -g.limy) ? dty : 0.0f) -
                      ((g.uy < -g.limy && -g.limy < g.limy) ? dty : 0.0f);
  const float dvx = dux / g.z, dvy = duy / g.z;
  dz -= (dux * g.ux + duy * g.uy + dlimx * g.limx + dlimy * g.limy) / g.z;

  // the screen position: ndc = clip / w
  const float dn0 = gr[0] * (float)k.width * 0.5f, dn1 = gr[1] * (float)k.height * 0.5f;
  const float dcx = dn0 / g.w, dcy = dn1 / g.w;
  const float dw = -(dn0 * g.ndc0 + dn1 * g.ndc1) / g.w;
  for (int j = 0; j < 3; ++j)
    d.m[j] = cam.v[j] * dvx + cam.v[4 + j] * dvy + cam.v[8 + j] * dz + cam.p[j] * dcx +
             cam.p[4 + j] * dcy + cam.p[8 + j] * dw;

  // M = R diag(sc)
  float dR[9], dsc[3];
  for (int j = 0; j < 3; ++j) {
    dsc[j] = dM[j] * g.R[j] + dM[3 + j] * g.R[3 + j] + dM[6 + j] * g.R[6 + j];
    for (int i = 0; i < 3; ++i) dR[3 * i + j] = dM[3 * i + j] * g.sc[j];
  }
  // the aspect clamp: sc = s factor, factor = aspect min(s) / max(s) where
  // it binds; amax and amin share their gradient equally among ties
  float ds[3];
  const float dfactor = dot3(dsc, g.s);
  for (int j = 0; j < 3; ++j) ds[j] = dsc[j] * g.factor;
  if (g.clamped) {
    const float dmax = -dfactor * g.factor / g.maxs;
    const float dmin = k.aspect_clamp * (dfactor / g.maxs);
    const float nmax = (float)((g.s[0] == g.maxs) + (g.s[1] == g.maxs) + (g.s[2] == g.maxs));
    const float nmin = (float)((g.s[0] == g.mins) + (g.s[1] == g.mins) + (g.s[2] == g.mins));
    for (int j = 0; j < 3; ++j) {
      if (g.s[j] == g.maxs) ds[j] += dmax / nmax;
      if (g.s[j] == g.mins) ds[j] += dmin / nmin;
    }
  }
  const float mls = k.max_log_scale;
  for (int j = 0; j < 3; ++j)
    d.ls[j] = (in.ls[j] >= -mls && in.ls[j] <= mls) ? ds[j] * g.s[j] : 0.0f;

  // R of the unit quaternion (w, x, y, z), then the normalisation
  if (g.qok) {
    const float qw = g.qn[0], qx = g.qn[1], qy = g.qn[2], qz = g.qn[3];
    float dq[4];
    dq[0] = 2.0f * (-qz * dR[1] + qy * dR[2] + qz * dR[3] - qx * dR[5] - qy * dR[6] +
                    qx * dR[7]);
    dq[1] = 2.0f * (qy * dR[1] + qz * dR[2] + qy * dR[3] - qw * dR[5] + qz * dR[6] +
                    qw * dR[7]) - 4.0f * qx * (dR[4] + dR[8]);
    dq[2] = 2.0f * (qx * dR[1] + qw * dR[2] + qx * dR[3] + qz * dR[5] - qw * dR[6] +
                    qz * dR[7]) - 4.0f * qy * (dR[0] + dR[8]);
    dq[3] = 2.0f * (-qw * dR[1] + qx * dR[2] + qw * dR[3] + qy * dR[5] + qx * dR[6] +
                    qy * dR[7]) - 4.0f * qz * (dR[0] + dR[4]);
    const float dqn = dq[0] * qw + dq[1] * qx + dq[2] * qy + dq[3] * qz;
    for (int j = 0; j < 4; ++j) d.q[j] = (dq[j] - g.qn[j] * dqn) / g.nq;
  }
  return d;
}

// -- kernels

__device__ __forceinline__ Cam load_cam(const float* __restrict__ view,
                                        const float* __restrict__ viewproj,
                                        const float* __restrict__ fx,
                                        const float* __restrict__ fy) {
  Cam cam;
  for (int j = 0; j < 12; ++j) cam.v[j] = __ldg(view + j);
  for (int j = 0; j < 8; ++j) cam.p[j] = __ldg(viewproj + j);
  for (int j = 0; j < 4; ++j) cam.p[8 + j] = __ldg(viewproj + 12 + j);
  cam.fx = __ldg(fx);
  cam.fy = __ldg(fy);
  return cam;
}

__device__ __forceinline__ In load_in(int i, const float* __restrict__ means,
                                      const float* __restrict__ log_scales,
                                      const float* __restrict__ quats,
                                      const float* __restrict__ raw_op,
                                      const unsigned char* __restrict__ alive) {
  In in;
  for (int j = 0; j < 3; ++j) {
    in.m[j] = means[3 * (size_t)i + j];
    in.ls[j] = log_scales[3 * (size_t)i + j];
  }
  const float4 q = reinterpret_cast<const float4*>(quats)[i];
  in.q[0] = q.x;
  in.q[1] = q.y;
  in.q[2] = q.z;
  in.q[3] = q.w;
  in.r = raw_op[i];
  in.alive = alive[i] != 0;
  return in;
}

__global__ void __launch_bounds__(kThreads) project_fwd_kernel(
    const float* __restrict__ means, const float* __restrict__ log_scales,
    const float* __restrict__ quats, const float* __restrict__ raw_op,
    const unsigned char* __restrict__ alive, const float* __restrict__ color,
    const float* __restrict__ vs, const float* __restrict__ view,
    const float* __restrict__ viewproj, const float* __restrict__ fx,
    const float* __restrict__ fy, int n, Consts k, float* __restrict__ rows,
    float* __restrict__ depth) {
  __shared__ float stage[kThreads * kRow];
  const int i0 = blockIdx.x * kThreads;
  const int i = i0 + threadIdx.x;
  if (i < n) {
    const Cam cam = load_cam(view, viewproj, fx, fy);
    const In in = load_in(i, means, log_scales, quats, raw_op, alive);
    const Geo g = geometry(in, cam, k);
    float col[3], row[kRow];
    for (int j = 0; j < 3; ++j) col[j] = color[3 * (size_t)i + j];
    fwd_row(g, col, vs ? vs + 2 * (size_t)i : nullptr, row);
    for (int j = 0; j < kRow; ++j) stage[threadIdx.x * kRow + j] = row[j];
    depth[i] = row[0];
  }
  __syncthreads();
  const int count = min(kThreads, n - i0) * kRow;
  float* out = rows + (size_t)i0 * kRow;
  for (int j = threadIdx.x; j < count; j += kThreads) out[j] = stage[j];
}

__global__ void __launch_bounds__(kThreads) project_bwd_kernel(
    const float* __restrict__ g_rows, const float* __restrict__ means,
    const float* __restrict__ log_scales, const float* __restrict__ quats,
    const float* __restrict__ raw_op, const unsigned char* __restrict__ alive,
    const float* __restrict__ color, const float* __restrict__ view,
    const float* __restrict__ viewproj, const float* __restrict__ fx,
    const float* __restrict__ fy, int n, Consts k, float* __restrict__ d_means,
    float* __restrict__ d_log_scales, float* __restrict__ d_quats,
    float* __restrict__ d_raw_op, float* __restrict__ d_color) {
  __shared__ float stage[kThreads * kRow];
  const int i0 = blockIdx.x * kThreads;
  const int count = min(kThreads, n - i0) * kRow;
  const float* src = g_rows + (size_t)i0 * kRow;
  for (int j = threadIdx.x; j < count; j += kThreads) stage[j] = src[j];
  __syncthreads();
  const int i = i0 + threadIdx.x;
  if (i >= n) return;
  const Cam cam = load_cam(view, viewproj, fx, fy);
  const In in = load_in(i, means, log_scales, quats, raw_op, alive);
  const Geo g = geometry(in, cam, k);
  float col[3], gr[9];
  for (int j = 0; j < 3; ++j) col[j] = color[3 * (size_t)i + j];
  for (int j = 0; j < 9; ++j) gr[j] = stage[threadIdx.x * kRow + 6 + j];
  const Grad d = bwd_row(in, g, cam, k, col, gr);
  for (int j = 0; j < 3; ++j) {
    d_means[3 * (size_t)i + j] = d.m[j];
    d_log_scales[3 * (size_t)i + j] = d.ls[j];
    d_color[3 * (size_t)i + j] = d.col[j];
  }
  reinterpret_cast<float4*>(d_quats)[i] = make_float4(d.q[0], d.q[1], d.q[2], d.q[3]);
  d_raw_op[i] = d.r;
}

Consts make_consts(int width, int height, int tile_size, int tiles_x, int tiles_y,
                   int max_tiles, float z_cull, float ndc_cull, float max_log_scale,
                   float aspect_clamp, float jacobian_clamp, float lowpass, float min_det,
                   float max_radius, float raw_opacity_clamp, float pair_min_opacity) {
  Consts k;
  k.z_cull = z_cull;
  k.ndc_cull = ndc_cull;
  k.max_log_scale = max_log_scale;
  k.aspect_clamp = aspect_clamp;
  k.jacobian_clamp = jacobian_clamp;
  k.lowpass = lowpass;
  k.min_det = min_det;
  k.max_radius = max_radius;
  k.raw_opacity_clamp = raw_opacity_clamp;
  k.pair_min_opacity = pair_min_opacity;
  k.max_tiles = max_tiles;
  k.width = width;
  k.height = height;
  k.tile_size = tile_size;
  k.tiles_x = tiles_x;
  k.tiles_y = tiles_y;
  return k;
}

}  // namespace

// rows [N, 15] and depth [N] from the fields (vs null: no vs_dummy).
extern "C" int gs_project_fwd(const float* means, const float* log_scales, const float* quats,
                              const float* raw_op, const unsigned char* alive,
                              const float* color, const float* vs, const float* view,
                              const float* viewproj, const float* fx, const float* fy, int n,
                              int width, int height, int tile_size, int tiles_x, int tiles_y,
                              int max_tiles, float z_cull, float ndc_cull, float max_log_scale,
                              float aspect_clamp, float jacobian_clamp, float lowpass,
                              float min_det, float max_radius, float raw_opacity_clamp,
                              float pair_min_opacity, float* rows, float* depth,
                              void* stream) {
  if (n <= 0) return 0;
  const Consts k = make_consts(width, height, tile_size, tiles_x, tiles_y, max_tiles, z_cull,
                               ndc_cull, max_log_scale, aspect_clamp, jacobian_clamp, lowpass,
                               min_det, max_radius, raw_opacity_clamp, pair_min_opacity);
  const int blocks = (n + kThreads - 1) / kThreads;
  project_fwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      means, log_scales, quats, raw_op, alive, color, vs, view, viewproj, fx, fy, n, k, rows,
      depth);
  return (int)cudaGetLastError();
}

// The fields' gradients from the rows' cotangent g_rows [N, 15] (cols 6-14
// read).
extern "C" int gs_project_bwd(const float* g_rows, const float* means, const float* log_scales,
                              const float* quats, const float* raw_op,
                              const unsigned char* alive, const float* color,
                              const float* view, const float* viewproj, const float* fx,
                              const float* fy, int n, int width, int height, int tile_size,
                              int tiles_x, int tiles_y, int max_tiles, float z_cull,
                              float ndc_cull, float max_log_scale, float aspect_clamp,
                              float jacobian_clamp, float lowpass, float min_det,
                              float max_radius, float raw_opacity_clamp,
                              float pair_min_opacity, float* d_means, float* d_log_scales,
                              float* d_quats, float* d_raw_op, float* d_color, void* stream) {
  if (n <= 0) return 0;
  const Consts k = make_consts(width, height, tile_size, tiles_x, tiles_y, max_tiles, z_cull,
                               ndc_cull, max_log_scale, aspect_clamp, jacobian_clamp, lowpass,
                               min_det, max_radius, raw_opacity_clamp, pair_min_opacity);
  const int blocks = (n + kThreads - 1) / kThreads;
  project_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      g_rows, means, log_scales, quats, raw_op, alive, color, view, viewproj, fx, fy, n, k,
      d_means, d_log_scales, d_quats, d_raw_op, d_color);
  return (int)cudaGetLastError();
}
