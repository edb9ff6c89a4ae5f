// Projection of 2D Gaussian surfels, forward and backward, for Hopper
// (sm_90a): each surfel's parameter fields into the row the depth presort
// carries, and the row's cotangent back into the fields' gradients.
//
// Replaces no Pallas kernel: the JAX package has no surfel.  Python
// wrappers and the plain PyTorch version: gaussiansplatting_tpu_torch/ops/
// surfel_projection.py (project_fwd, project_bwd, rows_plain; the contract
// is documented there); the autograd Function: ops/surfel_projection.py
// _Project.
//
// One thread a surfel, both ways, as csrc/projection.cu does for the 3D
// Gaussian (whose constants and helpers it shares: projection_common.cuh):
// a row needs nothing of any other, so a thread reads its fields once,
// keeps every intermediate in registers and writes its outputs once; the
// backward recomputes the forward from the same fields and writes exactly
// 0 on every row the forward culled.  No atomics: a second launch
// gives the same bits.  Rows go through shared memory so a warp's stores
// of the [N, 22] rows are one contiguous run.
//
// The row: T = W H, 3x3 (W world to (x w, y w, w) in pixels, H the disc's
// (s_u t_u, s_v t_v, p) columns), the opacity, the colour, and the normal
// t_w in camera space turned to face the camera; the tile rectangle from
// the bounding box of the image of the disc of radius r (r^2 = -2
// power_floor), its dual conic D = T diag(r^2, r^2, -1) T^T (culled where
// D22 >= 0: the disc reaches the camera plane), joined with the low-pass
// disc of radius sqrt(-power_floor) around the projected centre.
//
// What bounds it on the H100: HBM.  The forward reads 53 bytes a row
// (means, two log-scales, quaternion, raw opacity, alive, colour; 8 more
// with vs_dummy) and writes 92 (the [N, 22] row and the depth key); the
// backward reads the 53 and the row's cotangent (64 of it read) and
// writes 52.  ~250 float32 operations a row forward, ~300 backward.
//
// No kernel name here may hold "blend_fwd_win" or "blend_bwd_win": the
// benchmark's blend rooflines match those substrings.

#include <cuda_runtime.h>

#include "projection_common.cuh"

namespace {

constexpr int kRow = 22;          // floats in a presort row

struct Consts {
  float z_cull, ndc_cull, max_log_scale, power_floor, max_radius, raw_opacity_clamp,
      pair_min_opacity;
  int max_tiles, width, height, tile_size, tiles_x, tiles_y;
};

// The camera: view rows 0-2, and W's rows (x w, y w, w) in pixels.
struct Cam {
  float v[12], W[12];
};

struct In {
  float m[3], ls[2], q[4], r;
  bool alive;
};

struct Geo {
  bool ok, emit, qok, facing;
  float vx, vy, vz, s[2], nq, qn[4], R[9];
  float T[9];      // row-major, without vs
  float n[3];      // camera-space normal, facing the camera
  float opacity, e;
  int tmin_x, tmin_y, tmax_x, tmax_y, span;
};

// Not inlined: the forward and the backward kernel call this one compiled
// body, so both round every cull and facing test alike.  Inlined into each,
// the compiler fused their products into FMAs differently, and a disc at a
// cull's boundary was kept by one kernel and culled by the other (a kept
// row with no gradient, a culled row with one: 3 rows of the garden's 5.8M
// at 1297x840).
__device__ __noinline__ Geo geometry(const In& in, const float* vs, const Cam& cam,
                                        const float* vp3, const Consts& k) {
  Geo g;
  bool ok = in.alive;
  for (int j = 0; j < 3; ++j) ok = ok && finitef(in.m[j]) && fabsf(in.m[j]) <= kMaxCoord;
  ok = ok && finitef(in.ls[0]) && finitef(in.ls[1]);
  const float* m = in.m;
  g.vx = cam.v[0] * m[0] + cam.v[1] * m[1] + cam.v[2] * m[2] + cam.v[3];
  g.vy = cam.v[4] * m[0] + cam.v[5] * m[1] + cam.v[6] * m[2] + cam.v[7];
  g.vz = cam.v[8] * m[0] + cam.v[9] * m[1] + cam.v[10] * m[2] + cam.v[11];
  // clip x, y from viewproj's rows 0 and 1 (vp3), w from row 3
  const float cx = vp3[0] * m[0] + vp3[1] * m[1] + vp3[2] * m[2] + vp3[3];
  const float cy = vp3[4] * m[0] + vp3[5] * m[1] + vp3[6] * m[2] + vp3[7];
  const float w = vp3[8] * m[0] + vp3[9] * m[1] + vp3[10] * m[2] + vp3[11];
  ok = ok && w > k.z_cull && g.vz > k.z_cull;
  const float sw = ok ? w : 1.0f;
  ok = ok && fabsf(cx / sw) <= k.ndc_cull && fabsf(cy / sw) <= k.ndc_cull;

  for (int j = 0; j < 2; ++j) g.s[j] = expf(clampf(in.ls[j], -k.max_log_scale, k.max_log_scale));
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

  // T = W H: column 0 W tu, column 1 W tv, column 2 W (p, 1)
  float tu[3], tv[3];
  for (int j = 0; j < 3; ++j) {
    tu[j] = g.R[3 * j] * g.s[0];
    tv[j] = g.R[3 * j + 1] * g.s[1];
  }
  for (int i = 0; i < 3; ++i) {
    const float* Wi = cam.W + 4 * i;
    g.T[3 * i] = Wi[0] * tu[0] + Wi[1] * tu[1] + Wi[2] * tu[2];
    g.T[3 * i + 1] = Wi[0] * tv[0] + Wi[1] * tv[1] + Wi[2] * tv[2];
    g.T[3 * i + 2] = Wi[0] * m[0] + Wi[1] * m[1] + Wi[2] * m[2] + Wi[3];
  }
  float Tv[9];  // with vs: a screen-space shift of the surfel
  for (int j = 0; j < 9; ++j) Tv[j] = g.T[j];
  if (vs) {
    for (int j = 0; j < 3; ++j) {
      Tv[j] += vs[0] * g.T[6 + j];
      Tv[3 + j] += vs[1] * g.T[6 + j];
    }
  }
  // the dual conic of the disc of radius r
  const float r2 = -2.0f * k.power_floor;
  const float* t2 = Tv + 6;
  const float d22 = r2 * (t2[0] * t2[0] + t2[1] * t2[1]) - t2[2] * t2[2];
  ok = ok && d22 < 0.0f;
  const float sd22 = ok ? d22 : -1.0f;
  const float t22 = ok ? t2[2] : 1.0f;
  const float lp = sqrtf(-k.power_floor);
  float lo[2], hi[2];
  for (int i = 0; i < 2; ++i) {
    const float* ti = Tv + 3 * i;
    const float cen = (r2 * (ti[0] * t2[0] + ti[1] * t2[1]) - ti[2] * t2[2]) / sd22;
    const float dii = r2 * (ti[0] * ti[0] + ti[1] * ti[1]) - ti[2] * ti[2];
    const float ext = sqrtf(fmaxf(cen * cen - dii / sd22, 1e-4f));
    const float c = ti[2] / t22;
    lo[i] = fmaxf(fminf(cen - ext, c - lp), c - k.max_radius);
    hi[i] = fminf(fmaxf(cen + ext, c + lp), c + k.max_radius);
  }
  const int min_x = max(__float2int_rz(lo[0]), 0);
  const int min_y = max(__float2int_rz(lo[1]), 0);
  const int max_x = min(__float2int_rz(hi[0]), k.width - 1);
  const int max_y = min(__float2int_rz(hi[1]), k.height - 1);
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

  // t_w = R's column 2 in camera space, turned to face the camera
  float nc[3];
  for (int i = 0; i < 3; ++i)
    nc[i] = cam.v[4 * i] * g.R[2] + cam.v[4 * i + 1] * g.R[5] + cam.v[4 * i + 2] * g.R[8];
  g.facing = nc[0] * g.vx + nc[1] * g.vy + nc[2] * g.vz < 0.0f;
  for (int i = 0; i < 3; ++i) g.n[i] = g.facing ? nc[i] : -nc[i];
  for (int j = 0; j < 9; ++j) g.T[j] = Tv[j];
  return g;
}

__device__ __forceinline__ void fwd_row(const Geo& g, const float* col, float* row) {
  const bool ok = g.ok;
  row[0] = ok ? g.vz : 0.0f;
  row[1] = ok ? (float)g.tmin_x : 0.0f;
  row[2] = ok ? (float)g.tmin_y : 0.0f;
  row[3] = ok ? (float)g.tmax_x : 0.0f;
  row[4] = ok ? (float)g.tmax_y : 0.0f;
  row[5] = g.emit ? (float)g.span : 0.0f;
  for (int j = 0; j < 9; ++j) row[6 + j] = ok ? g.T[j] : 0.0f;
  row[15] = ok ? g.opacity : 0.0f;
  for (int j = 0; j < 3; ++j) row[16 + j] = clampf(ok ? col[j] : 0.0f, 0.0f, 1.0f);
  for (int j = 0; j < 3; ++j) row[19 + j] = ok ? g.n[j] : 0.0f;
}

struct Grad {
  float m[3], ls[2], q[4], r, col[3];
};

// Autograd's vector-Jacobian product of rows_plain for one row, given the
// cotangent gr of its sixteen data columns (cols 6-21); 0 where culled.
__device__ __forceinline__ Grad bwd_row(const In& in, const Geo& g, const Cam& cam,
                                        const Consts& k, const float* col, const float* gr) {
  Grad d;
  for (int j = 0; j < 3; ++j) d.m[j] = d.col[j] = 0.0f;
  d.ls[0] = d.ls[1] = 0.0f;
  for (int j = 0; j < 4; ++j) d.q[j] = 0.0f;
  d.r = 0.0f;
  if (!g.ok) return d;
  for (int j = 0; j < 3; ++j) {
    const float c = clampf(col[j], 0.0f, 1.0f);
    d.col[j] = (c > kDeadLo && c < kDeadHi) ? gr[10 + j] : 0.0f;
  }
  const float roc = k.raw_opacity_clamp;
  d.r = (in.r >= -roc && in.r <= roc) ? gr[9] * g.opacity * g.opacity * g.e : 0.0f;

  // T[i][c] = W_i . col_c: the columns' cotangents
  float dtu[3], dtv[3];
  for (int j = 0; j < 3; ++j) {
    dtu[j] = gr[0] * cam.W[j] + gr[3] * cam.W[4 + j] + gr[6] * cam.W[8 + j];
    dtv[j] = gr[1] * cam.W[j] + gr[4] * cam.W[4 + j] + gr[7] * cam.W[8 + j];
    d.m[j] = gr[2] * cam.W[j] + gr[5] * cam.W[4 + j] + gr[8] * cam.W[8 + j];
  }
  float dR[9];
  float ds0 = 0.0f, ds1 = 0.0f;
  for (int j = 0; j < 3; ++j) {
    dR[3 * j] = dtu[j] * g.s[0];
    dR[3 * j + 1] = dtv[j] * g.s[1];
    ds0 += dtu[j] * g.R[3 * j];
    ds1 += dtv[j] * g.R[3 * j + 1];
  }
  // n = +-V R[:, 2]: dR[:, 2] = +-V^T dn
  const float sg = g.facing ? 1.0f : -1.0f;
  for (int j = 0; j < 3; ++j)
    dR[3 * j + 2] = sg * (cam.v[j] * gr[13] + cam.v[4 + j] * gr[14] + cam.v[8 + j] * gr[15]);
  const float mls = k.max_log_scale;
  d.ls[0] = (in.ls[0] >= -mls && in.ls[0] <= mls) ? ds0 * g.s[0] : 0.0f;
  d.ls[1] = (in.ls[1] >= -mls && in.ls[1] <= mls) ? ds1 * g.s[1] : 0.0f;

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

// view rows 0-2 into cam.v, W's rows from viewproj; vp3 gets viewproj's
// rows 0, 1 and 3 (the clip coordinates the culls read)
__device__ __forceinline__ Cam load_cam(const float* __restrict__ view,
                                        const float* __restrict__ viewproj, const Consts& k,
                                        float* vp3) {
  Cam cam;
  for (int j = 0; j < 12; ++j) cam.v[j] = __ldg(view + j);
  for (int j = 0; j < 4; ++j) {
    const float r0 = __ldg(viewproj + j), r1 = __ldg(viewproj + 4 + j);
    const float r3 = __ldg(viewproj + 12 + j);
    vp3[j] = r0;
    vp3[4 + j] = r1;
    vp3[8 + j] = r3;
    cam.W[j] = 0.5f * (float)k.width * (r0 + r3);
    cam.W[4 + j] = 0.5f * (float)k.height * (r1 + r3);
    cam.W[8 + j] = r3;
  }
  return cam;
}

__device__ __forceinline__ In load_in(int i, const float* __restrict__ means,
                                      const float* __restrict__ log_scales,
                                      const float* __restrict__ quats,
                                      const float* __restrict__ raw_op,
                                      const unsigned char* __restrict__ alive) {
  In in;
  for (int j = 0; j < 3; ++j) in.m[j] = means[3 * (size_t)i + j];
  in.ls[0] = log_scales[2 * (size_t)i];
  in.ls[1] = log_scales[2 * (size_t)i + 1];
  const float4 q = reinterpret_cast<const float4*>(quats)[i];
  in.q[0] = q.x;
  in.q[1] = q.y;
  in.q[2] = q.z;
  in.q[3] = q.w;
  in.r = raw_op[i];
  in.alive = alive[i] != 0;
  return in;
}

__global__ void __launch_bounds__(kThreads) surfel_project_fwd_kernel(
    const float* __restrict__ means, const float* __restrict__ log_scales,
    const float* __restrict__ quats, const float* __restrict__ raw_op,
    const unsigned char* __restrict__ alive, const float* __restrict__ color,
    const float* __restrict__ vs, const float* __restrict__ view,
    const float* __restrict__ viewproj, int n, Consts k, float* __restrict__ rows,
    float* __restrict__ depth) {
  __shared__ float stage[kThreads * kRow];
  const int i0 = blockIdx.x * kThreads;
  const int i = i0 + threadIdx.x;
  if (i < n) {
    float vp3[12];
    const Cam cam = load_cam(view, viewproj, k, vp3);
    const In in = load_in(i, means, log_scales, quats, raw_op, alive);
    const Geo g = geometry(in, vs ? vs + 2 * (size_t)i : nullptr, cam, vp3, k);
    float col[3], row[kRow];
    for (int j = 0; j < 3; ++j) col[j] = color[3 * (size_t)i + j];
    fwd_row(g, col, row);
    for (int j = 0; j < kRow; ++j) stage[threadIdx.x * kRow + j] = row[j];
    depth[i] = row[0];
  }
  __syncthreads();
  const int count = min(kThreads, n - i0) * kRow;
  float* out = rows + (size_t)i0 * kRow;
  for (int j = threadIdx.x; j < count; j += kThreads) out[j] = stage[j];
}

__global__ void __launch_bounds__(kThreads) surfel_project_bwd_kernel(
    const float* __restrict__ g_rows, const float* __restrict__ means,
    const float* __restrict__ log_scales, const float* __restrict__ quats,
    const float* __restrict__ raw_op, const unsigned char* __restrict__ alive,
    const float* __restrict__ color, const float* __restrict__ view,
    const float* __restrict__ viewproj, int n, Consts k, float* __restrict__ d_means,
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
  float vp3[12];
  const Cam cam = load_cam(view, viewproj, k, vp3);
  const In in = load_in(i, means, log_scales, quats, raw_op, alive);
  const Geo g = geometry(in, nullptr, cam, vp3, k);
  float col[3], gr[16];
  for (int j = 0; j < 3; ++j) col[j] = color[3 * (size_t)i + j];
  for (int j = 0; j < 16; ++j) gr[j] = stage[threadIdx.x * kRow + 6 + j];
  const Grad d = bwd_row(in, g, cam, k, col, gr);
  for (int j = 0; j < 3; ++j) {
    d_means[3 * (size_t)i + j] = d.m[j];
    d_color[3 * (size_t)i + j] = d.col[j];
  }
  d_log_scales[2 * (size_t)i] = d.ls[0];
  d_log_scales[2 * (size_t)i + 1] = d.ls[1];
  reinterpret_cast<float4*>(d_quats)[i] = make_float4(d.q[0], d.q[1], d.q[2], d.q[3]);
  d_raw_op[i] = d.r;
}

Consts make_consts(int width, int height, int tile_size, int tiles_x, int tiles_y,
                   int max_tiles, float z_cull, float ndc_cull, float max_log_scale,
                   float power_floor, float max_radius, float raw_opacity_clamp,
                   float pair_min_opacity) {
  Consts k;
  k.z_cull = z_cull;
  k.ndc_cull = ndc_cull;
  k.max_log_scale = max_log_scale;
  k.power_floor = power_floor;
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

// rows [N, 22] and depth [N] from the fields (vs null: no vs_dummy).
extern "C" int gs_surfel_project_fwd(const float* means, const float* log_scales,
                                     const float* quats, const float* raw_op,
                                     const unsigned char* alive, const float* color,
                                     const float* vs, const float* view, const float* viewproj,
                                     int n, int width, int height, int tile_size, int tiles_x,
                                     int tiles_y, int max_tiles, float z_cull, float ndc_cull,
                                     float max_log_scale, float power_floor, float max_radius,
                                     float raw_opacity_clamp, float pair_min_opacity,
                                     float* rows, float* depth, void* stream) {
  if (n <= 0) return 0;
  const Consts k = make_consts(width, height, tile_size, tiles_x, tiles_y, max_tiles, z_cull,
                               ndc_cull, max_log_scale, power_floor, max_radius,
                               raw_opacity_clamp, pair_min_opacity);
  const int blocks = (n + kThreads - 1) / kThreads;
  surfel_project_fwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      means, log_scales, quats, raw_op, alive, color, vs, view, viewproj, n, k, rows, depth);
  return (int)cudaGetLastError();
}

// The fields' gradients from the rows' cotangent g_rows [N, 22] (cols 6-21
// read).
extern "C" int gs_surfel_project_bwd(const float* g_rows, const float* means,
                                     const float* log_scales, const float* quats,
                                     const float* raw_op, const unsigned char* alive,
                                     const float* color, const float* view,
                                     const float* viewproj, int n, int width, int height,
                                     int tile_size, int tiles_x, int tiles_y, int max_tiles,
                                     float z_cull, float ndc_cull, float max_log_scale,
                                     float power_floor, float max_radius,
                                     float raw_opacity_clamp, float pair_min_opacity,
                                     float* d_means, float* d_log_scales, float* d_quats,
                                     float* d_raw_op, float* d_color, void* stream) {
  if (n <= 0) return 0;
  const Consts k = make_consts(width, height, tile_size, tiles_x, tiles_y, max_tiles, z_cull,
                               ndc_cull, max_log_scale, power_floor, max_radius,
                               raw_opacity_clamp, pair_min_opacity);
  const int blocks = (n + kThreads - 1) / kThreads;
  surfel_project_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      g_rows, means, log_scales, quats, raw_op, alive, color, view, viewproj, n, k, d_means,
      d_log_scales, d_quats, d_raw_op, d_color);
  return (int)cudaGetLastError();
}
