"""Differentiable 3DGS math primitives on torch tensors (fully batched).

Counterpart of gaussiansplatting_tpu/core/transforms.py; semantics and
conventions are identical:
  * quaternions are (w, x, y, z), active rotation;
  * matrices are row-major; ``R @ v`` rotates the column vector v;
  * all functions take/return float32 tensors with a leading batch axis.
"""

from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w,x,y,z) -> rotation matrix, [..., 4] -> [..., 3, 3].
    Does NOT normalize; callers normalize first where the reference does."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def normalize_quat(q: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Normalize quaternion; fall back to identity if degenerate
    (length <= eps)."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    identity = torch.zeros_like(q)
    identity[..., 0] = 1.0
    return torch.where(norm > eps, q / torch.clamp(norm, min=eps), identity)


def clamp_scale_aspect(scale: torch.Tensor, max_aspect: float = 20.0) -> torch.Tensor:
    """If max scale > max_aspect * min scale, rescale so max == max_aspect*min."""
    max_s = scale.amax(dim=-1, keepdim=True)
    min_s = scale.amin(dim=-1, keepdim=True)
    target_max = max_aspect * min_s
    factor = torch.where(max_s > target_max, target_max / max_s, 1.0)
    return scale * factor


def covariance_3d(scale: torch.Tensor, q_normed: torch.Tensor) -> torch.Tensor:
    """Sigma3D = M @ M^T with M = R @ diag(scale).  Returns [..., 3, 3]."""
    R = quat_to_rotmat(q_normed)
    M = R * scale[..., None, :]
    return M @ M.transpose(-1, -2)


def ewa_project(
    cov3d: torch.Tensor,
    view_pos: torch.Tensor,
    view_rot: torch.Tensor,
    fx: torch.Tensor,
    fy: torch.Tensor,
    jacobian_clamp: float = 1.3,
    lowpass: float = 0.3,
) -> torch.Tensor:
    """EWA splatting: cov2D = (J W) Sigma3D (J W)^T with the frustum clamps
    on the Jacobian and +lowpass on the diagonal.  Returns [..., 3] packed
    (a, b, c) for [[a, b], [b, c]]."""
    z = view_pos[..., 2]
    limx = jacobian_clamp * fx / z
    limy = jacobian_clamp * fy / z
    txtz = torch.clamp(view_pos[..., 0] / z, -limx, limx)
    tytz = torch.clamp(view_pos[..., 1] / z, -limy, limy)

    j00 = fx / z
    j02 = -fx * txtz / z
    j11 = fy / z
    j12 = -fy * tytz / z

    w0, w1, w2 = view_rot[0], view_rot[1], view_rot[2]
    t_row0 = j00[..., None] * w0 + j02[..., None] * w2  # [..., 3]
    t_row1 = j11[..., None] * w1 + j12[..., None] * w2

    c_r0 = torch.einsum("...i,...ij->...j", t_row0, cov3d)
    c_r1 = torch.einsum("...i,...ij->...j", t_row1, cov3d)
    a = (c_r0 * t_row0).sum(-1) + lowpass
    b = (c_r0 * t_row1).sum(-1)
    c = (c_r1 * t_row1).sum(-1) + lowpass
    return torch.stack([a, b, c], dim=-1)


def conic_from_cov2d(cov2d: torch.Tensor, min_det: float = 1e-4):
    """Invert the 2x2 covariance into a conic.  Returns (conic [..., 3],
    det [...], valid [...]); invalid (det < min_det) conics are zeroed."""
    a, b, c = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = a * c - b * b
    valid = det >= min_det
    inv_det = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    return conic, det, valid


def radius_from_cov2d(cov2d: torch.Tensor, max_radius: float = 512.0) -> torch.Tensor:
    """3-sigma screen radius ceil(3*sqrt(lambda_1)) capped at max_radius."""
    a, b, c = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = a * c - b * b
    mid = 0.5 * (a + c)
    disc = mid * mid - det
    lam1 = mid + torch.sqrt(torch.clamp(disc, min=0.1))
    return torch.clamp(torch.ceil(3.0 * torch.sqrt(lam1)), max=max_radius)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


SH_C0 = 0.28209479177387814


def sh_dc_to_rgb(sh_dc: torch.Tensor) -> torch.Tensor:
    """DC spherical-harmonic coefficients -> clamp(SH_C0 * dc + 0.5, 0, 1)."""
    return torch.clamp(SH_C0 * sh_dc + 0.5, 0.0, 1.0)


def rgb_to_sh_dc(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / SH_C0


SH_C1 = 0.4886025119029199
# bands 2 and 3 (Kerbl et al. 2023's utils/sh_utils.py, the CUDA
# rasterizer's computeColorFromSH)
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
MAX_SH_DEGREE = 3


def sh_coeffs(degree: int) -> int:
    """Coefficients an SH row of ``degree`` holds: max(4, (degree + 1)^2), so
    degrees 0 and 1 share the [C, 4, 3] row."""
    if not 0 <= degree <= MAX_SH_DEGREE:
        raise ValueError(f"SH degree {degree} is not supported (0 to {MAX_SH_DEGREE})")
    return max(4, (degree + 1) ** 2)


def sh_eval(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """SH color up to ``degree`` (0 to 3) along unit view directions,
    clamp(sum + 0.5, 0, 1).  sh: [N, K, 3] (coeff, channel) with K >=
    (degree + 1)^2 (coefficients past the degree are not read); dirs: [N,
    3].  The basis is 3DGS's (band 1: -y, +z, -x; bands 2 and 3 as
    SH_C2 and SH_C3 weigh them).  Raises on a degree above 3 or a row too
    narrow for the degree."""
    if not 0 <= degree <= MAX_SH_DEGREE:
        raise ValueError(f"SH degree {degree} is not supported (0 to {MAX_SH_DEGREE})")
    if sh.shape[-2] < (degree + 1) ** 2:
        raise ValueError(f"SH degree {degree} needs {(degree + 1) ** 2} coefficients, "
                         f"the row holds {sh.shape[-2]}")
    rgb = SH_C0 * sh[..., 0, :] + 0.5
    if degree >= 1:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        rgb = rgb + SH_C1 * (-y * sh[..., 1, :] + z * sh[..., 2, :] - x * sh[..., 3, :])
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        rgb = (rgb + SH_C2[0] * xy * sh[..., 4, :] + SH_C2[1] * yz * sh[..., 5, :]
               + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
               + SH_C2[3] * xz * sh[..., 7, :] + SH_C2[4] * (xx - yy) * sh[..., 8, :])
    if degree >= 3:
        rgb = (rgb + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
               + SH_C3[1] * xy * z * sh[..., 10, :]
               + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
               + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
               + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
               + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
               + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :])
    return torch.clamp(rgb, 0.0, 1.0)
