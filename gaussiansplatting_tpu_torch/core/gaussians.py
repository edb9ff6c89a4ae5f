"""Gaussian parameters: padded fixed-capacity tensors with an alive mask.

Counterpart of gaussiansplatting_tpu/core/gaussians.py.  The five parameter
groups are ``nn.Parameter``s of one ``nn.Module`` and ``alive`` is a buffer,
so the module moves between devices with ``.to`` and an optimizer can take
``.parameters()`` as they are.

SH layout: [capacity, K, 3] = (coefficient, channel), coeff 0 the DC term,
K = max(4, (degree + 1)^2) (core/transforms.sh_coeffs): [C, 4, 3] for
degrees 0 and 1, [C, 16, 3] for degree 3; ``from_arrays`` also takes the
reference's flat [N, 12] channel-major layout.

Scales: [C, 3] log-scales for the 3D Gaussian, [C, 2] (s_u, s_v) for the
2D Gaussian surfel (RasterConfig.primitive "surfel"); ``primitive_of``
reads which from the row.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

FIELDS = ("means", "log_scales", "quats", "raw_opacities", "sh", "alive")


class GaussianParams(nn.Module):
    """means [C, 3], log_scales [C, 3] ([C, 2] for surfels), quats [C, 4] (w, x, y, z, not
    necessarily normalized), raw_opacities [C] (pre-sigmoid), sh [C, K, 3]
    (K = 4 for SH degrees 0-1, 9 for 2, 16 for 3) and the bool buffer alive
    [C]."""

    def __init__(self, means, log_scales, quats, raw_opacities, sh, alive):
        super().__init__()
        self.means = nn.Parameter(means)
        self.log_scales = nn.Parameter(log_scales)
        self.quats = nn.Parameter(quats)
        self.raw_opacities = nn.Parameter(raw_opacities)
        self.sh = nn.Parameter(sh)
        self.register_buffer("alive", alive)

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    def count(self) -> torch.Tensor:
        """Number of live Gaussians (0-dim tensor)."""
        return self.alive.sum()


def primitive_of(params) -> str:
    """"surfel" for a row of two log-scales, "gaussian" for three."""
    return "surfel" if params.log_scales.shape[-1] == 2 else "gaussian"


def scale_dims(primitive: str) -> int:
    """Log-scales a row of ``primitive`` holds: 3, or 2 for a surfel."""
    if primitive not in ("gaussian", "surfel"):
        raise ValueError(f"primitive must be 'gaussian' or 'surfel', got {primitive!r}")
    return 2 if primitive == "surfel" else 3


def zeros(capacity: int, device=None, sh_coeffs: int = 4, scales: int = 3) -> GaussianParams:
    quats = torch.zeros((capacity, 4), dtype=torch.float32, device=device)
    quats[:, 0] = 1.0
    return GaussianParams(
        means=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        log_scales=torch.zeros((capacity, scales), dtype=torch.float32, device=device),
        quats=quats,
        raw_opacities=torch.zeros((capacity,), dtype=torch.float32, device=device),
        sh=torch.zeros((capacity, sh_coeffs, 3), dtype=torch.float32, device=device),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def from_arrays(
    means: np.ndarray,
    log_scales: np.ndarray,
    quats: np.ndarray,
    raw_opacities: np.ndarray,
    sh: np.ndarray,
    capacity: int | None = None,
    device=None,
) -> GaussianParams:
    """Pack host arrays into a padded GaussianParams on ``device``.

    ``sh`` may be [N, K, 3] (K = 4, 9 or 16; the row keeps K) or the
    reference's flat [N, 12] channel-major layout (R0..R3, G0..G3,
    B0..B3)."""
    n = means.shape[0]
    cap = int(capacity if capacity is not None else n)
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")
    sh = np.asarray(sh, np.float32)
    if sh.ndim == 2 and sh.shape[1] == 12:
        sh = sh.reshape(n, 3, 4).transpose(0, 2, 1)  # [N,3ch,4coef] -> [N,4,3]
    if sh.ndim != 3 or sh.shape[1:] not in ((4, 3), (9, 3), (16, 3)):
        raise ValueError(f"sh must be [N, 4|9|16, 3] or [N, 12], got {sh.shape}")
    scales = np.asarray(log_scales).shape[1]
    if scales not in (2, 3):
        raise ValueError(f"log_scales must be [N, 3] or [N, 2] (surfels), got "
                         f"{np.asarray(log_scales).shape}")
    out = zeros(cap, device=device, sh_coeffs=sh.shape[1], scales=scales)
    with torch.no_grad():
        for name, arr in (
            ("means", means), ("log_scales", log_scales), ("quats", quats),
            ("raw_opacities", raw_opacities), ("sh", sh),
        ):
            getattr(out, name)[:n] = torch.from_numpy(np.array(arr, np.float32))
        out.alive[:n] = True
    return out


def params_from_numpy(d: dict[str, np.ndarray], device=None) -> GaussianParams:
    """Build the module from a dict of host arrays keyed by FIELDS, e.g.
    ``{f: np.asarray(getattr(jax_params, f)) for f in FIELDS}`` — the
    carry-over that gives both packages the same parameters."""
    def t(name, dtype):
        return torch.from_numpy(np.array(d[name], dtype)).to(device)

    return GaussianParams(
        means=t("means", np.float32),
        log_scales=t("log_scales", np.float32),
        quats=t("quats", np.float32),
        raw_opacities=t("raw_opacities", np.float32),
        sh=t("sh", np.float32),
        alive=t("alive", np.bool_),
    )


def to_flat_sh(sh: np.ndarray) -> np.ndarray:
    """[N, 4, 3] -> the reference's flat [N, 12] (R0..R3, G0..G3, B0..B3)."""
    return np.asarray(sh).transpose(0, 2, 1).reshape(sh.shape[0], 12)
