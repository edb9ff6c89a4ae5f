"""3DGS PLY interchange — binary little-endian, reference-compatible schema.

Export of an SH row of degree 0 or 1 ([N, 4, 3]) writes exactly the
reference's field set and ordering (ply_exporter.hpp:39-77): x y z, nx ny nz
(zeros), f_dc_0-2, f_rest_0-8 interleaved per-coefficient RGB
(ply_exporter.hpp:112-123 — note this differs from the official 3DGS
channel-planar layout), raw opacity, log scales, rot_0-3 = (w, x, y, z).  A
row of degree 2 or 3 ([N, 9, 3], [N, 16, 3]) is written in the official
3DGS layout: f_rest_{ch * (K - 1) + (c - 1)} for coefficient c = 1..K-1,
channel-major (f_rest_0-23, f_rest_0-44).  Invalid positions are skipped
(ply_exporter.hpp:29-36).

Load accepts any binary-LE PLY carrying the required fields, applies the
reference's linear-vs-log scale auto-detection (ply_loader.cpp:17-58), clamps
log scales to +/-8, normalizes quaternions, and skips invalid positions.  Its
SH row follows the file's f_rest fields: none -> [N, 4, 3] of the DC; 9 ->
the reference's interleave, [N, 4, 3]; 24 or 45 -> 3DGS's channel-major
layout of degree 2 or 3, [N, 9, 3] or [N, 16, 3], every band kept; any other
count raises.

Copied from gaussiansplatting_tpu/io/ply.py (numpy only); ``cloud_from_params``
takes the port's ``GaussianParams`` module.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4",
    "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}


@dataclasses.dataclass
class GaussianCloud:
    """Host-side Gaussian soup in the reference's parameterization."""

    means: np.ndarray          # [N, 3]
    log_scales: np.ndarray     # [N, 3] ([N, 2] for surfels)
    quats: np.ndarray          # [N, 4] (w, x, y, z), normalized
    raw_opacities: np.ndarray  # [N]
    sh: np.ndarray             # [N, K, 3] (coefficient, channel), [:,0]=DC; K = 4, 9, 16


def _parse_header(f):
    line = f.readline().strip()
    if line != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    count = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.strip().decode("ascii", "replace").split()
        if not tokens:
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            in_vertex = tokens[1] == "vertex"
            if in_vertex:
                count = int(tokens[2])
        elif tokens[0] == "property" and in_vertex:
            if tokens[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((tokens[2], _PLY_DTYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format: {fmt}")
    return count, props


def load_gaussian_ply(path: str, max_log_scale: float = 8.0) -> GaussianCloud:
    with open(path, "rb") as f:
        count, props = _parse_header(f)
        dtype = np.dtype([(name, dt) for name, dt in props])
        raw = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype, count=count)

    def col(name):
        return np.asarray(raw[name], np.float32)

    names = {n for n, _ in props}
    # a file without scale_2 holds surfels (2D Gaussian Splatting's
    # scale_0, scale_1): [N, 2] log-scales
    axes = 3 if "scale_2" in {n for n, _ in props} else 2
    required = {"x", "y", "z", *(f"scale_{i}" for i in range(axes)),
                "rot_0", "rot_1", "rot_2", "rot_3", "opacity",
                "f_dc_0", "f_dc_1", "f_dc_2"}
    missing = required - names
    if missing:
        raise ValueError(f"PLY missing fields: {sorted(missing)}")

    means = np.stack([col("x"), col("y"), col("z")], axis=1)
    scales = np.stack([col(f"scale_{i}") for i in range(axes)], axis=1)
    quats = np.stack([col(f"rot_{i}") for i in range(4)], axis=1)
    opac = col("opacity")
    rest = len([n for n in names if n.startswith("f_rest_")])
    if rest not in (0, 9, 24, 45) or any(f"f_rest_{i}" not in names for i in range(rest)):
        raise ValueError(f"PLY has {rest} f_rest fields: expected f_rest_0 .. f_rest_<n-1> "
                         f"with n = 0, 9 (the reference's interleave), 24 or 45 (3DGS's "
                         f"degree 2 or 3)")
    sh = np.zeros((count, 4 if rest <= 9 else rest // 3 + 1, 3), np.float32)
    sh[:, 0, 0] = col("f_dc_0")
    sh[:, 0, 1] = col("f_dc_1")
    sh[:, 0, 2] = col("f_dc_2")
    for c, ch, i in _rest_fields(rest):
        sh[:, c, ch] = col(f"f_rest_{i}")

    # linear-vs-log auto-detection (ply_loader.cpp:17-58): sample 1000, any
    # negative -> log; all in (0, 1] -> linear; else log.
    sample = scales[: min(count, 1000)].reshape(-1)
    has_negative = np.any(sample < 0)
    is_linear = (not has_negative) and sample.size > 0 and (
        sample.max() <= 1.0 and sample.min() > 0.0
    )
    if is_linear:
        scales = np.log(np.maximum(scales, 1e-8))
    scales = np.clip(scales, -max_log_scale, max_log_scale)

    # skip invalid positions (ply_loader.cpp:171-177)
    ok = np.all(np.isfinite(means), axis=1) & np.all(np.abs(means) <= 1e6, axis=1)

    qn = np.linalg.norm(quats, axis=1, keepdims=True)
    quats = np.where(qn > 1e-4, quats / np.maximum(qn, 1e-4),
                     np.array([[1.0, 0, 0, 0]], np.float32))

    return GaussianCloud(
        means=means[ok],
        log_scales=scales[ok].astype(np.float32),
        quats=quats[ok].astype(np.float32),
        raw_opacities=opac[ok],
        sh=sh[ok],
    )


def _rest_fields(rest: int):
    """(coefficient, channel, f_rest index) of each of a file's ``rest``
    f_rest fields: 9 in the reference's interleave, f_rest_[3 (c - 1) + ch]
    (ply_exporter.hpp:112-123 writes per-coefficient RGB groups); 24 or 45
    in 3DGS's channel-major layout, f_rest_[ch (K - 1) + (c - 1)] (all of R,
    then G, then B)."""
    if rest == 9:
        return [(c, ch, 3 * (c - 1) + ch) for c in range(1, 4) for ch in range(3)]
    per = rest // 3
    return [(c, ch, ch * per + (c - 1)) for c in range(1, per + 1) for ch in range(3)]


def export_gaussian_ply(path: str, cloud: GaussianCloud) -> int:
    """Write the reference's exact schema (an SH row of 4 coefficients) or
    3DGS's (9 or 16: f_rest channel-major); returns the number of Gaussians
    written (invalid positions skipped, ply_exporter.hpp:29-36).  Surfels
    (two log-scales a row) write scale_0 and scale_1 alone, as 2D Gaussian
    Splatting's files hold them."""
    means = np.asarray(cloud.means, np.float32)
    ok = (
        np.all(np.isfinite(means), axis=1)
        & (np.abs(means[:, 0]) < 1e6)
    )
    n = int(ok.sum())
    k = np.asarray(cloud.sh).shape[1]
    if k not in (4, 9, 16):
        raise ValueError(f"an SH row of {k} coefficients has no PLY layout (4, 9 or 16)")
    rest = 9 if k == 4 else 3 * (k - 1)
    axes = np.asarray(cloud.log_scales).shape[1]

    fields = (
        ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
        + [f"f_rest_{i}" for i in range(rest)]
        + ["opacity"] + [f"scale_{i}" for i in range(axes)]
        + ["rot_0", "rot_1", "rot_2", "rot_3"]
    )
    rec = np.zeros((n,), dtype=np.dtype([(f, "<f4") for f in fields]))
    sel = lambda a: np.asarray(a, np.float32)[ok]  # noqa: E731

    m = sel(cloud.means)
    rec["x"], rec["y"], rec["z"] = m[:, 0], m[:, 1], m[:, 2]
    sh = sel(cloud.sh)  # [n, K, 3]
    rec["f_dc_0"], rec["f_dc_1"], rec["f_dc_2"] = sh[:, 0, 0], sh[:, 0, 1], sh[:, 0, 2]
    for c, ch, i in _rest_fields(rest):
        rec[f"f_rest_{i}"] = sh[:, c, ch]
    rec["opacity"] = sel(cloud.raw_opacities)
    s = sel(cloud.log_scales)
    for i in range(axes):
        rec[f"scale_{i}"] = s[:, i]
    q = sel(cloud.quats)
    for i in range(4):
        rec[f"rot_{i}"] = q[:, i]

    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for name in fields:
            f.write(f"property float {name}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())
    return n


def cloud_from_params(params, count: int | None = None) -> GaussianCloud:
    """GaussianParams (module on any device) -> host GaussianCloud of live
    rows."""
    def host(t):
        return t.detach().cpu().numpy()

    idx = np.nonzero(host(params.alive))[0]
    if count is not None:
        idx = idx[:count]
    return GaussianCloud(
        means=host(params.means)[idx],
        log_scales=host(params.log_scales)[idx],
        quats=host(params.quats)[idx],
        raw_opacities=host(params.raw_opacities)[idx],
        sh=host(params.sh)[idx],
    )
