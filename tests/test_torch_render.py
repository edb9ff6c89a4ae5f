"""The port's render (gaussiansplatting_tpu_torch.ops.rasterize) against the
JAX windowed render (blend_impl="pallas", interpret mode on the CPU) and the
scalar NumPy oracle, plus the port's render CLI."""

import os

import numpy as np
import pytest
import torch

import jax

from gaussiansplatting_tpu.ops.rasterize import render as jrender

from gaussiansplatting_tpu_torch.config import RasterConfig
from gaussiansplatting_tpu_torch.core import gaussians as TG
from gaussiansplatting_tpu_torch.io import ply as tply
from gaussiansplatting_tpu_torch.ops.rasterize import render

from conftest import make_scene
from reference_renderer import render_reference
from torch_parity import cameras, configs, scene_params, t2n

torch.set_num_threads(1)


def _render_both(jp, tp, jc, tc, jcfg, tcfg):
    img_j, aux_j = jax.jit(jrender, static_argnums=2)(jp, jc, jcfg)
    with torch.no_grad():
        img_t, aux_t = render(tp, tc, tcfg)
    return np.asarray(img_j), aux_j, t2n(img_t), aux_t


@pytest.mark.parametrize("seed", [11, 12])
def test_render_matches_jax_windowed(seed):
    jp, tp = scene_params(seed, n=48)
    jc, tc = cameras()
    jcfg, tcfg = configs()
    img_j, aux_j, img_t, aux_t = _render_both(jp, tp, jc, tc, jcfg, tcfg)
    assert img_t.shape == (48, 64, 3) and img_t.dtype == np.float32
    assert int(aux_t.num_pairs) == int(aux_j.num_pairs) > 0
    assert bool(aux_t.overflow) == bool(aux_j.overflow) is False
    # the JAX package's own Pallas-vs-XLA image bar (test_pallas_blend.py:42)
    np.testing.assert_allclose(img_t, img_j, atol=2e-5)


def test_render_overflow_matches_jax():
    """A capacity far below the frame's pairs drops whole Gaussians in
    emission order in both packages: same count, same flag, same image."""
    jp, tp = scene_params(13, n=64, spread=0.2)
    jc, tc = cameras(32, 32)
    jcfg, tcfg = configs(pair_capacity=64, pair_block=8)
    img_j, aux_j, img_t, aux_t = _render_both(jp, tp, jc, tc, jcfg, tcfg)
    assert bool(aux_j.overflow) and bool(aux_t.overflow)
    assert int(aux_t.num_pairs) == int(aux_j.num_pairs)
    np.testing.assert_allclose(img_t, img_j, atol=2e-5)


def test_render_matches_numpy_oracle(rng):
    scene = make_scene(rng, n=64)
    means, log_scales, quats, raw_op, sh_dc = scene
    sh = np.zeros((64, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    tp = TG.from_arrays(means, log_scales, quats, raw_op, sh)
    jc, tc = cameras()
    with torch.no_grad():
        img, aux = render(tp, tc, RasterConfig(pair_capacity=4096, pair_block=32))
    img = t2n(img)
    assert not bool(aux.overflow) and int(aux.num_pairs) > 0
    ref = render_reference(
        means, log_scales, quats, raw_op, sh_dc,
        np.asarray(jc.view, np.float64), np.asarray(jc.viewproj, np.float64),
        float(jc.fx), float(jc.fy), jc.width, jc.height,
    )
    # the bar test_render_forward.py holds the JAX renderer to: the oracle
    # terminates at T <= 1e-4, the renderer does not
    err = np.abs(img - ref)
    assert err.max() < 5e-3, f"max pixel err {err.max()}"
    assert err.mean() < 2e-4


def test_empty_scene_renders_background():
    _, tc = cameras(32, 32)
    with torch.no_grad():
        img, aux = render(TG.zeros(16), tc, RasterConfig(pair_capacity=256, pair_block=16))
    np.testing.assert_array_equal(t2n(img), 1.0)
    assert int(aux.num_pairs) == 0 and not bool(aux.overflow)


def test_render_requires_no_grad():
    """render needs no torch.no_grad(): with grad enabled it returns the
    same image, attached to the graph through _BlendWindows."""
    _, tp = scene_params(14, n=16)
    _, tc = cameras()
    img, aux = render(tp, tc, configs()[1])
    assert img.requires_grad and int(aux.num_pairs) > 0
    with torch.no_grad():
        img_ng, _ = render(tp, tc, configs()[1])
    assert torch.equal(img.detach(), img_ng)


@pytest.mark.parametrize("kw", [
    dict(payload_dtype="bf16"),
    dict(payload_dtype="bf16", pack_positions=True),
    dict(overflow_drop="impact"),
], ids=["bf16", "pack_positions", "impact"])
def test_unported_modes_raise(kw):
    _, tp = scene_params(15, n=16)
    _, tc = cameras()
    with torch.no_grad(), pytest.raises(NotImplementedError, match="not ported"):
        render(tp, tc, RasterConfig(**{**dict(pair_capacity=2048, pair_block=16), **kw}))


def test_tile_rows_raise():
    """A strip needs row0 >= 0 and at least one row (tests/test_torch_batched.py
    holds the strips against JAX's)."""
    _, tp = scene_params(15, n=16)
    _, tc = cameras()
    for tile_rows in ((0, 0), (-1, 2)):
        with torch.no_grad(), pytest.raises(ValueError, match="tile_rows"):
            render(tp, tc, configs()[1], tile_rows=tile_rows)


def _tiny_ply(path, seed=16, n=40):
    rng = np.random.default_rng(seed)
    means, log_scales, quats, raw_op, sh_dc = make_scene(rng, n=n, spread=0.6)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    tply.export_gaussian_ply(str(path), tply.GaussianCloud(
        means=means, log_scales=log_scales, quats=quats, raw_opacities=raw_op,
        sh=sh,
    ))


def test_render_cli_orbit_cpu(tmp_path, capsys):
    from gaussiansplatting_tpu_torch.tools import render as render_cli

    _tiny_ply(tmp_path / "m.ply")
    rc = render_cli.main([
        "--ply", str(tmp_path / "m.ply"), "--output", str(tmp_path / "out"),
        "--device", "cpu", "--orbit", "2", "--width", "64", "--height", "48",
        "--pair-capacity", "4096",
    ])
    assert rc == 0
    for i in range(2):
        p = tmp_path / "out" / f"orbit_{i:03d}.png"
        assert p.exists() and p.stat().st_size > 0
    out = capsys.readouterr().out
    assert "[done] views=2" in out
    assert "blend_kernel_launches=0" in out     # the CPU runs the plain blend


def test_render_cli_matches_jax_cli(tmp_path):
    """Both CLIs on one PLY write the same orbit views (PPM bytes may differ
    only where a pixel rounds across a quantization step)."""
    from gaussiansplatting_tpu.tools import render as jrender_cli
    from gaussiansplatting_tpu_torch.tools import render as render_cli

    _tiny_ply(tmp_path / "m.ply")
    common = ["--ply", str(tmp_path / "m.ply"), "--orbit", "2", "--width", "64",
              "--height", "48", "--format", "ppm", "--pair-capacity", "4096"]
    assert render_cli.main(common + ["--output", str(tmp_path / "t"),
                                     "--device", "cpu"]) == 0
    assert jrender_cli.main(common + ["--output", str(tmp_path / "j")]) == 0
    for i in range(2):
        name = f"orbit_{i:03d}.ppm"
        a = np.frombuffer((tmp_path / "t" / name).read_bytes(), np.uint8)
        b = np.frombuffer((tmp_path / "j" / name).read_bytes(), np.uint8)
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_render_cli_refuses_missing_cuda(tmp_path, monkeypatch):
    from gaussiansplatting_tpu_torch.tools import render as render_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _tiny_ply(tmp_path / "m.ply")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        render_cli.main(["--ply", str(tmp_path / "m.ply"),
                         "--output", str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "o")


def test_render_cli_colmap_matches_jax_cli(tmp_path):
    """--colmap renders the reconstruction's training views at their native
    size, named after the images, in both CLIs alike."""
    from gaussiansplatting_tpu.tools import render as jrender_cli
    from gaussiansplatting_tpu_torch.tools import render as render_cli

    from test_io import write_cameras_bin, write_images_bin, write_points_bin

    sparse = tmp_path / "sparse"
    sparse.mkdir()
    write_cameras_bin(sparse / "cameras.bin", [(1, 1, 64, 48, [70.0, 70.0, 32.0, 24.0])])
    write_images_bin(sparse / "images.bin", [
        (1, (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 1, "front.png", 0),
        (2, (0.995, 0.0, 0.0998, 0.0), (-0.4, 0.0, 0.1), 1, "side.jpg", 0),
    ])
    write_points_bin(sparse / "points3D.bin", [(1, (0.0, 0.0, 4.0), (9, 9, 9), 0.1, 0)])
    _tiny_ply(tmp_path / "m.ply")
    common = ["--ply", str(tmp_path / "m.ply"), "--colmap", str(sparse),
              "--format", "ppm", "--pair-capacity", "4096"]
    assert render_cli.main(common + ["--output", str(tmp_path / "t"),
                                     "--device", "cpu"]) == 0
    assert jrender_cli.main(common + ["--output", str(tmp_path / "j")]) == 0
    for name in ("front.ppm", "side.ppm"):
        a = (tmp_path / "t" / name).read_bytes()
        b = (tmp_path / "j" / name).read_bytes()
        assert a.startswith(b"P6\n64 48\n255\n") and len(a) == len(b)
        diff = np.abs(np.frombuffer(a, np.uint8).astype(int)
                      - np.frombuffer(b, np.uint8).astype(int))
        assert diff.max() <= 1
