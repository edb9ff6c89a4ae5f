"""The port's config, parameter module, camera builders, synthetic scenes and
io against the JAX package: the copies must not drift."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaussiansplatting_tpu import config as jconfig
from gaussiansplatting_tpu.core import camera as jcam
from gaussiansplatting_tpu.core import gaussians as JG
from gaussiansplatting_tpu.io import colmap as jcolmap
from gaussiansplatting_tpu.io import images as jimages
from gaussiansplatting_tpu.io import ply as jply
from gaussiansplatting_tpu.utils import synthetic as jsyn

from gaussiansplatting_tpu_torch import config as tconfig
from gaussiansplatting_tpu_torch.core import camera as tcam
from gaussiansplatting_tpu_torch.core import gaussians as TG
from gaussiansplatting_tpu_torch.io import colmap as tcolmap
from gaussiansplatting_tpu_torch.io import images as timages
from gaussiansplatting_tpu_torch.io import ply as tply
from gaussiansplatting_tpu_torch.utils import synthetic as tsyn

from test_io import write_cameras_bin, write_images_bin, write_points_bin
from torch_parity import t2n, to_torch_camera, to_torch_params

torch.set_num_threads(1)

CAM_FIELDS = ("view", "proj", "viewproj", "cam_pos", "fx", "fy")


def _assert_camera_close(jc, tc):
    assert (tc.width, tc.height) == (jc.width, jc.height)
    for f in CAM_FIELDS:
        a, b = np.asarray(getattr(jc, f)), t2n(getattr(tc, f))
        assert b.dtype == np.float32 and b.shape == a.shape, f
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0, err_msg=f)


def test_config_dicts_equal():
    # the port's fields the JAX package lacks, each popped at its default and
    # left out of the JSON while it holds it: the SH rest bands' learning
    # rate (None = sh_lr), the primitive and 2DGS's two regularizer weights
    port = dataclasses.asdict(tconfig.Config())
    assert port["optim"].pop("sh_rest_lr") is None
    assert port["raster"].pop("primitive") == "gaussian"
    assert port["loss"].pop("lambda_dist") == 0.0
    assert port["loss"].pop("lambda_normal") == 0.0
    assert port == dataclasses.asdict(jconfig.Config())
    text = jconfig.Config().to_json()
    assert tconfig.Config.from_json(text).to_json() == text


@pytest.mark.parametrize("n,seed", [(64, 0), (1000, 7)])
def test_make_scene_bit_equal(n, seed):
    jp = jsyn.make_scene(n, seed=seed, capacity=n + 5)
    tp = tsyn.make_scene(n, seed=seed, capacity=n + 5)
    assert isinstance(tp, torch.nn.Module)
    assert {k for k, _ in tp.named_parameters()} == set(TG.FIELDS) - {"alive"}
    for f in TG.FIELDS:
        a, b = np.asarray(getattr(jp, f)), t2n(getattr(tp, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("render", [None, (80, 60)])
def test_make_camera_matches(render):
    q = np.array([0.9, 0.1, -0.2, 0.3], np.float32)
    q /= np.linalg.norm(q)
    args = (q, np.array([0.3, -0.1, 2.0], np.float32), 500.0, 510.0, 320.0, 240.0,
            640, 480)
    kw = {} if render is None else dict(render_width=render[0], render_height=render[1])
    _assert_camera_close(jcam.make_camera(*args, **kw), tcam.make_camera(*args, **kw))


@pytest.mark.parametrize("azimuth", [0.0, 1.3, 4.0])
def test_orbit_camera_matches(azimuth):
    args = ((0.1, 0.2, 4.0), 3.0, azimuth, 0.26, 500.0, 500.0, 800, 600)
    _assert_camera_close(jcam.orbit_camera(*args), tcam.orbit_camera(*args))


def test_canonical_camera_and_converter_match():
    jc = jsyn.make_canonical_camera(800, 608)
    _assert_camera_close(jc, tsyn.make_canonical_camera(800, 608))
    _assert_camera_close(jc, to_torch_camera(jc))
    moved = to_torch_camera(jc).to("cpu")
    assert moved.width == 800 and moved.view.device.type == "cpu"


def test_pose_helpers_match():
    q = np.array([0.7, -0.1, 0.5, 0.2], np.float32)
    t = np.array([1.0, 2.0, -0.5], np.float32)
    np.testing.assert_allclose(tcam.view_matrix(q, t), jcam.view_matrix(q, t), atol=1e-6)
    np.testing.assert_allclose(tcam.camera_world_position(q, t),
                               jcam.camera_world_position(q, t), atol=1e-6)
    R, _ = jcam.look_at_view((1.0, 2.0, 3.0), (0.0, 0.0, 4.0))
    np.testing.assert_array_equal(tcam.rotmat_to_quat_wxyz(R), jcam.rotmat_to_quat_wxyz(R))


def test_from_arrays_flat_sh_matches():
    rng = np.random.default_rng(61)
    means, ls, q = (rng.normal(size=(5, k)).astype(np.float32) for k in (3, 3, 4))
    op = rng.normal(size=5).astype(np.float32)
    sh_flat = rng.normal(size=(5, 12)).astype(np.float32)
    jp = JG.from_arrays(means, ls, q, op, sh_flat, capacity=8)
    tp = TG.from_arrays(means, ls, q, op, sh_flat, capacity=8)
    for f in TG.FIELDS:
        np.testing.assert_array_equal(t2n(getattr(tp, f)), np.asarray(getattr(jp, f)))
    np.testing.assert_array_equal(TG.to_flat_sh(t2n(tp.sh)), JG.to_flat_sh(np.asarray(jp.sh)))
    assert int(tp.count()) == 5 and tp.capacity == 8
    with pytest.raises(ValueError, match="capacity"):
        TG.from_arrays(means, ls, q, op, sh_flat, capacity=2)


def _cloud(seed=62, n=30):
    p = jsyn.make_scene(n, seed=seed)
    return jply.GaussianCloud(
        means=np.asarray(p.means), log_scales=np.asarray(p.log_scales),
        quats=np.asarray(p.quats), raw_opacities=np.asarray(p.raw_opacities),
        sh=np.random.default_rng(seed).normal(size=(n, 4, 3)).astype(np.float32),
    )


def _assert_cloud_equal(a, b):
    for f in ("means", "log_scales", "quats", "raw_opacities", "sh"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_ply_round_trip_across_packages(tmp_path, writer, reader):
    cloud = _cloud()
    mods = {"jax": jply, "torch": tply}
    path = str(tmp_path / "c.ply")
    assert mods[writer].export_gaussian_ply(path, cloud) == 30
    got = mods[reader].load_gaussian_ply(path)
    _assert_cloud_equal(got, mods[writer].load_gaussian_ply(path))
    _assert_cloud_equal(got, jply.load_gaussian_ply(path))


def test_cloud_from_params_matches():
    jp = jsyn.make_scene(20, seed=63, capacity=24)
    tp = to_torch_params(jp)
    _assert_cloud_equal(tply.cloud_from_params(tp), jply.cloud_from_params(jp))
    _assert_cloud_equal(tply.cloud_from_params(tp, count=7),
                        jply.cloud_from_params(jp, count=7))


def _cloud_deg3(seed=65, n=25):
    """A degree-3 cloud; unit rotations, which the load's normalization
    leaves as they are."""
    c = _cloud(seed, n)
    c.sh = np.random.default_rng(seed).normal(size=(n, 16, 3)).astype(np.float32)
    c.quats = np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (n, 1))
    return c


def test_ply_degree_3_round_trips_bit_for_bit(tmp_path):
    """A [N, 16, 3] row is written in 3DGS's layout (f_rest_0..44,
    channel-major: f_rest_{ch * 15 + (c - 1)}) and read back bit for bit;
    writing what was read gives the same file."""
    cloud = _cloud_deg3()
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    assert tply.export_gaussian_ply(a, cloud) == 25
    got = tply.load_gaussian_ply(a)
    assert got.sh.shape == (25, 16, 3)
    np.testing.assert_array_equal(got.sh, cloud.sh)
    np.testing.assert_array_equal(got.means, cloud.means)
    tply.export_gaussian_ply(b, got)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    _assert_cloud_equal(tply.load_gaussian_ply(b), got)
    header = open(a, "rb").read().split(b"end_header")[0].decode()
    rest = [ln.split()[-1] for ln in header.splitlines() if "f_rest_" in ln]
    assert rest == [f"f_rest_{i}" for i in range(45)]
    # the layout: coefficient c of channel ch is field ch * 15 + (c - 1)
    rec = np.frombuffer(open(a, "rb").read().split(b"end_header\n", 1)[1],
                        dtype=[(n, "<f4") for n in ("x y z nx ny nz f_dc_0 f_dc_1 f_dc_2".split()
                                                    + rest + ["opacity"]
                                                    + [f"scale_{i}" for i in range(3)]
                                                    + [f"rot_{i}" for i in range(4)])])
    for c in (1, 8, 15):
        for ch in range(3):
            np.testing.assert_array_equal(rec[f"f_rest_{ch * 15 + c - 1}"], cloud.sh[:, c, ch])


def test_ply_degree_3_file_keeps_every_band(tmp_path):
    """A 3DGS degree-3 file: the JAX package keeps band 1 of it, the port
    every band (the first four coefficients the same)."""
    path = str(tmp_path / "d3.ply")
    tply.export_gaussian_ply(path, _cloud_deg3())
    got, want = tply.load_gaussian_ply(path), jply.load_gaussian_ply(path)
    assert want.sh.shape == (25, 4, 3) and got.sh.shape == (25, 16, 3)
    np.testing.assert_array_equal(got.sh[:, :4], want.sh)
    assert np.abs(got.sh[:, 4:]).min() > 0


def test_ply_degree_1_loads_as_before(tmp_path):
    """A file in the reference's interleave (f_rest_0..8) loads as [N, 4, 3],
    as the JAX package loads it, and a degree-2 row writes 24 fields."""
    path = str(tmp_path / "d1.ply")
    tply.export_gaussian_ply(path, _cloud())
    got = tply.load_gaussian_ply(path)
    assert got.sh.shape == (30, 4, 3)
    _assert_cloud_equal(got, jply.load_gaussian_ply(path))
    c2 = _cloud()
    c2.sh = np.random.default_rng(3).normal(size=(30, 9, 3)).astype(np.float32)
    tply.export_gaussian_ply(path, c2)
    np.testing.assert_array_equal(tply.load_gaussian_ply(path).sh, c2.sh)


def test_ply_unknown_rest_count_raises(tmp_path):
    """A file whose f_rest fields are neither 0, 9, 24 nor 45 raises (it
    was read as the interleave of its first nine)."""
    cloud = _cloud_deg3()
    path = str(tmp_path / "odd.ply")
    tply.export_gaussian_ply(path, cloud)
    raw = open(path, "rb").read()
    head, body = raw.split(b"end_header\n", 1)
    lines = head.decode().splitlines()
    lines = [ln for ln in lines if ln not in ("property float f_rest_44",)]
    rec = np.frombuffer(body, dtype=np.float32).reshape(25, -1)
    rec = np.delete(rec, 9 + 44, axis=1)
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\nend_header\n").encode() + rec.tobytes())
    with pytest.raises(ValueError, match="44 f_rest fields"):
        tply.load_gaussian_ply(path)
    c = _cloud()
    c.sh = np.zeros((30, 5, 3), np.float32)
    with pytest.raises(ValueError, match="no PLY layout"):
        tply.export_gaussian_ply(path, c)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_tools_accept_sh_degree_0_to_3(degree):
    from gaussiansplatting_tpu_torch.tools import evaluate, render, train, view

    deg = ["--sh-degree", str(degree)]
    assert train.build_parser().parse_args(["--colmap", "c", "--images", "i"] + deg).sh_degree == degree
    assert render.build_parser().parse_args(["--ply", "x.ply", "--output", "o"]
                                            + deg).sh_degree == degree
    assert view.build_parser().parse_args(["--ply", "x.ply"] + deg).sh_degree == degree
    with pytest.raises(SystemExit, match="PLY not found"):
        evaluate.main(["--ply", "/nonexistent.ply", "--colmap", "c", "--images", "i"] + deg)
    with pytest.raises(SystemExit):
        render.build_parser().parse_args(["--ply", "x.ply", "--output", "o", "--sh-degree", "4"])


def test_save_ppm_bytes_match(tmp_path):
    img = np.random.default_rng(64).uniform(-0.1, 1.1, (12, 9, 3)).astype(np.float32)
    timages.save_ppm(str(tmp_path / "t.ppm"), img)
    jimages.save_ppm(str(tmp_path / "j.ppm"), img)
    assert (tmp_path / "t.ppm").read_bytes() == (tmp_path / "j.ppm").read_bytes()


def test_colmap_loader_matches(tmp_path):
    write_cameras_bin(tmp_path / "cameras.bin", [
        (1, 1, 640, 480, [500.0, 510.0, 320.0, 240.0]),
        (2, 2, 800, 600, [450.0, 400.0, 300.0, 0.01]),
    ])
    write_images_bin(tmp_path / "images.bin", [
        (1, (0.9, 0.1, 0.2, 0.0), (0.1, 0.2, 0.3), 1, "a.png", 3),
        (2, (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 1.0), 2, "b.jpg", 0),
    ])
    write_points_bin(tmp_path / "points3D.bin", [
        (1, (1.0, 2.0, 3.0), (255, 0, 10), 0.5, 2),
        (2, (-1.0, 0.5, 4.0), (1, 2, 3), 1.5, 0),
    ])
    a = jcolmap.load_colmap(str(tmp_path))
    b = tcolmap.load_colmap(str(tmp_path))
    assert {k: dataclasses.asdict(v) for k, v in a.cameras.items()} == \
        {k: dataclasses.asdict(v) for k, v in b.cameras.items()}
    for x, y in zip(a.images, b.images):
        assert (x.id, x.camera_id, x.name) == (y.id, y.camera_id, y.name)
        np.testing.assert_array_equal(x.quat_wxyz, y.quat_wxyz)
        np.testing.assert_array_equal(x.translation, y.translation)
    for f in ("points", "point_colors", "point_errors"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert tcolmap.compute_scene_extent(b) == pytest.approx(
        jcolmap.compute_scene_extent(a), rel=1e-6)


def test_params_from_numpy_round_trip():
    jp = jsyn.make_scene(16, seed=65, capacity=20)
    tp = to_torch_params(jp)
    assert tp.alive.dtype == torch.bool and not tp.alive.requires_grad
    assert all(p.requires_grad for p in tp.parameters())
    for f in TG.FIELDS:
        np.testing.assert_array_equal(t2n(getattr(tp, f)), np.asarray(getattr(jp, f)))
    sd = tp.state_dict()
    assert set(sd) == set(TG.FIELDS)
    assert jnp.asarray(t2n(sd["means"])).shape == (20, 3)
