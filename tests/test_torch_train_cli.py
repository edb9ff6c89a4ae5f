"""The port's COLMAP trainer path against the JAX package on the CPU: the
COLMAP writers, scene loading (cameras, extent, SfM initialisation, the
capacity rule, the median kNN mode above 10k points), image loading, the
training CLI end to end (events, checkpoint, resume, PLY), the training CLI
against JAX's on the same scene, and the evaluation CLI.

Both packages take the kNN from scipy here (the JAX package's native kNN is
stubbed out, as the port does not carry ``native/``).  Tolerances: integers,
bytes and initial arrays exact; cameras within 1e-6 (both build them in
float32 numpy); the trained state at the bars of tests/test_torch_train.py;
evaluation PSNR within 1e-4 dB, L1 within 1e-6, SSIM within 1e-5."""

import json

import numpy as np
import pytest
import torch

from gaussiansplatting_tpu.config import Config as JConfig
from gaussiansplatting_tpu.config import RasterConfig as JRasterConfig
from gaussiansplatting_tpu.config import TrainConfig as JTrainConfig
from gaussiansplatting_tpu.io import dataset as jdataset
from gaussiansplatting_tpu.io import init as jinit
from gaussiansplatting_tpu.io import native as jnative
from gaussiansplatting_tpu.utils import scenegen as jscenegen

from gaussiansplatting_tpu_torch.config import Config, InitConfig
from gaussiansplatting_tpu_torch.core import camera as tcam
from gaussiansplatting_tpu_torch.io import dataset as tdataset
from gaussiansplatting_tpu_torch.io import images as timages
from gaussiansplatting_tpu_torch.io import init as tinit
from gaussiansplatting_tpu_torch.io import ply as tply
from gaussiansplatting_tpu_torch.ops.rasterize import render as trender
from gaussiansplatting_tpu_torch.utils import scenegen as tscenegen
from gaussiansplatting_tpu_torch.utils import synthetic as tsyn

from test_torch_train import TRAINABLE, _compare_states
from torch_parity import t2n

torch.set_num_threads(1)

W = H = 64
FX = 76.8
POSES = [([1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
         ([1.0, 0.0, 0.0, 0.0], [0.15, 0.0, 0.0]),
         ([0.9987503, 0.0, 0.0499792, 0.0], [-0.1, 0.05, 0.0])]
# steps the CLI comparison runs: 2 epochs x 2 training views (eval split 3)
CLI_STEPS = 4


@pytest.fixture
def scipy_knn(monkeypatch):
    monkeypatch.setattr(jnative, "knn_mean_dist", lambda points, k=3: None)


@pytest.fixture
def scene_dir(tmp_path):
    """A 3-view COLMAP scene written with the port's writers: 40 SfM points
    and ground truth rendered by the port from a hidden 40-Gaussian cloud,
    stored as PPM."""
    rng = np.random.default_rng(1234)
    sparse, images = tmp_path / "sparse", tmp_path / "images"
    sparse.mkdir()
    images.mkdir()
    tscenegen.write_cameras_bin(str(sparse / "cameras.bin"), FX, FX, W / 2, H / 2, W, H)
    tscenegen.write_images_bin(str(sparse / "images.bin"),
                               [(q, t, f"v{i}.ppm") for i, (q, t) in enumerate(POSES)])
    pts = tsyn.make_scene(40, seed=11, spread=0.6)
    tscenegen.write_points_bin(str(sparse / "points3D.bin"), t2n(pts.means),
                               rng.uniform(0, 1, (40, 3)))
    gt = tsyn.make_scene(40, seed=12, spread=0.6)
    raster = Config().raster.replace(pair_capacity=2048, pair_block=16)
    for i, (q, t) in enumerate(POSES):
        cam = tcam.make_camera(np.array(q, np.float32), np.array(t, np.float32),
                               FX, FX, W / 2, H / 2, W, H)
        with torch.no_grad():
            img, _ = trender(gt, cam, raster)
        timages.save_ppm(str(images / f"v{i}.ppm"), t2n(img))
    return tmp_path


def test_colmap_writers_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    pts, cols = rng.normal(size=(25, 3)), rng.uniform(0, 1, (25, 3))
    poses = [(np.array(q), np.array(t), f"v{i}.png") for i, (q, t) in enumerate(POSES)]
    for name, args in (("write_cameras_bin", (FX, 70.0, 31.5, 30.0, W, H)),
                       ("write_images_bin", (poses,)),
                       ("write_points_bin", (pts, cols))):
        getattr(tscenegen, name)(str(tmp_path / "t.bin"), *args)
        getattr(jscenegen, name)(str(tmp_path / "j.bin"), *args)
        assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes(), name


def test_load_colmap_scene_matches_jax(scene_dir, scipy_knn):
    args = (str(scene_dir / "sparse"), str(scene_dir / "images"))
    want = jdataset.load_colmap_scene(*args, JConfig())
    got = tdataset.load_colmap_scene(*args, Config(), device="cpu")
    assert got.extent == want.extent and got.resolutions == want.resolutions
    assert got.params.capacity == want.params.capacity == 1 << 17
    for f in ("means", "log_scales", "quats", "raw_opacities", "sh", "alive"):
        np.testing.assert_array_equal(t2n(getattr(got.params, f)),
                                      np.asarray(getattr(want.params, f)), err_msg=f)
    assert len(got.cameras) == len(want.cameras) == 3
    for gc, wc in zip(got.cameras, want.cameras):
        assert (gc.width, gc.height) == (wc.width, wc.height)
        for f in ("view", "proj", "viewproj", "cam_pos", "fx", "fy"):
            np.testing.assert_allclose(t2n(getattr(gc, f)), np.asarray(getattr(wc, f)),
                                       rtol=0, atol=1e-6, err_msg=f)
    for g, w in zip(got.gt_images, want.gt_images):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("knn_mode", ["reference", "exact"])
def test_initial_scales_above_10k_match_jax(knn_mode, scipy_knn):
    """Above knn_sample_threshold the reference samples 1000 points and
    gives every point their median kNN distance; 'exact' keeps per-point."""
    pts = np.random.default_rng(3).normal(size=(12_000, 3)).astype(np.float32)
    cols = np.random.default_rng(4).uniform(0, 1, (12_000, 3)).astype(np.float32)
    want = jinit.gaussians_from_points(pts, cols, 5.0, knn_mode=knn_mode)
    got = tinit.gaussians_from_points(pts, cols, 5.0, InitConfig(), knn_mode=knn_mode)
    for f in ("means", "log_scales", "quats", "raw_opacities", "sh"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (np.unique(got.log_scales).size == 1) == (knn_mode == "reference")


@pytest.mark.parametrize("fmt,size", [("ppm", None), ("png", None), ("ppm", (19, 11))])
def test_load_image_matches_jax(tmp_path, fmt, size):
    """Both packages decode (and resize) an image through PIL: equal bits."""
    from gaussiansplatting_tpu.io import images as jimages

    img = np.random.default_rng(5).uniform(0, 1, (23, 37, 3)).astype(np.float32)
    path = str(tmp_path / f"a.{fmt}")
    getattr(timages, f"save_{fmt}")(path, img)
    got = timages.load_image(path, target_size=size)
    assert got.dtype == np.float32 and got.shape == ((23, 37, 3) if size is None else (11, 19, 3))
    np.testing.assert_array_equal(got, jimages.load_image(path, target_size=size))


def _cli_args(scene_dir, out, cfg_path, extra=()):
    return ["--colmap", str(scene_dir / "sparse"), "--images", str(scene_dir / "images"),
            "--output", str(out / "out.ply"), "--config", cfg_path,
            "--capacity", "64", "--pair-capacity", "2048",
            "--checkpoint-dir", str(out / "ck"), "--checkpoint-interval", "2",
            "--metrics", str(out / "metrics.jsonl"), "--eval-split", "3", *extra]


def _write_config(path, blend_impl="auto"):
    cfg = JConfig(raster=JRasterConfig(pair_capacity=2048, pair_block=16, blend_impl=blend_impl),
                  train=JTrainConfig(epochs=2, log_interval=100))
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return str(path)


def test_train_cli_end_to_end(scene_dir, tmp_path, scipy_knn):
    """tests/test_tools.py::test_train_cli_end_to_end for the port, on the
    CPU: events, checkpoint, PLY, held-out eval, renders, then a resume."""
    from gaussiansplatting_tpu_torch.tools import train as train_cli

    out = tmp_path / "port"
    cfg_path = _write_config(tmp_path / "cfg.json")
    rc = train_cli.main(_cli_args(scene_dir, out, cfg_path, [
        "--export-renders", str(out / "renders"), "--device", "cpu"]))
    assert rc == 0
    lines = [json.loads(s) for s in open(out / "metrics.jsonl")]
    events = [s["event"] for s in lines]
    assert {"start", "scene", "step", "checkpoint", "trained", "eval", "export_ply",
            "export_renders"} <= set(events)
    steps = [s for s in lines if s["event"] == "step"]
    assert [s["iter"] for s in steps] == [1, 2, 3, 4]
    assert all(np.isfinite(s["loss"]) and not s["overflow"] and s["n"] == 40 for s in steps)
    scene = next(s for s in lines if s["event"] == "scene")
    assert (scene["views"], scene["eval_views"], scene["capacity"]) == (2, 1, 64)
    export = next(s for s in lines if s["event"] == "export_ply")
    assert export["n"] == export["alive"] == 40
    assert tply.load_gaussian_ply(str(out / "out.ply")).means.shape[0] == 40
    assert (out / "renders" / "view_0001.png").exists() and (out / "ck" / "latest.npz").exists()

    rc = train_cli.main(_cli_args(scene_dir, out, cfg_path, [
        "--resume", "--epochs", "1", "--device", "cpu"]))
    assert rc == 0
    lines = [json.loads(s) for s in open(out / "metrics.jsonl")]
    resume = [s for s in lines if s["event"] == "resume"]
    assert resume and resume[0]["iteration"] == 4
    assert [s["iter"] for s in lines if s["event"] == "step"][-2:] == [5, 6]
    assert [s for s in lines if s["event"] == "trained"][-1]["iteration"] == 6


def test_train_cli_matches_jax_cli(scene_dir, tmp_path, scipy_knn):
    """Both CLIs on the same scene and config (JAX on its windowed Pallas
    path) for 2 epochs: the same events and counts, the final checkpoints at
    the step bars, the PLYs of the same Gaussians."""
    from gaussiansplatting_tpu.tools import train as jtrain_cli
    from gaussiansplatting_tpu_torch.tools import train as ttrain_cli

    cfg_path = _write_config(tmp_path / "cfg.json", blend_impl="pallas")
    assert ttrain_cli.main(_cli_args(scene_dir, tmp_path / "port", cfg_path,
                                     ["--device", "cpu"])) == 0
    assert jtrain_cli.main(_cli_args(scene_dir, tmp_path / "jax", cfg_path)) == 0
    logs = {k: [json.loads(s) for s in open(tmp_path / k / "metrics.jsonl")]
            for k in ("port", "jax")}
    for k in ("port", "jax"):
        logs[k] = [{f: v for f, v in s.items() if f not in ("t", "path", "seconds", "msg")}
                   for s in logs[k] if s["event"] not in ("start", "info")]
    assert [s["event"] for s in logs["port"]] == [s["event"] for s in logs["jax"]]
    for got, want in zip(logs["port"], logs["jax"]):
        for f, w in want.items():
            if f in ("loss", "l1", "dssim", "psnr", "lr_pos", "mean_op", "mean_scale"):
                assert got[f] == pytest.approx(w, rel=1e-5, abs=1e-6), (want["event"], f)
            elif f == "eval":
                continue
            elif want["event"] == "eval" and f.startswith("psnr"):
                assert got[f] == pytest.approx(w, abs=2e-3), f
            else:
                assert got[f] == w, (want["event"], f)
    with np.load(tmp_path / "port" / "ck" / "latest.npz") as z:
        got = {k: z[k] for k in z.files}
    with np.load(tmp_path / "jax" / "ck" / "latest.npz") as z:
        want = {k: z[k] for k in z.files if k != "__meta__"}
    lrs = Config().optim
    lr0 = dict(zip(TRAINABLE, (lrs.position_lr_init, lrs.scale_lr, lrs.rotation_lr,
                               lrs.opacity_lr, lrs.sh_lr)))
    _compare_states(got, want, CLI_STEPS, lr0)
    tp = tply.load_gaussian_ply(str(tmp_path / "port" / "out.ply"))
    jp = tply.load_gaussian_ply(str(tmp_path / "jax" / "out.ply"))
    assert tp.means.shape == jp.means.shape == (40, 3)
    np.testing.assert_allclose(tp.means, jp.means, atol=3 * CLI_STEPS * lr0["means"])


def test_evaluate_cli_matches_jax(scene_dir, capsys, monkeypatch):
    """Both evaluation CLIs on a model that is not the ground truth; their
    rounding of the printed numbers is switched off here, so the PSNR is
    compared to 1e-4 dB, not to its last printed digit."""
    from gaussiansplatting_tpu.tools import evaluate as jeval
    from gaussiansplatting_tpu_torch.tools import evaluate as teval

    for mod in (jeval, teval):
        monkeypatch.setattr(mod, "round", lambda x, ndigits=None: x, raising=False)
    ply_path = str(scene_dir / "model.ply")
    model = tsyn.make_scene(40, seed=13, spread=0.6)
    tply.export_gaussian_ply(ply_path, tply.cloud_from_params(model))
    args = ["--ply", ply_path, "--colmap", str(scene_dir / "sparse"),
            "--images", str(scene_dir / "images"), "--pair-capacity", "2048"]
    assert teval.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jeval.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["views"] == want["views"] == 3
    assert 5.0 < want["psnr"] < 40.0
    assert abs(got["psnr"] - want["psnr"]) <= 1e-4
    assert got["l1"] == pytest.approx(want["l1"], abs=1e-6)
    assert got["ssim"] == pytest.approx(want["ssim"], abs=1e-5)


@pytest.mark.parametrize("flags,needle", [
    (["--device", "cuda"], "CUDA is not available"),
    (["--devices", "2"], "parallel/"),
    (["--coordinator", "localhost:1234"], "parallel/"),
    (["--batch-views", "0"], "train_step_batched"),
])
def test_train_cli_refuses_what_it_cannot_run(scene_dir, tmp_path, monkeypatch, flags, needle):
    """No fallback: --device cuda without CUDA (also for --devices 2's ranks
    and --coordinator's process group) and a batch of no views exit
    non-zero, naming the reason."""
    from gaussiansplatting_tpu_torch.tools import train as train_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path = _write_config(tmp_path / "cfg.json")
    with pytest.raises(SystemExit, match=needle) as e:
        train_cli.main(_cli_args(scene_dir, tmp_path / "out", cfg_path, flags))
    assert e.value.code != 0
    assert not (tmp_path / "out" / "out.ply").exists()


@pytest.mark.parametrize("flags,raster", [
    (["--payload-dtype", "bf16"], dict(payload_dtype="bf16", pack_positions=False)),
    (["--payload-dtype", "bf16", "--pack-positions", "1"],
     dict(payload_dtype="bf16", pack_positions=True)),
    (["--overflow-drop", "impact"], dict(overflow_drop="impact")),
], ids=["bf16", "pack_positions", "impact"])
def test_train_cli_modes(scene_dir, tmp_path, flags, raster):
    """The flags of the bf16 payload mode and the impact drop train on the
    CPU (the JAX tool's flags, tools/train.py:35-53): finite steps, the
    config they set saved in the checkpoint."""
    from gaussiansplatting_tpu_torch.tools import train as train_cli
    from gaussiansplatting_tpu_torch.train import checkpoint

    out = tmp_path / "out"
    cfg_path = _write_config(tmp_path / "cfg.json")
    assert train_cli.main(_cli_args(scene_dir, out, cfg_path,
                                    flags + ["--epochs", "1", "--device", "cpu"])) == 0
    steps = [s for s in map(json.loads, open(out / "metrics.jsonl")) if s["event"] == "step"]
    assert [s["iter"] for s in steps] == [1, 2]
    assert all(np.isfinite(s["loss"]) and not s["overflow"] for s in steps)
    _, cfg = checkpoint.load(str(out / "ck" / "latest.npz"), "cpu")
    assert {k: getattr(cfg.raster, k) for k in raster} == raster
