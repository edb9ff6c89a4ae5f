"""The port's HTTP viewer (gaussiansplatting_tpu_torch.tools.view) on the
CPU: the port of tests/test_tools.py's viewer test (page, state, a JPEG
frame), a frame's render against the JAX ViewerState's at the same orbit
state (within 2e-5, the image bar of tests/test_torch_render.py), and
/train against the JAX ViewerState.train on the same COLMAP scene and
checkpoint (loss within 1e-5 relative, as the port's train step is held to
JAX's).  Without CUDA, the viewer and make_dataset CLIs refuse their
default device."""

import argparse
import io
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from gaussiansplatting_tpu.core import camera as jcamera
from gaussiansplatting_tpu.io import ply as jply
from gaussiansplatting_tpu.tools import view as jview

from gaussiansplatting_tpu_torch.tools import view as tview
from gaussiansplatting_tpu_torch.train import checkpoint as tckpt
from gaussiansplatting_tpu_torch.train import state as tstate

from test_torch_train_cli import scene_dir, scipy_knn  # noqa: F401  (fixtures)
from torch_parity import scene_params

torch.set_num_threads(1)


def _serve(state):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), tview.make_handler(state))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _get(url, timeout=120):
    return urllib.request.urlopen(url, timeout=timeout).read()


@pytest.fixture
def ply_path(tmp_path):
    jp, _ = scene_params(31, n=40)
    path = str(tmp_path / "model.ply")
    jply.export_gaussian_ply(path, jply.cloud_from_params(jp))
    return path


def test_view_server_serves_frames(ply_path):
    from PIL import Image

    state = tview.build_state(ply_path, width=64, height=48, fov=60.0, sh_degree=0,
                              pair_capacity=2048, device="cpu")
    srv, base = _serve(state)
    try:
        assert b"viewer" in _get(base + "/", 30)
        st = json.loads(_get(base + "/state", 30))
        assert st["r"] > 0 and st["trainable"] is False
        jpg = _get(base + "/frame?az=0.5&el=0.2")
        assert jpg[:2] == b"\xff\xd8" and len(jpg) > 500   # JPEG SOI
        img = np.asarray(Image.open(io.BytesIO(jpg)))
        assert img.shape == (48, 64, 3) and img.std() > 0
        with pytest.raises(urllib.error.HTTPError):
            _get(base + "/train?n=1", 30)                     # no dataset attached
    finally:
        srv.shutdown()
        srv.server_close()


def test_frame_matches_jax_viewer(ply_path, monkeypatch):
    """The same PLY, orbit state and render size through both viewers."""
    jstate_ = jview.build_state(ply_path, 64, 48, 60.0, 0, 2048)
    tstate_ = tview.build_state(ply_path, 64, 48, 60.0, 0, 2048, device="cpu")
    np.testing.assert_allclose(tstate_.center, jstate_.center)
    assert tstate_.radius == pytest.approx(jstate_.radius, rel=1e-6)
    az, el, r = 0.7, 0.25, tstate_.radius
    cam = jcamera.orbit_camera(np.asarray(jstate_.center, np.float32), r, azimuth=az,
                               elevation=el, fx=jstate_.fy, fy=jstate_.fy, width=64,
                               height=48)
    want = np.asarray(jstate_._render(jstate_.params, cam, jstate_.cfg.raster)[0])
    got = tstate_.render(tstate_.camera(az, el, r, *tstate_.center))
    assert float(got.max() - got.min()) > 0.05
    np.testing.assert_allclose(got, want, atol=2e-5)
    # a frame rendered in another thread (a handler's) builds no autograd
    # graph: the thread starts with grad enabled, frame_jpeg turns it off
    from gaussiansplatting_tpu_torch.ops import rasterize

    seen, inner = [], rasterize.render

    def spy(*a, **k):
        seen.append(torch.is_grad_enabled())
        return inner(*a, **k)

    def frame():
        seen.append(torch.is_grad_enabled())
        tstate_.frame_jpeg(az, el, r, *tstate_.center)

    monkeypatch.setattr(rasterize, "render", spy)
    t = threading.Thread(target=frame)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and seen == [True, False]


def _args(scene_dir, checkpoint, device=None):  # noqa: F811
    a = argparse.Namespace(colmap=str(scene_dir / "sparse"), images=str(scene_dir / "images"),
                           checkpoint=checkpoint, downscale=1, iters=100, width=64, height=48,
                           fov=60.0, sh_degree=0, pair_capacity=2048)
    if device is not None:
        a.device = device
    return a


def test_train_route_matches_jax(scene_dir, scipy_knn, tmp_path):  # noqa: F811
    """/train?n=3 on the port's viewer against JAX's ViewerState.train(3),
    both resumed from one checkpoint at iteration 5 (the port writes it,
    JAX reads it), then the next frame at the same pose differs."""
    from gaussiansplatting_tpu_torch.config import Config
    from gaussiansplatting_tpu_torch.io.dataset import load_colmap_scene

    cfg = Config(raster=Config().raster.replace(pair_capacity=2048, pair_block=16))
    scene = load_colmap_scene(str(scene_dir / "sparse"), str(scene_dir / "images"), cfg,
                              capacity=64, device="cpu")
    st = tstate.create(scene.params)
    st.opt.t = 5
    ck = str(tmp_path / "ck.npz")
    tckpt.save(ck, st, cfg)

    jst = jview.build_training_state(_args(scene_dir, ck))
    want = jst.train(3)
    state = tview.build_training_state(_args(scene_dir, ck, "cpu"))
    assert state.iteration == 5 and state.tstate.params.capacity == 64
    srv, base = _serve(state)
    try:
        st = json.loads(_get(base + "/state", 30))
        assert st["trainable"] is True
        q = "/frame?az=0.3&el=0.2"
        before = _get(base + q)
        got = json.loads(_get(base + "/train?n=3", 300))
        after = _get(base + q)
    finally:
        srv.shutdown()
        srv.server_close()
    assert got["iteration"] == want["iteration"] == 8
    assert state.iteration == 8 and state.tstate.opt.t == 8
    assert np.isfinite(got["loss"]) and got["num_gaussians"] == want["num_gaussians"] == 40
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert before != after


@pytest.mark.parametrize("cli", ["view", "make_dataset"])
def test_cli_refuses_without_cuda(cli, tmp_path, ply_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is available")
    from gaussiansplatting_tpu_torch.tools import make_dataset

    argv = {"view": ["--ply", ply_path],
            "make_dataset": ["--out", str(tmp_path / "s"), "--views", "1"]}[cli]
    main = {"view": tview.main, "make_dataset": make_dataset.main}[cli]
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code not in (0, None) and "CUDA is not available" in str(e.value.code)
    assert not (tmp_path / "s").exists()
