"""The port's inference render dispatch (train/graph.render_frame, the
counterpart of every jax.jit(render, static_argnums=2) of the JAX tools and
facade) on the CPU: render_frame against ops.rasterize.render under
no_grad and against JAX's jitted render in the default, T-floor and bf16
modes, the render graphs' key, the render and step caches evicting
independently, and the tools and the facade routed through render_frame.
On the CPU render_frame runs the render eagerly (the caller asked for the
CPU); the capture and the replays run on the card (the cuda-marked tests
here, and chip_smoke.py phase 13 at full size).

Tolerances: render_frame equals render bit for bit (the same ops); against
JAX within 2e-5 (tests/test_torch_render.py's image bar) with JAX's
Pallas kernels in interpret mode under GS_BLEND_POWER=vpu, the quadratic
form the port evaluates (ROADMAP.md §C), at a pair capacity no other test
traces JAX's render with (a jitted trace is reused across test files of
one worker, whatever the power form).  Pair counts and overflow flags
exact."""

import os

import numpy as np
import pytest
import torch

import jax

from gaussiansplatting_tpu.ops.rasterize import render as jrender

from gaussiansplatting_tpu_torch.ops import rasterize as traster
from gaussiansplatting_tpu_torch.train import graph as tgraph
from gaussiansplatting_tpu_torch.train import state as tstate

from test_torch_graph import _bits, _moved, _sh0
from torch_parity import cameras, configs, scene_params, t2n

torch.set_num_threads(1)

CAP = 6144
MODES = {"default": {}, "tfloor": dict(t_floor_exact=True), "bf16": dict(payload_dtype="bf16")}


@pytest.mark.parametrize("mode", list(MODES))
def test_render_frame_is_render_and_matches_jax(mode, monkeypatch):
    """render_frame on the CPU: render under no_grad bit for bit (image and
    aux), no graph captured, and JAX's jax.jit(render, static_argnums=2)
    within 2e-5 with the same pair count."""
    monkeypatch.setenv("GS_BLEND_POWER", "vpu")
    jp, tp = scene_params(41, n=48)
    jc, tc = cameras()
    jcfg, tcfg = configs(pair_capacity=CAP, **MODES[mode])
    captures = tgraph.counts["render_captures"]
    img, aux = tgraph.render_frame(tp, tc, tcfg)
    assert not img.requires_grad
    with torch.no_grad():
        ref, ref_aux = traster.render(tp, tc, tcfg)
    np.testing.assert_array_equal(_bits(t2n(img)), _bits(t2n(ref)))
    assert all(torch.equal(x, y) for x, y in zip(aux, ref_aux))
    img_j, aux_j = jax.jit(jrender, static_argnums=2)(jp, jc, jcfg)
    assert int(aux.num_pairs) == int(aux_j.num_pairs) > 0
    assert bool(aux.overflow) == bool(aux_j.overflow) is False
    np.testing.assert_allclose(t2n(img), np.asarray(img_j), atol=2e-5)
    assert tgraph.counts["render_captures"] == captures and not tgraph.live_renders()


@pytest.mark.parametrize("change", ["capacity", "resolution", "pair_capacity", "t_floor_exact",
                                    "payload_dtype", "sh_width", "inputs"])
def test_render_key(change):
    """The render graph's key changes with the capacity, W/H, the
    RasterConfig (pair capacity, T-floor, payload) and the SH width, not
    with the parameters' values or the pose."""
    _, tp = scene_params(21, n=48)
    _, tc = cameras()
    cfg = configs()[1]
    key = tgraph.render_key(tp, tc, cfg)
    if change == "capacity":
        other = tgraph.render_key(tstate.grow(tstate.create(tp), 64).params, tc, cfg)
    elif change == "resolution":
        other = tgraph.render_key(tp, cameras(64, 32)[1], cfg)
    elif change == "sh_width":
        other = tgraph.render_key(_sh0(tp), tc, cfg)
    elif change == "inputs":
        other = tgraph.render_key(scene_params(22, n=48)[1], _moved(tc, 0.1), cfg)
    else:
        value = {"pair_capacity": 4096, "t_floor_exact": True, "payload_dtype": "bf16"}[change]
        other = tgraph.render_key(tp, tc, cfg.replace(**{change: value}))
    assert (other == key) == (change == "inputs")


class _Fake:
    def __init__(self, name, freed):
        self.name, self.freed = name, freed

    def free(self):
        self.freed.append(self.name)


def test_render_and_step_caches_evict_independently(monkeypatch):
    """Each cache keeps its own bound: renders past MAX_RENDER_GRAPHS free
    the least recently used render graph and no step graph, a hit moves a
    graph to the back, and clear() frees both caches."""
    monkeypatch.setattr(tgraph, "_steps", tgraph._LRU(tgraph.MAX_GRAPHS))
    monkeypatch.setattr(tgraph, "_renders", tgraph._LRU(tgraph.MAX_RENDER_GRAPHS))
    freed = []

    def get(cache, name):
        return cache.get(name, lambda: _Fake(name, freed))

    steps = [get(tgraph._steps, ("step", i)) for i in range(tgraph.MAX_GRAPHS)]
    for i in range(tgraph.MAX_RENDER_GRAPHS):
        get(tgraph._renders, ("render", i))
    get(tgraph._renders, ("render", 0))                  # a hit: now the most recent
    get(tgraph._renders, ("render", "new"))
    assert freed == [("render", 1)]
    assert tgraph.live() == steps
    assert [g.name for g in tgraph.live_renders()][-2:] == [("render", 0), ("render", "new")]
    get(tgraph._steps, ("step", "new"))
    assert freed == [("render", 1), ("step", 0)]
    assert len(tgraph.live_renders()) == tgraph.MAX_RENDER_GRAPHS
    tgraph.clear()
    assert not tgraph.live() and not tgraph.live_renders() and len(freed) == 2 + \
        tgraph.MAX_GRAPHS + tgraph.MAX_RENDER_GRAPHS


def _counting(monkeypatch):
    """graph.render_frame wrapped to count its calls."""
    calls = []
    real = tgraph.render_frame

    def counted(params, camera, raster_cfg):
        calls.append((camera.width, camera.height))
        return real(params, camera, raster_cfg)

    monkeypatch.setattr(tgraph, "render_frame", counted)
    return calls


def test_tools_and_facade_render_through_render_frame(tmp_path, monkeypatch):
    """tools.render (each orbit view), the viewer's frame and the facade's
    render go through graph.render_frame, and their images are render's
    under no_grad bit for bit."""
    from gaussiansplatting_tpu_torch.config import Config
    from gaussiansplatting_tpu_torch.io import images, ply
    from gaussiansplatting_tpu_torch.models.gaussian_model import GaussianModel
    from gaussiansplatting_tpu_torch.tools import render as render_cli
    from gaussiansplatting_tpu_torch.tools import view

    calls = _counting(monkeypatch)
    _, tp = scene_params(21, n=48)
    _, tc = cameras()
    cfg = Config(raster=configs()[1])
    with torch.no_grad():
        want = t2n(traster.render(tp, tc, cfg.raster)[0])

    model = GaussianModel.from_params(tp, cfg, device="cpu")
    np.testing.assert_array_equal(_bits(model.render(tc)), _bits(want))
    assert calls == [(64, 48)]

    state = view.ViewerState(tp, cfg, 64, 48, 60.0, np.zeros(3, np.float32), 3.0)
    np.testing.assert_array_equal(_bits(state.render(tc)), _bits(want))
    assert len(calls) == 2

    path = os.path.join(tmp_path, "scene.ply")
    ply.export_gaussian_ply(path, ply.cloud_from_params(tp))
    out = os.path.join(tmp_path, "orbit")
    assert render_cli.main(["--ply", path, "--output", out, "--orbit", "2", "--width", "32",
                            "--height", "24", "--pair-capacity", "2048", "--device", "cpu"]) == 0
    assert calls[2:] == [(32, 24)] * 2
    assert images.load_image(os.path.join(out, "orbit_001.png")).shape == (24, 32, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_render_replays_equal_eager_renders_cuda(mode):
    """On the card: replays of the captured render against eager renders,
    bit for bit, for two poses and two parameter sets; the forward kernels
    (blends and compose) counted once per replay as the capture recorded;
    one capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the render graph is captured on the card")
    from gaussiansplatting_tpu_torch.utils import synthetic

    cfg = configs(pair_capacity=1 << 14, **MODES[mode])[1]
    cam = synthetic.make_canonical_camera(64, 48, device="cuda")
    captures = tgraph.counts["render_captures"]
    for seed in (4, 5):
        params = synthetic.make_scene(300, seed=seed, device="cuda")
        for c in (cam, _moved(cam, 0.02).to("cuda")):
            before = tgraph.launch_counts()
            img, aux = tgraph.render_frame(params, c, cfg)
            torch.cuda.synchronize()
            after = tgraph.launch_counts()
            with torch.no_grad():
                ref, ref_aux = traster.render(params, c, cfg)
            assert torch.equal(img, ref) and all(torch.equal(x, y) for x, y in zip(aux, ref_aux))
    graph = tgraph.live_renders()[-1]
    assert tgraph.counts["render_captures"] == captures + 1
    assert {k: after[k] - before[k] for k in graph.launches} == graph.launches
    blends = {k: n for k, n in graph.launches.items() if k.startswith("windowed_blend_")}
    assert sum(blends.values()) == (2 if mode == "tfloor" else 1)
    assert graph.launches["compose_fwd"] == 1
    tgraph.clear()


@pytest.mark.cuda
def test_render_capture_failure_names_the_line_cuda(monkeypatch):
    """A render that reads the card back fails its capture: the error names
    that line, no render graph is kept, and nothing falls back to eager."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the render graph is captured on the card")
    from gaussiansplatting_tpu_torch.utils import synthetic

    real = traster.render

    def syncing(params, camera, cfg, **kw):
        img, aux = real(params, camera, cfg, **kw)
        int(aux.num_pairs)                      # reads the card back to the host
        return img, aux

    monkeypatch.setattr(traster, "render", syncing)
    tgraph.clear()
    with pytest.raises(RuntimeError, match="capturing the render failed at .*test_torch_"
                                           "render_graph.py.*int\\(aux.num_pairs\\)"):
        tgraph.render_frame(synthetic.make_scene(300, seed=4, device="cuda"),
                            synthetic.make_canonical_camera(64, 48, device="cuda"),
                            configs(pair_capacity=1 << 14)[1])
    assert not tgraph.live_renders()
