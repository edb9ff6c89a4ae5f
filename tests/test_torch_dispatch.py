"""The last dispatches of train/graph.py on the CPU: the sharded steps' and
render's graph keys and the backend rule that decides which ranks replay
(parallel/sharded.replays), the density events with the iteration as a
0-d tensor (what their CUDA graphs read) against the Python-int form and
densify_step against JAX's jitted densify_step, the density events' graph
key and cache, and the garden's tracer with the pose in buffers (what its
CUDA graph reads) against render_view_tensor and JAX.  On the CPU the
eager bodies run (the caller asked for the CPU); the captures and the
replays run on the card (the cuda-marked tests here, and chip_smoke.py
phase 14 at full size).

Tolerances: the tensor-iteration decisions and events equal the int form
bit for bit; densify_step against JAX at tests/test_torch_density.py's
bars (integers exact, floats within 1e-6); the tracer with its pose in
buffers equals render_view_tensor bit for bit and is held to JAX's
op-by-op renderer at tests/test_torch_scenegen.py's bars."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussiansplatting_tpu.config import Config as JConfig
from gaussiansplatting_tpu.train import trainer as jtrainer
from gaussiansplatting_tpu.utils import scenegen as J

from gaussiansplatting_tpu_torch.config import Config, OptimConfig
from gaussiansplatting_tpu_torch.core.camera import quat_to_rotmat_np
from gaussiansplatting_tpu_torch.density import control as tdensity
from gaussiansplatting_tpu_torch.parallel import mesh as mesh_mod
from gaussiansplatting_tpu_torch.parallel import sharded
from gaussiansplatting_tpu_torch.train import graph as tgraph
from gaussiansplatting_tpu_torch.train import state as tstate
from gaussiansplatting_tpu_torch.train import trainer as ttrainer
from gaussiansplatting_tpu_torch.utils import scenegen

from test_torch_density import FLOAT_ATOL, _flat, _state_pair
from test_torch_graph import _moved, _sh0
from test_torch_scenegen import FX, H, W, _flagged, _j, _jax_view, _judge, _t
from torch_parity import cameras, configs, scene_params, t2n
import torch_sharding_ranks as ranks

torch.set_num_threads(1)

EXTENT = 10.0
FOCAL = 100.0
# both sides of the densify window (500, 15000) and of the opacity reset
# interval (3000, after which screen pruning starts) of the default
# DensityConfig
ITERATIONS = [500, 501, 2999, 3000, 3001, 3500, 14999, 15000]


def _bits(x):
    return np.ascontiguousarray(t2n(x)).reshape(-1).view(np.uint8)


# ------------------------------------------------------------ sharded


@pytest.mark.parametrize("backend,device,replays", [
    ("gloo", "cpu", False), ("gloo", "cuda", False), ("nccl", "cuda", True),
    ("nccl", "cpu", False)])
def test_backend_rule_decides_the_replays(backend, device, replays):
    """Only a CUDA rank of an NCCL group replays: gloo's collectives run on
    the host (on the CPU, or ranks sharing a card), where no capture can
    hold them."""
    assert sharded.replays(backend, torch.device(device)) is replays


_SHARDED_CHANGES = ["body", "views", "size", "rank", "backend", "chunks", "capacity",
                    "resolution", "config", "sh_width", "inputs"]


@pytest.mark.parametrize("change", _SHARDED_CHANGES)
def test_sharded_key(change):
    """The sharded cache's key changes with each of its fields (the body,
    views per replay, the mesh's size and rank, the backend, the chunks
    and step_key's), not with the pose, the ground truth or t."""
    _, tp = scene_params(21, n=48)
    _, tc = cameras()
    cfg = Config(raster=configs()[1])
    st = tstate.create(tp)
    mesh = mesh_mod.Mesh(None, 2, 0)
    args = dict(body=sharded.step_body, views=None, mesh=mesh, backend="nccl", chunks=1,
                state=st, camera=tc, cfg=cfg)
    other = dict(args)
    if change == "body":
        other["body"] = sharded.batched_body
    elif change == "views":
        other["views"] = 2
    elif change == "size":
        other["mesh"] = mesh_mod.Mesh(None, 4, 0)
    elif change == "rank":
        other["mesh"] = mesh_mod.Mesh(None, 2, 1)
    elif change == "backend":
        other["backend"] = "gloo"
    elif change == "chunks":
        other["chunks"] = 4
    elif change == "capacity":
        other["state"] = tstate.grow(st, 64)
    elif change == "resolution":
        other["camera"] = cameras(64, 32)[1]
    elif change == "config":
        other["cfg"] = cfg.replace(optim=OptimConfig(position_lr_init=2e-3))
    elif change == "sh_width":
        other["state"] = tstate.create(_sh0(tp))
    else:
        stepped, _ = ttrainer.train_step(st, tc, torch.rand(48, 64, 3), cfg, 100)
        other.update(state=stepped, camera=_moved(tc, 0.05))
    key, changed = tgraph.sharded_key(**args), tgraph.sharded_key(**other)
    assert (changed == key) == (change == "inputs")
    assert tgraph.sharded_render_key(sharded.render_body, mesh, "nccl", tp, tc, cfg.raster) != \
        tgraph.sharded_render_key(sharded.render_body, mesh_mod.Mesh(None, 2, 1), "nccl", tp,
                                  tc, cfg.raster)


# ------------------------------------------------------------ density


def _event_case(iteration):
    """tests/test_torch_density.py::_state_pair's state (20 Gaussians in 32
    slots, random scales, opacities, moments and accumulators) at
    ``iteration``: (JAX state, port state)."""
    js, ts = _state_pair(seed=3)
    js = js.replace(opt=js.opt.replace(t=jnp.int32(iteration)))
    return js, dataclasses.replace(ts, opt=dataclasses.replace(ts.opt, t=iteration))


@pytest.mark.parametrize("iteration", ITERATIONS)
def test_tensor_iteration_equals_int_iteration(iteration):
    """decide and apply given the iteration as a 0-d int32 tensor (what a
    captured event reads from its buffer) against the Python int, bit for
    bit: every decision, destination and count, every output array."""
    _, ts = _event_case(iteration)
    cfg = Config().density
    focal = torch.tensor(FOCAL, dtype=torch.float32)
    it = torch.tensor(iteration, dtype=torch.int32)
    args = (EXTENT, focal, 2.0 * EXTENT, cfg)
    want = tdensity.decide(ts.params, ts.accum, iteration, *args)
    got = tdensity.decide(ts.params, ts.accum, it, *args)
    for f in ("prune", "clone", "split", "primary_dst", "secondary_dst"):
        np.testing.assert_array_equal(_bits(getattr(got, f)), _bits(getattr(want, f)), f)
    assert tuple(map(int, got.stats)) == tuple(map(int, want.stats))
    r = torch.empty((ts.params.capacity, 3)).uniform_(
        -1.0, 1.0, generator=torch.Generator().manual_seed(5))
    (pa, oa, aa, sa), (pb, ob, ab, sb) = (
        tdensity.apply(ts.params, ts.opt, ts.accum, x, r, EXTENT, focal, 2.0 * EXTENT, cfg)
        for x in (iteration, it))
    a = tstate.state_to_numpy(tstate.TrainState(pa, oa, aa, None))
    b = tstate.state_to_numpy(tstate.TrainState(pb, ob, ab, None))
    assert [k for k in a if a[k].tobytes() != b[k].tobytes()] == []
    assert [_bits(x).tobytes() for x in sa] == [_bits(x).tobytes() for x in sb]
    # the case exercises each side: densify only inside the window, screen
    # pruning only past the reset interval
    inside = 500 < iteration < 15_000
    assert (int(want.stats.cloned) + int(want.stats.split) > 0) == inside
    before = tdensity.decide(ts.params, ts.accum, 2999, *args)
    if iteration == 3000:
        assert int(want.stats.pruned) == int(before.stats.pruned)
    if iteration == 3001:
        assert int(want.stats.pruned) > int(before.stats.pruned)


@pytest.mark.parametrize("iteration", [1000, 3500])
def test_densify_step_fed_jax_draw_matches_jax(iteration, monkeypatch):
    """densify_step with JAX's split draw injected (JAX splits the state's
    key and draws uniform(sub, (C, 3), -1, 1)) against JAX's jitted
    densify_step: stats and every integer exact, floats within
    FLOAT_ATOL."""
    js, ts = _event_case(iteration)
    _, sub = jax.random.split(js.key)
    draw = np.array(jax.random.uniform(sub, (ts.params.capacity, 3), jnp.float32, -1.0, 1.0))
    monkeypatch.setattr(tdensity, "draw_split_offsets",
                        lambda generator, capacity, device: torch.from_numpy(draw.copy()))
    jout, jstats = jtrainer.densify_step(js, EXTENT, jnp.float32(FOCAL), JConfig())
    tout, tstats = ttrainer.densify_step(ts, EXTENT, torch.tensor(FOCAL), Config())
    assert tuple(map(int, tstats)) == tuple(int(x) for x in jstats)
    assert int(tstats.cloned) + int(tstats.split) > 0
    want = {k: np.asarray(v) for k, v in _flat(jout).items() if k != "key"}
    got = tstate.state_to_numpy(tout)
    assert sorted(got) == sorted(want)
    for k in want:
        if want[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=FLOAT_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


_EVENT_CHANGES = ["body", "capacity", "device", "sh_width", "density", "scene_extent",
                  "inputs"]


@pytest.mark.parametrize("change", _EVENT_CHANGES)
def test_event_key(change):
    """The density cache's key changes with each of its fields (the event's
    body, the capacity, the device, the SH width, the DensityConfig and
    the scene extent), not with the iteration, the draw, the focal length
    or any value of the state."""
    _, ts = _state_pair(seed=3)
    cfg = Config()
    key = tgraph.event_key(ttrainer.densify_body, ts, cfg, EXTENT)
    body, st, c, extent = ttrainer.densify_body, ts, cfg, EXTENT
    if change == "body":
        body = ttrainer.opacity_reset_body
    elif change == "capacity":
        st = tstate.grow(ts, 48)
    elif change == "device":
        st = tstate.state_from_numpy(tstate.state_to_numpy(ts), "meta")
    elif change == "sh_width":
        st = tstate.create(_sh0(ts.params))
    elif change == "density":
        c = cfg.replace(density=cfg.density.replace(grad_threshold=1e-3))
    elif change == "scene_extent":
        extent = 2.0 * EXTENT
    else:
        st, _ = ttrainer.densify_step(ts, EXTENT, torch.tensor(FOCAL), cfg)
        c = cfg.replace(optim=OptimConfig(position_lr_init=2e-3))
    assert (tgraph.event_key(body, st, c, extent) == key) == (change == "inputs")


class _Fake:
    def __init__(self, name, freed):
        self.name, self.freed = name, freed

    def free(self):
        self.freed.append(self.name)


def test_density_and_step_caches_evict_independently(monkeypatch):
    """Density events past MAX_DENSITY_GRAPHS free the least recently used
    event graph and never a step graph (a loop's densify events keep the
    step it replays between them); clear() frees both caches."""
    monkeypatch.setattr(tgraph, "_steps", tgraph._LRU(tgraph.MAX_GRAPHS))
    monkeypatch.setattr(tgraph, "_events", tgraph._LRU(tgraph.MAX_DENSITY_GRAPHS))
    freed = []

    def get(cache, name):
        return cache.get(name, lambda: _Fake(name, freed))

    steps = [get(tgraph._steps, ("step", i)) for i in range(tgraph.MAX_GRAPHS)]
    for i in range(tgraph.MAX_DENSITY_GRAPHS + 2):
        get(tgraph._events, ("event", i))
    assert freed == [("event", 0), ("event", 1)]
    assert tgraph.live() == steps
    assert [g.name for g in tgraph.live_events()] == [("event", 2), ("event", 3)]
    tgraph.clear()
    assert not tgraph.live() and not tgraph.live_events()
    assert len(freed) == 4 + tgraph.MAX_GRAPHS


def test_cpu_events_capture_nothing():
    """On the CPU densify_step and opacity_reset_step are the eager forms,
    bit for bit, and no graph is captured."""
    _, ts = _state_pair(seed=4)
    ts = tstate.TrainState(ts.params, ts.opt.__class__(ts.opt.m, ts.opt.v, 1000), ts.accum,
                           tstate.make_generator(3))
    cfg = Config()
    before = dict(tgraph.counts)
    a, sa = ttrainer.densify_step(ts, EXTENT, torch.tensor(FOCAL), cfg)
    b, sb = ttrainer.densify_step_eager(ts, EXTENT, torch.tensor(FOCAL), cfg)
    ra, rb = ttrainer.opacity_reset_step(ts, cfg), ttrainer.opacity_reset_step_eager(ts, cfg)
    for x, y in ((a, b), (ra, rb)):
        x, y = tstate.state_to_numpy(x), tstate.state_to_numpy(y)
        assert [k for k in x if x[k].tobytes() != y[k].tobytes()] == []
    assert tuple(map(int, sa)) == tuple(map(int, sb))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert dict(tgraph.counts) == before and not tgraph.live_events()


# ------------------------------------------------------------ the tracer


def _pose(view):
    q, t, _ = scenegen.camera_ring_poses(8, seed=0)[view]
    return quat_to_rotmat_np(q), t


def _traced_from_buffers(view, first=0):
    """The tracer as its graph runs it: the pose of view ``first`` in
    static buffers, then view ``view``'s copied in, the constants made
    once."""
    rows, eye = (x.clone() for x in scenegen.pose_tensors(*_pose(first)))
    consts = scenegen.scene_constants()
    for dst, src in zip((rows, eye), scenegen.pose_tensors(*_pose(view))):
        dst.copy_(src)
    return scenegen.trace(rows, eye, FX, FX, W / 2, H / 2, W, H, consts)


@pytest.mark.parametrize("view", [1, 2])
def test_trace_from_buffers_equals_render_view_tensor(view):
    """The tracer body reading its pose from buffers that held another
    view equals render_view_tensor bit for bit on the CPU."""
    got = _traced_from_buffers(view)
    want = scenegen.render_view_tensor(*_pose(view), FX, FX, W / 2, H / 2, W, H)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert tgraph.counts["trace_captures"] == 0


def test_trace_from_buffers_matches_jax():
    """The tracer body with its pose in buffers against JAX's
    _render_view_jit body op by op, at tests/test_torch_scenegen.py's
    bars (flagged pixels excused, at most 0.5%)."""
    R, t = _pose(1)
    got = _traced_from_buffers(1).numpy()
    want = _jax_view(R, t)
    eye, d = (x.reshape(-1, 3).numpy() for x in scenegen.camera_rays(R, t, FX, FX, W / 2, H / 2,
                                                                     W, H))
    sj, bj, _, _ = J._scene_arrays(jnp)
    st, bt, _, _ = scenegen._scene_arrays()
    with jax.disable_jit():
        tj, hj, nj, pj = (np.asarray(x) for x in J._intersect(jnp, sj, bj, *_j(eye, d)))
    _, ht, _, pt = (x.numpy() for x in scenegen._intersect(st, bt, *_t(eye, d)))
    p = (eye + tj[:, None] * d).astype(np.float32)
    flips = (hj != ht) | (pj != pt) | (hj & _flagged(p, nj, pj))
    _judge("trace from buffers", np.abs(got - want).reshape(-1, 3).max(1), flips)


def test_trace_key():
    """One tracer graph per resolution, intrinsics and device."""
    key = tgraph.trace_key(FX, FX, W / 2, H / 2, W, H, "cpu")
    assert key == tgraph.trace_key(FX, FX, W / 2, H / 2, W, H, torch.device("cpu"))
    for other in (tgraph.trace_key(FX * 2, FX, W / 2, H / 2, W, H, "cpu"),
                  tgraph.trace_key(FX, FX, W / 2, H / 2 + 1, W, H, "cpu"),
                  tgraph.trace_key(FX, FX, W / 2, H / 2, W, H + 1, "cpu"),
                  tgraph.trace_key(FX, FX, W / 2, H / 2, W, H, "meta")):
        assert other != key


# ------------------------------------------------------------ on the card


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graphs are captured on the card")


@pytest.mark.cuda
def test_event_replays_equal_eager_events_cuda():
    """On the card: densify_step and opacity_reset_step replay their graphs
    (one capture each), bit for bit the eager events from one state
    (state, stats and generator), at two iterations of one key."""
    _needs_card()
    _, host = _state_pair(seed=3)
    cfg = Config()
    captures = tgraph.counts["density_captures"]
    for it in (1000, 3500):
        arrays = tstate.state_to_numpy(host)
        arrays["opt/t"] = np.asarray(it, np.int32)
        st = tstate.state_from_numpy(arrays, "cuda", seed=3)
        fx = torch.tensor(FOCAL, device="cuda")
        a, sa = ttrainer.densify_step(st, EXTENT, fx, cfg)
        b, sb = ttrainer.densify_step_eager(st, EXTENT, fx, cfg)
        x, y = tstate.state_to_numpy(a), tstate.state_to_numpy(b)
        assert all(x[k].tobytes() == y[k].tobytes() for k in x)
        assert all(torch.equal(p, q) for p, q in zip(sa, sb))
        assert torch.equal(a.generator.get_state(), b.generator.get_state())
        ra, rb = ttrainer.opacity_reset_step(st, cfg), ttrainer.opacity_reset_step_eager(st, cfg)
        x, y = tstate.state_to_numpy(ra), tstate.state_to_numpy(rb)
        assert all(x[k].tobytes() == y[k].tobytes() for k in x)
    assert tgraph.counts["density_captures"] == captures + 2
    tgraph.clear()


@pytest.mark.cuda
def test_event_capture_failure_names_the_line_cuda(monkeypatch):
    """A density event whose body reads its iteration back to the host
    fails its capture, naming that line; no graph is kept and nothing falls
    back to the eager event."""
    _needs_card()
    _, host = _state_pair(seed=3)
    st = tstate.state_from_numpy(tstate.state_to_numpy(host), "cuda", seed=3)
    real = ttrainer.densify_body

    def syncing(state, iteration, r, focal, cfg, scene_extent):
        int(iteration)                          # reads the card back to the host
        return real(state, iteration, r, focal, cfg, scene_extent)

    monkeypatch.setattr(ttrainer, "densify_body", syncing)
    with pytest.raises(RuntimeError, match="capturing the density event .* failed at .*int"):
        ttrainer.densify_step(st, EXTENT, torch.tensor(FOCAL, device="cuda"), Config())
    assert not tgraph.live_events()
    tgraph.clear()


@pytest.mark.cuda
def test_trace_replays_equal_eager_views_cuda():
    """On the card: render_view_tensor replays one graph for four views,
    each bit for bit the eager view."""
    _needs_card()
    captures = tgraph.counts["trace_captures"]
    for view in range(4):
        R, t = _pose(view)
        got = scenegen.render_view_tensor(R, t, FX, FX, W / 2, H / 2, W, H, "cuda")
        want = scenegen.render_view_tensor_eager(R, t, FX, FX, W / 2, H / 2, W, H, "cuda")
        assert torch.equal(got, want), view
    assert tgraph.counts["trace_captures"] == captures + 1
    tgraph.clear()


@pytest.mark.cuda
def test_sharded_replays_equal_eager_cuda():
    """On the card, one NCCL rank: the sharded step, batched step and
    render replay their graphs (three captures), bit for bit the bodies
    run eagerly."""
    _needs_card()
    from gaussiansplatting_tpu_torch.parallel import launch

    out = launch.spawn(ranks.nccl_graph_checks, 1, device="cuda")[0]
    assert out == {"step": True, "batched": True, "render": True, "captures": 3}
