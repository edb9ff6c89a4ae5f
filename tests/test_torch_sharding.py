"""The port's tile-strip sharding (parallel/) on the CPU: two gloo ranks
started by ``parallel.launch.spawn`` against JAX's make_sharded_* over
make_mesh(2) on the suite's virtual 8-CPU mesh (JAX on its windowed Pallas
path) and against the port's single-process steps; the chunked gradient
all-reduce; the ranks' states; a sharded train_loop across density events;
the sharded bodies (scalars passed in) against their float-scalar forms and
the gloo ranks' graph counts (none); launch.initialize without a group; tools.train --devices 2;
graft_entry.dryrun_multichip(2); and the refusals.

One spawn (the module fixture) runs every rank-side check of
torch_sharding_ranks.sharded_checks.  Bars: JAX's own
(tests/test_sharding.py:87-103): loss rtol 1e-5, parameters atol 2e-5,
accumulators atol 1e-4, pair counts exact; against the port's single
process the same bars and grad_count exact; chunked against unchunked and
rank against rank bit for bit (two ranks: each element of a sum is one
addition)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussiansplatting_tpu.config import Config as JConfig
from gaussiansplatting_tpu.core import gaussians as JG
from gaussiansplatting_tpu.ops.rasterize import render as jrender
from gaussiansplatting_tpu.parallel import mesh as jmesh
from gaussiansplatting_tpu.parallel import sharded as jsharded
from gaussiansplatting_tpu.train import state as jstate

from gaussiansplatting_tpu_torch.config import Config, DensityConfig, RasterConfig
from gaussiansplatting_tpu_torch.core import gaussians as TG
from gaussiansplatting_tpu_torch.ops.rasterize import render
from gaussiansplatting_tpu_torch.parallel import launch
from gaussiansplatting_tpu_torch.parallel import mesh as mesh_mod
from gaussiansplatting_tpu_torch.parallel import sharded
from gaussiansplatting_tpu_torch.train import state as tstate
from gaussiansplatting_tpu_torch.train import trainer as ttrainer

import torch_sharding_ranks as ranks
from conftest import make_camera_for_scene, make_scene
from test_torch_train import _jax_state_arrays
from test_torch_train_cli import _cli_args, _write_config, scene_dir, scipy_knn  # noqa: F401
from torch_parity import configs, to_torch_camera

torch.set_num_threads(1)

LOSS_RTOL, PARAM_ATOL, ACCUM_ATOL = 1e-5, 2e-5, 1e-4
TRAINABLE = ("means", "log_scales", "quats", "raw_opacities", "sh")
LOOP_DENSITY = dict(densify_from_iter=1, densify_until_iter=50, densify_interval=3,
                    opacity_reset_interval=8, grad_threshold=1e-9)


def _params(seed, n=48, capacity=None):
    """tests/test_sharding.py::_params: (JAX params, their host arrays)."""
    means, log_scales, quats, raw_op, sh_dc = make_scene(np.random.default_rng(seed), n=n,
                                                         spread=0.6)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    jp = JG.from_arrays(means, log_scales, quats, raw_op, sh, capacity=capacity)
    return jp, {f: np.asarray(getattr(jp, f)) for f in TG.FIELDS}


@pytest.fixture(scope="module")
def case():
    jr, _ = configs()
    jcams = [make_camera_for_scene(64, 64, fov_scale=s) for s in (1.2, 1.0)]
    target_j, target = _params(1234)
    gt = np.array(jrender(target_j, jcams[0], jr)[0])   # writable: torch.from_numpy
    gt2 = np.clip(gt * 0.8 + 0.1, 0.0, 1.0).astype(np.float32)
    start_j, start = _params(99)
    loop_cam = make_camera_for_scene(64, 48)
    loop_start_j, loop_start = _params(11, n=24, capacity=96)
    c = {"target": target, "params": start, "gts": [gt, gt2],
         "cams": [ranks.camera_arrays(to_torch_camera(j)) for j in jcams],
         "loop": {"start": loop_start, "camera": ranks.camera_arrays(to_torch_camera(loop_cam)),
                  "gt": np.array(jrender(target_j, loop_cam, jr)[0]),
                  "density": LOOP_DENSITY, "epochs": 10}}
    out = launch.spawn(ranks.sharded_checks, 2, (c,), device="cpu")
    return c, {"jcams": jcams, "target": target_j, "start": start_j}, out


def _tstate(arrays):
    return tstate.create(TG.params_from_numpy(arrays))


def _compare(got, want, label, grad_count=True):
    """JAX's sharding bars on the parameters and the accumulators."""
    for f in TRAINABLE:
        np.testing.assert_allclose(got[f"params/{f}"], want[f"params/{f}"], atol=PARAM_ATOL,
                                   err_msg=f"{label} {f}")
    np.testing.assert_allclose(got["accum/grad_accum"], want["accum/grad_accum"],
                               atol=ACCUM_ATOL, err_msg=label)
    if grad_count:
        np.testing.assert_array_equal(got["accum/grad_count"], want["accum/grad_count"])


def test_ranks_ran_a_two_rank_gloo_group(case):
    _, _, out = case
    for rank, o in enumerate(out):
        assert o["topo"]["backend"] == "gloo" and o["topo"]["process_index"] == rank
        assert o["topo"]["process_count"] == 2 and o["mesh"] == (2, rank)


def test_sharded_render_matches_jax_and_single(case):
    c, j, out = case
    _, tr = configs()
    jr, _ = configs()
    want = jsharded.make_sharded_render(jmesh.make_mesh(2), JConfig(raster=jr))(
        j["target"], j["jcams"][0])
    with torch.no_grad():
        single, aux = render(TG.params_from_numpy(c["target"]),
                             to_torch_camera(j["jcams"][0]), tr)
    img, pairs = out[0]["render"]
    np.testing.assert_allclose(img, np.asarray(want.image), atol=2e-5)
    np.testing.assert_allclose(img, single.numpy(), atol=1e-5)
    assert pairs == int(want.num_pairs) == int(aux.num_pairs) > 0


def test_sharded_step_matches_jax_and_single(case):
    c, j, out = case
    jr, tr = configs()
    gt = c["gts"][0]
    js, jm = jsharded.make_sharded_train_step(jmesh.make_mesh(2), JConfig(raster=jr), 100)(
        jstate.create(j["start"]), j["jcams"][0], jnp.asarray(gt))
    ts, tm = ttrainer.train_step(_tstate(c["params"]), to_torch_camera(j["jcams"][0]),
                                 torch.from_numpy(gt), Config(raster=tr), 100)
    got, gm = out[0]["step"]
    np.testing.assert_allclose(gm["loss"], float(jm.loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(gm["loss"], float(tm.loss), rtol=LOSS_RTOL)
    assert gm["num_pairs"] == int(jm.num_pairs) == int(tm.num_pairs) > 0
    _compare(got, _jax_state_arrays(js), "vs JAX", grad_count=False)
    _compare(got, tstate.state_to_numpy(ts), "vs single process")


def test_sharded_batched_step_matches_jax_and_single(case):
    c, j, out = case
    jr, tr = configs()
    jcams = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *j["jcams"])
    js, jm = jsharded.make_sharded_train_step_batched(jmesh.make_mesh(2), JConfig(raster=jr),
                                                      100, 2)(
        jstate.create(j["start"]), jcams, jnp.asarray(np.stack(c["gts"])))
    ts, tm = ttrainer.train_step_batched(
        _tstate(c["params"]), [to_torch_camera(x) for x in j["jcams"]],
        [torch.from_numpy(g) for g in c["gts"]], Config(raster=tr), 100)
    got, gm = out[0]["batched"]
    np.testing.assert_allclose(gm["loss"], float(jm.loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(gm["loss"], float(tm.loss), rtol=LOSS_RTOL)
    assert gm["num_pairs"] == int(jm.num_pairs) == int(tm.num_pairs) > 0
    _compare(got, _jax_state_arrays(js), "vs JAX", grad_count=False)
    _compare(got, tstate.state_to_numpy(ts), "vs single process")


@pytest.mark.parametrize("kind", ["step", "batched"])
def test_chunked_all_reduce_is_bit_equal(case, kind):
    _, _, out = case
    for o in out:
        plain, chunked = o[kind][0], o[f"{kind}_chunked"]
        for k in plain:
            np.testing.assert_array_equal(chunked[k], plain[k], err_msg=k)


@pytest.mark.parametrize("kind", ["step", "batched", "loop"])
def test_ranks_states_bit_identical(case, kind):
    _, _, out = case
    a, b = out[0][kind][0], out[1][kind][0]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert out[0][kind][1] == out[1][kind][1]


def test_sharded_train_loop_across_density(case):
    """tests/test_sharding.py::test_sharded_loop_with_densify on the port:
    10 iterations, densify every 3 from 1, a reset at 8; the same log lines
    and integers as the port's single-process loop, floats at the bars."""
    c, _, out = case
    loop = c["loop"]
    logs = []
    st = ttrainer.train_loop(
        _tstate(loop["start"]), [ranks.tcam.camera_from_numpy(*loop["camera"])],
        [torch.from_numpy(loop["gt"])],
        Config(raster=RasterConfig(**ranks.SMALL), density=DensityConfig(**LOOP_DENSITY)),
        scene_extent=1.0, num_epochs=10, log_fn=logs.append)
    got, got_logs = out[0]["loop"]
    want = tstate.state_to_numpy(st)
    assert got_logs == logs and sum("densify" in s for s in logs) == 3
    assert int(got["opt/t"]) == 10
    n = int(got["params/alive"].sum())
    assert n > 24 and got["params/alive"][:n].all()
    np.testing.assert_array_equal(got["params/alive"], want["params/alive"])
    _compare(got, want, "loop vs single process")


@pytest.mark.parametrize("kind", ["step", "batched"])
def test_sharded_bodies_equal_float_scalar_forms(case, kind):
    """The sharded step and batched step, the bodies given their scalars
    as a device tensor by make_sharded_*, against the form with Python
    float scalars (learning_rates, _bc), three steps with a decaying
    position LR on both gloo ranks: every state array and the loss bit for
    bit."""
    _, _, out = case
    for o in out:
        assert o["float_forms"][kind] == [[]] * ranks.FLOAT_FORM_STEPS


def test_gloo_ranks_run_eagerly(case):
    """A gloo rank replays no graph: the predicate says so and no capture
    of any kind ran."""
    _, _, out = case
    for o in out:
        assert o["replays"] is False and o["captures"] == {}


def test_initialize_is_a_single_process_noop(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "WORLD_SIZE", "RANK",
              "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    topo = launch.initialize(device="cpu")
    assert topo["process_index"] == 0 and topo["process_count"] == 1
    assert topo["global_devices"] == 1 and topo["backend"] is None
    assert topo["device"] == "cpu" and "gloo on the CPU" in topo["backend_rule"]
    assert launch.is_primary() and not torch.distributed.is_initialized()


def test_sharded_step_without_a_process_group_raises():
    """No fallback to the single-card step: the sharded paths and the
    sharded train_loop refuse without an initialized process group."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_mesh(2)
    step = sharded.make_sharded_train_step(mesh_mod.Mesh(None, 2, 0), Config(), 100)
    with pytest.raises(RuntimeError, match="process group"):
        step(None, None, None)
    with pytest.raises(RuntimeError, match="process group"):
        ttrainer.train_loop(tstate.create(TG.zeros(4)), [], [], Config(), 1.0, num_epochs=1,
                            mesh_devices=2)


@pytest.mark.parametrize("fn", ["spawn", "initialize"])
def test_launch_refuses_cuda_without_cuda(monkeypatch, fn):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if fn == "spawn":
            launch.spawn(ranks.sharded_checks, 2, ({},))
        else:
            launch.initialize()


def test_backend_rule():
    assert launch.backend_for(torch.device("cpu"), 4) == "gloo"


def test_train_cli_devices_2_only_rank0_writes(scene_dir, tmp_path, scipy_knn,  # noqa: F811
                                               monkeypatch):
    """tools.train --devices 2 with no launcher starts two gloo ranks: one
    stream of metrics (each iteration once), one checkpoint and PLY."""
    from gaussiansplatting_tpu_torch.tools import train as train_cli

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "port"
    cfg_path = _write_config(tmp_path / "cfg.json")
    rc = train_cli.main(_cli_args(scene_dir, out, cfg_path,
                                  ["--devices", "2", "--device", "cpu"]))
    assert rc == 0
    lines = [json.loads(s) for s in open(out / "metrics.jsonl")]
    start = [s for s in lines if s["event"] == "start"]
    assert len(start) == 1 and start[0]["process_count"] == 2
    assert start[0]["backend"] == "gloo" and start[0]["devices"] == 2
    assert [s["iter"] for s in lines if s["event"] == "step"] == [1, 2, 3, 4]
    assert sum(s["event"] == "export_ply" for s in lines) == 1
    assert (out / "out.ply").exists() and (out / "ck" / "latest.npz").exists()


def test_bench_scaling_two_ranks(monkeypatch):
    """tools.bench_scaling --devices 2 on the CPU: one line per group size
    (1, 2), the strips' pair counts summing to the one rank's frame."""
    from gaussiansplatting_tpu_torch.tools import bench_scaling

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = bench_scaling.bench(["--n", "48", "--width", "64", "--height", "64",
                               "--pair-capacity", "2048", "--steps", "1", "--devices", "2",
                               "--device", "cpu"])
    assert [r["devices"] for r in res] == [1, 2]
    assert res[0]["num_pairs"] == res[1]["num_pairs"] > 0
    assert not any(r["overflow"] for r in res) and {r["backend"] for r in res} == {"gloo"}


def test_bench_scaling_refuses_cuda_without_cuda(monkeypatch):
    from gaussiansplatting_tpu_torch.tools import bench_scaling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        bench_scaling.main(["--devices", "2"])


def test_dryrun_multichip_two_ranks(monkeypatch):
    from gaussiansplatting_tpu_torch.graft_entry import dryrun_multichip

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = dryrun_multichip(2, device="cpu")
    assert len(out) == 2 and out[0] == out[1]
    assert abs(out[0]["loss"] - out[0]["ref_loss"]) < 1e-5
    assert abs(out[0]["bf16_loss"] - out[0]["bf16_ref_loss"]) < 1e-4
