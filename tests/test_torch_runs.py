"""Slots to runs (ops/runs.py, csrc/runs.cu): the plain version against the
definition on every case of run_cases.py and on two live runs that share a
start; the counter folded into train/graph.py's accounting and printed by
tools/trace.py.  On the card:
the kernel pair against the plain version bit for bit on the same cases and
at the benchmark cells' real layouts (380,428, 1,640,300 and ~14.7M slots a
frame over two calls), two launches giving the same bits, and the captured
render and step graphs launching it twice a frame with no ``torch.cummax``
or ``scatter_reduce`` on the card.  (The JAX parity of every case is
tests/test_torch_pairs.py::test_run_ids_matches_jax.)

No JAX here: on the machine with the card this file runs alone,
``python -m pytest --noconftest tests/test_torch_runs.py``.
"""

import numpy as np
import pytest
import torch

from gaussiansplatting_tpu_torch.ops import runs as truns
from gaussiansplatting_tpu_torch.utils import tracing

import run_cases

torch.set_num_threads(1)

# two live runs that share a start: the amax keeps the larger id (slots
# 0, 0, 2, 2, 2, 3, 3)
SHARED_START = (np.array([0, 2, 2, 5], np.int32), np.ones(4, bool), 7)


def _case(name):
    return SHARED_START if name == "shared_start" else run_cases.CASES[name]()


CASE_NAMES = [*run_cases.CASES, "shared_start"]


def _args(starts, live, num_slots, device="cpu"):
    return torch.from_numpy(starts).to(device), torch.from_numpy(live).to(device), num_slots


@pytest.mark.parametrize("case", CASE_NAMES)
def test_plain_matches_the_definition(case):
    starts, live, num_slots = _case(case)
    got = truns.run_ids(*_args(starts, live, num_slots))
    assert got.dtype == torch.int32 and got.shape == (num_slots,)
    np.testing.assert_array_equal(got.numpy(), run_cases.oracle(starts, live, num_slots))


def test_run_ids_refuses_what_the_kernel_does_not_take():
    starts, live, num_slots = _args(*run_cases.CASES["7"]())
    for bad in ((starts.long(), live, num_slots), (starts, live.int(), num_slots),
                (starts, live[:-1], num_slots), (starts[None], live[None], num_slots),
                (starts, live, -1), (starts, live, truns.MAX_SLOTS + 1)):
        with pytest.raises(ValueError):
            truns.run_ids(*bad)


def test_runs_counter_round_trip():
    """The plain version launches nothing; the counter a replay adds to, by
    name, folded into train/graph.py's accounting."""
    from gaussiansplatting_tpu_torch.train import graph as tgraph

    before = tgraph.launch_counts()
    assert "run_ids" in before
    truns.run_ids(*_args(*run_cases.CASES["40"]()))
    assert tgraph.launch_counts() == before
    tgraph.add_launches({"run_ids": 4, "compose_fwd": 1})
    after = tgraph.launch_counts()
    assert after["run_ids"] - before["run_ids"] == 4
    assert after["compose_fwd"] - before["compose_fwd"] == 1
    tgraph.add_launches({k: before[k] - after[k] for k in before})
    assert tgraph.launch_counts() == before


def test_trace_tool_prints_the_launches(tmp_path, capsys, monkeypatch):
    """tools/trace.py prints the traced window's launches by counted
    wrapper and writes them beside the timeline: two run_ids a step (a
    counting stand-in for the kernel, which the CPU cannot launch)."""
    from gaussiansplatting_tpu_torch.tools import trace

    plain = truns.run_ids

    def counting(*args):
        tracing.add_launches({"run_ids": 1})
        return plain(*args)

    monkeypatch.setattr(truns, "run_ids", counting)
    assert trace.main(["--steps", "2", "--n", "40", "--width", "32", "--height", "32",
                       "--pair-capacity", "1024", "--top", "4", "--device", "cpu",
                       "--out", str(tmp_path)]) == 0
    assert "launches {'run_ids': 4}" in capsys.readouterr().out
    assert trace.launch_counts(str(tmp_path)) == {"run_ids": 4}


# -- on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the slots-to-runs kernels have no CPU mode")
    return torch.device("cuda")


def _kernel_vs_plain(starts, live, num_slots, dev):
    s, l, n = _args(starts, live, num_slots, dev)
    before = tracing.launch_counts()["run_ids"]
    got = truns.run_ids(s, l, n)
    want = truns.run_ids_plain(s, l, n)
    torch.cuda.synchronize()
    assert tracing.launch_counts()["run_ids"] == before + 1
    assert got.dtype == torch.int32 and got.shape == (n,) and got.device == s.device
    assert torch.equal(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASE_NAMES)
def test_kernel_matches_plain_cuda(case):
    _kernel_vs_plain(*_case(case), _cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(run_cases.CELLS))
def test_kernel_matches_plain_at_the_cells_cuda(cell):
    """The two calls of a frame at the cell's sizes: chunk slots over the
    Gaussians, blocks over the tiles; bit for bit, and -1 nowhere after the
    first live run's start."""
    dev = _cuda()
    for starts, live, num_slots in run_cases.CELLS[cell]():
        got = _kernel_vs_plain(starts, live, num_slots, dev)
        first = int(starts[live].min())
        assert int(got[first:].min()) >= 0 and bool((got[:first] == -1).all())


@pytest.mark.cuda
def test_kernel_repeats_its_bits_cuda():
    dev = _cuda()
    for starts, live, num_slots in run_cases.CELLS["garden_mip360"]():
        s, l, n = _args(starts, live, num_slots, dev)
        a, b = truns.run_ids(s, l, n), truns.run_ids(s, l, n)
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("tfloor", [False, True])
def test_graphs_launch_run_ids_not_cummax_cuda(tfloor, monkeypatch):
    """A captured render graph records two run_ids launches a frame (the
    T-floor pass reuses the frame's windows), a captured step graph two a
    step; neither path calls torch.cummax or scatter_reduce on the card."""
    dev = _cuda()
    from gaussiansplatting_tpu_torch.config import Config, RasterConfig
    from gaussiansplatting_tpu_torch.train import graph as tgraph
    from gaussiansplatting_tpu_torch.train import state as tstate
    from gaussiansplatting_tpu_torch.train import trainer as ttrainer
    from gaussiansplatting_tpu_torch.utils import synthetic

    cummax, scatter_reduce = torch.cummax, torch.Tensor.scatter_reduce

    def no_cummax(x, *a, **kw):
        if x.is_cuda:
            raise AssertionError("torch.cummax on the card")
        return cummax(x, *a, **kw)

    def no_scatter_reduce(self, *a, **kw):
        if self.is_cuda:
            raise AssertionError("scatter_reduce on the card")
        return scatter_reduce(self, *a, **kw)

    monkeypatch.setattr(torch, "cummax", no_cummax)
    monkeypatch.setattr(torch.Tensor, "scatter_reduce", no_scatter_reduce)
    tgraph.clear()
    raster = RasterConfig(pair_capacity=1 << 14, t_floor_exact=tfloor)
    params = synthetic.make_scene(300, seed=4, device=dev)
    cam = synthetic.make_canonical_camera(64, 48, device=dev)
    before = tgraph.launch_counts()
    tgraph.render_frame(params, cam, raster)
    tgraph.render_frame(params, cam, raster)
    torch.cuda.synchronize()
    assert tgraph.live_renders()[-1].launches["run_ids"] == 2
    # the capture's warm-up render and two replays
    assert tgraph.launch_counts()["run_ids"] - before["run_ids"] == 2 * 3
    gt = torch.zeros((48, 64, 3), device=dev)
    before = tgraph.launch_counts()
    ttrainer.train_steps(tstate.create(params), [cam] * 3, [gt] * 3, Config(raster=raster), 100)
    torch.cuda.synchronize()
    assert tgraph.live()[-1].launches["run_ids"] == 2
    n = 3 + tgraph.WARMUP_STEPS
    assert tgraph.launch_counts()["run_ids"] - before["run_ids"] == 2 * n
    tgraph.clear()
