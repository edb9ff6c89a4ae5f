"""The port's tracing (utils/tracing.py): host spans (recorded only under a
profiler or after enable(), nested with parents and request ids, on
time.time_ns(), in a bounded buffer that counts its drops), the stage marks
(nothing on the CPU; csrc/marks.cu defines every stage), the spans of the
training loop and of the sharded collectives, the operator's reader
(tools/trace.py) and the benchmark's reader (gsbench/portspans.py and its
metrics) on hand-made timelines, the launch-count registry and
kernels/build.py's launch seam.  The card's test captures a render and a
step and sees every mark once per replay, in order.

No JAX here: on the machine with the card this file runs alone,
``python -m pytest --noconftest tests/test_torch_tracing.py``.
"""

import contextlib
import ctypes
import re
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from gaussiansplatting_tpu_torch.config import Config, DensityConfig, RasterConfig
from gaussiansplatting_tpu_torch.train import graph as tgraph
from gaussiansplatting_tpu_torch.train import state as tstate
from gaussiansplatting_tpu_torch.train import trainer as ttrainer
from gaussiansplatting_tpu_torch.utils import synthetic, tracing

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ACT = torch.profiler.ProfilerActivity


@pytest.fixture(autouse=True)
def fresh_buffer():
    tracing.enable(False)
    tracing.clear()
    yield
    tracing.enable(False)
    tracing.clear()


def _names():
    return [s.name for s in tracing.spans()]


def test_spans_record_only_under_a_profiler_or_after_enable():
    assert not tracing.enabled()
    with tracing.span("off"):
        pass
    assert _names() == []
    with torch.profiler.profile(activities=[ACT.CPU]) as prof:
        assert tracing.enabled()
        with tracing.span("profiled"):
            torch.ones(3).sum()
    assert not tracing.enabled()
    assert _names() == ["profiled"]
    assert "profiled" in {e.key for e in prof.key_averages()}   # a profiler range too
    tracing.enable()
    with tracing.span("enabled"):
        pass
    tracing.enable(False)
    with tracing.span("off again"):
        pass
    assert _names() == ["profiled", "enabled"]
    # a timed span reads the clock even when nothing records
    with tracing.span("timed", timed=True) as t:
        time.sleep(0.002)
    assert t.seconds >= 0.002 and _names() == ["profiled", "enabled"]


def test_parents_request_ids_and_the_clock():
    tracing.enable()
    before = time.time_ns()
    with tracing.span("call"):
        with tracing.span("child"):
            with tracing.span("grandchild"):
                pass
        with tracing.span("second child"):
            pass
    with tracing.span("next call"):
        pass
    seen = {}

    def other():
        with tracing.span("thread call"):
            with tracing.span("thread child"):
                seen["stack"] = len(tracing._stack())

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    after = time.time_ns()
    sp = {s.name: (i, s) for i, s in enumerate(tracing.spans())}
    call, child = sp["call"][1], sp["child"][1]
    assert call.parent == -1 and child.parent == sp["call"][0]
    assert sp["grandchild"][1].parent == sp["child"][0]
    assert sp["second child"][1].parent == sp["call"][0]
    assert sp["next call"][1].parent == -1
    assert {sp[n][1].request for n in ("call", "child", "grandchild", "second child")} == {
        call.request}
    ids = {call.request, sp["next call"][1].request, sp["thread call"][1].request}
    assert len(ids) == 3 and sp["thread child"][1].request == sp["thread call"][1].request
    assert sp["thread child"][1].parent == sp["thread call"][0] and seen["stack"] == 2
    for _, s in sp.values():
        assert before <= s.start_ns <= s.end_ns <= after     # time.time_ns()
    assert call.start_ns <= child.start_ns <= child.end_ns <= call.end_ns


def test_the_buffer_is_bounded_and_counts_its_drops(monkeypatch):
    monkeypatch.setattr(tracing, "_bound", 3)
    tracing.enable()
    with tracing.span("a"):
        with tracing.span("b"):
            pass
        with tracing.span("c"):
            with tracing.span("d"):            # dropped: the buffer holds three
                pass
    with tracing.span("e"):                    # dropped
        pass
    assert _names() == ["a", "b", "c"] and tracing.dropped() == 2
    assert all(s.end_ns >= s.start_ns > 0 for s in tracing.spans())
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_marks_do_nothing_on_the_cpu(monkeypatch):
    from gaussiansplatting_tpu_torch.kernels import build

    def no_build(name):
        raise AssertionError(f"a CPU mark loaded {name}")

    monkeypatch.setattr(build, "load_library", no_build)
    x = torch.ones(4, requires_grad=True)
    for stage in tracing.STAGES:
        tracing.mark(stage, x)
        tracing.mark(stage, torch.device("cpu"))
    with pytest.raises(ValueError, match="no stage mark"):
        tracing.mark("projektion", x)
    assert tracing.mark_grad("compose_bwd", x) is x
    # csrc/marks.cu defines a kernel for every stage and no other; no name
    # holds the substrings the blend rooflines match
    src = (ROOT / "gaussiansplatting_tpu_torch" / "csrc" / "marks.cu").read_text()
    assert re.findall(r"^GS_MARK\((\w+)\)$", src, re.M) == list(tracing.STAGES)
    for stage in tracing.STAGES:
        name = tracing.MARK_PREFIX + stage
        assert "blend_fwd_win" not in name and "blend_bwd_win" not in name


MAIN_PATH_KERNELS = {f"windowed_blend_{d}{m}" for d in ("fwd", "bwd")
                     for m in ("", "_tf", "_packed")} | {
    "compose_fwd", "compose_logti", "compose_bwd", "run_ids", "project_fwd", "project_bwd"} | {
    f"surfel_{k}_{d}" for k in ("project", "blend", "compose") for d in ("fwd", "bwd")}


def test_the_launch_counts_are_one_registry():
    """graph.launch_counts() and add_launches() are the registry's: every
    main-path kernel wrapper's name (the surfel kernels' among them), the
    frames by SH degree and the surfel frames, registered when the port is
    imported (before any launch), and nothing else."""
    assert tgraph.launch_counts is tracing.launch_counts
    assert tgraph.add_launches is tracing.add_launches
    assert set(tgraph.launch_counts()) == MAIN_PATH_KERNELS | {
        f"sh.degree_{d}" for d in range(4)} | {"primitive.surfel"}


def test_the_registry_as_captures_and_replays_use_it():
    """Counts, snapshot difference and add, as train/graph.py's _Capture and
    StepGraph.run use them: the difference of two snapshots sets a capture's
    counts back and is what it recorded, and K replays add K times that.
    Registering a name again keeps its count; an unknown name raises."""
    before = tracing.launch_counts()
    for name in ("compose_fwd", "run_ids", "run_ids"):
        tracing.add_launches({name: 1})
    after = tracing.launch_counts()
    tracing.add_launches({k: before[k] - after[k] for k in before})
    assert tracing.launch_counts() == before
    recorded = {k: after[k] - before[k] for k in before if after[k] != before[k]}
    assert recorded == {"compose_fwd": 1, "run_ids": 2}
    tracing.add_launches({k: 3 * n for k, n in recorded.items()})
    tracing.counted("run_ids")
    now = tracing.launch_counts()
    assert {k: now[k] - before[k] for k in before if now[k] != before[k]} == {
        "compose_fwd": 3, "run_ids": 6}
    with pytest.raises(KeyError):
        tracing.add_launches({"windowed_blend_fwd_v1": 1})
    tracing.add_launches({k: before[k] - now[k] for k in before})
    assert tracing.launch_counts() == before


def test_the_launch_seam_binds_calls_checks_and_counts(monkeypatch):
    """kernels/build.py's launch on a C function of the C library (abs,
    which returns its int argument's magnitude: 0 is success, anything else
    a CUDA error), the card's context and stream stubbed: the prototype set
    once per symbol (another signature refused), the stream passed last, a
    nonzero return raised with the symbol and counted nowhere, a success
    counted under the wrapper's name only when one is given."""
    from gaussiansplatting_tpu_torch.kernels import build

    libc = ctypes.CDLL(None)
    streams = []

    class Stream:
        @property
        def cuda_stream(self):
            streams.append(1)
            return 0

    monkeypatch.setattr(build, "load_library", lambda name: libc)
    monkeypatch.setattr(build, "_entries", {})
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    before = tracing.launch_counts()
    build.launch("libc", "abs", "i", "cuda", 0, count="run_ids")
    build.launch("libc", "abs", "i", "cuda", 0)
    assert libc.abs.argtypes == [ctypes.c_int, ctypes.c_void_p]
    assert libc.abs.restype is ctypes.c_int and len(streams) == 2
    with pytest.raises(RuntimeError, match="abs launch failed: CUDA error 3"):
        build.launch("libc", "abs", "i", "cuda", -3, count="run_ids")
    with pytest.raises(ValueError, match="signature"):
        build.launch("libc", "abs", "f", "cuda", 0.0)
    assert build.entry("libc", "abs", "ip") is libc.abs
    after = tracing.launch_counts()
    assert {k: after[k] - before[k] for k in before if after[k] != before[k]} == {"run_ids": 1}
    tracing.add_launches({"run_ids": -1})


def test_the_training_loop_records_its_spans():
    """A CPU loop with adaptive pairs, a densify event that grows the
    capacity and an opacity reset, under enable(): each chunk, pair read,
    event, draw and growth is a span, the draw inside its event."""
    params = synthetic.make_scene(24, seed=3, spread=0.6)
    cam = synthetic.make_canonical_camera(32, 32)
    cfg = Config(raster=RasterConfig(pair_capacity=1 << 12, pair_block=16),
                 density=DensityConfig(densify_from_iter=1, densify_until_iter=40,
                                       densify_interval=4, opacity_reset_interval=6,
                                       grad_threshold=1e-9))
    gt = torch.zeros(32, 32, 3)
    tracing.enable()
    ttrainer.train_loop(tstate.create(params), [cam] * 2, [gt] * 2, cfg, scene_extent=1.0,
                        num_epochs=3, adaptive_pairs=True, adapt_interval=2,
                        min_pair_capacity=256, adaptive_capacity=True, max_capacity=64)
    tracing.enable(False)
    spans = tracing.spans()
    names = [s.name for s in spans]
    assert names.count("loop.chunk") == 6 and names.count("loop.pair_read") == 3
    assert names.count("loop.densify") == 1 and names.count("loop.opacity_reset") == 1
    assert names.count("loop.grow") == 1
    draw = spans[names.index("density.draw")]
    assert spans[draw.parent].name == "loop.densify"
    assert all(s.parent == -1 for s in spans if s.name.startswith("loop."))
    assert len({s.request for s in spans if s.parent == -1}) == len(
        [s for s in spans if s.parent == -1])


def test_sharded_collectives_keep_their_spans(tmp_path):
    """A one-rank gloo group in this process: the strip gather and the
    all-reduces run inside spans named sharded.gather_strips and
    sharded.all_reduce, seen by the profiler and by the buffer."""
    import torch.distributed as dist

    from gaussiansplatting_tpu_torch.parallel import sharded
    from gaussiansplatting_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1)
        with torch.profiler.profile(activities=[ACT.CPU]) as prof:
            full = sharded._GatherStrips.apply(torch.ones(2, 3, 3), mesh)
            sums = sharded.chunked_all_reduce({"means": torch.ones(5, 3)}, mesh, 2)
            one = sharded._all_reduce(torch.ones(4, 2)[:, 1], mesh)
    finally:
        dist.destroy_process_group()
    assert full.shape == (2, 3, 3) and torch.equal(sums["means"], torch.ones(5, 3))
    assert torch.equal(one, torch.ones(4))
    keys = {e.key for e in prof.key_averages()}
    assert set(sharded.COLLECTIVE_SPANS) <= keys
    assert _names() == ["sharded.gather_strips", "sharded.all_reduce", "sharded.all_reduce"]


# ------------------------------------------------------- the readers


def _frame(b, k):
    """A replayed frame at ``b`` (device operations) and its host spans."""
    ops = [("copy", b + 5, b + 7)]
    t = b + 10
    for stage, work in (("projection", 20), ("pairs", 30), ("blend", 10), ("compose", 10)):
        ops += [(tracing.MARK_PREFIX + stage, t, t + 1), (f"k_{stage}", t + 1, t + 1 + work)]
        t += 1 + work
    ops += [(tracing.MARK_PREFIX + "end", t, t + 1), ("clone", b + 90, b + 92)]
    port = [("graph.render_frame", b + 2, b + 92), ("graph.copy_in", b + 2, b + 9),
            ("graph.replay", b + 9, b + 20), ("graph.clone_out", b + 85, b + 92)]
    bench = [("gsbench.call", b, b + 92), ("gsbench.sync", b + 92, b + 150)]
    return ops, port, bench


def _timeline():
    """Two frames, a densify event and a capture's warm-up, window [1000,
    2000] (ns)."""
    ops, port, bench = [], [], [("gsbench.window", 1000, 2000)]
    for k in range(2):
        o, p, s = _frame(1000 + 200 * k, k)
        ops, port, bench = ops + o, port + p, bench + s
    ops += [("gs_mark_densify", 1500, 1501), ("k_densify", 1501, 1541), ("gs_mark_end", 1541, 1542),
            ("gs_mark_projection", 1610, 1611), ("k_warm", 1611, 1650),
            ("gs_mark_compose", 1650, 1651), ("gs_mark_end", 1651, 1652)]
    port += [("loop.densify", 1495, 1545), ("density.draw", 1495, 1500),
             ("graph.capture", 1590, 1700), ("graph.warmup", 1590, 1680)]
    return ops, port, bench


def _record(monkeypatch, with_port=True, with_marks=True):
    sys.path.insert(0, str(ROOT))
    from gsbench import devtrace

    ops, port, bench = _timeline()
    if not with_marks:
        ops = [o for o in ops if not o[0].startswith(tracing.MARK_PREFIX)]
    spans = [tracing.Span(n, s, e, -1, i + 1) for i, (n, s, e) in enumerate(port)]
    if with_port:
        monkeypatch.setattr(tracing, "spans", lambda: spans)
    else:
        monkeypatch.setitem(sys.modules, "gaussiansplatting_tpu_torch.utils.tracing", None)
    cap = devtrace.Capture([devtrace.Interval(*o) for o in ops],
                           [devtrace.Interval(*s) for s in bench])
    return {"cell": "x", "capture": cap, "window_s": 1e-6, "busy_s": 0.0, "work": {},
            "counters": {"passes": 1.0}, "spans": {}}


NEW_METRICS = ("projection_ms.render", "pairs_ms.render", "compose_ms.render", "loss_ms.train",
               "reduction_ms.train", "adam_ms.train", "copy_idle_ms.render",
               "capture_idle_ms.garden", "draw_ms.garden", "sync_idle_ms.garden")


def test_portspans_on_a_hand_made_capture(monkeypatch):
    rec = _record(monkeypatch)
    from gsbench import harness, portspans

    a = portspans.analysis(rec)
    assert a["replays"] == 2 and a["marks"] == 12          # the warm-up's three excluded
    assert a["stage_ns"] == {None: 2, "projection": 40, "pairs": 60, "blend": 20,
                             "compose": 20, "end": 6, "densify": 40}
    assert a["idle_ns"] == {"gsbench.call": 5, "graph.copy_in": 6, "graph.clone_out": 10,
                            "gsbench.sync": 113 + 208, "loop.densify": 68,
                            "graph.warmup": 348}
    got = {m: harness.metric_reader(m)(rec) for m in NEW_METRICS}
    want = {"projection_ms.render": 20e-6, "pairs_ms.render": 30e-6, "compose_ms.render": 10e-6,
            "loss_ms.train": 0.0, "reduction_ms.train": 0.0, "adam_ms.train": 0.0,
            "copy_idle_ms.render": 8e-6, "capture_idle_ms.garden": 348e-6,
            "draw_ms.garden": 5e-6, "sync_idle_ms.garden": 0.0}
    assert got == pytest.approx(want, rel=1e-12, abs=1e-18)


def test_portspans_read_null_without_the_port_or_its_marks(monkeypatch):
    from gsbench import harness

    rec = _record(monkeypatch, with_port=False)
    assert all(harness.metric_reader(m)(rec) is None for m in NEW_METRICS)
    monkeypatch.undo()
    rec = _record(monkeypatch)
    monkeypatch.setattr(tracing, "dropped", lambda: 1)      # a partial buffer reads null
    assert all(harness.metric_reader(m)(rec) is None for m in NEW_METRICS)
    monkeypatch.undo()
    rec = _record(monkeypatch, with_marks=False)
    got = {m: harness.metric_reader(m)(rec) for m in NEW_METRICS}
    assert all(got[m] is None for m in NEW_METRICS[:7])   # per replay: no marks, no replays
    assert got["capture_idle_ms.garden"] > 0 and got["draw_ms.garden"] == pytest.approx(5e-6)


def _nested(port):
    """tracing.Span of (name, start, end) rows: each span's parent is the
    last earlier row that contains it, and a root starts a request."""
    out = []
    for name, s, e in port:
        parent = max((j for j, p in enumerate(out) if p.start_ns <= s and e <= p.end_ns),
                     default=-1)
        request = out[parent].request if parent >= 0 else len(out) + 1
        out.append(tracing.Span(name, s, e, parent, request))
    return out


def test_the_operators_reader_on_a_hand_made_timeline():
    """tools/trace.py's stages, idle charges by span path and by request,
    and idle share (a union: overlapping kernels count once, so the share
    never falls below 0)."""
    from gaussiansplatting_tpu_torch.tools import trace

    ops, port, _ = _timeline()
    ops = [o for o in ops if not 1590 <= o[1] < 1700]
    spans = _nested(port)
    window = (1000, 2000)
    st = trace.stage_ms(ops, window, 2)
    assert st["projection"] == pytest.approx(20e-6) and st["pairs"] == pytest.approx(30e-6)
    by_path, by_request = trace.idle_ms(ops, spans, window, 2)
    assert by_path["graph.render_frame > graph.copy_in"] == pytest.approx(3e-6)
    assert by_path["graph.render_frame > graph.clone_out"] == pytest.approx(5e-6)
    assert by_path["loop.densify"] == pytest.approx((2000 - 1542) / 2e6)
    assert by_request["graph.render_frame"] == pytest.approx(sum(
        ms for p, ms in by_path.items() if p.startswith("graph.render_frame")))
    assert by_request["loop.densify"] == by_path["loop.densify"] and by_path["host"] > 0
    assert sum(by_path.values()) == pytest.approx(sum(by_request.values()))
    overlapping = [("a", 0, 10), ("b", 0, 10), ("c", 5, 15)]
    assert trace.idle_share(overlapping, (0, 20)) == pytest.approx(0.25)
    assert trace.idle_share([], (0, 20)) is None
    assert trace.stage_ms([("k", 0, 10)], (0, 20), 1) == {}


def test_the_operators_reader_traces_the_loop(tmp_path, capsys):
    """``--loop`` on the CPU: one train_loop from a fresh state under the
    profiler; its timeline holds each of the loop's spans, nested and in
    requests as the loop opened them, and the chrome trace carries them."""
    from gaussiansplatting_tpu_torch.tools import trace

    out = str(tmp_path / "loop")
    assert trace.main(["--loop", "--steps", "20", "--n", "40", "--width", "32", "--height",
                       "32", "--pair-capacity", "1024", "--out", out, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "no device operation traced"
    device, spans, window, dropped = trace.timeline(out)
    names = [s.name for s in spans]
    assert device == [] and dropped == 0 and window[0] < window[1]
    assert names.count("loop.chunk") == 4 and names.count("loop.pair_read") == 2
    assert names.count("loop.densify") == 2 and names.count("loop.opacity_reset") == 1
    assert names.count("loop.grow") >= 1 and names.count("density.draw") == 2
    assert all(spans[s.parent].name == "loop.densify" and s.request == spans[s.parent].request
               for s in spans if s.name == "density.draw")
    assert all(window[0] <= s.start_ns <= s.end_ns <= window[1] for s in spans)
    with open(Path(out) / "trace.json") as f:
        traced = f.read()
    assert all(f'"{n}"' in traced for n in set(names))


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
def test_marks_once_per_replay_in_order_cuda():
    """On the card: a captured render and a captured step, replayed twice
    each under a CUDA-only profiler, show every stage mark once per replay
    in the documented order, and the graph calls' spans nest under their
    request; the capture's timers come from its spans, its pool's bytes are
    read at first use."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graphs are captured on the card")
    params = synthetic.make_scene(300, seed=4, device="cuda")
    cam = synthetic.make_canonical_camera(64, 48, device="cuda")
    cfg = Config(raster=RasterConfig(pair_capacity=1 << 14, pair_block=16))
    st = tstate.create(params)
    gt = torch.zeros(48, 64, 3, device="cuda")
    tgraph.render_frame(params, cam, cfg.raster)                 # captures
    ttrainer.train_steps(st, [cam], [gt], cfg, 100)
    torch.cuda.synchronize()
    g = tgraph.live_renders()[-1]
    assert g._pool_bytes is None and g.pool_bytes > 0
    assert g._pool_bytes == g.pool_bytes and g.warmup_s > 0 and g.capture_s > 0
    with torch.profiler.profile(activities=[ACT.CUDA]) as prof:
        assert tracing.enabled()
        for _ in range(2):
            tgraph.render_frame(params, cam, cfg.raster)
        ttrainer.train_steps(st, [cam, cam], [gt, gt], cfg, 100)
        torch.cuda.synchronize()
    events = sorted((int(e.start_ns()), e.name()) for e in prof.profiler.kineto_results.events()
                    if not str(e.device_type()).endswith("CPU"))
    marks = [n[len(tracing.MARK_PREFIX):] for _, n in events if n.startswith(tracing.MARK_PREFIX)]
    frame = list(tracing.FRAME_STAGES) + ["end"]
    step = list(tracing.STEP_STAGES) + ["end"]
    assert marks == frame * 2 + step * 2, marks
    spans = tracing.spans()
    names = [s.name for s in spans]
    assert names.count("graph.render_frame") == 2 and names.count("graph.run_steps") == 1
    assert names.count("graph.replay") == 4 and names.count("graph.copy_in") == 3
    for s in spans:
        if s.name in ("graph.copy_in", "graph.replay", "graph.clone_out"):
            parent = spans[s.parent]
            assert parent.name in ("graph.render_frame", "graph.run_steps")
            assert s.request == parent.request
    tgraph.clear()
