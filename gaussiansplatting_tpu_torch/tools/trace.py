"""Device-time capture and aggregation for the train step: the operator's
reader of the port's tracing (utils/tracing.py).

Counterpart of gaussiansplatting_tpu/tools/trace.py: a ``torch.profiler``
capture around N already-warm train steps on the synthetic scene, the
device time grouped by kernel name, the top groups in ms per step, the
device ms per step of each stage of the port's stage marks
(``gs_mark_<stage>`` kernels: a stage runs from its mark to the next), the
device's idle ms per step charged to the innermost of the port's host spans
open when each gap began (named by its path from its request's root span)
and rolled up by request, and the card's idle share: 1 - the union of the
device operations' intervals over the traced window (overlapping kernels
count once).  The host clock of N synchronized steps, taken just before the
capture without the profiler, is printed beside it.  ``--loop`` traces the
training loop instead: ``train_loop`` for N iterations from a fresh state,
with a pair read and a densify event every LOOP_EVENTS iterations, an
opacity reset every second one, capacity growth and chunks of LOOP_CHUNK
replays, so the window holds the loop's spans, its captures and its events.

  python -m gaussiansplatting_tpu_torch.tools.trace [--steps 5] [--n 100000]
      [--width 800 --height 608] [--pair-capacity 2097152] [--top 25]
      [--payload-dtype f32|bf16] [--pack-positions 0|1] [--loop]
      [--out build/trace] [--parse-only] [--device cuda]

The chrome trace goes to ``<out>/trace.json`` (the port's host spans in it
as profiler ranges), the device operations and the port's spans on
``time.time_ns()`` to ``<out>/timeline.json``; ``--parse-only`` reads an
existing pair.  On the card the groups are the CUDA kernels (and memory
copies and sets); a CPU capture (``--device cpu``) groups the operators'
self time instead, and there are no stages, idle gaps or idle share.
``--payload-dtype bf16`` (with ``--pack-positions 1``) traces the bf16
payload mode, as the JAX tool does.

``device_profile`` and ``step_breakdown`` are the kernels-only profiles
chip_smoke.py prints for its paths.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import time

# chrome-trace categories of work on the card
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TIMELINE = "timeline.json"
# --loop: a pair read and a densify event every LOOP_EVENTS iterations, an
# opacity reset every second one, chunks of LOOP_CHUNK replays
LOOP_EVENTS = 10
LOOP_CHUNK = 5


def _setup(n, width, height, pair_capacity, device, payload_dtype="f32",
           pack_positions=False):
    """The JAX tool's workload: the synthetic scene (seed 0), its canonical
    camera, random ground truth, L1-only loss gradient, B = 128, the
    payload mode given."""
    import numpy as np
    import torch

    from gaussiansplatting_tpu_torch.config import Config, LossConfig, RasterConfig
    from gaussiansplatting_tpu_torch.train import state as train_state
    from gaussiansplatting_tpu_torch.utils import synthetic

    cfg = Config(raster=RasterConfig(pair_capacity=pair_capacity, pair_block=128,
                                     payload_dtype=payload_dtype,
                                     pack_positions=bool(pack_positions)),
                 loss=LossConfig(dssim_in_grad=False))
    params = synthetic.make_scene(n=n, seed=0, device=device)
    camera = synthetic.make_canonical_camera(width=width, height=height, device=device)
    gt = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (height, width, 3)).astype(np.float32)).to(device)
    return train_state.create(params), camera, gt, cfg


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def capture(steps, n, width, height, pair_capacity, out, device="cuda",
            payload_dtype="f32", pack_positions=False, loop=False):
    """Warm one step, time ``steps`` synchronized steps on the host clock,
    then profile ``steps`` more; ``loop``: profile one ``train_loop`` of
    ``steps`` iterations from a fresh state instead (see the module
    docstring), untimed.  Writes ``<out>/trace.json`` and
    ``<out>/timeline.json``.  Returns the host ms per step (None for a
    loop)."""
    import torch

    from gaussiansplatting_tpu_torch.train import trainer
    from gaussiansplatting_tpu_torch.utils import tracing

    device = torch.device(device)
    st, camera, gt, cfg = _setup(n, width, height, pair_capacity, device, payload_dtype,
                                 pack_positions)
    if loop:
        cfg = cfg.replace(density=cfg.density.replace(
            densify_from_iter=0, densify_interval=LOOP_EVENTS,
            opacity_reset_interval=2 * LOOP_EVENTS))

        def run(st):
            return trainer.train_loop(st, [camera] * steps, [gt] * steps, cfg, scene_extent=1.0,
                                      num_epochs=1, adaptive_pairs=True,
                                      adapt_interval=LOOP_EVENTS, adaptive_capacity=True,
                                      scan_steps=LOOP_CHUNK)
    else:
        def run(st):
            for _ in range(steps):
                st, _ = trainer.train_step(st, camera, gt, cfg, 30_000)
            return st

    host_ms = None
    if not loop:
        st, _ = trainer.train_step(st, camera, gt, cfg, 30_000)   # warm
        _sync(device)
        t0 = time.perf_counter()
        st = run(st)
        _sync(device)
        host_ms = 1e3 * (time.perf_counter() - t0) / steps

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    tracing.clear()
    with torch.profiler.profile(activities=acts) as prof:
        lo = time.time_ns()
        run(st)
        _sync(device)
        hi = time.time_ns()
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    ops = []
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        if not str(e.device_type()).endswith("CPU") and e.duration_ns() > 0:
            ops.append((e.name(), start, start + int(e.duration_ns())))
    with open(os.path.join(out, TIMELINE), "w") as f:
        json.dump({"window": [lo, hi], "device": ops, "spans": tracing.spans(),
                   "dropped": tracing.dropped()}, f)
    return host_ms


def _group_name(name: str) -> str:
    """Collapse a kernel or operator name to a stable group: the function
    name without its return type, namespace prefix of anonymous namespaces,
    template arguments and parameters."""
    base = name.replace("(anonymous namespace)::", "")
    base = re.sub(r"^void ", "", base)
    base = re.split(r"[<(]", base, maxsplit=1)[0].strip()
    return base or name


def _self_times(events):
    """[(name, self us)] of nested complete events: each event's duration
    less its direct children's, per thread."""
    by_tid = collections.defaultdict(list)
    for e in events:
        by_tid[(e.get("pid"), e.get("tid"))].append(e)
    out = []
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack = []                                   # [(end, name, self)]
        for e in evs:
            ts, dur = e["ts"], e.get("dur", 0)
            while stack and stack[-1][0] <= ts:
                _, nm, own = stack.pop()
                out.append((nm, own))
            if stack:
                stack[-1][2] -= dur
            stack.append([ts + dur, e.get("name", "?"), dur])
        out.extend((nm, own) for _, nm, own in stack)
    return out


def aggregate(trace_path: str, steps: int, top: int = 25,
              skip=frozenset()) -> list[tuple[str, float]]:
    """Parse a chrome trace (a file, or a directory holding trace.json);
    return [(group, ms per step)] sorted descending, the ``top`` largest,
    then ("TOTAL(device)", the sum of all groups).  Device events (kernels,
    memory copies and sets) where the trace has any, else the self time of
    the operators not named in ``skip`` (the port's host spans)."""
    if os.path.isdir(trace_path):
        trace_path = os.path.join(trace_path, "trace.json")
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    if dev:
        timed = [(e.get("name", "?"), e.get("dur", 0)) for e in dev]
    else:
        timed = _self_times([e for e in events
                             if e.get("cat") == "cpu_op" and e.get("name") not in skip])
    groups = collections.Counter()
    for name, us in timed:
        groups[_group_name(name)] += us
    total = sum(groups.values())
    out = [(name, us / 1e3 / steps) for name, us in groups.most_common(top)]
    out.append(("TOTAL(device)", total / 1e3 / steps))
    return out


def timeline(out: str):
    """(device operations [(name, start, end)], the port's host spans
    [tracing.Span], the traced window (start, end), spans the buffer
    dropped) of a capture's ``<out>/timeline.json``, all in ns on
    ``time.time_ns()``."""
    from gaussiansplatting_tpu_torch.utils.tracing import Span

    with open(os.path.join(out, TIMELINE)) as f:
        t = json.load(f)
    return ([tuple(d) for d in t["device"]], [Span(*s) for s in t["spans"]],
            tuple(t["window"]), t["dropped"])


def merged(intervals, lo, hi) -> list:
    """The union of (start, end) ``intervals`` clipped to [lo, hi], as
    sorted disjoint pairs."""
    out = []
    for s, e in sorted((max(i[0], lo), min(i[1], hi)) for i in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_share(device, window) -> float | None:
    """1 - the union of the device operations' intervals over the window;
    None without device operations."""
    if not device or window[1] <= window[0]:
        return None
    busy = sum(e - s for s, e in merged([d[1:] for d in device], *window))
    return 1.0 - busy / (window[1] - window[0])


def stage_ms(device, window, steps: int) -> dict:
    """{stage: device ms per step} of the port's stage marks: each non-mark
    operation counts in the stage of the last ``gs_mark_<stage>`` begun
    before it (None before the first), a union per stage over the window."""
    from gaussiansplatting_tpu_torch.utils.tracing import MARK_PREFIX

    if not any(d[0].startswith(MARK_PREFIX) for d in device):
        return {}
    by_stage, stage = collections.defaultdict(list), None
    for name, s, e in sorted(device, key=lambda d: d[1]):
        if name.startswith(MARK_PREFIX):
            stage = name[len(MARK_PREFIX):]
        else:
            by_stage[stage].append((s, e))
    return {k: sum(e - s for s, e in merged(v, *window)) / 1e6 / steps
            for k, v in by_stage.items()}


def _path(spans, i: int) -> str:
    """The names from span ``i``'s request root down to it."""
    names = []
    while i >= 0:
        names.append(spans[i].name)
        i = spans[i].parent
    return " > ".join(reversed(names))


def idle_ms(device, spans, window, steps: int) -> tuple[dict, dict]:
    """({span path: device idle ms per step}, {request: idle ms per step}):
    each gap in the union of the device operations over the window charged
    to the innermost span (the latest begun) open when it began, named by
    its path (``graph.run_steps > graph.replay``), and to the root span of
    its request; "host" where none is open."""
    if not device:
        return {}, {}
    gaps, t = [], window[0]
    for s, e in merged([d[1:] for d in device], *window):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if window[1] > t:
        gaps.append((t, window[1]))
    roots = {s.request: s.name for s in spans if s.parent == -1}
    by_path, by_request = collections.Counter(), collections.Counter()
    for g0, g1 in gaps:
        ms = (g1 - g0) / 1e6 / steps
        open_spans = [i for i, s in enumerate(spans) if s.start_ns <= g0 < s.end_ns]
        if not open_spans:
            by_path["host"] += ms
            by_request["host"] += ms
            continue
        i = max(open_spans, key=lambda i: (spans[i].start_ns, -spans[i].end_ns))
        by_path[_path(spans, i)] += ms
        by_request[roots.get(spans[i].request, spans[i].name)] += ms
    return dict(by_path), dict(by_request)


def device_profile(label, fn, reps, smi, device="cuda", log=print, top=12):
    """A kernels-only torch.profiler of ``reps`` calls of ``fn`` (warmed
    once) on ``device``: logs the device ms per call and the ``top`` largest
    kernels; returns (device ms per call, {kernel name: ms per call}).  On
    the CPU it profiles the operators' self time instead."""
    import torch

    cuda = torch.device(device).type == "cuda"
    fn()
    _sync(device)
    act = torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[act]) as prof:
        for _ in range(reps):
            fn()
        _sync(device)
    ka = prof.key_averages()

    def own(e):
        return e.self_device_time_total if cuda else e.self_cpu_time_total

    per = 1e3 * reps                                # profiler us -> ms per call
    kernels = {e.key: own(e) / per for e in ka}
    total = sum(kernels.values())
    log(f"{label}: device time {total:.3f} ms per call (torch.profiler, {reps} calls) on {smi}")
    for e in sorted(ka, key=lambda e: -own(e))[:top]:
        log(f"{label}   {own(e) / per:8.3f} ms x{e.count // reps:4d}  {e.key[:90]}")
    # what compose's global float32 prefix used to cost: torch's outer-dim
    # cumsum and the gather's index-put backward
    outer, put = (sum(v for k, v in kernels.items() if s in k)
                  for s in ("scan_outer_dim", "indexing_backward"))
    log(f"{label}   outer-dim scans {outer:.3f} ms, index-put backward {put:.3f} ms per call")
    return total, kernels


def step_breakdown(states, cam, gt, cfg, capacities, profile_capacity, total_iters, smi,
                   device="cuda", log=print, prefix="[step]", reps=3, top=12):
    """Where a train step goes on the card, for each ``states`` entry
    (label -> TrainState): the step timed (profile.time_ms, ``reps`` steps)
    at each pair capacity of ``capacities``, and a kernels-only profile
    (device_profile) of ``reps`` steps at ``profile_capacity``.  Returns
    {label: device ms per step} from the profiles."""
    from gaussiansplatting_tpu_torch.tools.profile import time_ms
    from gaussiansplatting_tpu_torch.train import trainer

    device_ms = {}
    for label, st in states.items():
        alive = int(st.params.alive.sum())
        for pc in sorted(set(capacities)):
            c = cfg.replace(raster=cfg.raster.replace(pair_capacity=pc))
            _, m = trainer.train_step(st, cam, gt, c, total_iters)
            ms = time_ms(lambda: trainer.train_step(st, cam, gt, c, total_iters), reps, device)
            log(f"{prefix} {label}: {alive} alive of {st.params.capacity} slots, "
                f"pair_capacity {pc}: {ms:.3f} ms/step (CUDA events, {reps} steps), pairs "
                f"{int(m.num_pairs)}, overflow {bool(m.overflow)} on {smi}")
        c = cfg.replace(raster=cfg.raster.replace(pair_capacity=profile_capacity))
        device_ms[label], _ = device_profile(
            f"{prefix} {label} profile at pair_capacity {profile_capacity}",
            lambda: trainer.train_step(st, cam, gt, c, total_iters), reps, smi, device, log,
            top)
    return device_ms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=608)
    p.add_argument("--pair-capacity", type=int, default=1 << 21)
    p.add_argument("--payload-dtype", choices=("f32", "bf16"), default="f32",
                   help="pair-payload precision (bf16: the packed table and blends)")
    p.add_argument("--pack-positions", type=int, choices=(0, 1), default=0,
                   help="with --payload-dtype bf16: tile-relative bf16 positions")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--loop", action="store_true",
                   help="trace train_loop for --steps iterations from a fresh state, its "
                        "events every %d iterations" % LOOP_EVENTS)
    p.add_argument("--out", default=os.path.join("build", "trace"))
    p.add_argument("--parse-only", action="store_true",
                   help="skip capture; aggregate an existing --out dir")
    p.add_argument("--device", default="cuda",
                   help="torch device to trace (default cuda; no fallback)")
    args = p.parse_args(argv)

    host_ms = None
    if not args.parse_only:
        from gaussiansplatting_tpu_torch.tools.render import _device

        host_ms = capture(args.steps, args.n, args.width, args.height, args.pair_capacity,
                          args.out, _device(args.device), args.payload_dtype,
                          bool(args.pack_positions), args.loop)
    device, spans, window, dropped = timeline(args.out)
    for stage, ms in sorted(stage_ms(device, window, args.steps).items(),
                            key=lambda x: -x[1]):
        print(f"{ms:9.3f} ms/step  stage {stage}")
    by_path, by_request = idle_ms(device, spans, window, args.steps)
    for path, ms in sorted(by_path.items(), key=lambda x: -x[1]):
        print(f"{ms:9.3f} ms/step  idle in {path}")
    for root, ms in sorted(by_request.items(), key=lambda x: -x[1]):
        print(f"{ms:9.3f} ms/step  idle under {root}")
    if dropped:
        print(f"{dropped} spans dropped (the buffer was full): the idle charges are partial")
    rows = aggregate(args.out, args.steps, args.top, {s.name for s in spans})
    for name, ms in rows:
        print(f"{ms:9.3f} ms/step  {name}")
    idle = idle_share(device, window)
    said = (f"the card idles {idle:.3f} of the traced window" if idle is not None
            else "no device operation traced")
    if host_ms is not None:
        print(f"{host_ms:9.3f} ms/step  host clock ({args.steps} synchronized steps); {said}")
    else:
        print(said)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
