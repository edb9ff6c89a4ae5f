"""Device-time capture and aggregation for the train step.

Counterpart of gaussiansplatting_tpu/tools/trace.py: a ``torch.profiler``
capture around N already-warm train steps on the synthetic scene, the
device time grouped by kernel name, the top groups in ms per step, and the
card's idle share, 1 - device time / host clock (the host clock of N
synchronized steps taken just before the capture, without the profiler).

  python -m gaussiansplatting_tpu_torch.tools.trace [--steps 5] [--n 100000]
      [--width 800 --height 608] [--pair-capacity 2097152] [--top 25]
      [--payload-dtype f32|bf16] [--pack-positions 0|1]
      [--out build/trace] [--parse-only] [--device cuda]

The chrome trace goes to ``<out>/trace.json``; ``--parse-only`` aggregates
an existing one.  On the card the groups are the CUDA kernels (and memory
copies and sets); a CPU capture (``--device cpu``) groups the operators'
self time instead.  ``--payload-dtype bf16`` (with ``--pack-positions 1``)
traces the bf16 payload mode, as the JAX tool does.

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
            payload_dtype="f32", pack_positions=False):
    """Warm one step, time ``steps`` synchronized steps on the host clock,
    then profile ``steps`` more and write ``<out>/trace.json``.  Returns the
    host ms per step."""
    import torch

    from gaussiansplatting_tpu_torch.train.trainer import train_step

    device = torch.device(device)
    st, camera, gt, cfg = _setup(n, width, height, pair_capacity, device, payload_dtype,
                                 pack_positions)
    st, _ = train_step(st, camera, gt, cfg, 30_000)   # warm
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        st, _ = train_step(st, camera, gt, cfg, 30_000)
    _sync(device)
    host_ms = 1e3 * (time.perf_counter() - t0) / steps

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            st, _ = train_step(st, camera, gt, cfg, 30_000)
        _sync(device)
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
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


def aggregate(trace_path: str, steps: int, top: int = 25) -> list[tuple[str, float]]:
    """Parse a chrome trace (a file, or a directory holding trace.json);
    return [(group, ms per step)] sorted descending, the ``top`` largest,
    then ("TOTAL(device)", the sum of all groups).  Device events (kernels,
    memory copies and sets) where the trace has any, else the operators'
    self time."""
    if os.path.isdir(trace_path):
        trace_path = os.path.join(trace_path, "trace.json")
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    if dev:
        timed = [(e.get("name", "?"), e.get("dur", 0)) for e in dev]
    else:
        timed = _self_times([e for e in events if e.get("cat") == "cpu_op"])
    groups = collections.Counter()
    for name, us in timed:
        groups[_group_name(name)] += us
    total = sum(groups.values())
    out = [(name, us / 1e3 / steps) for name, us in groups.most_common(top)]
    out.append(("TOTAL(device)", total / 1e3 / steps))
    return out


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
                          bool(args.pack_positions))
    rows = aggregate(args.out, args.steps, args.top)
    for name, ms in rows:
        print(f"{ms:9.3f} ms/step  {name}")
    if host_ms is not None:
        device_ms = rows[-1][1]
        print(f"{host_ms:9.3f} ms/step  host clock ({args.steps} synchronized steps); "
              f"the card idles {1 - device_ms / host_ms:.3f} of it")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
