"""One run of one cell: set-up, the measured window, the check against the
reference, the result line.

Everything is found by name.  ``BENCHMARK.json`` names the cell's
configuration and traffic mix; the configuration is
``gsbench/configs/<config>.json``, the mix ``gsbench/traffic/<mix>.json``,
whose ``driver`` names the generator under ``gsbench/drivers/`` that drives
it; the limits of the cell's check are ``gsbench/limits/<cell>.json``; a
per-layer metric ``<name>`` is read by ``gsbench/metrics/<name>.py``'s
``read(record)``.  A later change adds a configuration, a mix, a limit file
or a metric as a new file, and edits none.

A traced run (``--trace 1``) runs the window under ``torch.profiler`` for
the traffic's ``trace_seconds`` (the loop driver: one whole pass) and reports
the cell's per-layer metrics instead of its end-to-end ones.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussiansplatting_tpu")


def cache_env(root: Path) -> dict:
    """The build and kernel caches, at fixed paths inside the checkout (the
    port's own nvcc builds go to ``build/kernels/`` there)."""
    base = root / "build" / "gsbench"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton")}


def manifest(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_spec(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"gsbench: no workload {name!r} in BENCHMARK.json")


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys replaced, dicts merged at every depth."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def driver_class(traffic: dict):
    return importlib.import_module(f"gsbench.drivers.{traffic['driver']}").Driver


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("gsbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` that this cell reports."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name, compared whole,
    is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: dict | None = None) -> dict:
    """Run ``cell`` once on ``device`` and return the result dict (without
    printing).  ``overrides`` (tests) replaces keys of the configuration and
    the traffic mix: {"config": {...}, "traffic": {...}}, merged at every
    depth."""
    import torch

    spec = cell_spec(bench, cell)
    cfg = load_json("configs", spec["config"])
    traffic = load_json("traffic", spec["traffic"])
    limits = load_json("limits", cell)
    overrides = overrides or {}
    cfg = merged(cfg, overrides.get("config", {}))
    traffic = merged(traffic, overrides.get("traffic", {}))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    drv = driver_class(traffic)(cfg, traffic, seed, dev)
    drv.setup()
    setup_s = time.time() - t_start

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    from gsbench import devtrace

    spans = devtrace.Spans(trace)
    prof = None
    if trace:
        act = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(activities=[act.CUDA if cuda else act.CPU])
        prof.__enter__()
    if trace:
        # reading a trace costs ~40 us a device operation (profiler and reader):
        # a traced run traces the first trace_seconds of the window
        seconds = min(seconds, float(traffic["trace_seconds"]))
    try:
        with spans(devtrace.WINDOW_SPAN):
            stats = drv.window(seconds, time.perf_counter, spans)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    drv.release()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.time()
    readings = drv.check()
    print(f"gsbench: setup {setup_s:.3f} s, check {time.time() - t_check:.3f} s",
          file=sys.stderr)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": int(spec.get("chips", 1)), "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": stats["attempted"], "failed": stats["failed"]}
    if trace:
        t_read = time.time()
        cap = devtrace.collect(prof, spans)
        lo, hi = devtrace.window_of(cap)
        window_s = (hi - lo) * 1e-9
        busy_s = devtrace.busy_ns([(d.start, d.end) for d in cap.device], lo, hi) * 1e-9
        t_work = time.time()
        work = drv.work()
        t_work = time.time() - t_work
        record = {"cell": cell, "capture": cap, "window_s": window_s, "busy_s": busy_s,
                  "work": work, "counters": getattr(drv, "counters", {}),
                  "spans": getattr(drv, "spans", {})}
        metrics = {}
        for m in cell_metrics(bench, cell, "per_layer"):
            value = metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=busy_s, window_s=window_s)
        result.update(metrics=metrics, device=device_info,
                      breakdown={"device_ops": devtrace.device_ops(cap),
                                 "idle_gaps": devtrace.idle_gaps(cap)})
        first = min((d.start for d in cap.device), default=lo)
        last = max((d.end for d in cap.device), default=hi)
        print(f"gsbench: trace read in {time.time() - t_read - t_work:.3f} s and the work "
              f"counted in {t_work:.3f} s, {len(cap.device)} device "
              f"operations, the first {(first - lo) * 1e-6:.3f} ms after the window opened, "
              f"the last {(last - hi) * 1e-6:.3f} ms after it closed", file=sys.stderr)
    else:
        values = dict(stats["end_to_end"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, cell, "end_to_end")}
        result.update(metrics=metrics, device=device_info)
    result["checks"] = checks
    return result


def parse(argv):
    p = argparse.ArgumentParser(prog="gsbench/run.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float, root: Path) -> int:
    args = parse(argv)
    os.environ.update(cache_env(root))
    bench = manifest(root)
    spec = cell_spec(bench, args.workload)

    import torch

    chips = int(spec.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gsbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", t_start)
    found = forbidden_modules()
    if found:
        print(f"gsbench: the run loaded JAX or the JAX package: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
