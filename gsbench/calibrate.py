"""Readings that set a cell's limits: the program's on many seeds (the lower
reading of each number is their largest), the control's (the reference at
the precision below the configuration's, in the program's place) and,
for a cell that trains, the planted fault of half the batch left out (the
upper reading is the smallest of these that is at least three times the
lower), all in one process at the cell's own size:

    python3 gsbench/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 3] [--seconds 1]

Each seed runs the cell's set-up, a short window (``--seconds``, long
enough for the set-up's frames or steps and the sample a run compares) and
its check.  Prints one JSON line per seed, then a summary line.  Not part of
a benchmark run.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from gsbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3,
                   help="how many of the seeds also read the control and the faults")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)

    import os

    import torch

    os.environ.update(harness.cache_env(ROOT))
    bench = harness.manifest(ROOT)
    spec = harness.cell_spec(bench, args.workload)
    cfg = harness.load_json("configs", spec["config"])
    traffic = harness.load_json("traffic", spec["traffic"])
    cls = harness.driver_class(traffic)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lower, upper = {}, {}
    for n, seed in enumerate(args.seeds):
        t0 = time.time()
        drv = cls(cfg, traffic, seed, dev)
        drv.setup()
        drv.window(args.seconds, time.perf_counter)
        drv.release()
        row = {"seed": seed, "program": drv.check()}
        for k, v in row["program"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        if n < args.control_seeds:
            row["control"] = drv.control()
            if hasattr(drv, "fault_half_batch"):
                row["half_batch"] = drv.fault_half_batch()
            for kind in ("control", "half_batch"):
                for k, v in row.get(kind, {}).items():
                    upper.setdefault(k, {}).setdefault(kind, []).append(v)
        row["seconds"] = time.time() - t0
        print(json.dumps(row), flush=True)
        del drv
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    summary = {"workload": args.workload, "lower": lower,
               "upper": {k: {kind: min(v) for kind, v in d.items()} for k, d in upper.items()},
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
