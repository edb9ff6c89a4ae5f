"""Scaling benchmark on PyTorch: the sharded train step at 1, 2, 4, ...
ranks (BASELINE.md config #5), counterpart of
gaussiansplatting_tpu/tools/bench_scaling.py with its flags plus
``--devices`` and ``--device``.  Each rank is one process bound to one
device (parallel/launch.py); the group of the first d ranks runs the
sharded step while the others wait.

  python -m gaussiansplatting_tpu_torch.tools.bench_scaling [--n 100000]
      [--width 800 --height 608] [--steps 10] [--devices N] [--device cuda]
      [--coordinator host:port]

Under a launcher (``--coordinator`` or the environment of
parallel/launch.py) every rank runs this program; without one it starts
``--devices`` local ranks itself (default: one per visible card).  Ranks
that share a card run on gloo (launch.BACKEND_RULE): their times measure
the strip scheme's overhead on that card, not scaling.  Prints the
topology, one JSON line per group size and a summary line, from rank 0.
``--device cuda`` (the default) refuses without CUDA; the CPU runs only
when asked for with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=608)
    p.add_argument("--pair-capacity", type=int, default=1 << 20,
                   help="per-rank (per-strip) pair capacity")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--coordinator", default=None, help="process-group coordinator host:port")
    p.add_argument("--devices", type=int, default=None,
                   help="local ranks to start without a launcher (default: the visible "
                        "cards; 1 on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device kind of the ranks (default cuda; no fallback)")
    return p


def group_sizes(world: int) -> list[int]:
    """1, 2, 4, ... up to ``world``, and ``world`` itself."""
    sizes, d = [], 1
    while d <= world:
        sizes.append(d)
        d *= 2
    if sizes[-1] != world:
        sizes.append(world)
    return sizes


def run(topo: dict, args) -> list[dict]:
    """Every rank: the sharded step timed at each group size.  Returns the
    result lines (on every rank; rank 0 prints them)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gaussiansplatting_tpu_torch.config import Config, RasterConfig
    from gaussiansplatting_tpu_torch.parallel import launch
    from gaussiansplatting_tpu_torch.parallel import mesh as mesh_mod
    from gaussiansplatting_tpu_torch.parallel.sharded import make_sharded_train_step
    from gaussiansplatting_tpu_torch.train import state as state_mod
    from gaussiansplatting_tpu_torch.utils import synthetic

    primary = launch.is_primary()
    device = torch.device(topo["device"])
    if primary:
        print(json.dumps({"topology": topo}), flush=True)
    cfg = Config(raster=RasterConfig(pair_capacity=args.pair_capacity))
    params = synthetic.make_scene(n=args.n, seed=0, device=device)
    camera = synthetic.make_canonical_camera(args.width, args.height, device=device)
    gt = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (args.height, args.width, 3)).astype(np.float32)).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    results, base = [], None
    for nd in group_sizes(dist.get_world_size()):
        mesh = mesh_mod.make_mesh(nd)
        if mesh.rank >= 0:
            step = make_sharded_train_step(mesh, cfg, 30_000)
            st, m = step(state_mod.create(params), camera, gt)
            sync()
            t0 = time.perf_counter()
            for _ in range(args.steps):
                st, m = step(st, camera, gt)
            sync()
            dt = (time.perf_counter() - t0) / args.steps
            ips = 1.0 / dt
            base = ips if base is None else base
            results.append({"devices": nd, "iters_per_sec": round(ips, 3),
                            "scaling_efficiency": round(ips / (base * nd), 3),
                            "ms_per_step": round(dt * 1e3, 3), "num_pairs": int(m.num_pairs),
                            "overflow": bool(m.overflow), "backend": topo["backend"]})
            if primary:
                print(json.dumps(results[-1]), flush=True)
        dist.barrier()
    if primary:
        print(json.dumps({"metric": "scaling", "results": results}), flush=True)
    return results


def _rank_main(topo, argv):
    return run(topo, build_parser().parse_args(argv))


def bench(argv=None) -> list[dict]:
    """Run the benchmark (main without the exit code); returns rank 0's
    result lines."""
    args = build_parser().parse_args(argv)
    import torch

    from gaussiansplatting_tpu_torch.parallel import launch

    if args.coordinator is not None or launch.launched():
        try:
            topo = launch.initialize(coordinator=args.coordinator, device=args.device)
        except (ValueError, RuntimeError) as e:
            raise SystemExit(f"error: {e}")
        try:
            return run(topo, args)
        finally:
            launch.shutdown()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"error: --device {args.device} requested but CUDA is not available "
                         "(pass --device cpu for gloo ranks on the CPU)")
    n = args.devices
    if n is None:
        n = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1
    argv = sys.argv[1:] if argv is None else list(argv)
    return launch.spawn(_rank_main, n, (argv,), device=args.device)[0]


def main(argv=None) -> int:
    bench(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
