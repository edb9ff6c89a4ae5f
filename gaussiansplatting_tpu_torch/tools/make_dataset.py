"""Generate the synthetic photoreal-ish COLMAP dataset (utils/scenegen.py),
ray-traced with PyTorch.  Counterpart of
gaussiansplatting_tpu/tools/make_dataset.py with the same flags plus
``--device``.

  python -m gaussiansplatting_tpu_torch.tools.make_dataset --out /path/scene \
      [--views 200] [--width 800] [--height 608] [--points 150000] [--device cuda]

Then train on it like any COLMAP scene:
  python -m gaussiansplatting_tpu_torch.tools.train --colmap /path/scene/sparse/0 \
      --images /path/scene/images ...

``--device cuda`` (the default) exits with an error if CUDA is unavailable.
The last line printed is a JSON object of the times: ms per view of the ray
tracer (CUDA events on the card), the PNG writing, the point cloud and the
total (host clock).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--views", type=int, default=200)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=608)
    p.add_argument("--points", type=int, default=150_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--device", default="cuda",
                   help="torch device to ray-trace on (default cuda; no fallback)")
    args = p.parse_args(argv)

    from gaussiansplatting_tpu_torch.tools.render import _device
    from gaussiansplatting_tpu_torch.utils.scenegen import generate_dataset

    device = _device(args.device)
    times = generate_dataset(
        args.out, num_views=args.views, width=args.width, height=args.height,
        num_points=args.points, seed=args.seed, fov_deg=args.fov, device=device,
    )
    print(json.dumps({"views": args.views, "width": args.width, "height": args.height,
                      "points": args.points, "device": str(device), **times}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
