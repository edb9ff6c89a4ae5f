"""Graft entry point: a single-card forward render on the flagship model
(the differentiable tiled 3DGS rasterizer) plus example arguments.

Counterpart of ``entry`` in the repository's __graft_entry__.py: 1,024
Gaussians of ``utils/synthetic.make_scene(seed=0)``, the canonical 256x256
camera, ``pair_capacity=2^15`` and ``pair_block=64``.  The multi-card
``dryrun_multichip`` waits for the port of ``parallel/``.

    forward, (params, camera) = entry()          # on the card
    image = forward(params, camera)              # [256, 256, 3]
"""

from __future__ import annotations


def entry(device="cuda"):
    """(forward, (params, camera)) with params and camera on ``device``;
    forward(params, camera) returns the rendered image [H, W, 3]."""
    from gaussiansplatting_tpu_torch.config import RasterConfig
    from gaussiansplatting_tpu_torch.ops.rasterize import render
    from gaussiansplatting_tpu_torch.utils import synthetic

    cfg = RasterConfig(pair_capacity=1 << 15, pair_block=64)
    params = synthetic.make_scene(n=1024, seed=0, device=device)
    camera = synthetic.make_canonical_camera(width=256, height=256, device=device)

    def forward(params, camera):
        image, aux = render(params, camera, cfg)
        return image

    return forward, (params, camera)
