"""The numbers that decide ``correct``, each a reading of the system's output
against the reference's (float64) on the same inputs.

Training (a cell that trains): the set-up drives the trained object through
its first three steps on three different ground truths; the reference
follows them from the same initial parameters.

  loss_gap    the largest relative gap of a step's logged loss
  grad_gap    the first gradient as the optimizer received it (its first
              moment after one step over 1 - beta1, which is the clipped
              gradient), by the worst leaf: the gap of the two norms over the
              larger of the reference leaf's norm and the median leaf's
  change_gap  the parameters' change over the three steps, by the worst
              leaf, measured alike; leaves whose reference gradient is under a
              thousandth of the median leaf's are left out (they move by
              round-off alone)

The training loop's cell also compares the loop's last steps of its warm
pass, from the state it holds late in the pass to the state at its end
(``late_loss_gap``, ``late_grad_gap``, ``late_change_gap``: the same numbers
over those steps, the gradient being the first moment's increment over
them), and its densify events.

Frames (a cell that renders): the last frame served for each pose of the
path, and a sample of every frame of the window drawn from the seed (uint8,
as the viewer received them), each against the reference's frame of the
same pose rounded the same way.

  frame_off_share  the largest share, over those frames, of channel values
                   more than one level (of 255) off the reference's
"""

from __future__ import annotations

import statistics

import torch

from gsbench.reference import raster

LEAVES = raster.FIELDS


def _norms(d: dict) -> dict:
    return {f: float(torch.linalg.vector_norm(d[f].double())) for f in LEAVES}


def _worst(prog: dict, ref: dict, keep=None) -> float:
    med = statistics.median(ref.values())
    gaps = [abs(prog[f] - ref[f]) / max(ref[f], med, 1e-30)
            for f in ref if keep is None or f in keep]
    return max(gaps)


def train_readings(prog: dict, ref: dict, p0: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [a float per step], "grad": {leaf:
    the clipped gradient as the optimizer received it}, "params": {leaf: the
    parameters after the steps}}; ``p0`` the parameters they started from."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_prog, g_ref = _norms(prog["grad"]), _norms(ref["grad"])
    med = statistics.median(g_ref.values())
    moved = {f for f in LEAVES if g_ref[f] >= 1e-3 * med}
    c_prog, c_ref = ({f: d["params"][f].double() - p0[f].to(d["params"][f].device).double()
                      for f in LEAVES} for d in (prog, ref))
    c_prog, c_ref = _norms(c_prog), _norms(c_ref)
    return {"loss_gap": loss_gap, "grad_gap": _worst(g_prog, g_ref),
            "change_gap": _worst(c_prog, c_ref, moved)}


def frame_readings(frames: list, ref_images: list) -> dict:
    """``frames``: uint8 [H, W, 3] tensors as served; ``ref_images`` the
    reference's float images of the same poses."""
    worst = 0.0
    for got, want in zip(frames, ref_images):
        diff = (got.to(torch.int16) - raster.to_uint8(want).to(got.device).to(torch.int16)).abs()
        worst = max(worst, float((diff > 1).double().mean()))
    return {"frame_off_share": worst}
