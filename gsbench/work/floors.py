"""The frozen yardstick: the least time one NVIDIA H100 could take for a
frame, a training step or the blend inside them, counted from what the
inputs need and not from how any kernel lays out its work.

What is counted (``counts``: a frame's numbers, which the reference
computes from the benchmark's own inputs):

  live    Gaussians alive in the state
  pairs   (tile, Gaussian) pairs the frame emits (16 x 16 tiles, the
          3-sigma rectangle, the 256-tile cap, the opacity floor)
  pixels  pixels of the image
  tests   power tests at pixel granularity: for each emitting Gaussian, the
          pixels whose centre lies in the box of its 3-sigma ellipse (no
          other pixel can keep it)
  kept    (pixel, pair) terms whose alpha passes the power window and the
          alpha floor

Operations count an FMA as two, and ``F32_OPS_PER_S`` is the H100 SXM's
67 TFLOP/s of float32 outside the tensor cores; ``HBM_BYTES_PER_S`` its
3.35 TB/s (NVIDIA's data sheet, at 700 W).  Per power test: 7 multiplies,
an add, a subtraction and the window's 2 compares (11; dx and dy are shared
along a row and a column).  Per kept term in the forward: the multiply by
exp and the exp, the floor compare, the cap, w = alpha T, 3 colour FMAs, T
*= 1 - alpha (2), S += log1p (2): 15.  In the backward: 27 operations as
they are counted for the port's backward (op * exp, the compares, 1 - alpha
and its reciprocal, T, w, e (3), dl, dpow (3), dpow dx, dpow dy, the nine
sums, the suffix) with the nine sums as FMAs: 36.  The bytes are each
array touched once: a Gaussian's 14 render floats (23 stored floats where a
step writes them), a pair's id written and read, the image written once.
exp, log1p and a reciprocal count as one operation each though each takes
several, so every floor stays a lower bound.
"""

from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32 = 4

OPS_PER_TEST = 11
FWD_OPS_PER_KEPT = 15
BWD_OPS_PER_KEPT = 36
PROJECT_OPS = 100          # projection of one Gaussian, forward
PROJECT_BWD_OPS = 200      # and its backward
LOSS_OPS_PER_PIXEL = 670   # L1 (10) and D-SSIM: 5 planes x 2 passes x 11 taps x 2, fwd + 2x bwd
ADAM_OPS_PER_FLOAT = 12
RENDER_FLOATS = 14         # means 3, log-scales 3, quaternion 4, opacity 1, SH DC 3
STORED_FLOATS = 23         # ... and the SH coefficients of degree 1
PAIR_FLOATS = 10           # id, screen x, y, conic 3, opacity, rgb 3


class Work(NamedTuple):
    ops: float
    bytes: float

    def __add__(self, other):
        return Work(self.ops + other.ops, self.bytes + other.bytes)

    def seconds(self) -> float:
        """The floor: the larger of the operations' and the bytes' times."""
        return max(self.ops / F32_OPS_PER_S, self.bytes / HBM_BYTES_PER_S)


def blend_fwd(c: dict) -> Work:
    """The forward blend: every pair's render data read once, every pixel's
    colour and transmittance written once."""
    return Work(OPS_PER_TEST * c["tests"] + FWD_OPS_PER_KEPT * c["kept"],
                F32 * (PAIR_FLOATS * c["pairs"] + 4 * c["pixels"]))


def blend_bwd(c: dict) -> Work:
    """The backward blend: the pairs' data and the pixels' cotangents read,
    nine cotangent columns per pair written."""
    return Work(OPS_PER_TEST * c["tests"] + BWD_OPS_PER_KEPT * c["kept"],
                F32 * ((PAIR_FLOATS + 9) * c["pairs"] + 4 * c["pixels"]))


def frame(c: dict) -> Work:
    """A rendered frame: projection, the pairs, the forward blend, the
    image."""
    return blend_fwd(c) + Work(PROJECT_OPS * c["live"],
                               F32 * (RENDER_FLOATS * c["live"] + 2 * c["pairs"]
                                      + 3 * c["pixels"]))


def step(c: dict) -> Work:
    """A training step: the frame, the loss against the ground truth and
    its gradient, the backward blend and projection, the per-Gaussian
    gradients and Adam over the live Gaussians (parameters, gradient and
    both moments read, parameters and moments written)."""
    return (frame(c) + blend_bwd(c)
            + Work(LOSS_OPS_PER_PIXEL * c["pixels"] + PROJECT_BWD_OPS * c["live"]
                   + ADAM_OPS_PER_FLOAT * STORED_FLOATS * c["live"],
                   F32 * (3 * c["pixels"] + 2 * c["pairs"] + RENDER_FLOATS * c["live"]
                          + 7 * STORED_FLOATS * c["live"])))
