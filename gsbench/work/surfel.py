"""Floors of the 2D Gaussian surfel's kernels on one NVIDIA H100: the least
time the surfel blend pair and the surfel projection pair could take for a
training step, counted from what the inputs need (reference/surfel.py's
counts of a view) at work/floors.py's rates.

What is counted (``counts``):

  live    surfels alive in the state
  pairs   (tile, surfel) pairs the frame emits
  pixels  pixels of the image
  tests   (pixel, pair) intersection tests at pixel granularity: for each
          emitting surfel, the pixels whose centre lies in its rectangle's
          box (the image of its disc of radius 3 joined with the low-pass
          disc; no other pixel can keep it)
  kept    (pixel, pair) terms whose alpha passes the window and the floor

Operations count an FMA as two; a division, exp, log1p or reciprocal as
one.  Per test (the ray-splat intersection and the low-pass of eqs. 8-11):
h_u and h_v (6 FMAs), their cross product (3 FMAs, 3 multiplies), u and v
(2 divisions), u^2 + v^2 (an FMA, a multiply), the centre offsets (2), 2
|d|^2 (an FMA, 2 multiplies), the choice, the power and the two window
compares: 36.  Per kept term forward: the exp and op times it, the floor
compare, the cap, w = alpha T, the colour (3 FMAs), z (2 FMAs), m (a
division, a subtraction, a multiply), the depth, normal (3 FMAs) and two
moment sums (an FMA, a multiply, an FMA), T *= 1 - alpha (2), S += log1p
(2): 36.  Backward: T from the reciprocal (2), w, e (9 FMAs), dl, dalpha
(3), dpow, dm/dz (3), dz (4), the suffix (2), the intersection's chain (gu,
gv, the cross products' cotangents, gc: ~40) and sixteen column sums as
FMAs (32): 110.  Bytes: each array touched once, a pair's 17 table floats
read and its id written forward, its 17 floats and 16 cotangents backward,
each pixel's 10 sums written forward and their cotangents read backward.
The projection: 53 bytes read and 92 written a surfel forward (fields,
colour; the [22] row and the depth key), 53 + 64 read and 52 written
backward (the row's sixteen data cotangents, the gradients); its ~250 and
~300 operations a surfel lie ~10x below the bytes' time.
"""

from __future__ import annotations

from gsbench.work.floors import F32, Work

OPS_PER_TEST = 36
FWD_OPS_PER_KEPT = 36
BWD_OPS_PER_KEPT = 110
TABLE_FLOATS = 17
COLUMNS = 16
PIXEL_SUMS = 10
PROJECT_FWD = (250, 53 + 92)
PROJECT_BWD = (300, 53 + 64 + 52)


def blend_fwd(c: dict) -> Work:
    return Work(OPS_PER_TEST * c["tests"] + FWD_OPS_PER_KEPT * c["kept"],
                F32 * ((TABLE_FLOATS + 1) * c["pairs"] + PIXEL_SUMS * c["pixels"]))


def blend_bwd(c: dict) -> Work:
    return Work(OPS_PER_TEST * c["tests"] + BWD_OPS_PER_KEPT * c["kept"],
                F32 * ((TABLE_FLOATS + COLUMNS) * c["pairs"] + PIXEL_SUMS * c["pixels"]))


def project_fwd(c: dict) -> Work:
    return Work(PROJECT_FWD[0] * c["live"], PROJECT_FWD[1] * c["live"])


def project_bwd(c: dict) -> Work:
    return Work(PROJECT_BWD[0] * c["live"], PROJECT_BWD[1] * c["live"])
