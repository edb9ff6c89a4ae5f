"""regularizer_ms.refine: device ms a step in the port's ``regularizer`` and
``regularizer_bwd`` stages: 2D Gaussian Splatting's depth normal, normal
consistency and depth distortion over the frame's maps, and their
backward to the maps.

Read as loss_ms.train reads its stages (gsbench/portspans.py).  Null where
the trace holds no mark or the port no spans.
"""

from gsbench import portspans


def read(rec):
    return portspans.stage_ms(rec, ("regularizer", "regularizer_bwd"))
