"""reduction_ms.train: device ms a step in the port's ``reduction`` stage: the
blend backward's column cotangents reduced to per-Gaussian sums
(``ops/rasterize._reduce_to_data``).

Read as loss_ms.train reads its stages (gsbench/portspans.py).  Null where
the trace holds no mark or the port no spans.
"""

from gsbench import portspans


def read(rec):
    return portspans.stage_ms(rec, ("reduction",))
