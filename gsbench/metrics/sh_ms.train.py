"""sh_ms.train: device ms a step in the port's ``sh`` and ``sh_bwd`` stages:
the SH colour of degree 2 or 3 (the view directions, the bands, the clamp)
and its backward to the coefficients and the means.

Read as loss_ms.train reads its stages (gsbench/portspans.py).  Null where
the trace holds no mark or the port no spans.
"""

from gsbench import portspans


def read(rec):
    return portspans.stage_ms(rec, ("sh", "sh_bwd"))
