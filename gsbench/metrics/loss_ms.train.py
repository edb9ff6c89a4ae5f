"""loss_ms.train: device ms a step in the port's ``loss`` and ``loss_bwd``
stages: the photometric loss (L1 and D-SSIM) and its backward to the image.

Non-mark device operations between the stage marks, a union summed over the
traced window, over the steps the window replayed (the ``gs_mark_end`` marks
that close one; gsbench/portspans.py).  Null where the trace holds no mark or
the port no spans.
"""

from gsbench import portspans


def read(rec):
    return portspans.stage_ms(rec, ("loss", "loss_bwd"))
