"""compose_ms.render: device ms a frame in the port's ``compose`` stage: each
block's incoming log T, the segment sums and the image (``_compose_tiles``).

Read as projection_ms.render reads its stage (gsbench/portspans.py).  Null
where the trace holds no mark or the port no spans.
"""

from gsbench import portspans


def read(rec):
    return portspans.stage_ms(rec, ("compose",))
