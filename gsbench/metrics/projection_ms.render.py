"""projection_ms.render: device ms a frame in the port's ``projection`` stage:
the projection, the SH colour, the [N, 9] table and the depth presort.

The non-mark device operations between the port's ``gs_mark_projection`` and
the next stage mark, a union summed over the traced window, over the frames
the window replayed (the ``gs_mark_end`` marks that close one;
gsbench/portspans.py).  Null where the trace holds no mark or the port no
spans.
"""

from gsbench import portspans


def read(rec):
    return portspans.stage_ms(rec, ("projection",))
