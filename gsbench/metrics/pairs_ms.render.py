"""pairs_ms.render: device ms a frame in the port's ``pairs`` stage: the
capacity plan, the pair expansion, the tile sort, the windows and
``_run_ids``' cummax.

Read as projection_ms.render reads its stage (gsbench/portspans.py).  Null
where the trace holds no mark or the port no spans.
"""

from gsbench import portspans


def read(rec):
    return portspans.stage_ms(rec, ("pairs",))
