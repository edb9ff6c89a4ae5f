"""sync_idle_ms.garden: device idle ms a pass of the training loop charged to
the port's ``loop.pair_read`` span (the adaptive pair capacity reading the
pair count and the overflow flag back to the host).

Idle gaps charged as copy_idle_ms.render charges them, over the passes of the
traced window (gsbench/portspans.py).  Null where the port has no spans or
the window completed no step.
"""

from gsbench import portspans


def read(rec):
    return portspans.idle_ms(rec, ("loop.pair_read",), "pass")
