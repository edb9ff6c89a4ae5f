"""capture_idle_ms.garden: device idle ms a pass of the training loop charged
to the port's ``graph.capture`` and ``graph.warmup`` spans (the captures the
pass makes, their eager warm-up calls included).

Idle gaps charged as copy_idle_ms.render charges them, over the passes of the
traced window (gsbench/portspans.py).  Null where the port has no spans or
the window completed no step.
"""

from gsbench import portspans


def read(rec):
    return portspans.idle_ms(rec, ("graph.capture", "graph.warmup"), "pass")
