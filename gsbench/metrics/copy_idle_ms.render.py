"""copy_idle_ms.render: device idle ms a frame charged to the port's
``graph.copy_in`` and ``graph.clone_out`` spans (the render call copying the
parameters and the camera in, and cloning the image and aux out).

Each idle gap of the traced window is charged to the innermost span, the
port's or the benchmark's, open when it began; the sum over the frames the
window replayed (gsbench/portspans.py).  Null where the port has no spans or
the trace no mark.
"""

from gsbench import portspans


def read(rec):
    return portspans.idle_ms(rec, ("graph.copy_in", "graph.clone_out"), "replay")
