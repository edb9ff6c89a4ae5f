"""draw_ms.garden: the mean host ms of the port's ``density.draw`` span, the
CPU split draw of one densify event.

A duration and not an idle charge: in a traced run the benchmark's own
wrapper synchronizes the device before every density event.  Null where the
port has no spans or no draw fell in the window (gsbench/portspans.py).
"""

from gsbench import portspans


def read(rec):
    return portspans.mean_span_ms(rec, "density.draw")
