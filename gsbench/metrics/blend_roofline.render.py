"""blend_roofline.render: the forward blend kernel's share of its roofline in
the frame, in %.

The frozen floor of the forward blend (gsbench/work/floors.py ``blend_fwd``
per frame, summed over the window's frames) over the device time of the
kernels whose names hold one of PATTERNS.  Null where no such kernel ran.
"""

from gsbench import devtrace

PATTERNS = ("blend_fwd_win",)


def read(rec):
    busy = devtrace.kernel_seconds(rec["capture"], PATTERNS)
    if busy <= 0 or not rec["work"].get("requests"):
        return None
    return 100.0 * rec["work"]["blend_floor_s"] / busy
