"""surfel_blend_roofline.refine: the surfel blend pair's share of its
roofline in the training step, in %.

The floors of the forward and backward surfel blend (gsbench/work/
surfel.py ``blend_fwd`` + ``blend_bwd`` per step, summed over the window's
steps) over the device time of the kernels whose names hold PATTERN
(csrc/surfel_blend.cu's surfel_blend_fwd_kernel and
surfel_blend_bwd_kernel).  Null where no such kernel ran or drivers/train_surfels.py
counted no floor.
"""

from gsbench import devtrace

PATTERNS = ("surfel_blend_",)


def read(rec):
    busy = devtrace.kernel_seconds(rec["capture"], PATTERNS)
    floor = rec["work"].get("surfel_blend_floor_s")
    if busy <= 0 or not floor:
        return None
    return 100.0 * floor / busy
