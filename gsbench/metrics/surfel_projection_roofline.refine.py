"""surfel_projection_roofline.refine: the surfel projection pair's share of
its roofline in the training step, in %.

The floors of the surfel projection forward and backward (gsbench/work/
surfel.py ``project_fwd`` + ``project_bwd`` per step, bytes bound, summed
over the window's steps) over the device time of the kernels whose names
hold PATTERN (csrc/surfel_projection.cu's surfel_project_fwd_kernel and
surfel_project_bwd_kernel).  Null where no such kernel ran or drivers/train_surfels.py
counted no floor.
"""

from gsbench import devtrace

PATTERNS = ("surfel_project_",)


def read(rec):
    busy = devtrace.kernel_seconds(rec["capture"], PATTERNS)
    floor = rec["work"].get("surfel_projection_floor_s")
    if busy <= 0 or not floor:
        return None
    return 100.0 * floor / busy
