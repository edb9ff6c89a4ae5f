"""blend_roofline.train: the blend kernels' share of their roofline in the
training step, in %.

The frozen floors of the forward and backward blend (gsbench/work/floors.py
``blend_fwd`` + ``blend_bwd``, per step, summed over the window's steps) over
the device time of the kernels whose names hold one of PATTERNS (the float32
and the bf16 packed instances alike).  Null where no such kernel ran.
"""

from gsbench import devtrace

PATTERNS = ("blend_fwd_win", "blend_bwd_win")


def read(rec):
    busy = devtrace.kernel_seconds(rec["capture"], PATTERNS)
    if busy <= 0 or not rec["work"].get("requests"):
        return None
    return 100.0 * rec["work"]["blend_floor_s"] / busy
