"""step_mfu.train: the whole training step's share of the H100's peak, in %.

The floor of every step the traced window completed (gsbench/work/floors.py
``step``, counted from the inputs: live Gaussians, the pairs, power tests and
kept terms of the frame, the pixels) over the window's length.  Null where
the window completed no step.
"""


def read(rec):
    work = rec["work"]
    if not work.get("requests") or rec["window_s"] <= 0:
        return None
    return 100.0 * work["floor_s"] / rec["window_s"]
