"""device_idle.render: the share of the traced window in which no operation
ran on the device, in %: 1 - (union of the device operations' intervals) /
(the window).  Null where the trace holds no device operation.
"""


def read(rec):
    if rec["busy_s"] <= 0 or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
