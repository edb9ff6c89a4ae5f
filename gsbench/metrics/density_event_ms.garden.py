"""density_event_ms.garden: the mean time of a density event (densify or
opacity reset, its CPU draw included) in the traced window, in ms.

The benchmark wraps ``trainer.densify_step`` and ``trainer.opacity_reset_step``
(module attributes, as ``train_loop`` calls them) in the traced run only: the
device synchronized, a CUDA event recorded (the device idle, so it marks the
call's start), the call, a second event, synchronized.  Null where no event
fell in the window or the names are gone.
"""


def read(rec):
    ms = rec["spans"].get("density_event_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
