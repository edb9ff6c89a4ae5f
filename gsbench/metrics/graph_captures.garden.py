"""graph_captures.garden: CUDA graph captures per pass of the training loop in
the traced window (``graph.counts``: step, density, render, sharded and
tracer captures), after the set-up's warm pass captured every key once.
Null where the window completed no step.
"""


def read(rec):
    c = rec["counters"]
    if not c.get("passes"):
        return None
    return c["window_captures"] / c["passes"]
