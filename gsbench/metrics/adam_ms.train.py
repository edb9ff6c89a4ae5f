"""adam_ms.train: device ms a step in the port's ``adam`` stage
(``trainer.step_update``: Adam, the density statistics, the step's metrics,
and the new state written back into the graph's buffers).

Read as loss_ms.train reads its stages (gsbench/portspans.py).  Null where
the trace holds no mark or the port no spans.
"""

from gsbench import portspans


def read(rec):
    return portspans.stage_ms(rec, ("adam",))
