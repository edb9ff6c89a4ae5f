"""Slots to runs: the id of the run that covers each slot.  The CUDA kernel
pair's wrapper and its plain PyTorch version.

Counterpart of the JAX package's ``_run_ids`` (gaussiansplatting_tpu/ops/
pairs.py:82-95), which XLA compiles: no Pallas kernel.  Contract, for R runs
over S = ``num_slots`` slots:

  inputs   starts [R] int32, each run's first slot (exclusive-prefix sums
           of the run lengths, so never negative); run_live [R] bool, the
           runs that may seed (a run of length 0 must not: its start is the
           next run's).
  output   [S] int32: slot s gets the largest id i of a live run with
           starts[i] <= s, and -1 where there is none.  A live run whose
           start lies at or past S seeds nothing (JAX: ``mode="drop"``).

The pairs stage (ops/pairs.py) calls it twice a frame: chunk slots to
Gaussians (``_expand_and_sort1``) and aligned blocks to tiles
(``_block_tiles``), so every render, step and T-floor graph runs it.

On a CUDA tensor the wrapper launches csrc/runs.cu (a memset, a seed kernel
and a device-wide max-scan, in int32) and counts the call under ``run_ids``
in utils/tracing.py's registry; on a CPU tensor it runs the plain version, the JAX form: a scatter-amax of run ids at the live runs' starts,
then a running max.  Nothing falls back from one to the other.  Max over
integers is exact, so the two agree bit for bit.

Every launch goes to ``torch.cuda.current_stream``, and the result and its
workspace come from ``torch.empty`` on the card, so a step or a render
captured as a CUDA graph (train/graph.py) records them.
"""

from __future__ import annotations

import torch

from gaussiansplatting_tpu_torch.kernels import build
from gaussiansplatting_tpu_torch.utils import tracing

_I32 = torch.int32
# slots a launch may take: the kernels index in int32, up to a tile past S
MAX_SLOTS = 2**31 - 2**14

tracing.counted("run_ids")


def run_ids(starts: torch.Tensor, run_live: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Each slot's covering run id [num_slots] int32 (see the module
    docstring)."""
    num_slots = int(num_slots)
    if (starts.dim() != 1 or starts.dtype != _I32 or run_live.shape != starts.shape
            or run_live.dtype != torch.bool or run_live.device != starts.device):
        raise ValueError(f"starts must be [R] int32 and run_live [R] bool on one device, got "
                         f"{tuple(starts.shape)} {starts.dtype} on {starts.device} and "
                         f"{tuple(run_live.shape)} {run_live.dtype} on {run_live.device}")
    if not 0 <= num_slots <= MAX_SLOTS:
        raise ValueError(f"num_slots must lie in [0, {MAX_SLOTS}], got {num_slots}")
    if starts.device.type == "cuda":
        return _launch(starts.contiguous(), run_live.contiguous(), num_slots)
    return run_ids_plain(starts, run_live, num_slots)


def _launch(starts, run_live, num_slots):
    """One call of ``gs_run_ids`` (csrc/runs.cu) on the current stream: the
    result is the first ``num_slots`` ints of a buffer whose tail holds the
    tiles' maxima."""
    workspace = build.entry("runs", "gs_run_ids_workspace", "i")(num_slots)
    buf = torch.empty(num_slots + workspace, dtype=_I32, device=starts.device)
    build.launch("runs", "gs_run_ids", "ppiip", starts.device, starts, run_live,
                 starts.shape[0], num_slots, buf, count="run_ids")
    return buf[:num_slots]


# -- the plain version: the CPU path and the kernels' oracle


def run_ids_plain(starts: torch.Tensor, run_live: torch.Tensor, num_slots: int) -> torch.Tensor:
    """The JAX form in torch ops: one scatter-amax of run ids at live run
    starts into a -1 seed, then a running max."""
    ids = torch.arange(starts.shape[0], dtype=torch.int64, device=starts.device)
    # runs that start past the end go to a dump slot (JAX: mode="drop")
    dst = torch.where(run_live & (starts < num_slots), starts.long(), num_slots)
    seed = torch.full((num_slots + 1,), -1, dtype=torch.int64, device=starts.device)
    seed = seed.scatter_reduce(0, dst, ids, reduce="amax")
    return torch.cummax(seed[:num_slots], 0).values.to(_I32)
