"""Full train-state checkpointing in the JAX package's file format.

Counterpart of gaussiansplatting_tpu/train/checkpoint.py.  A checkpoint is
one .npz: every leaf of the TrainState keyed by its path (``params/means``,
``opt/m/means``, ``opt/t``, ``accum/grad_count``, ... as ``state_to_numpy``
keys them), the PRNG ``key`` leaf, and ``__meta__``, the JSON
``{format_version, config, iteration, capacity}`` as uint8 bytes.  The two
packages read each other's files:

* the port writes ``key`` as ``[0, cfg.train.seed]`` (uint32), what
  ``jax.random.PRNGKey(seed)`` holds, so JAX's loader finds every leaf of
  its template, plus ``torch/generator``, the state of the port's CPU
  generator, which JAX's loader ignores (it picks only its template's keys);
* a JAX checkpoint has no ``torch/generator``: the port seeds the generator
  from the saved config's ``train.seed`` (0 without a config), so a JAX
  checkpoint resumed here continues with other split offsets than JAX would
  draw (ROADMAP.md §C).
"""

from __future__ import annotations

import io as _io
import json
import os

import numpy as np
import torch

from gaussiansplatting_tpu_torch.config import Config
from gaussiansplatting_tpu_torch.train import state as state_mod
from gaussiansplatting_tpu_torch.train.state import TrainState

FORMAT_VERSION = 1
GENERATOR_KEY = "torch/generator"


def save(path: str, state: TrainState, config: Config | None = None) -> None:
    """Atomically write the checkpoint (write temp, rename)."""
    arrays = state_mod.state_to_numpy(state)
    seed = config.train.seed if config is not None else 0
    arrays["key"] = np.array([0, seed], np.uint32)
    arrays[GENERATOR_KEY] = state.generator.get_state().numpy()
    meta = {
        "format_version": FORMAT_VERSION,
        "config": json.loads(config.to_json()) if config is not None else None,
        "iteration": int(state.opt.t),
        "capacity": state.params.capacity,
    }
    buf = _io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def load(path: str, device) -> tuple[TrainState, Config | None]:
    """Load a checkpoint of either package onto ``device``; returns (state,
    config-or-None)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta["format_version"] > FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {meta['format_version']} newer than "
                f"supported {FORMAT_VERSION}"
            )
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    config = Config.from_json(json.dumps(meta["config"])) if meta["config"] else None
    missing = [k for k in state_mod.leaf_keys() if k not in arrays]
    if missing:
        raise ValueError(f"checkpoint missing leaf {missing[0]!r}")
    seed = config.train.seed if config is not None else 0
    state = state_mod.state_from_numpy(arrays, device, seed=seed)
    if GENERATOR_KEY in arrays:
        state.generator.set_state(torch.from_numpy(arrays[GENERATOR_KEY]))
    return state, config
