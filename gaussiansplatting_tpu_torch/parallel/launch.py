"""Starting and joining the process group (counterpart of
gaussiansplatting_tpu/parallel/launch.py).

JAX runs one controller per host over all its devices; PyTorch runs one
process per rank, each bound to one device.  ``initialize`` joins the group
from arguments or the environment, ``spawn`` starts N local ranks itself.

Environment contract (the JAX package's, then torchrun's):
  COORDINATOR_ADDRESS  host:port of rank 0 (or --coordinator; a URL with
                       "://", such as file:///path, is taken as it is)
  NUM_PROCESSES        total ranks          (torchrun: WORLD_SIZE)
  PROCESS_ID           this process's rank  (torchrun: RANK)
  MASTER_ADDR/PORT     torchrun's coordinator, used when no other is given
  LOCAL_RANK           rank on this host (default: the rank)
  LOCAL_WORLD_SIZE     ranks on this host (default 1: one per host, the
                       JAX contract)

Backend rule (``backend_for``): gloo on the CPU; on CUDA, nccl when every
rank on a host has a card of its own, gloo where ranks share one (NCCL
refuses two ranks on one GPU).  Each rank binds
``cuda:(local_rank % device_count)``.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile

import torch
import torch.distributed as dist

BACKEND_RULE = ("gloo on the CPU; on CUDA nccl when each rank on a host has its own card, "
                "gloo where ranks share one")


def _int_env(*names: str) -> int | None:
    for name in names:
        v = os.environ.get(name)
        if v is not None:
            return int(v)
    return None


def backend_for(device: torch.device, local_world_size: int) -> str:
    """The backend of BACKEND_RULE for ranks on ``device``'s kind."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def _check_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"parallel/launch: device {device!r} requested but CUDA is not "
                           "available (pass device='cpu' for gloo ranks on the CPU)")
    return dev


def _bind(device: str, local_rank: int) -> torch.device:
    dev = _check_device(device)
    if dev.type != "cuda":
        return dev
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str = "cuda",
    local_rank: int | None = None,
    local_world_size: int | None = None,
) -> dict:
    """Join the torch.distributed process group (a no-op with a single
    process and no coordinator) and return the topology: process_index,
    process_count, local_devices (devices of ``device``'s kind this process
    sees), global_devices (ranks, one device each), backend (None without a
    group), backend_rule and the bound device."""
    # explicit zeros are meaningful (process_id=0 is the coordinator), so
    # fall back to the environment only where an argument is None
    if coordinator is None:
        coordinator = os.environ.get("COORDINATOR_ADDRESS")
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = _int_env("NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _int_env("PROCESS_ID", "RANK")
    if local_rank is None:
        local_rank = _int_env("LOCAL_RANK")
    if local_rank is None:
        local_rank = process_id or 0
    if local_world_size is None:
        local_world_size = _int_env("LOCAL_WORLD_SIZE") or 1

    dev = _bind(device, local_rank)
    backend = None
    if coordinator is not None or num_processes not in (None, 1):
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError(
                "parallel/launch: a process group needs a coordinator, the process count "
                "and this process's rank (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID; "
                "or torchrun's MASTER_ADDR, WORLD_SIZE, RANK)")
        if dist.is_initialized():
            raise RuntimeError("parallel/launch: the process group is already initialized")
        backend = backend_for(dev, local_world_size)
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                                rank=process_id)
    count = dist.get_world_size() if backend else 1
    return {
        "process_index": dist.get_rank() if backend else 0,
        "process_count": count,
        "local_devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "global_devices": count,
        "backend": backend,
        "backend_rule": f"{local_world_size} rank(s) per host on {dev.type}: {BACKEND_RULE}",
        "device": str(dev),
    }


def launched() -> bool:
    """True under a launcher: the environment names a process group."""
    return any(k in os.environ for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "WORLD_SIZE",
                                         "MASTER_ADDR"))


def is_primary() -> bool:
    """True on the rank that writes checkpoints, metrics and exports."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, fn, args, world_size, root, device):
    topo = initialize(coordinator="file://" + os.path.join(root, "rendezvous"),
                      num_processes=world_size, process_id=rank, device=device,
                      local_rank=rank, local_world_size=world_size)
    try:
        out = fn(topo, *args)
    finally:
        shutdown()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn, world_size: int, args: tuple = (), device: str = "cuda") -> list:
    """Run ``fn(topology, *args)`` on ``world_size`` local ranks, each a
    process started with the ``spawn`` method (``fn`` and ``args`` must
    pickle: a module-level function), joined through a ``file://``
    rendezvous in a temporary directory, the backend by BACKEND_RULE.
    Returns each rank's return value, by rank; a rank that raises makes
    spawn raise with its traceback (torch.multiprocessing stops the
    others)."""
    _check_device(device)           # refuse before starting a process
    root = tempfile.mkdtemp(prefix="gs_spawn_")
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, args, world_size, root, device), nprocs=world_size,
            join=True, start_method="spawn")
        out = []
        for rank in range(world_size):
            # written by this function's own ranks just above
            with open(os.path.join(root, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)
