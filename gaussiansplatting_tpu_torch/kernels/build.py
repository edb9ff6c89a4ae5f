"""Build, load and launch the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file (which may include the
``csrc/*.cuh`` headers) with plain C entry points, compiled by ``nvcc`` for
``sm_90a`` into a shared library and loaded with ``ctypes``.  The build
runs at first use, into ``build/kernels/`` at the repository root, with a
hash of the source, the headers and the flags in the file name, so an edited
source rebuilds and an unchanged one is loaded as is.

``launch`` is the one way the port calls a kernel: every C entry takes its
arguments, then the stream, and returns ``cudaGetLastError()``.  A wrapper
in ``ops/`` validates its inputs, allocates the outputs with ``torch.empty``
and calls ``launch`` with the entry's signature and, for a counted launch,
its own name, under which utils/tracing.py's registry counts it (the wrapper
registers the name with ``tracing.counted`` when it is imported).  ``entry``
gives a C function of a library that is not a launch (a workspace size).

Nothing here runs at import time: the CPU-only test machine imports every
module and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from gaussiansplatting_tpu_torch.utils import tracing

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
# a C entry's argument types, one letter each: a pointer, a long long, an
# int, a float
_CTYPES = {"p": ctypes.c_void_p, "L": ctypes.c_longlong, "i": ctypes.c_int,
           "f": ctypes.c_float}
_entries: dict[tuple[str, str], tuple] = {}   # (name, symbol) -> (signature, function)
# compiler output (ptxas register / shared-memory report) of builds run in
# this process, by kernel name
build_logs: dict[str, str] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on PATH; raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels are built on the machine with the GPU"
    )


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lands, keyed by its content and
    that of the headers beside it (``csrc/*.cuh``)."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its build exists; returns the path.
    The library is written to a temporary name and renamed into place, so a
    concurrent builder never loads a half-written file."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu (exit {res.returncode}):\n"
                f"{' '.join(cmd)}\n{res.stdout}{res.stderr}"
            )
        build_logs[name] = res.stdout + res.stderr
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(names) -> dict[str, Path]:
    """Build several kernels at once, one nvcc process each, all started
    together; raises the first failure after every build has ended."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = [pool.submit(build, n) for n in names]
    return {n: f.result() for n, f in zip(names, futures)}


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s shared library once
    per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib


def entry(name: str, symbol: str, signature: str):
    """The C function ``symbol`` of ``csrc/<name>.cu``'s library, returning
    an int, with its argument types set from ``signature`` (one letter per
    argument: p a pointer, L a long long, i an int, f a float) once per
    symbol.  Raises if another signature was given for it before."""
    known = _entries.get((name, symbol))
    if known is None:
        fn = getattr(load_library(name), symbol)
        fn.argtypes = [_CTYPES[c] for c in signature]
        fn.restype = ctypes.c_int
        known = _entries[(name, symbol)] = (signature, fn)
    if known[0] != signature:
        raise ValueError(f"{symbol} is bound with signature {known[0]!r}, not {signature!r}")
    return known[1]


def launch(name: str, symbol: str, signature: str, device, *args,
           count: str | None = None) -> None:
    """Call the C entry ``symbol`` of ``csrc/<name>.cu`` with ``args`` (by
    ``signature``, as ``entry`` reads it; a tensor passes its data pointer,
    None a null pointer) and the current stream of ``device``.  Raises
    RuntimeError naming the symbol where the entry returns a CUDA error;
    then counts the launch under ``count`` in utils/tracing.py's registry,
    where given."""
    fn = entry(name, symbol, signature + "p")
    dev = torch.device(device)
    values = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = fn(*values, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    if count is not None:
        tracing.add_launches({count: 1})
