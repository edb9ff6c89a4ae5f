"""The port stands alone: with jax, flax and gaussiansplatting_tpu blocked
from import, every module of gaussiansplatting_tpu_torch (ops/packing.py
among them) imports and a tiny scene renders on the CPU, in float32 and in
the bf16 payload mode (the machine with the GPU has no JAX)."""

import os
import subprocess
import sys
import textwrap

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "gaussiansplatting_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())

    import torch
    torch.set_num_threads(1)
    import gaussiansplatting_tpu_torch as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)

    from gaussiansplatting_tpu_torch.config import RasterConfig
    from gaussiansplatting_tpu_torch.ops.rasterize import render
    from gaussiansplatting_tpu_torch.utils import synthetic

    params = synthetic.make_scene(40, seed=3, spread=0.6)
    cam = synthetic.make_canonical_camera(32, 32)
    with torch.no_grad():
        img, aux = render(params, cam, RasterConfig(pair_capacity=1024, pair_block=16))
    assert img.shape == (32, 32, 3) and bool(torch.isfinite(img).all())
    assert int(aux.num_pairs) > 0 and float(img.min()) < 0.99
    # the bf16 payload mode and its packing stand alone too
    assert "gaussiansplatting_tpu_torch.ops.packing" in names
    with torch.no_grad():
        img16, _ = render(params, cam, RasterConfig(pair_capacity=1024, pair_block=16,
                                                    payload_dtype="bf16", pack_positions=True))
    assert bool(torch.isfinite(img16).all()) and float((img16 - img).abs().max()) < 0.06
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("OK", len(names), int(aux.num_pairs))
""")


def test_port_imports_and_renders_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    ok, n_modules, n_pairs = res.stdout.split()[-3:]
    assert ok == "OK" and int(n_modules) >= 15 and int(n_pairs) > 0


def _imported_roots(path):
    """The top-level package of every import statement in ``path``,
    including those inside functions."""
    import ast

    roots = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py runs on the card's machine, which has no JAX: none of
    its imports, at top level or inside a phase, names JAX, flax or the
    JAX package."""
    roots = _imported_roots(os.path.join(REPO, "chip_smoke.py"))
    assert "gaussiansplatting_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "gaussiansplatting_tpu"}, roots


def test_chip_smoke_refuses_without_cuda():
    """Without CUDA (this CPU build of torch) and with JAX blocked,
    chip_smoke.py exits non-zero at its device phase and prints no result
    line."""
    if torch.cuda.is_available():
        import pytest

        pytest.skip("this machine has CUDA: chip_smoke.py would run its phases")
    runner = SCRIPT.split("import torch\n")[0] + textwrap.dedent("""
        import runpy
        sys.argv = ["chip_smoke.py"]
        runpy.run_path("chip_smoke.py", run_name="__main__")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", runner], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stdout + res.stderr
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
