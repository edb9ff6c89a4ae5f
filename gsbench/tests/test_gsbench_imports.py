"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared
whole (the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "gaussiansplatting_tpu"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax():
    for path in (ROOT / "gsbench").rglob("*.py"):
        assert not (_imports(path) & FORBIDDEN), path


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "gsbench" / "reference").rglob("*.py"):
        names = _imports(path)
        assert "gaussiansplatting_tpu_torch" not in names, path
        assert "tests" not in names, path


def test_forbidden_modules_compares_whole_names():
    from gsbench import harness

    sys.modules.setdefault("gaussiansplatting_tpu_torch_probe_x", sys)
    try:
        assert "gaussiansplatting_tpu_torch_probe_x" not in harness.forbidden_modules()
    finally:
        del sys.modules["gaussiansplatting_tpu_torch_probe_x"]


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, %r); import torch; torch.set_num_threads(2)\n"
            "from pathlib import Path\n"
            "from gsbench import harness\n"
            "from gsbench.tests import small\n"
            "b = harness.manifest(Path(%r))\n"
            "harness.run_cell(b, 'synth100k.render', 5, 0.2, False, 'cpu', time.time(), small.SYNTH)\n"
            "print(harness.forbidden_modules())\n") % (str(ROOT), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "gsbench/run.py", "--workload", "synth100k.render",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    import torch

    if not torch.cuda.is_available():
        assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_without_the_port_prints_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and gsbench/ has no port: the
    run fails and prints no result line (the look for a card skipped)."""
    import shutil

    shutil.copytree(ROOT / "gsbench", tmp_path / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys, time; sys.path[0] = %r\n"
            "from pathlib import Path\n"
            "from gsbench import harness\n"
            "r = harness.run_cell(harness.manifest(Path(%r)), 'synth100k.render', 1, 0.2, False,"
            " 'cpu', time.time())\n"
            "print(r)\n") % (str(tmp_path), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "gaussiansplatting_tpu_torch" in out.stderr
