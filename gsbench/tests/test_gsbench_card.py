"""On the card: one short run of each cell through gsbench/run.py prints a
result line that is correct and names the card.  Run on the machine with the
GPU: python -m pytest gsbench/tests -q -m cuda"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, cuda_device):
    out = subprocess.run([sys.executable, "gsbench/run.py", "--workload", cell, "--seed",
                          "2147483713", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert list(result)[-1] == "checks"
