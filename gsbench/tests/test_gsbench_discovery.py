"""A configuration, a traffic mix, a limit file and a per-layer metric added
as new files in a copy of the benchmark are found by their names in
BENCHMARK.json, with no file of the benchmark edited."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "gsbench", tmp_path / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    g = tmp_path / "gsbench"
    cfg = json.loads((g / "configs" / "synth100k.json").read_text())
    cfg["scene"].update(gaussians=300, spread=0.5, width=48, height=32)
    cfg["config"]["raster"].update(pair_capacity=1 << 14, pair_block=16)
    (g / "configs" / "tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((g / "traffic" / "render.json").read_text())
    traffic["orbit"].update(azimuths=3, elevations=1)
    (g / "traffic" / "orbit3.json").write_text(json.dumps(traffic))
    (g / "limits" / "tiny.orbit3.json").write_text(json.dumps({"frame_off_share": 8e-3}))
    (g / "metrics" / "frames_seen.orbit3.py").write_text(
        "def read(rec):\n    return float(rec['work']['requests']) or None\n")
    bench["configs"].append(dict(bench["configs"][0], name="tiny", file="gsbench/configs/tiny.json"))
    bench["workloads"].append({"name": "tiny.orbit3", "config": "tiny", "traffic": "orbit3",
                               "chips": 1, "why": "a cell added as files"})
    bench["per_layer"].append({"name": "frames_seen.orbit3", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "frames_per_s", "workloads": ["tiny.orbit3"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "synth100k.render" in m["workloads"]:
            m["workloads"].append("tiny.orbit3")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, time, json; sys.path[:0] = [%r, %r]\n"
            "import torch; torch.set_num_threads(2)\n"
            "from pathlib import Path\n"
            "from gsbench import harness\n"
            "assert harness.HERE == Path(%r)\n"
            "b = harness.manifest(Path(%r))\n"
            "r = harness.run_cell(b, 'tiny.orbit3', 3, 0.3, True, 'cpu', time.time())\n"
            "print(json.dumps(r))\n") % (str(tmp_path), str(ROOT), str(g), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["metrics"]["frames_seen.orbit3"]["value"] == result["attempted"] > 0
    assert "frame_off_share" in result["checks"]
