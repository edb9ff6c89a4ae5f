"""The port's measuring tools on the CPU: utils.sol (the H100
speed-of-light model), tools.profile (stage times) and tools.trace
(profiler capture and aggregation).

* step_model's stages that both packages share (presort, projection,
  optimizer, and the image touches of compose and loss) equal the JAX
  step_model's bytes exactly; the port's own stages are positive and the
  floor is the larger of the two times.
* blend_work against a brute-force count, pixel by pixel and lane by lane,
  on a two-block window: lanes read, kept pairs, and per layout the (warp,
  lane) pairs, those the padded box culls and the power tests.
* stage_times on the CPU at a toy size returns every stage with a finite,
  positive ms; the trace CLI captures and aggregates a CPU profile into
  finite groups; the refused flags exit non-zero.
"""

import math

import numpy as np
import pytest
import torch

from gaussiansplatting_tpu.utils import sol as jsol

from gaussiansplatting_tpu_torch.config import RasterConfig
from gaussiansplatting_tpu_torch.ops import blend
from gaussiansplatting_tpu_torch.utils import sol

torch.set_num_threads(1)

SHARED = ("presort", "projection", "optimizer", "image_loss")


@pytest.mark.parametrize("n,cap,h,w,block", [(100_000, 1 << 21, 608, 800, 128),
                                             (1024, 1 << 15, 256, 256, 64),
                                             (48, 2048, 48, 64, 16)])
def test_step_model_shared_stages_equal_jax(n, cap, h, w, block):
    want = jsol.step_model(n, cap, h, w, block=block)["bytes_by_stage"]
    got = sol.step_model(n, cap, h, w, block=block)
    for stage in SHARED:
        assert got["bytes_by_stage"][stage] == want[stage], stage
    assert all(v > 0 for v in got["bytes_by_stage"].values())
    assert got["bytes_total"] == sum(got["bytes_by_stage"].values())
    assert set(got) == {"bytes_by_stage", "bytes_total", "instructions", "t_bytes_ms",
                        "t_flops_ms", "floor_ms"}
    assert got["floor_ms"] == max(got["t_bytes_ms"], got["t_flops_ms"]) > 0
    work = {"tests_fwd": 10**9, "tests_bwd": 10**9, "kept": 10**8}
    more = sol.step_model(n, cap, h, w, block=block, work=work)
    assert more["instructions"] == got["instructions"] + 11 * 2 * 10**9 + 39 * 10**8
    assert more["bytes_total"] == got["bytes_total"]


def _two_blocks(block=16):
    """A two-block window (edge_windows' full block and its unaligned one)
    with the blend's arguments."""
    from chip_smoke import edge_windows

    table, src, valid, tile = edge_windows(block, seed=5, row0=0, nb=4)
    rc = RasterConfig()
    consts = (16, rc.power_floor, rc.alpha_cap, rc.alpha_floor, 50)
    pick = slice(1, 3)
    return (torch.from_numpy(table), torch.from_numpy(src[pick].copy()),
            torch.from_numpy(valid[pick].copy()), torch.from_numpy(tile[pick].copy()),
            0, block, consts)


def _brute_force(args):
    """The same counts from scalar float32 arithmetic, pixel by pixel."""
    table, src, valid, tile, row0, block, (ts, pfloor, _, afloor, tiles_x) = args
    table, f = table.numpy(), np.float32
    out = {"live": 0, "kept": 0}
    layouts = {"fwd": blend._FWD_PIXELS[False], "bwd": blend._BWD_PIXELS}   # per thread
    for name in layouts:
        out.update({f"pairs_{name}": 0, f"culled_{name}": 0, f"tests_{name}": 0})
    for k in range(src.shape[0]):
        nv = int(valid[k])
        out["live"] += nv
        tcx = f((int(tile[k]) % tiles_x) * 16 + 8)
        tcy = f((int(tile[k]) // tiles_x + row0) * 16 + 8)
        for lane in range(nv):
            col = table[:10, int(src[k]) + lane]
            mx, my = f(col[1] - tcx), f(col[2] - tcy)
            a, b, c = f(col[3]), f(col[4]), f(col[5])
            op = col[6] if abs(a) + abs(b) + abs(c) >= 1e-4 else f(0.0)
            kept_px = []
            for y in range(16):
                for x in range(16):
                    dx, dy = f(x + 0.5 - 8.0) - mx, f(y + 0.5 - 8.0) - my
                    power = f(-0.5) * (a * dx * dx + c * dy * dy) - b * (dx * dy)
                    alpha = op * f(math.exp(power))
                    if power <= 0 and power >= pfloor and alpha >= afloor and alpha > 0:
                        kept_px.append((x, y))
            out["kept"] += len(kept_px)
            if op <= 0:
                continue
            ex, ey = (float(v) for v in sol.cull_extent(
                *(torch.tensor([v]) for v in (a, b, c, op)), pfloor, afloor))
            for name, pixels in layouts.items():
                rows = 2 * pixels
                for wy in range(0, 16, rows):
                    # the warp's pixel centres span [-7.5, 7.5] x [y0, y1]
                    y0, y1 = wy + 0.5 - 8.0, wy + rows - 0.5 - 8.0
                    meets = (-7.5 - ex <= mx <= 7.5 + ex) and (y0 - ey <= my <= y1 + ey)
                    out[f"pairs_{name}"] += 1
                    if meets:
                        out[f"tests_{name}"] += 16 * rows        # every pixel tests it
                    else:
                        out[f"culled_{name}"] += 1
                        assert not [p for p in kept_px if wy <= p[1] < wy + rows]
    return out


def test_blend_work_matches_brute_force():
    args = _two_blocks()
    w = sol.blend_work(args)
    ref = _brute_force(args)
    assert w["live_fwd"] == w["live_bwd"] == ref["live"] > 0
    assert w["kept"] == ref["kept"] > 0
    for name in ("fwd", "bwd"):
        for c in ("pairs", "culled", "tests"):
            assert w[f"{c}_{name}"] == ref[f"{c}_{name}"], f"{c}_{name}"
    assert 0 < w["culled_fwd"] < w["pairs_fwd"]
    res, line = sol.work_bound(w, "fwd", 1000, sol.FWD_OPS_PER_KEPT)
    ops = sol.OPS_PER_TEST * w["tests_fwd"] + sol.FWD_OPS_PER_KEPT * w["kept"]
    assert res["bound_ms"] == pytest.approx(1e3 * max(1000 / sol.HBM_BYTES_PER_S,
                                                      ops / sol.F32_INSTR_PER_S))
    assert res["bound_by"] == "operations" and "power tests" in line


def test_stage_times_on_the_cpu(capsys):
    import json

    from gaussiansplatting_tpu_torch.tools import profile

    seen = []
    res = profile.stage_times(n=40, width=32, height=32, pair_capacity=1024, pair_block=16,
                              names=profile.STAGES, emit=lambda s, ms: seen.append(s),
                              device="cpu")
    assert list(res) == seen == list(profile.STAGES)
    assert all(math.isfinite(v) and v > 0 for v in res.values())
    with pytest.raises(ValueError, match="unknown stages"):
        profile.stage_times(names=("nope",), device="cpu")
    # the CLI: one line per stage, then the summary naming the device
    assert profile.main(["--n", "40", "--width", "32", "--height", "32", "--pair-capacity",
                         "1024", "--pair-block", "16", "--stages", "project,train_step",
                         "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["stage"] for x in lines[:2]] == ["project", "train_step"]
    assert lines[-1]["device"] == "cpu" and set(lines[-1]["stages_ms"]) == {"project",
                                                                           "train_step"}


def test_trace_on_the_cpu(tmp_path, capsys):
    from gaussiansplatting_tpu_torch.tools import trace

    out = str(tmp_path / "tr")
    rc = trace.main(["--steps", "2", "--n", "40", "--width", "32", "--height", "32",
                     "--pair-capacity", "1024", "--top", "8", "--out", out, "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].endswith("TOTAL(device)") and "host clock" in lines[-1]
    rows = trace.aggregate(out, 2, top=8)
    assert len(rows) == 9 and rows[-1][0] == "TOTAL(device)"
    assert all(math.isfinite(ms) and ms >= 0 for _, ms in rows) and rows[-1][1] > 0
    assert trace.main(["--parse-only", "--out", out, "--steps", "2"]) == 0
    for flag in (["--payload-dtype", "bf16"], ["--pack-positions", "1"]):
        with pytest.raises(SystemExit, match="not ported"):
            trace.main(flag + ["--device", "cpu"])
    # the device profile and the step breakdown, profiling the CPU
    st, cam, gt, cfg = trace._setup(40, 32, 32, 1024, "cpu")
    logs = []
    ms = trace.step_breakdown({"iteration 0": st}, cam, gt, cfg, [512, 1024], 1024, 10, "cpu",
                              device="cpu", log=logs.append, reps=1, top=3)
    assert set(ms) == {"iteration 0"} and ms["iteration 0"] > 0
    assert sum("ms/step" in x for x in logs) == 2
    assert any("device time" in x for x in logs)


def test_group_names():
    from gaussiansplatting_tpu_torch.tools.trace import _group_name, _self_times

    assert _group_name("void at::native::(anonymous namespace)::foo_kernel<float, 4>("
                       "float*)") == "at::native::foo_kernel"
    assert _group_name("aten::mul") == "aten::mul"
    ev = [{"name": "a", "ts": 0, "dur": 10, "tid": 1}, {"name": "b", "ts": 2, "dur": 3, "tid": 1},
          {"name": "c", "ts": 6, "dur": 2, "tid": 1}, {"name": "d", "ts": 0, "dur": 4, "tid": 2}]
    assert sorted(_self_times(ev)) == [("a", 5), ("b", 3), ("c", 2), ("d", 4)]
