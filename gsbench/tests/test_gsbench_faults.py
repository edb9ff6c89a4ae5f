"""``correct`` against planted faults and the control.

A run of each cell, on the CPU at a small size with the look for a card
skipped, with the timed path broken underneath, must come out not correct:
a step that returns its state unchanged (from the start, or only late in
the training loop's pass), half of the batch left out (the mean taken over
the rest), an answer altered where it is produced (in every frame, or in
one pose's).  No cell
runs on several chips, so no exchange between chips can be left out.  The
control (the reference at the precision below the configuration's, in the
program's place) must fail the cell's limits too."""

import time

import pytest
import torch

from gsbench import harness
from gsbench.tests import small

BENCH = harness.manifest(harness.HERE.parent)


def _run(cell, overrides, seconds=0.3, seed=21):
    torch.set_num_threads(4)
    return harness.run_cell(BENCH, cell, seed, seconds, False, "cpu", time.time(), overrides)


def _unchanged(monkeypatch):
    from gaussiansplatting_tpu_torch.train import trainer

    real = trainer.train_steps

    def steps(state, cams, gts, cfg, total):
        _, m = real(state, cams, gts, cfg, total)
        return state, m
    monkeypatch.setattr(trainer, "train_steps", steps)


def _loss(monkeypatch, half: bool):
    from gaussiansplatting_tpu_torch.ops import losses
    from gaussiansplatting_tpu_torch.train import trainer

    def loss(img, gt, cfg):
        if half:
            h = img.shape[0] // 2
            rep = losses.photometric_loss(img[:h], gt[:h], cfg)
            return rep._replace(grad_loss=2.0 * rep.grad_loss)
        rep = losses.photometric_loss(img, gt, cfg)
        return rep._replace(combined_mean=rep.combined_mean * 1.01)
    monkeypatch.setattr(trainer, "photometric_loss", loss)


def _frame(monkeypatch, half: bool):
    from gaussiansplatting_tpu_torch.train import graph

    real = graph.render_frame

    def frame(params, camera, rc):
        img, aux = real(params, camera, rc)
        img = img.clone()
        if half:
            img[img.shape[0] // 2:] = 1.0
        else:
            img += 0.02
        return img, aux
    monkeypatch.setattr(graph, "render_frame", frame)


TRAIN_FAULTS = {"state_unchanged": _unchanged,
                "half_batch": lambda mp: _loss(mp, True),
                "answer_altered": lambda mp: _loss(mp, False)}
FRAME_FAULTS = {"half_batch": lambda mp: _frame(mp, True),
                "answer_altered": lambda mp: _frame(mp, False)}


def test_synth_train_sound_run_is_correct():
    assert _run("synth100k.train", small.SYNTH)["correct"]


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_synth_train_fault_is_not_correct(fault, monkeypatch):
    TRAIN_FAULTS[fault](monkeypatch)
    assert not _run("synth100k.train", small.SYNTH)["correct"]


@pytest.mark.parametrize("cell,overrides", [("synth100k.render", small.SYNTH),
                                            ("garden_c4.render", small.GARDEN_RENDER)])
@pytest.mark.parametrize("fault", sorted(FRAME_FAULTS))
def test_render_fault_is_not_correct(fault, cell, overrides, monkeypatch):
    FRAME_FAULTS[fault](monkeypatch)
    assert not _run(cell, overrides)["correct"]


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_garden_train_fault_is_not_correct(fault, monkeypatch):
    TRAIN_FAULTS[fault](monkeypatch)
    assert not _run("garden_c4.train", small.GARDEN)["correct"]


def test_garden_densify_left_out_is_not_correct(monkeypatch):
    from gaussiansplatting_tpu_torch.train import trainer

    real = trainer.densify_step

    def densify(state, extent, focal, cfg):
        _, stats = real(state, extent, focal, cfg)
        return state, stats
    monkeypatch.setattr(trainer, "densify_step", densify)
    assert not _run("garden_c4.train", small.GARDEN)["correct"]


def test_garden_late_state_unchanged_is_not_correct(monkeypatch):
    """A step that returns its state unchanged only late in the pass (past
    the traffic's check_late), where the first steps and the events read
    sound: the check of the loop's last steps has to see it."""
    from gaussiansplatting_tpu_torch.train import trainer

    late = small.GARDEN["traffic"]["check_late"]
    for name in ("train_step", "train_steps"):
        real = getattr(trainer, name)

        def step(state, *args, _real=real, **kwargs):
            out, m = _real(state, *args, **kwargs)
            return (state if int(state.opt.t) >= late else out), m
        monkeypatch.setattr(trainer, name, step)
    result = _run("garden_c4.train", small.GARDEN)
    assert not result["correct"]
    assert all(v["value"] <= v["limit"] for k, v in result["checks"].items()
               if not k.startswith("late_")), result["checks"]


@pytest.mark.parametrize("cell,overrides,seconds", [("synth100k.render", small.SYNTH, 3.0),
                                                    ("garden_c4.render", small.GARDEN_RENDER, 15.0)])
def test_render_one_pose_altered_is_not_correct(cell, overrides, seconds, monkeypatch):
    """Frames of one pose of the path altered, with no sample drawn: the
    last frame served for every pose has to show it."""
    from gaussiansplatting_tpu_torch.train import graph

    real, seen = graph.render_frame, []

    def frame(params, camera, rc):
        img, aux = real(params, camera, rc)
        if id(camera) not in seen:
            seen.append(id(camera))
        if seen.index(id(camera)) == 2:
            img = img * 0.9
        return img, aux
    monkeypatch.setattr(graph, "render_frame", frame)
    result = _run(cell, harness.merged(overrides, {"traffic": {"sample_frames": 0}}), seconds)
    assert result["attempted"] >= 4 and not result["correct"]


def _driver(cell, overrides, seed=31):
    spec = harness.cell_spec(BENCH, cell)
    cfg = harness.merged(harness.load_json("configs", spec["config"]), overrides["config"])
    traffic = harness.merged(harness.load_json("traffic", spec["traffic"]), overrides["traffic"])
    drv = harness.driver_class(traffic)(cfg, traffic, seed, torch.device("cpu"))
    drv.setup()
    drv.window(0.2, time.perf_counter)
    drv.release()
    return drv, harness.load_json("limits", cell)


@pytest.mark.parametrize("cell,overrides", [("synth100k.train", small.SYNTH),
                                            ("synth100k.render", small.SYNTH_CONTROL),
                                            ("garden_c4.train", small.GARDEN)])
def test_control_fails_the_limits(cell, overrides):
    torch.set_num_threads(4)
    drv, limits = _driver(cell, overrides)
    program = drv.check()
    assert all(v <= limits[k] for k, v in program.items()), program
    control = drv.control()
    assert any(v > limits[k] for k, v in control.items()), control
