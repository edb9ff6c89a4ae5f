"""The cell of SH degree 3 (garden_mip360.refine) on the CPU at a small size:
a sound run is correct, and ``correct`` comes out false under each planted
fault: the SH bands above 1 left out of the program's colour, half of the
batch left out, and the control (the reference at TF32 in the program's
place) fails the limits.  A system that evaluates degree 1 where degree 3
is asked for stops at the set-up, before any state is built."""

import time

import pytest
import torch

from gsbench import harness

BENCH = harness.manifest(harness.HERE.parent)
CELL = "garden_mip360.refine"
SMALL = {"config": {"scene": {"views": 16, "width": 80, "height": 56, "gaussians": 2000},
                    "config": {"raster": {"pair_capacity": 1 << 16, "pair_block": 16},
                               "init": {"knn_sample_threshold": 500}}},
         "traffic": {"steps_per_call": 2, "restore_every_steps": 4}}


def _run(seed=21):
    torch.set_num_threads(4)
    return harness.run_cell(BENCH, CELL, seed, 0.3, False, "cpu", time.time(), SMALL)


def _bands_left_out(monkeypatch):
    """The frame's SH colour at degree 1 whatever the degree asked."""
    from gaussiansplatting_tpu_torch.ops import projection

    real = projection.sh_color

    def sh_color(params, camera, cfg):
        return real(params, camera, cfg.replace(sh_degree=min(cfg.sh_degree, 1)))
    monkeypatch.setattr(projection, "sh_color", sh_color)


def _half_batch(monkeypatch):
    from gaussiansplatting_tpu_torch.ops import losses
    from gaussiansplatting_tpu_torch.train import trainer

    def loss(img, gt, cfg):
        h = img.shape[0] // 2
        rep = losses.photometric_loss(img[:h], gt[:h], cfg)
        return rep._replace(grad_loss=2.0 * rep.grad_loss)
    monkeypatch.setattr(trainer, "photometric_loss", loss)


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0, result
    assert {"train_step_ms", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("fault", ["bands_left_out", "half_batch"])
def test_fault_is_not_correct(fault, monkeypatch):
    {"bands_left_out": _bands_left_out, "half_batch": _half_batch}[fault](monkeypatch)
    assert not _run()["correct"]


def test_control_and_faults_fail_the_limits():
    torch.set_num_threads(4)
    spec = harness.cell_spec(BENCH, CELL)
    cfg = harness.merged(harness.load_json("configs", spec["config"]), SMALL["config"])
    traffic = harness.merged(harness.load_json("traffic", spec["traffic"]), SMALL["traffic"])
    limits = harness.load_json("limits", CELL)
    drv = harness.driver_class(traffic)(cfg, traffic, 31, torch.device("cpu"))
    drv.setup()
    drv.window(0.2, time.perf_counter)
    drv.release()
    program = drv.check()
    assert all(v <= limits[k] for k, v in program.items()), program
    for readings in (drv.control(), drv.fault_half_batch(), drv.fault_bands()):
        assert any(v > limits[k] for k, v in readings.items()), readings


def test_a_system_at_degree_1_stops_at_the_set_up(monkeypatch):
    """sh_eval taking any degree above 1 as 1 (the port before degree 3):
    the set-up raises before the dataset or the state is made."""
    from gaussiansplatting_tpu_torch.core import transforms
    from gsbench.scene import garden

    real = transforms.sh_eval

    def sh_eval(sh, dirs, degree):
        return real(sh, dirs, min(degree, 1))
    monkeypatch.setattr(transforms, "sh_eval", sh_eval)

    def no_data(*a, **k):
        raise AssertionError("the set-up made data before it checked the degree")
    monkeypatch.setattr(garden, "ring_poses", no_data)
    t0 = time.time()
    with pytest.raises(RuntimeError, match="does not evaluate this degree"):
        _run()
    assert time.time() - t0 < 30
