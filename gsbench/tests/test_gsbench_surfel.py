"""The surfel cell (``garden_2dgs.refine_surfel``) at a small size on the
CPU: a sound run is correct, and the cell comes out not correct under each
fault planted in the system underneath (a step that returns its state
unchanged, half of the batch left out, both regularizers left out, the
low-pass filter of eq. 11 left out) and with the control (the reference at
the precision below the configuration's) in the program's place."""

import time

import pytest
import torch

from gsbench import harness

BENCH = harness.manifest(harness.HERE.parent)
CELL = "garden_2dgs.refine_surfel"
SMALL = {"config": {"scene": {"views": 20, "width": 96, "height": 64, "gaussians": 3000},
                    "config": {"raster": {"pair_capacity": 1 << 17, "pair_block": 16},
                               "init": {"knn_sample_threshold": 500}}},
         "traffic": {"steps_per_call": 2, "restore_every_steps": 2}}


def _run(seed=21):
    torch.set_num_threads(4)
    return harness.run_cell(BENCH, CELL, seed, 0.3, False, "cpu", time.time(), SMALL)


def _unchanged(monkeypatch):
    from gaussiansplatting_tpu_torch.train import trainer

    real = trainer.train_steps

    def steps(state, cams, gts, cfg, total):
        _, m = real(state, cams, gts, cfg, total)
        return state, m
    monkeypatch.setattr(trainer, "train_steps", steps)


def _half_batch(monkeypatch):
    from gaussiansplatting_tpu_torch.ops import losses
    from gaussiansplatting_tpu_torch.train import trainer

    def loss(img, gt, cfg):
        h = img.shape[0] // 2
        rep = losses.photometric_loss(img[:h], gt[:h], cfg)
        return rep._replace(grad_loss=2.0 * rep.grad_loss)
    monkeypatch.setattr(trainer, "photometric_loss", loss)


def _no_regularizers(monkeypatch):
    from gaussiansplatting_tpu_torch.ops import losses
    from gaussiansplatting_tpu_torch.train import trainer

    def regs(frame, camera, cfg):
        zero = frame.image.sum() * 0.0
        return losses.Regularizers(zero, zero, zero, zero)
    monkeypatch.setattr(trainer, "surfel_regularizers", regs)


def _no_low_pass(monkeypatch):
    """The blend's terms with eq. 11's filter left out: rho = u^2 + v^2
    wherever the intersection exists."""
    from gaussiansplatting_tpu_torch.ops import surfel_blend

    def terms(tm, op, px, py, consts):
        _, power_floor, alpha_cap, alpha_floor = (float(x) for x in consts[:4])
        t00, t01, t02, t10, t11, t12, t20, t21, t22 = (x[:, None, :] for x in tm)
        hu0, hu1, hu2 = px * t20 - t00, px * t21 - t01, px * t22 - t02
        hv0, hv1, hv2 = py * t20 - t10, py * t21 - t11, py * t22 - t12
        c2 = hu0 * hv1 - hu1 * hv0
        zero = c2 == 0.0
        c2s = torch.where(zero, 1.0, c2)
        u = torch.clamp((hu1 * hv2 - hu2 * hv1) / c2s, -1e18, 1e18)
        v = torch.clamp((hu2 * hv0 - hu0 * hv2) / c2s, -1e18, 1e18)
        power = -0.5 * torch.where(zero, torch.inf, u * u + v * v)
        a_raw = op[:, None, :] * torch.exp(power)
        mask = (power >= power_floor) & (a_raw >= alpha_floor)
        alpha = torch.where(mask, a_raw + (torch.clamp(a_raw, max=alpha_cap) - a_raw).detach(),
                            0.0)
        return alpha, torch.where(mask, t20 * u + t21 * v + t22, 1.0)
    monkeypatch.setattr(surfel_blend, "lane_terms", terms)


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch,
          "regularizers_left_out": _no_regularizers, "low_pass_left_out": _no_low_pass}


def test_surfel_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_surfel_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = _run()
    assert not result["correct"], result["checks"]


def test_surfel_control_fails_the_limits():
    torch.set_num_threads(4)
    spec = harness.cell_spec(BENCH, CELL)
    cfg = harness.merged(harness.load_json("configs", spec["config"]), SMALL["config"])
    traffic = harness.merged(harness.load_json("traffic", spec["traffic"]), SMALL["traffic"])
    drv = harness.driver_class(traffic)(cfg, traffic, 31, torch.device("cpu"))
    drv.setup()
    drv.window(0.2, time.perf_counter)
    drv.release()
    limits = harness.load_json("limits", CELL)
    program = drv.check()
    assert all(v <= limits[k] for k, v in program.items()), program
    control = drv.control()
    assert any(v > limits[k] for k, v in control.items()), control
