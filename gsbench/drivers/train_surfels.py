"""The ``train_surfels`` driver: the second half of a published 2D Gaussian
Splatting run (Huang et al. 2024), optimizer steps of surfels with the
depth-distortion and normal-consistency terms over a posed dataset's
training views at SH degree 3.

It is ``train_views`` (drivers/train_views.py, whose machinery it imports
and does not change) on surfels: the set-up also makes sure the system
renders the configuration's primitive (its ``raster.primitive`` parses as
"surfel"); a system that cannot stops there, within seconds.  The state is
train_views' with two log-scales a row: the median 3-NN scale raised to
the clamp, each axis then raised by U(0, ANISOTROPY), and uniform
orientations, both drawn from the seed.  The
window drives ``trainer.train_steps`` as train_views does; a step also
fails if the system's counters show no
surfel frame (``primitive.surfel``) or no launch of the surfel kernels
(``surfel_project_{fwd,bwd}``, ``surfel_blend_{fwd,bwd}``) in it.

The check compares the first three steps with the float64 reference of
reference/surfel.py from the same state on the same three views.  Besides
the control, three planted faults are read in the program's place: half
the batch left out, both regularizers left out, and the low-pass filter of
eq. 11 left out (3DGS's degenerate behaviour for a surfel seen edge-on).
``work`` counts the surfel blend's and projection's floors
(gsbench/work/surfel.py) from the reference's counts of the first checked
view, per step.
"""

from __future__ import annotations

import torch

from gsbench import devtrace
from gsbench.drivers import port, train_views
from gsbench.drivers.train import half_batch_loss
from gsbench.reference import compare, raster
from gsbench.reference import surfel as rsurf
from gsbench.reference import train as rtrain

ANISOTROPY = 0.25
SURFEL_COUNTERS = ("surfel_project_fwd", "surfel_project_bwd", "surfel_blend_fwd",
                   "surfel_blend_bwd")


def check_primitive(cfg: dict) -> None:
    """Raise unless the system takes the configuration as one of surfels."""
    pcfg = port.config(cfg["config"])
    if getattr(pcfg.raster, "primitive", None) != "surfel":
        raise RuntimeError("gsbench: the system does not render the configuration's "
                           "primitive 'surfel'")


class Driver(train_views.Driver):
    def _dataset(self) -> None:
        super()._dataset()
        # two log-scales a row: train_views' (the median 3-NN scale raised to
        # the clamp), each raised by U(0, ANISOTROPY), so no disc is exactly
        # round (a round disc's rotation about its normal is a symmetry: its
        # zero gradient, rounded, takes Adam's full step); the orientations
        # uniform, so every view holds discs seen near edge-on (where the
        # low-pass of eq. 11 acts), as a trained state's discs follow its
        # surfaces; both drawn from the seed
        ls = self.arrays["log_scales"][:, :2]
        g = torch.Generator(device=self.device).manual_seed((self.seed + 2) % (1 << 63))
        self.arrays["log_scales"] = ls + ANISOTROPY * torch.rand(ls.shape, generator=g,
                                                                device=self.device)
        q = torch.randn(self.arrays["quats"].shape, generator=g, device=self.device)
        self.arrays["quats"] = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)

    def setup(self) -> None:
        check_primitive(self.cfg)
        super().setup()

    def window(self, seconds: float, clock, spans=None) -> dict:
        """train_views' window, with the surfel counters read over it."""
        from gaussiansplatting_tpu_torch.train import graph

        spans = spans or devtrace.Spans(False)
        keys = (f"sh.degree_{self.pcfg.raster.sh_degree}", "primitive.surfel") + SURFEL_COUNTERS
        losses, overflows = [], []
        calls, state = 0, self.start
        before = {k: graph.launch_counts().get(k, 0) for k in keys}
        t0 = clock()
        while clock() - t0 < seconds:
            if calls % self.restore_calls == 0:
                state = self.start
            with spans("gsbench.call"):
                state, m = self._call(state)
            losses.append(m.loss)
            overflows.append(m.overflow)
            calls += 1
        with spans("gsbench.sync"):
            port.sync(self.device)
        t1 = clock()
        loss, ovf = torch.cat(losses), torch.cat(overflows)
        self.requests = calls * self.k
        seen = {k: graph.launch_counts().get(k, 0) - before[k] for k in keys}
        self.counters.update(steps=self.requests, **{f"steps_with_{k}": v for k, v in seen.items()})
        short = max(self.requests - min(seen.values()), 0)
        failed = int((~torch.isfinite(loss) | ovf.bool()).sum()) + short
        return {"attempted": self.requests, "failed": min(failed, self.requests),
                "window_s": t1 - t0,
                "end_to_end": {"train_step_ms": 1e3 * (t1 - t0) / self.requests}}

    def _reference(self, prec, loss_fn=None, degree=None, lowpass=True,
                   regularizers=True) -> dict:
        degree = self.pcfg.raster.sh_degree if degree is None else degree
        st = rtrain.init_state(self.arrays, prec)._replace(t=self.first)
        losses, grad = [], None
        for i, v in enumerate(self.checked_views):
            out = rsurf.step(st, self.poses[v], self.gts[v], self.cfg["config"], self.total,
                             degree, lowpass, regularizers, loss_fn)
            losses.append(out.loss)
            if i == 0:
                clip = rtrain.optim_constants(self.cfg["config"])["grad_clip"]
                grad = {f: out.grads[f].clamp(-clip, clip) for f in compare.LEAVES}
                self.counts = out.counts
            st = out.state
        return {"losses": losses, "grad": grad, "params": st.params}

    def fault_bands(self) -> dict:
        """train_views' fault of the SH bands above 1 left out."""
        return compare.train_readings(self._reference(torch.float64, degree=1), self.ref,
                                      self.arrays)

    def fault_half_batch(self) -> dict:
        """The readings of the reference with half of the batch left out."""
        return compare.train_readings(self._reference(torch.float64, half_batch_loss),
                                      self.ref, self.arrays)

    def fault_regularizers(self) -> dict:
        """The readings of the reference with both regularizers left out."""
        return compare.train_readings(self._reference(torch.float64, regularizers=False),
                                      self.ref, self.arrays)

    def fault_lowpass(self) -> dict:
        """The readings of the reference with eq. 11's low-pass left out."""
        return compare.train_readings(self._reference(torch.float64, lowpass=False),
                                      self.ref, self.arrays)

    def control(self) -> dict:
        """The readings of the reference at the precision below the
        configuration's in the program's place; after check()."""
        prec = raster.control_precision(self.cfg["config"])
        return compare.train_readings(self._reference(prec), self.ref, self.arrays)

    def work(self) -> dict:
        """The surfel blend's and projection's floors for the traced window:
        every step does the work of the first checked view."""
        from gsbench.work import surfel as wsurf

        n = self.requests
        c = self.counts
        return {"requests": n, "counts": c,
                "surfel_blend_floor_s": n * (wsurf.blend_fwd(c).seconds()
                                             + wsurf.blend_bwd(c).seconds()),
                "surfel_projection_floor_s": n * (wsurf.project_fwd(c).seconds()
                                                  + wsurf.project_bwd(c).seconds())}
