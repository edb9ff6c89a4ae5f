"""The ``train`` driver on a posed dataset: the trainer users run.

The set-up makes the configuration's dataset from the seed (gsbench/scene/
garden.py: the views traced and rounded to 8 bits, the SfM-like cloud, every
``eval_split``-th view held out), the initial Gaussians from the cloud as the
port's initialisation defines them (one median 3-NN distance for every
scale, clamped to [1e-4, 0.1] x the scene's extent; identity rotations;
opacity 0.5; the DC colour), drives the first three steps through
``trainer.train_steps`` with the loop's starting configuration, and runs
one whole warm pass of ``trainer.train_loop`` (iterations [0, epochs x
views)) with the configuration's loop flags, which captures every graph the
pass uses once.  The window then runs passes of the same loop, each from the
initial state (``train_loop`` leaves its input as it was), and stops at the
first step past ``--seconds``; a traced window is one whole pass.

The check compares three stages of what the loop produces, each against
the reference (a pass of the window repeats the warm pass: the same start,
the same graphs, the same draws):

- the three first steps, from the seed's initial state;
- the loop's own densify events at ``check_events`` in the warm pass
  (``trainer.densify_step`` as the loop calls it, on the state it holds),
  against the reference's event on that state and the same draw (the
  state's CPU generator, as the program draws);
- the warm pass's last steps, from the state the loop holds at
  ``check_late`` (grown, at the pass's later pair capacity, in the scan
  chunks of ``scan_steps`` replays) to the state at the pass's end, with
  the losses the loop logged for them: the reference follows those steps
  from the program's state at ``check_late`` (parameters and Adam moments),
  which it could not reach on its own without running the events in between.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gsbench import devtrace
from gsbench.drivers import port
from gsbench.drivers.train import CHECKED_STEPS, half_batch_loss
from gsbench.reference import compare
from gsbench.reference import density as rdensity
from gsbench.reference import raster
from gsbench.reference import train as rtrain
from gsbench.scene import garden, synthetic


class _WindowClosed(Exception):
    pass


def _snapshot(st) -> dict:
    """A host copy of a training state's parameters, Adam moments and step."""
    fields = (*compare.LEAVES, "alive")
    return {"params": {f: getattr(st.params, f).detach().to("cpu", copy=True) for f in fields},
            "m": {f: st.opt.m[f].to("cpu", copy=True) for f in compare.LEAVES},
            "v": {f: st.opt.v[f].to("cpu", copy=True) for f in compare.LEAVES},
            "t": int(st.opt.t)}


def _moment_gradient(m_end: dict, m_start: dict, beta1: float, steps: int) -> dict:
    """The gradient as the optimizer received it over ``steps`` steps: the
    first moment's increment, (m_end - beta1^k m_start) / (1 - beta1^k), the
    mean of the clipped gradients weighted as Adam weighs them."""
    b = beta1 ** steps
    return {f: (m_end[f].double() - b * m_start[f].to(m_end[f].device).double()) / (1.0 - b)
            for f in compare.LEAVES}


class LoopDriver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.counters, self.spans = {}, {}

    def _dataset(self) -> None:
        sc = self.cfg["scene"]
        w, h = sc["width"], sc["height"]
        g = synthetic.generator(self.seed, self.device)
        poses = garden.ring_poses(sc["views"], np.random.default_rng(self.seed), w, h,
                                  sc.get("fov_deg", 60.0))
        tracer = garden.Tracer(w, h, poses[0]["fx"], poses[0]["fy"], self.device)
        # the dataset's PNGs hold 8 bits a channel
        gts = [torch.floor(torch.clamp(tracer(p), 0, 1) * 255.0 + 0.5) / 255.0 for p in poses]
        tracer.close()
        pts, cols = garden.surface_points(sc["points"], g, self.device)
        self.extent = garden.scene_extent(poses, self.cfg["config"]["init"]["extent_multiplier"])
        self.arrays = garden.initial_gaussians(pts, cols, self.extent, self.cfg["config"]["init"],
                                               self.cfg["config"]["density"]["max_gaussians"])
        split = sc["eval_split"]
        train = [i for i in range(len(poses)) if i % split]
        self.poses = [poses[i] for i in train]
        self.gts = [gts[i] for i in train]

    def setup(self) -> None:
        from gaussiansplatting_tpu_torch.train import graph, trainer
        from gaussiansplatting_tpu_torch.train import state as state_mod

        self._dataset()
        self.pcfg = port.config(self.cfg["config"])
        loop = self.cfg["loop"]
        self.loop = dict(adaptive_pairs=loop["adaptive_pairs"],
                         min_pair_capacity=loop["min_pair_capacity"],
                         adaptive_capacity=loop["adaptive_capacity"],
                         scan_steps=loop["scan_steps"])
        self.epochs = int(self.cfg["epochs"])
        self.total = self.epochs * len(self.poses)
        self.cams = [port.camera(p, self.device) for p in self.poses]
        self.state0 = state_mod.create(port.params(self.arrays), seed=self.seed % (1 << 63))

        # the first three steps, with the loop's first pair capacity
        start = self.pcfg.raster.pair_capacity
        if loop["adaptive_pairs"]:
            start = min(start, max(loop["min_pair_capacity"], 1))
        self.cfg0 = self.pcfg.replace(raster=self.pcfg.raster.replace(pair_capacity=start))
        s1, m1 = trainer.train_steps(self.state0, [self.cams[0]], [self.gts[0]], self.cfg0,
                                     self.total)
        s3, m3 = trainer.train_steps(s1, self.cams[1:CHECKED_STEPS], self.gts[1:CHECKED_STEPS],
                                     self.cfg0, self.total)
        beta1 = self.pcfg.optim.beta1
        self.checked = {"losses": torch.cat([m1.loss, m3.loss]),
                        "grad": {f: s1.opt.m[f] / (1.0 - beta1) for f in compare.LEAVES},
                        "params": {f: getattr(s3.params, f).detach() for f in compare.LEAVES}}
        print(f"gsbench: checked steps' pairs {torch.cat([m1.num_pairs, m3.num_pairs]).tolist()} "
              f"(capacity {start}), overflow {torch.cat([m1.overflow, m3.overflow]).tolist()}",
              file=sys.stderr)
        del s1, s3

        # the warm pass, keeping what the loop's own densify events took and
        # gave, its state at check_late and at the pass's end, and the losses
        # it logged in between
        events = {int(i) for i in self.traffic["check_events"]}
        late = int(self.traffic["check_late"])
        self.events, held, late_losses, late_pairs, at = [], {}, [], [], [0]
        real = trainer.densify_step

        def densify(state, extent, focal, cfg):
            it = at[0]
            if it not in events:
                return real(state, extent, focal, cfg)
            ev = {"iteration": it,
                  "params": {f: getattr(state.params, f).detach().clone()
                             for f in compare.LEAVES},
                  "alive": state.params.alive.clone(),
                  "grad_accum": state.accum.grad_accum.clone(),
                  "grad_count": state.accum.grad_count.clone(),
                  "generator": state.generator.get_state()}
            post, stats = real(state, extent, focal, cfg)
            alive = post.params.alive
            ev["out"] = {f: getattr(post.params, f).detach()[alive].clone()
                         for f in compare.LEAVES}
            ev["counts"] = {k: int(getattr(stats, k)) for k in ("pruned", "cloned", "split",
                                                                "count")}
            self.events.append(ev)
            return post, stats

        def keep(iteration, st):
            held["late"] = _snapshot(st)

        def on_step(iteration, m):
            at[0] = iteration
            if iteration > late:
                late_losses.append(m.loss)
                late_pairs.append(torch.stack([m.num_pairs, m.overflow.to(m.num_pairs.dtype)]))

        before = dict(graph.counts)
        trainer.densify_step = densify
        try:
            end = trainer.train_loop(self.state0, self.cams, self.gts, self.pcfg, self.extent,
                                     num_epochs=self.epochs, metrics_fn=on_step,
                                     checkpoint_fn=keep, checkpoint_interval=late, **self.loop)
        finally:
            trainer.densify_step = real
        port.sync(self.device)
        self.counters["warm_pass_captures"] = self._captures(before)
        if sorted(ev["iteration"] for ev in self.events) != sorted(events) or "late" not in held:
            raise RuntimeError(f"gsbench: the warm pass did not reach the checked events "
                               f"{sorted(events)} and iteration {late}")
        self.late = dict(held["late"], end=_snapshot(end),
                         losses=[float(x) for x in late_losses])
        alive = int(held["late"]["params"]["alive"].sum())
        print(f"gsbench: the last steps' (pairs, overflow) {torch.stack(late_pairs).tolist()}, "
              f"alive {alive}", file=sys.stderr)
        del end, held
        port.sync(self.device)

    @staticmethod
    def _captures(before: dict) -> int:
        from gaussiansplatting_tpu_torch.train import graph

        kinds = ("captures", "density_captures", "render_captures", "sharded_captures",
                 "trace_captures")
        return sum(graph.counts.get(k, 0) - before.get(k, 0) for k in kinds)

    def window(self, seconds: float, clock, spans=None) -> dict:
        """The measured window; ``spans`` (devtrace.Spans) records the
        host's spans in a traced run."""
        from gaussiansplatting_tpu_torch.train import graph, trainer

        spans = spans or devtrace.Spans(False)
        losses, overflows = [], []
        t0 = clock()

        def on_step(iteration, m):
            losses.append(m.loss)
            overflows.append(m.overflow)
            if not spans.enabled and clock() - t0 >= seconds:
                raise _WindowClosed

        originals = trainer.densify_step, trainer.opacity_reset_step
        event_ms = []
        if spans.enabled and self.cuda:
            def timed(fn):
                def call(*args, **kwargs):
                    torch.cuda.synchronize(self.device)
                    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    e0.record()
                    out = fn(*args, **kwargs)
                    e1.record()
                    e1.synchronize()
                    event_ms.append(e0.elapsed_time(e1))
                    return out
                return call
            trainer.densify_step, trainer.opacity_reset_step = (timed(f) for f in originals)
        before = dict(graph.counts)
        try:
            while True:
                with spans("gsbench.pass"):
                    trainer.train_loop(self.state0, self.cams, self.gts, self.pcfg, self.extent,
                                       num_epochs=self.epochs, metrics_fn=on_step, **self.loop)
                if spans.enabled:      # a traced window is one whole pass
                    break
        except _WindowClosed:
            pass
        finally:
            trainer.densify_step, trainer.opacity_reset_step = originals
        with spans("gsbench.sync"):
            port.sync(self.device)
        t1 = clock()
        steps = len(losses)
        self.counters.update(window_captures=self._captures(before), steps=steps,
                             passes=steps / self.total)
        self.spans["density_event_ms"] = event_ms
        loss, ovf = torch.stack(losses), torch.stack(overflows)
        failed = int((~torch.isfinite(loss) | ovf.bool()).sum())
        return {"attempted": steps, "failed": failed, "window_s": t1 - t0,
                "end_to_end": {"train_step_ms": 1e3 * (t1 - t0) / steps}}

    def release(self) -> None:
        from gaussiansplatting_tpu_torch.train import graph

        self.state0 = None
        graph.clear()

    def _reference(self, prec, loss_fn=None) -> dict:
        st = rtrain.init_state(self.arrays, prec)
        losses, grad = [], None
        for i in range(CHECKED_STEPS):
            out = rtrain.step(st, self.poses[i], self.gts[i], self.cfg["config"], self.total,
                              loss_fn)
            losses.append(out.loss)
            if i == 0:
                clip = rtrain.optim_constants(self.cfg["config"])["grad_clip"]
                grad = {f: out.grads[f].clamp(-clip, clip) for f in compare.LEAVES}
            st = out.state
        return {"losses": losses, "grad": grad, "params": st.params}

    def _late_reference(self, prec, loss_fn=None) -> dict:
        """The reference from the program's state at check_late through the
        pass's last steps, on the views the loop gave them."""
        s, dev, dtype = self.late, self.device, raster.real(prec)
        p = {f: s["params"][f].to(dev, dtype) for f in compare.LEAVES}
        p["alive"] = s["params"]["alive"].to(dev)
        st = rtrain.State(p, {f: s["m"][f].to(dev, dtype) for f in compare.LEAVES},
                          {f: s["v"][f].to(dev, dtype) for f in compare.LEAVES}, s["t"], prec)
        losses = []
        for it in range(s["t"], self.total):
            v = it % len(self.poses)
            out = rtrain.step(st, self.poses[v], self.gts[v], self.cfg["config"], self.total,
                              loss_fn)
            losses.append(out.loss)
            st = out.state
        grad = _moment_gradient(st.m, s["m"], rtrain.optim_constants(self.cfg["config"])["beta1"],
                                self.total - s["t"])
        return {"losses": losses, "grad": grad, "params": st.params}

    def _late_readings(self, ref: dict) -> dict:
        s = self.late
        prog = {"losses": s["losses"], "params": s["end"]["params"],
                "grad": _moment_gradient(s["end"]["m"], s["m"], self.pcfg.optim.beta1,
                                         self.total - s["t"])}
        out = compare.train_readings(prog, ref, s["params"])
        return {"late_" + k: v for k, v in out.items()}

    def _readings(self, prec, loss_fn=None) -> dict:
        out = compare.train_readings(self._reference(prec, loss_fn), self.ref, self.arrays)
        late = compare.train_readings(self._late_reference(prec, loss_fn), self.late_ref,
                                      self.late["params"])
        out.update({"late_" + k: v for k, v in late.items()})
        return out

    def check(self) -> dict:
        prog = dict(self.checked, losses=[float(x) for x in self.checked["losses"]])
        self.ref = self._reference(torch.float64)
        out = compare.train_readings(prog, self.ref, self.arrays)
        self.late_ref = self._late_reference(torch.float64)
        out.update(self._late_readings(self.late_ref))
        out.update(self._event_readings())
        return out

    def _event_readings(self) -> dict:
        """The worst of the checked events' readings."""
        out = {}
        for ev in self.events:
            p = dict(ev["params"], alive=ev["alive"])
            r = rdensity.split_draw(ev["generator"], ev["alive"].shape[0])
            ref = rdensity.densify(p, ev["grad_accum"], ev["grad_count"], ev["iteration"],
                                   self.extent, float(self.poses[0]["fx"]), r,
                                   rdensity.density_constants(self.cfg["config"]))
            for k, v in rdensity.readings(ev["out"], ev["counts"], ref).items():
                out[k] = max(out.get(k, 0.0), v)
        return out

    def control(self) -> dict:
        """The step readings of the reference at the precision below the
        configuration's in the program's place; after check()."""
        return self._readings(raster.control_precision(self.cfg["config"]))

    def fault_half_batch(self) -> dict:
        return self._readings(torch.float64, half_batch_loss)

    def work(self) -> dict:
        return {"requests": self.counters.get("steps", 0)}
