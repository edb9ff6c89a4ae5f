"""The port's density control against the JAX package on the CPU: the
density event (``apply``) on every case of tests/test_density.py with JAX's
own uniform draw injected as ``r``, ``grow``, ``opacity_reset_step``, the
schedule predicates, and the repair of the state's random generator (a CPU
generator, cloned by every function that draws).

Tolerances: every integer output (stats, alive, the compaction order) is
exact; floats within 1e-6 absolute (the split offsets are a rotation of the
draw times exp(scale), summed in another order; the rest is moved, not
computed)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussiansplatting_tpu.config import Config as JConfig
from gaussiansplatting_tpu.config import DensityConfig as JDensityConfig
from gaussiansplatting_tpu.core import gaussians as JG
from gaussiansplatting_tpu.density import control as jdensity
from gaussiansplatting_tpu.train import optimizer as jopt
from gaussiansplatting_tpu.train import state as jstate
from gaussiansplatting_tpu.train import trainer as jtrainer

from gaussiansplatting_tpu_torch.config import Config, DensityConfig
from gaussiansplatting_tpu_torch.core import gaussians as TG
from gaussiansplatting_tpu_torch.density import control as tdensity
from gaussiansplatting_tpu_torch.train import optimizer as topt
from gaussiansplatting_tpu_torch.train import state as tstate
from gaussiansplatting_tpu_torch.train import trainer as ttrainer

from torch_parity import t2n

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
EXTENT = 10.0
FLOAT_ATOL = 1e-6
TRAINABLE = topt.TRAINABLE


def _case(name):
    """(host params, host m for 'means', accum (grad_accum, grad_count),
    iteration, DensityConfig kwargs) of one tests/test_density.py case, at
    its seed (rng 1234) and sizes; the hard-cap case at 1/16 of its
    1.6M-slot scale with the cap scaled alike."""
    rng = np.random.default_rng(1234)
    n, cap, log_scale, raw_op, it, cfg = 8, 32, -3.0, 2.0, 1000, {}
    if name in ("clone", "outside_400", "outside_15000", "clamp"):
        log_scale = -4.0
    if name == "split":
        log_scale = 0.0
    if name in ("world_2999", "world_3001"):
        log_scale = 0.5
        it = int(name[-4:])
    if name.startswith("outside"):
        it = int(name.split("_")[1])
    if name == "clamp":
        cap = 10
    if name == "hard_cap":
        return _hard_cap_case(rng)
    p = {
        "means": rng.normal(size=(n, 3)).astype(np.float32),
        "log_scales": np.full((n, 3), log_scale, np.float32),
        "quats": np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        "raw_opacities": np.full((n,), raw_op, np.float32),
        "sh": rng.normal(size=(n, 4, 3)).astype(np.float32),
    }
    p = _pad(p, n, cap)
    ga = np.zeros(cap, np.float32)
    gc = np.zeros(cap, np.int32)
    m_means = np.zeros((cap, 3), np.float32)
    if name == "prune":
        p["raw_opacities"][[2, 5]] = -6.0
    if name in ("clone", "split"):
        g = 3 if name == "clone" else 1
        ga[g], gc[g] = 1.0, 1
        m_means[g] = 7.0
    if name.startswith("outside"):
        ga[:] += 1.0
        gc[:] += 1
    if name == "clamp":
        ga[:8], gc[:8] = 1.0, 1
    return p, m_means, (ga, gc), it, cfg


def _hard_cap_case(rng, scale=16):
    """tests/test_density.py::test_densify_at_real_scale_hits_hard_cap with
    every count divided by ``scale``: pruned, split and clone bands, and a
    hard cap (max_gaussians) below the capacity that drops clone requests."""
    C, n = 1_600_000 // scale, 1_400_000 // scale
    s0, c1 = 100_000 // scale, 450_000 // scale
    p = {
        "means": rng.normal(size=(n, 3)).astype(np.float32),
        "log_scales": np.full((n, 3), -4.0, np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "raw_opacities": np.full((n,), 2.0, np.float32),
        "sh": np.zeros((n, 4, 3), np.float32),
    }
    p["log_scales"][s0:150_000 // scale] = np.log(0.5)
    p["raw_opacities"][:s0] = -6.0
    p = _pad(p, n, C)
    ga = np.zeros(C, np.float32)
    gc = np.zeros(C, np.int32)
    ga[s0:c1], gc[s0:c1] = 1.0, 1
    m_means = np.zeros((C, 3), np.float32)
    m_means[c1 - 1_000 // scale] = 7.0
    return p, m_means, (ga, gc), 5000, {"max_gaussians": 1_500_000 // scale}


def _pad(p, n, cap):
    out = {}
    for f, v in p.items():
        buf = np.zeros((cap,) + v.shape[1:], np.float32)
        buf[:n] = v
        out[f] = buf
    out["quats"][n:, 0] = 1.0
    out["alive"] = np.arange(cap) < n
    return out


CASES = ["noop", "prune", "clone", "split", "outside_400", "outside_15000",
         "world_2999", "world_3001", "clamp", "hard_cap"]


@pytest.mark.parametrize("name", CASES)
def test_apply_matches_jax(name):
    p, m_means, (ga, gc), it, cfg_kw = _case(name)
    C = p["means"].shape[0]
    jcfg, tcfg = JDensityConfig(**cfg_kw), DensityConfig(**cfg_kw)

    jp = JG.GaussianParams(**{f: jnp.asarray(v) for f, v in p.items()})
    jo = jopt.init_state(jp)
    jo = jo.replace(m={**jo.m, "means": jnp.asarray(m_means)})
    ja = jdensity.init_accum(C).replace(grad_accum=jnp.asarray(ga), grad_count=jnp.asarray(gc))
    want = jdensity.apply(jp, jo, ja, jnp.int32(it), KEY, EXTENT, jnp.float32(100.0),
                          jnp.float32(2.0 * EXTENT), jcfg)

    tp = TG.params_from_numpy(p)
    to = topt.init_state(tp)
    to.m["means"] = torch.from_numpy(m_means)
    ta = tdensity.DensityAccum(torch.from_numpy(ga), torch.from_numpy(gc),
                               torch.zeros((C, 3)))
    r = torch.from_numpy(np.array(jax.random.uniform(KEY, (C, 3), jnp.float32, -1.0, 1.0)))
    got = tdensity.apply(tp, to, ta, it, r, EXTENT, torch.tensor(100.0, dtype=torch.float32),
                         2.0 * EXTENT, tcfg)

    (jp2, jo2, ja2, js), (tp2, to2, ta2, ts) = want, got
    for f in ("pruned", "cloned", "split", "count"):
        assert int(getattr(ts, f)) == int(getattr(js, f)), f
    alive = t2n(tp2.alive)
    np.testing.assert_array_equal(alive, np.asarray(jp2.alive))
    n = int(ts.count)
    assert alive[:n].all() and not alive[n:].any()
    for f in TRAINABLE:
        np.testing.assert_allclose(t2n(getattr(tp2, f)), np.asarray(getattr(jp2, f)),
                                   rtol=0, atol=FLOAT_ATOL, err_msg=f)
        for mom in ("m", "v"):
            np.testing.assert_allclose(t2n(getattr(to2, mom)[f]),
                                       np.asarray(getattr(jo2, mom)[f]),
                                       rtol=0, atol=FLOAT_ATOL, err_msg=f"{mom} {f}")
    # the compaction moves values: means outside split children are exact
    split_rows = np.zeros(C, bool)
    plan = tdensity.decide(tp, ta, it, EXTENT, torch.tensor(100.0), 2.0 * EXTENT, tcfg)
    for d in (plan.primary_dst, plan.secondary_dst):
        d = t2n(d)[t2n(plan.split)]
        split_rows[d[d < C]] = True
    np.testing.assert_array_equal(t2n(tp2.means)[~split_rows],
                                  np.asarray(jp2.means)[~split_rows])
    for f in ("grad_accum", "grad_count", "pos_grad_accum"):
        assert not t2n(getattr(ta2, f)).any()
    assert to2.t == int(jo2.t)
    if name == "hard_cap":
        assert int(ts.cloned) == 150_000 // 16 and int(ts.count) == 1_500_000 // 16
    if name in ("clone", "split", "clamp"):
        assert int(ts.cloned) + int(ts.split) > 0


def _state_pair(seed=3, n=20, cap=32):
    rng = np.random.default_rng(seed)
    p = _pad({
        "means": rng.normal(size=(n, 3)).astype(np.float32),
        "log_scales": rng.uniform(-4, 1, (n, 3)).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "raw_opacities": rng.uniform(-3, 3, (n,)).astype(np.float32),
        "sh": rng.normal(size=(n, 4, 3)).astype(np.float32),
    }, n, cap)
    js = jstate.create(JG.GaussianParams(**{f: jnp.asarray(v) for f, v in p.items()}))
    mv = {f: rng.normal(size=p[f].shape).astype(np.float32) for f in TRAINABLE}
    js = js.replace(
        opt=js.opt.replace(m={f: jnp.asarray(v) for f, v in mv.items()},
                           v={f: jnp.asarray(np.abs(v)) for f, v in mv.items()},
                           t=jnp.int32(7)),
        accum=js.accum.replace(grad_accum=jnp.asarray(rng.uniform(0, 1, cap).astype(np.float32)),
                               grad_count=jnp.asarray(rng.integers(0, 4, cap).astype(np.int32))),
    )
    arrays = {k: np.asarray(v) for k, v in _flat(js).items()}
    return js, tstate.state_from_numpy(arrays)


def _flat(js):
    from gaussiansplatting_tpu.train.checkpoint import _leaf_key

    return {_leaf_key(p): v for p, v in jax.tree_util.tree_flatten_with_path(js)[0]}


def _assert_states_equal(got, want):
    want = {k: np.asarray(v) for k, v in _flat(want).items() if k != "key"}
    got = tstate.state_to_numpy(got)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("new_capacity", [32, 20, 48])
def test_grow_matches_jax(new_capacity):
    js, ts = _state_pair()
    _assert_states_equal(tstate.grow(ts, new_capacity), jstate.grow(js, new_capacity))


def test_opacity_reset_step_matches_jax():
    js, ts = _state_pair(seed=4)
    cfg_j, cfg_t = JConfig(), Config()
    got = ttrainer.opacity_reset_step(ts, cfg_t)
    _assert_states_equal(got, jtrainer.opacity_reset_step(js, cfg_j))
    assert got.generator is ts.generator


def test_schedule_predicates_match_jax():
    cfgs = [(JConfig(), Config())]
    small = dict(densify_from_iter=2, densify_until_iter=100, densify_interval=5,
                 opacity_reset_interval=12)
    cfgs.append((JConfig(density=JDensityConfig(**small)), Config(density=DensityConfig(**small))))
    iters = list(range(0, 130)) + [499, 500, 600, 2999, 3000, 3001, 6000, 14_900,
                                   15_000, 15_100, 29_999, 30_000]
    for jc, tc in cfgs:
        for it in iters:
            assert ttrainer.should_densify(it, tc) == jtrainer.should_densify(it, jc), it
            assert ttrainer.should_reset_opacity(it, tc) == jtrainer.should_reset_opacity(it, jc), it
            for ap, ai, ck, sn in ((False, 50, 0, 0), (True, 7, 16, 0), (True, 50, 0, 25)):
                assert (ttrainer._steps_until_event(it, tc, ap, ai, ck, sn)
                        == jtrainer._steps_until_event(it, jc, ap, ai, ck, sn)), it


def test_generator_is_cpu_and_never_shared():
    """The fault: one generator object handed on from state to state means
    a draw in one state advances every other.  The repair: densify_step
    draws on a clone and returns it, so the input state keeps its generator
    state and a replay from it gives the same bits."""
    _, ts = _state_pair(seed=5)
    assert ts.generator.device.type == "cpu"
    cfg = Config(density=DensityConfig(densify_from_iter=0, grad_threshold=1e-9))
    ts = tstate.TrainState(ts.params, ts.opt, ts.accum, tstate.make_generator(11))
    before = ts.generator.get_state().clone()

    # the fault a shared generator would have: two draws from one object
    shared = ts.generator
    a = tdensity.draw_split_offsets(shared, 8, "cpu")
    b = tdensity.draw_split_offsets(shared, 8, "cpu")
    assert not torch.equal(a, b)
    ts.generator.set_state(before)

    one, stats1 = ttrainer.densify_step(ts, 1.0, torch.tensor(50.0), cfg)
    two, stats2 = ttrainer.densify_step(ts, 1.0, torch.tensor(50.0), cfg)
    assert int(stats1.split) > 0 and tuple(map(int, stats1)) == tuple(map(int, stats2))
    assert torch.equal(ts.generator.get_state(), before)
    assert one.generator is not ts.generator and one.generator is not two.generator
    assert torch.equal(one.generator.get_state(), two.generator.get_state())
    assert not torch.equal(one.generator.get_state(), before)
    a, b = tstate.state_to_numpy(one), tstate.state_to_numpy(two)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the draw it made is the clone's next draw from the input's state
    clone = tstate.clone_generator(ts.generator)
    r = tdensity.draw_split_offsets(clone, ts.params.capacity, "cpu")
    assert torch.equal(clone.get_state(), one.generator.get_state())
    assert r.shape == (ts.params.capacity, 3) and float(r.abs().max()) <= 1.0
