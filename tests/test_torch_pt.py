"""Parallel tempering and mobility tuning in the port against tpu_smc: the
exchange step bitwise under the same uniforms, the interval rule, a PT run
split into more calls, and the tuning searches under one synthetic
acceptance model driven through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_smc.pt as jpt
import tpu_smc.state as jstate
import tpu_smc.tsweep as jts
import tpu_smc.tuning as jtune
from tpu_smc.config import RunParams
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc_torch import driver as tdrv
from tpu_smc_torch import ensemble as ten
from tpu_smc_torch import pt as tpt
from tpu_smc_torch import tsweep as tts
from tpu_smc_torch import tuning as ttune
from tpu_smc_torch.config import SMCConfig as TConfig
from tpu_smc_torch.state import (ChainState, fold_in, init_ensemble_state,
                                 seed_words)

# tiny tensors: keep torch's intra-op pool from competing with the
# other test workers for cores
torch.set_num_threads(1)


_jax_exchange = jax.jit(jpt.exchange_step, static_argnums=(2,))


@pytest.mark.parametrize("n_t", [2, 3, 4, 5])
def test_exchange_step_bitwise_jax(n_t):
    """tpt.exchange_step fed jax.random.uniform(key, (n_t, R)) swaps r,
    energy and rbin and counts accepts / attempts exactly as
    tpu_smc.pt.exchange_step under that key, for both parities."""
    r_per, n = 6, 5
    c = n_t * r_per
    rng = np.random.default_rng(n_t)
    temps = np.sort(rng.uniform(0.8, 1.6, n_t))
    betas = 1.0 / temps
    r = rng.normal(size=(c, n, 3))
    # energies a few kT apart so both outcomes occur
    energy = rng.normal(0.0, 3.0, c)
    rbin = rng.integers(0, 50, (c, n))
    zi = np.zeros(c, np.int64)
    for parity in (0, 1):
        key = jax.random.key(10 * n_t + parity)
        js = jstate.ChainState(
            r=jnp.asarray(r), energy=jnp.asarray(energy),
            key=jax.vmap(lambda i: jax.random.fold_in(key, i))(
                jnp.arange(c)),
            sweeps=jnp.asarray(zi, jnp.int32),
            accepted=jnp.asarray(zi, jnp.int32),
            rbin=jnp.asarray(rbin, jnp.int32),
            density=jnp.zeros((c, 4), jnp.uint32),
            mobility=jnp.zeros((c, 4), jnp.uint32))
        jnew, jacc, jatt = _jax_exchange(js, jnp.asarray(betas), r_per,
                                          key, parity)
        u = np.asarray(jax.random.uniform(key, (n_t, r_per)))
        i64 = lambda v: torch.as_tensor(np.asarray(v, np.int64))
        ts = ChainState(r=torch.as_tensor(r), energy=torch.as_tensor(energy),
                        key=torch.zeros((c, 2), dtype=torch.int64),
                        sweeps=i64(zi), accepted=i64(zi), rbin=i64(rbin),
                        density=torch.zeros((c, 4), dtype=torch.int64),
                        mobility=torch.zeros((c, 4), dtype=torch.int64))
        tnew, tacc, tatt = tpt.exchange_step(
            ts, torch.as_tensor(betas), r_per, None, parity,
            uniforms=torch.as_tensor(u))
        np.testing.assert_array_equal(tnew.r.numpy(), np.asarray(jnew.r))
        np.testing.assert_array_equal(tnew.energy.numpy(),
                                      np.asarray(jnew.energy))
        np.testing.assert_array_equal(tnew.rbin.numpy(),
                                      np.asarray(jnew.rbin))
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        np.testing.assert_array_equal(tatt.numpy(), np.asarray(jatt))
        if n_t >= 3:
            assert 0 < int(tacc.sum()) < int(tatt.sum())


def test_exchange_uniforms_open_interval():
    u = tpt.exchange_uniforms(torch.tensor([5, 9]), 4, 64, "cpu",
                              torch.float32)
    assert u.shape == (4, 64) and bool(((u > 0) & (u < 1)).all())
    assert abs(float(u.mean()) - 0.5) < 0.06


def test_choose_exchange_interval_matches_jax():
    rng = np.random.default_rng(0)
    cases = [[], [0.58, 0.92], [0.01], [0.99, 0.98], [0.3, 0.6, 0.9]]
    cases += [list(rng.uniform(0, 1, k)) for k in (1, 3, 7)]
    for p in cases:
        for kw in ({}, {"target_rate": 0.1}, {"lo": 5, "hi": 20},
                   {"target_rate": 0.02, "lo": 2, "hi": 50}):
            assert tpt.choose_exchange_interval(p, **kw) == \
                jpt.choose_exchange_interval(p, **kw), (p, kw)


def _pt_inputs(cfg, n_t=2, cpt=2):
    temps = np.linspace(1.0, 1.4, n_t)
    state, w = init_ensemble_state(cfg, seed_words(4), n_t * cpt,
                                   device="cpu")
    temps_c = torch.as_tensor(np.repeat(temps, cpt))
    betas = torch.as_tensor(1.0 / temps, dtype=cfg.torch_dtype)
    ekey = fold_in(state.key[0], [0x9C0FFEE])[0]
    return state, w, temps_c, betas, ekey


def test_pt_cycles_split_invariance():
    """Exchange seed words and parity come from the ABSOLUTE cycle index
    (and the sweeps' streams from the absolute sweep counter): 6 cycles
    in one call equal 3 + 3 and 2 + 4, bitwise."""
    cfg = TConfig.for_n(16)
    state, w, temps_c, betas, ekey = _pt_inputs(cfg)

    def run(st, n, c0):
        return tpt.pt_cycles(st, w, cfg, temps_c, betas, 1.0, 2, 1, n, c0,
                             ekey, "dense")

    one, acc1, att1, _ = run(state, 6, 0)
    for k in (3, 2):
        st, a1, t1, _ = run(state, k, 0)
        st, a2, t2, _ = run(st, 6 - k, k)
        assert torch.equal(st.r, one.r) and torch.equal(st.energy, one.energy)
        np.testing.assert_array_equal(a1 + a2, acc1)
        np.testing.assert_array_equal(t1 + t2, att1)
    assert int(att1.sum()) == 3 * 2 and int(one.sweeps[0]) == 6


def test_pt_driver_harvest_grouping_invariance(monkeypatch):
    """simulate_parallel_tempering harvests every budget // interval
    cycles; changing that grouping changes no trajectory, swap count or
    pooled statistic."""
    cfg = TConfig.for_n(16)
    params = RunParams(eqsteps=2, maxsteps=8, numdata=2)
    outs = []
    for budget in (50, 4):
        monkeypatch.setattr(tdrv, "therm_chunk", lambda *a, b=budget, **k: b)
        outs.append(tpt.simulate_parallel_tempering(
            cfg, params, [1.0, 1.4], seed_words(2), chains_per_t=2,
            exchange_interval=2, sampler="dense", device="cpu"))
    (s1, p1), (s2, p2) = outs
    assert torch.equal(s1.r, s2.r) and torch.equal(s1.energy, s2.energy)
    np.testing.assert_array_equal(p1.swap_attempts, p2.swap_attempts)
    np.testing.assert_array_equal(p1.swap_acceptance, p2.swap_acceptance)
    np.testing.assert_array_equal(p1.tsweep.energy_samples,
                                  p2.tsweep.energy_samples)
    np.testing.assert_array_equal(p1.tsweep.acceptance, p2.tsweep.acceptance)
    assert p1.tsweep.energy_samples.shape == (2, 2, 2)
    assert p1.swap_attempts.tolist() == [2 * 2]       # 4 cycles, 2 even
    assert p1.tsweep.pressure_samples.shape[0] == 1   # one group
    assert p2.tsweep.pressure_samples.shape[0] == 2   # one per 2 cycles


def _acc_model(a, t, k, n):
    """Acceptance of a level at mobility a and temperature t, rounded to
    whole moves of k sweeps x n particles: decreasing in a, and above
    0.5 even at the cap for the hottest levels."""
    p = 0.35 + 0.6 / (1.0 + a / (2.0 * t ** 6))
    return np.round(p * k * n) / (k * n)


def test_tune_mobility_ladder_search_matches_jax(monkeypatch):
    """tune_mobility_ladder's search in both packages under one synthetic
    acceptance model (tpu_smc.tsweep._multi_t_block and the port's
    _ladder_block patched to report it): the same a_per_t sequence probe
    for probe, with the hot levels pinned at the cap."""
    temps = [0.8, 1.0, 1.5, 3.0]
    cpt, k, n = 2, 25, 32
    jc, tc = JConfig.for_n(n, dtype="float64"), \
        TConfig.for_n(n, dtype="float64")
    seen = {"jax": [], "port": []}

    def jblock(state, w, cfg, temps_c, a_scale, n_sweeps, collect_trace=False,
               a_c=None):
        a = np.asarray(a_c)
        seen["jax"].append(a[::cpt].copy())
        acc = _acc_model(a, np.asarray(temps_c), k, n) * k * n
        return state._replace(accepted=jnp.asarray(np.rint(acc),
                                                    jnp.int32)), None

    def tblock(state, w, cfg, temps_c, a_scale, n_sweeps, sampler,
               collect_trace=False, a_c=None):
        a = a_c.numpy()
        seen["port"].append(a[::cpt].copy())
        acc = _acc_model(a, temps_c.numpy(), k, n) * k * n
        return state.replace(accepted=torch.as_tensor(
            np.rint(acc).astype(np.int64))), None

    monkeypatch.setattr(jts, "_multi_t_block", jblock)
    monkeypatch.setattr(tts, "_ladder_block", tblock)
    jr = jtune.tune_mobility_ladder(jc, temps, jax.random.key(0),
                                    chains_per_t=cpt, target=0.5)
    tr = ttune.tune_mobility_ladder(tc, temps, seed_words(0),
                                    chains_per_t=cpt, target=0.5,
                                    device="cpu")
    assert len(seen["port"]) == len(seen["jax"]) > 3
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tr.a_per_t, jr.a_per_t)
    np.testing.assert_array_equal(tr.acceptance, jr.acceptance)
    assert tr.sweeps_used == jr.sweeps_used
    cap = ttune.mobility_cap(tc)
    assert tr.a_per_t[-1] == cap and tr.acceptance[-1] > 0.5
    assert abs(tr.acceptance[0] - 0.5) <= 0.02


def test_tune_mobility_search_matches_jax(monkeypatch):
    """tune_mobility (the ensemble's --target-acceptance) in both packages
    under one synthetic acceptance model: the same probe history."""
    k, n, c = 25, 32, 2
    jc, tc = JConfig.for_n(n, dtype="float64"), \
        TConfig.for_n(n, dtype="float64")
    jst, jw = jstate.init_ensemble_state(jc, jax.random.key(0), c)
    tst, tw = init_ensemble_state(tc, seed_words(0), c, device="cpu")

    def jblock(state, w, cfg, a, n_sweeps):
        acc = _acc_model(float(a), 1.0, k, n) * k * n
        return state._replace(accepted=jnp.full((c,), int(round(acc)),
                                                jnp.int32))

    def tsweeps(state, w, cfg, a, n_sweeps, **kw):
        acc = _acc_model(a, 1.0, k, n) * k * n
        return state.replace(accepted=torch.full(
            (c,), int(round(acc)), dtype=torch.int64)), None

    monkeypatch.setattr(jtune, "_tune_block_xla", jblock)
    monkeypatch.setattr(ten, "ensemble_sweeps", tsweeps)
    _, jr = jtune.tune_mobility(jc, jst, jw, target=0.7)
    _, tr = ttune.tune_mobility(tc, tst, tw, target=0.7)
    assert [h[0] for h in tr.history] == [h[0] for h in jr.history]
    assert [h[1] for h in tr.history] == [h[1] for h in jr.history]
    assert (tr.proposal_a, tr.acceptance, tr.sweeps_used) == \
        (jr.proposal_a, jr.acceptance, jr.sweeps_used)
    with pytest.raises(ValueError):
        ttune.tune_mobility(tc, tst, tw, target=1.0)
