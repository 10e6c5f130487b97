"""MBAR reweighting in the port against tpu_smc.reweight on synthetic
samples made with numpy: the free energies and reweighted moments, the
ladder reweighting with its replica bootstrap (same numpy seed), the
quenched-disorder solve, the analytic harmonic ladder, and the grid
parser. Both packages solve in float32: relative agreement 1e-5."""

import numpy as np
import pytest

import tpu_smc.reweight as jrw
import tpu_smc.tsweep as jts
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc_torch import reweight as trw
from tpu_smc_torch import tsweep as tts
from tpu_smc_torch.config import SMCConfig as TConfig

RTOL = 1e-5
TEMPS = np.array([0.8, 1.0, 1.25])


def _gamma_samples(temps, m, seed=0, offset=0.0):
    """Per-T energy samples of a 3-dof harmonic well, Gamma(3/2, T):
    <E> = 1.5 T, var = 1.5 T^2, f(beta) = 1.5 ln(beta) + const."""
    rng = np.random.default_rng(seed)
    return [offset + rng.gamma(1.5, t, m) for t in temps]


def _close(a, b, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=atol)


@pytest.mark.parametrize("offset", [0.0, 1.0e4])
def test_mbar_and_moments_match_jax(offset):
    e_k = _gamma_samples(TEMPS, 4000, seed=1, offset=offset)
    tf, tld, tes, tsh, _ = trw.mbar_free_energies(e_k, 1.0 / TEMPS)
    jf, jld, jes, jsh, _ = jrw.mbar_free_energies(e_k, 1.0 / TEMPS)
    assert tsh == jsh
    np.testing.assert_array_equal(tes.numpy(), np.asarray(jes))
    # f is O(offset * dbeta); compare to the f32 solve's resolution
    _close(tf, jf, atol=1e-5 * (1.0 + offset))
    _close(tld.numpy(), np.asarray(jld), atol=1e-5)
    grid = np.array([0.8, 0.9, 1.1, 1.25])
    tr = trw.reweight_observables(e_k, TEMPS, grid)
    jr = jrw.reweight_observables(e_k, TEMPS, grid)
    for name in ("mean_energy", "cv", "ess"):
        _close(getattr(tr, name), getattr(jr, name))
    _close(tr.free_energy, jr.free_energy, atol=1e-5 * (1.0 + offset))
    o_k = [np.sin(e) for e in e_k]
    _close(trw.reweight_paired_observable(e_k, o_k, TEMPS, grid),
           jrw.reweight_paired_observable(e_k, o_k, TEMPS, grid), atol=1e-6)


def test_analytic_ladder():
    """A temperature never sampled lands on the analytic harmonic-well
    values (tests/test_reweight.py's check of tpu_smc)."""
    e_k = _gamma_samples(TEMPS, 40_000, seed=3)
    grid = np.array([0.8, 0.9, 1.1, 1.25])
    res = trw.reweight_observables(e_k, TEMPS, grid)
    np.testing.assert_allclose(res.mean_energy, 1.5 * grid, rtol=0.02)
    np.testing.assert_allclose(res.cv, 1.5, rtol=0.05)
    f_exact = 1.5 * np.log(1.0 / grid)
    np.testing.assert_allclose(res.free_energy, f_exact - f_exact[0],
                               atol=0.02)
    f_k, *_ = trw.mbar_free_energies(e_k, 1.0 / TEMPS)
    f_exact = 1.5 * np.log(1.0 / TEMPS)
    np.testing.assert_allclose(f_k, f_exact - f_exact[0], atol=0.02)
    assert np.all(res.ess > 10_000) and res.iterations > 0


def _ladder_results(mod, temps, g, r, seed, offset=-30.0):
    """TSweepResults-shaped synthetic ladder samples [g, n_t, r]: energies
    with a per-replica offset and paired pressures."""
    rng = np.random.default_rng(seed)
    e = np.stack([rng.gamma(1.5, t, (g, r)) for t in temps], axis=1)
    e = e + offset + rng.normal(0.0, 0.2, r)
    p = 0.01 * e + rng.normal(0.0, 0.001, e.shape)
    z = np.zeros(len(temps))
    return mod.TSweepResults(temps=np.asarray(temps), mean_energy=z,
                             err_energy=z, acceptance=z, cv=z,
                             energy_samples=e, pressure_samples=p,
                             energy_at_pressure=e)


def _close_results(t, j, names):
    for name in names:
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _close(a, b, atol=1e-7)


FIELDS = ("temps", "mean_energy", "cv", "ess", "free_energy", "ladder_f",
          "err_energy", "err_cv", "err_f", "pressure", "err_pressure")


def test_reweight_from_ladder_with_bootstrap_matches_jax():
    """reweight_from_ladder with a 6-draw replica bootstrap: the same
    np.random.default_rng(seed) replica draws, so estimates and errors
    agree to float32 resolution."""
    temps, grid = [0.9, 1.1, 1.3], np.linspace(0.9, 1.3, 5)
    tc, jc = TConfig.for_n(32), JConfig.for_n(32)
    t_res = trw.reweight_from_ladder(_ladder_results(tts, temps, 20, 8, 4),
                                     tc, grid, n_boot=6, seed=11)
    j_res = jrw.reweight_from_ladder(_ladder_results(jts, temps, 20, 8, 4),
                                     jc, grid, n_boot=6, seed=11)
    _close_results(t_res, j_res, FIELDS)
    assert t_res.err_energy is not None and (t_res.err_energy > 0).all()


def test_reweight_disorder_ladder_matches_jax():
    """One MBAR solve per realization (the replica axis split in K
    blocks), averaged, with between-realization standard errors."""
    temps, grid = [1.0, 1.2], np.array([1.0, 1.1, 1.2])
    tc, jc = TConfig.for_n(32), JConfig.for_n(32)
    t_c, t_parts = trw.reweight_disorder_ladder(
        _ladder_results(tts, temps, 10, 6, 5), tc, grid, 3)
    j_c, j_parts = jrw.reweight_disorder_ladder(
        _ladder_results(jts, temps, 10, 6, 5), jc, grid, 3)
    _close_results(t_c, j_c, FIELDS)
    assert len(t_parts) == len(j_parts) == 3
    for tp, jp in zip(t_parts, j_parts):
        _close_results(tp, jp, FIELDS)
    with pytest.raises(ValueError):
        trw.reweight_disorder_ladder(_ladder_results(tts, temps, 4, 6, 5),
                                     tc, grid, 4)


@pytest.mark.parametrize("spec", ["0.9:1.6:15", "1.0:1.3:7", "1.1",
                                  "1.0,1.2,1.5", "2:2:1"])
def test_parse_t_grid_matches_jax(spec):
    np.testing.assert_array_equal(trw.parse_t_grid(spec),
                                  jrw.parse_t_grid(spec))


@pytest.mark.parametrize("spec", ["1:2", "1:2:3:4", "1.3:1.0:4", "0:1:3",
                                  "1:2:0", "1.0,-1.0", "1.0,0"])
def test_parse_t_grid_errors(spec):
    with pytest.raises(ValueError):
        jrw.parse_t_grid(spec)
    with pytest.raises(ValueError):
        trw.parse_t_grid(spec)
