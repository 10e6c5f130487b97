"""tpu_smc_torch's structure observables against tpu_smc.observables on
the same positions in float64: the z-density profile, g(r) (the same
integer pair counts), the Harasima pressure-tensor profile and the
in-plane structure factor; the P_N/P_T virial identity; the pair
budget at large N; and the ensemble driver's per-gather collection
(measurement samples never touch the trajectory)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_smc.observables as jobs
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc_torch import observables as tobs
from tpu_smc_torch import potentials as tpot
from tpu_smc_torch.config import SMCConfig as TConfig

torch.set_num_threads(1)

N = 108
TOL = 1e-10


def _cfgs(n=N, **kw):
    return (JConfig.for_n(n, dtype="float64", **kw),
            TConfig.for_n(n, dtype="float64", **kw))


def cluster(c: int, n: int = N, seed: int = 0, lz: float = 200.0):
    """c chains of a dense jittered cubic cluster (spacing 1.15) on the
    lower wall, one particle across the periodic x edge: many pairs
    within the cutoff, none overlapping."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n] * 1.15
    r = g[None] - np.array([3.0, 3.0, lz / 2 - 1.2]) \
        + rng.normal(0.0, 0.08, (c, n, 3))
    r[:, 0, 0] = 33.0 / 2 - 0.05
    r[:, 1, 0] = -33.0 / 2 + 0.4
    return r


def test_z_profile_and_gr_match_jax():
    jc, tc = _cfgs()
    r = cluster(3)
    rt = torch.as_tensor(r)
    for nb in (16, 64):
        zc_t, zp_t = tobs.z_density_profile(rt, tc, nbins=nb)
        vol = tc.box_l ** 2 * tc.box_lz / nb
        for ci in range(3):
            # tpu_smc's profile is float32 even under x64: the same
            # integer counts, the density to float32 rounding
            zc_j, zp_j = jobs.z_density_profile(jnp.asarray(r[ci]), jc, nb)
            np.testing.assert_array_equal(
                np.rint(zp_t[ci].numpy() * vol),
                np.rint(np.asarray(zp_j, np.float64) * vol))
            np.testing.assert_allclose(zp_t[ci].numpy(), np.asarray(zp_j),
                                       rtol=1e-7)
        np.testing.assert_allclose(zc_t.numpy(), np.asarray(zc_j), rtol=TOL)
        rc_t, g_t = tobs.radial_distribution(rt, tc, nbins=nb)
        for ci in range(3):
            rc_j, g_j = jobs.radial_distribution(jnp.asarray(r[ci]), jc, nb)
            # the same integer pair counts: g is count / norm in both
            np.testing.assert_allclose(g_t[ci].numpy(), np.asarray(g_j),
                                       rtol=TOL, atol=0)
        np.testing.assert_allclose(rc_t.numpy(), np.asarray(rc_j), rtol=TOL)
    # the counts themselves: every unique pair within rmax counted once
    _, g = tobs.radial_distribution(rt, tc, nbins=8)
    edges = np.linspace(0.0, tc.lj_cutoff, 9)
    shell = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    counts = g.numpy() * (tc.rho * shell * N / 2.0)
    np.testing.assert_allclose(counts, np.rint(counts), atol=1e-8)
    d = r[0][:, None] - r[0][None]
    d[..., :2] -= 33.0 * np.round(d[..., :2] / 33.0)
    dr = np.sqrt((d ** 2).sum(-1))[np.triu_indices(N, 1)]
    assert int(np.rint(counts[0]).sum()) == int((dr < tc.lj_cutoff).sum())


@pytest.mark.parametrize("pbc", [False, True])
def test_pressure_tensor_and_sk_match_jax(pbc):
    """P_N/P_T per bin against tpu_smc's, which adds its ~N^2/2 pair
    terms into the bins in float32 even under x64 (the bins agree to
    that summation's rounding: 1e-5 of the profile's largest value);
    S(k) to 1e-10."""
    if pbc:
        jc = JConfig.bulk(n=64, rho=0.3, temperature=1.0, dtype="float64")
        tc = TConfig.bulk(n=64, rho=0.3, temperature=1.0, dtype="float64")
        rng = np.random.default_rng(4)
        side = 4
        g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                     -1).reshape(-1, 3) * (jc.box_l / side)
        r = g[None] - jc.box_l / 2 + rng.normal(0.0, 0.1, (2, 64, 3))
    else:
        jc, tc = _cfgs()
        r = cluster(2, seed=5)
    rt = torch.as_tensor(r)
    for ideal in (True, False):
        zc, pn, pt = tobs.pressure_tensor_profile(rt, tc, nbins=24,
                                                  include_ideal=ideal)
        for ci in range(2):
            _, pn_j, pt_j = jobs.pressure_tensor_profile(
                jnp.asarray(r[ci]), jc, nbins=24, include_ideal=ideal)
            for a, b in ((pn[ci], pn_j), (pt[ci], pt_j)):
                b = np.asarray(b, np.float64)
                np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                           atol=1e-5 * np.abs(b).max())
    for kmax in (2, 5):
        k_t, s_t = tobs.structure_factor(rt, tc, n_kmax=kmax)
        for ci in range(2):
            k_j, s_j = jobs.structure_factor(jnp.asarray(r[ci]), jc, kmax)
            np.testing.assert_allclose(s_t[ci].numpy(), np.asarray(s_j),
                                       rtol=TOL)
        np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=TOL)


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12),
                                        ("float32", 1e-4)])
def test_pressure_profile_sums_to_scalar_virial(dtype, rtol):
    """mean_b (P_N + 2 P_T)/3 = rho T + the pair virial pressure, in
    float64 and in float32 (the card's dtype; the bins accumulate in
    float64 either way)."""
    tc = TConfig.for_n(N, dtype=dtype)
    rt = torch.as_tensor(cluster(2, seed=7), dtype=tc.torch_dtype)
    for nb in (16, 48):
        _, pn, pt = tobs.pressure_tensor_profile(rt, tc, nbins=nb)
        mech = ((pn.double() + 2 * pt.double()) / 3.0).mean(-1)
        scalar = tc.rho * tc.temperature \
            + tpot.pair_virial_pressure(rt.double(), tc)
        np.testing.assert_allclose(mech.numpy(), scalar.numpy(), rtol=rtol)


def test_pair_passes_stay_within_the_budget(monkeypatch):
    """With PAIR_BUDGET cut to 4 N the all-pairs observables run over
    1-row chunks and many chain batches and give the same results."""
    tc = TConfig.for_n(N, dtype="float64")
    rt = torch.as_tensor(cluster(3, seed=9))
    full = (tobs.radial_distribution(rt, tc, nbins=16)[1],
            *tobs.pressure_tensor_profile(rt, tc, nbins=16)[1:],
            tobs.structure_factor(rt, tc, n_kmax=3)[1])
    monkeypatch.setattr(tpot, "PAIR_BUDGET", 4 * N)
    monkeypatch.setattr(tobs.potentials, "PAIR_BUDGET", 4 * N)
    assert tpot.pair_row_chunk(3, N) == 1
    small = (tobs.radial_distribution(rt, tc, nbins=16)[1],
             *tobs.pressure_tensor_profile(rt, tc, nbins=16)[1:],
             tobs.structure_factor(rt, tc, n_kmax=3)[1])
    for a, b in zip(full, small):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-15)


def test_ensemble_collects_fields_without_touching_the_trajectory():
    """simulate_ensemble with every measurement option gives the same
    trajectory, traces and voxel counts as without, and pools the
    per-gather samples as tpu_smc's driver does (means over gathers and
    chains; Widom [gathers, chains, K]); rho(z) integrates to N."""
    from tpu_smc_torch.config import RunParams
    from tpu_smc_torch.driver import ObservableOptions, simulate
    from tpu_smc_torch.driver_ensemble import simulate_ensemble
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    tc = TConfig.for_n(32, dtype="float64")
    st, w = init_ensemble_state(tc, seed_words(5), 3, device="cpu")
    params = RunParams(2, 6, 3)
    base = ObservableOptions(stream_seed=5)
    full = ObservableOptions(stream_seed=5, gr_bins=8, z_bins=10,
                             widom_k=6, ptensor_bins=5)
    s0, a0 = simulate_ensemble(tc, params, st, w, base)
    s1, a1 = simulate_ensemble(tc, params, st, w, full)
    for f in ("r", "energy", "density", "mobility", "key", "sweeps"):
        assert torch.equal(getattr(s0, f), getattr(s1, f)), f
    np.testing.assert_array_equal(a0.chains[1].energy_trace_full,
                                  a1.chains[1].energy_trace_full)
    assert a0.gr is None and a0.widom_du is None
    assert a1.widom_du.shape == a1.widom_z.shape == (3, 3, 6)
    assert a1.gr.shape == (8,) and a1.gr_chains.shape == (3, 8)
    assert a1.pn.shape == a1.pt.shape == (5,)
    np.testing.assert_allclose(a1.zprofile.sum() * tc.box_l ** 2
                               * tc.box_lz / 10, 32, rtol=1e-12)
    np.testing.assert_allclose(a1.zprofile_chains.mean(0), a1.zprofile,
                               rtol=1e-12)
    # the final gather's samples are those of the final state
    _, zp = tobs.z_density_profile(s1.r, tc, nbins=10)
    assert np.isfinite(a1.widom_du[np.isfinite(a1.widom_du)]).all()
    # one chain: simulate carries the pooled fields on its SimResults
    _, res = simulate(tc, params, st.replace(
        **{f: getattr(st, f)[:1] for f in ("r", "energy", "key", "sweeps",
                                           "accepted", "rbin", "density",
                                           "mobility")}), w, full)
    assert res.widom_du.shape == (3, 1, 6) and res.gr.shape == (8,)
    assert res.pn.shape == (5,) and res.zprofile.shape == (10,)
    del zp
