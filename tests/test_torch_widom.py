"""Widom insertion in tpu_smc_torch against tpu_smc.widom in float64:
ghost energies on the same injected ghosts (shared and per-chain walls),
the estimators on the same arrays, the port's ghost stream (absolute
gather: a continued run draws the uninterrupted run's ghosts), the
ladder's paired fields and mu_ex through MBAR against tpu_smc.reweight,
and the CLI's measurement branches (ensemble, single chain, ladder)
with tpu_smc's CSV headers and shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_smc.reweight as jrw
import tpu_smc.tsweep as jts
import tpu_smc.widom as jwd
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc.system import build_wall_ensemble, build_walls, fcc_lattice
from tpu_smc_torch import reweight as trw
from tpu_smc_torch import tsweep as tts
from tpu_smc_torch import widom as twd
from tpu_smc_torch.config import SMCConfig as TConfig

torch.set_num_threads(1)

N = 32


def _jax_ghosts(key, cfg, k):
    """tpu_smc.widom.widom_delta_u's own ghost draws [k, 3]."""
    kx, kz = jax.random.split(jax.random.fold_in(key, jwd._WIDOM_FOLD))
    xy = jax.random.uniform(kx, (k, 2), cfg.jnp_dtype, -cfg.box_l / 2,
                            cfg.box_l / 2)
    z = jax.random.uniform(kz, (k,), cfg.jnp_dtype, -cfg.box_lz / 2,
                           cfg.box_lz / 2)
    return np.array(jnp.concatenate([xy, z[:, None]], axis=1))


def _positions(c, seed=0):
    jc = JConfig.for_n(N, dtype="float64")
    rng = np.random.default_rng(seed)
    r = fcc_lattice(jc)[None] + rng.normal(0.0, 0.4, (c, N, 3))
    r[:, 0, 2] = -jc.box_lz / 2 + 0.9
    return r


@pytest.mark.parametrize("per_chain_walls", [False, True])
def test_delta_u_matches_jax_on_injected_ghosts(per_chain_walls):
    jc = JConfig.for_n(N, dtype="float64")
    tc = TConfig.for_n(N, dtype="float64")
    c, k = 3, 40
    r = _positions(c, seed=1)
    if per_chain_walls:
        w = build_wall_ensemble(jc, c)[0]            # [C, M*M, 2]
    else:
        w = build_walls(jc)[0]
    ghosts, du_j = [], []
    for ci in range(c):
        key = jax.random.key(10 + ci)
        g = _jax_ghosts(key, jc, k)
        # ghosts at every branch: near a particle, at the walls, over the
        # periodic edge
        g[0] = r[ci, 3] + 0.95
        g[1, 2] = -jc.box_lz / 2 + 0.5
        g[2, 0] = jc.box_l / 2 - 0.01
        wc = jnp.asarray(w[ci] if per_chain_walls else w)
        rj = jnp.asarray(r[ci])
        du, z = jwd.widom_delta_u(rj, wc, jc, key, k)
        np.testing.assert_array_equal(np.asarray(z), _jax_ghosts(key, jc,
                                                                 k)[:, 2])
        from tpu_smc.potentials import energy_force_single

        du_j.append(np.asarray(jax.vmap(lambda gg: energy_force_single(
            rj, jnp.int32(-1), gg, wc, jc)[0])(jnp.asarray(g))))
        ghosts.append(g)
    du_t = twd.widom_delta_u(torch.as_tensor(r), torch.as_tensor(w), tc,
                             torch.as_tensor(np.stack(ghosts)))
    np.testing.assert_allclose(du_t.numpy(), np.stack(du_j), rtol=1e-10,
                               atol=1e-13)


def test_wall_sites_in_the_run_dtype():
    """float64 wall sites are i * L/M in float64 (L/M was rounded to
    float32 before, which moved the site terms of an N = 32 box by 1e-6
    relative), float32 ones the float32 products tpu_smc computes."""
    from tpu_smc.potentials import wall_site_positions as jsites
    from tpu_smc_torch.potentials import wall_site_positions as tsites

    for m in (3, 10):
        jc = JConfig.for_n(N, dtype="float64", m=m)
        tc = TConfig.for_n(N, dtype="float64", m=m)
        np.testing.assert_array_equal(tsites(tc).numpy(),
                                      np.asarray(jsites(jc)))
        assert tsites(tc).dtype == torch.float64
        assert tsites(tc, torch.float32).dtype == torch.float32


def test_estimators_match_jax():
    rng = np.random.default_rng(3)
    t = 1.1
    du = rng.normal(0.2, 1.0, (6, 5, 16))
    du[0, 0, :3] = np.inf
    z = rng.uniform(-100, 100, du.shape)
    cfg_t, cfg_j = TConfig.for_n(108), JConfig.for_n(108)
    for a, b in zip(twd.mu_ex(du, t, n_boot=50, seed=2),
                    jwd.mu_ex(du, t, n_boot=50, seed=2)):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    # one chain bootstraps its gathers
    np.testing.assert_allclose(twd.mu_ex(du[:, :1], t, n_boot=20),
                               jwd.mu_ex(du[:, :1], t, n_boot=20), rtol=1e-12)
    for a, b in zip(twd.mu_ex_profile(du, z, t, cfg_t, nbins=12, n_boot=30),
                    jwd.mu_ex_profile(du, z, t, cfg_j, nbins=12, n_boot=30)):
        np.testing.assert_allclose(a, b, rtol=1e-12, equal_nan=True)
    assert np.isnan(twd.mu_ex(np.zeros((0,)), t)[0])
    temps = np.array([1.0, 1.2, 1.4])
    e_k = [rng.gamma(1.5, tt, 300) for tt in temps]
    du_k = [rng.normal(0.1, 0.5, (300, 8)) for _ in temps]
    grid = np.array([1.0, 1.1, 1.3])
    # both packages solve MBAR in float32
    for a, b in zip(twd.mu_ex_reweighted(du_k, e_k, temps, grid),
                    jwd.mu_ex_reweighted(du_k, e_k, temps, grid)):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert twd.second_virial(1.3) == jwd.second_virial(1.3)


def test_ghost_stream_follows_the_absolute_gather():
    """Ghosts are uniform over the box, differ between chains and
    gathers, and depend on (key, gather) alone; a run continued from a
    state draws the same ghosts as the uninterrupted run."""
    from tpu_smc_torch.config import RunParams
    from tpu_smc_torch.driver import ObservableOptions
    from tpu_smc_torch.driver_ensemble import simulate_ensemble
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    tc = TConfig.for_n(N, dtype="float64")
    key = torch.tensor([[1, 2], [3, 4], [1, 2]])
    g = twd.ghost_positions(key, 7, tc, 4096)
    assert torch.equal(g[0], g[2]) and not torch.equal(g[0], g[1])
    assert not torch.equal(g, twd.ghost_positions(key, 8, tc, 4096))
    lo = torch.tensor([-tc.box_l / 2, -tc.box_l / 2, -tc.box_lz / 2])
    assert bool(((g >= lo) & (g <= -lo)).all())
    np.testing.assert_allclose(g.mean((0, 1)).numpy(), 0.0,
                               atol=0.03 * tc.box_lz)

    st, w = init_ensemble_state(tc, seed_words(8), 2, device="cpu")
    opts = ObservableOptions(stream_seed=8, widom_k=5)
    _, full = simulate_ensemble(tc, RunParams(2, 8, 4), st, w, opts)
    st_a, _ = simulate_ensemble(tc, RunParams(2, 4, 2), st, w, opts)
    _, tail = simulate_ensemble(tc, RunParams(0, 4, 2), st_a, w, opts)
    np.testing.assert_array_equal(tail.widom_du, full.widom_du[2:])
    np.testing.assert_array_equal(tail.widom_z, full.widom_z[2:])


def _ladder_samples(seed=0):
    """A synthetic ladder with every paired field, [B, n_t, R, ...]."""
    rng = np.random.default_rng(seed)
    temps = np.array([1.0, 1.2, 1.4])
    b, r = 20, 6
    e = np.stack([rng.gamma(1.5, t, (b, r)) for t in temps], axis=1) * 30
    e_p = e[::2]
    fields = {name: rng.random((b // 2, 3, r, nb)) for name, nb in (
        ("gr_samples", 8), ("zprofile_samples", 10), ("sk_samples", 4),
        ("ptensor_n_samples", 5), ("ptensor_t_samples", 5),
        ("ptensor_rho_samples", 5))}
    fields["widom_samples"] = rng.normal(0.1, 0.4, (b // 2, 3, r, 7))
    common = dict(temps=temps, mean_energy=e.mean((0, 2)),
                  err_energy=np.ones(3), acceptance=np.ones(3), cv=np.ones(3),
                  energy_samples=e, pressure_samples=rng.random(e_p.shape),
                  energy_at_pressure=e_p)
    return (jts.TSweepResults(**common, **fields),
            tts.TSweepResults(**common, **fields))


@pytest.mark.parametrize("n_boot", [0, 4])
def test_ladder_fields_reweight_like_jax(n_boot):
    """reweight_from_ladder on the same paired samples: g(r; T), rho(z;
    T), S(k; T), mu_ex(T), P_N/P_T(z; T) and gamma(T) with their
    bootstrap errors (float32 MBAR in both: 1e-5), the per-realization
    solve, and the CSVs with tpu_smc's columns."""
    js, ts = _ladder_samples()
    jc, tc = JConfig.for_n(N), TConfig.for_n(N)
    grid = np.array([1.0, 1.15, 1.4])
    jr = jrw.reweight_from_ladder(js, jc, grid, n_boot=n_boot, seed=3)
    tr = trw.reweight_from_ladder(ts, tc, grid, n_boot=n_boot, seed=3)
    for name in ("gr", "zprofile", "sk", "mu_ex", "pn", "pt", "gamma",
                 "err_gr", "err_zprofile", "err_sk", "err_mu_ex",
                 "err_gamma"):
        a, b = getattr(tr, name), getattr(jr, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)
    jd, jparts = jrw.reweight_disorder_ladder(js, jc, grid, 2)
    td, tparts = trw.reweight_disorder_ladder(ts, tc, grid, 2)
    for name in ("mu_ex", "err_mu_ex", "zprofile", "gamma"):
        np.testing.assert_allclose(getattr(td, name), getattr(jd, name),
                                   rtol=1e-4, atol=1e-5)


def test_ladder_samples_fields_on_the_plain_engine():
    """tsweep and PT collect the paired fields at every boundary with
    the shapes tpu_smc's TSweepResults carry."""
    from tpu_smc_torch.config import RunParams
    from tpu_smc_torch.pt import simulate_parallel_tempering
    from tpu_smc_torch.state import seed_words

    tc = TConfig.for_n(N, dtype="float64")
    fo = tts.FieldOptions(gr_bins=6, z_bins=5, sk_kmax=2, widom_k=3,
                          ptensor_bins=4)
    _, res = tts.simulate_temperature_sweep(
        tc, RunParams(2, 4, 2), [1.0, 1.3], seed_words(2), chains_per_t=2,
        sampler="torch", device="cpu", fields=fo)
    b = res.energy_at_pressure.shape[0]
    assert res.gr_samples.shape == (b, 2, 2, 6)
    assert res.zprofile_samples.shape == (b, 2, 2, 5)
    assert res.sk_samples.shape == (b, 2, 2, 5)  # |n|^2 in {1, 2, 4, 5, 8}
    assert res.widom_samples.shape == (b, 2, 2, 3)
    for name in ("ptensor_n_samples", "ptensor_t_samples",
                 "ptensor_rho_samples"):
        assert getattr(res, name).shape == (b, 2, 2, 4)
    _, pt = simulate_parallel_tempering(
        tc, RunParams(2, 4, 2), [1.0, 1.3], seed_words(2), chains_per_t=2,
        exchange_interval=2, sampler="torch", device="cpu", fields=fo)
    assert pt.tsweep.widom_samples.shape[1:] == (2, 2, 3)
    assert pt.tsweep.gr_samples.shape[0] == pt.tsweep.energy_at_pressure \
        .shape[0]


def _cli(tmp_path, *argv):
    from tpu_smc_torch import cli

    assert cli.main(["4", "8", "2", "1.1", "--n", str(N), "--device", "cpu",
                     "--seed", "3", "--data-dir", str(tmp_path),
                     *argv]) == 0
    cfg = TConfig.for_n(N)
    return tmp_path / cfg.run_name(), cfg.file_key()


def _head(path, rows=None):
    lines = path.read_text().splitlines()
    if rows is not None:
        assert len(lines) == rows, (path.name, len(lines))
    return lines[0]


@pytest.mark.parametrize("mode", ["ensemble", "single", "disorder"])
def test_cli_measurement_csvs(tmp_path, mode, capsys):
    """The ensemble, single-chain and disorder branches write tpu_smc's
    gr / zprofile / widom / ptensor CSVs (and the per-realization
    profiles), with its headers and row counts."""
    extra = {"ensemble": ["--chains", "3"], "single": [],
             "disorder": ["--chains", "4", "--wall-realizations", "2"]}[mode]
    d, key = _cli(tmp_path, "--gr-bins", "8", "--z-bins", "6", "--widom",
                  "4", "--widom-bins", "5", "--ptensor-bins", "7",
                  "--nonuniform-z", *extra)
    out = capsys.readouterr().out
    assert "Widom excess chemical potential: mu_ex =" in out
    assert "Wall tension (per wall): gamma" in out
    assert _head(d / f"gr_{key}_rank0.csv", 9) == "r, g"
    assert _head(d / f"zprofile_{key}_rank0.csv", 7) == "z, density"
    assert _head(d / f"ptensor_{key}.csv", 8) == "z, p_n, p_t"
    lines = (d / f"widom_{key}_rank0.csv").read_text().splitlines()
    assert lines[0].startswith("# mu_ex_global, ")
    assert lines[1] == "z, mu_ex, err, insertions" and len(lines) == 7
    if mode == "disorder":
        assert _head(d / f"zprofile_disorder_{key}.csv", 13) == \
            "k, z, value"
        assert _head(d / f"gr_disorder_{key}.csv", 17) == "k, r, value"


def test_cli_ladder_measurements(tmp_path, capsys):
    """The ladder branch: per-level mu_ex, the mu_ex and gamma columns of
    the MBAR table and CSV, and the reweighted field CSVs."""
    d, key = _cli(tmp_path, "--temperatures", "1.0,1.2", "--chains-per-t",
                  "2", "--pt-exchange", "2", "--reweight", "1.0:1.2:3",
                  "--z-bins", "6", "--gr-bins", "5", "--sk-kmax", "2",
                  "--widom", "3", "--ptensor-bins", "4", "--sampler",
                  "torch")
    out = capsys.readouterr().out
    assert "###  Widom mu_ex per level  ###" in out
    assert _head(d / f"reweight_{key}.csv", 4) == (
        "T, E_mean, E_err, cv, cv_err, P, P_err, mu_ex, mu_ex_err, gamma, "
        "gamma_err, ess, f")
    for stem, rows, head in (("reweight_zprofile", 19, "T, z, value, err"),
                             ("reweight_pmf", 19, "T, z, value, err"),
                             ("reweight_gr", 16, "T, r, value, err"),
                             ("reweight_sk", 16, "T, k, value, err"),
                             ("reweight_pn", 13, "T, z, value"),
                             ("reweight_pt", 13, "T, z, value")):
        assert _head(d / f"{stem}_{key}.csv", rows) == head, stem
