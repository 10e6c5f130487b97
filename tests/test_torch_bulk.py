"""The bulk LJ fluid (the SMC_noMPI_noWall.c variant: z periodic, no
walls, cutoff L/2) in tpu_smc_torch against tpu_smc: the kernel's plain
version move for move against tpu_smc.sampler.sweep in float64, carried
energy against tpu_smc's recompute with pad rows, ensemble statistics
against tpu_smc's simulate_ensemble, and the CLI's --bulk, --rho and
--lj-cutoff.

    PYTHONPATH=. python tests/test_torch_bulk.py

prints tpu_smc's CPU run of chip_smoke.py's N = 32 bulk ensemble (the
REF_BULK record there)."""

import unittest.mock as um

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_smc.io as jio
import tpu_smc.observables as jobs
import tpu_smc.potentials as jpot
import tpu_smc.sampler as jsam
from tpu_smc.config import RunParams as JParams
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc.driver import ObservableOptions as JOptions
from tpu_smc.driver_ensemble import simulate_ensemble as j_simulate
from tpu_smc.state import init_ensemble_state as j_init
from tpu_smc.system import build_walls, fcc_lattice
from tpu_smc_torch import cli as tcli
from tpu_smc_torch import ensemble as ten
from tpu_smc_torch import observables as tobs
from tpu_smc_torch.config import RunParams, SMCConfig as TConfig
from tpu_smc_torch.driver import ObservableOptions
from tpu_smc_torch.driver_ensemble import simulate_ensemble
from tpu_smc_torch.kernels import sweep as ks
from tpu_smc_torch.state import init_ensemble_state, seed_words

# tiny tensors: keep torch's intra-op pool from competing with the
# other test workers for cores
torch.set_num_threads(1)


def _bulk(cls, n, **kw):
    return cls.bulk(n=n, temperature=1.5, rho=kw.pop("rho", 0.3),
                    gamma=0.02 / 1.5, **kw)


@pytest.mark.parametrize("n", [30, 32])
def test_plain_kernel_bulk_matches_jax_sweep_float64(n):
    """sweep_block_plain under pbc_z and use_walls=False is
    tpu_smc.sampler.sweep move for move in float64 (tolerance 1e-10, the
    same injected noise, uniforms and offset). N = 30 has 2 pad rows,
    which only the row-id mask can exclude once z wraps."""
    c, off = 2, 7
    jc, tc = _bulk(JConfig, n, dtype="float64"), _bulk(TConfig, n,
                                                       dtype="float64")
    assert tc.pbc_z and not tc.use_walls and tc.lj_cutoff == tc.box_l / 2
    w = build_walls(jc)[0]
    rng = np.random.default_rng(n)
    r = fcc_lattice(jc)[None] + rng.normal(0.0, 0.05, (c, n, 3))
    noise = rng.normal(0.0, np.sqrt(2 * jc.proposal_a), (c, n, 3))
    unif = rng.uniform(0.0, 1.0, (c, n))
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(
        jnp.arange(c))
    e0 = jax.vmap(lambda x: jpot.total_energy(x, jnp.asarray(w), jc))(
        jnp.asarray(r))

    def jsweep(x, e, k, nz, u):
        with um.patch.object(jax.random, "normal",
                             lambda *a, **kw: nz / jnp.sqrt(
                                 2.0 * jc.proposal_a)), \
                um.patch.object(jax.random, "uniform", lambda *a, **kw: u):
            return jsam.sweep(x, e, k, jnp.asarray(w), jc, jc.proposal_a,
                              offset=jnp.int32(off))

    outs = [jsweep(jnp.asarray(r[i]), e0[i], keys[i], jnp.asarray(noise[i]),
                   jnp.asarray(unif[i])) for i in range(c)]
    rj = np.stack([np.asarray(o[0]) for o in outs])
    ej = np.asarray([float(o[1]) for o in outs])
    accj = np.asarray([int(o[3]) for o in outs])

    n_pad = ks.padded_rows(n)
    x, y, z = (torch.cat([torch.as_tensor(r[..., k]).T, torch.full(
        (n_pad - n, c), ks.PARK, dtype=torch.float64)]) for k in range(3))
    wa, wb = (t.double() for t in ks.wall_coeff_rows(torch.as_tensor(w), tc))
    g = torch.roll(torch.as_tensor(noise), -off, dims=1).permute(1, 0, 2)
    u = torch.as_tensor(unif).T
    x, y, z, e, etr, atr = ks.sweep_block_plain(
        x, y, z, torch.as_tensor(np.array(e0))[None], wa, wb,
        torch.tensor([off]), torch.zeros((1, 2), dtype=torch.int64), tc, 1,
        tc.proposal_a, draws=(g[None], u[None]))
    np.testing.assert_array_equal(atr[0].numpy(), accj)
    assert 0 < accj.min() and accj.max() < n
    np.testing.assert_allclose(ks.from_planes(x, y, z, tc).numpy(), rj,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(e[0].numpy(), ej, rtol=1e-10, atol=1e-10)


def test_bulk_pad_rows_carried_energy_matches_jax_recompute():
    """tests/test_pallas.py's pbc_z regression on the port: N = 12 (4 pad
    rows), 2 sweeps of the dense engine (the kernel's plain version on the
    CPU, float32); carried E equals tpu_smc.potentials.total_energy of the
    final positions within rtol 1e-4, atol 1e-3 (as there)."""
    kw = dict(n=12, box_l=10.0, box_lz=10.0, dtype="float32",
              use_walls=False, pbc_z=True, lj_cutoff=3.0)
    jc, tc = JConfig(**kw), TConfig(**kw)
    r0 = np.random.default_rng(5).uniform(-4.5, 4.5, (12, 3))
    state, w = init_ensemble_state(tc, seed_words(1), 8, r0=r0, device="cpu")
    st2, tr = ten.ensemble_sweeps_dense(state, w, tc, tc.proposal_a, 2,
                                        seed=4)
    exact = jax.vmap(lambda x: jpot.total_energy(x, jnp.zeros((9, 2)), jc))(
        jnp.asarray(st2.r.numpy()))
    np.testing.assert_allclose(st2.energy.numpy(), np.asarray(exact),
                               rtol=1e-4, atol=1e-3)
    acc = tr.accepted.numpy()
    assert (acc >= 0).all() and (acc <= 12).all() and acc.sum() > 0
    assert (np.abs(st2.r.numpy()) <= 5.0).all()      # z wrapped too


def test_bulk_voxel_map_matches_jax():
    """The voxel density/mobility update of the bulk cube (rho 0.5,
    positions over the whole cube and on its faces) equals tpu_smc's
    exactly."""
    jc = JConfig.bulk(n=108, rho=0.5, dtype="float64")
    tc = TConfig.bulk(n=108, rho=0.5, dtype="float64")
    rng = np.random.default_rng(12)
    r = rng.uniform(-0.5, 0.5, (3, 108, 3)) * jc.box_l
    r[0, :6] = [[h * jc.box_l / 2 for h in s] for s in (
        (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))]
    rbin = rng.integers(0, jc.n_voxels, (3, 108))
    dens = rng.integers(0, 5, (3, jc.n_voxels))
    mob = rng.integers(0, 5, (3, jc.n_voxels))
    jv = jax.vmap(lambda a, b, c_, d: jobs.density_mobility_update(
        a, b, c_, d, jc))(jnp.asarray(r), jnp.asarray(rbin, jnp.int32),
                          jnp.asarray(dens, jnp.uint32),
                          jnp.asarray(mob, jnp.uint32))
    tv = tobs.density_mobility_update(
        torch.as_tensor(r), torch.as_tensor(rbin), torch.as_tensor(dens),
        torch.as_tensor(mob), tc)
    for a, b in zip(jv, tv):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy())
    assert not np.array_equal(np.asarray(jv[1]), dens)


def test_bulk_engines_follow_one_chain():
    """The plain engine makes the kernel's draws in bulk mode too: the
    dense engine (its plain version on the CPU) follows the same chains;
    z-skip is refused under pbc_z, as in tpu_smc. Float32 on both
    sides; positions within 1e-4, as for the walled engines."""
    cfg = _bulk(TConfig, 32)
    state, w = init_ensemble_state(cfg, seed_words(4), 3, device="cpu")
    p, ptr = ten.ensemble_sweeps(state, w, cfg, cfg.proposal_a, 3,
                                 collect_trace=True, stream_seed=9)
    d, dtr = ten.ensemble_sweeps_dense(state, w, cfg, cfg.proposal_a, 3,
                                       seed=9)
    assert torch.equal(ptr.accepted.to(torch.int32), dtr.accepted)
    np.testing.assert_allclose(p.r.numpy(), d.r.numpy(), rtol=0, atol=1e-4)
    with pytest.raises(NotImplementedError, match="pbc_z"):
        ten.ensemble_sweeps_zsorted(state, w, cfg, cfg.proposal_a, 2, seed=9)
    assert not ten.zsorted_streams(cfg, "cpu")


# tests/test_bulk_parity.py's state: N = 32, T = 1.5, rho = 0.1, A = 0.02
STAT_N, STAT_T, STAT_A = 32, 1.5, 0.02


def _stats(agg):
    """Mean E, its SE, mean acceptance, its SE, over the chains."""
    e = np.asarray([ch.mean_energy for ch in agg.chains])
    acc = np.asarray([ch.acceptance_ratio for ch in agg.chains])
    k = len(e)
    return (e.mean(), e.std(ddof=1) / np.sqrt(k), acc.mean(),
            acc.std(ddof=1) / np.sqrt(k))


def jax_bulk_stats(chains: int, params, seed: int):
    """tpu_smc's simulate_ensemble (XLA engine, float32) in the statistics
    state from the FCC lattice. Returns _stats of the run."""
    jc = JConfig.bulk(n=STAT_N, temperature=STAT_T, rho=0.1,
                      gamma=STAT_A / STAT_T)
    state, w = j_init(jc, jax.random.key(seed), chains)
    _, agg = j_simulate(jc, JParams(*params), state, w,
                        opts=JOptions(clusters=False, sampler="xla",
                                      stream_seed=seed))
    return _stats(agg)


def test_bulk_ensemble_statistics_match_jax():
    """Mean E and acceptance of the port's bulk ensemble (plain engine,
    32 chains, 100 + 200 sweeps) within 3 combined SE of tpu_smc's run of
    the same state (its XLA engine, other streams)."""
    params = (100, 200, 4)
    tc = TConfig.bulk(n=STAT_N, temperature=STAT_T, rho=0.1,
                      gamma=STAT_A / STAT_T)
    state, w = init_ensemble_state(tc, seed_words(3), 32, device="cpu")
    _, agg = simulate_ensemble(tc, RunParams(*params), state, w,
                               ObservableOptions(sampler="torch",
                                                 stream_seed=3))
    te, tse, ta, tase = _stats(agg)
    je, jse, ja, jase = jax_bulk_stats(32, params, 5)
    assert abs(te - je) <= 3.0 * np.hypot(tse, jse), (te, tse, je, jse)
    assert abs(ta - ja) <= 3.0 * np.hypot(tase, jase), (ta, tase, ja, jase)
    assert 0.5 < ta < 1.0


def test_cli_bulk_flags_and_refusals(capsys):
    """--bulk, --rho and --lj-cutoff build SMCConfig.bulk as tpu_smc's CLI
    does; tpu_smc's refusals hold: --rho without --bulk, --wall-
    realizations with --bulk, --sampler zsorted under pbc_z."""
    args = tcli.build_parser().parse_args(
        ["1", "2", "1", "1.5", "--bulk", "--rho", "0.5", "--lj-cutoff",
         "2.5"])
    assert args.bulk and args.rho == 0.5 and args.lj_cutoff == 2.5
    base = ["1", "2", "1", "1.5", "--device", "cpu", "--chains", "2"]
    for extra, msg in ((["--rho", "0.5"], "needs --bulk"),
                       (["--bulk", "--chains", "4", "--wall-realizations",
                         "2"], "bulk mode has no walls"),
                       (["--bulk", "--sampler", "zsorted"], "confined z")):
        with pytest.raises(SystemExit, match=msg):
            tcli.main(base + extra)


def test_cli_bulk_routing(monkeypatch):
    """auto sends pbc_z to the dense kernel at every N on a card (tpu_smc/
    cli.py:327), torch elsewhere; beyond the resident capacity a bulk run
    exits with a message instead of streaming."""
    monkeypatch.setattr(ks, "resident_fits", lambda n_pad, device=None,
                        sites=0: (
        torch.device(device or "cuda").type != "cuda" or n_pad <= 4096))
    for n in (32, 1024, 4000):
        assert tcli._resolve_sampler("auto", TConfig.bulk(n=n),
                                     "cuda") == "dense"
    assert tcli._resolve_sampler("auto", TConfig.bulk(n=4000), "cpu") == "torch"
    with pytest.raises(SystemExit, match="no streamed kernel"):
        tcli._resolve_sampler("auto", TConfig.bulk(n=8192), "cuda")
    assert tcli._engine_label("dense", TConfig.bulk(n=4000), "cuda") == "dense"


def test_cli_bulk_writes_jax_file_set(tmp_path, capsys):
    """One in-process bulk run writes the run directory (rho of the cube)
    and the file names and CSV headers of tpu_smc's writers; the config
    is SMCConfig.bulk's with the given rho and cutoff."""
    n, chains, lapse = 32, 2, 4
    argv = ["4", "16", "4", "1.5", "--bulk", "--n", str(n), "--rho", "0.2",
            "--lj-cutoff", "2.5", "--chains", str(chains), "--device", "cpu",
            "--sampler", "torch", "--seed", "3", "--data-dir",
            str(tmp_path / "port"), "--lca-time", "2"]
    assert tcli.main(argv) == 0
    out = capsys.readouterr().out
    assert "Ensemble sweep engine: torch" in out
    jc = JConfig.bulk(n=n, temperature=1.5, rho=0.2, lj_cutoff=2.5)
    d = jio.run_dir(jc, tmp_path / "jax")
    _, x0, ym = build_walls(jc)
    jio.write_wall_csv(d, jc, x0, ym)
    res = type("R", (), dict(
        energy_trace_full=np.zeros(4 * lapse + 1), pressure_trace=np.zeros(4),
        accept_trace=np.zeros(4 * lapse), mean_energy=0.0, std_energy=0.0,
        mean_pressure=0.0, std_pressure=0.0, cv=0.0, tau=0.0,
        acceptance_ratio=0.0, l2=np.zeros(7), l3=np.zeros(7)))()
    for rk in range(chains):
        jio.PositionsWriter(d, jc, rank=rk)
        jio.write_data_csv(d, jc, res.energy_trace_full, res.pressure_trace,
                           res.accept_trace, lapse, rank=rk)
        jio.LocalWriter(d, jc, "local", rank=rk)
        jio.write_total_clusters_csv(d, jc, 0.0, res.l2, res.l3, rank=rk)
        jio.write_autocorrelation_csv(d, jc, np.zeros(3), rank=rk)
    jio.write_ensemble_data_csv(d, jc, [res] * chains, lapse)
    jio.write_info_csv(d, jc, JParams(4, 16, 4), res)
    jio.write_last_state(d, jc, np.zeros((n, 3)))
    port = tmp_path / "port" / jc.run_name()
    assert "r0.2000" in jc.run_name()
    assert sorted(p.name for p in port.iterdir()) == \
        sorted(p.name for p in d.iterdir())
    for p in d.iterdir():
        if not p.name.startswith(("last_state", "info")):
            assert (port / p.name).read_text().splitlines()[0] == \
                p.read_text().splitlines()[0], p.name
    e = np.loadtxt(port / f"data_ensemble_{jc.file_key()}.csv",
                   delimiter=",", skiprows=1, ndmin=2)
    assert np.isfinite(e).all()


if __name__ == "__main__":
    # tpu_smc's CPU run of `python -m tpu_smc 200 800 8 1.5 --bulk --n 32
    # --rho 0.1 --gamma 0.013333 --chains 64 --seed 7` through its own
    # CLI, simulate_ensemble's per-chain results captured for _stats
    import tempfile

    import tpu_smc.cli as jcli
    import tpu_smc.driver_ensemble as jde

    jax.config.update("jax_platforms", "cpu")
    seen, simulate = {}, jde.simulate_ensemble

    def capture(*a, **kw):
        seen["out"] = simulate(*a, **kw)
        return seen["out"]

    with tempfile.TemporaryDirectory() as tmp, \
            um.patch.object(jde, "simulate_ensemble", capture):
        jcli.main(["200", "800", "8", "1.5", "--bulk", "--n", "32", "--rho",
                   "0.1", "--gamma", "0.013333", "--chains", "64", "--seed",
                   "7", "--platform", "cpu", "--data-dir", tmp])
    e, e_se, a, a_se = _stats(seen["out"][1])
    print({"E": float(e), "E_err": float(e_se), "acc": float(a),
           "acc_err": float(a_se)})
