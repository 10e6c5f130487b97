"""The slice as a whole against tpu_smc: the ensemble engine from a
carried-across JAX state under the JAX keys' own draws, call-split
invariance of the three engines, particle identity through the z-sorts,
the gather-step observables, and the CLI's CSV set."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_smc.ensemble as jens
import tpu_smc.io as jio
import tpu_smc.observables as jobs
from tpu_smc.config import RunParams
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc.state import init_ensemble_state as j_init
from tpu_smc_torch import cli as tcli
from tpu_smc_torch import ensemble as ten
from tpu_smc_torch import observables as tobs
from tpu_smc_torch import sampler as tsam
from tpu_smc_torch.config import SMCConfig as TConfig
from tpu_smc_torch.driver import ObservableOptions
from tpu_smc_torch.driver_ensemble import simulate_ensemble
from tpu_smc_torch.state import from_jax_state, init_ensemble_state, seed_words

# tiny tensors: keep torch's intra-op pool from competing with the
# other test workers for cores
torch.set_num_threads(1)


def _carry(jstate, jw, tc):
    arrays = {f: np.asarray(getattr(jstate, f)) for f in jstate._fields
              if f != "key"}
    arrays["key"] = np.asarray(jax.random.key_data(jstate.key))
    return from_jax_state(arrays, np.asarray(jw), tc, device="cpu")


def test_ensemble_sweeps_reproduce_jax_float64():
    """tpu_smc.ensemble.ensemble_sweeps (2 sweeps, f64, stream seed) and
    the port's plain engine fed the JAX keys' noise, uniforms and shared
    offsets, from the same state carried across by from_jax_state."""
    n, c, s, seed = 32, 3, 2, 7
    jc, tc = JConfig.for_n(n, dtype="float64"), TConfig.for_n(n, dtype="float64")
    jstate, jw = j_init(jc, jax.random.key(11), c)
    a = jc.proposal_a
    j2, jtr = jens.ensemble_sweeps(jstate, jw, jc, a, s, collect_trace=True,
                                   stream_seed=seed)
    # re-derive the draws exactly as ensemble_sweeps / sampler.sweep do
    skey = jax.random.fold_in(jax.random.key(seed), 0x5EED)
    keys, noises, unifs, offsets = jstate.key, [], [], []
    for k in range(s):
        offsets.append(int(jax.random.randint(
            jax.random.fold_in(skey, k), (), 0, n)))

        def one(key):
            key, kn, ku, _ = jax.random.split(key, 4)
            return key, jnp.sqrt(2.0 * jnp.asarray(a, jnp.float64)) * \
                jax.random.normal(kn, (n, 3), jnp.float64), \
                jax.random.uniform(ku, (n,), jnp.float64)

        keys, nz, u = jax.vmap(one)(keys)
        noises.append(np.asarray(nz))
        unifs.append(np.asarray(u))
    tstate, tw = _carry(jstate, jw, tc)
    t2, ttr = ten.ensemble_sweeps(
        tstate, tw, tc, a, s, collect_trace=True,
        draws=(torch.as_tensor(np.stack(noises)),
               torch.as_tensor(np.stack(unifs)), offsets))
    np.testing.assert_array_equal(ttr.accepted.numpy(),
                                  np.asarray(jtr.accepted))
    np.testing.assert_allclose(t2.r.numpy(), np.asarray(j2.r), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(ttr.energy.numpy(), np.asarray(jtr.energy),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(t2.sweeps.numpy(), np.asarray(j2.sweeps))
    np.testing.assert_array_equal(t2.accepted.numpy(),
                                  np.asarray(j2.accepted))


@pytest.mark.parametrize("engine", ["torch", "dense", "zsorted"])
def test_call_split_invariance(engine):
    """Seeds and offsets fold the ABSOLUTE sweep counter and the state is
    kept in real units, so 8 sweeps in one call equal 4 + 4 bitwise (for
    zsorted: splits at multiples of the sort cadence, set to 4 here)."""
    cfg = TConfig.for_n(32)
    state, w = init_ensemble_state(cfg, seed_words(5), 2, device="cpu")
    run = {"torch": lambda st, k: tsam.run_sweeps(st, w, cfg, cfg.proposal_a,
                                                  k, collect_trace=False,
                                                  seed=3)[0],
           "dense": lambda st, k: ten.ensemble_sweeps_dense(
               st, w, cfg, cfg.proposal_a, k, seed=3)[0],
           "zsorted": lambda st, k: ten.ensemble_sweeps_zsorted(
               st, w, cfg, cfg.proposal_a, k, seed=3,
               sweeps_per_sort=4)[0]}[engine]
    one = run(state, 8)
    two = run(run(state, 4), 4)
    assert torch.equal(one.r, two.r) and torch.equal(one.energy, two.energy)
    assert torch.equal(one.accepted, two.accepted)
    assert int(one.sweeps[0]) == 8


def test_dense_and_zsorted_engines_match_plain_draws():
    """The plain engine makes the kernel's own Philox draws: in float32
    the dense engine's kernel path (its plain version on CPU) follows the
    same chain; zsorted visits rows in z order, so only its bookkeeping
    matches."""
    cfg = TConfig.for_n(32)
    state, w = init_ensemble_state(cfg, seed_words(4), 3, device="cpu")
    p, ptr = ten.ensemble_sweeps(state, w, cfg, cfg.proposal_a, 3,
                                 collect_trace=True, stream_seed=9)
    d, dtr = ten.ensemble_sweeps_dense(state, w, cfg, cfg.proposal_a, 3,
                                       seed=9)
    assert torch.equal(ptr.accepted.to(torch.int32), dtr.accepted)
    np.testing.assert_allclose(p.r.numpy(), d.r.numpy(), atol=1e-4)
    z, ztr = ten.ensemble_sweeps_zsorted(state, w, cfg, cfg.proposal_a, 3,
                                         seed=9)
    assert ztr.energy.shape == (3, 3) and int(z.sweeps[0]) == 3


def test_zsorted_preserves_particle_identity():
    """With a vanishing mobility no particle moves: the zsorted engine must
    hand positions back in ORIGINAL particle order (as
    tests/test_pallas.py pins for tpu_smc)."""
    cfg = TConfig(n=24, box_l=10.0, box_lz=60.0)
    rng = np.random.default_rng(3)
    r0 = np.stack([rng.uniform(-4, 4, 24), rng.uniform(-4, 4, 24),
                   rng.uniform(-25, 25, 24)], axis=1)
    assert not np.all(np.diff(r0[:, 2]) >= 0)
    state, w = init_ensemble_state(cfg, seed_words(6), 3, r0=r0,
                                   device="cpu")
    st2, _ = ten.ensemble_sweeps_zsorted(state, w, cfg, 1e-18, 2, seed=7)
    np.testing.assert_allclose(st2.r.numpy(), state.r.numpy(), atol=1e-5)


def test_gather_observables_match_jax():
    """Voxel density/mobility, the CNA histograms (bonded-pair matmuls)
    and the ACF statistics against tpu_smc.observables."""
    jc = JConfig.for_n(108, dtype="float64")
    tc = TConfig.for_n(108, dtype="float64")
    rng = np.random.default_rng(8)
    # a compact blob so that pairs bond within lca_cutoff
    r = rng.uniform(-3.0, 3.0, (3, 108, 3))
    r[1, :, :2] += 14.0    # straddles the periodic x/y edge
    rbin = rng.integers(0, jc.n_voxels, (3, 108))
    dens = rng.integers(0, 5, (3, jc.n_voxels)).astype(np.uint32)
    mob = rng.integers(0, 5, (3, jc.n_voxels)).astype(np.uint32)
    jv = jax.vmap(lambda a, b, c_, d: jobs.density_mobility_update(
        a, b, c_, d, jc))(jnp.asarray(r), jnp.asarray(rbin, jnp.int32),
                          jnp.asarray(dens), jnp.asarray(mob))
    tv = tobs.density_mobility_update(
        torch.as_tensor(r), torch.as_tensor(rbin),
        torch.as_tensor(dens.astype(np.int64)),
        torch.as_tensor(mob.astype(np.int64)), tc)
    for a, b in zip(jv, tv):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy())
    jl = [jobs.cluster_histograms(jobs.cluster_analysis(jnp.asarray(ri), jc))
          for ri in r]
    tl = tobs.cluster_histograms_chains(torch.as_tensor(r), tc)
    assert int(tl[0].min()) > 0
    for k in range(3):
        np.testing.assert_array_equal(
            np.stack([np.asarray(x[k]) for x in jl]), tl[k].numpy())
    one = tobs.cluster_histograms(tobs.cluster_analysis(torch.as_tensor(r[0]),
                                                        tc))
    for k in range(3):
        np.testing.assert_array_equal(np.asarray(jl[0][k]), one[k].numpy())
    trace = np.cumsum(rng.normal(size=301))
    for mode in ("reference", "circular", "unbiased"):
        np.testing.assert_allclose(tobs.autocorrelation(trace, 40, mode),
                                   jobs.autocorrelation(trace, 40, mode),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tobs.autocorrelation_direct(trace, 20),
        np.asarray(jobs.autocorrelation_direct(jnp.asarray(trace), 20)),
        rtol=1e-10, atol=1e-12)
    assert tobs.tau_int(trace) == pytest.approx(jobs.tau_int(trace), 1e-12)
    assert tobs.variance_strided(trace, 3.7) == pytest.approx(
        float(jobs.variance_strided(jnp.asarray(trace), 3.7)), 1e-12)
    np.testing.assert_allclose(tobs.trace_mean_var(trace),
                               [float(v) for v in
                                jobs.trace_mean_var(jnp.asarray(trace))],
                               rtol=1e-12)


def test_window_split_invariance_driver():
    """The storage window is an I/O cadence, not part of the chain: the
    driver gives identical trajectories and traces for storage_time 2 and
    6, with the energy resync keyed to absolute chain time."""
    params = RunParams(eqsteps=2, maxsteps=12, numdata=6)
    outs = []
    for st in (2, 6):
        cfg = TConfig.for_n(32, storage_time=st, recompute_every=2)
        state, w = init_ensemble_state(cfg, seed_words(7), 2, device="cpu")
        state, agg = simulate_ensemble(
            cfg, params, state, w,
            opts=ObservableOptions(sampler="dense", stream_seed=1))
        outs.append((state.r, np.stack([c.energy_trace for c in agg.chains])))
    assert torch.equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_cli_writes_jax_file_set_and_headers(tmp_path, capsys):
    """The port's CLI writes the file names and CSV headers that
    tpu_smc.io's writers produce for the same configuration, and a second
    run in the same data dir warm-starts from last_state."""
    n, chains, lapse = 32, 2, 4
    argv = ["4", "16", "4", "1.1", "--n", str(n), "--chains", str(chains),
            "--device", "cpu", "--sampler", "torch", "--seed", "3",
            "--data-dir", str(tmp_path / "port"), "--lca-time", "2"]
    assert tcli.main(argv) == 0
    assert "Initializing system" in capsys.readouterr().out
    jc = JConfig.for_n(n)
    d = jio.run_dir(jc, tmp_path / "jax")
    from tpu_smc.system import build_walls
    _, x0, ym = build_walls(jc)
    jio.write_wall_csv(d, jc, x0, ym)
    g = 4
    res = type("R", (), dict(
        energy_trace_full=np.zeros(g * lapse + 1), pressure_trace=np.zeros(g),
        accept_trace=np.zeros(g * lapse), mean_energy=0.0, std_energy=0.0,
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
    jio.write_info_csv(d, jc, RunParams(4, 16, 4), res)
    jio.write_last_state(d, jc, np.zeros((n, 3)))
    port = tmp_path / "port" / jc.run_name()
    assert sorted(p.name for p in port.iterdir()) == \
        sorted(p.name for p in d.iterdir())
    for p in d.iterdir():
        q = port / p.name
        if p.name.startswith("last_state"):
            assert len(q.read_text().split(",")) == 3 * n + 1
        elif p.name.startswith("info"):
            assert [ln.split(":")[0] for ln in q.read_text().splitlines()] \
                == [ln.split(":")[0] for ln in p.read_text().splitlines()]
        else:
            assert q.read_text().splitlines()[0] == \
                p.read_text().splitlines()[0], p.name
    assert (port / f"wall_{jc.file_key()}.csv").read_text() == \
        (d / f"wall_{jc.file_key()}.csv").read_text()
    rows = (port / f"positions_{jc.file_key()}_rank0.csv").read_text() \
        .splitlines()
    assert len(rows) == 1 + 2 and rows[1].count(",") == 3 * n
    assert tcli.main(argv) == 0
    assert "Using previously saved particle configuration" in \
        capsys.readouterr().out
