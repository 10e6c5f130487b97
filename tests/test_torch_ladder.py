"""Temperature ladders and quenched wall disorder in the port against
tpu_smc: the sweep with per-chain (A, T, W) move for move in float64, the
kernel's plain version in its per-chain modes, the wall ensemble and the
per-chain-wall energy, ladder statistics beside tpu_smc's XLA engine, and
the ladder CLI's CSV files."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_smc.potentials as jpot
import tpu_smc.sampler as jsam
import tpu_smc.state as jstate
import tpu_smc.system as jsys
from tpu_smc.config import RunParams
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc_torch import cli as tcli
from tpu_smc_torch import ensemble as ten
from tpu_smc_torch import sampler as tsam
from tpu_smc_torch import tsweep as tts
from tpu_smc_torch.config import SMCConfig as TConfig
from tpu_smc_torch.kernels import sweep as ks
from tpu_smc_torch.state import (init_ensemble_state, per_chain_wall_energy,
                                 seed_words)
from tpu_smc_torch.system import build_wall_ensemble

# tiny tensors: keep torch's intra-op pool from competing with the
# other test workers for cores
torch.set_num_threads(1)

N = 32
TOL = 1e-10


def _start(c, seed, n=N):
    """c chains of a jittered 4 x 4 x 2 slab of spacing 1.5 lying on the
    lower wall (float64 numpy): pair and wall terms both matter."""
    lz = TConfig.for_n(n).box_lz
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(2),
                             indexing="ij"), -1).reshape(-1, 3) * 1.5
    slab = g - [2.25, 2.25, lz / 2 - 1.6]
    rng = np.random.default_rng(seed)
    return slab[None] + rng.normal(0.0, 0.05, (c, n, 3))


def _ladder(c):
    """Per-chain temperatures of 2 levels (temperature-major) and
    mobilities that differ within a level too, float64."""
    t = np.repeat([1.0, 1.3], c // 2)
    a = t * np.linspace(0.03, 0.3, c)
    return a, t


@pytest.fixture(scope="module")
def jax_ladder_sweep():
    """One sweep of 4 chains with per-chain (A, T) and wall tables
    [w0, w1, w0, w1] through tpu_smc.sampler.sweep vmapped over (chain,
    wall, A, T) — tsweep._multi_t_sweeps' call — in float64, rows
    z-sorted per chain, with the draws its keys make."""
    c, off = 4, 9
    jc = JConfig.for_n(N, dtype="float64")
    w = jsys.build_wall_ensemble(jc, 2)[0][[0, 1, 0, 1]]
    r = _start(c, 1)
    r = np.take_along_axis(r, np.argsort(r[..., 2], axis=1)[..., None], 1)
    a, t = _ladder(c)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(5), i))(
        jnp.arange(c))

    @jax.jit
    def run(r, keys, w, a, t):
        def one(x, k, wc, ac, tt):
            e0 = jpot.total_energy(x, wc, jc)
            _, kn, ku, _ = jax.random.split(k, 4)
            draws = (jnp.sqrt(2.0 * ac) * jax.random.normal(kn, (N, 3)),
                     jax.random.uniform(ku, (N,)))
            return e0, jsam.sweep(x, e0, k, wc, jc, ac, offset=jnp.int32(off),
                                  temperature=tt), draws

        return jax.vmap(one)(r, keys, w, a, t)

    e0, (rj, ej, _, accj), (noise, unif) = run(
        jnp.asarray(r), keys, jnp.asarray(w), jnp.asarray(a), jnp.asarray(t))
    return dict(r=r, e0=np.array(e0), w=w, a=a, t=t, off=off,
                noise=np.array(noise), unif=np.array(unif),
                rj=np.asarray(rj), ej=np.asarray(ej), accj=np.asarray(accj))


def test_sweep_per_chain_at_and_walls_match_jax_float64(jax_ladder_sweep):
    """tsam.sweep with per-chain (A, T) and per-chain wall tables is
    tpu_smc.sampler.sweep move for move under the JAX keys' own noise
    and uniforms."""
    j = jax_ladder_sweep
    tc = TConfig.for_n(N, dtype="float64")
    rt, et, acct = tsam.sweep(
        torch.as_tensor(j["r"]), torch.as_tensor(j["e0"]),
        torch.as_tensor(j["w"]), tc, torch.as_tensor(j["a"]),
        torch.as_tensor(j["noise"]), torch.as_tensor(j["unif"]), j["off"],
        temperature=torch.as_tensor(j["t"]))
    np.testing.assert_array_equal(acct.numpy(), j["accj"])
    assert 0 < int(acct.min()) and int(acct.max()) < N
    np.testing.assert_allclose(rt.numpy(), j["rj"], rtol=0, atol=TOL)
    np.testing.assert_allclose(et.numpy(), j["ej"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("zskip", [False, True])
def test_plain_kernel_per_chain_matches_jax_float64(jax_ladder_sweep,
                                                    zskip):
    """sweep_block_plain with per-chain (A, T) rows and per-chain wall
    tables in float64 is tpu_smc.sampler.sweep move for move under the
    same noise, uniforms and offset: the version the kernel's per-chain
    modes are held against on the card."""
    j = jax_ladder_sweep
    tc = TConfig.for_n(N, dtype="float64")
    rt = torch.as_tensor(j["r"])
    planes = [rt[..., k].T.contiguous() for k in range(3)]   # n = N_pad
    wa, wb = (torch.as_tensor(j["w"][..., k]) for k in range(2))  # [C, MM]
    # particle-indexed noise -> move order: move nn visits (nn + off) % N
    g = torch.roll(torch.as_tensor(j["noise"]), -j["off"], dims=1) \
        .permute(1, 0, 2)
    x, y, z, e, etr, atr = ks.sweep_block_plain(
        *planes, torch.as_tensor(j["e0"])[None], wa, wb,
        torch.tensor([j["off"]]), torch.zeros((1, 2), dtype=torch.int64), tc,
        1, torch.as_tensor(j["a"]), zskip=zskip,
        draws=(g[None], torch.as_tensor(j["unif"]).T[None]),
        temperature=torch.as_tensor(j["t"]))
    np.testing.assert_array_equal(atr[0].numpy(), j["accj"])
    np.testing.assert_allclose(ks.from_planes(x, y, z, tc).numpy(), j["rj"],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(e[0].numpy(), j["ej"], rtol=TOL, atol=TOL)


def _f32_inputs(c, walls=0, seed=7):
    cfg = TConfig.for_n(N)
    w_np = (np.repeat(build_wall_ensemble(cfg, walls)[0], c // walls, axis=0)
            if walls else None)
    state, w = init_ensemble_state(cfg, seed_words(seed), c, w=w_np,
                                   device="cpu")
    state, _ = ten.ensemble_sweeps_dense(state, w, cfg, cfg.proposal_a, 1,
                                         seed=seed)
    words, offsets = ten._per_sweep_randomness(state, cfg, seed + 1, 1)
    x, y, z, e, wa, wb = ten._kernel_inputs(state, w, cfg)
    return cfg, w, (x, y, z, e), (wa, wb), (offsets, words)


@pytest.mark.parametrize("zskip", [False, True])
def test_plain_kernel_per_chain_contracts(zskip):
    """Float32, the kernel's own Philox draws: uniform (A, T) rows are
    bitwise the scalar call (the host rounds A/T, A/4T, sqrt(2A), 1/T
    once from float64), identical per-chain wall tables bitwise the
    shared row, and a [w0, w0, w1, w1] ensemble bitwise the runs with
    the shared rows w0 (chains 0, 1) and w1 (chains 2, 3)."""
    c = 4
    cfg, w, pl, rows, rnd = _f32_inputs(c)
    scalar = ks.sweep_block_plain(*pl, *rows, *rnd, cfg, 1, cfg.proposal_a,
                                  zskip=zskip)
    full = lambda v: torch.full((c,), v, dtype=torch.float64)
    uni = ks.sweep_block_plain(*pl, *rows, *rnd, cfg, 1,
                               full(cfg.proposal_a), zskip=zskip,
                               temperature=full(cfg.temperature))
    assert all(torch.equal(u, v) for u, v in zip(scalar, uni))
    sc = ks.chain_scales(cfg.proposal_a, cfg.temperature, c, "cpu")
    t = cfg.temperature
    assert torch.equal(sc[:, 0], torch.tensor(
        [cfg.proposal_a / t, cfg.proposal_a / (4 * t),
         (2 * cfg.proposal_a) ** 0.5, 1 / t], dtype=torch.float32))
    same = ks.wall_coeff_rows(w.expand(c, -1, -1), cfg)
    out = ks.sweep_block_plain(*pl, *same, *rnd, cfg, 1, cfg.proposal_a,
                               zskip=zskip)
    assert all(torch.equal(u, v) for u, v in zip(scalar, out))

    cfg, w, pl, rows, rnd = _f32_inputs(c, walls=2)
    a, t = (torch.as_tensor(v) for v in _ladder(c))
    comb = ks.sweep_block_plain(*pl, *rows, *rnd, cfg, 1, a, zskip=zskip,
                                temperature=t)
    for g in range(2):
        split = ks.sweep_block_plain(
            *pl, *ks.wall_coeff_rows(w[2 * g], cfg), *rnd, cfg, 1, a,
            zskip=zskip, temperature=t)
        for u, v in zip(comb, split):
            assert torch.equal(u[..., 2 * g:2 * g + 2],
                               v[..., 2 * g:2 * g + 2])
    assert not torch.equal(comb[0][:, :2], comb[0][:, 2:])


def test_wall_ensemble_and_per_chain_energy_match_jax():
    """build_wall_ensemble array-equal with tpu_smc (realization 0 with
    seed 42 is the reference wall), per_chain_wall_energy within 1e-10 in
    float64, and init_ensemble_state's per-chain energies."""
    jc = JConfig.for_n(N, dtype="float64")
    tc = TConfig.for_n(N, dtype="float64")
    for k, seed in ((3, 42), (2, 7)):
        for a, b in zip(jsys.build_wall_ensemble(jc, k, base_seed=seed),
                        build_wall_ensemble(tc, k, base_seed=seed)):
            np.testing.assert_array_equal(a, b)
    w_k = build_wall_ensemble(tc, 3)[0]
    np.testing.assert_array_equal(w_k[0], jsys.build_walls(jc)[0])
    w = w_k[[0, 1, 2, 1]]
    r = _start(1, 5).repeat(4, axis=0)
    je = jstate.per_chain_wall_energy(jnp.asarray(r), jnp.asarray(w), jc)
    te = per_chain_wall_energy(torch.as_tensor(r), torch.as_tensor(w), tc)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=TOL,
                               atol=TOL)
    assert len(set(np.round(te.numpy(), 6))) == 3
    st, wt = init_ensemble_state(tc, seed_words(1), 4, r0=r[0], w=w,
                                 device="cpu")
    assert tuple(wt.shape) == (4, 9, 2)
    np.testing.assert_allclose(
        st.energy.numpy(), per_chain_wall_energy(st.r, wt, tc).numpy(),
        rtol=0, atol=0)


def test_tsweep_statistics_match_jax():
    """simulate_temperature_sweep on the port's plain engine and on
    tpu_smc's XLA engine, N = 32, 2 temperatures x 384 chains from the
    same condensed slab on the lower wall, where potential energy and
    acceptance both depend on T (T = 0.6: U ~ -46, acceptance ~0.21;
    T = 1.2: U ~ -26, ~0.57), so a chain run at the wrong temperature
    fails both checks: per-T mean E within 3 combined replica error
    bars, and acceptance within 0.02. The acceptance of one such run
    spreads by at most 0.0045 (port, 8 seeds) and 0.0032 (tpu_smc, 3
    seeds) over seeds (scripts/torch_stat_spread.py), so 0.02 is 3.6
    combined standard deviations; the binomial SE (0.0008) misses the
    chain-to-chain spread of a cluster's fate."""
    temps = [0.6, 1.2]
    params = RunParams(eqsteps=10, maxsteps=30, numdata=6)
    r0 = _start(1, 7)[0]
    from tpu_smc.tsweep import simulate_temperature_sweep as jsweep

    jc = JConfig.for_n(N)
    _, jr = jsweep(jc, params, temps, jax.random.key(3), chains_per_t=384,
                   r0=r0)
    tc = TConfig.for_n(N)
    _, tr = tts.simulate_temperature_sweep(tc, params, temps, seed_words(3),
                                           chains_per_t=384, r0=r0,
                                           sampler="torch", device="cpu")
    assert tr.energy_samples.shape == jr.energy_samples.shape == (6, 2, 384)
    assert tr.pressure_samples.shape == jr.pressure_samples.shape
    se = np.hypot(tr.err_energy, jr.err_energy)
    assert (np.abs(tr.mean_energy - jr.mean_energy) < 3 * se).all(), \
        (tr.mean_energy, jr.mean_energy, se)
    np.testing.assert_allclose(tr.acceptance, jr.acceptance, atol=0.02)
    # the levels lie far apart on both measures
    u = tr.mean_energy - 1.5 * N * np.asarray(temps)
    assert u[1] - u[0] > 10 * se.max() and \
        tr.acceptance[1] - tr.acceptance[0] > 0.2, (u, tr.acceptance)
    assert np.isfinite(tr.cv).all() and (tr.cv > 0).all()


def test_ladder_cli_csv_files_match_jax(tmp_path, capsys):
    """A tiny --device cpu --sampler torch ladder CLI run with parallel
    tempering, quenched walls and MBAR writes tpu_smc's file names,
    headers and column counts (tpu_smc's writers on results of the same
    shape)."""
    import tpu_smc.io as jio
    import tpu_smc.pt as jpt
    import tpu_smc.reweight as jrw
    import tpu_smc.tsweep as jts

    temps = [1.0, 1.2]
    argv = ["2", "8", "2", "1.1", "--n", str(N), "--temperatures",
            "1.0,1.2", "--chains-per-t", "2", "--pt-exchange", "2",
            "--wall-realizations", "2", "--reweight", "1.0:1.2:3",
            "--device", "cpu", "--sampler", "torch", "--seed", "3",
            "--data-dir", str(tmp_path / "port")]
    assert tcli.main(argv) == 0
    out = capsys.readouterr().out
    assert "Quenched wall disorder ladder: 2 realizations x 1 replicas" \
        in out and "Replica-exchange swap acceptance" in out
    jc = JConfig.for_n(N)
    d = jio.run_dir(jc, tmp_path / "jax")
    _, x0, ym = jsys.build_wall_ensemble(jc, 2)
    jio.write_wall_csv(d, jc, x0, ym)
    z2 = np.zeros(2)
    ts = jts.TSweepResults(np.asarray(temps), z2, z2, z2, z2)
    jts.write_tsweep_csv(d, jc, ts)
    jpt.write_pt_csv(d, jc, jpt.PTResults(ts, z2[:1], z2[:1], z2[:1],
                                          np.zeros(1, int), 2))
    z3 = np.zeros(3)
    rw = jrw.ReweightResults(z3, z3, z3, z3, z3, z2, 1, err_energy=z3,
                             err_cv=z3, err_f=z3, pressure=z3,
                             err_pressure=z3)
    jrw.write_reweight_csv(d, jc, rw)
    jrw.write_reweight_disorder_csv(d, jc, [rw._replace(err_energy=None)] * 2)
    port = tmp_path / "port" / jc.run_name()
    assert sorted(p.name for p in port.iterdir()) == \
        sorted(p.name for p in d.iterdir())
    for p in d.iterdir():
        mine = (port / p.name).read_text().splitlines()
        theirs = p.read_text().splitlines()
        assert mine[0] == theirs[0], p.name
        assert len(mine) == len(theirs), p.name
        assert [len(ln.split(",")) for ln in mine] == \
            [len(ln.split(",")) for ln in theirs], p.name
    assert (port / f"wall_{jc.file_key()}.csv").read_text() == \
        (d / f"wall_{jc.file_key()}.csv").read_text()
