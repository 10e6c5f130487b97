"""Umbrella sampling in tpu_smc_torch against tpu_smc in float64: the
biased sweep move for move under tpu_smc's own draws, a zero spring
bitwise the unbiased sweep, the window exchange (REUS) under injected
uniforms, the MBAR-unbiased PMF and pmf_from_profile on the same
samples, the CSV byte for byte, and the CLI's umbrella branch with its
refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_smc.potentials as jpot
import tpu_smc.reweight as jrw
import tpu_smc.sampler as jsam
import tpu_smc.umbrella as jum
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc.system import build_walls, fcc_lattice
from tpu_smc_torch import reweight as trw
from tpu_smc_torch import sampler as tsam
from tpu_smc_torch import umbrella as tum
from tpu_smc_torch.config import SMCConfig as TConfig
from tpu_smc_torch.state import init_ensemble_state, seed_words

torch.set_num_threads(1)

N = 32
TAG = 5


def _cfgs():
    return (JConfig.for_n(N, dtype="float64"),
            TConfig.for_n(N, dtype="float64"))


def _draws(keys, cfg, a):
    """The noise and uniforms tpu_smc.sampler.sweep derives per key."""
    def one(k):
        _, kn, ku, _ = jax.random.split(k, 4)
        noise = jnp.sqrt(2.0 * jnp.asarray(a, jnp.float64)) * \
            jax.random.normal(kn, (cfg.n, 3), jnp.float64)
        return noise, jax.random.uniform(ku, (cfg.n,), jnp.float64)

    noise, unif = jax.vmap(one)(keys)
    return np.asarray(noise), np.asarray(unif)


@pytest.mark.parametrize("offset", [0, 17])
def test_biased_sweep_move_for_move_float64(offset):
    jc, tc = _cfgs()
    w = build_walls(jc)[0]
    rng = np.random.default_rng(1)
    c = 4
    r = fcc_lattice(jc)[None] + rng.normal(0.0, 0.3, (c, N, 3))
    # window centers around the tagged particle: the bias decides moves
    z0 = r[:, TAG, 2] + np.array([-1.5, -0.4, 0.4, 1.5])
    k_spring, a = 6.0, jc.proposal_a
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(9), i))(
        jnp.arange(c))
    wj = jnp.asarray(w)
    e0 = jax.vmap(lambda x: jpot.total_energy(x, wj, jc))(jnp.asarray(r))
    noise, unif = _draws(keys, jc, a)
    args = (torch.as_tensor(r), torch.as_tensor(np.array(e0)),
            torch.as_tensor(w), tc, a, torch.as_tensor(noise),
            torch.as_tensor(unif), offset)
    for spring in (k_spring, 30.0):
        rj, ej, _, accj = jax.vmap(
            lambda x, e, k, z: jsam.sweep(x, e, k, wj, jc, a,
                                          offset=jnp.int32(offset),
                                          umbrella=(TAG, spring, z)))(
            jnp.asarray(r), e0, keys, jnp.asarray(z0))
        rt, et, acct = tsam.sweep(*args, umbrella=(TAG, spring,
                                                   torch.as_tensor(z0)))
        np.testing.assert_array_equal(acct.numpy(), np.asarray(accj))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-10,
                                   atol=1e-10)
    # the bias decided a move: the stiff spring's tagged z differ from
    # the unbiased sweep's on some chain
    r_free, _, _ = tsam.sweep(*args)
    assert not torch.equal(r_free[:, TAG], rt[:, TAG])


@pytest.mark.parametrize("umbrella", [False, True])
def test_sweep_order_form_is_bitwise_the_offset_form(umbrella):
    """The graph-capturable form (visiting order as a tensor, index ops)
    gives the offset form's sweep bitwise."""
    tc = TConfig.for_n(N)
    st, w = init_ensemble_state(tc, seed_words(6), 3, device="cpu")
    rng = np.random.default_rng(6)
    r = st.r + torch.as_tensor(rng.normal(0.0, 0.4, st.r.shape),
                               dtype=st.r.dtype)
    noise = torch.as_tensor(rng.normal(0.0, 1.0, (3, N, 3)),
                            dtype=st.r.dtype)
    unif = torch.as_tensor(rng.random((3, N)), dtype=st.r.dtype)
    bias = (TAG, 5.0, r[:, TAG, 2] + torch.tensor([-1.0, 0.0, 1.0])) \
        if umbrella else None
    off = 11
    a = tsam.sweep(r, st.energy, w, tc, tc.proposal_a, noise, unif, off,
                   umbrella=bias)
    b = tsam.sweep(r, st.energy, w, tc, tc.proposal_a, noise, unif, 0,
                   umbrella=bias, order=(torch.arange(N) + off) % N)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_zero_spring_is_bitwise_the_unbiased_sweep():
    from tpu_smc_torch.ensemble import ensemble_sweeps

    tc = TConfig.for_n(N)
    st, w = init_ensemble_state(tc, seed_words(4), 3, device="cpu")
    z0 = torch.tensor([-5.0, 0.0, 5.0])
    plain, tp = ensemble_sweeps(st, w, tc, tc.proposal_a, 3,
                                collect_trace=True, stream_seed=4)
    zero, tz = ensemble_sweeps(st, w, tc, tc.proposal_a, 3,
                               collect_trace=True, stream_seed=4,
                               umbrella=(TAG, 0.0, z0))
    for f in ("r", "energy", "accepted"):
        assert torch.equal(getattr(plain, f), getattr(zero, f)), f
    assert torch.equal(tp.energy, tz.energy)


@pytest.mark.parametrize("parity", [0, 1])
def test_exchange_windows_step_matches_jax(parity):
    """Slots keep their bias, configurations (r, E, rbin) travel; the
    accepted and attempted counts per adjacent pair; the same uniforms
    in both packages."""
    jc, tc = _cfgs()
    n_w, reps = 5, 6
    c = n_w * reps
    rng = np.random.default_rng(2 + parity)
    centers = np.linspace(-8.0, 8.0, n_w)
    r = rng.normal(0.0, 3.0, (c, N, 3))
    r[:, TAG, 2] = np.repeat(centers, reps) + rng.normal(0.0, 4.0, c)
    e = rng.normal(0.0, 1.0, c)
    rbin = rng.integers(0, 100, (c, N))
    key = jax.random.key(7 + parity)
    u = np.asarray(jax.random.uniform(key, (n_w, reps)))
    from tpu_smc.state import ChainState as JState

    js = JState(r=jnp.asarray(r), energy=jnp.asarray(e),
                key=jax.vmap(jax.random.key)(jnp.arange(c)),
                sweeps=jnp.zeros(c, jnp.int32),
                accepted=jnp.zeros(c, jnp.int32), rbin=jnp.asarray(rbin),
                density=jnp.zeros((c, 4), jnp.uint32),
                mobility=jnp.zeros((c, 4), jnp.uint32))
    jn, jacc, jatt = jum.exchange_windows_step(
        js, jnp.asarray(centers), 4.0, TAG, 1.0 / 1.1, reps, key, parity)
    ts, _ = init_ensemble_state(tc, seed_words(1), c, device="cpu")
    ts = ts.replace(r=torch.as_tensor(r), energy=torch.as_tensor(e),
                    rbin=torch.as_tensor(rbin))
    tn, tacc, tatt = tum.exchange_windows_step(
        ts, torch.as_tensor(centers), 4.0, TAG, 1.0 / 1.1, reps, None,
        parity, uniforms=torch.as_tensor(u))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(tatt.numpy(), np.asarray(jatt))
    assert int(tacc.sum()) > 0
    np.testing.assert_array_equal(tn.r.numpy(), np.asarray(jn.r))
    np.testing.assert_array_equal(tn.energy.numpy(), np.asarray(jn.energy))
    np.testing.assert_array_equal(tn.rbin.numpy(), np.asarray(jn.rbin))
    # the port's own stream: uniforms in (0, 1), fixed by the key
    uu = tum.exchange_uniforms(torch.tensor([3, 4]), n_w, reps, "cpu",
                               torch.float64)
    assert bool(((uu > 0) & (uu < 1)).all())
    assert torch.equal(uu, tum.exchange_uniforms(torch.tensor([3, 4]), n_w,
                                                 reps, "cpu", torch.float64))


def _samples(seed=0, g=200, n_w=5, reps=4):
    """Window samples of a known F(z) = 0.3 z: Gaussian windows of the
    biased density, centers -4..4, spring 2, T = 1."""
    rng = np.random.default_rng(seed)
    centers = np.linspace(-4.0, 4.0, n_w)
    k, t = 2.0, 1.0
    mean = centers - 0.3 / k           # F' = 0.3 shifts each window
    z = mean[None, :, None] + rng.normal(0.0, np.sqrt(t / k),
                                         (g, n_w, reps))
    acc = np.full(n_w, 0.9)
    common = dict(centers=centers, k_spring=k, tag=0, temperature=t,
                  z_samples=z, acceptance=acc)
    return jum.UmbrellaResults(**common), tum.UmbrellaResults(**common)


@pytest.mark.parametrize("z_range", [None, (-5.0, 5.0)])
def test_umbrella_pmf_matches_jax(z_range):
    """The same samples through both packages' MBAR (float32 in each):
    PMF, bootstrap errors and window free energies within 1e-4; the
    recovered F(z) has the known slope."""
    jr, tr = _samples()
    ju = jum.umbrella_pmf(jr, n_bins=16, z_range=z_range, n_boot=4, seed=1)
    tu = tum.umbrella_pmf(tr, n_bins=16, z_range=z_range, n_boot=4, seed=1)
    np.testing.assert_allclose(tu.z_grid, ju.z_grid, rtol=1e-12)
    for name in ("pmf", "err_pmf", "window_f"):
        np.testing.assert_allclose(getattr(tu, name), getattr(ju, name),
                                   rtol=0, atol=1e-4, equal_nan=True,
                                   err_msg=name)
    ok = np.isfinite(tu.pmf) & (np.abs(tu.z_grid) < 3.5)
    slope = np.polyfit(tu.z_grid[ok], tu.pmf[ok], 1)[0]
    assert abs(slope - 0.3) < 0.05
    # the CSV, byte for byte on the same arrays
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        jp = jum.write_umbrella_csv(d, JConfig.for_n(N), ju)
        text_j = jp.read_bytes()
        tp = tum.write_umbrella_csv(d, TConfig.for_n(N), tu._replace(
            pmf=ju.pmf, err_pmf=ju.err_pmf, window_f=ju.window_f))
        assert tp.read_bytes() == text_j


def test_pmf_from_profile_and_centers_match_jax():
    rng = np.random.default_rng(5)
    temps = np.array([1.0, 1.3])
    field = rng.random((2, 12))
    field[0, 3] = 0.0
    err = 0.1 * rng.random((2, 12))
    for e in (None, err):
        a = trw.pmf_from_profile(temps, field, e)
        b = jrw.pmf_from_profile(temps, field, e)
        np.testing.assert_array_equal(a[0], b[0])
        if e is not None:
            np.testing.assert_array_equal(a[1], b[1])
    with pytest.raises(ValueError):
        trw.pmf_from_profile(temps, np.zeros((2, 3)))
    for spec in ("-99:-92:8", "1.5,2,3"):
        np.testing.assert_array_equal(tum.parse_centers(spec),
                                      jum.parse_centers(spec))
    for bad in ("1:2", "2:1:4", "0:1:1"):
        with pytest.raises(ValueError):
            tum.parse_centers(bad)


def test_simulate_umbrella_windows_pull_the_tagged_particle():
    """Plain-engine windows: the tagged z follows its window, the
    acceptances lie in (0, 1] and the swap acceptances in [0, 1]; with
    REUS one z sample per cycle."""
    from tpu_smc_torch.config import RunParams

    tc = TConfig.for_n(N)
    centers = [-50.0, -45.0, -40.0]
    _, res = tum.simulate_umbrella(tc, RunParams(6, 12, 3), centers,
                                   seed_words(3), k_spring=8.0, tag=TAG,
                                   replicas=2, exchange_interval=3,
                                   device="cpu", stream_seed=3)
    assert res.z_samples.shape == (4, 3, 2)
    assert bool(((res.acceptance > 0) & (res.acceptance <= 1)).all())
    assert bool(((res.swap_acceptance >= 0)
                 & (res.swap_acceptance <= 1)).all())
    assert np.all(np.diff(res.z_samples[-1].mean(axis=1)) > 0)
    with pytest.raises(ValueError):
        tum.simulate_umbrella(tc, RunParams(1, 1, 1), [-70.0, 0.0],
                              seed_words(3), device="cpu")


def test_cli_umbrella_branch(tmp_path, capsys):
    from tpu_smc_torch import cli

    base = ["4", "8", "4", "1.1", "--n", str(N), "--device", "cpu",
            "--seed", "3", "--data-dir", str(tmp_path)]
    assert cli.main(base + ["--umbrella=-55:-45:3", "--umbrella-replicas",
                            "2", "--umbrella-exchange", "2",
                            "--umbrella-bins", "6", "--umbrella-tag",
                            "4"]) == 0
    out = capsys.readouterr().out
    assert "Ensemble sweep engine: torch (plain engine, umbrella bias)" in out
    assert "Window-exchange swap acceptance (REUS, every 2 sweeps)" in out
    assert "PMF resolved over" in out
    cfg = TConfig.for_n(N)
    lines = (tmp_path / cfg.run_name()
             / f"umbrella_pmf_{cfg.file_key()}.csv").read_text().splitlines()
    assert lines[0] == "z, F, err" and len(lines) == 1 + 6 + 1 + 3
    assert lines[7] == "# window, z0, f, acceptance"
    for extra, msg in ((["--sampler", "dense"], "plain engine"),
                       (["--sampler", "zsorted"], "plain engine"),
                       (["--temperatures", "1.0,1.2"], "separate run modes"),
                       (["--chains", "4"], "drop --chains"),
                       (["--bulk"], "walls"),
                       (["--target-acceptance", "0.5"], "target-acceptance")):
        with pytest.raises(SystemExit, match=msg):
            cli.main(base + ["--umbrella=-55:-45:3"] + extra)
    with pytest.raises(SystemExit, match="umbrella"):
        cli.main(base + ["--umbrella=1:2"])
