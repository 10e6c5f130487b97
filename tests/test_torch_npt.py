"""Constant-pressure MC in tpu_smc_torch against tpu_smc.npt: the
per-chain box in the pair energy, force and virial, volume_move and
npt_sweep move for move under tpu_smc's draws (float64), the frozen
volume bitwise the port's plain-engine bulk NVT run, the volume floor,
bitwise resume, MBAR over pressure and over (T, P), the CSV writers
byte for byte, and the CLI's --npt and --npt-grid runs on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_smc import npt as jn
from tpu_smc import potentials as jp
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc_torch import npt as tn
from tpu_smc_torch import potentials as tp
from tpu_smc_torch.config import SMCConfig as TConfig
from tpu_smc_torch.state import npt_state_from_jax

torch.set_num_threads(1)


def _cfgs(**kw):
    kw = {**dict(n=16, temperature=2.0, rho=0.25, gamma=0.02,
                 lj_cutoff=1.8, lj_shift=True, dtype="float64"), **kw}
    return JConfig.bulk(**kw), TConfig.bulk(**kw)


def _positions(cfg, c, seed):
    from tpu_smc.gcmc import cubic_grid

    rng = np.random.default_rng(seed)
    return cubic_grid(cfg, cfg.n)[None] + rng.normal(0.0, 0.3,
                                                     (c, cfg.n, 3))


def test_box_override_energy_force_virial_match_jax():
    jc, tc = _cfgs()
    r = _positions(jc, 3, 0)
    box = np.array([0.9, 1.0, 1.07]) * jc.box_l
    rt, bt = torch.as_tensor(r), torch.as_tensor(box)
    e_t = tp.pair_energy_total(rt, tc, box=bt).numpy()
    p_t = tp.pair_virial_pressure(rt, tc, box=bt).numpy()
    u_t, f_t = tp.pair_energy_force_single(rt, 3, rt[:, 3], tc, box=bt)
    for c in range(3):
        rj, bj = jnp.asarray(r[c]), jnp.asarray(box[c])
        np.testing.assert_allclose(
            e_t[c], float(jp.pair_energy_total(rj, jc, box=bj)),
            rtol=1e-10)
        np.testing.assert_allclose(
            p_t[c], float(jp.pair_virial_pressure(rj, jc, box=bj)),
            rtol=1e-10)
        u, f = jp.pair_energy_force_single(rj, 3, rj[3], jc, box=bj)
        np.testing.assert_allclose(u_t[c].item(), float(u), rtol=1e-10)
        np.testing.assert_allclose(f_t[c].numpy(), np.asarray(f),
                                   rtol=1e-10, atol=1e-12)


def _sweep_draws(key, vkey, cfg, a, n):
    """npt_sweep's draws: sampler.sweep's key split (tpu_smc/sampler.py:
    125-145) and volume_move's vkey split (tpu_smc/npt.py:100-111)."""
    dtype = cfg.jnp_dtype
    _, k_noise, k_unif, k_off = jax.random.split(key, 4)
    noise = jnp.sqrt(2.0 * jnp.asarray(a, dtype)) * jax.random.normal(
        k_noise, (n, 3), dtype)
    unif = jax.random.uniform(k_unif, (n,), dtype)
    off = jax.random.randint(k_off, (), 0, n)
    _, k_step, k_acc = jax.random.split(vkey, 3)
    return (noise, unif, off, jax.random.uniform(k_step, (), dtype),
            jax.random.uniform(k_acc, (), dtype))


_jdraws = jax.jit(_sweep_draws, static_argnames=("cfg", "n"))
_jsweep = jax.jit(jn.npt_sweep, static_argnames=("cfg",))


def _arrays(st):
    out = {f: np.asarray(getattr(st, f))[None] for f in st._fields
           if f not in ("key", "vkey")}
    out["key"] = np.asarray(jax.random.key_data(st.key))[None]
    return out


def test_npt_sweep_move_for_move():
    """Four NPT sweeps per chain at P = 0.7, dlnV 0.3 from the same state
    and tpu_smc's draws: positions, box and energy within 1e-10,
    counters equal; volume moves are both accepted and rejected."""
    jc, tc = _cfgs()
    a, p, dlnv = jc.proposal_a, 0.7, 0.3
    vacc = []
    for c in range(2):
        st = jn.init_npt_state(jc, jax.random.key(30 + c))
        ts = npt_state_from_jax(_arrays(st), tc, device="cpu")
        for _ in range(4):
            noise, unif, off, us, ua = _jdraws(st.key, st.vkey, jc, a, jc.n)
            st = _jsweep(st, jc, p, a, dlnv)
            t = lambda v: torch.as_tensor(np.array(v))[None]
            ts = tn.npt_sweep(ts, tc, p, a, dlnv, draws=(
                t(noise), t(unif), int(off),
                t(us), t(ua)))
            np.testing.assert_allclose(ts.r[0].numpy(), np.asarray(st.r),
                                       rtol=0, atol=1e-10)
            np.testing.assert_allclose(ts.l[0].item(), float(st.l),
                                       rtol=1e-12)
            np.testing.assert_allclose(ts.energy[0].item(),
                                       float(st.energy), rtol=1e-10)
            for f in ("accepted", "vol_acc", "vol_att"):
                assert int(getattr(ts, f)[0]) == int(getattr(st, f)), f
        vacc.append(int(st.vol_acc))
    assert 0 < sum(vacc) < 8


def test_volume_move_injected_energy():
    """volume_move with an injected pair_u (U = 0, the ideal-gas limit's
    hook) against tpu_smc's at the same uniforms, and the hard floor as a
    rejection: a move below 2 rc keeps the old box even at log_ap > 0."""
    jc, tc = _cfgs(n=8, rho=0.1, lj_cutoff=0.5)
    r = _positions(jc, 1, 2)[0]
    zero_j = lambda rr, box: jnp.zeros((), jc.jnp_dtype)
    for seed in range(4):
        out_j = jn.volume_move(jnp.asarray(r), jnp.asarray(jc.box_l),
                               jnp.asarray(1.5), jax.random.key(seed), jc,
                               jnp.asarray(0.7), jnp.asarray(0.4),
                               pair_u=zero_j)
        vk = jax.random.split(jax.random.key(seed), 3)
        us = float(jax.random.uniform(vk[1], (), jc.jnp_dtype))
        ua = float(jax.random.uniform(vk[2], (), jc.jnp_dtype))
        f64 = lambda v: torch.tensor([v], dtype=torch.float64)
        out_t = tn.volume_move(
            torch.as_tensor(r)[None], f64(jc.box_l), f64(1.5), tc, 0.7, 0.4,
            f64(us), f64(ua), pair_u=lambda rr, box: torch.zeros_like(box))
        np.testing.assert_allclose(out_t[0][0].numpy(), np.asarray(out_j[0]),
                                   rtol=1e-12)
        assert out_t[1][0].item() == pytest.approx(float(out_j[1]),
                                                   rel=1e-12)
        assert bool(out_t[3][0]) == bool(out_j[4])
    # floor: a box shrinking below 2 rc is rejected, not clamped
    jc2, tc2 = _cfgs(n=8, rho=0.1, lj_cutoff=2.0)
    l0 = 2.0 * tc2.lj_cutoff * 1.01
    out = tn.volume_move(torch.zeros(1, 8, 3, dtype=torch.float64),
                         f64(l0), f64(0.0), tc2, 50.0, 0.3, f64(1e-6),
                         f64(1e-6), pair_u=lambda rr, box: torch.zeros_like(box))
    assert not bool(out[3][0]) and out[1][0].item() == l0


def test_frozen_volume_bitwise_nvt():
    """dlnv = 0: every volume move is the identity (scale exactly 1.0),
    so the positions are bitwise the port's plain-engine bulk NVT run of
    the same seed (float32, as tpu_smc's pin)."""
    from tpu_smc_torch.ensemble import ensemble_sweeps
    from tpu_smc_torch.gcmc import batch_state
    from tpu_smc_torch.state import init_ensemble_state

    tc = TConfig.bulk(n=32, temperature=0.9, rho=0.3, gamma=0.02,
                      lj_cutoff=1.8, lj_shift=True)
    key = torch.tensor([0, 7])
    st = batch_state(tn.init_npt_state(tc, key, device="cpu"), 3)
    nvt, w = init_ensemble_state(tc, key, 3, r0=tn.cubic_grid(tc, tc.n),
                                 device="cpu")
    assert torch.equal(nvt.r, st.r) and torch.equal(nvt.key, st.key)
    nvt, _ = ensemble_sweeps(nvt, w, tc, tc.proposal_a, 25, stream_seed=11)
    st, _ = tn.npt_block(st, tc, 1.0, tc.proposal_a, 0.0, 25, seed=11)
    assert torch.equal(st.r, nvt.r)
    assert torch.equal(st.l, torch.full((3,), tc.box_l,
                                        dtype=torch.float32))
    assert st.vol_acc.tolist() == st.vol_att.tolist() == [25] * 3
    assert torch.equal(st.accepted, nvt.accepted)


def test_floor_and_resume_bitwise(tmp_path):
    """A crushing pressure presses the box onto V = (2 rc)^3 and never
    through it; 20 + 20 sweeps, a checkpoint and 20 more are bitwise
    the unbroken 20 + 40 (tracked energy included)."""
    _, tc = _cfgs(n=8, rho=0.15, lj_cutoff=1.6)
    kw = dict(n_chains=3, dlnv=0.3, chunk=25, seed=2, device="cpu")
    key = torch.tensor([0, 2])
    st_a, res = tn.simulate_npt(tc, 50.0, 20, 40, key, **kw)
    floor = (2.0 * tc.lj_cutoff) ** 3
    assert res.volume_trace.min() >= floor * (1 - 1e-12)
    assert res.volume_trace.min() <= floor * 1.35
    assert res.resync_drift < 1e-9 and 0 < res.vol_acceptance <= 1
    st_b, _ = tn.simulate_npt(tc, 50.0, 20, 20, key, **kw)
    p = tn.save_npt_checkpoint(tmp_path / "ck", st_b, tc, stream_seed=2)
    st_l, cfg_l, seed = tn.load_npt_checkpoint(p, device="cpu")
    st_c, _ = tn.simulate_npt(cfg_l, 50.0, 0, 20, None, state0=st_l,
                              **{**kw, "seed": seed})
    for f in ("r", "l", "energy"):
        assert torch.equal(getattr(st_a, f), getattr(st_c, f)), f


def _traces(seed=0):
    rng = np.random.default_rng(seed)
    ps = np.repeat([0.5, 0.9, 1.4], 2)
    v = 60.0 / ps[None, :] + rng.normal(0, 4.0, (300, 6))
    e = -20.0 - 3.0 * ps[None, :] + rng.normal(0, 2.0, (300, 6))
    return e, v, ps


def test_reweight_isobars_and_tp_match_jax():
    """MBAR over P and over (T, P) on the same traces; both packages
    solve and weigh in float32 (tpu_smc/npt.py:480-486) with their own
    logsumexp, and the enthalpy and kappa_T are float32 differences, so
    they agree to 1e-4 relative."""
    e, v, ps = _traces()
    grid = [0.5, 0.7, 1.1, 1.4, 3.0]
    a = tn.reweight_isobars(e, v, ps, 2.0, grid, 16)
    b = jn.reweight_isobars(e, v, ps, 2.0, grid, 16)
    for f in ("rho", "v_mean", "kappa_t", "enthalpy", "ess", "f_k"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                   rtol=1e-4, atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(a.p_k, b.p_k)
    temps = np.repeat([1.6, 2.4], 3)
    targets = [(1.6, 0.5), (2.0, 0.8), (2.4, 1.4)]
    ta = tn.reweight_tp(e, v, temps, ps, targets, 16)
    tb = jn.reweight_tp(e, v, temps, ps, targets, 16)
    for i, (x, y) in enumerate(zip(ta, tb)):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-6,
                                   err_msg=str(i))


def test_state_from_jax_and_csv_byte_identical(tmp_path):
    jc, tc = _cfgs()
    st = jn.init_npt_state(jc, jax.random.key(5))
    ts = npt_state_from_jax(_arrays(st), tc, device="cpu")
    np.testing.assert_array_equal(ts.r[0].numpy(), np.asarray(st.r))
    assert ts.l[0].item() == float(st.l)
    _, res = tn.simulate_npt(tc, 0.7, 3, 8, torch.tensor([0, 5]),
                             n_chains=2, gr_bins=6, seed=5, device="cpu")
    assert res.gr.shape == (6,)
    e, v, ps = _traces(1)
    rw = tn.reweight_isobars(e, v, ps, 2.0, [0.5, 1.0], 16)
    for sub in ("t", "j"):
        (tmp_path / sub).mkdir()
    pairs = [(tn.write_npt_csv(tmp_path / "t", tc, 0.7, res),
              jn.write_npt_csv(tmp_path / "j", jc, 0.7, res)),
             (tn.write_npt_reweight_csv(tmp_path / "t", tc, rw),
              jn.write_npt_reweight_csv(tmp_path / "j", jc, rw))]
    names = {p.name for p in (tmp_path / "t").iterdir()}
    assert names == {p.name for p in (tmp_path / "j").iterdir()}
    assert len(names) == 3                  # npt, npt_gr, npt_reweight
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    assert all(a.name == b.name for a, b in pairs)


def _cli(tmp_path, *argv):
    import contextlib
    import io

    from tpu_smc_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv) + ["--device", "cpu", "--data-dir",
                                    str(tmp_path / "Data")])
    assert rc == 0
    return buf.getvalue()


def test_cli_npt_resume_and_isobars(tmp_path):
    common = ["2.0", "--npt", "0.7", "--n", "12", "--rho", "0.25",
              "--gamma", "0.02", "--chains", "2", "--seed", "5",
              "--gr-bins", "6"]
    out = _cli(tmp_path, "4", "10", "5", *common, "--checkpoint",
               str(tmp_path / "ck.npz"))
    assert "Constant-pressure results" in out and "--bulk implied" in out
    d = next((tmp_path / "Data").iterdir())
    rows = np.genfromtxt(next(d.glob("npt_N12_*.csv")), delimiter=",",
                         skip_header=2)
    assert rows.shape == (10, 4) and np.isfinite(rows).all()
    assert len(list(d.glob("npt_gr_N12_*.csv"))) == 1
    out = _cli(tmp_path, "0", "6", "3", *common, "--resume",
               str(tmp_path / "ck.npz"))
    assert "Resuming NPT" in out
    out = _cli(tmp_path, "4", "10", "5", "2.0", "--npt-grid", "0.3:2.5:3",
               "--n", "12", "--rho", "0.25", "--gamma", "0.02", "--chains",
               "2", "--seed", "9", "--npt-reweight", "0.3:2.5:5")
    assert "Equation of state" in out and "MBAR over the pressure axis" in out
    iso = np.genfromtxt(next((tmp_path / "Data").glob(
        "*/npt_isobar_*.csv")), delimiter=",", skip_header=1)
    rw = np.genfromtxt(next((tmp_path / "Data").glob(
        "*/npt_reweight_*.csv")), delimiter=",", skip_header=1)
    assert iso.shape == (3, 5) and rw.shape == (5, 6)
    assert np.isfinite(rw).all()
