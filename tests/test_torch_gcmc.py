"""Grand-canonical MC in tpu_smc_torch against tpu_smc.gcmc in float64:
the masked energy with parked overlaps, gc_sweep move for move under the
draws re-derived from tpu_smc's key splits (slab and bulk), the batched
sweep against one chain at a time, the driver's bookkeeping and bitwise
resume, the state carried across, the CSV writer byte for byte, and the
CLI's --gcmc and --gcmc-grid runs in-process on the CPU."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_smc import gcmc as jg
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc_torch import gcmc as tg
from tpu_smc_torch.config import SMCConfig as TConfig
from tpu_smc_torch.state import gcmc_state_from_jax

torch.set_num_threads(1)

CAP, X = 24, 6


def _cfgs(kind):
    """(jax cfg, port cfg, mu) of the slab (walls) and bulk systems."""
    if kind == "slab":
        kw = dict(temperature=1.3, dtype="float64")
        jc = dataclasses.replace(JConfig.for_n(16, **kw), box_l=7.0,
                                 box_lz=20.0)
        tc = dataclasses.replace(TConfig.for_n(16, **kw), box_l=7.0,
                                 box_lz=20.0)
        return jc, tc, -2.0
    kw = dict(n=16, temperature=1.5, rho=0.05, gamma=0.02, dtype="float64")
    jc, tc = JConfig.bulk(**kw), TConfig.bulk(**kw)
    return jc, tc, 1.5 * math.log(4.0 / jg.box_volume(jc))


def _draws(key, cfg, a, cap, x):
    """gc_sweep's own draws from its key (tpu_smc/gcmc.py:152-175)."""
    dtype = cfg.jnp_dtype
    a = jnp.asarray(a, dtype)
    _, k_noise, k_unif, k_off, k_ex = jax.random.split(key, 5)
    noise = jnp.sqrt(2.0 * a) * jax.random.normal(k_noise, (cap, 3), dtype)
    unif = jax.random.uniform(k_unif, (cap,), dtype)
    offset = jax.random.randint(k_off, (), 0, cap)
    kind = jax.random.bernoulli(jax.random.fold_in(k_ex, 0), 0.5, (x,))
    xy = jax.random.uniform(jax.random.fold_in(k_ex, 1), (x, 2), dtype,
                            -cfg.box_l / 2.0, cfg.box_l / 2.0)
    z = jax.random.uniform(jax.random.fold_in(k_ex, 2), (x,), dtype,
                           -cfg.box_lz / 2.0, cfg.box_lz / 2.0)
    eu = jax.random.uniform(jax.random.fold_in(k_ex, 3), (x,), dtype)
    pick = jax.random.uniform(jax.random.fold_in(k_ex, 4), (x,), dtype)
    return (noise, unif, offset, kind,
            jnp.concatenate([xy, z[:, None]], axis=1), eu, pick)


def _port_draws(dr):
    """The draws as the port's gc_sweep takes them (one chain)."""
    return tuple(int(v) if np.ndim(v) == 0 else torch.as_tensor(
        np.array(v))[None] for v in dr)


def _arrays(st):
    out = {f: np.asarray(getattr(st, f))[None] for f in st._fields
           if f != "key"}
    out["key"] = np.asarray(jax.random.key_data(st.key))[None]
    return out


_jsweep = jax.jit(jg.gc_sweep, static_argnames=("cfg", "n_exchange"))
_jdraws = jax.jit(_draws, static_argnames=("cfg", "cap", "x"))


def test_masked_energy_matches_jax_with_parked_overlaps():
    jc, tc, _ = _cfgs("slab")
    jcc, tcc = jg._with_n(jc, CAP), tg._with_n(tc, CAP)
    rng = np.random.default_rng(0)
    r = np.stack([jg.cubic_grid(jc, CAP) + rng.normal(0, 0.05, (CAP, 3))
                  for _ in range(3)])
    act = rng.random((3, CAP)) < 0.6
    # parked slots on top of active particles: exact overlaps
    r[:, 5] = r[:, 0]
    act[:, 0], act[:, 5] = True, False
    st, w = jg.init_gcmc_state(jc, jax.random.key(1), CAP)
    e_j = [float(jg.total_energy_masked(jnp.asarray(r[c]),
                                        jnp.asarray(act[c]), w, jcc))
           for c in range(3)]
    e_t = tg.total_energy_masked(torch.as_tensor(r), torch.as_tensor(act),
                                 torch.as_tensor(np.array(w)), tcc)
    assert np.isfinite(e_t.numpy()).all()
    np.testing.assert_allclose(e_t.numpy(), e_j, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("kind", ["slab", "bulk"])
def test_gc_sweep_move_for_move(kind):
    """Three GC sweeps per chain from the same state and tpu_smc's draws:
    positions and energy within 1e-10, masks and counters equal."""
    jc, tc, mu = _cfgs(kind)
    jcc, tcc = jg._with_n(jc, CAP), tg._with_n(tc, CAP)
    a = jc.proposal_a
    moved = 0
    for c in range(2):
        st, w = jg.init_gcmc_state(jc, jax.random.key(20 + c), CAP)
        ts = gcmc_state_from_jax(_arrays(st), tc, device="cpu")
        tw = torch.as_tensor(np.array(w))
        for _ in range(3):
            dr = _port_draws(_jdraws(st.key, jcc, a, CAP, X))
            st = _jsweep(st, w, jcc, mu, a, X)
            ts = tg.gc_sweep(ts, tw, tcc, mu, a, X, draws=dr)
            np.testing.assert_array_equal(ts.active[0].numpy(),
                                          np.asarray(st.active))
            np.testing.assert_allclose(ts.r[0].numpy(), np.asarray(st.r),
                                       rtol=0, atol=1e-10)
            np.testing.assert_allclose(float(ts.energy[0]),
                                       float(st.energy), rtol=1e-10,
                                       atol=1e-10)
            for f in tg.COUNTERS:
                np.testing.assert_allclose(
                    getattr(ts, f)[0].numpy(), np.asarray(getattr(st, f)),
                    rtol=1e-10, err_msg=f)
        moved += int(st.ins_acc) + int(st.del_acc)
    assert moved > 0


def test_batched_sweep_is_one_chain_at_a_time():
    """Chains of a batch (each its own mask, fill and picks) step exactly
    as each chain alone: the selects and gathers keep chains apart."""
    jc, tc, mu = _cfgs("bulk")
    tcc = tg._with_n(tc, CAP)
    st, w = tg.init_gcmc_state(tc, torch.tensor([0, 5]), CAP, device="cpu")
    st = tg.batch_state(st, 3)
    rng = np.random.default_rng(3)
    act = torch.as_tensor(rng.random((3, CAP)) < 0.5)
    act[0] = True                      # full capacity: insertions refuse
    r = torch.as_tensor(tg.cubic_grid(tc, CAP)).expand(3, CAP, 3).clone()
    st = st.replace(r=r, active=act,
                    energy=tg.total_energy_masked(r, act, w, tcc))
    a = 0.05
    t = lambda v: torch.as_tensor(v)
    dr = (t(rng.normal(0, 0.3, (3, CAP, 3))), t(rng.random((3, CAP))), 7,
          t(rng.random((3, X)) < 0.5),
          t((rng.random((3, X, 3)) - 0.5) * tc.box_l), t(rng.random((3, X))),
          t(rng.random((3, X))))
    mus = torch.tensor([mu, mu + 1.0, mu - 1.0], dtype=torch.float64)
    batched = tg.gc_sweep(st, w, tcc, mus, a, X, draws=dr)
    for c in range(3):
        one = tg.gc_sweep(
            tg.GCMCState(**{f.name: getattr(st, f.name)[c:c + 1]
                            for f in dataclasses.fields(st)}),
            w, tcc, mus[c:c + 1], a, X,
            draws=tuple(v if isinstance(v, int) else v[c:c + 1]
                        for v in dr))
        for f in dataclasses.fields(st):
            assert torch.equal(getattr(batched, f.name)[c],
                               getattr(one, f.name)[0]), f.name
    assert int(batched.ins_acc[0]) == 0


def test_simulate_bookkeeping_and_resume_bitwise(tmp_path):
    """The driver: N within the capacity, the tracked energy on the exact
    one at every resync, acceptances in (0, 1]; 10 + 30 sweeps, a
    checkpoint and 30 more are bitwise the unbroken 10 + 60."""
    _, tc, mu = _cfgs("bulk")
    kw = dict(n_chains=2, n_exchange=X, chunk=25, seed=9, device="cpu")
    key = torch.tensor([0, 9])
    st_a, res = tg.simulate_gcmc(tc, mu, CAP, 10, 60, key, **kw)
    assert res.n_trace.shape == (60, 2)
    assert (res.n_trace <= CAP).all() and (res.n_trace >= 0).all()
    assert res.resync_drift < 1e-9
    assert 0 < res.insert_acceptance <= 1 and 0 < res.delete_acceptance <= 1
    assert 0 < res.disp_acceptance <= 1 and np.isfinite(res.mu_ex)
    np.testing.assert_array_equal(res.n_trace[-1],
                                  st_a.active.sum(-1).numpy())
    st_b, _ = tg.simulate_gcmc(tc, mu, CAP, 10, 30, key, **kw)
    p = tg.save_gcmc_checkpoint(tmp_path / "ck", st_b, tc, stream_seed=9)
    st_l, cfg_l, seed = tg.load_gcmc_checkpoint(p, device="cpu")
    assert cfg_l == tc and seed == 9
    kw["seed"] = seed
    st_c, _ = tg.simulate_gcmc(cfg_l, mu, CAP, 0, 30, None, state0=st_l,
                               **kw)
    assert torch.equal(st_a.r, st_c.r)
    assert torch.equal(st_a.active, st_c.active)
    assert torch.equal(st_a.energy, st_c.energy)
    # tpu_smc reads the port's checkpoint
    js, jcfg = jg.load_gcmc_checkpoint(p)
    np.testing.assert_array_equal(np.asarray(js.active), st_b.active.numpy())


def test_state_from_jax_and_csv_byte_identical(tmp_path):
    jc, tc, mu = _cfgs("slab")
    st, _ = jg.init_gcmc_state(jc, jax.random.key(4), CAP)
    ts = gcmc_state_from_jax(_arrays(st), tc, device="cpu")
    np.testing.assert_array_equal(ts.r[0].numpy(), np.asarray(st.r))
    np.testing.assert_array_equal(ts.active[0].numpy(),
                                  np.asarray(st.active))
    assert ts.key[0].tolist() == np.asarray(
        jax.random.key_data(st.key)).tolist()
    _, res = tg.simulate_gcmc(tc, mu, CAP, 4, 12, torch.tensor([0, 4]),
                              n_chains=2, n_exchange=X, z_bins=5,
                              gr_bins=6, seed=4, device="cpu")
    assert res.zprofile.shape == (5,) and res.gr.shape == (6,)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    pt = tg.write_gcmc_csv(tmp_path / "t", tc, mu, res)
    pj = jg.write_gcmc_csv(tmp_path / "j", jc, mu, res)
    assert pt.name == pj.name
    assert pt.read_bytes() == pj.read_bytes()


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


def test_cli_gcmc_and_isotherm(tmp_path):
    out = _cli(tmp_path, "4", "12", "4", "1.5", "--bulk", "--n", "12",
               "--rho", "0.05", "--gamma", "0.02", "--gcmc", "-6",
               "--gcmc-cap", "16", "--chains", "2", "--seed", "3",
               "--z-bins", "4", "--gr-bins", "4",
               "--checkpoint", str(tmp_path / "ck.npz"))
    assert "Grand-canonical results" in out
    assert "torch (plain engine)" in out and "Self-consistency" in out
    d = next((tmp_path / "Data").iterdir())
    for stem in ("gcmc", "gcmc_zprofile", "gcmc_gr"):
        assert len(list(d.glob(f"{stem}_N12_*.csv"))) == 1, stem
    rows = np.genfromtxt(next(d.glob("gcmc_N12_*.csv")), delimiter=",",
                         skip_header=2)
    assert rows.shape == (12, 3)
    out = _cli(tmp_path, "0", "8", "4", "1.5", "--bulk", "--n", "12",
               "--rho", "0.05", "--gamma", "0.02", "--gcmc", "-6",
               "--resume", str(tmp_path / "ck.npz"))
    assert "Resuming GCMC" in out
    out = _cli(tmp_path, "4", "10", "2", "2.0", "--bulk", "--n", "12",
               "--gcmc-grid=-9:-6:3", "--chains", "2", "--seed", "6")
    assert "Adsorption isotherm" in out
    iso = np.genfromtxt(next((tmp_path / "Data").glob(
        "*/gcmc_isotherm_*.csv")), delimiter=",", skip_header=1)
    assert iso.shape == (3, 4)


def test_cli_refuses_kernel_sampler(tmp_path):
    from tpu_smc_torch import cli

    with pytest.raises(SystemExit, match="--sampler dense"):
        cli.main(["1", "2", "1", "1.5", "--bulk", "--gcmc", "-6",
                  "--sampler", "dense", "--device", "cpu"])
