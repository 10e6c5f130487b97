"""Gibbs-ensemble MC in tpu_smc_torch against tpu_smc.gibbs in float64:
the masked energy at a per-box side, gibbs_sweep move for move under the
draws re-derived from tpu_smc's key splits, frozen exchanges as two
independent boxes, conservation and bitwise resume through the driver,
the coexistence grouping and the CSV writers against tpu_smc's on the
same arrays, the state carried across, and the CLI's --gibbs and
--gibbs-temps runs on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpu_smc import gibbs as jgb
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc.gcmc import total_energy_masked as j_masked
from tpu_smc_torch import gibbs as tgb
from tpu_smc_torch.config import SMCConfig as TConfig
from tpu_smc_torch.gcmc import total_energy_masked as t_masked
from tpu_smc_torch.state import gibbs_state_from_jax

torch.set_num_threads(1)

CAP, X = 24, 6


def _cfgs(n=24, rho=0.25, **kw):
    """tests/test_gibbs.py's mk_cfg for both packages: cfg.n the total,
    box_l the per-box side of n/2 at rho."""
    kw = {**dict(temperature=1.2, gamma=0.02, lj_cutoff=1.5, lj_shift=True,
                 dtype="float64"), **kw}
    l = ((n / 2) / rho) ** (1.0 / 3.0)
    return tuple(dataclasses.replace(c.bulk(n=n, **kw), box_l=l, box_lz=l)
                 for c in (JConfig, TConfig))


def _draws(st, cfg, a, cap, x):
    """gibbs_sweep's own draws from its three keys (tpu_smc/gibbs.py:
    107-190)."""
    dtype = cfg.jnp_dtype
    a = jnp.asarray(a, dtype)
    _, k1, k2 = jax.random.split(st.key, 3)

    def draw(k):
        kn, ku, ko = jax.random.split(k, 3)
        return (jnp.sqrt(2.0 * a) * jax.random.normal(kn, (cap, 3), dtype),
                jax.random.uniform(ku, (cap,), dtype),
                jax.random.randint(ko, (), 0, cap))

    d1, d2 = draw(k1), draw(k2)
    _, k_step, k_vacc = jax.random.split(st.vkey, 3)
    _, k_t = jax.random.split(st.tkey)
    return (jnp.stack([d1[0], d2[0]]), jnp.stack([d1[1], d2[1]]),
            (d1[2], d2[2]), jax.random.uniform(k_step, (), dtype),
            jax.random.uniform(k_vacc, (), dtype),
            jax.random.bernoulli(jax.random.fold_in(k_t, 0), 0.5, (x,)),
            jax.random.uniform(jax.random.fold_in(k_t, 1), (x, 3),
                               dtype) - 0.5,
            jax.random.uniform(jax.random.fold_in(k_t, 2), (x,), dtype),
            jax.random.uniform(jax.random.fold_in(k_t, 3), (x,), dtype))


_jdraws = jax.jit(_draws, static_argnames=("cfg", "cap", "x"))
_jsweep = jax.jit(jgb.gibbs_sweep, static_argnames=("cfg", "n_transfer"))


def _port_draws(dr):
    t = lambda v: torch.as_tensor(np.array(v))[None]
    noise, unif, offs, us, uv, tdir, tpos, tu, tp = dr
    return (t(noise), t(unif), tuple(int(o) for o in offs), t(us), t(uv),
            t(tdir), t(tpos), t(tu), t(tp))


def _arrays(st):
    out = {f: np.asarray(getattr(st, f))[None] for f in st._fields
           if f not in ("key", "vkey", "tkey")}
    out["key"] = np.asarray(jax.random.key_data(st.key))[None]
    return out


def test_masked_energy_at_box_matches_jax():
    jc, tc = _cfgs()
    rng = np.random.default_rng(0)
    r = (rng.random((2, 2, 20, 3)) - 0.5) * jc.box_l
    act = rng.random((2, 2, 20)) < 0.7
    l = np.array([[0.9, 1.1], [1.0, 0.95]]) * jc.box_l
    w = jnp.zeros((0,), jnp.float64)
    e_t = t_masked(torch.as_tensor(r), torch.as_tensor(act),
                   torch.zeros(0, dtype=torch.float64), tc,
                   box=torch.as_tensor(l)).numpy()
    for c in range(2):
        for b in range(2):
            e_j = float(j_masked(jnp.asarray(r[c, b]), jnp.asarray(act[c, b]),
                                 w, jc, box=jnp.asarray(l[c, b])))
            np.testing.assert_allclose(e_t[c, b], e_j, rtol=1e-10)


def test_gibbs_sweep_move_for_move():
    """Three Gibbs sweeps per chain (dlnV 0.2, 6 transfers) from the same
    state and tpu_smc's draws (one offset per box): positions, sides and
    energies within 1e-10, masks and counters equal."""
    jc, tc = _cfgs()
    a, dlnv = jc.proposal_a, 0.2
    moved = 0
    for c in range(2):
        st = jgb.init_gibbs_state(jc, jax.random.key(40 + c), CAP)
        ts = gibbs_state_from_jax(_arrays(st), tc, device="cpu")
        for _ in range(3):
            dr = _port_draws(_jdraws(st, jc, a, CAP, X))
            st = _jsweep(st, jc, a, dlnv, X)
            ts = tgb.gibbs_sweep(ts, tc, a, dlnv, X, draws=dr)
            np.testing.assert_array_equal(ts.active[0].numpy(),
                                          np.asarray(st.active))
            np.testing.assert_allclose(ts.r[0].numpy(), np.asarray(st.r),
                                       rtol=0, atol=1e-10)
            np.testing.assert_allclose(ts.l[0].numpy(), np.asarray(st.l),
                                       rtol=1e-12)
            np.testing.assert_allclose(ts.energy[0].numpy(),
                                       np.asarray(st.energy), rtol=1e-10,
                                       atol=1e-10)
            # (atol: XLA on the CPU flushes a subnormal ghost weight to 0)
            for f in tgb.COUNTERS:
                np.testing.assert_allclose(
                    getattr(ts, f)[0].numpy(), np.asarray(getattr(st, f)),
                    rtol=1e-10, atol=1e-300, err_msg=f)
        moved += int(st.tr_acc) + int(st.vol_acc)
    assert moved > 0


def test_frozen_exchange_boxes_independent():
    """dlnv = 0 and no transfers: box 1's trajectory is bitwise blind to
    box 2's contents; sides and counts frozen."""
    _, tc = _cfgs()

    def run(seed2):
        st = tgb.init_gibbs_state(tc, torch.tensor([0, 3]), 16,
                                  device="cpu")
        g = torch.Generator().manual_seed(seed2)
        r = st.r.clone()
        r[:, 1] += 0.05 * torch.randn(r[:, 1].shape, generator=g,
                                      dtype=r.dtype)
        st = st.replace(r=r, energy=t_masked(r, st.active, r.new_zeros(0),
                                             tc, box=st.l))
        return tgb.gibbs_block(st, tc, tc.proposal_a, 0.0, 0, 20,
                               seed=5)[0]

    a, b = run(10), run(20)
    assert torch.equal(a.r[:, 0], b.r[:, 0])
    assert not torch.equal(a.r[:, 1], b.r[:, 1])
    for s in (a, b):
        assert s.l.tolist() == [[tc.box_l, tc.box_l]]
        assert s.active[0, 0].sum() == 12 and int(s.disp_acc[0]) > 0


def test_conservation_and_resume_bitwise(tmp_path):
    _, tc = _cfgs()
    kw = dict(cap=CAP, n_chains=2, dlnv=0.2, n_transfer=X, chunk=25,
              seed=8, device="cpu")
    key = torch.tensor([0, 8])
    st_a, res = tgb.simulate_gibbs(tc, 10, 40, key, **kw)
    assert res.n_conserved and (res.n_final.sum(-1) == tc.n).all()
    vtot = 2.0 * tc.box_l ** 3
    np.testing.assert_allclose((res.l_final ** 3).sum(-1), vtot, rtol=1e-12)
    assert res.transfer_acceptance > 0 and res.resync_drift < 1e-9
    st_b, _ = tgb.simulate_gibbs(tc, 10, 20, key, **kw)
    p = tgb.save_gibbs_checkpoint(tmp_path / "ck", st_b, tc, stream_seed=8)
    st_l, cfg_l, seed = tgb.load_gibbs_checkpoint(p, device="cpu")
    st_c, _ = tgb.simulate_gibbs(cfg_l, 0, 20, None, state0=st_l,
                                 **{**kw, "seed": seed})
    for f in ("r", "active", "l", "energy"):
        assert torch.equal(getattr(st_a, f), getattr(st_c, f)), f


def test_binodal_csv_and_state_match_jax(tmp_path):
    jc, tc = _cfgs()
    st = jgb.init_gibbs_state(jc, jax.random.key(6), CAP)
    ts = gibbs_state_from_jax(_arrays(st), tc, device="cpu")
    np.testing.assert_array_equal(ts.r[0].numpy(), np.asarray(st.r))
    np.testing.assert_array_equal(ts.active[0].numpy(),
                                  np.asarray(st.active))
    temps = np.repeat([1.0, 1.4], 2)
    state, res = tgb.simulate_gibbs(tc, 4, 10, torch.tensor([0, 6]), CAP,
                                    n_chains=4, dlnv=0.2, n_transfer=X,
                                    temperatures=temps, seed=6,
                                    device="cpu")
    rows_t = tgb.binodal_from_results(state, res, temps, tc)
    rows_j = jgb.binodal_from_results(state, res, temps, jc)
    assert [r["two_phase"] for r in rows_t] == \
        [r["two_phase"] for r in rows_j]
    for rt, rj in zip(rows_t, rows_j):
        for k in ("t", "rho_v", "err_v", "rho_l", "err_l", "dmu"):
            np.testing.assert_allclose(rt[k], rj[k], rtol=1e-10)
    for sub in ("t", "j"):
        (tmp_path / sub).mkdir()
    tgb.write_gibbs_csv(tmp_path / "t", tc, res)
    jgb.write_gibbs_csv(tmp_path / "j", jc, res)
    tgb.write_gibbs_binodal_csv(tmp_path / "t", tc, rows_t)
    jgb.write_gibbs_binodal_csv(tmp_path / "j", jc, rows_t)
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert len(names) == 2
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


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


def test_cli_gibbs_resume_and_binodal(tmp_path):
    common = ["1.2", "--gibbs", "--n", "16", "--rho", "0.3", "--gamma",
              "0.02", "--chains", "2", "--seed", "4", "--gibbs-transfers",
              "4"]
    out = _cli(tmp_path, "4", "10", "5", *common, "--checkpoint",
               str(tmp_path / "ck.npz"))
    assert "Gibbs-ensemble results" in out and "--bulk implied" in out
    d = next((tmp_path / "Data").iterdir())
    rows = np.genfromtxt(next(d.glob("gibbs_N16_*.csv")), delimiter=",",
                         skip_header=2)
    assert rows.shape == (10, 5) and np.isfinite(rows).all()
    out = _cli(tmp_path, "0", "6", "3", *common, "--resume",
               str(tmp_path / "ck.npz"))
    assert "Resuming Gibbs" in out
    out = _cli(tmp_path, "4", "10", "5", "1.2", "--gibbs", "--gibbs-temps",
               "0.9,1.6", "--n", "16", "--rho", "0.3", "--gamma", "0.02",
               "--chains", "2", "--seed", "4")
    assert "Coexistence curve" in out
    b = np.genfromtxt(next((tmp_path / "Data").glob(
        "*/gibbs_binodal_*.csv")), delimiter=",", skip_header=1)
    assert b.shape == (2, 7)
