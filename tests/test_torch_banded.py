"""The z-banded random-scan sweep K4, plain version, and its wrapper
ensemble_sweeps_banded against tpu_smc: sort_and_margin bitwise, the
sweep move for move against tpu_smc.sampler.sweep in float64 under an
injected cyclic schedule and injected randomness (every move through the
window, and with moves falling back to the full pass), the |dz| bound,
the fallback count against a numpy count, carried energy against
tpu_smc.potentials.total_energy, call-split invariance, the schedule's
arithmetic and the refusals."""

import unittest.mock as um

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_smc.potentials as jpot
import tpu_smc.sampler as jsam
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc.kernels import sweep_banded as jsb
from tpu_smc.system import build_walls
from tpu_smc_torch import ensemble as ten
from tpu_smc_torch.config import SMCConfig as TConfig
from tpu_smc_torch.kernels import banded as kb
from tpu_smc_torch.kernels import sweep as ks
from tpu_smc_torch.state import init_ensemble_state, seed_words

# tiny tensors: keep torch's intra-op pool from competing with the
# other test workers for cores
torch.set_num_threads(1)

# 8 groups of 4 along z, 14 apart: within a group the particles interact,
# and sqrt(2A) = 0.21 keeps every proposal's |dz| far below d_z
CLUSTER = dict(n=32, box_l=10.0, box_lz=120.0, gamma=0.02)


def _clusters(c, seed):
    """c chains of CLUSTER's groups (squares of side 1.12, jittered),
    rows sorted by z per chain: [c, 32, 3] float64."""
    rng = np.random.default_rng(seed)
    sq = np.array([[0, 0], [1.12, 0], [0, 1.12], [1.12, 1.12]])
    out = []
    for _ in range(c):
        r = []
        for g in range(8):
            xy = rng.uniform(-4.0, 3.0, 2) + sq
            z = -49.0 + 14.0 * g + rng.uniform(-0.3, 0.3, 4)
            r.append(np.column_stack([xy + rng.normal(0, 0.05, (4, 2)), z]))
        r = np.concatenate(r)
        out.append(r[np.argsort(r[:, 2], kind="stable")])
    return np.stack(out)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sort_and_margin_bitwise_jax(dtype):
    """sort_and_margin is tpu_smc's (sweep_banded.py:368) bit for bit:
    planes, pads and margins, ties in z included."""
    cfg = TConfig.for_n(100, dtype=dtype)
    jc = JConfig.for_n(100, dtype=dtype)
    rng = np.random.default_rng(4)
    r = rng.uniform(-16, 16, (3, 100, 3)).astype(dtype)
    r[..., 2] = np.round(r[..., 2])             # ties
    for w in (8, 60):
        got = kb.sort_and_margin(torch.as_tensor(r), cfg, w)
        want = jsb.sort_and_margin(jnp.asarray(r), jc, w)
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _jax_sweeps(r, w, jc, noise, unif, off):
    """tpu_smc.sampler.sweep of every chain with injected draws."""
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(
        jnp.arange(len(r)))
    e0 = jax.vmap(lambda x: jpot.total_energy(x, jnp.asarray(w), jc))(
        jnp.asarray(r))
    outs = []
    for i in range(len(r)):
        with um.patch.object(jax.random, "normal",
                             lambda *a, **kw: jnp.asarray(noise[i]) / jnp.sqrt(
                                 2.0 * jc.proposal_a)), \
                um.patch.object(jax.random, "uniform",
                                lambda *a, **kw: jnp.asarray(unif[i])):
            outs.append(jsam.sweep(jnp.asarray(r[i]), e0[i], keys[i],
                                   jnp.asarray(w), jc, jc.proposal_a,
                                   offset=jnp.int32(off)))
    return e0, outs


def _planes64(r):
    rt = torch.as_tensor(r)
    return [rt[..., q].T.contiguous() for q in range(3)]     # n = N_pad


@pytest.mark.parametrize("window,d_z", [(4, 5.0), (8, 24.5)])
def test_banded_plain_matches_jax_sweep_float64(window, d_z):
    """banded_sweep_plain in float64 with the schedule set to the cyclic
    order (nn + off) % n is tpu_smc.sampler.sweep move for move on the
    z-sorted rows (tolerance 1e-10) while d_z rejects nothing: with W = 4
    every move passes the window test; with W = 8 and d_z = 24.5 the
    margins (two groups, ~28) straddle cut + drift + d_z, so some moves
    fall back to the full pass."""
    n, c, off = 32, 3, 5
    jc = JConfig(**CLUSTER, dtype="float64")
    tc = TConfig(**CLUSTER, dtype="float64")
    w = build_walls(jc)[0]
    r = _clusters(c, 1)
    rng = np.random.default_rng(2)
    noise = rng.normal(0.0, np.sqrt(2 * jc.proposal_a), (c, n, 3))
    unif = rng.uniform(0.0, 1.0, (c, n))
    e0, outs = _jax_sweeps(r, w, jc, noise, unif, off)
    rj = np.stack([np.asarray(o[0]) for o in outs])
    accj = np.asarray([int(o[3]) for o in outs])

    x, y, z = _planes64(r)
    margin = kb.window_margin(z, n, window)
    wa = torch.as_tensor(w[:, 0])[None]
    wb = torch.as_tensor(w[:, 1])[None]
    rows = (torch.arange(n) + off) % n
    g = torch.roll(torch.as_tensor(noise), -off, dims=1).permute(1, 0, 2)
    diag = {}
    x, y, z, e, acc, fb = kb.banded_sweep_plain(
        x, y, z, torch.as_tensor(np.array(e0))[None], wa, wb, margin, None,
        tc, tc.proposal_a, window, d_z, rows=rows,
        draws=(g, torch.as_tensor(unif).T), diag=diag)
    assert bool((diag["ddz"].abs() < d_z / 4).all())
    np.testing.assert_array_equal(acc[0].numpy(), accj)
    assert 0 < accj.min() and accj.max() < n
    np.testing.assert_allclose(ks.from_planes(x, y, z, tc).numpy(), rj,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(e[0].numpy(), [float(o[1]) for o in outs],
                               rtol=1e-10, atol=1e-10)
    if window == 4:
        assert int(fb.sum()) == 0
    else:
        assert 0 < int(fb.sum()) < c * n


def _f32_inputs(c, seed, window):
    cfg = TConfig(**CLUSTER)
    state, w = init_ensemble_state(cfg, seed_words(seed), c,
                                   r0=_clusters(1, seed)[0], device="cpu")
    x, y, z, margin = kb.sort_and_margin(state.r, cfg, window)
    wa, wb = ks.wall_coeff_rows(w, cfg)
    e = state.energy.reshape(1, -1).float()
    return cfg, state, w, (x, y, z, e, wa, wb, margin)


def test_dz_bound_rejects_by_itself():
    """With d_z below the proposal's spread, the |dz| bound alone rejects
    moves the Metropolis test would accept, and an accepted move never
    has |dz| > d_z."""
    cfg, _, _, args = _f32_inputs(4, 3, 4)
    d_z = 0.1
    diag = {}
    out = kb.banded_sweep_plain(*args, (123, 456), cfg, cfg.proposal_a, 4,
                                d_z, diag=diag)
    metropolis = (diag["log_ap"] >= 0) | (diag["u"] < torch.exp(
        diag["log_ap"]))
    within = diag["ddz"].abs() <= d_z
    assert torch.equal(diag["accept"], metropolis & within)
    assert int((metropolis & ~within).sum()) > 0
    assert int(diag["accept"].sum()) == int(out[4].sum()) > 0


def test_fallback_count_against_numpy():
    """The per-chain fallback count is the number of failed sufficiency
    tests margin_i > cut + |z_i - z_i at sort| + drift_max + d_z, the
    drifts recomputed in numpy from the moves' recorded z before and
    after."""
    window, d_z = 8, 24.5
    cfg, _, _, args = _f32_inputs(4, 5, window)
    diag = {}
    out = kb.banded_sweep_plain(*args, (77, 88), cfg, cfg.proposal_a,
                                window, d_z, diag=diag)
    z0, margin = args[2].numpy(), args[6].numpy()
    rows = diag["rows"].numpy()
    zb, za = diag["z_before"].numpy(), diag["z_after"].numpy()
    c = z0.shape[1]
    count = np.zeros(c, np.int64)
    drift = np.zeros(c, np.float32)
    cut, dz32 = np.float32(cfg.lj_cutoff), np.float32(d_z)
    for nn, i in enumerate(rows):
        safe = margin[i] > cut + np.abs(zb[nn] - z0[i]) + drift + dz32
        count += ~safe
        drift = np.maximum(drift, np.abs(za[nn] - z0[i]))
    np.testing.assert_array_equal(out[5][0].numpy(), count)
    assert 0 < count.sum() < c * cfg.n


def test_banded_wrapper_energy_and_call_split():
    """ensemble_sweeps_banded on the CPU (the kernel's plain version):
    carried energy against tpu_smc.potentials.total_energy of the final
    positions, 4 sweeps bitwise 2 + 2, determinism, fallback fraction in
    [0, 1], sweep bookkeeping."""
    cfg, state, w, _ = _f32_inputs(3, 7, 8)
    run = lambda st, k: ten.ensemble_sweeps_banded(
        st, w, cfg, cfg.proposal_a, k, window=8, d_z=2.0, seed=11)
    four, tr, fb4 = run(state, 4)
    two, _, fb_a = run(state, 2)
    split, _, fb_b = run(two, 2)
    again = run(state, 4)[0]
    for a, b, d in ((four.r, split.r, again.r),
                    (four.energy, split.energy, again.energy),
                    (four.accepted, split.accepted, again.accepted)):
        assert torch.equal(a, b) and torch.equal(a, d)
    assert fb4 == pytest.approx((fb_a + fb_b) / 2, abs=1e-12)
    assert 0.0 <= fb4 <= 1.0
    assert tr.energy.shape == (4, 3) and int(four.sweeps[0]) == 4
    assert torch.equal(four.accepted, tr.accepted.sum(0).to(torch.int64))
    assert 0 < int(four.accepted.sum()) < 4 * 3 * cfg.n
    jc = JConfig(**CLUSTER)
    exact = jax.vmap(lambda r: jpot.total_energy(
        r, jnp.asarray(w.numpy()), jc))(jnp.asarray(four.r.numpy()))
    np.testing.assert_allclose(four.energy.numpy(), np.asarray(exact),
                               rtol=1e-4, atol=1e-3)


def test_schedule_arithmetic_and_spread():
    """banded_rows is floor(w n / 2^64) of the 64-bit word of Philox
    (nn, 0, 3, 0), checked against Python integers, in [0, n), and
    spread evenly over the rows."""
    words = (2024, 99)
    nn = torch.arange(64)
    zero = torch.zeros_like(nn)
    lo, hi = ks.philox4x32(nn, zero, zero + 3, zero,
                           torch.full_like(nn, words[0]),
                           torch.full_like(nn, words[1]))[:2]
    for n in (64, 1024, 1000003):
        want = [((h << 32 | lo_) * n) >> 64
                for h, lo_ in zip(hi.tolist(), lo.tolist())]
        assert kb.banded_rows(words, n)[:64].tolist() == want
    spread = np.bincount(torch.cat([kb.banded_rows((s, 1), 64)
                                    for s in range(200)]).numpy(),
                         minlength=64)
    assert spread.shape == (64,)
    assert spread.min() > 0.6 * 200 and spread.max() < 1.4 * 200


def test_schedule_draws_a_row_twice_in_a_row():
    """The premise of K4's repeated-row cases on the card
    (tests/test_torch_cuda.py test_banded_kernel_repeated_row,
    chip_smoke.py compare_repeated_row, kernel_ab.py): under the seed
    words (3, 7) the schedule of an N = 32 sweep draws row 13 at moves 2
    and 3."""
    rows = kb.banded_rows((3, 7), 32)
    assert int(rows[2]) == int(rows[3]) == 13
    assert int((rows[1:] == rows[:-1]).sum()) == 2       # moves 2 and 27


def test_banded_refusals():
    cfg, state, w, _ = _f32_inputs(2, 1, 4)
    with pytest.raises(NotImplementedError, match="reference noise"):
        ten.ensemble_sweeps_banded(state, w, TConfig(**CLUSTER,
                                                     reference_noise=True),
                                   cfg.proposal_a, 1)
    with pytest.raises(NotImplementedError, match="shared wall table"):
        ten.ensemble_sweeps_banded(state, w.expand(2, -1, -1), cfg,
                                   cfg.proposal_a, 1)
    bulk = TConfig.bulk(n=32)
    bstate, bw = init_ensemble_state(bulk, seed_words(1), 2, device="cpu")
    with pytest.raises(NotImplementedError, match="confined-z"):
        ten.ensemble_sweeps_banded(bstate, bw, bulk, bulk.proposal_a, 1)
    with pytest.raises(ValueError, match="window >= 1"):
        ten.ensemble_sweeps_banded(state, w, cfg, cfg.proposal_a, 1,
                                   window=0)
