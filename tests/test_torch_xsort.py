"""The 2-D (z-band, x-slice) skip K1-xs, plain version, and its wrapper
ensemble_sweeps_zsorted(xsort_slices=k) against tpu_smc: move for move
against tpu_smc.sampler.sweep in float64 under injected randomness,
bitwise the dense and z-skip passes on the same rows (also on a cluster
at the periodic x seam), the 2-D row order bitwise tpu_smc's recipe, the
wrapper's bookkeeping, and the refusals with tpu_smc's wording."""

import inspect
import unittest.mock as um

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_smc.potentials as jpot
import tpu_smc.sampler as jsam
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc.system import build_walls, fcc_lattice
from tpu_smc_torch import ensemble as ten
from tpu_smc_torch.config import SMCConfig as TConfig
from tpu_smc_torch.kernels import sweep as ks
from tpu_smc_torch.potentials import total_energy
from tpu_smc_torch.state import from_jax_state, init_ensemble_state, seed_words

# tiny tensors: keep torch's intra-op pool from competing with the
# other test workers for cores
torch.set_num_threads(1)


def _sorted_2d(r, k):
    """Rows of r [C, n, 3] sorted by z, then by x within each band of
    128 k rows (numpy, stable): the layout the wrapper builds."""
    c, n, _ = r.shape
    r = np.take_along_axis(r, np.argsort(r[..., 2], axis=1,
                                         kind="stable")[..., None], axis=1)
    band = r.reshape(c, n // (128 * k), 128 * k, 3)
    order = np.argsort(band[..., 0], axis=2, kind="stable")
    return np.take_along_axis(band, order[..., None], axis=2).reshape(c, n, 3)


def _jittered(n, c, seed, cfg):
    rng = np.random.default_rng(seed)
    return fcc_lattice(cfg)[None] + rng.normal(0.0, 0.3, (c, n, 3))


def test_plain_xskip_matches_jax_sweep_float64():
    """sweep_block_plain(zskip=True, xslices=2) in float64 is
    tpu_smc.sampler.sweep move for move under the same injected noise,
    uniforms and offset, at N = 512 on 2-D-sorted rows (two bands of two
    blocks), and it visits fewer rows than the 1-D z-skip pass."""
    n, c, off, k = 512, 2, 77, 2
    jc, tc = (JConfig.for_n(n, dtype="float64"),
              TConfig.for_n(n, dtype="float64"))
    w = build_walls(jc)[0]
    r = _sorted_2d(_jittered(n, c, 1, tc), k)
    rng = np.random.default_rng(2)
    noise = rng.normal(0.0, np.sqrt(2 * jc.proposal_a), (c, n, 3))
    unif = rng.uniform(0.0, 1.0, (c, n))
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(
        jnp.arange(c))
    e0 = jax.vmap(lambda x: jpot.total_energy(x, jnp.asarray(w), jc))(
        jnp.asarray(r))
    outs = []
    for i in range(c):
        with um.patch.object(jax.random, "normal",
                             lambda *a, **kw: jnp.asarray(noise[i]) / jnp.sqrt(
                                 2.0 * jc.proposal_a)), \
                um.patch.object(jax.random, "uniform",
                                lambda *a, **kw: jnp.asarray(unif[i])):
            outs.append(jsam.sweep(jnp.asarray(r[i]), e0[i], keys[i],
                                   jnp.asarray(w), jc, jc.proposal_a,
                                   offset=jnp.int32(off)))
    rj = np.stack([np.asarray(o[0]) for o in outs])
    accj = np.asarray([int(o[3]) for o in outs])

    rt = torch.as_tensor(r)
    planes = [rt[..., q].T.contiguous() for q in range(3)]    # n = N_pad
    wa = torch.as_tensor(w[:, 0])[None]
    wb = torch.as_tensor(w[:, 1])[None]
    g = torch.roll(torch.as_tensor(noise), -off, dims=1).permute(1, 0, 2)
    args = (*planes, torch.as_tensor(np.array(e0))[None], wa, wb,
            torch.tensor([off]), torch.zeros((1, 2), dtype=torch.int64), tc,
            1, tc.proposal_a)
    draws = (g[None], torch.as_tensor(unif).T[None])
    dx, dz = {}, {}
    x, y, z, e, _, atr = ks.sweep_block_plain(*args, zskip=True, xslices=k,
                                              draws=draws, diag=dx)
    np.testing.assert_array_equal(atr[0].numpy(), accj)
    assert 0 < accj.min() and accj.max() < n
    np.testing.assert_allclose(ks.from_planes(x, y, z, tc).numpy(), rj,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(e[0].numpy(), [float(o[1]) for o in outs],
                               rtol=1e-10, atol=1e-10)
    ks.sweep_block_plain(*args, zskip=True, draws=draws, diag=dz)
    assert bool((dx["visited"] < dz["visited"]).all())


def _f32_args(r, cfg, c, seed, sweeps=1):
    """Kernel inputs of positions r [n, 3] (the same rows in every chain)
    with `sweeps` sweeps of the port's Philox draws."""
    state, w = init_ensemble_state(cfg, seed_words(seed), c, r0=r,
                                   device="cpu")
    x, y, z, e, wa, wb = ten._kernel_inputs(state, w, cfg)
    words, offsets = ten._per_sweep_randomness(state, cfg, seed, sweeps)
    return (x, y, z, e, wa, wb, offsets, words, cfg, sweeps, cfg.proposal_a)


def _seam_cluster(n, seed, box_l=33.0):
    """n particles with every x within 1.5 of the periodic seam +-L/2."""
    rng = np.random.default_rng(seed)
    half = box_l / 2
    side = rng.uniform(size=n) < 0.5
    x = np.where(side, -half + rng.uniform(0, 1.5, n),
                 half - rng.uniform(0, 1.5, n))
    return np.stack([x, rng.uniform(-half, half, n),
                     rng.uniform(-60.0, 60.0, n)], axis=1)


@pytest.mark.parametrize("case", ["lattice N=512", "seam N=256"])
def test_xskip_bitwise_dense_and_zskip(case):
    """On the same 2-D-sorted rows the 2-D pass changes which exact zeros
    are summed, never a sum: bitwise the dense and the 1-D z-skip passes
    (each thread adds its rows in ascending block order), also when every
    window wraps the x seam. At N = 512 (two bands) it visits fewer rows
    than z-skip; at N = 256 one band holds both blocks, so it visits at
    least z-skip's envelope (tpu_smc's band granularity)."""
    lattice = case.startswith("lattice")
    n, c = (512, 2) if lattice else (256, 3)
    cfg = TConfig.for_n(n)
    r = _sorted_2d(_jittered(n, 1, 3, cfg) if lattice
                   else _seam_cluster(n, 12)[None], 2)[0]
    args = _f32_args(r, cfg, c, 4)
    dd, dz, dx = {}, {}, {}
    dense = ks.sweep_block_plain(*args, diag=dd)
    zskip = ks.sweep_block_plain(*args, zskip=True, diag=dz)
    xskip = ks.sweep_block_plain(*args, zskip=True, xslices=2, diag=dx)
    for a, b, d in zip(dense, zskip, xskip):
        assert torch.equal(a, b) and torch.equal(a, d)
    assert int(dense[5].sum()) > 0
    assert bool((dx["visited"] < dd["visited"]).all())
    if lattice:
        assert bool((dx["visited"] < dz["visited"]).all())


@pytest.mark.parametrize("k", [2, 4])
def test_xsort_perm_matches_jax_recipe(k):
    """The wrapper's 2-D row order is tpu_smc/ensemble.py:503-513's
    recipe (jnp argsorts, stable) on the same float32 planes, ties
    included."""
    n, c = 512, 3
    rng = np.random.default_rng(k)
    # a coarse grid makes ties in z and in x
    x = np.round(rng.uniform(-16, 16, (n + 8, c)) * 2) / 2
    z = np.round(rng.uniform(-100, 100, (n + 8, c)) * 2) / 2
    x, z = x.astype(np.float32), z.astype(np.float32)
    band_rows = 128 * k
    jx, jz = jnp.asarray(x), jnp.asarray(z)
    perm = jnp.argsort(jz[:n], axis=0)
    xz = jnp.take_along_axis(jx[:n], perm, axis=0)
    xperm = jnp.argsort(xz.reshape(n // band_rows, band_rows, c), axis=1)
    perm = jnp.take_along_axis(perm.reshape(n // band_rows, band_rows, c),
                               xperm, axis=1).reshape(n, c)
    got = ten.xsort_perm(torch.as_tensor(x), torch.as_tensor(z), n, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(perm))
    plain = ten.xsort_perm(torch.as_tensor(x), torch.as_tensor(z), n, 0)
    np.testing.assert_array_equal(plain.numpy(),
                                  np.asarray(jnp.argsort(jz[:n], axis=0)))


def test_xsort_wrapper_bookkeeping():
    """ensemble_sweeps_zsorted(xsort_slices=2) at N = 256: carried energy
    against an exact recompute, determinism, bitwise call-split
    invariance at the sort cadence, and particle identity through the
    2-D sorts at a vanishing mobility."""
    n, c = 256, 2
    cfg = TConfig.for_n(n)
    state, w = init_ensemble_state(cfg, seed_words(5), c, device="cpu")
    run = lambda st, k: ten.ensemble_sweeps_zsorted(
        st, w, cfg, cfg.proposal_a, k, seed=3, sweeps_per_sort=1,
        xsort_slices=2)
    one, tr = run(state, 2)
    again, _ = run(state, 2)
    split, _ = run(run(state, 1)[0], 1)
    for a, b, d in ((one.r, again.r, split.r),
                    (one.energy, again.energy, split.energy),
                    (one.accepted, again.accepted, split.accepted)):
        assert torch.equal(a, b) and torch.equal(a, d)
    assert tr.energy.shape == (2, c) and int(one.sweeps[0]) == 2
    assert int(one.accepted.sum()) > 0
    np.testing.assert_allclose(one.energy.numpy(),
                               total_energy(one.r, w, cfg).numpy(),
                               rtol=1e-4, atol=1e-3)
    r0 = _seam_cluster(n, 6)
    st0, w0 = init_ensemble_state(cfg, seed_words(6), c, r0=r0, device="cpu")
    assert not np.all(np.diff(r0[:, 2]) >= 0)
    still, _ = ten.ensemble_sweeps_zsorted(st0, w0, cfg, 1e-18, 1, seed=7,
                                           xsort_slices=2)
    np.testing.assert_allclose(still.r.numpy(), st0.r.numpy(), atol=1e-5)


def test_xsort_refusals():
    """tpu_smc's refusals (ensemble.py:454-466, sweep_pallas.py:273-283),
    in its wording."""
    cfg = TConfig.for_n(200)
    state, w = init_ensemble_state(cfg, seed_words(1), 2, device="cpu")
    with pytest.raises(ValueError, match=r"xsort_slices 2: n 200 must be a "
                       r"multiple of row_block\*xslices = 256"):
        ten.ensemble_sweeps_zsorted(state, w, cfg, cfg.proposal_a, 1,
                                    xsort_slices=2)
    cfg = TConfig.for_n(256)
    state, w = init_ensemble_state(cfg, seed_words(1), 2, device="cpu")
    with pytest.raises(NotImplementedError, match="resident kernel only"):
        ten.ensemble_sweeps_zsorted(state, w, cfg, cfg.proposal_a, 1,
                                    xsort_slices=2, hbm_stream=True)
    rcfg = TConfig.for_n(256, reference_noise=True)
    with pytest.raises(NotImplementedError, match="requires i.i.d."):
        ten.ensemble_sweeps_zsorted(state, w, rcfg, rcfg.proposal_a, 1,
                                    xsort_slices=2)
    args = _f32_args(fcc_lattice(cfg), cfg, 2, 1)
    with pytest.raises(ValueError, match="xslices 3 must divide the 2 row "
                       "blocks"):
        ks.sweep_block(*args, zskip=True, xslices=3)
    with pytest.raises(NotImplementedError, match="refines the zskip"):
        ks.sweep_block(*args, xslices=2)
    with pytest.raises(NotImplementedError, match="requires i.i.d."):
        ks.sweep_block(*args[:8], rcfg, 2, rcfg.proposal_a, zskip=True,
                       xslices=2)


def test_from_jax_state_defaults_to_the_card():
    """from_jax_state, like every entry point of the port, puts the state
    on the card unless the caller asks for the CPU."""
    assert inspect.signature(from_jax_state).parameters["device"].default \
        == "cuda"
    cfg = TConfig.for_n(32)
    arrays = {"r": np.zeros((2, 32, 3)), "energy": np.zeros(2),
              "key": np.zeros((2, 2), np.uint32), "sweeps": np.zeros(2),
              "accepted": np.zeros(2), "rbin": np.zeros((2, 32)),
              "density": np.zeros((2, 4)), "mobility": np.zeros((2, 4))}
    w = np.zeros((9, 2))
    state, _ = from_jax_state(arrays, w, cfg, device="cpu")
    assert state.r.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            from_jax_state(arrays, w, cfg)
