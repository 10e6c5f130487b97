"""The whole-sweep kernel's plain version (kernels/sweep.py) against
tpu_smc: plane adapters bitwise, dense and z-skip move for move against
tpu_smc.sampler.sweep in float64 under injected randomness, z-skip on/off
bitwise, the Philox stream, and the interpret-mode Pallas engine's
bookkeeping beside the port's dense engine."""

import unittest.mock as um

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tpu_smc.potentials as jpot
import tpu_smc.sampler as jsam
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc.ensemble import ensemble_sweeps_pallas
from tpu_smc.kernels import sweep_pallas as sp
from tpu_smc.state import init_ensemble_state as j_init
from tpu_smc.system import build_walls, fcc_lattice
from tpu_smc_torch import ensemble as ten
from tpu_smc_torch.config import SMCConfig as TConfig
from tpu_smc_torch.kernels import sweep as ks
from tpu_smc_torch.potentials import total_energy
from tpu_smc_torch.state import from_jax_state, init_ensemble_state, seed_words

# tiny tensors: keep torch's intra-op pool from competing with the
# other test workers for cores
torch.set_num_threads(1)


def test_philox_known_answers():
    """Philox4x32-10 known-answer vectors of the Random123 distribution."""
    def run(ctr, key):
        t = [torch.tensor([v], dtype=torch.int64) for v in ctr + key]
        return [int(v) for v in ks.philox4x32(*t)]

    assert run((0, 0, 0, 0), (0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert run((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
               (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_uniforms_open_interval_and_exact():
    bits = torch.tensor([0, 255, 256, 0xFFFFFFFF, 0xFFFFFF00],
                        dtype=torch.int64)
    u32 = ks.unit_uniform(bits, torch.float32)
    assert bool(((u32 > 0) & (u32 < 1)).all())
    np.testing.assert_array_equal(
        u32.double().numpy(), ks.unit_uniform(bits, torch.float64).numpy())
    u = ks.move_uniforms((123, 456), 64, 8)
    assert u.shape == (64, 8, 5) and bool(((u > 0) & (u < 1)).all())
    assert abs(float(u.mean()) - 0.5) < 0.05


def test_plane_adapters_bitwise():
    cfg = JConfig.for_n(108)
    rng = np.random.default_rng(5)
    r = rng.normal(0.0, 10.0, (4, 108, 3)).astype(np.float32)
    w = build_walls(cfg)[0]
    tc = TConfig.for_n(108)
    for a, b in zip(sp.to_planes(jnp.asarray(r), cfg),
                    ks.to_planes(torch.as_tensor(r), tc)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    x, y, z = ks.to_planes(torch.as_tensor(r), tc)
    np.testing.assert_array_equal(
        np.asarray(sp.from_planes(*(jnp.asarray(p.numpy())
                                    for p in (x, y, z)), cfg)),
        ks.from_planes(x, y, z, tc).numpy())
    for a, b in zip(sp.wall_coeff_rows(jnp.asarray(w), cfg),
                    ks.wall_coeff_rows(torch.as_tensor(w), tc)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _sorted_start(n, c, seed):
    """c chains of a jittered FCC start, rows sorted by z per chain."""
    cfg = TConfig.for_n(n, dtype="float64")
    rng = np.random.default_rng(seed)
    r = fcc_lattice(cfg)[None] + rng.normal(0.0, 0.3, (c, n, 3))
    return np.take_along_axis(r, np.argsort(r[..., 2], axis=1)[..., None],
                              axis=1)


@pytest.mark.parametrize("zskip", [False, True])
def test_plain_kernel_matches_jax_sweep_float64(zskip):
    """sweep_block_plain in float64 is tpu_smc.sampler.sweep (the physics
    sweep_pallas.py:28-30 names for its kernel) move for move under the
    same injected noise, uniforms and offset. N = 256 gives two z-skip
    blocks."""
    n, c, off = 256, 2, 77
    jc, tc = JConfig.for_n(n, dtype="float64"), \
        TConfig.for_n(n, dtype="float64")
    w = build_walls(jc)[0]
    r = _sorted_start(n, c, 1)
    rng = np.random.default_rng(2)
    noise = rng.normal(0.0, np.sqrt(2 * jc.proposal_a), (c, n, 3))
    unif = rng.uniform(0.0, 1.0, (c, n))
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(
        jnp.arange(c))
    e0 = jax.vmap(lambda x: jpot.total_energy(x, jnp.asarray(w), jc))(
        jnp.asarray(r))

    def jsweep(x, e, k, nz, u):
        # tpu_smc.sampler.sweep with its draws replaced by the injected ones
        import unittest.mock as um
        with um.patch.object(jax.random, "normal",
                             lambda *a, **kw: nz / jnp.sqrt(2.0 * jc.proposal_a)), \
                um.patch.object(jax.random, "uniform", lambda *a, **kw: u):
            return jsam.sweep(x, e, k, jnp.asarray(w), jc, jc.proposal_a,
                              offset=jnp.int32(off))

    outs = [jsweep(jnp.asarray(r[i]), e0[i], keys[i], jnp.asarray(noise[i]),
                   jnp.asarray(unif[i])) for i in range(c)]
    rj = np.stack([np.asarray(o[0]) for o in outs])
    ej = np.asarray([float(o[1]) for o in outs])
    accj = np.asarray([int(o[3]) for o in outs])

    rt = torch.as_tensor(r)
    planes = [rt[..., k].T.contiguous() for k in range(3)]   # n = N_pad
    wa = torch.as_tensor(w[:, 0])[None]
    wb = torch.as_tensor(w[:, 1])[None]
    g = torch.roll(torch.as_tensor(noise), -off, dims=1).permute(1, 0, 2)
    u = torch.as_tensor(unif).T
    diag = {}
    x, y, z, e, etr, atr = ks.sweep_block_plain(
        *planes, torch.as_tensor(np.array(e0))[None], wa, wb,
        torch.tensor([off]), torch.zeros((1, 2), dtype=torch.int64), tc, 1,
        tc.proposal_a, zskip=zskip, draws=(g[None], u[None]), diag=diag)
    np.testing.assert_array_equal(atr[0].numpy(), accj)
    assert 0 < accj.min() and accj.max() < n
    np.testing.assert_allclose(ks.from_planes(x, y, z, tc).numpy(), rj,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(e[0].numpy(), ej, rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(etr[0].numpy(), e[0].numpy())
    visited = diag["visited"].numpy()
    assert (visited < 2 * n * n).all() if zskip else \
        (visited == 2 * n * n).all()


def test_plain_kernel_wall_grid_m10_matches_jax_float64():
    """A 10 x 10 wall grid (100 sites: more than the CUDA kernel's old
    64-site cap): sweep_block_plain is tpu_smc.sampler.sweep move for
    move in float64 (tolerance 1e-10) in a box whose walls reach the
    particles, and the launcher's input checks take mm = 100 (no site
    cap left)."""
    n, c, off = 30, 2, 4
    kw = dict(n=n, m=10, box_l=6.0, box_lz=14.0, dtype="float64")
    jc, tc = JConfig(**kw), TConfig(**kw)
    w = build_walls(jc)[0]
    assert w.shape == (100, 2)
    rng = np.random.default_rng(10)
    r = fcc_lattice(jc)[None] + rng.normal(0.0, 0.05, (c, n, 3))
    noise = rng.normal(0.0, np.sqrt(2 * jc.proposal_a), (c, n, 3))
    unif = rng.uniform(0.0, 1.0, (c, n))
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(1), i))(
        jnp.arange(c))
    e0 = jax.vmap(lambda x: jpot.total_energy(x, jnp.asarray(w), jc))(
        jnp.asarray(r))
    ew = jax.vmap(lambda x: jpot.wall_energy_total(x, jnp.asarray(w), jc)
                  - jpot.wall_energy_total(x, jnp.zeros_like(w), jc))(
        jnp.asarray(r))
    assert float(jnp.abs(ew).min()) > 1e-3     # the wall sites reach the slab
    outs = []
    for i in range(c):
        with um.patch.object(jax.random, "normal",
                             lambda *a, **k: jnp.asarray(noise[i]) / jnp.sqrt(
                                 2.0 * jc.proposal_a)), \
                um.patch.object(jax.random, "uniform",
                                lambda *a, **k: jnp.asarray(unif[i])):
            outs.append(jsam.sweep(jnp.asarray(r[i]), e0[i], keys[i],
                                   jnp.asarray(w), jc, jc.proposal_a,
                                   offset=jnp.int32(off)))
    rj = np.stack([np.asarray(o[0]) for o in outs])
    accj = np.asarray([int(o[3]) for o in outs])
    assert 0 < accj.sum() < c * n

    n_pad = ks.padded_rows(n)
    x, y, z = (torch.cat([torch.as_tensor(r[..., k]).T, torch.full(
        (n_pad - n, c), ks.PARK, dtype=torch.float64)]) for k in range(3))
    wa, wb = (t.double() for t in ks.wall_coeff_rows(torch.as_tensor(w), tc))
    g = torch.roll(torch.as_tensor(noise), -off, dims=1).permute(1, 0, 2)
    args = (x, y, z, torch.as_tensor(np.array(e0))[None], wa, wb,
            torch.tensor([off]), torch.zeros((1, 2), dtype=torch.int64))
    x, y, z, e, _, atr = ks.sweep_block_plain(
        *args, tc, 1, tc.proposal_a,
        draws=(g[None], torch.as_tensor(unif).T[None]))
    np.testing.assert_array_equal(atr[0].numpy(), accj)
    np.testing.assert_allclose(ks.from_planes(x, y, z, tc).numpy(), rj,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(e[0].numpy(),
                               [float(o[1]) for o in outs], rtol=1e-10,
                               atol=1e-10)
    f32 = [t.float() for t in args[:6]] + list(args[6:])
    assert ks._cuda_call(*f32, tc, 1, tc.proposal_a, None, None)[3] == 0


def test_zskip_on_off_bitwise_plain():
    """On the same z-sorted rows z-skip changes which exact zeros are
    summed, never a sum: bitwise equal to dense, and fewer rows visited."""
    n, c = 300, 3
    cfg = TConfig.for_n(n)
    state, w = init_ensemble_state(cfg, seed_words(9), c,
                                   r0=_sorted_start(n, 1, 3)[0],
                                   device="cpu")
    x, y, z, e, wa, wb = ten._kernel_inputs(state, w, cfg)
    words, offsets = ten._per_sweep_randomness(state, cfg, 3, 2)
    args = (x, y, z, e, wa, wb, offsets, words, cfg, 2, cfg.proposal_a)
    dd, dz = {}, {}
    dense = ks.sweep_block_plain(*args, zskip=False, diag=dd)
    skip = ks.sweep_block_plain(*args, zskip=True, diag=dz)
    for a, b in zip(dense, skip):
        assert torch.equal(a, b)
    assert bool((dz["visited"] < dd["visited"]).all())


def test_plain_move_trace():
    """diag={"moves": True}: each move's decision, log_ap, log u and the
    mover's position after it, in move order: away from a tie the
    decisions are log_ap >= 0 or log u < log_ap, they add up to the
    acceptance trace,
    every row's last position is the sweep's result, and the traced run
    is bitwise an untraced one."""
    n, c, sweeps = 300, 3, 2
    cfg = TConfig.for_n(n)
    state, w = init_ensemble_state(cfg, seed_words(9), c,
                                   r0=_sorted_start(n, 1, 3)[0],
                                   device="cpu")
    x, y, z, e, wa, wb = ten._kernel_inputs(state, w, cfg)
    words, offsets = ten._per_sweep_randomness(state, cfg, 3, sweeps)
    args = (x, y, z, e, wa, wb, offsets, words, cfg, sweeps, cfg.proposal_a)
    d = {"moves": True}
    out = ks.sweep_block_plain(*args, zskip=True, diag=d)
    for a, b in zip(out, ks.sweep_block_plain(*args, zskip=True)):
        assert torch.equal(a, b)
    mv = d["moves"]
    assert mv["r"].shape == (sweeps * n, 3, c)
    acc, log_ap, log_u = mv["accept"], mv["log_ap"], mv["log_u"]
    clear = (torch.clamp(log_ap, max=0.0) - log_u).abs() > 1e-5
    assert torch.equal(acc[clear], ((log_ap >= 0) | (log_u < log_ap))[clear])
    assert torch.equal(acc.reshape(sweeps, n, c).sum(1).to(torch.int32),
                       out[5])
    last = offsets[-1] + torch.arange(n)
    rows = last % n
    planes = torch.stack(out[:3], 1)[rows]
    assert torch.equal(mv["r"][-n:], planes)


def test_interpret_pallas_bookkeeping_beside_dense_engine():
    """tpu_smc's Pallas engine (interpret mode) and the port's dense engine
    from one carried-across state: the PRNGs differ, so compare what does
    not depend on them — shapes, dtypes, sweep/accept bookkeeping, the
    trace's last row, carried E against a recompute."""
    n, c, s = 32, 8, 2
    jc, tc = JConfig.for_n(n), TConfig.for_n(n)
    jstate, jw = j_init(jc, jax.random.key(3), c)
    with pltpu.force_tpu_interpret_mode():
        j2, jtr = ensemble_sweeps_pallas(jstate, jw, jc, jc.proposal_a, s,
                                         seed=5, c_tile=c)
    arrays = {f: np.asarray(getattr(jstate, f)) for f in jstate._fields
              if f != "key"}
    arrays["key"] = np.asarray(jax.random.key_data(jstate.key))
    tstate, tw = from_jax_state(arrays, np.asarray(jw), tc, device="cpu")
    np.testing.assert_array_equal(tstate.r.numpy(), arrays["r"])
    t2, ttr = ten.ensemble_sweeps_dense(tstate, tw, tc, tc.proposal_a, s,
                                        seed=5)
    for jout, tout, jt, tt in ((j2, t2, jtr, ttr),):
        assert tuple(tout.r.shape) == np.asarray(jout.r).shape
        assert tuple(tt.energy.shape) == np.asarray(jt.energy).shape == (s, c)
        assert tuple(tt.accepted.shape) == np.asarray(jt.accepted).shape
        assert str(tout.r.dtype).endswith(str(np.asarray(jout.r).dtype))
        np.testing.assert_array_equal(np.asarray(jout.sweeps), s)
        np.testing.assert_array_equal(tout.sweeps.numpy(), s)
    np.testing.assert_array_equal(np.asarray(j2.accepted),
                                  np.asarray(jtr.accepted).sum(0))
    np.testing.assert_array_equal(t2.accepted.numpy(),
                                  ttr.accepted.sum(0).numpy())
    np.testing.assert_array_equal(np.asarray(jtr.energy)[-1],
                                  np.asarray(j2.energy))
    np.testing.assert_array_equal(ttr.energy[-1].numpy(), t2.energy.numpy())
    je = jax.vmap(lambda r: jpot.total_energy(r, jw, jc))(j2.r)
    np.testing.assert_allclose(np.asarray(j2.energy), np.asarray(je),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(t2.energy.numpy(),
                               total_energy(t2.r, tw, tc).numpy(),
                               rtol=1e-4, atol=1e-3)
