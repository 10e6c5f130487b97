"""The bug-compatible reference-noise mode (SMCConfig(reference_noise=True),
the C vecBoxMuller's dependent pairs, matematicose.c:187-192) in
tpu_smc_torch against tpu_smc: the pair recipe given the same uniforms,
the sweep move for move in float64 under tpu_smc's own draws, the noise
moments of the counter-based plane, the engines and the routing.

    PYTHONPATH=. python tests/test_torch_refnoise.py [CHAINS]

prints tpu_smc's CPU run of chip_smoke.py's reference-noise state (N = 108
in the default box, T = 1.1, 200 + 600 sweeps, 6 gathers, seed 2024) with
reference_noise=True and with i.i.d. noise: each mean energy with its SE
over CHAINS chains (default 128) and the offset between them."""

import unittest.mock as um

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_smc.potentials as jpot
import tpu_smc.sampler as jsam
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc.rng import GlibcRandom
from tpu_smc.system import build_walls, fcc_lattice
from tpu_smc_torch import cli as tcli
from tpu_smc_torch import ensemble as ten
from tpu_smc_torch import sampler as tsam
from tpu_smc_torch.config import SMCConfig as TConfig
from tpu_smc_torch.kernels import sweep as ks
from tpu_smc_torch.state import init_ensemble_state, seed_words

# tiny tensors: keep torch's intra-op pool from competing with the
# other test workers for cores
torch.set_num_threads(1)


def test_pair_recipe_matches_jax_given_uniforms():
    """ks.pair_noise on tpu_smc's uniforms is the noise tpu_smc.sampler.sweep
    builds from them (tolerance 1e-12). The JAX noise is read off its own
    sweep: four particles 250 apart, cutoff 1, no walls, so every force is
    zero, every move is accepted and each particle moves by its noise."""
    n, a = 4, 0.05
    jc = JConfig(n=n, box_l=1000.0, box_lz=1000.0, dtype="float64",
                 use_walls=False, pbc_z=True, lj_cutoff=1.0,
                 reference_noise=True)
    npairs = (3 * n + 1) // 2
    u = np.random.default_rng(1).uniform(0.0, 1.0, (2, npairs))
    r0 = np.asarray([[-250.0, -250.0, -250.0], [250.0, -250.0, 0.0],
                     [-250.0, 250.0, 250.0], [0.0, 0.0, 100.0]])

    def uniform(key, shape, dtype=None, *args, **kw):
        return jnp.asarray(u) if tuple(shape) == (2, npairs) else \
            jnp.full(shape, 0.5)

    with um.patch.object(jax.random, "uniform", uniform):
        r1, _, _, acc = jsam.sweep(jnp.asarray(r0), jnp.float64(0.0),
                                   jax.random.key(0), jnp.zeros((9, 2)), jc,
                                   a, offset=jnp.int32(0))
    assert int(acc) == n
    noise_j = np.asarray(r1) - r0
    d0, d1 = ks.pair_noise(torch.as_tensor(u[0]), torch.as_tensor(u[1]),
                           np.sqrt(2 * a))
    noise_t = torch.stack([d0, d1], -1).reshape(-1)[:3 * n].reshape(n, 3)
    np.testing.assert_allclose(noise_t.numpy(), noise_j, rtol=0, atol=1e-12)


def _jax_refnoise_sweep(jc, w, r, e0, keys, off):
    """tpu_smc.sampler.sweep(reference_noise=True) of each chain with its
    key, and the uniforms it drew, re-derived from the key split as
    sampler.sweep makes them: (outputs, pair uniforms [C, 2, P], unif
    [C, N])."""
    npairs = (3 * jc.n + 1) // 2
    outs, ups, uns = [], [], []
    for i in range(len(r)):
        outs.append(jsam.sweep(jnp.asarray(r[i]), e0[i], keys[i],
                               jnp.asarray(w), jc, jc.proposal_a,
                               offset=jnp.int32(off)))
        _, k_noise, k_unif, _ = jax.random.split(keys[i], 4)
        ups.append(np.asarray(jax.random.uniform(k_noise, (2, npairs),
                                                 jnp.float64)))
        uns.append(np.asarray(jax.random.uniform(k_unif, (jc.n,),
                                                 jnp.float64)))
    return outs, np.stack(ups), np.stack(uns)


@pytest.mark.parametrize("bulk", [False, True])
def test_refnoise_sweep_matches_jax_float64(bulk):
    """The port's plain sweep (sampler.sweep with the pair noise by
    particle) and the kernel's plain version (pair uniforms injected,
    noise built by the kernel's recipe, read by particle id) are
    tpu_smc.sampler.sweep(reference_noise=True) move for move in float64
    (tolerance 1e-10), walled and bulk. The uniforms are tpu_smc's own,
    re-derived from the JAX key split."""
    n, c, off = 30, 2, 11
    if bulk:
        kw = dict(temperature=1.5, rho=0.3, gamma=0.02 / 1.5,
                  dtype="float64", reference_noise=True)
        jc, tc = JConfig.bulk(n=n, **kw), TConfig.bulk(n=n, **kw)
    else:
        # a small walled box, dense enough for rejections
        kw = dict(n=n, box_l=6.0, box_lz=12.0, dtype="float64",
                  reference_noise=True)
        jc, tc = JConfig(**kw), TConfig(**kw)
    w = build_walls(jc)[0]
    rng = np.random.default_rng(n + bulk)
    r = fcc_lattice(jc)[None] + rng.normal(0.0, 0.05, (c, n, 3))
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(3), i))(
        jnp.arange(c))
    e0 = jax.vmap(lambda x: jpot.total_energy(x, jnp.asarray(w), jc))(
        jnp.asarray(r))
    outs, up, un = _jax_refnoise_sweep(jc, w, r, e0, keys, off)
    rj = np.stack([np.asarray(o[0]) for o in outs])
    ej = np.asarray([float(o[1]) for o in outs])
    accj = np.asarray([int(o[3]) for o in outs])
    assert 0 < accj.sum() < c * n           # accepts and rejects

    # plain engine: pair noise by particle, uniforms by move
    s2a = np.sqrt(2 * jc.proposal_a)
    d0, d1 = ks.pair_noise(torch.as_tensor(up[:, 0]),
                           torch.as_tensor(up[:, 1]), s2a)
    noise = torch.stack([d0, d1], -1).reshape(c, -1)[:, :3 * n] \
        .reshape(c, n, 3)
    tw = torch.as_tensor(w)
    r_t, e_t, acc_t = tsam.sweep(torch.as_tensor(r), torch.as_tensor(
        np.array(e0)), tw, tc, tc.proposal_a, noise, torch.as_tensor(un),
        off)
    np.testing.assert_array_equal(acc_t.numpy(), accj)
    np.testing.assert_allclose(r_t.numpy(), rj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(e_t.numpy(), ej, rtol=1e-10, atol=1e-10)

    # kernel's plain version: pair uniforms [S, P, C, 2], u [S, N, C]
    n_pad = ks.padded_rows(n)
    x, y, z = (torch.cat([torch.as_tensor(r[..., k]).T, torch.full(
        (n_pad - n, c), ks.PARK, dtype=torch.float64)]) for k in range(3))
    wa, wb = (t.double() for t in ks.wall_coeff_rows(tw, tc))
    draws = (torch.as_tensor(up).permute(2, 0, 1)[None],
             torch.as_tensor(un).T[None])
    x, y, z, e, _, atr = ks.sweep_block_plain(
        x, y, z, torch.as_tensor(np.array(e0))[None], wa, wb,
        torch.tensor([off]), torch.zeros((1, 2), dtype=torch.int64), tc, 1,
        tc.proposal_a, draws=draws)
    np.testing.assert_array_equal(atr[0].numpy(), accj)
    np.testing.assert_allclose(ks.from_planes(x, y, z, tc).numpy(), rj,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(e[0].numpy(), ej, rtol=1e-10, atol=1e-10)


def test_reference_noise_plane_moments():
    """The counter-based plane reproduces the reference recipe's dependent
    pair structure: E[d0^2 d1] = -0.498 s^3 and E[d0 d1^2] = +0.274 s^3
    (each within 0.02; ~0 for i.i.d. Gaussians) and std/s = 1 within
    0.01, on one [3 * 4096, 256] plane (1.6 M pairs; tpu_smc checks these
    on the TPU only, tests/test_pallas.py). As tests/test_sampler.py,
    E[d0 d1^2] also agrees with the glibc vecBoxMuller's within 0.01. K5
    on the CPU is this plane."""
    s = 0.3
    d = ks.reference_noise_plane((12345, 678), 4096, 256, s).double()
    assert d.shape == (ks.noise_rows(4096), 256) == (12288, 256)
    assert torch.equal(ks.debug_reference_noise((12345, 678), 4096, 256, s,
                                                "cpu"), d.float())
    d0, d1 = d[0::2].reshape(-1), d[1::2].reshape(-1)
    m21 = float((d0 * d0 * d1).mean()) / s ** 3
    m12 = float((d0 * d1 * d1).mean()) / s ** 3
    assert abs(m21 - (-0.498)) < 0.02, m21
    assert abs(m12 - 0.274) < 0.02, m12
    assert abs(float(d.std()) / s - 1.0) < 0.01
    ref = GlibcRandom(777).box_muller(s, 400_000).reshape(-1, 2)
    assert m12 == pytest.approx(float(np.mean(ref[:, 0] * ref[:, 1] ** 2))
                                / s ** 3, abs=0.01)


def test_pair_stream_is_apart_from_move_stream():
    """Pair k of chain c is Philox of (k, c, 2, 0): not any move's draw
    (move counters (nn, c, 0|1, 0)), and uniforms stay inside (0, 1) so
    log1p(-u) is finite."""
    words = (99, 7)
    up = ks.pair_uniforms(words, 64, 4)
    u5 = ks.move_uniforms(words, 64, 4)
    assert not torch.isin(up.reshape(-1), u5.reshape(-1)).any()
    assert bool(((up > 0) & (up < 1)).all())
    plane = ks.reference_noise_plane(words, 40, 4, 0.2)
    assert plane.shape == (120, 4) and bool(torch.isfinite(plane).all())


def test_refnoise_engines_follow_one_chain():
    """The plain engine draws the kernel's pair noise: the dense engine
    (its plain version on the CPU) follows the same chains in float32
    (positions within 1e-4, accept counts equal); the kernel's dump of a
    reference-noise move is its two pairs' uniforms and u_acc."""
    cfg = TConfig.for_n(32, reference_noise=True)
    state, w = init_ensemble_state(cfg, seed_words(4), 3, device="cpu")
    p, ptr = ten.ensemble_sweeps(state, w, cfg, cfg.proposal_a, 2,
                                 collect_trace=True, stream_seed=9)
    d, dtr = ten.ensemble_sweeps_dense(state, w, cfg, cfg.proposal_a, 2,
                                       seed=9)
    assert torch.equal(ptr.accepted.to(torch.int32), dtr.accepted)
    np.testing.assert_allclose(p.r.numpy(), d.r.numpy(), rtol=0, atol=1e-4)
    iid, _ = ten.ensemble_sweeps(state, w, TConfig.for_n(32), cfg.proposal_a,
                                 2, stream_seed=9)
    assert not torch.equal(iid.r, p.r)

    words, offsets = ten._per_sweep_randomness(state, cfg, 9, 1)
    x, y, z, e, wa, wb = ten._kernel_inputs(state, w, cfg)
    diag = {"uniforms": True}
    ks.sweep_block_plain(x, y, z, e, wa, wb, offsets, words, cfg, 1,
                         cfg.proposal_a, diag=diag)
    du = diag["uniforms"][0]                       # [C, N, 5]
    nn = 5
    i = (nn + int(offsets[0])) % cfg.n
    up = ks.pair_uniforms(words[0], ks.noise_rows(cfg.n) // 2, 3)
    k = 3 * i // 2
    assert torch.equal(du[:, nn, :4], torch.cat([up[k], up[k + 1]], -1))
    assert torch.equal(du[:, nn, 4],
                       ks.move_uniforms(words[0], cfg.n, 3)[nn, :, 4])
    with pytest.raises(NotImplementedError, match="reference_noise"):
        ten.ensemble_sweeps_zsorted(state, w, cfg, cfg.proposal_a, 2, seed=9)


def test_refnoise_routing(monkeypatch):
    """auto keeps reference noise on the dense kernel on a card at every N
    (tpu_smc/cli.py:327-330), torch elsewhere; zsorted stays refused
    (DEVIATIONS A8); the mode never streams."""
    monkeypatch.setattr(ks, "resident_fits", lambda n_pad, device=None,
                        sites=0: (
        torch.device(device or "cuda").type != "cuda" or n_pad <= 4096))
    for n in (108, 1024):
        cfg = TConfig.for_n(n, reference_noise=True)
        assert tcli._resolve_sampler("auto", cfg, "cuda") == "dense"
        assert tcli._resolve_sampler("auto", cfg, "cpu") == "torch"
        assert not ten.zsorted_streams(cfg, "cuda")
    with pytest.raises(SystemExit, match="A8"):
        tcli._resolve_sampler("zsorted", cfg, "cuda")
    with pytest.raises(SystemExit, match="no streamed kernel"):
        tcli._resolve_sampler("dense", TConfig.for_n(8192,
                                                     reference_noise=True),
                              "cuda")


if __name__ == "__main__":
    # tpu_smc's simulate_ensemble (XLA engine, float32) in chip_smoke.py's
    # drive_refnoise state, reference noise beside i.i.d. noise
    import sys
    import time

    from tpu_smc.config import RunParams as JParams
    from tpu_smc.driver import ObservableOptions as JOptions
    from tpu_smc.driver_ensemble import simulate_ensemble as j_simulate
    from tpu_smc.state import init_ensemble_state as j_init

    jax.config.update("jax_platforms", "cpu")
    chains, seed = (int(sys.argv[1]) if len(sys.argv) > 1 else 128), 2024
    res = {}
    for rn in (True, False):
        jc = JConfig.for_n(108, reference_noise=rn)
        state, w = j_init(jc, jax.random.key(seed), chains)
        t0 = time.perf_counter()
        _, agg = j_simulate(jc, JParams(200, 600, 6), state, w,
                            opts=JOptions(clusters=False, sampler="xla",
                                          stream_seed=seed))
        e = np.asarray([ch.mean_energy for ch in agg.chains])
        acc = np.mean([ch.acceptance_ratio for ch in agg.chains])
        res[rn] = (e.mean(), e.std(ddof=1) / np.sqrt(chains))
        print(f"reference_noise={rn}: mean E {res[rn][0]:.6f} +- "
              f"{res[rn][1]:.6f}, acceptance {acc:.6f} ({chains} chains, "
              f"{time.perf_counter() - t0:.0f} s)", flush=True)
    (e1, s1), (e0, s0) = res[True], res[False]
    print(f"offset {(e1 / e0 - 1) * 100:+.4f} % "
          f"({(e1 - e0) / np.hypot(s1, s0):+.2f} combined SE)")
