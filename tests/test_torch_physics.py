"""tpu_smc_torch physics against tpu_smc in float64: potentials, force as
the negative gradient, and the plain sweep move for move under the JAX
key split's own noise, uniforms and offset (sampler.py:125-145)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_smc.potentials as jpot
import tpu_smc.sampler as jsam
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc.system import build_walls, fcc_lattice
from tpu_smc_torch import potentials as tpot
from tpu_smc_torch import sampler as tsam
from tpu_smc_torch.config import SMCConfig as TConfig

# tiny tensors: keep torch's intra-op pool from competing with the
# other test workers for cores
torch.set_num_threads(1)

N = 32
TOL = 1e-10


def _cfgs(**kw):
    return (JConfig.for_n(N, dtype="float64", **kw),
            TConfig.for_n(N, dtype="float64", **kw))


def _positions(c, seed=0):
    """c chains of a jittered FCC start, one pushed near the lower wall
    and one across the periodic x edge, so every branch is exercised."""
    jc, _ = _cfgs()
    rng = np.random.default_rng(seed)
    r = fcc_lattice(jc)[None] + rng.normal(0.0, 0.4, (c, N, 3))
    r[:, 0, 2] = -jc.box_lz / 2 + 0.9
    r[:, 1, 0] = jc.box_l / 2 - 0.05
    r[:, 2] = r[:, 1] + np.array([0.3, 0.8, 0.1])
    return r


def test_potentials_match_jax_float64():
    jc, tc = _cfgs()
    w = build_walls(jc)[0]
    r = _positions(3)
    rt, wt = torch.as_tensor(r), torch.as_tensor(w)
    rj, wj = jnp.asarray(r), jnp.asarray(w)
    pairs = [
        (tpot.wrap_xy(rt, tc), jax.vmap(lambda x: jpot.wrap_xy(x, jc))(rj)),
        (tpot.pair_energy_total(rt, tc),
         jax.vmap(lambda x: jpot.pair_energy_total(x, jc))(rj)),
        (tpot.pair_virial_pressure(rt, tc),
         jax.vmap(lambda x: jpot.pair_virial_pressure(x, jc))(rj)),
        (tpot.wall_energy_total(rt, wt, tc),
         jax.vmap(lambda x: jpot.wall_energy_total(x, wj, jc))(rj)),
        (tpot.wall_virial_pressure(rt, wt, tc),
         jax.vmap(lambda x: jpot.wall_virial_pressure(x, wj, jc))(rj)),
        (tpot.total_energy(rt, wt, tc),
         jax.vmap(lambda x: jpot.total_energy(x, wj, jc))(rj)),
        (tpot.total_pressure(rt, wt, tc),
         jax.vmap(lambda x: jpot.total_pressure(x, wj, jc))(rj)),
        (tpot.total_forces(rt, wt, tc),
         jax.vmap(lambda x: jpot.total_forces(x, wj, jc))(rj)),
    ]
    for i in (0, 1, 5):
        ri = rt[:, i] + torch.tensor([0.2, -0.1, 0.3], dtype=torch.float64)
        for k, (t, j) in enumerate(zip(
                tpot.energy_force_single(rt, i, ri, wt, tc),
                jax.vmap(lambda x, q: jpot.energy_force_single(
                    x, i, q, wj, jc))(rj, jnp.asarray(ri.numpy())))):
            pairs.append((t, j))
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL)


def test_force_is_minus_gradient():
    _, tc = _cfgs()
    w = torch.as_tensor(build_walls(tc)[0])
    r = torch.as_tensor(_positions(2, seed=1)).requires_grad_(True)
    u = tpot.total_energy(r, w, tc).sum()
    (grad,) = torch.autograd.grad(u, r)
    f = tpot.total_forces(r.detach(), w, tc)
    np.testing.assert_allclose(f.numpy(), -grad.numpy(), rtol=1e-9,
                               atol=1e-9)


def jax_sweep_draws(keys, cfg, a):
    """The noise [C, N, 3], uniforms [C, N] and next keys that
    tpu_smc.sampler.sweep derives from each chain key."""
    def one(k):
        k, kn, ku, _ = jax.random.split(k, 4)
        noise = jnp.sqrt(2.0 * jnp.asarray(a, jnp.float64)) * \
            jax.random.normal(kn, (cfg.n, 3), jnp.float64)
        return k, noise, jax.random.uniform(ku, (cfg.n,), jnp.float64)

    k, noise, unif = jax.vmap(one)(keys)
    return k, np.asarray(noise), np.asarray(unif)


@pytest.mark.parametrize("offset", [0, 13])
def test_sweep_move_for_move_float64(offset):
    jc, tc = _cfgs()
    w = build_walls(jc)[0]
    r = _positions(3, seed=2)
    a = jc.proposal_a
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(4), i))(
        jnp.arange(3))
    e0 = jax.vmap(lambda x: jpot.total_energy(x, jnp.asarray(w), jc))(
        jnp.asarray(r))
    rj, ej, _, accj = jax.vmap(
        lambda x, e, k: jsam.sweep(x, e, k, jnp.asarray(w), jc, a,
                                   offset=jnp.int32(offset)))(
        jnp.asarray(r), e0, keys)
    _, noise, unif = jax_sweep_draws(keys, jc, a)
    rt, et, acct = tsam.sweep(torch.as_tensor(r),
                              torch.as_tensor(np.array(e0)),
                              torch.as_tensor(w), tc, a,
                              torch.as_tensor(noise), torch.as_tensor(unif),
                              offset)
    np.testing.assert_array_equal(acct.numpy(), np.asarray(accj))
    assert 0 < int(acct.min()) and int(acct.max()) <= N
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=TOL,
                               atol=TOL)
