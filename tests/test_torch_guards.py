"""guards.checked_sweep (the port's counterpart of tpu_smc's checkify
sweep): bitwise the plain engine's sweep on a clean state, and the first
non-finite term named with its sweep, move, particle and chain
(CPU, N = 32, float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_smc import guards as jguards
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc.system import build_walls as jbuild_walls
from tpu_smc.system import fcc_lattice as jfcc
from tpu_smc_torch import guards, sampler
from tpu_smc_torch.config import SMCConfig
from tpu_smc_torch.potentials import total_energy
from tpu_smc_torch.system import build_walls, fcc_lattice

N, C = 32, 4


def _setup(seed=0):
    cfg = SMCConfig.for_n(N, temperature=1.1, dtype="float64")
    r = torch.tensor(fcc_lattice(cfg))[None].repeat(C, 1, 1)
    w = torch.tensor(build_walls(cfg)[0])
    rng = np.random.default_rng(seed)
    noise = torch.tensor(rng.normal(size=(C, N, 3))
                         * np.sqrt(2.0 * cfg.proposal_a))
    unif = torch.tensor(rng.uniform(size=(C, N)))
    return cfg, r, w, noise, unif


@pytest.mark.parametrize("per_chain_t", [False, True])
def test_clean_state_is_bitwise_the_plain_sweep(per_chain_t):
    cfg, r, w, noise, unif = _setup()
    e = total_energy(r, w, cfg)
    t = torch.tensor([1.0, 1.1, 1.2, 1.3], dtype=torch.float64) \
        if per_chain_t else None
    fn = guards.checked_sweep(cfg)
    rr, ee = r, e
    for s, off in enumerate((5, 17, 0)):
        err, (r1, e1, a1) = fn(rr, ee, w, cfg.proposal_a, noise, unif, off,
                               temperature=t, sweep=s)
        r2, e2, a2 = sampler.sweep(rr, ee, w, cfg, cfg.proposal_a, noise,
                                   unif, off, temperature=t)
        assert err is None
        assert torch.equal(r1, r2) and torch.equal(e1, e2) \
            and torch.equal(a1, a2)
        rr, ee = r1, e1
    assert int(a1.sum()) > 0


def test_overlap_named_in_both_packages():
    """Two particles on one site: tpu_smc's checkify sweep reports an
    error, the port's names the pair term, the particle and the chain."""
    jcfg = JConfig.for_n(N, temperature=1.1, dtype="float64")
    r0 = jfcc(jcfg)
    r0[7] = r0[3]
    jw = jnp.asarray(jbuild_walls(jcfg)[0])
    jfn = jguards.checked_sweep(jcfg)
    jerr, _ = jfn(jnp.asarray(r0), jnp.asarray(0.0), jax.random.key(0), jw,
                  jcfg.proposal_a)
    assert jerr.get() is not None

    cfg, r, w, noise, unif = _setup()
    r[2, 7] = r[2, 3]
    e = torch.zeros(C, dtype=torch.float64)
    err, (r1, e1, acc) = guards.checked_sweep(cfg)(
        r, e, w, cfg.proposal_a, noise, unif, 5, sweep=11)
    assert err is not None
    assert err.term == "pair energy/force at the current position"
    assert (err.sweep, err.chain) == (11, 2)
    # the first of the two to move in the visiting order 5, 6, ...
    assert err.particle == 7 and err.move == 2
    assert "particle 7" in str(err) and "chain 2" in str(err)
    # the outputs are still the plain sweep's
    r2, e2, a2 = sampler.sweep(r, e, w, cfg, cfg.proposal_a, noise, unif, 5)
    assert torch.equal(torch.nan_to_num(r1), torch.nan_to_num(r2))
    assert torch.equal(acc, a2)


@pytest.mark.parametrize("where", ["wall", "proposal"])
def test_other_terms_named(where):
    cfg, r, w, noise, unif = _setup(1)
    e = total_energy(r, w, cfg)
    if where == "wall":
        # NaN site coefficients reach a particle within the cutoff of a
        # wall: particle 6 of chain 1, one unit above the lower wall
        w = w.clone()
        w[:] = float("nan")
        r = r.clone()
        r[1, 6, 2] = -cfg.box_lz / 2.0 + 1.0
        want, chain = "wall energy/force at the current position", 1
    else:
        noise = noise.clone()
        noise[3, 9, 1] = float("inf")
        want, chain = "proposal", 3
    err, _ = guards.checked_sweep(cfg)(r, e, w, cfg.proposal_a, noise, unif,
                                       0)
    assert err is not None and err.term == want and err.chain == chain
    assert (err.move, err.particle) == ((6, 6) if where == "wall"
                                        else (9, 9))
