"""Parallel tempering's sampling in the port against tpu_smc: the whole
ladder driver (sweeps at per-chain (A, T), exchanges at the absolute
cycle's parity, per-level harvest) run by both packages on the CPU from
one start, with per-level statistics held within their run-to-run
spread."""

import jax
import numpy as np
import torch

import tpu_smc.pt as jpt
from tpu_smc.config import RunParams
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc_torch import pt as tpt
from tpu_smc_torch.config import SMCConfig as TConfig
from tpu_smc_torch.state import seed_words

# tiny tensors: keep torch's intra-op pool from competing with the
# other test workers for cores
torch.set_num_threads(1)

N = 32


def test_pt_statistics_match_jax():
    """simulate_parallel_tempering in both packages, N = 32, 4 levels x
    64 ladders, exchanges every 2 sweeps, 10 + 30 sweeps from a condensed
    4 x 4 x 2 slab on the lower wall: potential energy, acceptance and
    swap acceptance all depend on the level there (U from -47 to -25,
    acceptance 0.22 to 0.56, swap acceptance 0.16 to 0.54), so
    statistics harvested to the wrong level show (the exchange step
    itself is held bitwise in test_torch_pt.py). Per-level mean E within
    3 combined replica error bars; acceptance within 0.04 and swap
    acceptance within 0.17: 3 combined standard deviations of their
    spread over seeds, pooled over 10 runs of the port and 3 of tpu_smc
    (0.009 and 0.038 at the widest level or pair;
    scripts/torch_stat_spread.py)."""
    temps = [0.6, 0.8, 1.0, 1.2]
    params = RunParams(eqsteps=10, maxsteps=30, numdata=6)
    lz = TConfig.for_n(N).box_lz
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(2),
                             indexing="ij"), -1).reshape(-1, 3)
    r0 = g * 1.5 - [2.25, 2.25, lz / 2 - 1.6]
    _, jr = jpt.simulate_parallel_tempering(
        JConfig.for_n(N), params, temps, jax.random.key(0), chains_per_t=64,
        exchange_interval=2, r0=r0)
    _, tr = tpt.simulate_parallel_tempering(
        TConfig.for_n(N), params, temps, seed_words(0), chains_per_t=64,
        exchange_interval=2, r0=r0, sampler="torch", device="cpu")
    js, ts = jr.tsweep, tr.tsweep
    assert ts.energy_samples.shape == js.energy_samples.shape == (6, 4, 64)
    se = np.hypot(ts.err_energy, js.err_energy)
    assert (np.abs(ts.mean_energy - js.mean_energy) < 3 * se).all(), \
        (ts.mean_energy, js.mean_energy, se)
    np.testing.assert_allclose(ts.acceptance, js.acceptance, atol=0.04)
    np.testing.assert_array_equal(tr.swap_attempts, jr.swap_attempts)
    np.testing.assert_allclose(tr.swap_acceptance, jr.swap_acceptance,
                               atol=0.17)
    # the levels and pairs lie far apart on every measure
    assert (np.diff(ts.mean_energy) > 10 * se.max()).all()
    assert (np.diff(ts.acceptance) > 0.05).all()
    assert (np.diff(tr.swap_acceptance) > 0.1).all(), tr.swap_acceptance
