#!/usr/bin/env python
"""Seed-to-seed spread of the statistics that the port's CPU ladder tests
compare with tpu_smc, on the CPU.

tests/test_torch_ladder.py::test_tsweep_statistics_match_jax and
tests/test_torch_pt_sampling.py::test_pt_statistics_match_jax hold per-
level acceptance (and swap acceptance) of one port run against one
tpu_smc run within fixed tolerances. This script reruns those exact
setups over seeds and prints, per level or pair, the mean and standard
deviation across seeds: the run-to-run spread that the tolerances are
3 combined standard deviations of.

    python scripts/torch_stat_spread.py     # ~3 min on one core
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N = 32


def slab(lz: float, jitter_seed: int | None) -> np.ndarray:
    """The tests' start: a 4 x 4 x 2 slab of spacing 1.5 on the lower
    wall, jittered by 0.05 when jitter_seed is given."""
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(2),
                             indexing="ij"), -1).reshape(-1, 3) * 1.5
    r = g - [2.25, 2.25, lz / 2 - 1.6]
    if jitter_seed is not None:
        r = r + np.random.default_rng(jitter_seed).normal(0.0, 0.05, r.shape)
    return r


def spread(rows) -> dict:
    x = np.asarray(rows)
    return {"mean": x.mean(0).round(5).tolist(),
            "sd": x.std(0, ddof=1).round(5).tolist(), "runs": len(x)}


def main() -> int:
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    from tpu_smc import pt as jpt
    from tpu_smc.config import RunParams
    from tpu_smc.config import SMCConfig as JConfig
    from tpu_smc.tsweep import simulate_temperature_sweep as jsweep
    from tpu_smc_torch import pt as tpt
    from tpu_smc_torch import tsweep as tts
    from tpu_smc_torch.config import SMCConfig as TConfig
    from tpu_smc_torch.state import seed_words

    params = RunParams(eqsteps=10, maxsteps=30, numdata=6)
    lz = TConfig.for_n(N).box_lz
    out = {}

    # test_tsweep_statistics_match_jax: 2 levels x 384 chains
    r0, temps = slab(lz, 7), [0.6, 1.2]
    port = [tts.simulate_temperature_sweep(
        TConfig.for_n(N), params, temps, seed_words(s), chains_per_t=384,
        r0=r0, sampler="torch", device="cpu")[1].acceptance
        for s in range(8)]
    ref = [jsweep(JConfig.for_n(N), params, temps, jax.random.key(s),
                  chains_per_t=384, r0=r0)[1].acceptance for s in range(3)]
    out["tsweep acceptance"] = {"port": spread(port), "tpu_smc": spread(ref)}

    # test_pt_statistics_match_jax: 4 levels x 64 ladders, interval 2
    r0, temps = slab(lz, None), [0.6, 0.8, 1.0, 1.2]
    runs = [tpt.simulate_parallel_tempering(
        TConfig.for_n(N), params, temps, seed_words(s), chains_per_t=64,
        exchange_interval=2, r0=r0, sampler="torch", device="cpu")[1]
        for s in range(10, 20)]
    out["pt acceptance"] = {"port": spread([r.tsweep.acceptance
                                            for r in runs])}
    out["pt swap acceptance"] = {"port": spread([r.swap_acceptance
                                                 for r in runs])}
    ref = [jpt.simulate_parallel_tempering(
        JConfig.for_n(N), params, temps, jax.random.key(s), chains_per_t=64,
        exchange_interval=2, r0=r0)[1] for s in range(10, 13)]
    out["pt acceptance"]["tpu_smc"] = spread([r.tsweep.acceptance
                                              for r in ref])
    out["pt swap acceptance"]["tpu_smc"] = spread([r.swap_acceptance
                                                   for r in ref])
    for name, v in out.items():
        print(f"{name}: {json.dumps(v)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
