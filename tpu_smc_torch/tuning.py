"""Proposal-mobility auto-tuning to a target acceptance ratio
(counterpart of tpu_smc.tuning).

The reference fixes A = gamma*T with gamma = 1.0 (main.c:48-51), which
lands the default system near 0.97 acceptance. `tune_mobility` finds the
A that gives a requested acceptance before the run starts, by an adaptive
multiplicative search in A on short measurement blocks; production then
holds the tuned A fixed, so detailed balance is untouched (the tuning
sweeps only advance the chains, like extra thermalization).
`tune_mobility_ladder` does the same per temperature level of a ladder,
measured at once on one [n_t x chains_per_t] ensemble.

On the kernel engines every probe goes through the dense kernel with the
mobility as run-time data (the launch's scale rows), so a new A costs no
rebuild. The searches themselves (`search_mobility`,
`search_mobility_ladder`) run on a `measure(a) -> acceptance` function.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .config import SMCConfig
from .state import ChainState


class LadderTuneResult(NamedTuple):
    temps: np.ndarray          # [n_t]
    a_per_t: np.ndarray        # [n_t] tuned mobility per level
    acceptance: np.ndarray     # [n_t] measured at the returned ladder
    gamma_per_t: np.ndarray    # [n_t] A_t / T_t
    sweeps_used: int


class TuneResult(NamedTuple):
    proposal_a: float          # tuned mobility
    acceptance: float          # measured at the returned A
    gamma: float               # tuned A / T (the reference's knob)
    history: list              # [(A, acceptance), ...] per probe block
    sweeps_used: int


def mobility_cap(cfg: SMCConfig) -> float:
    """A proposal std sqrt(2A) beyond L/2 is pointless under the periodic
    wrap: the searches stop at (L/2)^2 / 2."""
    return (float(cfg.box_l) / 2.0) ** 2 / 2.0


def _check_target(target: float) -> None:
    if not 0.0 < target < 1.0:
        raise ValueError(f"target acceptance must be in (0, 1): {target}")


def search_mobility(measure: Callable[[float], float], a0: float,
                    target: float, a_cap: float, max_blocks: int = 16,
                    tol: float = 0.02, burn_in_blocks: int = 2):
    """tpu_smc.tuning.tune_mobility's search: burn-in blocks at the start
    A, then a multiplicative step (factor 4) whose factor shrinks by a
    square root on every direction reversal, until |acc - target| <= tol,
    max_blocks probes, or A pinned at the cap. Drift tolerant: it keeps
    no bracket that early, unequilibrated measurements could poison.
    Returns (a, acceptance, history [(A, acc)], blocks incl. burn-in)."""
    a = min(float(a0), a_cap)
    for _ in range(burn_in_blocks):
        measure(a)
    history = []
    blocks = 0
    factor = 4.0
    prev_up = None
    acc = measure(a)
    history.append((a, acc))
    blocks += 1
    while abs(acc - target) > tol and blocks < max_blocks:
        up = acc > target              # too much acceptance -> grow A
        if prev_up is not None and up != prev_up:
            factor = math.sqrt(factor)
        prev_up = up
        a = min(a * factor, a_cap) if up else a / factor
        if history and a == history[-1][0] == a_cap:
            break   # pinned at the cap: acceptance stays above target
        acc = measure(a)
        history.append((a, acc))
        blocks += 1
    return a, acc, history, blocks + burn_in_blocks


def search_mobility_ladder(measure: Callable[[np.ndarray], np.ndarray],
                           a_t: np.ndarray, target: float, a_cap: float,
                           max_blocks: int = 16, tol: float = 0.02,
                           burn_in_blocks: int = 2):
    """tpu_smc.tuning.tune_mobility_ladder's search, one multiplicative
    search per level on a measure(a_t [n_t]) -> acceptance [n_t]; levels
    within tol, or pinned at the cap with acceptance above target, stop
    moving. Returns (a_t, acceptance, blocks incl. burn-in)."""
    a_t = np.minimum(np.asarray(a_t, np.float64), a_cap)
    n_t = len(a_t)
    for _ in range(burn_in_blocks):
        measure(a_t)
    factors = np.full(n_t, 4.0)
    prev_up = [None] * n_t
    blocks = 0
    acc_t = measure(a_t)
    blocks += 1
    while blocks < max_blocks:
        live = (np.abs(acc_t - target) > tol) \
            & ~((a_t >= a_cap) & (acc_t > target))   # cap-pinned levels
        if not live.any():
            break
        for i in np.flatnonzero(live):
            up = acc_t[i] > target
            if prev_up[i] is not None and up != prev_up[i]:
                factors[i] = math.sqrt(factors[i])
            prev_up[i] = up
            a_t[i] = min(a_t[i] * factors[i], a_cap) if up \
                else a_t[i] / factors[i]
        acc_t = measure(a_t)
        blocks += 1
    return a_t, acc_t, blocks + burn_in_blocks


def tune_mobility(cfg: SMCConfig, state: ChainState, w: torch.Tensor,
                  target: float = 0.5, sampler: str = "torch",
                  sweeps_per_block: int = 25, max_blocks: int = 16,
                  tol: float = 0.02, burn_in_blocks: int = 2,
                  seed: int | None = None, chain0: int = 0,
                  pooled: bool = False, devices=None):
    """Tune one A for every chain of `state` (leading chain axis) to the
    target acceptance. The kernel engines probe through the dense
    kernel. Returns (advanced state, TuneResult): the tuning sweeps
    double as burn-in. chain0: the global index of the state's chain 0;
    pooled: every probe's acceptance is the job's, gathered from every
    process (collective), so that every process tunes the same A as one
    process running all the chains would. devices: every probe block
    runs with the chains split over these devices (the sharded engines;
    tpu_smc's `mesh`), its acceptance pooled over them in chain order,
    so the tuned A is bitwise one device's."""
    _check_target(target)
    from . import ensemble as ens

    t = float(cfg.temperature)
    k = sweeps_per_block
    dense = sampler in ("dense", "zsorted")

    def measure(a_val: float) -> float:
        nonlocal state
        state = state.replace(accepted=torch.zeros_like(state.accepted))
        if devices:
            fn = (ens.ensemble_sweeps_dense_sharded if dense
                  else ens.ensemble_sweeps_sharded)
            state, _ = fn(state, w, cfg, a_val, k, seed, list(devices),
                          chain0=chain0)
        elif dense:
            state, _ = ens.ensemble_sweeps_dense(state, w, cfg, a_val, k,
                                                 seed=seed, chain0=chain0)
        else:
            state, _ = ens.ensemble_sweeps(state, w, cfg, a_val, k,
                                           stream_seed=seed, chain0=chain0)
        moves = state.accepted.cpu().numpy().astype(np.int64)
        if pooled:
            from .distributed import allgather_chain_axis

            moves = allgather_chain_axis(moves)
        return float(moves.mean()) / (k * cfg.n)

    a, acc, history, blocks = search_mobility(
        measure, cfg.proposal_a, target, mobility_cap(cfg), max_blocks, tol,
        burn_in_blocks)
    state = state.replace(accepted=torch.zeros_like(state.accepted))
    return state, TuneResult(proposal_a=a, acceptance=acc, gamma=a / t,
                             history=history, sweeps_used=blocks * k)


def tune_mobility_ladder(cfg: SMCConfig, temps, key: torch.Tensor,
                         w: np.ndarray | None = None, chains_per_t: int = 16,
                         target: float = 0.5, sampler: str = "torch",
                         sweeps_per_block: int = 25, max_blocks: int = 16,
                         tol: float = 0.02, burn_in_blocks: int = 2,
                         device="cuda") -> LadderTuneResult:
    """Per-level mobility for the ladder drivers (tsweep / pt): every
    temperature gets its own A_t hitting `target`, measured at once on
    one [n_t x chains_per_t] ensemble started from the lattice (each
    level's acceptance is its own chain group's counter). The kernel
    engines probe through the dense kernel's per-chain rows. Pass the
    result to simulate_temperature_sweep / simulate_parallel_tempering
    as `a_per_t`."""
    _check_target(target)
    from . import tsweep
    from .state import init_ensemble_state

    temps = np.asarray(temps, np.float64)
    n_t = len(temps)
    state, w_t = init_ensemble_state(cfg, key, n_t * chains_per_t, w=w,
                                     device=device)
    temps_c = torch.as_tensor(np.repeat(temps, chains_per_t),
                              dtype=torch.float64, device=device)
    k = sweeps_per_block
    probe = "dense" if sampler in ("dense", "zsorted") else "torch"

    def measure(a_t: np.ndarray) -> np.ndarray:
        nonlocal state
        state = state.replace(accepted=torch.zeros_like(state.accepted))
        a_c = torch.as_tensor(np.repeat(a_t, chains_per_t),
                              dtype=torch.float64, device=device)
        state, _ = tsweep._ladder_block(state, w_t, cfg, temps_c, 1.0, k,
                                        probe, a_c=a_c)
        moves = state.accepted.cpu().numpy().astype(np.int64)
        return moves.reshape(n_t, chains_per_t).mean(axis=1) / (k * cfg.n)

    a_t, acc_t, blocks = search_mobility_ladder(
        measure, cfg.gamma * temps, target, mobility_cap(cfg), max_blocks,
        tol, burn_in_blocks)
    return LadderTuneResult(temps=temps, a_per_t=a_t, acceptance=acc_t,
                            gamma_per_t=a_t / temps,
                            sweeps_used=blocks * k)
