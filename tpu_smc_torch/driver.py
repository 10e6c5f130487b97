"""Driver pieces shared by the ensemble run (counterpart of the subset of
tpu_smc.driver that `simulate_ensemble` uses).

A run is a sequence of storage windows (STORAGE_TIME, SMC.c:158-182); a
window is a sequence of gathers; a gather is `gather_lapse` sweeps on the
chosen engine followed by the observable pass. The host reads each
gather's outputs; the sweeps themselves never return to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import SMCConfig
from .state import ChainState


def therm_chunk(cfg: SMCConfig, sampler: str = "torch") -> int:
    """Thermalization sweeps per engine call, fixed by (N, engine) alone
    so that seeded runs never depend on host speed; the same rule as
    tpu_smc.driver.therm_chunk."""
    budget = 5e8 if sampler in ("dense", "zsorted") else 1e8
    return max(50, min(2000, int(budget / (cfg.n * cfg.n))))


def _sync(state: ChainState) -> ChainState:
    """Wait for the device work that produced `state`."""
    if state.r.is_cuda:
        torch.cuda.synchronize(state.r.device)
    return state


class GatherOut(NamedTuple):
    """One gather's outputs (host numpy), chains on the last axis."""

    energy_trace: np.ndarray  # [gather_lapse, C] running E per sweep
    accept_trace: np.ndarray  # [gather_lapse, C] accepted moves per sweep
    pressure: np.ndarray      # [C] virial pressure after the block
    l1: np.ndarray            # [C] bonded pairs (0 off the LCA cadence)
    l2: np.ndarray            # [C, 7] num2 histogram
    l3: np.ndarray            # [C, 7] num3 histogram


@dataclass(frozen=True)
class ObservableOptions:
    collect_sweep_trace: bool = True   # full-resolution E/jj traces
    # "torch" (plain engine), "dense" (whole-sweep kernel) or "zsorted"
    # (the kernel with exact z-block skipping)
    sampler: str = "torch"
    # run seed of the per-sweep streams; None derives them from chain 0's
    # key
    stream_seed: int | None = None
    # production mobility A (tuning.tune_mobility); None = gamma*T
    proposal_a: float | None = None


class SimResults(NamedTuple):
    """Per-chain results (the reference's struct Sim, SMC.h:76-88)."""

    mean_energy: float        # mean E incl. 3NT/2 (SMC.c:210-211, 244)
    std_energy: float
    mean_pressure: float      # incl. ideal rho*T (SMC.c:207-208)
    std_pressure: float
    acceptance_ratio: float   # SMC.c:248
    cv: float                 # var(E)/T^2 (SMC.c:250)
    cv_strided: float         # tau-strided variance / T^2 (SMC.c:1128-1142)
    tau: float                # sum of the ACF (SMC.c:235)
    acf: np.ndarray
    r_final: np.ndarray
    l1: float                 # mean bonded pairs per LCA pass
    l2: np.ndarray            # [7] normalized num2 histogram
    l3: np.ndarray            # [7] normalized num3 histogram
    energy_trace: np.ndarray  # per-sweep E (+3NT/2), empty if not collected
    energy_trace_full: np.ndarray  # initial E prepended (SMC.c:47)
    accept_trace: np.ndarray
    pressure_trace: np.ndarray
    density: np.ndarray       # cumulative voxel density [ncx, ncx, ncz]
    mobility: np.ndarray
    gr: Optional[np.ndarray]
    zprofile: Optional[np.ndarray]
    therm_acceptance: float
    sweeps_per_second: float
