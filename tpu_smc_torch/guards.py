"""Runtime guards (counterpart of tpu_smc.guards without its checkify
sweep).

The reference's only runtime checks are console warnings: boundsCheck's
"beta-carotene Valhalla" prints (SMC.c:529-543), perror on I/O, and an
LCA-cutoff warning (SMC.c:1038). Its real failure modes (NaN positions,
particles through a wall, silent energy drift) go unnoticed. Here:

  * state_health — one pass on the state's device returning finiteness,
    bounds violations and energy drift of every chain;
  * HealthError / check_state — raise (or warn) on violations, with the
    reference's wording kept.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import SMCConfig
from .observables import wall_obs_chains
from .potentials import total_energy
from .state import ChainState


class StateHealth(NamedTuple):
    finite: torch.Tensor        # bool: all positions and energies finite
    escaped_xy: torch.Tensor    # int64: particles outside the periodic box
    through_wall: torch.Tensor  # int64: particles beyond +-Lz/2
    energy_drift: torch.Tensor  # max over chains |carried E - recomputed E|


def state_health(state: ChainState, w: torch.Tensor,
                 cfg: SMCConfig) -> StateHealth:
    """Health of every chain of `state` (r [C, N, 3]); w is the shared
    wall table or per-chain tables [C, M*M, 2]. The exact energies run in
    bounded chain batches, like every all-pairs observable."""
    r = state.r
    finite = torch.isfinite(r).all() & torch.isfinite(state.energy).all()
    half_l = cfg.box_l / 2.0
    esc = ((r[..., 0].abs() > half_l + 1e-6)
           | (r[..., 1].abs() > half_l + 1e-6)).sum()
    wall = (r[..., 2].abs() > cfg.box_lz / 2.0).sum()
    exact = wall_obs_chains(lambda rb, wb: total_energy(rb, wb, cfg), r, w,
                            cfg.n)
    drift = (exact - state.energy).abs().max()
    return StateHealth(finite, esc, wall, drift)


class HealthError(RuntimeError):
    pass


def check_state(state: ChainState, w: torch.Tensor, cfg: SMCConfig,
                drift_tol: float = 1e-2, strict: bool = True) -> StateHealth:
    """Host-side verdict on a health pass: raise HealthError naming every
    problem, or with strict=False print it as a warning and go on (the
    reference's behaviour)."""
    h = state_health(state, w, cfg)
    problems = []
    if not bool(h.finite):
        problems.append("non-finite positions or energies")
    if int(h.escaped_xy):
        problems.append(
            f"{int(h.escaped_xy)} particles escaping to the "
            "beta-carotene Valhalla"  # boundsCheck wording, SMC.c:535
        )
    if int(h.through_wall):
        problems.append(f"{int(h.through_wall)} particles smashed through "
                        "a wall")
    if float(h.energy_drift) > drift_tol:
        problems.append(f"energy drift {float(h.energy_drift):.3e} > "
                        f"{drift_tol}")
    if problems:
        msg = "; ".join(problems)
        if strict:
            raise HealthError(msg)
        print(f"WARNING: {msg}")
    return h
