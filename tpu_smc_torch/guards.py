"""Runtime guards (counterpart of tpu_smc.guards).

The reference's only runtime checks are console warnings: boundsCheck's
"beta-carotene Valhalla" prints (SMC.c:529-543), perror on I/O, and an
LCA-cutoff warning (SMC.c:1038). Its real failure modes (NaN positions,
particles through a wall, silent energy drift) go unnoticed. Here:

  * state_health — one pass on the state's device returning finiteness,
    bounds violations and energy drift of every chain;
  * HealthError / check_state — raise (or warn) on violations, with the
    reference's wording kept;
  * checked_sweep — a debug mode of the plain engine's sweep that checks
    every term of every move for finiteness and names the first bad one
    (the counterpart of tpu_smc's checkify-wrapped sampler).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import SMCConfig
from .observables import wall_obs_chains
from .potentials import (pair_energy_force_single, total_energy,
                         wall_energy_force_single)
from .sampler import _wrap_proposal
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


# the terms of a move checked_sweep checks, in the order a move evaluates
# them
SWEEP_TERMS = ("pair energy/force at the current position",
               "wall energy/force at the current position",
               "proposal",
               "pair energy/force at the proposal",
               "wall energy/force at the proposal",
               "log_ap")


class SweepError(NamedTuple):
    """The first non-finite term of a checked sweep: which term (one of
    SWEEP_TERMS), in which sweep, move (0-based, in visiting order),
    particle and chain."""
    term: str
    sweep: int
    move: int
    particle: int
    chain: int

    def __str__(self) -> str:
        return (f"non-finite {self.term} in sweep {self.sweep}, move "
                f"{self.move}, particle {self.particle}, chain {self.chain}")


def checked_sweep(cfg: SMCConfig):
    """The plain engine's sweep (`sampler.sweep`, offset form, NVT) with a
    finiteness check of every term of every move: the pair and wall
    energies and forces at the current and the proposed positions, the
    proposal and log_ap. A debug tool that no default path calls.

    Returns fn(r, energy, w, a, noise, unif, offset, temperature=None,
    sweep=0) -> (err, (r, energy, n_accepted)), the arguments and results
    of sampler.sweep; err is None, or the SweepError of the first
    non-finite term (first move, then the term order of SWEEP_TERMS, then
    the lowest chain), `sweep` naming the sweep in it. The terms are the
    ones sampler.sweep computes, in its order, so on a clean state the
    outputs are bitwise sampler.sweep's under the same draws. The checks
    cost one host read per sweep."""

    def fn(r, energy, w, a, noise, unif, offset, temperature=None,
           sweep=0):
        n, c = r.shape[1], r.shape[0]
        t = cfg.temperature if temperature is None else temperature
        if torch.is_tensor(a) or torch.is_tensor(t):
            a, t = (v.to(r.dtype).expand(c) if torch.is_tensor(v) else
                    torch.full((c,), v, dtype=r.dtype, device=r.device)
                    for v in (a, t))
            a_t = (a / t)[:, None]
        else:
            a, t = float(a), float(t)
            a_t = a / t
        r = r.clone()
        acc = torch.zeros(c, dtype=torch.int64, device=r.device)
        zero = torch.zeros((), dtype=r.dtype, device=r.device)
        bad = []

        def finite(*ts):
            ok = torch.ones(c, dtype=torch.bool, device=r.device)
            for v in ts:
                ok = ok & torch.isfinite(v.reshape(c, -1)).all(-1)
            return ok

        def terms(ri):
            pu, pf = pair_energy_force_single(r, i, ri, cfg)
            if not cfg.use_walls:
                return pu, pf, finite(pu, pf), ok_all
            uw, fw = wall_energy_force_single(ri, w, cfg)
            # energy_force_single's sums, in its order
            return pu + uw, pf + fw, finite(pu, pf), finite(uw, fw)

        ok_all = torch.ones(c, dtype=torch.bool, device=r.device)
        for nn in range(n):
            i = (nn + int(offset)) % n
            ri, noise_i = r[:, i], noise[:, i]
            um, fm, ok_pm, ok_wm = terms(ri)
            delta = fm * a_t + noise_i
            rp = _wrap_proposal(ri + delta, cfg)
            un, fn_, ok_pn, ok_wn = terms(rp)
            df = fn_ - fm
            dw = ((df * df).sum(-1) + 2.0 * (df * fm).sum(-1)) * a / (4.0 * t)
            log_ap = -(un - um + 0.5 * (delta * (fn_ + fm)).sum(-1) + dw) / t
            bad.append(~torch.stack([ok_pm, ok_wm, finite(rp), ok_pn, ok_wn,
                                     finite(log_ap)]))
            accept = (unif[:, nn] < torch.exp(torch.clamp(log_ap, max=0.0))) \
                | (log_ap >= 0.0)
            r[:, i] = torch.where(accept[:, None], rp, ri)
            energy = energy + torch.where(accept, un - um, zero)
            acc += accept.to(torch.int64)
        hit = torch.stack(bad).nonzero()          # [k, 3] (move, term, chain)
        err = None
        if hit.shape[0]:
            mv, term, ch = (int(v) for v in hit[0].cpu())
            err = SweepError(SWEEP_TERMS[term], int(sweep), mv,
                             (mv + int(offset)) % n, ch)
        return err, (r, energy, acc)

    return fn
