"""The Smart (force-biased) Monte Carlo sweep, plain PyTorch — the port's
reference engine and the oracle its kernel is held against
(counterpart of tpu_smc.sampler; reference: oneParticleMoves,
SMC.c:278-351).

One sweep makes N single-particle moves in cyclic order from `offset`.
Each move proposes

    delta = F * A/T + xi,        xi ~ N(0, 2A)        (SMC.c:284, 307-309)

wraps the proposal in x, y (SMC.c:315-316), and accepts with

    ap = exp(-(dU + delta.(Fn+Fm)/2 + dW)/T)           (SMC.c:329)
    dW = (|Fn|^2 - |Fm|^2) * A/(4T)                    (SMC.c:326-327)

The moves are sequential; every tensor carries a leading chain axis [C]
and all chains share the visiting order. A and T are scalars or one value
per chain (temperature ladders, tsweep.py), and the wall table is shared
[M*M, 2] or per chain [C, M*M, 2] (quenched disorder). Randomness is
injected: the caller passes the proposal noise (indexed by particle, like
the reference's displ[3n]) and the acceptance uniforms (indexed by move).
With cfg.reference_noise that noise is the reference's dependent
Box-Muller pair vector (matematicose.c:187-192, tpu_smc.sampler's
reference_noise branch), which ensemble.ensemble_sweeps draws from the
counter-based pair stream (kernels.sweep.reference_noise_plane).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import SMCConfig
from .potentials import energy_force_single, split_chains, total_energy
from .state import ChainState


class SweepStats(NamedTuple):
    """Per-sweep traces [S, C]: running energy and accepted moves."""

    energy: torch.Tensor
    accepted: torch.Tensor


def _wrap_proposal(rp: torch.Tensor, cfg: SMCConfig,
                   box=None) -> torch.Tensor:
    """Periodic wrap of proposals [C, 3]: x, y always; z in bulk only.
    box [C]: the per-chain cubic side in place of cfg's (NPT, Gibbs),
    element for element the same operations."""
    if box is not None:
        assert cfg.pbc_z, "a per-chain box is bulk-only"
        b = box[:, None]
        return rp - b * torch.round(rp / b)
    l = cfg.box_l
    x = rp[:, 0] - l * torch.round(rp[:, 0] / l)
    y = rp[:, 1] - l * torch.round(rp[:, 1] / l)
    z = rp[:, 2]
    if cfg.pbc_z:
        z = z - cfg.box_lz * torch.round(z / cfg.box_lz)
    return torch.stack([x, y, z], dim=-1)


def sweep(r: torch.Tensor, energy: torch.Tensor, w: torch.Tensor,
          cfg: SMCConfig, a, noise: torch.Tensor, unif: torch.Tensor,
          offset: int, temperature=None, umbrella=None, order=None,
          box=None, active=None):
    """One sweep of every chain.

    r [C, N, 3], energy [C]; noise [C, N, 3] is the proposal noise
    sqrt(2A) * xi by particle (the pair recipe's under
    cfg.reference_noise), unif [C, N] the acceptance uniforms by move,
    offset the shared cyclic start (SMC.c:290). a, temperature: scalars
    or [C] (None = cfg.temperature); w [M*M, 2] or [C, M*M, 2].

    umbrella = (tag, k_spring, z0): the harmonic bias b(z) = k/2 (z_tag -
    z0)^2 on particle `tag`'s z, z0 a scalar or one window center per
    chain [C] (umbrella.py). As in tpu_smc.sampler.sweep it enters only
    the acceptance of the tagged particle's moves, -(b(z') - b(z))/T;
    the force-biased proposal is unchanged, so each move is an exact
    Metropolis-Hastings step for exp(-(U + b)/T), and the carried energy
    stays the physical U.

    order: the visiting order [N] (int64, on r's device) in place of
    `offset`: particles are then read and written through index ops,
    with no host read, so that the sweep can be captured in a CUDA graph
    (run_step); the results are bitwise those of the offset form.

    box [C]: each chain's cubic side (bulk only; the NPT and Gibbs
    engines), in place of cfg's dims. active [C, N] bool: the capacity
    slots of GCMC and Gibbs, tpu_smc.gcmc.masked_disp_pass: only active
    particles interact, and a move of an inactive slot is never
    accepted. With both None the operations are the NVT sweep's.
    Returns (r, energy, n_accepted [C])."""
    n = r.shape[1]
    t = cfg.temperature if temperature is None else temperature
    if torch.is_tensor(a) or torch.is_tensor(t):
        c = r.shape[0]
        # a float becomes a filled row (no host copy: a CUDA graph may be
        # capturing)
        a, t = (v.to(r.dtype).expand(c) if torch.is_tensor(v) else
                torch.full((c,), v, dtype=r.dtype, device=r.device)
                for v in (a, t))
        a_t = (a / t)[:, None]
    else:
        a, t = float(a), float(t)
        a_t = a / t
    if umbrella is not None:
        u_tag = int(umbrella[0])
        u_k, u_z0 = (torch.as_tensor(v, dtype=r.dtype, device=r.device)
                     for v in umbrella[1:])
    r = r.clone()
    acc = torch.zeros(r.shape[0], dtype=torch.int64, device=r.device)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    for nn in range(n):
        if order is None:
            i = (nn + int(offset)) % n
            ri, noise_i = r[:, i], noise[:, i]
        else:
            sel = order[nn:nn + 1]
            i = order[nn]
            ri = r.index_select(1, sel)[:, 0]
            noise_i = noise.index_select(1, sel)[:, 0]
        um, fm = energy_force_single(r, i, ri, w, cfg, active, box)
        # acceptance uses the UNWRAPPED delta, energies the wrapped
        # position (SMC.c:307-316)
        delta = fm * a_t + noise_i
        rp = _wrap_proposal(ri + delta, cfg, box)
        un, fn = energy_force_single(r, i, rp, w, cfg, active, box)
        df = fn - fm
        dw = ((df * df).sum(-1) + 2.0 * (df * fm).sum(-1)) * a / (4.0 * t)
        log_ap = -(un - um + 0.5 * (delta * (fn + fm)).sum(-1) + dw) / t
        if umbrella is not None and (order is not None or i == u_tag):
            db = 0.5 * u_k * ((rp[:, 2] - u_z0) ** 2 - (ri[:, 2] - u_z0) ** 2)
            if order is not None:       # x - 0/t == x: bitwise the branch
                db = torch.where(i == u_tag, db, zero)
            log_ap = log_ap - db / t
        accept = (unif[:, nn] < torch.exp(torch.clamp(log_ap, max=0.0))) \
            | (log_ap >= 0.0)
        if active is not None:
            accept = accept & (active[:, i] if order is None
                               else active.index_select(1, sel)[:, 0])
        new = torch.where(accept[:, None], rp, ri)
        if order is None:
            r[:, i] = new
        else:
            r.index_copy_(1, sel, new[:, None])
        energy = energy + torch.where(accept, un - um, zero)
        acc += accept.to(torch.int64)
    return r, energy, acc


class GraphStep:
    """A step function of tensors captured once in a CUDA graph and
    replayed: a plain-engine sweep (ensemble_sweeps, and the ensemble
    family's sweeps in gcmc, npt and gibbs), tens to hundreds of
    thousands of small launches, replays as one graph launch.
    EVERY tensor the step reads is an argument, and every argument is a
    static input buffer that each call copies in: positions, masks,
    energies, the per-chain box sides (a volume move changes them every
    sweep), the seed words and the visiting order. So no value is held
    as captured, a graph never replays a stale box, and one graph
    serves a whole run. fn must not write to its arguments; a replay is
    bitwise the eager call on the same arguments."""

    def __init__(self, fn, args):
        dev = args[0].device
        self.bufs = tuple(a.clone() for a in args)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*self.bufs)               # warm-up outside the capture
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(*self.bufs)

    def __call__(self, *args):
        for b, a in zip(self.bufs, args):
            b.copy_(a)
        self.graph.replay()
        return tuple(o.clone() for o in self.out)


_STEPS: dict = {}       # captured GraphSteps by key, newest last


# captured GraphSteps kept per device: a run sharded over k cards
# alternates k devices' graphs in every sweep, each card's modes (the
# doubled thermalization A beside production, a ladder's per-chain rows)
# then stay captured
STEPS_PER_DEVICE = 8


def run_step(key, fn, args):
    """fn(*args): eagerly for CPU tensors; on the card through the
    GraphStep captured for `key` (the step's mode and every static value
    fn closes over), the arguments' shapes and dtypes and the unsplit
    call's chains (potentials.split_chains: the order of its row sums),
    captured on first use; the STEPS_PER_DEVICE most recent of each device are
    kept."""
    if not args[0].is_cuda:
        return fn(*args)
    dev = str(args[0].device)
    key = (key, dev, split_chains(),
           tuple((tuple(a.shape), a.dtype, str(a.device)) for a in args))
    step = _STEPS.pop(key, None)
    if step is None:
        step = GraphStep(fn, args)
    _STEPS[key] = step
    mine = [k for k in _STEPS if k[1] == dev]
    for old in mine[:-STEPS_PER_DEVICE]:
        del _STEPS[old]
    return step(*args)


def sweep_state(state: ChainState, w: torch.Tensor, cfg: SMCConfig,
                a, noise: torch.Tensor, unif: torch.Tensor,
                offset: int, temperature=None, umbrella=None):
    """One sweep on a ChainState (umbrella: see `sweep`). Returns (state,
    SweepStats row)."""
    r, e, acc = sweep(state.r, state.energy, w, cfg, a, noise, unif, offset,
                      temperature=temperature, umbrella=umbrella)
    new = state.replace(r=r, energy=e, sweeps=state.sweeps + 1,
                        accepted=state.accepted + acc)
    return new, SweepStats(energy=e, accepted=acc)


def run_sweeps(state: ChainState, w: torch.Tensor, cfg: SMCConfig,
               a: float, n_sweeps: int, collect_trace: bool = True,
               seed=None):
    """`n_sweeps` consecutive sweeps of every chain (the main loop body,
    SMC.c:134-196), on the plain engine with the counter-based draws of
    ensemble._per_sweep_randomness."""
    from .ensemble import ensemble_sweeps

    return ensemble_sweeps(state, w, cfg, a, n_sweeps,
                           collect_trace=collect_trace, stream_seed=seed)


def recompute_energy(state: ChainState, w: torch.Tensor,
                     cfg: SMCConfig) -> ChainState:
    """Replace the tracked energy by an exact recompute (the reference
    never does; float32 drift needs it, SURVEY §7.4.5)."""
    from .observables import wall_obs_chains

    e = wall_obs_chains(lambda rb, wb: total_energy(rb, wb, cfg), state.r, w,
                        cfg.n)
    return state.replace(energy=e.to(state.energy.dtype))


def thermalize(state: ChainState, w: torch.Tensor, cfg: SMCConfig,
               eqsteps: int, collect_trace: bool = True, seed=None):
    """Thermalization: eqsteps sweeps with A doubled (SMC.c:110-125)."""
    return run_sweeps(state, w, cfg, 2.0 * cfg.proposal_a, eqsteps,
                      collect_trace=collect_trace, seed=seed)
