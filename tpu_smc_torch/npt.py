"""Isothermal-isobaric (NPT) Monte Carlo: the bulk fluid at constant
pressure (counterpart of tpu_smc.npt; the reference is strictly NVT).

The cubic box side L is a per-chain tensor [C] riding the chain batch,
like the temperature of a ladder: the pair physics takes it through the
`box` argument of potentials and sampler.sweep, and positions stay
physical (a volume move rescales them by L'/L). An NPT sweep is one
smart-MC displacement pass over the N particles at the chain's current
L, then one volume move in ln V (Frenkel & Smit ch. 5.4),

    ln V' = ln V + dlnv (2u - 1),
    accept with min(1, exp(-(dU + P dV)/T + (N+1) ln(V'/V))),

which recomputes U' exactly (pair_energy_total at L', in chain blocks
within PAIR_BUDGET). The scale is taken from the step, exp(step/3), so
dlnv = 0 scales by exactly 1.0 and an NPT run with frozen volume is
bitwise the port's plain-engine bulk NVT run at the same seed: the
displacement pass makes the NVT engine's draws (ensemble.move_draws) and
the volume move draws from its own stream (gcmc._VOLUME_SALT). The
cutoff is static (cfg.lj_cutoff): a move to L' < 2 rc is rejected (a
rejection, not a clamp), and init refuses a box with no compression
headroom. Runs on the chains' device in plain PyTorch, one CUDA graph
per sweep on the card (sampler.run_step), as tpu_smc runs it on XLA.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from .config import SMCConfig
from .ensemble import (move_draws, stream_uniforms, stream_words,
                       visiting_orders)
from .gcmc import (_VOLUME_SALT, _rate, batch_state, cubic_grid, run_parts,
                   zero_counters)
from .kernels.sweep import chain_scales
from .potentials import pair_energy_total, pair_virial_pressure
from .sampler import run_step, sweep


@dataclasses.dataclass
class NPTState:
    """Constant-pressure chains, every field with a leading chain axis."""

    r: torch.Tensor         # [C, N, 3] physical positions in the box
    l: torch.Tensor         # [C] cubic box side
    energy: torch.Tensor    # [C] running potential energy
    key: torch.Tensor       # [C, 2] int64 seed words
    sweeps: torch.Tensor    # [C] int64
    accepted: torch.Tensor  # [C] accepted displacement moves
    vol_acc: torch.Tensor   # [C] accepted volume moves
    vol_att: torch.Tensor   # [C] attempted volume moves

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def n_chains(self) -> int:
        return self.r.shape[0]


def volume_move(r, l, energy, cfg: SMCConfig, pressure, dlnv, u_step,
                u_acc, temperature=None, pair_u=None):
    """One ln-V volume move of every chain (tpu_smc.npt.volume_move).
    r [C, N, 3], l and energy [C]; pressure and temperature scalars or
    [C]; u_step, u_acc [C] the move's uniforms. pair_u(r, box): the
    total potential at a per-chain box (injectable: U = 0 tests the
    ideal-gas volume law). Returns (r, l, energy, accepted [C] bool)."""
    n = r.shape[1]
    t = cfg.temperature if temperature is None else temperature
    if pair_u is None:
        def pair_u(rr, box):
            return pair_energy_total(rr, cfg, box=box)
    step = dlnv * (2.0 * u_step - 1.0)
    # scale from the STEP: exp(0) == 1.0, so dlnv = 0 rescales by 1.0
    scale = torch.exp(step / 3.0)
    l_new = l * scale
    r_new = r * scale[:, None, None]
    u_new = pair_u(r_new, l_new)
    dv = l_new ** 3 - l ** 3
    log_ap = -(u_new - energy + pressure * dv) / t + (n + 1.0) * step
    accept = (u_acc < torch.exp(torch.clamp(log_ap, max=0.0))) \
        | (log_ap >= 0.0)
    # hard-wall prior V >= (2 rc)^3 (a rejection, not a clamp)
    accept = accept & (l_new >= 2.0 * cfg.lj_cutoff)
    return (torch.where(accept[:, None, None], r_new, r),
            torch.where(accept, l_new, l),
            torch.where(accept, u_new, energy), accept)


def _npt_core(r, l, energy, cfg: SMCConfig, pressure, a, dlnv, t, noise,
              unif, offset, u_step, u_acc, order=None):
    """Displacement pass at the current box, then the volume move.
    Returns (r, l, energy, accepted [C], volume accepted [C] bool)."""
    w = r.new_zeros((0,))          # bulk: no wall table
    r, e, acc = sweep(r, energy, w, cfg, a, noise, unif, offset,
                      temperature=t, order=order, box=l)
    r, l, e, vacc = volume_move(r, l, e, cfg, pressure, dlnv, u_step, u_acc,
                                temperature=t)
    return r, l, e, acc, vacc


def npt_sweep(state: NPTState, cfg: SMCConfig, pressure, a, dlnv,
              temperature=None, draws=None, seed=None) -> NPTState:
    """One NPT sweep of every chain: N displacement moves at the current
    box, then one volume move. pressure, temperature: scalars or [C].

    draws: None = the port's streams at the state's sweep counter (run
    seed `seed`); or injected (noise [C, N, 3], unif [C, N], offset int,
    u_step [C], u_acc [C]), as the tests re-derive them from tpu_smc's
    key splits."""
    if draws is None:
        return npt_block(state, cfg, pressure, a, dlnv, 1,
                         temperature=temperature, seed=seed)[0]
    return _advance(state, *_npt_core(state.r, state.l, state.energy, cfg,
                                      pressure, a, dlnv, temperature,
                                      *draws))


def _advance(state: NPTState, r, l, energy, acc, vacc) -> NPTState:
    return state.replace(r=r, l=l, energy=energy, sweeps=state.sweeps + 1,
                         accepted=state.accepted + acc,
                         vol_acc=state.vol_acc + vacc.to(torch.int64),
                         vol_att=state.vol_att + 1)


def _chain_t(t, c, dtype, dev):
    """A scalar temperature stays a float (the NVT engine's arithmetic);
    per-chain ones become a [C] tensor."""
    if t is None or np.ndim(t) == 0:
        return None
    return torch.as_tensor(np.asarray(t, np.float64), dtype=dtype,
                           device=dev).expand(c)


def npt_block(state: NPTState, cfg: SMCConfig, pressure, a, dlnv,
              n_sweeps: int, temperature=None, gr_bins: int = 0,
              track_virial: bool = False, seed=None, chain0: int = 0):
    """n_sweeps NPT sweeps of every chain from the port's streams
    (tpu_smc.npt.npt_block), each one replayed CUDA graph on the card
    (sampler.run_step, one per (cfg, A, dlnv, T, chain0)). pressure and
    temperature: scalars or one per chain. chain0: the global index of
    the state's chain 0, the chain word of every draw (displacements
    and the volume move), with seed the run seed or the global chain
    0's key (ensemble.stream_base): a shard of a wider ensemble is
    bitwise those chains of it. Returns (state, traces): E and V [S, C]
    after each sweep, the reduced pair histogram summed over chains
    [S, gr_bins] and the virial pressure [S, C] (None where off)."""
    c, n = state.r.shape[:2]
    dev, dtype = state.r.device, state.r.dtype
    a, dlnv = float(a), float(dlnv)
    t_c = _chain_t(temperature, c, dtype, dev)
    t_f = (cfg.temperature if temperature is None else float(temperature)) \
        if t_c is None else None
    s2a = chain_scales(a, 1.0, c, dev, dtype)[2]       # sqrt(2A)
    p_c = torch.as_tensor(np.asarray(pressure, np.float64), dtype=dtype,
                          device=dev).expand(c)
    words, offsets, (wv,) = stream_words(state.key, seed,
                                        int(state.sweeps[0]), n_sweeps, n,
                                        (_VOLUME_SALT,))
    orders = visiting_orders(offsets, n, dev)
    words, wv = words.to(dev), wv.to(dev)

    def step(r, l, energy, p_c, s2a, wd, wv, order, *t_arg):
        t = t_arg[0] if t_arg else t_f
        noise, unif = move_draws(wd, n, c, s2a, order, dtype, chain0)
        uv = stream_uniforms(wv, 1, c, 0, dtype, chain0)[:, 0]
        return _npt_core(r, l, energy, cfg, p_c, a, dlnv, t, noise, unif, 0,
                         uv[:, 0], uv[:, 1], order=order)

    key = ("npt", cfg, a, dlnv, t_f, chain0)
    extra = () if t_c is None else (t_c,)
    tr = [[] for _ in range(4)]
    for s in range(n_sweeps):
        state = _advance(state, *run_step(
            key, step, (state.r, state.l, state.energy, p_c, s2a, words[s],
                        wv[s], orders[s]) + extra))
        tr[0].append(state.energy)
        tr[1].append(state.l ** 3)
        if gr_bins:
            tr[2].append(_gr_hist_reduced(state.r, state.l, gr_bins))
        if track_virial:
            tr[3].append(pair_virial_pressure(state.r, cfg, box=state.l))
    return state, tuple(torch.stack(x) if x else None for x in tr)


def init_npt_state(cfg: SMCConfig, key, device="cuda") -> NPTState:
    """One fresh chain at the cfg box (cubic bulk) on cubic_grid
    (tpu_smc.npt.init_npt_state), with its seed words key [2]."""
    if cfg.use_walls or not cfg.pbc_z:
        raise ValueError("NPT engine is bulk-only (SMCConfig.bulk)")
    if abs(cfg.box_l - cfg.box_lz) > 1e-9:
        raise ValueError("NPT engine needs a cubic box (box_l == box_lz)")
    if 2.0 * cfg.lj_cutoff >= cfg.box_l:
        raise ValueError(
            f"NPT needs compression headroom: lj_cutoff "
            f"({cfg.lj_cutoff:g}) must be < box_l/2 ({cfg.box_l / 2:g})"
            " — volume moves reject boxes below 2*cutoff (pass a "
            "smaller --lj-cutoff; the bulk default rc = L/2 leaves "
            "none)")
    from .state import init_chain_state

    chain, _ = init_chain_state(cfg, key, r0=cubic_grid(cfg, cfg.n),
                                device=device)
    z = torch.zeros((1,), dtype=torch.int64, device=device)
    return NPTState(r=chain.r, l=torch.full((1,), cfg.box_l,
                                            dtype=cfg.torch_dtype,
                                            device=device),
                    energy=chain.energy, key=chain.key, sweeps=z,
                    accepted=z, vol_acc=z, vol_att=z)


def _gr_hist_reduced(r: torch.Tensor, l: torch.Tensor,
                     nbins: int) -> torch.Tensor:
    """Pair histogram in REDUCED separation x = dr/L in [0, 1/2], summed
    over chains (tpu_smc.npt._gr_hist_reduced): ideal-gas shell weights
    are L-independent, so histograms from different volumes pool."""
    from .gcmc import chain_blocks

    c, n = r.shape[:2]
    hist = torch.zeros(nbins + 1, dtype=torch.float64, device=r.device)
    upper = torch.triu(torch.ones(n, n, dtype=torch.bool, device=r.device),
                       diagonal=1)
    for c0, c1 in chain_blocks(c, n * n):
        lb = l[c0:c1, None, None, None]
        d = r[c0:c1, :, None, :] - r[c0:c1, None, :, :]
        d = d - lb * torch.round(d / lb)
        x = torch.sqrt((d * d).sum(-1)) / lb[..., 0]
        b = torch.clamp((x * 2.0 * nbins).to(torch.int64), 0, nbins)
        hist.scatter_add_(0, b[:, upper].reshape(-1),
                          torch.ones(b[:, upper].numel(),
                                     dtype=torch.float64, device=r.device))
    return hist[:nbins]


class NPTResults(NamedTuple):
    mean_density: float      # <N/V>
    err_density: float       # chain-spread (ensembles) / trace error
    mean_v: float
    mean_energy: float
    enthalpy: float          # configurational H = <U> + P <V>
    kappa_t: float           # <dV^2> / (T <V>)
    disp_acceptance: float
    vol_acceptance: float
    energy_trace: np.ndarray  # [S, C]
    volume_trace: np.ndarray  # [S, C]
    gr: np.ndarray | None     # pooled g(x * <L>) on the reduced grid
    gr_r: np.ndarray | None
    virial_trace: np.ndarray | None  # [S, C] instantaneous virial P
    r_final: np.ndarray
    l_final: np.ndarray
    # the port's: the largest relative drift at a resync and the
    # production chain-sweeps per second
    resync_drift: float = float("nan")
    sweeps_per_second: float = float("nan")


def simulate_npt(cfg: SMCConfig, pressure, eqsteps: int, maxsteps: int,
                 key, n_chains: int = 1, dlnv: float = 0.05,
                 gr_bins: int = 0, track_virial: bool = False,
                 chunk: int = 200, state0: NPTState | None = None,
                 temperatures=None, seed=None, device="cuda", devices=None):
    """NPT driver (tpu_smc.npt.simulate_npt): eqsteps thermalization
    sweeps with A doubled (SMC.c:110-125) and maxsteps production sweeps
    of every chain. pressure, temperatures: scalars or one per chain
    (an isobar family, or a (T, P) grid for reweight_tp). key, seed and
    state0 as in gcmc.simulate_gcmc; the tracked energy is replaced by
    the exact recompute at every absolute multiple of `chunk` sweeps.
    devices: the chains split over these devices (ensemble.make_mesh;
    tpu_smc's `mesh`), one contiguous range each with its pressures and
    temperatures, every draw keyed by the global chain index: bitwise
    the one-device run. The returned state is on `device` (state0's
    own when given). Returns (state, NPTResults)."""
    from .driver import _sync
    from .ensemble import concat_states, shard_ensemble

    a = cfg.proposal_a
    if state0 is not None:
        if state0.n_chains != n_chains:
            raise ValueError(f"checkpoint holds {state0.n_chains} chains; "
                             f"run asked {n_chains}")
        state = state0
    else:
        state = batch_state(init_npt_state(cfg, key, device=device),
                            n_chains)
    dev = state.r.device
    if seed is None:
        seed = state.key[0].cpu()      # the global chain 0's streams
    ps = np.broadcast_to(np.asarray(pressure, np.float64),
                         (n_chains,)).copy()
    temps = (None if temperatures is None
             else np.broadcast_to(np.asarray(temperatures, np.float64),
                                  (n_chains,)).copy())
    parts = shard_ensemble(state, devices) if devices else [(state, 0)]
    drift: list = []

    def run(parts, n_sweeps, collect, aa):
        def block(st, c0, k):
            sl = slice(c0, c0 + st.n_chains)
            return npt_block(
                st, cfg, ps[sl], aa, dlnv, k,
                temperature=None if temps is None else temps[sl],
                gr_bins=gr_bins if collect else 0,
                track_virial=track_virial and collect, seed=seed, chain0=c0)

        return run_parts(parts, n_sweeps, chunk, block, lambda st:
                         pair_energy_total(st.r, cfg, box=st.l), drift)

    parts, _ = run(parts, eqsteps, False, 2.0 * a)
    parts = [(zero_counters(st, ("accepted", "vol_acc", "vol_att")), c0)
             for st, c0 in parts]
    for st, _ in parts:
        _sync(st)
    t0 = time.perf_counter()
    parts, traces = run(parts, maxsteps, True, a)
    for st, _ in parts:
        _sync(st)
    state = (parts[0][0] if len(parts) == 1
             else concat_states([p for p, _ in parts], dev))
    traces = [_join_traces(trs) for trs in traces]

    def cat(i):
        if not traces or traces[0][i] is None:
            return None
        return np.concatenate([t[i] for t in traces])

    e_tr, v_tr = cat(0), cat(1)
    if e_tr is None:
        e_tr = v_tr = np.zeros((0, n_chains))
    wall = time.perf_counter() - t0
    return state, _npt_results(cfg, state, ps, e_tr, v_tr, cat(3), cat(2),
                               maxsteps, drift,
                               n_chains * maxsteps / max(wall, 1e-12))


def _join_traces(trs) -> tuple:
    """npt_block's traces of every part as float64 host arrays, joined on
    the chain axis; the chain-summed pair histograms added."""
    out = []
    for i, xs in enumerate(zip(*trs)):
        if xs[0] is None:
            out.append(None)
            continue
        xs = [x.double().cpu().numpy() for x in xs]
        out.append(sum(xs[1:], xs[0]) if i == 2 else np.concatenate(xs, 1))
    return tuple(out)


def _npt_results(cfg, state, ps, e_tr, v_tr, p_tr, g_tr, maxsteps, drift,
                 rate) -> NPTResults:
    """NPTResults from the production traces (tpu_smc/npt.py:391-445);
    g_tr: npt_block's per-sweep pair histograms or None."""
    n_chains, n = state.n_chains, cfg.n
    rho_tr = n / v_tr if v_tr.size else v_tr
    chain_rho = rho_tr.mean(axis=0) if rho_tr.size else np.zeros(n_chains)
    kappa = (float(v_tr.var()) / (cfg.temperature * float(v_tr.mean()))
             if v_tr.size else float("nan"))
    gr = gr_r = None
    if g_tr is not None:
        x_edges = np.linspace(0.0, 0.5, g_tr.shape[1] + 1)
        shell = (4.0 / 3.0) * np.pi * (x_edges[1:] ** 3 - x_edges[:-1] ** 3)
        npairs = n * (n - 1) / 2.0
        gr = g_tr.sum(0) / max(v_tr.size, 1) / (npairs * shell)
        mean_l = float(v_tr.mean() ** (1.0 / 3.0))
        gr_r = 0.5 * (x_edges[1:] + x_edges[:-1]) * mean_l
    mean_p = float(np.asarray(ps).mean())
    return NPTResults(
        mean_density=float(chain_rho.mean()),
        err_density=float(chain_rho.std() / np.sqrt(max(1, n_chains - 1)))
        if n_chains > 1
        else float(rho_tr.std() / np.sqrt(max(1, rho_tr.size))),
        mean_v=float(v_tr.mean()) if v_tr.size else float("nan"),
        mean_energy=float(e_tr.mean()) if e_tr.size else float("nan"),
        enthalpy=(float(e_tr.mean()) + mean_p * float(v_tr.mean())
                  if v_tr.size else float("nan")),
        kappa_t=kappa,
        disp_acceptance=_rate(state.accepted.cpu().numpy(),
                              maxsteps * n_chains * n),
        vol_acceptance=_rate(state.vol_acc.cpu().numpy(),
                             state.vol_att.cpu().numpy()),
        energy_trace=e_tr, volume_trace=v_tr, gr=gr, gr_r=gr_r,
        virial_trace=p_tr, r_final=state.r.cpu().numpy(),
        l_final=state.l.cpu().numpy(),
        resync_drift=max(drift) if drift else float("nan"),
        sweeps_per_second=rate)


def save_npt_checkpoint(path, state: NPTState, cfg: SMCConfig,
                        stream_seed=None):
    """Full NPT ensemble state -> npz (tpu_smc's fields with the
    `__npt__` mark, plus the streams' run seed)."""
    from .gcmc import state_arrays
    from .io import save_npz_state

    return save_npz_state(path, cfg, state_arrays(state), stream_seed,
                          __npt__=1)


def load_npt_checkpoint(path, device="cuda"):
    """-> (NPTState, SMCConfig, stream_seed or None), either package's."""
    from .gcmc import load_checkpoint_of

    return load_checkpoint_of(path, "__npt__", NPTState, device)


# ----------------------------------------------------------------------
# MBAR over the pressure axis
# ----------------------------------------------------------------------

class IsobarReweight(NamedTuple):
    """Continuous equation of state from MBAR over the pressure axis."""

    p_grid: np.ndarray     # [G] target pressures
    rho: np.ndarray        # [G] N/<V>(P)
    v_mean: np.ndarray     # [G]
    kappa_t: np.ndarray    # [G] Var(V)/(T <V>) under the MBAR weights
    enthalpy: np.ndarray   # [G] <E> + P <V> (configurational)
    ess: np.ndarray        # [G] effective sample size
    f_k: np.ndarray        # [K] per-state dimensionless free energies
    p_k: np.ndarray        # [K] the sampled ladder pressures


def _pool_states(e_tr, v_tr, inv, n_states: int, max_samples: int):
    """Pooled (E, V) samples [M] grouped by state and each state's count,
    thinned to at most max_samples per state (tpu_smc's stride)."""
    e_s, v_s = [], []
    for k in range(n_states):
        cols = np.flatnonzero(inv == k)
        e = e_tr[:, cols].reshape(-1)
        v = v_tr[:, cols].reshape(-1)
        step = max(1, -(-e.size // max_samples))
        e_s.append(e[::step])
        v_s.append(v[::step])
    n_k = np.asarray([e.size for e in e_s], np.int64)
    if (n_k <= 0).any():
        raise ValueError("every pressure state needs samples")
    return np.concatenate(e_s), np.concatenate(v_s), n_k


def _mbar_fields(u64: np.ndarray, n_k: np.ndarray, device):
    """MBAR in float32 on u_kn = u64 - mean (tpu_smc's shift): (f_k,
    log_denom [M], shift), through reweight._mbar_fixed_point, on
    `device` (an isobar family's [K, M] matrix holds up to 2^17 samples
    per state)."""
    from .reweight import _mbar_fixed_point

    shift = float(u64.mean())
    f32 = dict(dtype=torch.float32, device=device)
    u_kn = torch.as_tensor(u64 - shift, **f32)
    log_n_k = torch.as_tensor(np.log(n_k), **f32)
    f_k, _ = _mbar_fixed_point(u_kn, log_n_k, 2e-6, 5_000)
    log_denom = torch.logsumexp(log_n_k[:, None] + f_k[:, None] - u_kn,
                                dim=0)
    return f_k, log_denom, shift


def _weighted_moments(beta, p, e_j, v_j, shift, log_denom):
    """(<V>, Var V, <E>, ESS) under the MBAR weights at (beta, P), in
    float32 as tpu_smc computes them."""
    f32 = dict(dtype=torch.float32, device=e_j.device)
    logw = -(torch.tensor(beta, **f32) * (e_j + torch.tensor(p, **f32) * v_j)
             - torch.tensor(shift, **f32)) - log_denom
    logw = logw - torch.logsumexp(logw, dim=0)
    w = torch.exp(logw)
    vm = (w * v_j).sum()
    vv = (w * (v_j - vm) ** 2).sum()
    em = (w * e_j).sum()
    return float(vm), float(vv), float(em), float(1.0 / (w * w).sum())


def reweight_isobars(e_tr, v_tr, pressures, temperature, p_grid, n: int,
                     max_samples_per_state: int = 1 << 17, device="cpu"):
    """MBAR over the PRESSURE axis at constant T: the continuous rho(P)
    from an isobar family (tpu_smc.npt.reweight_isobars). e_tr, v_tr
    [S, C] production traces of a run with per-chain `pressures` [C];
    u_kn = beta (E_m + P_k V_m), the lnV Jacobian V^(N+1) cancels. The
    solve runs in float32 like tpu_smc's, on `device`. Returns
    IsobarReweight."""
    beta = 1.0 / float(temperature)
    pressures = np.asarray(pressures, np.float64).reshape(-1)
    e_tr = np.asarray(e_tr, np.float64)
    v_tr = np.asarray(v_tr, np.float64)
    if e_tr.shape != v_tr.shape or e_tr.shape[1] != pressures.size:
        raise ValueError(
            f"trace/pressure shapes disagree: {e_tr.shape}, "
            f"{v_tr.shape}, {pressures.shape}")
    p_k, inv = np.unique(pressures, return_inverse=True)
    e_m, v_m, n_k = _pool_states(e_tr, v_tr, inv, p_k.size,
                                 max_samples_per_state)
    u64 = beta * (e_m[None, :] + p_k[:, None] * v_m[None, :])
    f_k, log_denom, shift = _mbar_fields(u64, n_k, device)
    e_j = torch.as_tensor(e_m, dtype=torch.float32, device=device)
    v_j = torch.as_tensor(v_m, dtype=torch.float32, device=device)
    p_grid = np.atleast_1d(np.asarray(p_grid, np.float64))
    vm, kap, hh, ess = (np.empty_like(p_grid) for _ in range(4))
    for i, p in enumerate(p_grid):
        v_i, vv_i, e_i, ess[i] = _weighted_moments(beta, p, e_j, v_j, shift,
                                                   log_denom)
        vm[i] = v_i
        kap[i] = vv_i / (float(temperature) * max(v_i, 1e-12))
        hh[i] = e_i + p * v_i
    return IsobarReweight(
        p_grid=p_grid, rho=n / np.maximum(vm, 1e-12), v_mean=vm,
        kappa_t=kap, enthalpy=hh, ess=ess,
        f_k=f_k.double().cpu().numpy(), p_k=p_k)


def reweight_tp(e_tr, v_tr, temps_c, press_c, targets, n: int,
                max_samples_per_state: int = 1 << 17, device="cpu"):
    """MBAR over BOTH fields: the continuous rho(T, P) surface from one
    sampled (T, P) grid (tpu_smc.npt.reweight_tp); u_kn = beta_k (E_m +
    P_k V_m), solved in float32 on `device`. targets: (T, P) rows.
    Returns (targets [G, 2], rho [G], v_mean [G], kappa_t [G], e_mean
    [G], ess [G])."""
    temps_c = np.asarray(temps_c, np.float64).reshape(-1)
    press_c = np.asarray(press_c, np.float64).reshape(-1)
    e_tr = np.asarray(e_tr, np.float64)
    v_tr = np.asarray(v_tr, np.float64)
    if not (e_tr.shape == v_tr.shape
            and e_tr.shape[1] == temps_c.size == press_c.size):
        raise ValueError("trace/temperature/pressure shapes disagree")
    pairs, inv = np.unique(np.stack([temps_c, press_c], axis=1), axis=0,
                           return_inverse=True)
    e_m, v_m, n_k = _pool_states(e_tr, v_tr, np.asarray(inv).reshape(-1),
                                 len(pairs), max_samples_per_state)
    beta_k = 1.0 / pairs[:, 0]
    u64 = beta_k[:, None] * (e_m[None, :]
                             + pairs[:, 1][:, None] * v_m[None, :])
    _, log_denom, shift = _mbar_fields(u64, n_k, device)
    e_j = torch.as_tensor(e_m, dtype=torch.float32, device=device)
    v_j = torch.as_tensor(v_m, dtype=torch.float32, device=device)
    targets = np.atleast_2d(np.asarray(targets, np.float64))
    g = len(targets)
    vm, kap, em, ess = (np.empty(g) for _ in range(4))
    for i, (t, p) in enumerate(targets):
        v_i, vv_i, em[i], ess[i] = _weighted_moments(
            float(np.float32(1.0 / t)), p, e_j, v_j, shift, log_denom)
        vm[i] = v_i
        kap[i] = vv_i / (t * max(v_i, 1e-12))
    return targets, n / np.maximum(vm, 1e-12), vm, kap, em, ess


def write_npt_reweight_csv(d, cfg: SMCConfig, rw: IsobarReweight):
    """npt_reweight_*.csv: the continuous MBAR equation of state."""
    from .io import _fname

    p = _fname(d, "npt_reweight", cfg)
    with open(p, "w") as f:
        f.write("P, rho, V_mean, kappa_T, H_conf, ess\n")
        for i in range(len(rw.p_grid)):
            f.write(f"{rw.p_grid[i]:0.6f}, {rw.rho[i]:0.9f}, "
                    f"{rw.v_mean[i]:0.6f}, {rw.kappa_t[i]:0.9f}, "
                    f"{rw.enthalpy[i]:0.6f}, {rw.ess[i]:0.1f}\n")
    return p


def write_npt_csv(d, cfg: SMCConfig, pressure: float, res: NPTResults):
    """npt_*.csv: run summary in the header comment, then the pooled
    per-sweep (V, rho, E) trace (chain means); npt_gr_*.csv with g(r)."""
    from .io import _fname

    p = _fname(d, "npt", cfg)
    with open(p, "w") as f:
        f.write(f"# P, {pressure:0.9f}, mean_density, "
                f"{res.mean_density:0.9f}, err_density, "
                f"{res.err_density:0.9f}, mean_V, {res.mean_v:0.6f}, "
                f"E, {res.mean_energy:0.6f}, H_conf, "
                f"{res.enthalpy:0.6f}, kappa_T, {res.kappa_t:0.6f}, "
                f"acc_disp, {res.disp_acceptance:0.4f}, acc_vol, "
                f"{res.vol_acceptance:0.4f}\n")
        f.write("sweep, V_mean, rho_mean, E_mean\n")
        v_m = res.volume_trace.mean(axis=1)
        e_m = res.energy_trace.mean(axis=1)
        for i in range(len(v_m)):
            f.write(f"{i}, {v_m[i]:0.6f}, {cfg.n / v_m[i]:0.9f}, "
                    f"{e_m[i]:0.6f}\n")
    if res.gr is not None:
        pg = _fname(d, "npt_gr", cfg)
        with open(pg, "w") as f:
            f.write("r, g\n")
            for ri, gi in zip(res.gr_r, res.gr):
                f.write(f"{ri:0.6f}, {gi:0.6f}\n")
    return p
