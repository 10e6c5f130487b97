"""Gibbs-ensemble Monte Carlo: direct liquid-vapor coexistence in two
coupled boxes (Panagiotopoulos 1987; counterpart of tpu_smc.gibbs, no
reference counterpart).

Total N = N1 + N2 and total V = V1 + V2 are fixed while particles and
volume move between the boxes. Each box is GCMC's capacity layout (a
[cap, 3] array with an active mask) at NPT's per-chain cubic side, and
the box pair is an axis of 2 behind the chain axis: r [C, 2, cap, 3],
active [C, 2, cap], l and energy [C, 2]. Moves per Gibbs sweep (Frenkel
& Smit ch. 8):

  1. one masked smart-MC displacement pass in each box at its side
     (gcmc.masked_disp_pass; the two boxes of every chain ride one pass
     as 2C chains, one visiting order);
  2. one volume exchange in y = ln(V1/V2) at fixed Vtot, accepted with
     min(1, exp(-(dU1 + dU2)/T + (N1+1) ln(V1'/V1) + (N2+1) ln(V2'/V2)));
     a zero step is the identity (sides kept, scale exactly 1.0);
  3. n_transfer transfers: a uniformly chosen active particle of a
     random donor box proposed at a uniform position of the other box,
     accepted with min(1, N_don V_acc / ((N_acc + 1) V_don)
     exp(-(dU_acc - dU_don)/T)); each ghost is a Widom sample of the
     acceptor box, so the run measures per-box mu = T ln rho + mu_ex.

Neither box may shrink below two cutoffs (rejected). The draws come
from the streams of gcmc's docstring: the displacement pass's (chain
counter 2c + box), _GIBBS_VOLUME_SALT and _TRANSFER_SALT (tag 0: donor
box 1 where < 0.5, reduced x, y, z; tag 1: acceptance, pick), keyed to
the absolute sweep. Plain PyTorch on the chains' device, one CUDA graph
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
from .gcmc import (_GIBBS_VOLUME_SALT, _TRANSFER_SALT, _accept, _rate,
                   _rows, _set_rows, batch_state, cubic_grid, first_free,
                   kth_active, masked_disp_pass, run_parts,
                   total_energy_masked, widom_weight, zero_counters)
from .kernels.sweep import chain_scales
from .potentials import energy_force_single
from .sampler import run_step


@dataclasses.dataclass
class GibbsState:
    """Two-box Gibbs chains, every field with a leading chain axis."""

    r: torch.Tensor          # [C, 2, cap, 3] (parked slots stale)
    active: torch.Tensor     # [C, 2, cap] bool
    l: torch.Tensor          # [C, 2] cubic box sides
    energy: torch.Tensor     # [C, 2] running potential energies
    key: torch.Tensor        # [C, 2] int64 seed words
    sweeps: torch.Tensor     # [C] int64
    disp_acc: torch.Tensor
    vol_acc: torch.Tensor
    vol_att: torch.Tensor
    tr_acc: torch.Tensor
    tr_att: torch.Tensor
    boltz_sum: torch.Tensor  # [C, 2] per-box Widom sums (transfer ghosts)
    boltz_cnt: torch.Tensor  # [C, 2]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def n_chains(self) -> int:
        return self.r.shape[0]


COUNTERS = ("disp_acc", "vol_acc", "vol_att", "tr_acc", "tr_att",
            "boltz_sum", "boltz_cnt")


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(x, 1.0 / 3.0)


def _displace(r, active, l, energy, cfg, a, t, noise, unif, offsets,
              order):
    """Step 1 for both boxes: one pass over 2C chains when the boxes
    share their visiting order, else one pass per box (injected draws of
    tpu_smc, which draws an offset per box). Returns (r, energy,
    accepted [C])."""
    c, _, cap = active.shape
    w = r.new_zeros((0,))
    if order is not None or offsets[0] == offsets[1]:
        t2 = t.repeat_interleave(2) if torch.is_tensor(t) else t
        rf, ef, acc = masked_disp_pass(
            r.reshape(2 * c, cap, 3), active.reshape(2 * c, cap),
            energy.reshape(2 * c), w, cfg, a, t2,
            noise.reshape(2 * c, cap, 3), unif.reshape(2 * c, cap),
            0 if order is not None else offsets[0],
            box=l.reshape(2 * c), order=order)
        return (rf.reshape(c, 2, cap, 3), ef.reshape(c, 2),
                acc.reshape(c, 2).sum(-1))
    out = [masked_disp_pass(r[:, b], active[:, b], energy[:, b], w, cfg, a,
                            t, noise[:, b], unif[:, b], offsets[b],
                            box=l[:, b]) for b in (0, 1)]
    return (torch.stack([o[0] for o in out], 1),
            torch.stack([o[1] for o in out], 1), out[0][2] + out[1][2])


def volume_exchange(r, active, l, energy, cfg: SMCConfig, dlnv, t, u_step,
                    u_acc):
    """Step 2, the coupled volume exchange in y = ln(V1/V2) at fixed
    Vtot = 2 box_l^3 (tpu_smc/gibbs.py:137-169). Returns (r, l, energy,
    accepted [C] bool)."""
    dtype = r.dtype
    w = r.new_zeros((0,))
    vtot = 2.0 * torch.full((), cfg.box_l, dtype=dtype, device=r.device) ** 3
    s = dlnv * (2.0 * u_step - 1.0)
    v1, v2 = l[:, 0] ** 3, l[:, 1] ** 3
    v1n = vtot * torch.sigmoid(torch.log(v1) - torch.log(v2) + s)
    # a zero step is the identity proposal, bitwise: sides kept
    frozen = s == 0.0
    v1n = torch.where(frozen, v1, v1n)
    v2n = torch.where(frozen, v2, vtot - v1n)
    l_new = torch.stack([torch.where(frozen, l[:, 0], _cbrt(v1n)),
                         torch.where(frozen, l[:, 1], _cbrt(v2n))], -1)
    scale = torch.stack([_cbrt(v1n / v1), _cbrt(v2n / v2)], -1)
    r_new = r * scale[..., None, None]
    u_new = total_energy_masked(r_new, active, w, cfg, box=l_new)
    n1 = active[:, 0].sum(-1).to(dtype)
    n2 = active[:, 1].sum(-1).to(dtype)
    log_ap = (-(u_new.sum(-1) - energy.sum(-1)) / t
              + (n1 + 1.0) * torch.log(v1n / v1)
              + (n2 + 1.0) * torch.log(v2n / v2))
    ok = _accept(u_acc, log_ap) & (l_new >= 2.0 * cfg.lj_cutoff).all(-1)
    return (torch.where(ok[:, None, None, None], r_new, r),
            torch.where(ok[:, None], l_new, l),
            torch.where(ok[:, None], u_new, energy), ok)


def transfers(r, active, l, energy, cfg: SMCConfig, t, t_dir, t_pos,
              t_unif, t_pick):
    """Step 3, the particle transfers of every chain (tpu_smc/gibbs.py:
    191-232). t_dir [C, X] bool (True: box 1 donates), t_pos [C, X, 3]
    reduced positions in [-1/2, 1/2), t_unif and t_pick [C, X]. Returns
    (r, active, energy, accepted [C], boltz_sum [C, 2], boltz_cnt
    [C, 2])."""
    dtype = r.dtype
    c = r.shape[0]
    w = r.new_zeros((0,))
    zero = torch.zeros((), dtype=dtype, device=r.device)
    boxes = torch.arange(2, device=r.device)[None, :]
    ta = torch.zeros(c, dtype=torch.int64, device=r.device)
    bs = torch.zeros(c, 2, dtype=dtype, device=r.device)
    bc = torch.zeros(c, 2, dtype=torch.int64, device=r.device)
    for j in range(t_dir.shape[1]):
        don = t_dir[:, j].to(torch.int64)
        acc_b = 1 - don
        nb = active.sum(-1).to(dtype)
        n_don, n_acc = _rows(nb, don), _rows(nb, acc_b)
        l_don, l_acc = _rows(l, don), _rows(l, acc_b)
        # donor: the k-th active slot, k uniform in [0, n_don)
        act_d, r_d = _rows(active, don), _rows(r, don)
        k = torch.floor(t_pick[:, j] * torch.clamp(n_don, min=1.0)).to(
            torch.int64)
        slot_d = kth_active(act_d, k)
        du_d, _ = energy_force_single(r_d, slot_d, _rows(r_d, slot_d), w,
                                      cfg, act_d, l_don)
        # acceptor ghost at a uniform position of the acceptor box
        act_a, r_a = _rows(active, acc_b), _rows(r, acc_b)
        gi = t_pos[:, j] * l_acc[:, None]
        du_a, _ = energy_force_single(r_a, -1, gi, w, cfg, act_a, l_acc)
        slot_a = first_free(act_a)
        room = ~_rows(act_a, slot_a)
        log_ap = (torch.log(torch.clamp(n_don, min=1.0)) - torch.log1p(n_acc)
                  + 3.0 * (torch.log(l_acc) - torch.log(l_don))
                  - (du_a - du_d) / t)
        ok = (n_don > 0.5) & room & _accept(t_unif[:, j], log_ap)
        act_d = _set_rows(act_d, slot_d, _rows(act_d, slot_d) & ~ok)
        act_a = _set_rows(act_a, slot_a, _rows(act_a, slot_a) | ok)
        r_a = _set_rows(r_a, slot_a, torch.where(ok[:, None], gi,
                                                 _rows(r_a, slot_a)))
        active = _set_rows(_set_rows(active, don, act_d), acc_b, act_a)
        r = _set_rows(r, acc_b, r_a)
        e_d = _rows(energy, don) + torch.where(ok, -du_d, zero)
        e_a = _rows(energy, acc_b) + torch.where(ok, du_a, zero)
        energy = _set_rows(_set_rows(energy, don, e_d), acc_b, e_a)
        to_acc = boxes == acc_b[:, None]
        bs = bs + torch.where(to_acc, widom_weight(du_a, t)[:, None], zero)
        bc = bc + to_acc.to(torch.int64)
        ta = ta + ok.to(torch.int64)
    return r, active, energy, ta, bs, bc


def _gibbs_core(r, active, l, energy, cfg, a, dlnv, t, noise, unif,
                offsets, u_step, u_vacc, t_dir, t_pos, t_unif, t_pick,
                order=None):
    r, energy, dacc = _displace(r, active, l, energy, cfg, a, t, noise, unif,
                                offsets, order)
    r, l, energy, vok = volume_exchange(r, active, l, energy, cfg, dlnv, t,
                                        u_step, u_vacc)
    r, active, energy, ta, bs, bc = transfers(r, active, l, energy, cfg, t,
                                              t_dir, t_pos, t_unif, t_pick)
    return r, active, l, energy, dacc, vok, ta, bs, bc


def _advance(state: GibbsState, n_transfer: int, r, active, l, energy,
             dacc, vok, ta, bs, bc) -> GibbsState:
    return state.replace(
        r=r, active=active, l=l, energy=energy, sweeps=state.sweeps + 1,
        disp_acc=state.disp_acc + dacc,
        vol_acc=state.vol_acc + vok.to(torch.int64),
        vol_att=state.vol_att + 1,
        tr_acc=state.tr_acc + ta, tr_att=state.tr_att + n_transfer,
        boltz_sum=state.boltz_sum + bs, boltz_cnt=state.boltz_cnt + bc)


def gibbs_sweep(state: GibbsState, cfg: SMCConfig, a, dlnv,
                n_transfer: int, temperature=None, draws=None,
                seed=None) -> GibbsState:
    """One Gibbs sweep of every chain: per-box displacement passes, one
    volume exchange, n_transfer transfers. temperature: scalar or [C].

    draws: None = the port's streams at the state's sweep counter (run
    seed `seed`); or injected (noise [C, 2, cap, 3], unif [C, 2, cap],
    offsets (box 1, box 2), u_step [C], u_vacc [C], t_dir [C, X] bool,
    t_pos [C, X, 3], t_unif [C, X], t_pick [C, X]), as the tests
    re-derive them from tpu_smc's key splits."""
    t = cfg.temperature if temperature is None else temperature
    if draws is None:
        return gibbs_block(state, cfg, a, dlnv, n_transfer, 1,
                           temperature=temperature, seed=seed)[0]
    return _advance(state, n_transfer, *_gibbs_core(
        state.r, state.active, state.l, state.energy, cfg, a, dlnv, t,
        *draws))


def gibbs_block(state: GibbsState, cfg: SMCConfig, a, dlnv,
                n_transfer: int, n_sweeps: int, temperature=None,
                seed=None, chain0: int = 0):
    """n_sweeps Gibbs sweeps of every chain from the port's streams
    (tpu_smc.gibbs.gibbs_block), each one replayed CUDA graph on the
    card (sampler.run_step, one per (cfg, A, dlnv, X, T, chain0));
    temperature: a scalar or one per chain (a coexistence curve).
    chain0: the global index of the state's chain 0, the chain word of
    every draw (the displacement pass's 2 chain0 + box, the volume and
    transfer streams' chain0), with seed the run seed or the global
    chain 0's key (ensemble.stream_base): a shard of a wider ensemble is
    bitwise those chains of it. Returns (state, traces): N1, V1, E1, E2
    [S, C] after each sweep, as tpu_smc's, and N2 [S, C], which the
    driver's conservation check reads."""
    c, _, cap = state.active.shape
    dev, dtype = state.r.device, state.r.dtype
    a, dlnv = float(a), float(dlnv)
    per_chain = temperature is not None and np.ndim(temperature) > 0
    t_f = None if per_chain else (cfg.temperature if temperature is None
                                  else float(temperature))
    s2a = chain_scales(a, 1.0, 2 * c, dev, dtype)[2]   # sqrt(2A)
    words, offsets, (wv, wt) = stream_words(
        state.key, seed, int(state.sweeps[0]), n_sweeps, cap,
        (_GIBBS_VOLUME_SALT, _TRANSFER_SALT))
    orders = visiting_orders(offsets, cap, dev)
    words, wv, wt = words.to(dev), wv.to(dev), wt.to(dev)

    def step(r, active, l, energy, s2a, wd, wv, wt, order, *t_arg):
        t = t_arg[0] if t_arg else t_f
        noise, unif = move_draws(wd, cap, 2 * c, s2a, order, dtype,
                                 2 * chain0)
        uv = stream_uniforms(wv, 1, c, 0, dtype, chain0)[:, 0]
        u = stream_uniforms(wt, n_transfer, c, 0, dtype, chain0)
        u2 = stream_uniforms(wt, n_transfer, c, 1, dtype, chain0)
        return _gibbs_core(r, active, l, energy, cfg, a, dlnv, t,
                           noise.reshape(c, 2, cap, 3),
                           unif.reshape(c, 2, cap), None, uv[:, 0],
                           uv[:, 1], u[..., 0] < 0.5, u[..., 1:] - 0.5,
                           u2[..., 0], u2[..., 1], order=order)

    extra = ()
    if per_chain:
        extra = (torch.as_tensor(np.asarray(temperature, np.float64),
                                 dtype=dtype, device=dev).expand(c),)
    key = ("gibbs", cfg, a, dlnv, n_transfer, t_f, chain0)
    tr = [[] for _ in range(5)]
    for s in range(n_sweeps):
        state = _advance(state, n_transfer, *run_step(
            key, step, (state.r, state.active, state.l, state.energy, s2a,
                        words[s], wv[s], wt[s], orders[s]) + extra))
        n_b = state.active.sum(-1)
        for x, v in zip(tr, (n_b[:, 0], state.l[:, 0] ** 3,
                             state.energy[:, 0], state.energy[:, 1],
                             n_b[:, 1])):
            x.append(v)
    return state, tuple(torch.stack(x) for x in tr)


def init_gibbs_state(cfg: SMCConfig, key, cap: int, n1: int | None = None,
                     n2: int | None = None, device="cuda") -> GibbsState:
    """One chain of two boxes at the cfg side, N = cfg.n split (evenly
    by default) on never-overlapping grids (tpu_smc.gibbs.
    init_gibbs_state); key: the chain's seed words [2]."""
    if cfg.use_walls or not cfg.pbc_z:
        raise ValueError("the Gibbs engine is bulk-only (SMCConfig.bulk)")
    if abs(cfg.box_l - cfg.box_lz) > 1e-9:
        raise ValueError("the Gibbs engine needs cubic boxes")
    if 2.0 * cfg.lj_cutoff >= cfg.box_l:
        raise ValueError(
            f"Gibbs needs volume-exchange headroom: lj_cutoff "
            f"({cfg.lj_cutoff:g}) must be < box_l/2 ({cfg.box_l / 2:g})")
    n1 = cfg.n // 2 if n1 is None else n1
    n2 = cfg.n - n1 if n2 is None else n2
    if n1 + n2 != cfg.n:
        raise ValueError(f"n1 + n2 ({n1}+{n2}) must equal cfg.n ({cfg.n})")
    if max(n1, n2) > cap:
        raise ValueError(f"cap ({cap}) below the initial split "
                         f"({n1}, {n2})")
    dtype = cfg.torch_dtype
    r = np.zeros((2, cap, 3), np.float64)
    active = np.zeros((2, cap), bool)
    for b, nb in enumerate((n1, n2)):
        g = cubic_grid(cfg, max(nb, 1))
        reps = -(-cap // max(nb, 1))
        r[b] = np.tile(g, (reps, 1))[:cap]
        active[b, :nb] = True
    r = torch.as_tensor(r, dtype=dtype, device=device)[None]
    active = torch.as_tensor(active, device=device)[None]
    l = torch.full((1, 2), cfg.box_l, dtype=dtype, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    z = torch.zeros((1,), **i64)
    return GibbsState(
        r=r, active=active, l=l,
        energy=total_energy_masked(r, active, r.new_zeros((0,)), cfg,
                                   box=l),
        key=torch.as_tensor(key, **i64).reshape(1, 2), sweeps=z,
        disp_acc=z, vol_acc=z, vol_att=z, tr_acc=z, tr_att=z,
        boltz_sum=torch.zeros((1, 2), dtype=dtype, device=device),
        boltz_cnt=torch.zeros((1, 2), **i64))


class GibbsResults(NamedTuple):
    rho_lo: float             # vapor branch (boxes sorted per sweep)
    rho_hi: float             # liquid branch
    err_lo: float
    err_hi: float
    mu_box: np.ndarray        # [2] T ln rho + mu_ex per physical box
    mu_ex_box: np.ndarray     # [2]
    disp_acceptance: float
    vol_acceptance: float
    transfer_acceptance: float
    n1_trace: np.ndarray      # [S, C]
    v1_trace: np.ndarray      # [S, C]
    e_trace: np.ndarray       # [S, C, 2]
    rho_samples: np.ndarray   # [S, C, 2] both boxes' densities
    l_final: np.ndarray
    n_final: np.ndarray
    # the port's: the largest relative drift at a resync, production
    # chain-sweeps per second, and whether N1 + N2 = N held at every
    # sweep of the run
    resync_drift: float = float("nan")
    sweeps_per_second: float = float("nan")
    n_conserved: bool = True


def simulate_gibbs(cfg: SMCConfig, eqsteps: int, maxsteps: int, key,
                   cap: int, n_chains: int = 1, dlnv: float = 0.05,
                   n_transfer: int | None = None, chunk: int = 200,
                   state0: GibbsState | None = None, temperatures=None,
                   seed=None, device="cuda", devices=None):
    """Gibbs driver (tpu_smc.gibbs.simulate_gibbs): eqsteps sweeps with A
    doubled and maxsteps production sweeps of every chain. cfg.n is the
    TOTAL particle count and cfg.box_l the initial per-box side, so the
    overall density n / (2 box_l^3) is conserved. temperatures: one per
    chain (a coexistence curve, binodal_from_results). key, seed and
    state0 as in gcmc.simulate_gcmc; the tracked energies are replaced
    by the exact recompute at every absolute multiple of `chunk`
    sweeps. devices: the chains split over these devices as in
    npt.simulate_npt, bitwise the one-device run. Returns (state,
    GibbsResults)."""
    from .driver import _sync
    from .ensemble import concat_states, shard_ensemble

    a = cfg.proposal_a
    n_transfer = max(1, cfg.n // 4) if n_transfer is None else n_transfer
    if state0 is not None:
        state = state0
    else:
        state = batch_state(init_gibbs_state(cfg, key, cap, device=device),
                            n_chains)
    n_chains = state.n_chains
    dev = state.r.device
    temps = (None if temperatures is None
             else np.broadcast_to(np.asarray(temperatures, np.float64),
                                  (n_chains,)).copy())
    if seed is None:
        seed = state.key[0].cpu()      # the global chain 0's streams
    parts = shard_ensemble(state, devices) if devices else [(state, 0)]
    drift: list = []

    def run(parts, n_sweeps, aa):
        def block(st, c0, k):
            return gibbs_block(
                st, cfg, aa, dlnv, n_transfer, k,
                temperature=(None if temps is None
                             else temps[c0:c0 + st.n_chains]),
                seed=seed, chain0=c0)

        return run_parts(parts, n_sweeps, chunk, block, lambda st:
                         total_energy_masked(st.r, st.active,
                                             st.r.new_zeros((0,)), cfg,
                                             box=st.l), drift)

    parts, _ = run(parts, eqsteps, 2.0 * a)
    parts = [(zero_counters(st, COUNTERS), c0) for st, c0 in parts]
    for st, _ in parts:
        _sync(st)
    t0 = time.perf_counter()
    parts, traces = run(parts, maxsteps, a)
    for st, _ in parts:
        _sync(st)
    state = (parts[0][0] if len(parts) == 1
             else concat_states([p for p, _ in parts], dev))
    if traces:
        n1, v1, e1, e2, n2 = (np.concatenate(
            [np.concatenate([tr[i].cpu().numpy() for tr in blk], 1)
             for blk in traces]) for i in range(5))
        v1, e1, e2 = (x.astype(np.float64) for x in (v1, e1, e2))
        n_ok = bool((n1 + n2 == cfg.n).all())
    else:
        n1 = v1 = e1 = e2 = np.zeros((0, max(1, n_chains)))
        n_ok = True
    wall = time.perf_counter() - t0
    return state, _gibbs_results(cfg, state, n1, v1, e1, e2, maxsteps,
                                 drift, n_chains * maxsteps
                                 / max(wall, 1e-12), n_ok)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _gibbs_results(cfg, state, n1, v1, e1, e2, maxsteps, drift, rate,
                   n_ok) -> GibbsResults:
    """GibbsResults from the production traces (tpu_smc/gibbs.py:
    502-547)."""
    n_chains = state.n_chains
    vtot = 2.0 * cfg.box_l ** 3
    n = cfg.n
    v2 = vtot - v1
    rho = np.stack([n1 / np.maximum(v1, 1e-12),
                    (n - n1) / np.maximum(v2, 1e-12)], axis=-1)
    rho_sorted = np.sort(rho, axis=-1)
    if rho.size:
        chain_lo = rho_sorted[..., 0].mean(axis=0)
        chain_hi = rho_sorted[..., 1].mean(axis=0)

        def err(x):
            return (float(x.std() / np.sqrt(max(1, n_chains - 1)))
                    if n_chains > 1 else float("nan"))

        rho_lo, rho_hi = float(chain_lo.mean()), float(chain_hi.mean())
        err_lo, err_hi = err(chain_lo), err(chain_hi)
    else:
        rho_lo = rho_hi = err_lo = err_hi = float("nan")
    bs = _np(state.boltz_sum).reshape(-1, 2).sum(axis=0)
    bcn = _np(state.boltz_cnt).reshape(-1, 2).sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        mu_ex = -cfg.temperature * np.log(bs / np.maximum(bcn, 1))
    rho_box = (np.stack([n1, n - n1], -1)
               / np.maximum(np.stack([v1, v2], -1), 1e-12))
    rho_box_mean = (rho_box.reshape(-1, 2).mean(axis=0)
                    if rho.size else np.full(2, np.nan))
    mu_box = cfg.temperature * np.log(np.maximum(rho_box_mean, 1e-12)) \
        + mu_ex
    return GibbsResults(
        rho_lo=rho_lo, rho_hi=rho_hi, err_lo=err_lo, err_hi=err_hi,
        mu_box=mu_box, mu_ex_box=mu_ex,
        disp_acceptance=_rate(_np(state.disp_acc), maxsteps * n_chains * n),
        vol_acceptance=_rate(_np(state.vol_acc), _np(state.vol_att)),
        transfer_acceptance=_rate(_np(state.tr_acc), _np(state.tr_att)),
        n1_trace=n1, v1_trace=v1, e_trace=np.stack([e1, e2], axis=-1),
        rho_samples=rho, l_final=_np(state.l),
        n_final=_np(state.active.sum(-1)).astype(np.int32),
        resync_drift=max(drift) if drift else float("nan"),
        sweeps_per_second=rate, n_conserved=n_ok)


def binodal_from_results(state, res: GibbsResults, temps_c,
                         cfg: SMCConfig):
    """Group a temperature-ladder Gibbs run by T: the coexistence curve
    (tpu_smc.gibbs.binodal_from_results). temps_c [C]: the per-chain
    temperatures of the run; state: its final state (boltz_sum and
    boltz_cnt [C, 2]). Returns dict rows in ascending T: t, rho_v/err_v,
    rho_l/err_l, dmu, two_phase."""
    temps_c = np.asarray(temps_c, np.float64)
    t_vals, inv = np.unique(temps_c, return_inverse=True)
    rs = np.sort(res.rho_samples, axis=-1)
    bs = _np(state.boltz_sum)
    bc = _np(state.boltz_cnt)
    rows = []
    for k, t in enumerate(t_vals):
        cols = np.flatnonzero(inv == k)
        chain_lo = rs[:, cols, 0].mean(axis=0)
        chain_hi = rs[:, cols, 1].mean(axis=0)
        nrep = len(cols)

        def err(x):
            return (float(x.std() / np.sqrt(nrep - 1)) if nrep > 1
                    else float("nan"))

        with np.errstate(divide="ignore", invalid="ignore"):
            mu_ex = -t * np.log(bs[cols].sum(axis=0)
                                / np.maximum(bc[cols].sum(axis=0), 1))
        rho_box = res.rho_samples[:, cols, :].reshape(-1, 2).mean(axis=0)
        mu = t * np.log(np.maximum(rho_box, 1e-12)) + mu_ex
        lo, hi = float(chain_lo.mean()), float(chain_hi.mean())
        rows.append({
            "t": float(t), "rho_v": lo, "err_v": err(chain_lo),
            "rho_l": hi, "err_l": err(chain_hi),
            "dmu": float(abs(mu[0] - mu[1])),
            "two_phase": bool(hi > 2.0 * lo),
        })
    return rows


def write_gibbs_binodal_csv(d, cfg: SMCConfig, rows):
    """gibbs_binodal_*.csv: the coexistence curve from one ladder run."""
    from .io import _fname

    p = _fname(d, "gibbs_binodal", cfg)
    with open(p, "w") as f:
        f.write("T, rho_v, err_v, rho_l, err_l, dmu, two_phase\n")
        for r in rows:
            f.write(f"{r['t']:0.6f}, {r['rho_v']:0.9f}, "
                    f"{r['err_v']:0.9f}, {r['rho_l']:0.9f}, "
                    f"{r['err_l']:0.9f}, {r['dmu']:0.6f}, "
                    f"{int(r['two_phase'])}\n")
    return p


def save_gibbs_checkpoint(path, state: GibbsState, cfg: SMCConfig,
                          stream_seed=None):
    """Full Gibbs ensemble state -> npz (tpu_smc's fields with the
    `__gibbs__` mark, plus the streams' run seed)."""
    from .gcmc import state_arrays
    from .io import save_npz_state

    return save_npz_state(path, cfg, state_arrays(state), stream_seed,
                          __gibbs__=1)


def load_gibbs_checkpoint(path, device="cuda"):
    """-> (GibbsState, SMCConfig, stream_seed or None), either package's."""
    from .gcmc import load_checkpoint_of

    return load_checkpoint_of(path, "__gibbs__", GibbsState, device)


def write_gibbs_csv(d, cfg: SMCConfig, res: GibbsResults):
    """gibbs_*.csv: coexistence summary + pooled per-sweep traces."""
    from .io import _fname

    p = _fname(d, "gibbs", cfg)
    with open(p, "w") as f:
        f.write(f"# rho_lo, {res.rho_lo:0.9f}, err_lo, "
                f"{res.err_lo:0.9f}, rho_hi, {res.rho_hi:0.9f}, "
                f"err_hi, {res.err_hi:0.9f}, mu_box1, "
                f"{res.mu_box[0]:0.6f}, mu_box2, {res.mu_box[1]:0.6f}, "
                f"acc_disp, {res.disp_acceptance:0.4f}, acc_vol, "
                f"{res.vol_acceptance:0.4f}, acc_transfer, "
                f"{res.transfer_acceptance:0.4f}\n")
        f.write("sweep, N1_mean, V1_mean, rho_lo_mean, rho_hi_mean\n")
        n1m = res.n1_trace.mean(axis=1)
        v1m = res.v1_trace.mean(axis=1)
        rs = np.sort(res.rho_samples, axis=-1)
        lo = rs[..., 0].mean(axis=1)
        hi = rs[..., 1].mean(axis=1)
        for i in range(len(n1m)):
            f.write(f"{i}, {n1m[i]:0.3f}, {v1m[i]:0.6f}, "
                    f"{lo[i]:0.9f}, {hi[i]:0.9f}\n")
    return p
