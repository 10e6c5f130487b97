"""Grand-canonical Monte Carlo: adsorption isotherms from a chemical
potential (counterpart of tpu_smc.gcmc; no reference counterpart, the C
code is strictly NVT).

The particle count is a CAPACITY `cap` with an active mask: positions
are [C, cap, 3], all pair physics is mask algebra (potentials' `active`,
applied before 1/dr2, so parked slots may hold anything), an insertion
claims the first free slot and a deletion clears one. Moves per GC
sweep: one smart-MC displacement pass over the capacity (sampler.sweep
with the mask: a move of an inactive slot is never accepted) and
`n_exchange` insertion/deletion attempts with the textbook acceptances
(Frenkel & Smit ch. 5; Lambda = 1 reduced units),

    insert: min(1, z V / (N+1) * exp(-dU/T))
    delete: min(1, N / (z V)   * exp(+dU/T)),      z = exp(mu/T),

V the full box volume L*L*Lz. Every insertion attempt is also a Widom
ghost sample (boltz_sum / boltz_cnt), so a run measures its own mu_ex.

tpu_smc runs these sweeps on XLA, never on a Pallas kernel, and so does
the port: plain PyTorch on the chains' device, each sweep one replayed
CUDA graph on the card (sampler.run_step). Branches are selects: both
the insertion and the deletion of an attempt are evaluated for every
chain and `torch.where` keeps one, as tpu_smc's `lax.cond` under `vmap`
does; no host read happens inside a sweep.

Random streams (the port's own; tpu_smc splits a jax key per sweep).
All are keyed to the ABSOLUTE sweep counter s and a run base: the run
seed's words, or Philox of chain 0's key folded with 0x5EEDB1 when no
seed is given (ensemble.stream_base). The displacement pass makes the
NVT plain engine's draws exactly (ensemble.move_draws: seed words
fold_in(base, s), the shared cyclic offset from fold 0x0FF5E7, five
uniforms of counters (move, chain, 0|1, 0)). Each other stream has
sweep words fold_in(fold_in(base, SALT), s) (ensemble.stream_words)
and uniforms of counters (attempt, chain, tag, 0):

  _EXCHANGE_SALT 0x6C3C  GCMC attempts: tag 0 (kind < 0.5 inserts,
                          x, y, z), tag 1 (acceptance, pick);
  _VOLUME_SALT   0x4E5054 NPT volume move (npt.py): counter (chain, 0,
                          0, 0), (step, acceptance);
  _GIBBS_VOLUME_SALT 0x474D43, _TRANSFER_SALT 0x545246: Gibbs volume
                          exchange and transfers (gibbs.py), laid out as
                          the volume move and the GCMC attempts.

A resumed run therefore draws what the unbroken run would have. The
exact-energy resync happens at absolute multiples of `chunk` sweeps,
where the unbroken run resyncs too.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from .config import SMCConfig
from .ensemble import (move_draws, stream_uniforms, stream_words,
                       visiting_orders)
from .kernels.sweep import chain_scales
from .potentials import (PAIR_BUDGET, chain_sum, energy_force_single,
                         pair_energy_total, split_of,
                         wall_energy_force_single)
from .sampler import run_step, sweep
from .state import fold_in

_EXCHANGE_SALT = 0x6C3C
_VOLUME_SALT = 0x4E5054
_GIBBS_VOLUME_SALT = 0x474D43
_TRANSFER_SALT = 0x545246


# ----------------------------------------------------------------------
# State and masked physics
# ----------------------------------------------------------------------

@dataclasses.dataclass
class GCMCState:
    """Grand-canonical chains, every field with a leading chain axis."""

    r: torch.Tensor          # [C, cap, 3] (parked slots hold stale data)
    active: torch.Tensor     # [C, cap] bool
    energy: torch.Tensor     # [C] running energy of the ACTIVE set
    key: torch.Tensor        # [C, 2] int64 seed words
    sweeps: torch.Tensor     # [C] int64
    disp_acc: torch.Tensor   # [C] int64 accepted displacement moves
    disp_att: torch.Tensor   # attempted (active count per sweep)
    ins_acc: torch.Tensor
    ins_att: torch.Tensor
    del_acc: torch.Tensor
    del_att: torch.Tensor
    boltz_sum: torch.Tensor  # [C] running sum of exp(-dU/T) (Widom)
    boltz_cnt: torch.Tensor  # [C] insertion attempts counted

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def n_chains(self) -> int:
        return self.r.shape[0]


COUNTERS = ("disp_acc", "disp_att", "ins_acc", "ins_att", "del_acc",
            "del_att", "boltz_sum", "boltz_cnt")


def batch_state(st, n_chains: int):
    """Broadcast a one-chain state dataclass to n_chains chains, each
    with its own seed words folded from the seed chain's key by chain
    index (state.batch_chain_state)."""
    out = {}
    for f in dataclasses.fields(st):
        x = getattr(st, f.name)
        if f.name == "key":
            out["key"] = fold_in(x[0].cpu(), torch.arange(n_chains)).to(
                x.device)
        else:
            out[f.name] = x.expand((n_chains,) + x.shape[1:]).clone()
    return type(st)(**out)


def zero_counters(st, names):
    """st with the named counters set to zero (after thermalization)."""
    return st.replace(**{f: torch.zeros_like(getattr(st, f))
                         for f in names})


def _with_n(cfg: SMCConfig, cap: int) -> SMCConfig:
    return dataclasses.replace(cfg, n=cap)


def total_energy_masked(r: torch.Tensor, active: torch.Tensor,
                        w: torch.Tensor, cfg: SMCConfig,
                        box=None) -> torch.Tensor:
    """Exact active-set energy per chain: pairs with both ends active,
    plus the wall term of active particles; box [...] the per-chain
    cubic side (Gibbs). r [..., cap, 3], active [..., cap]."""
    u = pair_energy_total(r, cfg, box=box, active=active)
    if cfg.use_walls:
        uw = wall_energy_force_single(r, w, cfg)[0]
        u = u + chain_sum(torch.where(active, uw, torch.zeros_like(uw)))
    return u


def masked_disp_pass(r, active, energy, w, cfg: SMCConfig, a, t, noise,
                     unif, offset, box=None, order=None):
    """One smart-MC displacement pass over the capacity with inactive
    slots masked to no-ops (tpu_smc.gcmc.masked_disp_pass): sampler.sweep
    with the active mask. noise [C, cap, 3] by slot, unif [C, cap] by
    move, offset the shared cyclic start (or `order`, the visiting
    order, for a CUDA graph). Returns (r, energy, accepted [C])."""
    return sweep(r, energy, w, cfg, a, noise, unif, offset, temperature=t,
                 order=order, box=box, active=active)


def box_volume(cfg: SMCConfig) -> float:
    return float(cfg.box_l * cfg.box_l * cfg.box_lz)


def exchange_draws(words: torch.Tensor, n_exchange: int, c: int,
                   cfg: SMCConfig, chain0: int = 0):
    """One sweep's exchange draws from the _EXCHANGE_SALT stream: kind
    [c, X] bool (True inserts), positions [c, X, 3] uniform over the
    box, acceptance uniforms and picks [c, X]; chain0 the global index
    of chain 0 (the counters' chain word)."""
    dtype = cfg.torch_dtype
    u = stream_uniforms(words, n_exchange, c, 0, dtype, chain0)
    u2 = stream_uniforms(words, n_exchange, c, 1, dtype, chain0)
    pos = torch.stack([-side / 2.0 + side * u[..., k + 1] for k, side in
                       enumerate((cfg.box_l, cfg.box_l, cfg.box_lz))], -1)
    return u[..., 0] < 0.5, pos, u2[..., 0], u2[..., 1]


def _accept(u, log_ap):
    """The Metropolis test of tpu_smc: u < exp(min(log_ap, 0)) or
    log_ap >= 0 (a NaN log_ap rejects)."""
    return (u < torch.exp(torch.clamp(log_ap, max=0.0))) | (log_ap >= 0.0)


def widom_weight(du: torch.Tensor, t) -> torch.Tensor:
    """A ghost's Boltzmann weight exp(-du/T), clamped at exp(80) (a deep
    well keeps a large finite weight) and 0 where -du/T is NaN
    (tpu_smc/gcmc.py:192-201)."""
    lw = -du / t
    bw = torch.exp(torch.clamp(lw, max=80.0))
    return torch.where(torch.isnan(lw), torch.zeros_like(bw), bw)


def first_free(active: torch.Tensor) -> torch.Tensor:
    """[C] index of the first inactive slot (argmin of the mask; 0 when
    every slot is active)."""
    return torch.argmin(active.to(torch.uint8), dim=-1)


def kth_active(active: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[C] index of the k-th active slot (cumsum == k + 1; 0 when there
    is none)."""
    hit = active.to(torch.int64).cumsum(-1) == (k + 1)[..., None]
    return torch.argmax(hit.to(torch.uint8), dim=-1)


def _rows(x: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """x[c, slot[c]] for x [C, cap, ...]."""
    idx = slot.reshape((-1, 1) + (1,) * (x.dim() - 2))
    return x.gather(1, idx.expand((-1, 1) + x.shape[2:]))[:, 0]


def _set_rows(x: torch.Tensor, slot: torch.Tensor, v: torch.Tensor):
    """x with x[c, slot[c]] = v[c] (out of place)."""
    idx = slot.reshape((-1, 1) + (1,) * (x.dim() - 2))
    return x.scatter(1, idx.expand((-1, 1) + x.shape[2:]), v.unsqueeze(1))


def exchange_attempts(r, active, energy, w, cfg: SMCConfig, mu, t, kind,
                      pos, eu, pick):
    """The insertion/deletion attempts of one GC sweep for every chain
    (tpu_smc/gcmc.py:177-228), each attempt's two branches evaluated and
    one kept per chain. mu: scalar or [C]. Returns (r, active, energy,
    ins_acc, ins_att, del_acc, del_att, boltz_sum, boltz_cnt), the last
    six [C]."""
    dtype = r.dtype
    c = r.shape[0]
    vol = torch.full((), box_volume(cfg), dtype=dtype, device=r.device)
    zero = torch.zeros((), dtype=dtype, device=r.device)
    i64 = dict(dtype=torch.int64, device=r.device)
    ia, it, da, dt = (torch.zeros(c, **i64) for _ in range(4))
    bs = torch.zeros(c, dtype=dtype, device=r.device)
    for j in range(kind.shape[1]):
        n = active.sum(-1).to(dtype)
        ins = kind[:, j]
        # insertion at the ghost position, into the first free slot
        gi = pos[:, j]
        du_i, _ = energy_force_single(r, -1, gi, w, cfg, active)
        slot_i = first_free(active)
        room = ~_rows(active, slot_i)
        ok_i = room & _accept(eu[:, j], torch.log(vol) - torch.log1p(n)
                              + (mu - du_i) / t)
        # deletion of the k-th active particle, k uniform in [0, n)
        k = torch.floor(pick[:, j] * n).to(torch.int64)
        slot_d = kth_active(active, k)
        du_d, _ = energy_force_single(r, slot_d, _rows(r, slot_d), w, cfg,
                                      active)
        ok_d = (n > 0.5) & _accept(
            eu[:, j], torch.log(torch.clamp(n, min=1.0)) - torch.log(vol)
            + (du_d - mu) / t)
        ok_i = ins & ok_i
        ok_d = ~ins & ok_d
        slot = torch.where(ins, slot_i, slot_d)
        r = _set_rows(r, slot, torch.where(ok_i[:, None], gi,
                                           _rows(r, slot)))
        a_slot = _rows(active, slot)
        active = _set_rows(active, slot, torch.where(ins, a_slot | ok_i,
                                                     a_slot & ~ok_d))
        energy = torch.where(ins, energy + torch.where(ok_i, du_i, zero),
                             energy - torch.where(ok_d, du_d, zero))
        ia = ia + ok_i.to(torch.int64)
        it = it + ins.to(torch.int64)
        da = da + ok_d.to(torch.int64)
        dt = dt + (~ins).to(torch.int64)
        bs = bs + torch.where(ins, widom_weight(du_i, t), zero)
    return r, active, energy, ia, it, da, dt, bs, it.clone()


def gc_sweep(state: GCMCState, w, cfg: SMCConfig, mu, a, n_exchange: int,
             draws=None, seed=None) -> GCMCState:
    """One grand-canonical sweep of every chain: the masked displacement
    pass over the capacity, then n_exchange insert/delete attempts. cfg
    is the capacity's (cfg.n = cap); mu a scalar or [C]; a a scalar.

    draws: None = the port's streams at the state's sweep counter (run
    seed `seed`); or injected (noise [C, cap, 3] sqrt(2A)-scaled by slot,
    unif [C, cap] by move, offset int, kind [C, X] bool, pos [C, X, 3],
    eu [C, X], pick [C, X]), as the tests re-derive them from tpu_smc's
    key splits."""
    if draws is None:
        return gc_block(state, w, cfg, mu, a, 1, n_exchange, seed=seed)[0]
    t = cfg.temperature
    noise, unif, offset, kind, pos, eu, pick = draws
    r, e, dacc = masked_disp_pass(state.r, state.active, state.energy, w,
                                  cfg, a, t, noise, unif, offset)
    return _advance(state, dacc, *exchange_attempts(
        r, state.active, e, w, cfg, mu, t, kind, pos, eu, pick))


def _advance(state: GCMCState, dacc, r, active, energy, ia, it, da, dt, bs,
             bc) -> GCMCState:
    """The state after a sweep from the step's outputs."""
    return state.replace(
        r=r, active=active, energy=energy, sweeps=state.sweeps + 1,
        disp_acc=state.disp_acc + dacc,
        disp_att=state.disp_att + state.active.sum(-1),
        ins_acc=state.ins_acc + ia, ins_att=state.ins_att + it,
        del_acc=state.del_acc + da, del_att=state.del_att + dt,
        boltz_sum=state.boltz_sum + bs, boltz_cnt=state.boltz_cnt + bc)


def gc_block(state: GCMCState, w, cfg: SMCConfig, mu, a, n_sweeps: int,
             n_exchange: int, z_bins: int = 0, gr_bins: int = 0,
             seed=None, chain0: int = 0, draws=None):
    """n_sweeps GC sweeps of every chain from the port's streams
    (tpu_smc.gcmc.gc_block), each one replayed CUDA graph on the card
    (sampler.run_step, one per (cfg, A, X, chain0)); cfg is the
    capacity's, mu a scalar or one per chain. chain0: the global index
    of the state's chain 0, the chain word of every draw, with seed the
    run seed or the global chain 0's key (ensemble.stream_base): a shard
    of a wider ensemble is bitwise those chains of it (npt_block).
    draws: None, or one gc_sweep draws tuple per sweep in place of the
    streams (tests inject tpu_smc's). Returns (state, traces): N and E
    [S, C] after each sweep, and per sweep, summed over the chains, the
    z-histogram [S, z_bins] and the active-pair histogram [S, gr_bins]
    with the active-pair count [S] (None where off; integer counts in
    float64, so the sums of shards add exactly)."""
    c, cap = state.active.shape
    dev, dtype = state.r.device, state.r.dtype
    a, t = float(a), cfg.temperature
    s2a = chain_scales(a, t, c, dev, dtype)[2]         # sqrt(2A)
    mu_c = torch.as_tensor(mu, dtype=dtype, device=dev).expand(c)
    words, offsets, (wx,) = stream_words(state.key, seed,
                                         int(state.sweeps[0]), n_sweeps,
                                         cap, (_EXCHANGE_SALT,))
    orders = visiting_orders(offsets, cap, dev)
    words, wx = words.to(dev), wx.to(dev)

    def step(r, active, energy, mu_c, s2a, w, wd, wx, order):
        noise, unif = move_draws(wd, cap, c, s2a, order, dtype, chain0)
        r2, e2, dacc = masked_disp_pass(r, active, energy, w, cfg, a, t,
                                        noise, unif, 0, order=order)
        return (dacc,) + exchange_attempts(
            r2, active, e2, w, cfg, mu_c, t,
            *exchange_draws(wx, n_exchange, c, cfg, chain0))

    tr = [[] for _ in range(5)]
    for s in range(n_sweeps):
        if draws is not None:
            state = gc_sweep(state, w, cfg, mu_c, a, n_exchange, draws[s])
        else:
            state = _advance(state, *run_step(
                ("gcmc", cfg, a, n_exchange, chain0), step,
                (state.r, state.active, state.energy, mu_c, s2a, w,
                 words[s], wx[s], orders[s])))
        tr[0].append(state.active.sum(-1))
        tr[1].append(state.energy)
        if z_bins:
            tr[2].append(z_hist(state.r, state.active, cfg, z_bins).sum(0))
        if gr_bins:
            h, npr = _masked_gr_hist(state.r, state.active, cfg, gr_bins)
            tr[3].append(h)
            tr[4].append(npr)
    return state, tuple(torch.stack(x) if x else None for x in tr)


# ----------------------------------------------------------------------
# Initial states
# ----------------------------------------------------------------------

def cubic_grid(cfg: SMCConfig, n0: int) -> np.ndarray:
    """Never-overlapping simple-cubic start: ceil(n0^(1/3))^3 sites sized
    to the box, first n0 taken (tpu_smc.gcmc.cubic_grid; shared with the
    NPT and Gibbs engines)."""
    m = max(1, math.ceil(n0 ** (1.0 / 3.0)))
    ax_xy = (np.arange(m) + 0.5) / m * cfg.box_l - cfg.box_l / 2.0
    zspan = cfg.box_lz if cfg.pbc_z else max(cfg.box_lz - 2.0, 1.0)
    ax_z = (np.arange(m) + 0.5) / m * zspan - zspan / 2.0
    grid = np.stack(np.meshgrid(ax_xy, ax_xy, ax_z,
                                indexing="ij"), axis=-1).reshape(-1, 3)
    return grid[:n0]


def wall_table(cfg: SMCConfig, device) -> torch.Tensor:
    """The reference's wall table W [M*M, 2] (srand(42)) on `device`."""
    from .system import build_walls

    return torch.as_tensor(build_walls(cfg)[0], dtype=cfg.torch_dtype,
                           device=device)


def init_gcmc_state(cfg: SMCConfig, key, cap: int, n0: int | None = None,
                    device="cuda"):
    """(one-chain GCMCState, wall table): n0 active particles (default
    cap // 2) on cubic_grid, parked slots repeating active positions
    (tpu_smc.gcmc.init_gcmc_state). key: the chain's seed words [2]."""
    cfg_cap = _with_n(cfg, cap)
    n0 = cap // 2 if n0 is None else n0
    if not 0 < n0 <= cap:
        raise ValueError(f"n0 ({n0}) must be in (0, cap={cap}]")
    r0 = cubic_grid(cfg, n0)
    w = wall_table(cfg, device)
    dtype = cfg.torch_dtype
    reps = -(-cap // n0)
    r = torch.as_tensor(np.tile(r0, (reps, 1))[:cap], dtype=dtype,
                        device=device)[None]
    active = (torch.arange(cap, device=device) < n0)[None]
    i64 = dict(dtype=torch.int64, device=device)
    z = torch.zeros((1,), **i64)
    st = GCMCState(
        r=r, active=active,
        energy=total_energy_masked(r, active, w, cfg_cap),
        key=torch.as_tensor(key, **i64).reshape(1, 2),
        sweeps=z, disp_acc=z, disp_att=z, ins_acc=z, ins_att=z,
        del_acc=z, del_att=z,
        boltz_sum=torch.zeros((1,), dtype=dtype, device=device),
        boltz_cnt=z)
    return st, w


# ----------------------------------------------------------------------
# Per-sweep observables
# ----------------------------------------------------------------------

def chain_blocks(c: int, per_chain: int):
    """Chain ranges whose per_chain elements each stay within
    PAIR_BUDGET."""
    step = max(1, PAIR_BUDGET // max(per_chain, 1))
    return [(c0, min(c, c0 + step)) for c0 in range(0, c, step)]


def z_hist(r: torch.Tensor, active: torch.Tensor, cfg: SMCConfig,
           z_bins: int) -> torch.Tensor:
    """[C, z_bins] counts of active particles by z bin
    (tpu_smc/gcmc.py:332-336)."""
    zb = torch.clamp(((r[..., 2] / cfg.box_lz + 0.5) * z_bins).to(
        torch.int64), 0, z_bins - 1)
    h = torch.zeros(r.shape[0], z_bins, dtype=torch.float64,
                    device=r.device)
    return h.scatter_add_(1, zb, active.to(torch.float64))


def gr_rmax(cfg: SMCConfig) -> float:
    return cfg.lj_cutoff if cfg.lj_cutoff < cfg.box_l / 2 else cfg.box_l / 2


def _masked_gr_hist(r: torch.Tensor, active: torch.Tensor,
                    cfg: SMCConfig, nbins: int):
    """Pair-distance histogram over ACTIVE pairs i < j (min image in x, y
    and z under pbc_z), summed over chains: ([nbins] counts, active pair
    count, a 0-d tensor), tpu_smc.gcmc._masked_gr_hist; in chain
    blocks."""
    c, cap = active.shape
    rmax = gr_rmax(cfg)
    hist = torch.zeros(nbins + 1, dtype=torch.float64, device=r.device)
    upper = torch.triu(torch.ones(cap, cap, dtype=torch.bool,
                                  device=r.device), diagonal=1)
    for c0, c1 in chain_blocks(c, cap * cap):
        rb, ab = r[c0:c1], active[c0:c1]
        d = rb[:, :, None, :] - rb[:, None, :, :]
        dx = d[..., 0] - cfg.box_l * torch.round(d[..., 0] / cfg.box_l)
        dy = d[..., 1] - cfg.box_l * torch.round(d[..., 1] / cfg.box_l)
        dz = d[..., 2]
        if cfg.pbc_z:
            dz = dz - cfg.box_lz * torch.round(dz / cfg.box_lz)
        dr = torch.sqrt(dx * dx + dy * dy + dz * dz)
        ok = (ab[:, :, None] & ab[:, None, :] & upper).to(torch.float64)
        b = torch.clamp((dr / rmax * nbins).to(torch.int64), 0, nbins)
        hist.scatter_add_(0, b.reshape(-1), ok.reshape(-1))
    n = active.sum(-1).to(torch.float64)
    return hist[:nbins], (n * (n - 1.0) / 2.0).sum()


# ----------------------------------------------------------------------
# Driver
# ----------------------------------------------------------------------

class GCMCResults(NamedTuple):
    mean_n: float
    err_n: float            # chain-spread error bar (ensemble runs)
    mean_density: float     # <N>/V
    mean_energy: float      # potential E (no kinetic: N fluctuates)
    disp_acceptance: float
    insert_acceptance: float
    delete_acceptance: float
    n_trace: np.ndarray     # [sweeps, C]
    energy_trace: np.ndarray
    zprofile: np.ndarray | None
    gr: np.ndarray | None
    r_final: np.ndarray
    active_final: np.ndarray
    mu_ex: float = float("nan")     # in-run Widom, shared-mu runs
    kappa_t: float = float("nan")   # V <dN^2> / (T <N>^2)
    # the port's: the largest |tracked - exact| / max(|exact|, 1) over
    # the run's resyncs, and production chain-sweeps per second
    resync_drift: float = float("nan")
    sweeps_per_second: float = float("nan")


def resync(energy: torch.Tensor, exact: torch.Tensor, drift: list):
    """Record the tracked energy's relative drift from the exact
    recompute, and return the exact one."""
    rel = (energy - exact).abs() / torch.clamp(exact.abs(), min=1.0)
    drift.append(float(rel.max()))
    return exact.to(energy.dtype)


def run_parts(parts, n_sweeps: int, chunk: int, block, exact,
              drift: list):
    """n_sweeps sweeps of every part [(state, chain0)] of a chain-sharded
    ensemble (one part: the unsharded run), in blocks that end at the
    absolute multiples of `chunk`: block(state, chain0, k) -> (state,
    traces) on each part, one after another from this thread (each
    part's launches go to its device); at every multiple the tracked
    energies are replaced by exact(state) (resync), with one drift
    entry, the largest over the parts. Both sum each part's chains as
    the unsharded call does (potentials.split_of). Returns (parts,
    [[traces of each part] per block])."""
    traces = []
    done = 0
    with split_of(sum(st.n_chains for st, _ in parts), len(parts)):
        while done < n_sweeps:
            s0 = int(parts[0][0].sweeps[0])
            k = min(chunk - s0 % chunk, n_sweeps - done)
            out = [block(st, c0, k) for st, c0 in parts]
            if (s0 + k) % chunk == 0:
                worst: list = []
                out = [(st.replace(energy=resync(st.energy, exact(st),
                                                 worst)), tr)
                       for st, tr in out]
                drift.append(max(worst))
            parts = [(st, c0) for (st, _), (_, c0) in zip(out, parts)]
            traces.append([tr for _, tr in out])
            done += k
    return parts, traces


def _rate(acc, att) -> float:
    acc = int(np.asarray(acc).sum())
    att = int(np.asarray(att).sum())
    return acc / att if att else float("nan")


def simulate_gcmc(cfg: SMCConfig, mu, cap: int, eqsteps: int,
                  maxsteps: int, key, n_chains: int = 1,
                  n_exchange: int | None = None, n0: int | None = None,
                  z_bins: int = 0, gr_bins: int = 0, chunk: int = 200,
                  state0: GCMCState | None = None, seed=None,
                  device="cuda", devices=None):
    """Grand-canonical driver (tpu_smc.gcmc.simulate_gcmc): eqsteps
    thermalization sweeps (the same A; tpu_smc does not double it here)
    and maxsteps production sweeps of every chain. mu: scalar or one per
    chain [n_chains] (an isotherm rides the chain batch). n_exchange
    defaults to cap // 4. key: seed words [2] of the chains' keys
    (chain i's folded from it by index); seed: the run seed of the
    streams (None: chain 0's key). state0: a resumed batched state.
    The tracked energy is replaced by the exact recompute at every
    absolute multiple of `chunk` sweeps. devices: the chains split over
    these devices (ensemble.make_mesh; tpu_smc shards its isotherm
    family the same way), one contiguous range each with its mu, every
    draw keyed by the global chain index, each shard's sums in the
    one-device call's order (run_parts) and the profiles' counts added:
    bitwise the one-device run.
    The returned state is on `device` (state0's own when given).
    Returns (state, GCMCResults)."""
    from .driver import _sync
    from .ensemble import concat_states, shard_ensemble

    if n_exchange is None:
        n_exchange = max(1, cap // 4)
    cfg_cap = _with_n(cfg, cap)
    a = cfg.proposal_a
    if state0 is not None:
        if tuple(state0.active.shape) != (n_chains, cap):
            raise ValueError(
                f"checkpoint holds {state0.r.shape[0]} chains x cap "
                f"{state0.r.shape[1]}; run asked {n_chains} x {cap}")
        state = state0
    else:
        state = batch_state(init_gcmc_state(cfg, key, cap, n0=n0,
                                            device=device)[0], n_chains)
    dev = state.r.device
    if seed is None:
        seed = state.key[0].cpu()      # the global chain 0's streams
    mu_np = np.broadcast_to(np.asarray(mu, np.float64), (n_chains,)).copy()
    parts = shard_ensemble(state, devices) if devices else [(state, 0)]
    walls = {}
    drift: list = []

    def run(parts, n_sweeps, collect):
        def block(st, c0, k):
            d = st.r.device
            if d not in walls:
                walls[d] = wall_table(cfg, d)
            mu_c = torch.as_tensor(mu_np[c0:c0 + st.n_chains],
                                   dtype=cfg.torch_dtype, device=d)
            return gc_block(st, walls[d], cfg_cap, mu_c, a, k, n_exchange,
                            z_bins if collect else 0,
                            gr_bins if collect else 0, seed, chain0=c0)

        return run_parts(parts, n_sweeps, chunk, block, lambda st:
                         total_energy_masked(st.r, st.active,
                                             walls[st.r.device], cfg_cap),
                         drift)

    parts, _ = run(parts, eqsteps, collect=False)
    parts = [(zero_counters(st, COUNTERS), c0) for st, c0 in parts]
    for st, _ in parts:
        _sync(st)
    t0 = time.perf_counter()
    parts, traces = run(parts, maxsteps, collect=True)
    for st, _ in parts:
        _sync(st)
    state = (parts[0][0] if len(parts) == 1
             else concat_states([p for p, _ in parts], dev))

    def cat(i):
        if not traces or traces[0][0][i] is None:
            return None
        if i < 2:       # [S, C]: the parts side by side
            x = torch.cat([torch.cat([tr[i].to(dev) for tr in trs], 1)
                           for trs in traces])
        else:           # chain sums: the parts' counts added
            x = torch.cat([sum(tr[i].to(dev) for tr in trs)
                           for trs in traces])
        return (x if i == 0 else x.double()).cpu().numpy()

    n_tr, e_tr = cat(0), cat(1)
    if n_tr is None:
        n_tr = e_tr = np.zeros((0, n_chains))
    wall = time.perf_counter() - t0
    return state, _gcmc_results(cfg, state, n_tr, e_tr, cat(2), cat(3),
                                cat(4), drift,
                                n_chains * maxsteps / max(wall, 1e-12))


def _gcmc_results(cfg, state, n_tr, e_tr, z_tr, g_tr, p_tr, drift,
                  rate) -> GCMCResults:
    """GCMCResults from the production traces (tpu_smc/gcmc.py:479-541);
    z_tr, g_tr, p_tr: gc_block's per-sweep profile sums or None."""
    n_chains = state.n_chains
    chain_n = n_tr.mean(axis=0) if n_tr.size else np.zeros(n_chains)
    zp = None
    if z_tr is not None:
        zp = (z_tr.sum(0) / (n_chains * len(z_tr))
              / (cfg.box_l ** 2 * (cfg.box_lz / z_tr.shape[1])))
    gr = None
    if g_tr is not None:
        edges = np.linspace(0.0, gr_rmax(cfg), g_tr.shape[1] + 1)
        shell = (4.0 / 3.0) * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
        gr = (g_tr.sum(0) / max(float(p_tr.sum()), 1.0)) * box_volume(cfg) \
            / shell
    bsum = float(state.boltz_sum.double().sum())
    bcnt = int(state.boltz_cnt.sum())
    mu_ex = (-cfg.temperature * np.log(bsum / bcnt)
             if bcnt and bsum > 0 else float("nan"))
    if n_tr.size and n_tr.mean() > 0:
        kappa = (box_volume(cfg) * float(n_tr.var())
                 / (cfg.temperature * float(n_tr.mean()) ** 2))
    else:
        kappa = float("nan")
    cnt = {f: getattr(state, f).cpu().numpy() for f in COUNTERS}
    return GCMCResults(
        mean_n=float(chain_n.mean()),
        err_n=float(chain_n.std() / np.sqrt(max(1, n_chains - 1)))
        if n_chains > 1 else float(n_tr.std() / np.sqrt(max(1, len(n_tr)))),
        mean_density=float(chain_n.mean()) / box_volume(cfg),
        mean_energy=float(e_tr.mean()) if e_tr.size else float("nan"),
        disp_acceptance=_rate(cnt["disp_acc"], cnt["disp_att"]),
        insert_acceptance=_rate(cnt["ins_acc"], cnt["ins_att"]),
        delete_acceptance=_rate(cnt["del_acc"], cnt["del_att"]),
        n_trace=n_tr, energy_trace=e_tr, zprofile=zp, gr=gr,
        r_final=state.r.cpu().numpy(),
        active_final=state.active.cpu().numpy(),
        mu_ex=mu_ex, kappa_t=kappa,
        resync_drift=max(drift) if drift else float("nan"),
        sweeps_per_second=rate)


# ----------------------------------------------------------------------
# Checkpoints and CSV
# ----------------------------------------------------------------------

_INT32 = ("sweeps", "disp_acc", "disp_att", "ins_acc", "ins_att",
          "del_acc", "del_att", "boltz_cnt", "accepted", "vol_acc",
          "vol_att", "tr_acc", "tr_att")


def state_arrays(state) -> dict:
    """numpy leaves of a state dataclass in tpu_smc's checkpoint dtypes:
    counters int32, the key words uint32."""
    out = {}
    for f in dataclasses.fields(state):
        a = getattr(state, f.name).detach().cpu().numpy()
        if f.name == "key":
            a = a.astype(np.uint32)
        elif f.name in _INT32:
            a = a.astype(np.int32)
        out[f.name] = a
    return out


def state_from_npz(cls, arrays, cfg: SMCConfig, device):
    """A state dataclass on `device` from numpy leaves of either package
    (keys as uint32 words, jax.random.key_data of tpu_smc's keys; extra
    leaves such as tpu_smc's vkey / tkey are ignored): `active` bool,
    counters and keys int64, the rest in cfg's dtype."""
    fields = {}
    for f in dataclasses.fields(cls):
        a = np.asarray(arrays[f.name])
        if f.name == "active":
            fields[f.name] = torch.as_tensor(a.astype(bool), device=device)
        elif f.name == "key" or f.name in _INT32:
            fields[f.name] = torch.as_tensor(a.astype(np.int64),
                                             device=device)
        else:
            fields[f.name] = torch.as_tensor(a.astype(np.float64),
                                             dtype=cfg.torch_dtype,
                                             device=device)
    return cls(**fields)


def save_gcmc_checkpoint(path, state: GCMCState, cfg: SMCConfig,
                         stream_seed=None):
    """Full GCMC ensemble state -> npz in tpu_smc's format (with the
    `__gcmc__` mark), plus the streams' run seed. Resume is bitwise:
    the streams are keyed to the absolute sweep."""
    from .io import save_npz_state

    return save_npz_state(path, cfg, state_arrays(state), stream_seed,
                          __gcmc__=1)


def load_checkpoint_of(path, mark: str, cls, device):
    """(state, cfg, stream_seed) of an ensemble-family checkpoint of
    either package carrying `mark`."""
    from .io import checkpoint_config

    with np.load(path) as data:
        if mark not in data.files:
            raise ValueError(f"{path} is not a {mark.strip('_').upper()} "
                             "checkpoint")
        cfg, seed = checkpoint_config(data, path)
        arrays = {k: data[k] for k in data.files}
    return state_from_npz(cls, arrays, cfg, device), cfg, seed


def load_gcmc_checkpoint(path, device="cuda"):
    """-> (GCMCState, SMCConfig, stream_seed or None); cfg.n is the run's
    base n (the capacity is the state's r.shape[1])."""
    return load_checkpoint_of(path, "__gcmc__", GCMCState, device)


def write_gcmc_csv(d, cfg: SMCConfig, mu: float, res: GCMCResults):
    """gcmc_*.csv: run summary in the header comment, then the pooled
    per-sweep (N, E) trace (chain means); tpu_smc's writer."""
    from .io import _fname

    p = _fname(d, "gcmc", cfg)
    with open(p, "w") as f:
        f.write(f"# mu, {mu:0.9f}, mean_N, {res.mean_n:0.6f}, "
                f"err_N, {res.err_n:0.6f}, density, "
                f"{res.mean_density:0.9f}, acc_disp, "
                f"{res.disp_acceptance:0.4f}, acc_ins, "
                f"{res.insert_acceptance:0.4f}, acc_del, "
                f"{res.delete_acceptance:0.4f}, mu_ex_run, "
                f"{res.mu_ex:0.6f}\n")
        f.write("sweep, N_mean, E_mean\n")
        n_m = res.n_trace.mean(axis=1)
        e_m = res.energy_trace.mean(axis=1)
        for i in range(len(n_m)):
            f.write(f"{i}, {n_m[i]:0.4f}, {e_m[i]:0.6f}\n")
    return p
