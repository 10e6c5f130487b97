"""Parallel tempering (replica exchange) over the temperature ladder
(counterpart of tpu_smc.pt).

The C chains are laid out [n_t, chains_per_t], temperature-major like
tsweep: chains_per_t independent ladders side by side. Every
`exchange_interval` sweeps an exchange step proposes swaps between
adjacent levels (i, i+1) of each ladder, even and odd pairings in turn,
and accepts with

    P = min(1, exp((beta_i - beta_j) (E_i - E_j)))

on the chains' running potential energies. On accept the CONFIGURATION
(positions r, energy E and the voxel tracker rbin) swaps slots; the
temperature, mobility, seed words, counters and voxel accumulators stay
with the slot. With per-chain walls the realization lives in the replica
index, so a swap never crosses realizations.

The sweeps of a cycle are one engine call; the exchange is a few small
torch ops on the chains' device. Its uniforms and parity derive from the
ABSOLUTE cycle index, so a run split into more calls gives the same
result.

One ladder spanning the processes (a `tsweep.LadderShard` per rank):
every exchange gathers the ladder's (r, E, rbin) from every rank, runs
the exchange step on the global arrays, identically on every rank, and
each rank keeps its slice; the swap counters are therefore global on
every rank, and `--pt-exchange auto` chooses one interval everywhere.
Complete ladders per process pool with `pool_pt_across_processes`.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .config import RunParams, SMCConfig
from .state import ChainState, fold_in
from .tsweep import (FieldOptions, LadderPart, LadderShard, TSweepResults,
                     _fields, _pressure, gather_chain_axis, host_cat,
                     join_ladder, ladder_blocks, ladder_stats, parts_moves,
                     split_ladder, stack_fields)

_EXCHANGE_SALT = 0x9C0FFEE


def exchange_uniforms(key: torch.Tensor, n_t: int, chains_per_t: int,
                      device, dtype) -> torch.Tensor:
    """[n_t, chains_per_t] uniforms in (0, 1) of one exchange attempt:
    Philox4x32-10 of (index, 0xE8C, 0, 0) under the attempt's seed words."""
    from .kernels.sweep import philox4x32, unit_uniform

    idx = torch.arange(n_t * chains_per_t, dtype=torch.int64, device=device)
    z = torch.zeros_like(idx)
    b = philox4x32(idx, z + 0xE8C, z, z, z + int(key[0]), z + int(key[1]))
    return unit_uniform(b[0], dtype).reshape(n_t, chains_per_t)


def exchange_step(state: ChainState, betas_t: torch.Tensor,
                  chains_per_t: int, key: torch.Tensor | None, parity: int,
                  uniforms: torch.Tensor | None = None):
    """One replica-exchange attempt across the ladder.

    `state` carries C = n_t * chains_per_t chains, temperature-major.
    betas_t [n_t] is 1/T per level; parity 0/1 picks the even/odd
    pairing. uniforms [n_t, chains_per_t] replaces the draws made from
    `key` (tests inject the JAX package's).
    Returns (state, accepts [n_t-1] int32, attempts [n_t-1] int32)."""
    n_t = betas_t.shape[0]
    dev = state.energy.device
    if uniforms is None:
        uniforms = exchange_uniforms(key, n_t, chains_per_t, dev,
                                     state.energy.dtype)
    u = uniforms.to(device=dev, dtype=state.energy.dtype)
    e = state.energy.reshape(n_t, chains_per_t)
    betas = betas_t.to(device=dev, dtype=state.energy.dtype)
    idx = torch.arange(n_t, device=dev)
    # level i is the LOW side of a proposed pair (i, i+1) when its index
    # matches the parity and a partner above exists
    is_lo = ((idx % 2) == (int(parity) % 2)) & (idx + 1 < n_t)
    up = torch.clamp(idx + 1, max=n_t - 1)
    delta = (betas - betas[up])[:, None] * (e - e[up])
    accept_lo = is_lo[:, None] & (torch.log(u) < delta)
    # a level swaps UP if it accepted as the low side, DOWN if the level
    # below accepted; with an even/odd pairing these are disjoint
    from_below = torch.cat([torch.zeros_like(accept_lo[:1]),
                            accept_lo[:-1]])
    col = idx[:, None].expand(n_t, chains_per_t)
    partner = torch.where(accept_lo, col + 1,
                          torch.where(from_below, col - 1, col))

    def swap(x):
        xl = x.reshape((n_t, chains_per_t) + x.shape[1:])
        p = partner.reshape(partner.shape + (1,) * (xl.dim() - 2))
        return torch.take_along_dim(xl, p.expand(xl.shape), dim=0) \
            .reshape(x.shape)

    new = state.replace(r=swap(state.r), energy=swap(state.energy),
                        rbin=swap(state.rbin))
    accepts = accept_lo.sum(dim=1)[:-1].to(torch.int32)
    attempts = (is_lo.to(torch.int32) * chains_per_t)[:-1]
    return new, accepts, attempts


def exchange_global(state: ChainState, betas_t: torch.Tensor,
                    chains_per_t: int, key: torch.Tensor, parity: int,
                    shard: LadderShard | None = None):
    """exchange_step on the whole ladder: a shard's (r, E, rbin) are
    gathered from every rank, the step runs on the global arrays (the
    same on every rank) and the shard keeps its slice. Returns (state,
    accepts, attempts), global counts."""
    if shard is None:
        return exchange_step(state, betas_t, chains_per_t, key, parity)
    from .distributed import allgather_chain_axis

    def whole(x):
        return torch.from_numpy(allgather_chain_axis(
            x.cpu().numpy())).to(x.device)

    g = state.replace(r=whole(state.r), energy=whole(state.energy),
                      rbin=whole(state.rbin))
    g, acc, att = exchange_step(g, betas_t, chains_per_t, key, parity)
    mine = slice(shard.chain0, shard.chain0 + shard.count)
    return (state.replace(r=g.r[mine].contiguous(),
                          energy=g.energy[mine].contiguous(),
                          rbin=g.rbin[mine].contiguous()), acc, att)


def exchange_parts(parts, betas_t: torch.Tensor, chains_per_t: int,
                   key: torch.Tensor, parity: int,
                   shard: LadderShard | None = None):
    """exchange_global over a process's LadderParts: their (r, E, rbin)
    gathered to the first part's device in chain order, the step run
    there once (on the whole ladder, with the other ranks' chains under
    a shard), and each part handed back its slice; no host round trip.
    Returns (parts, accepts, attempts)."""
    if len(parts) == 1:
        st, acc, att = exchange_global(parts[0].state, betas_t, chains_per_t,
                                       key, parity, shard)
        return [parts[0]._replace(state=st)], acc, att
    dev0 = parts[0].state.r.device

    def whole(name):
        return torch.cat([getattr(p.state, name).to(dev0) for p in parts])

    g = parts[0].state.replace(r=whole("r"), energy=whole("energy"),
                               rbin=whole("rbin"))
    g, acc, att = exchange_global(g, betas_t, chains_per_t, key, parity,
                                  shard)
    out, k0 = [], 0
    for p in parts:
        dev, sl = p.state.r.device, slice(k0, k0 + p.state.n_chains)
        out.append(p._replace(state=p.state.replace(
            r=g.r[sl].to(dev), energy=g.energy[sl].to(dev),
            rbin=g.rbin[sl].to(dev))))
        k0 = sl.stop
    return out, acc, att


def pt_cycles_parts(parts, cfg: SMCConfig, betas_t: torch.Tensor,
                    a_scale: float, chains_per_t: int, interval: int,
                    n_cycles: int, cycle0: int, ekey: torch.Tensor,
                    sampler: str, collect_trace: bool = False,
                    shard: LadderShard | None = None, seed=None):
    """pt_cycles over LadderParts (tsweep.split_ladder): each cycle's
    sweeps one engine call per part, then one exchange of the whole
    ladder (exchange_parts). Returns (parts, accepts, attempts, energy
    traces per part: a list of [interval, C_part] per cycle)."""
    n_t = betas_t.shape[0]
    nacc = np.zeros((max(n_t - 1, 0),), np.int64)
    natt = np.zeros_like(nacc)
    traces = [[] for _ in parts]
    for k in range(n_cycles):
        parts, stats = ladder_blocks(parts, cfg, a_scale, interval, sampler,
                                     collect_trace=collect_trace, seed=seed)
        if collect_trace:
            for tr, st in zip(traces, stats):
                tr.append(st.energy)
        abs_k = cycle0 + k
        parts, acc, att = exchange_parts(parts, betas_t, chains_per_t,
                                         fold_in(ekey, [abs_k])[0],
                                         abs_k % 2, shard)
        nacc += acc.cpu().numpy()
        natt += att.cpu().numpy()
    return parts, nacc, natt, traces


def pt_cycles(state: ChainState, w, cfg: SMCConfig, temps_c: torch.Tensor,
              betas_t: torch.Tensor, a_scale: float, chains_per_t: int,
              interval: int, n_cycles: int, cycle0: int, ekey: torch.Tensor,
              sampler: str, collect_trace: bool = False, a_c=None,
              shard: LadderShard | None = None, seed=None):
    """n_cycles x (interval sweeps as one engine call + one exchange
    attempt). cycle0 is the absolute index of the first cycle: the
    attempt's seed words fold it into `ekey` and its parity is its
    parity, so cycles split over calls give the same result. shard and
    seed (the global chain 0 key): one ladder spanning the processes
    (exchange_global). Returns (state, accepts [n_t-1] int64, attempts
    [n_t-1] int64, energy traces [interval, C] per cycle when
    collect_trace)."""
    part = LadderPart(state, w, temps_c, a_c,
                      0 if shard is None else shard.chain0)
    parts, nacc, natt, traces = pt_cycles_parts(
        [part], cfg, betas_t, a_scale, chains_per_t, interval, n_cycles,
        cycle0, ekey, sampler, collect_trace=collect_trace, shard=shard,
        seed=seed)
    return parts[0].state, nacc, natt, traces[0]


class PTResults(NamedTuple):
    tsweep: TSweepResults           # per-T E/err/acceptance/cv
    pair_t_lo: np.ndarray           # [n_t-1]
    pair_t_hi: np.ndarray           # [n_t-1]
    swap_acceptance: np.ndarray     # [n_t-1] accepted / attempted
    swap_attempts: np.ndarray       # [n_t-1] production attempts per pair
    exchange_interval: int          # the interval used ("auto": chosen)
    # "auto": per-pair swap acceptance of the post-thermalization probe
    probe_acceptance: np.ndarray | None = None


def choose_exchange_interval(pair_acceptance, target_rate: float = 0.06,
                             lo: int = 2, hi: int = 50) -> int:
    """Exchange interval holding the accepted-swap rate per pair per
    sweep near `target_rate` for the weakest pair:
    clip(round(min(p) / target_rate), lo, hi), quantized log-nearest to
    {2, 5, 10, 20, 50} (tpu_smc.pt.choose_exchange_interval's rule)."""
    p = np.asarray(pair_acceptance, np.float64)
    if p.size == 0:       # single-level "ladder": no pairs to exchange
        return hi
    raw = np.clip(float(p.min()) / target_rate, lo, hi)
    menu = np.asarray([2, 5, 10, 20, 50], np.float64)
    menu = menu[(menu >= lo) & (menu <= hi)]
    return int(menu[np.argmin(np.abs(np.log(menu) - np.log(raw)))])


def simulate_parallel_tempering(
    cfg: SMCConfig,
    params: RunParams,
    temps,
    key: torch.Tensor,
    chains_per_t: int = 16,
    exchange_interval: int | str = 10,
    r0: np.ndarray | None = None,
    w: np.ndarray | None = None,
    sampler: str = "torch",
    a_per_t=None,
    device="cuda",
    state0: ChainState | None = None,
    fields: FieldOptions = FieldOptions(),
    shard: LadderShard | None = None,
    devices=None,
) -> tuple[ChainState, PTResults]:
    """The ladder with replica exchange every `exchange_interval` sweeps
    ("auto": measure the swap acceptance on a 40-cycle probe after
    thermalization at interval 10 and choose with
    choose_exchange_interval). eqsteps / maxsteps round up to whole
    cycles; swap statistics count production attempts only; per-T
    statistics follow tsweep's. The mobility (a_per_t or gamma*T)
    belongs to the temperature slot, like T. state0: resume from a
    ladder state (tsweep's); exchange attempts are numbered from its
    absolute sweep counter, so a resumed run at a cycle boundary
    continues the uninterrupted one's exchanges. fields: the paired
    field samples taken with each (P, E) pair (tsweep._fields). shard:
    this process's chains of one ladder spanning the processes, as in
    tsweep.simulate_temperature_sweep (collective). devices: the chains
    split over these devices as in simulate_temperature_sweep, every
    exchange gathered to the first (exchange_parts); bitwise the
    one-device run, swap counts and the auto probe included."""
    from .driver import therm_chunk
    from .tsweep import ladder_start

    temps = np.asarray(temps, dtype=np.float64)
    n_t = len(temps)
    auto = exchange_interval == "auto"
    if isinstance(exchange_interval, str) and not auto:
        raise ValueError(f"exchange_interval must be an int or 'auto', "
                         f"got {exchange_interval!r}")
    interval = 10 if auto else max(1, int(exchange_interval))
    c = n_t * chains_per_t
    state, w_t, key0 = ladder_start(cfg, key, c, r0, w, device, state0,
                                    shard)
    mine = slice(0, c) if shard is None else slice(
        shard.chain0, shard.chain0 + shard.count)
    f64 = dict(dtype=torch.float64, device=device)
    temps_c = torch.as_tensor(np.repeat(temps, chains_per_t)[mine], **f64)
    dev0 = torch.device(devices[0]) if devices else device
    betas_t = torch.as_tensor(1.0 / temps, dtype=cfg.torch_dtype,
                              device=dev0)
    a_c = (None if a_per_t is None else torch.as_tensor(
        np.repeat(np.asarray(a_per_t, np.float64), chains_per_t)[mine],
        **f64))
    home = state.r.device
    parts = split_ladder(state, w_t, temps_c, a_c, mine.start, devices)
    ekey = fold_in(key0, [_EXCHANGE_SALT])[0]
    sweep_budget = therm_chunk(cfg, sampler=sampler)

    def run_phase(parts, total_sweeps, a_scale, cycle0, collect=False,
                  lapse=1):
        """ceil(total_sweeps / interval) cycles in groups of
        max(1, budget // interval), each group harvested (accept counts,
        and when collecting the paired (P, E) sample at its end);
        energies sampled at the absolute gather cadence."""
        cycles = -(-total_sweeps // interval)
        group = max(1, sweep_budget // interval)
        acc = np.zeros((max(n_t - 1, 0),), np.int64)
        att = np.zeros_like(acc)
        moves = np.zeros((state.n_chains,), np.int64)
        samples, p_samples, e_at_p, f_samples = [], [], [], []
        done = sweep0 = 0
        while done < cycles:
            k = min(group, cycles - done)
            parts, a_blk, t_blk, traces = pt_cycles_parts(
                parts, cfg, betas_t, a_scale, chains_per_t, interval, k,
                cycle0 + done, ekey, sampler, collect_trace=collect,
                shard=shard, seed=key0)
            acc += a_blk
            att += t_blk
            if collect:
                e_blk = host_cat([torch.cat(tr) for tr in traces], 1)
                samples.append(e_blk[(lapse - 1 - sweep0) % lapse::lapse])
                sweep0 += e_blk.shape[0]
                whole = join_ladder(parts, home)
                p_samples.append(_pressure(cfg, whole.r, w_t))
                e_at_p.append(whole.energy.cpu().numpy())
                if fields.any():
                    f_samples.append(_fields(cfg, whole, w_t, fields, lapse))
            blk_moves, parts = parts_moves(parts)
            moves += blk_moves
            done += k
        return (parts, acc, att, samples, moves, p_samples, e_at_p,
                f_samples, cycle0 + cycles)

    # thermalization: A doubled (SMC.c:110, 125); exchanges run but are
    # not counted
    parts, *_, cyc = run_phase(parts, params.eqsteps, 2.0,
                               int(state.sweeps[0]) // interval)
    probe_acc = None
    if auto:
        parts, acc_p, att_p, *_, cyc = run_phase(parts, 40 * interval, 1.0,
                                                 cyc)
        probe_acc = acc_p / np.maximum(att_p, 1)
        interval = choose_exchange_interval(probe_acc)

    lapse = max(1, params.gather_lapse)
    t0 = time.perf_counter()
    parts, acc, att, samples, moves, p_s, e_p, f_s, _ = run_phase(
        parts, params.maxsteps, 1.0, cyc, collect=True, lapse=lapse)
    prod_sweeps = -(-params.maxsteps // interval) * interval
    prod_sps = prod_sweeps * c / max(time.perf_counter() - t0, 1e-9)

    e_tr = gather_chain_axis(np.concatenate(samples) if samples
                             else np.zeros((0, state.n_chains)), 1, shard)
    moves = gather_chain_axis(moves, 0, shard)
    e_t = e_tr.reshape(len(e_tr), n_t, chains_per_t)
    mean_e, err_e, acc_moves, cv = ladder_stats(e_t, moves, prod_sweeps,
                                                temps, cfg)
    shape_t = (-1, n_t, chains_per_t)
    ts = TSweepResults(
        temps=temps, mean_energy=mean_e, err_energy=err_e,
        acceptance=acc_moves, cv=cv, energy_samples=e_t,
        pressure_samples=(gather_chain_axis(np.stack(p_s), 1, shard)
                          .reshape(shape_t) if p_s else None),
        energy_at_pressure=(gather_chain_axis(np.stack(e_p), 1, shard)
                            .reshape(shape_t) if e_p else None),
        sweeps_per_second=prod_sps,
        **stack_fields(f_s, n_t, chains_per_t, shard))
    return join_ladder(parts, home), PTResults(
        tsweep=ts, pair_t_lo=temps[:-1], pair_t_hi=temps[1:],
        swap_acceptance=acc / np.maximum(att, 1), swap_attempts=att,
        exchange_interval=interval, probe_acceptance=probe_acc)


def pool_pt_across_processes(res: PTResults, cfg: SMCConfig) -> PTResults:
    """Pool per-process PT results (tpu_smc/pt.py:490-509): the replica
    axis concatenated (tsweep.pool_tsweep_across_processes), the per-pair
    swap attempts summed and the acceptance weighted by them (every
    process owns complete ladders, so its exchanges are its own).
    Collective; every rank gets the pooled result."""
    from .distributed import allgather_chain_axis
    from .tsweep import pool_tsweep_across_processes

    ts = pool_tsweep_across_processes(res.tsweep, cfg)
    att = allgather_chain_axis(
        np.asarray(res.swap_attempts, np.int64)[None])      # [P, n_t-1]
    acc = allgather_chain_axis(
        (np.asarray(res.swap_acceptance)
         * np.asarray(res.swap_attempts))[None])
    att_sum = att.sum(axis=0)
    return res._replace(tsweep=ts,
                        swap_acceptance=acc.sum(axis=0) / np.maximum(att_sum,
                                                                     1),
                        swap_attempts=att_sum)


def write_pt_csv(d, cfg: SMCConfig, res: PTResults):
    from .io import _fname

    p = _fname(d, "pt", cfg)
    with open(p, "w") as f:
        f.write("T_lo, T_hi, swap_acceptance, attempts\n")
        for i in range(len(res.pair_t_lo)):
            f.write(f"{res.pair_t_lo[i]:0.4f}, {res.pair_t_hi[i]:0.4f}, "
                    f"{res.swap_acceptance[i]:0.6f}, "
                    f"{res.swap_attempts[i]:d}\n")
    return p
