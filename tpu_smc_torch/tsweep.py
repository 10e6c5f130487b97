"""Temperature-sweep driver: a whole temperature ladder as one ensemble
(counterpart of tpu_smc.tsweep).

The reference fixes T per process (argv, main.c:18). Here temperature is
a per-chain value: chains_per_t replicas at each of the len(temps)
temperatures run as ONE ensemble, temperature-major (np.repeat(temps,
chains_per_t)). On the kernel engines every chain's (A, T) rides the
kernel's per-chain rows, so one launch advances the whole ladder. The
mobility follows A = gamma * T per chain (main.c:48-51) unless a tuned
ladder is given, and thermalization doubles it (SMC.c:110, 125).

Output: `tsweep_*.csv` with one row per temperature
    T, E_mean, E_err, acceptance, cv
where E carries the 3NT/2 kinetic offset (SMC.c:210-211), E_err is the
replica error bar (spread of chain means / sqrt(chains - 1)), and
cv = var(E)/T^2 (SMC.c:249) pooled over the level's chains.

Over several processes a ladder runs in one of two ways: complete
replica ladders per process, pooled at the end
(`pool_tsweep_across_processes`), or ONE ladder whose flat chain axis is
cut into contiguous rank ranges (`LadderShard`, --global-ladder): each
rank sweeps its range keyed by the global chain index, the samples are
gathered before the statistics, and every rank holds the global result,
bitwise the single-process run's.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .config import RunParams, SMCConfig
from .potentials import split_of
from .state import ChainState, fold_in, init_ensemble_state
from .system import build_walls


class LadderShard(NamedTuple):
    """This process's share of ONE ladder spanning the processes
    (--global-ladder): chains [chain0, chain0 + count) of the flat,
    temperature-major ladder-chain axis."""
    chain0: int
    count: int


def gather_chain_axis(x: np.ndarray | None, axis: int,
                      shard: LadderShard | None):
    """x with its chain axis `axis` gathered from every rank in rank
    order (the global ladder), contiguous; x itself without a shard."""
    if x is None or shard is None:
        return x
    from .distributed import allgather_chain_axis

    moved = np.ascontiguousarray(np.moveaxis(np.asarray(x), axis, 0))
    return np.ascontiguousarray(np.moveaxis(allgather_chain_axis(moved), 0,
                                            axis))


class TSweepResults(NamedTuple):
    temps: np.ndarray          # [T]
    mean_energy: np.ndarray    # [T] incl. 3NT/2
    err_energy: np.ndarray     # [T] replica error bar
    acceptance: np.ndarray     # [T]
    cv: np.ndarray             # [T] var(E)/T^2 from the pooled trace
    # per-gather POTENTIAL energies [gathers, T, chains_per_t] (no kinetic
    # offset): the input of MBAR reweighting (reweight.py)
    energy_samples: np.ndarray | None = None
    # paired (virial pressure, energy) samples at engine-call boundaries
    # [B, T, chains_per_t]; the ideal rho*T is added at output
    pressure_samples: np.ndarray | None = None
    energy_at_pressure: np.ndarray | None = None
    # production chain-sweeps/s across all ladder chains
    sweeps_per_second: float | None = None
    # paired field samples at the same boundaries [B, T, chains_per_t,
    # bins] (each None unless sampled): g(r), rho(z), S(k) shells, Widom
    # ghost energies [.., widom_k], and the pressure tensor's VIRIAL parts
    # with the rho(z) on its bins (reweight.py adds rho(z; T') T')
    gr_samples: np.ndarray | None = None
    zprofile_samples: np.ndarray | None = None
    sk_samples: np.ndarray | None = None
    widom_samples: np.ndarray | None = None
    ptensor_n_samples: np.ndarray | None = None
    ptensor_t_samples: np.ndarray | None = None
    ptensor_rho_samples: np.ndarray | None = None


def _ladder_block(state: ChainState, w, cfg: SMCConfig,
                  temps_c: torch.Tensor, a_scale: float, n_sweeps: int,
                  sampler: str, collect_trace: bool = False, a_c=None,
                  chain0: int = 0, seed=None):
    """n_sweeps sweeps of the ladder on one engine with per-chain rows
    A = a_scale * (a_c or gamma*T) and T = temps_c [C]; chain0 and seed
    (the global ladder's chain 0 key on a shard) as the engines take
    them. Returns (state, SweepStats or None)."""
    from . import ensemble as ens

    base = cfg.gamma * temps_c if a_c is None else a_c
    rows = dict(a_per_chain=a_scale * base, t_per_chain=temps_c,
                chain0=chain0, seed=seed)
    if sampler == "zsorted":
        state, stats = ens.ensemble_sweeps_zsorted(state, w, cfg, 0.0,
                                                   n_sweeps, **rows)
    elif sampler == "dense":
        state, stats = ens.ensemble_sweeps_dense(state, w, cfg, 0.0,
                                                 n_sweeps, **rows)
    elif sampler == "torch":
        rows["stream_seed"] = rows.pop("seed")
        state, stats = ens.ensemble_sweeps(state, w, cfg, 0.0, n_sweeps,
                                           collect_trace=collect_trace,
                                           **rows)
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    return state, (stats if collect_trace else None)


class LadderPart(NamedTuple):
    """One device's contiguous chains of a ladder: its state, wall table
    (shared, or its chains' rows of per-chain tables), per-chain T and
    mobility rows, and the global index of its chain 0."""
    state: ChainState
    w: torch.Tensor
    temps_c: torch.Tensor
    a_c: torch.Tensor | None
    chain0: int


def split_ladder(state: ChainState, w, temps_c, a_c, chain0: int,
                 devices=None) -> list:
    """The ladder's chains as LadderParts: one part on the state's device
    without `devices`, else one contiguous range per device
    (ensemble.shard_ensemble), the per-chain rows and wall tables going
    with their chains."""
    if not devices:
        return [LadderPart(state, w, temps_c, a_c, chain0)]
    from .ensemble import _rows_of, shard_ensemble

    c, per = state.n_chains, state.n_chains // len(devices)
    parts = []
    for k, (st, c0) in enumerate(shard_ensemble(state, devices, chain0)):
        dev, sl = st.r.device, slice(k * per, (k + 1) * per)
        parts.append(LadderPart(
            st, (w[sl] if w.dim() == 3 else w).to(dev),
            temps_c[sl].to(dev), _rows_of(a_c, sl, c, dev), c0))
    return parts


def join_ladder(parts, device) -> ChainState:
    """The parts' states concatenated in chain order on `device`."""
    if len(parts) == 1:
        return parts[0].state
    from .ensemble import concat_states

    return concat_states([p.state for p in parts], device)


def ladder_blocks(parts, cfg: SMCConfig, a_scale: float, n_sweeps: int,
                  sampler: str, collect_trace: bool = False, seed=None):
    """_ladder_block on every part, one after another from this thread
    (each part's launches go to its device). Returns (parts, [stats or
    None per part])."""
    out, stats = [], []
    c = sum(p.state.n_chains for p in parts)
    for p in parts:
        with split_of(c, len(parts)):
            st, s = _ladder_block(p.state, p.w, cfg, p.temps_c, a_scale,
                                  n_sweeps, sampler,
                                  collect_trace=collect_trace, a_c=p.a_c,
                                  chain0=p.chain0, seed=seed)
        out.append(p._replace(state=st))
        stats.append(s)
    return out, stats


def host_cat(tensors, axis: int) -> np.ndarray:
    """Per-part tensors joined on the host on the chain axis `axis`, in
    chain order."""
    return np.concatenate([t.cpu().numpy() for t in tensors], axis)


def parts_moves(parts) -> tuple:
    """(accepted moves [C] int64 on the host, the parts with their
    counters set to zero)."""
    moves = host_cat([p.state.accepted for p in parts], 0).astype(np.int64)
    return moves, [p._replace(state=p.state.replace(
        accepted=torch.zeros_like(p.state.accepted))) for p in parts]


def _pressure(cfg: SMCConfig, r: torch.Tensor, w) -> np.ndarray:
    """Per-chain virial pressure (pressure + wallsPressure, SMC.c:140),
    shared or per-chain walls, bounded chain batches."""
    from .observables import wall_obs_chains
    from .potentials import total_pressure

    return wall_obs_chains(lambda rb, wb: total_pressure(rb, wb, cfg), r, w,
                           cfg.n).cpu().numpy()


class FieldOptions(NamedTuple):
    """The ladder's paired field samples (tpu_smc.tsweep._fields_fn's
    arguments); 0 disables each."""
    gr_bins: int = 0
    z_bins: int = 0
    sk_kmax: int = 0
    widom_k: int = 0
    ptensor_bins: int = 0

    def any(self) -> bool:
        return any(self)


# TSweepResults' paired field samples
FIELD_NAMES = ("gr_samples", "zprofile_samples", "sk_samples",
               "widom_samples", "ptensor_n_samples", "ptensor_t_samples",
               "ptensor_rho_samples")


def _fields(cfg: SMCConfig, state: ChainState, w, fo: FieldOptions,
            gather_lapse: int) -> dict:
    """One boundary's paired field samples of every chain, host arrays
    [C, bins] keyed by TSweepResults field: per-configuration g(r) and
    rho(z), S(k), Widom ghost energies (their stream folds the absolute
    gather state.sweeps // gather_lapse, widom.py) and the pressure
    tensor's virial parts with rho(z) on its bins; the all-pairs ones in
    chain batches within potentials.PAIR_BUDGET."""
    from .observables import (pressure_tensor_profile, radial_distribution,
                              structure_factor, vmap_chains_bounded,
                              z_density_profile)

    r, n, out = state.r, cfg.n, {}
    if fo.gr_bins:
        out["gr_samples"] = vmap_chains_bounded(
            lambda rb: radial_distribution(rb, cfg, nbins=fo.gr_bins)[1],
            r, n)
    if fo.z_bins:
        out["zprofile_samples"] = z_density_profile(r, cfg, fo.z_bins)[1]
    if fo.sk_kmax:
        out["sk_samples"] = structure_factor(r, cfg, n_kmax=fo.sk_kmax)[1]
    if fo.widom_k:
        from .widom import ghost_positions, widom_delta_u

        ghosts = ghost_positions(state.key, state.sweeps // gather_lapse,
                                 cfg, fo.widom_k)
        out["widom_samples"] = widom_delta_u(r, w, cfg, ghosts)
    if fo.ptensor_bins:
        pn, pt = vmap_chains_bounded(
            lambda rb: pressure_tensor_profile(
                rb, cfg, nbins=fo.ptensor_bins, include_ideal=False)[1:],
            r, n)
        out["ptensor_n_samples"], out["ptensor_t_samples"] = pn, pt
        out["ptensor_rho_samples"] = z_density_profile(
            r, cfg, fo.ptensor_bins)[1]
    return {k: v.cpu().numpy() for k, v in out.items()}


def stack_fields(samples: list, n_t: int, chains_per_t: int,
                 shard: LadderShard | None = None) -> dict:
    """The boundaries' `_fields` dicts stacked into TSweepResults fields
    [B, n_t, chains_per_t, bins] (a shard's gathered from every rank
    first)."""
    if not samples:
        return {}
    return {k: gather_chain_axis(np.stack([s[k] for s in samples]), 1,
                                 shard).reshape(
        (-1, n_t, chains_per_t) + samples[0][k].shape[1:])
        for k in samples[0]}


def ladder_stats(e_t: np.ndarray, moves: np.ndarray, sweeps: int,
                 temps: np.ndarray, cfg: SMCConfig):
    """(mean E incl. 3NT/2, replica error bar, acceptance, cv) per level
    from energy samples [G, n_t, R] and accepted moves [C]."""
    n_t, r = e_t.shape[1], e_t.shape[2]
    chain_means = e_t.mean(axis=0)                 # [T, chains]
    mean_e = chain_means.mean(axis=1) + 1.5 * cfg.n * temps
    err_e = chain_means.std(axis=1) / max(1, r - 1) ** 0.5
    acc = moves.reshape(n_t, r).mean(axis=1) / (sweeps * cfg.n)
    cv = e_t.var(axis=(0, 2)) / temps ** 2
    return mean_e, err_e, np.asarray(acc), np.asarray(cv)


def ladder_start(cfg: SMCConfig, key: torch.Tensor, c: int, r0, w, device,
                 state0: ChainState | None,
                 shard: LadderShard | None = None):
    """(state, wall tensor, chain 0 key) of a ladder of c chains: a fresh
    ensemble (a shard's chains of it), or the resumed state0 after
    checking its chain count. The chain 0 key is the GLOBAL chain 0's,
    from which the engines' streams and the exchanges derive."""
    if shard is not None:
        if state0 is not None or np.ndim(w) == 3:
            raise ValueError("a global-ladder shard starts fresh, with one "
                             "shared wall table")
        state, w_t = init_ensemble_state(cfg, key, shard.count, r0=r0, w=w,
                                         device=device,
                                         chain_offset=shard.chain0)
        return state, w_t, fold_in(torch.as_tensor(key), [0])[0]
    if state0 is None:
        state, w_t = init_ensemble_state(cfg, key, c, r0=r0, w=w,
                                         device=device)
        return state, w_t, state.key[0].cpu()
    if state0.n_chains != c:
        raise ValueError(f"resumed ladder state has {state0.n_chains} "
                         f"chains; this ladder needs {c}")
    if w is None:
        w = build_walls(cfg)[0]
    return state0, torch.as_tensor(np.asarray(w), dtype=cfg.torch_dtype,
                                   device=state0.r.device), \
        state0.key[0].cpu()


def simulate_temperature_sweep(
    cfg: SMCConfig,
    params: RunParams,
    temps,
    key: torch.Tensor,
    chains_per_t: int = 16,
    r0: np.ndarray | None = None,
    w: np.ndarray | None = None,
    sampler: str = "torch",
    a_per_t=None,
    device="cuda",
    state0: ChainState | None = None,
    fields: FieldOptions = FieldOptions(),
    shard: LadderShard | None = None,
    devices=None,
) -> tuple[ChainState, TSweepResults]:
    """The full ladder: thermalization (A doubled) + production, energies
    sampled at the gather cadence and (pressure, energy) pairs, with the
    paired field samples `fields` asks for, at each engine-call boundary,
    pooled per temperature.

    w: the shared wall table, or per-chain tables [C, M*M, 2] (quenched
    disorder; the realization lives in the replica index). a_per_t [n_t]:
    per-level mobility overriding gamma*T (tuning.tune_mobility_ladder),
    held fixed through the run. state0: resume from a ladder state
    (io.load_checkpoint of an earlier ladder's final state, the same
    temperature-major layout; usually with eqsteps 0). shard: this
    process's chains of one ladder spanning the processes; the returned
    state is the shard's, the results the whole ladder's (collective:
    every rank calls it with its shard). devices: this process's chains
    split over these devices (ensemble.make_mesh; tpu_smc's `mesh`), one
    contiguous range each, every engine keyed by the global chain index:
    bitwise the one-device run. The returned state is on `device`."""
    from .driver import _sync, therm_chunk

    temps = np.asarray(temps, dtype=np.float64)
    n_t = len(temps)
    c = n_t * chains_per_t
    state, w_t, key0 = ladder_start(cfg, key, c, r0, w, device, state0,
                                    shard)
    mine = slice(0, c) if shard is None else slice(
        shard.chain0, shard.chain0 + shard.count)
    f64 = dict(dtype=torch.float64, device=device)
    temps_c = torch.as_tensor(np.repeat(temps, chains_per_t)[mine], **f64)
    a_c = (None if a_per_t is None else torch.as_tensor(
        np.repeat(np.asarray(a_per_t, np.float64), chains_per_t)[mine],
        **f64))
    home = state.r.device
    parts = split_ladder(state, w_t, temps_c, a_c, mine.start, devices)

    chunk = therm_chunk(cfg, sampler=sampler)
    done = 0
    while done < params.eqsteps:
        k = min(params.eqsteps - done, chunk)
        parts, _ = ladder_blocks(parts, cfg, 2.0, k, sampler, seed=key0)
        for p in parts:
            _sync(p.state)
        done += k
    _, parts = parts_moves(parts)

    # Production: energies subsampled at the gather cadence, acceptance
    # from the cumulative counters (harvested every call).
    lapse = max(1, params.gather_lapse)
    chunk_g = max(lapse, (chunk // lapse) * lapse)
    e_samples, p_samples, e_at_p, f_samples = [], [], [], []
    prod_moves = np.zeros((state.n_chains,), np.int64)
    done = 0
    t0 = time.perf_counter()
    while done < params.maxsteps:
        k = min(params.maxsteps - done, chunk_g)
        parts, stats = ladder_blocks(parts, cfg, 1.0, k, sampler,
                                     collect_trace=True, seed=key0)
        e_samples.append(host_cat([s.energy[lapse - 1::lapse]
                                   for s in stats], 1))
        # the observables of the whole ladder on its device: a chain's
        # sums then do not depend on the chains of its shard
        whole = join_ladder(parts, home)
        p_samples.append(_pressure(cfg, whole.r, w_t))
        e_at_p.append(whole.energy.cpu().numpy())
        if fields.any():
            f_samples.append(_fields(cfg, whole, w_t, fields, lapse))
        moves, parts = parts_moves(parts)
        prod_moves += moves
        done += k
    prod_sps = done * c / max(time.perf_counter() - t0, 1e-9)

    e_tr = gather_chain_axis(np.concatenate(e_samples), 1, shard)
    prod_moves = gather_chain_axis(prod_moves, 0, shard)
    e_t = e_tr.reshape(len(e_tr), n_t, chains_per_t)
    mean_e, err_e, acc, cv = ladder_stats(e_t, prod_moves, done, temps, cfg)
    shape_t = (-1, n_t, chains_per_t)
    return join_ladder(parts, home), TSweepResults(
        temps=temps, mean_energy=mean_e, err_energy=err_e, acceptance=acc,
        cv=cv, energy_samples=e_t,
        pressure_samples=gather_chain_axis(np.stack(p_samples), 1,
                                           shard).reshape(shape_t),
        energy_at_pressure=gather_chain_axis(np.stack(e_at_p), 1,
                                             shard).reshape(shape_t),
        sweeps_per_second=prod_sps,
        **stack_fields(f_samples, n_t, chains_per_t, shard))


def pool_tsweep_across_processes(res: TSweepResults,
                                 cfg: SMCConfig) -> TSweepResults:
    """Pool per-process ladder results (tpu_smc/tsweep.py:430-476):
    every process ran complete replica ladders of its own, so the
    replica axis is concatenated in rank order and the per-T statistics
    recomputed from the full sample set (reweighting then sees P times
    the samples); acceptance is the mean of the ranks' and the rate
    their sum. Collective; every rank gets the pooled result."""
    from .distributed import allgather_chain_axis

    def cat_replicas(a):
        if a is None or a.size == 0:
            return a
        moved = np.moveaxis(np.asarray(a), 2, 0)     # [R_local, G, n_t, ..]
        return np.moveaxis(allgather_chain_axis(moved), 0, 2)

    e_t = cat_replicas(res.energy_samples)           # [G, n_t, R_total]
    kinetic = 1.5 * cfg.n * res.temps
    chain_means = e_t.mean(axis=0)                   # [n_t, R_total]
    r_tot = chain_means.shape[1]
    acc = allgather_chain_axis(np.asarray(res.acceptance)[None]).mean(axis=0)
    return res._replace(
        mean_energy=chain_means.mean(axis=1) + kinetic,
        err_energy=chain_means.std(axis=1) / max(1, r_tot - 1) ** 0.5,
        acceptance=acc, cv=e_t.var(axis=(0, 2)) / res.temps ** 2,
        energy_samples=e_t,
        **{name: cat_replicas(getattr(res, name)) for name in
           ("pressure_samples", "energy_at_pressure") + FIELD_NAMES},
        sweeps_per_second=(float(allgather_chain_axis(np.asarray(
            [[res.sweeps_per_second]])).sum())
            if res.sweeps_per_second is not None else None))


def write_tsweep_csv(d, cfg: SMCConfig, res: TSweepResults):
    from .io import _fname

    p = _fname(d, "tsweep", cfg)
    with open(p, "w") as f:
        f.write("T, E_mean, E_err, acceptance, cv\n")
        for i in range(len(res.temps)):
            f.write(f"{res.temps[i]:0.4f}, {res.mean_energy[i]:0.9f}, "
                    f"{res.err_energy[i]:0.9f}, {res.acceptance[i]:0.6f}, "
                    f"{res.cv[i]:0.9f}\n")
    return p
