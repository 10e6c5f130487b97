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
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .config import RunParams, SMCConfig
from .state import ChainState, init_ensemble_state
from .system import build_walls


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
                  sampler: str, collect_trace: bool = False, a_c=None):
    """n_sweeps sweeps of the ladder on one engine with per-chain rows
    A = a_scale * (a_c or gamma*T) and T = temps_c [C]. Returns
    (state, SweepStats or None)."""
    from . import ensemble as ens

    base = cfg.gamma * temps_c if a_c is None else a_c
    rows = dict(a_per_chain=a_scale * base, t_per_chain=temps_c)
    if sampler == "zsorted":
        state, stats = ens.ensemble_sweeps_zsorted(state, w, cfg, 0.0,
                                                   n_sweeps, **rows)
    elif sampler == "dense":
        state, stats = ens.ensemble_sweeps_dense(state, w, cfg, 0.0,
                                                 n_sweeps, **rows)
    elif sampler == "torch":
        state, stats = ens.ensemble_sweeps(state, w, cfg, 0.0, n_sweeps,
                                           collect_trace=collect_trace,
                                           **rows)
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    return state, (stats if collect_trace else None)


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


def stack_fields(samples: list, n_t: int, chains_per_t: int) -> dict:
    """The boundaries' `_fields` dicts stacked into TSweepResults fields
    [B, n_t, chains_per_t, bins]."""
    if not samples:
        return {}
    return {k: np.stack([s[k] for s in samples]).reshape(
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
                 state0: ChainState | None):
    """(state, wall tensor) of a ladder of c chains: a fresh ensemble, or
    the resumed state0 after checking its chain count."""
    if state0 is None:
        return init_ensemble_state(cfg, key, c, r0=r0, w=w, device=device)
    if state0.n_chains != c:
        raise ValueError(f"resumed ladder state has {state0.n_chains} "
                         f"chains; this ladder needs {c}")
    if w is None:
        w = build_walls(cfg)[0]
    return state0, torch.as_tensor(np.asarray(w), dtype=cfg.torch_dtype,
                                   device=state0.r.device)


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
    temperature-major layout; usually with eqsteps 0)."""
    from .driver import _sync, therm_chunk

    temps = np.asarray(temps, dtype=np.float64)
    n_t = len(temps)
    c = n_t * chains_per_t
    state, w_t = ladder_start(cfg, key, c, r0, w, device, state0)
    f64 = dict(dtype=torch.float64, device=device)
    temps_c = torch.as_tensor(np.repeat(temps, chains_per_t), **f64)
    a_c = (None if a_per_t is None else torch.as_tensor(
        np.repeat(np.asarray(a_per_t, np.float64), chains_per_t), **f64))

    chunk = therm_chunk(cfg, sampler=sampler)
    done = 0
    while done < params.eqsteps:
        k = min(params.eqsteps - done, chunk)
        state = _sync(_ladder_block(state, w_t, cfg, temps_c, 2.0, k,
                                    sampler, a_c=a_c)[0])
        done += k
    state = state.replace(accepted=torch.zeros_like(state.accepted))

    # Production: energies subsampled at the gather cadence, acceptance
    # from the cumulative counters (harvested every call).
    lapse = max(1, params.gather_lapse)
    chunk_g = max(lapse, (chunk // lapse) * lapse)
    e_samples, p_samples, e_at_p, f_samples = [], [], [], []
    prod_moves = np.zeros((c,), np.int64)
    done = 0
    t0 = time.perf_counter()
    while done < params.maxsteps:
        k = min(params.maxsteps - done, chunk_g)
        state, stats = _ladder_block(state, w_t, cfg, temps_c, 1.0, k,
                                     sampler, collect_trace=True, a_c=a_c)
        e_samples.append(stats.energy[lapse - 1::lapse].cpu().numpy())
        p_samples.append(_pressure(cfg, state.r, w_t))
        e_at_p.append(state.energy.cpu().numpy())
        if fields.any():
            f_samples.append(_fields(cfg, state, w_t, fields, lapse))
        prod_moves += state.accepted.cpu().numpy().astype(np.int64)
        state = state.replace(accepted=torch.zeros_like(state.accepted))
        done += k
    prod_sps = done * c / max(time.perf_counter() - t0, 1e-9)

    e_tr = np.concatenate(e_samples)               # [gathers, C]
    e_t = e_tr.reshape(len(e_tr), n_t, chains_per_t)
    mean_e, err_e, acc, cv = ladder_stats(e_t, prod_moves, done, temps, cfg)
    shape_t = (-1, n_t, chains_per_t)
    return state, TSweepResults(
        temps=temps, mean_energy=mean_e, err_energy=err_e, acceptance=acc,
        cv=cv, energy_samples=e_t,
        pressure_samples=np.stack(p_samples).reshape(shape_t),
        energy_at_pressure=np.stack(e_at_p).reshape(shape_t),
        sweeps_per_second=prod_sps,
        **stack_fields(f_samples, n_t, chains_per_t))


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
