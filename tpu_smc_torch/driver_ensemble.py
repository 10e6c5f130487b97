"""Ensemble driver: thermalization, the windowed gather loop with fault
replay and the per-chain / pooled post-processing (counterpart of
tpu_smc.driver_ensemble without its device mesh). The single-chain run
(driver.simulate) is this loop with one chain.

Outputs keep the reference's per-rank naming with rank = chain index
(SMC.c:66-96), plus the cross-chain aggregation it left to offline
scripts.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from .config import RunParams, SMCConfig
from .driver import (GatherOut, ObservableOptions, SimResults, _sync,
                     is_device_fault, restore_from_host, snapshot_to_host,
                     therm_chunk)
from .ensemble import (ensemble_sweeps, ensemble_sweeps_dense,
                       ensemble_sweeps_dense_sharded, ensemble_sweeps_sharded,
                       ensemble_sweeps_zsorted,
                       ensemble_sweeps_zsorted_sharded)
from .observables import (autocorrelation, cluster_histograms_chains,
                          density_mobility_update,
                          integrated_autocorrelation_time,
                          pressure_tensor_profile, radial_distribution,
                          vmap_chains_bounded, wall_obs_chains,
                          z_density_profile)
from .potentials import total_pressure
from .sampler import recompute_energy
from .state import ChainState


def _advance(state: ChainState, w, cfg: SMCConfig, a: float, n_sweeps: int,
             opts: ObservableOptions, collect_trace: bool):
    """n_sweeps of every chain on opts.sampler, keyed from the global
    chain opts.chain0, over opts.devices when given (the sharded
    engines). Returns (state, trace)."""
    c0 = opts.chain0
    if opts.devices and opts.sampler == "torch":
        return ensemble_sweeps_sharded(state, w, cfg, a, n_sweeps,
                                       opts.stream_seed, list(opts.devices),
                                       collect_trace=collect_trace,
                                       chain0=c0)
    if opts.devices and opts.sampler in ("dense", "zsorted"):
        fn = (ensemble_sweeps_zsorted_sharded if opts.sampler == "zsorted"
              else ensemble_sweeps_dense_sharded)
        return fn(state, w, cfg, a, n_sweeps, opts.stream_seed,
                  list(opts.devices), chain0=c0)
    if opts.sampler == "zsorted":
        return ensemble_sweeps_zsorted(state, w, cfg, a, n_sweeps,
                                       seed=opts.stream_seed, chain0=c0)
    if opts.sampler == "dense":
        return ensemble_sweeps_dense(state, w, cfg, a, n_sweeps,
                                     seed=opts.stream_seed, chain0=c0)
    if opts.sampler == "torch":
        return ensemble_sweeps(state, w, cfg, a, n_sweeps,
                               collect_trace=collect_trace,
                               stream_seed=opts.stream_seed, chain0=c0)
    raise ValueError(f"unknown sampler {opts.sampler!r}")


def _mobility(cfg: SMCConfig, opts: ObservableOptions) -> float:
    """Production mobility: the tuned A when given, else A = gamma*T."""
    return cfg.proposal_a if opts.proposal_a is None else opts.proposal_a


def structure_observables(state: ChainState, w, cfg: SMCConfig,
                          opts: ObservableOptions, gather_lapse: int) -> dict:
    """The measurement layer's per-gather samples of every chain, as host
    arrays keyed like GatherOut's fields: g(r), rho(z), Widom ghost
    energies and heights, P_N/P_T(z), each when its option is on. The
    all-pairs ones run in chain batches and row chunks within
    potentials.PAIR_BUDGET; the Widom stream folds the absolute gather
    state.sweeps // gather_lapse (widom.py). Reads the state, never
    changes it."""
    out = {}
    n = cfg.n
    if opts.gr_bins:
        out["gr"] = vmap_chains_bounded(
            lambda rb: radial_distribution(rb, cfg, nbins=opts.gr_bins)[1],
            state.r, n)
    if opts.z_bins:
        out["zprof"] = z_density_profile(state.r, cfg, nbins=opts.z_bins)[1]
    if opts.widom_k:
        from .widom import ghost_positions, widom_delta_u

        ghosts = ghost_positions(state.key, state.sweeps // gather_lapse,
                                 cfg, opts.widom_k)
        out["widom_du"] = widom_delta_u(state.r, w, cfg, ghosts)
        out["widom_z"] = ghosts[..., 2]
    if opts.ptensor_bins:
        out["pn"], out["pt"] = vmap_chains_bounded(
            lambda rb: pressure_tensor_profile(
                rb, cfg, nbins=opts.ptensor_bins)[1:], state.r, n)
    return {k: v.cpu().numpy() for k, v in out.items()}


def _gather_step_batched(state: ChainState, w, cfg: SMCConfig,
                         gather_lapse: int, gather_index: int,
                         opts: ObservableOptions):
    """One gather for every chain: gather_lapse sweeps, the exact-energy
    resync, pressure, voxel density/mobility and (at the LCA cadence) the
    cluster analysis, then the measurement layer's samples
    (structure_observables). Returns (state, GatherOut)."""
    with record_function("smc.sweeps"):
        state, trace = _advance(state, w, cfg, _mobility(cfg, opts),
                                gather_lapse, opts, opts.collect_sweep_trace)
    with record_function("smc.observables"):
        return _gather_observables(state, trace, w, cfg, gather_lapse,
                                   gather_index, opts)


def _gather_observables(state: ChainState, trace, w, cfg: SMCConfig,
                        gather_lapse: int, gather_index: int,
                        opts: ObservableOptions):
    """The gather's observables after its sweeps (_gather_step_batched)."""
    c = state.n_chains

    if cfg.recompute_every and \
            (int(state.sweeps[0]) // gather_lapse) % cfg.recompute_every == 0:
        # keyed to ABSOLUTE chain time (state.sweeps), not the run-relative
        # gather index, so a resumed run resyncs at the same chain times
        state = recompute_energy(state, w, cfg)

    p = wall_obs_chains(lambda r, wb: total_pressure(r, wb, cfg), state.r, w,
                        cfg.n)
    rbin, density, mobility = density_mobility_update(
        state.r, state.rbin, state.density, state.mobility, cfg)
    state = state.replace(rbin=rbin, density=density, mobility=mobility)

    if (gather_index + 1) % cfg.lca_time == 0:
        l1, l2, l3 = (t.cpu().numpy() for t in
                      cluster_histograms_chains(state.r, cfg))
    else:
        l1 = np.zeros((c,), np.int64)
        l2 = np.zeros((c, 7), np.int64)
        l3 = np.zeros((c, 7), np.int64)

    if opts.collect_sweep_trace:
        e_tr = trace.energy.clone()
        if cfg.recompute_every:
            # the gather-boundary entry reports the state's (resynced)
            # energy at this chain time, as the JAX driver does
            e_tr[-1] = state.energy
        e_tr = e_tr.cpu().numpy()
        a_tr = trace.accepted.cpu().numpy()
    else:
        e_tr = np.zeros((0, c))
        a_tr = np.zeros((0, c), np.int64)
    fields = structure_observables(state, w, cfg, opts, gather_lapse)
    return state, GatherOut(e_tr, a_tr, p.cpu().numpy(), l1, l2, l3,
                            **fields)


class EnsembleResults(NamedTuple):
    chains: list                    # per-chain SimResults
    mean_energy: float              # ensemble mean of chain means
    std_energy: float               # std of chain means (replica error bar)
    mean_pressure: float
    std_pressure: float
    acceptance_ratio: float
    therm_acceptance: float
    sweeps_per_second: float        # aggregate across chains
    # the measurement layer (None unless sampled): ensemble-pooled g(r)
    # and rho(z), their gather means per chain [C, bins] (per-
    # realization profiles of a disorder run), the Widom samples
    # [gathers, C, widom_k] and the pooled P_N/P_T(z)
    gr: np.ndarray | None = None
    zprofile: np.ndarray | None = None
    gr_chains: np.ndarray | None = None
    zprofile_chains: np.ndarray | None = None
    widom_du: np.ndarray | None = None
    widom_z: np.ndarray | None = None
    pn: np.ndarray | None = None
    pt: np.ndarray | None = None


def _thermalize(state: ChainState, w, cfg: SMCConfig, params: RunParams,
                opts: ObservableOptions):
    """Thermalization: eqsteps sweeps at twice the production mobility
    (SMC.c:110-125) in therm_chunk calls, then the exact-energy resync.
    Returns (state, thermalization acceptance)."""
    chunk = therm_chunk(cfg, sampler=opts.sampler)
    done_eq, therm_moves = 0, 0.0
    state = state.replace(accepted=torch.zeros_like(state.accepted))
    while done_eq < params.eqsteps:
        k = min(chunk, params.eqsteps - done_eq)
        state = _sync(_advance(state, w, cfg, 2.0 * _mobility(cfg, opts),
                               k, opts, False)[0])
        therm_moves += float(state.accepted.double().mean())
        state = state.replace(accepted=torch.zeros_like(state.accepted))
        done_eq += k
    return (recompute_energy(state, w, cfg),
            therm_moves / (params.eqsteps * cfg.n))


def simulate_ensemble(cfg: SMCConfig, params: RunParams, state: ChainState,
                      w: torch.Tensor,
                      opts: ObservableOptions = ObservableOptions(),
                      on_window=None, acf_mode: str = "reference",
                      max_fault_retries: int = 2):
    """Ensemble run: thermalization + windowed main loop + per-chain and
    pooled post-processing. `state` carries the chain axis. on_window(
    widx, state, outs) runs after each storage window; returning "stop"
    ends the run there. `w` is the shared wall table or per-chain tables
    [C, M*M, 2] (quenched disorder). acf_mode: autocorrelation's mode
    ("reference", "circular" or "unbiased").

    Each window is a transaction: on a fault that `driver.is_device_fault`
    deems retryable, its partial gathers are dropped, the state restored
    from the window-start host snapshot and the window replayed, at most
    max_fault_retries times in a row (0: no snapshots, every error
    re-raises). Returns (state, EnsembleResults)."""
    lapse = params.gather_lapse
    gather_steps = params.gather_steps
    n_chains = state.n_chains

    therm_acc = 0.0
    if params.eqsteps:
        with record_function("smc.thermalization"):
            state, therm_acc = _thermalize(state, w, cfg, params, opts)

    e_begin = state.energy.cpu().numpy()
    prod_moves = np.zeros((n_chains,), np.int64)
    state = state.replace(accepted=torch.zeros_like(state.accepted))
    outs: list[GatherOut] = []
    done = widx = faults = 0
    with record_function("smc.snapshot"):
        snap = snapshot_to_host(state) if max_fault_retries else None
    t1 = time.perf_counter()
    while done < gather_steps:
        g = min(cfg.storage_time, gather_steps - done)
        try:
            window, moves_w = [], np.zeros_like(prod_moves)
            for k in range(g):
                state, out = _gather_step_batched(state, w, cfg, lapse,
                                                  done + k, opts)
                moves_w += state.accepted.cpu().numpy()
                state = state.replace(
                    accepted=torch.zeros_like(state.accepted))
                window.append(out)
        except Exception as exc:  # noqa: BLE001 - classified, else re-raised
            if snap is None or faults >= max_fault_retries \
                    or not is_device_fault(exc):
                raise
            faults += 1
            print(f"\n[elastic] device fault in window {widx} "
                  f"(retry {faults}/{max_fault_retries}): "
                  f"{str(exc).splitlines()[0][:120]}", flush=True)
            state = restore_from_host(snap, state.r.device)
            continue
        faults = 0
        prod_moves += moves_w
        outs += window
        done += g
        with record_function("smc.on_window"):
            verdict = on_window(widx, state, window) if on_window else None
        widx += 1
        if snap is not None:
            with record_function("smc.snapshot"):
                snap = snapshot_to_host(state)
        if verdict == "stop":
            gather_steps = done
            break
    with record_function("smc.post"):
        return _post_process(cfg, params, opts, state, outs, e_begin,
                             prod_moves, therm_acc, gather_steps, t1,
                             acf_mode)


def _post_process(cfg: SMCConfig, params: RunParams, opts: ObservableOptions,
                  state: ChainState, outs: list, e_begin, prod_moves,
                  therm_acc: float, gather_steps: int, t1: float,
                  acf_mode: str):
    """simulate_ensemble's per-chain and pooled results of the gathers
    `outs` (the production window began at perf_counter t1)."""
    lapse = params.gather_lapse
    n_chains = state.n_chains
    kinetic = 1.5 * cfg.n * cfg.temperature
    elapsed = time.perf_counter() - t1
    total_sweeps = gather_steps * lapse
    sps = total_sweeps * n_chains / elapsed if elapsed > 0 else float("nan")

    p_traces = np.stack([o.pressure for o in outs]) + cfg.rho * cfg.temperature
    l1s = np.stack([o.l1 for o in outs])                      # [G, C]
    l2s = np.stack([o.l2 for o in outs])                      # [G, C, 7]
    l3s = np.stack([o.l3 for o in outs])
    n_lca = max(1, gather_steps // cfg.lca_time)
    if opts.collect_sweep_trace:
        e_traces = np.concatenate([o.energy_trace for o in outs]) + kinetic
        a_traces = np.concatenate([o.accept_trace for o in outs])
    else:
        e_traces = np.zeros((0, n_chains))
        a_traces = np.zeros((0, n_chains), np.int64)

    shape = (n_chains, cfg.ncx, cfg.ncx, cfg.ncz)
    density = state.density.cpu().numpy().reshape(shape)
    mobility = state.mobility.cpu().numpy().reshape(shape)
    r_final = state.r.cpu().numpy()
    e_final = state.energy.cpu().numpy()

    per_chain = []
    for ci in range(n_chains):
        if e_traces.size:
            e_full = np.concatenate([[e_begin[ci] + kinetic], e_traces[:, ci]])
            me, ve = float(np.mean(e_full)), float(np.var(e_full))
            acf = autocorrelation(e_full, cfg.kmax, mode=acf_mode)
            tau = integrated_autocorrelation_time(acf)
            if not np.isfinite(tau):
                tau = 0.0   # zero-variance trace: the ACF is 0/0
            sub = e_full[::max(1, int(np.floor(abs(tau))))]
            cv_strided = (float(np.sum((sub - me) ** 2) / max(1, len(sub) - 1))
                          / cfg.temperature ** 2)
            acc = float(np.mean(a_traces[:, ci])) / cfg.n
        else:
            e_full = np.zeros((0,))
            me, ve = float(e_final[ci]) + kinetic, float("nan")
            acf = np.zeros((0,))
            tau = cv_strided = float("nan")
            acc = float(prod_moves[ci] / (total_sweeps * cfg.n))
        per_chain.append(SimResults(
            mean_energy=me, std_energy=float(np.sqrt(ve)),
            mean_pressure=float(np.mean(p_traces[:, ci])),
            std_pressure=float(np.std(p_traces[:, ci])),
            acceptance_ratio=acc, cv=ve / cfg.temperature ** 2,
            cv_strided=cv_strided, tau=tau, acf=acf, r_final=r_final[ci],
            l1=float(np.sum(l1s[:, ci])) / n_lca,
            l2=l2s[:, ci].sum(axis=0) / n_lca,
            l3=l3s[:, ci].sum(axis=0) / n_lca,
            energy_trace=e_traces[:, ci] if e_traces.size else np.zeros((0,)),
            energy_trace_full=e_full,
            accept_trace=a_traces[:, ci] if a_traces.size else np.zeros((0,)),
            pressure_trace=p_traces[:, ci],
            density=density[ci], mobility=mobility[ci], gr=None,
            zprofile=None, therm_acceptance=therm_acc,
            sweeps_per_second=sps / n_chains))

    def stacked(name):
        vals = [getattr(o, name) for o in outs]
        if not vals or vals[0] is None:
            return None
        return np.stack(vals)                             # [G, C, ...]

    gr_all, zp_all = stacked("gr"), stacked("zprof")
    pn_all, pt_all = stacked("pn"), stacked("pt")
    chain_means = np.asarray([r.mean_energy for r in per_chain])
    chain_ps = np.asarray([r.mean_pressure for r in per_chain])
    return state, EnsembleResults(
        chains=per_chain,
        mean_energy=float(np.mean(chain_means)),
        std_energy=float(np.std(chain_means)),
        mean_pressure=float(np.mean(chain_ps)),
        std_pressure=float(np.std(chain_ps)),
        acceptance_ratio=float(np.mean([r.acceptance_ratio
                                        for r in per_chain])),
        therm_acceptance=therm_acc, sweeps_per_second=sps,
        gr=None if gr_all is None else gr_all.mean(axis=(0, 1)),
        zprofile=None if zp_all is None else zp_all.mean(axis=(0, 1)),
        gr_chains=None if gr_all is None else gr_all.mean(axis=0),
        zprofile_chains=None if zp_all is None else zp_all.mean(axis=0),
        widom_du=stacked("widom_du"), widom_z=stacked("widom_z"),
        pn=None if pn_all is None else pn_all.mean(axis=(0, 1)),
        pt=None if pt_all is None else pt_all.mean(axis=(0, 1)))


class PooledChain(NamedTuple):
    """What the pooled outputs read of one chain of another process:
    its mean energy and its traces (io.write_ensemble_data_csv)."""
    mean_energy: float
    energy_trace_full: np.ndarray
    accept_trace: np.ndarray
    pressure_trace: np.ndarray


def pool_ensemble_across_processes(agg: EnsembleResults) -> EnsembleResults:
    """The job's pooled results from every process's EnsembleResults of
    its own chains (tpu_smc/cli.py:1762-1828), on every rank: the chain
    summaries gathered in global chain order, so the means and spreads
    are the single-process run's to the bit; the traces (cut to the
    shortest rank's length, agreed first: a graceful stop can reach the
    ranks at different windows) as `chains`; the Widom samples at an
    agreed gather count; g(r), rho(z), P_N/P_T as the mean of the ranks'
    means (equal shares: the global mean to round-off) and the per-chain
    profiles gathered. Collective: every rank must call it."""
    from .distributed import allgather_chain_axis

    summ = np.asarray([[r.mean_energy, r.mean_pressure, r.acceptance_ratio,
                        r.sweeps_per_second] for r in agg.chains],
                      np.float64)
    g = allgather_chain_axis(summ)                        # [C, 4]
    col = [np.ascontiguousarray(g[:, k]) for k in range(4)]
    c0 = agg.chains[0]
    lens = allgather_chain_axis(np.asarray(
        [[len(c0.energy_trace_full), len(c0.accept_trace),
          len(c0.pressure_trace)]], np.int64)).min(axis=0)
    se, sa, sp = (int(v) for v in lens)
    traces = [allgather_chain_axis(np.stack([getattr(r, name)[:k]
                                             for r in agg.chains]))
              for name, k in (("energy_trace_full", se),
                              ("accept_trace", sa),
                              ("pressure_trace", sp))]
    chains = [PooledChain(float(col[0][i]), traces[0][i], traces[1][i],
                          traces[2][i]) for i in range(g.shape[0])]

    def rank_mean(x):
        return None if x is None else allgather_chain_axis(x[None]).mean(0)

    def per_chain(x):
        return None if x is None else allgather_chain_axis(x)

    wdu, wz = agg.widom_du, agg.widom_z
    if wdu is not None:
        sg = int(allgather_chain_axis(
            np.asarray([[len(wdu)]], np.int64)).min())
        wdu, wz = (np.moveaxis(allgather_chain_axis(
            np.moveaxis(v[:sg], 1, 0)), 0, 1) for v in (wdu, wz))
    return agg._replace(
        chains=chains, mean_energy=float(np.mean(col[0])),
        std_energy=float(np.std(col[0])),
        mean_pressure=float(np.mean(col[1])),
        std_pressure=float(np.std(col[1])),
        acceptance_ratio=float(np.mean(col[2])),
        sweeps_per_second=float(col[3].sum()),
        gr=rank_mean(agg.gr), zprofile=rank_mean(agg.zprofile),
        gr_chains=per_chain(agg.gr_chains),
        zprofile_chains=per_chain(agg.zprofile_chains),
        widom_du=wdu, widom_z=wz, pn=rank_mean(agg.pn),
        pt=rank_mean(agg.pt))
