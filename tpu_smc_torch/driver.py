"""The single-chain run and the driver pieces it shares with the ensemble
run (counterpart of tpu_smc.driver without its TPU call chunking).

A run is a sequence of storage windows (STORAGE_TIME, SMC.c:158-182); a
window is a sequence of gathers; a gather is `gather_lapse` sweeps on the
chosen engine followed by the observable pass. The host reads each
gather's outputs; the sweeps themselves never return to the host.

One chain is an ensemble of one: `simulate` runs the loop of
driver_ensemble.simulate_ensemble and returns its chain 0. Windows are
transactional: a device fault that a live CUDA context survives
(`is_device_fault`) discards the window's partial gathers, restores the
window-start host snapshot and replays it, bitwise, since every draw is
keyed to the absolute sweep.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import RunParams, SMCConfig
from .state import ChainState


def therm_chunk(cfg: SMCConfig, sampler: str = "torch") -> int:
    """Thermalization sweeps per engine call, fixed by (N, engine) alone
    so that seeded runs never depend on host speed; the same rule as
    tpu_smc.driver.therm_chunk."""
    budget = 5e8 if sampler in ("dense", "zsorted") else 1e8
    return max(50, min(2000, int(budget / (cfg.n * cfg.n))))


# cudaError codes after which the CUDA context is unusable (CUDA's
# driver_types.h: IllegalAddress, LaunchTimeout, HardwareStackError,
# IllegalInstruction, MisalignedAddress, InvalidAddressSpace, InvalidPc,
# LaunchFailure)
STICKY_CUDA_ERRORS = frozenset({700, 702, 714, 715, 716, 717, 718, 719})


def is_device_fault(exc: BaseException) -> bool:
    """Whether a window may be replayed after `exc`: a fault that leaves
    the CUDA context usable. That is a launch error reported by a kernel
    wrapper (kernels.sweep.KernelLaunchError: bad configuration, no
    resources, allocation), or torch.cuda.OutOfMemoryError, after which
    the caching allocator has released what it could.

    Everything else re-raises at once: programming errors, and sticky
    errors (an illegal address or instruction, a failed or timed-out
    launch, found here by their cudaError codes or seen by torch at a
    later synchronisation as a plain RuntimeError), after which every
    CUDA call of the process fails and no in-process restore can
    succeed."""
    from .kernels.sweep import KernelLaunchError

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return isinstance(exc, KernelLaunchError) \
        and exc.code not in STICKY_CUDA_ERRORS


def snapshot_to_host(state: ChainState) -> ChainState:
    """A host copy of every leaf of `state`: the window-start snapshot a
    faulted window replays from (device memory may hold a half-written
    window by then)."""
    return ChainState(**{f.name: getattr(state, f.name).detach().to(
        "cpu", copy=True) for f in dataclasses.fields(ChainState)})


def restore_from_host(snap: ChainState, device) -> ChainState:
    """The snapshot's leaves copied back onto `device`."""
    return ChainState(**{f.name: getattr(snap, f.name).to(device, copy=True)
                         for f in dataclasses.fields(ChainState)})


def _sync(state: ChainState) -> ChainState:
    """Wait for the device work that produced `state`."""
    if state.r.is_cuda:
        torch.cuda.synchronize(state.r.device)
    return state


class GatherOut(NamedTuple):
    """One gather's outputs (host numpy), chains on the last axis."""

    energy_trace: np.ndarray  # [gather_lapse, C] running E per sweep
    accept_trace: np.ndarray  # [gather_lapse, C] accepted moves per sweep
    pressure: np.ndarray      # [C] virial pressure after the block
    l1: np.ndarray            # [C] bonded pairs (0 off the LCA cadence)
    l2: np.ndarray            # [C, 7] num2 histogram
    l3: np.ndarray            # [C, 7] num3 histogram
    # the measurement layer's per-gather samples (None when disabled):
    gr: np.ndarray | None = None        # [C, gr_bins] g(r)
    zprof: np.ndarray | None = None     # [C, z_bins] rho(z)
    widom_du: np.ndarray | None = None  # [C, widom_k] ghost energies
    widom_z: np.ndarray | None = None   # [C, widom_k] ghost z
    pn: np.ndarray | None = None        # [C, ptensor_bins] P_N(z)
    pt: np.ndarray | None = None        # [C, ptensor_bins] P_T(z)


@dataclass(frozen=True)
class ObservableOptions:
    collect_sweep_trace: bool = True   # full-resolution E/jj traces
    # "torch" (plain engine), "dense" (whole-sweep kernel) or "zsorted"
    # (the kernel with exact z-block skipping)
    sampler: str = "torch"
    # run seed of the per-sweep streams; None derives them from chain 0's
    # key
    stream_seed: int | None = None
    # production mobility A (tuning.tune_mobility); None = gamma*T
    proposal_a: float | None = None
    gr_bins: int = 0          # g(r) bins per gather (0: off)
    z_bins: int = 0           # z-density profile bins (0: off)
    # Widom ghost insertions per chain per gather (0: off); the ghosts'
    # stream folds the absolute gather index (widom.py)
    widom_k: int = 0
    ptensor_bins: int = 0     # P_N(z)/P_T(z) bins (0: off)
    # global index of the state's chain 0: a process's share of a
    # multi-process run (every draw is keyed by the global chain index)
    chain0: int = 0
    # devices of a chain-sharded run (ensemble.make_mesh; every
    # engine); None: the state's own device
    devices: tuple | None = None


class SimResults(NamedTuple):
    """Per-chain results (the reference's struct Sim, SMC.h:76-88)."""

    mean_energy: float        # mean E incl. 3NT/2 (SMC.c:210-211, 244)
    std_energy: float
    mean_pressure: float      # incl. ideal rho*T (SMC.c:207-208)
    std_pressure: float
    acceptance_ratio: float   # SMC.c:248
    cv: float                 # var(E)/T^2 (SMC.c:250)
    cv_strided: float         # tau-strided variance / T^2 (SMC.c:1128-1142)
    tau: float                # sum of the ACF (SMC.c:235)
    acf: np.ndarray
    r_final: np.ndarray
    l1: float                 # mean bonded pairs per LCA pass
    l2: np.ndarray            # [7] normalized num2 histogram
    l3: np.ndarray            # [7] normalized num3 histogram
    energy_trace: np.ndarray  # per-sweep E (+3NT/2), empty if not collected
    energy_trace_full: np.ndarray  # initial E prepended (SMC.c:47)
    accept_trace: np.ndarray
    pressure_trace: np.ndarray
    density: np.ndarray       # cumulative voxel density [ncx, ncx, ncz]
    mobility: np.ndarray
    gr: Optional[np.ndarray]
    zprofile: Optional[np.ndarray]
    therm_acceptance: float
    sweeps_per_second: float
    # Widom samples [gathers, 1, widom_k] and the pressure-tensor
    # profiles [ptensor_bins] (None unless sampled)
    widom_du: Optional[np.ndarray] = None
    widom_z: Optional[np.ndarray] = None
    pn: Optional[np.ndarray] = None
    pt: Optional[np.ndarray] = None


def simulate(cfg: SMCConfig, params: RunParams, state: ChainState,
             w: torch.Tensor, opts: ObservableOptions = ObservableOptions(),
             on_window=None, acf_mode: str = "reference",
             max_fault_retries: int = 2) -> tuple[ChainState, SimResults]:
    """The full single-chain run, the reference's sMC (SMC.c:21-267):
    thermalization with A doubled, the windowed main loop and the
    post-processing, for a one-chain `state` (chain axis 1).

    on_window(window_index, state, outs) is the host I/O hook, called
    after each storage window; returning "stop" ends the run there.
    max_fault_retries: consecutive device faults tolerated per window,
    each replaying it from the window-start host snapshot (0: none).
    Returns (state, SimResults). A one-chain run is bitwise chain 0 of a
    simulate_ensemble run from the same seeded start (batch_chain_state),
    as the draws of a chain depend on its index only."""
    from . import driver_ensemble

    if state.n_chains != 1:
        raise ValueError(f"simulate runs one chain, got {state.n_chains}; "
                         "use driver_ensemble.simulate_ensemble")
    state, agg = driver_ensemble.simulate_ensemble(
        cfg, params, state, w, opts=opts, on_window=on_window,
        acf_mode=acf_mode, max_fault_retries=max_fault_retries)
    return state, agg.chains[0]._replace(
        gr=agg.gr, zprofile=agg.zprofile, widom_du=agg.widom_du,
        widom_z=agg.widom_z, pn=agg.pn, pt=agg.pt)
