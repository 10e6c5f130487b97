"""Chain state (PyTorch counterpart of tpu_smc.state).

One dataclass of tensors holds everything a chain carries: positions, the
running energy, its seed words, the sweep and acceptance counters, and the
voxel density/mobility accumulators (SMC.c:44-60). An ensemble carries a
leading chain axis [C] on every field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SMCConfig
from .system import build_walls, fcc_lattice


@dataclasses.dataclass
class ChainState:
    r: torch.Tensor         # [C, N, 3] positions
    energy: torch.Tensor    # [C] running potential energy (pair + wall)
    key: torch.Tensor       # [C, 2] int64 seed words (uint32 values)
    sweeps: torch.Tensor    # [C] int64 sweeps completed (therm included)
    accepted: torch.Tensor  # [C] int64 accepted moves
    rbin: torch.Tensor      # [C, N] int64 current voxel of each particle
    density: torch.Tensor   # [C, Nc] int64 cumulative voxel counts
    mobility: torch.Tensor  # [C, Nc] int64 cumulative cell-change counts

    def replace(self, **kw) -> "ChainState":
        return dataclasses.replace(self, **kw)

    @property
    def n_chains(self) -> int:
        return self.r.shape[0]


def seed_words(seed: int) -> torch.Tensor:
    """A run seed as the two 32-bit words of a chain key."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                        dtype=torch.int64)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Child seed words of `key` [2] for each integer in `data` [K]:
    Philox4x32-10 of the counter (data, 0xF01D, 0, 0) under `key`."""
    from .kernels.sweep import philox4x32

    data = torch.as_tensor(data, dtype=torch.int64)
    z = torch.zeros_like(data)
    k0 = torch.full_like(data, int(key[0]))
    k1 = torch.full_like(data, int(key[1]))
    b = philox4x32(data, torch.full_like(data, 0xF01D), z, z, k0, k1)
    return torch.stack([b[0], b[1]], dim=-1)


def init_chain_state(cfg: SMCConfig, key: torch.Tensor,
                     r0: np.ndarray | None = None,
                     w: np.ndarray | None = None,
                     device="cuda") -> tuple[ChainState, torch.Tensor]:
    """(state, wall table) for ONE chain, carried with a chain axis of 1.

    r0 defaults to the reference's FCC lattice, w to its bit-exact wall
    table; the initial energy is computed from scratch (SMC.c:48)."""
    from .potentials import total_energy

    dtype = cfg.torch_dtype
    if r0 is None:
        r0 = fcc_lattice(cfg)
    if w is None:
        w, _, _ = build_walls(cfg)
    r = torch.as_tensor(np.asarray(r0), dtype=dtype, device=device)[None]
    w = torch.as_tensor(np.asarray(w), dtype=dtype, device=device)
    nvox = cfg.n_voxels
    i64 = dict(dtype=torch.int64, device=device)
    state = ChainState(
        r=r,
        energy=total_energy(r, w, cfg),
        key=torch.as_tensor(key, **i64).reshape(1, 2),
        sweeps=torch.zeros((1,), **i64),
        accepted=torch.zeros((1,), **i64),
        # Rbin starts calloc'd to 0 in the reference (SMC.c:52)
        rbin=torch.zeros((1, cfg.n), **i64),
        density=torch.zeros((1, nvox), **i64),
        mobility=torch.zeros((1, nvox), **i64),
    )
    return state, w


def batch_chain_state(state: ChainState, n_chains: int,
                      chain_offset: int = 0) -> ChainState:
    """Broadcast a one-chain state to `n_chains` chains, each with its
    own seed words folded from the seed chain's key by global chain index
    (chain_offset + i), like tpu_smc.state.batch_chain_state."""
    keys = fold_in(state.key[0].cpu(),
                   torch.arange(chain_offset, chain_offset + n_chains))

    def rep(x):
        return x.expand((n_chains,) + x.shape[1:]).clone()

    return ChainState(
        r=rep(state.r), energy=rep(state.energy),
        key=keys.to(state.r.device),
        sweeps=rep(state.sweeps), accepted=rep(state.accepted),
        rbin=rep(state.rbin), density=rep(state.density),
        mobility=rep(state.mobility))


def per_chain_wall_energy(r: torch.Tensor, w: torch.Tensor,
                          cfg: SMCConfig) -> torch.Tensor:
    """Total energy [C] of every chain of r [C, N, 3] under its own wall
    table w [C, M*M, 2] (quenched disorder: chains of different
    realizations start at different wall energies), in bounded chain
    batches."""
    from .observables import wall_obs_chains
    from .potentials import total_energy

    return wall_obs_chains(lambda rb, wb: total_energy(rb, wb, cfg), r, w,
                           cfg.n)


def init_ensemble_state(cfg: SMCConfig, key: torch.Tensor, n_chains: int,
                        r0: np.ndarray | None = None,
                        w: np.ndarray | None = None,
                        device="cuda",
                        chain_offset: int = 0) -> tuple[ChainState,
                                                        torch.Tensor]:
    """`n_chains` chains from one common start configuration (every MPI
    rank of the reference starts from the common R0, SMC.c:43-45), keyed
    as chains chain_offset .. chain_offset + n_chains - 1 of the seed.

    w: the shared [M*M, 2] wall table (default: the reference's), or
    per-chain tables [C, M*M, 2]; with per-chain tables each chain's
    initial energy is computed under its own wall, and the returned wall
    tensor is the [C, M*M, 2] table."""
    if w is not None and np.ndim(w) == 3:
        if np.shape(w)[0] != n_chains:
            raise ValueError(f"per-chain wall tables ({np.shape(w)[0]}) != "
                             f"chains ({n_chains})")
        state, _ = init_chain_state(cfg, key, r0=r0, w=np.asarray(w)[0],
                                    device=device)
        state = batch_chain_state(state, n_chains, chain_offset)
        w_t = torch.as_tensor(np.asarray(w), dtype=cfg.torch_dtype,
                              device=device)
        return state.replace(energy=per_chain_wall_energy(state.r, w_t, cfg)
                             .to(state.energy.dtype)), w_t
    state, w_t = init_chain_state(cfg, key, r0=r0, w=w, device=device)
    return batch_chain_state(state, n_chains, chain_offset), w_t


def broadcast_resumed_chain(state: ChainState, n_chains: int) -> ChainState:
    """Broadcast a RESUMED one-chain state to `n_chains` chains, like
    batch_chain_state, but with the cumulative voxel counters kept in
    chain 0 only: plain replication would count the pre-resume history
    n_chains times in the pooled density/mobility CSVs (as
    tpu_smc.state.broadcast_resumed_chain)."""
    batched = batch_chain_state(state, n_chains)
    density, mobility = batched.density.clone(), batched.mobility.clone()
    density[1:] = 0
    mobility[1:] = 0
    return batched.replace(density=density, mobility=mobility)


def state_from_arrays(arrays: dict, cfg: SMCConfig,
                      device="cuda") -> ChainState:
    """A ChainState on `device` from numpy leaves with a chain axis (r
    [C, N, 3], energy, sweeps and accepted [C], rbin [C, N], density and
    mobility [C, Nc], key [C, 2] of uint32 values), in any integer dtype:
    positions and energy in cfg's float dtype, the rest int64."""
    dtype = cfg.torch_dtype
    i64 = dict(dtype=torch.int64, device=device)

    def f(name, **kw):
        return torch.as_tensor(np.asarray(arrays[name]).astype(
            np.float64 if kw["dtype"].is_floating_point else np.int64),
            **kw)

    return ChainState(
        r=f("r", dtype=dtype, device=device),
        energy=f("energy", dtype=dtype, device=device),
        key=f("key", **i64).reshape(-1, 2),
        sweeps=f("sweeps", **i64),
        accepted=f("accepted", **i64),
        rbin=f("rbin", **i64),
        density=f("density", **i64),
        mobility=f("mobility", **i64),
    )


def from_jax_state(arrays: dict, w, cfg: SMCConfig,
                   device="cuda") -> tuple[ChainState, torch.Tensor]:
    """Carry a tpu_smc ensemble state across: `arrays` holds its leaves as
    numpy (r, energy, sweeps, accepted, rbin, density, mobility, and
    `key` = jax.random.key_data of the chain keys, [C, 2] uint32), `w`
    the [M*M, 2] wall table, onto `device` (the card by default, as
    every entry point; pass "cpu" for the CPU). Returns (ChainState,
    wall table tensor)."""
    return (state_from_arrays(arrays, cfg, device),
            torch.as_tensor(np.array(w), dtype=cfg.torch_dtype,
                            device=device))


def gcmc_state_from_jax(arrays: dict, cfg: SMCConfig, device="cuda"):
    """Carry a tpu_smc GCMC ensemble state across: `arrays` holds its
    leaves as numpy with the chain axis (r [C, cap, 3], active, energy,
    the counters, boltz_sum/boltz_cnt, and `key` =
    jax.random.key_data of the chain keys [C, 2]); returns the port's
    gcmc.GCMCState on `device` (the card by default)."""
    from .gcmc import GCMCState, state_from_npz

    return state_from_npz(GCMCState, arrays, cfg, device)


def npt_state_from_jax(arrays: dict, cfg: SMCConfig, device="cuda"):
    """Carry a tpu_smc NPT ensemble state across (r, l, energy, key,
    sweeps, accepted, vol_acc, vol_att; its `vkey` is not read: the
    port's volume stream is keyed by the run, gcmc's docstring);
    returns npt.NPTState on `device`."""
    from .npt import NPTState
    from .gcmc import state_from_npz

    return state_from_npz(NPTState, arrays, cfg, device)


def gibbs_state_from_jax(arrays: dict, cfg: SMCConfig, device="cuda"):
    """Carry a tpu_smc Gibbs ensemble state across (r [C, 2, cap, 3],
    active, l, energy, key, the counters and the per-box Widom sums; its
    `vkey` and `tkey` are not read); returns gibbs.GibbsState on
    `device`."""
    from .gibbs import GibbsState
    from .gcmc import state_from_npz

    return state_from_npz(GibbsState, arrays, cfg, device)
