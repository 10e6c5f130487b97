"""Widom test-particle insertion: the excess chemical potential mu_ex
(counterpart of tpu_smc.widom; no reference counterpart).

Ghost particles are inserted at uniform positions over the box and the
Boltzmann factor of their interaction energy is averaged,

    exp(-beta mu_ex) = < exp(-beta dU_ghost) >_{NVT, uniform s}

(Widom 1963); mu_ex(z) bins the insertions on the z-density profile's
grid, where T ln rho(z) + mu_ex(z) is constant at equilibrium.

`widom_delta_u` evaluates the ghost energies of every chain on the
chains' device in plain torch: the pair term against all N particles
(nothing excluded) plus the wall term, the sampler's own single-particle
arithmetic, over [chains, ghosts, N] blocks within potentials.PAIR_BUDGET.

Ghosts come from their own Philox4x32-10 stream: per chain, the seed
words are Philox of the counter (gather, _WIDOM_FOLD, 0, 0) under the
chain's key, and ghost k takes the uniforms of the counter (k,
_GHOST_SALT, 0, 0) under those words. The chain's key is read, never
replaced, so enabling Widom leaves the trajectory bitwise unchanged.
`gather` is the ABSOLUTE gather index, state.sweeps // gather_lapse (the
ladders: the absolute sweep count of the sample), where tpu_smc folds
the run-relative one: a resumed run then draws the ghosts the
uninterrupted run would have drawn.

The estimators (mu_ex, mu_ex_profile, mu_ex_reweighted, second_virial)
are tpu_smc's numpy code.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .config import SMCConfig
from . import potentials

# Fold constant of the Widom stream (tpu_smc.widom._WIDOM_FOLD)
_WIDOM_FOLD = 0x57D0
# counter word of a ghost's uniforms
_GHOST_SALT = 0x6057


def ghost_positions(key: torch.Tensor, gather, cfg: SMCConfig,
                    k: int) -> torch.Tensor:
    """The k ghost positions [C, k, 3] of every chain for one gather:
    x, y uniform in [-L/2, L/2), z across [-Lz/2, Lz/2). key [C, 2] are
    the chains' seed words; gather an int or one per chain [C]."""
    from .kernels.sweep import philox4x32, unit_uniform

    dtype = cfg.torch_dtype
    dev = key.device
    c = key.shape[0]
    g = torch.as_tensor(gather, dtype=torch.int64, device=dev).expand(c)
    z = torch.zeros_like(g)
    w = philox4x32(g, z + _WIDOM_FOLD, z, z, key[:, 0], key[:, 1])
    idx = torch.arange(k, dtype=torch.int64, device=dev)[None, :].expand(c, k)
    zk = torch.zeros_like(idx)
    b = philox4x32(idx, zk + _GHOST_SALT, zk, zk, w[0][:, None],
                   w[1][:, None])
    u = torch.stack([unit_uniform(b[j], dtype) for j in range(3)], dim=-1)
    lo = torch.tensor([-cfg.box_l / 2, -cfg.box_l / 2, -cfg.box_lz / 2],
                      dtype=dtype, device=dev)
    span = torch.tensor([cfg.box_l, cfg.box_l, cfg.box_lz], dtype=dtype,
                        device=dev)
    return lo + span * u


def widom_delta_u(r: torch.Tensor, w: torch.Tensor, cfg: SMCConfig,
                  ghosts: torch.Tensor) -> torch.Tensor:
    """Interaction energies [C, K] of ghosts [C, K, 3] inserted into each
    chain of r [C, N, 3]: the pair term against every particle plus the
    wall term under w ([M*M, 2] shared or [C, M*M, 2] per chain). +inf
    where a ghost overlaps (the estimators weigh it 0). Ghosts go in
    blocks of PAIR_BUDGET // (C N)."""
    c, n = r.shape[0], r.shape[1]
    k = ghosts.shape[1]
    step = max(1, potentials.PAIR_BUDGET // max(c * n, 1))
    out = []
    for k0 in range(0, k, step):
        g = ghosts[:, k0:k0 + step]
        d, dr2 = potentials._pair_displacements(g, r.unsqueeze(1), cfg)
        u, _ = potentials._lj_terms(d, dr2, dr2 < cfg.cutoff2, cfg)
        if cfg.use_walls:
            u = u + potentials.wall_energy_force_single(g, w, cfg)[0]
        out.append(u)
    return torch.cat(out, dim=1)


def _boltz(du: np.ndarray, temperature: float) -> np.ndarray:
    """exp(-du/T) with non-finite du mapped to weight 0 (hard overlap)."""
    du = np.asarray(du, np.float64)
    out = np.zeros_like(du)
    ok = np.isfinite(du)
    with np.errstate(over="ignore", under="ignore"):
        out[ok] = np.exp(-du[ok] / float(temperature))
    return out


def mu_ex(du: np.ndarray, temperature: float, n_boot: int = 200,
          seed: int = 0) -> Tuple[float, float]:
    """Scalar mu_ex with a bootstrap error over the chain axis of du
    [samples..., chains, k] (a single chain bootstraps its gathers).
    Returns (mu_ex, err); (nan, nan) without data."""
    du = np.asarray(du)
    if du.size == 0:
        return float("nan"), float("nan")
    b = _boltz(du, temperature)
    if b.shape[-2] == 1 and b.ndim >= 3 and b.shape[0] > 1:
        b = np.moveaxis(b, 0, -2)
    per_chain = np.moveaxis(b, -2, 0).reshape(b.shape[-2], -1).mean(axis=1)
    mean = float(per_chain.mean())
    if mean <= 0.0:
        return float("inf"), float("nan")
    mu = -float(temperature) * np.log(mean)
    rng = np.random.default_rng(seed)
    c = per_chain.shape[0]
    boots = np.empty(n_boot)
    for i in range(n_boot):
        m = per_chain[rng.integers(0, c, c)].mean()
        boots[i] = -temperature * np.log(m) if m > 0 else np.nan
    return mu, float(np.nanstd(boots))


def mu_ex_profile(du: np.ndarray, z: np.ndarray, temperature: float,
                  cfg: SMCConfig, nbins: int = 64, n_boot: int = 200,
                  seed: int = 0):
    """mu_ex(z) on the z-density profile's uniform grid from paired du, z
    [..., chains, k]. Returns (centers, mu, err, counts), each [nbins];
    bins without insertions (or with zero mean weight) are nan."""
    du = np.asarray(du)
    z = np.asarray(z)
    lz = float(cfg.box_lz)
    dz = lz / nbins
    centers = -lz / 2 + dz * (np.arange(nbins) + 0.5)
    if du.size == 0:
        nanv = np.full(nbins, np.nan)
        return centers, nanv, nanv.copy(), np.zeros(nbins)

    b = _boltz(du, temperature)
    zb = np.clip(((z / lz + 0.5) * nbins).astype(np.int64), 0, nbins - 1)
    if b.shape[-2] == 1 and b.ndim >= 3 and b.shape[0] > 1:
        b = np.moveaxis(b, 0, -2)
        zb = np.moveaxis(zb, 0, -2)
    c = b.shape[-2]
    bc = np.moveaxis(b, -2, 0).reshape(c, -1)
    ic = np.moveaxis(zb, -2, 0).reshape(c, -1)
    sums = np.zeros((c, nbins))
    cnts = np.zeros((c, nbins))
    for ci in range(c):
        sums[ci] = np.bincount(ic[ci], weights=bc[ci], minlength=nbins)
        cnts[ci] = np.bincount(ic[ci], minlength=nbins)

    def est(s, n):
        with np.errstate(divide="ignore", invalid="ignore"):
            m = s.sum(axis=0) / n.sum(axis=0)
            return np.where(m > 0, -temperature * np.log(m), np.nan)

    mu = est(sums, cnts)
    rng = np.random.default_rng(seed)
    boots = np.empty((n_boot, nbins))
    for i in range(n_boot):
        pick = rng.integers(0, c, c)
        boots[i] = est(sums[pick], cnts[pick])
    err = np.nanstd(boots, axis=0)
    return centers, mu, err, cnts.sum(axis=0)


def mu_ex_reweighted(du_k, e_k, temps, t_grid):
    """Continuous mu_ex(T) from ladder samples through MBAR: du_k[l]
    [M_l, k] ghost energies paired sample for sample with the level's
    configuration energies e_k[l] [M_l]; at a target T' the configuration
    weights and the insertion factor both reweight exactly. Returns
    (mu [t_grid], ess [t_grid])."""
    from .reweight import mbar_free_energies

    _, log_denom, e_shifted, _, _ = mbar_free_energies(
        e_k, 1.0 / np.asarray(temps, np.float64))
    du = np.concatenate([np.asarray(d, np.float64) for d in du_k], axis=0)
    mus = np.empty(len(t_grid))
    esss = np.empty(len(t_grid))
    log_denom = np.asarray(log_denom, np.float64)
    e_shifted = np.asarray(e_shifted, np.float64)
    for i, t in enumerate(np.asarray(t_grid, np.float64)):
        beta = 1.0 / t
        logw = -beta * e_shifted - log_denom
        logw -= logw.max()
        wgt = np.exp(logw)
        wgt /= wgt.sum()
        mean_b = float(wgt @ _boltz(du, t).mean(axis=1))
        mus[i] = -t * np.log(mean_b) if mean_b > 0 else np.inf
        esss[i] = 1.0 / float((wgt ** 2).sum())
    return mus, esss


def second_virial(temperature: float, n_grid: int = 4096,
                  r_max: float = 12.0) -> float:
    """LJ second virial coefficient B2(T) = -2 pi int (e^{-bu} - 1) r^2
    dr; to first order in density beta mu_ex = 2 rho B2(T)."""
    r = np.linspace(1e-6, r_max, n_grid)
    u = 4.0 * (r ** -12.0 - r ** -6.0)
    with np.errstate(over="ignore"):
        f = np.expm1(-np.minimum(u / temperature, 700.0))
    trapz = getattr(np, "trapezoid", None) or np.trapz
    return -2.0 * np.pi * trapz(f * r * r, r)
