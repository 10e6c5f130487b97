"""Observables of the gather step (counterpart of tpu_smc.observables):
voxel density/mobility (SMC.c:912-927), common neighbour analysis
(SMC.c:971-1045, corrected as in the JAX package), the structure
observables that have no reference counterpart (the z-density profile,
g(r), the Harasima pressure-tensor profile P_N(z)/P_T(z) and the
in-plane structure factor S(k)), and the host-side autocorrelation and
variance statistics (SMC.c:1055-1142).

Device observables take positions [C, N, 3]; O(N^2) ones run over chain
batches (`vmap_chains_bounded`) and row chunks so that their pair
temporaries stay within a fixed element budget at any N; CNA runs on
padded neighbour lists, O(P K^2 log K) per chain for P bonded pairs of
at most K neighbours each.
The statistics are numpy on host traces.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .config import SMCConfig
from . import potentials
from .potentials import pair_row_chunk


def obs_chain_batch(n: int) -> int:
    """Chains per batch of an all-pairs observable: B * N * N within
    PAIR_BUDGET (64 chains at N = 1024), at least one chain, whose pair
    sums then run over row chunks (potentials.pair_row_chunk), so that
    B * rows * N stays within the same budget at any N."""
    return max(1, potentials.PAIR_BUDGET // max(n * n, 1))


def vmap_chains_bounded(fn, r: torch.Tensor, n: int,
                        batch: int | None = None):
    """fn over the chain axis of r in batches of at most `batch` chains
    (default obs_chain_batch(n)); fn maps [B, ...] to a tensor or a
    tuple of tensors with leading [B]. Results are concatenated. Under a
    split (potentials.split_of) each batch sums as the unsplit call's
    batch of the same chains."""
    b = batch or obs_chain_batch(n)
    with potentials.chain_block(b):
        if r.shape[0] <= b:
            return fn(r)
        parts = [fn(r[i:i + b]) for i in range(0, r.shape[0], b)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def wall_obs_chains(fn, r: torch.Tensor, w: torch.Tensor, n: int):
    """Wall-dependent observable fn(r_batch, w_batch) over the chains of
    r [C, N, 3] in bounded batches. `w` is the shared [M*M, 2] table or
    per-chain tables [C, M*M, 2] (quenched wall disorder), sliced with
    the chains."""
    if w.dim() == 2:
        return vmap_chains_bounded(lambda rb: fn(rb, w), r, n)
    b = obs_chain_batch(n)
    with potentials.chain_block(b):
        if r.shape[0] <= b:
            return fn(r, w)
        return torch.cat([fn(r[i:i + b], w[i:i + b])
                          for i in range(0, r.shape[0], b)])


# ----------------------------------------------------------------------
# Voxel density & mobility (SMC.c:912-927)
# ----------------------------------------------------------------------

def z_range_edges(cfg: SMCConfig) -> np.ndarray:
    """Non-uniform z bin edges in [0, Lz] (createZRange, SMC.c:1153-1169):
    (Ncz-3)/2 thin layers of layer_depth per wall + 3 equal central
    layers, as tpu_smc.observables.z_range_edges builds them."""
    ncz = cfg.ncz
    ld = float(cfg.layer_depth)
    lz = float(cfg.box_lz)
    half = (ncz - 3) // 2
    ld = min(ld, lz / (2.0 * half + 3.0)) if half else ld
    lower = ld * np.arange(half + 1)
    upper = lz - ld * np.arange(half, -1, -1)
    inner_lo, inner_hi = lower[-1], upper[0]
    central = inner_lo + (inner_hi - inner_lo) / 3.0 * np.arange(1, 3)
    edges = np.concatenate([lower, central, upper])
    if edges.size != ncz + 1:
        edges = np.unique(np.concatenate(
            [edges, [inner_lo + (inner_hi - inner_lo) / 2.0]]))[: ncz + 1]
    if edges.size != ncz + 1:
        raise ValueError(f"z edges: {edges.size} for ncz={ncz}")
    return edges


def voxel_index(r: torch.Tensor, cfg: SMCConfig) -> torch.Tensor:
    """Voxel id per particle [C, N]: i*Ncx*Ncz + j*Ncz + k with
    i = floor((x/L + 1/2) Ncx) etc. (SMC.c:917-920), clipped into range."""
    i = torch.floor((r[..., 0] / cfg.box_l + 0.5) * cfg.ncx).to(torch.int64)
    j = torch.floor((r[..., 1] / cfg.box_l + 0.5) * cfg.ncx).to(torch.int64)
    if cfg.nonuniform_z:
        edges = torch.as_tensor(z_range_edges(cfg), dtype=r.dtype,
                                device=r.device)
        k = torch.searchsorted(edges, (r[..., 2] + cfg.box_lz / 2.0)
                               .contiguous(), right=True) - 1
    else:
        k = torch.floor((r[..., 2] / cfg.box_lz + 0.5) * cfg.ncz
                        ).to(torch.int64)
    i = i.clamp(0, cfg.ncx - 1)
    j = j.clamp(0, cfg.ncx - 1)
    k = k.clamp(0, cfg.ncz - 1)
    return i * (cfg.ncx * cfg.ncz) + j * cfg.ncz + k


def density_mobility_update(r, rbin, density, mobility, cfg: SMCConfig):
    """One gather's cumulative voxel update for every chain (SMC.c:916-926):
    D[v]++ per particle; Mu[v]++ and Rbin[n] = v when particle n changed
    voxel. Returns (rbin, density, mobility)."""
    v = voxel_index(r, cfg)
    density = density.scatter_add(1, v, torch.ones_like(v))
    mobility = mobility.scatter_add(1, v, (rbin != v).to(mobility.dtype))
    return v, density, mobility


# ----------------------------------------------------------------------
# Common Neighbour Analysis
# ----------------------------------------------------------------------

class ClusterCounts(NamedTuple):
    num1: torch.Tensor  # [P] bool: pair within lca_cutoff
    num2: torch.Tensor  # [P] int: common neighbours of the pair
    num3: torch.Tensor  # [P] int: bonds among those common neighbours


def pair_indices(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Row/col arrays of the N(N-1)/2 unique pairs (l, i < l), row-major."""
    l, i = np.tril_indices(n, k=-1)
    return l, i


def neighbour_lists(r: torch.Tensor, cfg: SMCConfig) -> torch.Tensor:
    """Padded neighbour lists [N, K] of one chain r [N, 3]: row l holds,
    in ascending order, the particles bonded to l (within lca_cutoff,
    x/y min-image, z unwrapped as SMC.c:987-992; l itself excluded),
    padded with N; K = the largest degree. Built over row chunks of
    pair_row_chunk(1, N) rows, never an [N, N] tensor."""
    n = r.shape[0]
    cut2 = cfg.lca_cutoff * cfg.lca_cutoff
    step = pair_row_chunk(1, n)
    cols = torch.arange(n, device=r.device)
    li, lj = [], []
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)

        def comp(k):
            d = r[r0:r1, k].unsqueeze(-1) - r[:, k]
            if k < 2:
                return d - cfg.box_l * torch.round(d / cfg.box_l)
            if cfg.pbc_z:
                return d - cfg.box_lz * torch.round(d / cfg.box_lz)
            return d

        dx = comp(0)
        dr2 = dx * dx
        del dx
        dy = comp(1)
        dr2 = dr2 + dy * dy
        del dy
        dz = comp(2)
        dr2 = dr2 + dz * dz
        del dz
        bond = (dr2 < cut2) & (cols[r0:r1, None] != cols)
        a, b = bond.nonzero(as_tuple=True)
        li.append(a + r0)
        lj.append(b)
    li, lj = torch.cat(li), torch.cat(lj)       # row-major: sorted by (l, j)
    deg = torch.bincount(li, minlength=n)
    k = int(deg.max()) if n else 0
    slot = torch.arange(li.numel(), device=r.device) - (
        torch.cumsum(deg, 0) - deg)[li]
    nbr = torch.full((n, k), n, dtype=torch.int64, device=r.device)
    nbr[li, slot] = lj
    return nbr


def _member(v: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """v [..., V] in seq [..., K] (ascending), elementwise over v."""
    if seq.shape[-1] == 0:
        return torch.zeros_like(v, dtype=torch.bool)
    v = v.contiguous()
    pos = torch.searchsorted(seq.contiguous(), v)
    return seq.gather(-1, pos.clamp(max=seq.shape[-1] - 1)) == v


def _pair_counts(nbr: torch.Tensor, lrow: torch.Tensor, icol: torch.Tensor):
    """num2, num3 of pairs (lrow, icol) from one chain's neighbour lists
    [N, K]: the common neighbours are list l's entries found in list i;
    num3 counts each bond among them twice (j in list k, k in list j)
    and halves. Pairs run in batches of PAIR_BUDGET // K^2."""
    n, k = nbr.shape
    step = max(1, potentials.PAIR_BUDGET // max(k * k, 1))
    num2, num3 = [], []
    for p0 in range(0, lrow.shape[0], step):
        nl = nbr[lrow[p0:p0 + step]]                           # [P, K]
        common = _member(nl, nbr[icol[p0:p0 + step]]) & (nl < n)
        cn = torch.where(common, nl, n)
        rows = nbr[cn.clamp(max=max(n - 1, 0))]                 # [P, K, K]
        bonds = _member(cn[:, None, :].expand(-1, k, -1), rows)
        bonds &= common[:, None, :] & common[:, :, None]
        num2.append(common.sum(-1))
        num3.append(bonds.sum((1, 2)) // 2)
    if not num2:
        empty = torch.zeros((0,), dtype=torch.int64, device=nbr.device)
        return empty, empty
    return torch.cat(num2), torch.cat(num3)


def cluster_analysis(r: torch.Tensor, cfg: SMCConfig) -> ClusterCounts:
    """CNA of one chain r [N, 3] over all unique pairs, the corrected
    analysis tpu_smc.observables.cluster_analysis documents: num1 = pair
    bonded, num2 = particles bonded to both, num3 = bonds among them."""
    nbr = neighbour_lists(r, cfg)
    lrow, icol = (torch.as_tensor(a, device=r.device, dtype=torch.int64)
                  for a in pair_indices(r.shape[0]))
    num1 = _member(icol[:, None], nbr[lrow])[:, 0]
    num2, num3 = _pair_counts(nbr, lrow, icol)
    return ClusterCounts(num1, num2, num3)


def cluster_histograms(counts: ClusterCounts, nbins: int = 7):
    """Among bonded pairs, histograms of num2 and num3 in `nbins` buckets
    (SMC.c:146-155, the corrected aggregation). Returns (l1, l2, l3)."""
    bonded = counts.num1
    l1 = bonded.sum()
    l2 = torch.bincount(counts.num2[bonded].clamp(0, nbins - 1),
                        minlength=nbins)
    l3 = torch.bincount(counts.num3[bonded].clamp(0, nbins - 1),
                        minlength=nbins)
    return l1, l2, l3


def cluster_histograms_chains(r: torch.Tensor, cfg: SMCConfig,
                              nbins: int = 7):
    """(l1 [C], l2 [C, nbins], l3 [C, nbins]) of every chain of r
    [C, N, 3]: cluster_histograms(cluster_analysis(r[c])) per chain,
    evaluated on the bonded pairs only (the only pairs the histograms
    count), from each chain's neighbour lists."""
    c, n = r.shape[0], r.shape[1]
    l1 = torch.zeros((c,), dtype=torch.int64, device=r.device)
    l2 = torch.zeros((c, nbins), dtype=torch.int64, device=r.device)
    l3 = torch.zeros((c, nbins), dtype=torch.int64, device=r.device)
    for ci in range(c):
        nbr = neighbour_lists(r[ci], cfg)
        lrow = torch.arange(n, device=r.device)[:, None].expand_as(nbr)
        bonded = nbr < lrow                        # each pair once, i < l
        num2, num3 = _pair_counts(nbr, lrow[bonded], nbr[bonded])
        l1[ci] = num2.shape[0]
        l2[ci] = torch.bincount(num2.clamp(0, nbins - 1), minlength=nbins)
        l3[ci] = torch.bincount(num3.clamp(0, nbins - 1), minlength=nbins)
    return l1, l2, l3


# ----------------------------------------------------------------------
# Structure observables: rho(z), g(r), P_N/P_T(z), S(k)
# ----------------------------------------------------------------------
# tpu_smc bins g(r) by compare-and-reduce (`_bincount_rows`) because TPU
# scatters serialize; here the counts are a scatter_add_ of the same
# integer bin indices, so they are the same integers.

def _bin_counts(idx: torch.Tensor, nbins: int) -> torch.Tensor:
    """Per-row histograms [B, nbins] (int64) of bin indices idx [B, ...];
    indices outside [0, nbins) land in a dropped overflow bin."""
    flat = idx.reshape(idx.shape[0], -1)
    flat = torch.where((flat >= 0) & (flat < nbins), flat, nbins)
    out = torch.zeros((idx.shape[0], nbins + 1), dtype=torch.int64,
                      device=idx.device)
    return out.scatter_add_(1, flat, torch.ones_like(flat))[:, :nbins]


def z_density_profile(r: torch.Tensor, cfg: SMCConfig, nbins: int = 128
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Number density against the wall-normal z in [-Lz/2, Lz/2] of every
    chain of r [C, N, 3]: (centers [nbins], rho [C, nbins])."""
    lz = cfg.box_lz
    z = r[..., 2].clamp(-lz / 2, lz / 2)
    b = ((z / lz + 0.5) * nbins).to(torch.int64).clamp(0, nbins - 1)
    dz = lz / nbins
    centers = -lz / 2 + dz * (torch.arange(nbins, device=r.device,
                                           dtype=r.dtype) + 0.5)
    return centers, _bin_counts(b, nbins).to(r.dtype) / (
        cfg.box_l * cfg.box_l * dz)


def gr_rmax(cfg: SMCConfig) -> float:
    """g(r)'s default range: the pair cutoff, or L/2 when shorter."""
    return cfg.lj_cutoff if cfg.lj_cutoff < cfg.box_l / 2 else cfg.box_l / 2


def gr_edges(cfg: SMCConfig, nbins: int, rmax: float | None = None,
             dtype=torch.float32, device=None):
    """g(r)'s bin edges [nbins + 1] over [0, rmax] (default gr_rmax) and
    centers [nbins]."""
    rmax = gr_rmax(cfg) if rmax is None else rmax
    edges = torch.linspace(0.0, rmax, nbins + 1, dtype=dtype, device=device)
    return edges, 0.5 * (edges[:-1] + edges[1:])


def _pair_d_rows(R: torch.Tensor, r0: int, r1: int, cfg: SMCConfig):
    """(dx, dy, dz) [B, r1 - r0, N] of rows r0..r1-1 to every particle:
    r_i - r_j, min-image in x and y (z too when pbc_z); the components
    of potentials._pair_dr2_rows."""
    out = []
    for k, period in ((0, cfg.box_l), (1, cfg.box_l),
                      (2, cfg.box_lz if cfg.pbc_z else None)):
        dk = R[:, r0:r1, k].unsqueeze(-1) - R[:, :, k].unsqueeze(-2)
        out.append(dk - period * torch.round(dk / period) if period else dk)
    return out


def radial_distribution(r: torch.Tensor, cfg: SMCConfig, nbins: int = 128,
                        rmax: float | None = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g(r) of every chain of r [C, N, 3] over the unique pairs, bins of
    int(dr / rmax * nbins) as tpu_smc.observables.radial_distribution,
    over row chunks within potentials.PAIR_BUDGET. Returns (centers
    [nbins], g [C, nbins])."""
    c, n = r.shape[0], r.shape[1]
    rmax = gr_rmax(cfg) if rmax is None else rmax
    edges, centers = gr_edges(cfg, nbins, rmax, r.dtype, r.device)
    hist = torch.zeros((c, nbins), dtype=torch.int64, device=r.device)
    step = pair_row_chunk(c, n)
    cols = torch.arange(n, device=r.device)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        dr = torch.sqrt(potentials._pair_dr2_rows(r, r0, r1, cfg)[0])
        q = (dr / rmax * nbins).to(torch.int64).clamp(0, nbins)
        q = torch.where(cols[r0:r1, None] < cols, q, nbins)   # i < j only
        hist += _bin_counts(q, nbins)
    shell = (4.0 / 3.0) * math.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    return centers, hist.to(r.dtype) / (cfg.rho * shell * n / 2.0)


def pressure_tensor_profile(r: torch.Tensor, cfg: SMCConfig,
                            nbins: int = 64, include_ideal: bool = True):
    """Normal and tangential pressure profiles P_N(z), P_T(z) of every
    chain of r [C, N, 3] (Harasima: each pair's virial in the bin of its
    midpoint z), as tpu_smc.observables.pressure_tensor_profile:
    mean_b (P_N + 2 P_T)/3 equals rho T + the pair virial pressure. The
    bins accumulate in float64 over row chunks within PAIR_BUDGET.
    include_ideal=False returns the virial parts alone (the ladders add
    rho(z; T') T' after reweighting). Returns (centers [nbins], P_N
    [C, nbins], P_T [C, nbins])."""
    c, n = r.shape[0], r.shape[1]
    lz = cfg.box_lz
    dzb = lz / nbins
    vb = cfg.box_l * cfg.box_l * dzb
    pn = torch.zeros((c, nbins), dtype=torch.float64, device=r.device)
    pt = torch.zeros_like(pn)
    step = pair_row_chunk(c, n)
    cols = torch.arange(n, device=r.device)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        dx, dy, dz = _pair_d_rows(r, r0, r1, cfg)
        dr2 = dx * dx + dy * dy + dz * dz
        mask = (dr2 < cfg.cutoff2) & (cols[r0:r1, None] != cols)
        inv2 = 1.0 / torch.where(mask, dr2, torch.ones_like(dr2))
        inv6 = inv2 * inv2 * inv2
        dv = torch.where(mask, (48.0 * inv6 * inv6 - 24.0 * inv6) * inv2,
                         torch.zeros_like(inv2))
        tang = dv * (dx * dx + dy * dy)
        norm = dv * (dz * dz)
        zmid = r[:, r0:r1, 2].unsqueeze(-1) - 0.5 * dz
        if cfg.pbc_z:
            zmid = zmid - lz * torch.round(zmid / lz)
        b = ((zmid / lz + 0.5) * nbins).to(torch.int64).clamp(0, nbins - 1)
        b = b.reshape(c, -1)
        pn.scatter_add_(1, b, norm.reshape(c, -1).double())
        pt.scatter_add_(1, b, tang.reshape(c, -1).double())
    pn = (0.5 * pn / vb).to(r.dtype)            # unique pairs
    pt = (0.5 * pt / (2.0 * vb)).to(r.dtype)
    centers = -lz / 2 + dzb * (torch.arange(nbins, device=r.device,
                                            dtype=r.dtype) + 0.5)
    if not include_ideal:
        return centers, pn, pt
    ideal = z_density_profile(r, cfg, nbins=nbins)[1] * cfg.temperature
    return centers, ideal + pn, ideal + pt


def _sk_grid(n_kmax: int):
    """In-plane k grid of structure_factor: one of each +-k pair,
    0 < |n|_inf <= n_kmax, its shells of equal |n|^2 and the shell of
    each vector."""
    ns = np.arange(-n_kmax, n_kmax + 1)
    nx, ny = np.meshgrid(ns, ns, indexing="ij")
    grid = np.stack([nx.ravel(), ny.ravel()], axis=1)
    n2 = (grid ** 2).sum(axis=1)
    keep = (n2 > 0) & ((grid[:, 0] > 0)
                       | ((grid[:, 0] == 0) & (grid[:, 1] > 0)))
    shells, shell_idx = np.unique(n2[keep], return_inverse=True)
    return grid[keep], shells, shell_idx


def structure_factor(r: torch.Tensor, cfg: SMCConfig, n_kmax: int = 8
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-plane S(k) = |sum_j exp(i k . r_j)|^2 / N on k = (2 pi / L)
    (nx, ny), pooled over shells of equal |n|^2, for every chain of r
    [C, N, 3] (tpu_smc.observables.structure_factor), chains batched so
    that the [B, N, nk] phases stay within PAIR_BUDGET. Returns
    (|k| [shells], S [C, shells])."""
    grid, shells, shell_idx = _sk_grid(n_kmax)
    kvecs = torch.as_tensor(grid.T, dtype=r.dtype, device=r.device)
    idx = torch.as_tensor(shell_idx, device=r.device)
    counts = torch.as_tensor(np.bincount(shell_idx), dtype=r.dtype,
                             device=r.device)

    def batch(rb):
        ph = (2.0 * math.pi / cfg.box_l) * (rb[..., :2] @ kvecs)
        s_k = (torch.cos(ph).sum(1) ** 2 + torch.sin(ph).sum(1) ** 2) / cfg.n
        pooled = torch.zeros((rb.shape[0], len(shells)), dtype=s_k.dtype,
                             device=r.device)
        return pooled.index_add_(1, idx, s_k) / counts

    b = max(1, potentials.PAIR_BUDGET // max(r.shape[1] * len(grid), 1))
    k_mag = (2.0 * np.pi / cfg.box_l) * np.sqrt(shells)
    return (torch.as_tensor(k_mag, dtype=r.dtype, device=r.device),
            vmap_chains_bounded(batch, r, r.shape[1], batch=b))


# ----------------------------------------------------------------------
# Autocorrelation and summary statistics (host numpy)
# ----------------------------------------------------------------------

def autocorrelation(trace: np.ndarray, k_max: int,
                    mode: str = "reference") -> np.ndarray:
    """Normalized autocorrelation of a scalar trace, acf[0] = 1.

    "reference" reproduces fft_acf (SMC.c:1055-1093): de-mean, rfft,
    power spectrum truncated to n//2 + n%2 bins, complex inverse FFT,
    normalised by lag 0. "circular" is the Wiener-Khinchin circular ACF;
    "unbiased" zero-pads and divides by (n - k)."""
    trace = np.asarray(trace)
    n = trace.shape[0]
    if n < 2 * k_max + 1:
        k_max = int(np.rint(n / 2)) - 2
    z = trace - np.mean(trace)
    if mode == "reference":
        lfft = n // 2 + n % 2
        f = np.fft.rfft(z)
        ch = np.fft.ifft((f * np.conj(f))[:lfft])
        return np.real(ch[:k_max]) / np.real(ch[0])
    if mode == "circular":
        f = np.fft.rfft(z)
        ch = np.fft.irfft(f * np.conj(f), n=n)
        return ch[:k_max] / ch[0]
    if mode == "unbiased":
        m = 2 * n
        f = np.fft.rfft(z, n=m)
        ch = np.fft.irfft(f * np.conj(f), n=m)[:k_max]
        ch = ch / (n - np.arange(k_max))
        return ch / ch[0]
    raise ValueError(f"unknown acf mode {mode}")


def autocorrelation_direct(trace: np.ndarray, k_max: int) -> np.ndarray:
    """Direct O(n k) ACF of simple_acf (SMC.c:1096-1122)."""
    trace = np.asarray(trace)
    n = trace.shape[0]
    z = trace - np.mean(trace)
    m = n - k_max - 1
    acf = np.array([np.sum(z[:m] * z[k:k + m]) / (n - k_max)
                    for k in range(k_max)])
    return acf / acf[0]


def integrated_autocorrelation_time(acf: np.ndarray) -> float:
    """tau = sum of the ACF, as the reference driver computes it
    (SMC.c:235)."""
    return float(np.sum(acf))


def tau_int(trace: np.ndarray, k_max: int | None = None) -> float:
    """0.5 + sum of the normalized circular ACF up to its first negative
    lag; k_max defaults to len/3 capped at 20k lags (tpu_smc's rule)."""
    trace = np.asarray(trace, np.float64)
    if k_max is None:
        k_max = max(2, min(len(trace) // 3, 20_000))
    acf = autocorrelation(trace, k_max, mode="circular")
    neg = int(np.argmax(acf < 0)) or len(acf)
    if neg == len(acf):
        warnings.warn(
            f"tau_int: ACF has no negative crossing within k_max={k_max} "
            f"lags (trace length {len(trace)}); the returned tau is a "
            "truncated lower bound", stacklevel=2)
    return float(0.5 + acf[1:neg].sum())


def variance_strided(trace: np.ndarray, tau: float) -> float:
    """Variance over tau-strided samples (variance_corr, SMC.c:1128-1142)."""
    trace = np.asarray(trace)
    sub = trace[::max(1, int(np.floor(tau)))]
    return float(np.sum((sub - np.mean(trace)) ** 2) / (sub.shape[0] - 1))


def trace_mean_var(trace: np.ndarray) -> Tuple[float, float]:
    """Mean and population variance E[x^2] - E[x]^2
    (matematicose.c:97-104)."""
    trace = np.asarray(trace)
    m = np.mean(trace)
    return float(m), float(np.mean(trace * trace) - m * m)
