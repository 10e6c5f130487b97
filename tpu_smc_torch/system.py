"""System construction: FCC lattice init, wall construction, bounds checks
(copy of tpu_smc.system; numpy, float64).

Reference: initializeBox (SMC.c:413-465), initializeWalls (SMC.c:475-501),
shiftSystem{,2D,3D} (SMC.c:505-527), boundsCheck (SMC.c:529-543).

Construction is host-side numpy in float64 (it runs once), then cast to the
compute dtype when building device state. The lattice reproduces the
reference bit-for-bit, including its famous quirk: the intended random
jitter `L*(rand()/RAND_MAX)/50` is integer division in C, so every particle
gets a deterministic +a/4 shift instead (SMC.c:455-459).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from .config import SMCConfig
from .rng import reference_wall_params


def fcc_lattice(cfg: SMCConfig) -> np.ndarray:
    """Initial positions as the reference builds them (initializeBox,
    SMC.c:413-465). Returns [N, 3] float64, centered around the origin.
    """
    n = cfg.n
    l, lz = cfg.box_l, cfg.box_lz
    nc = math.ceil(n / 4)  # total fcc cells (SMC.c:416)
    na = 1
    for c in range(1, n):  # largest cube of cells not exceeding nc (SMC.c:419-425)
        if c * c * c > nc:
            na = c - 1
            break
    nz = int(np.rint((n // 4) / (na * na)))  # SMC.c:426 (integer n/4)
    if 4 * na * na * nz < n:
        # The reference only warns here (perror, SMC.c:427-428) and then
        # leaves the surplus particles overlapping at the origin — which
        # diverges. We instead extend the lattice by enough z-layers to
        # give every particle a distinct site (documented deviation).
        nz = math.ceil(n / (4 * na * na))
    a = l / na

    x = np.zeros((n, 3), dtype=np.float64)
    base = np.array(
        [[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]]
    ) * a
    idx = 0
    for i in range(na):
        for j in range(na):
            for k in range(nz):
                if idx >= n:
                    break
                origin = np.array([a * i, a * j, a * k])
                take = min(4, n - idx)
                x[idx : idx + take] = origin[None, :] + base[:take]
                idx += take

    # "Jitter": integer division makes it exactly +a/4 on every coordinate
    # (SMC.c:455-459). Reproduced deliberately — see docs/DEVIATIONS.md.
    x += a / 4.0

    # Recentre: wrap x,y by L and z by Lz - Lz/20 (SMC.c:461).
    x[:, 0] -= l * np.rint(x[:, 0] / l)
    x[:, 1] -= l * np.rint(x[:, 1] / l)
    zper = lz - lz / 20.0
    x[:, 2] -= zper * np.rint(x[:, 2] / zper)
    return x


def build_walls(cfg: SMCConfig, seed: int = 42
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Wall coefficient table W[M*M, 2] plus the raw (x0, ym) site draws.

    Bit-exact with initializeWalls (SMC.c:475-501): srand(42) + glibc
    Box-Muller, a = x0^12*ym, b = x0^6*ym. Returns (W, x0, ym) in float64.
    `seed` != 42 draws a different quenched-disorder realization.
    """
    from .rng import reference_wall_draws

    x0, ym = reference_wall_draws(cfg, seed)
    w = reference_wall_params(cfg, seed)
    return w, x0, ym


def build_wall_ensemble(cfg: SMCConfig, k: int, base_seed: int = 42
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """K quenched wall-disorder realizations drawn with seeds base_seed ..
    base_seed + K - 1 through build_walls, so realization 0 with the
    default seed is the reference wall bit for bit (the reference freezes
    its wall at srand(42), SMC.c:477). Returns (W [K, M*M, 2],
    x0 [K, M*M], ym [K, M*M]) in float64."""
    ws, x0s, yms = zip(*(build_walls(cfg, base_seed + i) for i in range(k)))
    return np.stack(ws), np.stack(x0s), np.stack(yms)


def bounds_check(r: np.ndarray, cfg: SMCConfig, lz_margin: float = 0.1) -> Tuple[int, int]:
    """Count particles outside the x/y box or beyond the walls
    (boundsCheck, SMC.c:529-543; called with Lz-0.1 at SMC.c:191).

    Returns (n_escaped_xy, n_through_walls)."""
    half_l = cfg.box_l / 2.0
    half_lz = (cfg.box_lz - lz_margin) / 2.0
    out_xy = np.sum((np.abs(r[:, 0]) > half_l) | (np.abs(r[:, 1]) > half_l))
    out_z = np.sum(
        ~((np.abs(r[:, 0]) > half_l) | (np.abs(r[:, 1]) > half_l))
        & (np.abs(r[:, 2]) > half_lz)
    )
    return int(out_xy), int(out_z)
