"""Geometry random numbers (glibc-compatible), copied from tpu_smc.rng.

The reference seeds `srand(42)` before building the walls (SMC.c:477) and the
FCC lattice (SMC.c:415), so its initial geometry is a deterministic function
of glibc's `rand()`. `GlibcRandom` reimplements glibc's TYPE_3
additive-feedback generator (31-word state, r[i] = r[i-31] + r[i-3] mod 2^32,
output >> 1), so the wall table is bit-exact with the C program and with the
JAX package. The wall draws run on its C++ twin, native.NativeGlibcRandom
(as tpu_smc's do when its library is built); this pure-Python one is the
plain version the tests hold it against. The FCC lattice consumes no draw
(its jitter is a constant, system.fcc_lattice). The chains' own random
numbers are the counter-based Philox stream of kernels/sweep.py.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

GLIBC_RAND_MAX = 2147483647


class GlibcRandom:
    """glibc rand()/srand() (TYPE_3 / degree 31, separation 3).

    Matches glibc's default `rand()` stream for a given seed.
    """

    def __init__(self, seed: int = 1):
        self.srand(seed)

    def srand(self, seed: int) -> None:
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = [0] * 344
        r[0] = seed
        # Initial scrambling: LCG x_{i} = 16807 x_{i-1} mod (2^31 - 1),
        # evaluated in signed arithmetic exactly like glibc.
        for i in range(1, 31):
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += GLIBC_RAND_MAX
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        # Keep the last 31 words as the ring buffer; glibc discards the
        # first 310 outputs (34..343 above produce them).
        self._ring = r[-31:]
        self._idx = 0  # next output combines ring[-31] and ring[-3]

    def rand(self) -> int:
        ring = self._ring
        val = (ring[0] + ring[28]) & 0xFFFFFFFF
        ring.append(val)
        del ring[0]
        return val >> 1

    def uniform(self) -> float:
        """rand() / RAND_MAX as the C acceptance test does (SMC.c:335)."""
        return self.rand() / GLIBC_RAND_MAX

    def box_muller(self, sigma: float, length: int) -> np.ndarray:
        """vecBoxMuller (matematicose.c:183-193), including its quirks:

        * draws use rand() / (RAND_MAX + 1.0),
        * the loop bound is round(length/2) where length/2 is size_t
          (integer) division, so for odd `length` the final element is
          never written — it keeps its malloc contents, which for the
          reference's fresh small allocations is 0.0 in practice. We
          reproduce that: fill 2*(length//2) values, zero the tail.
        """
        iters = length // 2
        out = np.zeros(2 * iters + (length % 2), dtype=np.float64)
        denom = GLIBC_RAND_MAX + 1.0
        for i in range(iters):
            x1 = self.rand() / denom
            x2 = self.rand() / denom
            out[2 * i] = sigma * math.sqrt(-2.0 * math.log(1.0 - x1)) * math.cos(
                2.0 * math.pi * x2
            )
            out[2 * i + 1] = sigma * math.sqrt(-2.0 * math.log(1.0 - x2)) * math.sin(
                2.0 * math.pi * x1
            )
        return out[:length]


def round_half_away(x: float) -> float:
    """C round(): half away from zero (Python round() is half-even)."""
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


def reference_wall_draws(cfg, seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """The exact (x0, ym) site parameters the reference generates.

    initializeWalls (SMC.c:475-501): srand(42), Box-Muller fill of X0 then
    YM (each consuming 2*round(M^2/2) draws), x0 = X0 + x0m, ym = YM + ymm.

    `seed` defaults to the reference's hard-coded 42 (bit-exact parity);
    any other value draws a DIFFERENT disorder realization from the same
    distribution family (the reference cannot do this at all — its wall
    is frozen at srand(42) for every run and every MPI rank).
    """
    from .native import NativeGlibcRandom

    g = NativeGlibcRandom(seed)
    mm = cfg.m * cfg.m
    x0 = g.box_muller(cfg.wall_x0_sigma, mm) + cfg.wall_x0_mean
    ym = g.box_muller(cfg.wall_ym_sigma, mm) + cfg.wall_ym_mean
    return x0, ym


def reference_wall_params(cfg, seed: int = 42) -> np.ndarray:
    """Bit-exact W[M*M, 2] = (x0^12 * ym, x0^6 * ym) as the C code computes
    (SMC.c:495-496), in float64."""
    x0, ym = reference_wall_draws(cfg, seed)
    a = np.power(x0, 12.0) * ym
    b = np.power(x0, 6.0) * ym
    return np.stack([a, b], axis=-1)
