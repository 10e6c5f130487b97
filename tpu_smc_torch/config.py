"""Static configuration of the Smart-MC engine (PyTorch port).

Field-for-field copy of tpu_smc.config so both packages key their runs,
file names and physics on the same values; the only change is the
`torch_dtype` property in place of `jnp_dtype`.

The reference fixes most of its configuration at compile time as C macros
(SMC.h:26-61) plus hardcoded values in main (main.c:35-51, 74-77). Here all
of it lives in one frozen dataclass.

Reference config surface mirrored here:
  M, N, a0, b0, LJ_CUTOFF            SMC.h:26-41
  STORAGE_TIME, LCA_TIME, LCA_cutoff SMC.h:45-50
  Ncx, Ncz, LAYER_DEPTH, KMAX        SMC.h:53-61
  box dims by N                      main.c:35-44
  A = gamma * T (gamma = 1)          main.c:48-51
  wall statistics x0m/x0sigma/ym/ymsigma  main.c:74-77
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

# Uniform ("omnipresent") planar wall coefficients, SMC.h:31-33.
# a0 = 0.25**12 * 0.1, b0 = 0.25**6 * 0.1 exactly.
A0_WALL = 5.960464477539063e-9
B0_WALL = 2.44140625e-5


def default_box(n: int) -> Tuple[float, float]:
    """Box dimensions the reference hardcodes per particle count (main.c:35-44)."""
    if n == 32:
        return 20.0, 120.0
    if n < 150:
        return 33.0, 200.0
    return 33.0, 240.0


@dataclasses.dataclass(frozen=True)
class SMCConfig:
    """Full static configuration of one Smart-MC system.

    Frozen + hashable so it can be passed as a static argnum to jit.
    """

    # --- system size (SMC.h:26-29) ---
    n: int = 108                 # particles
    m: int = 3                   # wall grid points per dimension (M^2 sources/wall)

    # --- geometry (main.c:35-44) ---
    box_l: float = 33.0          # box side in x and y (periodic)
    box_lz: float = 200.0        # box extent in z (confined by walls at +-Lz/2)

    # --- thermodynamics / proposal (main.c:48-51) ---
    temperature: float = 1.1
    gamma: float = 1.0           # A = gamma * T

    # --- pair potential (SMC.h:31-41) ---
    a0: float = A0_WALL
    b0: float = B0_WALL
    lj_cutoff: float = 3.0       # sigma units; reference TRUNCATE=1 path
    # Bulk variant uses cutoff^2 = L^2/4 (SMC_noMPI_noWall.c:519); set
    # lj_cutoff = box_l / 2 to reproduce.
    # Truncated-and-SHIFTED pair potential: subtract u(rc) inside the
    # cutoff so u is continuous at rc. The reference is truncated-
    # unshifted (SMC.c:578 just drops the pair), which carries an
    # impulsive delta-force at rc that the force-only virial misses —
    # fine for NVT parity, but the NPT engine equilibrates against the
    # TRUE mechanical pressure, so constant-P runs default this on
    # (npt.py; the NVT<->NPT closed-loop test quantifies the ~0.12
    # pressure gap at rho=0.3, rc=1.8). Forces are unchanged; the XLA
    # engine only — the Pallas kernels assert it off.
    lj_shift: bool = False

    # --- wall statistics (main.c:74-77) ---
    wall_x0_mean: float = 1.6
    wall_x0_sigma: float = 0.0
    wall_ym_mean: float = 3.0
    wall_ym_sigma: float = 0.5

    # --- boundary conditions ---
    use_walls: bool = True       # False = bulk fluid (SMC_noMPI_noWall.c variant)
    pbc_z: bool = False          # bulk variant wraps z too (SMC_noMPI_noWall.c:516-517)

    # --- observables cadence (SMC.h:45-55) ---
    storage_time: int = 1000     # gathers between position/density-window dumps
    lca_time: int = 10           # gathers between cluster analyses
    lca_cutoff: float = 1.7      # CNA neighbour cutoff
    ncx: int = 33                # density voxels along x and y
    ncz: int = 33                # density voxels along z
    layer_depth: float = 5.0     # non-uniform z-cell thickness (SMC.h:58)
    # Non-uniform z binning for density/mobility voxels: thin layer_depth
    # layers at both walls, 3 thick layers in the center (createZRange /
    # localDensityAndMobility_nonuniz, SMC.c:1153-1169, 930-964 — present
    # but unused in the reference's live path; the reference's edge array
    # even leaves index 17 unset. We implement the commented intent with
    # a complete Ncz+1 edge partition — docs/DEVIATIONS.md F8).
    nonuniform_z: bool = False
    kmax: int = 2_500_000        # max ACF lag (SMC.h:61)

    # --- numerics (new: the reference is double everywhere) ---
    dtype: str = "float32"       # compute dtype; the kernel engines run float32
    # Contact clamp for the uniform wall term. The reference clamps the
    # signed wall distance to +-1e-4 when a particle crosses a wall
    # (SMC.c:738-739, 785-786); dz**-12 then reaches ~1e48 which overflows
    # float32. In float32 we clamp at 1e-3 instead: the resulting energies
    # (~1e24) still force the same accept/reject decisions while staying
    # finite. Documented deviation, see docs/DEVIATIONS.md.
    wall_contact_dz: float = 1e-4
    # Reproduce the reference's EXACT proposal-noise distribution instead
    # of i.i.d. Gaussians. The reference's vecBoxMuller builds pairs as
    # (R(x1) cos 2pi x2, R(x2) sin 2pi x1) (matematicose.c:190-191):
    # marginally normal but strongly DEPENDENT (E[n1 n2^2] = 0.27), so the
    # C chain's stationary distribution is slightly biased (~0.6% in mean
    # energy, measured). Off by default — i.i.d. noise is the correct
    # Smart-MC; on for bug-compatible validation runs. docs/DEVIATIONS.md.
    reference_noise: bool = False
    # Recompute the total energy exactly every `recompute_every` gathers to
    # bound incremental-energy drift (the reference never recomputes,
    # SMC.c:194,341 — it tolerates double-precision drift; we do not tolerate
    # float32 drift). 0 disables.
    recompute_every: int = 1

    def __post_init__(self):
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported dtype {self.dtype}")
        if self.n < 2:
            raise ValueError("need at least 2 particles")

    # ------------------------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "float64" else torch.float32

    @property
    def proposal_a(self) -> float:
        """The Smart-MC mobility A = gamma*T (main.c:51)."""
        return self.gamma * self.temperature

    @property
    def rho(self) -> float:
        return self.n / (self.box_l * self.box_l * self.box_lz)

    @property
    def cutoff2(self) -> float:
        return self.lj_cutoff * self.lj_cutoff

    @property
    def contact_dz(self) -> float:
        """Wall contact clamp, widened in float32 to stay finite."""
        if self.dtype == "float32":
            return max(self.wall_contact_dz, 1e-3)
        return self.wall_contact_dz

    @property
    def n_voxels(self) -> int:
        # The reference driver sizes the voxel arrays as Ncx^3 even though
        # indices only reach Ncx*Ncx*Ncz (SMC.c:28); we allocate what is used.
        return self.ncx * self.ncx * self.ncz

    def run_name(self) -> str:
        """Config-keyed run directory name, matching main.c:58."""
        return f"data_N{self.n}_M{self.m}_r{self.rho:0.4f}_T{self.temperature:0.2f}"

    def file_key(self) -> str:
        """Config key used in every output filename (SMC.c:66-96)."""
        return f"N{self.n}_M{self.m}_r{self.rho:0.4f}_T{self.temperature:0.2f}"

    # ------------------------------------------------------------------
    @classmethod
    def for_n(cls, n: int, temperature: float = 1.1, **kw) -> "SMCConfig":
        """Config with the reference's default box for a given N (main.c:35-44)."""
        l, lz = default_box(n)
        return cls(n=n, box_l=l, box_lz=lz, temperature=temperature, **kw)

    @classmethod
    def bulk(cls, n: int = 32, temperature: float = 0.4, rho: float = 0.1,
             **kw) -> "SMCConfig":
        """Bulk LJ fluid, the SMC_noMPI_noWall.c variant.

        That program hardcodes N=32, rho=0.1, T=0.4, full 3-D periodicity,
        a cutoff of L/2 and — unlike the wall program's A = gamma*T — a
        fixed tiny mobility A = 4e-8 (SMC_noMPI_noWall.c:77-82, 192,
        516-519). gamma defaults so that A matches at the given T.
        """
        l = (n / rho) ** (1.0 / 3.0)
        kw.setdefault("gamma", 4e-8 / temperature)
        # rc defaults to the reference's L/2; NPT runs pass a smaller
        # fixed cutoff (npt.py needs compression headroom below L0)
        kw.setdefault("lj_cutoff", l / 2.0)
        return cls(
            n=n, box_l=l, box_lz=l, temperature=temperature,
            use_walls=False, pbc_z=True, **kw,
        )


@dataclasses.dataclass(frozen=True)
class RunParams:
    """Runtime parameters: the reference's four positional CLI args
    (main.c:13-19) plus the derived gather cadence (main.c:32)."""

    eqsteps: int
    maxsteps: int
    numdata: int

    @property
    def gather_lapse(self) -> int:
        return max(1, math.floor(self.maxsteps / self.numdata))

    @property
    def gather_steps(self) -> int:
        return int(self.maxsteps / self.gather_lapse)
