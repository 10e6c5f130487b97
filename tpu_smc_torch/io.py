"""Reference-schema CSV outputs and warm start (counterpart of the
subset of tpu_smc.io the NVT ensemble path writes).

Files go to `Data/data_N{N}_M{M}_r{rho:.4f}_T{T:.2f}/` (main.c:55-60) with
byte-identical headers and names, rank = chain index (SMC.c:66-96):

  wall_<key>.csv                 nx, ny, x0, ymin          SMC.c:488-494
  positions_<key>_rank<r>.csv    x1,y1,z1,... rows %0.3lf, SMC.c:66-73
  data_<key>_rank<r>.csv         E, P, jj                  SMC.c:75-77
  local_<key>_rank<r>.csv        nx, ny, nz, n, mu         SMC.c:79-82
  total_clusters_<key>_rank<r>.csv  l1, l2, l3             SMC.c:89-92
  autocorrelation_<key>_rank<r>.csv CH                     SMC.c:94-97
  data_ensemble_<key>.csv        E_mean, E_std, P_mean, jj_mean
  info_<key>.csv                 run summary               main.c:138-159
  last_state_<key>.csv           3N doubles %0.12f         main.c:163-171

and the measurement layer's files (no reference counterpart): the g(r)
and z-profile CSVs (`write_profile_csv`), the per-realization profiles
of a disorder run (`write_disorder_profile_csv`) and the Widom mu_ex(z)
profile (`write_widom_csv`).

The positions, voxel and last_state rows go through the C++ formatters
of `native` (tpu_smc's, byte-identical); `fixed3_csv` and
`local_rows_plain` are their plain twins, kept for the tests.

Full-state checkpoints (`save_checkpoint` / `load_checkpoint`) are
tpu_smc's `.npz` files: the same leaves and `__config__` JSON, readable
by either package.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from .config import RunParams, SMCConfig
from .state import ChainState, state_from_arrays


def run_dir(cfg: SMCConfig, base: str | Path = "Data") -> Path:
    d = Path(base) / cfg.run_name()
    d.mkdir(parents=True, exist_ok=True)
    return d


def _fname(d: Path, stem: str, cfg: SMCConfig, rank: Optional[int] = None) -> Path:
    key = cfg.file_key()
    if rank is None:
        return d / f"{stem}_{key}.csv"
    return d / f"{stem}_{key}_rank{rank}.csv"


def write_wall_csv(d: Path, cfg: SMCConfig, x0: np.ndarray, ym: np.ndarray) -> Path:
    """wall csv: site grid indices + raw (x0, ymin) draws (SMC.c:488-494).
    Draws of a quenched-disorder ensemble ([K, M*M]) gain a leading `k`
    realization column; the 1-D schema is the reference's."""
    p = _fname(d, "wall", cfg)
    x0 = np.asarray(x0)
    ym = np.asarray(ym)
    with open(p, "w") as f:
        if x0.ndim == 2:
            f.write("k, nx, ny, x0, ymin\n")
            for k in range(x0.shape[0]):
                for i in range(cfg.m):
                    for j in range(cfg.m):
                        m = i * cfg.m + j
                        f.write(f"{k}, {i}, {j}, {x0[k, m]:f}, "
                                f"{ym[k, m]:f}\n")
        else:
            f.write("nx, ny, x0, ymin\n")
            for i in range(cfg.m):
                for j in range(cfg.m):
                    m = i * cfg.m + j
                    f.write(f"{i}, {j}, {x0[m]:f}, {ym[m]:f}\n")
    return p


class PositionsWriter:
    """positions csv: header x1,y1,z1,...; one %0.3lf-formatted row per
    snapshot, trailing comma like the reference (SMC.c:68-73)."""

    def __init__(self, d: Path, cfg: SMCConfig, rank: int = 0):
        self.path = _fname(d, "positions", cfg, rank)
        with open(self.path, "w") as f:
            f.write("".join(f"x{n+1},y{n+1},z{n+1}," for n in range(cfg.n)) + "\n")

    def append(self, r: np.ndarray) -> None:
        from . import native

        with open(self.path, "ab") as f:
            f.write(native.format_positions_row(r))


def fixed3_csv(values) -> str:
    """The plain twin of native.format_positions_row (without its
    newline): '%0.3f,' of every value, concatenated: byte-identical to
    Python's f"{v:0.3f}," but formatted as numpy arrays of digits. The
    thousandths are rint(v * 1000) in float64, which rounds like Python's
    exact decimal conversion except within float64 error of a tie
    (v * 1000 is exact for float32 inputs); those values, non-finite
    ones and |v| >= 2^31 / 1000 go through Python's own formatting."""
    v = np.asarray(values, np.float64).reshape(-1)
    with np.errstate(invalid="ignore"):
        t = v * 1000.0
        q = np.rint(t)
        odd = ~(np.abs(t) < 2.0 ** 31) | (np.abs(np.abs(t - q) - 0.5) < 1e-6)
    a = np.where(odd, 0, np.abs(q)).astype(np.int64)
    ip, fp = a // 1000, a % 1000
    neg = np.signbit(v) & ~odd           # '-0.000' keeps its sign, as in C
    digits = np.ones_like(ip)
    p10 = 10
    while (more := ip >= p10).any():
        digits += more
        p10 *= 10
    extra = [f"{x:0.3f}".encode() for x in v[odd].tolist()]
    length = neg + digits + 5            # [-]digits . ddd ,
    length[odd] = [len(s) + 1 for s in extra]
    end = np.cumsum(length)
    start = end - length
    buf = np.empty(int(end[-1]) if v.size else 0, np.uint8)
    buf[end - 1] = ord(",")
    ok = ~odd
    s, e, d, x, f, ng = start[ok], end[ok], digits[ok], ip[ok], fp[ok], neg[ok]
    buf[s[ng]] = ord("-")
    last = s + ng + d - 1                # the integer part's last digit
    for k in range(int(d.max()) if d.size else 0):
        m = d > k
        buf[(last - k)[m]] = 48 + x[m] % 10
        x = x // 10
    buf[e - 5] = ord(".")
    buf[e - 4] = 48 + f // 100
    buf[e - 3] = 48 + f // 10 % 10
    buf[e - 2] = 48 + f % 10
    for k0, text in zip(start[odd].tolist(), extra):
        buf[k0:k0 + len(text)] = np.frombuffer(text, np.uint8)
    return buf.tobytes().decode()


class LocalWriter:
    """local csv: voxel rows 'i, j, k, n, mu' (SMC.c:218-225)."""

    def __init__(self, d: Path, cfg: SMCConfig, stem: str, rank: int = 0):
        self.cfg = cfg
        self.path = _fname(d, stem, cfg, rank)
        with open(self.path, "w") as f:
            f.write("nx, ny, nz, n, mu\n")

    def append(self, density: np.ndarray, mobility: np.ndarray) -> None:
        from . import native

        cfg = self.cfg
        with open(self.path, "ab") as f:
            f.write(native.format_local_rows(density, mobility, cfg.ncx,
                                             cfg.ncz))


def local_rows_plain(density, mobility, ncx: int, ncz: int) -> str:
    """The plain twin of native.format_local_rows: the voxel rows
    'i, j, k, n, mu' formatted by Python."""
    prefixes = _voxel_prefixes(ncx, ncz)
    dv = np.asarray(density).reshape(-1).tolist()
    mv = np.asarray(mobility).reshape(-1).tolist()
    return "".join(f"{p}{d}, {m}\n" for p, d, m in zip(prefixes, dv, mv))


@functools.lru_cache(maxsize=4)
def _voxel_prefixes(ncx: int, ncz: int) -> tuple:
    """'i, j, k, ' of every voxel in file order (i, then j, then k)."""
    return tuple(f"{i}, {j}, {k}, " for i in range(ncx) for j in range(ncx)
                 for k in range(ncz))


def write_data_csv(
    d: Path,
    cfg: SMCConfig,
    energy_trace: np.ndarray,
    pressure_trace: np.ndarray,
    accept_trace: np.ndarray,
    gather_lapse: int,
    rank: int = 0,
) -> Path:
    """data csv: per-gather rows 'E, P, jj' (SMC.c:214-215).

    Faithful to the reference's sampling: E subsampled at k*gather_lapse
    from the full trace (index 0 = initial energy), P the k-th gather, and
    jj the k-th SWEEP's acceptance count (the reference's E-vs-jj index
    mismatch is reproduced for schema parity, SURVEY §7.4)."""
    p = _fname(d, "data", cfg, rank)
    gather_steps = len(pressure_trace)
    with open(p, "w") as f:
        f.write("E, P, jj\n")
        for k in range(gather_steps):
            idx = k * gather_lapse
            e = float(energy_trace[idx]) if idx < len(energy_trace) else 0.0
            jj = int(accept_trace[k]) if k < len(accept_trace) else 0
            f.write(f"{e:0.9f}, {pressure_trace[k]:0.9f}, {jj}\n")
    return p


def write_total_clusters_csv(
    d: Path, cfg: SMCConfig, l1: float, l2: np.ndarray, l3: np.ndarray, rank: int = 0
) -> Path:
    """total_clusters csv. The reference writes the header and then never
    writes a row (SMC.c:89-92); we write the actual histograms."""
    p = _fname(d, "total_clusters", cfg, rank)
    with open(p, "w") as f:
        f.write("l1, l2, l3\n")
        for s in range(len(l2)):
            f.write(f"{l1 if s == 0 else 0:0.9f}, {l2[s]:0.9f}, {l3[s]:0.9f}\n")
    return p


def write_autocorrelation_csv(
    d: Path, cfg: SMCConfig, acf: np.ndarray, rank: int = 0
) -> Path:
    p = _fname(d, "autocorrelation", cfg, rank)
    with open(p, "w") as f:
        f.write("CH\n")
        for v in np.asarray(acf):
            f.write(f"{v:0.6f}\n")
    return p


def write_ensemble_data_csv(
    d: Path,
    cfg: SMCConfig,
    chains,                 # list[SimResults] (driver_ensemble per-chain)
    gather_lapse: int,
) -> Path | None:
    """Pooled ensemble data: `data_ensemble_*.csv`, one row per gather with
    the CROSS-CHAIN mean/spread of E, mean P and mean acceptance count.

    This is the aggregation the reference's replica model left to offline
    filesystem scripts (per-rank data_*_rank%d.csv only, SMC.c:75-77,
    SURVEY §5.8). Schema: `E_mean, E_std, P_mean, jj_mean` with the same
    per-gather sampling convention as the per-rank files (E at k*lapse
    from the full trace, jj the k-th sweep's acceptance count).
    Returns None when no chain carries traces (--no-trace runs)."""
    if not chains:
        return None
    e_tr = np.stack([np.asarray(c.energy_trace_full) for c in chains], axis=1)
    a_tr = np.stack([np.asarray(c.accept_trace) for c in chains], axis=1)
    if e_tr.size == 0 or a_tr.size == 0:
        return None  # --no-trace runs carry no per-sweep data to pool
    p_tr = np.stack([np.asarray(c.pressure_trace) for c in chains], axis=1)
    gather_steps = p_tr.shape[0]
    p = _fname(d, "data_ensemble", cfg)
    with open(p, "w") as f:
        f.write("E_mean, E_std, P_mean, jj_mean\n")
        for k in range(gather_steps):
            idx = k * gather_lapse
            if idx < e_tr.shape[0]:
                em = float(e_tr[idx].mean())
                es = float(e_tr[idx].std())
            else:
                em = es = 0.0
            jj = float(a_tr[k].mean()) if k < a_tr.shape[0] else 0.0
            f.write(f"{em:0.9f}, {es:0.9f}, {float(p_tr[k].mean()):0.9f}, "
                    f"{jj:0.4f}\n")
    return p


def write_profile_csv(
    d: Path, cfg: SMCConfig, stem: str, centers: np.ndarray,
    values: np.ndarray, header: str, rank: int = 0,
) -> Path:
    """g(r) / z-profile CSVs: `header`, then 'center, value' rows
    (tpu_smc.io.write_profile_csv's schema; no reference counterpart)."""
    p = _fname(d, stem, cfg, rank)
    with open(p, "w") as f:
        f.write(header + "\n")
        for c, v in zip(np.asarray(centers), np.asarray(values)):
            f.write(f"{c:0.6f}, {v:0.9f}\n")
    return p


def write_disorder_profile_csv(d: Path, cfg: SMCConfig, stem: str,
                               axis_name: str, centers, prof) -> Path:
    """Long-format per-realization profile of a wall-disorder run: one
    row per (realization k, bin), header `k, <axis>, value`
    (zprofile_disorder / gr_disorder)."""
    p = _fname(d, stem, cfg)
    prof = np.asarray(prof)
    with open(p, "w") as f:
        f.write(f"k, {axis_name}, value\n")
        for k in range(prof.shape[0]):
            for b in range(prof.shape[1]):
                f.write(f"{k}, {centers[b]:0.6f}, {prof[k, b]:0.9f}\n")
    return p


def write_widom_csv(
    d: Path, cfg: SMCConfig, centers: np.ndarray, mu: np.ndarray,
    err: np.ndarray, counts: np.ndarray, mu_global: float,
    err_global: float, rank: int = 0,
) -> Path:
    """The Widom mu_ex(z) profile, the volume-averaged scalar in a
    comment header (tpu_smc.io.write_widom_csv's schema)."""
    p = _fname(d, "widom", cfg, rank)
    with open(p, "w") as f:
        f.write(f"# mu_ex_global, {mu_global:0.9f}, {err_global:0.9f}\n")
        f.write("z, mu_ex, err, insertions\n")
        for zc, m, e, n in zip(np.asarray(centers), np.asarray(mu),
                               np.asarray(err), np.asarray(counts)):
            f.write(f"{zc:0.6f}, {m:0.9f}, {e:0.9f}, {int(n)}\n")
    return p


def write_info_csv(
    d: Path, cfg: SMCConfig, params: RunParams, results, gamma: float | None = None
) -> Path:
    """info csv, field-for-field with main.c:141-159."""
    gamma = cfg.gamma if gamma is None else gamma
    p = _fname(d, "info", cfg)
    l = cfg.box_l
    lz = cfg.box_lz
    with open(p, "w") as f:
        f.write(f"\nEquilibration steps: {params.eqsteps}")
        f.write(f"\nSimulation steps: {params.maxsteps}")
        f.write(f"\nNumber of data: {params.numdata}")
        f.write(f"\nBox dimensions: {l:0.1f} * {l:0.1f} * {lz:0.1f}")
        f.write(f"\nCells grid: {cfg.ncx} * {cfg.ncx} * {cfg.ncz}")
        f.write(f"\nParticle density: {cfg.rho:0.4f}")
        f.write(
            f"\nAverage interparticle distance: ~{(l * l * lz / cfg.n) ** (1 / 3) / 2:0.3f}"
        )
        f.write(
            "\nWall elements distance / interparticle distance: "
            f"~{(l / cfg.m) / ((l * l * lz / cfg.n) ** (1 / 3)) / 2:0.3f}"
        )
        f.write(f"\nA used: {cfg.proposal_a:0.3f} ({gamma:0.3f} * kT)")
        f.write(f"\nMean energy: {results.mean_energy:f} ± {results.std_energy:f}")
        f.write(
            f"\nMean pressure: {results.mean_pressure:f} ± {results.std_pressure:f}"
        )
        f.write(f"\nApproximate heat capacity: {results.cv:f}")
        f.write(f"\nAverage autocorrelation time: {results.tau:f}")
        f.write(f"\nAverage acceptance ratio: {results.acceptance_ratio:f}")
        f.write(f"\nCutoff used for the local cluster analysis: {cfg.lca_cutoff:f}")
        f.write(
            "\nl2[0] = {:0.11f}\tl2[1] = {:0.11f}\tl2[2] = {:0.11f}\t"
            "l2[3] = {:0.11f}\tl2[4] = {:0.11f}\tl2[5] = {:0.11f}".format(
                *results.l2[:6]
            )
        )
        f.write(
            "\nl3[0] = {:0.11f}\tl3[1] = {:0.11f}\tl3[2] = {:0.11f}\t"
            "l3[3] = {:0.11f}\tl3[4] = {:0.11f}\tl3[5] = {:0.11f}\n".format(
                *results.l3[:6]
            )
        )
    return p


def write_last_state(d: Path, cfg: SMCConfig, r: np.ndarray) -> Path:
    """last_state csv: single row of 3N %0.12f doubles (main.c:163-171)."""
    from . import native

    p = _fname(d, "last_state", cfg)
    with open(p, "wb") as f:
        f.write(native.format_last_state(r))
    return p


def load_last_state(d: Path, cfg: SMCConfig) -> Optional[np.ndarray]:
    """Warm start: read last_state if a run with the same (N, M, rho, T)
    key exists (main.c:98-113). Returns [N, 3] or None."""
    p = _fname(d, "last_state", cfg)
    if not p.exists():
        return None
    vals = [float(v) for v in p.read_text().strip().split(",") if v]
    if len(vals) != 3 * cfg.n:
        raise ValueError(f"{p} holds {len(vals)} values, expected {3 * cfg.n}")
    return np.asarray(vals).reshape(cfg.n, 3)


# ----------------------------------------------------------------------
# Full-state checkpoints (tpu_smc.io's format)
# ----------------------------------------------------------------------

# SMCConfig fields of tpu_smc that only its TPU drivers read (the
# watchdog's call chunking); a checkpoint's values are dropped
TPU_ONLY_FIELDS = ("max_gathers_per_call",)
_LEAVES = ("r", "energy", "key", "sweeps", "accepted", "rbin", "density",
           "mobility")


def atomic_savez(path: Path, **arrays) -> None:
    """Crash-safe np.savez with one-generation rotation: write a temp
    file beside `path`, move an existing checkpoint to `<stem>.prev.npz`,
    then rename the temp into place, so a complete checkpoint exists at
    every instant (tpu_smc.io.atomic_savez)."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    if path.exists():
        os.replace(path, path.with_name(path.stem + ".prev.npz"))
    os.replace(tmp, path)


def save_checkpoint(path: str | Path, state: ChainState, cfg: SMCConfig,
                    chain_axis: bool = True,
                    stream_seed: int | None = None) -> Path:
    """Persist the complete state and config; returns the path written
    (".npz" appended when missing, as np.savez would do silently).

    chain_axis=False writes a one-chain state without its chain axis,
    tpu_smc's layout of a single-chain run. Counters are written as the
    port holds them (int64), the key words as uint32. stream_seed, the
    run seed of the per-sweep streams, rides along as `stream_seed` (a
    field tpu_smc's loader ignores) so that a resumed run draws the
    streams the uninterrupted one would have."""
    if not chain_axis and state.n_chains != 1:
        raise ValueError(f"chain_axis=False needs one chain, got "
                         f"{state.n_chains}")
    arrays = {}
    for name in _LEAVES:
        a = getattr(state, name).detach().cpu().numpy()
        arrays[name] = a if chain_axis else a[0]
    arrays["key"] = arrays["key"].astype(np.uint32)
    return save_npz_state(path, cfg, arrays, stream_seed)


def save_npz_state(path: str | Path, cfg: SMCConfig, arrays: dict,
                   stream_seed: int | None = None, **marks) -> Path:
    """Write numpy leaves, the config as JSON (`__config__`), the run
    seed of the per-sweep streams (`stream_seed`, when given) and any
    marker arrays (tpu_smc's `__gcmc__`, `__npt__`, `__gibbs__`) to
    `path` (".npz" appended when missing) with atomic_savez."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = dict(arrays)
    if stream_seed is not None:
        arrays["stream_seed"] = np.asarray(stream_seed, np.int64)
    cfg_json = json.dumps(dataclasses.asdict(cfg))
    atomic_savez(path, __config__=np.frombuffer(cfg_json.encode(),
                                                dtype=np.uint8),
                 **{k: np.asarray(v) for k, v in marks.items()}, **arrays)
    return path


def checkpoint_config(data, path) -> tuple[SMCConfig, int | None]:
    """(config, stream_seed or None) of a loaded checkpoint of either
    package: tpu_smc's TPU-only config fields are dropped with a note;
    any other unknown field raises."""
    fields = json.loads(bytes(data["__config__"]).decode())
    seed = (int(data["stream_seed"]) if "stream_seed" in data.files
            else None)
    for f in TPU_ONLY_FIELDS:
        if f in fields:
            print(f"Note: checkpoint field {f} = {fields.pop(f)} is "
                  "tpu_smc's TPU call chunking; dropped.")
    unknown = set(fields) - {f.name for f in dataclasses.fields(SMCConfig)}
    if unknown:
        raise ValueError(f"{path}: unknown config fields {sorted(unknown)}")
    return SMCConfig(**fields), seed


class Checkpoint(NamedTuple):
    state: ChainState          # with a chain axis
    cfg: SMCConfig
    batched: bool              # False: a single chain's checkpoint
    stream_seed: int | None    # None in tpu_smc's checkpoints


def load_checkpoint(path: str | Path, device="cuda") -> Checkpoint:
    """Read a checkpoint of either package onto `device`. A single
    chain's leaves (no chain axis) gain one; uint32/int32 counters of
    tpu_smc load as int64 (state.state_from_arrays, the carry-across of
    from_jax_state). tpu_smc's TPU-only config fields are dropped with
    a note; any other unknown field raises."""
    with np.load(path) as data:
        arrays = {name: data[name] for name in _LEAVES}
        cfg, seed = checkpoint_config(data, path)
    batched = np.ndim(arrays["r"]) == 3
    if not batched:
        arrays = {k: np.asarray(v)[None] for k, v in arrays.items()}
    return Checkpoint(state_from_arrays(arrays, cfg, device), cfg, batched,
                      seed)
