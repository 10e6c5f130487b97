"""Tracing and profiling (counterpart of tpu_smc.profiling).

The reference's instrumentation is clock() around thermalization and the
main loop plus the self-reported "s per million sweeps" metric
(SMC.c:38-39,111,120-132,198-200). Here:

  * PhaseTimer — wall-clock phase accounting with the reference's
    "seconds per million sweeps" formatting;
  * ThroughputMeter — running aggregate sweeps/s across chains;
  * trace() — a context manager around torch.profiler.profile that
    writes a Chrome trace and a key_averages() table, and refuses a CUDA
    trace in which CUPTI recorded no device event;
  * device_timeline / timeline_summary — the device's busy intervals of
    such a trace: idle share, the operations that took most time and the
    longest idle gaps with the host ranges open during them;
  * estimate_completion — the reference's thermalization-extrapolated ETA
    (SMC.c:131);
  * the z-skip cost models, for the port's sweep kernels
    (kernels/csrc/sweep.cu: one CTA per chain, 128-row blocks, each pass
    querying the mover's own z).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from .kernels.sweep import ROW_BLOCK, padded_rows

# trace categories of device work: kernels and copies / fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class PhaseTimer:
    """Named wall-clock phases (thermalization / production / post)."""

    phases: Dict[str, float] = field(default_factory=dict)
    _start: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def seconds(self, name: str) -> float:
        return self.phases.get(name, 0.0)

    def report(self, sweeps: Optional[Dict[str, int]] = None) -> str:
        """Per-phase report; with sweep counts, adds the reference's
        's per million' metric (SMC.c:200)."""
        lines = []
        for name, secs in self.phases.items():
            line = f"{name}: {secs:0.1f} s"
            if sweeps and sweeps.get(name):
                line += f" ({secs * 1e6 / sweeps[name]:0.1f} per million)"
            lines.append(line)
        return "\n".join(lines)


class ThroughputMeter:
    """Aggregate sweeps/s across all chains, windowed."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.chain_sweeps = 0

    def add(self, sweeps: int, chains: int = 1) -> None:
        self.chain_sweeps += sweeps * chains

    @property
    def sweeps_per_second(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.chain_sweeps / dt if dt > 0 else float("nan")


def estimate_completion(therm_seconds: float, eqsteps: int, maxsteps: int,
                        margin: float = 1.03) -> float:
    """Expected production minutes, extrapolated from thermalization
    exactly like the reference (SMC.c:131)."""
    if eqsteps == 0:
        return float("nan")
    return margin * therm_seconds * maxsteps / eqsteps / 60.0


# ----------------------------------------------------------------------
# Device trace
# ----------------------------------------------------------------------

@dataclass
class Trace:
    """What trace() wrote, filled in when its block ends: the Chrome
    trace (`path`), the key_averages() table (`table_path`) and the
    number of device events in the trace."""
    path: Optional[Path] = None
    table_path: Optional[Path] = None
    device_events: int = 0


@contextlib.contextmanager
def trace(log_dir, device="cuda") -> Iterator[Trace]:
    """Profile the block with torch.profiler: CPU and CUDA activities on a
    CUDA device, CPU only when `device` is the CPU. On a clean exit it
    writes `trace.json` (Chrome trace; chrome://tracing or perfetto) and
    `key_averages.txt` into log_dir. A CUDA trace in which CUPTI recorded
    no device event raises RuntimeError and leaves no trace behind."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    rec = Trace()
    with profile(activities=acts) as prof:
        yield rec
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    rec.device_events = sum(1 for e in prof.events()
                            if e.device_type != DeviceType.CPU)
    if dev.type == "cuda" and rec.device_events == 0:
        raise RuntimeError(
            "torch.profiler recorded no device event (CUPTI gave none): "
            "no device trace was written")
    rec.path = out / "trace.json"
    prof.export_chrome_trace(str(rec.path))
    sort = "self_cuda_time_total" if dev.type == "cuda" else \
        "self_cpu_time_total"
    rec.table_path = out / "key_averages.txt"
    rec.table_path.write_text(
        prof.key_averages().table(sort_by=sort, row_limit=40))


def device_timeline(trace_path) -> dict:
    """The events of a Chrome trace written by trace(): `device` (kernels,
    copies and fills), `host` (CPU operators and user annotations) and
    `window` (first start, last end of any complete event), times in us
    as the trace gives them."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, host, lo, hi = [], [], float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        lo, hi = min(lo, ts), max(hi, ts + dur)
        rec = (e.get("name", ""), ts, dur)
        if e.get("cat") in DEVICE_CATS:
            dev.append(rec)
        elif e.get("cat") in ("cpu_op", "user_annotation",
                              "python_function"):
            host.append(rec)
    return {"device": dev, "host": host, "window": (lo, hi)}


def timeline_summary(device, host, window, top: int = 5) -> dict:
    """Device idle share of `window` (1 - the union of the device
    intervals over its length), the `top` device operations by summed
    time, and the `top` longest idle gaps between device intervals, each
    with the host range open during it: the innermost host event open at
    the gap's midpoint (else the one overlapping the gap most).
    device, host: (name, ts, dur)."""
    lo, hi = window
    span = hi - lo
    ivs = sorted((ts, ts + dur) for _, ts, dur in device)
    busy, gaps, cur = 0.0, [], None
    for s, e in ivs:
        if cur is None:
            if s > lo:
                gaps.append((lo, s))
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
        if hi > cur[1]:
            gaps.append((cur[1], hi))
    else:
        gaps.append((lo, hi))
    by_name: Dict[str, list] = {}
    for name, _, dur in device:
        t = by_name.setdefault(name, [0.0, 0])
        t[0] += dur
        t[1] += 1
    ops = sorted(((n, t[0], t[1]) for n, t in by_name.items()),
                 key=lambda v: -v[1])[:top]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    out_gaps = []
    for g0, g1 in longest:
        mid = 0.5 * (g0 + g1)
        cover = [h for h in host if h[1] <= mid <= h[1] + h[2]]
        if cover:
            best = min(cover, key=lambda h: h[2])
        else:
            ov = [(min(g1, ts + dur) - max(g0, ts), (name, ts, dur))
                  for name, ts, dur in host]
            ov = [v for v in ov if v[0] > 0]
            best = max(ov, key=lambda v: v[0])[1] if ov else None
        out_gaps.append({"start_us": g0, "us": g1 - g0,
                         "host": None if best is None else best[0],
                         "host_us": None if best is None else best[2]})
    return {"window_us": span, "busy_us": busy,
            "idle_share": 1.0 - busy / span if span > 0 else float("nan"),
            "top_ops": [{"name": n, "us": t, "count": c} for n, t, c in ops],
            "gaps": out_gaps}


# ----------------------------------------------------------------------
# z-skip cost models
# ----------------------------------------------------------------------

def zskip_processed_fraction_band(
    r_pre, r_post, cfg, row_block_rows: int = 128,
) -> tuple[float, float]:
    """The IDEAL per-chain band (tpu_smc.profiling's, unchanged): the
    (lo, hi) fraction of j-blocks a z-skip pass processes per move,
    reconstructed from the positions at a sort point (`r_pre`, tight
    per-block bounds) and at the end of one sort cadence (`r_post`).

      lo — sort-point positions against the sort-point (tight) bounds;
      hi — end-of-chunk positions against bounds widened by the whole
           chunk's drift (union of start/end per-block ranges).

    Each particle queries its own z +- lj_cutoff against its own chain's
    bounds over blocks of `row_block_rows` (shrunk by 8 until it divides
    N) with the contiguous [b_lo, b_hi) envelope.

    r_pre, r_post: [C, N, 3] position arrays (host or device).
    Returns (frac_lo, frac_hi) averaged over chains and particles.
    """
    rp = np.asarray(r_pre, np.float64)
    rq = np.asarray(r_post, np.float64)
    c, n = rp.shape[0], rp.shape[1]
    rb = min(n, max(8, (row_block_rows // 8) * 8))
    while n % rb != 0:
        rb -= 8
    nb = n // rb
    cut = float(cfg.lj_cutoff)
    order = np.argsort(rp[:, :, 2], axis=1)
    z0 = np.take_along_axis(rp[:, :, 2], order, axis=1)   # [C, N] sorted
    z1 = np.take_along_axis(rq[:, :, 2], order, axis=1)   # same row order
    b0 = z0.reshape(c, nb, rb)
    b1 = z1.reshape(c, nb, rb)
    bmin0, bmax0 = b0.min(axis=2), b0.max(axis=2)
    bmin1 = np.minimum(bmin0, b1.min(axis=2))              # live bounds
    bmax1 = np.maximum(bmax0, b1.max(axis=2))              # only widen

    def mean_span(z, bmin, bmax):
        # contiguous envelope [b_lo, b_hi) over every block whose range
        # can overlap [z - cut, z + cut]; chain-chunked to bound the
        # [C, N, nb] mask
        tot = 0.0
        step = max(1, int(2 ** 24 // max(1, n * nb)))
        for s in range(0, c, step):
            e = min(c, s + step)
            need = ((bmin[s:e, None, :] <= (z[s:e] + cut)[:, :, None])
                    & (bmax[s:e, None, :] >= (z[s:e] - cut)[:, :, None]))
            any_ = need.any(axis=2)
            first = need.argmax(axis=2)
            last = nb - need[:, :, ::-1].argmax(axis=2)
            span = np.where(any_, last - first, 0)
            tot += float(span.sum())
        return tot / (c * n * nb)

    lo = mean_span(z0, bmin0, bmax0)
    hi = mean_span(z1, bmin1, bmax1)
    return lo, hi


def _kernel_blocks(z_sorted: np.ndarray, n_pad: int):
    """Per-chain block bounds [C, nb] of z-sorted rows [C, N] laid out as
    the kernel's planes: blocks of ROW_BLOCK rows over n_pad rows, pads
    parked (never in a bound; a block of pads only has empty bounds)."""
    c, n = z_sorted.shape
    nb = -(-n_pad // ROW_BLOCK)
    zp = np.full((c, nb * ROW_BLOCK), np.nan)
    zp[:, :n] = z_sorted
    zp = zp.reshape(c, nb, ROW_BLOCK)
    real = ~np.isnan(zp)
    bmin = np.where(real, zp, np.inf).min(axis=2)
    bmax = np.where(real, zp, -np.inf).max(axis=2)
    return bmin, bmax


def _envelope_rows(bmin, bmax, qlo, qhi, n_pad: int) -> np.ndarray:
    """Rows the kernel visits per query: the contiguous block envelope
    [b_lo, b_hi) of one chain's bounds (bmin, bmax [C, nb]) that can
    reach [qlo, qhi] ([C, Q] each), as `rows_in` counts them (the last
    block clamped to n_pad). Returns [C, Q]."""
    c, nb = bmin.shape
    out = np.zeros(qlo.shape)
    step = max(1, int(2 ** 24 // max(1, qlo.shape[1] * nb)))
    for s in range(0, c, step):
        e = min(c, s + step)
        need = ((bmin[s:e, None, :] <= qhi[s:e, :, None])
                & (bmax[s:e, None, :] >= qlo[s:e, :, None]))
        any_ = need.any(axis=2)
        first = need.argmax(axis=2)
        last = nb - need[:, :, ::-1].argmax(axis=2)
        rows = np.minimum(last * ROW_BLOCK, n_pad) - first * ROW_BLOCK
        out[s:e] = np.where(any_, rows, 0)
    return out


def _zcut(cfg) -> float:
    """The z window's half-width of a pass (kernels/sweep.py: the cutoff
    widened by a relative 1e-5)."""
    return float(cfg.lj_cutoff * (1.0 + 1e-5))


def zskip_kernel_fraction_band(r_pre, r_post, cfg) -> tuple[float, float]:
    """The band of the fraction of the n_pad plane rows that one pair pass
    of the port's z-skip kernels visits per move, over one sort cadence
    that starts with the z-sort at `r_pre` and ends at `r_post` ([C, N, 3]
    each, particle order; the kernel's visited rows per pass are
    diag["visited"] / (2 S N) over S sweeps).

    It models kernels/csrc/sweep.cu (`sweep_chain`, K2; K3 and the plain
    version in kernels/sweep.py share its semantics):
      * one CTA per chain: each chain's rows, sorted by z at the sort
        point, carry their OWN per-block bounds, pooled with no other
        chain (tpu_smc's chain tiles are gone: c_tile = 1);
      * ROW_BLOCK = 128 rows per block over n_pad = N rounded up to 8;
        pads park at 1e15 outside every bound, and `rows_in` clamps the
        last block to n_pad;
      * the bounds are recomputed exactly at every sweep start ("exact
        bounds of the real rows at sweep start") and only widen within a
        sweep, by each proposal's z;
      * both passes query the MOVER's own z +- zcut (pass 1 its current
        z, pass 2 its proposal's; `envelope` / `_envelope`), zcut =
        lj_cutoff (1 + 1e-5), over the contiguous envelope [b_lo, b_hi).

    lo: sort-point positions against the sort-point bounds, each pass at
    the particle's own z (the cadence's first sweep without proposals'
    widening). hi: bounds widened to the union of the sort-point and
    end-of-cadence block ranges (the row order goes stale as particles
    drift), each pass querying the particle's whole swept range
    [min(z0, z1) - zcut, max(z0, z1) + zcut].
    Returns (frac_lo, frac_hi), mean rows per pass over n_pad."""
    rp = np.asarray(r_pre, np.float64)
    rq = np.asarray(r_post, np.float64)
    n = rp.shape[1]
    n_pad = padded_rows(n)
    zc = _zcut(cfg)
    order = np.argsort(rp[:, :, 2], axis=1, kind="stable")
    z0 = np.take_along_axis(rp[:, :, 2], order, axis=1)
    z1 = np.take_along_axis(rq[:, :, 2], order, axis=1)
    bmin0, bmax0 = _kernel_blocks(z0, n_pad)
    bmin1, bmax1 = _kernel_blocks(z1, n_pad)
    bmin1, bmax1 = np.minimum(bmin0, bmin1), np.maximum(bmax0, bmax1)
    lo = _envelope_rows(bmin0, bmax0, z0 - zc, z0 + zc, n_pad).mean()
    hi = _envelope_rows(bmin1, bmax1, np.minimum(z0, z1) - zc,
                        np.maximum(z0, z1) + zc, n_pad).mean()
    return float(lo) / n_pad, float(hi) / n_pad


def zskip_inplane_headroom(r, cfg, sample_i: int = 256,
                           seed: int = 0) -> dict:
    """What an in-plane (x/y) skip could still save on top of the port's
    z-block envelope, at a sort point (`r` [C, N, 3]).

    Per move (sampled particles; the model of zskip_kernel_fraction_band
    at the sort point: the particle's own chain bounds, its own z +-
    zcut, 128-row blocks over n_pad):

      admitted_rows — rows the kernel visits per pass;
      z_rows        — rows with |dz| < cutoff (a perfect row-granular
                      per-chain z scheme's floor);
      box_rows      — rows also within the min-image x/y cutoff box
                      (a perfect in-plane refinement at row granularity);
      sphere_rows   — rows inside the spherical cutoff (the physics).

    The mover's own row counts in every class (the kernel visits it,
    parked). Returns the mean counts and their ratios to admitted_rows:
    optimistic ceilings of what a finer scheme could reach."""
    rr = np.asarray(r, np.float64)
    c, n = rr.shape[0], rr.shape[1]
    n_pad = padded_rows(n)
    cut = float(cfg.lj_cutoff)
    box_l = float(cfg.box_l)
    order = np.argsort(rr[:, :, 2], axis=1, kind="stable")
    zs = np.take_along_axis(rr[:, :, 2], order, axis=1)
    xs = np.take_along_axis(rr[:, :, 0], order, axis=1)
    ys = np.take_along_axis(rr[:, :, 1], order, axis=1)
    rng = np.random.default_rng(seed)
    k = min(sample_i, n)
    idx = np.sort(rng.choice(n, size=k, replace=False))
    bmin, bmax = _kernel_blocks(zs, n_pad)
    zc = _zcut(cfg)
    q = zs[:, idx]
    adm = float(_envelope_rows(bmin, bmax, q - zc, q + zc, n_pad).mean())
    z_rows = box_rows = sph_rows = 0.0
    for ci in range(c):
        dz = np.abs(zs[ci][idx, None] - zs[ci][None, :])   # [k, N]
        dx = xs[ci][idx, None] - xs[ci][None, :]
        dy = ys[ci][idx, None] - ys[ci][None, :]
        dx -= box_l * np.round(dx / box_l)
        dy -= box_l * np.round(dy / box_l)
        zin = dz < cut
        boxin = zin & (np.abs(dx) < cut) & (np.abs(dy) < cut)
        z_rows += float(zin.sum(axis=1).mean())
        box_rows += float(boxin.sum(axis=1).mean())
        sph_rows += float(((dx * dx + dy * dy + dz * dz) < cut * cut)
                          .sum(axis=1).mean())
    z_rows /= c
    box_rows /= c
    sph_rows /= c
    return {
        "admitted_rows": adm,
        "z_rows": z_rows,
        "box_rows": box_rows,
        "sphere_rows": sph_rows,
        "z_over_admitted": z_rows / adm,
        "box_over_admitted": box_rows / adm,
        "sphere_over_admitted": sph_rows / adm,
        "sampled_particles": int(k),
        "row_block": ROW_BLOCK,
        "n_pad": int(n_pad),
    }


def zskip_cadence_rows(state, w, cfg, a: float, n_sweeps: int | None = None,
                       seed: int = 0) -> dict:
    """Run one sort cadence of the z-skip engine as
    ensemble.ensemble_sweeps_zsorted runs it (rows z-sorted per chain,
    one resident launch of `n_sweeps`, default ensemble.zsort_cadence(N))
    with the visited-row count on: K2 on a CUDA state, its plain version
    on the CPU. Returns r_pre / r_post (host [C, N, 3] in row order, the
    positions at the sort point and after the cadence), rows_per_pass [C]
    (diag["visited"] / (2 S N)) and n_pad: the inputs and the measurement
    that zskip_kernel_fraction_band brackets."""
    import torch

    from .ensemble import (_kernel_inputs, _per_sweep_randomness,
                           xsort_perm, zsort_cadence)
    from .kernels import sweep as ks

    n = cfg.n
    s = int(n_sweeps or zsort_cadence(n))
    words, offsets = _per_sweep_randomness(state, cfg, seed, s)
    x, y, z, e, wa, wb = _kernel_inputs(state, w, cfg)
    perm = xsort_perm(x, z, n, 0)
    x, y, z = (torch.cat([torch.take_along_dim(p[:n], perm, dim=0), p[n:]])
               for p in (x, y, z))
    r_pre = ks.from_planes(x, y, z, cfg).double().cpu().numpy()
    diag: dict = {}
    x, y, z, *_ = ks.sweep_block(x, y, z, e, wa, wb, offsets, words, cfg, s,
                                 a, zskip=True, diag=diag)
    r_post = ks.from_planes(x, y, z, cfg).double().cpu().numpy()
    rows = diag["visited"].double().cpu().numpy() / (2.0 * s * n)
    return {"r_pre": r_pre, "r_post": r_post, "rows_per_pass": rows,
            "n_pad": x.shape[0], "sweeps": s}
