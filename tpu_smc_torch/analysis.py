"""Offline analysis & visualization — the plotting.jl replacement
(counterpart of tpu_smc.analysis, on the port's CSVs, which are
byte-compatible with tpu_smc's).

The reference ships a 331-line Julia script (plotting.jl) that reads the
run CSVs back and renders: particle scatter with wall planes (:17-37),
temporal overlays (:39-56), ACF + spectrum (:58-87), density/mobility
stacked into 7 z-bands with contour grids (:123-201), wall-potential maps
(:203-234), E/P/acceptance traces (:247-264) and volume animation
(:273-331). This module reproduces that capability in Python on our (and the
reference's — identical schemas) output files.

Usage:
    python -m tpu_smc_torch.analysis Data/data_N108_M3_r0.0005_T1.10 \
        [--out plots/] [--rank R] [--box L LZ] [--animate] [--device cuda|cpu]

Matplotlib renders PNGs when present; otherwise the computed summaries
(and, with --box, the S(k) panel's numbers) are saved as .npz so the
analysis capability works headless. The S(k) panel runs
observables.structure_factor on --device (default cuda, like every entry
point of the port), batched over the snapshots.
"""

from __future__ import annotations

import argparse
import math
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    HAVE_MPL = True
except Exception:  # pragma: no cover
    HAVE_MPL = False


@dataclass
class RunData:
    """Everything a run directory contains (schemas in SURVEY §5.5)."""

    run_dir: Path
    key: str                      # N..._M..._r..._T...
    n: int
    m: int
    rho: float
    temperature: float
    positions: np.ndarray         # [snapshots, N, 3]
    energy: np.ndarray            # [gathers]
    pressure: np.ndarray
    accepted: np.ndarray
    local: np.ndarray             # [ncx, ncx, ncz, 2] cumulative (n, mu)
    local_dims: tuple
    acf: np.ndarray
    wall: np.ndarray              # [M*M, 4] nx, ny, x0, ymin
    info: str


def load_run(run_dir: str | Path, rank: int = 0) -> RunData:
    run_dir = Path(run_dir)
    m = re.search(r"N(\d+)_M(\d+)_r([\d.]+)_T([\d.]+)", run_dir.name)
    if not m:
        raise ValueError(f"not a run directory: {run_dir}")
    n, mm = int(m.group(1)), int(m.group(2))
    rho, t = float(m.group(3)), float(m.group(4))
    key = f"N{n}_M{mm}_r{m.group(3)}_T{m.group(4)}"

    def rd(stem, ranked=True):
        suffix = f"_rank{rank}" if ranked else ""
        return run_dir / f"{stem}_{key}{suffix}.csv"

    # The standard-run artifacts are OPTIONAL: ladder (--temperatures)
    # and umbrella (--umbrella) run dirs carry their own CSVs instead,
    # and render_all skips the panels whose data is absent.
    pos_rows = []
    if rd("positions").exists():
        with open(rd("positions")) as f:
            next(f)
            for line in f:
                vals = [float(v) for v in line.strip().split(",") if v]
                if len(vals) == 3 * n:
                    pos_rows.append(vals)
    positions = np.asarray(pos_rows).reshape(-1, n, 3)

    data = (np.atleast_2d(np.genfromtxt(rd("data"), delimiter=",",
                                        skip_header=1))
            if rd("data").exists() else np.zeros((0, 3)))

    if rd("local").exists():
        local_raw = np.genfromtxt(rd("local"), delimiter=",",
                                  skip_header=1)
        ncx = int(local_raw[:, 0].max()) + 1
        ncz = int(local_raw[:, 2].max()) + 1
        local = np.zeros((ncx, ncx, ncz, 2))
        i, j, k = (local_raw[:, 0].astype(int),
                   local_raw[:, 1].astype(int),
                   local_raw[:, 2].astype(int))
        local[i, j, k, 0] = local_raw[:, 3]
        local[i, j, k, 1] = local_raw[:, 4]
    else:
        ncx = ncz = 1
        local = np.zeros((1, 1, 1, 2))

    acf_path = rd("autocorrelation")
    acf = (np.genfromtxt(acf_path, skip_header=1)
           if acf_path.exists() else np.zeros(0))

    wall_path = run_dir / f"wall_{key}.csv"
    wall = (np.genfromtxt(wall_path, delimiter=",", skip_header=1)
            if wall_path.exists() else np.zeros((0, 4)))

    info_path = run_dir / f"info_{key}.csv"
    info = info_path.read_text() if info_path.exists() else ""

    return RunData(
        run_dir=run_dir, key=key, n=n, m=mm, rho=rho, temperature=t,
        positions=positions,
        energy=data[:, 0], pressure=data[:, 1], accepted=data[:, 2],
        local=local, local_dims=(ncx, ncx, ncz),
        acf=np.atleast_1d(acf), wall=np.atleast_2d(wall), info=info,
    )


def z_band_maps(run: RunData, bands: int = 7) -> dict[str, np.ndarray]:
    """Density & mobility stacked into z-bands (plotting.jl:123-166):
    collapse the voxel grid into `bands` slabs along z, giving [bands,
    ncx, ncx] contour-ready maps."""
    ncx, _, ncz = run.local_dims
    edges = np.linspace(0, ncz, bands + 1).astype(int)
    out = {}
    for name, ch in (("density", 0), ("mobility", 1)):
        maps = np.stack([
            run.local[:, :, a:b, ch].sum(axis=2) for a, b in
            zip(edges[:-1], edges[1:])
        ])
        out[name] = maps
    return out


def spectrum(run: RunData) -> tuple[np.ndarray, np.ndarray]:
    """Power spectrum of the de-meaned energy trace (plotting.jl:58-87)."""
    z = run.energy - run.energy.mean()
    f = np.fft.rfft(z)
    return np.fft.rfftfreq(len(z)), np.abs(f) ** 2


def acf_check(run: RunData, k_max: int = 200) -> np.ndarray:
    """Recompute the ACF from the energy trace as a cross-check of the
    stored autocorrelation file (plotting.jl:58-87 does the same)."""
    z = run.energy - run.energy.mean()
    n = len(z)
    f = np.fft.rfft(z, n=2 * n)
    ch = np.fft.irfft(f * np.conj(f))[: min(k_max, n)]
    return ch / ch[0]


# ----------------------------------------------------------------------
# Rendering
# ----------------------------------------------------------------------

def load_local_windows(run: RunData, rank: int = 0) -> np.ndarray:
    """Windowed density deltas from local_temp (one block appended per
    STORAGE_TIME gather, SMC.c:171-181). Returns [W, ncx, ncx, ncz, 2]
    (possibly W=0 when the run wrote no windows)."""
    p = run.run_dir / f"local_temp_{run.key}_rank{rank}.csv"
    if not p.exists():
        return np.zeros((0,) + run.local_dims + (2,))
    raw = np.genfromtxt(p, delimiter=",", skip_header=1)
    raw = np.atleast_2d(raw)
    ncx, _, ncz = run.local_dims
    block = ncx * ncx * ncz
    if raw.size == 0 or raw.shape[0] % block:
        return np.zeros((0, ncx, ncx, ncz, 2))
    w = raw.shape[0] // block
    out = np.zeros((w, ncx, ncx, ncz, 2))
    for wi in range(w):
        b = raw[wi * block:(wi + 1) * block]
        i, j, k = (b[:, 0].astype(int), b[:, 1].astype(int),
                   b[:, 2].astype(int))
        out[wi, i, j, k, 0] = b[:, 3]
        out[wi, i, j, k, 1] = b[:, 4]
    return out


def _composite(vol: np.ndarray, axis: int, opacity: float = 4.0,
               vmax: float | None = None, normalize: bool = True):
    """Front-to-back alpha compositing of a density volume along `axis` —
    an emission-absorption volume render (the capability of plotting.jl's
    Makie `volume`, :273-331) done in numpy. Returns (rgb image, alpha).

    `vmax` fixes the density scale across calls (animation frames must
    share one exposure or density evolution is invisible); `normalize`
    controls the final brightness stretch (off for animations, same
    reason)."""
    v = np.moveaxis(vol, axis, 0).astype(float)
    if vmax is None:
        vmax = v.max()
    if vmax <= 0:
        shape = v.shape[1:]
        return np.zeros(shape + (3,)), np.zeros(shape)
    v = v / vmax
    cmap = plt.cm.inferno if HAVE_MPL else None
    rgb = np.zeros(v.shape[1:] + (3,))
    transmit = np.ones(v.shape[1:])
    for slab in v:  # front-to-back through the volume
        a = 1.0 - np.exp(-opacity * slab / len(v))
        col = cmap(slab)[..., :3] if cmap is not None else slab[..., None]
        rgb += (transmit * a)[..., None] * col
        transmit *= 1.0 - a
    if normalize:
        rgb = rgb / max(float(rgb.max()), 1e-9)  # normalize exposure
    return rgb, 1.0 - transmit


def render_volume(run: RunData, out_dir: str | Path,
                  animate: bool = True) -> list[Path]:
    """Volumetric rendering of the voxel density field (plotting.jl's
    Makie volume scene + animation, :273-331):

      * volume_<key>.png — alpha-composited projections of the cumulative
        density along x, y, z plus a translucent 3-D voxel point cloud;
      * volume_anim_<key>.gif — the windowed density (local_temp deltas)
        composited per window, animated over simulation time (when the
        run wrote >= 2 windows).
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written: list[Path] = []
    density = run.local[..., 0]
    if not HAVE_MPL or density.max() <= 0:  # pragma: no cover
        return written

    fig = plt.figure(figsize=(13, 3.6))
    for ai, axis_name in enumerate("xyz"):
        ax = fig.add_subplot(1, 4, ai + 1)
        rgb, _ = _composite(density, ai)
        ax.imshow(np.clip(rgb.swapaxes(0, 1), 0, 1), origin="lower")
        ax.set_title(f"density volume along {axis_name}", fontsize=9)
        ax.set_xticks([])
        ax.set_yticks([])
    ax = fig.add_subplot(1, 4, 4, projection="3d")
    ncx, _, ncz = run.local_dims
    thresh = np.quantile(density[density > 0], 0.5) if (density > 0).any() else 0
    ii, jj, kk = np.nonzero(density > thresh)
    d = density[ii, jj, kk]
    ax.scatter(ii, jj, kk, c=d, cmap="inferno", s=3,
               alpha=0.25, linewidths=0)
    ax.set_title("voxel cloud", fontsize=9)
    fig.suptitle(f"density volume {run.key}")
    p = out / f"volume_{run.key}.png"
    fig.savefig(p, dpi=120)
    plt.close(fig)
    written.append(p)

    if animate:
        windows = load_local_windows(run)
        if windows.shape[0] >= 2:
            from matplotlib import animation as mpl_anim

            fig, ax = plt.subplots(figsize=(4.5, 4.5))
            vmax = max(windows[..., 0].max(), 1)
            im = ax.imshow(np.zeros((ncx, ncz, 3)), origin="lower",
                           aspect="auto")
            ax.set_xticks([])
            ax.set_yticks([])

            def update(wi):
                # fixed vmax + no per-frame normalization: frames share
                # one exposure so density evolution is visible
                rgb, _ = _composite(windows[wi, ..., 0], 1, opacity=8.0,
                                    vmax=float(vmax), normalize=False)
                rgb = rgb * 3.0  # fixed brightness boost, same all frames
                im.set_data(np.clip(rgb.swapaxes(0, 1), 0, 1))
                ax.set_title(f"density window {wi} / {windows.shape[0]}",
                             fontsize=9)
                return (im,)

            ani = mpl_anim.FuncAnimation(
                fig, update, frames=windows.shape[0], interval=300)
            p = out / f"volume_anim_{run.key}.gif"
            ani.save(p, writer=mpl_anim.PillowWriter(fps=3))
            plt.close(fig)
            written.append(p)
    return written


_VOLUME_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>tpu_smc volume {key}</title>
<style>
 body {{ font-family: system-ui, sans-serif; background: #111; color: #ddd;
        display: flex; flex-direction: column; align-items: center; }}
 canvas {{ image-rendering: pixelated; border: 1px solid #444;
          margin: 10px; }}
 .row {{ margin: 4px; }} label {{ margin: 0 8px; }}
 input[type=range] {{ width: 260px; vertical-align: middle; }}
 select, button {{ background: #222; color: #ddd; border: 1px solid #555; }}
</style></head><body>
<h3>voxel density volume — {key}</h3>
<div class="row">
 axis <select id="axis"><option>x</option><option>y</option>
      <option selected>z</option></select>
 <label>mode <select id="mode"><option selected>slice</option>
      <option>MIP</option></select></label>
 <label>slice <input id="slice" type="range" min="0" value="0">
      <span id="sliceval"></span></label>
</div>
<div class="row" id="timerow" style="display:none">
 window <input id="time" type="range" min="0" value="0">
 <span id="timeval"></span>
 <button id="play">play</button>
</div>
<canvas id="cv" width="512" height="512"></canvas>
<div class="row" id="info"></div>
<script>
const DIMS = {dims};          // [ncx, ncy, ncz]
const CUM = {cum};            // flat, C order, cumulative density
const WINDOWS = {windows};    // [] or flat [W * ncx * ncy * ncz]
const NW = {n_windows};
// inferno-ish colormap
function cmap(t) {{
  t = Math.max(0, Math.min(1, t));
  const r = Math.min(255, 255 * Math.pow(t, 0.55) * 1.3);
  const g = 255 * Math.pow(t, 1.6) * 0.9;
  const b = 255 * (t < 0.5 ? 0.4 + 1.2 * t * (1 - t) * 2 : 1.6 * (1 - t));
  return [r, g, b];
}}
const cv = document.getElementById("cv"), ctx = cv.getContext("2d");
const axisEl = document.getElementById("axis"),
      modeEl = document.getElementById("mode"),
      sliceEl = document.getElementById("slice"),
      timeEl = document.getElementById("time");
if (NW > 1) document.getElementById("timerow").style.display = "";
timeEl.max = Math.max(0, NW - 1);
function vol() {{
  if (NW > 1) {{
    const sz = DIMS[0] * DIMS[1] * DIMS[2], w = +timeEl.value;
    return WINDOWS.slice(w * sz, (w + 1) * sz);
  }}
  return CUM;
}}
function at(v, i, j, k) {{
  return v[(i * DIMS[1] + j) * DIMS[2] + k];
}}
// ONE fixed exposure across time windows (per-frame auto-scaling would
// hide the density evolution the time axis exists to show — same rule
// as the GIF renderer, analysis.py render_volume)
let VMAX = 1e-12;
for (const x of (NW > 1 ? WINDOWS : CUM)) if (x > VMAX) VMAX = x;
function draw() {{
  const ax = axisEl.selectedIndex, v = vol();
  const other = [0, 1, 2].filter(a => a !== ax);
  sliceEl.max = DIMS[ax] - 1;
  const s = Math.min(+sliceEl.value, DIMS[ax] - 1);
  document.getElementById("sliceval").textContent = s;
  document.getElementById("timeval").textContent =
      NW > 1 ? (+timeEl.value + 1) + "/" + NW : "";
  const W = DIMS[other[0]], H = DIMS[other[1]];
  const vmax = VMAX;
  const img = ctx.createImageData(W, H);
  for (let a = 0; a < W; a++) for (let b = 0; b < H; b++) {{
    let val = 0;
    const idx = [0, 0, 0];
    idx[other[0]] = a; idx[other[1]] = b;
    if (modeEl.selectedIndex === 0) {{        // slice
      idx[ax] = s; val = at(v, idx[0], idx[1], idx[2]);
    }} else {{                                 // MIP along axis
      for (let c = 0; c < DIMS[ax]; c++) {{
        idx[ax] = c;
        val = Math.max(val, at(v, idx[0], idx[1], idx[2]));
      }}
    }}
    const [r, g, bl] = cmap(val / vmax);
    const p = 4 * ((H - 1 - b) * W + a);
    img.data[p] = r; img.data[p + 1] = g; img.data[p + 2] = bl;
    img.data[p + 3] = 255;
  }}
  // nearest-neighbour upscale to the canvas
  const off = document.createElement("canvas");
  off.width = W; off.height = H;
  off.getContext("2d").putImageData(img, 0, 0);
  ctx.imageSmoothingEnabled = false;
  ctx.clearRect(0, 0, cv.width, cv.height);
  ctx.drawImage(off, 0, 0, cv.width, cv.height);
  document.getElementById("info").textContent =
    "dims " + DIMS.join("x") + ", max voxel count " + vmax;
}}
for (const el of [axisEl, modeEl, sliceEl, timeEl])
  el.addEventListener("input", draw);
let playing = null;
document.getElementById("play").addEventListener("click", () => {{
  if (playing) {{ clearInterval(playing); playing = null; return; }}
  playing = setInterval(() => {{
    timeEl.value = (+timeEl.value + 1) % NW; draw();
  }}, 300);
}});
draw();
</script></body></html>
"""


def render_volume_html(run: RunData, out_dir: str | Path,
                       max_floats: int = 2_000_000) -> Optional[Path]:
    """Self-contained interactive volume viewer (volume_<key>.html): the
    cumulative voxel density with axis/slice/MIP controls, plus a time
    slider over the local_temp windows when the run wrote them — the
    interactive counterpart of plotting.jl's Makie volume scene
    (:273-331), with zero external dependencies (plain canvas JS).

    Windows are embedded only while the total payload stays under
    `max_floats` values (~a few MB of HTML); beyond that the viewer
    falls back to the cumulative volume alone."""
    density = run.local[..., 0]
    if density.max() <= 0:
        return None
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    def compact(a):
        flat = np.asarray(a, dtype=float).ravel()
        # voxel counts are integers; keep the JSON small
        return "[" + ",".join(
            str(int(x)) if float(x).is_integer() else f"{x:.4g}"
            for x in flat) + "]"

    windows = load_local_windows(run)
    n_windows = int(windows.shape[0])
    if n_windows * density.size > max_floats:
        windows = windows[:0]
        n_windows = 0
    html = _VOLUME_HTML.format(
        key=run.key,
        dims=list(run.local_dims),
        cum=compact(density),
        windows=compact(windows[..., 0]) if n_windows > 1 else "[]",
        n_windows=n_windows if n_windows > 1 else 0,
    )
    p = out / f"volume_{run.key}.html"
    p.write_text(html)
    return p


_REWEIGHT_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>rho(z; T) {key}</title>
<style>
 body {{ font-family: system-ui, sans-serif; background: #111; color: #ddd;
        display: flex; flex-direction: column; align-items: center; }}
 canvas {{ border: 1px solid #444; margin: 8px; }}
 input[type=range] {{ width: 320px; vertical-align: middle; }}
</style></head><body>
<h3>MBAR-reweighted rho(z; T) — {key}</h3>
<div>T <input id="tsel" type="range" min="0" value="0">
 <span id="tval"></span></div>
<canvas id="line" width="640" height="240"></canvas>
<canvas id="heat" width="640" height="200"></canvas>
<div id="info"></div>
<script>
const TS = {ts};            // [G] target temperatures
const ZS = {zs};            // [B] bin centers
const V = {vals};           // flat [G * B] densities
const E = {errs};           // flat [G * B] bootstrap errors ([] if none)
const G = TS.length, B = ZS.length;
let VMAX = 1e-12;
for (const x of V) if (x > VMAX) VMAX = x;
const tsel = document.getElementById("tsel");
tsel.max = G - 1;
const lc = document.getElementById("line").getContext("2d");
const hc = document.getElementById("heat").getContext("2d");
function cmap(t) {{
  t = Math.max(0, Math.min(1, t));
  return [255 * Math.pow(t, 0.55) * 1.3, 255 * Math.pow(t, 1.6) * 0.9,
          255 * (t < 0.5 ? 0.4 + 2.4 * t * (1 - t) : 1.6 * (1 - t))];
}}
function heat() {{
  const W = 640, H = 200, img = hc.createImageData(W, H);
  for (let px = 0; px < W; px++) for (let py = 0; py < H; py++) {{
    const g = Math.min(G - 1, Math.floor(py / H * G));
    const b = Math.min(B - 1, Math.floor(px / W * B));
    const [r, gr, bl] = cmap(V[g * B + b] / VMAX);
    const p = 4 * (py * W + px);
    img.data[p] = r; img.data[p+1] = gr; img.data[p+2] = bl;
    img.data[p+3] = 255;
  }}
  hc.putImageData(img, 0, 0);
  // marker for the selected T row
  const y = (+tsel.value + 0.5) / G * H;
  hc.strokeStyle = "#fff"; hc.beginPath();
  hc.moveTo(0, y); hc.lineTo(8, y); hc.stroke();
}}
function line() {{
  const g = +tsel.value, W = 640, H = 240;
  document.getElementById("tval").textContent = TS[g].toFixed(3);
  lc.clearRect(0, 0, W, H);
  lc.strokeStyle = "#6cf"; lc.fillStyle = "rgba(100,160,255,0.25)";
  const xpix = b => (b + 0.5) / B * W;
  const ypix = v => H - 8 - v / VMAX * (H - 20);
  if (E.length) {{
    lc.beginPath();
    for (let b = 0; b < B; b++)
      lc.lineTo(xpix(b), ypix(V[g * B + b] + E[g * B + b]));
    for (let b = B - 1; b >= 0; b--)
      lc.lineTo(xpix(b), ypix(Math.max(0, V[g * B + b] - E[g * B + b])));
    lc.closePath(); lc.fill();
  }}
  lc.beginPath();
  for (let b = 0; b < B; b++) lc.lineTo(xpix(b), ypix(V[g * B + b]));
  lc.stroke();
  document.getElementById("info").textContent =
    "z in [" + ZS[0].toFixed(1) + ", " + ZS[B-1].toFixed(1) +
    "], peak " + VMAX.toPrecision(3);
  heat();
}}
tsel.addEventListener("input", line);
line();
</script></body></html>
"""


def render_reweight_html(run: RunData, out_dir: str | Path) -> Optional[Path]:
    """Interactive rho(z; T) surface viewer from reweight_zprofile_*.csv
    (reweight.write_reweight_profile_csv): a T-slider profile line with
    the bootstrap band plus a (T, z) heatmap — the whole MBAR density
    surface explorable in one self-contained zero-dependency file."""
    f = run.run_dir / f"reweight_zprofile_{run.key}.csv"
    if not f.exists():
        return None
    rows = np.atleast_2d(np.genfromtxt(f, delimiter=",", skip_header=1))
    if rows.size == 0:
        return None
    ts = np.unique(rows[:, 0])
    zs = np.unique(rows[:, 1])
    if rows.shape[0] != len(ts) * len(zs):
        return None   # malformed/partial file: skip rather than garble
    order = np.lexsort((rows[:, 1], rows[:, 0]))
    vals = rows[order, 2]
    errs = rows[order, 3] if rows.shape[1] > 3 else np.zeros((0,))

    def js(a, fmt="{:.6g}"):
        # Non-finite values must become the JS spelling: Python's 'nan'
        # / 'inf' are ReferenceErrors at script parse and would blank
        # the whole viewer (a NaN bootstrap err from a zero-ESS level,
        # or a truncated CSV field, is enough to produce one).
        def one(v):
            v = float(v)
            if math.isnan(v):
                return "NaN"
            if math.isinf(v):
                return "Infinity" if v > 0 else "-Infinity"
            return fmt.format(v)
        return "[" + ",".join(one(v) for v in a) + "]"

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    p = out / f"reweight_zprofile_{run.key}.html"
    p.write_text(_REWEIGHT_HTML.format(
        key=run.key, ts=js(ts, "{:.4f}"), zs=js(zs), vals=js(vals),
        errs=js(errs)))
    return p


def sk_panel(run: RunData, box, device="cuda"
             ) -> tuple[np.ndarray, np.ndarray]:
    """The S(k) panel's numbers: observables.structure_factor of every
    stored snapshot in float32 on `device`, in one batched call (the |k|
    shells are snapshot-independent), averaged over the snapshots.
    box = (L, LZ). Returns (|k| [shells], S(k) [shells])."""
    import torch

    from .config import SMCConfig
    from .observables import structure_factor

    cfg_sk = SMCConfig(n=run.n, box_l=float(box[0]), box_lz=float(box[1]))
    r = torch.as_tensor(run.positions, dtype=torch.float32, device=device)
    ks, sk_all = structure_factor(r, cfg_sk)
    return ks.cpu().numpy(), sk_all.mean(dim=0).cpu().numpy()


def render_all(run: RunData, out_dir: str | Path, box=None,
               device="cuda") -> list[Path]:
    """Produce the full plot set (or .npz summaries without matplotlib;
    with `box`, they hold the S(k) panel's numbers, sk_k and sk).
    `device` runs the S(k) panel."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []

    # ladder/umbrella run dirs carry no standard trace/local artifacts
    # (load_run loads them as empty) — skip those panels, render theirs
    has_trace = run.energy.size > 0
    has_local = run.local.size > 2   # the empty placeholder is (1,1,1,2)
    bands = z_band_maps(run) if has_local else {}
    freqs, spec = spectrum(run) if has_trace else (np.zeros(1),
                                                   np.zeros(1))
    acf2 = acf_check(run) if has_trace else np.zeros(0)

    if not HAVE_MPL:  # pragma: no cover
        p = out / f"analysis_{run.key}.npz"
        sk = {}
        if box is not None and run.positions.shape[0] > 0:
            sk["sk_k"], sk["sk"] = sk_panel(run, box, device)
        np.savez(p, density_bands=bands.get("density", np.zeros(0)),
                 mobility_bands=bands.get("mobility", np.zeros(0)),
                 freqs=freqs, spectrum=spec, acf_recomputed=acf2, **sk)
        return [p]

    # E / P / acceptance traces (plotting.jl:247-264)
    if has_trace:
        fig, axes = plt.subplots(3, 1, figsize=(9, 8), sharex=True)
        for ax, (series, label) in zip(axes, (
            (run.energy, "E"), (run.pressure, "P"),
            (run.accepted, "accepted"),
        )):
            ax.plot(series, lw=0.6)
            ax.set_ylabel(label)
        axes[-1].set_xlabel("gather")
        fig.suptitle(f"traces {run.key}")
        p = out / f"traces_{run.key}.png"
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(p)

        # ACF + spectrum (plotting.jl:58-87)
        fig, (a1, a2) = plt.subplots(1, 2, figsize=(11, 4))
        if run.acf.size:
            a1.plot(run.acf[:400], label="stored (reference recipe)")
        a1.plot(acf2, label="recomputed (Wiener-Khinchin)", ls="--")
        a1.set_xlabel("lag")
        a1.set_ylabel("ACF")
        a1.legend()
        a2.loglog(freqs[1:], spec[1:], lw=0.6)
        a2.set_xlabel("frequency")
        a2.set_ylabel("|E(f)|^2")
        p = out / f"acf_{run.key}.png"
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(p)

    # density / mobility z-band contour grids (plotting.jl:123-201)
    for name, maps in bands.items():
        k = maps.shape[0]
        fig, axes = plt.subplots(1, k, figsize=(2.2 * k, 2.6))
        for b in range(k):
            axes[b].contourf(maps[b], levels=12)
            axes[b].set_title(f"z-band {b}", fontsize=8)
            axes[b].set_xticks([])
            axes[b].set_yticks([])
        fig.suptitle(f"{name} by z-band {run.key}")
        p = out / f"{name}_bands_{run.key}.png"
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(p)

    # wall potential map (plotting.jl:203-234); disorder ensembles
    # (5-column wall csv: k, nx, ny, x0, ymin) get one panel per
    # realization
    if run.wall.size:
        mm = run.m
        wv = run.wall
        if wv.shape[1] == 5:
            ks = np.unique(wv[:, 0].astype(int))
            ncol = min(len(ks), 6)
            nrow = -(-len(ks) // ncol)
            fig, axes = plt.subplots(nrow, ncol,
                                     figsize=(2.6 * ncol, 2.6 * nrow),
                                     squeeze=False)
            im = None
            for idx, k in enumerate(ks):
                ax = axes[idx // ncol][idx % ncol]
                ymin = wv[wv[:, 0].astype(int) == k][:, 4].reshape(mm, mm)
                im = ax.imshow(ymin, origin="lower")
                ax.set_title(f"k={k}", fontsize=8)
            for idx in range(len(ks), nrow * ncol):
                axes[idx // ncol][idx % ncol].axis("off")
            fig.colorbar(im, ax=[a for row in axes for a in row],
                         label="well depth y_min")
            fig.suptitle(f"wall sites ({len(ks)} realizations) {run.key}")
        else:
            fig, ax = plt.subplots(figsize=(4, 3.5))
            im = ax.imshow(wv[:, 3].reshape(mm, mm), origin="lower")
            fig.colorbar(im, ax=ax, label="well depth y_min")
            ax.set_title(f"wall sites {run.key}")
        p = out / f"wall_{run.key}.png"
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(p)

    # temporal overlay: x-y positions across snapshots, early->late
    # colour ramp (plotting.jl:39-56)
    if run.positions.shape[0] > 1:
        fig, ax = plt.subplots(figsize=(5, 5))
        snaps = run.positions
        for si in range(snaps.shape[0]):
            cval = si / max(1, snaps.shape[0] - 1)
            ax.scatter(snaps[si, :, 0], snaps[si, :, 1], s=4,
                       color=plt.cm.viridis(cval), alpha=0.5)
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.set_title(f"temporal overlay {run.key}")
        p = out / f"overlay_{run.key}.png"
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(p)

    # 3-D scatter of the last configuration with wall planes
    # (plotting.jl:17-37)
    if run.positions.size:
        r = run.positions[-1]
        fig = plt.figure(figsize=(6, 5))
        ax = fig.add_subplot(projection="3d")
        ax.scatter(r[:, 0], r[:, 1], r[:, 2], s=6)
        if box is not None:
            l, lz = box
            xx, yy = np.meshgrid([-l / 2, l / 2], [-l / 2, l / 2])
            for zw in (-lz / 2, lz / 2):
                ax.plot_surface(xx, yy, np.full_like(xx, zw), alpha=0.15)
        ax.set_title(f"final configuration {run.key}")
        p = out / f"scatter_{run.key}.png"
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(p)

    # In-plane structure factor S(k) from the stored position snapshots
    # (reciprocal-space order parameter the reference lacks entirely;
    # needs the box to build the k-lattice, hence gated on --box)
    if box is not None and run.positions.shape[0] > 0:
        ks, sk = sk_panel(run, box, device)
        fig, ax = plt.subplots(figsize=(5, 3.4))
        ax.plot(ks, sk, marker="o", ms=2.5, lw=0.8)
        ax.axhline(1.0, color="gray", lw=0.6, ls=":")
        ax.set_xlabel("|k| (in-plane)")
        ax.set_ylabel("S(k)")
        fig.suptitle(f"structure factor {run.key} "
                     f"({run.positions.shape[0]} snapshots)")
        fig.tight_layout()
        p = out / f"sk_{run.key}.png"
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(p)

    # voxel density volume rendering (plotting.jl:273-331)
    written.extend(render_volume(run, out))
    html = render_volume_html(run, out)
    if html is not None:
        written.append(html)
    rw_html = render_reweight_html(run, out)
    if rw_html is not None:
        written.append(rw_html)

    # g(r) / z-density profile panels when the run accumulated them
    # (--gr-bins / --z-bins; beyond-reference observables, gr_*.csv and
    # zprofile_*.csv written by the CLI)
    def _ranked(stem):
        p = run.run_dir / f"{stem}_{run.key}_rank0.csv"
        return p if p.exists() else run.run_dir / f"{stem}_{run.key}.csv"

    gr_file = _ranked("gr")
    zp_file = _ranked("zprofile")
    if gr_file.exists() or zp_file.exists():
        panels = [(p, lab) for p, lab in
                  ((gr_file, ("r", "g(r)")), (zp_file, ("z", "density")))
                  if p.exists()]
        fig, axes = plt.subplots(1, len(panels), figsize=(5 * len(panels), 3.4),
                                 squeeze=False)
        for ax, (p, (xl, yl)) in zip(axes[0], panels):
            data = np.atleast_2d(
                np.genfromtxt(p, delimiter=",", skip_header=1))
            ax.plot(data[:, 0], data[:, 1], lw=1)
            if xl == "r":
                ax.axhline(1.0, color="gray", lw=0.6, ls=":")
            ax.set_xlabel(xl)
            ax.set_ylabel(yl)
        fig.suptitle(f"structure {run.key}")
        fig.tight_layout()
        p = out / f"structure_{run.key}.png"
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(p)

    # temperature-sweep curves when the run produced a tsweep CSV
    # (tsweep.py — a beyond-reference capability)
    ts = run.run_dir / f"tsweep_{run.key}.csv"
    if ts.exists():
        data = np.genfromtxt(ts, delimiter=",", skip_header=1)
        data = np.atleast_2d(data)
        # MBAR reweighting curve, when the run produced one (reweight.py):
        # the continuous E(T)/c_v(T) line the discrete ladder points sit on
        rw_file = run.run_dir / f"reweight_{run.key}.csv"
        rw = rw_cols = None
        if rw_file.exists():
            # header-driven parse: the schema grew E_err/cv_err columns
            # when the CLI bootstrap was added
            hdr = [h.strip() for h in
                   rw_file.open().readline().strip().split(",")]
            rw_cols = {name: i for i, name in enumerate(hdr)}
            rw = np.atleast_2d(
                np.genfromtxt(rw_file, delimiter=",", skip_header=1))
        has_p = rw is not None and "P" in rw_cols
        has_mu = rw is not None and "mu_ex" in rw_cols
        n_panels = 3 + int(has_p) + int(has_mu)
        fig, axes = plt.subplots(1, n_panels,
                                 figsize=(4 * n_panels, 3.4))
        if rw is not None:
            e_err = (rw[:, rw_cols["E_err"]] if "E_err" in rw_cols
                     else None)
            axes[0].plot(rw[:, 0], rw[:, rw_cols["E_mean"]], lw=1,
                         color="C1", label="MBAR")
            if e_err is not None:
                axes[0].fill_between(
                    rw[:, 0], rw[:, rw_cols["E_mean"]] - e_err,
                    rw[:, rw_cols["E_mean"]] + e_err,
                    color="C1", alpha=0.25, lw=0)
            axes[1].plot(rw[:, 0], rw[:, rw_cols["cv"]], lw=1, color="C1")
        # NB ls="none" (not lw=0) suppresses the connecting line: lw
        # would propagate to elinewidth and erase the error bars too
        axes[0].errorbar(data[:, 0], data[:, 1], yerr=data[:, 2],
                         marker="o", ms=3,
                         ls="none" if rw is not None else "-",
                         label="ladder" if rw is not None else None)
        if rw is not None:
            axes[0].legend(fontsize=8)
        axes[0].set_xlabel("T")
        axes[0].set_ylabel("E")
        axes[1].plot(data[:, 0], data[:, 4], marker="o", ms=3,
                     ls="none" if rw is not None else "-")
        axes[1].set_xlabel("T")
        axes[1].set_ylabel("c_v")
        axes[2].plot(data[:, 0], data[:, 3], marker="o", ms=3, lw=1)
        axes[2].set_xlabel("T")
        axes[2].set_ylabel("acceptance")
        nax = 3
        if has_p:
            # MBAR equation-of-state panel (reweight.py paired samples)
            pv = rw[:, rw_cols["P"]]
            axes[nax].plot(rw[:, 0], pv, lw=1, color="C1")
            if "P_err" in rw_cols:
                pe = rw[:, rw_cols["P_err"]]
                axes[nax].fill_between(rw[:, 0], pv - pe, pv + pe,
                                       color="C1", alpha=0.25, lw=0)
            axes[nax].set_xlabel("T")
            axes[nax].set_ylabel("P")
            nax += 1
        if has_mu:
            # Widom mu_ex(T) via MBAR (reweight.py + widom.py): the
            # insertion factor re-evaluated at each target beta
            mv = rw[:, rw_cols["mu_ex"]]
            axes[nax].plot(rw[:, 0], mv, lw=1, color="tab:green")
            if "mu_ex_err" in rw_cols:
                me = rw[:, rw_cols["mu_ex_err"]]
                axes[nax].fill_between(rw[:, 0], mv - me, mv + me,
                                       color="tab:green", alpha=0.25,
                                       lw=0)
            axes[nax].set_xlabel("T")
            axes[nax].set_ylabel("mu_ex")
        fig.suptitle(f"temperature sweep {run.key}")
        fig.tight_layout()
        p = out / f"tsweep_{run.key}.png"
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(p)

    # Reweighted density fields rho(z; T) / g(r; T) (reweight.py paired
    # field samples) — the continuous-T version of the density maps the
    # reference could only draw at the simulated T (plotting.jl:123-201)
    for stem, xl, yl in (("reweight_zprofile", "z", "rho(z)"),
                         ("reweight_gr", "r", "g(r)"),
                         ("reweight_pmf", "z", "F(z) = -T ln rho"),
                         ("reweight_sk", "k", "S(k)"),
                         ("reweight_pn", "z", "P_N(z)"),
                         ("reweight_pt", "z", "P_T(z)")):
        f = run.run_dir / f"{stem}_{run.key}.csv"
        if not f.exists():
            continue
        rows = np.atleast_2d(np.genfromtxt(f, delimiter=",", skip_header=1))
        temps = np.unique(rows[:, 0])
        fig, ax = plt.subplots(figsize=(6, 4))
        cmap = plt.get_cmap("coolwarm")
        tlo, thi = temps.min(), temps.max()
        for t in temps:
            sel = rows[rows[:, 0] == t]
            frac = 0.5 if thi == tlo else (t - tlo) / (thi - tlo)
            ax.plot(sel[:, 1], sel[:, 2], lw=1, color=cmap(frac),
                    label=f"T={t:0.3f}")
            if sel.shape[1] > 3:
                ax.fill_between(sel[:, 1], sel[:, 2] - sel[:, 3],
                                sel[:, 2] + sel[:, 3],
                                color=cmap(frac), alpha=0.2, lw=0)
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        if len(temps) <= 10:
            ax.legend(fontsize=7)
        fig.suptitle(f"{yl} vs T (MBAR) {run.key}")
        fig.tight_layout()
        p = out / f"{stem}_{run.key}.png"
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(p)

    # Disorder-resolved profiles from wall-disorder runs (io.py
    # write_disorder_profile_csv): one curve per quenched realization
    for stem, xl, yl in (("zprofile_disorder", "z", "rho(z)"),
                         ("gr_disorder", "r", "g(r)")):
        f = run.run_dir / f"{stem}_{run.key}.csv"
        if not f.exists():
            continue
        rows = np.atleast_2d(np.genfromtxt(f, delimiter=",", skip_header=1))
        ks = np.unique(rows[:, 0].astype(int))
        fig, ax = plt.subplots(figsize=(6, 4))
        cmap = plt.get_cmap("viridis")
        for k in ks:
            sel = rows[rows[:, 0].astype(int) == k]
            frac = 0.5 if len(ks) == 1 else k / (len(ks) - 1)
            ax.plot(sel[:, 1], sel[:, 2], lw=1, color=cmap(frac),
                    label=f"k={k}")
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        if len(ks) <= 10:
            ax.legend(fontsize=7)
        fig.suptitle(f"{yl} per wall realization {run.key}")
        fig.tight_layout()
        p = out / f"{stem}_{run.key}.png"
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(p)

    # Widom mu_ex(z) profile (io.write_widom_csv): the z-resolved excess
    # chemical potential with its chain-bootstrap band; the skipped bins
    # (no insertions landed / zero mean weight) are nan and left blank
    wfile = _ranked("widom")
    if wfile.exists():
        rows = np.atleast_2d(np.genfromtxt(
            wfile, delimiter=",", skip_header=2))
        if rows.size:
            fig, ax = plt.subplots(figsize=(6, 4))
            m = np.isfinite(rows[:, 1])
            ax.plot(rows[m, 0], rows[m, 1], lw=1.2, color="tab:green")
            if rows.shape[1] > 2 and np.isfinite(rows[m, 2]).any():
                ax.fill_between(rows[m, 0], rows[m, 1] - rows[m, 2],
                                rows[m, 1] + rows[m, 2],
                                color="tab:green", alpha=0.2, lw=0)
            # the volume-averaged scalar rides the header comment line
            try:
                head = wfile.read_text().splitlines()[0]
                mu_g = float(head.split(",")[1])
                ax.axhline(mu_g, color="gray", lw=0.6, ls=":",
                           label=f"volume avg {mu_g:0.4f}")
                ax.legend(fontsize=8)
            except (ValueError, IndexError):
                pass
            ax.set_xlabel("z")
            ax.set_ylabel("mu_ex(z)")
            fig.suptitle(f"Widom excess chemical potential {run.key}")
            fig.tight_layout()
            p = out / f"widom_{run.key}.png"
            fig.savefig(p, dpi=120)
            plt.close(fig)
            written.append(p)

    # Pressure-tensor profile (--ptensor-bins): P_N/P_T across the slab
    # with the wall-tension integrand shaded
    ptf = run.run_dir / f"ptensor_{run.key}.csv"
    if ptf.exists():
        rows = np.atleast_2d(np.genfromtxt(ptf, delimiter=",",
                                           skip_header=1))
        if rows.size:
            fig, ax = plt.subplots(figsize=(6, 4))
            ax.plot(rows[:, 0], rows[:, 1], lw=1.2, label="P_N")
            ax.plot(rows[:, 0], rows[:, 2], lw=1.2, label="P_T")
            ax.fill_between(rows[:, 0], rows[:, 1], rows[:, 2],
                            color="tab:orange", alpha=0.15, lw=0)
            dz = rows[1, 0] - rows[0, 0] if len(rows) > 1 else 1.0
            gamma = 0.5 * float(np.sum(rows[:, 1] - rows[:, 2]) * dz)
            ax.set_xlabel("z")
            ax.set_ylabel("pressure")
            ax.legend(fontsize=8, title=f"gamma/wall = {gamma:0.4g}")
            fig.suptitle(f"pressure tensor {run.key}")
            fig.tight_layout()
            p = out / f"ptensor_{run.key}.png"
            fig.savefig(p, dpi=120)
            plt.close(fig)
            written.append(p)

    # Grand-canonical isotherm (--gcmc-grid): coverage vs mu
    iso = run.run_dir / f"gcmc_isotherm_{run.key}.csv"
    if iso.exists():
        rows = np.atleast_2d(np.genfromtxt(iso, delimiter=",",
                                           skip_header=1))
        if rows.size:
            fig, ax = plt.subplots(figsize=(5.2, 3.8))
            ax.errorbar(rows[:, 0], rows[:, 1], yerr=rows[:, 2],
                        marker="o", ms=3, lw=1, capsize=2)
            ax.set_xlabel("mu")
            ax.set_ylabel("<N>")
            fig.suptitle(f"adsorption isotherm {run.key}")
            fig.tight_layout()
            p = out / f"gcmc_isotherm_{run.key}.png"
            fig.savefig(p, dpi=120)
            plt.close(fig)
            written.append(p)

    # Grand-canonical run (gcmc.write_gcmc_csv): N(t)/E(t) traces with
    # the imposed mu and <N> from the header comment; plus the density
    # profile when the run collected one
    gcf = run.run_dir / f"gcmc_{run.key}.csv"
    if gcf.exists():
        rows = np.atleast_2d(np.genfromtxt(gcf, delimiter=",",
                                           skip_header=2))
        if rows.size:
            zpf = _ranked("gcmc_zprofile")
            grf = _ranked("gcmc_gr")
            n_panels = 2 + int(zpf.exists()) + int(grf.exists())
            fig, axes = plt.subplots(1, n_panels,
                                     figsize=(4.2 * n_panels, 3.4))
            axes[0].plot(rows[:, 0], rows[:, 1], lw=0.8)
            try:
                head = gcf.read_text().splitlines()[0].split(",")
                mu_v, mean_n = float(head[1]), float(head[3])
                axes[0].axhline(mean_n, color="gray", lw=0.6, ls=":",
                                label=f"<N>={mean_n:0.2f} @ mu={mu_v:g}")
                axes[0].legend(fontsize=8)
            except (ValueError, IndexError):
                pass
            axes[0].set_xlabel("GC sweep")
            axes[0].set_ylabel("N")
            axes[1].plot(rows[:, 0], rows[:, 2], lw=0.8, color="C1")
            axes[1].set_xlabel("GC sweep")
            axes[1].set_ylabel("E")
            pax = 2
            if zpf.exists():
                zp = np.atleast_2d(np.genfromtxt(zpf, delimiter=",",
                                                 skip_header=1))
                axes[pax].plot(zp[:, 0], zp[:, 1], lw=1, color="C2")
                axes[pax].set_xlabel("z")
                axes[pax].set_ylabel("density")
                pax += 1
            if grf.exists():
                gdat = np.atleast_2d(np.genfromtxt(grf, delimiter=",",
                                                   skip_header=1))
                axes[pax].plot(gdat[:, 0], gdat[:, 1], lw=1, color="C3")
                axes[pax].axhline(1.0, color="gray", lw=0.6, ls=":")
                axes[pax].set_xlabel("r")
                axes[pax].set_ylabel("g(r)")
            fig.suptitle(f"grand-canonical {run.key}")
            fig.tight_layout()
            p = out / f"gcmc_{run.key}.png"
            fig.savefig(p, dpi=120)
            plt.close(fig)
            written.append(p)

    # Constant-pressure equation of state (--npt-grid): rho(P) with the
    # volume-fluctuation compressibility on a twin axis
    nif = run.run_dir / f"npt_isobar_{run.key}.csv"
    if nif.exists():
        rows = np.atleast_2d(np.genfromtxt(nif, delimiter=",",
                                           skip_header=1))
        if rows.size:
            fig, ax = plt.subplots(figsize=(5.2, 3.8))
            ax.errorbar(rows[:, 0], rows[:, 1], yerr=rows[:, 2],
                        marker="o", ms=3, lw=1, capsize=2,
                        ls="none", label="simulated")
            rwf = run.run_dir / f"npt_reweight_{run.key}.csv"
            if rwf.exists():
                rw = np.atleast_2d(np.genfromtxt(rwf, delimiter=",",
                                                 skip_header=1))
                if rw.size:
                    ax.plot(rw[:, 0], rw[:, 1], lw=1.2, color="C2",
                            alpha=0.9, label="MBAR")
            ax.legend(fontsize=8)
            ax.set_xlabel("P")
            ax.set_ylabel("rho")
            if rows.shape[1] > 4:
                ax2 = ax.twinx()
                ax2.plot(rows[:, 0], rows[:, 4], marker="s", ms=2.5,
                         lw=0.8, color="C3", alpha=0.8)
                ax2.set_ylabel("kappa_T", color="C3")
            fig.suptitle(f"equation of state {run.key}")
            fig.tight_layout()
            p = out / f"npt_isobar_{run.key}.png"
            fig.savefig(p, dpi=120)
            plt.close(fig)
            written.append(p)

    # Constant-pressure run (npt.write_npt_csv): V(t)/E(t) traces with
    # the imposed P and <rho> from the header; g(r) when collected
    npf = run.run_dir / f"npt_{run.key}.csv"
    if npf.exists():
        rows = np.atleast_2d(np.genfromtxt(npf, delimiter=",",
                                           skip_header=2))
        if rows.size:
            grf = run.run_dir / f"npt_gr_{run.key}.csv"
            n_panels = 2 + int(grf.exists())
            fig, axes = plt.subplots(1, n_panels,
                                     figsize=(4.2 * n_panels, 3.4))
            axes[0].plot(rows[:, 0], rows[:, 2], lw=0.8)
            try:
                head = npf.read_text().splitlines()[0].split(",")
                p_v, mean_rho = float(head[1]), float(head[3])
                axes[0].axhline(mean_rho, color="gray", lw=0.6, ls=":",
                                label=f"<rho>={mean_rho:0.3f} @ P={p_v:g}")
                axes[0].legend(fontsize=8)
            except (ValueError, IndexError):
                pass
            axes[0].set_xlabel("NPT sweep")
            axes[0].set_ylabel("rho")
            axes[1].plot(rows[:, 0], rows[:, 3], lw=0.8, color="C1")
            axes[1].set_xlabel("NPT sweep")
            axes[1].set_ylabel("E")
            if grf.exists():
                gdat = np.atleast_2d(np.genfromtxt(grf, delimiter=",",
                                                   skip_header=1))
                axes[2].plot(gdat[:, 0], gdat[:, 1], lw=1, color="C3")
                axes[2].axhline(1.0, color="gray", lw=0.6, ls=":")
                axes[2].set_xlabel("r (x <L>)")
                axes[2].set_ylabel("g(r)")
            fig.suptitle(f"constant-pressure {run.key}")
            fig.tight_layout()
            p = out / f"npt_{run.key}.png"
            fig.savefig(p, dpi=120)
            plt.close(fig)
            written.append(p)

    # Gibbs coexistence curve (gibbs.write_gibbs_binodal_csv): the
    # binodal dome in the classic (rho, T) orientation
    gbn = run.run_dir / f"gibbs_binodal_{run.key}.csv"
    if gbn.exists():
        rows = np.atleast_2d(np.genfromtxt(gbn, delimiter=",",
                                           skip_header=1))
        if rows.size:
            fig, ax = plt.subplots(figsize=(5.2, 4.0))
            two = rows[:, 6] > 0.5
            ax.errorbar(rows[two, 1], rows[two, 0],
                        xerr=rows[two, 2], marker="o", ms=4, lw=1,
                        capsize=2, color="C0", label="vapor branch")
            ax.errorbar(rows[two, 3], rows[two, 0],
                        xerr=rows[two, 4], marker="o", ms=4, lw=1,
                        capsize=2, color="C3", label="liquid branch")
            if (~two).any():
                mid = 0.5 * (rows[~two, 1] + rows[~two, 3])
                ax.plot(mid, rows[~two, 0], marker="x", ms=5, lw=0,
                        color="gray", label="one phase")
            ax.set_xlabel("rho")
            ax.set_ylabel("T")
            ax.legend(fontsize=8)
            fig.suptitle(f"coexistence curve {run.key}")
            fig.tight_layout()
            p = out / f"gibbs_binodal_{run.key}.png"
            fig.savefig(p, dpi=120)
            plt.close(fig)
            written.append(p)

    # Gibbs-ensemble run (gibbs.write_gibbs_csv): the vapor/liquid
    # branch densities vs sweep + the N1/V1 exchange traces
    gbf = run.run_dir / f"gibbs_{run.key}.csv"
    if gbf.exists():
        rows = np.atleast_2d(np.genfromtxt(gbf, delimiter=",",
                                           skip_header=2))
        if rows.size:
            fig, axes = plt.subplots(1, 2, figsize=(8.6, 3.4))
            axes[0].plot(rows[:, 0], rows[:, 4], lw=0.9, color="C3",
                         label="liquid branch")
            axes[0].plot(rows[:, 0], rows[:, 3], lw=0.9, color="C0",
                         label="vapor branch")
            try:
                head = gbf.read_text().splitlines()[0].split(",")
                lo_v, hi_v = float(head[1]), float(head[5])
                for v, c in ((lo_v, "C0"), (hi_v, "C3")):
                    axes[0].axhline(v, color=c, lw=0.6, ls=":")
            except (ValueError, IndexError):
                pass
            axes[0].set_xlabel("Gibbs sweep")
            axes[0].set_ylabel("rho")
            axes[0].legend(fontsize=8)
            axes[1].plot(rows[:, 0], rows[:, 1], lw=0.8, color="C1")
            axes[1].set_xlabel("Gibbs sweep")
            axes[1].set_ylabel("N1", color="C1")
            ax2 = axes[1].twinx()
            ax2.plot(rows[:, 0], rows[:, 2], lw=0.8, color="C2",
                     alpha=0.8)
            ax2.set_ylabel("V1", color="C2")
            fig.suptitle(f"Gibbs ensemble {run.key}")
            fig.tight_layout()
            p = out / f"gibbs_{run.key}.png"
            fig.savefig(p, dpi=120)
            plt.close(fig)
            written.append(p)

    # Umbrella-sampling PMF (umbrella.write_umbrella_csv): the MBAR-
    # unbiased F(z) with its replica-bootstrap band
    upf = run.run_dir / f"umbrella_pmf_{run.key}.csv"
    if upf.exists():
        rows = np.atleast_2d(np.genfromtxt(
            upf, delimiter=",", skip_header=1, comments="#"))
        if rows.size:
            fig, ax = plt.subplots(figsize=(6, 4))
            ax.plot(rows[:, 0], rows[:, 1], lw=1.2, color="tab:purple")
            if rows.shape[1] > 2 and np.isfinite(rows[:, 2]).any():
                ax.fill_between(rows[:, 0], rows[:, 1] - rows[:, 2],
                                rows[:, 1] + rows[:, 2],
                                color="tab:purple", alpha=0.2, lw=0)
            ax.set_xlabel("z")
            ax.set_ylabel("F(z) / T-units")
            fig.suptitle(f"umbrella PMF {run.key}")
            fig.tight_layout()
            p = out / f"umbrella_pmf_{run.key}.png"
            fig.savefig(p, dpi=120)
            plt.close(fig)
            written.append(p)

    # Per-realization MBAR curves from wall-disorder ladders
    # (reweight.write_reweight_disorder_csv): E(T) and f(T) per quenched
    # wall, the spread behind the combined curve's error bars
    rdf = run.run_dir / f"reweight_disorder_{run.key}.csv"
    if rdf.exists():
        rows = np.atleast_2d(np.genfromtxt(rdf, delimiter=",",
                                           skip_header=1))
        if rows.size:
            ks = np.unique(rows[:, 0].astype(int))
            fig, axes = plt.subplots(1, 2, figsize=(8, 3.4))
            cmap = plt.get_cmap("viridis")
            fcol = rows.shape[1] - 1
            for k in ks:
                sel = rows[rows[:, 0].astype(int) == k]
                frac = 0.5 if len(ks) == 1 else k / (len(ks) - 1)
                axes[0].plot(sel[:, 1], sel[:, 2], lw=1,
                             color=cmap(frac), label=f"k={k}")
                axes[1].plot(sel[:, 1], sel[:, fcol], lw=1,
                             color=cmap(frac))
            axes[0].set_xlabel("T")
            axes[0].set_ylabel("E(T)")
            axes[1].set_xlabel("T")
            axes[1].set_ylabel("f(T)")
            if len(ks) <= 10:
                axes[0].legend(fontsize=7)
            fig.suptitle(f"MBAR per wall realization {run.key}")
            fig.tight_layout()
            p = out / f"reweight_disorder_{run.key}.png"
            fig.savefig(p, dpi=120)
            plt.close(fig)
            written.append(p)

    # Parallel-tempering swap acceptance per adjacent pair (pt.py CSV)
    ptf = run.run_dir / f"pt_{run.key}.csv"
    if ptf.exists():
        rows = np.atleast_2d(np.genfromtxt(ptf, delimiter=",",
                                           skip_header=1))
        if rows.size:
            mid = 0.5 * (rows[:, 0] + rows[:, 1])
            fig, ax = plt.subplots(figsize=(5, 3.4))
            ax.bar(mid, rows[:, 2], width=0.6 * np.min(np.diff(mid))
                   if len(mid) > 1 else 0.05, color="C0")
            for x, a, n_att in zip(mid, rows[:, 2], rows[:, 3]):
                ax.annotate(f"{int(n_att)}", (x, a), ha="center",
                            va="bottom", fontsize=7)
            ax.axhspan(0.2, 0.4, color="green", alpha=0.08,
                       label="classic target band")
            ax.set_xlabel("pair midpoint T")
            ax.set_ylabel("swap acceptance")
            ax.set_ylim(0, 1.05)
            ax.legend(fontsize=7)
            fig.suptitle(f"replica-exchange acceptance {run.key}")
            fig.tight_layout()
            p = out / f"pt_{run.key}.png"
            fig.savefig(p, dpi=120)
            plt.close(fig)
            written.append(p)

    return written


def render_animation(run: RunData, out_dir: str | Path,
                     fps: int = 6) -> Optional[Path]:
    """Animate the stored position snapshots (x-z plane, the wall-normal
    view) — the capability analog of plotting.jl's Makie volume animation
    (:273-331). Saves a GIF; returns None without matplotlib or with < 2
    snapshots."""
    if not HAVE_MPL or run.positions.shape[0] < 2:
        return None
    from matplotlib import animation

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    snaps = run.positions
    fig, ax = plt.subplots(figsize=(5, 6))
    scat = ax.scatter(snaps[0, :, 0], snaps[0, :, 2], s=8)
    ax.set_xlim(snaps[..., 0].min() - 1, snaps[..., 0].max() + 1)
    ax.set_ylim(snaps[..., 2].min() - 1, snaps[..., 2].max() + 1)
    ax.set_xlabel("x")
    ax.set_ylabel("z (wall-normal)")
    title = ax.set_title("")

    def update(fi):
        scat.set_offsets(np.stack([snaps[fi, :, 0], snaps[fi, :, 2]], -1))
        title.set_text(f"snapshot {fi + 1}/{snaps.shape[0]} {run.key}")
        return scat, title

    anim = animation.FuncAnimation(fig, update, frames=snaps.shape[0])
    p = out / f"trajectory_{run.key}.gif"
    anim.save(p, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_smc_torch.analysis")
    ap.add_argument("run_dir")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--box", type=float, nargs=2, default=None,
                    metavar=("L", "LZ"))
    ap.add_argument("--animate", action="store_true",
                    help="also render a trajectory GIF")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the S(k) panel (default cuda)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and args.box is not None:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("tpu_smc_torch.analysis: no CUDA device "
                             "available; pass --device cpu")
    run = load_run(args.run_dir, rank=args.rank)
    out = args.out or (Path(args.run_dir) / "plots")
    written = render_all(run, out, box=args.box, device=args.device)
    if args.animate:
        gif = render_animation(run, out)
        if gif is not None:
            written.append(gif)
    for p in written:
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
