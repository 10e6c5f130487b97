"""The z-banded random-scan sweep (K4, csrc/sweep.cu `smc_banded_kernel`):
its launcher, its plain PyTorch version and the sort-and-margin helper.

Counterpart of tpu_smc/kernels/sweep_banded.py, an experimental sampler
that is exact by construction, not an approximation:

  * Random scan. Each move picks a uniformly random ROW of the z-sorted
    planes, the same schedule for every chain. A uniformly random row is
    a uniformly random particle whatever the per-chain sort, so the visit
    schedule does not depend on the state and random-scan Metropolis-
    Hastings leaves the target invariant.
  * Symmetric z-step bound. Moves with |delta_z| > d_z are rejected in
    both directions; the indicator is symmetric in (x, y), so detailed
    balance holds exactly. The default d_z = 12 is the code's
    (`sweep_banded.py:314`), about 8 sigma of the proposal at the default
    A = 1.1 (sqrt(2A) = 1.48); the module docstring there says 8 sigma.
  * Window sufficiency with per-move fallback. At sort time each row
    records the margin min(z[r+W] - z[r], z[r] - z[r-W]) (1e15 on a
    clipped side). The window pass over rows [clip(i - W, 0, n_pad - 2W),
    +2W) is complete when margin_i > cut + own_drift + drift_max + d_z,
    own_drift = |z_i - z_i at sort| and drift_max the chain's running
    maximum of |z - z at sort| over written rows; otherwise the move
    takes the full pass. Energies are exact either way.

Randomness follows the port's contract: the sweep's seed words come from
`ensemble._per_sweep_randomness` (absolute sweep counter); the move draws
are Philox4x32-10 of (move, chain, 0|1, 0) as in the sweep kernels, and
the schedule's row of move nn is Philox of (nn, 0, 3, 0): its first two
outputs form a 64-bit word w and row = floor(w n / 2^64), so each row
has probability within n / 2^64 (relative) of 1 / n.

Deliberate differences from tpu_smc:

  * One CTA per chain: a move is counted as a fallback when THIS chain's
    sufficiency test failed. tpu_smc counts it when any lane of its
    128-chain tile failed (`sweep_banded.py:195, 278`); the port's
    `fallback_fraction` is what tpu_smc reports at c_tile = 1. Positions
    and energies do not depend on it (tpu_smc selects per lane).
  * Windows past the planes: with n_pad < 2W the window is rows [0,
    n_pad) (tpu_smc's clip would start it below row 0).

Layout as in kernels/sweep.py: planes [N_pad, C] float32 with pad rows at
1e15, energy [1, C], one shared wall row [1, MM_pad].
"""

from __future__ import annotations

import torch

from ..config import SMCConfig
from . import sweep as ks

BIG = 1e15     # margin of a clipped side and of pad rows
# the phases of a K4 move whose SM clock cycles a diagnostic launch sums
# per chain (diag={"cycles": True}; csrc/sweep.cu `Phase`, in its order,
# the first one K4's schedule row and the mover's loads)
PHASES = ("schedule and loads",) + ks.PHASES[1:]


def window_margin(z: torch.Tensor, n: int, window: int) -> torch.Tensor:
    """Per-row window margin [N_pad, C] of z-sorted planes z [N_pad, C]
    (n real rows): min(z[r+W] - z[r], z[r] - z[r-W]), BIG on a side the
    window clips and on pad rows; in z's dtype."""
    zs = z[:n]
    r = torch.arange(n, device=z.device)[:, None]
    big = torch.tensor(BIG, dtype=z.dtype, device=z.device)
    up = torch.where(r + window < n, torch.roll(zs, -window, 0) - zs, big)
    down = torch.where(r - window >= 0, zs - torch.roll(zs, window, 0), big)
    return torch.cat([torch.minimum(up, down),
                      big.expand(z.shape[0] - n, z.shape[1])])


def sort_and_margin(r: torch.Tensor, cfg: SMCConfig, window: int):
    """Per-chain z-sort of positions r [C, N, 3] into float32 planes
    [N_pad, C] (pads at 1e15) plus the window margin: (x, y, z, margin),
    bitwise tpu_smc's `sort_and_margin` (sweep_banded.py:368)."""
    order = torch.argsort(r[:, :, 2], dim=1, stable=True)
    x, y, z = ks.to_planes(torch.take_along_dim(r, order[:, :, None], 1),
                           cfg)
    return x, y, z, window_margin(z, cfg.n, window)


def banded_rows(words, n: int, device=None) -> torch.Tensor:
    """The random-scan schedule [n] int64 of one sweep's seed words: row
    floor(w n / 2^64) of move nn, w the 64-bit word of Philox (nn, 0, 3,
    0)'s first two outputs (`banded_row` in csrc/sweep.cu)."""
    nn = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(nn)
    lo, hi = ks.philox4x32(nn, zero, zero + 3, zero,
                           torch.full_like(nn, int(words[0])),
                           torch.full_like(nn, int(words[1])))[:2]
    # floor((hi 2^32 + lo) n / 2^64) = floor((hi n + floor(lo n / 2^32)) / 2^32)
    return (hi * n + ((lo * n) >> 32)) >> 32


def _check_window(window: int, d_z: float) -> None:
    if window < 1 or not d_z > 0:
        raise ValueError(f"need window >= 1 and d_z > 0, got {window}, {d_z}")


def _window_rows(i: int, n_pad: int, window: int):
    """Rows [j0, j1) of row i's window."""
    j0 = max(0, min(i - window, n_pad - 2 * window))
    return j0, min(j0 + 2 * window, n_pad)


def banded_sweep_plain(x, y, z, e, wa, wb, margin, words, cfg: SMCConfig, a,
                       window: int = 128, d_z: float = 12.0, rows=None,
                       draws=None, diag: dict | None = None,
                       chain0: int = 0):
    """Plain PyTorch version of K4: one sweep of n random-scan moves over
    z-sorted planes, in the planes' dtype (float32 for the kernel's
    inputs; float64 for parity with tpu_smc.sampler.sweep).

    rows: None = the kernel's schedule (`banded_rows`), or injected [n];
    draws: None = the kernel's Philox draws (global chains chain0 ..
    chain0 + C - 1; the schedule is chain-independent), or injected (g [n, C, 3]
    proposal noise already scaled by sqrt(2A), u [n, C]), by move.
    a: the mobility, a scalar as in tpu_smc; the temperature is
    cfg.temperature.
    diag: optional dict, filled with the per-move "rows" [n], "safe",
    "slack" (margin_i minus the sufficiency bound), "ddz", "log_ap",
    "u", "accept", "z_before" and "z_after" [n, C].

    The mover is masked by row id (not parked), pads by id and 1e15.
    Pair sums add each lane's rows (row - window start, mod 128) in
    ascending order, then the lanes (`kernels.sweep._lane_sums`).

    Returns (x, y, z, e [1, C], accepted [1, C] int32, fallback moves
    [1, C] int32)."""
    _check_window(window, d_z)
    z0 = z
    x, y, z, e = x.clone(), y.clone(), z.clone(), e.clone().reshape(-1)
    n, (n_pad, c) = cfg.n, x.shape
    dt, dev = x.dtype, x.device
    a_t, a_4t, s2a, inv_t = ks.chain_scales(a, cfg.temperature, c, dev, dt)
    if rows is None:
        rows = banded_rows(words, n, dev)
    rows = [int(v) for v in rows]
    if draws is None:
        g_all, u_all = ks.box_muller(
            ks.move_uniforms(words, n, c, dev, dt, chain0), s2a)
    else:
        g_all, u_all = draws
    cut = torch.tensor(cfg.lj_cutoff, dtype=dt, device=dev)
    dzt = torch.tensor(d_z, dtype=dt, device=dev)
    drift = torch.zeros((c,), dtype=dt, device=dev)
    acc = torch.zeros((c,), dtype=torch.int32, device=dev)
    fb = torch.zeros((c,), dtype=torch.int32, device=dev)
    rows_j = torch.arange(n_pad, device=dev)[:, None]
    keys = ("safe", "slack", "ddz", "log_ap", "u", "accept", "z_before",
            "z_after")
    rec = {k: [] for k in keys} if diag is not None else None

    def sums(qx, qy, qz, i, j0, j1):
        mask = (rows_j[j0:j1] != i) & (rows_j[j0:j1] < n)
        return ks._pair_pass(qx, qy, qz, x[j0:j1], y[j0:j1], z[j0:j1], mask,
                             cfg)

    def terms(qx, qy, qz, i, safe, win):
        """Pair + wall terms: the window's where safe, else the full pass."""
        out = sums(qx, qy, qz, i, *win)
        if not bool(safe.all()):
            full = sums(qx, qy, qz, i, 0, n_pad)
            out = [torch.where(safe, w_, f_) for w_, f_ in zip(out, full)]
        if cfg.use_walls:
            wall = ks._wall_terms(qx, qy, qz, wa, wb, cfg)
            out = [p_ + w_ for p_, w_ in zip(out, wall)]
        return out

    for nn, i in enumerate(rows):
        xi, yi, zi = x[i].clone(), y[i].clone(), z[i].clone()
        bound = cut + (zi - z0[i]).abs() + drift + dzt
        safe = margin[i] > bound
        win = _window_rows(i, n_pad, window)
        um, fmx, fmy, fmz = terms(xi, yi, zi, i, safe, win)
        g, u_acc = g_all[nn], u_all[nn]
        ddx = fmx * a_t + g[:, 0]
        ddy = fmy * a_t + g[:, 1]
        ddz = fmz * a_t + g[:, 2]
        px = xi + ddx
        px = px - cfg.box_l * torch.round(px * (1.0 / cfg.box_l))
        py = yi + ddy
        py = py - cfg.box_l * torch.round(py * (1.0 / cfg.box_l))
        pz = zi + ddz
        un, fnx, fny, fnz = terms(px, py, pz, i, safe, win)

        dfx, dfy, dfz = fnx - fmx, fny - fmy, fnz - fmz
        dw_term = (dfx * dfx + dfy * dfy + dfz * dfz
                   + 2.0 * (dfx * fmx + dfy * fmy + dfz * fmz)) * a_4t
        log_ap = -(un - um
                   + 0.5 * (ddx * (fnx + fmx) + ddy * (fny + fmy)
                            + ddz * (fnz + fmz))
                   + dw_term) * inv_t
        # NaN log_ap rejects; the symmetric |dz| bound
        accept = ((log_ap >= 0.0) | (u_acc < torch.exp(log_ap))) \
            & (ddz.abs() <= dzt)
        x[i] = torch.where(accept, px, xi)
        y[i] = torch.where(accept, py, yi)
        z[i] = torch.where(accept, pz, zi)
        e = e + torch.where(accept, un - um, torch.zeros_like(un))
        acc += accept.to(torch.int32)
        fb += (~safe).to(torch.int32)
        drift = torch.maximum(drift, (z[i] - z0[i]).abs())
        if rec is not None:
            for k, v in zip(keys, (safe, margin[i] - bound, ddz, log_ap,
                                   u_acc, accept, zi, z[i].clone())):
                rec[k].append(v)
    if diag is not None:
        diag["rows"] = torch.tensor(rows, dtype=torch.int64)
        diag.update({k: torch.stack(v) for k, v in rec.items()})
    return x, y, z, e.reshape(1, c), acc.reshape(1, c), fb.reshape(1, c)


def banded_sweep_block(x, y, z, e, wa, wb, margin, words, cfg: SMCConfig, a,
                       window: int = 128, d_z: float = 12.0,
                       diag: dict | None = None, chain0: int = 0):
    """One sweep of n random-scan moves of every chain (columns of the
    z-sorted planes; `sort_and_margin`) through K4.

    CUDA tensors launch the kernel and count a "banded" launch in
    `kernels.sweep.sweep_block.launches`; N_pad beyond the resident
    capacity (`kernels.sweep.capacity`) raises, since the planes live in
    shared memory (tpu_smc's banded kernel is VMEM-resident only). CPU
    tensors run `banded_sweep_plain`. diag: on CUDA, filled with "rows",
    the schedule [n] the kernel drew (chain 0's); with "cycles": True,
    the SM clock cycles of each move phase (`PHASES`) summed over the
    sweep, [C, len(PHASES)] int64, from a diagnostic launch whose results
    are bitwise a plain one's. chain0: the global index of column 0, as
    in kernels.sweep.sweep_block.

    Returns (x, y, z, e [1, C], accepted [1, C] int32, fallback moves
    [1, C] int32)."""
    if not x.is_cuda:
        return banded_sweep_plain(x, y, z, e, wa, wb, margin, words, cfg, a,
                                  window, d_z, diag=diag, chain0=chain0)
    _check_window(window, d_z)
    if cfg.pbc_z:
        raise NotImplementedError("the banded kernel is for the wall "
                                  "(confined-z) system")
    n_pad, c = x.shape
    dev = x.device
    f32 = torch.float32
    for name, t in (("x", x), ("y", y), ("z", z), ("margin", margin)):
        ks._check(t, name, (n_pad, c), f32, dev)
    ks._check(e, "e", (1, c), f32, dev)
    if wa.dim() != 2 or wa.shape[0] != 1 or wa.shape[1] < cfg.m * cfg.m:
        raise ValueError(f"wa: need one shared row [1, MM_pad], got "
                         f"{tuple(wa.shape)}")
    ks._check(wa, "wa", wa.shape, f32, dev)
    ks._check(wb, "wb", wa.shape, f32, dev)
    sites = ks.wall_sites(cfg)
    cap = ks.capacity(dev, sites)[0]
    if n_pad > cap or n_pad < cfg.n:
        raise ValueError(
            f"N_pad = {n_pad} rows: the banded kernel holds its planes in "
            f"shared memory, at most {cap} rows with {sites} wall sites on "
            f"{torch.cuda.get_device_name(dev)} (nor does tpu_smc stream "
            "it): run fewer particles")
    scales = ks.chain_scales(a, cfg.temperature, c, dev)
    xo, yo, zo = (torch.empty_like(x) for _ in range(3))
    eo = torch.empty_like(e)
    acc = torch.empty((1, c), dtype=torch.int32, device=dev)
    fb = torch.empty_like(acc)
    rows = (torch.empty((cfg.n,), dtype=torch.int32, device=dev)
            if diag is not None else None)
    cycles = (torch.empty((c, len(PHASES)), dtype=torch.int64, device=dev)
              if diag is not None and diag.get("cycles") else None)
    lib = ks.build()
    with torch.cuda.device(dev):
        err = lib.smc_banded_launch(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), margin.data_ptr(),
            e.data_ptr(), wa.data_ptr(), wb.data_ptr(), scales.data_ptr(),
            xo.data_ptr(), yo.data_ptr(), zo.data_ptr(), eo.data_ptr(),
            acc.data_ptr(), fb.data_ptr(), ks._ptr(rows), ks._ptr(cycles),
            cfg.n, n_pad, c,
            cfg.m, int(cfg.use_walls), int(words[0]), int(words[1]),
            int(window), float(d_z), *ks._geometry(cfg), int(chain0),
            torch.cuda.current_stream(dev).cuda_stream)
    ks._raise_on("smc_banded_launch", err)
    ks._count("banded", cfg, a, None, 0, None, None, None)
    if diag is not None:
        diag["rows"] = rows
        if cycles is not None:
            diag["cycles"] = cycles
    return xo, yo, zo, eo, acc, fb


def visited_rows(fallback, n: int, n_pad: int, window: int):
    """Pair rows K4 visited in a sweep with `fallback` full-pass moves
    (per chain): two passes per move, min(2W, n_pad) rows each through
    the window, n_pad through the full pass."""
    w = min(2 * window, n_pad)
    return 2 * ((n - fallback) * w + fallback * n_pad)
