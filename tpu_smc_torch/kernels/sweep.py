"""Whole-sweep Smart-MC kernels (CUDA, csrc/sweep.cu): build, binding,
their plain PyTorch versions, the plane adapters and the capacity query.

Counterpart of tpu_smc/kernels/sweep_pallas.py `pallas_sweep_block` in its
dense and zskip modes and the 2-D (z-band, x-slice) refinement of zskip
(`xslices > 1`), with per-chain (A, T) (`per_chain_at`) and per-chain
wall coefficients (`per_chain_w`), in bulk (`cfg.pbc_z`, `use_walls=False`)
and in reference-noise mode (`cfg.reference_noise`, dense only, as on the
TPU), of its hbm_stream mode (`_pallas_sweep_block_stream`), and of the
test-only `debug_reference_noise` (`reference_noise_plane` is its plain
version). `sweep_block` launches the resident kernel
(planes in shared memory, N_pad up to `capacity(device, sites)[0]`) and
`sweep_block_stream` the streamed kernel K3 (planes in device memory,
chain-major for the call) for CUDA tensors; for CPU tensors they run
`sweep_block_plain` and `sweep_block_stream_plain`. Nothing else selects
between kernel and plain version.

The kernel is built at first use with plain `nvcc` into a shared library
with a C interface (tpu_smc_torch/_build/, keyed by the source's hash) and
bound with ctypes; no PyTorch headers are compiled.

Layout at this interface is the JAX package's: position planes [N_pad, C]
float32 (pad rows parked at 1e15), energy [1, C], per-sweep offsets [S]
and seed words [S, 2]. Wall coefficients are one shared row [1, MM_pad]
or a chain-major table [C, MM_pad] (the TPU kernel's per-chain planes are
[s_pad, C]). A and T are scalars or per-chain rows [C]. Unlike the TPU
kernel, x/y are NOT pre-scaled by 1/L inside: coordinates stay in real
units, so a call boundary rounds nothing and the kernel engines are
invariant to how a run is split into calls.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..config import SMCConfig

ROW_BLOCK = 128          # rows per z-skip block = threads per CTA
PARK = 1e15              # pad / parked rows: beyond every cutoff
# the phases of a move whose SM clock cycles a diagnostic launch sums per
# chain (diag={"cycles": True}; csrc/sweep.cu `Phase`, in its order)
PHASES = ("envelope", "pass 1", "reduction 1", "wall terms",
          "draws and proposal", "pass 2", "reduction 2",
          "acceptance and write-back", "end barrier")
_CSRC = Path(__file__).resolve().parent / "csrc" / "sweep.cu"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
_MASK32 = 0xFFFFFFFF


class KernelLaunchError(RuntimeError):
    """A launcher of csrc/sweep.cu returned the cudaError `code` of
    cudaGetLastError() after its launch."""

    def __init__(self, launcher: str, code: int):
        super().__init__(f"{launcher} failed: cudaError {code}")
        self.code = code


def _raise_on(launcher: str, err: int) -> None:
    if err != 0:
        raise KernelLaunchError(launcher, err)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_rows(n: int) -> int:
    """N_pad: the planes' rows for n particles (a multiple of 8)."""
    return _round_up(n, 8)


# ----------------------------------------------------------------------
# Philox4x32-10 (Salmon et al., SC'11), uint32 arithmetic in int64 ops
# ----------------------------------------------------------------------

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a * b for a constant a < 2^32 and b
    holding uint32 values in int64, without overflowing int64."""
    b_hi, b_lo = b >> 16, b & 0xFFFF
    p_lo = a * b_lo                        # < 2^48
    p_hi = a * b_hi                        # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)   # < 2^49
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of counters (c0..c3) under key (k0, k1); tensors of
    one shape holding uint32 values as int64. Returns four such tensors."""
    c = [t.to(torch.int64) & _MASK32 for t in (c0, c1, c2, c3)]
    k0 = k0.to(torch.int64) & _MASK32
    k1 = k1.to(torch.int64) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def unit_uniform(bits: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """((bits >> 8) | 1) * 2^-24: exact in float32, strictly in (0, 1)."""
    return ((bits >> 8) | 1).to(dtype) * (2.0 ** -24)


def move_uniforms(words, n: int, c: int, device=None,
                  dtype=torch.float32, chain0: int = 0) -> torch.Tensor:
    """The kernel's 5 uniforms of every move of one sweep: [n, c, 5] for
    seed words (w0, w1), counters (move, chain, 0|1, 0) with the GLOBAL
    chain index chain0 + c."""
    nn = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    ch = torch.arange(chain0, chain0 + c, dtype=torch.int64,
                      device=device)[None, :]
    nn, ch = torch.broadcast_tensors(nn, ch)
    k0 = torch.full_like(nn, int(words[0]))
    k1 = torch.full_like(nn, int(words[1]))
    z = torch.zeros_like(nn)
    b = philox4x32(nn, ch, z, z, k0, k1)
    b4 = philox4x32(nn, ch, z + 1, z, k0, k1)[0]
    return unit_uniform(torch.stack(b + [b4], dim=-1), dtype)


def noise_rows(n: int) -> int:
    """Rows of a reference-noise plane for n particles: the flat [3N]
    noise vector padded to a multiple of 8 (the TPU kernel's flat_pad)."""
    return _round_up(3 * n, 8)


def pair_uniforms(words, pairs: int, c: int, device=None,
                  dtype=torch.float32, chain0: int = 0) -> torch.Tensor:
    """The uniforms (u1, u2) of reference-noise pairs 0..pairs-1 of every
    chain: [pairs, c, 2], Philox of counters (pair, chain0 + chain, 2, 0)
    under the sweep's seed words (tag 2: apart from the move counters)."""
    k = torch.arange(pairs, dtype=torch.int64, device=device)[:, None]
    ch = torch.arange(chain0, chain0 + c, dtype=torch.int64,
                      device=device)[None, :]
    k, ch = torch.broadcast_tensors(k, ch)
    z = torch.zeros_like(k)
    b = philox4x32(k, ch, z + 2, z, torch.full_like(k, int(words[0])),
                   torch.full_like(k, int(words[1])))
    return unit_uniform(torch.stack(b[:2], dim=-1), dtype)


def pair_noise(u1: torch.Tensor, u2: torch.Tensor, s2a):
    """The reference's dependent Box-Muller pair (matematicose.c:187-192)
    with scale s2a = sqrt(2A): d0 = s sqrt(-2 ln(1-u1)) cos 2 pi u2 and
    d1 = s sqrt(-2 ln(1-u2)) sin 2 pi u1, the kernel's operation order."""
    two_pi = 2.0 * math.pi
    d0 = torch.sqrt(-2.0 * torch.log1p(-u1)) * s2a * torch.cos(two_pi * u2)
    d1 = torch.sqrt(-2.0 * torch.log1p(-u2)) * s2a * torch.sin(two_pi * u1)
    return d0, d1


def _pair_plane(u: torch.Tensor, s2a) -> torch.Tensor:
    """Pair uniforms [P, C, 2] -> the flat noise plane [2P, C]: row 2k + q
    holds component q of pair k."""
    d0, d1 = pair_noise(u[..., 0], u[..., 1], s2a)
    return torch.stack([d0, d1], dim=1).reshape(-1, u.shape[1])


def reference_noise_plane(words, n: int, c: int, s2a, device=None,
                          dtype=torch.float32,
                          chain0: int = 0) -> torch.Tensor:
    """Plain version of K5 (`debug_reference_noise`): the reference-noise
    plane [noise_rows(n), c] of one sweep's seed words, the pairs the
    kernel draws in reference-noise mode for global chains chain0 ..
    chain0 + c - 1; particle i's proposal noise is rows 3i..3i+2. s2a:
    scalar or one value per chain."""
    return _pair_plane(pair_uniforms(words, noise_rows(n) // 2, c, device,
                                     dtype, chain0), s2a)


def box_muller(u: torch.Tensor, s2a):
    """Proposal noise [.., 3] and acceptance uniform from 5 uniforms, the
    TPU kernel's recipe (3 Gaussians with sigma sqrt(2A) + 1 uniform);
    s2a is a scalar or one value per chain (the last axis of u[..., 0])."""
    two_pi = 2.0 * math.pi
    r1 = torch.sqrt(-2.0 * torch.log(u[..., 0])) * s2a
    g1 = r1 * torch.cos(two_pi * u[..., 1])
    g2 = r1 * torch.sin(two_pi * u[..., 1])
    g3 = torch.sqrt(-2.0 * torch.log(u[..., 2])) * s2a * torch.cos(
        two_pi * u[..., 3])
    return torch.stack([g1, g2, g3], dim=-1), u[..., 4]


# ----------------------------------------------------------------------
# Layout adapters: [C, N, 3]  <->  planes [N_pad, C]
# ----------------------------------------------------------------------

def to_planes(r: torch.Tensor, cfg: SMCConfig):
    """[C, N, 3] -> three [N_pad, C] float32 planes, pad rows at 1e15."""
    c, n, _ = r.shape
    n_pad = padded_rows(n)
    planes = r.permute(2, 1, 0).to(torch.float32)
    pad = torch.full((3, n_pad - n, c), PARK, dtype=torch.float32,
                     device=r.device)
    planes = torch.cat([planes, pad], dim=1).contiguous()
    return planes[0], planes[1], planes[2]


def from_planes(x, y, z, cfg: SMCConfig, dtype=None) -> torch.Tensor:
    """Three [N_pad, C] planes -> [C, N, 3]."""
    n = cfg.n
    out = torch.stack([x[:n], y[:n], z[:n]], dim=0).permute(2, 1, 0)
    return out.to(dtype) if dtype is not None else out.contiguous()


def wall_coeff_rows(w: torch.Tensor, cfg: SMCConfig):
    """W [MM, 2] -> padded [1, MM_pad] float32 rows (MM_pad = 128k); per-
    chain tables W [C, MM, 2] -> [C, MM_pad], row c for chain c. Pad
    sites carry zeros and contribute exactly 0."""
    mm = cfg.m * cfg.m
    mm_pad = _round_up(mm, 128)
    w3 = w.reshape((-1, mm, 2))
    wa = torch.zeros((w3.shape[0], mm_pad), dtype=torch.float32,
                     device=w.device)
    wb = torch.zeros_like(wa)
    wa[:, :mm] = w3[..., 0].to(torch.float32)
    wb[:, :mm] = w3[..., 1].to(torch.float32)
    return wa, wb


# ----------------------------------------------------------------------
# Plain PyTorch version
# ----------------------------------------------------------------------

def chain_scales(a, t, c: int, device, dtype=torch.float32) -> torch.Tensor:
    """[4, C] rows A/T, A/(4T), sqrt(2A), 1/T of every chain for mobility
    `a` and temperature `t` (each a scalar or [C]), computed in float64
    and rounded once to `dtype`: uniform rows are bitwise the scalar
    arithmetic of a float64 (A, T) rounded to float32."""
    f64 = dict(dtype=torch.float64, device=device)
    a = torch.as_tensor(a, **f64).expand(c)
    t = torch.as_tensor(t, **f64).expand(c)
    rows = torch.stack([a / t, a / (4.0 * t), torch.sqrt(2.0 * a), 1.0 / t])
    return rows.to(dtype).contiguous()


def _lane_sums(t: torch.Tensor) -> torch.Tensor:
    """[K, R, C] terms of R rows starting at a block boundary -> [K, C]:
    each lane (row mod 128) summed in ascending block order, as the
    kernel's threads add their rows, then the lanes as the kernel's
    block_sum4 adds them: a shuffle-down tree within each warp of 32,
    then the four warps in order. Every sum is elementwise adds in a
    fixed order, on every device, so a chain's result does not depend on
    how many chains share the call (torch's reductions over the lane
    axis change their order with the chain count). Blocks of exact zeros
    before, between or after the others change no sum, so a pass over
    the block envelope alone equals a masked pass over every row."""
    k, r, c = t.shape
    pad = -r % ROW_BLOCK
    if pad:
        t = torch.cat([t, t.new_zeros((k, pad, c))], dim=1)
    lanes = t.reshape(k, -1, ROW_BLOCK, c).cumsum(1)[:, -1]
    warps = lanes.reshape(k, ROW_BLOCK // 32, 32, c)
    off = 16
    while off:
        warps = warps[:, :, :off] + warps[:, :, off:2 * off]
        off //= 2
    out = warps[:, 0, 0]
    for w in range(1, ROW_BLOCK // 32):
        out = out + warps[:, w, 0]
    return out


def _pair_pass(qx, qy, qz, x, y, z, rows, cfg: SMCConfig):
    """LJ energy and force sums [C] of queries [C] against rows [R, C] of
    the planes (R from a block boundary); `rows` [R, C] bool restricts
    them (None = all). z takes the minimum image too under cfg.pbc_z."""
    inv_l = 1.0 / cfg.box_l
    dx = qx - x
    dx = dx - cfg.box_l * torch.round(dx * inv_l)
    dy = qy - y
    dy = dy - cfg.box_l * torch.round(dy * inv_l)
    dz = qz - z
    if cfg.pbc_z:
        dz = dz - cfg.box_lz * torch.round(dz * (1.0 / cfg.box_lz))
    dr2 = dx * dx + dy * dy + dz * dz
    mask = dr2 < cfg.cutoff2
    if rows is not None:
        mask = mask & rows
    inv2 = torch.where(mask, 1.0 / torch.clamp(dr2, min=1e-12),
                       torch.zeros_like(dr2))
    inv6 = inv2 * inv2 * inv2
    inv12 = inv6 * inv6
    ut = inv12 - inv6
    dv = (inv12 + ut) * inv2
    s = _lane_sums(torch.stack([ut, dv * dx, dv * dy, dv * dz]))
    return 4.0 * s[0], 24.0 * s[1], 24.0 * s[2], 24.0 * s[3]


def _wall_terms(qx, qy, qz, wa, wb, cfg: SMCConfig):
    """Uniform + grid wall energy and force [C] at query positions [C],
    site by site in the kernel's order; wa/wb [1 or C, MM_pad]."""
    box_l, box_lz = cfg.box_l, cfg.box_lz
    inv_l, inv_lz, half = 1.0 / box_l, 1.0 / box_lz, box_lz / 2.0
    dz = qz + half
    dz = dz - box_lz * torch.round(dz * inv_lz)
    dz = torch.where(qz <= -half, cfg.contact_dz,
                     torch.where(qz >= half, -cfg.contact_dz, dz))
    dz2 = dz * dz
    iz2 = 1.0 / dz2
    iz6 = iz2 * iz2 * iz2
    iz12 = iz6 * iz6
    us = cfg.a0 * iz12 - cfg.b0 * iz6
    fz0 = (48.0 * cfg.a0 * iz12 - 24.0 * cfg.b0 * iz6) * iz2 * dz
    # every site's terms at once [MM, C], then added site by site
    mm = cfg.m * cfg.m
    site = torch.arange(mm, device=qx.device)
    dw = box_l / cfg.m
    dxm = qx - (site // cfg.m).to(qx.dtype)[:, None] * dw
    dxm = dxm - box_l * torch.round(dxm * inv_l)
    dym = qy - (site % cfg.m).to(qx.dtype)[:, None] * dw
    dym = dym - box_l * torch.round(dym * inv_l)
    dr2 = dxm * dxm + dym * dym + dz2
    m = dr2 < cfg.cutoff2
    inv2 = 1.0 / torch.clamp(dr2, min=1e-12)
    inv6 = inv2 * inv2 * inv2
    inv12 = inv6 * inv6
    a, b = wa[:, :mm].T, wb[:, :mm].T     # shared [MM, 1] or per-chain [MM, C]
    zero = torch.zeros_like(dr2)
    u_s = torch.where(m, a * inv12 - b * inv6, zero)
    dv = torch.where(m, (48.0 * a * inv12 - 24.0 * b * inv6) * inv2, zero)
    # (u, fx, fy, dv) of each site [MM, 4, C], added site by site onto
    # (planar u, 0, 0, 0): one add per site for the four sums
    terms = torch.stack([u_s, dv * dxm, dv * dym, dv], dim=1)
    zero = torch.zeros_like(qx)
    acc = torch.stack([us, zero, zero, zero])
    for s in range(mm):
        acc = acc + terms[s]
    us, fx, fy, fzs = acc
    return 4.0 * us, fx, fy, fz0 + fzs * dz


def _envelope(sbmin, sbmax, lo, hi):
    """Each chain's block envelope [b_lo, b_hi) over [lo, hi] ([C] each;
    empty (nb, 0) when no block's live bounds reach it)."""
    nb = sbmin.shape[0]
    b = torch.arange(nb, device=sbmin.device)[:, None]
    need = (sbmin <= hi) & (sbmax >= lo)
    return (torch.where(need, b, nb).amin(0),
            torch.where(need, b + 1, 0).amax(0))


def xcut(cfg: SMCConfig) -> float:
    """Half-width of the x-slice admission window: the cutoff widened by a
    relative 1e-5 as the z window is, plus 1e-6 L for the float32
    rounding of coordinates up to L/2 (the wrap of the window's edge,
    the +L shift of the doubled index space)."""
    return float(cfg.lj_cutoff * (1.0 + 1e-5) + cfg.box_l * 1e-6)


def _xs_blocks(sbmin, sbmax, sxmin, sxmax, qx, qz, k: int, cfg: SMCConfig):
    """Blocks [nb, C] the 2-D pass visits for queries (qx, qz) [C]: the
    contiguous band envelope (bands of k blocks) whose z bounds reach the
    z window, and within each band the x-slices whose live bounds reach
    the circular x window [qx - xcut, qx + xcut]. The window's lower edge
    is wrapped into [-L/2, L/2); slice s of a band stands at index s
    (shift 0) and s + k (shift +L) of a doubled index space, where the
    window is one interval; the admitted run there is clamped to k
    entries, so it holds every residue at most once (sweep_pallas.py
    `pair_terms_2d`)."""
    nb, c = sbmin.shape
    zc = float(cfg.lj_cutoff * (1.0 + 1e-5))
    b_lo, b_hi = _envelope(sbmin, sbmax, qz - zc, qz + zc)
    bd_lo, bd_hi = b_lo // k, (b_hi + k - 1) // k
    box_l, xc = cfg.box_l, xcut(cfg)
    lo = qx - xc
    lo = lo - box_l * torch.floor(lo * (1.0 / box_l) + 0.5)
    hi = lo + min(2.0 * xc, box_l)
    bmin, bmax = sxmin.reshape(-1, k, c), sxmax.reshape(-1, k, c)
    need = torch.cat([(bmin <= hi) & (bmax >= lo),
                      (bmin + box_l <= hi) & (bmax + box_l >= lo)], dim=1)
    s = torch.arange(2 * k, device=sbmin.device)[None, :, None]
    s_lo = torch.where(need, s, 2 * k).amin(1, keepdim=True)
    s_hi = torch.minimum(torch.where(need, s + 1, 0).amax(1, keepdim=True),
                         s_lo + k)
    r = s[:, :k]
    adm = ((r >= s_lo) & (r < s_hi)) | ((r + k >= s_lo) & (r + k < s_hi))
    band = torch.arange(nb // k, device=sbmin.device)[:, None, None]
    return (adm & (band >= bd_lo) & (band < bd_hi)).reshape(nb, c)


def _envelope_pass(qx, qy, qz, x, y, z, i: int, b_lo, b_hi, cfg: SMCConfig):
    """The streamed kernel's pass: only rows of the blocks [min b_lo,
    max b_hi) are read, each chain's own envelope and the row id (not
    parking) select its terms. Returns the four sums and the rows of its
    own envelope [C]."""
    n_pad = x.shape[0]
    lo, hi = torch.stack([b_lo.min(), b_hi.max()]).tolist()
    lo, hi = lo * ROW_BLOCK, min(hi * ROW_BLOCK, n_pad)
    seen = torch.clamp(torch.minimum(b_hi * ROW_BLOCK, torch.full_like(
        b_hi, n_pad)) - b_lo * ROW_BLOCK, min=0)
    if hi <= lo:
        zero = torch.zeros_like(qx)
        return (zero, zero, zero, zero), seen
    j = torch.arange(lo, hi, device=x.device)[:, None]
    rows = (j >= b_lo * ROW_BLOCK) & (j < b_hi * ROW_BLOCK) & (j != i)
    return _pair_pass(qx, qy, qz, x[lo:hi], y[lo:hi], z[lo:hi], rows,
                      cfg), seen


def sweep_block_plain(x, y, z, e, wa, wb, offsets, seeds, cfg: SMCConfig,
                      n_sweeps: int, a, zskip: bool = False,
                      draws=None, diag: dict | None = None,
                      temperature=None, xslices: int = 0, chain0: int = 0):
    """Plain PyTorch version of the resident kernel: same arguments,
    results and semantics, in the dtype of the planes (float32 for the
    kernel's inputs; float64 for parity with tpu_smc.sampler.sweep).

    a, temperature: scalars or per-chain [C] (None = cfg.temperature);
    wa/wb: the shared [1, MM_pad] rows or per-chain [C, MM_pad] tables.

    The moving row is parked at 1e15 during its move, pads sit at 1e15,
    the acceptance uses the unwrapped displacement, and zskip restricts
    each pass to the block envelope the kernel visits; xslices = k > 1
    (with zskip) to the 2-D pass's blocks (`_xs_blocks`) over rows sorted
    by z-band of k blocks and by x within each band, with live x bounds
    per block beside the z bounds (`check_xslices`). Pair sums add each
    lane's rows in ascending block order, then the lanes (`_lane_sums`).
    Under cfg.pbc_z z wraps too, in the pair pass and the proposal, so
    the mover and the pads are masked by row id instead of parked; the
    wall terms are skipped when not cfg.use_walls. With
    cfg.reference_noise the proposal noise of particle i is rows
    3i..3i+2 of the sweep's pair plane (`reference_noise_plane`). Both
    modes are dense only, as on the TPU.

    draws: None = the kernel's own Philox stream, bit for bit (exact
    mode), for global chains chain0 .. chain0 + C - 1; or injected: (g [S, N, C, 3] proposal noise already scaled by
    sqrt(2A), u [S, N, C] acceptance uniforms), g indexed by MOVE; with
    cfg.reference_noise (pair uniforms [S, P, C, 2] with 2P >= 3N, u),
    made into the pair plane by the kernel's recipe and read by particle.
    diag: optional dict; filled with "visited" [C] (pair rows visited),
    "min_gap" [C] (smallest |min(log_ap, 0) - log u| of any move),
    "near_ties" [C] (moves with that gap below diag["tie_margin"],
    default 0) and, when it holds "uniforms": True on entry, the kernel's
    uniforms [S, C, N, 5] in exact mode (with reference noise (u1, u2) of
    the move's two pairs, then the acceptance uniform); with "moves":
    True, every move's "log_ap", "log_u", "accept" [S N, C] and the
    mover's position after it, "r" [S N, 3, C], in move order.

    Returns (x, y, z, e [1, C], e_trace [S, C], acc_trace [S, C] int32)."""
    mode = "zskip" if zskip else "dense"
    if check_xslices(cfg, x.shape[0], zskip, xslices):
        mode = "xskip"
    return _sweep_plain(x, y, z, e, wa, wb, offsets, seeds, cfg, n_sweeps,
                        a, mode, draws, diag, temperature, xslices, chain0)


def check_xslices(cfg: SMCConfig, n_pad: int, zskip: bool,
                  xslices: int) -> bool:
    """Whether a call runs the 2-D (z-band, x-slice) pass: xslices > 1.
    Refuses what sweep_pallas.py:273-283 refuses: without zskip, with
    reference noise, and k that does not divide the row blocks (pbc_z
    and streaming are refused for every z-skip pass)."""
    if xslices <= 1:
        return False
    if not zskip:
        raise NotImplementedError("xslices refines the zskip engine")
    if cfg.reference_noise:
        raise NotImplementedError("xslices requires i.i.d. noise")
    nb = -(-n_pad // ROW_BLOCK)
    if nb % xslices:
        raise ValueError(f"xslices {xslices} must divide the {nb} row blocks")
    return True


def sweep_block_stream_plain(x, y, z, e, wa, wb, offsets, seeds,
                             cfg: SMCConfig, n_sweeps: int, a, draws=None,
                             diag: dict | None = None, temperature=None,
                             chain0: int = 0):
    """Plain PyTorch version of the streamed kernel (K3), with
    sweep_block_plain's arguments and results (z-skip always on). Like
    K3 it reads, per pass, only the rows of the block envelope (`_envelope_
    pass`) and excludes the moving row by its row id instead of parking
    it; on the same rows it is bitwise sweep_block_plain(zskip=True)."""
    return _sweep_plain(x, y, z, e, wa, wb, offsets, seeds, cfg, n_sweeps,
                        a, "stream", draws, diag, temperature, chain0=chain0)


def _dense_only(cfg: SMCConfig, mode: str) -> None:
    """Bulk and reference-noise sweeps run dense only, in both versions:
    z-skip assumes confined z and a fixed row order (the TPU kernel
    refuses zskip under pbc_z, sweep_pallas.py:271-272, and never streams
    either mode, tpu_smc/ensemble.py:434)."""
    if mode != "dense" and (cfg.pbc_z or cfg.reference_noise):
        raise NotImplementedError(
            f"the {mode} sweep takes neither pbc_z nor reference_noise; "
            "they run on the dense sweep only")


def _sweep_plain(x, y, z, e, wa, wb, offsets, seeds, cfg: SMCConfig,
                 n_sweeps: int, a, mode: str, draws, diag, temperature,
                 xslices: int = 0, chain0: int = 0):
    """The plain sweep loop; mode "dense", "zskip", "xskip" (xslices
    blocks per band) or "stream"."""
    _dense_only(cfg, mode)
    x, y, z, e = x.clone(), y.clone(), z.clone(), e.clone().reshape(-1)
    n, (n_pad, c) = cfg.n, x.shape
    dt, dev = x.dtype, x.device
    t = cfg.temperature if temperature is None else temperature
    a_t, a_4t, s2a, inv_t = chain_scales(a, t, c, dev, dt)
    zcut = float(cfg.lj_cutoff * (1.0 + 1e-5))
    nb = -(-n_pad // ROW_BLOCK)
    e_trace = torch.empty((n_sweeps, c), dtype=dt, device=dev)
    a_trace = torch.empty((n_sweeps, c), dtype=torch.int32, device=dev)
    visited = torch.zeros((c,), dtype=torch.int64, device=dev)
    min_gap = torch.full((c,), float("inf"), dtype=dt, device=dev)
    near_ties = torch.zeros((c,), dtype=torch.int64, device=dev)
    tie_margin = float(diag.get("tie_margin", 0.0)) if diag else 0.0
    dump = [] if diag is not None and diag.get("uniforms") else None
    moves = [] if diag is not None and diag.get("moves") else None
    rows_j = torch.arange(n_pad, device=dev)[:, None]
    rn, park = cfg.reference_noise, not cfg.pbc_z and mode != "stream"

    def pass_sums(qx, qy, qz, i):
        """Pair sums of the queries against the planes and rows visited."""
        if mode == "stream":
            b_lo, b_hi = _envelope(sbmin, sbmax, qz - zcut, qz + zcut)
            return _envelope_pass(qx, qy, qz, x, y, z, i, b_lo, b_hi, cfg)
        rows = None
        if mode == "zskip":
            b_lo, b_hi = _envelope(sbmin, sbmax, qz - zcut, qz + zcut)
            rows = (rows_j >= b_lo * ROW_BLOCK) & (rows_j < b_hi * ROW_BLOCK)
        elif mode == "xskip":
            rows = _xs_blocks(sbmin, sbmax, sxmin, sxmax, qx, qz, xslices,
                              cfg)[rows_j[:, 0] // ROW_BLOCK]
        cnt = n_pad if rows is None else rows.sum(0)
        if cfg.pbc_z:
            # a wrapped park value lands in the box: mask mover and pads
            rows = (rows_j != i) & (rows_j < n)
        return _pair_pass(qx, qy, qz, x, y, z, rows, cfg), cnt

    for s in range(n_sweeps):
        off = int(offsets[s])
        if draws is None:
            u5 = move_uniforms(seeds[s], n, c, dev, dt, chain0)
            u_all = u5[..., 4]
            if rn:
                up = pair_uniforms(seeds[s], noise_rows(n) // 2, c, dev, dt,
                                   chain0)
            else:
                g_all, u_all = box_muller(u5, s2a)
            if dump is not None and rn:
                # the kernel's dump: (u1, u2) of the move's two pairs, u_acc
                k = 3 * ((torch.arange(n, device=dev) + off) % n) // 2
                dump.append(torch.cat([up[k], up[k + 1], u5[..., 4:]],
                                      dim=-1).permute(1, 0, 2))
            elif dump is not None:
                dump.append(u5.permute(1, 0, 2))
        elif rn:
            up, u_all = draws[0][s], draws[1][s]
        else:
            g_all, u_all = draws[0][s], draws[1][s]
        if rn:
            plane = _pair_plane(up, s2a)
        if mode != "dense":
            # exact bounds of the real rows per block at sweep start
            zp = torch.cat([z, z.new_full((nb * ROW_BLOCK - n_pad, c), PARK)])
            zp = zp.reshape(nb, ROW_BLOCK, c)
            real = zp < 1e14
            sbmin = torch.where(real, zp, PARK).amin(1)
            sbmax = torch.where(real, zp, -PARK).amax(1)
            if mode == "xskip":
                xp = torch.cat([x, x.new_full((nb * ROW_BLOCK - n_pad, c),
                                              PARK)]).reshape(nb, ROW_BLOCK, c)
                sxmin = torch.where(real, xp, PARK).amin(1)
                sxmax = torch.where(real, xp, -PARK).amax(1)
        acc = torch.zeros((c,), dtype=torch.int32, device=dev)
        for nn in range(n):
            i = (nn + off) % n
            xi, yi, zi = x[i].clone(), y[i].clone(), z[i].clone()
            if park:
                x[i] = PARK
                y[i] = PARK
                z[i] = PARK
            (um, fmx, fmy, fmz), cnt = pass_sums(xi, yi, zi, i)
            visited += cnt
            if cfg.use_walls:
                uw, wx, wy, wz = _wall_terms(xi, yi, zi, wa, wb, cfg)
                um, fmx, fmy, fmz = um + uw, fmx + wx, fmy + wy, fmz + wz

            # noise by particle id (displ[3n], SMC.c:309) or by move
            g = plane[3 * i:3 * i + 3].T if rn else g_all[nn]
            u_acc = u_all[nn]
            ddx = fmx * a_t + g[:, 0]
            ddy = fmy * a_t + g[:, 1]
            ddz = fmz * a_t + g[:, 2]
            px = xi + ddx
            px = px - cfg.box_l * torch.round(px * (1.0 / cfg.box_l))
            py = yi + ddy
            py = py - cfg.box_l * torch.round(py * (1.0 / cfg.box_l))
            pz = zi + ddz
            if cfg.pbc_z:
                pz = pz - cfg.box_lz * torch.round(pz * (1.0 / cfg.box_lz))

            (un, fnx, fny, fnz), cnt = pass_sums(px, py, pz, i)
            visited += cnt
            if cfg.use_walls:
                uw, wx, wy, wz = _wall_terms(px, py, pz, wa, wb, cfg)
                un, fnx, fny, fnz = un + uw, fnx + wx, fny + wy, fnz + wz

            dfx, dfy, dfz = fnx - fmx, fny - fmy, fnz - fmz
            dw_term = (dfx * dfx + dfy * dfy + dfz * dfz
                       + 2.0 * (dfx * fmx + dfy * fmy + dfz * fmz)) * a_4t
            log_ap = -(un - um
                       + 0.5 * (ddx * (fnx + fmx) + ddy * (fny + fmy)
                                + ddz * (fnz + fmz))
                       + dw_term) * inv_t
            # a NaN log_ap rejects, as with jnp.minimum on the TPU
            accept = (log_ap >= 0.0) | (u_acc < torch.exp(log_ap))
            gap = (torch.clamp(log_ap, max=0.0) - torch.log(u_acc)).abs()
            min_gap = torch.minimum(min_gap, gap)
            near_ties += gap < tie_margin

            x[i] = torch.where(accept, px, xi)
            y[i] = torch.where(accept, py, yi)
            z[i] = torch.where(accept, pz, zi)
            if moves is not None:
                moves.append((log_ap, torch.log(u_acc), accept,
                              torch.stack([x[i], y[i], z[i]])))
            if mode != "dense":
                ib = i // ROW_BLOCK
                sbmin[ib] = torch.minimum(sbmin[ib], pz)
                sbmax[ib] = torch.maximum(sbmax[ib], pz)
                if mode == "xskip":
                    # a seam-wrapping write widens the linear x interval:
                    # loose, never unsafe
                    sxmin[ib] = torch.minimum(sxmin[ib], px)
                    sxmax[ib] = torch.maximum(sxmax[ib], px)
            e = e + torch.where(accept, un - um, torch.zeros_like(un))
            acc += accept.to(torch.int32)
        e_trace[s] = e
        a_trace[s] = acc
    if diag is not None:
        diag["visited"] = visited
        diag["min_gap"] = min_gap
        diag["near_ties"] = near_ties
        if dump is not None:
            diag["uniforms"] = torch.stack(dump) if dump else None
        if moves is not None:
            diag["moves"] = {k: torch.stack(v) for k, v in zip(
                ("log_ap", "log_u", "accept", "r"), zip(*moves))}
    return x, y, z, e.reshape(1, c), e_trace, a_trace


# ----------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ----------------------------------------------------------------------

class _Build:
    """The compiled kernel library, built once per process, and the
    capacities it reports per device index."""
    lib = None
    log = ""
    seconds = 0.0
    capacity: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return path


def build() -> ctypes.CDLL:
    """Compile csrc/sweep.cu with nvcc (sm_90a) into _build/ unless a
    library built from the same source exists, and load it."""
    if _Build.lib is not None:
        return _Build.lib
    import time

    src = _CSRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so = _BUILD / f"sweep_{tag}.so"
    t0 = time.perf_counter()
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(_CSRC)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        _Build.log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{_Build.log}")
        os.replace(tmp, so)
    _Build.seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.smc_sweep_launch.argtypes = [P] * 18 + [I] * 11 + [D] * 7 + [I, P]
    lib.smc_sweep_launch.restype = I
    lib.smc_sweep_stream_launch.argtypes = ([P] * 15 + [I] * 7 + [D] * 6
                                            + [I, P])
    lib.smc_sweep_stream_launch.restype = I
    lib.smc_sweep_capacity.argtypes = [I, I] + [ctypes.POINTER(
        ctypes.c_longlong)] * 2
    lib.smc_sweep_capacity.restype = I
    lib.smc_banded_launch.argtypes = [P] * 16 + [I] * 8 + [D] * 7 + [I, P]
    lib.smc_banded_launch.restype = I
    lib.smc_debug_reference_noise.argtypes = [P, I, I, P, I, I, D, I, P]
    lib.smc_debug_reference_noise.restype = I
    lib.smc_empty_launch.argtypes = [I, I, P]
    lib.smc_empty_launch.restype = I
    _Build.lib = lib
    return lib


def wall_sites(cfg: SMCConfig) -> int:
    """Wall sites whose coefficients a launch for cfg holds in shared
    memory: M*M, none without walls."""
    return cfg.m * cfg.m if cfg.use_walls else 0


def capacity(device, sites: int = 0) -> tuple[int, int]:
    """(resident, streamed): the largest N_pad each kernel takes on the
    CUDA `device` with `sites` wall sites (`wall_sites(cfg)`). The
    resident kernel holds three planes and the 2 x sites wall
    coefficients in shared memory (the device's opt-in limit per block,
    cudaDevAttrMaxSharedMemoryPerBlockOptin, beside the kernel's static
    shared memory) and at most MAX_BLOCKS = 256 blocks of 128 rows; the
    streamed kernel holds the wall coefficients and two floats of block
    bounds per 128 rows."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if (idx, sites) not in _Build.capacity:
        res, stream = ctypes.c_longlong(), ctypes.c_longlong()
        err = build().smc_sweep_capacity(idx, sites, ctypes.byref(res),
                                         ctypes.byref(stream))
        if err != 0:
            raise RuntimeError(f"smc_sweep_capacity failed: cudaError {err}")
        _Build.capacity[idx, sites] = (res.value, stream.value)
    return _Build.capacity[idx, sites]


def resident_fits(n_pad: int, device=None, sites: int = 0) -> bool:
    """Whether the resident kernel takes N_pad rows and `sites` wall
    sites on `device` (default: the current CUDA device). The plain
    versions that CPU tensors run have no such limit."""
    device = torch.device("cuda") if device is None else torch.device(device)
    return device.type != "cuda" or n_pad <= capacity(device, sites)[0]


def chain_major(x, y, z):
    """[N_pad, C] planes <-> chain-major [C, N_pad] planes (the streamed
    kernel's layout, where a 128-row block of one chain is contiguous);
    the adapter is its own inverse."""
    return tuple(p.T.contiguous() for p in (x, y, z))


def _check(t: torch.Tensor, name: str, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: need contiguous {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _cuda_call(x, y, z, e, wa, wb, offsets, seeds, cfg: SMCConfig,
               n_sweeps: int, a, diag, temperature):
    """Checked inputs and fresh outputs of one launch of either kernel:
    (offsets, seeds, scales, w_stride, e_out, e_trace, acc_trace,
    visited, u_dump, cycles), the last three None unless `diag` asks."""
    n_pad, c = x.shape
    dev = x.device
    f32 = torch.float32
    for name, t in (("x", x), ("y", y), ("z", z)):
        _check(t, name, (n_pad, c), f32, dev)
    _check(e, "e", (1, c), f32, dev)
    if wa.dim() != 2 or wa.shape[0] not in (1, c):
        raise ValueError(f"wa: need [1, MM_pad] or [{c}, MM_pad], got "
                         f"{tuple(wa.shape)}")
    _check(wa, "wa", wa.shape, f32, dev)
    _check(wb, "wb", wa.shape, f32, dev)
    if wa.shape[-1] < cfg.m * cfg.m or n_pad < cfg.n:
        raise ValueError("wall rows or planes shorter than the config")
    w_stride = wa.shape[1] if wa.shape[0] == c and c > 1 else 0
    offsets = offsets.to(device=dev, dtype=torch.int32).contiguous()
    seeds = seeds.to(device=dev, dtype=torch.int32).contiguous()
    _check(offsets, "offsets", (n_sweeps,), torch.int32, dev)
    _check(seeds, "seeds", (n_sweeps, 2), torch.int32, dev)
    visited = u_dump = cycles = None
    if diag is not None:
        visited = torch.empty((c,), dtype=torch.int64, device=dev)
    if diag is not None and diag.get("uniforms"):
        u_dump = torch.empty((n_sweeps, c, cfg.n, 5), dtype=f32, device=dev)
    if diag is not None and diag.get("cycles"):
        cycles = torch.empty((c, len(PHASES)), dtype=torch.int64, device=dev)
    t = cfg.temperature if temperature is None else temperature
    return (offsets, seeds, chain_scales(a, t, c, dev), w_stride,
            torch.empty_like(e),
            torch.empty((n_sweeps, c), dtype=f32, device=dev),
            torch.empty((n_sweeps, c), dtype=torch.int32, device=dev),
            visited, u_dump, cycles)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _count(kind: str, cfg: SMCConfig, a, temperature, w_stride: int, diag,
           visited, u_dump, cycles=None):
    """Count a launch by kind and mode; hand the diagnostics over."""
    launches = sweep_block.launches
    launches[kind] += 1
    if torch.is_tensor(a) or torch.is_tensor(temperature):
        launches["per_chain_at"] += 1
    if w_stride:
        launches["per_chain_w"] += 1
    if cfg.pbc_z:
        launches["pbc_z"] += 1
    if not cfg.use_walls:
        launches["no_walls"] += 1
    if cfg.reference_noise:
        launches["reference_noise"] += 1
    if diag is not None:
        diag["visited"] = visited
        if u_dump is not None:
            diag["uniforms"] = u_dump
        if cycles is not None:
            diag["cycles"] = cycles


def _geometry(cfg: SMCConfig):
    return (float(cfg.box_l), float(cfg.box_lz), float(cfg.lj_cutoff),
            float(cfg.contact_dz), float(cfg.a0), float(cfg.b0))


def _sweep_block_cuda(x, y, z, e, wa, wb, offsets, seeds, cfg: SMCConfig,
                      n_sweeps: int, a, zskip: bool, diag, temperature,
                      xslices: int, chain0: int):
    n_pad, c = x.shape
    dev = x.device
    xs = check_xslices(cfg, n_pad, zskip, xslices)
    _dense_only(cfg, "zskip" if zskip else "dense")
    (offsets, seeds, scales, w_stride, eo, e_tr, a_tr, visited, u_dump,
     cycles) = _cuda_call(x, y, z, e, wa, wb, offsets, seeds, cfg, n_sweeps,
                          a, diag, temperature)
    # the 2-D pass keeps its x bounds (2 floats per block) in dynamic
    # shared memory beside the wall sites (2 floats each)
    sites = wall_sites(cfg) + (-(-n_pad // ROW_BLOCK) if xs else 0)
    if not resident_fits(n_pad, dev, sites):
        instead = ("bulk (pbc_z) and reference-noise sweeps have no "
                   "streamed kernel (nor in tpu_smc): run fewer particles "
                   "or the plain engine" if cfg.pbc_z or cfg.reference_noise
                   else "the 2-D x-slice pass has no streamed kernel (nor in "
                   "tpu_smc): run it at fewer particles" if xs
                   else "run the streamed kernel instead (sweep_block_stream, "
                   "or ensemble_sweeps_zsorted, which routes there by itself)")
        raise ValueError(
            f"N_pad = {n_pad} rows exceed the resident sweep kernel's "
            f"capacity on {torch.cuda.get_device_name(dev)} "
            f"({capacity(dev, sites)[0]} rows: three planes and {sites} "
            f"wall sites in shared memory, at most 256 blocks); {instead}")
    lib = build()
    xo, yo, zo = (torch.empty_like(x) for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.smc_sweep_launch(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), e.data_ptr(),
            wa.data_ptr(), wb.data_ptr(), offsets.data_ptr(), seeds.data_ptr(),
            scales.data_ptr(), xo.data_ptr(), yo.data_ptr(), zo.data_ptr(),
            eo.data_ptr(), e_tr.data_ptr(), a_tr.data_ptr(), _ptr(visited),
            _ptr(u_dump), _ptr(cycles), cfg.n, n_pad, c, n_sweeps, cfg.m,
            int(bool(zskip)),
            w_stride, int(cfg.pbc_z), int(cfg.use_walls),
            int(cfg.reference_noise), xslices if xs else 0, *_geometry(cfg),
            xcut(cfg), int(chain0), stream)
    _raise_on("smc_sweep_launch", err)
    _count("xskip" if xs else "zskip" if zskip else "dense", cfg, a,
           temperature, w_stride, diag, visited, u_dump, cycles)
    return xo, yo, zo, eo, e_tr, a_tr


def _sweep_block_stream_cuda(x, y, z, e, wa, wb, offsets, seeds,
                             cfg: SMCConfig, n_sweeps: int, a, diag,
                             temperature, chain0: int):
    n_pad, c = x.shape
    dev = x.device
    _dense_only(cfg, "stream")
    (offsets, seeds, scales, w_stride, eo, e_tr, a_tr, visited, u_dump,
     cycles) = _cuda_call(x, y, z, e, wa, wb, offsets, seeds, cfg, n_sweeps,
                          a, diag, temperature)
    rows = capacity(dev, wall_sites(cfg))[1]
    if n_pad > rows:
        raise ValueError(f"N_pad = {n_pad} rows exceed the streamed sweep "
                         f"kernel's capacity ({rows} rows)")
    lib = build()
    xc, yc, zc = chain_major(x, y, z)        # updated in place by the kernel
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.smc_sweep_stream_launch(
            xc.data_ptr(), yc.data_ptr(), zc.data_ptr(), e.data_ptr(),
            wa.data_ptr(), wb.data_ptr(), offsets.data_ptr(), seeds.data_ptr(),
            scales.data_ptr(), eo.data_ptr(), e_tr.data_ptr(), a_tr.data_ptr(),
            _ptr(visited), _ptr(u_dump), _ptr(cycles), cfg.n, n_pad, c,
            n_sweeps, cfg.m,
            w_stride, int(cfg.use_walls), *_geometry(cfg), int(chain0),
            stream)
    _raise_on("smc_sweep_stream_launch", err)
    _count("stream", cfg, a, temperature, w_stride, diag, visited, u_dump,
           cycles)
    return (*chain_major(xc, yc, zc), eo, e_tr, a_tr)


def sweep_block(x, y, z, e, wa, wb, offsets, seeds, cfg: SMCConfig,
                n_sweeps: int, a, zskip: bool = False,
                diag: dict | None = None, temperature=None,
                xslices: int = 0, chain0: int = 0):
    """n_sweeps Smart-MC sweeps of every chain (columns of the planes) on
    the resident kernel.

    a, temperature: scalars or per-chain [C] (None = cfg.temperature);
    wa/wb: shared rows [1, MM_pad] or per-chain tables [C, MM_pad].

    CUDA tensors go through the CUDA kernel and count a launch in
    `sweep_block.launches`: by kernel ("dense", "zskip", "xskip" for the
    2-D pass, "stream" for sweep_block_stream, "banded" for
    kernels.banded), and also as "per_chain_at" when a or
    temperature is per-chain and "per_chain_w" with per-chain wall
    tables, and by mode as "pbc_z", "no_walls" (use_walls=False) and
    "reference_noise" (both dense only). N_pad beyond
    `capacity(device, wall_sites(cfg))[0]` raises, naming the streamed kernel where the
    mode has one. CPU tensors go through the plain version.
    zskip: rows must be z-sorted per chain for the skips to pay; results
    are bitwise those of zskip=False on the same row order.
    xslices = k > 1 (with zskip; K1-xs): rows sorted by z-band of k
    blocks and by x within each band; each pass visits the admitted
    (z, x) blocks in ascending order, so results are again bitwise those
    of zskip=False on the same rows. Resident kernel and i.i.d. noise
    only, k dividing the row blocks (`check_xslices`).
    diag (CUDA): filled with "visited" [C]; with "uniforms": True, the
    move uniforms [S, C, N, 5]; with "cycles": True, the SM clock cycles
    of each move phase (`PHASES`) summed over the call, [C, len(PHASES)]
    int64. A diagnostic launch gives bitwise the results of a plain one.
    chain0: the global index of column 0, the chain word of every Philox
    counter (column c draws chain chain0 + c's stream), so a call over
    columns [k, k + C') of a wider ensemble with chain0 = k is bitwise
    those columns of the wider call; 0 is every earlier result.

    Returns (x, y, z, e [1, C], e_trace [S, C], acc_trace [S, C])."""
    if x.is_cuda:
        return _sweep_block_cuda(x, y, z, e, wa, wb, offsets, seeds, cfg,
                                 n_sweeps, a, zskip, diag, temperature,
                                 xslices, chain0)
    return sweep_block_plain(x, y, z, e, wa, wb, offsets, seeds, cfg,
                             n_sweeps, a, zskip=zskip, diag=diag,
                             temperature=temperature, xslices=xslices,
                             chain0=chain0)


def sweep_block_stream(x, y, z, e, wa, wb, offsets, seeds, cfg: SMCConfig,
                       n_sweeps: int, a, diag: dict | None = None,
                       temperature=None, chain0: int = 0):
    """sweep_block(zskip=True) on the streamed kernel (K3): the planes
    stay in device memory (chain-major for the call), so N is bounded by
    device memory, not shared memory. Same arguments and results; on the
    same rows bitwise the resident z-skip kernel. CUDA tensors count a
    "stream" launch; CPU tensors go through sweep_block_stream_plain.
    chain0 as in sweep_block."""
    if x.is_cuda:
        return _sweep_block_stream_cuda(x, y, z, e, wa, wb, offsets, seeds,
                                        cfg, n_sweeps, a, diag, temperature,
                                        chain0)
    return sweep_block_stream_plain(x, y, z, e, wa, wb, offsets, seeds, cfg,
                                    n_sweeps, a, diag=diag,
                                    temperature=temperature, chain0=chain0)


def debug_reference_noise(words, n: int, c: int, s2a: float, device="cuda",
                          chain0: int = 0):
    """K5: one reference-noise plane [noise_rows(n), c] float32 for the
    seed words (w0, w1) and the scale s2a = sqrt(2A), from the device
    function the reference-noise sweep draws its pairs with (test-only,
    as tpu_smc's debug_reference_noise); column c holds global chain
    chain0 + c's pairs. A CUDA `device` launches the
    kernel and counts a "debug_reference_noise" launch in
    sweep_block.launches; the CPU runs reference_noise_plane. Words in a
    tensor on the launch's card are read by the kernel, not the host, so
    the call does not wait for the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return reference_noise_plane(words, n, c, float(s2a), device,
                                     chain0=chain0)
    rows = noise_rows(n)
    out = torch.empty((rows, c), dtype=torch.float32, device=device)
    on_card = torch.is_tensor(words) and words.is_cuda
    if on_card:
        words = words.to(device=device, dtype=torch.int64).reshape(-1)
        words = words[:2].contiguous()
        k0 = k1 = 0
    else:
        k0, k1 = int(words[0]), int(words[1])
    lib = build()
    with torch.cuda.device(device):
        err = lib.smc_debug_reference_noise(
            out.data_ptr(), rows, c, words.data_ptr() if on_card else None,
            k0, k1, float(s2a), int(chain0),
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on("smc_debug_reference_noise", err)
    sweep_block.launches["debug_reference_noise"] += 1
    return out


def empty_launch(n: int, c: int, device="cuda") -> None:
    """An empty kernel on K5's grid for a [noise_rows(n), c] plane: the
    launch floor K5's device time is read against. Computes nothing and
    counts no launch; CUDA only."""
    device = torch.device(device)
    with torch.cuda.device(device):
        err = build().smc_empty_launch(
            noise_rows(n), c, torch.cuda.current_stream(device).cuda_stream)
    _raise_on("smc_empty_launch", err)


sweep_block.launches = {"dense": 0, "zskip": 0, "xskip": 0, "stream": 0,
                        "banded": 0,
                        "per_chain_at": 0, "per_chain_w": 0, "pbc_z": 0,
                        "no_walls": 0, "reference_noise": 0,
                        "debug_reference_noise": 0}
