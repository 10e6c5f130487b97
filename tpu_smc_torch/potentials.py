"""Lennard-Jones pair and surface-wall physics on tensors with a leading
chain axis (PyTorch counterpart of tpu_smc.potentials).

Reference semantics (file:line cites into the C original, as in the JAX
package):
  - pair energy/force of one particle:  SMC.c:557-618  (energySingle, forceSingle)
  - total pair energy / virial:          SMC.c:626-720
  - wall energy/force of one particle:   SMC.c:729-813
  - total wall energy / virial:          SMC.c:822-895

Conventions kept from the reference:
  * minimum image in x and y only (z unwrapped); the bulk variant
    (cfg.pbc_z) wraps z too;
  * pair cutoff tested on r^2 < LJ_CUTOFF^2;
  * V = 4 (r^-12 - r^-6); force kernel (-dV/dr)/r = 48 r^-14 - 24 r^-8;
  * the uniform wall term uses the signed distance to the NEAREST wall,
    clamped at contact.

Every function takes positions R [C, N, 3] (C chains) and returns one
value per chain; `torch.round` is round-half-to-even like C `rint` and
`jnp.round`.
"""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch

from .config import SMCConfig

# The count of outputs from which torch's CUDA sum over a contiguous last
# axis keeps one order: below it the block gives more threads to each
# output (Reduce.cuh's block shape follows the outputs up to 16 rows of
# 32 threads; over another axis, up to 32 outputs), so on an H100 a
# chain's sum of a row of N terms (measured from N = 96 on, not at 32;
# scripts/torch_shard_sums.py) would follow the chains that share its
# call.
ROW_ORDER_OUTPUTS = 16

# The chains of the unsplit call whose chains the calls made now hold a
# share of (split_of, chain_block); 0 outside a split.
_WHOLE = [0]


@contextlib.contextmanager
def _whole(chains: int):
    _WHOLE.append(int(chains))
    try:
        yield
    finally:
        _WHOLE.pop()


def split_of(chains: int, shares: int):
    """The calls inside hold one of `shares` shares of the chain axis of
    an unsplit call over `chains` chains (a card's shard, a rank's
    chains; one share is no split): chain_sum then adds each chain's
    terms in that call's order. A split inside a split (a rank's
    shards) keeps the outer count, the whole run's. The one case it
    misses: an unsplit call that cuts its W > b chains into blocks of b
    (chain_block) and ends in a shorter block below 16 chains, whose
    order no share sees."""
    return _whole(_WHOLE[-1] or (chains if shares > 1 else 0))


def chain_block(b: int):
    """The calls inside hold one block of at most b chains of a call cut
    into such blocks: under a split the unsplit call's block holds
    min(b, its chains)."""
    return _whole(min(b, _WHOLE[-1]))


def split_chains() -> int:
    """The unsplit call's chains in force (0 outside split_of)."""
    return _WHOLE[-1]


def chain_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x.sum(dim) of x [C, ...] over C chains; under a split, beside the
    zero chains padded_chains asks for: each chain's sum then takes the
    unsplit call's order."""
    want = padded_chains(x, dim)
    if not want:
        return x.sum(dim)
    c = x.shape[0]
    pad = x.new_zeros((want - c,) + x.shape[1:])
    return torch.cat([x, pad]).sum(dim)[:c]


def padded_chains(x: torch.Tensor, dim: int = -1) -> int:
    """The chains chain_sum(x, dim) pads x [C, ...] to, 0 for none: under
    split_of(W), min(W, ROW_ORDER_OUTPUTS) when C is fewer and the count
    of chains can reorder the sum (over the last axis with fewer than
    ROW_ORDER_OUTPUTS rows, or over another axis)."""
    want = min(ROW_ORDER_OUTPUTS, _WHOLE[-1])
    if x.dim() < 2 or x.shape[0] >= want or (
            dim == -1 and x.numel() // max(x.shape[-1], 1)
            >= ROW_ORDER_OUTPUTS):
        return 0
    return want


def _min_image(d: torch.Tensor, period: float) -> torch.Tensor:
    return d - period * torch.round(d / period)


def wrap_xy(r: torch.Tensor, cfg: SMCConfig) -> torch.Tensor:
    """Wrap positions into the periodic x/y box (shiftSystem2D,
    SMC.c:521-527); z too when cfg.pbc_z."""
    x = _min_image(r[..., 0], cfg.box_l)
    y = _min_image(r[..., 1], cfg.box_l)
    z = _min_image(r[..., 2], cfg.box_lz) if cfg.pbc_z else r[..., 2]
    return torch.stack([x, y, z], dim=-1)


def _periods(cfg: SMCConfig, box, lead: int):
    """Periods of x, y, z (None: z unwrapped). `box`, the side of a
    cubic fully periodic box per chain (shape [...]), overrides cfg's
    dims: it gains `lead` trailing axes to broadcast against the
    particle axes (tpu_smc's traced `box`, bulk only)."""
    if box is None:
        return cfg.box_l, cfg.box_l, cfg.box_lz if cfg.pbc_z else None
    assert cfg.pbc_z, "a per-chain box is bulk-only (cubic PBC)"
    p = box.reshape(box.shape + (1,) * lead)
    return p, p, p


def _pair_displacements(ri: torch.Tensor, R: torch.Tensor, cfg: SMCConfig,
                        box=None):
    """ri [..., 3] against R [..., N, 3] -> d [..., N, 3], dr2 [..., N].
    box: per-chain cubic side [...] in place of cfg's dims (NPT, Gibbs);
    the same operations, so a box equal to cfg's gives cfg's bits."""
    px, py, pz = _periods(cfg, box, 1)
    d = ri.unsqueeze(-2) - R
    dx = _min_image(d[..., 0], px)
    dy = _min_image(d[..., 1], py)
    dz = _min_image(d[..., 2], pz) if pz is not None else d[..., 2]
    d = torch.stack([dx, dy, dz], dim=-1)
    return d, dx * dx + dy * dy + dz * dz


def _lj_terms(d: torch.Tensor, dr2: torch.Tensor, mask: torch.Tensor,
              cfg: SMCConfig):
    """Masked LJ energy and force sums over the last particle axis."""
    safe = torch.where(mask, dr2, torch.ones_like(dr2))
    inv2 = 1.0 / safe
    inv6 = inv2 * inv2 * inv2
    inv12 = inv6 * inv6
    zero = torch.zeros_like(dr2)
    u = 4.0 * chain_sum(torch.where(mask, inv12 - inv6, zero))
    if cfg.lj_shift:
        rc6 = cfg.cutoff2 ** 3
        u = u - 4.0 * (1.0 / (rc6 * rc6) - 1.0 / rc6) * mask.to(u.dtype).sum(-1)
    dv = torch.where(mask, (48.0 * inv12 - 24.0 * inv6) * inv2, zero)
    f = chain_sum(dv.unsqueeze(-1) * d, -2)
    return u, f


def pair_energy_force_single(R: torch.Tensor, i, ri: torch.Tensor,
                             cfg: SMCConfig, active=None,
                             box=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pair energy of and force on a particle at `ri` [C, 3], excluding
    particle index `i` (int or [C] tensor; -1 excludes none) of R
    [C, N, 3]. active [C, N] bool: only those particles interact (the
    capacity slots of GCMC and Gibbs; applied before 1/dr2, so parked
    slots may hold anything, exact overlaps included). box [C]: the
    per-chain cubic side (NPT, Gibbs); the cutoff stays cfg's.
    Returns (U [C], F [C, 3])."""
    n = R.shape[-2]
    d, dr2 = _pair_displacements(ri, R, cfg, box)
    idx = torch.arange(n, device=R.device)
    # a number excludes one index of every chain (no host copy: a CUDA
    # graph may be capturing), a tensor one per chain
    mask = (dr2 < cfg.cutoff2) & (idx != (i.reshape(-1, 1) if torch.is_tensor(i)
                                          else int(i)))
    if active is not None:
        mask = mask & active
    return _lj_terms(d, dr2, mask, cfg)


# Elements of one [B, rows, N] pair temporary (256 MB in float32): the
# all-pairs sums run over row chunks of this size, so no [N, N] tensor
# per chain exists at any N.
PAIR_BUDGET = 1 << 26


def pair_row_chunk(b: int, n: int) -> int:
    """Rows per chunk of an all-pairs pass over b chains of n particles:
    b * rows * n stays within PAIR_BUDGET (one row at least)."""
    return max(1, PAIR_BUDGET // max(b * n, 1))


def _pair_dr2_rows(R: torch.Tensor, r0: int, r1: int, cfg: SMCConfig,
                   box=None, active=None):
    """Squared distances [..., r1 - r0, N] of particles r0..r1-1 to all
    particles and the in-cutoff mask without the self pairs (no
    [..., rows, N, 3] displacement tensor); box [...] and active
    [..., N] as in pair_energy_force_single (both ends of a pair
    active)."""
    n = R.shape[-2]
    periods = _periods(cfg, box, 2)

    def comp(k):
        dk = R[..., r0:r1, k].unsqueeze(-1) - R[..., :, k].unsqueeze(-2)
        return _min_image(dk, periods[k]) if periods[k] is not None else dk

    dx = comp(0)
    dr2 = dx * dx
    del dx
    dy = comp(1)
    dr2 += dy * dy
    del dy
    dz = comp(2)
    dr2 += dz * dz
    del dz
    rows = torch.arange(r0, r1, device=R.device)[:, None]
    cols = torch.arange(n, device=R.device)[None, :]
    mask = (dr2 < cfg.cutoff2) & (rows != cols)
    if active is not None:
        mask = mask & active[..., r0:r1, None] & active[..., None, :]
    return dr2, mask


def _pair_sum(R: torch.Tensor, cfg: SMCConfig, term, box=None,
              active=None) -> torch.Tensor:
    """Sum over ordered pairs i != j within the cutoff of term(inv6,
    mask) [..., rows, N] per configuration (the leading axes), in blocks
    of a fixed count of configurations within PAIR_BUDGET: each
    configuration's sum then takes the same row chunks whatever the
    count of chains beside it, so that a chain-sharded run is bitwise
    the unsharded one (the row chunk of a call over every chain at once
    shrinks as the chains grow). Within a block, row chunk by row chunk:
    each row's sum over j, then the rows."""
    n = R.shape[-2]
    lead = R.shape[:-2]
    step = max(1, PAIR_BUDGET // max(n * n, 1))
    flat = R.reshape((-1,) + R.shape[-2:])
    with chain_block(step):
        if flat.shape[0] <= step:
            return _pair_sum_block(R, cfg, term, box, active)
        box_f = None if box is None else box.expand(lead).reshape(-1)
        act_f = (None if active is None
                 else active.expand(lead + (n,)).reshape(-1, n))
        return torch.cat([_pair_sum_block(
            flat[b0:b0 + step], cfg, term,
            None if box_f is None else box_f[b0:b0 + step],
            None if act_f is None else act_f[b0:b0 + step])
            for b0 in range(0, flat.shape[0], step)]).reshape(lead)


def _pair_sum_block(R: torch.Tensor, cfg: SMCConfig, term, box=None,
                    active=None) -> torch.Tensor:
    """_pair_sum of one block of configurations. Under a per-chain box
    (NPT, Gibbs: their volume moves sum each shard's chains on its own)
    the rows are added in a fixed order (fixed_order_sum); the fixed
    box's sums run on whole ensembles and keep torch's."""
    n = R.shape[-2]
    rows = pair_row_chunk(max(1, R[..., 0, 0].numel()), n)
    total = R.new_zeros(R.shape[:-2])
    for r0 in range(0, n, rows):
        dr2, mask = _pair_dr2_rows(R, r0, min(n, r0 + rows), cfg, box,
                                   active)
        safe = torch.where(mask, dr2, torch.ones_like(dr2))
        inv6 = 1.0 / (safe * safe * safe)
        per_row = chain_sum(term(inv6, mask))
        total = total + (chain_sum(per_row) if box is None
                         else fixed_order_sum(per_row))
    return total


def fixed_order_sum(x: torch.Tensor) -> torch.Tensor:
    """x [..., R] summed over its last axis in one order on every device
    and at any count of leading entries: zeros pad R to a power of two,
    then halves are added elementwise. torch's CUDA sum over that axis
    changes its order with the count of outputs (on an H100, with fewer
    than 16 chains at R >= 96), so a chain's sum would follow the
    chains that share its call."""
    r = x.shape[-1]
    p = 1 << max(r - 1, 0).bit_length()
    if p != r:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (p - r,))], -1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def pair_energy_total(R: torch.Tensor, cfg: SMCConfig, box=None,
                      active=None) -> torch.Tensor:
    """Total pair energy per chain, all unique pairs (SMC.c:626-646);
    box [...] and active [..., N] as in pair_energy_force_single."""
    shift = 0.0
    if cfg.lj_shift:
        rc6 = cfg.cutoff2 ** 3
        shift = 1.0 / (rc6 * rc6) - 1.0 / rc6

    def term(inv6, mask):
        u = torch.where(mask, inv6 * inv6 - inv6, torch.zeros_like(inv6))
        return 4.0 * (u - shift * mask.to(u.dtype)) if shift else 4.0 * u

    return 0.5 * _pair_sum(R, cfg, term, box, active)


def pair_virial_pressure(R: torch.Tensor, cfg: SMCConfig,
                         box=None) -> torch.Tensor:
    """Virial pair pressure -sum(24 r^-6 - 48 r^-12)/(3 L^2 Lz) per chain
    (SMC.c:696-720); box [...]: the per-chain cubic side and volume."""
    p = 0.5 * _pair_sum(R, cfg, lambda inv6, mask: torch.where(
        mask, 24.0 * inv6 - 48.0 * inv6 * inv6, torch.zeros_like(inv6)),
        box)
    if box is not None:
        return -p / (3.0 * (box * box * box))
    return -p / (3.0 * cfg.box_l * cfg.box_l * cfg.box_lz)


# ----------------------------------------------------------------------
# Walls
# ----------------------------------------------------------------------

def wall_site_positions(cfg: SMCConfig, dtype=None, device=None) -> torch.Tensor:
    """In-plane coordinates of the M*M wall sites at (i*L/M, j*L/M),
    m = i*M + j ordering (SMC.c:748-751). Returns [M*M, 2]."""
    dw = cfg.box_l / cfg.m
    # i * dw in the run's dtype, as tpu_smc computes it: an integer index
    # times a float32 default would round L/M to float32 in float64 runs
    # (made on `device`: no host copy, so a CUDA graph can capture it)
    idx = torch.arange(cfg.m, dtype=dtype or cfg.torch_dtype, device=device)
    ii, jj = torch.meshgrid(idx, idx, indexing="ij")
    return torch.stack([ii.reshape(-1) * dw, jj.reshape(-1) * dw], dim=-1)


def make_wall_params(x0, ym, cfg: SMCConfig) -> torch.Tensor:
    """The per-site (a, b) coefficient table W [M*M, 2] from site widths
    x0 and well depths ym: a = x0^12 ym, b = x0^6 ym (SMC.c:495-496),
    computed in the inputs' dtype (float64 for numpy arrays) and cast to
    the run's."""
    x0, ym = torch.as_tensor(x0), torch.as_tensor(ym)
    a = torch.pow(x0, 12.0) * ym
    b = torch.pow(x0, 6.0) * ym
    return torch.stack([a, b], dim=-1).to(cfg.torch_dtype)


def sample_wall_params(words, cfg: SMCConfig, device="cuda") -> torch.Tensor:
    """Gaussian-randomized wall coefficients (initializeWalls,
    SMC.c:475-501): x0 ~ N(x0_mean, x0_sigma), ym ~ N(ym_mean, ym_sigma)
    per site, from the port's Philox stream under the seed words `words`
    [2]: site m's four words of counters (m, 0x3A11, 0, 0) give two
    Box-Muller Gaussians in float64. The reference's srand(42) table is
    system.build_walls."""
    from .kernels.sweep import philox4x32, unit_uniform

    mm = cfg.m * cfg.m
    m = torch.arange(mm, dtype=torch.int64, device=device)
    z = torch.zeros_like(m)
    w0, w1 = (int(v) for v in torch.as_tensor(words).reshape(2))
    u = [unit_uniform(b, torch.float64)
         for b in philox4x32(m, z + 0x3A11, z, z, z + w0, z + w1)]

    def gauss(u1, u2):
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi
                                                             * u2)

    x0 = cfg.wall_x0_mean + cfg.wall_x0_sigma * gauss(u[0], u[1])
    ym = cfg.wall_ym_mean + cfg.wall_ym_sigma * gauss(u[2], u[3])
    return make_wall_params(x0, ym, cfg)


def _site_coeffs(W: torch.Tensor, dr2: torch.Tensor):
    """Per-site (a, b) broadcastable against dr2 [C, ..., MM]: from the
    shared table W [MM, 2], or from per-chain tables W [C, MM, 2]
    (quenched wall disorder) with chain c's row against dr2[c]."""
    a, b = W[..., 0].to(dr2.dtype), W[..., 1].to(dr2.dtype)
    if W.dim() == 3:
        shape = (W.shape[0],) + (1,) * (dr2.dim() - 2) + (W.shape[1],)
        a, b = a.reshape(shape), b.reshape(shape)
    return a, b


def _wall_dz(rz: torch.Tensor, cfg: SMCConfig) -> torch.Tensor:
    """Signed distance to the nearest wall with the contact clamp
    (SMC.c:736-739)."""
    lz = cfg.box_lz
    dz = rz + lz / 2.0
    dz = dz - lz * torch.round(dz / lz)
    c = cfg.contact_dz
    return torch.where(rz <= -lz / 2.0, torch.full_like(dz, c),
                       torch.where(rz >= lz / 2.0, torch.full_like(dz, -c), dz))


def wall_energy_force_single(rpos: torch.Tensor, W: torch.Tensor,
                             cfg: SMCConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wall energy of and force on particles at rpos [..., 3]: the uniform
    planar 12-6 term on the nearest-wall distance plus the M*M grid sites
    with per-site (a, b) = W [M*M, 2] (SMC.c:729-813), or per-chain tables
    W [C, M*M, 2] against rpos [C, ..., 3].
    Returns (U [...], F [..., 3])."""
    rx, ry, rz = rpos[..., 0], rpos[..., 1], rpos[..., 2]
    dz = _wall_dz(rz, cfg)
    dz2 = dz * dz
    izv2 = 1.0 / dz2
    izv6 = izv2 * izv2 * izv2
    izv12 = izv6 * izv6
    u = cfg.a0 * izv12 - cfg.b0 * izv6
    fz = (48.0 * cfg.a0 * izv12 - 24.0 * cfg.b0 * izv6) * izv2 * dz

    sites = wall_site_positions(cfg, rpos.dtype, rpos.device)
    dx = _min_image(rx.unsqueeze(-1) - sites[:, 0], cfg.box_l)   # [..., MM]
    dy = _min_image(ry.unsqueeze(-1) - sites[:, 1], cfg.box_l)
    dr2 = dx * dx + dy * dy + dz2.unsqueeze(-1)
    mask = dr2 < cfg.cutoff2
    safe = torch.where(mask, dr2, torch.ones_like(dr2))
    inv2 = 1.0 / safe
    inv6 = inv2 * inv2 * inv2
    inv12 = inv6 * inv6
    a, b = _site_coeffs(W, dr2)
    zero = torch.zeros_like(dr2)
    u = u + chain_sum(torch.where(mask, a * inv12 - b * inv6, zero))
    dv = torch.where(mask, (48.0 * a * inv12 - 24.0 * b * inv6) * inv2, zero)
    fx = chain_sum(dv * dx)
    fy = chain_sum(dv * dy)
    fz = fz + chain_sum(dv) * dz
    return 4.0 * u, torch.stack([fx, fy, fz], dim=-1)


def wall_energy_total(R: torch.Tensor, W: torch.Tensor,
                      cfg: SMCConfig) -> torch.Tensor:
    """Total particle-wall energy per chain (SMC.c:822-859)."""
    return chain_sum(wall_energy_force_single(R, W, cfg)[0])


def wall_virial_pressure(R: torch.Tensor, W: torch.Tensor, cfg: SMCConfig,
                         reproduce_ref_bug: bool = False) -> torch.Tensor:
    """Wall virial pressure per chain (SMC.c:862-895), with the
    reference's dz = rz + L/2 bug fixed unless reproduce_ref_bug; no
    contact clamp, and the uniform-wall virial counted once per in-cutoff
    site, as in the reference (see tpu_smc.potentials). W: [M*M, 2] or
    per-chain [C, M*M, 2]."""
    half = (cfg.box_l if reproduce_ref_bug else cfg.box_lz) / 2.0
    sites = wall_site_positions(cfg, R.dtype, R.device)
    dz = R[..., 2] + half
    dz = (dz - cfg.box_lz * torch.round(dz / cfg.box_lz)).unsqueeze(-1)
    dx = _min_image(R[..., 0].unsqueeze(-1) - sites[:, 0], cfg.box_l)
    dy = _min_image(R[..., 1].unsqueeze(-1) - sites[:, 1], cfg.box_l)
    dr2 = dx * dx + dy * dy + dz * dz
    a, b = _site_coeffs(W, dr2)
    mask = dr2 < cfg.cutoff2
    safe = torch.where(mask, dr2, torch.ones_like(dr2))
    inv6 = 1.0 / (safe * safe * safe)
    term = 24.0 * b * inv6 - 48.0 * a * inv6 * inv6
    dz6 = dz ** 6
    term0 = 24.0 * cfg.b0 / dz6 - 48.0 * cfg.a0 / (dz6 * dz6)
    p = chain_sum(chain_sum(torch.where(mask, term + term0,
                                    torch.zeros_like(dr2))))
    return -p / (3.0 * cfg.box_l * cfg.box_l * cfg.box_lz)


# ----------------------------------------------------------------------
# Combined evaluations
# ----------------------------------------------------------------------

def energy_force_single(R: torch.Tensor, i, ri: torch.Tensor, W: torch.Tensor,
                        cfg: SMCConfig, active=None,
                        box=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """U [C] and F [C, 3] of particle i at ri [C, 3]: pair + wall terms
    (the four calls per evaluation of oneParticleMoves, SMC.c:300-321);
    active and box as in pair_energy_force_single."""
    u, f = pair_energy_force_single(R, i, ri, cfg, active, box)
    if cfg.use_walls:
        assert box is None, "a per-chain box is bulk-only"
        uw, fw = wall_energy_force_single(ri, W, cfg)
        u = u + uw
        f = f + fw
    return u, f


def total_forces(R: torch.Tensor, W: torch.Tensor, cfg: SMCConfig) -> torch.Tensor:
    """Total force on every particle [C, N, 3]: pair + wall terms."""
    n = R.shape[-2]
    d, dr2 = _pair_displacements(R, R.unsqueeze(-3), cfg)
    mask = (dr2 < cfg.cutoff2) & ~torch.eye(n, dtype=torch.bool,
                                             device=R.device)
    f = _lj_terms(d, dr2, mask, cfg)[1]
    if cfg.use_walls:
        f = f + wall_energy_force_single(R, W, cfg)[1]
    return f


def total_energy(R: torch.Tensor, W: torch.Tensor, cfg: SMCConfig) -> torch.Tensor:
    """Total potential energy per chain: pair + wall (SMC.c:48)."""
    u = pair_energy_total(R, cfg)
    if cfg.use_walls:
        u = u + wall_energy_total(R, W, cfg)
    return u


def total_pressure(R: torch.Tensor, W: torch.Tensor, cfg: SMCConfig) -> torch.Tensor:
    """Virial pressure per chain, pair + wall (SMC.c:140); the ideal-gas
    term is added by the driver."""
    p = pair_virial_pressure(R, cfg)
    if cfg.use_walls:
        p = p + wall_virial_pressure(R, W, cfg)
    return p
