"""Umbrella sampling along z with replica exchange between windows
(REUS) and the MBAR-unbiased potential of mean force (counterpart of
tpu_smc.umbrella; no reference counterpart).

K harmonic windows b_k(z) = k_spring/2 (z_tag - z0_k)^2 bias a tagged
particle's z toward centers spanning a region that plain sampling does
not visit (the wall's contact layer); MBAR stitches the biased
histograms into the unbiased F(z). The window axis is the chain axis,
window-major [K, replicas], so one engine call advances every window.

The windows run on the port's plain engine (ensemble.ensemble_sweeps
with sampler.sweep's `umbrella` bias) on the chains' device: tpu_smc
runs umbrella sampling on its XLA sweep, never on its Pallas kernel,
and the CUDA kernels carry no bias term either. The bias enters only
the acceptance; the draws are the plain engine's counter-based Philox
streams, keyed to the absolute sweep.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import RunParams, SMCConfig
from .state import ChainState, fold_in, init_ensemble_state

__all__ = [
    "UmbrellaResults", "simulate_umbrella", "umbrella_pmf",
    "parse_centers", "write_umbrella_csv", "exchange_windows_step",
]

# salts of the window-exchange stream (tpu_smc: 0xB1A5) and of its
# uniforms' counters
_EXCHANGE_FOLD = 0xB1A5
_EXCHANGE_SALT = 0xB1A6


class UmbrellaResults(NamedTuple):
    centers: np.ndarray        # [K] window centers z0_k
    k_spring: float
    tag: int
    temperature: float
    z_samples: np.ndarray      # [samples, K, replicas] tagged-particle z
    acceptance: np.ndarray     # [K] production acceptance per window
    # the MBAR-unbiased PMF (umbrella_pmf)
    z_grid: np.ndarray | None = None       # [B] bin centers
    pmf: np.ndarray | None = None          # [B], min-shifted, NaN empty
    err_pmf: np.ndarray | None = None      # [B] replica-bootstrap SE
    window_f: np.ndarray | None = None     # [K] MBAR window free energies
    # replica exchange between windows (None without it)
    swap_acceptance: np.ndarray | None = None   # [K-1] per adjacent pair
    exchange_interval: int | None = None
    sweeps_per_second: float | None = None      # production chain-sweeps/s


def _umbrella_sweeps(state: ChainState, w, cfg: SMCConfig, z0_c, k_spring,
                     tag: int, a: float, n_sweeps: int, seed=None,
                     devices=None):
    """n_sweeps biased sweeps of every chain, window center z0_c [C] per
    chain, on the plain engine (one visiting order for all chains); on a
    CUDA state each sweep replays a captured CUDA graph (sampler.run_step).
    devices: the chains split over them (ensemble_sweeps_sharded), the
    state gathered back in chain order."""
    from .ensemble import ensemble_sweeps, ensemble_sweeps_sharded

    bias = (tag, k_spring, z0_c)
    if devices:
        return ensemble_sweeps_sharded(state, w, cfg, a, n_sweeps, seed,
                                       devices, umbrella=bias)[0]
    return ensemble_sweeps(state, w, cfg, a, n_sweeps, stream_seed=seed,
                           umbrella=bias)[0]


def exchange_uniforms(key: torch.Tensor, n_w: int, replicas: int, device,
                      dtype) -> torch.Tensor:
    """[n_w, replicas] uniforms in (0, 1) of one window-exchange attempt:
    Philox4x32-10 of (index, _EXCHANGE_SALT, 0, 0) under its seed words."""
    from .kernels.sweep import philox4x32, unit_uniform

    idx = torch.arange(n_w * replicas, dtype=torch.int64, device=device)
    z = torch.zeros_like(idx)
    b = philox4x32(idx, z + _EXCHANGE_SALT, z, z, z + int(key[0]),
                   z + int(key[1]))
    return unit_uniform(b[0], dtype).reshape(n_w, replicas)


def exchange_windows_step(state: ChainState, centers_w: torch.Tensor,
                          k_spring: float, tag: int, beta: float,
                          replicas: int, key: torch.Tensor | None,
                          parity: int, uniforms: torch.Tensor | None = None):
    """One replica-exchange attempt between ADJACENT windows (REUS),
    window-major [K, R]: the bias stays with the slot, configurations
    (r, E, rbin) travel. U is unchanged by a swap, so

        log P = +beta k (z0_i - z0_j)(z_j - z_i)

    for the pair (i, j = i + 1), even or odd pairs by `parity`, as
    tpu_smc.umbrella.exchange_windows_step. uniforms [K, R] replaces the
    draws made from `key` (tests inject tpu_smc's). Returns (state,
    accepts [K-1], attempts [K-1])."""
    n_w = centers_w.shape[0]
    dev, dt = state.r.device, state.r.dtype
    if uniforms is None:
        uniforms = exchange_uniforms(key, n_w, replicas, dev, dt)
    u = uniforms.to(device=dev, dtype=dt)
    cw = centers_w.to(device=dev, dtype=dt)
    z = state.r[:, tag, 2].reshape(n_w, replicas)
    idx = torch.arange(n_w, device=dev)
    is_lo = ((idx % 2) == (int(parity) % 2)) & (idx + 1 < n_w)
    up = torch.clamp(idx + 1, max=n_w - 1)
    dz0 = (cw - cw[up])[:, None]                      # z0_i - z0_j
    delta = beta * k_spring * dz0 * (z[up] - z)
    accept_lo = is_lo[:, None] & (torch.log(u) < delta)
    from_below = torch.cat([torch.zeros_like(accept_lo[:1]),
                            accept_lo[:-1]])
    col = idx[:, None].expand(n_w, replicas)
    partner = torch.where(accept_lo, col + 1,
                          torch.where(from_below, col - 1, col))

    def swap(x):
        xl = x.reshape((n_w, replicas) + x.shape[1:])
        p = partner.reshape(partner.shape + (1,) * (xl.dim() - 2))
        return torch.take_along_dim(xl, p.expand(xl.shape), dim=0) \
            .reshape(x.shape)

    new = state.replace(r=swap(state.r), energy=swap(state.energy),
                        rbin=swap(state.rbin))
    accepts = accept_lo.sum(dim=1)[:-1].to(torch.int64)
    attempts = (is_lo.to(torch.int64) * replicas)[:-1]
    return new, accepts, attempts


def simulate_umbrella(cfg: SMCConfig, params: RunParams, centers,
                      key: torch.Tensor, k_spring: float = 4.0, tag: int = 0,
                      replicas: int = 4, r0: np.ndarray | None = None,
                      w: np.ndarray | None = None,
                      exchange_interval: int | None = None, device="cuda",
                      stream_seed=None,
                      devices=None) -> tuple[ChainState, UmbrellaResults]:
    """K windows x `replicas` chains from one start (window-major), on
    the plain engine. Thermalization doubles A (SMC.c:110, 125) with the
    bias on; production samples the tagged z once per gather (or, with
    `exchange_interval`, once per exchange cycle of that many sweeps,
    maxsteps // interval cycles). Exchange attempts fold the absolute
    cycle index into their seed words and take its parity.
    devices: the window ladder's chains split over these devices
    (ensemble.make_mesh; tpu_smc shards the chain axis so), one
    contiguous range each, a shard boundary possibly inside a window:
    the sweeps run on the shards with their global chain indices and
    the global chain 0's streams, each exchange on the joined (r, E,
    rbin) on `device`, where the state lives between calls. Bitwise the
    one-device run."""
    from .driver import _sync, therm_chunk

    centers = np.asarray(centers, np.float64)
    n_w = len(centers)
    c = n_w * replicas
    half = cfg.box_lz / 2.0
    if np.any(np.abs(centers) >= half):
        raise ValueError(f"umbrella centers must lie inside the slab "
                         f"(|z0| < {half})")
    if not 0 <= tag < cfg.n:
        raise ValueError(f"--umbrella-tag must be in [0, {cfg.n})")
    state, w_t = init_ensemble_state(cfg, key, c, r0=r0, w=w, device=device)
    dt = cfg.torch_dtype
    z0_c = torch.as_tensor(np.repeat(centers, replicas), dtype=dt,
                           device=device)
    k_spring, tag = float(k_spring), int(tag)

    def run(st, a, n):
        return _sync(_umbrella_sweeps(st, w_t, cfg, z0_c, k_spring, tag, a,
                                      n, seed=stream_seed, devices=devices))

    chunk = therm_chunk(cfg)
    done = 0
    while done < params.eqsteps:
        k = min(params.eqsteps - done, chunk)
        state = run(state, 2.0 * cfg.proposal_a, k)
        done += k
    state = state.replace(accepted=torch.zeros_like(state.accepted))

    import time

    t0 = time.perf_counter()
    z_rows = []
    swap_acc = None
    if exchange_interval:
        interval = max(1, int(exchange_interval))
        cycles = max(1, params.maxsteps // interval)
        centers_w = torch.as_tensor(centers, dtype=dt, device=device)
        ekey = fold_in(state.key[0].cpu(), [_EXCHANGE_FOLD])[0]
        acc_sw = np.zeros((max(n_w - 1, 0),), np.int64)
        att_sw = np.zeros_like(acc_sw)
        cycle0 = int(state.sweeps[0]) // interval
        for k in range(cycles):
            state = run(state, cfg.proposal_a, interval)
            abs_k = cycle0 + k
            state, a_c, t_c = exchange_windows_step(
                state, centers_w, k_spring, tag, 1.0 / cfg.temperature,
                replicas, fold_in(ekey, [abs_k])[0], abs_k % 2)
            acc_sw += a_c.cpu().numpy()
            att_sw += t_c.cpu().numpy()
            z_rows.append(state.r[:, tag, 2].cpu().numpy())
        total_sweeps = cycles * interval
        swap_acc = acc_sw / np.maximum(att_sw, 1)
    else:
        lapse = max(1, params.gather_lapse)
        n_gathers = max(1, params.maxsteps // lapse)
        for _ in range(n_gathers):
            state = run(state, cfg.proposal_a, lapse)
            z_rows.append(state.r[:, tag, 2].cpu().numpy())
        total_sweeps = n_gathers * lapse
    sps = total_sweeps * c / max(time.perf_counter() - t0, 1e-9)
    moves = state.accepted.cpu().numpy().astype(np.int64)
    acc = moves.reshape(n_w, replicas).mean(axis=1) / (total_sweeps * cfg.n)
    return state, UmbrellaResults(
        centers=centers, k_spring=k_spring, tag=tag,
        temperature=float(cfg.temperature),
        z_samples=np.stack(z_rows).reshape(-1, n_w, replicas),
        acceptance=np.asarray(acc), swap_acceptance=swap_acc,
        exchange_interval=(int(exchange_interval)
                           if exchange_interval else None),
        sweeps_per_second=sps)


def umbrella_pmf(res: UmbrellaResults, n_bins: int = 48,
                 z_range: tuple | None = None, n_boot: int = 16,
                 seed: int = 0) -> UmbrellaResults:
    """MBAR-unbias the window samples into F(z) on a regular grid over
    z_range (default: the samples' span, padded by 2 %), as
    tpu_smc.umbrella.umbrella_pmf: u_kn = beta b_k(z_m) (the physical
    energy cancels sample-wise), the float32 fixed point of
    reweight._mbar_fixed_point, F = -T ln p min-shifted with NaN where no
    sample landed, errors from a replica bootstrap."""
    from .reweight import _mbar_fixed_point, pmf_from_profile

    t = res.temperature
    beta = 1.0 / t
    centers = np.asarray(res.centers, np.float64)
    g, n_w, reps = res.z_samples.shape
    if z_range is None:
        lo = float(res.z_samples.min())
        hi = float(res.z_samples.max())
        pad = 0.02 * (hi - lo + 1e-9)
        z_range = (lo - pad, hi + pad)
    edges = np.linspace(z_range[0], z_range[1], n_bins + 1)
    zc = 0.5 * (edges[:-1] + edges[1:])
    f32 = torch.float32

    def estimate(idx):
        z = res.z_samples[:, :, idx]                       # [g, K, R']
        z_k = [z[:, k].reshape(-1) for k in range(n_w)]
        z_pooled = torch.as_tensor(np.concatenate(z_k), dtype=f32)
        log_n = torch.as_tensor(np.log([zk.size for zk in z_k]), dtype=f32)
        cj = torch.as_tensor(centers, dtype=f32)
        u_kn = (0.5 * beta * res.k_spring) * (z_pooled[None, :]
                                              - cj[:, None]) ** 2
        f_k, _ = _mbar_fixed_point(u_kn, log_n, 2e-6, 5_000)
        log_denom = torch.logsumexp(log_n[:, None] + f_k[:, None] - u_kn,
                                    dim=0)
        logw = -log_denom
        logw = logw - torch.logsumexp(logw, dim=0)
        wgt = torch.exp(logw).double().numpy()
        hist, _ = np.histogram(np.concatenate(z_k), bins=edges, weights=wgt)
        p, _ = pmf_from_profile([t], hist[None, :] + 0.0)
        return p[0], f_k.double().numpy()

    pmf, f_k = estimate(np.arange(reps))
    err = None
    if n_boot > 0 and reps > 1:
        rng = np.random.default_rng(seed)
        draws = [estimate(rng.integers(0, reps, size=reps))[0]
                 for _ in range(n_boot)]
        err = np.nanstd(np.stack(draws), axis=0)
    return res._replace(z_grid=zc, pmf=pmf, err_pmf=err, window_f=f_k)


def parse_centers(spec: str) -> np.ndarray:
    """CLI spec: 'zmin:zmax:num' (inclusive linspace) or 'z1,z2,...'."""
    if ":" in spec:
        parts = spec.split(":")
        if len(parts) != 3:
            raise ValueError(f"bad umbrella spec {spec!r} "
                             "(want zmin:zmax:num or z1,z2,...)")
        lo, hi, num = float(parts[0]), float(parts[1]), int(parts[2])
        if num < 2 or hi <= lo:
            raise ValueError(f"bad umbrella spec {spec!r} "
                             "(need zmin < zmax, num >= 2)")
        return np.linspace(lo, hi, num)
    return np.asarray([float(v) for v in spec.split(",")], np.float64)


def write_umbrella_csv(d, cfg: SMCConfig, res: UmbrellaResults):
    """umbrella_pmf csv: `z, F, err` (NaN = never visited), then the
    windows as comment rows `# window, z0, f, acceptance`."""
    from .io import _fname

    p = _fname(d, "umbrella_pmf", cfg)
    with open(p, "w") as f:
        f.write("z, F, err\n")
        for b in range(len(res.z_grid)):
            e = (res.err_pmf[b] if res.err_pmf is not None
                 else float("nan"))
            f.write(f"{res.z_grid[b]:0.6f}, {res.pmf[b]:0.9f}, {e:0.9f}\n")
        f.write("# window, z0, f, acceptance\n")
        for k in range(len(res.centers)):
            f.write(f"# {k}, {res.centers[k]:0.4f}, "
                    f"{res.window_f[k]:0.6f}, {res.acceptance[k]:0.4f}\n")
    return p
