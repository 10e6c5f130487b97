"""Chain-ensemble sweep engines (counterpart of tpu_smc.ensemble).

Three engines advance every chain of a ChainState by n sweeps, and a
fourth, experimental one, by n random-scan sweeps:

  * `ensemble_sweeps` — the plain PyTorch engine (sampler.sweep over the
    chain batch, one visiting order shared by all chains; on the card
    each sweep is a replayed CUDA graph);
  * `ensemble_sweeps_dense` — the whole-sweep CUDA kernel
    (kernels/sweep.py), one launch per call;
  * `ensemble_sweeps_zsorted` — the same kernel with exact z-block
    skipping over rows z-sorted per chain every `zsort_cadence(n)` sweeps,
    particle identity carried through the sorts; beyond the resident
    kernel's shared-memory capacity it runs the streamed kernel (K3),
    bitwise the same on the same rows; `xsort_slices` > 1 adds the
    experimental 2-D (z-band, x-slice) skip (K1-xs);
  * `ensemble_sweeps_banded` — the experimental z-banded random-scan
    kernel (K4, kernels/banded.py), one launch per sweep.

All three draw from the same counter-based stream: per-sweep seed words
and cyclic offsets folded from a base key and the ABSOLUTE sweep counter
(`_per_sweep_randomness`), then Philox4x32-10 of (move, chain) under the
sweep's words. Trajectories therefore do not depend on how a run is
split into calls, and the plain engine makes exactly the kernel's draws.

Bulk (cfg.pbc_z) and reference-noise (cfg.reference_noise) runs go
through the plain and dense engines only, as in tpu_smc: z-skip assumes
confined z, and the z-sorted move order would permute the reference's
noise pairs (docs/DEVIATIONS.md A8). Reference noise is the pair stream
of `kernels.sweep.reference_noise_plane`, by particle, in both engines.

Every engine takes the mobility as the scalar `a` (temperature
cfg.temperature) or as per-chain rows `a_per_chain` / `t_per_chain` [C]
(both or neither: a temperature ladder); and the wall table shared [M*M, 2] or
per chain [C, M*M, 2] (quenched disorder). Rows and tables are indexed
by chain, so the zsorted engine's particle sorts never touch them.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import SMCConfig
from .kernels import banded as kb
from .kernels import sweep as ks
from .potentials import split_of
from .sampler import SweepStats, run_step, sweep, sweep_state
from .state import ChainState, fold_in, seed_words


def stream_base(key: torch.Tensor, seed) -> torch.Tensor:
    """Base seed words of a run's streams: the run seed's, or chain 0's
    key (key [C, 2]) folded with 0x5EEDB1 when no seed is given. A seed
    given as a key tensor [2] stands for chain 0's key: a shard of a
    wider ensemble passes its GLOBAL chain 0's key, so that its streams
    are the whole ensemble's."""
    if seed is None:
        seed = key[0]
    if torch.is_tensor(seed):
        return fold_in(seed.cpu(), [0x5EEDB1])[0]
    return seed_words(seed)


def stream_words(key: torch.Tensor, seed, s0: int, n_sweeps: int,
                 rows: int, salts=()):
    """Host-side words of the n_sweeps sweeps from absolute sweep s0:
    the moves' seed words [S, 2] (31-bit, int64) and cyclic offsets [S]
    (modulo `rows`), then, for each salt, the words [S, 2] of a stream of
    its own, fold_in(fold_in(base, salt), s) (the ensemble family's
    exchange, volume and transfer draws, gcmc.py)."""
    base = stream_base(key, seed)
    ids = torch.arange(s0, s0 + n_sweeps, dtype=torch.int64)
    words = fold_in(base, ids) & 0x7FFFFFFF
    offsets = fold_in(fold_in(base, [0x0FF5E7])[0], ids)[:, 0] % rows
    return words, offsets, [fold_in(fold_in(base, [salt])[0], ids)
                            & 0x7FFFFFFF for salt in salts]


def _per_sweep_randomness(state: ChainState, cfg: SMCConfig, seed,
                          n_sweeps: int):
    """Per-sweep seed words [S, 2] (31-bit, int64) and cyclic offsets
    [S] for the sweeps starting at the state's absolute counter."""
    words, offsets, _ = stream_words(state.key, seed,
                                     int(state.sweeps.reshape(-1)[0]),
                                     n_sweeps, cfg.n)
    return words, offsets


def stream_uniforms(words: torch.Tensor, n_idx: int, c: int, tag: int,
                    dtype, chain0: int = 0) -> torch.Tensor:
    """Uniforms [c, n_idx, 4] in (0, 1) of Philox counters (j, chain0 +
    chain, tag, 0) under one sweep's words, a tensor [2] on the chains'
    device (no host read: a CUDA graph replays it with new words)."""
    dev = words.device
    j = torch.arange(n_idx, dtype=torch.int64, device=dev)[None, :]
    ch = torch.arange(chain0, chain0 + c, dtype=torch.int64,
                      device=dev)[:, None]
    j, ch = torch.broadcast_tensors(j, ch)
    z = torch.zeros_like(j)
    b = ks.philox4x32(j, ch, z + tag, z, words[0].expand_as(j),
                      words[1].expand_as(j))
    return ks.unit_uniform(torch.stack(b, dim=-1), dtype)


def move_draws(words: torch.Tensor, rows: int, c: int, s2a,
               order: torch.Tensor, dtype, chain0: int = 0):
    """One sweep's i.i.d. move draws, the kernel's: the Box-Muller noise
    [c, rows, 3] by particle and the acceptance uniforms [c, rows] by
    move, from the five uniforms of counters (move, chain0 + chain, 0|1,
    0) under the sweep's words (a tensor [2]); move nn visits particle
    order[nn]. s2a: sqrt(2A), a scalar or [c]."""
    u = stream_uniforms(words, rows, c, 0, dtype, chain0).transpose(0, 1)
    u4 = stream_uniforms(words, rows, c, 1, dtype, chain0)[..., 0].T
    g, unif = ks.box_muller(torch.cat([u, u4[..., None]], dim=-1), s2a)
    noise = torch.empty_like(g).index_copy_(0, order, g)
    return noise.permute(1, 0, 2), unif.T


def visiting_orders(offsets: torch.Tensor, rows: int, device):
    """[S, rows] visiting orders (offset + nn) % rows on `device`."""
    nn = torch.arange(rows, dtype=torch.int64)
    return ((nn[None, :] + offsets[:, None]) % rows).to(device)


def _chain_at(a, cfg: SMCConfig, a_per_chain, t_per_chain):
    """(A, T) of a call: per-chain rows, or (a, cfg.T)."""
    if (a_per_chain is None) != (t_per_chain is None):
        raise ValueError("a_per_chain and t_per_chain: both or neither")
    if a_per_chain is not None:
        return a_per_chain, t_per_chain
    return float(a), cfg.temperature


def ensemble_sweeps(state: ChainState, w: torch.Tensor, cfg: SMCConfig,
                    a: float, n_sweeps: int, collect_trace: bool = False,
                    stream_seed=None, draws=None, a_per_chain=None,
                    t_per_chain=None, umbrella=None, chain0: int = 0):
    """n_sweeps sweeps of every chain on the plain PyTorch engine.

    draws: None = the kernel's Philox draws of each sweep (with
    cfg.reference_noise its pair plane, by particle); or injected
    (noise [S, C, N, 3] by particle, unif [S, C, N] by move, offsets [S]).
    umbrella: the window bias (tag, k_spring, z0 [C]) of sampler.sweep,
    which only this engine takes (umbrella.py).
    On a CUDA state each sweep replays a CUDA graph (sampler.run_step,
    every tensor a copied-in buffer): bitwise the eager sweep, without
    the host's cost of its ~170 launches per move.
    chain0: the global index of the state's chain 0 (the Philox chain
    word; a shard of a wider ensemble, see ensemble_sweeps_dense).
    Returns (state, SweepStats [S, C] or None)."""
    if draws is None:
        words, offsets = _per_sweep_randomness(state, cfg, stream_seed,
                                               n_sweeps)
    else:
        offsets = torch.as_tensor(draws[2], dtype=torch.int64)
    a, t = _chain_at(a, cfg, a_per_chain, t_per_chain)
    c, dev, dt = state.n_chains, state.r.device, state.r.dtype
    s2a = ks.chain_scales(a, t, c, dev, dt)[2]
    orders = visiting_orders(offsets, cfg.n, dev)
    if draws is None:
        # one host-to-device copy per call: a pageable copy per sweep
        # would wait for the sweep before it
        words_dev = words.to(dev)
    e_tr, a_tr = [], []
    for s in range(n_sweeps):
        off = int(offsets[s])
        if draws is None and cfg.reference_noise:
            plane = ks.reference_noise_plane(words[s], cfg.n, c, s2a, dev, dt,
                                             chain0)
            noise = plane[:3 * cfg.n].T.reshape(c, cfg.n, 3)
            unif = ks.move_uniforms(words[s], cfg.n, c, dev, dt,
                                    chain0)[..., 4].T
        elif draws is None:
            noise, unif = move_draws(words_dev[s], cfg.n, c, s2a, orders[s],
                                     dt, chain0)
        else:
            noise, unif = draws[0][s], draws[1][s]
        if state.r.is_cuda:
            r, e, acc = _graph_sweep(state, w, cfg, a, t, umbrella, noise,
                                     unif, orders[s])
            state = state.replace(r=r, energy=e, sweeps=state.sweeps + 1,
                                  accepted=state.accepted + acc)
            st = SweepStats(energy=e, accepted=acc)
        else:
            state, st = sweep_state(state, w, cfg, a, noise, unif, off,
                                    temperature=t, umbrella=umbrella)
        if collect_trace:
            e_tr.append(st.energy)
            a_tr.append(st.accepted)
    if not collect_trace:
        return state, None
    return state, SweepStats(torch.stack(e_tr), torch.stack(a_tr))


def _graph_sweep(state: ChainState, w, cfg: SMCConfig, a, t, umbrella,
                 noise, unif, order):
    """sampler.sweep of the state through sampler.run_step: one CUDA
    graph per (cfg, float A and T, umbrella tag, shapes); A and T where
    they are per-chain rows, and the umbrella's spring and centers, are
    copied-in buffers like the rest."""
    static = tuple(None if torch.is_tensor(v) else v for v in (a, t))
    rows = [v for v in (a, t) if torch.is_tensor(v)]
    tag = None if umbrella is None else int(umbrella[0])
    if umbrella is not None:
        rows += [torch.as_tensor(v, dtype=state.r.dtype,
                                 device=state.r.device) for v in umbrella[1:]]

    def step(r, e, noise, unif, order, w, *rows):
        rows = iter(rows)
        aa, tt = (next(rows) if v is None else v for v in static)
        bias = None if tag is None else (tag, next(rows), next(rows))
        return sweep(r, e, w, cfg, aa, noise, unif, 0, temperature=tt,
                     umbrella=bias, order=order)

    return run_step(("sweep", cfg) + static + (tag,), step,
                    (state.r, state.energy, noise, unif, order, w, *rows))


def _kernel_inputs(state: ChainState, w: torch.Tensor, cfg: SMCConfig):
    if cfg.lj_shift:
        raise NotImplementedError(
            "the sweep kernel implements the truncated-unshifted LJ")
    x, y, z = ks.to_planes(state.r, cfg)
    wa, wb = ks.wall_coeff_rows(w, cfg)
    e = state.energy.reshape(1, -1).to(torch.float32)
    return x, y, z, e, wa, wb


def _finish(state: ChainState, r: torch.Tensor, e, e_trace, a_trace,
            cfg: SMCConfig, n_sweeps: int):
    dt = cfg.torch_dtype
    new = state.replace(
        r=r.to(dt), energy=e.reshape(-1).to(dt),
        sweeps=state.sweeps + n_sweeps,
        accepted=state.accepted + a_trace.sum(0).to(torch.int64))
    return new, SweepStats(e_trace.to(dt), a_trace)


def ensemble_sweeps_dense(state: ChainState, w: torch.Tensor,
                          cfg: SMCConfig, a: float, n_sweeps: int,
                          seed=None, a_per_chain=None, t_per_chain=None,
                          chain0: int = 0):
    """n_sweeps sweeps of every chain in ONE launch of the whole-sweep
    kernel (counterpart of ensemble_sweeps_pallas). The state stays in
    real units, so the result does not depend on call boundaries. On a
    CUDA device beyond the resident kernel's capacity it raises, naming
    the streamed engine (ensemble_sweeps_zsorted) where the mode has one
    (bulk and reference-noise runs do not).

    chain0: the global index of the state's chain 0. Every engine keys
    chain c's draws by chain0 + c, so the state's chains [k, k + C') run
    alone with chain0 = k (and seed = the run seed, or the ensemble's
    chain 0 key, `stream_base`) are bitwise those chains of the whole
    call: how an ensemble is split over processes or devices changes no
    result."""
    a, t = _chain_at(a, cfg, a_per_chain, t_per_chain)
    words, offsets = _per_sweep_randomness(state, cfg, seed, n_sweeps)
    x, y, z, e, wa, wb = _kernel_inputs(state, w, cfg)
    x, y, z, e, e_tr, a_tr = ks.sweep_block(
        x, y, z, e, wa, wb, offsets, words, cfg, n_sweeps, a,
        temperature=t, chain0=chain0)
    return _finish(state, ks.from_planes(x, y, z, cfg), e, e_tr, a_tr, cfg,
                   n_sweeps)


def zsort_cadence(n: int) -> int:
    """Sweeps between per-chain z-sorts: 16 up to N = 1024, else 8
    (tpu_smc's cadence, kept as behaviour; chip_smoke.py times 4 to 32
    against it on the card, see PERF.md). Staleness costs skips, never
    correctness: the kernel's block bounds are live."""
    return 16 if n <= 1024 else 8


def zsorted_streams(cfg: SMCConfig, device) -> bool:
    """Whether ensemble_sweeps_zsorted runs the streamed kernel by default
    for cfg on `device`: exactly when the resident kernel does not fit
    (`kernels.sweep.resident_fits`; never on the CPU), and never for bulk
    or reference-noise runs, which have no streamed kernel (tpu_smc's
    `stream_ok`, tpu_smc/ensemble.py:434)."""
    if cfg.pbc_z or cfg.reference_noise:
        return False
    return not ks.resident_fits(ks.padded_rows(cfg.n), device,
                                ks.wall_sites(cfg))


def xsort_perm(x: torch.Tensor, z: torch.Tensor, n: int,
               xslices: int) -> torch.Tensor:
    """Row order [n, C] of the zsorted engine: the stable z argsort of the
    real rows of planes x, z [N_pad, C], and for xslices = k > 1, inside
    each band of 128 k rows, a stable x argsort (tpu_smc/ensemble.py:
    503-513)."""
    perm = torch.argsort(z[:n], dim=0, stable=True)
    if xslices > 1:
        band = ks.ROW_BLOCK * xslices
        c = x.shape[1]
        xz = torch.take_along_dim(x[:n], perm, dim=0).reshape(-1, band, c)
        xperm = torch.argsort(xz, dim=1, stable=True)
        perm = torch.take_along_dim(perm.reshape(-1, band, c), xperm,
                                    dim=1).reshape(n, c)
    return perm


def ensemble_sweeps_zsorted(state: ChainState, w: torch.Tensor,
                            cfg: SMCConfig, a: float, n_sweeps: int,
                            seed=None, sweeps_per_sort: int | None = None,
                            a_per_chain=None, t_per_chain=None,
                            hbm_stream: bool | None = None,
                            xsort_slices: int = 0, chain0: int = 0):
    """n_sweeps sweeps through the kernel with exact z-block skipping.

    Every `sweeps_per_sort` sweeps (plus one shorter chunk for a
    remainder) the real rows are argsorted by z per chain and the kernel
    runs one launch over the sorted planes. idx[j, c] = particle id of
    row j of chain c rides through the sorts, and positions are scattered
    back to particle order at the end, so density/mobility bookkeeping
    and the positions CSV keep particle identity.

    hbm_stream: run the streamed kernel (planes in device memory) instead
    of the resident one; None = `zsorted_streams(cfg, device)`. The two
    are bitwise equal on the same rows, so the switch changes capacity
    and speed, not results.

    xsort_slices = k > 1: the EXPERIMENTAL 2-D refinement (K1-xs): rows
    are also x-sorted within z-bands of k row blocks (`xsort_perm`) and
    the kernel skips blocks by live (z, x) bounds; results are bitwise
    the no-skip kernel on the same rows. Resident kernel and i.i.d. noise
    only, and n a multiple of 128 k (tpu_smc/ensemble.py:454-466).

    chain0: the global index of the state's chain 0, as in
    ensemble_sweeps_dense (the sorts are per chain)."""
    if n_sweeps < 1:
        raise ValueError("n_sweeps must be >= 1")
    a, t = _chain_at(a, cfg, a_per_chain, t_per_chain)
    n, c = cfg.n, state.n_chains
    sps = max(1, int(sweeps_per_sort or zsort_cadence(n)))
    xsl = max(0, int(xsort_slices or 0))
    if xsl > 1:
        if hbm_stream or (hbm_stream is None and zsorted_streams(
                cfg, state.r.device)):
            raise NotImplementedError(
                "xsort_slices: resident kernel only (prototype)")
        if cfg.reference_noise:
            raise NotImplementedError("xsort_slices requires i.i.d. "
                                      "noise (DEVIATIONS A8 scope)")
        band_rows = ks.ROW_BLOCK * xsl
        if n != ks.padded_rows(n) or n % band_rows:
            raise ValueError(
                f"xsort_slices {xsl}: n {n} must be a multiple of "
                f"row_block*xslices = {band_rows} (pad-free bands)")
        hbm_stream = False
    words, offsets = _per_sweep_randomness(state, cfg, seed, n_sweeps)
    x, y, z, e, wa, wb = _kernel_inputs(state, w, cfg)
    if hbm_stream is None:
        hbm_stream = zsorted_streams(cfg, x.device)
    idx = torch.arange(n, device=x.device)[:, None].expand(n, c)
    e_pieces, a_pieces = [], []
    k0 = 0
    while k0 < n_sweeps:
        length = min(sps, n_sweeps - k0)
        perm = xsort_perm(x, z, n, xsl)
        x, y, z = (torch.cat([torch.take_along_dim(p[:n], perm, dim=0),
                              p[n:]]) for p in (x, y, z))
        idx = torch.take_along_dim(idx, perm, dim=0)
        args = (x, y, z, e, wa, wb, offsets[k0:k0 + length],
                words[k0:k0 + length], cfg, length, a)
        x, y, z, e, e_tr, a_tr = (
            ks.sweep_block_stream(*args, temperature=t, chain0=chain0)
            if hbm_stream
            else ks.sweep_block(*args, zskip=True, temperature=t,
                                xslices=xsl, chain0=chain0))
        e_pieces.append(e_tr)
        a_pieces.append(a_tr)
        k0 += length
    r_sorted = ks.from_planes(x, y, z, cfg)                  # [C, n, 3]
    r = torch.empty_like(r_sorted)
    r.scatter_(1, idx.T[:, :, None].expand(c, n, 3), r_sorted)
    return _finish(state, r, e, torch.cat(e_pieces), torch.cat(a_pieces),
                   cfg, n_sweeps)


def ensemble_sweeps_banded(state: ChainState, w: torch.Tensor,
                           cfg: SMCConfig, a: float, n_sweeps: int,
                           window: int = 128, d_z: float = 12.0, seed=None,
                           chain0: int = 0):
    """n_sweeps random-scan sweeps of every chain on the EXPERIMENTAL
    z-banded kernel (K4, kernels/banded.py; counterpart of tpu_smc's
    ensemble_sweeps_banded): each sweep z-sorts every chain and records
    the window margins (`kernels.banded.sort_and_margin`, plain torch
    between launches, as in tpu_smc), then runs one launch of n moves.

    As in tpu_smc, particle LABELS are permuted by the per-sweep sorts
    (physically meaningless; density, g(r), pressure and E are
    unaffected, the Rbin mobility bookkeeping loses identity), and the
    wall table is one shared [M*M, 2] row. Refused: pbc_z (the kernel is
    for the confined system), per-chain wall tables, and reference noise
    (deliberately: tpu_smc silently ignores cfg.reference_noise here, but
    noise by particle id cannot follow a random-scan order, DEVIATIONS
    A8).

    Returns (state, SweepStats [S, C], fallback_fraction): the mean over
    sweeps and chains of the moves that took the full pass, over n (per
    chain; tpu_smc counts per 128-chain tile). chain0 as in
    ensemble_sweeps_dense."""
    if n_sweeps < 1:
        raise ValueError("n_sweeps must be >= 1")
    if cfg.pbc_z:
        raise NotImplementedError("the banded engine is for the wall "
                                  "(confined-z) system")
    if w.dim() == 3:
        raise NotImplementedError("the banded engine takes one shared wall "
                                  "table [M*M, 2]")
    if cfg.reference_noise:
        raise NotImplementedError(
            "the banded engine takes i.i.d. noise only: reference noise is "
            "by particle id, which a random-scan order cannot follow "
            "(DEVIATIONS A8)")
    if cfg.lj_shift:
        raise NotImplementedError(
            "the banded kernel implements the truncated-unshifted LJ")
    words, _ = _per_sweep_randomness(state, cfg, seed, n_sweeps)
    wa, wb = ks.wall_coeff_rows(w, cfg)
    e = state.energy.reshape(1, -1).to(torch.float32)
    r = state.r
    e_tr, a_tr, fb = [], [], []
    for s in range(n_sweeps):
        x, y, z, margin = kb.sort_and_margin(r, cfg, window)
        x, y, z, e, acc, fbk = kb.banded_sweep_block(
            x, y, z, e, wa, wb, margin, words[s], cfg, a, window, d_z,
            chain0=chain0)
        r = ks.from_planes(x, y, z, cfg, dtype=cfg.torch_dtype)
        e_tr.append(e[0])
        a_tr.append(acc[0])
        fb.append(fbk[0])
    new, stats = _finish(state, r, e, torch.stack(e_tr), torch.stack(a_tr),
                         cfg, n_sweeps)
    return new, stats, float(torch.stack(fb).double().mean()) / cfg.n


# ----------------------------------------------------------------------
# Devices and shards (counterparts of tpu_smc/ensemble.py:40-110 and
# :642-814). A list of torch.device takes the place of a jax Mesh; a
# shard is a contiguous chain range with its global chain index chain0,
# so a sharded call is bitwise the unsharded one. tpu_smc's
# global_shard_put and fetch exist for jax.Array sharding only: their
# port is the slicing (shard_ensemble) and gathering
# (gather_global_state) below.
# ----------------------------------------------------------------------

def make_mesh(n_devices: int | None = None, devices=None) -> list:
    """This process's devices for a sharded call: `devices` as given (the
    CPU tests pass ["cpu", "cpu"]; one card may appear more than once),
    else its CUDA devices, the first `n_devices` of either."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"make_mesh: {n_devices} devices asked, "
                             f"{len(devs)} available")
        devs = devs[:n_devices]
    return devs


def _map_leaves(state, fn):
    """fn of every field of a chain-state dataclass (ChainState, and the
    ensemble family's NPTState, GibbsState), all with a leading chain
    axis."""
    return type(state)(**{f.name: fn(getattr(state, f.name))
                          for f in dataclasses.fields(state)})


def _split(n_chains: int, parts: int) -> int:
    if parts < 1 or n_chains % parts:
        raise ValueError(f"{n_chains} chains must divide over {parts} "
                         "shards")
    return n_chains // parts


def shard_ensemble(state: ChainState, devices, chain0: int = 0) -> list:
    """[(shard state, chain0 of the shard)]: the state's chains cut into
    len(devices) contiguous ranges, each on its device; `chain0` is the
    global index of the state's own chain 0. Any chain-state dataclass
    (_map_leaves) splits so."""
    per = _split(state.n_chains, len(devices))
    return [(_map_leaves(state, lambda x, k=k, d=d:
                         x[k * per:(k + 1) * per].to(d)), chain0 + k * per)
            for k, d in enumerate(devices)]


def concat_states(parts, device):
    """Shard states (of one chain-state dataclass) concatenated along the
    chain axis on `device`."""
    return type(parts[0])(**{
        f.name: torch.cat([getattr(p, f.name).to(device) for p in parts])
        for f in dataclasses.fields(parts[0])})


def gather_global_state(parts, device="cpu") -> ChainState:
    """The job's whole ensemble on `device`: a state or a list of shard
    states, concatenated, then (under distributed.init_distributed)
    gathered from every rank in rank order, so each rank holds it; what a
    --global-ladder checkpoint writes."""
    from . import distributed as dist

    if isinstance(parts, ChainState):
        parts = [parts]
    state = concat_states(parts, device)
    if dist.process_count() == 1:
        return state
    return _map_leaves(state, lambda x: torch.from_numpy(
        dist.allgather_chain_axis(x.cpu().numpy())).to(device))


def _rows_of(v, sl: slice, c: int, device):
    """Per-chain rows of a shard: a [C] tensor sliced, a scalar kept."""
    if torch.is_tensor(v) and v.dim() and v.shape[0] == c:
        return v[sl].to(device)
    return v


def _sharded(engine, state: ChainState, w: torch.Tensor, cfg: SMCConfig,
             a, n_sweeps: int, seed, devices, a_per_chain, t_per_chain,
             chain0: int, **kw):
    """One call of `engine` per shard on its device, with the shard's
    chain0, per-chain rows and wall tables; the states and traces (None
    where the engine collects none) concatenated back on the state's
    device. seed None: the state's chain 0 key, for every shard."""
    c, home = state.n_chains, state.r.device
    if seed is None:
        seed = state.key[0].cpu()
    per = _split(c, len(devices))
    outs = []
    for k, (st, c0) in enumerate(shard_ensemble(state, devices, chain0)):
        dev, sl = devices[k], slice(k * per, (k + 1) * per)
        wk = (w[sl] if w.dim() == 3 else w).to(dev)
        rows = {}
        if a_per_chain is not None:
            rows = dict(a_per_chain=_rows_of(a_per_chain, sl, c, dev),
                        t_per_chain=_rows_of(t_per_chain, sl, c, dev))
        with split_of(c, len(devices)):
            outs.append(engine(st, wk, cfg, a, n_sweeps, seed=seed,
                               chain0=c0, **rows, **kw))
    new = concat_states([o[0] for o in outs], home)
    if outs[0][1] is None:
        return new, None
    stats = SweepStats(*(torch.cat([getattr(o[1], f).to(home)
                                    for o in outs], dim=1)
                         for f in SweepStats._fields))
    return new, stats


def ensemble_sweeps_sharded(state: ChainState, w: torch.Tensor,
                            cfg: SMCConfig, a: float, n_sweeps: int, seed,
                            devices, collect_trace: bool = False,
                            a_per_chain=None, t_per_chain=None,
                            chain0: int = 0, umbrella=None):
    """ensemble_sweeps (the plain engine, CUDA graphs on the card) with
    the chain axis split over `devices`, as ensemble_sweeps_dense_sharded
    (tpu_smc partitions its XLA engine the same way): every draw is keyed
    by the global chain index and each chain's arithmetic is its own, so
    the call is bitwise the unsharded one. umbrella: the window bias
    (tag, k_spring, z0 [C]) of ensemble_sweeps, each shard with its own
    rows of z0. Traces [S, C] when collect_trace, else None."""
    c, base = state.n_chains, chain0

    def plain(st, wk, cfg, a, n, seed, chain0, **rows):
        bias = None
        if umbrella is not None:
            k0 = chain0 - base
            bias = umbrella[:2] + (_rows_of(
                umbrella[2], slice(k0, k0 + st.n_chains), c,
                st.r.device),)
        return ensemble_sweeps(st, wk, cfg, a, n, collect_trace=collect_trace,
                               stream_seed=seed, chain0=chain0,
                               umbrella=bias, **rows)

    return _sharded(plain, state, w, cfg, a, n_sweeps, seed, devices,
                    a_per_chain, t_per_chain, chain0)


def ensemble_sweeps_dense_sharded(state: ChainState, w: torch.Tensor,
                                  cfg: SMCConfig, a: float, n_sweeps: int,
                                  seed, devices, a_per_chain=None,
                                  t_per_chain=None, chain0: int = 0):
    """ensemble_sweeps_dense with the chain axis split over `devices`
    (make_mesh; counterpart of ensemble_sweeps_pallas_sharded): one
    launch per shard on its device, with the shard's global chain0, its
    per-chain (A, T) rows and wall tables; traces [S, C] concatenated on
    the chain axis. Bitwise the unsharded call (tpu_smc salts the seed
    per device instead, a statistically equal split)."""
    return _sharded(ensemble_sweeps_dense, state, w, cfg, a, n_sweeps, seed,
                    devices, a_per_chain, t_per_chain, chain0)


def ensemble_sweeps_zsorted_sharded(state: ChainState, w: torch.Tensor,
                                    cfg: SMCConfig, a: float, n_sweeps: int,
                                    seed, devices,
                                    sweeps_per_sort: int | None = None,
                                    hbm_stream: bool | None = None,
                                    a_per_chain=None, t_per_chain=None,
                                    chain0: int = 0):
    """ensemble_sweeps_zsorted (resident or, with hbm_stream, the streamed
    kernel) with the chain axis split over `devices`, as
    ensemble_sweeps_dense_sharded; the sorts are per chain, so the split
    changes nothing: bitwise the unsharded call."""
    return _sharded(ensemble_sweeps_zsorted, state, w, cfg, a, n_sweeps,
                    seed, devices, a_per_chain, t_per_chain, chain0,
                    sweeps_per_sort=sweeps_per_sort, hbm_stream=hbm_stream)


def particle_sharded_energy(r: torch.Tensor, w: torch.Tensor,
                            cfg: SMCConfig, shards, group=None) -> float:
    """Total energy of one configuration r [N, 3] with its particle rows
    split into blocks (counterpart of tpu_smc's particle_sharded_energy,
    the O(N^2) pass cut by rows): each block sums its rows against all N
    positions, half of every pair term, plus its rows' wall terms, on its
    device, in row chunks within potentials.PAIR_BUDGET; the blocks' sums
    are added in float64. shards: this process's devices (make_mesh), one
    block each. group: a torch.distributed process group whose ranks
    each hold len(shards) blocks (rank p the p-th run of them); their
    sums are then all-reduced. N must divide into the blocks."""
    from . import potentials

    import torch.distributed as tdist

    n = r.shape[0]
    nd = len(shards)
    nproc, rank = 1, 0
    if group is not None:
        nproc, rank = tdist.get_world_size(group), tdist.get_rank(group)
    per = n // (nd * nproc)
    if per * nd * nproc != n:
        raise ValueError(f"N = {n} must divide over {nd * nproc} blocks")
    shift = 0.0
    if cfg.lj_shift:
        rc6 = cfg.cutoff2 ** 3
        shift = 1.0 / (rc6 * rc6) - 1.0 / rc6
    step = max(1, potentials.PAIR_BUDGET // max(n, 1))
    total = 0.0
    for k, dev in enumerate(shards):
        rr = r.to(dev)[None]
        b0 = (rank * nd + k) * per
        part = torch.zeros((), dtype=torch.float64, device=dev)
        for r0 in range(b0, b0 + per, step):
            r1 = min(b0 + per, r0 + step)
            dr2, mask = potentials._pair_dr2_rows(rr, r0, r1, cfg)
            safe = torch.where(mask, dr2, torch.ones_like(dr2))
            inv6 = 1.0 / (safe * safe * safe)
            u = torch.where(mask, inv6 * inv6 - inv6 - shift,
                            torch.zeros_like(inv6))
            part += (2.0 * u.sum()).double()
            if cfg.use_walls:
                part += potentials.wall_energy_force_single(
                    rr[:, r0:r1], w.to(dev), cfg)[0].sum().double()
        total += float(part)
    if group is not None:
        t = torch.tensor([total], dtype=torch.float64)
        tdist.all_reduce(t, group=group)
        total = float(t[0])
    return total
