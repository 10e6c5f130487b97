#!/usr/bin/env python3
"""On-card check of tpu_smc_torch: builds the CUDA kernels, holds them against
their plain PyTorch versions in every mode, and drives the CLI at full width:
the NVT chain ensemble (N = 1024 x 512 and N = 108 x 512 chains), the
reference's single-chain main.c run (N = 108, and one chain at N = 1024)
with checkpoint, SIGTERM stop, resume and fault replay, the
temperature ladder with parallel tempering, tuning and MBAR (N = 1024,
8 x 64 chains), the quenched-disorder ladder (N = 108, 4 x 128 chains, 4
walls), the disordered ensemble (N = 108 x 512, 8 walls), the large-N
confined ensemble on the streamed kernel (N = 32768 x 128 chains, through
simulate_ensemble and through the CLI), the bulk fluid (N = 4000 x 128
and N = 32 x 512 through the CLI), the bug-compatible reference-noise
ensemble (N = 108 x 512), a 10 x 10 wall grid (N = 108 x 512), the
two experimental engines, zsorted with the 2-D x-slice skip (K1-xs) and
the z-banded random-scan kernel (K4), held with zsorted against dense at
N = 1024 x 256 chains, the measurement layer: g(r), rho(z), P_N/P_T
and Widom on the N = 1024 x 512 ensemble, the N = 108 PT ladder with
paired fields and MBAR, and umbrella windows with replica exchange, and
the ensemble family: grand-canonical (N0 = 108 x 512), constant-pressure
(N = 108 x 4096 isobars) and Gibbs-ensemble (N = 96 x 256) MC, and the
diagnostics and tooling: a device trace of the N = 1024 x 512 run, the
z-skip cost model against K2, the checked sweep, the offline analysis
CLI and an example.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; imports neither jax nor tpu_smc. Phases:

  1. setup: card name and power limit, versions, cold nvcc build (ptxas
     registers, spills and stack per kernel instantiation);
  2. kernel vs plain, dense and z-skip, at N = 108 x 64 and N = 1024 x 128
     chains, 2 sweeps, identical Philox draws (the plain version's exact
     mode): uniforms bitwise equal and inside (0, 1), accept decisions and
     positions/energies equal within the stated tolerances except chains
     whose trajectory passed a near-tie move, z-skip on/off bitwise equal
     on the same row order, determinism, carried energy vs recompute;
     then the ladder modes at the same shapes: per-chain (A, T) over 8
     levels, plain and with the x2 thermalization mobility + per-chain
     walls of 4 realizations, against the plain version as above (carried
     E against a per-chain-wall recompute); uniform rows bitwise the
     scalar call, identical per-chain wall tables bitwise the shared row,
     and a [w0.., w1.., w2.., w3..] ensemble bitwise the shared-row runs;
     then the streamed kernel (K3) bitwise the resident z-skip kernel on
     the same sorted rows at N = 4096 and 16384 x 128 and at N = 4096 x
     128 with per-chain (2A, T) and 4 walls, and K3 against its plain
     version at N = 1024 x 64 as above; then the bulk mode K1-pbc at
     N = 12 x 64 (4 pad rows) and N = 256 x 64 (also with per-chain
     (A, T), and uniform rows bitwise the scalar call), the reference-
     noise mode K1-rn at N = 108 x 64, K5 against reference_noise_plane
     (within 1e-6) with the pair moments on a [3 * 4096, 256] plane, K1
     at M = 10 (100 wall sites) at N = 108 x 512 and K3 at M = 10 at
     N = 108 x 64, each against its plain version as above; then K1-xs
     (the 2-D pass) against its plain version at N = 256 x 64 (k = 2)
     and bitwise K1 on the same 2-D-sorted rows at N = 1024 x 128 for k
     = 4 and 8, from the equilibrated ensemble (400 dense sweeps from
     the lattice) and from a cluster at the x seam, and K4 against its
     plain version at N = 1024 x 64, one sweep (the same schedule,
     fallback counts equal, carried E against a recompute), and at N =
     32 x 32 clusters with walls on a sweep whose schedule draws one row
     twice in a row, the first of the two moves accepted on some chains;
  3. the main path: `tpu_smc_torch.cli.main` at N = 1024 x 512 chains
     (auto -> zsorted, z-skip launches) and N = 108 x 512 (auto -> dense),
     each reproducing the mean energy and acceptance recorded for it
     exactly (the per-chain CSVs through the C++ formatters, "after" in
     the wall-time split); then the measurement layer: the N = 1024 x 512
     run again with --gr-bins 64 --z-bins 64 --ptensor-bins 32 --widom 64
     --widom-bins 32 --nonuniform-z, bitwise the same mean E and
     acceptance, its gr / zprofile / ptensor / widom CSVs, int rho(z) dz
     L^2 = N to 1e-4, mu_ex finite, mean_b (P_N + 2 P_T)/3 = rho T + pair
     virial on chain 0's final state (float32, 1e-4), the measurements'
     per-gather cost beside the sweeps'; the N = 108 PT ladder (4 x 128,
     PT every 16) with --z-bins 32 --gr-bins 32 --sk-kmax 4 --widom 32 and
     MBAR (reweight mu_ex column, rho(z; T), g(r; T), S(k; T) finite, the
     PMF finite where rho(z; T) > 0, per-level mu_ex within 3 combined SE
     of tpu_smc's runs, REF_WIDOM); the umbrella windows at N = 108 (8
     centers -99..-92 x 8 replicas, REUS every 10, 200 + 800 sweeps) on
     the plain engine's CUDA-graph sweeps (no kernel launched): window and
     swap acceptances in (0, 1], the PMF finite over >= 80 % of its bins
     and within 3 combined SE of tpu_smc's runs (REF_UMBRELLA), chain-
     sweeps/s; then the single chain: the main.c run `2000 8000 400 1.10`
     (N = 108, dense; tpu_smc's nine CSVs, finite results, mean E within
     4 combined SE of a 64-chain run, the chain's SE from its own tau)
     and one chain at N = 1024 (zsorted), each with its wall-time split;
     driver.simulate of one chain bitwise chain 0 of simulate_ensemble of
     8 chains at N = 108 (K1) and N = 1024 (K2); scripts/resume_drill.py's
     protocol in-process at N = 1024 x 64 (zsorted) and N = 108 single
     chain (dense): uninterrupted, SIGTERM after the first auto-
     checkpoint, resumed, with last_state and local byte-identical and
     the data (E, P) and positions rows the uninterrupted run's tail, and
     the uninterrupted run again with one injected launch error, replayed
     to byte-identical CSVs; then (a) the N = 1024 ladder with parallel tempering, tuned
     mobility and MBAR, (b) the N = 108 disorder ladder with per-
     realization MBAR, (d) an N = 108 parallel-tempering ladder run near
     equilibrium and (c) the N = 108 disordered ensemble; launch counts
     reset before and read after each run, the plain versions barred;
     per-T results finite and rising with T, swap acceptance in (0, 1],
     MBAR at the ladder's temperatures within 3 combined SE of the
     sampled means on (b) and (d); (a), too short to reach equilibrium,
     holds its per-T mean E and its MBAR - sampled offsets within 3
     combined SE of tpu_smc's run of the same ladder (REF_A); tpu_smc's
     CSV names and headers; then the large-N runs on the streamed kernel:
     simulate_ensemble at tpu_smc's density-matched N = 32768 box x 128
     chains (finite, carried vs exact energy within 1e-4 relative at
     every resync, CNA run, E/N and acceptance beside tpu_smc's, peak
     memory, the gather loop's time split) and the CLI at N = 32768 x 128
     in the default box (the CSV set, the streamed engine line); then
     the bulk CLI at N = 4000 x 128 (dense K1-pbc launches only, carried
     vs exact energy within 1e-4 relative at every resync, acceptance in
     (0, 1), the CSV set, the wall-time split), the bulk CLI at N = 32 x
     512 (mean E and acceptance within 3 combined SE of tpu_smc's CPU run,
     REF_BULK), simulate_ensemble at N = 108 x 512 with reference noise
     beside i.i.d. noise at the same seed (both mean energies and the
     offset reported; the run's own noise of 64 sweeps dumped through K5,
     each plane within 1e-6 of reference_noise_plane, holds the pair
     moments), and the CLI with --m 10 at N = 108 x 512; then
     scripts/validate_banded.py's contract: from the equilibrated N =
     1024 x 256 ensemble, 200 sweeps each through the dense, zsorted,
     zsorted + xsort 4 and banded engines, each within 4 combined SE of
     dense in mean E and within 0.01 in acceptance; then the ensemble
     family on the plain engine's CUDA graphs (no kernel launched, the
     counts read back as 0): the slab GCMC `100 100 3 1.1 --gcmc MU
     --chains 512 --z-bins 32` (N0 = 108, cap 216; N <= cap, tracked vs
     exact energy within 1e-4 relative at every resync, acceptances in
     (0, 1], T ln<rho> + in-run mu_ex within 0.1 of MU, tpu_smc's CSV
     headers) and 100 + 50 sweeps, a checkpoint and 50 more bitwise its
     final r and active; the Widom -> GCMC loop at tests/test_gcmc.py's
     state point (N = 32, cap 64, 512 chains each); the isotherm
     `--gcmc-grid=-9.5:-7:8 --bulk --n 32 --chains 512` (<N> rising);
     the NPT isobars `--npt-grid 0.3:2.5:8 --npt-reweight 0.3:2.5:33 --n
     108 --rho 0.3 --chains 512` (rho(P) rising, MBAR finite and
     monotone, V never below (2 rc)^3), `--npt 0.7` and the NVT -> NPT
     loop at N = 32 x 512 (<rho> = 0.300 ± 0.02); Gibbs at N = 96 x 256,
     T = 0.75 (N1 + N2 = N every sweep, V1 + V2 to round-off, rho_hi > 3
     rho_lo, rho_hi > 0.45, rho_lo < 0.15, |dmu| < 0.4) and the
     coexistence curve `--gibbs-temps 0.7,2.0`; chain-sweeps/s and the
     wall-time split of each run; then multi-process and sharded runs,
     the children on the one card over gloo, each within 300 s and all
     killed on a failure: (a) the N = 1024 x 512 run above split over
     two processes (`--coordinator --num-processes 2`, 2 x 256 chains on
     K2), its 2560 per-rank CSVs, data_ensemble, last_state and wall CSV
     byte-identical to the one-process run and the recorded mean E and
     acceptance printed by both ranks, both wall times and the
     aggregate chain-sweeps/s; (b) one PT ladder across two processes
     (`--global-ladder`, N = 1024, 4 x 32, `--pt-exchange auto`, MBAR,
     --z-bins 16; K1-at with z-skip): tsweep, pt, reweight and
     reweight_zprofile and the gathered checkpoint byte-identical to
     the one-process run, one auto interval everywhere; (c) per-process
     ladders (N = 108, 3 x 64, PT every 5) pooled: swap attempts equal
     to one process's, E within 6 combined SE + 0.3; (d) in one
     process over [cuda:0, cuda:0]: the zsorted (N = 1024 x 512), dense
     (N = 108 x 512) and streamed (N = 4096 x 128) engines bitwise the
     unsharded call, K1 and K2 with chain0 = 256 against their plain
     versions as in phase 2, the particle-sharded energy of one N =
     32768 density-matched chain over 4 shards within 1e-5 relative of
     the full recompute; (e) the batched drivers in one process over
     [cuda:0, cuda:0], each bitwise the one-device call and both timed:
     the tsweep ladder N = 108, 4 T x 128 (K1-at), the PT ladder N =
     1024, 8 T x 64, every 16 (z-skip K1-at; swap counts), tune_mobility
     of the N = 1024 x 512 ensemble, the NPT isobars N = 108, 8 P x 512
     and Gibbs N = 96 x 256 (plain engine graphs, resync every 25), and
     a CLI PT ladder (N = 108, 4 x 128, MBAR) and the CLI NPT isobars
     with the device helper patched to [cuda:0, cuda:0], their CSVs
     byte-identical to the unpatched run; (f) on [cuda:0, cuda:0], each
     bitwise one device and both timed: the GCMC isotherm family (N0 =
     108, cap 216 x 512, mu per chain, z and g(r) profiles, resyncs),
     a dense bulk GCMC at 8 + 8 chains with cap 96 (also once outside
     split_of, which has to differ: what the split's order repairs) and
     the umbrella windows (8 x 8, REUS every 10); each rank's cards:
     phase 3's N = 1024 x 512 run
     over 2 ranks x 2 shards (every rank's helper patched to [cuda:0,
     cuda:0]; K2) with every CSV byte-identical to phase 3's, and (b)'s
     global ladder over 2 ranks x 2 shards byte-identical to its one
     process; the row order: torch's sum of 108 terms in an 8-row and a
     16-row call, and the N = 108 x 16 CLI run of the bulk fluid at rho
     0.5 (K1-pbc) over 2 ranks x 8 chains with every CSV byte-identical
     to one process;
  4. at the main path's shapes (N = 108 x 512 dense, N = 1024 x 512
     z-skip): kernel vs plain as in phase 2, the plain time and the
     bound, for the uniform form and for per-chain (A, T) and per-chain
     walls (N = 108 x 512); kernel times of those and of per-chain (A, T)
     z-skip (N = 1024 x 512) taken in turns within the call; dense mode
     at N = 1024 x 512 beside z-skip; K3 at the large-N main path's N =
     32768 x 128 planes: windows of 1024 moves at the bottom, the middle
     and the top of the z-sorted slab against the plain version as in
     phase 2 on all 128 chains and the plain time of them, the bound and
     the kernel's time of a whole sweep, and K3
     beside K2 in turns at N = 16384 x 128; the dense and zsorted engines at
     N = 512 and 1024 x 512, behind auto routing, and the zsorted engine
     at sort cadences 8 and 16 (N = 1024 x 512); K1-pbc at N = 4000 x
     128 and K1-rn at N = 108 x 512 against their plain versions and
     timed in the same turns as K1, and K5 on one plane of the reference-
     noise run ([328, 512]): its device time in a CUDA graph beside an
     empty kernel's on its grid, and its time per wrapper call; K1-xs
     (k = 4) at N = 1024 x 256 against its plain version and timed in the
     same turns, K1-xs (k = 4, 8) beside
     K2 in turns at scripts/probe_xsort.py's N = 1024 x 512 and 4096 x
     256, and K4 at N = 1024 x 256 against its plain version and beside
     K2 per sweep in turns; first, where a move's time goes: the SM
     clock cycles per move in each phase (envelope, passes, reductions,
     wall terms, draws, acceptance, end barrier) from diagnostic launches
     of K1 (N = 108 x 512), K2 (N = 1024 x 512), K3 (N = 32768 x 128)
     and K4 (N = 1024 x 256; its first phase the schedule's row and the
     mover's loads), their outputs held bitwise the main path's
     instantiation's.
  5. last (a profiled process keeps CUPTI's per-launch cost, which phase
     4's timing must not pay), the diagnostics and tooling: (a) the N =
     1024 x 512 run again with --profile-dir (mean E and acceptance
     exactly the recorded ones, smc_sweep_kernel among the trace's
     device events; the device idle share of the traced window, the five
     device operations that took most time, the five longest idle gaps
     with the host range open during each); (b) K2 over one sort cadence
     at N = 1024 x 512 (400 zsorted sweeps past the lattice), every
     chain's visited rows per pass inside
     profiling.zskip_kernel_fraction_band, printed beside the ideal per-
     chain band and the in-plane headroom; (c) guards.checked_sweep at N
     = 108 x 64, bitwise sampler.sweep on a clean state, an injected NaN
     named with its chain and particle; (d) `python -m
     tpu_smc_torch.analysis` with --box on (a)'s run directory (phase
     3's CSVs, bitwise): artifacts written, S(k) finite; (e)
     examples/torch_run_ensemble.py at its own depth (N = 108 x 256, 500
     + 2000 sweeps, dense K1).

Each phase prints its elapsed seconds; any failure exits non-zero before
the result lines. The last two lines are the kernel table (JSON) and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# FP32 operations of one pair-row visit in csrc/sweep.cu `pair_rows`
# (min image 2 x 4, dz 1, dr2 5, compare/select 3, reciprocal 1,
# powers 3, u/dv terms 3, four accumulations 7), + 4 for the z minimum
# image under pbc_z; counting an FMA as 2, Philox's and the row-id
# masks' integer work not counted.
FLOPS_PER_ROW = 31
FLOPS_PER_ROW_PBC = 35


def move_flops(cfg) -> int:
    """FP32 operations of a move outside its pair passes: proposal and
    acceptance with the i.i.d. Box-Muller (50) or the reference's two
    noise pairs (61), + 4 for the proposal's z wrap under pbc_z, and,
    with walls, two evaluations of the planar term (20) and the M*M
    sites (25 each): 540 at M = 3."""
    ops = (61 if cfg.reference_noise else 50) + (4 if cfg.pbc_z else 0)
    if cfg.use_walls:
        ops += 2 * (20 + 25 * cfg.m * cfg.m)
    return ops


def row_flops(cfg) -> int:
    return FLOPS_PER_ROW_PBC if cfg.pbc_z else FLOPS_PER_ROW

POS_TOL = 1e-2         # |dx| between kernel and plain on agreeing chains
E_ATOL, E_RTOL = 5e-2, 1e-4   # energies, kernel vs plain and vs recompute
TIE_MARGIN = 1e-3      # |min(log_ap, 0) - log u| of a near-tie move
MAX_DIVERGED = 0.05    # share of chains a near-tie may have flipped

# tpu_smc's run of ladder (a) on the CPU (XLA engine, jax.random streams):
# `python scripts/ladder_pt_reference.py`, per ladder temperature
REF_A = {
    "T": [
        0.9, 1.0, 1.1, 1.2, 1.3, 1.4, 1.5, 1.6],
    "E": [
        1369.134827042, 1523.994953156, 1676.662477112, 1832.144596291,
        1984.258519936, 2139.371552849, 2291.972492218, 2446.30680809],
    "E_err": [
        0.24062565, 0.206386194, 0.190504611, 0.206624866, 0.194926769,
        0.196352452, 0.174293354, 0.151825085],
    "mbar_E": [
        1368.137829604, 1522.781590022, 1677.124228998, 1831.27454633,
        1985.295807626, 2139.22703773, 2293.093413391, 2446.91177453],
    "mbar_err": [
        0.188363774, 0.141073086, 0.113652118, 0.096488567, 0.085892233,
        0.079586929, 0.076009982, 0.074119363],
}


class Failure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise Failure(msg)


FAILED = []   # statistical checks of the main path, reported at the end


def check_later(cond, msg: str) -> None:
    """A check whose failure lets the run go on to show the rest; the
    script still fails, before its result lines."""
    if not cond:
        print(f"  FAILED: {msg}", flush=True)
        FAILED.append(msg)


def phase_line(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s "
          f"(total {time.perf_counter() - T_START:.2f} s)", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# Phase 2: kernel against its plain version
# ----------------------------------------------------------------------

def kernel_inputs(n: int, c: int, device, seed: int = 11, sweeps: int = 2,
                  sort: bool = False, walls: int = 0, cfg=None, r0=None,
                  xsort: int = 0):
    """Planes of an FCC-started ensemble (default box, or `cfg`; or the
    start r0 [n, 3]), advanced one sweep on the dense engine (the zsorted
    one where the resident kernel does not fit) so the chains differ,
    plus the per-sweep draws of `sweeps`; sort: rows z-sorted per chain;
    xsort = k: sorted by z-band of 128 k rows and by x within each band
    (the order of ensemble_sweeps_zsorted(xsort_slices=k)). walls = K > 0: per-chain wall
    tables of K realizations, each on a contiguous block of c / K chains
    (the energies under their own walls); the returned w is then the
    [c, M*M, 2] table."""
    from tpu_smc_torch import ensemble as en
    from tpu_smc_torch.config import SMCConfig
    from tpu_smc_torch.kernels import sweep as ks
    from tpu_smc_torch.state import init_ensemble_state, seed_words
    from tpu_smc_torch.system import build_wall_ensemble

    cfg = SMCConfig.for_n(n) if cfg is None else cfg
    w_np = (np.repeat(build_wall_ensemble(cfg, walls)[0], c // walls, axis=0)
            if walls else None)
    state, w = init_ensemble_state(cfg, seed_words(seed), c, r0=r0, w=w_np,
                                   device=device)
    engine = (en.ensemble_sweeps_zsorted if en.zsorted_streams(cfg, device)
              else en.ensemble_sweeps_dense)
    state, _ = engine(state, w, cfg, cfg.proposal_a, 1, seed=seed)
    words, offsets = en._per_sweep_randomness(state, cfg, seed + 1, sweeps)
    x, y, z, e, wa, wb = en._kernel_inputs(state, w, cfg)
    if sort or xsort:
        perm = en.xsort_perm(x, z, n, xsort)
        x, y, z = (torch.cat([torch.take_along_dim(p[:n], perm, 0), p[n:]])
                   for p in (x, y, z))
    return cfg, w, (x, y, z, e, wa, wb, offsets, words), ks


def ladder_rows(cfg, c: int, device, a_scale: float = 1.0):
    """Per-chain (A, T) [c] of an 8-level ladder T = 0.9 ... 1.6,
    temperature-major, A = a_scale * gamma * T; float64."""
    t = torch.repeat_interleave(torch.linspace(0.9, 1.6, 8,
                                               dtype=torch.float64), c // 8)
    t = t.to(device)
    return a_scale * cfg.gamma * t, t


def compare(cfg, w, args, ks, zskip: bool, label: str, a=None, t=None,
            stream: bool = False, xslices: int = 0, chain0: int = 0,
            moves: int = 0):
    """Kernel vs plain (exact Philox) on the same inputs, with mobility
    and temperature a / t (default the config's; scalars or per-chain
    rows); stream: the streamed kernel and its plain version; xslices:
    the 2-D pass (K1-xs) with that many blocks per band; chain0: the
    global index of chain 0, the same for kernel and plain version;
    moves = k > 0: a partial sweep, both move only rows [0, k) of the
    planes (a config with n = k; every row of cfg still interacts, and
    the carried energies are held against a recompute of all of them).
    Returns the kernel's outputs, the largest
    position error over chains whose trajectories agree, the plain
    version's wall ms (diagnostics included) and the kernel's visited
    pair rows [C]."""
    from tpu_smc_torch.potentials import total_energy

    sweeps = args[-1].shape[0]
    a = cfg.proposal_a if a is None else a
    if stream:
        kernel, plain, kw = ks.sweep_block_stream, ks.sweep_block_stream_plain, {}
    else:
        kernel, plain, kw = ks.sweep_block, ks.sweep_block_plain, {"zskip": zskip}
        if xslices:
            kw["xslices"] = xslices
    if chain0:
        kw["chain0"] = chain0
    full = cfg
    if moves:
        cfg = dataclasses.replace(cfg, n=moves)
    dk = {"uniforms": True}
    outk = kernel(*args, cfg, sweeps, a, diag=dk, temperature=t, **kw)
    dp = {"uniforms": True, "tie_margin": TIE_MARGIN}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outp = plain(*args, cfg, sweeps, a, diag=dp, temperature=t, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    uk, up = dk["uniforms"], dp["uniforms"]
    check(torch.equal(uk, up), f"{label}: kernel uniforms != plain Philox")
    check(bool(((uk > 0) & (uk < 1)).all()), f"{label}: uniform outside (0,1)")

    c = outk[0].shape[1]
    dpos = torch.stack([(outk[k] - outp[k])[:full.n].abs().amax(0)
                        for k in range(3)]).amax(0)
    de = (outk[3] - outp[3]).abs().reshape(-1)
    acc_same = (outk[5] == outp[5]).all(0)
    agree = acc_same & (dpos <= POS_TOL) & (
        de <= E_ATOL + E_RTOL * outp[3].abs().reshape(-1))
    diverged = (~agree).nonzero().reshape(-1)
    ties = dp["near_ties"]
    q = torch.quantile(dpos[acc_same].double(), torch.tensor(
        [0.5, 0.99], dtype=torch.float64, device=dpos.device)).tolist() \
        if bool(acc_same.any()) else [0.0, 0.0]
    print(f"  {label}: {int(ties.sum())} near-tie moves "
          f"(|min(log_ap,0) - log u| < {TIE_MARGIN}), "
          f"{len(diverged)}/{c} chains diverged; max |dx| per chain with "
          f"equal accept counts: median {q[0]:.3g}, p99 {q[1]:.3g}, max "
          f"{float(dpos[acc_same].max()) if bool(acc_same.any()) else 0.0:.3g}",
          flush=True)
    for ci in diverged.tolist():
        check(int(ties[ci]) > 0,
              f"{label}: chain {ci} diverged (|dx| {float(dpos[ci]):.3g}, "
              f"|dE| {float(de[ci]):.3g}) without a near-tie move")
    check(len(diverged) <= max(2, MAX_DIVERGED * c),
          f"{label}: {len(diverged)} of {c} chains diverged")
    max_err = float(dpos[agree].max()) if bool(agree.any()) else 0.0
    vis_k, vis_p = dk["visited"][agree], dp["visited"][agree]
    check(bool(((vis_k - vis_p).abs() <= 0.01 * vis_p).all()),
          f"{label}: pair rows visited differ from the plain envelope")
    # carried energy against a from-scratch recompute (under each chain's
    # own wall when w is a per-chain table)
    r = ks.from_planes(outk[0], outk[1], outk[2], full)
    exact = total_energy(r, w.to(torch.float32), full)
    err = (outk[3].reshape(-1) - exact).abs()
    check(bool((err <= E_ATOL + E_RTOL * exact.abs()).all()),
          f"{label}: carried E vs recompute off by {float(err.max()):.3g}")
    print(f"  {label}: max |dx| {max_err:.3g} on agreeing chains, "
          f"max |E - recompute| {float(err.max()):.3g}, "
          f"visited rows/move {float(dk['visited'].double().mean()) / (sweeps * cfg.n):.1f}",
          flush=True)
    return dict(out=outk, max_err=max_err, plain_ms=plain_ms,
                visited=dk["visited"])


def phase_kernel_vs_plain(device):
    for n, c in ((108, 64), (1024, 128)):
        cfg, w, args, ks = kernel_inputs(n, c, device)
        outd = compare(cfg, w, args, ks, False, f"dense N={n} C={c}")["out"]
        again = ks.sweep_block(*args, cfg, 2, cfg.proposal_a)
        check(all(torch.equal(a, b) for a, b in zip(outd, again)),
              f"N={n}: same seed twice is not bitwise equal")
        cfg, w, args, ks = kernel_inputs(n, c, device, sort=True)
        outz = compare(cfg, w, args, ks, True, f"zskip N={n} C={c}")["out"]
        outd = ks.sweep_block(*args, cfg, 2, cfg.proposal_a, zskip=False)
        check(all(torch.equal(a, b) for a, b in zip(outd, outz)),
              f"N={n}: z-skip on/off not bitwise equal on the same rows")


def bitwise(out1, out2) -> bool:
    return all(torch.equal(a, b) for a, b in zip(out1, out2))


def phase_ladder_modes(device):
    """The kernel's per-chain (A, T) and per-chain wall modes against the
    plain version, and their bitwise contracts, at phase 2's shapes."""
    for n, c, zskip in ((108, 64, False), (1024, 128, True)):
        mode = "zskip" if zskip else "dense"
        cfg, w, args, ks = kernel_inputs(n, c, device, sort=zskip)
        a_c, t_c = ladder_rows(cfg, c, device)
        compare(cfg, w, args, ks, zskip, f"{mode} N={n} C={c} per-chain "
                "(A, T) 8 levels", a=a_c, t=t_c)
        # uniform rows against the scalar form
        full = lambda v: torch.full((c,), v, dtype=torch.float64,
                                    device=device)
        scalar = ks.sweep_block(*args, cfg, 2, cfg.proposal_a, zskip=zskip)
        rows = ks.sweep_block(*args, cfg, 2, full(cfg.proposal_a),
                              zskip=zskip, temperature=full(cfg.temperature))
        check(bitwise(scalar, rows), f"{mode} N={n}: uniform (A, T) rows "
              "are not bitwise the scalar call")
        # identical per-chain wall tables against the shared row
        x, y, z, e, wa, wb, offsets, words = args
        tab = ks.wall_coeff_rows(w.expand(c, -1, -1), cfg)
        same = ks.sweep_block(x, y, z, e, *tab, offsets, words, cfg, 2,
                              cfg.proposal_a, zskip=zskip)
        check(bitwise(scalar, same), f"{mode} N={n}: identical per-chain "
              "wall tables are not bitwise the shared row")

        cfg, w, args, ks = kernel_inputs(n, c, device, sort=zskip, walls=4)
        a2, t_c = ladder_rows(cfg, c, device, a_scale=2.0)
        compare(cfg, w, args, ks, zskip, f"{mode} N={n} C={c} per-chain "
                "(2A, T) + walls of 4 realizations", a=a2, t=t_c)
        # [w0.., w1.., w2.., w3..] against the shared-row runs of each
        x, y, z, e, wa, wb, offsets, words = args
        comb = ks.sweep_block(*args, cfg, 2, a2, zskip=zskip, temperature=t_c)
        g = c // 4
        for k in range(4):
            rows = ks.wall_coeff_rows(w[k * g], cfg)
            split = ks.sweep_block(x, y, z, e, *rows, offsets, words, cfg, 2,
                                   a2, zskip=zskip, temperature=t_c)
            check(all(torch.equal(u[..., k * g:(k + 1) * g],
                                  v[..., k * g:(k + 1) * g])
                      for u, v in zip(comb, split)),
                  f"{mode} N={n}: realization {k}'s chains differ from its "
                  "shared-row run")
        print(f"  {mode} N={n} C={c}: uniform rows == scalar, identical "
              "tables == shared row, per-realization blocks == shared-row "
              "runs (all bitwise)", flush=True)


def phase_stream(device):
    """The streamed kernel K3 against the resident z-skip kernel K2 on the
    same sorted rows, every output and the visited rows bitwise: at
    N = 4096 and 16384 x 128 chains, and at N = 4096 x 128 with per-chain
    (2A, T) of 8 levels and 4 wall realizations; then K3 against its
    plain version at N = 1024 x 64 as in phase 2 (phase 4 holds it
    against its plain version at the main path's N = 32768 x 128)."""
    cases = ((4096, 128, 0, False), (16384, 128, 0, False),
             (4096, 128, 4, True))
    for n, c, walls, at in cases:
        cfg, w, args, ks = kernel_inputs(n, c, device, sort=True, walls=walls)
        a, t = (ladder_rows(cfg, c, device, a_scale=2.0) if at
                else (cfg.proposal_a, None))
        dr, ds = {}, {}
        resident = ks.sweep_block(*args, cfg, 2, a, zskip=True, diag=dr,
                                  temperature=t)
        stream = ks.sweep_block_stream(*args, cfg, 2, a, diag=ds,
                                       temperature=t)
        torch.cuda.synchronize()
        label = (f"K3 vs K2 N={n} C={c}"
                 + (" per-chain (2A, T) + 4 walls" if at else ""))
        check(bitwise(resident, stream) and torch.equal(dr["visited"],
                                                        ds["visited"]),
              f"{label}: not bitwise equal")
        acc = float(stream[5].double().mean()) / (2 * n)
        check(acc > 0, f"{label}: no move accepted")
        print(f"  {label}: bitwise equal (positions, energies, traces, "
              f"visited rows {float(ds['visited'].double().mean()) / (2 * 2 * n):.0f}"
              f" per pass), acceptance {acc:.4f}", flush=True)
    cfg, w, args, ks = kernel_inputs(1024, 64, device, sort=True)
    compare(cfg, w, args, ks, True, "K3 vs plain N=1024 C=64", stream=True)


def bulk_config(n: int):
    """The bulk fluid of the full-width bulk run: rho 0.5, T = 1.5,
    A = 0.015 (gamma 0.01), cutoff 2.5."""
    from tpu_smc_torch.config import SMCConfig

    return SMCConfig.bulk(n=n, temperature=1.5, rho=0.5, gamma=0.01,
                          lj_cutoff=2.5)


NOISE_S = 0.3          # sqrt(2A) of the K5 moment check
# the reference recipe's pair moments in units of s^3 (tpu_smc/tests/
# test_pallas.py's TPU check; +-0.02) and std/s (+-0.01)
NOISE_M21, NOISE_M12, NOISE_TOL = -0.498, 0.274, 0.02


def noise_moments(d: torch.Tensor, s: float):
    """E[d0^2 d1] / s^3, E[d0 d1^2] / s^3 and std / s of noise planes
    [..., rows, C] whose rows 2k, 2k + 1 are pair k."""
    d = d.double().reshape(-1, 2, d.shape[-1])
    d0, d1 = d[:, 0], d[:, 1]
    return (float((d0 * d0 * d1).mean()) / s ** 3,
            float((d0 * d1 * d1).mean()) / s ** 3, float(d.std()) / s)


def check_moments(d: torch.Tensor, s: float, label: str):
    m21, m12, sd = noise_moments(d, s)
    print(f"  {label}: E[d0^2 d1] {m21:+.4f} s^3 (reference {NOISE_M21}), "
          f"E[d0 d1^2] {m12:+.4f} s^3 (reference {NOISE_M12}), std/s "
          f"{sd:.4f}", flush=True)
    check(abs(m21 - NOISE_M21) < NOISE_TOL and abs(m12 - NOISE_M12)
          < NOISE_TOL and abs(sd - 1.0) < 0.01,
          f"{label}: noise moments {m21}, {m12}, {sd}")


def phase_new_modes(device):
    """K1-pbc, K1-rn, K5 and the M = 10 wall grid against their plain
    versions: K1-pbc at N = 12 x 64 (4 pad rows, random start) and at
    N = 256 x 64 (the bulk lattice, rho 0.5), there also with per-chain
    (A, T) of 8 levels and uniform rows bitwise the scalar call; K1-rn at
    N = 108 x 64; K5 against reference_noise_plane on a [3 * 4096, 256]
    plane, with the pair moments; K1 (dense) at M = 10 at the M = 10 CLI
    run's N = 108 x 512 and K3 (streamed, sorted rows) at N = 108 x 64."""
    from tpu_smc_torch.config import SMCConfig
    from tpu_smc_torch.kernels import sweep as ks

    cfg12 = SMCConfig(n=12, box_l=10.0, box_lz=10.0, use_walls=False,
                      pbc_z=True, lj_cutoff=3.0)
    r0 = np.random.default_rng(5).uniform(-4.5, 4.5, (12, 3))
    cfg, w, args, ks = kernel_inputs(12, 64, device, cfg=cfg12, r0=r0)
    compare(cfg, w, args, ks, False, "pbc N=12 C=64 (4 pad rows)")
    cfg, w, args, ks = kernel_inputs(256, 64, device, cfg=bulk_config(256))
    out = compare(cfg, w, args, ks, False, "pbc N=256 C=64")["out"]
    check(bool((out[2][:cfg.n].abs() <= cfg.box_lz / 2).all()),
          "pbc N=256: a z outside the periodic box")
    a_c, t_c = ladder_rows(cfg, 64, device)
    compare(cfg, w, args, ks, False, "pbc N=256 C=64 per-chain (A, T) "
            "8 levels", a=a_c, t=t_c)
    full = lambda v: torch.full((64,), v, dtype=torch.float64, device=device)
    rows = ks.sweep_block(*args, cfg, 2, full(cfg.proposal_a),
                          temperature=full(cfg.temperature))
    check(bitwise(ks.sweep_block(*args, cfg, 2, cfg.proposal_a), rows),
          "pbc N=256: uniform (A, T) rows are not bitwise the scalar call")

    cfg = SMCConfig.for_n(108, reference_noise=True)
    cfg, w, args, ks = kernel_inputs(108, 64, device, cfg=cfg)
    compare(cfg, w, args, ks, False, "refnoise N=108 C=64")

    words = (12345, 678)
    d = ks.debug_reference_noise(words, 4096, 256, NOISE_S, device)
    p = ks.reference_noise_plane(words, 4096, 256, NOISE_S, device)
    torch.cuda.synchronize()
    k5_err = float((d - p).abs().max())
    check(d.shape == (12288, 256) and k5_err <= 1e-6,
          f"K5: {tuple(d.shape)}, max |kernel - plain| {k5_err:.3g}")
    print(f"  K5 [12288, 256]: max |kernel - plain| {k5_err:.3g} "
          f"({'bitwise' if torch.equal(d, p) else 'within 1e-6'})",
          flush=True)
    check_moments(d, NOISE_S, "K5 [12288, 256] plane")

    cfg, w, args, ks = kernel_inputs(108, 512, device,
                                     cfg=SMCConfig.for_n(108, m=10))
    compare(cfg, w, args, ks, False, "dense M=10 N=108 C=512")
    cfg10 = SMCConfig(n=108, m=10, box_l=10.0, box_lz=24.0)
    cfg, w, args, ks = kernel_inputs(108, 64, device, cfg=cfg10, sort=True)
    compare(cfg, w, args, ks, True, "K3 M=10 N=108 C=64", stream=True)


_EQUILIBRATED = {}


def equilibrated(device, n: int = 1024, c: int = 256, sweeps: int = 400):
    """(cfg, state, w): c chains at N = n in the default box, from the
    FCC lattice through `sweeps` sweeps of the dense engine, one launch
    (64 sweeps from the lattice are too few at N = 1024, PERF.md); made
    once per run."""
    from tpu_smc_torch import ensemble as en
    from tpu_smc_torch.config import SMCConfig
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    if (n, c) not in _EQUILIBRATED:
        cfg = SMCConfig.for_n(n)
        state, w = init_ensemble_state(cfg, seed_words(2024), c,
                                       device=device)
        state, _ = en.ensemble_sweeps_dense(state, w, cfg, cfg.proposal_a,
                                            sweeps, seed=2024)
        _EQUILIBRATED[n, c] = (cfg, state, w)
    return _EQUILIBRATED[n, c]


def seam_start(n: int, box_l: float) -> np.ndarray:
    """n particles on a jittered grid with every x within 1.5 of the
    periodic seam +-L/2: three columns 1.2 apart across the seam, rows
    L/27 apart in y, layers 1.2 apart in z."""
    rng = np.random.default_rng(13)
    k = np.arange(n)
    x = (k % 3 - 1) * 1.2 + box_l / 2
    y = (k // 3 % 27) * (box_l / 27) - box_l / 2
    z = (k // 81 - (n // 81) / 2) * 1.2
    r = np.stack([x, y, z], axis=1) + rng.normal(0.0, 0.05, (n, 3))
    r[:, 0] -= box_l * np.rint(r[:, 0] / box_l)
    return r


def chain_planes(cfg, state, w, c: int, seed: int, sweeps: int):
    """Kernel inputs of the first c chains of `state` with the draws of
    `sweeps` sweeps."""
    from tpu_smc_torch import ensemble as en

    x, y, z, e, wa, wb = en._kernel_inputs(state, w, cfg)
    words, offsets = en._per_sweep_randomness(state, cfg, seed, sweeps)
    return [p[:, :c].contiguous() for p in (x, y, z, e)] + [wa, wb, offsets,
                                                           words]


def compare_banded(cfg, w, r, e, words, label: str, window: int = 128,
                   d_z: float = 12.0):
    """K4 against its plain version (exact Philox) for one sweep from
    positions r [C, N, 3] with carried energies e [C]: the same schedule,
    positions within POS_TOL and energies within E_ATOL + E_RTOL on
    chains whose trajectories agree (a chain may diverge only through a
    near-tie acceptance or sufficiency test), per-chain fallback counts
    equal on them, carried E against a recompute. Returns the kernel's
    outputs, the max |dx| on agreeing chains, the plain version's ms and
    the inputs."""
    from tpu_smc_torch.kernels import banded as kb
    from tpu_smc_torch.kernels import sweep as ks
    from tpu_smc_torch.potentials import total_energy

    x, y, z, margin = kb.sort_and_margin(r, cfg, window)
    wa, wb = ks.wall_coeff_rows(w, cfg)
    args = (x, y, z, e.reshape(1, -1).to(torch.float32), wa, wb, margin,
            words, cfg, cfg.proposal_a, window, d_z)
    dk, dp = {}, {}
    outk = kb.banded_sweep_block(*args, diag=dk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outp = kb.banded_sweep_plain(*args, diag=dp)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(dk["rows"].long(), dp["rows"].to(x.device)),
          f"{label}: kernel schedule != banded_rows")
    c = x.shape[1]
    dpos = torch.stack([(outk[k] - outp[k])[:cfg.n].abs().amax(0)
                        for k in range(3)]).amax(0)
    de = (outk[3] - outp[3]).abs().reshape(-1)
    agree = (outk[4] == outp[4]).reshape(-1) & (dpos <= POS_TOL) & (
        de <= E_ATOL + E_RTOL * outp[3].abs().reshape(-1))
    gap = (torch.clamp(dp["log_ap"], max=0.0) - torch.log(dp["u"])).abs()
    ties = ((gap < TIE_MARGIN) | (dp["slack"].abs() < TIE_MARGIN)).sum(0)
    diverged = (~agree).nonzero().reshape(-1).tolist()
    for ci in diverged:
        check(int(ties[ci]) > 0, f"{label}: chain {ci} diverged without a "
              "near-tie acceptance or sufficiency test")
    check(len(diverged) <= max(2, MAX_DIVERGED * c),
          f"{label}: {len(diverged)} of {c} chains diverged")
    fb_k, fb_p = outk[5].reshape(-1), outp[5].reshape(-1)
    check(torch.equal(fb_k[agree], fb_p[agree]),
          f"{label}: fallback counts differ on agreeing chains")
    exact = total_energy(ks.from_planes(*outk[:3], cfg), w, cfg)
    err = (outk[3].reshape(-1) - exact).abs()
    check(bool((err <= E_ATOL + E_RTOL * exact.abs()).all()),
          f"{label}: carried E vs recompute off by {float(err.max()):.3g}")
    max_err = float(dpos[agree].max()) if bool(agree.any()) else 0.0
    print(f"  {label}: schedule equal, {len(diverged)}/{c} chains diverged "
          f"({int(ties.sum())} near ties), fallback counts equal on the "
          f"others (fallback fraction {float(fb_k.double().mean()) / cfg.n:.4f}"
          f" per chain), max |dx| {max_err:.3g}, max |E - recompute| "
          f"{float(err.max()):.3g}", flush=True)
    return dict(out=outk, max_err=max_err, plain_ms=plain_ms, args=args,
                plain_diag=dp)


def phase_xs_banded(device):
    """K1-xs and K4: K1-xs against its plain version at N = 256 x 64 (k =
    2); K1-xs bitwise the no-skip kernel K1 on the same 2-D-sorted rows at
    N = 1024 x 128 for k = 4 and 8, from the equilibrated ensemble and
    from a cluster at the x seam; K4 against its plain version at N = 1024
    x 64, one sweep, from the equilibrated ensemble."""
    from tpu_smc_torch import ensemble as en
    from tpu_smc_torch.config import SMCConfig
    from tpu_smc_torch.kernels import sweep as ks
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    cfg, w, args, ks = kernel_inputs(256, 64, device, xsort=2)
    compare(cfg, w, args, ks, True, "xskip k=2 N=256 C=64", xslices=2)

    cfg, state, w = equilibrated(device)
    seam = SMCConfig.for_n(1024)
    st, sw = init_ensemble_state(seam, seed_words(5), 128,
                                 r0=seam_start(1024, seam.box_l),
                                 device=device)
    st, _ = en.ensemble_sweeps_dense(st, sw, seam, seam.proposal_a, 1, seed=5)
    for label, (s0, w0) in (("equilibrated", (state, w)),
                            ("seam cluster", (st, sw))):
        x, y, z, *rest = chain_planes(cfg, s0, w0, 128, 9, 2)
        for k in (4, 8):
            perm = en.xsort_perm(x, z, cfg.n, k)
            planes = [torch.take_along_dim(p, perm, 0) for p in (x, y, z)]
            dd, dx = {}, {}
            dense = ks.sweep_block(*planes, *rest, cfg, 2, cfg.proposal_a,
                                   diag=dd)
            xs = ks.sweep_block(*planes, *rest, cfg, 2, cfg.proposal_a,
                                zskip=True, xslices=k, diag=dx)
            torch.cuda.synchronize()
            check(bitwise(dense, xs), f"K1-xs k={k} ({label}): not bitwise "
                  "the dense kernel on the same rows")
            rows = lambda d: float(d["visited"].double().mean()) / (4 * cfg.n)
            print(f"  K1-xs k={k} N=1024 C=128 ({label}): bitwise K1 on the "
                  f"same rows (positions, energies, traces); pair rows per "
                  f"pass {rows(dx):.1f} against K1's {rows(dd):.0f}, "
                  f"acceptance {float(xs[5].double().mean()) / (2 * cfg.n):.4f}",
                  flush=True)

    words = en._per_sweep_randomness(state, cfg, 21, 1)[0][0]
    compare_banded(cfg, w, state.r[:64], state.energy[:64], words,
                   "K4 vs plain N=1024 C=64")
    compare_repeated_row(device)


# K4's repeated-row case: a sweep of N = 32 whose schedule under these
# words draws row 13 at moves 2 and 3 (tests/test_torch_banded.py pins
# it), from z-separated clusters where some moves take the window
REPEAT_WORDS, REPEAT_MOVE = (3, 7), 2


def clusters(seed: int) -> np.ndarray:
    """32 particles in 8 groups of 4 along z, 14 apart (squares of side
    1.12, jittered), for a 10 x 10 x 120 box: [32, 3] float64."""
    rng = np.random.default_rng(seed)
    sq = np.array([[0, 0], [1.12, 0], [0, 1.12], [1.12, 1.12]])
    r = []
    for g in range(8):
        xy = rng.uniform(-4.0, 3.0, 2) + sq
        z = -49.0 + 14.0 * g + rng.uniform(-0.3, 0.3, 4)
        r.append(np.column_stack([xy + rng.normal(0, 0.05, (4, 2)), z]))
    return np.concatenate(r)


def compare_repeated_row(device):
    """K4 against its plain version (compare_banded) on a sweep whose
    schedule draws one row twice in a row, the first of the two moves
    accepted on some chains and rejected on others: N = 32 x 32 clusters
    with walls, W = 8, d_z = 24.5."""
    from tpu_smc_torch.config import SMCConfig
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    cfg = SMCConfig(n=32, box_l=10.0, box_lz=120.0, gamma=0.02)
    state, w = init_ensemble_state(cfg, seed_words(5), 32, r0=clusters(5),
                                   device=device)
    cmp = compare_banded(cfg, w, state.r, state.energy, REPEAT_WORDS,
                         "K4 vs plain N=32 C=32, a row drawn twice in a row",
                         window=8, d_z=24.5)
    d, m = cmp["plain_diag"], REPEAT_MOVE
    took = int(d["accept"][m].sum())
    check(int(d["rows"][m]) == int(d["rows"][m + 1]) and 0 < took < 32,
          f"repeated-row premise: rows {d['rows'][m:m + 2].tolist()}, move "
          f"{m} accepted on {took} of 32 chains")
    print(f"  K4 repeated row: row {int(d['rows'][m])} at moves {m} and "
          f"{m + 1}, move {m} accepted on {took} of 32 chains", flush=True)


# ----------------------------------------------------------------------
# Phase 3: the main path through the CLI
# ----------------------------------------------------------------------

STEMS_RANK = ("positions", "data", "local", "total_clusters",
              "autocorrelation")
STEMS_SHARED = ("wall", "data_ensemble", "info", "last_state")


class Tee(io.TextIOBase):
    """Standard output kept while it is printed."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.buf.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


@contextlib.contextmanager
def patched(module, **fns):
    """Module attributes replaced for the duration of the block."""
    saved = {k: getattr(module, k) for k in fns}
    for k, v in fns.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


@contextlib.contextmanager
def captured(module, name: str):
    """module.name(...) recorded (its return value and host wall times)
    for the duration of the block."""
    fn, seen = getattr(module, name), {}

    def wrapper(*args, **kw):
        seen["t0"] = time.perf_counter()
        seen["out"] = fn(*args, **kw)
        torch.cuda.synchronize()
        seen["t1"] = time.perf_counter()
        return seen["out"]

    with patched(module, **{name: wrapper}):
        yield seen


@contextlib.contextmanager
def main_path():
    """A main-path run: the launch counts set to 0 just before it and
    copied into the yielded dict just after, the kernels' plain versions
    made to fail if called."""
    from tpu_smc_torch.kernels import banded as kb
    from tpu_smc_torch.kernels import sweep as ks

    def refuse(*args, **kw):
        raise Failure("a plain version ran on the main path")

    for k in ks.sweep_block.launches:
        ks.sweep_block.launches[k] = 0
    counts = {}
    with patched(ks, sweep_block_plain=refuse,
                 sweep_block_stream_plain=refuse), \
            patched(kb, banded_sweep_plain=refuse):
        yield counts
        torch.cuda.synchronize()
    counts.update(ks.sweep_block.launches)


def run_main(argv):
    """cli.main(argv) as a main-path run, simulate_ensemble timed when
    the run calls it. Returns (standard output, launch counts, wall s,
    simulate_ensemble times)."""
    from tpu_smc_torch import cli
    from tpu_smc_torch import driver_ensemble as de

    simulate = de.simulate_ensemble
    sim = {}

    def timed_simulate(*args, **kw):
        sim["t0"] = time.perf_counter()
        out = simulate(*args, **kw)
        torch.cuda.synchronize()
        sim["t1"] = time.perf_counter()
        sim["sps"] = out[1].sweeps_per_second
        sim["agg"] = out[1]
        return out

    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with main_path() as launches, \
            patched(de, simulate_ensemble=timed_simulate), \
            contextlib.redirect_stdout(tee):
        rc = cli.main(argv)
    dt = time.perf_counter() - t0
    check(rc == 0, f"cli.main{argv} returned {rc}")
    sim["start"] = t0
    return tee.buf.getvalue(), launches, dt, sim


def print_split(n: int, mx: int, chains: int, dt: float, sim: dict):
    """Where a CLI run's wall time went, around simulate_ensemble."""
    loop = mx * chains / sim["sps"]
    print(f"  N={n} wall time: {sim['t0'] - sim['start']:.3f} s before "
          f"simulate_ensemble (walls, state), "
          f"{sim['t1'] - sim['t0'] - loop:.3f} s in it outside the gather "
          f"loop (thermalization, post-processing), {loop:.3f} s gather "
          f"loop (incl. per-window positions CSV), "
          f"{sim['start'] + dt - sim['t1']:.3f} s after it (per-chain CSVs)",
          flush=True)


def summary_value(out: str, label: str) -> str:
    m = re.search(re.escape(label) + r" (-?[0-9.]+)", out)
    check(m is not None, f"no '{label}' in the run's output")
    return m.group(1)


def check_ensemble_files(d: Path, cfg, chains: int, num: int):
    key = cfg.file_key()
    want = {f"{s}_{key}_rank{r}.csv" for s in STEMS_RANK
            for r in range(chains)}
    want |= {f"{s}_{key}.csv" for s in STEMS_SHARED}
    have = {p.name for p in d.iterdir()}
    check(want <= have, f"missing CSVs: {sorted(want - have)[:5]}")
    pooled = np.loadtxt(d / f"data_ensemble_{key}.csv", delimiter=",",
                        skiprows=1, ndmin=2)
    check(pooled.shape[0] == num and np.isfinite(pooled).all(),
          f"pooled per-gather means not all finite: {pooled[:, 0]}")


def cli_argv(n: int, chains: int, eq: int, mx: int, num: int) -> list:
    """drive_cli's command line (without --data-dir)."""
    return [str(eq), str(mx), str(num), "1.1", "--n", str(n), "--chains",
            str(chains), "--sampler", "auto", "--seed", "2024",
            "--lca-time", "2"]


def drive_cli(n: int, chains: int, eq: int, mx: int, num: int, card: str,
              expect: tuple, keep: Path | None = None):
    """The ensemble CLI at (n, chains) into a temporary data dir (`keep`:
    into that one, kept for a later phase): the CSV set, the summary,
    and the mean energy and acceptance printed exactly as `expect` (the
    values recorded for these seeds); prints where the run's wall time
    went; returns the run's launch counts."""
    from tpu_smc_torch.config import SMCConfig

    with tempfile.TemporaryDirectory() as tmp:
        data = str(keep) if keep is not None else tmp
        out, launches, dt, sim = run_main(cli_argv(n, chains, eq, mx, num)
                                          + ["--data-dir", data])
        cfg = SMCConfig.for_n(n)
        check_ensemble_files(Path(data) / cfg.run_name(), cfg, chains, num)
    mean_e = summary_value(out, "Mean energy:")
    acc = summary_value(out, "Average acceptance ratio:")
    check((mean_e, acc) == expect,
          f"N={n}: mean energy {mean_e}, acceptance {acc}; recorded "
          f"{expect[0]}, {expect[1]}")
    rate = (eq + mx) * chains / dt
    print(f"  N={n} x {chains} chains: {dt:.1f} s, mean E {mean_e}, "
          f"acceptance {acc} (bitwise the recorded run), {rate:,.0f} "
          f"chain-sweeps/s end to end incl. observables and CSVs ({card})",
          flush=True)
    print_split(n, mx, chains, dt, sim)
    if keep is not None:
        RUNS[n] = {"dir": Path(data) / cfg.run_name(), "s": dt,
                   "argv": cli_argv(n, chains, eq, mx, num)}
    return launches


RUNS = {}   # drive_cli's kept runs by N (run dir, wall s, command line)
#             and chain 0 of the large-N run (RUNS[32768])


# tpu_smc's headers of the ladder CSVs (tsweep.py, pt.py, reweight.py)
LADDER_HEADERS = {
    "tsweep": "T, E_mean, E_err, acceptance, cv",
    "pt": "T_lo, T_hi, swap_acceptance, attempts",
    "reweight": "T, E_mean, E_err, cv, cv_err, P, P_err, ess, f",
    "reweight_disorder": "k, T, E_mean, cv, P, ess, f",
}


def read_csv(path: Path):
    lines = path.read_text().splitlines()
    return lines[0], np.asarray([[float(v) for v in ln.split(",")]
                                 for ln in lines[1:]])


def drive_ladder(argv, label: str, stems, card: str, ref=None):
    """A ladder through cli.main (launch counts, plain barred): per-T mean
    E and acceptance finite, mean E rising with T, swap acceptance in
    (0, 1] for every pair, the CSVs with tpu_smc's headers, and MBAR at
    the ladder's own temperatures against the sampled means: within 3
    combined SE of them, or, given `ref` (tpu_smc's run of the same
    ladder, scripts/ladder_pt_reference.py), per-T mean E and the offset
    MBAR - sampled each within 3 combined SE of tpu_smc's. Returns
    (launch counts, seconds)."""
    from tpu_smc_torch.config import SMCConfig

    n = int(argv[argv.index("--n") + 1])
    temps = [float(v) for v in argv[argv.index("--temperatures") + 1]
             .split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        out, launches, dt, _ = run_main(argv + ["--data-dir", tmp])
        cfg = SMCConfig.for_n(n, temperature=float(argv[3]))
        d = Path(tmp) / cfg.run_name()
        tabs = {}
        for stem in stems:
            path = d / f"{stem}_{cfg.file_key()}.csv"
            check(path.exists(), f"{label}: no {path.name}")
            head, tabs[stem] = read_csv(path)
            check(head == LADDER_HEADERS[stem],
                  f"{label}: {path.name} header {head!r}")
    ts = tabs["tsweep"]
    check(np.allclose(ts[:, 0], temps), f"{label}: tsweep temperatures")
    check(np.isfinite(ts).all(), f"{label}: per-T results not finite")
    check_later(bool((np.diff(ts[:, 1]) > 0).all()),
                f"{label}: mean E does not rise with T: {ts[:, 1]}")
    check(bool(((ts[:, 3] > 0) & (ts[:, 3] <= 1)).all()),
          f"{label}: acceptance {ts[:, 3]}")
    if "pt" in tabs:
        sw = tabs["pt"][:, 2]
        check_later(len(sw) == len(temps) - 1
                    and bool(((sw > 0) & (sw <= 1)).all()),
                    f"{label}: swap acceptance {sw}")
    rw = tabs["reweight"]
    mbar = []
    for t in temps:
        j = np.flatnonzero(np.isclose(rw[:, 0], t))
        check(len(j) == 1, f"{label}: reweight grid lacks T = {t}")
        mbar.append(rw[j[0], 1:3])
    mbar = np.asarray(mbar)
    off = mbar[:, 0] - ts[:, 1]
    se = np.hypot(ts[:, 2], mbar[:, 1])
    print(f"  {label}: {dt:.1f} s, launches {launches}; per-T mean E "
          f"{np.round(ts[:, 1], 3).tolist()}, acceptance "
          f"{np.round(ts[:, 3], 4).tolist()}"
          + (f", swap acceptance {np.round(tabs['pt'][:, 2], 3).tolist()}"
             if "pt" in tabs else "")
          + f"; MBAR - sampled at the ladder's T {np.round(off, 3).tolist()}"
          f" = {np.round(off / se, 2).tolist()} combined SE ({card})",
          flush=True)
    if ref is None:
        check_later(np.abs(off / se).max() <= 3.0, f"{label}: MBAR at the "
                    f"ladder's temperatures is {np.abs(off / se).max():.2f}"
                    " combined SE from the sampled means")
    else:
        r_e, r_m = np.asarray(ref["E"]), np.asarray(ref["mbar_E"])
        r_se = np.hypot(ref["E_err"], ref["mbar_err"])
        z_e = (ts[:, 1] - r_e) / np.hypot(ts[:, 2], ref["E_err"])
        z_off = (off - (r_m - r_e)) / np.hypot(se, r_se)
        print(f"  {label} against tpu_smc's run: its MBAR - sampled "
              f"{np.round(r_m - r_e, 3).tolist()}; port - tpu_smc in "
              f"combined SE: mean E {np.round(z_e, 2).tolist()}, MBAR - "
              f"sampled {np.round(z_off, 2).tolist()}", flush=True)
        check_later(np.allclose(ref["T"], temps)
                    and np.abs(z_e).max() <= 3.0
                    and np.abs(z_off).max() <= 3.0,
                    f"{label}: per-T mean E or MBAR - sampled more than 3 "
                    f"combined SE from tpu_smc's run ({z_e}, {z_off})")
    return launches, dt


def drive_disorder_ensemble(n: int, chains: int, k: int, card: str):
    """The disordered ensemble: the CSV set (wall CSV with the realization
    column), finite results, the per-realization summary."""
    from tpu_smc_torch.config import SMCConfig

    with tempfile.TemporaryDirectory() as tmp:
        out, launches, dt, _ = run_main(
            ["200", "600", "6", "1.1", "--n", str(n), "--chains", str(chains),
             "--wall-realizations", str(k), "--seed", "2024",
             "--lca-time", "2", "--data-dir", tmp])
        cfg = SMCConfig.for_n(n)
        d = Path(tmp) / cfg.run_name()
        check_ensemble_files(d, cfg, chains, 6)
        wall = (d / f"wall_{cfg.file_key()}.csv").read_text().splitlines()
        check(wall[0] == "k, nx, ny, x0, ymin"
              and len(wall) == 1 + k * cfg.m * cfg.m,
              f"disorder wall CSV: {wall[:2]}")
    e_k = [float(v) for v in re.findall(r"realization \d+ \(wall seed "
                                        r"\d+\): E = (-?[0-9.]+)", out)]
    mean_e = float(summary_value(out, "Disorder-averaged energy:"))
    check(len(e_k) == k and np.isfinite(e_k).all() and math.isfinite(mean_e)
          and abs(np.mean(e_k) - mean_e) < 1e-5,
          f"disorder summary: {e_k}, {mean_e}")
    print(f"  disordered ensemble N={n} x {chains}, {k} walls: {dt:.1f} s, "
          f"launches {launches}; per-realization E "
          f"{np.round(e_k, 3).tolist()}, disorder-averaged {mean_e} ({card})",
          flush=True)
    return launches, dt


# ----------------------------------------------------------------------
# Phase 3: the measurement layer (g(r), rho(z), P_N/P_T, S(k), Widom,
# umbrella sampling with window exchange)
# ----------------------------------------------------------------------

# tpu_smc's runs on the CPU (XLA engine, jax.random streams) of the
# measurement ladder and of the umbrella windows below, one per seed:
# `python scripts/measurement_reference.py`. Per level (per PMF bin) the
# mean over the seeds and the standard deviation across them, the scatter
# of a single run; the umbrella PMFs on UMBRELLA_GRID, shifted to zero
# mean. A port run passes within 3 combined SE of the mean: its own SE
# is the larger of its bootstrap SE and that scatter (the umbrella's
# replica bootstrap understates it several-fold), the mean's is the
# scatter over sqrt(seeds). The umbrella's seeds 17 and 19 are left out:
# in each a frozen dimer kept one configuration far from every window,
# where tpu_smc's PMF on the grid fails (PERF.md §7).
REF_WIDOM = {
    "T": [1.0, 1.2, 1.4, 1.6], "seeds": 4,
    "mu_ex": [-0.0230865, -0.012596, -0.013291500000000001, -0.00933475],
    "sd": [0.011084434296195125, 0.007532218973627006, 0.005880183132068818,
           0.0011483661944983689]}
REF_UMBRELLA = {
    "seeds": 6,
    "F": [-0.2592321426330457, -0.22369781983252954, -0.2605681483537927,
          0.036529064658552456, 0.0684593958875228, 0.08363007893046964,
          0.10369230348213433, 0.07795944148659818, 0.1195866485654704,
          0.07887988013528825, 0.046422888491877645, 0.0646677441748177,
          0.06594707338351397, 0.046381670497223804, 0.02090711108737588,
          -0.06956518996147697],
    "sd": [0.23989637555199222, 0.14847794825646032, 0.12374830657367507,
           0.059616723355595765, 0.053612610326904155, 0.08975116141909313,
           0.03610527684313603, 0.07227646857237167, 0.11020089587749267,
           0.138667991232286, 0.10998254600281546, 0.0651695337434036,
           0.07649122643968508, 0.12556177830497522, 0.08949328132975229,
           0.10306846254800589]}
UMBRELLA_GRID = (-99.5, -91.5, 16)
UMBRELLA_BOOT = 64
MEASURE_FLAGS = ["--gr-bins", "64", "--z-bins", "64", "--ptensor-bins", "32",
                 "--widom", "64", "--widom-bins", "32", "--nonuniform-z"]
PTENSOR_RTOL = 1e-4    # mean_b (P_N + 2 P_T)/3 against rho T + pair virial


def gather_timer(de, names):
    """Synchronised host-clock timers of driver_ensemble functions, split
    into time inside the gather loop and outside it. Returns (patches for
    `patched(de, ...)`, spent in the loop, calls in the loop)."""
    spent = {k: 0.0 for k in names}
    calls = {k: 0 for k in names}
    in_loop = [False]

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            if in_loop[0]:
                spent[name] += time.perf_counter() - t0
                calls[name] += 1
            return out
        return run

    step = de._gather_step_batched

    def gather(*args, **kw):
        in_loop[0] = True
        try:
            return step(*args, **kw)
        finally:
            in_loop[0] = False

    patches = {k: timed(k, getattr(de, k)) for k in names}
    patches["_gather_step_batched"] = gather
    return patches, spent, calls


def drive_cli_measure(device, card: str):
    """Phase 3's N = 1024 x 512 CLI run with every per-gather measurement
    (MEASURE_FLAGS): mean E and acceptance exactly the recorded values
    (the observables read the state, never change it), the gr, zprofile,
    ptensor and widom CSVs, int rho(z) dz L^2 = N to 1e-4, mu_ex finite,
    and on chain 0's final state mean_b (P_N + 2 P_T)/3 = rho T + the
    pair virial in float32 to PTENSOR_RTOL. Prints the per-gather cost of
    the measurements apart from the sweeps (synchronised host clock).
    Returns the run's launch counts."""
    from tpu_smc_torch import driver_ensemble as de
    from tpu_smc_torch.config import SMCConfig
    from tpu_smc_torch.observables import pressure_tensor_profile
    from tpu_smc_torch.potentials import pair_virial_pressure

    n, c, eq, mx, num = 1024, 512, 64, 192, 3
    patches, spent, calls = gather_timer(
        de, ("_advance", "structure_observables"))
    with tempfile.TemporaryDirectory() as tmp, patched(de, **patches):
        out, launches, dt, sim = run_main(
            [str(eq), str(mx), str(num), "1.1", "--n", str(n), "--chains",
             str(c), "--sampler", "auto", "--seed", "2024", "--lca-time",
             "2"] + MEASURE_FLAGS + ["--data-dir", tmp])
        cfg = SMCConfig.for_n(n, nonuniform_z=True)
        d = Path(tmp) / cfg.run_name()
        key = cfg.file_key()
        check_ensemble_files(d, cfg, c, num)
        _, zp = read_csv(d / f"zprofile_{key}_rank0.csv")
        heads = {stem: read_csv(d / f"{stem}_{key}{sfx}.csv")[0]
                 for stem, sfx in (("gr", "_rank0"), ("zprofile", "_rank0"),
                                   ("ptensor", ""))}
        widom = (d / f"widom_{key}_rank0.csv").read_text().splitlines()
    check(heads == {"gr": "r, g", "zprofile": "z, density",
                    "ptensor": "z, p_n, p_t"}, f"measurement CSVs {heads}")
    check(widom[1] == "z, mu_ex, err, insertions" and len(widom) == 2 + 32,
          f"widom CSV {widom[:2]}")
    mean_e = summary_value(out, "Mean energy:")
    acc = summary_value(out, "Average acceptance ratio:")
    check((mean_e, acc) == ("1590.673720", "0.789075"),
          f"measurement run: mean energy {mean_e}, acceptance {acc}; the "
          "observables changed the trajectory")
    n_int = float(zp[:, 1].sum()) * cfg.box_lz / 64 * cfg.box_l ** 2
    check(abs(n_int / n - 1) <= 1e-4, f"int rho(z) dz L^2 = {n_int}")
    mu = float(summary_value(out, "mu_ex ="))
    check(math.isfinite(mu), f"mu_ex {mu}")
    r0 = torch.as_tensor(sim["agg"].chains[0].r_final, device=device)[None]
    _, pn, pt = pressure_tensor_profile(r0, cfg, nbins=32)
    mech = float(((pn.double() + 2.0 * pt.double()) / 3.0).mean())
    scalar = cfg.rho * cfg.temperature + float(pair_virial_pressure(r0, cfg))
    check(abs(mech / scalar - 1) <= PTENSOR_RTOL,
          f"P_N/P_T identity: {mech} against {scalar}")
    g = calls["structure_observables"]
    print(f"  N={n} x {c} with {' '.join(MEASURE_FLAGS)}: {dt:.1f} s, mean "
          f"E {mean_e}, acceptance {acc} (bitwise the run without them), "
          f"mu_ex {mu}, int rho(z) dz L^2 = {n_int:.4f}, (P_N + 2 P_T)/3 "
          f"{mech:.7g} vs rho T + virial {scalar:.7g} ({card})", flush=True)
    print(f"  N={n} measurement cost per gather: "
          f"{spent['structure_observables'] / g:.3f} s (g(r), rho(z), Widom "
          f"64, P_N/P_T) beside {spent['_advance'] / g:.3f} s of sweeps "
          f"({mx // num} per gather), {g} gathers ({card})", flush=True)
    print_split(n, mx, c, dt, sim)
    return launches


def drive_measure_ladder(card: str):
    """The N = 108 PT ladder with the paired fields: per-T results finite
    and swap acceptance in (0, 1], tpu_smc's reweight columns with mu_ex
    finite, the reweighted rho(z; T), g(r; T), S(k; T) finite, the PMF
    F(z; T) finite wherever rho(z; T) > 0, and the per-level mu_ex within
    3 combined SE of tpu_smc's runs (REF_WIDOM). Returns (launches, s)."""
    from tpu_smc_torch.config import SMCConfig

    argv = ["200", "800", "8", "1.1", "--n", "108", "--temperatures",
            "1.0,1.2,1.4,1.6", "--chains-per-t", "128", "--pt-exchange",
            "16", "--reweight", "1.0:1.6:7", "--z-bins", "32", "--gr-bins",
            "32", "--sk-kmax", "4", "--widom", "32", "--seed", "2024"]
    with tempfile.TemporaryDirectory() as tmp:
        out, launches, dt, _ = run_main(argv + ["--data-dir", tmp])
        cfg = SMCConfig.for_n(108)
        d = Path(tmp) / cfg.run_name()
        tabs = {}
        for stem in ("tsweep", "pt", "reweight", "reweight_zprofile",
                     "reweight_gr", "reweight_sk", "reweight_pmf"):
            path = d / f"{stem}_{cfg.file_key()}.csv"
            check(path.exists(), f"measurement ladder: no {path.name}")
            tabs[stem] = read_csv(path)
    head, rw = tabs["reweight"]
    check(head == "T, E_mean, E_err, cv, cv_err, P, P_err, mu_ex, mu_ex_err,"
          " ess, f", f"measurement ladder: reweight header {head!r}")
    check(np.isfinite(rw).all(), "measurement ladder: reweight not finite")
    ts, sw = tabs["tsweep"][1], tabs["pt"][1][:, 2]
    check(np.isfinite(ts).all() and bool(((sw > 0) & (sw <= 1)).all()),
          f"measurement ladder: per-T results or swaps {sw}")
    for stem in ("reweight_zprofile", "reweight_gr", "reweight_sk"):
        check(np.isfinite(tabs[stem][1]).all(),
              f"measurement ladder: {stem} not finite")
    zp, pmf = tabs["reweight_zprofile"][1], tabs["reweight_pmf"][1]
    occupied = zp[:, 2] > 0
    check(bool(np.isfinite(pmf[occupied, 2:]).all()) and len(
        np.unique(pmf[np.isfinite(pmf[:, 2]), 0])) == 7,
          "measurement ladder: the PMF is not finite where rho(z; T) > 0")
    rows = re.findall(r"T ([0-9.]+): mu_ex = (-?[0-9.]+) ± ([0-9.]+)", out)
    mu = np.asarray([[float(v) for v in row] for row in rows])
    check(mu.shape == (4, 3) and np.allclose(mu[:, 0], REF_WIDOM["T"]),
          f"measurement ladder: per-level mu_ex lines {rows}")
    ref, sd = np.asarray(REF_WIDOM["mu_ex"]), np.asarray(REF_WIDOM["sd"])
    z = (mu[:, 1] - ref) / np.hypot(np.maximum(mu[:, 2], sd),
                                    sd / math.sqrt(REF_WIDOM["seeds"]))
    print(f"  measurement ladder N=108 4 x 128, PT every 16, fields: "
          f"{dt:.1f} s, launches {launches}; per-level mu_ex "
          f"{mu[:, 1].tolist()} ± {mu[:, 2].tolist()}, tpu_smc "
          f"{np.round(ref, 6).tolist()} (mean of {REF_WIDOM['seeds']} seeds, "
          f"scatter {np.round(sd, 6).tolist()}): {np.round(z, 2).tolist()} "
          f"combined SE; "
          f"MBAR mu_ex(T) {np.round(rw[:, 7], 5).tolist()}; PMF finite "
          f"over {int(np.isfinite(pmf[:, 2]).sum())}/{len(pmf)} (T, z) "
          f"bins ({card})", flush=True)
    check_later(np.abs(z).max() <= 3.0, f"measurement ladder: mu_ex "
                f"{np.abs(z).max():.2f} combined SE from tpu_smc's run")
    return launches, dt


def drive_umbrella(card: str):
    """`--umbrella=-99:-92:8` at N = 108 (the lower wall's contact region;
    the wall is at z = -100) with 8 replicas and REUS every 10 sweeps,
    200 + 800 sweeps, on the plain engine: window and swap acceptances in
    (0, 1], the CLI's PMF finite over >= 80 % of its bins, and the PMF of
    the same samples on tpu_smc's grid (UMBRELLA_GRID) within 3 combined
    SE of the mean of tpu_smc's runs (REF_UMBRELLA) in every bin both
    resolve, after removing each PMF's mean over those bins (F is
    defined up to a constant). Prints chain-sweeps/s. Returns (launches,
    s)."""
    from tpu_smc_torch import umbrella as tum
    from tpu_smc_torch.config import SMCConfig

    argv = ["200", "800", "80", "1.1", "--umbrella=-99:-92:8",
            "--umbrella-replicas", "8", "--umbrella-exchange", "10",
            "--umbrella-bins", "32", "--seed", "2024"]
    with tempfile.TemporaryDirectory() as tmp, \
            captured(tum, "simulate_umbrella") as seen:
        out, launches, dt, _ = run_main(argv + ["--data-dir", tmp])
        cfg = SMCConfig.for_n(108)
        lines = (Path(tmp) / cfg.run_name() / f"umbrella_pmf_"
                 f"{cfg.file_key()}.csv").read_text().splitlines()
    check("Ensemble sweep engine: torch (plain engine, umbrella bias)" in out,
          "umbrella: no plain-engine line")
    check(lines[0] == "z, F, err" and len(lines) == 1 + 32 + 1 + 8,
          f"umbrella CSV {lines[:2]}")
    f_cli = np.asarray([float(v.split(",")[1]) for v in lines[1:33]])
    res = seen["out"][1]
    acc, sw = res.acceptance, res.swap_acceptance
    check(bool(((acc > 0) & (acc <= 1)).all())
          and bool(((sw > 0) & (sw <= 1)).all()),
          f"umbrella acceptances {acc}, swaps {sw}")
    lo, hi, nb = UMBRELLA_GRID
    try:
        ours = tum.umbrella_pmf(res, n_bins=nb, z_range=(lo, hi),
                                n_boot=UMBRELLA_BOOT, seed=0)
    except ValueError as exc:     # every MBAR weight outside the grid
        raise Failure(f"umbrella PMF on tpu_smc's grid: {exc}")
    ref_f = np.asarray(REF_UMBRELLA["F"], np.float64)
    ref_sd = np.asarray(REF_UMBRELLA["sd"], np.float64)
    both = np.isfinite(ours.pmf) & np.isfinite(ref_f) & np.isfinite(
        ours.err_pmf)
    dev = (ours.pmf - ours.pmf[both].mean()) - (ref_f - ref_f[both].mean())
    zs = dev[both] / np.hypot(np.maximum(ours.err_pmf[both], ref_sd[both]),
                              ref_sd[both] / math.sqrt(REF_UMBRELLA["seeds"]))
    fin = float(np.isfinite(f_cli).mean())
    print(f"  umbrella N=108, 8 windows z0 -99..-92 x 8 replicas, REUS every "
          f"10: {dt:.1f} s, {res.sweeps_per_second:,.1f} chain-sweeps/s in "
          f"production ({res.sweeps_per_second / 64:.2f} sweeps/s per chain,"
          f" plain engine), launches {launches}; window acceptance "
          f"{np.round(acc, 4).tolist()}, swap acceptance "
          f"{np.round(sw, 3).tolist()}; CLI PMF finite over {fin:.0%} of 32 "
          f"bins; against tpu_smc on {int(both.sum())} shared bins: "
          f"max {np.abs(zs).max():.2f} combined SE ({card})", flush=True)
    check_later(fin >= 0.8, f"umbrella PMF finite over {fin:.0%} of bins")
    check_later(both.sum() >= 0.8 * nb and np.abs(zs).max() <= 3.0,
                f"umbrella PMF {np.abs(zs).max():.2f} combined SE from "
                f"tpu_smc's over {int(both.sum())} bins")
    return launches, dt


# tpu_smc's large-N run (scripts/validate_stream.py:105-115, its record
# docs/EVIDENCE_STREAM.json "n32768_rho_matched", a TPU v5 lite chip):
# the x/y box scaled to the N = 1024 density, 16 + 32 sweeps at cadence 8
TPU_LARGE_N = {"e_per_n": -0.0625, "acceptance": 0.8474,
               "tracked_vs_exact_rel": 3.439566398911803e-05}
LARGE_N_DRIFT = 1e-4   # carried vs exact energy, relative, at every resync


def resync_drift():
    """A stand-in for driver_ensemble.recompute_energy that records, at
    every resync, the largest |carried - exact| / max(|exact|, 1) over
    the chains, and the list it fills."""
    from tpu_smc_torch import driver_ensemble as de

    recompute, drift = de.recompute_energy, []

    def resync(state, w, cfg):
        new = recompute(state, w, cfg)
        exact = new.energy.double()
        rel = (state.energy.double() - exact).abs() / exact.abs().clamp(min=1.0)
        drift.append(float(rel.max()))
        return new

    return resync, drift


def large_n_config():
    from tpu_smc_torch.config import SMCConfig

    n = 32768
    return SMCConfig(n=n, box_l=math.sqrt(n / (5.7e-3 * 240.0)),
                     box_lz=240.0, dtype="float32", lca_time=2)


def drive_large_n(device, card: str):
    """simulate_ensemble at tpu_smc's large-N width: the density-matched
    N = 32768 box x 128 chains, 16 warm-up + 32 production sweeps at
    sort cadence 8 (2 gathers of 16, CNA at the second; the length of
    tpu_smc's run), as a main-path run. Gates: every per-gather value finite, carried vs exact energy
    within LARGE_N_DRIFT at every resync, the streamed kernel launched
    (and no other), CNA run. Prints E/N and acceptance beside tpu_smc's,
    peak device memory, and where the wall time went, the gather loop's
    observables split out. Returns (launch counts, the split)."""
    from tpu_smc_torch import driver_ensemble as de
    from tpu_smc_torch.config import RunParams
    from tpu_smc_torch.driver import ObservableOptions
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    cfg, c = large_n_config(), 128
    params = RunParams(16, 32, 2)
    spent = {k: 0.0 for k in ("sweeps", "recompute", "pressure", "voxels",
                              "cna")}
    loop_spent = dict(spent)
    calls = {"cna": 0}
    resync, drift = resync_drift()
    in_loop = [False]

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            spent[name] += dt
            if in_loop[0]:
                loop_spent[name] += dt
            calls[name] = calls.get(name, 0) + 1
            return out
        return run

    def gather(*args, **kw):
        in_loop[0] = True
        try:
            return gather_step(*args, **kw)
        finally:
            in_loop[0] = False

    gather_step = de._gather_step_batched
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, w = init_ensemble_state(cfg, seed_words(1), c, device=device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    with main_path() as launches, patched(
            de, _advance=timed("sweeps", de._advance),
            recompute_energy=timed("recompute", resync),
            wall_obs_chains=timed("pressure", de.wall_obs_chains),
            density_mobility_update=timed("voxels",
                                          de.density_mobility_update),
            cluster_histograms_chains=timed("cna",
                                            de.cluster_histograms_chains),
            _gather_step_batched=gather):
        t1 = time.perf_counter()
        state, agg = de.simulate_ensemble(
            cfg, params, state, w,
            ObservableOptions(sampler="zsorted", stream_seed=3))
    t_sim = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loop = params.maxsteps * c / agg.sweeps_per_second
    finite = all(np.isfinite(r.pressure_trace).all()
                 and np.isfinite(r.energy_trace_full).all()
                 for r in agg.chains) and bool(torch.isfinite(state.r).all())
    check(finite, "large N: a per-gather value is not finite")
    check(launches["stream"] > 0 and launches["zskip"] == launches["dense"]
          == 0, f"large N: launches {launches}: the streamed kernel only")
    check(calls["cna"] >= 1, "large N: CNA did not run")
    check(max(drift) <= LARGE_N_DRIFT,
          f"large N: carried vs exact energy {max(drift):.3g} relative")
    e_n = float(state.energy.double().mean()) / cfg.n
    obs = sum(v for k, v in loop_spent.items() if k != "sweeps")
    print(f"  N=32768 x {c} density-matched box (L = {cfg.box_l:.3f}, "
          f"Lz = 240): {t_init + t_sim:.1f} s; E/N {e_n:.4f} (tpu_smc "
          f"{TPU_LARGE_N['e_per_n']}), acceptance {agg.acceptance_ratio:.4f} "
          f"(tpu_smc {TPU_LARGE_N['acceptance']}; its run: 16 + 32 sweeps on "
          f"a TPU v5 lite chip), carried vs exact energy max "
          f"{max(drift):.3g} relative over {len(drift)} resyncs (tpu_smc "
          f"{TPU_LARGE_N['tracked_vs_exact_rel']:.3g}), launches {launches}, "
          f"peak device memory {peak:.2f} GiB ({card})", flush=True)
    print(f"  N=32768 wall time: {t_init:.3f} s state init (energy of the "
          f"lattice), {t_sim - loop:.3f} s thermalization + post-processing, "
          f"{loop:.3f} s gather loop = {loop_spent['sweeps']:.3f} s sweeps + "
          f"{obs:.3f} s observables (recompute {loop_spent['recompute']:.3f}, "
          f"pressure {loop_spent['pressure']:.3f}, voxels "
          f"{loop_spent['voxels']:.3f}, CNA {loop_spent['cna']:.3f} s for "
          f"{calls['cna']} pass); {params.maxsteps * c / loop:.2f} chain-"
          f"sweeps/s over the loop, {params.maxsteps * c / loop_spent['sweeps']:.2f}"
          f" over its sweeps; thermalization sweeps "
          f"{spent['sweeps'] - loop_spent['sweeps']:.3f} s ({card})",
          flush=True)
    # chain 0 of the final state stays for the particle-sharded energy
    RUNS[32768] = {"r": state.r[0].clone(), "w": w, "cfg": cfg}
    return launches


def chain_stats(agg):
    """Mean E, its SE, mean acceptance, its SE, over the chains of an
    EnsembleResults (the SE from the spread of the chain means)."""
    e = np.asarray([ch.mean_energy for ch in agg.chains])
    acc = np.asarray([ch.acceptance_ratio for ch in agg.chains])
    k = len(e)
    return (float(e.mean()), float(e.std(ddof=1) / np.sqrt(k)),
            float(acc.mean()), float(acc.std(ddof=1) / np.sqrt(k)))


def drive_bulk_full(card: str):
    """The bulk CLI at full width: `python -m tpu_smc_torch 16 48 3 1.5
    --bulk --n 4000 --rho 0.5 --lj-cutoff 2.5 --gamma 0.01 --chains 128
    --seed 5 --lca-time 3` (N = 4 x 10^3 fills the FCC lattice: L = 20).
    Gates: the dense engine line and dense bulk launches only, carried vs
    exact energy within LARGE_N_DRIFT relative at every resync,
    acceptance in (0, 1), the CSV set with finite pooled means. Prints
    where the wall time went. Returns the launch counts."""
    from tpu_smc_torch import driver_ensemble as de

    n, c = 4000, 128
    resync, drift = resync_drift()
    with tempfile.TemporaryDirectory() as tmp, patched(
            de, recompute_energy=resync):
        out, launches, dt, sim = run_main(
            ["16", "48", "3", "1.5", "--bulk", "--n", str(n), "--rho", "0.5",
             "--lj-cutoff", "2.5", "--gamma", "0.01", "--chains", str(c),
             "--seed", "5", "--lca-time", "3", "--data-dir", tmp])
        cfg = bulk_config(n)
        check_ensemble_files(Path(tmp) / cfg.run_name(), cfg, c, 3)
    check("Ensemble sweep engine: dense" in out, "bulk CLI: no dense line")
    check(launches["dense"] > 0 and launches["pbc_z"] == launches["dense"]
          == launches["no_walls"] and launches["zskip"] == launches["stream"]
          == 0, f"bulk CLI launches {launches}")
    check(len(drift) >= 4 and max(drift) <= LARGE_N_DRIFT,
          f"bulk CLI: carried vs exact energy {drift} relative")
    acc = float(summary_value(out, "Average acceptance ratio:"))
    mean_e = float(summary_value(out, "Mean energy:"))
    check(0.0 < acc < 1.0 and math.isfinite(mean_e),
          f"bulk CLI: acceptance {acc}, mean E {mean_e}")
    print(f"  bulk CLI N={n} x {c} (L = {cfg.box_l:.3f}, rho 0.5, rc 2.5): "
          f"{dt:.1f} s, mean E {mean_e}, acceptance {acc}, carried vs "
          f"exact energy max {max(drift):.3g} relative over {len(drift)} "
          f"resyncs, launches {launches} ({card})", flush=True)
    print_split(n, 48, c, dt, sim)
    return launches


# tpu_smc's CPU run of `python -m tpu_smc 200 800 8 1.5 --bulk --n 32
# --rho 0.1 --gamma 0.013333 --chains 64 --seed 7` (XLA engine, float32):
# `PYTHONPATH=. python tests/test_torch_bulk.py`, mean E and acceptance
# over the chains with their SE from the chain spread
REF_BULK = {"E": 49.94991594552994, "E_err": 0.1029273613723217,
            "acc": 0.8041113281250001, "acc_err": 0.0010348520348878293}


def drive_bulk_vs_jax(card: str):
    """`python -m tpu_smc_torch 200 800 8 1.5 --bulk --n 32 --rho 0.1
    --gamma 0.013333 --chains 512 --seed 7` (A = 0.02, tests/
    test_bulk_parity.py's state) on the dense kernel: mean E and
    acceptance within 3 combined SE of tpu_smc's run (REF_BULK).
    Returns the launch counts."""
    with tempfile.TemporaryDirectory() as tmp:
        out, launches, dt, sim = run_main(
            ["200", "800", "8", "1.5", "--bulk", "--n", "32", "--rho", "0.1",
             "--gamma", "0.013333", "--chains", "512", "--seed", "7",
             "--data-dir", tmp])
    check("Ensemble sweep engine: dense" in out and launches["pbc_z"] > 0
          and launches["pbc_z"] == launches["dense"],
          f"bulk N=32: engine or launches {launches}")
    e, e_se, acc, acc_se = chain_stats(sim["agg"])
    z_e = (e - REF_BULK["E"]) / math.hypot(e_se, REF_BULK["E_err"])
    z_a = (acc - REF_BULK["acc"]) / math.hypot(acc_se, REF_BULK["acc_err"])
    print(f"  bulk N=32 x 512: {dt:.1f} s, mean E {e:.4f} +- {e_se:.4f}, "
          f"acceptance {acc:.5f} +- {acc_se:.5f}; tpu_smc (64 chains, CPU) "
          f"{REF_BULK['E']:.4f} +- {REF_BULK['E_err']:.4f}, "
          f"{REF_BULK['acc']:.5f} +- {REF_BULK['acc_err']:.5f}: "
          f"{z_e:+.2f} and {z_a:+.2f} combined SE, launches {launches} "
          f"({card})", flush=True)
    check_later(abs(z_e) <= 3.0 and abs(z_a) <= 3.0,
                f"bulk N=32: mean E {z_e:+.2f} or acceptance {z_a:+.2f} "
                "combined SE from tpu_smc's run")
    return launches


def drive_refnoise(device, card: str):
    """simulate_ensemble at N = 108 x 512 on the dense engine with
    reference_noise=True and, at the same seed, with i.i.d. noise (200 +
    600 sweeps, 6 gathers): both mean energies and the reference mode's
    offset (tpu_smc measured about +0.6 %, tpu_smc/config.py:113-119;
    reported, not gated). Then the reference run's own noise, the pairs
    the kernel drew in its first 64 production sweeps, dumped through K5
    from the same seed words: each plane against reference_noise_plane
    of the same words (within 1e-6), and the pair moments. Gates: finite,
    reference-noise launches in the one run, carried vs exact energy
    within LARGE_N_DRIFT. Returns the launch counts of the reference run
    and K5's main-path case: (its words, n, c, s2a, max |kernel -
    plain|)."""
    from tpu_smc_torch import driver_ensemble as de
    from tpu_smc_torch import ensemble as en
    from tpu_smc_torch.config import RunParams, SMCConfig
    from tpu_smc_torch.driver import ObservableOptions
    from tpu_smc_torch.kernels import sweep as ks
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    params, c, seed = RunParams(200, 600, 6), 512, 2024
    res = {}
    for rn in (True, False):
        cfg = SMCConfig.for_n(108, reference_noise=rn)
        state, w = init_ensemble_state(cfg, seed_words(seed), c,
                                       device=device)
        resync, drift = resync_drift()
        t0 = time.perf_counter()
        with main_path() as launches, patched(de, recompute_energy=resync):
            end, agg = de.simulate_ensemble(
                cfg, params, state, w,
                ObservableOptions(sampler="dense", stream_seed=seed))
            if rn:
                # the run's production sweeps 200..263: their seed words
                start = end.replace(sweeps=torch.full_like(
                    end.sweeps, params.eqsteps))
                words, _ = en._per_sweep_randomness(start, cfg, seed, 64)
                s2a = math.sqrt(2.0 * cfg.proposal_a)
                planes = torch.stack([ks.debug_reference_noise(
                    wd, cfg.n, c, s2a, device) for wd in words])
        dt = time.perf_counter() - t0
        finite = all(np.isfinite(r.energy_trace_full).all()
                     for r in agg.chains)
        check(finite and max(drift) <= LARGE_N_DRIFT,
              f"reference noise {rn}: finite {finite}, drift {drift}")
        check(launches["dense"] > 0 and launches["reference_noise"] == (
            launches["dense"] if rn else 0), f"reference noise {rn}: "
            f"launches {launches}")
        res[rn] = (agg, launches, dt)
    plain = torch.stack([ks.reference_noise_plane(wd, cfg.n, c, s2a, device)
                         for wd in words])
    k5_err = float((planes - plain).abs().max())
    check(k5_err <= 1e-6, f"K5 at the run's [{planes.shape[1]}, {c}]: max "
          f"|kernel - plain| {k5_err:.3g}")
    print(f"  K5, the run's 64 planes [{planes.shape[1]}, {c}]: max |kernel "
          f"- reference_noise_plane| {k5_err:.3g} "
          f"({'bitwise' if torch.equal(planes, plain) else 'within 1e-6'})",
          flush=True)
    e_rn, se_rn, a_rn, _ = chain_stats(res[True][0])
    e_iid, se_iid, a_iid, _ = chain_stats(res[False][0])
    print(f"  N=108 x {c}, 200 + 600 sweeps: reference noise mean E "
          f"{e_rn:.4f} +- {se_rn:.4f} (acceptance {a_rn:.5f}, "
          f"{res[True][2]:.1f} s), i.i.d. {e_iid:.4f} +- {se_iid:.4f} "
          f"(acceptance {a_iid:.5f}, {res[False][2]:.1f} s): offset "
          f"{(e_rn / e_iid - 1) * 100:+.3f} % ({(e_rn - e_iid) / math.hypot(se_rn, se_iid):+.2f} "
          f"combined SE; tpu_smc measured about +0.6 %), launches "
          f"{res[True][1]} ({card})", flush=True)
    check_moments(planes, s2a, "the reference run's noise, sweeps 200-263 "
                  f"({planes.shape[0]} x {tuple(planes.shape[1:])} via K5)")
    return res[True][1], (tuple(int(v) for v in words[0]), cfg.n, c, s2a,
                          k5_err)


def drive_m10(card: str):
    """`python -m tpu_smc_torch 8 16 2 1.1 --m 10 --chains 512` (N = 108,
    a 10 x 10 wall grid): the dense kernel, the CSV set, a finite mean E.
    Returns the launch counts."""
    from tpu_smc_torch.config import SMCConfig

    with tempfile.TemporaryDirectory() as tmp:
        out, launches, dt, _ = run_main(
            ["8", "16", "2", "1.1", "--m", "10", "--chains", "512", "--seed",
             "2024", "--data-dir", tmp])
        cfg = SMCConfig.for_n(108, m=10)
        check_ensemble_files(Path(tmp) / cfg.run_name(), cfg, 512, 2)
    mean_e = float(summary_value(out, "Mean energy:"))
    check("Ensemble sweep engine: dense" in out and launches["dense"] > 0
          and math.isfinite(mean_e), f"M=10 CLI: launches {launches}, "
          f"mean E {mean_e}")
    print(f"  CLI M=10 N=108 x 512: {dt:.1f} s, mean E {mean_e}, acceptance "
          f"{summary_value(out, 'Average acceptance ratio:')}, launches "
          f"{launches} ({card})", flush=True)
    return launches


def drive_cli_large(card: str):
    """`python -m tpu_smc_torch 8 8 1 1.1 --n 32768 --chains 128 --seed 5
    --lca-time 1` in the reference's default 33 x 33 x 240 box (dense:
    tpu_smc measured acceptance 0 there, so acceptance is not gated): the
    9-file set, finite pooled means, the streamed engine line, streamed
    launches only. One gather of 8 sweeps (8 16 2 before the ensemble
    family's phase: each gather's observables take ~35 s here)."""
    from tpu_smc_torch.config import SMCConfig

    n, c = 32768, 128
    with tempfile.TemporaryDirectory() as tmp:
        out, launches, dt, sim = run_main(
            ["8", "8", "1", "1.1", "--n", str(n), "--chains", str(c),
             "--seed", "5", "--lca-time", "1", "--data-dir", tmp])
        cfg = SMCConfig.for_n(n)
        check_ensemble_files(Path(tmp) / cfg.run_name(), cfg, c, 1)
    check("Ensemble sweep engine: zsorted (streamed)" in out,
          "N=32768 CLI: no streamed engine line")
    check(launches["stream"] > 0 and launches["zskip"] == launches["dense"]
          == 0, f"N=32768 CLI launches {launches}")
    mean_e = float(summary_value(out, "Mean energy:"))
    check(math.isfinite(mean_e), f"N=32768 CLI mean energy {mean_e}")
    print(f"  CLI N={n} x {c} (default box): {dt:.1f} s, mean E {mean_e}, "
          f"acceptance {summary_value(out, 'Average acceptance ratio:')}, "
          f"launches {launches} ({card})", flush=True)
    print_split(n, 8, c, dt, sim)
    return launches


def drive_validation(device, card: str):
    """scripts/validate_banded.py's contract on the port: from one state at
    N = 1024 x 256 chains (400 dense sweeps from the lattice), 200 sweeps
    each through the dense, zsorted, zsorted + xsort 4 (K1-xs) and banded
    (K4) engines, as one main-path run. Gates, the script's bar
    (validate_banded.py:108-110): each engine's mean final energy within
    4 combined SE of dense (SE = std / sqrt(C - 1) over the chains) and
    its acceptance within 0.01. Prints each engine's mean E, acceptance,
    chain-sweeps/s (the engine call, sorts included) and the banded
    fallback fraction. Returns the launch counts."""
    from tpu_smc_torch import ensemble as en

    cfg, state, w = equilibrated(device)
    a, c, s = cfg.proposal_a, state.n_chains, 200
    engines = {
        "dense": lambda: en.ensemble_sweeps_dense(state, w, cfg, a, s,
                                                  seed=7),
        "zsorted": lambda: en.ensemble_sweeps_zsorted(state, w, cfg, a, s,
                                                      seed=7),
        "xsort 4": lambda: en.ensemble_sweeps_zsorted(
            state, w, cfg, a, s, seed=7, xsort_slices=4),
        "banded": lambda: en.ensemble_sweeps_banded(state, w, cfg, a, s,
                                                    seed=7)}
    res = {}
    with main_path() as launches:
        for name, run in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            e = out[0].energy.double().cpu().numpy()
            res[name] = dict(
                E=float(e.mean()), err=float(e.std() / math.sqrt(c - 1)),
                acc=float(out[1].accepted.double().mean()) / cfg.n,
                rate=s * c / dt, fb=out[2] if len(out) > 2 else None)
    check(launches["dense"] == 1 and launches["zskip"] > 0
          and launches["xskip"] > 0 and launches["banded"] == s
          and launches["stream"] == 0, f"validation launches {launches}")
    ref = res["dense"]
    for name, r in res.items():
        sig = math.hypot(r["err"], ref["err"])
        de, dacc = abs(r["E"] - ref["E"]), abs(r["acc"] - ref["acc"])
        print(f"  validation N=1024 x {c}, {s} sweeps from 400 dense: "
              f"{name} mean E {r['E']:.3f} +- {r['err']:.3f}, acceptance "
              f"{r['acc']:.5f}, {r['rate']:,.0f} chain-sweeps/s"
              + (f", fallback fraction {r['fb']:.4f}" if r["fb"] is not None
                 else "")
              + ("" if name == "dense" else
                 f"; against dense {de / sig:.2f} combined SE, |d acc| "
                 f"{dacc:.5f}") + f" ({card})", flush=True)
        if name != "dense":
            check_later(de < 4 * sig and dacc < 0.01,
                        f"validation: {name} is {de / sig:.2f} combined SE "
                        f"and {dacc:.5f} in acceptance from dense")
    return launches


# ----------------------------------------------------------------------
# Phase 3: the single chain (main.c) and resume
# ----------------------------------------------------------------------

STEMS_SINGLE = ("positions", "local_temp", "data", "local", "total_clusters",
                "autocorrelation")
# (EQ, MAX, NUM) of the main.c run at N = 108, of the 64-chain run it is
# held against, and of the single chain at N = 1024; (N, engine, (EQ,
# MAX, NUM)) of the one-chain-against-8 checks
MAIN_C = (2000, 8000, 400)
MAIN_C_ENSEMBLE = (2000, 2000, 100)
SINGLE_1024 = (100, 400, 20)
SINGLE_VS_8 = ((108, "dense", (64, 256, 8)), (1024, "zsorted", (32, 128, 4)))


def check_single_files(d: Path, cfg, num: int, windows: int):
    """tpu_smc's nine CSVs of a single-chain run, finite data rows and
    one local_temp voxel block per storage window."""
    key = cfg.file_key()
    want = {f"{s}_{key}_rank0.csv" for s in STEMS_SINGLE}
    want |= {f"{s}_{key}.csv" for s in ("wall", "info", "last_state")}
    have = {p.name for p in d.iterdir()}
    check(have == want, f"single-chain CSVs: extra {sorted(have - want)}, "
          f"missing {sorted(want - have)}")
    data = np.loadtxt(d / f"data_{key}_rank0.csv", delimiter=",",
                      skiprows=1, ndmin=2)
    check(data.shape == (num, 3) and np.isfinite(data).all(),
          f"single-chain data rows: {data.shape}")
    temp = (d / f"local_temp_{key}_rank0.csv").read_text().count("\n")
    check(temp == 1 + windows * cfg.n_voxels,
          f"local_temp holds {temp} lines, want 1 + {windows} blocks")


def trace_se(e: np.ndarray) -> float:
    """Standard error of a correlated trace's mean from its own tau."""
    from tpu_smc_torch.observables import tau_int

    return float(np.std(e) * math.sqrt(2.0 * tau_int(e) / len(e)))


@contextlib.contextmanager
def engine_timer():
    """driver_ensemble._advance timed on the host clock, synchronised
    before and after, for the production calls (those that collect the
    sweep trace; thermalization does not): yields their seconds."""
    from tpu_smc_torch import driver_ensemble as de

    advance, spent = de._advance, []

    def timed(state, w, cfg, a, n_sweeps, opts, collect_trace):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = advance(state, w, cfg, a, n_sweeps, opts, collect_trace)
        torch.cuda.synchronize()
        if collect_trace:
            spent.append(time.perf_counter() - t)
        return out

    with patched(de, _advance=timed):
        yield spent


def print_single_split(n: int, mx: int, dt: float, sim: dict, spent: list):
    """A single-chain run's wall-time split, its gather loop split into
    the engine's calls and the rest (observables, host reads, CSV rows)."""
    print_split(n, mx, 1, dt, sim)
    loop = mx / sim["sps"]
    print(f"  N={n} one chain: gather loop {loop:.3f} s = {sum(spent):.3f} s "
          f"in {len(spent)} engine calls of {mx // max(len(spent), 1)} "
          f"sweeps ({1e3 * sum(spent) / mx:.4f} ms per sweep, synchronised "
          f"host clock) + {loop - sum(spent):.3f} s observables and host",
          flush=True)


def drive_main_c(device, card: str):
    """The reference's main.c run, `python -m tpu_smc_torch 2000 8000 400
    1.10` (one chain, N = 108, the dense kernel): tpu_smc's nine CSVs,
    finite results, mean E within 4 combined SE of a 64-chain run of
    2000 + 2000 sweeps (the chain's SE from its own tau, the ensemble's
    from its chain spread); then the single chain at N = 1024 (zsorted).
    Returns the launch counts of both runs."""
    from tpu_smc_torch.config import RunParams, SMCConfig
    from tpu_smc_torch.driver import ObservableOptions
    from tpu_smc_torch.driver_ensemble import simulate_ensemble
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    eq, mx, num = MAIN_C
    with tempfile.TemporaryDirectory() as tmp, \
            engine_timer() as spent:
        out, launches, dt, sim = run_main(
            [str(eq), str(mx), str(num), "1.10", "--seed", "2024",
             "--data-dir", tmp])
        cfg = SMCConfig.for_n(108, temperature=1.10)
        check_single_files(Path(tmp) / cfg.run_name(), cfg, num, 1)
    check("Ensemble sweep engine: dense" in out, "main.c run: not dense")
    check(launches["dense"] > 0 and launches["zskip"] == launches["stream"]
          == 0, f"main.c run launches {launches}")
    res = sim["agg"].chains[0]
    e = res.energy_trace_full
    check(len(e) == mx + 1 and np.isfinite(e).all()
          and 0 < res.acceptance_ratio < 1, "main.c run: results")
    check(summary_value(out, "Mean energy:") == f"{res.mean_energy:f}",
          "main.c run: printed mean energy")
    with main_path() as ens_launches:
        state, w = init_ensemble_state(cfg, seed_words(2025), 64,
                                       device=device)
        _, agg = simulate_ensemble(cfg, RunParams(*MAIN_C_ENSEMBLE), state,
                                   w, opts=ObservableOptions(
                                       sampler="dense", stream_seed=2025))
    check(ens_launches["dense"] > 0, f"64-chain launches {ens_launches}")
    means = np.asarray([c.mean_energy for c in agg.chains])
    se1, se2 = trace_se(e), float(means.std(ddof=1) / math.sqrt(64))
    z = (res.mean_energy - means.mean()) / math.hypot(se1, se2)
    print(f"  main.c run N=108, one chain, {eq} + {mx} sweeps: {dt:.1f} s, "
          f"{res.sweeps_per_second:,.1f} sweeps/s in the gather loop, "
          f"launches {launches}; mean E {res.mean_energy:f} +- {se1:.4f} "
          f"(tau), acceptance {res.acceptance_ratio:f}; 64 chains of "
          f"{MAIN_C_ENSEMBLE[0]} + {MAIN_C_ENSEMBLE[1]} sweeps: mean E "
          f"{means.mean():f} +- {se2:.4f}, acceptance "
          f"{agg.acceptance_ratio:f}; {z:+.2f} combined SE ({card})",
          flush=True)
    print_single_split(108, mx, dt, sim, spent)
    check_later(abs(z) < 4.0, f"main.c run: mean E {z:+.2f} combined SE "
                "from the 64-chain run")
    eq, mx, num = SINGLE_1024
    with tempfile.TemporaryDirectory() as tmp, \
            engine_timer() as spent:
        out, l1024, dt, sim = run_main(
            [str(eq), str(mx), str(num), "1.10", "--n", "1024", "--seed",
             "2024", "--data-dir", tmp])
        cfg = SMCConfig.for_n(1024, temperature=1.10)
        check_single_files(Path(tmp) / cfg.run_name(), cfg, num, 1)
    check("Ensemble sweep engine: zsorted" in out
          and l1024["zskip"] > 0 and l1024["dense"] == 0,
          f"N=1024 single chain: engine or launches {l1024}")
    r = sim["agg"].chains[0]
    print(f"  single chain N=1024, {eq} + {mx} sweeps: {dt:.1f} s, "
          f"{r.sweeps_per_second:,.1f} sweeps/s in the gather loop, "
          f"launches {l1024}; mean E {r.mean_energy:f}, acceptance "
          f"{r.acceptance_ratio:f} ({card})", flush=True)
    print_single_split(1024, mx, dt, sim, spent)
    return {k: launches[k] + l1024[k] for k in launches}


def drive_single_vs_ensemble(device, card: str):
    """driver.simulate of one chain bitwise chain 0 of simulate_ensemble
    of 8 chains from the same seeded start, at N = 108 (dense, K1) and
    N = 1024 (zsorted, K2). Returns the launch counts."""
    from tpu_smc_torch.config import RunParams, SMCConfig
    from tpu_smc_torch.driver import ObservableOptions, simulate
    from tpu_smc_torch.driver_ensemble import simulate_ensemble
    from tpu_smc_torch.state import (batch_chain_state, init_chain_state,
                                     seed_words)

    total = {}
    for n, sampler, steps in SINGLE_VS_8:
        params = RunParams(*steps)
        cfg = SMCConfig.for_n(n, storage_time=2, lca_time=2)
        s0, w = init_chain_state(cfg, seed_words(31), device=device)
        opts = ObservableOptions(sampler=sampler, stream_seed=31)
        with main_path() as l1:
            st1, one = simulate(cfg, params, batch_chain_state(s0, 1), w,
                                opts=opts)
        with main_path() as l8:
            st8, ens = simulate_ensemble(cfg, params,
                                         batch_chain_state(s0, 8), w,
                                         opts=opts)
        mode = "zskip" if sampler == "zsorted" else "dense"
        check(l1[mode] > 0 and l1[mode] == l8[mode],
              f"N={n}: launches {l1} and {l8}")
        c0 = ens.chains[0]
        for f in ("r_final", "energy_trace_full", "accept_trace",
                  "pressure_trace", "density", "mobility", "l2", "l3"):
            check(np.array_equal(getattr(one, f), getattr(c0, f)),
                  f"N={n} {sampler}: one chain's {f} is not chain 0's of 8")
        check(torch.equal(st1.r[0], st8.r[0]), f"N={n}: final state")
        print(f"  simulate, one chain N={n} ({sampler}, {params.eqsteps} + "
              f"{params.maxsteps} sweeps): bitwise chain 0 of 8 chains "
              f"(positions, E/P/acceptance traces, voxel counts, CNA); "
              f"{one.sweeps_per_second:,.1f} sweeps/s for one chain, "
              f"{ens.sweeps_per_second:,.1f} chain-sweeps/s for 8 ({card})",
              flush=True)
        for k, v in l1.items():
            total[k] = total.get(k, 0) + v
    return total


def run_quiet(argv):
    """cli.main(argv) as a main-path run, its output kept and not shown.
    Returns (output, launch counts)."""
    from tpu_smc_torch import cli

    buf = io.StringIO()
    with main_path() as launches, contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"cli.main{argv} returned {rc}: {buf.getvalue()[-400:]}")
    return buf.getvalue(), launches


def one_run_dir(root: Path) -> Path:
    dirs = sorted((root / "Data").iterdir())
    check(len(dirs) == 1, f"run dirs {dirs}")
    return dirs[0]


def resume_drill(label: str, common: list, card: str):
    """scripts/resume_drill.py's protocol in this process: A uninterrupted;
    B with --auto-checkpoint 1, SIGTERM raised once its first checkpoint
    has landed (it finishes the window, checkpoints and stops); C resumes
    B's checkpoint with the remaining steps into B's directory. last_state
    and local byte-identical to A's; C's (E, P) data rows and positions
    rows A's tail. Then D, A again with the engine raising a retryable
    launch error once mid-run: one [elastic] retry and every CSV byte-
    identical to A's. Returns the launch counts of the four runs."""
    import signal

    from tpu_smc_torch import driver_ensemble as de
    from tpu_smc_torch import io as smcio
    from tpu_smc_torch.kernels.sweep import KernelLaunchError

    eq, mx, num = (int(v) for v in common[:3])
    lapse = mx // num
    counts = {}

    def add(launches):
        for k, v in launches.items():
            counts[k] = counts.get(k, 0) + v

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        wd = Path(tmp)
        add(run_quiet(common + ["--data-dir", str(wd / "A" / "Data")])[1])
        save, fired = smcio.save_checkpoint, []

        def save_then_sigterm(*args, **kw):
            path = save(*args, **kw)
            if not fired:
                fired.append(path)
                signal.raise_signal(signal.SIGTERM)
            return path

        ck = wd / "ckB.npz"
        with patched(smcio, save_checkpoint=save_then_sigterm):
            out, lb = run_quiet(common + [
                "--data-dir", str(wd / "B" / "Data"), "--auto-checkpoint",
                "1", "--checkpoint", str(ck)])
        add(lb)
        check("[signal" in out and f"Checkpoint written to {ck}" in out,
              f"{label}: run B did not stop on SIGTERM")
        with np.load(ck) as data:
            sweeps = int(data["sweeps"].reshape(-1)[0])
        done = (sweeps - eq) // lapse
        check(0 < done < num, f"{label}: B stopped after {done} gathers")
        out, lc = run_quiet([
            "0", str(mx - done * lapse), str(num - done)] + common[3:]
            + ["--resume", str(ck), "--data-dir", str(wd / "B" / "Data")])
        add(lc)
        check("Resumed full" in out, f"{label}: run C did not resume")
        da, db = one_run_dir(wd / "A"), one_run_dir(wd / "B")
        for pat in ("last_state_*.csv", "local_N*_rank*.csv"):
            fa, fb = sorted(da.glob(pat)), sorted(db.glob(pat))
            check(fa and [f.name for f in fa] == [f.name for f in fb]
                  and all(a.read_bytes() == b.read_bytes()
                          for a, b in zip(fa, fb)),
                  f"{label}: {pat} not byte-identical after the resume")
        for pat, cols in (("data_N*_rank*.csv", 2),
                          ("positions_*_rank*.csv", None)):
            fa, fb = sorted(da.glob(pat)), sorted(db.glob(pat))
            check(fa and len(fa) == len(fb), f"{label}: {pat} files")
            for a, b in zip(fa, fb):
                ra = [",".join(ln.split(",")[:cols])
                      for ln in a.read_text().splitlines()]
                rb = [",".join(ln.split(",")[:cols])
                      for ln in b.read_text().splitlines()]
                check(ra[0] == rb[0] and ra[-(len(rb) - 1):] == rb[1:],
                      f"{label}: {b.name} is not the tail of A's")
        # the fault hits the second gather of window 1 (sweeps of the
        # chain before it: eq + lapse * (storage_time + 1))
        st = int(common[common.index("--storage-time") + 1])
        at, advance, fired = eq + lapse * (st + 1), de._advance, []

        def fault_once(state, *args, **kw):
            if not fired and int(state.sweeps[0]) == at:
                fired.append(at)
                raise KernelLaunchError("smc_sweep_launch (injected)", 2)
            return advance(state, *args, **kw)

        with patched(de, _advance=fault_once):
            out, ld = run_quiet(common + ["--data-dir",
                                          str(wd / "D" / "Data")])
        add(ld)
        check(fired and out.count("[elastic] device fault") == 1,
              f"{label}: run D reported {out.count('[elastic]')} retries")
        dd = one_run_dir(wd / "D")
        names = sorted(p.name for p in da.iterdir())
        check(names == sorted(p.name for p in dd.iterdir())
              and all((da / f).read_bytes() == (dd / f).read_bytes()
                      for f in names),
              f"{label}: the replayed run's CSVs differ from A's")
    print(f"  resume drill {label}: B stopped after {done} of {num} gathers "
          f"on SIGTERM, C resumed: last_state and local byte-identical, "
          f"data (E, P) and positions A's tail; D, one injected launch "
          f"error replayed: all {len(names)} CSVs byte-identical to A's; "
          f"{time.perf_counter() - t0:.1f} s, launches {counts} ({card})",
          flush=True)
    return counts


# ----------------------------------------------------------------------
# Phase 3, ensemble family: GCMC, NPT and Gibbs on the plain engine
# ----------------------------------------------------------------------

# MU of the slab GCMC run: T ln(N0 / V) + mu_ex at N0 = 108, T = 1.1, V =
# 33 x 33 x 200, with mu_ex = -0.0066 interpolated between the per-level
# Widom values that the measurement ladder below prints at T = 1.0 and
# 1.2 (-0.00819, -0.00503), so that <N> lands near N0
GCMC_MU = round(1.1 * math.log(108 / (33.0 * 33.0 * 200.0)) - 0.0066, 4)
# sweeps of the ensemble-family runs (eq, max)
ENS_DEPTH = {"gcmc": (100, 100), "gcmc_split": 150, "loop_nvt": (100, 150),
             "loop_gcmc": (100, 200), "isotherm": (60, 200),
             "isobars": (100, 200), "npt": (50, 100),
             "loop_npt_nvt": (150, 300), "loop_npt": (250, 500),
             "gibbs": (600, 250), "gibbs_temps": (50, 100)}


def ens_run(argv, module, name: str, label: str, card: str):
    """One ensemble-family CLI run as a main-path run (kernel launches
    counted, plain versions barred): (output, run dir, the driver's
    (state, results), launches). Prints chain-sweeps/s and the wall-time
    split around the driver."""
    with captured(module, name) as seen:
        out, launches, dt, sim = run_main(argv)
    state, res = seen["out"]
    check("Ensemble sweep engine: torch (plain engine, CUDA graphs)" in out,
          f"{label}: no plain-engine line")
    check(not any(launches.values()),
          f"{label}: kernel launches {launches} (the ensemble family runs "
          "on the plain engine)")
    print(f"  {label}: {dt:.1f} s = {seen['t0'] - sim['start']:.3f} before "
          f"the driver + {seen['t1'] - seen['t0']:.3f} driver + "
          f"{sim['start'] + dt - seen['t1']:.3f} after (CSVs); "
          f"{res.sweeps_per_second:,.1f} chain-sweeps/s in production "
          f"({card})", flush=True)
    return out, launches, state, res


def csv_head(d: Path, stem: str, cfg, lines: int = 1):
    """The first lines of the run's CSV `stem` (tpu_smc's name, with or
    without its rank0 suffix)."""
    paths = list(d.glob(f"{stem}_{cfg.file_key()}*.csv"))
    check(len(paths) == 1, f"no single {stem}_{cfg.file_key()} CSV")
    return paths[0].read_text().splitlines()[:lines]


def drive_gcmc(card: str):
    """The slab GCMC at the reference geometry, full width (N0 = 108,
    cap 216, 512 chains, --z-bins 32): N <= cap in every trace, tracked
    against exact energy within 1e-4 relative at every resync, the three
    acceptances in (0, 1], T ln<rho> + mu_ex(in run) within 0.1 of MU,
    tpu_smc's CSV names and headers; then 100 + 50 sweeps, a checkpoint
    and the rest: final r and active bitwise the unbroken run's."""
    from tpu_smc_torch import gcmc as tg
    from tpu_smc_torch.config import SMCConfig

    eq, mx = ENS_DEPTH["gcmc"]
    common = ["1.1", "--gcmc", str(GCMC_MU), "--chains", "512",
              "--seed", "2024"]
    cfg = SMCConfig.for_n(108)
    with tempfile.TemporaryDirectory() as tmp:
        out, _, st, res = ens_run(
            [str(eq), str(mx), "3", *common, "--z-bins", "32",
             "--data-dir", tmp], tg, "simulate_gcmc",
            f"GCMC slab N0=108 cap 216 x 512, {eq} + {mx}", card)
        d = Path(tmp) / cfg.run_name()
        head = csv_head(d, "gcmc", cfg, 2)
        zhead = csv_head(d, "gcmc_zprofile", cfg)
        k = ENS_DEPTH["gcmc_split"] - eq
        ck = str(Path(tmp) / "ck.npz")
        ens_run([str(eq), str(k), "3", *common, "--checkpoint", ck,
                 "--data-dir", tmp], tg, "simulate_gcmc",
                f"GCMC slab, first {eq + k} sweeps", card)
        _, _, st2, _ = ens_run(
            ["0", str(mx - k), "3", *common, "--resume", ck, "--data-dir",
             tmp], tg, "simulate_gcmc",
            f"GCMC slab, resumed for {mx - k}", card)
    cap = 216
    rho = res.mean_density
    mu_back = 1.1 * math.log(rho) + res.mu_ex
    accs = (res.disp_acceptance, res.insert_acceptance,
            res.delete_acceptance)
    print(f"  GCMC slab: <N> {res.mean_n:.3f} ± {res.err_n:.3f} (N0 108), "
          f"N in [{res.n_trace.min()}, {res.n_trace.max()}], acceptance "
          f"displace/insert/delete {accs[0]:.4f} / {accs[1]:.4f} / "
          f"{accs[2]:.4f}, in-run mu_ex {res.mu_ex:.5f}, T ln<rho> + mu_ex "
          f"{mu_back:.5f} against MU {GCMC_MU}, resync drift "
          f"{res.resync_drift:.3g}", flush=True)
    check(res.n_trace.max() <= cap and res.n_trace.min() >= 0,
          f"GCMC N outside [0, {cap}]")
    check(not res.resync_drift > 1e-4, f"GCMC tracked vs exact energy "
          f"{res.resync_drift:.3g} > 1e-4")
    check(all(0 < a <= 1 for a in accs), f"GCMC acceptances {accs}")
    check(head[0].startswith("# mu, ") and head[1] == "sweep, N_mean, E_mean"
          and zhead == ["z, density"], f"GCMC CSV headers {head}, {zhead}")
    check_later(abs(mu_back - GCMC_MU) < 0.1, f"GCMC in-run identity "
                f"{mu_back:.4f} against MU {GCMC_MU}")
    check(torch.equal(st.r, st2.r) and torch.equal(st.active, st2.active),
          "GCMC resume: final r / active differ from the unbroken run")
    print("  GCMC resume: final r and active bitwise the unbroken run's",
          flush=True)


def drive_gcmc_loop(card: str):
    """Widom -> GCMC closed loop at tests/test_gcmc.py:97-136's state
    point (bulk, T = 2, rho = 0.15, N = 32, cap 64), 512 chains each: the
    port's NVT Widom on the plain engine measures mu = T ln rho + mu_ex,
    GCMC at that mu brings the density back (that test's tolerance), and
    its in-run identity closes within 0.1."""
    from tpu_smc_torch import gcmc as tg
    from tpu_smc_torch.config import RunParams, SMCConfig
    from tpu_smc_torch.driver import ObservableOptions
    from tpu_smc_torch.driver_ensemble import simulate_ensemble
    from tpu_smc_torch.state import init_ensemble_state, seed_words
    from tpu_smc_torch.widom import mu_ex

    t, rho = 2.0, 0.15
    cfg = SMCConfig.bulk(n=32, temperature=t, rho=rho)
    eq, mx = ENS_DEPTH["loop_nvt"]
    t0 = time.perf_counter()
    with main_path() as launches:
        st, w = init_ensemble_state(cfg, seed_words(5), 512)
        st, nvt = simulate_ensemble(
            cfg, RunParams(eq, mx, mx // 5), st, w,
            opts=ObservableOptions(collect_sweep_trace=False, widom_k=64,
                                   proposal_a=0.1, stream_seed=5),
            max_fault_retries=0)
        muex, muerr = mu_ex(nvt.widom_du, t)
        mu = t * math.log(rho) + muex
        eg, mg = ENS_DEPTH["loop_gcmc"]
        _, res = tg.simulate_gcmc(cfg, mu, 64, eg, mg, seed_words(6),
                                  n_chains=512, seed=6)
    check(not any(launches.values()), f"Widom/GCMC loop launches {launches}")
    v = tg.box_volume(cfg)
    dn = res.n_trace.var() / t * muerr
    tol = 4 * res.err_n + dn + 0.06 * rho * v
    mu_back = t * math.log(res.mean_density) + res.mu_ex
    print(f"  Widom -> GCMC loop N=32 bulk T=2 rho=0.15, 512 chains: NVT "
          f"{eq} + {mx} (plain engine) mu_ex {muex:.5f} ± {muerr:.5f}, mu "
          f"{mu:.5f}; GCMC {eg} + {mg}: <N> {res.mean_n:.3f} ± "
          f"{res.err_n:.3f} against rho V {rho * v:.3f} (tolerance "
          f"{tol:.3f}), mu_back {mu_back:.5f} (|dmu| "
          f"{abs(mu_back - mu):.4f}); {time.perf_counter() - t0:.1f} s, "
          f"GCMC {res.sweeps_per_second:,.1f} chain-sweeps/s ({card})",
          flush=True)
    check_later(abs(res.mean_n - rho * v) < tol,
                f"Widom -> GCMC: <N> {res.mean_n:.3f} vs {rho * v:.3f}")
    check_later(abs(mu_back - mu) < 0.1,
                f"Widom -> GCMC: mu_back {mu_back:.4f} vs mu {mu:.4f}")


def drive_isotherm(card: str):
    """`--gcmc-grid=-9.5:-7:8 --bulk --n 32 --chains 512` at T = 2.0 (4096
    chains): <N>(mu) strictly rising (tests/test_gcmc.py:154-178)."""
    from tpu_smc_torch import gcmc as tg
    from tpu_smc_torch.config import SMCConfig

    eq, mx = ENS_DEPTH["isotherm"]
    with tempfile.TemporaryDirectory() as tmp:
        out, _, _, res = ens_run(
            [str(eq), str(mx), "40", "2.0", "--gcmc-grid=-9.5:-7:8",
             "--bulk", "--n", "32", "--chains", "512", "--seed", "6",
             "--data-dir", tmp], tg, "simulate_gcmc",
            f"GCMC isotherm N=32 bulk, 8 mu x 512, {eq} + {mx}", card)
        cfg = SMCConfig.bulk(n=32, temperature=2.0)
        head, rows = read_csv(Path(tmp) / cfg.run_name()
                              / f"gcmc_isotherm_{cfg.file_key()}.csv")
    print(f"  isotherm <N>(mu): {np.round(rows[:, 1], 3).tolist()}",
          flush=True)
    check(head == "mu, N_mean, N_err, density" and rows.shape == (8, 4),
          f"isotherm CSV {head}, {rows.shape}")
    check_later(bool(np.all(np.diff(rows[:, 1]) > 0)),
                f"isotherm not strictly rising: {rows[:, 1]}")


def drive_npt(card: str):
    """NPT isobars at full width (`--npt-grid 0.3:2.5:8 --npt-reweight
    0.3:2.5:33 --n 108 --rho 0.3 --gamma 0.02 --lj-cutoff 1.8 --chains
    512`, T = 2.0; 4096 chains): rho(P) strictly rising, the MBAR curve
    finite and monotone, the volume floor never crossed; the single
    pressure `--npt 0.7` with its CSVs; then the NVT -> NPT closed loop
    (tests/test_npt.py:376-406) at N = 32 with 512 chains: the NVT virial
    pressure P_vir at rho0 = 0.3, NPT at P_vir + T/V0 gives <rho> = 0.300
    ± 0.02."""
    from tpu_smc_torch import ensemble as en
    from tpu_smc_torch import npt as tn
    from tpu_smc_torch.config import SMCConfig
    from tpu_smc_torch.potentials import pair_virial_pressure
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    eq, mx = ENS_DEPTH["isobars"]
    kw = dict(n=108, temperature=2.0, rho=0.3, gamma=0.02, lj_cutoff=1.8,
              lj_shift=True)
    cfg = SMCConfig.bulk(**kw)
    with tempfile.TemporaryDirectory() as tmp:
        out, _, _, res = ens_run(
            [str(eq), str(mx), "50", "2.0", "--npt-grid", "0.3:2.5:8",
             "--npt-reweight", "0.3:2.5:33", "--n", "108", "--rho", "0.3",
             "--gamma", "0.02", "--lj-cutoff", "1.8", "--chains", "512",
             "--seed", "9", "--data-dir", tmp], tn, "simulate_npt",
            f"NPT isobars N=108, 8 P x 512, {eq} + {mx}", card)
        d = Path(tmp) / cfg.run_name()
        hi, iso = read_csv(d / f"npt_isobar_{cfg.file_key()}.csv")
        hr, rw = read_csv(d / f"npt_reweight_{cfg.file_key()}.csv")
        e1, m1 = ENS_DEPTH["npt"]
        _, _, _, r1 = ens_run(
            [str(e1), str(m1), "10", "2.0", "--npt", "0.7", "--n", "108",
             "--rho", "0.3", "--gamma", "0.02", "--lj-cutoff", "1.8",
             "--chains", "512", "--seed", "9", "--gr-bins", "32",
             "--data-dir", tmp], tn, "simulate_npt",
            f"NPT P=0.7 N=108 x 512, {e1} + {m1}", card)
        h1 = csv_head(d, "npt", cfg, 2) + csv_head(d, "npt_gr", cfg)
    floor = (2.0 * cfg.lj_cutoff) ** 3
    vmin = res.volume_trace.min()
    print(f"  isobars rho(P): {np.round(iso[:, 1], 5).tolist()}; MBAR rho "
          f"on 33 points {rw[0, 1]:.5f} .. {rw[-1, 1]:.5f}, ess "
          f"{rw[:, 5].min():.0f} .. {rw[:, 5].max():.0f}; smallest V "
          f"{vmin:.4f} (floor {floor:.4f}); resync drift "
          f"{res.resync_drift:.3g}; P=0.7: rho {r1.mean_density:.5f} ± "
          f"{r1.err_density:.5f}, acceptance {r1.disp_acceptance:.4f} / "
          f"{r1.vol_acceptance:.4f}", flush=True)
    check(hi == "P, rho_mean, rho_err, V_mean, kappa_T"
          and hr == "P, rho, V_mean, kappa_T, H_conf, ess"
          and iso.shape == (8, 5) and rw.shape == (33, 6),
          f"NPT CSVs {hi}, {hr}")
    check(h1[1] == "sweep, V_mean, rho_mean, E_mean" and h1[2] == "r, g",
          f"NPT CSV headers {h1}")
    check(vmin >= floor * (1 - 1e-6) and r1.volume_trace.min() >= floor
          * (1 - 1e-6), f"NPT volume {vmin} below the floor {floor}")
    check(np.isfinite(rw).all(), "NPT MBAR curve not finite")
    check(not res.resync_drift > 1e-4, f"NPT resync drift "
          f"{res.resync_drift}")
    check_later(bool(np.all(np.diff(iso[:, 1]) > 0)),
                f"isobars not strictly rising: {iso[:, 1]}")
    check_later(bool(np.all(np.diff(rw[:, 1]) > 0)),
                f"MBAR rho(P) not monotone: {rw[:, 1]}")

    # the NVT -> NPT closed loop
    t, rho0 = 2.0, 0.3
    cfg32 = SMCConfig.bulk(**{**kw, "n": 32})
    ne, nm = ENS_DEPTH["loop_npt_nvt"]
    t0 = time.perf_counter()
    with main_path() as launches:
        st, w = init_ensemble_state(cfg32, seed_words(0), 512)
        st, _ = en.ensemble_sweeps(st, w, cfg32, 2 * cfg32.proposal_a, ne,
                                   stream_seed=0)
        ps = []
        for _ in range(nm // 15):
            st, _ = en.ensemble_sweeps(st, w, cfg32, cfg32.proposal_a, 15,
                                       stream_seed=0)
            ps.append(pair_virial_pressure(st.r, cfg32).double().cpu())
        chain_p = rho0 * t + torch.stack(ps).mean(0).numpy()
        p_vir = float(chain_p.mean())
        p_err = float(chain_p.std() / math.sqrt(len(chain_p) - 1))
        v0 = cfg32.n / rho0
        pe, pm = ENS_DEPTH["loop_npt"]
        _, loop = tn.simulate_npt(cfg32, p_vir + t / v0, pe, pm,
                                  seed_words(1), n_chains=512, dlnv=0.1,
                                  seed=1)
    check(not any(launches.values()), f"NVT -> NPT launches {launches}")
    print(f"  NVT -> NPT loop N=32, 512 chains: NVT {ne} + {nm} (plain "
          f"engine) P_vir {p_vir:.5f} ± {p_err:.5f}; NPT at P_vir + T/V0 "
          f"{pe} + {pm}: <rho> {loop.mean_density:.5f} ± "
          f"{loop.err_density:.5f} (rho0 0.3); {time.perf_counter() - t0:.1f}"
          f" s, NPT {loop.sweeps_per_second:,.1f} chain-sweeps/s ({card})",
          flush=True)
    check_later(abs(loop.mean_density - rho0) < 0.02,
                f"NVT -> NPT: <rho> {loop.mean_density:.4f} vs 0.3")


def drive_gibbs(card: str):
    """Gibbs at tests/test_gibbs.py:232-253's state point (`--gibbs --n 96
    --rho 0.3 --lj-cutoff 1.8 --gibbs-transfers 24 --npt-dlnv 0.08` at T
    = 0.75, 256 chains): N1 + N2 = N at every sweep, V1 + V2 conserved
    to round-off, and that test's bifurcation gates; then the
    coexistence curve `--gibbs-temps 0.7,2.0` (N = 48, 2 x 64 chains)."""
    from tpu_smc_torch import gibbs as tgb
    from tpu_smc_torch.config import SMCConfig

    eq, mx = ENS_DEPTH["gibbs"]
    with tempfile.TemporaryDirectory() as tmp:
        out, _, st, res = ens_run(
            [str(eq), str(mx), "50", "0.75", "--gibbs", "--n", "96", "--rho",
             "0.3", "--lj-cutoff", "1.8", "--gibbs-transfers", "24",
             "--npt-dlnv", "0.08", "--gamma", "0.02", "--chains", "256",
             "--seed", "7", "--data-dir", tmp], tgb, "simulate_gibbs",
            f"Gibbs N=96 T=0.75 x 256, {eq} + {mx}", card)
        cfg = SMCConfig.bulk(n=96, temperature=0.75, rho=0.6, gamma=0.02,
                             lj_cutoff=1.8, lj_shift=True)
        head = csv_head(Path(tmp) / cfg.run_name(), "gibbs", cfg, 2)
        e2, m2 = ENS_DEPTH["gibbs_temps"]
        _, _, bst, bres = ens_run(
            [str(e2), str(m2), "10", "1.0", "--gibbs", "--gibbs-temps",
             "0.7,2.0", "--n", "48", "--rho", "0.3", "--gamma", "0.02",
             "--chains", "64", "--seed", "15", "--data-dir", tmp], tgb,
            "simulate_gibbs", f"Gibbs curve N=48, 2 T x 64, {e2} + {m2}",
            card)
        bcfg = SMCConfig.bulk(n=48, temperature=1.0, rho=0.6, gamma=0.02,
                              lj_cutoff=min(2.5, 0.45 * (48 / 0.6) ** (1 / 3)),
                              lj_shift=True)
        hb, brows = read_csv(Path(tmp) / bcfg.run_name()
                             / f"gibbs_binodal_{bcfg.file_key()}.csv")
    vtot = 2.0 * cfg.box_l ** 3
    vdev = float(np.abs((st.l.double() ** 3).sum(-1).cpu().numpy() - vtot)
                 .max() / vtot)
    dmu = abs(res.mu_box[0] - res.mu_box[1])
    print(f"  Gibbs: rho_lo {res.rho_lo:.5f} ± {res.err_lo:.5f}, rho_hi "
          f"{res.rho_hi:.5f} ± {res.err_hi:.5f}, mu_box "
          f"{np.round(res.mu_box, 4).tolist()} (|dmu| {dmu:.4f}), "
          f"acceptance {res.disp_acceptance:.4f} / {res.vol_acceptance:.4f}"
          f" / {res.transfer_acceptance:.4f}; N1 + N2 = 96 at every sweep: "
          f"{res.n_conserved}; |V1 + V2 - Vtot| / Vtot {vdev:.3g}; "
          f"curve rows {brows.tolist()}", flush=True)
    check(res.n_conserved and bres.n_conserved, "Gibbs: N1 + N2 != N")
    check(vdev < 1e-5, f"Gibbs: V1 + V2 off by {vdev:.3g}")
    check(head[0].startswith("# rho_lo, ") and head[1] ==
          "sweep, N1_mean, V1_mean, rho_lo_mean, rho_hi_mean"
          and hb == "T, rho_v, err_v, rho_l, err_l, dmu, two_phase"
          and brows.shape == (2, 7), f"Gibbs CSVs {head}, {hb}")
    check(not res.resync_drift > 1e-4, f"Gibbs resync drift "
          f"{res.resync_drift}")
    check_later(res.rho_hi > 3.0 * res.rho_lo and res.rho_hi > 0.45
                and res.rho_lo < 0.15 and dmu < 0.4,
                f"Gibbs bifurcation: rho {res.rho_lo:.4f} / "
                f"{res.rho_hi:.4f}, |dmu| {dmu:.4f}")


def phase_ensemble_family(card: str):
    """Phase 3's ensemble family: every run on the plain engine's CUDA
    graphs, no kernel launched."""
    for drive in (drive_gcmc, drive_gcmc_loop, drive_isotherm, drive_npt,
                  drive_gibbs):
        t0 = time.perf_counter()
        drive(card)
        print(f"  ({drive.__name__}: {time.perf_counter() - t0:.1f} s)",
              flush=True)


# ----------------------------------------------------------------------
# Phase 3, multi-process and sharded: the main path split over two
# processes on the one card, one ladder across them, per-process
# ladders, and the chain- and particle-sharded calls in one process
# ----------------------------------------------------------------------

# A child rank: cli.main as `python -m tpu_smc_torch` runs it, the kernels'
# plain versions made to fail if called, its launch counts and wall
# seconds printed on its last line. A first argument --cards=0,0 gives
# the rank those cards, as cli._host_cards gives a rank its share of a
# host with more cards than ranks.
CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from tpu_smc_torch import cli
from tpu_smc_torch.kernels import banded as kb, sweep as ks
def refuse(*args, **kw):
    raise RuntimeError("a plain version ran on the main path")
ks.sweep_block_plain = ks.sweep_block_stream_plain = refuse
kb.banded_sweep_plain = refuse
argv = sys.argv[2:]
if argv[0].startswith("--cards="):
    cards = [int(c) for c in argv.pop(0)[len("--cards="):].split(",")]
    cli._host_cards = lambda rank, hosts, n_cards: cards
t0 = time.perf_counter()
rc = cli.main(argv)
print("CHILD " + json.dumps({"rc": rc, "s": time.perf_counter() - t0,
                             "launches": ks.sweep_block.launches}),
      flush=True)
sys.exit(rc)
"""
CHILD_TIMEOUT = 300


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv, label: str, tmp: Path, nproc: int = 2,
              cards: str = "") -> list:
    """`argv` as nproc ranks of one --coordinator job, children on the
    card, each within CHILD_TIMEOUT s (cards: each rank's cards, e.g.
    "0,0", in place of its share of the host's); any failure kills every
    child and fails. Returns [(output, child record)] per rank, the
    record with the process's wall seconds from its start (torch import
    and CUDA start included) as "s_proc" beside cli.main's "s"."""
    port = free_port()
    procs, logs, ends = [], [], {}
    t0 = time.perf_counter()
    try:
        for rank in range(nproc):
            log = open(tmp / f"{label}.rank{rank}.log", "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CHILD, str(ROOT),
                 *([f"--cards={cards}"] if cards else []), *argv,
                 "--coordinator", f"127.0.0.1:{port}", "--num-processes",
                 str(nproc), "--process-id", str(rank)],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, text=True))
        deadline = time.perf_counter() + CHILD_TIMEOUT
        while len(ends) < nproc:
            for rank, p in enumerate(procs):
                if rank not in ends and p.poll() is not None:
                    ends[rank] = time.perf_counter() - t0
            if any(procs[r].returncode for r in ends):
                break           # a failed rank: the others are killed
            if time.perf_counter() > deadline:
                raise subprocess.TimeoutExpired(argv, CHILD_TIMEOUT)
            time.sleep(0.05)
    except subprocess.TimeoutExpired:
        raise Failure(f"{label}: a rank ran past {CHILD_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        rec = [ln for ln in text.splitlines() if ln.startswith("CHILD ")]
        check(p.returncode == 0 and rec,
              f"{label}: rank {rank} exited {p.returncode}: {text[-2000:]}")
        out.append((text, dict(json.loads(rec[-1][6:]),
                               s_proc=ends.get(rank, float("nan")))))
    return out


def add_counts(total: dict, *runs) -> dict:
    """Launch counts summed over runs (dicts, or child records)."""
    for r in runs:
        for k, v in (r.get("launches", r)).items():
            total[k] = total.get(k, 0) + v
    return total


def drive_split_main(tmp: Path, card: str) -> dict:
    """(a) phase 3's N = 1024 x 512 run split over two processes, each N =
    1024 x 256 on K2: every per-rank CSV, data_ensemble, last_state and
    the wall CSV byte-identical to phase 3's single-process run, the
    printed mean E and acceptance its recorded ones; both wall times and
    the aggregate chain-sweeps/s beside the single process's."""
    from tpu_smc_torch.config import SMCConfig

    one = RUNS[1024]
    data = tmp / "split"
    ranks = run_ranks(one["argv"] + ["--data-dir", str(data)], "split", tmp)
    cfg = SMCConfig.for_n(1024)
    two = data / cfg.run_name()
    key = cfg.file_key()
    names = [f"{s}_{key}_rank{r}.csv" for s in STEMS_RANK
             for r in range(512)]
    names += [f"{s}_{key}.csv" for s in ("wall", "data_ensemble",
                                         "last_state")]
    diff = [nm for nm in names
            if (one["dir"] / nm).read_bytes() != (two / nm).read_bytes()]
    check(not diff, f"(a) split run differs from one process in "
          f"{len(diff)} files: {diff[:4]}")
    for rank, (text, rec) in enumerate(ranks):
        got = (summary_value(text, "Mean energy:"),
               summary_value(text, "Average acceptance ratio:"))
        check(got == MAIN_1024, f"(a) rank {rank} printed {got}, one "
              f"process {MAIN_1024}")
        lc = rec["launches"]
        check(lc["zskip"] > 0 and lc["dense"] == lc["stream"] == 0,
              f"(a) rank {rank} launches {lc}")
    walls = [rec["s"] for _, rec in ranks]
    procs = [rec["s_proc"] for _, rec in ranks]
    argv = one["argv"]
    sweeps = (int(argv[0]) + int(argv[1])) * 512
    print(f"  (a) N=1024 x 512 over 2 processes (2 x 256 chains, K2): "
          f"{len(names)} CSVs byte-identical to one process, mean E / "
          f"acceptance {MAIN_1024}; wall s per rank {walls[0]:.2f} / "
          f"{walls[1]:.2f} in cli.main, {procs[0]:.2f} / {procs[1]:.2f} "
          f"from the process's start, against {one['s']:.2f} s of cli.main "
          f"in one process; aggregate {sweeps / max(walls):,.0f} chain-"
          f"sweeps/s over cli.main ({sweeps / max(procs):,.0f} over the "
          f"processes) against {sweeps / one['s']:,.0f} ({card})",
          flush=True)
    return add_counts({}, *[rec for _, rec in ranks])


GLOBAL_LADDER = ["32", "96", "3", "1.1", "--n", "1024", "--temperatures",
                 "0.9,1.1,1.3,1.6", "--chains-per-t", "32", "--pt-exchange",
                 "auto", "--reweight", "0.9:1.6:8", "--z-bins", "16",
                 "--seed", "2024"]


def drive_global_ladder(tmp: Path, card: str) -> dict:
    """(b) one PT ladder across two processes (K1-at with z-skip; every
    exchange gathers the configurations across the process boundary):
    tsweep, pt, reweight and reweight_zprofile byte-identical to the same
    command in one process, both ranks and the one process choosing the
    same auto interval, the gathered checkpoint equal to the single-
    process one."""
    from tpu_smc_torch.config import SMCConfig

    t0 = time.perf_counter()
    out1, l1, dt1, _ = run_main(GLOBAL_LADDER + [
        "--data-dir", str(tmp / "gl1"), "--checkpoint", str(tmp / "gl1.npz")])
    RUNS["gl1_s"] = dt1
    ranks = run_ranks(GLOBAL_LADDER + [
        "--global-ladder", "--data-dir", str(tmp / "gl2"), "--checkpoint",
        str(tmp / "gl2.npz")], "global_ladder", tmp)
    cfg = SMCConfig.for_n(1024)
    d1, d2 = (tmp / g / cfg.run_name() for g in ("gl1", "gl2"))
    for stem in ("tsweep", "pt", "reweight", "reweight_zprofile"):
        nm = f"{stem}_{cfg.file_key()}.csv"
        check((d1 / nm).read_bytes() == (d2 / nm).read_bytes(),
              f"(b) {nm} differs from one process")
    iv = [re.search(r"Auto-chosen exchange interval: (\d+)", t)
          for t in [out1] + [t for t, _ in ranks]]
    check(all(iv) and len({m.group(1) for m in iv}) == 1,
          f"(b) auto intervals {[m and m.group(1) for m in iv]}")
    with np.load(tmp / "gl1.npz") as a, np.load(tmp / "gl2.npz") as b:
        bad = [k for k in a.files if not np.array_equal(a[k], b[k])]
        check(sorted(a.files) == sorted(b.files) and not bad,
              f"(b) gathered checkpoint differs in {bad}")
    lc = add_counts({}, *[rec for _, rec in ranks])
    for name, c in (("one process", l1), ("two processes", lc)):
        check(c["zskip"] > 0 and c["per_chain_at"] == c["zskip"] + c["dense"],
              f"(b) {name} launches {c}: per-chain (A, T), z-skip")
    print(f"  (b) global ladder N=1024, 4 x 32, PT auto (interval "
          f"{iv[0].group(1)}), MBAR: tsweep/pt/reweight/reweight_zprofile "
          f"and the checkpoint byte-identical across 2 processes; one "
          f"process {dt1:.1f} s, ranks {ranks[0][1]['s']:.1f} / "
          f"{ranks[1][1]['s']:.1f} s; {time.perf_counter() - t0:.1f} s in "
          f"all ({card})", flush=True)
    return add_counts(lc, l1)


PER_PROCESS_LADDER = ["200", "600", "6", "1.1", "--n", "108",
                      "--temperatures", "1.0,1.2,1.4", "--chains-per-t",
                      "64", "--pt-exchange", "5", "--seed", "2024"]


def drive_per_process_ladders(tmp: Path, card: str) -> dict:
    """(c) complete PT ladders per process (N = 108, 3 x 64, K1-at),
    pooled, against one process: pooled swap attempts equal exactly,
    each level's E within 6 combined SE + 0.3 (tests/test_distributed.py's
    criterion)."""
    from tpu_smc_torch.config import SMCConfig

    _, l1, dt1, _ = run_main(PER_PROCESS_LADDER + ["--data-dir",
                                                   str(tmp / "pl1")])
    ranks = run_ranks(PER_PROCESS_LADDER + ["--data-dir", str(tmp / "pl2")],
                      "per_process_ladders", tmp)
    cfg = SMCConfig.for_n(108)
    tab = {g: {s: read_csv(tmp / g / cfg.run_name()
                           / f"{s}_{cfg.file_key()}.csv")[1]
               for s in ("tsweep", "pt")} for g in ("pl1", "pl2")}
    s, m = tab["pl1"]["tsweep"], tab["pl2"]["tsweep"]
    att1, att2 = tab["pl1"]["pt"][:, 3], tab["pl2"]["pt"][:, 3]
    check(np.array_equal(att1, att2), f"(c) pooled attempts {att2}, one "
          f"process {att1}")
    z = np.abs(s[:, 1] - m[:, 1]) - (6 * np.hypot(s[:, 2], m[:, 2]) + 0.3)
    check(bool((z < 0).all()), f"(c) per-level E {m[:, 1]} against "
          f"{s[:, 1]} (SE {m[:, 2]}, {s[:, 2]})")
    lc = add_counts({}, *[rec for _, rec in ranks])
    check(lc["dense"] > 0 and lc["per_chain_at"] == lc["dense"],
          f"(c) launches {lc}: dense, per-chain (A, T)")
    print(f"  (c) per-process ladders N=108, 3 x 64 over 2 processes "
          f"(2 x 32 replicas each): attempts {att2.astype(int).tolist()} "
          f"as one process; E {np.round(m[:, 1], 4).tolist()} against "
          f"{np.round(s[:, 1], 4).tolist()} (SE "
          f"{np.round(np.hypot(s[:, 2], m[:, 2]), 4).tolist()}); one "
          f"process {dt1:.1f} s, ranks {ranks[0][1]['s']:.1f} / "
          f"{ranks[1][1]['s']:.1f} s ({card})", flush=True)
    return add_counts(lc, l1)


def drive_sharded(device, card: str) -> dict:
    """(d) sharding inside one process on [cuda:0, cuda:0]: the zsorted
    engine at N = 1024 x 512 (K2), the dense one at N = 108 x 512 (K1)
    and the streamed one at N = 4096 x 128 (K3), each bitwise the
    unsharded call; K1 and K2 with chain0 = 256 against their plain
    versions with the same base (phase 2's tolerances); the particle-
    sharded energy of one chain of the density-matched N = 32768 state
    over 4 shards within 1e-5 relative of the full recompute (chain 0
    of the large-N run's final state, 48 sweeps from the lattice, whose
    pairs interact; the lattice's hardly do)."""
    from tpu_smc_torch import ensemble as en
    from tpu_smc_torch.config import SMCConfig
    from tpu_smc_torch.potentials import total_energy
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    mesh = en.make_mesh(devices=[device, device])
    counts = {}
    for label, n, c, sweeps, fn, kw in (
            ("zsorted", 1024, 512, 32, "zsorted", {}),
            ("dense", 108, 512, 32, "dense", {}),
            ("zsorted streamed", 4096, 128, 8, "zsorted",
             {"hbm_stream": True})):
        cfg = SMCConfig.for_n(n)
        state, w = init_ensemble_state(cfg, seed_words(7), c, device=device)
        one_fn = getattr(en, f"ensemble_sweeps_{fn}")
        two_fn = getattr(en, f"ensemble_sweeps_{fn}_sharded")
        with main_path() as lc:
            t0 = time.perf_counter()
            one, s1 = one_fn(state, w, cfg, cfg.proposal_a, sweeps, seed=5,
                             **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            two, s2 = two_fn(state, w, cfg, cfg.proposal_a, sweeps, 5, mesh,
                             **kw)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        check(torch.equal(one.r, two.r) and torch.equal(one.energy, two.energy)
              and torch.equal(s1.energy, s2.energy)
              and torch.equal(s1.accepted, s2.accepted),
              f"(d) {label} N={n} x {c}: two shards differ from one call")
        add_counts(counts, lc)
        print(f"  (d) {label} N={n} x {c}, {sweeps} sweeps over 2 shards: "
              f"bitwise one call; {1e3 * (t1 - t0):.1f} ms one call, "
              f"{1e3 * (t2 - t1):.1f} ms sharded ({card})", flush=True)
    for n, c, zskip in ((108, 64, False), (1024, 128, True)):
        cfg, w, args, ks = kernel_inputs(n, c, device, sort=zskip)
        compare(cfg, w, args, ks, zskip,
                f"(d) {'zskip' if zskip else 'dense'} chain0=256 N={n} "
                f"C={c}", chain0=256)
    r, w, cfg = (RUNS[32768][k] for k in ("r", "w", "cfg"))
    full = float(total_energy(r[None], w, cfg)[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e4 = en.particle_sharded_energy(r, w, cfg, [device] * 4)
    dt = time.perf_counter() - t0
    rel = abs(e4 - full) / abs(full)
    check(rel <= 1e-5, f"(d) particle-sharded energy {e4} against the full "
          f"recompute {full} ({rel:.3g} relative)")
    print(f"  (d) particle-sharded energy N=32768 (density-matched box, "
          f"chain 0 after the large-N run), 4 shards: {e4:.6f} against the "
          f"full recompute {full:.6f} "
          f"({rel:.3g} relative), {dt * 1e3:.1f} ms ({card})", flush=True)
    return counts


def same_results(a, b) -> list:
    """The fields of two results (NamedTuples of arrays, floats and None,
    nested) that differ to the bit, the measured rate aside."""
    bad = []
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "sweeps_per_second":
            continue
        if hasattr(x, "_fields"):
            bad += [f"{f}.{g}" for g in same_results(x, y)]
        elif (x is None) != (y is None) or x is not None and not \
                np.array_equal(np.asarray(x), np.asarray(y), equal_nan=(
                    np.asarray(x).dtype.kind == "f")):
            bad.append(f)
    return bad


def same_states(a, b) -> list:
    """The fields of two chain-state dataclasses that differ."""
    return [f.name for f in dataclasses.fields(a)
            if not torch.equal(getattr(a, f.name), getattr(b, f.name))]


def one_and_sharded(fn):
    """fn(None) (one device) then fn(devices) on [cuda:0, cuda:0], each a
    main-path run timed on the host clock around synchronised calls:
    ((state, results) of each, launch counts of both, ms of each)."""
    dev = torch.device("cuda", 0)
    out, ms = [], []
    with main_path() as lc:
        for devices in (None, [dev, dev]):
            t0 = time.perf_counter()
            out.append(fn(devices))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
    return out, lc, ms


def check_same(out, label: str, ms, card: str, extra: str = "",
               tag: str = "(e)"):
    """(e)'s and (f)'s verdict on one item: results and state bitwise."""
    (s1, r1), (s2, r2) = out
    bad = same_results(r1, r2) + same_states(s1, s2)
    check(not bad, f"{tag} {label}: the sharded run differs in {bad}")
    print(f"  {tag} {label}: bitwise one device{extra}; {ms[0]:.1f} ms one "
          f"device, {ms[1]:.1f} ms sharded over [cuda:0, cuda:0] ({card})",
          flush=True)


# (e)'s CLI runs: a PT ladder with MBAR, and the NPT isobars
LOCAL_CLI = (
    ("CLI ladder N=108, 4 T x 128, PT every 10, MBAR",
     ["50", "150", "3", "1.1", "--n", "108", "--temperatures",
      "1.0,1.1,1.2,1.3", "--chains-per-t", "128", "--pt-exchange", "10",
      "--reweight", "1.0:1.3:7", "--seed", "2024"]),
    ("CLI NPT isobars N=108, 8 P x 512, 20 + 40",
     ["20", "40", "10", "2.0", "--npt-grid", "0.3:2.5:8", "--n", "108",
      "--rho", "0.3", "--gamma", "0.02", "--lj-cutoff", "1.8", "--chains",
      "512", "--seed", "9"]))


def drive_local_devices(tmp: Path, card: str):
    """(e) the batched drivers with their chains split over [cuda:0,
    cuda:0] in one process, each bitwise the one-device call and both
    timed: the tsweep ladder N = 108, 4 T x 128 (dense K1-at); the PT
    ladder at (a)'s width (N = 1024, 8 T x 64, z-skip K1-at, exchange
    every 16), swap counts included; tune_mobility of the N = 1024 x 512
    ensemble (dense probes); the NPT isobars N = 108, 8 P x 512 and
    Gibbs N = 96 x 256 (plain engine graphs); the CLI ladder and NPT
    isobars with the device helper patched, their CSVs byte-identical to
    the unpatched run. Returns the launch counts (uniform, ladders)."""
    from tpu_smc_torch import cli, cli_ensembles
    from tpu_smc_torch import gcmc as tg
    from tpu_smc_torch import gibbs as tgb
    from tpu_smc_torch import npt as tn
    from tpu_smc_torch import pt as tpt
    from tpu_smc_torch import tsweep as tts
    from tpu_smc_torch import tuning as ttune
    from tpu_smc_torch.config import RunParams, SMCConfig
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    ladders, uniform = {}, {}
    temps4 = [1.0, 1.1, 1.2, 1.3]
    out, lc, ms = one_and_sharded(
        lambda devs: tts.simulate_temperature_sweep(
            SMCConfig.for_n(108), RunParams(100, 300, 6), temps4,
            seed_words(2024), chains_per_t=128, sampler="dense",
            device="cuda", devices=devs))
    check(lc["dense"] > 0 and lc["per_chain_at"] == lc["dense"],
          f"(e) tsweep launches {lc}")
    check_same(out, "tsweep N=108, 4 T x 128, 100 + 300 (K1-at)", ms, card)
    add_counts(ladders, lc)

    temps8 = [0.9, 1.0, 1.1, 1.2, 1.3, 1.4, 1.5, 1.6]
    out, lc, ms = one_and_sharded(
        lambda devs: tpt.simulate_parallel_tempering(
            SMCConfig.for_n(1024), RunParams(32, 96, 3), temps8,
            seed_words(2024), chains_per_t=64, exchange_interval=16,
            sampler="zsorted", device="cuda", devices=devs))
    check(lc["zskip"] > 0 and lc["per_chain_at"] == lc["zskip"]
          + lc["dense"], f"(e) PT launches {lc}")
    att = out[1][1].swap_attempts
    check_same(out, "PT N=1024, 8 T x 64, every 16, 32 + 96 (z-skip "
               "K1-at)", ms, card, f", swap attempts {att.tolist()}, "
               f"acceptance {np.round(out[1][1].swap_acceptance, 3).tolist()}")
    add_counts(ladders, lc)

    cfg = SMCConfig.for_n(1024)
    st, w = init_ensemble_state(cfg, seed_words(7), 512)
    out, lc, ms = one_and_sharded(
        lambda devs: ttune.tune_mobility(
            cfg, st, w, target=0.5, sampler="zsorted", seed=5,
            sweeps_per_block=10, max_blocks=6, devices=devs))
    check(lc["dense"] > 0 and lc["per_chain_at"] == 0,
          f"(e) tuning launches {lc}")
    (s1, t1), (s2, t2) = out
    bad = same_states(s1, s2)
    check(t1 == t2 and not bad, f"(e) tune_mobility: A {t1.proposal_a} "
          f"against {t2.proposal_a}, states differ in {bad}")
    print(f"  (e) tune_mobility N=1024 x 512 (dense probes, {t1.sweeps_used}"
          f" sweeps): A = {t2.proposal_a:.6g}, history bitwise one device; "
          f"{ms[0]:.1f} ms one device, {ms[1]:.1f} ms sharded over "
          f"[cuda:0, cuda:0] ({card})", flush=True)
    add_counts(uniform, lc)

    ncfg = SMCConfig.bulk(n=108, temperature=2.0, rho=0.3, gamma=0.02,
                          lj_cutoff=1.8, lj_shift=True)
    p_c = np.repeat(np.linspace(0.3, 2.5, 8), 512)
    out, lc, ms = one_and_sharded(
        lambda devs: tn.simulate_npt(ncfg, p_c, 20, 40, seed_words(9),
                                     n_chains=len(p_c), dlnv=0.1, seed=9,
                                     chunk=25, device="cuda",
                                     devices=devs))
    check(not any(lc.values()), f"(e) NPT launches {lc}")
    check_same(out, "NPT isobars N=108, 8 P x 512, 20 + 40 (resync every "
               "25)", ms, card)
    gcfg = SMCConfig.bulk(n=96, temperature=0.75, rho=0.6, gamma=0.02,
                          lj_cutoff=1.8, lj_shift=True)
    out, lc, ms = one_and_sharded(
        lambda devs: tgb.simulate_gibbs(gcfg, 40, 60, seed_words(7), 96,
                                        n_chains=256, dlnv=0.08,
                                        n_transfer=24, seed=7, chunk=25,
                                        device="cuda", devices=devs),
)
    check(not any(lc.values()), f"(e) Gibbs launches {lc}")
    check(out[1][1].n_conserved, "(e) Gibbs: N1 + N2 != N")
    check_same(out, "Gibbs N=96 x 256, 40 + 60 (resync every 25)", ms, card)

    # the CLI: the device helper of every mode patched to [cuda:0, cuda:0]
    asked = []

    def two(device, n, nproc, label=""):
        asked.append((n, label))
        return (torch.device("cuda", 0),) * 2

    for i, (label, argv) in enumerate(LOCAL_CLI):
        files, ms = [], []
        for k in (0, 1):
            d = tmp / f"local{i}_{k}"
            with contextlib.ExitStack() as stack:
                if k:
                    stack.enter_context(patched(cli, _chain_devices=two))
                    stack.enter_context(patched(cli_ensembles,
                                                _chain_devices=two))
                _, lc, dt, _ = run_main(argv + ["--data-dir", str(d)])
            files.append({p.name: p.read_bytes() for p in d.rglob("*.csv")})
            ms.append(1e3 * dt)
            add_counts(ladders, lc)
        diff = sorted(set(files[0]) ^ set(files[1])) + [
            k for k in files[0] if files[0][k] != files[1].get(k)]
        check(asked and files[0] and not diff,
              f"(e) {label}: CSVs differ from the one-device run: {diff}")
        print(f"  (e) {label}: {len(files[0])} CSVs byte-identical to the "
              f"unpatched run (helper asked for {asked[-1]}); cli.main "
              f"{ms[0]:.1f} ms one device, {ms[1]:.1f} ms sharded ({card})",
              flush=True)
    return uniform, ladders


# (f)'s depths: the GCMC family and the dense 8 + 8 split (eq, max,
# resync every), the umbrella windows (eq, max; REUS every 10)
F_DEPTH = {"gcmc": (4, 8, 6), "gcmc8": (6, 12, 6), "umbrella": (10, 30)}
# (f)'s row order run, 16 chains over 2 ranks x 8: a dense bulk fluid,
# where every order shows (in the reference slab, a dilute gas, a row of
# pair terms holds a few nonzero ones, which add alike in any order)
C2_RUN = ("bulk N=108, rho 0.5", ["200", "600", "6", "1.5", "--bulk", "--n",
                                  "108", "--rho", "0.5", "--lj-cutoff", "2.5",
                                  "--gamma", "0.01", "--chains", "16",
                                  "--seed", "2024"])
# (f)'s dense GCMC: a bulk fluid whose mu keeps a cap of 96 nearly full,
# so that a move sums 96 terms a chain, most of them nonzero
DENSE_GCMC = dict(n=96, temperature=1.5, rho=0.6, lj_cutoff=2.5, gamma=0.01)
DENSE_GCMC_MU = 2.0


def drive_gcmc_family_sharded(card: str):
    """(f) the GCMC isotherm family at the slab width (N0 = 108, cap 216
    x 512, mu per chain around MU, z and g(r) profiles, resyncs inside
    both stages) and a dense bulk GCMC at 8 + 8 chains with cap 96 (a
    move sums 96 terms a chain below 16 chains a call), each on [cuda:0,
    cuda:0] against one device; the dense split also once with gcmc's
    split_of a no-op, the order of 8-chain calls, which has to differ."""
    import contextlib

    from tpu_smc_torch import gcmc as tg
    from tpu_smc_torch.config import SMCConfig
    from tpu_smc_torch.state import seed_words

    cfg = SMCConfig.for_n(108)
    eq, mx, chunk = F_DEPTH["gcmc"]
    mu = GCMC_MU + np.linspace(-0.5, 0.5, 512)
    out, lc, ms = one_and_sharded(lambda devs: tg.simulate_gcmc(
        cfg, mu, 216, eq, mx, seed_words(2024), n_chains=512, chunk=chunk,
        z_bins=32, gr_bins=32, device="cuda", devices=devs))
    check(not any(lc.values()), f"(f) GCMC family launches {lc}")
    n_tr = out[0][1].n_trace
    n_lo, n_hi = n_tr[:, 0].mean(), n_tr[:, -1].mean()
    check_same(out, f"GCMC isotherm family N0=108, cap 216 x 512, mu "
               f"{mu[0]:.3f}..{mu[-1]:.3f}, {eq} + {mx}", ms, card,
               f", <N> {n_lo:.1f} at the lowest mu, {n_hi:.1f} at the "
               f"highest", tag="(f)")
    eq, mx, chunk = F_DEPTH["gcmc8"]
    dense = SMCConfig.bulk(**DENSE_GCMC)

    def eight(devs):
        return tg.simulate_gcmc(dense, DENSE_GCMC_MU, 96, eq, mx,
                                seed_words(7), n_chains=16, n0=88,
                                chunk=chunk, z_bins=16, device="cuda",
                                devices=devs)

    out, lc, ms = one_and_sharded(eight)
    with patched(tg, split_of=lambda c, k: contextlib.nullcontext()):
        bare = eight(["cuda:0", "cuda:0"])
    n_mean = float(out[0][1].n_trace.mean())
    bad = same_results(out[0][1], bare[1]) + same_states(out[0][0], bare[0])
    check(bool(bad), "(f) dense GCMC 8 + 8 outside split_of is bitwise one "
          "device: the check reaches no order that differs")
    check_same(out, f"dense bulk GCMC 8 + 8 chains, rho 0.6, cap 96 (<N> "
               f"{n_mean:.1f}), {eq} + {mx}", ms, card,
               f"; outside split_of it differs in {bad}", tag="(f)")


def drive_umbrella_sharded(card: str):
    """(f) the umbrella windows at the measurement layer's width (N =
    108, 8 windows z0 -99..-92 x 8 replicas, REUS every 10) on [cuda:0,
    cuda:0] against one device: the exchange on the joined ladder."""
    from tpu_smc_torch import umbrella as tum
    from tpu_smc_torch.config import RunParams, SMCConfig
    from tpu_smc_torch.state import seed_words

    eq, mx = F_DEPTH["umbrella"]
    out, lc, ms = one_and_sharded(lambda devs: tum.simulate_umbrella(
        SMCConfig.for_n(108), RunParams(eq, mx, 8),
        np.linspace(-99.0, -92.0, 8), seed_words(2024), replicas=8,
        exchange_interval=10, device="cuda", devices=devs))
    check(not any(lc.values()), f"(f) umbrella launches {lc}")
    sw = out[1][1].swap_acceptance
    check_same(out, f"umbrella N=108, 8 windows x 8, REUS every 10, {eq} + "
               f"{mx}", ms, card, f", swap acceptance "
               f"{np.round(sw, 3).tolist()}", tag="(f)")


def drive_ranks_of_cards(tmp: Path, card: str):
    """(f) the ranks' own cards: phase 3's N = 1024 x 512 run over 2 ranks
    x 2 shards (each rank's helper gives it [cuda:0, cuda:0]; K2) with
    every CSV byte-identical to phase 3's, and (b)'s global ladder over 2
    ranks x 2 shards (K1-at, z-skip) byte-identical to (b)'s one
    process. Returns the launch counts (uniform, ladder)."""
    from tpu_smc_torch.config import SMCConfig

    one = RUNS[1024]
    data = tmp / "split4"
    ranks = run_ranks(one["argv"] + ["--data-dir", str(data)], "split4",
                      tmp, cards="0,0")
    cfg = SMCConfig.for_n(1024)
    key = cfg.file_key()
    names = [f"{st}_{key}_rank{r}.csv" for st in STEMS_RANK
             for r in range(512)]
    names += [f"{st}_{key}.csv" for st in ("wall", "data_ensemble",
                                           "last_state")]
    two = data / cfg.run_name()
    diff = [nm for nm in names
            if (one["dir"] / nm).read_bytes() != (two / nm).read_bytes()]
    check(not diff, f"(f) 2 ranks x 2 shards differ from one process in "
          f"{len(diff)} files: {diff[:4]}")
    for rank, (text, rec) in enumerate(ranks):
        check("Sharding 256 chains over 2 local devices" in text,
              f"(f) rank {rank} printed no local sharding line")
        lc = rec["launches"]
        check(lc["zskip"] > 0 and lc["dense"] == lc["stream"] == 0,
              f"(f) rank {rank} launches {lc}")
    walls = [rec["s"] for _, rec in ranks]
    print(f"  (f) N=1024 x 512 over 2 ranks x 2 shards (K2): {len(names)} "
          f"CSVs byte-identical to one process; wall s per rank "
          f"{walls[0]:.2f} / {walls[1]:.2f} in cli.main against "
          f"{one['s']:.2f} s in one process ({card})", flush=True)
    uniform = add_counts({}, *[rec for _, rec in ranks])

    t0 = time.perf_counter()
    granks = run_ranks(GLOBAL_LADDER + [
        "--global-ladder", "--data-dir", str(tmp / "gl4"), "--checkpoint",
        str(tmp / "gl4.npz")], "global_ladder4", tmp, cards="0,0")
    d1, d4 = (tmp / g / cfg.run_name() for g in ("gl1", "gl4"))
    for stem in ("tsweep", "pt", "reweight", "reweight_zprofile"):
        nm = f"{stem}_{key}.csv"
        check((d1 / nm).read_bytes() == (d4 / nm).read_bytes(),
              f"(f) global ladder over 2 x 2: {nm} differs from one process")
    with np.load(tmp / "gl1.npz") as a, np.load(tmp / "gl4.npz") as b:
        bad = [k for k in a.files if not np.array_equal(a[k], b[k])]
        check(sorted(a.files) == sorted(b.files) and not bad,
              f"(f) global ladder over 2 x 2: checkpoint differs in {bad}")
    for rank, (text, rec) in enumerate(granks):
        check("Global ladder: 128 chains sharded over 4 devices across 2 "
              "processes" in text and "a device shard of the ONE global "
              "ladder" in text, f"(f) global ladder rank {rank} lines")
    ladder = add_counts({}, *[rec for _, rec in granks])
    check(ladder["zskip"] > 0 and ladder["per_chain_at"] == ladder["zskip"]
          + ladder["dense"], f"(f) global ladder launches {ladder}")
    print(f"  (f) global ladder N=1024, 4 x 32 over 2 ranks x 2 shards "
          f"(z-skip K1-at): tsweep/pt/reweight/reweight_zprofile and the "
          f"checkpoint byte-identical to (b)'s one process; ranks "
          f"{granks[0][1]['s']:.1f} / {granks[1][1]['s']:.1f} s against "
          f"(b)'s one process {RUNS['gl1_s']:.1f} s; "
          f"{time.perf_counter() - t0:.1f} s in all ({card})", flush=True)
    return uniform, ladder


def drive_row_order(tmp: Path, card: str) -> dict:
    """(f) the row order: torch's [B, 108].sum(-1) of 8 rows beside the
    same rows in a 16-row call, and the pair energy of 16 dense bulk
    chains in two calls of 8 beside one call of 16 (the hazard), both
    under split_of(16, 2) against the 16-row call; then C2_RUN split
    over 2 ranks x 8 chains (one card each; a rank's energy resync and
    pressure sum its 8 chains) against one process: every CSV
    byte-identical. Returns the launch counts."""
    from tpu_smc_torch import potentials as tp
    from tpu_smc_torch.config import SMCConfig
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    x = torch.randn(16, 108, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(5))
    d = (x[:8].sum(-1) - x.sum(-1)[:8]).abs()
    with tp.split_of(16, 2):
        padded = bool(torch.equal(tp.chain_sum(x[:8]), x.sum(-1)[:8]))
    check(padded, "(f) chain_sum under split_of(16, 2) is not the 16-row "
          "sum")
    # the dense bulk fluid's pair energy of 16 chains, in two calls of 8
    cfg = SMCConfig.bulk(n=108, temperature=1.5, rho=0.5, lj_cutoff=2.5,
                         gamma=0.01)
    st, _ = init_ensemble_state(cfg, seed_words(3), 16, device="cuda")
    r = st.r + 0.05 * torch.randn(st.r.shape, device="cuda",
                                  generator=torch.Generator(
                                      "cuda").manual_seed(6))
    whole = tp.pair_energy_total(r, cfg)
    halves = torch.cat([tp.pair_energy_total(r[:8], cfg),
                        tp.pair_energy_total(r[8:], cfg)])
    with tp.split_of(16, 2):
        shared = torch.cat([tp.pair_energy_total(r[:8], cfg),
                            tp.pair_energy_total(r[8:], cfg)])
    check(torch.equal(shared, whole), "(f) the bulk pair energy in calls "
          "of 8 under split_of(16, 2) is not the 16-chain call's")
    rel = float(((halves - whole).abs() / whole.abs()).max())
    print(f"  (f) row order: torch's sum of 108 normal terms differs in "
          f"{int((d > 0).sum())} of 8 rows between an 8-row and a 16-row "
          f"call (largest {float(d.max()):.3g}); the pair energy of 16 bulk "
          f"chains at rho 0.5 in two calls of 8 differs in "
          f"{int((halves != whole).sum())} of 16 chains (largest "
          f"{rel:.3g} relative); under split_of(16, 2) both are the "
          f"16-row call's bits ({card})", flush=True)
    label, argv = C2_RUN
    t0 = time.perf_counter()
    _, l1, dt1, _ = run_main(argv + ["--data-dir", str(tmp / "c2one")])
    ranks = run_ranks(argv + ["--data-dir", str(tmp / "c2two")], "c2", tmp)
    files = [{p.relative_to(tmp / g): p.read_bytes()
              for p in (tmp / g).rglob("*.csv")} for g in ("c2one", "c2two")]
    diff = sorted(set(files[0]) ^ set(files[1])) + [
        k for k in files[0] if files[0][k] != files[1].get(k)]
    check(files[0] and not diff, f"(f) {label} x 16 over 2 ranks x 8: "
          f"CSVs differ from one process: {diff[:4]}")
    print(f"  (f) {label} x 16 over 2 ranks x 8 chains: {len(files[0])} "
          f"CSVs byte-identical to one process; one process {dt1:.1f} s, "
          f"ranks {ranks[0][1]['s']:.1f} / {ranks[1][1]['s']:.1f} s in "
          f"cli.main; {time.perf_counter() - t0:.1f} s in all ({card})",
          flush=True)
    return add_counts({}, l1, *[rec for _, rec in ranks])


def phase_multiprocess(device, card: str):
    """The phase's runs (a)-(f). Returns their launch counts summed:
    (uniform (A, T) runs (a), (d), (e)'s tuning and (f)'s CLI runs, the
    ladders (b), (c), (e)'s and (f)'s)."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        uniform = drive_split_main(tmp, card)
        ladders = drive_global_ladder(tmp, card)
        add_counts(ladders, drive_per_process_ladders(tmp, card))
        e_uniform, e_ladders = drive_local_devices(tmp, card)
        drive_gcmc_family_sharded(card)
        drive_umbrella_sharded(card)
        f_uniform, f_ladders = drive_ranks_of_cards(tmp, card)
        c2 = drive_row_order(tmp, card)
    add_counts(ladders, e_ladders, f_ladders)
    return add_counts(uniform, drive_sharded(device, card), e_uniform,
                      f_uniform, c2), ladders


# ----------------------------------------------------------------------
# Phase 5: diagnostics and tooling (device trace, z-skip cost model,
# checked sweep, analysis CLI, examples)
# ----------------------------------------------------------------------

MAIN_1024 = ("1590.673720", "0.789075")   # drive_cli's N = 1024 x 512 run


def trace_summary(tdir: Path, card: str) -> dict:
    """The device timeline of the trace in tdir (profiling.trace's
    files): fails unless smc_sweep_kernel is among its device events;
    prints the idle share of the traced window, the five device
    operations that took most time, the five longest idle gaps with the
    host range open during each, and the head of the operator table."""
    from tpu_smc_torch import profiling

    t0 = time.perf_counter()
    tl = profiling.device_timeline(tdir / "trace.json")
    sweeps = [e for e in tl["device"] if "smc_sweep_kernel" in e[0]]
    check(sweeps, "no smc_sweep_kernel among the trace's device events")
    s = profiling.timeline_summary(tl["device"], tl["host"], tl["window"])
    size = (tdir / "trace.json").stat().st_size
    print(f"  trace {size / 1e6:.1f} MB, {len(tl['device'])} device and "
          f"{len(tl['host'])} host events, parsed in "
          f"{time.perf_counter() - t0:.1f} s; smc_sweep_kernel "
          f"{len(sweeps)} launches, {sum(e[2] for e in sweeps) / 1e3:.3f} "
          f"ms ({card})", flush=True)
    print(f"  device idle share of the traced window: "
          f"{s['idle_share']:.4f} (busy {s['busy_us'] / 1e3:.3f} of "
          f"{s['window_us'] / 1e3:.3f} ms) ({card})", flush=True)
    for op in s["top_ops"]:
        print(f"    device op {op['us'] / 1e3:10.3f} ms x {op['count']:6d}: "
              f"{op['name'][:90]}", flush=True)
    for g in s["gaps"]:
        print(f"    idle gap {g['us'] / 1e3:10.3f} ms at "
              f"{(g['start_us'] - tl['window'][0]) / 1e3:.3f} ms, host "
              f"range open: {(g['host'] or 'none')[:60]}", flush=True)
    table = (tdir / "key_averages.txt").read_text().splitlines()
    print("\n".join("    " + ln[:160] for ln in table[:14]), flush=True)
    return s


def drive_profiled(card: str, tmp: Path):
    """(a) The N = 1024 x 512 main-path run of phase 3 (drive_cli's
    arguments) again, with --profile-dir: mean E and acceptance exactly
    the recorded ones, smc_sweep_kernel among the trace's device events;
    prints the device idle share of the traced window, the five device
    operations that took most time and the five longest idle gaps with
    the host range open during each. Returns (launch counts, run dir)."""
    tdir = tmp / "trace"
    out, launches, dt, sim = run_main(
        ["64", "192", "3", "1.1", "--n", "1024", "--chains", "512",
         "--sampler", "auto", "--seed", "2024", "--lca-time", "2",
         "--data-dir", str(tmp / "Data"), "--profile-dir", str(tdir)])
    mean_e = summary_value(out, "Mean energy:")
    acc = summary_value(out, "Average acceptance ratio:")
    check((mean_e, acc) == MAIN_1024,
          f"profiled N=1024: mean energy {mean_e}, acceptance {acc}; "
          f"recorded {MAIN_1024}")
    check(launches["zskip"] > 0 and launches["dense"] == 0,
          f"profiled N=1024 launches {launches}")
    print(f"  profiled N=1024 x 512: {dt:.1f} s, mean E {mean_e}, "
          f"acceptance {acc} (bitwise the recorded run) ({card})",
          flush=True)
    trace_summary(tdir, card)
    print_split(1024, 192, 512, dt, sim)
    return launches, one_run_dir(tmp)


def drive_cost_model(device, card: str):
    """(b) K2 over one sort cadence (16 sweeps) at N = 1024 x 512 from an
    ensemble 400 zsorted sweeps past the lattice, with visited rows
    counted (a diagnostic launch): every chain's rows per pass inside
    profiling.zskip_kernel_fraction_band; prints both, the ideal
    per-chain band and the in-plane headroom at the sort point."""
    from tpu_smc_torch import ensemble as en
    from tpu_smc_torch import profiling
    from tpu_smc_torch.config import SMCConfig
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    cfg = SMCConfig.for_n(1024)
    state, w = init_ensemble_state(cfg, seed_words(2024), 512, device=device)
    state, _ = en.ensemble_sweeps_zsorted(state, w, cfg, cfg.proposal_a,
                                          400, seed=2024)
    out = profiling.zskip_cadence_rows(state, w, cfg, cfg.proposal_a,
                                       seed=7)
    n_pad, rows = out["n_pad"], out["rows_per_pass"]
    lo, hi = profiling.zskip_kernel_fraction_band(out["r_pre"],
                                                  out["r_post"], cfg)
    ilo, ihi = profiling.zskip_processed_fraction_band(out["r_pre"],
                                                       out["r_post"], cfg)
    head = profiling.zskip_inplane_headroom(out["r_pre"], cfg)
    inside = (rows >= lo * n_pad) & (rows <= hi * n_pad)
    print(f"  K2 N=1024 x 512, one cadence ({out['sweeps']} sweeps): "
          f"visited rows per pass mean {rows.mean():.1f} (min "
          f"{rows.min():.1f}, max {rows.max():.1f}; per move "
          f"{2 * rows.mean():.1f}); the port's kernel band "
          f"[{lo * n_pad:.1f}, {hi * n_pad:.1f}], the ideal per-chain band "
          f"[{ilo * cfg.n:.1f}, {ihi * cfg.n:.1f}] rows of {n_pad}; "
          f"{int(inside.sum())}/{len(rows)} chains inside ({card})",
          flush=True)
    print(f"  in-plane headroom at the sort point: admitted "
          f"{head['admitted_rows']:.1f} rows, |dz| < rc "
          f"{head['z_rows']:.1f}, x/y box {head['box_rows']:.1f}, sphere "
          f"{head['sphere_rows']:.1f} (z/admitted "
          f"{head['z_over_admitted']:.3f}, box/admitted "
          f"{head['box_over_admitted']:.3f})", flush=True)
    check(bool(inside.all()), f"K2's visited rows outside the model band: "
          f"{rows[~inside][:5]} not in [{lo * n_pad}, {hi * n_pad}]")


def drive_checked_sweep(device, card: str):
    """(c) guards.checked_sweep on the card at N = 108 x 64: a clean
    state bitwise sampler.sweep under the same draws, and a NaN injected
    into one particle named with its chain, particle and move."""
    from tpu_smc_torch import guards, sampler
    from tpu_smc_torch.config import SMCConfig
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    cfg = SMCConfig.for_n(108)
    state, w = init_ensemble_state(cfg, seed_words(7), 64, device=device)
    g = torch.Generator(device=device).manual_seed(7)
    a = cfg.proposal_a
    noise = torch.randn((64, 108, 3), generator=g, device=device) \
        * math.sqrt(2.0 * a)
    unif = torch.rand((64, 108), generator=g, device=device)
    fn = guards.checked_sweep(cfg)
    t0 = time.perf_counter()
    err, (r1, e1, a1) = fn(state.r, state.energy, w, a, noise, unif, 5)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r2, e2, a2 = sampler.sweep(state.r, state.energy, w, cfg, a, noise,
                               unif, 5)
    check(err is None, f"checked_sweep on a clean state: {err}")
    check(torch.equal(r1, r2) and torch.equal(e1, e2)
          and torch.equal(a1, a2),
          "checked_sweep is not bitwise sampler.sweep on the card")
    # a NaN in chain 9's first mover (offset 5): its own move is the
    # first non-finite one (a NaN position poisons every later mover's
    # pair force in that chain)
    r = state.r.clone()
    r[9, 5, 0] = float("nan")
    err, _ = fn(r, state.energy, w, a, noise, unif, 5, sweep=3)
    check(err is not None and (err.chain, err.particle, err.move, err.sweep)
          == (9, 5, 0, 3), f"injected NaN at chain 9, particle 5: {err}")
    print(f"  checked_sweep N=108 x 64: clean sweep bitwise sampler.sweep "
          f"({dt * 1e3:.1f} ms, {int(a1.sum())} moves accepted); injected "
          f"NaN: {err} ({card})", flush=True)


def drive_analysis(run_dir: Path, card: str, tmp: Path):
    """(d) `python -m tpu_smc_torch.analysis RUN_DIR --box L LZ` on the
    profiled N = 1024 x 512 run (the CSVs of phase 3's run, bitwise): a
    non-empty artifact list, and the S(k) panel's numbers finite."""
    from tpu_smc_torch import analysis
    from tpu_smc_torch.config import SMCConfig

    cfg = SMCConfig.for_n(1024)
    box = [f"{cfg.box_l!r}", f"{cfg.box_lz!r}"]
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "tpu_smc_torch.analysis", str(run_dir),
         "--box", *box, "--out", str(tmp / "plots")], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    check(res.returncode == 0, f"analysis CLI failed: {res.stderr[-800:]}")
    arts = res.stdout.split()
    check(arts and all(Path(p).exists() for p in arts),
          f"analysis artifacts {arts}")
    ks_, sk = analysis.sk_panel(analysis.load_run(run_dir),
                                (cfg.box_l, cfg.box_lz), "cuda")
    check(bool(np.isfinite(sk).all()) and sk.size > 0, f"S(k) {sk}")
    print(f"  python -m tpu_smc_torch.analysis on the N=1024 run: "
          f"{len(arts)} artifacts ({', '.join(Path(p).name for p in arts[:4])}"
          f"{', ...' if len(arts) > 4 else ''}), {dt:.1f} s, matplotlib "
          f"{'present' if analysis.HAVE_MPL else 'absent (npz summaries)'}; "
          f"S(k) at |k| {ks_[0]:.4f} .. {ks_[-1]:.4f}: {sk[0]:.4f} .. "
          f"{sk[-1]:.4f}, finite ({card})", flush=True)


def drive_example(card: str):
    """(e) examples/torch_run_ensemble.py at its own depth (N = 108 x 256
    chains, 500 + 2000 sweeps, 100 gathers; dense K1) as a user runs it."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_run_ensemble.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    check(res.returncode == 0, f"torch_run_ensemble.py failed: "
          f"{res.stderr[-800:]}")
    out = res.stdout
    check("sampler: dense" in out, f"example engine: {out[:200]}")
    mean_e = float(summary_value(out, "mean energy:"))
    check(math.isfinite(mean_e) and 150.0 < mean_e < 200.0,
          f"example mean energy {mean_e}")
    lines = [ln for ln in out.splitlines() if ln.strip()]
    print(f"  examples/torch_run_ensemble.py: {dt:.1f} s (process "
          f"included): " + "; ".join(lines) + f" ({card})", flush=True)


def phase_tooling(device, card: str):
    """Phase 5, the diagnostics and tooling, (a)-(e). Returns the profiled
    run's launch counts."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        launches, run_dir = drive_profiled(card, tmp)
        print(f"  ((a) profiled main path: {time.perf_counter() - t0:.1f} s)",
              flush=True)
        for label, drive, args in (
                ("(b) cost model", drive_cost_model, (device, card)),
                ("(c) checked sweep", drive_checked_sweep, (device, card)),
                ("(d) analysis CLI", drive_analysis, (run_dir, card, tmp)),
                ("(e) example", drive_example, (card,))):
            t0 = time.perf_counter()
            drive(*args)
            print(f"  ({label}: {time.perf_counter() - t0:.1f} s)",
                  flush=True)
    return launches


# ----------------------------------------------------------------------
# Phase 4: timing
# ----------------------------------------------------------------------

def cuda_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, launches: int = 100, reps: int = 5) -> float:
    """Device ms per call of fn: `launches` calls captured in one CUDA
    graph and the graph replayed `reps` times between CUDA events, so no
    host work (the wrapper's Python, its allocation, ctypes) lies between
    the launches; it ran once, at capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * launches)


def kernel_templates(source: str) -> dict:
    """{kernel: its bool template parameters' names, in order}, read from
    the __global__ declarations of csrc/sweep.cu's text."""
    decl = re.finditer(r"template <([^>]*)>\s*__global__ void"
                       r"(?: __launch_bounds__\([^)]*\))?\s*(\w+)\s*\(",
                       source)
    return {m.group(2): tuple(re.findall(r"bool (\w+)", m.group(1)))
            for m in decl}


def ptxas_table(log: str, templates: dict) -> list:
    """Registers, spills and stack per kernel instantiation from nvcc's
    `-Xptxas -v` log: [(name<modes>, registers, spill stores, spill
    loads, stack bytes)], modes the template flags that are set, named
    by `templates` (kernel_templates); a kernel whose parsed flags do not
    match its parameters in number raises."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
        if m:
            k = int(m.group(1))
            name, rest = m.group(2)[:k], m.group(2)[k:]
            targs = re.match(r"I((?:Lb[01]E)+)E", rest)
            flags = re.findall(r"Lb([01])E", targs.group(1)) if targs else []
            names = templates.get(name, ())
            if len(flags) != len(names):
                raise ValueError(f"ptxas log: {name} has {len(flags)} template "
                                 f"flags, csrc/sweep.cu declares {names}")
            modes = [nm for nm, f in zip(names, flags) if f == "1"]
            cur = [f"{name}<{','.join(modes)}>" if targs else name, 0, 0, 0, 0]
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur[4], cur[2], cur[3] = (int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur[1] = int(m.group(1))
    return rows


def print_ptxas(log: str, source: str) -> None:
    for name, regs, st, ld, stack in ptxas_table(log,
                                                 kernel_templates(source)):
        print(f"  ptxas: {name}: {regs} registers, {st} bytes spill stores, "
              f"{ld} bytes spill loads, {stack} bytes stack", flush=True)


def cycle_split(device, card: str) -> None:
    """Where a move's time goes: SM clock cycles per move in each phase
    (kernels.sweep.PHASES, csrc/sweep.cu `Laps`), lapped by lane 0 of the
    wall warp of each chain in a diagnostic launch and averaged over the
    chains, at K1 (dense, N = 108 x 512, 2 sweeps), K2 (z-skip, N = 1024 x
    512, 2 sweeps), K3 (streamed, the large-N main path's N = 32768 x
    128, 1 sweep) and K4 (N = 1024 x 256, 1 sweep, W = 128;
    kernels.banded.PHASES); the lapped launch's outputs are held bitwise
    those of the main path's instantiation."""
    from tpu_smc_torch.kernels import sweep as ks

    def split(label, run, moves, phases):
        d = {"cycles": True}
        check(bitwise(run(diag=d), run()), f"cycle split {label}: the lapped "
              "launch is not bitwise the main path's")
        per = d["cycles"].double().mean(0) / moves
        total = float(per.sum())
        print(f"  cycle split {label}: {total:.0f} cycles per move; "
              + ", ".join(f"{k} {v:.0f} ({v / total:.1%})"
                          for k, v in zip(phases, per.tolist()))
              + f" ({card})", flush=True)

    big = large_n_config()
    cases = (("K1", 108, 512, False, False, 2, None),
             ("K2", 1024, 512, True, False, 2, None),
             ("K3", big.n, 128, True, True, 1, big))
    for label, n, c, zskip, stream, sweeps, cfg in cases:
        cfg, _, args, ks = kernel_inputs(n, c, device, sweeps=sweeps,
                                         sort=zskip, cfg=cfg)
        run = ((lambda **kw: ks.sweep_block_stream(*args, cfg, sweeps,
                                                   cfg.proposal_a, **kw))
               if stream else
               (lambda **kw: ks.sweep_block(*args, cfg, sweeps, cfg.proposal_a,
                                            zskip=zskip, **kw)))
        split(f"{label} N={n} x {c}, {sweeps} sweep(s)", run,
              sweeps * cfg.n, ks.PHASES)
    # K4 at its main path's shape (banded_case's): one sweep, W = 128
    from tpu_smc_torch import ensemble as en
    from tpu_smc_torch.kernels import banded as kb

    cfg, state, w = equilibrated(device)
    x, y, z, margin = kb.sort_and_margin(state.r, cfg, 128)
    wa, wb = ks.wall_coeff_rows(w, cfg)
    args = (x, y, z, state.energy.reshape(1, -1).to(torch.float32), wa, wb,
            margin, en._per_sweep_randomness(state, cfg, 31, 1)[0][0], cfg,
            cfg.proposal_a, 128, 12.0)
    split(f"K4 N={cfg.n} x {state.n_chains}, 1 sweep, W=128",
          lambda **kw: kb.banded_sweep_block(*args, **kw), cfg.n, kb.PHASES)


def kernel_case(n: int, c: int, zskip: bool, device, sweeps: int = 2,
                at: bool = False, walls: int = 0, plain: bool = True,
                cfg=None, xsort: int = 0):
    """At the main path's shape (n, c): kernel vs plain on the same inputs
    (phase 2's comparison; skipped when not `plain`), the plain version's
    ms and the bound of this run's work, and a launch of the kernel on
    these inputs to time. at: per-chain (A, T) rows of an 8-level ladder;
    walls: per-chain wall tables of that many realizations; cfg: the
    configuration (default: the default box for n); xsort = k: the 2-D
    pass (K1-xs) on rows sorted by z-band of 128 k rows and x, its bound
    from the fewer of its own visited rows and K2's on the same positions
    z-sorted (the 2-D admission visits more rows than the 1-D one, and
    the bound counts the least work the sweep needs)."""
    cfg, w, args, ks = kernel_inputs(n, c, device, sweeps=sweeps,
                                     sort=zskip, walls=walls, cfg=cfg,
                                     xsort=xsort)
    a, t = ladder_rows(cfg, c, device) if at else (cfg.proposal_a, None)
    mode = (f"xskip k={xsort}" if xsort else "zskip" if zskip else "dense") \
        + (" pbc" if cfg.pbc_z else "") \
        + (" refnoise" if cfg.reference_noise else "")
    label = (f"{mode} N={n} C={c}" + (" per-chain (A, T)" if at else "")
             + (f" walls of {walls}" if walls else ""))
    dk = {}
    cmp = (compare(cfg, w, args, ks, zskip, label, a=a, t=t, xslices=xsort)
           if plain else None)
    if cmp is None:
        ks.sweep_block(*args, cfg, sweeps, a, zskip=zskip, diag=dk,
                       temperature=t, xslices=xsort)
    visited = float((cmp["visited"] if cmp else dk["visited"]).double().sum())
    if xsort:
        _, _, args2, _ = kernel_inputs(n, c, device, sweeps=sweeps, sort=True,
                                       cfg=cfg)
        d2 = {}
        ks.sweep_block(*args2, cfg, sweeps, a, zskip=True, diag=d2,
                       temperature=t)
        k2 = float(d2["visited"].double().sum())
        print(f"  {label}: pair rows per pass {visited / (2 * sweeps * n * c):.0f}"
              f", K2's on the same positions z-sorted "
              f"{k2 / (2 * sweeps * n * c):.0f}; the bound counts "
              f"{'K2' if k2 < visited else 'K1-xs'}'s", flush=True)
        visited = min(visited, k2)
    n_pad = args[0].shape[0]
    wall_floats = args[4].numel() + args[5].numel()
    # planes and energy in and out, wall rows, per-chain scales, offsets
    # and seed words, traces
    nbytes = 4 * (2 * (3 * n_pad * c + c) + wall_floats + 4 * c
                  + 3 * sweeps + 2 * sweeps * c)
    flops = row_flops(cfg) * visited + move_flops(cfg) * sweeps * n * c
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    launch = lambda: ks.sweep_block(*args, cfg, sweeps, a, zskip=zskip,
                                    temperature=t, xslices=xsort)
    return launch, dict(max_abs_err=cmp["max_err"] if cmp else None,
                        plain_ms=cmp["plain_ms"] if cmp else None,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by=("bytes" if t_bytes > t_ops
                                  else "operations"))


# K3's plain comparison at N = 32768: windows of K3_WINDOW moves that
# start at the bottom, the middle and the top of the z-sorted slab (the
# plain version's cost is per move, ~6 ms of launches and two host syncs,
# whatever the chain count; a whole sweep took 175-224 s of the run)
K3_WINDOW = 1024
K3_WINDOW_STARTS = (0.0, 0.5, 1.0)


def stream_case(device, card: str):
    """K3 at the large-N main path's shape (the density-matched N = 32768
    box x 128 chains), one sweep per call: against its plain version as
    in phase 2 on all 128 chains, over windows of K3_WINDOW moves at the
    bottom, the middle and the top of the z-sorted slab (the planes
    rolled by a multiple of 128 rows so that the window's rows lead and
    the blocks stay whole; a config with n = K3_WINDOW moves them, every
    row still interacts, carried energies against a recompute of all
    rows); the plain version's ms over the windows, the bound from the
    visited rows of a whole sweep (a diagnostic launch) and the kernel's
    ms on the whole sweep; and K3 against K2 in turns at N = 16384 x 128,
    where both fit. Returns the kernels-line fields it measures."""
    cfg = large_n_config()
    c, sweeps = 128, 1
    cfg, w, args, ks = kernel_inputs(cfg.n, c, device, sweeps=sweeps,
                                     sort=True, cfg=cfg)
    max_err, plain_ms = 0.0, 0.0
    for f in K3_WINDOW_STARTS:
        k0 = int(f * (cfg.n - K3_WINDOW)) // ks.ROW_BLOCK * ks.ROW_BLOCK
        rolled = tuple(torch.roll(p, -k0, 0) for p in args[:3]) + args[3:]
        cmp = compare(cfg, w, rolled, ks, True,
                      f"K3 vs plain N={cfg.n} x {c}, moves of rows "
                      f"{k0}-{k0 + K3_WINDOW - 1} of the z-sorted slab",
                      stream=True, moves=K3_WINDOW)
        max_err = max(max_err, cmp["max_err"])
        plain_ms += cmp["plain_ms"]
    dk = {}
    ks.sweep_block_stream(*args, cfg, sweeps, cfg.proposal_a, diag=dk)
    visited = float(dk["visited"].double().sum())
    n_pad = args[0].shape[0]
    wall_floats = args[4].numel() + args[5].numel()
    nbytes = 4 * (2 * (3 * n_pad * c + c) + wall_floats + 4 * c
                  + 3 * sweeps + 2 * sweeps * c)
    flops = row_flops(cfg) * visited + move_flops(cfg) * sweeps * cfg.n * c
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    streamed = 12 * visited / PEAK_BYTES * 1e3
    ms = cuda_ms(lambda: ks.sweep_block_stream(*args, cfg, sweeps,
                                               cfg.proposal_a), reps=3)
    print(f"  sweep_stream N={cfg.n} x {c}, {sweeps} sweep: kernel {ms:.3f} "
          f"ms ({sweeps * c / ms * 1e3:.1f} chain-sweeps/s), plain "
          f"{plain_ms:.1f} ms for {len(K3_WINDOW_STARTS)} x {K3_WINDOW} of "
          f"the sweep's {cfg.n} moves, bound "
          f"{max(t_bytes, t_ops):.4f} ms ({'bytes' if t_bytes > t_ops else 'operations'}; "
          f"inputs read once), its envelope rows streamed at the HBM rate "
          f"{streamed:.3f} ms, visited rows per pass "
          f"{visited / (2 * sweeps * cfg.n * c):.0f} ({card})", flush=True)
    cfg2, _, args2, _ = kernel_inputs(16384, c, device, sweeps=1, sort=True)
    turns = interleaved_ms({
        "K2": lambda: ks.sweep_block(*args2, cfg2, 1, cfg2.proposal_a,
                                     zskip=True),
        "K3": lambda: ks.sweep_block_stream(*args2, cfg2, 1,
                                            cfg2.proposal_a)},
        rounds=3, reps=2)
    print(f"  N=16384 x {c}, 1 sweep, in turns: K2 (resident z-skip) "
          f"{turns['K2']:.3f} ms, K3 (streamed) {turns['K3']:.3f} ms "
          f"({turns['K3'] / turns['K2'] - 1:+.1%}) ({card})", flush=True)
    return dict(max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations")


# FP32 operations of one reference-noise pair: two of log1p, scale by
# -2, sqrt, scale by s, 2 pi u, cos or sin, product, and two uniforms'
# conversions (Philox's integer work not counted)
FLOPS_PER_PAIR = 18


def noise_case(device, words, n: int, c: int, s2a: float, err: float,
               card: str):
    """K5 at the main path's shape (one plane of the reference-noise run,
    [noise_rows(n), c], its first seed words and scale; err: its max
    |kernel - plain| there): its device ms (graph_ms: launches in one
    CUDA graph) beside the launch floor, an empty kernel on K5's grid
    launched the same way; the ms of a call through the Python wrapper
    (launches back to back, the host's share included); the plain
    version's (reference_noise_plane on the card); and the bound of
    writing the plane. Returns the kernels-line fields, ms the device
    time."""
    from tpu_smc_torch.kernels import sweep as ks

    rows = ks.noise_rows(n)
    launch = lambda: ks.debug_reference_noise(words, n, c, s2a, device)
    ms = graph_ms(launch)
    floor_ms = graph_ms(lambda: ks.empty_launch(n, c, device))
    call_ms = cuda_ms(launch, reps=20)
    plain_ms = cuda_ms(lambda: ks.reference_noise_plane(words, n, c, s2a,
                                                        device), reps=3)
    t_bytes = 4 * rows * c / PEAK_BYTES * 1e3
    t_ops = FLOPS_PER_PAIR * rows // 2 * c / PEAK_F32 * 1e3
    print(f"  debug_reference_noise [{rows}, {c}]: kernel {ms:.4f} ms on the "
          f"device (CUDA graph) beside the empty kernel's {floor_ms:.4f} ms, "
          f"{call_ms:.4f} ms per call through the wrapper, plain "
          f"{plain_ms:.3f} ms, bound {max(t_bytes, t_ops):.4f} ms "
          f"({'bytes' if t_bytes > t_ops else 'operations'}), max |kernel - "
          f"plain| {err:.3g} ({card})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations")


def xsort_probe(device, card: str):
    """K1-xs (k = 4, 8) beside K2 in turns at scripts/probe_xsort.py's
    shapes, N = 1024 x 512 and N = 4096 x 256, 2-sweep calls from the
    same state (K2 on z-sorted rows, K1-xs on the 2-D-sorted rows), with
    the pair rows each visits per pass."""
    for n, c in ((1024, 512), (4096, 256)):
        launches, rows = {}, {}
        for k in (0, 4, 8):
            cfg, _, args, ks = kernel_inputs(n, c, device, sort=True, xsort=k)
            kw = dict(zskip=True, xslices=k)
            d = {}
            ks.sweep_block(*args, cfg, 2, cfg.proposal_a, diag=d, **kw)
            name = f"xs{k}" if k else "K2"
            rows[name] = float(d["visited"].double().mean()) / (4 * n)
            launches[name] = (lambda args=args, cfg=cfg, kw=kw:
                              ks.sweep_block(*args, cfg, 2, cfg.proposal_a,
                                             **kw))
        ms = interleaved_ms(launches, rounds=3, reps=5)
        print(f"  N={n} x {c}, 2 sweeps, in turns: K2 {ms['K2']:.3f} ms "
              f"({rows['K2']:.0f} rows/pass); K1-xs k=4 {ms['xs4']:.3f} ms "
              f"({ms['xs4'] / ms['K2']:.3f}x, {rows['xs4']:.0f} rows/pass); "
              f"k=8 {ms['xs8']:.3f} ms ({ms['xs8'] / ms['K2']:.3f}x, "
              f"{rows['xs8']:.0f} rows/pass) ({card})", flush=True)


def banded_case(device, card: str):
    """K4 at its main path's shape (the validation run's N = 1024 x 256
    equilibrated ensemble, W = 128, d_z = 12), one sweep: against its
    plain version (compare_banded), the plain version's ms, the bound of
    this sweep's work (the rows its fallback counts imply), and K4 beside
    K2 per sweep in turns (K2 on the same state's z-sorted rows). Returns
    the kernels-line fields."""
    from tpu_smc_torch import ensemble as en
    from tpu_smc_torch.kernels import banded as kb
    from tpu_smc_torch.kernels import sweep as ks

    cfg, state, w = equilibrated(device)
    c, n = state.n_chains, cfg.n
    words, offsets = en._per_sweep_randomness(state, cfg, 31, 1)
    cmp = compare_banded(cfg, w, state.r, state.energy, words[0],
                         f"K4 vs plain N={n} C={c}")
    args = cmp["args"]
    fb = float(cmp["out"][5].double().sum())
    n_pad = args[0].shape[0]
    visited = kb.visited_rows(fb, n * c, n_pad, 128)
    # planes and margin in, planes out, energy in and out, accepted and
    # fallback counts, wall rows, scales
    nbytes = 4 * (7 * n_pad * c + 4 * c + args[4].numel() + args[5].numel()
                  + 4 * c)
    flops = row_flops(cfg) * visited + move_flops(cfg) * n * c
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    x, y, z, e, wa, wb = en._kernel_inputs(state, w, cfg)
    perm = en.xsort_perm(x, z, n, 0)
    x, y, z = (torch.take_along_dim(p, perm, 0) for p in (x, y, z))
    ms = interleaved_ms({
        "K4": lambda: kb.banded_sweep_block(*args),
        "K2": lambda: ks.sweep_block(x, y, z, e, wa, wb, offsets, words, cfg,
                                     1, cfg.proposal_a, zskip=True)},
        rounds=3, reps=10)
    print(f"  sweep_banded N={n} x {c}, 1 sweep: kernel {ms['K4']:.3f} ms "
          f"beside K2 {ms['K2']:.3f} ms per sweep in turns "
          f"({ms['K4'] / ms['K2']:.3f}x), plain {cmp['plain_ms']:.1f} ms, "
          f"bound {max(t_bytes, t_ops):.4f} ms "
          f"({'bytes' if t_bytes > t_ops else 'operations'}), pair rows per "
          f"pass {visited / (2 * n * c):.0f}, fallback fraction "
          f"{fb / (n * c):.4f}, max |dx| {cmp['max_err']:.3g} ({card})",
          flush=True)
    return dict(max_abs_err=cmp["max_err"], ms=ms["K4"],
                plain_ms=cmp["plain_ms"], bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations")


def interleaved_ms(launches: dict, rounds: int = 3, reps: int = 10) -> dict:
    """ms per launch of each kernel case, timed in turns (one batch of
    `reps` launches of each case per round) so that clock and power
    drift falls on all alike; the median over rounds."""
    times = {name: [] for name in launches}
    for _ in range(rounds):
        for name, fn in launches.items():
            times[name].append(cuda_ms(fn, reps=reps))
    return {name: float(np.median(v)) for name, v in times.items()}


def engine_ms(n: int, c: int, device, sweeps: int = 16,
              cadences=()) -> dict:
    """ms of one call of the dense and of the zsorted engine for `sweeps`
    sweeps (one sort cadence at N <= 1024) from the same state at (n, c),
    and of the zsorted engine at each sort cadence in `cadences`: the
    measurements behind the CLI's auto routing and `zsort_cadence`."""
    from tpu_smc_torch import ensemble as en
    from tpu_smc_torch.config import SMCConfig
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    cfg = SMCConfig.for_n(n)
    state, w = init_ensemble_state(cfg, seed_words(11), c, device=device)
    state, _ = en.ensemble_sweeps_dense(state, w, cfg, cfg.proposal_a, 1,
                                        seed=11)
    runs = {"dense": lambda: en.ensemble_sweeps_dense(
                state, w, cfg, cfg.proposal_a, sweeps, seed=12),
            "zsorted": lambda: en.ensemble_sweeps_zsorted(
                state, w, cfg, cfg.proposal_a, sweeps, seed=12)}
    for k in cadences:
        runs[f"zsorted/{k}"] = lambda k=k: en.ensemble_sweeps_zsorted(
            state, w, cfg, cfg.proposal_a, sweeps, seed=12,
            sweeps_per_sort=k)
    return {name: cuda_ms(fn, reps=2) for name, fn in runs.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from tpu_smc_torch.kernels import sweep as ks
    except ImportError as exc:
        print(f"chip_smoke: tpu_smc_torch not found next to the script "
              f"({exc})", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    t0 = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}",
          flush=True)
    ks.build()
    print(f"nvcc build of kernels/csrc/sweep.cu: {ks._Build.seconds:.1f} s",
          flush=True)
    print_ptxas(ks._Build.log, ks._CSRC.read_text())
    caps = {m: ks.capacity(device, m * m) for m in (3, 10)}
    print("capacity (N_pad rows, resident / streamed): "
          + ", ".join(f"M = {m}: {r} / {st}" for m, (r, st) in caps.items())
          + f", no walls: {ks.capacity(device)[0]} / {ks.capacity(device)[1]}",
          flush=True)
    phase_line("setup", t0)

    t0 = time.perf_counter()
    phase_kernel_vs_plain(device)
    phase_line("kernel vs plain", t0)

    t0 = time.perf_counter()
    phase_ladder_modes(device)
    phase_line("kernel vs plain, ladder modes", t0)

    t0 = time.perf_counter()
    phase_stream(device)
    phase_line("streamed kernel vs resident and plain", t0)

    t0 = time.perf_counter()
    phase_new_modes(device)
    phase_line("kernel vs plain, bulk, reference noise, K5, M = 10", t0)

    t0 = time.perf_counter()
    phase_xs_banded(device)
    phase_line("kernel vs plain, K1-xs and K4", t0)

    t0 = time.perf_counter()
    launches = {}
    # phase 3's N = 1024 x 512 run stays for the split run of (a) below
    kept = tempfile.TemporaryDirectory()
    launches["zskip"] = drive_cli(1024, 512, 64, 192, 3, card, MAIN_1024,
                                  keep=Path(kept.name))
    check(launches["zskip"]["zskip"] > 0 and launches["zskip"]["dense"]
          == launches["zskip"]["stream"] == 0,
          f"N=1024 main path launches {launches['zskip']}")
    launches["dense"] = drive_cli(108, 512, 200, 600, 6, card,
                                  ("176.874728", "0.979679"))
    check(launches["dense"]["dense"] > 0 and launches["dense"]["zskip"] == 0,
          f"N=108 main path launches {launches['dense']}")
    phase_line("main path, ensembles", t0)

    t0 = time.perf_counter()
    lmeas = drive_cli_measure(device, card)
    check(lmeas["zskip"] > 0 and lmeas["dense"] == lmeas["stream"] == 0,
          f"measurement run launches {lmeas}")
    lmlad, _ = drive_measure_ladder(card)
    check(lmlad["dense"] > 0 and lmlad["per_chain_at"] == lmlad["dense"],
          f"measurement ladder launches {lmlad}: dense, per-chain (A, T)")
    lumb, _ = drive_umbrella(card)
    check(not any(lumb.values()), f"umbrella launches {lumb}: the windows "
          "run on the plain engine")
    phase_line("main path, measurement layer (fields, Widom, umbrella)", t0)

    t0 = time.perf_counter()
    lsingle = drive_main_c(device, card)
    drive_single_vs_ensemble(device, card)
    ldrill = resume_drill(
        "N=1024 x 64 zsorted",
        ["64", "320", "10", "1.10", "--n", "1024", "--chains", "64",
         "--sampler", "zsorted", "--seed", "33", "--storage-time", "2"],
        card)
    check(ldrill["zskip"] > 0 and ldrill["dense"] == 0,
          f"drill N=1024 launches {ldrill}")
    ldrill1 = resume_drill(
        "N=108 single chain dense",
        ["64", "1600", "100", "1.10", "--sampler", "dense", "--seed", "33",
         "--storage-time", "20"], card)
    check(ldrill1["dense"] > 0 and ldrill1["zskip"] == 0,
          f"drill N=108 launches {ldrill1}")
    phase_line("main path, single chain and resume", t0)

    t0 = time.perf_counter()
    # (a) starts from the FCC lattice and runs 64 + 192 sweeps, too few to
    # reach equilibrium, so MBAR need not reproduce its sampled means; it
    # is held against tpu_smc's run of the same ladder instead (REF_A)
    la, _ = drive_ladder(
        ["64", "192", "3", "1.1", "--n", "1024", "--temperatures",
         "0.9,1.0,1.1,1.2,1.3,1.4,1.5,1.6", "--chains-per-t", "64",
         "--pt-exchange", "16", "--target-acceptance", "0.5",
         "--reweight", "0.9:1.6:15", "--seed", "2024"],
        "(a) ladder N=1024 8 x 64, PT, tuned A, MBAR",
        ("tsweep", "pt", "reweight"), card, ref=REF_A)
    check(la["zskip"] > 0 and la["dense"] > 0
          and la["per_chain_at"] == la["zskip"] + la["dense"],
          f"(a) launches {la}: every launch per-chain (A, T), z-skip "
          "production and dense tuning probes")
    lb, _ = drive_ladder(
        ["200", "600", "6", "1.1", "--n", "108", "--temperatures",
         "1.0,1.1,1.2,1.3", "--chains-per-t", "128", "--wall-realizations",
         "4", "--reweight", "1.0:1.3:7", "--seed", "2024"],
        "(b) disorder ladder N=108 4 x 128, 4 walls, MBAR per realization",
        ("tsweep", "reweight", "reweight_disorder"), card)
    check(lb["dense"] > 0 and lb["zskip"] == 0
          and lb["per_chain_at"] == lb["per_chain_w"] == lb["dense"],
          f"(b) launches {lb}: every launch dense with per-chain (A, T) "
          "and walls")
    ld, _ = drive_ladder(
        ["1000", "4000", "20", "1.1", "--n", "108", "--temperatures",
         "1.0,1.1,1.2,1.3", "--chains-per-t", "128", "--pt-exchange", "10",
         "--reweight", "1.0:1.3:7", "--seed", "2024"],
        "(d) PT ladder N=108 4 x 128 near equilibrium, MBAR",
        ("tsweep", "pt", "reweight"), card)
    check(ld["dense"] > 0 and ld["per_chain_at"] == ld["dense"],
          f"(d) launches {ld}: every launch dense with per-chain (A, T)")
    lc, _ = drive_disorder_ensemble(108, 512, 8, card)
    check(lc["dense"] > 0 and lc["per_chain_w"] == lc["dense"]
          and lc["per_chain_at"] == lc["zskip"] == 0,
          f"(c) launches {lc}: every launch dense with per-chain walls")
    phase_line("main path, ladders and disorder", t0)

    t0 = time.perf_counter()
    large = drive_large_n(device, card)
    large_cli = drive_cli_large(card)
    phase_line("main path, large N (streamed)", t0)

    t0 = time.perf_counter()
    lbulk = drive_bulk_full(card)
    lbulk32 = drive_bulk_vs_jax(card)
    lrn, k5_case = drive_refnoise(device, card)
    lm10 = drive_m10(card)
    phase_line("main path, bulk, reference noise, M = 10", t0)

    t0 = time.perf_counter()
    lval = drive_validation(device, card)
    phase_line("main path, validation of the engines (K1-xs, K4)", t0)

    t0 = time.perf_counter()
    phase_ensemble_family(card)
    phase_line("main path, ensemble family (GCMC, NPT, Gibbs)", t0)

    # before phase 5: a profiled process keeps CUPTI's per-launch cost
    t0 = time.perf_counter()
    lmp, lmp_ladders = phase_multiprocess(device, card)
    kept.cleanup()
    phase_line("main path, multi-process and sharded (split CLI, global "
               "ladder, per-process ladders, sharded engines, sharded "
               "drivers)", t0)

    t0 = time.perf_counter()
    cycle_split(device, card)
    cases = (
        ("sweep_dense", 108, False, {}, "tpu_smc/kernels/sweep_pallas.py:992",
         launches["dense"]["dense"] + lsingle["dense"] + lmp["dense"]),
        ("sweep_zskip", 1024, True, {}, "tpu_smc/kernels/sweep_pallas.py:306",
         launches["zskip"]["zskip"] + lsingle["zskip"] + lmeas["zskip"]
         + lmp["zskip"]),
        ("sweep_per_chain_at", 108, False, {"at": True},
         "tpu_smc/kernels/sweep_pallas.py:475",
         la["per_chain_at"] + lb["per_chain_at"] + ld["per_chain_at"]
         + lmlad["per_chain_at"] + lmp_ladders["per_chain_at"]),
        ("sweep_per_chain_w", 108, False, {"walls": 8},
         "tpu_smc/kernels/sweep_pallas.py:1064",
         lb["per_chain_w"] + lc["per_chain_w"]))
    runs, rows = {}, []
    for name, n, zskip, kw, replaces, count in cases:
        runs[name], t = kernel_case(n, 512, zskip, device, **kw)
        rows.append({"name": name, "route": "cuda",
                     "source": "tpu_smc_torch/kernels/csrc/sweep.cu",
                     "replaces": replaces, "launches": count, **t,
                     "library_ms": None})
    runs["sweep_zskip_per_chain_at"], zat = kernel_case(
        1024, 512, True, device, at=True, plain=False)
    from tpu_smc_torch.config import SMCConfig

    new = (("sweep_pbc", 4000, 128, bulk_config(4000),
            "tpu_smc/kernels/sweep_pallas.py:157",
            lbulk["pbc_z"] + lbulk32["pbc_z"] + lmp["pbc_z"]),
           ("sweep_refnoise", 108, 512,
            SMCConfig.for_n(108, reference_noise=True),
            "tpu_smc/kernels/sweep_pallas.py:57", lrn["reference_noise"]))
    new_rows = []
    for name, n, c, cfg, replaces, count in new:
        runs[name], t = kernel_case(n, c, False, device, cfg=cfg)
        new_rows.append({"name": name, "route": "cuda",
                         "source": "tpu_smc_torch/kernels/csrc/sweep.cu",
                         "replaces": replaces, "launches": count, **t,
                         "library_ms": None})
    # K1-xs at its main path's shape, the validation run's xsort 4
    runs["sweep_xskip"], t = kernel_case(1024, 256, True, device, xsort=4)
    xs_row = {"name": "sweep_xskip", "route": "cuda",
              "source": "tpu_smc_torch/kernels/csrc/sweep.cu",
              "replaces": "tpu_smc/kernels/sweep_pallas.py:344",
              "launches": lval["xskip"], **t, "library_ms": None}
    ms = interleaved_ms(runs)
    rows.append({"name": "sweep_stream", "route": "cuda",
                 "source": "tpu_smc_torch/kernels/csrc/sweep.cu",
                 "replaces": "tpu_smc/kernels/sweep_pallas.py:1153",
                 "launches": large["stream"] + large_cli["stream"]
                 + lmp["stream"],
                 **stream_case(device, card), "library_ms": None})
    for row, (_, n, *_) in zip(rows[:len(cases)], cases):
        row["ms"] = ms[row["name"]]
        print(f"  {row['name']} N={n} x 512, 2 sweeps: kernel "
              f"{row['ms']:.3f} ms, plain {row['plain_ms']:.1f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), max |dx| "
              f"{row['max_abs_err']:.3g} ({card})", flush=True)
    for row, (_, n, c, *_) in zip(new_rows, new):
        row["ms"] = ms[row["name"]]
        print(f"  {row['name']} N={n} x {c}, 2 sweeps: kernel "
              f"{row['ms']:.3f} ms ({row['ms'] / ms['sweep_dense'] - 1:+.1%} "
              f"against sweep_dense N=108 x 512 in the same turns), plain "
              f"{row['plain_ms']:.1f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), max |dx| {row['max_abs_err']:.3g} "
              f"({card})", flush=True)
    rows += new_rows
    rows.append({"name": "debug_reference_noise", "route": "cuda",
                 "source": "tpu_smc_torch/kernels/csrc/sweep.cu",
                 "replaces": "tpu_smc/kernels/sweep_pallas.py:81",
                 "launches": lrn["debug_reference_noise"],
                 **noise_case(device, *k5_case, card), "library_ms": None})
    xs_row["ms"] = ms["sweep_xskip"]
    print(f"  sweep_xskip k=4 N=1024 x 256, 2 sweeps: kernel "
          f"{xs_row['ms']:.3f} ms, plain {xs_row['plain_ms']:.1f} ms, bound "
          f"{xs_row['bound_ms']:.4f} ms ({xs_row['bound_by']}), max |dx| "
          f"{xs_row['max_abs_err']:.3g} ({card})", flush=True)
    rows.append(xs_row)
    xsort_probe(device, card)
    rows.append({"name": "sweep_banded", "route": "cuda",
                 "source": "tpu_smc_torch/kernels/csrc/sweep.cu",
                 "replaces": "tpu_smc/kernels/sweep_banded.py:308",
                 "launches": lval["banded"], **banded_case(device, card),
                 "library_ms": None})
    print(f"  sweep_zskip per-chain (A, T) N=1024 x 512, 2 sweeps: kernel "
          f"{ms['sweep_zskip_per_chain_at']:.3f} ms, bound "
          f"{zat['bound_ms']:.4f} ms ({card})", flush=True)
    print(f"  per-chain against uniform, same call: dense (A, T) "
          f"{ms['sweep_per_chain_at'] / ms['sweep_dense'] - 1:+.1%}, "
          f"walls {ms['sweep_per_chain_w'] / ms['sweep_dense'] - 1:+.1%}, "
          f"z-skip (A, T) "
          f"{ms['sweep_zskip_per_chain_at'] / ms['sweep_zskip'] - 1:+.1%}",
          flush=True)
    cfg, _, args, _ = kernel_inputs(1024, 512, device)
    print(f"  dense mode N=1024 x 512 on unsorted rows, 2 sweeps: kernel "
          f"{cuda_ms(lambda: ks.sweep_block(*args, cfg, 2, cfg.proposal_a)):.3f}"
          f" ms ({card})", flush=True)
    for n in (512, 1024):
        e = engine_ms(n, 512, device)
        print(f"  engines N={n} x 512, 16 sweeps: dense {e['dense']:.3f} ms, "
              f"zsorted {e['zsorted']:.3f} ms ({card})", flush=True)
    e = engine_ms(1024, 512, device, sweeps=32, cadences=(8, 16))
    print(f"  engines N=1024 x 512, 32 sweeps: dense {e['dense']:.3f} ms; "
          f"zsorted sorting every " + ", ".join(
              f"{k} sweeps {e[f'zsorted/{k}']:.3f} ms" for k in (8, 16))
          + f" ({card})", flush=True)
    phase_line("timing", t0)

    # last: a profiled process keeps CUPTI's per-launch cost, which the
    # timing above must not pay
    t0 = time.perf_counter()
    lprof = phase_tooling(device, card)
    phase_line("main path, diagnostics and tooling (trace, cost model, "
               "checked sweep, analysis, example)", t0)
    next(r for r in rows if r["name"] == "sweep_zskip")["launches"] += \
        lprof["zskip"]

    check(lm10["dense"] > 0, f"M=10 launches {lm10}")
    check(not FAILED, f"{len(FAILED)} main-path checks failed: {FAILED}")
    print("kernels: " + ", ".join(r["name"] for r in rows))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Failure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        code = 1
    sys.exit(code)
