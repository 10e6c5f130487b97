#!/usr/bin/env python3
"""On-card check of tpu_smc_torch: builds the CUDA kernel, holds it against
its plain PyTorch version, and drives the NVT chain-ensemble CLI at full
width (N = 1024 x 512 chains, and N = 108 x 512 chains).

    python3 chip_smoke.py

Needs one CUDA device and nvcc; imports neither jax nor tpu_smc. Phases:

  1. setup: card name and power limit, versions, cold nvcc build;
  2. kernel vs plain, dense and z-skip, at N = 108 x 64 and N = 1024 x 128
     chains, 2 sweeps, identical Philox draws (the plain version's exact
     mode): uniforms bitwise equal and inside (0, 1), accept decisions and
     positions/energies equal within the stated tolerances except chains
     whose trajectory passed a near-tie move, z-skip on/off bitwise equal
     on the same row order, determinism, carried energy vs recompute;
  3. the main path: `tpu_smc_torch.cli.main` at N = 1024 x 512 chains
     (auto -> zsorted, z-skip launches) and N = 108 x 512 (auto -> dense),
     launch counts reset before and read after each, the plain version
     barred;
  4. at the main path's shapes (N = 108 x 512 dense, N = 1024 x 512
     z-skip): kernel vs plain as in phase 2, kernel and plain times and
     the bound; dense mode at N = 1024 x 512 beside z-skip; and the dense
     and zsorted engines at N = 256 ... 2048 x 512, behind auto routing,
     and the zsorted engine at sort cadences 4 ... 32 (N = 1024 x 512).

Each phase prints its elapsed seconds; any failure exits non-zero before
the result lines. The last two lines are the kernel table (JSON) and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
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
# powers 3, u/dv terms 3, four accumulations 7), and the fixed work of a
# move (two wall evaluations of 9 sites + the planar term, Box-Muller,
# proposal and acceptance), counting an FMA as 2.
FLOPS_PER_ROW = 31
FLOPS_PER_MOVE = 540

POS_TOL = 1e-2         # |dx| between kernel and plain on agreeing chains
E_ATOL, E_RTOL = 5e-2, 1e-4   # energies, kernel vs plain and vs recompute
TIE_MARGIN = 1e-3      # |min(log_ap, 0) - log u| of a near-tie move
MAX_DIVERGED = 0.05    # share of chains a near-tie may have flipped


class Failure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise Failure(msg)


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
                  sort: bool = False):
    """Planes of an FCC-started ensemble, advanced one sweep on the plain
    engine so the chains differ, plus the per-sweep draws of `sweeps`."""
    from tpu_smc_torch import ensemble as en
    from tpu_smc_torch.config import SMCConfig
    from tpu_smc_torch.kernels import sweep as ks
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    cfg = SMCConfig.for_n(n)
    state, w = init_ensemble_state(cfg, seed_words(seed), c, device=device)
    state, _ = en.ensemble_sweeps_dense(state, w, cfg, cfg.proposal_a, 1,
                                        seed=seed)
    words, offsets = en._per_sweep_randomness(state, cfg, seed + 1, sweeps)
    x, y, z, e, wa, wb = en._kernel_inputs(state, w, cfg)
    if sort:
        perm = torch.argsort(z[:n], dim=0, stable=True)
        x, y, z = (torch.cat([torch.take_along_dim(p[:n], perm, 0), p[n:]])
                   for p in (x, y, z))
    return cfg, w, (x, y, z, e, wa, wb, offsets, words), ks


def compare(cfg, w, args, ks, zskip: bool, label: str):
    """Kernel vs plain (exact Philox) on the same inputs. Returns the
    kernel's outputs, the largest position error over chains whose
    trajectories agree, the plain version's wall ms (diagnostics included)
    and the kernel's visited pair rows [C]."""
    from tpu_smc_torch.potentials import total_energy

    sweeps = args[-1].shape[0]
    dk = {"uniforms": True}
    outk = ks.sweep_block(*args, cfg, sweeps, cfg.proposal_a, zskip=zskip,
                          diag=dk)
    dp = {"uniforms": True, "tie_margin": TIE_MARGIN}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outp = ks.sweep_block_plain(*args, cfg, sweeps, cfg.proposal_a,
                                zskip=zskip, diag=dp)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    uk, up = dk["uniforms"], dp["uniforms"]
    check(torch.equal(uk, up), f"{label}: kernel uniforms != plain Philox")
    check(bool(((uk > 0) & (uk < 1)).all()), f"{label}: uniform outside (0,1)")

    c = args[0].shape[1]
    dpos = torch.stack([(outk[k] - outp[k])[:cfg.n].abs().amax(0)
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
    # carried energy against a from-scratch recompute
    r = ks.from_planes(outk[0], outk[1], outk[2], cfg)
    exact = total_energy(r, w.to(torch.float32), cfg)
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


# ----------------------------------------------------------------------
# Phase 3: the main path through the CLI
# ----------------------------------------------------------------------

STEMS_RANK = ("positions", "data", "local", "total_clusters",
              "autocorrelation")
STEMS_SHARED = ("wall", "data_ensemble", "info", "last_state")


def drive_cli(n: int, chains: int, eq: int, mx: int, num: int, card: str):
    """cli.main at (n, chains) into a temporary data dir, with the kernel's
    plain version made to fail if called; checks the CSV set and the
    summary; prints where the run's wall time went; returns the run's
    launch counts."""
    from tpu_smc_torch import cli
    from tpu_smc_torch import driver_ensemble as de
    from tpu_smc_torch.config import SMCConfig
    from tpu_smc_torch.kernels import sweep as ks

    with tempfile.TemporaryDirectory() as tmp:
        for k in ks.sweep_block.launches:
            ks.sweep_block.launches[k] = 0
        plain = ks.sweep_block_plain

        def refuse(*args, **kw):
            raise Failure("the plain version ran on the main path")

        ks.sweep_block_plain = refuse
        simulate = de.simulate_ensemble
        sim = {}

        def timed_simulate(*args, **kw):
            sim["t0"] = time.perf_counter()
            out = simulate(*args, **kw)
            torch.cuda.synchronize()
            sim["t1"] = time.perf_counter()
            sim["sps"] = out[1].sweeps_per_second
            return out

        de.simulate_ensemble = timed_simulate
        t0 = time.perf_counter()
        try:
            rc = cli.main([str(eq), str(mx), str(num), "1.1", "--n", str(n),
                           "--chains", str(chains), "--sampler", "auto",
                           "--seed", "2024", "--lca-time", "2",
                           "--data-dir", tmp])
        finally:
            ks.sweep_block_plain = plain
            de.simulate_ensemble = simulate
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(ks.sweep_block.launches)
        check(rc == 0, f"cli.main returned {rc}")
        cfg = SMCConfig.for_n(n)
        d = Path(tmp) / cfg.run_name()
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
        info = (d / f"info_{key}.csv").read_text()
        mean_e = float(info.split("Mean energy: ")[1].split(" ")[0])
        acc = float(info.split("Average acceptance ratio: ")[1].split()[0])
        kinetic = 1.5 * n * 1.1
        check(math.isfinite(mean_e) and kinetic - 6 * n < mean_e
              < kinetic + n, f"mean energy {mean_e} out of range")
        check(0.3 < acc <= 1.0, f"acceptance {acc} out of range")
    rate = (eq + mx) * chains / dt
    loop = mx * chains / sim["sps"]
    print(f"  N={n} x {chains} chains: {dt:.1f} s, mean E {mean_e:.3f}, "
          f"acceptance {acc:.4f}, {rate:,.0f} chain-sweeps/s end to end "
          f"incl. observables and CSVs ({card})", flush=True)
    print(f"  N={n} wall time: {sim['t0'] - t0:.3f} s before "
          f"simulate_ensemble (walls, state), "
          f"{sim['t1'] - sim['t0'] - loop:.3f} s in it outside the gather "
          f"loop (thermalization, post-processing), {loop:.3f} s gather "
          f"loop (incl. per-window positions CSV), "
          f"{t0 + dt - sim['t1']:.3f} s after it (per-chain CSVs)",
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


def time_kernel(n: int, c: int, zskip: bool, device, sweeps: int = 2):
    """At the main path's shape (n, c): kernel vs plain on the same inputs
    (phase 2's comparison), the kernel's ms, the plain version's ms and
    the bound of this run's work."""
    cfg, w, args, ks = kernel_inputs(n, c, device, sweeps=sweeps,
                                     sort=zskip)
    mode = "zskip" if zskip else "dense"
    cmp = compare(cfg, w, args, ks, zskip, f"{mode} N={n} C={c}")
    ms = cuda_ms(lambda: ks.sweep_block(*args, cfg, sweeps, cfg.proposal_a,
                                        zskip=zskip))
    n_pad = args[0].shape[0]
    nbytes = 4 * (2 * (3 * n_pad * c + c) + 2 * 128 + 3 * sweeps
                  + 2 * sweeps * c)
    flops = (FLOPS_PER_ROW * float(cmp["visited"].double().sum())
             + FLOPS_PER_MOVE * sweeps * n * c)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return dict(max_abs_err=cmp["max_err"], ms=ms, plain_ms=cmp["plain_ms"],
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations")


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
    for line in ks._Build.log.splitlines():
        if "registers" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    phase_line("setup", t0)

    t0 = time.perf_counter()
    phase_kernel_vs_plain(device)
    phase_line("kernel vs plain", t0)

    t0 = time.perf_counter()
    launches = {}
    launches["zskip"] = drive_cli(1024, 512, 64, 192, 3, card)
    check(launches["zskip"]["zskip"] > 0 and launches["zskip"]["dense"] == 0,
          f"N=1024 main path launches {launches['zskip']}")
    launches["dense"] = drive_cli(108, 512, 200, 600, 6, card)
    check(launches["dense"]["dense"] > 0 and launches["dense"]["zskip"] == 0,
          f"N=108 main path launches {launches['dense']}")
    phase_line("main path", t0)

    t0 = time.perf_counter()
    rows = []
    for name, n, zskip, replaces in (
            ("sweep_dense", 108, False,
             "tpu_smc/kernels/sweep_pallas.py:992"),
            ("sweep_zskip", 1024, True,
             "tpu_smc/kernels/sweep_pallas.py:306")):
        t = time_kernel(n, 512, zskip, device)
        mode = "zskip" if zskip else "dense"
        rows.append({"name": name, "route": "cuda",
                     "source": "tpu_smc_torch/kernels/csrc/sweep.cu",
                     "replaces": replaces,
                     "launches": launches[mode][mode], **t,
                     "library_ms": None})
        print(f"  {name} N={n} x 512, 2 sweeps: kernel {t['ms']:.3f} ms, "
              f"plain {t['plain_ms']:.1f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), max |dx| {t['max_abs_err']:.3g} "
              f"({card})", flush=True)
    cfg, _, args, _ = kernel_inputs(1024, 512, device)
    ms = cuda_ms(lambda: ks.sweep_block(*args, cfg, 2, cfg.proposal_a))
    print(f"  dense mode N=1024 x 512 on unsorted rows, 2 sweeps: kernel "
          f"{ms:.3f} ms ({card})", flush=True)
    for n in (256, 512, 1024, 2048):
        e = engine_ms(n, 512, device)
        print(f"  engines N={n} x 512, 16 sweeps: dense {e['dense']:.3f} ms, "
              f"zsorted {e['zsorted']:.3f} ms ({card})", flush=True)
    e = engine_ms(1024, 512, device, sweeps=32, cadences=(4, 8, 16, 32))
    print(f"  engines N=1024 x 512, 32 sweeps: dense {e['dense']:.3f} ms; "
          f"zsorted sorting every " + ", ".join(
              f"{k} sweeps {e[f'zsorted/{k}']:.3f} ms" for k in (4, 8, 16, 32))
          + f" ({card})", flush=True)
    phase_line("timing", t0)

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
