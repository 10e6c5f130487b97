#!/usr/bin/env python3
"""A CLI run in one process against the same run split over two
--coordinator ranks of 8 chains each: every CSV compared byte for byte
and, for the `data` CSVs that differ, the largest difference of each
column (E, P, jj) and of E relative.

    python3 scripts/torch_rank_split.py [--root DIR] [--device cpu]

Two runs of 16 chains at N = 108: the reference slab (a dilute gas, whose
rows of pair terms hold few nonzero terms) and the bulk fluid at rho 0.5
(every row full). --root: the checkout whose tpu_smc_torch runs (another
commit unpacked from `git archive`; default this one). The ranks share
the card (or the CPU with --device cpu) and talk over gloo on
127.0.0.1. Imports neither jax nor tpu_smc.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

RUNS = (
    ("slab N=108 x 16", ["200", "600", "6", "1.1", "--n", "108", "--chains",
                         "16", "--seed", "2024"]),
    ("bulk N=108 x 16, rho 0.5", ["200", "600", "6", "1.5", "--bulk", "--n",
                                  "108", "--rho", "0.5", "--lj-cutoff", "2.5",
                                  "--gamma", "0.01", "--chains", "16",
                                  "--seed", "2024"]))
TIMEOUT = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(root: Path, argv, nproc: int, data: Path) -> None:
    """`python -m tpu_smc_torch argv` in one process or as nproc ranks;
    every process must exit 0 within TIMEOUT s (all killed otherwise)."""
    env = dict(os.environ, PYTHONPATH=str(root))
    base = [sys.executable, "-m", "tpu_smc_torch", *argv, "--data-dir",
            str(data)]
    if nproc > 1:
        base += ["--coordinator", f"127.0.0.1:{free_port()}",
                 "--num-processes", str(nproc)]
    procs = [subprocess.Popen(
        base + (["--process-id", str(i)] if nproc > 1 else []), cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(nproc)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        if p.returncode:
            raise SystemExit(f"exit {p.returncode}: {out[-2000:]}")


def compare(one: Path, two: Path) -> None:
    a = {p.relative_to(one): p.read_bytes() for p in one.rglob("*.csv")}
    b = {p.relative_to(two): p.read_bytes() for p in two.rglob("*.csv")}
    diff = sorted(str(k) for k in set(a) | set(b) if a.get(k) != b.get(k))
    print(f"  {len(a)} CSVs, {len(diff)} differ"
          + (f": {diff[:6]}{' ...' if len(diff) > 6 else ''}" if diff
             else " (byte-identical)"), flush=True)
    for name in diff:
        if not Path(name).name.startswith("data_"):
            continue
        x = np.genfromtxt(one / name, delimiter=",", skip_header=1)
        y = np.genfromtxt(two / name, delimiter=",", skip_header=1)
        d = np.nanmax(np.abs(x - y), axis=0)
        rel = float(np.nanmax(np.abs(x[:, 0] - y[:, 0]) / np.abs(x[:, 0])))
        print(f"  {Path(name).name}: largest |difference| per column "
              f"{[float(v) for v in d]}, E relative {rel:.3g}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    root = args.root.resolve()
    extra = ["--device", "cpu"] if args.device == "cpu" else []
    print(f"tpu_smc_torch from {root}", flush=True)
    for label, argv in RUNS:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            run(root, argv + extra, 1, tmp / "one")
            run(root, argv + extra, 2, tmp / "two")
            print(f"{label}, one process against 2 ranks:", flush=True)
            compare(tmp / "one", tmp / "two")
    return 0


if __name__ == "__main__":
    sys.exit(main())
