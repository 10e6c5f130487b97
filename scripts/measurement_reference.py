#!/usr/bin/env python
"""tpu_smc's measurement-layer runs on the CPU, over several seeds,
reduced to the numbers that the port's chip_smoke.py holds its own runs
against (REF_WIDOM and REF_UMBRELLA there).

  ladder   `python -m tpu_smc 200 800 8 1.1 --n 108 --temperatures
           1.0,1.2,1.4,1.6 --chains-per-t C --pt-exchange 16 --reweight
           1.0:1.6:7 --z-bins 32 --gr-bins 32 --sk-kmax 4 --widom 32
           --seed S`: per level, Widom's mu_ex and its bootstrap error
           over the chains (tpu_smc.widom.mu_ex on the run's paired
           samples, as its CLI prints them);
  umbrella `python -m tpu_smc 200 800 80 1.1 --umbrella=-99:-92:8
           --umbrella-replicas 8 --umbrella-exchange 10 --seed S`: the
           MBAR-unbiased PMF of the run's samples on the fixed grid
           UMBRELLA_GRID (tpu_smc.umbrella.umbrella_pmf with z_range),
           shifted to zero mean over the grid (F is defined up to a
           constant), with its bootstrap error over the replicas.

For each, one run per seed S; the JSON object printed holds every run's
values, their mean over the seeds and their standard deviation across
the seeds (ddof 1): the scatter of a single run, which bootstrap errors
may understate. An umbrella run whose own PMF fails (a configuration
that stays far from every window, so that every MBAR weight lands
outside the grid) is recorded with its far samples and left out.

Both run in-process through tpu_smc's CLI (`--platform cpu --sampler
xla`) into temporary data dirs.

    python scripts/measurement_reference.py --only ladder
    python scripts/measurement_reference.py --only umbrella --seeds 1,2

chip_smoke's port runs use 128 chains per level; a smaller C here only
widens the reference's scatter. About 11 min (ladder, 4 seeds at C =
128) and 5 min (umbrella, 8 seeds) on 8 CPU cores.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LADDER = ["200", "800", "8", "1.1", "--n", "108", "--temperatures",
          "1.0,1.2,1.4,1.6", "--pt-exchange", "16", "--reweight",
          "1.0:1.6:7", "--z-bins", "32", "--gr-bins", "32", "--sk-kmax",
          "4", "--widom", "32"]
UMBRELLA = ["200", "800", "80", "1.1", "--umbrella=-99:-92:8",
            "--umbrella-replicas", "8", "--umbrella-exchange", "10"]
UMBRELLA_GRID = (-99.5, -91.5, 16)     # z_min, z_max, bins
UMBRELLA_BOOT = 64
LADDER_SEEDS = (2024, 7, 11, 13)
UMBRELLA_SEEDS = (2024, 7, 11, 13, 17, 19, 23, 29)


def run_cli(argv):
    """tpu_smc.cli.main(argv) on the CPU into a temporary data dir;
    returns its standard output."""
    from tpu_smc import cli

    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--platform", "cpu", "--sampler", "xla",
                              "--data-dir", tmp])
    if rc:
        raise SystemExit(f"tpu_smc returned {rc}")
    return buf.getvalue()


def summary(runs: list, key: str) -> dict:
    import numpy as np

    v = np.asarray([r[key] for r in runs], np.float64)
    return {"mean": np.nanmean(v, axis=0).tolist(),
            "sd": np.nanstd(v, axis=0, ddof=1).tolist()}


def ladder(cpt: int, seeds) -> dict:
    runs = []
    for seed in seeds:
        out = run_cli(LADDER + ["--chains-per-t", str(cpt), "--seed",
                                str(seed)])
        rows = re.findall(r"T ([0-9.]+): mu_ex = (-?[0-9.]+) ± ([0-9.]+)",
                          out)
        runs.append({"seed": seed, "T": [float(r[0]) for r in rows],
                     "mu_ex": [float(r[1]) for r in rows],
                     "mu_ex_err": [float(r[2]) for r in rows]})
    return {"argv": LADDER + ["--chains-per-t", str(cpt)], "runs": runs,
            "T": runs[0]["T"], "seeds": len(runs), **summary(runs, "mu_ex")}


def umbrella(seeds) -> dict:
    import numpy as np

    from tpu_smc import umbrella as um

    lo, hi, nb = UMBRELLA_GRID
    runs = []
    for seed in seeds:
        seen = {}
        simulate = um.simulate_umbrella

        def capture(*args, **kw):
            seen["out"] = simulate(*args, **kw)
            return seen["out"]

        um.simulate_umbrella = capture
        try:
            out = run_cli(UMBRELLA + ["--seed", str(seed)])
            pmf = um.umbrella_pmf(seen["out"][1], n_bins=nb,
                                  z_range=(lo, hi), n_boot=UMBRELLA_BOOT,
                                  seed=0)
        except ValueError as exc:
            out, pmf = str(exc), None
        finally:
            um.simulate_umbrella = simulate
        res = seen["out"][1]
        if pmf is None:
            # the PMF fails when a configuration stays far from every
            # window (a frozen dimer, PERF.md §7): every MBAR weight lands
            # outside the grid. Recorded, and left out of the mean.
            far = np.abs(res.z_samples - res.centers[None, :, None]) > 3.0
            runs.append({"seed": seed, "error": out,
                         "far_samples": int(far.sum()),
                         "far_z": sorted({round(float(v), 4)
                                          for v in res.z_samples[far]})[:4]})
            continue
        f = pmf.pmf - np.nanmean(pmf.pmf)
        runs.append({"seed": seed, "F": f.tolist(),
                     "F_err": pmf.err_pmf.tolist(),
                     "swap_acceptance": [float(s) for s in re.findall(
                         r"<-> -?[0-9.]+: ([0-9.]+)", out)]})
    zc = (lo + (hi - lo) / nb * (np.arange(nb) + 0.5)).tolist()
    ok = [r for r in runs if "F" in r]
    return {"argv": UMBRELLA, "grid": list(UMBRELLA_GRID),
            "n_boot": UMBRELLA_BOOT, "z": zc, "runs": runs,
            "seeds": len(ok), **summary(ok, "F")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains-per-t", type=int, default=128)
    ap.add_argument("--only", choices=("ladder", "umbrella"), default=None)
    ap.add_argument("--seeds", default=None,
                    help="comma list (default: LADDER_SEEDS / "
                         "UMBRELLA_SEEDS)")
    args = ap.parse_args()
    pick = ([int(s) for s in args.seeds.split(",")] if args.seeds
            else None)
    out = {}
    if args.only in (None, "ladder"):
        out["ladder"] = ladder(args.chains_per_t, pick or LADDER_SEEDS)
    if args.only in (None, "umbrella"):
        out["umbrella"] = umbrella(pick or UMBRELLA_SEEDS)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
