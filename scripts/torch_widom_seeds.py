#!/usr/bin/env python3
"""The port's N = 108 PT ladder with Widom insertion over the seeds that
scripts/measurement_reference.py gives tpu_smc (LADDER_SEEDS), on the
card: per level, the port's mu_ex of each seed, their mean and their
standard deviation across the seeds (ddof 1), beside tpu_smc's (the
reference's numbers as chip_smoke records them, REF_WIDOM), and the
difference of the two means in units of its standard error
(sd_port^2 / n_port + sd_tpu_smc^2 / n_tpu_smc)^(1/2). Settles whether
the port's mu_ex sits above tpu_smc's by an offset or by scatter.

    python3 scripts/torch_widom_seeds.py [--chains-per-t 128]
        [--seeds 2024,7,11,13,17,19,23,29] [--reference REF.json]

--reference takes the JSON that `python scripts/measurement_reference.py
--only ladder --seeds ...` prints for further tpu_smc seeds; they are
pooled with REF_WIDOM's (means and standard deviations combined).

The ladder is chip_smoke's "measurement ladder" (`200 800 8 1.1 --n 108
--temperatures 1.0,1.2,1.4,1.6 --pt-exchange 16 --reweight 1.0:1.6:7
--z-bins 32 --gr-bins 32 --sk-kmax 4 --widom 32`), through
tpu_smc_torch.cli.main in-process into temporary data dirs. Prints one
JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LADDER = ["200", "800", "8", "1.1", "--n", "108", "--temperatures",
          "1.0,1.2,1.4,1.6", "--pt-exchange", "16", "--reweight",
          "1.0:1.6:7", "--z-bins", "32", "--gr-bins", "32", "--sk-kmax",
          "4", "--widom", "32"]
SEEDS = (2024, 7, 11, 13)      # measurement_reference.LADDER_SEEDS


def main() -> int:
    import numpy as np

    import chip_smoke
    from tpu_smc_torch import cli

    ap = argparse.ArgumentParser()
    ap.add_argument("--chains-per-t", type=int, default=128)
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    ap.add_argument("--reference", default=None)
    args = ap.parse_args()
    runs = []
    for seed in [int(v) for v in args.seeds.split(",")]:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(buf):
            rc = cli.main(LADDER + ["--chains-per-t",
                                    str(args.chains_per_t), "--seed",
                                    str(seed), "--data-dir", tmp])
        if rc:
            raise SystemExit(f"seed {seed}: cli.main returned {rc}")
        rows = re.findall(r"T ([0-9.]+): mu_ex = (-?[0-9.]+) ± ([0-9.]+)",
                          buf.getvalue())
        runs.append({"seed": seed, "T": [float(r[0]) for r in rows],
                     "mu_ex": [float(r[1]) for r in rows],
                     "mu_ex_err": [float(r[2]) for r in rows],
                     "s": round(time.perf_counter() - t0, 1)})
        print(json.dumps(runs[-1]), file=sys.stderr, flush=True)
    mu = np.asarray([r["mu_ex"] for r in runs])
    ref = dict(chip_smoke.REF_WIDOM)
    ref_m, ref_sd = np.asarray(ref["mu_ex"]), np.asarray(ref["sd"])
    if args.reference:
        more = np.asarray([r["mu_ex"] for r in json.loads(
            Path(args.reference).read_text())["ladder"]["runs"]])
        n1, n2 = ref["seeds"], len(more)
        m2 = more.mean(0)
        pooled = (n1 * ref_m + n2 * m2) / (n1 + n2)
        ss = ((n1 - 1) * ref_sd ** 2 + ((more - m2) ** 2).sum(0)
              + n1 * (ref_m - pooled) ** 2 + n2 * (m2 - pooled) ** 2)
        ref_m, ref_sd = pooled, np.sqrt(ss / (n1 + n2 - 1))
        ref = {"mu_ex": ref_m.tolist(), "sd": ref_sd.tolist(),
               "seeds": n1 + n2}
    m, sd = mu.mean(0), mu.std(0, ddof=1)
    se = np.sqrt(sd ** 2 / len(runs) + ref_sd ** 2 / ref["seeds"])
    z = (m - ref_m) / se
    print(json.dumps({
        "argv": LADDER + ["--chains-per-t", str(args.chains_per_t)],
        "card": chip_smoke.card_line(), "runs": runs, "T": runs[0]["T"],
        "mean": m.tolist(), "sd": sd.tolist(),
        "tpu_smc": {"mean": ref_m.tolist(), "sd": ref_sd.tolist(),
                    "seeds": ref["seeds"]},
        "diff": (m - ref_m).tolist(), "z": z.tolist()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
