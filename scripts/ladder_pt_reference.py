#!/usr/bin/env python
"""tpu_smc's temperature-ladder CLI on the CPU, reduced to the numbers
that the port's chip_smoke.py holds its own ladder run (a) against.

Runs `python -m tpu_smc EQ MAX NUM T ... --platform cpu --sampler xla`
in-process into a temporary data dir, reads the tsweep and reweight
CSVs, and prints one JSON object: per ladder temperature the sampled
mean E and its replica error bar, and MBAR's E at that temperature and
its bootstrap error bar. Where MBAR and the sampled means disagree on a
run that is not stationary, this is the reference's own disagreement.

    python scripts/ladder_pt_reference.py               # chip_smoke's (a)
    python scripts/ladder_pt_reference.py -- 64 192 3 1.1 --n 1024 ...

(a) at 8 x 64 chains takes about 40 min on 8 CPU cores.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RUN_A = ["64", "192", "3", "1.1", "--n", "1024", "--temperatures",
         "0.9,1.0,1.1,1.2,1.3,1.4,1.5,1.6", "--chains-per-t", "64",
         "--pt-exchange", "16", "--target-acceptance", "0.5",
         "--reweight", "0.9:1.6:15", "--seed", "2024"]


def rows(path: Path):
    lines = path.read_text().splitlines()[1:]
    return [[float(v) for v in ln.split(",")] for ln in lines]


def main() -> int:
    argv = sys.argv[1:]
    if argv[:1] == ["--"]:
        argv = argv[1:]
    argv = argv or RUN_A
    from tpu_smc import cli
    from tpu_smc.config import SMCConfig

    n = int(argv[argv.index("--n") + 1])
    temps = [float(v) for v in
             argv[argv.index("--temperatures") + 1].split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        rc = cli.main(argv + ["--platform", "cpu", "--sampler", "xla",
                              "--data-dir", tmp])
        if rc:
            return rc
        cfg = SMCConfig.for_n(n, temperature=float(argv[3]))
        d = Path(tmp) / cfg.run_name()
        ts = rows(d / f"tsweep_{cfg.file_key()}.csv")
        rw = rows(d / f"reweight_{cfg.file_key()}.csv")
    mbar = {round(r[0], 6): r for r in rw}
    out = {"argv": argv, "T": temps, "E": [r[1] for r in ts],
           "E_err": [r[2] for r in ts],
           "mbar_E": [mbar[round(t, 6)][1] for t in temps],
           "mbar_err": [mbar[round(t, 6)][2] for t in temps]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
