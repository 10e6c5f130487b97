#!/usr/bin/env python3
"""chip_smoke.py's ensemble-family phase alone, on the card, with every
run's sweep counts scaled by --scale (widths unchanged): the quick way to
time the GCMC, NPT and Gibbs runs and to size their depths.

    python3 scripts/probe_ensemble_family.py --scale 0.1

Prints chip_smoke's lines for each run (chain-sweeps/s, the wall-time
split, the gates' values) and the failed statistical gates, which short
depths are expected to miss; exits non-zero on a hard failure.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args()
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("probe_ensemble_family: no CUDA device", file=sys.stderr)
        return 1
    for k, v in cs.ENS_DEPTH.items():
        cs.ENS_DEPTH[k] = (tuple(max(1, round(x * args.scale)) for x in v)
                           if isinstance(v, tuple)
                           else max(2, round(v * args.scale)))
    if cs.ENS_DEPTH["gcmc_split"] <= cs.ENS_DEPTH["gcmc"][0]:
        cs.ENS_DEPTH["gcmc_split"] = cs.ENS_DEPTH["gcmc"][0] + 1
    print(f"depths {cs.ENS_DEPTH}", flush=True)
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    cs.phase_ensemble_family(card)
    print(f"phase: {time.perf_counter() - t0:.1f} s; failed gates: "
          f"{cs.FAILED}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
