"""Parallel tempering: the temperature ladder with replica exchange
(tpu_smc_torch/pt.py; the counterpart of examples/parallel_tempering.py).

Each of the `chains_per_t` independent ladders attempts configuration
swaps between adjacent temperatures every `exchange_interval` sweeps —
low-T chains escape local minima through the high-T end, something the
reference's zero-communication replica model cannot express. On the card
the sweeps run through the whole-sweep kernel with per-chain (A, T) rows
(K1-at, sampler "dense"); the exchange itself is a handful of tensor ops.

    python examples/torch_parallel_tempering.py [--device cuda|cpu]
        [--chains-per-t C] [--scale S]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from tpu_smc_torch.config import RunParams, SMCConfig
from tpu_smc_torch.pt import simulate_parallel_tempering
from tpu_smc_torch.state import seed_words


def main(argv=None):
    ap = argparse.ArgumentParser(description="parallel tempering")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--chains-per-t", type=int, default=16)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every sweep and gather count")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    cfg = SMCConfig(dtype="float32")
    params = RunParams(eqsteps=max(10, round(2000 * args.scale)),
                       maxsteps=max(10, round(10000 * args.scale)),
                       numdata=max(1, round(1000 * args.scale)))
    temps = np.linspace(0.7, 1.6, 8)
    sampler = "dense" if args.device == "cuda" else "torch"

    _, res = simulate_parallel_tempering(
        cfg, params, temps, seed_words(0), chains_per_t=args.chains_per_t,
        exchange_interval=10, sampler=sampler, device=args.device)

    ts = res.tsweep
    print("T        E_mean      +-err     acc      cv")
    for i, t in enumerate(ts.temps):
        print(f"{t:0.3f}  {ts.mean_energy[i]:10.4f}  "
              f"{ts.err_energy[i]:8.4f}  {ts.acceptance[i]:0.4f}  "
              f"{ts.cv[i]:8.4f}")
    print("\npair swap acceptance (healthy ladders sit around 0.2-0.9):")
    for i in range(len(res.pair_t_lo)):
        print(f"  {res.pair_t_lo[i]:0.3f} <-> {res.pair_t_hi[i]:0.3f}: "
              f"{res.swap_acceptance[i]:0.3f}")
    return res


if __name__ == "__main__":
    main()
