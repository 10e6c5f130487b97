"""Example: a 256-chain molecule-surface ensemble with observables on the
card, through the port's Python API (the CLI equivalent is
`python -m tpu_smc_torch 500 2000 100 1.1 --chains 256 --gr-bins 64
--z-bins 64`; the counterpart of examples/run_ensemble.py).

Run: python examples/torch_run_ensemble.py [--device cuda|cpu]
     [--chains C] [--scale S]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from tpu_smc_torch.config import RunParams, SMCConfig
from tpu_smc_torch.driver import ObservableOptions
from tpu_smc_torch.driver_ensemble import simulate_ensemble
from tpu_smc_torch.state import init_ensemble_state, seed_words


def main(argv=None):
    ap = argparse.ArgumentParser(description="256-chain NVT ensemble")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every sweep and gather count (0.1: a "
                         "quick look)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    cfg = SMCConfig(dtype="float32")          # N=108 molecule-surface system
    params = RunParams(eqsteps=max(1, round(500 * args.scale)),
                       maxsteps=max(1, round(2000 * args.scale)),
                       numdata=max(1, round(100 * args.scale)))
    n_chains = args.chains

    state, w = init_ensemble_state(cfg, seed_words(0), n_chains,
                                   device=args.device)
    # the whole-sweep kernel (K1) on the card, the plain engine elsewhere
    sampler = "dense" if args.device == "cuda" else "torch"
    state, res = simulate_ensemble(
        cfg, params, state, w,
        opts=ObservableOptions(gr_bins=64, z_bins=64, sampler=sampler),
    )

    print(f"chains: {n_chains}  sampler: {sampler}")
    print(f"mean energy: {res.mean_energy:.3f} ± {res.std_energy:.3f} "
          "(chain spread)")
    print(f"acceptance: {res.acceptance_ratio:.4f}")
    print(f"aggregate throughput: {res.sweeps_per_second:,.0f} sweeps/s")
    zp = res.zprofile
    peak = np.argmax(zp)
    print(f"z-profile peak bin: {peak}/64 (density {zp[peak]:.4f})")
    return res


if __name__ == "__main__":
    main()
