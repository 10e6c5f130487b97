"""Quenched wall-disorder averaging in one run (the counterpart of
examples/wall_disorder.py).

The reference's random wall is frozen at srand(42) for every run and
every MPI rank (SMC.c:477): one disorder realization, forever. Here K
wall realizations become per-chain wall tables that ride the chain
batch (on the card: the whole-sweep kernel's per-chain wall mode, K1-w),
so one run samples every realization at once, reports per-realization
means, and quenched-averages them with an honest between-realization
error bar.

    python examples/torch_wall_disorder.py [--device cuda|cpu]
        [--per-k C] [--scale S]
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
from tpu_smc_torch.state import (batch_chain_state, init_chain_state,
                                 per_chain_wall_energy, seed_words)
from tpu_smc_torch.system import build_wall_ensemble

K = 4            # disorder realizations (wall seeds 42..45)


def main(argv=None):
    ap = argparse.ArgumentParser(description="quenched wall disorder")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--per-k", type=int, default=8,
                    help="chains per realization")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every sweep and gather count")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    per_k = args.per_k
    cfg = SMCConfig(dtype="float32")
    params = RunParams(eqsteps=max(1, round(1000 * args.scale)),
                       maxsteps=max(1, round(4000 * args.scale)),
                       numdata=max(1, round(400 * args.scale)))

    w_k, x0, ym = build_wall_ensemble(cfg, K)          # [K, M*M, 2]
    print("well-depth draws per realization (ym ~ N(3.0, 0.5)):")
    for k in range(K):
        print(f"  k={k} (seed {42 + k}): mean {ym[k].mean():0.3f}, "
              f"min {ym[k].min():0.3f}, max {ym[k].max():0.3f}")

    # per-chain tables: chain c simulates realization c // per_k
    chains = K * per_k
    seed_state, _ = init_chain_state(cfg, seed_words(0), device=args.device)
    state = batch_chain_state(seed_state, chains)
    w = torch.as_tensor(np.repeat(w_k, per_k, axis=0),
                        dtype=cfg.torch_dtype, device=args.device)

    # realizations start at different wall energies: recompute E0 per chain
    state = state.replace(energy=per_chain_wall_energy(state.r, w, cfg)
                          .to(state.energy.dtype))

    sampler = "dense" if args.device == "cuda" else "torch"
    state, agg = simulate_ensemble(cfg, params, state, w,
                                   opts=ObservableOptions(sampler=sampler))

    e = np.asarray([c.mean_energy for c in agg.chains]).reshape(K, per_k)
    e_k = e.mean(axis=1)
    print("\nper-realization mean energy:")
    for k in range(K):
        print(f"  k={k}: E = {e_k[k]:10.4f}  "
              f"(chain spread {e[k].std():0.4f})")
    se = e_k.std(ddof=1) / np.sqrt(K)
    print(f"\nquenched disorder average: E = {e_k.mean():0.4f} +- "
          f"{se:0.4f} (between-realization SE)")
    print("\n(The CLI equivalent: python -m tpu_smc_torch 1000 4000 400 1.1 "
          f"--chains {chains} --wall-realizations {K})")
    return e_k


if __name__ == "__main__":
    main()
