"""Example: a large-N system on the sweep kernel plus the particle-sharded
O(N^2) energy pass over the process's devices (the counterpart of
examples/large_n_sharded.py).

The chain ensemble advances through the dense kernel (K1) on the card,
the plain engine elsewhere; then chain 0's total energy is summed with
its particle rows split into one block per shard (one device each,
ensemble.make_mesh; one card may carry every block), beside the full
recompute.

Run: python examples/torch_large_n_sharded.py [--device cuda|cpu]
     [--n N] [--shards D]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch

from tpu_smc_torch import ensemble as ens
from tpu_smc_torch.config import SMCConfig
from tpu_smc_torch.potentials import total_energy
from tpu_smc_torch.state import init_ensemble_state, seed_words


def main(argv=None):
    ap = argparse.ArgumentParser(description="large N, particle-sharded "
                                             "energy")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=1024, help="particles")
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--shards", type=int, default=None,
                    help="row blocks (default: one per CUDA device, 4 on "
                         "the CPU or a single card)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    if args.device == "cuda" and torch.cuda.device_count() > 1:
        mesh = ens.make_mesh(args.shards)
    else:
        mesh = ens.make_mesh(devices=[args.device] * (args.shards or 4))
    cfg = SMCConfig.for_n(args.n, dtype="float32")
    state, w = init_ensemble_state(cfg, seed_words(0), args.chains,
                                   device=args.device)

    # advance the ensemble a little at the thermalization mobility
    if args.device == "cuda":
        state, stats = ens.ensemble_sweeps_dense(state, w, cfg,
                                                 2.0 * cfg.proposal_a, 3)
    else:
        state, stats = ens.ensemble_sweeps(state, w, cfg,
                                           2.0 * cfg.proposal_a, 3,
                                           collect_trace=True)
    acc = float(stats.accepted.double().mean()) / cfg.n
    print(f"shards: {len(mesh)}  mean E: "
          f"{float(state.energy.double().mean()):.2f}  acceptance: "
          f"{acc:.3f}")

    # particle-sharded total energy: rows split over the shards, each
    # block against all N positions, the block sums added
    e = ens.particle_sharded_energy(state.r[0], w, cfg, mesh)
    full = float(total_energy(state.r[:1].double(), w.double(), cfg)[0])
    print(f"particle-sharded total energy (chain 0): {e:.4f} "
          f"(full recompute {full:.4f})")
    return e, full


if __name__ == "__main__":
    main()
