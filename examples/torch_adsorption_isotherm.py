"""Grand-canonical adsorption isotherm: coverage vs chemical potential
in ONE run (the counterpart of examples/adsorption_isotherm.py).

The chemical-potential axis rides the chain batch (exactly the trick
temperature ladders use): n_mu values of mu run as one GCMC ensemble
(tpu_smc_torch/gcmc.py; on the card each sweep replays one CUDA graph),
each point with its own replica chains. Output is the isotherm <N>(mu)
for the confined slab — the question the reference's NVT-only workflow
cannot ask at all.

    python examples/torch_adsorption_isotherm.py [--device cuda|cpu]
        [--scale S]
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from tpu_smc_torch.config import SMCConfig
from tpu_smc_torch.gcmc import box_volume, simulate_gcmc
from tpu_smc_torch.state import seed_words


def main(argv=None):
    ap = argparse.ArgumentParser(description="GCMC adsorption isotherm")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every sweep count")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    # thin slab so the walls matter
    cfg = dataclasses.replace(
        SMCConfig.for_n(64, temperature=1.3, dtype="float32"),
        box_l=7.0, box_lz=16.0)

    mus = np.linspace(-9.5, -6.0, 8)
    replicas = 2                     # chains per mu point
    mu_c = np.repeat(mus, replicas)  # the mu axis rides the chain batch

    state, res = simulate_gcmc(
        cfg, mu_c, cap=128, eqsteps=max(1, round(400 * args.scale)),
        maxsteps=max(1, round(1200 * args.scale)), key=seed_words(0),
        n_chains=len(mu_c), n0=24, device=args.device)

    n_chain = res.n_trace.mean(axis=0).reshape(len(mus), replicas)
    v = box_volume(cfg)
    print(f"V = {v:g}, T = {cfg.temperature}, capacity 128\n")
    print("  mu      <N>      rho        (replica spread)")
    for i, mu in enumerate(mus):
        m = n_chain[i].mean()
        s = n_chain[i].std()
        print(f"{mu:6.2f}  {m:7.2f}  {m / v:9.5f}   ±{s:0.2f}")

    full = n_chain.mean(axis=1).max()
    if full >= 128 * 0.9:
        raise SystemExit("capacity nearly saturated — raise cap")
    print("\n(the isotherm rises smoothly toward the wall-condensed branch;"
          f"\n one run, {len(mu_c)} GCMC chains)")
    return n_chain


if __name__ == "__main__":
    main()
