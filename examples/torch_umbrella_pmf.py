"""Umbrella sampling: the adsorption free-energy profile F(z) of a
tagged particle, resolved where plain sampling never goes (the
counterpart of examples/umbrella_pmf.py).

K harmonic windows restrain the tagged particle's z at centers spanning
the slab; every window x replica runs in ONE ensemble (the window axis
rides the chain batch; on the card each sweep replays one CUDA graph of
the plain engine), and MBAR stitches the biased histograms into the
unbiased PMF — including the barrier region where the equilibrium
density (and so the -T ln rho route) vanishes.

    python examples/torch_umbrella_pmf.py [--device cuda|cpu] [--scale S]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from tpu_smc_torch.config import RunParams, SMCConfig
from tpu_smc_torch.state import seed_words
from tpu_smc_torch.umbrella import simulate_umbrella, umbrella_pmf


def main(argv=None):
    ap = argparse.ArgumentParser(description="umbrella sampling PMF")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every sweep and gather count")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    cfg = SMCConfig(n=32, temperature=1.1, dtype="float32")
    params = RunParams(eqsteps=max(1, round(400 * args.scale)),
                       maxsteps=max(1, round(2000 * args.scale)),
                       numdata=max(1, round(500 * args.scale)))
    centers = np.linspace(-9.0, 9.0, 10)

    _, res = simulate_umbrella(
        cfg, params, centers, seed_words(0),
        k_spring=6.0, tag=0, replicas=4, device=args.device)
    res = umbrella_pmf(res, n_bins=40, n_boot=8)

    print("window  z0       f_k      acceptance")
    for k in range(len(res.centers)):
        print(f"{k:4d}  {res.centers[k]:7.2f}  {res.window_f[k]:8.3f}  "
              f"{res.acceptance[k]:0.3f}")

    fin = np.isfinite(res.pmf)
    print(f"\nF(z) over z in [{res.z_grid[fin].min():0.2f}, "
          f"{res.z_grid[fin].max():0.2f}] "
          f"(barrier {np.nanmax(res.pmf):0.2f} T-units):")
    for b in range(0, len(res.z_grid), 4):
        if np.isfinite(res.pmf[b]):
            e = res.err_pmf[b] if res.err_pmf is not None else float("nan")
            print(f"  z = {res.z_grid[b]:7.2f}   F = {res.pmf[b]:8.3f} "
                  f"+- {e:0.3f}")
    print("\n(CLI equivalent: python -m tpu_smc_torch 400 2000 500 1.1 "
          "--n 32 --umbrella=-9:9:10 --umbrella-spring 6 "
          "--umbrella-replicas 4)")
    return res


if __name__ == "__main__":
    main()
