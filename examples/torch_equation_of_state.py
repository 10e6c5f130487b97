"""Equation of state rho(P) of the bulk LJ fluid in ONE run, then the
CONTINUOUS curve by MBAR over the pressure axis (the counterpart of
examples/equation_of_state.py).

The pressure axis rides the chain batch (the same trick temperature
ladders and GCMC's mu grid use): K pressures x R replicas advance as
one NPT ensemble — every chain at its own instantaneous volume, since
the box side is a per-chain tensor (tpu_smc_torch/npt.py).
`reweight_isobars` then MBAR-combines the sampled states into
rho(P)/kappa_T(P) at pressures the run never simulated — the
constant-P sibling of the temperature ladder's --reweight, and a
capability the strictly-NVT reference (SMC_noMPI_noWall.c) cannot
approach.

    python examples/torch_equation_of_state.py [--device cuda|cpu]
        [--scale S]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from tpu_smc_torch.config import SMCConfig
from tpu_smc_torch.npt import reweight_isobars, simulate_npt
from tpu_smc_torch.state import seed_words


def main(argv=None):
    ap = argparse.ArgumentParser(description="NPT isobars + MBAR")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every sweep count")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    t = 2.0
    cfg = SMCConfig.bulk(n=32, temperature=t, rho=0.3, gamma=0.02,
                         lj_cutoff=1.8, lj_shift=True)

    pressures = np.asarray([0.4, 0.8, 1.2, 1.6])
    replicas = 5                          # chains per pressure point
    p_c = np.repeat(pressures, replicas)  # the P axis rides the chain batch

    state, res = simulate_npt(
        cfg, p_c, eqsteps=max(1, round(2500 * args.scale)),
        maxsteps=max(1, round(3500 * args.scale)), key=seed_words(0),
        n_chains=len(p_c), dlnv=0.1, chunk=250, device=args.device)

    v_grp = res.volume_trace.reshape(-1, len(pressures), replicas)
    v_mean = v_grp.mean(axis=(0, 2))
    rho = cfg.n / v_mean
    rho_err = ((cfg.n / v_grp.mean(axis=0)).std(axis=1)
               / np.sqrt(replicas - 1))

    print(f"\nSampled isobars, bulk LJ  N={cfg.n}  T={t}  "
          f"rc={cfg.lj_cutoff:g} (shifted)")
    print("P        rho       +-err     <V>")
    for i, p in enumerate(pressures):
        print(f"{p:6.3f}  {rho[i]:8.5f}  {rho_err[i]:8.5f}  "
              f"{v_mean[i]:8.3f}")
    print(f"displacement acceptance {res.disp_acceptance:0.3f}, "
          f"volume acceptance {res.vol_acceptance:0.3f}")

    # MBAR over the pressure axis: 4 sampled states -> a 13-point curve
    p_grid = np.linspace(0.4, 1.6, 13)
    rw = reweight_isobars(res.energy_trace, res.volume_trace, p_c, t,
                          p_grid, cfg.n, device=args.device)
    print("\nContinuous equation of state (MBAR):")
    print("P        rho       kappa_T    ess")
    for i, p in enumerate(p_grid):
        mark = "  <- sampled" if np.any(np.isclose(p, pressures)) else ""
        print(f"{p:6.3f}  {rw.rho[i]:8.5f}  {rw.kappa_t[i]:8.5f}  "
              f"{rw.ess[i]:7.0f}{mark}")

    # self-consistency: the MBAR curve must pass through the direct points
    at = np.searchsorted(p_grid, pressures)
    rel = np.abs(rw.rho[at] - rho) / rho
    print(f"\nMBAR vs direct at the sampled pressures: "
          f"max |rel diff| {rel.max():0.2%} (pooling tightens the "
          f"estimate; large deviations would mean unequilibrated states)")
    return rho, rw


if __name__ == "__main__":
    main()
