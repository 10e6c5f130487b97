"""Liquid-vapor coexistence of the bulk LJ fluid by Gibbs-ensemble MC
— two coupled boxes find both phase densities in ONE run, with no
imposed pressure or chemical potential (the counterpart of
examples/coexistence.py).

Below the critical point the two boxes bifurcate: one drifts dense
(liquid), the other dilute (vapor), while volume exchanges equalize
pressure and particle transfers equalize chemical potential. The
transfer ghosts double as per-box Widom samples, so the run prints
mu = T ln rho + mu_ex for each box — watching the two values converge
IS watching coexistence being reached. Above T_c the same program
reports a single density: the one-phase verdict.

    python examples/torch_coexistence.py [--device cuda|cpu] [--scale S]
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch

from tpu_smc_torch.config import SMCConfig
from tpu_smc_torch.gibbs import simulate_gibbs
from tpu_smc_torch.state import seed_words


def main(argv=None):
    ap = argparse.ArgumentParser(description="Gibbs-ensemble coexistence")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every sweep count")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    n_total = 96          # across both boxes
    rho_all = 0.30        # overall density — inside the binodal at low T
    out = {}
    for t in (0.75, 2.0):                 # two-phase, then one-phase
        l0 = ((n_total / 2) / rho_all) ** (1.0 / 3.0)
        cfg = dataclasses.replace(
            SMCConfig.bulk(n=n_total, temperature=t, gamma=0.02,
                           lj_cutoff=1.8, lj_shift=True),
            box_l=l0, box_lz=l0)
        state, res = simulate_gibbs(
            cfg, eqsteps=max(1, round(1200 * args.scale)),
            maxsteps=max(1, round(2000 * args.scale)), key=seed_words(1),
            cap=n_total, n_chains=4, dlnv=0.08, n_transfer=n_total // 4,
            chunk=200, device=args.device)
        two = res.rho_hi > 2.0 * res.rho_lo
        print(f"\nT = {t}:  "
              f"{'TWO-PHASE (coexistence)' if two else 'one phase'}")
        print(f"  branch densities: {res.rho_lo:0.4f} ± {res.err_lo:0.4f}"
              f"  /  {res.rho_hi:0.4f} ± {res.err_hi:0.4f}")
        print(f"  per-box mu (T ln rho + Widom mu_ex): "
              f"{res.mu_box[0]:0.3f} vs {res.mu_box[1]:0.3f}  "
              f"(equal at equilibrium)")
        print(f"  acceptances disp/vol/transfer: "
              f"{res.disp_acceptance:0.3f} / {res.vol_acceptance:0.3f} / "
              f"{res.transfer_acceptance:0.3f}")
        out[t] = res
    return out


if __name__ == "__main__":
    main()
