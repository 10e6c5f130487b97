"""The full phase-curve workflow in one script: tune, temper, reweight
(the counterpart of examples/phase_curve.py).

1. Auto-tune a per-level proposal mobility to a target acceptance
   (tuning.tune_mobility_ladder) — the reference hard-codes A = gamma*T.
2. Run the temperature ladder WITH replica exchange (parallel
   tempering, pt.py) as one ensemble using the tuned ladder.
3. MBAR-reweight the ladder's samples onto a fine grid (reweight.py):
   continuous E(T), c_v(T) and relative free energy, with the effective
   sample size per point.

Every stage runs on the card; the reference would need one process per
temperature and could do neither the exchanges nor the reweighting.

    python examples/torch_phase_curve.py [--device cuda|cpu]
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
from tpu_smc_torch.reweight import reweight_from_ladder
from tpu_smc_torch.state import fold_in, seed_words
from tpu_smc_torch.tuning import tune_mobility_ladder


def main(argv=None):
    ap = argparse.ArgumentParser(description="tune, temper, reweight")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--chains-per-t", type=int, default=32)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every sweep and gather count (and the "
                         "tuning's blocks)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    cfg = SMCConfig(dtype="float32")
    temps = np.linspace(0.8, 1.5, 6)
    key = seed_words(0)
    cpt = args.chains_per_t
    sampler = "dense" if args.device == "cuda" else "torch"

    print("Tuning per-level mobility to 70% acceptance...")
    lt = tune_mobility_ladder(
        cfg, temps, fold_in(key, [1])[0], chains_per_t=cpt, target=0.7,
        sampler=sampler, sweeps_per_block=max(2, round(25 * args.scale)),
        device=args.device)
    for i, t in enumerate(lt.temps):
        print(f"  T {t:0.3f}: A = {lt.a_per_t[i]:8.4f} "
              f"(acceptance {lt.acceptance[i]:0.3f})")

    print("\nParallel tempering on the tuned ladder...")
    params = RunParams(eqsteps=max(10, round(2000 * args.scale)),
                       maxsteps=max(10, round(8000 * args.scale)),
                       numdata=max(1, round(800 * args.scale)))
    _, res = simulate_parallel_tempering(
        cfg, params, temps, key, chains_per_t=cpt, exchange_interval=10,
        a_per_t=lt.a_per_t, sampler=sampler, device=args.device)
    for i in range(len(temps) - 1):
        print(f"  swap T {res.pair_t_lo[i]:0.3f} <-> "
              f"{res.pair_t_hi[i]:0.3f}: {res.swap_acceptance[i]:0.3f}")

    print("\nMBAR reweighting onto a fine grid (16 bootstrap draws)...")
    rw = reweight_from_ladder(res, cfg, np.linspace(0.8, 1.5, 29),
                              n_boot=16)
    print("T        E_mean     +-err       cv          P           ESS"
          "       f")
    for i in range(0, len(rw.temps), 4):
        print(f"{rw.temps[i]:0.3f}  {rw.mean_energy[i]:10.4f}  "
              f"{rw.err_energy[i]:8.4f}  {rw.cv[i]:8.4f}  "
              f"{rw.pressure[i]:10.6f}  {rw.ess[i]:8.1f}  "
              f"{rw.free_energy[i]:8.4f}")
    return lt, res, rw


if __name__ == "__main__":
    main()
