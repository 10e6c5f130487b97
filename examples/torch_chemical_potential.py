"""Widom insertion: the excess chemical potential of the confined fluid
(the counterpart of examples/chemical_potential.py).

Two estimates from one short run each:
  1. mu_ex(z) across the slab — ghost particles inserted uniformly,
     binned on the z grid; together with the density profile this
     exhibits the constant total chemical potential
     T ln rho(z) + mu_ex(z) = const (the adsorption equilibrium).
  2. mu_ex(T) as a CONTINUOUS curve from a temperature ladder: the
     paired (E, dU_ghost) samples reweight exactly to any target T via
     MBAR (both the configuration weights and the insertion Boltzmann
     factor re-evaluated at the target beta) — no extra simulation per
     temperature.

    python examples/torch_chemical_potential.py [--device cuda|cpu]
        [--scale S]
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from tpu_smc_torch.config import RunParams, SMCConfig
from tpu_smc_torch.driver import ObservableOptions
from tpu_smc_torch.driver_ensemble import simulate_ensemble
from tpu_smc_torch.reweight import reweight_from_ladder
from tpu_smc_torch.state import init_ensemble_state, seed_words
from tpu_smc_torch.tsweep import FieldOptions, simulate_temperature_sweep
from tpu_smc_torch.widom import mu_ex, mu_ex_profile


def main(argv=None):
    ap = argparse.ArgumentParser(description="Widom mu_ex(z) and mu_ex(T)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every sweep and gather count")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    s = args.scale
    sampler = "dense" if args.device == "cuda" else "torch"

    # --- 1. mu_ex(z) across a thin slab -------------------------------
    cfg = dataclasses.replace(
        SMCConfig.for_n(64, temperature=1.1, dtype="float32"),
        box_l=7.0, box_lz=20.0)
    state, w = init_ensemble_state(cfg, seed_words(0), n_chains=16,
                                   device=args.device)
    opts = ObservableOptions(collect_sweep_trace=False, widom_k=128,
                             z_bins=40, sampler=sampler)
    state, res = simulate_ensemble(
        cfg, RunParams(eqsteps=max(1, round(300 * s)),
                       maxsteps=max(1, round(900 * s)),
                       numdata=max(1, round(300 * s))),
        state, w, opts=opts, max_fault_retries=0)

    mu, err = mu_ex(res.widom_du, cfg.temperature)
    print(f"volume-averaged mu_ex = {mu:0.4f} ± {err:0.4f}")
    centers, muz, ez, cnt = mu_ex_profile(
        res.widom_du, res.widom_z, cfg.temperature, cfg, nbins=40)
    print("\n   z     mu_ex(z)   T*ln(rho)   sum (≈const where sampled)")
    rho = res.zprofile
    for i in range(len(centers)):
        if cnt[i] > 300 and np.isfinite(muz[i]) and rho[i] > 1e-3:
            tlr = cfg.temperature * np.log(rho[i])
            print(f"{centers[i]:6.2f}  {muz[i]:8.4f}  {tlr:9.4f}  "
                  f"{muz[i] + tlr:8.4f}")

    # --- 2. mu_ex(T) from one ladder -----------------------------------
    bulk = SMCConfig.bulk(n=32, temperature=1.0, rho=0.1, dtype="float32")
    temps = [0.85, 1.0, 1.15]
    _, lres = simulate_temperature_sweep(
        bulk, RunParams(eqsteps=max(1, round(200 * s)),
                        maxsteps=max(1, round(800 * s)),
                        numdata=max(1, round(200 * s))), temps,
        seed_words(1), chains_per_t=8, sampler=sampler,
        fields=FieldOptions(widom_k=64), device=args.device)
    t_grid = np.linspace(0.85, 1.15, 7)
    rw = reweight_from_ladder(lres, bulk, t_grid, n_boot=16, seed=0)
    print("\nmu_ex(T) via MBAR (bulk rho=0.1):")
    for t, m, e in zip(rw.temps, rw.mu_ex, rw.err_mu_ex):
        print(f"T {t:0.3f}: mu_ex = {m:8.4f} ± {e:0.4f}")
    return (mu, err), rw


if __name__ == "__main__":
    main()
