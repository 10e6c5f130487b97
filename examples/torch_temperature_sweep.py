"""Map the E(T) / c_v(T) curve of the confined LJ fluid in one run
(the counterpart of examples/temperature_sweep.py).

Every temperature in the ladder runs as replica chains inside one
ensemble (tpu_smc_torch/tsweep.py): one engine call per block for the
whole ladder, no per-T process (the reference needs one run per T).

    python examples/torch_temperature_sweep.py [--device cuda|cpu]
        [--chains-per-t C] [--scale S]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from tpu_smc_torch.config import RunParams, SMCConfig
from tpu_smc_torch.reweight import reweight_from_ladder
from tpu_smc_torch.state import seed_words
from tpu_smc_torch.tsweep import simulate_temperature_sweep


def main(argv=None):
    ap = argparse.ArgumentParser(description="temperature sweep + MBAR")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--chains-per-t", type=int, default=32)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every sweep and gather count")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")

    cfg = SMCConfig(dtype="float32")
    params = RunParams(eqsteps=max(1, round(2000 * args.scale)),
                       maxsteps=max(1, round(10000 * args.scale)),
                       numdata=max(1, round(1000 * args.scale)))
    temps = np.linspace(0.7, 1.6, 10)
    sampler = "dense" if args.device == "cuda" else "torch"

    _, res = simulate_temperature_sweep(
        cfg, params, temps, seed_words(0), chains_per_t=args.chains_per_t,
        sampler=sampler, device=args.device)

    print("T        E_mean      +-err     acc      cv")
    for i, t in enumerate(res.temps):
        print(f"{t:0.3f}  {res.mean_energy[i]:10.4f}  "
              f"{res.err_energy[i]:8.4f}  {res.acceptance[i]:0.4f}  "
              f"{res.cv[i]:8.4f}")

    # MBAR-reweight the ladder's samples onto a fine grid: continuous
    # E(T)/c_v(T)/f(T) between the simulated temperatures (reweight.py).
    rw = reweight_from_ladder(res, cfg, np.linspace(0.7, 1.6, 37))
    print("\nMBAR curve (every 4th point):")
    print("T        E_mean        cv        ESS       f")
    for i in range(0, len(rw.temps), 4):
        print(f"{rw.temps[i]:0.3f}  {rw.mean_energy[i]:10.4f}  "
              f"{rw.cv[i]:8.4f}  {rw.ess[i]:8.1f}  "
              f"{rw.free_energy[i]:8.4f}")
    return res, rw


if __name__ == "__main__":
    main()
