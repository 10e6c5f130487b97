#!/usr/bin/env python3
"""Why a sweep at a large mobility can end with other decisions in the
sweep kernel than in its plain version on a chain without a near tie.

    python3 scripts/torch_lane_order.py [N ...]     # default 1000 4096

On the inputs of tests/test_torch_cuda.py::test_grouped_rows_edges
(z-layers of 128 rows, 64 chains, one z-skip sweep) at the default
mobility and at A = 4 and 8, on one CUDA device:

1. the plain version twice, its lanes added in block_sum4's fixed order
   (kernels/sweep.py `_lane_sums`, the reference) and with torch's sum
   over the lane axis, each against the kernel: the clean chains (no
   move within 1e-3 of a tie), the clean chains whose accepted moves
   differ from the kernel's, and the largest position difference on the
   others;
2. the two plain runs move by move: the chains whose decisions split,
   the first split's log_ap on each side and its gap to log u, and how
   far the two runs' earlier movers had drifted apart by then;
3. at A = 8, the kernel against the reference in windows of 256, 512 and
   1024 moves from the same start that together move every row (planes
   rolled by a multiple of 128 rows, a config with n = the window), as
   test_grouped_rows_edges holds them.

Imports neither jax nor tpu_smc.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from tpu_smc_torch.config import SMCConfig  # noqa: E402
from tpu_smc_torch.kernels import sweep as ks  # noqa: E402
from test_torch_cuda import _cfg_inputs, _layers  # noqa: E402

TIE_MARGIN = 1e-3
FIXED = ks._lane_sums


def torch_lane_sums(t: torch.Tensor) -> torch.Tensor:
    """_lane_sums with torch's reduction over the 128 lanes."""
    k, r, c = t.shape
    pad = -r % ks.ROW_BLOCK
    if pad:
        t = torch.cat([t, t.new_zeros((k, pad, c))], dim=1)
    return t.reshape(k, -1, ks.ROW_BLOCK, c).cumsum(1)[:, -1].sum(1)


def plain(lane_sums, args, cfg, a):
    ks._lane_sums = lane_sums
    try:
        d = {"tie_margin": TIE_MARGIN, "moves": True}
        out = ks.sweep_block_plain(*args, cfg, 1, a, zskip=True, diag=d)
    finally:
        ks._lane_sums = FIXED
    return out, d


def max_dx(outk, out, n, chains):
    if not bool(chains.any()):
        return 0.0
    d = torch.stack([(outk[k] - out[k])[:n].abs().amax(0) for k in range(3)])
    return float(d.amax(0)[chains].max())


def orders(n: int, cfg, args) -> None:
    for a in (cfg.proposal_a, 4.0, 8.0):
        outk = ks.sweep_block(*args, cfg, 1, a, zskip=True)
        runs = {}
        for name, fn in (("fixed", FIXED), ("torch", torch_lane_sums)):
            out, d = plain(fn, args, cfg, a)
            clean = d["near_ties"] == 0
            same = (outk[5] == out[5]).all(0)
            bad = (clean & ~same).nonzero().reshape(-1).tolist()
            print(f"N={n} A={a:g}, {name} lane order: clean chains "
                  f"{int(clean.sum())}/64, clean chains whose accepts differ "
                  f"from the kernel's {bad}, max |dx| against the kernel on "
                  f"the other clean chains "
                  f"{max_dx(outk, out, n, clean & same):.3g}", flush=True)
            runs[name] = (d["moves"], clean)
        (mf, cf), (mt, ct) = runs["fixed"], runs["torch"]
        split = mf["accept"] != mt["accept"]
        drift = (mf["r"] - mt["r"]).abs().amax(1).cummax(0).values
        chains = split.any(0).nonzero().reshape(-1).tolist()
        print(f"  fixed against torch order: {len(chains)} chains decide "
              f"otherwise ({int((split.any(0) & cf & ct).sum())} clean in "
              f"both); drift of the movers after the sweep: median "
              f"{float(drift[-1].median()):.3g}, max "
              f"{float(drift[-1].max()):.3g}", flush=True)
        for ch in chains[:5]:
            m = int(split[:, ch].int().argmax())
            lu = float(mf["log_u"][m, ch])
            la = [float(mm["log_ap"][m, ch]) for mm in (mf, mt)]
            gaps = [abs(min(v, 0.0) - lu) for v in la]
            print(f"  chain {ch}: first split at move {m}: log_ap "
                  f"{la[0]:.6g} (fixed) / {la[1]:.6g} (torch), log u "
                  f"{lu:.6g}, gaps {gaps[0]:.3g} / {gaps[1]:.3g}; movers "
                  f"drifted apart by "
                  f"{float(drift[m - 1, ch]) if m else 0.0:.3g} before it",
                  flush=True)


def windows(n: int, cfg, args) -> None:
    for m in (256, 512, 1024):
        if m >= n:
            continue
        flips = clean_windows = 0
        dx = 0.0
        for k0 in range(0, n, m):
            part = dataclasses.replace(cfg, n=min(m, n - k0))
            wargs = tuple(torch.roll(p, -k0, 0) for p in args[:3]) + args[3:]
            outk = ks.sweep_block(*wargs, part, 1, 8.0, zskip=True)
            d = {"tie_margin": TIE_MARGIN}
            outp = ks.sweep_block_plain(*wargs, part, 1, 8.0, zskip=True,
                                        diag=d)
            clean = d["near_ties"] == 0
            same = (outk[5] == outp[5]).all(0)
            flips += int((clean & ~same).sum())
            clean_windows += int(clean.sum())
            dx = max(dx, max_dx(outk, outp, n, clean & same))
        print(f"N={n} A=8 in windows of {m} moves over every row: {flips} "
              f"of {clean_windows} clean chain-windows decide otherwise "
              f"than the kernel; max |dx| on the others {dx:.3g}",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lane_order: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    for n in [int(v) for v in sys.argv[1:]] or [1000, 4096]:
        layers = -(-n // 128)
        cfg = SMCConfig(n=n, box_l=18.0, box_lz=layers * 3.6 + 24.0)
        x, y, z, e, wa, wb, offsets, words = _cfg_inputs(cfg, 64, dev,
                                                         r0=_layers(n))
        args = (x, y, z, e, wa, wb, offsets[:1], words[:1])
        orders(n, cfg, args)
        windows(n, cfg, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
