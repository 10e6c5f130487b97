#!/usr/bin/env python3
"""Whether a chain's sums on the card depend on how many chains share
its call, and whether the drivers split over two shards of one card
stay bitwise the one-call run at small shard sizes.

    python3 scripts/torch_shard_sums.py [--device cpu]

On one CUDA device (or, with --device cpu, on the CPU, where torch's
vectorised elementwise kernels finish a tensor's tail in scalar code):

1. for N in (12, 32, 96, 108, 256, 1024), 64 bulk configurations under
   per-chain boxes, computed all at once and in calls of 1, 2, 4, 8, 16
   and 32 chains: torch's sum over each pair row (`[B, N, N].sum(-1)`),
   torch's sum of those rows (`[B, N].sum(-1)`), the same rows added in
   potentials.fixed_order_sum's order, the box pair energy
   (potentials.pair_energy_total, which adds them so), a particle's
   pair energy (pair_energy_force_single), and in the fixed box a
   particle's pair force and the pair energy, in torch's order and
   under potentials.split_of (the sums padded to the 64-chain call's
   chains, up to 16); each printed as
   bitwise the 64-chain call or not;
2. at C = 2, 4, ..., 64 chains, the plain engine (N = 108, 3 sweeps),
   NPT (N = 108, 4 + 6, resync every 5) and Gibbs (N = 96, 4 + 6) over
   two shards of the device against one call: the fields that differ
   (an empty list is bitwise).

Imports neither jax nor tpu_smc.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tpu_smc_torch import ensemble as ten  # noqa: E402
from tpu_smc_torch import gibbs as tgb  # noqa: E402
from tpu_smc_torch import npt as tnpt  # noqa: E402
from tpu_smc_torch import potentials as tp  # noqa: E402
from tpu_smc_torch.config import SMCConfig  # noqa: E402
from tpu_smc_torch.state import init_ensemble_state, seed_words  # noqa


def bulk(n: int) -> SMCConfig:
    return SMCConfig.bulk(n=n, temperature=2.0, rho=0.3, gamma=0.02,
                          lj_cutoff=1.8, lj_shift=True)


def differing(a, b) -> list:
    """Fields of two results or chain-state dataclasses that differ."""
    if dataclasses.is_dataclass(a):
        return [f.name for f in dataclasses.fields(a)
                if not torch.equal(getattr(a, f.name), getattr(b, f.name))]
    out = []
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "sweeps_per_second" or x is None:
            continue
        if torch.is_tensor(x):
            x, y = x.cpu(), y.cpu()
        if not np.array_equal(np.asarray(x), np.asarray(y),
                              equal_nan=np.asarray(x).dtype.kind == "f"):
            out.append(f)
    return out


def row_sums(dev) -> None:
    c = 64
    for n in (12, 32, 96, 108, 256, 1024):
        cfg = bulk(n)
        rng = np.random.default_rng(n)
        side = cfg.box_l
        r = torch.as_tensor(rng.uniform(-side / 2, side / 2, (c, n, 3)),
                            dtype=torch.float32, device=dev)
        box = torch.as_tensor(side * rng.uniform(0.98, 1.02, c),
                              dtype=torch.float32, device=dev)
        dr2, mask = tp._pair_dr2_rows(r, 0, n, cfg, box)
        safe = torch.where(mask, dr2, torch.ones_like(dr2))
        inv6 = 1.0 / (safe * safe * safe)
        terms = torch.where(mask, inv6 * inv6 - inv6, torch.zeros_like(inv6))
        rows = terms.sum(-1)
        whole = {"row sums over j": rows, "torch sum of rows": rows.sum(-1),
                 "fixed-order sum of rows": tp.fixed_order_sum(rows),
                 "pair_energy_total(box)": tp.pair_energy_total(r, cfg,
                                                                box=box),
                 "one particle's pair energy": tp.pair_energy_force_single(
                     r, 3, r[:, 3], cfg, None, box)[0],
                 "one particle's pair force": tp.pair_energy_force_single(
                     r, 3, r[:, 3], cfg)[1],
                 "one particle's pair force under split_of":
                     tp.pair_energy_force_single(r, 3, r[:, 3], cfg)[1],
                 "pair_energy_total": tp.pair_energy_total(r, cfg),
                 "pair_energy_total under split_of": tp.pair_energy_total(
                     r, cfg)}
        for b in (1, 2, 4, 8, 16, 32):
            parts = {k: [] for k in whole}
            for i in range(0, c, b):
                sl = slice(i, i + b)
                rb = terms[sl].sum(-1)
                parts["row sums over j"].append(rb)
                parts["torch sum of rows"].append(rows[sl].sum(-1))
                parts["fixed-order sum of rows"].append(
                    tp.fixed_order_sum(rows[sl]))
                parts["pair_energy_total(box)"].append(
                    tp.pair_energy_total(r[sl], cfg, box=box[sl]))
                parts["one particle's pair energy"].append(
                    tp.pair_energy_force_single(r[sl], 3, r[sl, 3], cfg,
                                                None, box[sl])[0])
                parts["one particle's pair force"].append(
                    tp.pair_energy_force_single(r[sl], 3, r[sl, 3], cfg)[1])
                parts["pair_energy_total"].append(
                    tp.pair_energy_total(r[sl], cfg))
                with tp.split_of(c, c // b):
                    parts["one particle's pair force under split_of"].append(
                        tp.pair_energy_force_single(r[sl], 3, r[sl, 3],
                                                    cfg)[1])
                    parts["pair_energy_total under split_of"].append(
                        tp.pair_energy_total(r[sl], cfg))
            same = {k: torch.equal(torch.cat(v), whole[k])
                    for k, v in parts.items()}
            print(f"N = {n}, calls of {b} chains against one of {c}: "
                  + ", ".join(f"{k} {'bitwise' if v else 'DIFFERS'}"
                              for k, v in same.items()), flush=True)


def small_shards(dev) -> None:
    two = [dev, dev]
    ncfg = bulk(108)
    gcfg = SMCConfig.bulk(n=96, temperature=0.75, rho=0.6, gamma=0.02,
                          lj_cutoff=1.8, lj_shift=True)
    for c in (2, 4, 8, 16, 32, 64):
        cfg = SMCConfig.for_n(108)
        st, w = init_ensemble_state(cfg, seed_words(3), c, device=dev)
        one = ten.ensemble_sweeps(st, w, cfg, cfg.proposal_a, 3,
                                  stream_seed=9, collect_trace=True)
        sh = ten.ensemble_sweeps_sharded(st, w, cfg, cfg.proposal_a, 3, 9,
                                         two, collect_trace=True)
        plain = differing(one[0], sh[0]) + differing(one[1], sh[1])
        npt = [tnpt.simulate_npt(ncfg, 1.0, 4, 6, seed_words(9), n_chains=c,
                                 dlnv=0.1, seed=9, chunk=5, device=dev,
                                 devices=d) for d in (None, two)]
        gib = [tgb.simulate_gibbs(gcfg, 4, 6, seed_words(7), 96, n_chains=c,
                                  dlnv=0.08, n_transfer=24, seed=7, chunk=5,
                                  device=dev, devices=d) for d in (None, two)]
        npt_bad = differing(npt[0][1], npt[1][1]) + differing(npt[0][0],
                                                              npt[1][0])
        gib_bad = differing(gib[0][1], gib[1][1]) + differing(gib[0][0],
                                                              gib[1][0])
        print(f"C = {c} over two shards, fields that differ from one call: "
              f"plain engine {plain}, NPT {npt_bad}, Gibbs {gib_bad}",
              flush=True)


def main() -> int:
    if sys.argv[1:] == ["--device", "cpu"]:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
        print(f"CPU, torch {torch.__version__}, "
              f"{torch.backends.cpu.get_cpu_capability()}", flush=True)
    elif not torch.cuda.is_available():
        print("torch_shard_sums: needs a CUDA device (or --device cpu)",
              file=sys.stderr)
        return 1
    else:
        dev = torch.device("cuda", 0)
        print(torch.cuda.get_device_name(0), flush=True)
    row_sums(dev)
    small_shards(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
