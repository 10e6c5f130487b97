#!/usr/bin/env python3
"""The sweep kernels of this tree against those of another checkout (an
earlier design of csrc/sweep.cu), on one card: every output bitwise equal
on the same inputs in each mode, then the two timed in turns at the main
path's shapes, and K5's device time in a CUDA graph beside an empty
kernel's. The ptxas table and the per-move cycle split are
chip_smoke.py's.

    python3 kernel_ab.py --parent DIR     # against DIR/tpu_smc_torch

DIR is a checkout of the earlier commit (for instance `git archive` of it
unpacked into a directory that .gitignore lists). Its package is imported
under another name beside this tree's and builds its own library under
DIR/tpu_smc_torch/_build. Needs one CUDA device and nvcc; imports neither
jax nor tpu_smc. Exits non-zero if an output differs in any bit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def load_parent(root: Path):
    """DIR/tpu_smc_torch imported as package `parent_tpu_smc_torch`;
    returns its kernels.sweep and kernels.banded modules."""
    pkg = root / "tpu_smc_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_tpu_smc_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_tpu_smc_torch"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("parent_tpu_smc_torch.kernels.sweep"),
            importlib.import_module("parent_tpu_smc_torch.kernels.banded"))


def turns_ms(fa, fb, rounds: int, reps: int):
    """ms per launch of fa and fb, timed in turns a, b, b, a per round;
    the median over rounds."""
    ta, tb = [], []
    for _ in range(rounds):
        ta.append(cs.cuda_ms(fa, reps=reps))
        tb.append(cs.cuda_ms(fb, reps=reps))
        tb.append(cs.cuda_ms(fb, reps=reps))
        ta.append(cs.cuda_ms(fa, reps=reps))
    return float(np.median(ta)), float(np.median(tb))


def cases(device):
    """(label, launch((sweep, banded) modules) -> outputs, timed, rounds,
    reps): every mode of the two kernels that run sweep_chain, and K4 and
    K5, which share its device functions: K4 at the main path's shape,
    where every move falls back, where every move takes the window, and
    on a sweep that draws a row twice in a row; K5 at the main path's
    plane and at planes that end in a ragged tail; `timed` marks the main
    path's shapes."""
    from tpu_smc_torch import ensemble as en
    from tpu_smc_torch.config import SMCConfig
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    out = []

    def resident(label, n, c, zskip, timed=False, sweeps=2, at=False,
                 walls=0, cfg=None, xsort=0, reps=10):
        cfg, _, args, _ = cs.kernel_inputs(n, c, device, sweeps=sweeps,
                                           sort=zskip, walls=walls, cfg=cfg,
                                           xsort=xsort)
        a, t = (cs.ladder_rows(cfg, c, device, a_scale=2.0 if walls else 1.0)
                if at else (cfg.proposal_a, None))
        out.append((label, lambda m: m[0].sweep_block(
            *args, cfg, sweeps, a, zskip=zskip, temperature=t,
            xslices=xsort), timed, 3, reps))

    def stream(label, n, c, timed=False, sweeps=2, at=False, walls=0,
               cfg=None, reps=10):
        cfg, _, args, _ = cs.kernel_inputs(n, c, device, sweeps=sweeps,
                                           sort=True, walls=walls, cfg=cfg)
        a, t = (cs.ladder_rows(cfg, c, device, a_scale=2.0)
                if at else (cfg.proposal_a, None))
        out.append((label, lambda m: m[0].sweep_block_stream(
            *args, cfg, sweeps, a, temperature=t), timed, 3, reps))

    resident("K1 dense N=108 x 512", 108, 512, False, timed=True)
    resident("K1-at dense N=108 x 512", 108, 512, False, timed=True, at=True)
    resident("K1-w dense N=108 x 512, 8 walls", 108, 512, False, timed=True,
             walls=8)
    resident("K2 z-skip N=1024 x 512", 1024, 512, True, timed=True)
    resident("K1-at z-skip N=1024 x 512", 1024, 512, True, timed=True,
             at=True)
    resident("K1-pbc N=4000 x 128", 4000, 128, False, timed=True,
             cfg=cs.bulk_config(4000), reps=3)
    resident("K1-rn N=108 x 512", 108, 512, False, timed=True,
             cfg=SMCConfig.for_n(108, reference_noise=True))
    resident("K1-xs k=4 N=1024 x 256", 1024, 256, True, timed=True, xsort=4)
    resident("K2 z-skip N=4096 x 256", 4096, 256, True, timed=True, reps=3)
    resident("K1 dense M=10 N=108 x 512", 108, 512, False,
             cfg=SMCConfig.for_n(108, m=10))
    resident("K2 z-skip N=1024 x 128, (2A, T) + 4 walls", 1024, 128, True,
             at=True, walls=4)
    resident("K1 dense N=1000 x 64", 1000, 64, False)
    resident("K1-pbc N=12 x 64", 12, 64, False,
             cfg=SMCConfig(n=12, box_l=10.0, box_lz=10.0, use_walls=False,
                           pbc_z=True, lj_cutoff=3.0))
    big = cs.large_n_config()
    stream("K3 N=32768 x 128, 1 sweep", big.n, 128, timed=True, sweeps=1,
           cfg=big, reps=2)
    stream("K3 N=4096 x 128, (2A, T) + 4 walls", 4096, 128, at=True, walls=4)
    stream("K3 M=10 N=108 x 64", 108, 64,
           cfg=SMCConfig(n=108, m=10, box_l=10.0, box_lz=24.0))

    def banded(label, cfg, state, w, words, window, d_z=12.0, timed=False):
        """K4 on one sweep from `state`; the outputs and the schedule
        (rows_out). The sort and margins are made once, by this tree."""
        from tpu_smc_torch.kernels import banded as kb
        from tpu_smc_torch.kernels import sweep as ks

        x, y, z, margin = kb.sort_and_margin(state.r, cfg, window)
        wa, wb = ks.wall_coeff_rows(w, cfg)
        args = (x, y, z, state.energy.reshape(1, -1).to(torch.float32), wa,
                wb, margin, words, cfg, cfg.proposal_a, window, d_z)

        def launch(m):
            d = {}
            return m[1].banded_sweep_block(*args, diag=d) + (d["rows"],)
        out.append((label, launch, timed, 3, 10))

    cfg, state, w = cs.equilibrated(device)
    banded("K4 N=1024 x 256, W=128", cfg, state, w,
           en._per_sweep_randomness(state, cfg, 21, 1)[0][0], 128,
           timed=True)
    # tests/test_torch_cuda.py's test_banded_kernel_matches_plain state:
    # at W = 32 every move falls back, at W = 512 >= n every move takes
    # the window
    cfg5 = SMCConfig.for_n(512)
    st5, w5 = init_ensemble_state(cfg5, seed_words(2), 32, device=device)
    st5, _ = en.ensemble_sweeps_dense(st5, w5, cfg5, cfg5.proposal_a, 2,
                                      seed=2)
    words5 = en._per_sweep_randomness(st5, cfg5, 3, 1)[0][0]
    banded("K4 N=512 x 32, W=32 (every move falls back)", cfg5, st5, w5,
           words5, 32)
    banded("K4 N=512 x 32, W=512 (every move takes the window)", cfg5, st5,
           w5, words5, 512)
    cfgc = SMCConfig(n=32, box_l=10.0, box_lz=120.0, gamma=0.02)
    stc, wc = init_ensemble_state(cfgc, seed_words(5), 32,
                                  r0=cs.clusters(5), device=device)
    banded("K4 N=32 x 32 clusters, W=8: a row drawn twice in a row", cfgc,
           stc, wc, cs.REPEAT_WORDS, 8, d_z=24.5)

    def noise(label, n, c, timed=False):
        out.append((label, lambda m: (m[0].debug_reference_noise(
            (12345, 678), n, c, NOISE_S2A, device),), timed, 3, 10))

    noise("K5 [328, 512]", 108, 512, timed=True)
    noise("K5 [12288, 256]", 4096, 256)
    noise("K5 [24, 37] (ragged tail)", 7, 37)
    noise("K5 [15000, 301] (grid-stride loop, ragged tail)", 5000, 301)
    return out


# K5's timed shape (the main path's plane) and scale sqrt(2A), A = 1.1
NOISE_SHAPE = (108, 512)
NOISE_S2A = 1.4832396974191326


def noise_device_ms(mods: dict, device, rounds: int = 3) -> None:
    """K5's device time at NOISE_SHAPE (chip_smoke.graph_ms: launches in
    one CUDA graph) for the parent and this tree in turns, beside the
    launch floor (this tree's empty kernel on K5's grid)."""
    n, c = NOISE_SHAPE
    run = {k: (lambda m=m: m[0].debug_reference_noise(
        (12345, 678), n, c, NOISE_S2A, device)) for k, m in mods.items()}
    times = {"parent": [], "this": [], "floor": []}
    for _ in range(rounds):
        for k in ("parent", "this", "this", "parent"):
            times[k].append(cs.graph_ms(run[k]))
        times["floor"].append(cs.graph_ms(
            lambda: mods["this"][0].empty_launch(n, c, device)))
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"  device time (CUDA graph) K5 [{mods['this'][0].noise_rows(n)}, "
          f"{c}]: parent {med['parent']:.4f} ms, this {med['this']:.4f} ms, "
          f"empty kernel on K5's grid {med['floor']:.4f} ms "
          f"({cs.card_line()})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="checkout of the earlier design to hold against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from tpu_smc_torch.kernels import banded as kb
    from tpu_smc_torch.kernels import sweep as ks

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = cs.card_line()
    print(card, flush=True)
    ks.build()
    print(f"nvcc build of kernels/csrc/sweep.cu: {ks._Build.seconds:.1f} s",
          flush=True)
    parent = load_parent(args.parent.resolve())
    parent[0].build()
    print(f"parent ({args.parent}): nvcc build {parent[0]._Build.seconds:.1f} s",
          flush=True)
    this = (ks, kb)
    mods = {"parent": parent, "this": this}
    launch_of = {}
    failed = []
    for label, launch, timed, rounds, reps in cases(device):
        run = {k: (lambda m=m, launch=launch: launch(m))
               for k, m in mods.items()}
        a, b = run["parent"](), run["this"]()
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip(a, b))
        print(f"  {label}: {'bitwise equal' if same else 'DIFFERS'} "
              f"(every output)", flush=True)
        if not same:
            failed.append(label)
        if timed:
            launch_of[label] = (run, rounds, reps)
    for label, (run, rounds, reps) in launch_of.items():
        tp, tt = turns_ms(run["parent"], run["this"], rounds, reps)
        print(f"  in turns {label}: parent {tp:.3f} ms, this {tt:.3f} ms "
              f"({tt / tp:.3f}x, {tp / tt:.2f}x faster) ({card})", flush=True)
    noise_device_ms(mods, device)
    if failed:
        print(f"kernel_ab: outputs differ from the parent in: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
