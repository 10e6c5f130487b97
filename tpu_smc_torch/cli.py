"""Command-line entry point of the port: the NVT chain-ensemble path of
tpu_smc.cli (main.c equivalent).

    python -m tpu_smc_torch EQSTEPS MAXSTEPS NUMDATA T --chains C [options]

Runs on the CUDA device unless `--device cpu` is given. Options of the JAX
CLI that this port does not have yet are recognised and refused by name.
"""

from __future__ import annotations

import argparse
import sys
import time

# Options of `python -m tpu_smc` that are not ported yet.
NOT_PORTED = (
    "--wall-seed", "--wall-realizations", "--bulk", "--gr-bins", "--z-bins",
    "--widom", "--widom-bins", "--ptensor-bins", "--gcmc", "--gcmc-cap",
    "--gcmc-exchanges", "--gcmc-grid", "--npt", "--npt-grid", "--npt-dlnv",
    "--gibbs", "--gibbs-transfers", "--gibbs-cap", "--gibbs-temps",
    "--npt-reweight", "--rho", "--lj-cutoff", "--sk-kmax", "--checkpoint",
    "--resume", "--acf-mode", "--auto-checkpoint", "--fault-retries",
    "--health-checks", "--profile-dir", "--platform", "--x64",
    "--temperatures", "--chains-per-t", "--pt-exchange",
    "--target-acceptance", "--umbrella", "--umbrella-spring",
    "--umbrella-tag", "--umbrella-replicas", "--umbrella-bins",
    "--umbrella-exchange", "--reweight", "--coordinator", "--num-processes",
    "--process-id", "--global-ladder", "--nonuniform-z",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_smc_torch",
        description="Smart Monte Carlo of a confined LJ fluid, chain "
                    "ensembles on a CUDA GPU (PyTorch port of tpu_smc)")
    p.add_argument("eqsteps", type=int, help="equilibration sweeps")
    p.add_argument("maxsteps", type=int, help="production sweeps")
    p.add_argument("numdata", type=int, help="number of gathers")
    p.add_argument("temperature", type=float, help="temperature")
    p.add_argument("--n", type=int, default=108, help="particles (SMC.h:29)")
    p.add_argument("--m", type=int, default=3,
                   help="wall grid per dim (SMC.h:26)")
    p.add_argument("--lca-time", type=int, default=None, metavar="G",
                   help="gathers between cluster analyses (SMC.h:48)")
    p.add_argument("--storage-time", type=int, default=None, metavar="G",
                   help="gathers between position dumps (SMC.h:45)")
    p.add_argument("--gamma", type=float, default=None,
                   help="A = gamma*T (main.c:51; default 1.0)")
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default="float32")
    p.add_argument("--data-dir", default="Data", help="output root (main.c:55)")
    p.add_argument("--seed", type=int, default=None,
                   help="run seed (default: time, like srand(time(NULL)))")
    p.add_argument("--chains", type=int, default=2,
                   help="independent chains (replaces MPI ranks); >= 2")
    p.add_argument("--no-trace", action="store_true",
                   help="skip per-sweep E/jj traces (big runs)")
    p.add_argument("--sampler", choices=("torch", "dense", "zsorted", "auto"),
                   default="auto",
                   help="sweep engine: torch = plain PyTorch, dense = the "
                        "whole-sweep CUDA kernel, zsorted = the kernel with "
                        "exact z-block skipping; auto picks dense below "
                        "N=1024 and zsorted from N=1024 on a CUDA device in "
                        "float32, torch otherwise")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    for flag in NOT_PORTED:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    return p


def _resolve_sampler(requested: str, cfg, device: str) -> str:
    """--sampler auto: the kernel engines on a CUDA device in float32
    (zsorted from N = 1024 when z is confined, dense below), the plain
    engine otherwise — tpu_smc.cli._resolve_sampler's routing, whose
    crossover chip_smoke.py times on the card (see PERF.md)."""
    if requested == "zsorted" and cfg.reference_noise:
        raise SystemExit(
            "--sampler zsorted cannot honor reference_noise=True: the "
            "z-sorted move order permutes the bug-compatible noise-pair "
            "structure (docs/DEVIATIONS.md A8).")
    if requested in ("dense", "zsorted") and cfg.dtype != "float32":
        raise SystemExit(f"--sampler {requested} runs float32; use "
                         "--sampler torch for --dtype float64")
    if requested != "auto":
        return requested
    if device != "cuda" or cfg.dtype != "float32" or cfg.reference_noise:
        return "torch"
    return "zsorted" if cfg.n >= 1024 and not cfg.pbc_z else "dense"


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    given = [f for f in NOT_PORTED
             if getattr(args, f.lstrip("-").replace("-", "_")) is not None]
    if given:
        parser.exit(2, f"tpu_smc_torch: {', '.join(given)}: not yet ported "
                       "to the PyTorch package (use python -m tpu_smc)\n")
    if args.chains < 2:
        parser.exit(2, "tpu_smc_torch: the single-chain path (--chains 1) "
                       "is not yet ported; use --chains >= 2\n")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tpu_smc_torch: no CUDA device available; pass "
                         "--device cpu to run on the CPU")

    from . import io as smcio
    from .config import RunParams, SMCConfig
    from .state import init_chain_state, seed_words
    from .system import build_walls, fcc_lattice

    gkw = {} if args.gamma is None else {"gamma": args.gamma}
    if args.lca_time is not None:
        gkw["lca_time"] = args.lca_time
    if args.storage_time is not None:
        gkw["storage_time"] = args.storage_time
    cfg = SMCConfig.for_n(args.n, temperature=args.temperature,
                          dtype=args.dtype, m=args.m, **gkw)
    params = RunParams(args.eqsteps, args.maxsteps, args.numdata)
    sampler = _resolve_sampler(args.sampler, cfg, args.device)

    now = time.localtime()
    print(f"\n\n----  Starting the simulation at local time "
          f"{now.tm_hour:02d}:{now.tm_min:02d}  ----\n")
    d = smcio.run_dir(cfg, args.data_dir)
    w_np, x0, ym = build_walls(cfg)
    smcio.write_wall_csv(d, cfg, x0, ym)

    seed = args.seed if args.seed is not None else int(time.time())
    r0 = smcio.load_last_state(d, cfg)
    if r0 is not None:
        print("\nUsing previously saved particle configuration...")
    else:
        print("\nInitializing system...")
        r0 = fcc_lattice(cfg)
    state, w = init_chain_state(cfg, seed_words(seed), r0=r0, w=w_np,
                                device=args.device)

    kinetic = 1.5 * cfg.n * cfg.temperature
    print(f"\nSystem initialized, with energy E0 = "
          f"{float(state.energy[0]) + kinetic:f}.\n")
    print(f"Starting new run with {cfg.n} particles in "
          f"{cfg.box_l:0.1f}x{cfg.box_l:0.1f}x{cfg.box_lz:0.1f} box, "
          f"T={cfg.temperature:0.2f}, rho={cfg.rho:0.4f}, "
          f"A={cfg.proposal_a:0.3f}, for {params.maxsteps} steps...")
    return _run_ensemble(args, cfg, params, d, state, w, sampler, seed)


def _run_ensemble(args, cfg, params, d, seed_state, w, sampler: str,
                  seed: int) -> int:
    """Multi-chain run: per-chain files (rank = chain, the reference's
    per-MPI-rank naming) + the pooled ensemble summary."""
    from . import io as smcio
    from .driver import ObservableOptions
    from .driver_ensemble import simulate_ensemble
    from .state import batch_chain_state

    c = args.chains
    state = batch_chain_state(seed_state, c)
    pos_writers = [smcio.PositionsWriter(d, cfg, rank=ci) for ci in range(c)]
    r = state.r.cpu().numpy()
    for ci in range(c):
        pos_writers[ci].append(r[ci])

    def on_window(widx, st, outs):
        r = st.r.cpu().numpy()
        for ci in range(c):
            pos_writers[ci].append(r[ci])
        print(f"\rWindow {widx + 1} done...", end="", flush=True)

    print(f"Ensemble sweep engine: {sampler}")
    opts = ObservableOptions(collect_sweep_trace=not args.no_trace,
                             sampler=sampler, stream_seed=seed)
    state, agg = simulate_ensemble(cfg, params, state, w, opts=opts,
                                   on_window=on_window)

    for ci, res in enumerate(agg.chains):
        smcio.write_data_csv(d, cfg, res.energy_trace_full, res.pressure_trace,
                             res.accept_trace, params.gather_lapse, rank=ci)
        smcio.LocalWriter(d, cfg, "local", rank=ci).append(res.density,
                                                          res.mobility)
        smcio.write_total_clusters_csv(d, cfg, res.l1, res.l2, res.l3, rank=ci)
        smcio.write_autocorrelation_csv(d, cfg, res.acf, rank=ci)

    print(f"\n\nAggregate throughput: {agg.sweeps_per_second:,.0f} sweeps/s "
          f"across {c} chains")
    print("\n###  Final ensemble results  ###")
    print(f"Mean energy: {agg.mean_energy:f} ± {agg.std_energy:f} "
          "(chain spread)")
    print(f"Mean pressure: {agg.mean_pressure:f} ± {agg.std_pressure:f}")
    print(f"Average acceptance ratio: {agg.acceptance_ratio:f}")
    smcio.write_ensemble_data_csv(d, cfg, agg.chains, params.gather_lapse)
    smcio.write_info_csv(d, cfg, params, agg.chains[0])
    smcio.write_last_state(d, cfg, agg.chains[0].r_final)
    return 0


if __name__ == "__main__":
    sys.exit(main())
