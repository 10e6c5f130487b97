"""Command-line entry point of the port: the single-chain run of
tpu_smc.cli (the reference's main.c), its NVT chain ensembles,
temperature ladders (tsweep, parallel tempering, tuned mobility, MBAR
reweighting), quenched wall disorder and the bulk LJ fluid (--bulk, the
SMC_noMPI_noWall.c variant), with full-state checkpoints, resume,
graceful stop on SIGINT/SIGTERM, fault replay and health checks; and the
measurement layer: g(r), rho(z), P_N/P_T(z) and S(k) (--gr-bins,
--z-bins, --ptensor-bins, --sk-kmax), Widom insertion (--widom) and
umbrella sampling with replica exchange between windows (--umbrella);
and the ensemble family (cli_ensembles): grand-canonical MC (--gcmc,
--gcmc-grid), constant pressure (--npt, --npt-grid, --npt-reweight) and
the Gibbs ensemble (--gibbs, --gibbs-temps); and multi-process runs on
torch.distributed (--coordinator, --num-processes, --process-id): the
chains split evenly over the processes, each keyed by its global index
(bitwise the single-process run), pooled at the end, or one ladder
spanning the processes (--global-ladder).

    python -m tpu_smc_torch EQSTEPS MAXSTEPS NUMDATA T [options]
    python -m tpu_smc_torch EQSTEPS MAXSTEPS NUMDATA T --chains C [options]
    python -m tpu_smc_torch EQSTEPS MAXSTEPS NUMDATA T --temperatures T1,T2,..
    python -m tpu_smc_torch EQSTEPS MAXSTEPS NUMDATA T --umbrella=Z1:Z2:K
    python -m tpu_smc_torch ... --seed S --coordinator HOST:PORT \
        --num-processes P --process-id p        (one command per process)

Left-out positionals are asked for on stdin, as the reference's main.c
asks. On a host with several cards a one-process run splits its chains
(an ensemble, a ladder, NPT, the isobars, Gibbs, the coexistence curve)
over them when they divide, bitwise the run on one card; under
--coordinator the ranks of a host share out its cards, and each splits
its chains (or its share of a --global-ladder) over its own.

Runs on the CUDA device unless `--device cpu` is given. The two options
of the JAX CLI that `--device` and `--dtype` replace (--platform, --x64)
are recognised and refused by name.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

# Options of `python -m tpu_smc` that are not ported: --device and --dtype
# take their place.
NOT_PORTED = ("--platform", "--x64")


def _exchange_arg(v: str):
    """--pt-exchange accepts an integer interval or 'auto'."""
    if v == "auto":
        return v
    return int(v)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_smc_torch",
        description="Smart Monte Carlo of a confined LJ fluid, chain "
                    "ensembles on a CUDA GPU (PyTorch port of tpu_smc)")
    p.add_argument("eqsteps", type=int, nargs="?", default=None,
                   help="equilibration sweeps; prompted for when omitted "
                        "(main.c:20-30)")
    p.add_argument("maxsteps", type=int, nargs="?", default=None,
                   help="production sweeps")
    p.add_argument("numdata", type=int, nargs="?", default=None,
                   help="number of gathers")
    p.add_argument("temperature", type=float, nargs="?", default=None,
                   help="temperature")
    p.add_argument("--n", type=int, default=108, help="particles (SMC.h:29)")
    p.add_argument("--m", type=int, default=3,
                   help="wall grid per dim (SMC.h:26)")
    p.add_argument("--lca-time", type=int, default=None, metavar="G",
                   help="gathers between cluster analyses (SMC.h:48)")
    p.add_argument("--storage-time", type=int, default=None, metavar="G",
                   help="gathers between position dumps (SMC.h:45)")
    p.add_argument("--gamma", type=float, default=None,
                   help="A = gamma*T (main.c:51; default 1.0, or the bulk "
                        "variant's A=4e-8 equivalent under --bulk)")
    p.add_argument("--bulk", action="store_true",
                   help="bulk LJ fluid (SMC_noMPI_noWall.c variant)")
    p.add_argument("--rho", type=float, default=None,
                   help="bulk number density (default 0.1, "
                        "SMC_noMPI_noWall.c:77); sets the box")
    p.add_argument("--lj-cutoff", type=float, default=None, metavar="RC",
                   help="pair cutoff (default: 3.0 with walls, L/2 bulk "
                        "- the reference conventions)")
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default="float32")
    p.add_argument("--data-dir", default="Data", help="output root (main.c:55)")
    p.add_argument("--seed", type=int, default=None,
                   help="run seed (default: time, like srand(time(NULL)))")
    p.add_argument("--chains", type=int, default=1,
                   help="independent chains (replaces MPI ranks); 1 is the "
                        "reference's single-chain run")
    p.add_argument("--no-trace", action="store_true",
                   help="skip per-sweep E/jj traces (big runs)")
    p.add_argument("--checkpoint", default=None,
                   help="write a full-state checkpoint here at the end")
    p.add_argument("--resume", default=None,
                   help="resume from a full-state checkpoint (of either "
                        "package)")
    p.add_argument("--acf-mode", choices=("reference", "circular", "unbiased"),
                   default="reference")
    p.add_argument("--auto-checkpoint", type=int, default=0, metavar="W",
                   help="write the full-state checkpoint every W storage "
                        "windows (failure recovery); also written on "
                        "SIGINT/SIGTERM before a clean stop")
    p.add_argument("--fault-retries", type=int, default=2, metavar="K",
                   help="tolerate K consecutive device faults per storage "
                        "window that leave the CUDA context usable (launch "
                        "errors, out of memory), replaying the window from "
                        "a host snapshot (bitwise continuation; 0 disables)")
    p.add_argument("--health-checks", action="store_true",
                   help="per-window health pass (finite positions, bounds, "
                        "energy drift); warns like boundsCheck")
    p.add_argument("--sampler", choices=("torch", "dense", "zsorted", "auto"),
                   default="auto",
                   help="sweep engine: torch = plain PyTorch, dense = the "
                        "whole-sweep CUDA kernel, zsorted = the kernel with "
                        "exact z-block skipping; auto picks dense below "
                        "N=1024 and zsorted from N=1024 on a CUDA device in "
                        "float32 (dense at every N for --bulk), torch "
                        "otherwise")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--temperatures", default=None, metavar="T1,T2,...",
                   help="temperature-ladder mode: chains at EVERY listed "
                        "temperature in one ensemble, tsweep_*.csv with "
                        "E/acceptance/cv per T; the positional T names the "
                        "run directory")
    p.add_argument("--chains-per-t", type=int, default=16,
                   help="replicas per temperature in --temperatures mode")
    p.add_argument("--pt-exchange", type=_exchange_arg, default=None,
                   metavar="K|auto",
                   help="with --temperatures: parallel tempering, replica "
                        "exchanges between adjacent temperatures every K "
                        "sweeps (pt_*.csv); 'auto' picks K from a short "
                        "post-thermalization probe")
    p.add_argument("--target-acceptance", type=float, default=None,
                   metavar="ACC",
                   help="tune the proposal mobility A before the run to hit "
                        "this acceptance ratio (per level on a ladder); "
                        "production holds the tuned A fixed")
    p.add_argument("--reweight", default=None, metavar="TMIN:TMAX:NUM",
                   help="with --temperatures: MBAR-reweight the ladder's "
                        "samples onto this grid (inclusive linspace or "
                        "T1,T2,...), reweight_*.csv")
    p.add_argument("--wall-seed", type=int, default=42,
                   help="seed of the wall draws (the reference's srand(42)); "
                        "with --wall-realizations the first of K seeds")
    p.add_argument("--wall-realizations", type=int, default=1, metavar="K",
                   help="quenched wall disorder: K wall realizations as "
                        "per-chain wall tables (chains, or replicas per "
                        "temperature, split evenly)")
    p.add_argument("--nonuniform-z", action="store_true",
                   help="non-uniform z voxel binning: layer_depth layers at"
                        " the walls, 3 thick central layers (createZRange,"
                        " SMC.c:1153-1169)")
    p.add_argument("--gr-bins", type=int, default=0, help="accumulate g(r)")
    p.add_argument("--z-bins", type=int, default=0,
                   help="accumulate the z-density profile")
    p.add_argument("--ptensor-bins", type=int, default=0, metavar="B",
                   help="accumulate the normal/tangential pressure profile "
                        "P_N(z)/P_T(z) (Harasima midpoint convention) and "
                        "report the wall tension 1/2 int (P_N - P_T) dz; "
                        "writes ptensor_*.csv")
    p.add_argument("--sk-kmax", type=int, default=0, metavar="K",
                   help="with --temperatures and --reweight: sample the "
                        "in-plane structure factor S(k) on |n|_inf <= K and "
                        "reweight it to S(k; T) (reweight_sk_*.csv)")
    p.add_argument("--widom", type=int, default=0, metavar="K",
                   help="Widom test-particle insertion: K ghost insertions "
                        "per chain per gather; prints mu_ex and writes "
                        "widom_*.csv with mu_ex(z). Trajectories are "
                        "unaffected")
    p.add_argument("--widom-bins", type=int, default=64, metavar="B",
                   help="z bins of the mu_ex(z) profile (default 64)")
    p.add_argument("--umbrella", default=None, metavar="Z0MIN:Z0MAX:K",
                   help="umbrella sampling: K harmonic windows restraining a "
                        "tagged particle's z at centers spanning the range "
                        "(inclusive linspace, or a comma list; use the = "
                        "form for a negative start), windows x replicas in "
                        "one ensemble on the plain engine; MBAR stitches "
                        "the unbiased PMF F(z) (umbrella_pmf_*.csv)")
    p.add_argument("--umbrella-spring", type=float, default=4.0,
                   metavar="K", help="harmonic bias spring constant")
    p.add_argument("--umbrella-tag", type=int, default=0, metavar="I",
                   help="index of the restrained particle")
    p.add_argument("--umbrella-replicas", type=int, default=4, metavar="R",
                   help="independent chains per window")
    p.add_argument("--umbrella-bins", type=int, default=48, metavar="B",
                   help="z bins of the unbiased PMF grid")
    p.add_argument("--umbrella-exchange", type=int, default=None,
                   metavar="K",
                   help="replica exchange between adjacent windows every K "
                        "sweeps (REUS); per-pair swap acceptance reported")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process mode: the torch.distributed (gloo) "
                        "rendezvous, served by process 0 (the reference's "
                        "mpirun model: chains split evenly, every draw "
                        "keyed by the global chain index, pooled stats "
                        "gathered; requires --num-processes/--process-id "
                        "and a fixed --seed)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total processes in the --coordinator job")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index in the --coordinator job")
    p.add_argument("--global-ladder", action="store_true",
                   help="with --coordinator and --temperatures: run ONE "
                        "ladder whose chain axis is split over all "
                        "processes instead of complete per-process ladders; "
                        "PT exchanges then swap configurations across "
                        "processes (--pt-exchange auto allowed: every "
                        "process computes the same probe)")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="capture a torch.profiler device trace of the "
                        "simulation call here (trace.json, "
                        "key_averages.txt)")
    from .cli_ensembles import add_arguments

    add_arguments(p)
    for flag in NOT_PORTED:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    return p


def _prompt_missing(args) -> None:
    """Ask for the positionals that were left out, as the reference does
    with scanf when argc != 5 (main.c:20-30), in tpu_smc's words
    (tpu_smc/cli.py:334-352)."""
    prompts = (
        ("eqsteps", int, "Enter the number of equilibration steps: "),
        ("maxsteps", int, "Enter the number of simulation steps: "),
        ("numdata", int, "Enter the number of microstates to analyze: "),
        ("temperature", float,
         "Enter the temperature in normalized units: "),
    )
    for name, cast, text in prompts:
        if getattr(args, name) is None:
            print(text, end="", flush=True)
            setattr(args, name, cast(input()))


@contextlib.contextmanager
def profiled(args):
    """The simulation call's context: profiling.trace(args.profile_dir) on
    the run's device when --profile-dir is given, nothing otherwise. The
    trace observes; every result is the run's without it."""
    if not args.profile_dir:
        yield
        return
    from .profiling import trace

    with trace(args.profile_dir, args.device) as rec:
        yield
    print(f"\nDevice trace written to {rec.path} ({rec.device_events} "
          f"device events; operator table {rec.table_path})")


def _resolve_sampler(requested: str, cfg, device: str) -> str:
    """--sampler auto: the kernel engines on a CUDA device in float32
    (zsorted from N = 1024 when z is confined and the noise i.i.d., dense
    otherwise), the plain engine elsewhere — tpu_smc.cli._resolve_sampler's
    routing, whose crossover chip_smoke.py times on the card (see
    PERF.md)."""
    if requested == "zsorted" and cfg.reference_noise:
        raise SystemExit(
            "--sampler zsorted cannot honor reference_noise=True: the "
            "z-sorted move order permutes the bug-compatible noise-pair "
            "structure (docs/DEVIATIONS.md A8).")
    if requested == "zsorted" and cfg.pbc_z:
        raise SystemExit("--sampler zsorted assumes confined z (bulk pbc_z "
                         "runs need --sampler dense)")
    if requested in ("dense", "zsorted") and cfg.dtype != "float32":
        raise SystemExit(f"--sampler {requested} runs float32; use "
                         "--sampler torch for --dtype float64")
    from . import ensemble as en
    from .kernels import sweep as ks

    if requested == "dense" and en.zsorted_streams(cfg, device):
        raise SystemExit(f"--sampler dense: N = {cfg.n} exceeds the resident "
                         "kernel's shared-memory capacity on this card; use "
                         "--sampler zsorted (the streamed kernel)")
    if requested != "auto":
        sampler = requested
    elif device != "cuda" or cfg.dtype != "float32":
        sampler = "torch"
    elif cfg.n >= 1024 and not cfg.pbc_z and not cfg.reference_noise:
        sampler = "zsorted"
    else:
        # reference noise stays dense: its fixed-label move order keeps
        # the pair semantics the mode exists for (tpu_smc/cli.py:327-330)
        sampler = "dense"
    if sampler == "dense" and (cfg.pbc_z or cfg.reference_noise) \
            and not ks.resident_fits(ks.padded_rows(cfg.n), device,
                                     ks.wall_sites(cfg)):
        raise SystemExit(f"N = {cfg.n} exceeds the resident kernel's "
                         "shared-memory capacity on this card, and bulk and "
                         "reference-noise runs have no streamed kernel; use "
                         "--sampler torch or fewer particles")
    return sampler


def _engine_label(sampler: str, cfg, device: str) -> str:
    """The engine as printed: zsorted runs the streamed kernel where
    `ensemble.zsorted_streams` says so."""
    from . import ensemble as en

    if sampler == "zsorted" and en.zsorted_streams(cfg, device):
        return "zsorted (streamed)"
    return sampler


def _distributed_refusals(args, mode, wall_k: int) -> None:
    """The multi-process options' usage errors, all before the rendezvous
    (which waits for every process, so a usage error must fail first),
    with tpu_smc's wording (tpu_smc/cli.py:395-452, and the single-process
    modes at :534, :587, :697, :769, :847)."""
    if args.global_ladder and not args.coordinator:
        raise SystemExit("--global-ladder needs --coordinator (it spans the "
                         "processes of a torch.distributed job)")
    if not args.coordinator:
        return
    if args.num_processes is None or args.process_id is None:
        raise SystemExit("--coordinator needs --num-processes and "
                         "--process-id")
    from .distributed import check_coordinator

    try:
        check_coordinator(args.coordinator, args.num_processes,
                          args.process_id)
    except ValueError as err:
        raise SystemExit(str(err)) from None
    if args.resume:
        raise SystemExit("--coordinator with --resume is not supported; "
                         "resume single-process, then restart the "
                         "multi-process run from its last_state")
    if args.global_ladder and not args.temperatures:
        raise SystemExit("--global-ladder needs a --temperatures ladder")
    nproc = args.num_processes
    if args.temperatures and not args.global_ladder:
        # complete replica ladders per process, pooled at the end
        if args.pt_exchange == "auto":
            raise SystemExit(
                "--coordinator ladders need a fixed --pt-exchange interval "
                "(per-process probes could choose different intervals) "
                "unless --global-ladder (one shared probe); probe "
                "single-process first, then pass the value")
        if args.chains_per_t < nproc or args.chains_per_t % nproc:
            raise SystemExit(f"--chains-per-t {args.chains_per_t} must "
                             f"divide evenly over {nproc} processes")
    elif not args.temperatures and (args.chains < nproc
                                    or args.chains % nproc):
        raise SystemExit(f"--chains {args.chains} must divide evenly over "
                         f"{nproc} processes")
    if args.seed is None:
        raise SystemExit("--coordinator needs an explicit --seed (all "
                         "processes must agree on the key stream)")
    if nproc > 1:
        for flag, on, scale in (("--gcmc", mode == "gcmc", "--chains"),
                                ("--npt", mode == "npt", "--chains"),
                                ("--gibbs", mode == "gibbs", "--chains"),
                                ("--umbrella", bool(args.umbrella),
                                 "--umbrella-replicas")):
            if on:
                raise SystemExit(f"{flag} is single-process (scale with "
                                 f"{scale})")
        if wall_k > 1 and args.temperatures:
            raise SystemExit("--wall-realizations ladders are single-process "
                             "(use more chains-per-t instead)")


def _ck_with_suffix(ck: str, suffix: str) -> str:
    """`ck` with a per-process suffix before its extension: every rank of
    a multi-process run writes its own checkpoint of its own chains
    (tpu_smc/cli.py:1595-1604)."""
    if not suffix:
        return ck
    root, dot, ext = ck.rpartition(".")
    return f"{root}{suffix}{dot}{ext}" if dot else ck + suffix


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    given = [f for f in NOT_PORTED
             if getattr(args, f.lstrip("-").replace("-", "_")) is not None]
    if given:
        parser.exit(2, f"tpu_smc_torch: {', '.join(given)}: not yet ported "
                       "to the PyTorch package (use python -m tpu_smc)\n")
    if args.chains < 1:
        parser.exit(2, "tpu_smc_torch: --chains must be >= 1\n")
    _prompt_missing(args)
    from . import cli_ensembles

    mode = cli_ensembles.mode_of(args)
    if mode:
        cli_ensembles.refusals(args, mode)
    if args.rho is not None and not args.bulk:
        raise SystemExit("--rho sets the bulk box; it needs --bulk (the slab "
                         "geometry is fixed by --n/--m)")
    wall_k = max(1, args.wall_realizations)
    _distributed_refusals(args, mode, wall_k)
    centers = _umbrella_refusals(args, wall_k) if args.umbrella else None
    if wall_k > 1:
        if args.bulk:
            raise SystemExit("--wall-realizations: bulk mode has no walls")
        if args.resume:
            raise SystemExit("--wall-realizations cannot be combined with "
                             "--resume (restart the disorder run with the "
                             "same seeds instead)")
        if args.temperatures and (args.chains_per_t < wall_k
                                  or args.chains_per_t % wall_k):
            raise SystemExit(f"--chains-per-t {args.chains_per_t} must be a "
                             f"positive multiple of --wall-realizations "
                             f"{wall_k}")
        if args.target_acceptance:
            raise SystemExit("--wall-realizations does not support "
                             "--target-acceptance yet (one tuned A would "
                             "have to serve every realization)")
        if not args.temperatures and (args.chains < wall_k
                                      or args.chains % wall_k):
            raise SystemExit(f"--chains {args.chains} must be a positive "
                             f"multiple of --wall-realizations {wall_k}")
    rw_grid = None
    if args.reweight and args.temperatures:
        from .reweight import parse_t_grid

        # a malformed grid fails now, not after the ladder has run
        rw_grid = parse_t_grid(args.reweight)

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tpu_smc_torch: no CUDA device available; pass "
                         "--device cpu to run on the CPU")
    nproc, rank = 1, 0
    if args.coordinator:
        from .distributed import init_distributed, process_count

        rank = init_distributed(args.coordinator, args.num_processes,
                                args.process_id)
        nproc = process_count()
        local_desc = (
            "a device shard of the ONE global ladder"
            if args.temperatures and args.global_ladder
            else f"{args.chains_per_t // nproc} of {args.chains_per_t} "
                 "replica ladders" if args.temperatures
            else f"{args.chains // nproc} of {args.chains} chains")
        n_dev = torch.cuda.device_count() if args.device == "cuda" else 1
        print(f"Multi-process run: process {rank}/{nproc}, {local_desc} "
              f"locally ({n_dev} local devices"
              f"{_take_cards(args.device, rank)})", flush=True)

    from . import io as smcio
    from .config import RunParams, SMCConfig
    from .state import init_chain_state, seed_words
    from .system import build_wall_ensemble, build_walls, fcc_lattice

    ck = None
    if args.resume and not mode:
        # the checkpoint's config is authoritative: a resumed [N_ck] state
        # under the CLI's physics would be wrong
        ck = smcio.load_checkpoint(args.resume, device=args.device)
        cfg = ck.cfg
        if cfg.n != args.n or cfg.temperature != args.temperature:
            print(f"Note: resuming with the checkpoint's config "
                  f"(N={cfg.n}, T={cfg.temperature}); CLI values ignored.")
    else:
        gkw = {} if args.gamma is None else {"gamma": args.gamma}
        if args.nonuniform_z:
            gkw["nonuniform_z"] = True
        if args.lca_time is not None:
            gkw["lca_time"] = args.lca_time
        if args.storage_time is not None:
            gkw["storage_time"] = args.storage_time
        if args.lj_cutoff is not None:
            gkw["lj_cutoff"] = args.lj_cutoff
        if args.bulk and args.rho is not None:
            gkw["rho"] = args.rho
        if mode in ("npt", "gibbs"):
            cli_ensembles.bulk_physics(args, gkw)
        if args.bulk:
            cfg = SMCConfig.bulk(n=args.n, temperature=args.temperature,
                                 dtype=args.dtype, **gkw)
        else:
            cfg = SMCConfig.for_n(args.n, temperature=args.temperature,
                                  dtype=args.dtype, m=args.m, **gkw)
    params = RunParams(args.eqsteps, args.maxsteps, args.numdata)
    sampler = None if mode else _resolve_sampler(args.sampler, cfg,
                                                 args.device)

    now = time.localtime()
    print(f"\n\n----  Starting the simulation at local time "
          f"{now.tm_hour:02d}:{now.tm_min:02d}  ----\n")
    d = smcio.run_dir(cfg, args.data_dir)
    w_k = None
    if wall_k > 1:
        # quenched wall disorder: the reference freezes its wall at
        # srand(42) for every run and rank (SMC.c:477)
        w_k, x0, ym = build_wall_ensemble(cfg, wall_k,
                                          base_seed=args.wall_seed)
        w_np = w_k[0]
    else:
        w_np, x0, ym = build_walls(cfg, seed=args.wall_seed)
    if rank == 0:
        smcio.write_wall_csv(d, cfg, x0, ym)

    seed = args.seed if args.seed is not None else int(time.time())
    if ck is not None and ck.stream_seed is not None:
        # continue the per-sweep streams of the checkpointed run
        seed = ck.stream_seed
    if args.reweight and not args.temperatures:
        print("Note: --reweight needs the --temperatures ladder; ignored.")
    if args.sk_kmax and not (args.temperatures and args.reweight):
        # no per-gather S(k) for output nothing consumes
        print("Note: --sk-kmax needs --temperatures AND --reweight; "
              "ignored.")
        args.sk_kmax = 0
    if mode:
        return cli_ensembles.run(mode, args, cfg, params, d, seed)
    if centers is not None:
        return _run_umbrella(args, cfg, params, d, w_np, seed, centers)
    if args.temperatures:
        return _run_ladder(args, cfg, params, d, w_np, w_k, sampler, seed,
                           rw_grid, ck, nproc, rank)
    from .distributed import chain_range
    from .state import batch_chain_state

    # this process's chains of the run: all of them, or its share
    chain0, c_local = chain_range(args.chains, nproc, rank)

    if ck is not None:
        state = ck.state
        w = torch.as_tensor(w_np, dtype=cfg.torch_dtype, device=args.device)
        print(f"Resumed full {'ensemble' if ck.batched else 'chain'} state "
              f"from {args.resume} ({int(state.sweeps[0])} sweeps done)")
        if ck.batched and args.chains > 1 and args.chains != state.n_chains:
            print(f"Note: checkpoint holds {state.n_chains} chains; "
                  "--chains ignored.")
        elif not ck.batched and args.chains > 1:
            from .state import broadcast_resumed_chain

            state = broadcast_resumed_chain(state, args.chains)
            print(f"Note: resumed single chain broadcast to {args.chains} "
                  "chains; cumulative density/mobility history kept in "
                  "chain 0 only.")
    else:
        r0 = smcio.load_last_state(d, cfg)
        if r0 is not None:
            print("\nUsing previously saved particle configuration...")
        else:
            print("\nInitializing system...")
            r0 = fcc_lattice(cfg)
        seed_state, w = init_chain_state(cfg, seed_words(seed), r0=r0,
                                         w=w_np, device=args.device)
        # one chain is chain 0 of the ensemble this seed starts
        state = batch_chain_state(seed_state, c_local, chain0)
    if w_k is not None:
        from .state import per_chain_wall_energy

        reps = args.chains // wall_k
        w = torch.as_tensor(
            np.repeat(w_k, reps, axis=0)[chain0:chain0 + c_local],
            dtype=cfg.torch_dtype, device=args.device)
        # each realization's chains start at their own wall energy
        state = state.replace(energy=per_chain_wall_energy(state.r, w, cfg)
                              .to(state.energy.dtype))
        print(f"Quenched wall disorder: {wall_k} realizations x {reps} "
              f"chains (wall seeds {args.wall_seed}.."
              f"{args.wall_seed + wall_k - 1})")

    kinetic = 1.5 * cfg.n * cfg.temperature
    print(f"\nSystem initialized, with energy E0 = "
          f"{float(state.energy[0]) + kinetic:f}.\n")
    print(f"Starting new run with {cfg.n} particles in "
          f"{cfg.box_l:0.1f}x{cfg.box_l:0.1f}x{cfg.box_lz:0.1f} box, "
          f"T={cfg.temperature:0.2f}, rho={cfg.rho:0.4f}, "
          f"A={cfg.proposal_a:0.3f}, for {params.maxsteps} steps...")
    if state.n_chains > 1 or nproc > 1 or (ck is not None and ck.batched):
        return _run_ensemble(args, cfg, params, d, state, w, sampler, seed,
                             nproc, rank, chain0)
    return _run_single(args, cfg, params, d, state, w, sampler, seed)


@contextlib.contextmanager
def _install_signal_stop():
    """SIGINT/SIGTERM set the yielded flag, and the run stops cleanly at
    the next window boundary with a checkpoint (`_window_maintenance`).
    The previous handlers come back when the block ends. Handlers install
    only in the main thread; elsewhere the flag is never set."""
    import signal

    flag = {"stop": False}

    def handler(signum, frame):
        print(f"\n[signal {signum}] finishing current window, "
              "checkpointing, and stopping...", flush=True)
        flag["stop"] = True

    saved = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            saved[sig] = signal.signal(sig, handler)
        except (ValueError, OSError):
            pass  # not the main thread, or a restricted environment
    try:
        yield flag
    finally:
        for sig, old in saved.items():
            signal.signal(sig, old)


def _window_maintenance(args, cfg, widx, st, stopper, w, seed: int,
                        chain_axis: bool = True, ck_suffix: str = ""):
    """After each storage window: the auto-checkpoint (ck_suffix: a
    process's own, `_ck_with_suffix`), the health check and the graceful
    stop. Returns "stop" to end the run at this window boundary."""
    from . import io as smcio

    def save():
        return smcio.save_checkpoint(
            _ck_with_suffix(args.checkpoint or "autosave.npz", ck_suffix),
            st, cfg, chain_axis=chain_axis, stream_seed=seed)

    if args.auto_checkpoint and (widx + 1) % args.auto_checkpoint == 0:
        save()
    if args.health_checks:
        from .guards import check_state

        check_state(st, w, cfg, strict=False)
    if stopper["stop"]:
        print(f"Checkpoint written to {save()}")
        return "stop"
    return None


def _options(args, sampler: str, seed: int, state, w, cfg,
             chain0: int = 0, devices=None):
    """(state, ObservableOptions) of a run whose state holds the chains
    from global index chain0, sharded over `devices` when given
    (_chain_devices), the proposal mobility tuned on `state` first under
    --target-acceptance (on those devices; on the job's pooled
    acceptance under --coordinator, so every process gets the same A)."""
    from .driver import ObservableOptions

    opts = ObservableOptions(collect_sweep_trace=not args.no_trace,
                             sampler=sampler, stream_seed=seed,
                             gr_bins=args.gr_bins, z_bins=args.z_bins,
                             widom_k=args.widom,
                             ptensor_bins=args.ptensor_bins, chain0=chain0,
                             devices=devices)
    if args.target_acceptance:
        import dataclasses

        from .tuning import tune_mobility

        state, tr = tune_mobility(cfg, state, w,
                                  target=args.target_acceptance,
                                  sampler=sampler, seed=seed, chain0=chain0,
                                  pooled=bool(args.coordinator),
                                  devices=devices)
        opts = dataclasses.replace(opts, proposal_a=tr.proposal_a)
        print(f"Auto-tuned proposal mobility: A = {tr.proposal_a:0.4g} "
              f"(gamma = {tr.gamma:0.3g}, acceptance {tr.acceptance:0.3f} "
              f"after {tr.sweeps_used} tuning sweeps)")
    return state, opts


def _run_single(args, cfg, params, d, state, w, sampler: str,
                seed: int) -> int:
    """The reference's single-chain run (main.c) of a one-chain state:
    rank-0 files, the per-window local_temp blocks, the final results
    block."""
    import numpy as np

    from . import io as smcio
    from .driver import simulate

    print(f"Ensemble sweep engine: {_engine_label(sampler, cfg, args.device)}")
    state, opts = _options(args, sampler, seed, state, w, cfg)
    pos_writer = smcio.PositionsWriter(d, cfg)
    pos_writer.append(state.r[0].cpu().numpy())
    temp_writer = smcio.LocalWriter(d, cfg, "local_temp")
    snap = {"d": np.zeros(cfg.n_voxels, np.int64),
            "mu": np.zeros(cfg.n_voxels, np.int64)}

    with _install_signal_stop() as stopper:
        def on_window(widx, st, outs):
            pos_writer.append(st.r[0].cpu().numpy())
            dnow = st.density[0].cpu().numpy()
            munow = st.mobility[0].cpu().numpy()
            temp_writer.append(dnow - snap["d"], munow - snap["mu"])
            snap["d"], snap["mu"] = dnow, munow
            done = (widx + 1) * min(cfg.storage_time, params.gather_steps)
            print(f"\rStoring the latest density distribution at "
                  f"~{done * params.gather_lapse} steps... ", end="",
                  flush=True)
            return _window_maintenance(args, cfg, widx, st, stopper, w, seed,
                                       chain_axis=False)

        with profiled(args):
            state, res = simulate(cfg, params, state, w, opts=opts,
                                  on_window=on_window,
                                  acf_mode=args.acf_mode,
                                  max_fault_retries=args.fault_retries)

    print(f"\n\nTime-equivalent throughput: {res.sweeps_per_second:,.0f} "
          f"sweeps/s ({1e6 / max(res.sweeps_per_second, 1e-9):0.1f} s per "
          "million)")
    print("\n###  Final results  ###")
    print(f"Mean energy: {res.mean_energy:f} ± {res.std_energy:f}")
    print(f"Mean pressure: {res.mean_pressure:f} ± {res.std_pressure:f}")
    print(f"Approximate heat capacity: {res.cv:f}")
    print(f"Average autocorrelation time: {res.tau:f}")
    print(f"Average acceptance ratio: {res.acceptance_ratio:f}")

    smcio.write_data_csv(d, cfg, res.energy_trace_full, res.pressure_trace,
                         res.accept_trace, params.gather_lapse)
    smcio.LocalWriter(d, cfg, "local").append(res.density, res.mobility)
    smcio.write_total_clusters_csv(d, cfg, res.l1, res.l2, res.l3)
    smcio.write_autocorrelation_csv(d, cfg, res.acf)
    smcio.write_info_csv(d, cfg, params, res)
    smcio.write_last_state(d, cfg, res.r_final)
    _write_measurements(args, cfg, d, res.gr, res.zprofile, res.widom_du,
                        res.widom_z, res.pn, res.pt)
    if args.checkpoint:
        ck_path = smcio.save_checkpoint(args.checkpoint, state, cfg,
                                        chain_axis=False, stream_seed=seed)
        print(f"Full chain state checkpointed to {ck_path}")
    return 0


# this process's cards under --coordinator, device names (_take_cards;
# None on the CPU and without --coordinator)
_RANK_CARDS: tuple | None = None


def _host_cards(rank: int, hosts: list, n_cards: int) -> list:
    """The cards of its host that `rank` takes: the host's ranks (those
    whose host name, hosts[r], is rank's, in rank order) split its
    n_cards into equal contiguous sets, the i-th rank taking cards
    [i k, (i + 1) k), k = n_cards // (its ranks); when they outnumber
    the cards, card rank mod n_cards, shared."""
    mine = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    if len(mine) > n_cards:
        return [rank % n_cards]
    k = n_cards // len(mine)
    i = mine.index(rank)
    return list(range(i * k, (i + 1) * k))


def _take_cards(device: str, rank: int) -> str:
    """Under --device cuda, this rank's cards of its host (_host_cards,
    the host names gathered from every rank) recorded for
    _chain_devices, the first made the current device; returns the
    note for the multi-process line ("" on the CPU)."""
    import socket

    import torch

    from .distributed import allgather_object

    global _RANK_CARDS
    _RANK_CARDS = None
    if device != "cuda":
        return ""
    cards = _host_cards(rank, allgather_object(socket.gethostname()),
                        torch.cuda.device_count())
    torch.cuda.set_device(cards[0])
    _RANK_CARDS = tuple(f"cuda:{c}" for c in cards)
    return ", this process on " + ", ".join(_RANK_CARDS)


def _chain_devices(device: str, n: int, nproc: int,
                   label: str = "") -> tuple | None:
    """The cards a run shards its n chains over, bitwise one card
    (tpu_smc's _auto_chain_mesh and its ladder and ensemble meshes, with
    their lines; `label` names the chains: "ladder", "NPT", ...): a
    one-process run's every card, a multi-process rank's own cards
    (_take_cards; tpu_smc's local devices), when there are several and
    the chains divide over them; else None (one card), with tpu_smc's
    note when only the division stood in the way. Every engine shards.
    The CPU has no cards."""
    import torch

    if nproc > 1:
        cards = _RANK_CARDS or ()
    elif device == "cuda":
        cards = tuple(f"cuda:{i}" for i in range(torch.cuda.device_count()))
    else:
        cards = ()
    n_dev = len(cards)
    if n_dev < 2:
        return None
    if n % n_dev:
        # tpu_smc's wording: the ladder's note names the ladder,
        # _auto_chain_mesh's and the ensemble's do not
        what = "ladder chains" if label == "ladder" else "chains"
        print(f"Note: {n} {what} do not divide over {n_dev} devices; "
              "running on one device")
        return None
    from .ensemble import make_mesh

    print(f"Sharding {n} {label + ' ' if label else ''}chains over {n_dev} "
          f"{'local ' if nproc > 1 else ''}devices")
    return tuple(make_mesh(devices=cards))


def _run_ensemble(args, cfg, params, d, state, w, sampler: str,
                  seed: int, nproc: int = 1, rank: int = 0,
                  chain0: int = 0) -> int:
    """Multi-chain run: per-chain files (rank = global chain index, the
    reference's per-MPI-rank naming) + the pooled ensemble summary. Over
    nproc > 1 processes the state holds this process's chains from
    global index chain0; the pooled results are gathered at the end
    (driver_ensemble.pool_ensemble_across_processes) and process 0
    writes the shared files (tpu_smc/cli.py:1762-1890)."""
    import numpy as np
    import torch

    from . import io as smcio
    from .driver_ensemble import (pool_ensemble_across_processes,
                                  simulate_ensemble)
    from .potentials import split_of

    c = state.n_chains
    pos_writers = [smcio.PositionsWriter(d, cfg, rank=chain0 + ci)
                   for ci in range(c)]
    r = state.r.cpu().numpy()
    for ci in range(c):
        pos_writers[ci].append(r[ci])

    devices = _chain_devices(args.device, c, nproc)
    print(f"Ensemble sweep engine: {_engine_label(sampler, cfg, args.device)}")
    state, opts = _options(args, sampler, seed, state, w, cfg, chain0,
                           devices)
    ck_suffix = f".p{rank}" if nproc > 1 else ""
    with _install_signal_stop() as stopper:
        def on_window(widx, st, outs):
            r = st.r.cpu().numpy()
            for ci in range(c):
                pos_writers[ci].append(r[ci])
            print(f"\rWindow {widx + 1} done...", end="", flush=True)
            return _window_maintenance(args, cfg, widx, st, stopper, w, seed,
                                       ck_suffix=ck_suffix)

        # a rank's chains sum as the one-process run's calls
        with profiled(args), split_of(c * nproc, nproc):
            state, agg = simulate_ensemble(
                cfg, params, state, w, opts=opts, on_window=on_window,
                acf_mode=args.acf_mode, max_fault_retries=args.fault_retries)

    for ci, res in enumerate(agg.chains):
        rk = chain0 + ci
        smcio.write_data_csv(d, cfg, res.energy_trace_full, res.pressure_trace,
                             res.accept_trace, params.gather_lapse, rank=rk)
        smcio.LocalWriter(d, cfg, "local", rank=rk).append(res.density,
                                                          res.mobility)
        smcio.write_total_clusters_csv(d, cfg, res.l1, res.l2, res.l3, rank=rk)
        smcio.write_autocorrelation_csv(d, cfg, res.acf, rank=rk)

    pooled = pool_ensemble_across_processes(agg) if nproc > 1 else agg
    print(f"\n\nAggregate throughput: {pooled.sweeps_per_second:,.0f} "
          f"sweeps/s across {len(pooled.chains)} chains"
          + (f" on {nproc} processes" if nproc > 1 else ""))
    print("\n###  Final ensemble results  ###")
    print(f"Mean energy: {pooled.mean_energy:f} ± {pooled.std_energy:f} "
          "(chain spread)")
    print(f"Mean pressure: {pooled.mean_pressure:f} ± "
          f"{pooled.std_pressure:f}")
    print(f"Average acceptance ratio: {pooled.acceptance_ratio:f}")
    if rank == 0:
        _quenched_summary(args, cfg, d, pooled)
        _write_measurements(args, cfg, d, pooled.gr, pooled.zprofile,
                            pooled.widom_du, pooled.widom_z, pooled.pn,
                            pooled.pt)
        smcio.write_ensemble_data_csv(d, cfg, pooled.chains,
                                      params.gather_lapse)
        smcio.write_info_csv(d, cfg, params, agg.chains[0])
        smcio.write_last_state(d, cfg, agg.chains[0].r_final)
    if args.checkpoint:
        ck_path = smcio.save_checkpoint(
            _ck_with_suffix(args.checkpoint, ck_suffix), state, cfg,
            stream_seed=seed)
        print(f"Full ensemble state checkpointed to {ck_path}")
    return 0


def _quenched_summary(args, cfg, d, agg) -> None:
    """--wall-realizations: per-realization energies, the quenched
    average and the per-realization profiles of a (pooled) ensemble."""
    import numpy as np

    from . import io as smcio

    k_real = max(1, args.wall_realizations)
    if k_real == 1:
        return
    # quenched average: mean within each realization first, then
    # across realizations; their spread is the disorder error bar
    e_k = np.asarray([r.mean_energy for r in agg.chains]) \
        .reshape(k_real, -1).mean(axis=1)
    print("\n###  Quenched wall-disorder summary  ###")
    for i, ek in enumerate(e_k):
        print(f"realization {i} (wall seed {args.wall_seed + i}): "
              f"E = {ek:f}")
    se = np.std(e_k, ddof=1) / np.sqrt(k_real)
    print(f"Disorder-averaged energy: {e_k.mean():f} ± {se:f} "
          "(between-realization SE)")
    # disorder-resolved structure: per-realization profiles (the
    # pooled gr / zprofile CSVs are their average)
    for prof, stem, axis, centers, what in (
            (agg.zprofile_chains, "zprofile_disorder", "z", _z_centers,
             "z profiles"),
            (agg.gr_chains, "gr_disorder", "r", _gr_centers, "g(r)")):
        if prof is not None:
            pth = smcio.write_disorder_profile_csv(
                d, cfg, stem, axis, centers(cfg, prof.shape[-1]),
                prof.reshape(k_real, -1, prof.shape[-1]).mean(axis=1))
            print(f"Per-realization {what} written to {pth}")


def _z_centers(cfg, nbins: int):
    """Bin centers of the uniform z grid of nbins over [-Lz/2, Lz/2]."""
    import numpy as np

    dz = cfg.box_lz / nbins
    return -cfg.box_lz / 2 + dz * (np.arange(nbins) + 0.5)


def _gr_centers(cfg, nbins: int):
    """g(r)'s bin centers in the run's dtype (tpu_smc writes those of
    radial_distribution on the final configuration)."""
    from .observables import gr_edges

    return gr_edges(cfg, nbins, dtype=cfg.torch_dtype)[1].numpy()


def _write_measurements(args, cfg, d, gr, zprofile, widom_du, widom_z, pn,
                        pt) -> None:
    """The measurement layer's files of a single-chain or ensemble run:
    gr_*.csv, zprofile_*.csv, widom_*.csv and ptensor_*.csv, each when
    its samples exist (tpu_smc/cli.py:1293-1335)."""
    from . import io as smcio

    if gr is not None:
        smcio.write_profile_csv(d, cfg, "gr", _gr_centers(cfg, args.gr_bins),
                                gr, "r, g")
    if zprofile is not None:
        smcio.write_profile_csv(d, cfg, "zprofile",
                                _z_centers(cfg, args.z_bins), zprofile,
                                "z, density")
    if widom_du is not None:
        _report_widom(d, cfg, widom_du, widom_z, args.widom_bins)
    if pn is not None:
        _report_ptensor(d, cfg, pn, pt, args.ptensor_bins)


def _report_ptensor(d, cfg, pn, pt, nbins: int) -> None:
    """Write ptensor_*.csv and print the wall-tension integral."""
    import numpy as np

    from . import io as smcio

    dz = cfg.box_lz / nbins
    centers = _z_centers(cfg, nbins)
    p = smcio._fname(d, "ptensor", cfg)
    with open(p, "w") as f:
        f.write("z, p_n, p_t\n")
        for i in range(nbins):
            f.write(f"{centers[i]:0.6f}, {pn[i]:0.9f}, {pt[i]:0.9f}\n")
    gamma = 0.5 * float(np.sum(pn - pt) * dz)
    print(f"Pressure-tensor profile written to {p}")
    print(f"Wall tension (per wall): gamma = 1/2 int (P_N - P_T) dz = "
          f"{gamma:0.6f}")


def _report_widom(d, cfg, du, z, nbins: int) -> None:
    """Print the scalar mu_ex and write the widom_*.csv profile."""
    from . import io as smcio
    from . import widom

    mu, merr = widom.mu_ex(du, cfg.temperature)
    print(f"Widom excess chemical potential: mu_ex = {mu:f} ± {merr:f} "
          f"({du.size} insertions, volume-averaged)")
    centers, muz, ez, cnts = widom.mu_ex_profile(du, z, cfg.temperature, cfg,
                                                 nbins=nbins)
    pth = smcio.write_widom_csv(d, cfg, centers, muz, ez, cnts, mu, merr)
    print(f"mu_ex(z) profile written to {pth}")


def _umbrella_refusals(args, wall_k: int):
    """--umbrella's refusals (tpu_smc/cli.py:838-860, and an explicit
    kernel sampler, which cannot carry the bias); returns the parsed
    window centers."""
    from .umbrella import parse_centers

    if args.temperatures:
        raise SystemExit("--umbrella and --temperatures are separate run "
                         "modes")
    if args.bulk:
        raise SystemExit("--umbrella needs the confined geometry (walls)")
    if wall_k > 1:
        raise SystemExit("--umbrella does not combine with "
                         "--wall-realizations yet")
    if args.resume:
        raise SystemExit("--umbrella does not support --resume yet (rerun "
                         "the windows; they rethermalize inside their own "
                         "restraints)")
    if args.target_acceptance:
        raise SystemExit("--umbrella does not support --target-acceptance")
    if args.chains > 1:
        raise SystemExit("--umbrella sizes its own ensemble (windows x "
                         "--umbrella-replicas); drop --chains")
    if args.sampler in ("dense", "zsorted"):
        raise SystemExit(f"--umbrella runs on the plain engine (the bias "
                         f"enters the acceptance, which the CUDA kernels do "
                         f"not carry); drop --sampler {args.sampler}")
    try:
        return parse_centers(args.umbrella)
    except ValueError as exc:
        raise SystemExit(f"--umbrella: {exc}")


def _run_umbrella(args, cfg, params, d, w_np, seed: int, centers) -> int:
    """--umbrella: K windows x replicas on the plain engine, optional REUS,
    the MBAR-unbiased PMF (tpu_smc/cli.py:838-900)."""
    import numpy as np

    from . import io as smcio
    from .state import seed_words
    from .system import fcc_lattice
    from .umbrella import simulate_umbrella, umbrella_pmf, write_umbrella_csv

    for flag, name in ((args.widom, "--widom"),
                       (args.ptensor_bins, "--ptensor-bins")):
        if flag:
            print(f"Note: {name} does not apply to umbrella runs; ignored.")
    print(f"Umbrella sampling: {len(centers)} windows x "
          f"{args.umbrella_replicas} replicas, spring "
          f"{args.umbrella_spring}, tagged particle {args.umbrella_tag} "
          "(one ensemble)")
    print("Ensemble sweep engine: torch (plain engine, umbrella bias)")
    r0 = smcio.load_last_state(d, cfg)
    if r0 is None:
        r0 = fcc_lattice(cfg)
    try:
        with profiled(args):
            lstate, ures = simulate_umbrella(
                cfg, params, centers, seed_words(seed),
                k_spring=args.umbrella_spring, tag=args.umbrella_tag,
                replicas=args.umbrella_replicas, r0=r0, w=w_np,
                exchange_interval=args.umbrella_exchange,
                device=args.device, stream_seed=seed)
    except ValueError as exc:
        raise SystemExit(str(exc))
    ures = umbrella_pmf(ures, n_bins=args.umbrella_bins, seed=seed)
    print(f"\nUmbrella throughput: {ures.sweeps_per_second:,.1f} "
          f"chain-sweeps/s across {len(centers) * args.umbrella_replicas} "
          "chains (production)")
    print("\n###  Umbrella windows  ###")
    print("z0        f_window   acceptance")
    for i, z0 in enumerate(ures.centers):
        print(f"{z0:8.3f}  {ures.window_f[i]:9.4f}   "
              f"{ures.acceptance[i]:0.4f}")
    if ures.swap_acceptance is not None:
        print("\nWindow-exchange swap acceptance (REUS, every "
              f"{ures.exchange_interval} sweeps):")
        for i in range(len(ures.swap_acceptance)):
            print(f"  z0 {ures.centers[i]:0.2f} <-> "
                  f"{ures.centers[i + 1]:0.2f}: "
                  f"{ures.swap_acceptance[i]:0.3f}")
    path = write_umbrella_csv(d, cfg, ures)
    fin = np.isfinite(ures.pmf)
    print(f"\nPMF resolved over {fin.sum()}/{len(fin)} bins "
          f"(z in [{ures.z_grid[fin].min():0.2f}, "
          f"{ures.z_grid[fin].max():0.2f}]); barrier "
          f"{np.nanmax(ures.pmf):0.3f} T-units")
    print(f"Written to {path}")
    if args.checkpoint:
        ck = smcio.save_checkpoint(args.checkpoint, lstate, cfg,
                                   stream_seed=seed)
        print(f"Full ensemble state checkpointed to {ck}")
    return 0


def _run_ladder(args, cfg, params, d, w_np, w_k, sampler: str, seed: int,
                rw_grid, ck=None, nproc: int = 1, rank: int = 0) -> int:
    """--temperatures: the ladder (tsweep, or parallel tempering with
    --pt-exchange), optional per-level tuning, optional MBAR reweighting;
    with --wall-realizations the realizations ride the replica index.
    ck: a loaded checkpoint of a ladder to resume; --checkpoint writes the
    final ladder state. Over nproc > 1 processes: complete replica
    ladders per process, their streams salted per rank and pooled at the
    end, or with --global-ladder one ladder split over the processes
    (tpu_smc/cli.py:910-1090); process 0 writes the shared files."""
    import numpy as np

    from . import io as smcio

    from .potentials import split_of
    from .state import fold_in, seed_words
    from .tsweep import (FieldOptions, LadderShard,
                         simulate_temperature_sweep, write_tsweep_csv)

    temps = [float(v) for v in args.temperatures.split(",")]
    cpt = args.chains_per_t
    # tuning takes the common key: every process derives the same
    # per-level mobility
    key = common_key = seed_words(seed)
    global_ladder = nproc > 1 and args.global_ladder
    shard = None
    if nproc > 1 and not global_ladder:
        cpt //= nproc
        # distinct per-process replica streams, pooled at the end
        key = fold_in(key, [0xD150 + rank])[0]
    devices = None
    if global_ladder:
        from .distributed import allgather_object, chain_range
        from .ensemble import make_mesh

        # ONE ladder over every process's cards (a process on the CPU
        # counts as one device): each rank's contiguous range of it,
        # split over the rank's own cards
        ladder_c = len(temps) * cpt
        cards = _RANK_CARDS or (args.device,)
        n_dev = sum(allgather_object(len(cards)))
        if ladder_c % n_dev or ladder_c % nproc:
            raise SystemExit(f"--global-ladder: {ladder_c} ladder chains "
                             f"(= {len(temps)} temps x {cpt}) must divide "
                             f"over the job's {n_dev} devices")
        shard = LadderShard(*chain_range(ladder_c, nproc, rank))
        print(f"Global ladder: {ladder_c} chains sharded over {n_dev} "
              f"devices across {nproc} processes (chains {shard.chain0}.."
              f"{shard.chain0 + shard.count - 1} here)")
        if len(cards) > 1 and shard.count % len(cards) == 0:
            devices = tuple(make_mesh(devices=cards))
    else:
        devices = _chain_devices(args.device, len(temps) * cpt, nproc,
                                 "ladder")
    wall_k = max(1, args.wall_realizations)
    w_ladder = w_np
    if w_k is not None:
        # slot-indexed per-chain walls: realization = replica index
        # group, identical across levels, so PT swaps (along the
        # temperature axis within a replica column) never cross them
        g_rep = cpt // wall_k
        w_ladder = np.tile(np.repeat(w_k, g_rep, axis=0),
                           (len(temps), 1, 1))
        print(f"Quenched wall disorder ladder: {wall_k} realizations "
              f"x {g_rep} replicas per level (wall seeds "
              f"{args.wall_seed}..{args.wall_seed + wall_k - 1})")
    print(f"Temperature sweep: {len(temps)} temperatures x {cpt} chains, "
          f"one ensemble ({sampler} engine)")
    a_per_t = None
    if args.target_acceptance:
        from .tuning import tune_mobility_ladder

        lt = tune_mobility_ladder(
            cfg, temps, fold_in(common_key, [0x7E0])[0], w=w_np,
            chains_per_t=cpt,
            target=args.target_acceptance, sampler=sampler,
            device=args.device)
        a_per_t = lt.a_per_t
        print(f"Auto-tuned per-level mobility "
              f"({lt.sweeps_used} tuning sweeps):")
        for i, t in enumerate(lt.temps):
            print(f"  T {t:0.3f}: A = {lt.a_per_t[i]:0.4g} "
                  f"(gamma = {lt.gamma_per_t[i]:0.3g}, "
                  f"acceptance {lt.acceptance[i]:0.3f})")
    state0 = None
    if ck is not None:
        state0 = ck.state
        print(f"Resumed ladder state from {args.resume} "
              f"({int(state0.sweeps[0])} sweeps done); chains are "
              "thermalized — consider eqsteps 0.")
    # a rank's share of ONE ladder sums as the whole ladder's calls
    split = (len(temps) * cpt, nproc if global_ladder else 1)
    kw = dict(chains_per_t=cpt, w=w_ladder, sampler=sampler,
              a_per_t=a_per_t, device=args.device, state0=state0,
              fields=FieldOptions(args.gr_bins, args.z_bins, args.sk_kmax,
                                  args.widom, args.ptensor_bins), shard=shard,
              devices=devices)
    if args.pt_exchange:
        from .pt import simulate_parallel_tempering, write_pt_csv

        if args.pt_exchange == "auto":
            print("Parallel tempering: auto exchange interval (choosing "
                  "from a post-thermalization probe)")
        else:
            print(f"Parallel tempering: exchange attempts every "
                  f"{args.pt_exchange} sweeps")
        with profiled(args), split_of(*split):
            lstate, pt_res = simulate_parallel_tempering(
                cfg, params, temps, key,
                exchange_interval=args.pt_exchange, **kw)
        if nproc > 1 and not global_ladder:
            from .pt import pool_pt_across_processes

            pt_res = pool_pt_across_processes(pt_res, cfg)
        res = pt_res.tsweep
        if rank == 0:
            pt_path = write_pt_csv(d, cfg, pt_res)
        if args.pt_exchange == "auto":
            pa = ", ".join(f"{v:0.3f}" for v in pt_res.probe_acceptance)
            print(f"Auto-chosen exchange interval: "
                  f"{pt_res.exchange_interval} sweeps "
                  f"(probe swap acceptance [{pa}])")
        print("\n###  Replica-exchange swap acceptance  ###")
        for i in range(len(pt_res.pair_t_lo)):
            print(f"T {pt_res.pair_t_lo[i]:0.3f} <-> "
                  f"{pt_res.pair_t_hi[i]:0.3f}: "
                  f"{pt_res.swap_acceptance[i]:0.3f} "
                  f"({pt_res.swap_attempts[i]} attempts)")
        if rank == 0:
            print(f"Written to {pt_path}")
    else:
        with profiled(args), split_of(*split):
            lstate, res = simulate_temperature_sweep(cfg, params, temps,
                                                     key, **kw)
        if nproc > 1 and not global_ladder:
            from .tsweep import pool_tsweep_across_processes

            res = pool_tsweep_across_processes(res, cfg)
    if args.checkpoint and global_ladder:
        # one ladder: its state gathered, one checkpoint from process 0
        from .ensemble import gather_global_state

        whole = gather_global_state(lstate)
        if rank == 0:
            ck_path = smcio.save_checkpoint(args.checkpoint, whole, cfg)
            print(f"Full ladder state checkpointed to {ck_path}")
    elif args.checkpoint:
        ck_path = smcio.save_checkpoint(
            _ck_with_suffix(args.checkpoint,
                            f".p{rank}" if nproc > 1 else ""), lstate, cfg)
        print(f"Full ladder state checkpointed to {ck_path}")
    if rank == 0:
        path = write_tsweep_csv(d, cfg, res)
    # pooled ladders sum the processes' rates; one global ladder counts
    # its chains once
    n_ch = len(temps) * cpt * (1 if global_ladder else nproc)
    print(f"\n\nAggregate throughput: {res.sweeps_per_second:,.0f} "
          f"sweeps/s across {n_ch} chains"
          + (f" on {nproc} processes" if nproc > 1 else ""))
    print("\n###  Temperature sweep results  ###")
    print("T        E_mean      +-err     acc      cv")
    for i, t in enumerate(res.temps):
        print(f"{t:0.3f}  {res.mean_energy[i]:10.4f}  "
              f"{res.err_energy[i]:8.4f}  {res.acceptance[i]:0.4f}  "
              f"{res.cv[i]:8.4f}")
    if args.widom and res.widom_samples is not None:
        from .widom import mu_ex

        print("\n###  Widom mu_ex per level  ###")
        for i, t in enumerate(res.temps):
            mu_l, me_l = mu_ex(res.widom_samples[:, i], float(t))
            print(f"T {t:0.3f}: mu_ex = {mu_l:f} ± {me_l:f}")
    if rank != 0:
        # MBAR runs on the pooled samples, and process 0 writes
        return 0
    print(f"\nWritten to {path}")
    if rw_grid is None:
        return 0
    from .reweight import reweight_from_ladder, write_reweight_csv

    if wall_k > 1:
        # one MBAR solve per wall realization, quenched-averaged
        from .reweight import (reweight_disorder_ladder,
                               write_reweight_disorder_csv)

        rw, rw_parts = reweight_disorder_ladder(res, cfg, rw_grid, wall_k)
        rwd_path = write_reweight_disorder_csv(d, cfg, rw_parts)
        print(f"\n###  MBAR reweighting ({rw.iterations} iterations; "
              f"quenched average over {wall_k} wall realizations, errors = "
              "between-realization SE)  ###")
        print(f"Per-realization curves written to {rwd_path}")
    else:
        rw = reweight_from_ladder(res, cfg, rw_grid, n_boot=16, seed=seed)
        print(f"\n###  MBAR reweighting ({rw.iterations} iterations, 16 "
              "bootstrap draws)  ###")
    rw_path = write_reweight_csv(d, cfg, rw)
    has_p = rw.pressure is not None
    has_mu = rw.mu_ex is not None
    print("T        E_mean     +-err       cv   "
          + ("      P      " if has_p else "")
          + ("    mu_ex    " if has_mu else "") + "   ESS       f")
    for i, t in enumerate(rw.temps):
        pcol = f"{rw.pressure[i]:12.6g} " if has_p else ""
        mcol = f"{rw.mu_ex[i]:12.6g} " if has_mu else ""
        print(f"{t:0.3f}  {rw.mean_energy[i]:10.4f}  "
              f"{rw.err_energy[i]:8.4f}  "
              f"{rw.cv[i]:8.4f} {pcol}{mcol} {rw.ess[i]:8.1f}  "
              f"{rw.free_energy[i]:8.4f}")
    print(f"\nWritten to {rw_path}")
    _write_reweighted_fields(args, cfg, d, rw, lstate)
    return 0


def _write_reweighted_fields(args, cfg, d, rw, lstate) -> None:
    """The reweighted fields on the T grid (tpu_smc/cli.py:1133-1196):
    P_N/P_T(z; T) and the wall tension gamma(T), rho(z; T) and its PMF
    F(z; T) = -T ln rho(z; T), g(r; T) and S(k; T)."""
    from .reweight import pmf_from_profile, write_reweight_profile_csv

    if rw.pn is not None:
        zc_p = _z_centers(cfg, args.ptensor_bins)
        pn_path = write_reweight_profile_csv(d, cfg, "reweight_pn", "z",
                                             zc_p, rw, rw.pn, None)
        pt_path = write_reweight_profile_csv(d, cfg, "reweight_pt", "z",
                                             zc_p, rw, rw.pt, None)
        print(f"P_N(z; T) / P_T(z; T) surfaces written to {pn_path} / "
              f"{pt_path}")
        print("Wall tension gamma(T) = 1/2 int (P_N - P_T) dz:")
        for gi, tv in enumerate(rw.temps):
            err = (f" ± {rw.err_gamma[gi]:0.6f}"
                   if rw.err_gamma is not None else "")
            print(f"  T {tv:0.3f}: gamma = {rw.gamma[gi]:0.6f}{err}")
    if rw.zprofile is not None:
        zc = _z_centers(cfg, args.z_bins)
        zp_path = write_reweight_profile_csv(d, cfg, "reweight_zprofile", "z",
                                             zc, rw, rw.zprofile,
                                             rw.err_zprofile)
        print(f"rho(z; T) surface written to {zp_path}")
        pmf, pmf_err = pmf_from_profile(rw.temps, rw.zprofile,
                                        rw.err_zprofile)
        pmf_path = write_reweight_profile_csv(d, cfg, "reweight_pmf", "z", zc,
                                              rw, pmf, pmf_err)
        print(f"F(z; T) PMF surface written to {pmf_path}")
    if rw.gr is not None:
        gr_path = write_reweight_profile_csv(
            d, cfg, "reweight_gr", "r", _gr_centers(cfg, args.gr_bins), rw,
            rw.gr, rw.err_gr)
        print(f"g(r; T) surface written to {gr_path}")
    if rw.sk is not None:
        from .observables import structure_factor

        kc = structure_factor(lstate.r[:1], cfg,
                              n_kmax=args.sk_kmax)[0].cpu().numpy()
        sk_path = write_reweight_profile_csv(d, cfg, "reweight_sk", "k", kc,
                                             rw, rw.sk, rw.err_sk)
        print(f"S(k; T) surface written to {sk_path}")


if __name__ == "__main__":
    sys.exit(main())
