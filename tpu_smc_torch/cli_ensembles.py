"""The ensemble family's run modes of `python -m tpu_smc_torch`
(tpu_smc/cli.py:464-836, 1344-1540): grand-canonical MC (--gcmc, the
isotherm --gcmc-grid), constant pressure (--npt, the isobars --npt-grid
with --npt-reweight) and the Gibbs ensemble (--gibbs, the coexistence
curve --gibbs-temps), each with --checkpoint / --resume. They run on the
plain engine (gcmc, npt, gibbs: CUDA graphs on the card); the CUDA sweep
kernels carry neither an active mask nor a per-chain box, so an explicit
--sampler dense|zsorted is refused."""

from __future__ import annotations

import numpy as np

from .cli import _chain_devices, profiled


def add_arguments(p) -> None:
    """The twelve options of the three modes, as tpu_smc declares them."""
    p.add_argument("--gcmc", type=float, default=None, metavar="MU",
                   help="grand-canonical mode: sample N at chemical "
                        "potential MU (Lambda=1 reduced units). Prints "
                        "<N>/density/acceptances and writes gcmc_*.csv; "
                        "--z-bins adds the density profile")
    p.add_argument("--gcmc-cap", type=int, default=0, metavar="CAP",
                   help="particle capacity (default 2x --n); insertions "
                        "reject at capacity")
    p.add_argument("--gcmc-exchanges", type=int, default=None, metavar="K",
                   help="insertion/deletion attempts per sweep "
                        "(default cap//4)")
    p.add_argument("--gcmc-grid", default=None, metavar="MU1:MU2:K",
                   help="adsorption isotherm: K chemical potentials "
                        "(inclusive linspace, or a comma list) x --chains "
                        "replicas in one ensemble; gcmc_isotherm_*.csv. "
                        "Negative mu needs the = form: --gcmc-grid=-9:-6:7")
    p.add_argument("--npt", type=float, default=None, metavar="P",
                   help="constant-pressure mode (implies --bulk): sample "
                        "the volume at pressure P; npt_*.csv, --gr-bins "
                        "adds g(r) in reduced separation")
    p.add_argument("--npt-grid", default=None, metavar="P1:P2:K",
                   help="equation of state: K pressures x --chains "
                        "replicas in one ensemble; npt_isobar_*.csv")
    p.add_argument("--npt-dlnv", type=float, default=0.1, metavar="D",
                   help="max lnV volume step (default 0.1)")
    p.add_argument("--gibbs", action="store_true",
                   help="Gibbs-ensemble mode (implies --bulk): two boxes "
                        "exchange volume and particles at fixed total N "
                        "and V. --n is the TOTAL count, --rho the OVERALL "
                        "density, --npt-dlnv the volume-exchange step; "
                        "gibbs_*.csv")
    p.add_argument("--gibbs-transfers", type=int, default=None, metavar="K",
                   help="particle-transfer attempts per sweep (default "
                        "N/4)")
    p.add_argument("--gibbs-cap", type=int, default=0, metavar="CAP",
                   help="per-box capacity (default N)")
    p.add_argument("--gibbs-temps", default=None, metavar="T1:T2:K",
                   help="with --gibbs: the coexistence curve, K "
                        "temperatures x --chains replicas in one "
                        "ensemble; gibbs_binodal_*.csv")
    p.add_argument("--npt-reweight", default=None, metavar="P1:P2:K",
                   help="with --npt-grid: MBAR over the pressure axis, the "
                        "continuous equation of state (npt_reweight_*.csv)")


def mode_of(args) -> str | None:
    if args.gcmc is not None or args.gcmc_grid:
        return "gcmc"
    if args.npt is not None or args.npt_grid:
        return "npt"
    if args.gibbs or args.gibbs_temps:
        return "gibbs"
    return None


def refusals(args, mode: str) -> None:
    """tpu_smc's refusals and notes of the three modes, plus an explicit
    kernel sampler, which carries neither mask nor box."""
    flag = {"gcmc": "--gcmc", "npt": "--npt", "gibbs": "--gibbs"}[mode]
    others = [m for m in ("gcmc", "npt", "gibbs")
              if m != mode and (getattr(args, m) not in (None, False)
                                or getattr(args, m + "_grid", None)
                                or (m == "gibbs" and args.gibbs_temps))]
    if args.temperatures or args.umbrella or others:
        raise SystemExit(f"{flag} is its own run mode (no --temperatures/"
                         "--umbrella/--gcmc/--npt/--gibbs)")
    if mode == "gcmc" and args.gcmc is not None and args.gcmc_grid:
        raise SystemExit("--gcmc and --gcmc-grid are exclusive")
    if mode == "npt" and args.npt is not None and args.npt_grid:
        raise SystemExit("--npt and --npt-grid are exclusive")
    if max(1, args.wall_realizations) > 1:
        raise SystemExit(f"{flag} does not combine with --wall-realizations "
                         "yet")
    if args.target_acceptance:
        raise SystemExit(f"{flag} does not support --target-acceptance yet")
    if args.sampler in ("dense", "zsorted"):
        raise SystemExit(f"{flag} runs on the plain engine (the CUDA sweep "
                         "kernels carry no active mask or per-chain box); "
                         f"drop --sampler {args.sampler}")
    if args.gibbs_temps and not args.gibbs:
        args.gibbs = True
    if mode in ("npt", "gibbs") and not args.bulk:
        print(f"Note: {flag} is a bulk mode (volume moves rescale cubic "
              "periodic boxes); --bulk implied.")
        args.bulk = True
    if args.npt_reweight and not args.npt_grid:
        print("Note: --npt-reweight needs the --npt-grid isobar family; "
              "ignored.")
        args.npt_reweight = None


def bulk_physics(args, gkw: dict) -> None:
    """NPT and Gibbs physics (tpu_smc/cli.py:496-509): the truncated and
    shifted potential, the doubled --rho of Gibbs' two boxes, and a fixed
    cutoff min(2.5, 0.45 L0) below the starting box."""
    gkw["lj_shift"] = True
    if args.gibbs:
        gkw["rho"] = 2.0 * gkw.get("rho", 0.1)
    l0 = (args.n / gkw.get("rho", 0.1)) ** (1.0 / 3.0)
    gkw.setdefault("lj_cutoff", min(2.5, 0.45 * l0))


def _engine(args) -> str:
    return ("torch (plain engine, CUDA graphs)" if args.device == "cuda"
            else "torch (plain engine)")


def _grid(spec: str, what: str) -> np.ndarray:
    """MU1:MU2:K / P1:P2:K (inclusive linspace) or a comma list."""
    if ":" in spec:
        pieces = spec.split(":")
        if len(pieces) != 3:
            raise SystemExit(f"bad {what} grid spec {spec!r} "
                             f"(want A:B:K or a comma list)")
        lo, hi, num = float(pieces[0]), float(pieces[1]), int(pieces[2])
        if num < 1:
            raise SystemExit(f"{what} grid needs K >= 1")
        return np.linspace(lo, hi, num)
    return np.asarray([float(v) for v in spec.split(",")], np.float64)


def _resumed(args, load, label: str, cfg):
    """(state, cfg, run dir, stream seed or None) of --resume."""
    from . import io as smcio

    state, ck_cfg, seed = load(args.resume, device=args.device)
    if (ck_cfg.n != cfg.n or ck_cfg.temperature != cfg.temperature
            or ck_cfg.dtype != cfg.dtype):
        print(f"Note: resuming with the checkpoint's config "
              f"(N={ck_cfg.n}, T={ck_cfg.temperature}, {ck_cfg.dtype}); "
              "CLI values ignored.")
    print(f"Resuming {label} from {args.resume}: {state.n_chains} "
          "chain(s) (bitwise continuation)")
    return state, ck_cfg, smcio.run_dir(ck_cfg, args.data_dir), seed


def _rate(res) -> None:
    print(f"Throughput: {res.sweeps_per_second:,.1f} chain-sweeps/s "
          "(production)")


def run(mode: str, args, cfg, params, d, seed: int) -> int:
    from .state import seed_words

    print(f"Ensemble sweep engine: {_engine(args)}")
    if mode == "gcmc":
        return _run_gcmc(args, cfg, params, d, seed, seed_words(seed))
    if mode == "npt":
        return _run_npt(args, cfg, params, d, seed, seed_words(seed))
    return _run_gibbs(args, cfg, params, d, seed, seed_words(seed))


def _run_gcmc(args, cfg, params, d, seed, key) -> int:
    """--gcmc / --gcmc-grid (tpu_smc/cli.py:579-686)."""
    from . import io as smcio
    from .gcmc import (box_volume, gr_rmax, load_gcmc_checkpoint,
                       save_gcmc_checkpoint, simulate_gcmc, write_gcmc_csv)

    cap = args.gcmc_cap or 2 * cfg.n
    n_ch = args.chains
    state0 = None
    if args.resume:
        if args.gcmc_grid:
            raise SystemExit("--gcmc-grid does not support --resume")
        state0, cfg, d, ck_seed = _resumed(args, load_gcmc_checkpoint,
                                           "GCMC", cfg)
        seed = ck_seed if ck_seed is not None else seed
        n_ch, cap = state0.active.shape
    for flag, name in ((args.widom, "--widom"),
                       (args.ptensor_bins, "--ptensor-bins")):
        if flag:
            print(f"Note: {name} does not apply to GCMC runs; ignored.")
    if args.gcmc_grid:
        if args.z_bins:
            print("Note: --z-bins is not accumulated in isotherm mode "
                  "(per-mu states differ); ignored.")
        if args.checkpoint:
            print("Note: --checkpoint is not supported in isotherm mode; "
                  "ignored.")
        return _run_gcmc_isotherm(args, cfg, params, key, d, cap, seed)
    if cfg.pbc_z and cfg.proposal_a < 1e-4:
        print("Note: the bulk reference mobility (A = 4e-8, "
              "SMC_noMPI_noWall.c) freezes displacements — GCMC mixing "
              "then comes entirely from insertion/deletion turnover. Pass "
              "--gamma (e.g. --gamma 0.05) for fluid-scale displacement "
              "moves.")
    print(f"Grand-canonical MC: mu = {args.gcmc:g}, capacity {cap}, "
          f"{n_ch} chain(s), "
          f"{args.gcmc_exchanges or max(1, cap // 4)} exchange "
          f"attempts/sweep (V = {box_volume(cfg):g})")
    with profiled(args):
        gstate, gres = simulate_gcmc(
            cfg, args.gcmc, cap,
            0 if state0 is not None else params.eqsteps, params.maxsteps,
            key, n_chains=n_ch, n_exchange=args.gcmc_exchanges,
            z_bins=args.z_bins, gr_bins=args.gr_bins, state0=state0,
            seed=seed, device=args.device)
    print("\n###  Grand-canonical results  ###")
    print(f"Mean N: {gres.mean_n:f} ± {gres.err_n:f} "
          f"(density {gres.mean_density:g})")
    print(f"Mean potential energy: {gres.mean_energy:f}")
    print(f"Acceptance (displace/insert/delete): "
          f"{gres.disp_acceptance:0.4f} / {gres.insert_acceptance:0.4f} / "
          f"{gres.delete_acceptance:0.4f}")
    if np.isfinite(gres.kappa_t):
        print(f"Isothermal compressibility (number fluctuations): "
              f"kappa_T = {gres.kappa_t:0.6g}  (ideal-gas 1/(rho T) = "
              f"{1.0 / max(gres.mean_density * cfg.temperature, 1e-12):0.6g})")
    if np.isfinite(gres.mu_ex) and gres.mean_density > 0:
        mu_back = cfg.temperature * np.log(gres.mean_density) + gres.mu_ex
        print(f"Self-consistency: in-run Widom mu_ex = {gres.mu_ex:0.4f}, "
              f"T ln(rho) + mu_ex = {mu_back:0.4f} (imposed mu "
              f"{args.gcmc:g})")
    print(f"Energy resync: largest relative drift {gres.resync_drift:0.3g}")
    _rate(gres)
    path = write_gcmc_csv(d, cfg, args.gcmc, gres)
    print(f"Written to {path}")
    if gres.zprofile is not None and args.z_bins:
        dz = cfg.box_lz / args.z_bins
        centers = -cfg.box_lz / 2 + dz * (np.arange(args.z_bins) + 0.5)
        zp = smcio.write_profile_csv(d, cfg, "gcmc_zprofile", centers,
                                     gres.zprofile, "z, density")
        print(f"Density profile written to {zp}")
    if gres.gr is not None and args.gr_bins:
        centers = (np.arange(args.gr_bins) + 0.5) * gr_rmax(cfg) \
            / args.gr_bins
        gp = smcio.write_profile_csv(d, cfg, "gcmc_gr", centers, gres.gr,
                                     "r, g")
        print(f"g(r) written to {gp}")
    if args.checkpoint:
        ck = save_gcmc_checkpoint(args.checkpoint, gstate, cfg,
                                  stream_seed=seed)
        print(f"Full GCMC state checkpointed to {ck}")
    return 0


def _run_gcmc_isotherm(args, cfg, params, key, d, cap, seed) -> int:
    """--gcmc-grid: the whole mu -> <N> isotherm as one ensemble
    (per-chain mu; --chains replicas per grid point;
    tpu_smc/cli.py:1344-1396)."""
    from . import io as smcio
    from .gcmc import box_volume, simulate_gcmc

    grid = _grid(args.gcmc_grid, "mu")
    reps = max(1, args.chains)
    mu_c = np.repeat(grid, reps)
    print(f"Grand-canonical isotherm: {len(grid)} chemical potentials x "
          f"{reps} replicas, capacity {cap}, one ensemble "
          f"(V = {box_volume(cfg):g})")
    with profiled(args):
        _, res = simulate_gcmc(cfg, mu_c, cap, params.eqsteps,
                               params.maxsteps, key, n_chains=len(mu_c),
                               n_exchange=args.gcmc_exchanges, seed=seed,
                               device=args.device)
    n_chain = res.n_trace.mean(axis=0).reshape(len(grid), reps)
    n_mean = n_chain.mean(axis=1)
    n_err = (n_chain.std(axis=1) / np.sqrt(max(1, reps - 1))
             if reps > 1 else np.zeros(len(grid)))
    v = box_volume(cfg)
    _rate(res)
    print("\n###  Adsorption isotherm  ###")
    print("mu        <N>        +-err     density")
    for i, mu in enumerate(grid):
        print(f"{mu:8.3f}  {n_mean[i]:9.3f}  {n_err[i]:8.3f}  "
              f"{n_mean[i] / v:9.6f}")
    if n_mean.max() > 0.9 * cap:
        print(f"WARNING: <N> within 10% of capacity {cap} — raise "
              "--gcmc-cap (insertions reject at capacity, biasing the top "
              "of the isotherm)")
    p = smcio._fname(d, "gcmc_isotherm", cfg)
    with open(p, "w") as f:
        f.write("mu, N_mean, N_err, density\n")
        for i, mu in enumerate(grid):
            f.write(f"{mu:0.6f}, {n_mean[i]:0.6f}, {n_err[i]:0.6f}, "
                    f"{n_mean[i] / v:0.9f}\n")
    print(f"\nWritten to {p}")
    return 0


def _run_npt(args, cfg, params, d, seed, key) -> int:
    """--npt / --npt-grid (tpu_smc/cli.py:688-761)."""
    from .npt import (load_npt_checkpoint, save_npt_checkpoint, simulate_npt,
                      write_npt_csv)

    for flag, name in ((args.widom, "--widom"),
                       (args.ptensor_bins, "--ptensor-bins"),
                       (args.z_bins, "--z-bins")):
        if flag:
            print(f"Note: {name} does not apply to NPT runs; ignored.")
    if cfg.proposal_a < 1e-4:
        print("Note: the bulk reference mobility (A = 4e-8, "
              "SMC_noMPI_noWall.c) freezes displacements — NPT mixing then "
              "comes entirely from volume moves. Pass --gamma (e.g. --gamma "
              "0.05) for fluid-scale displacement moves.")
    n_ch = args.chains
    state0 = None
    if args.resume:
        if args.npt_grid:
            raise SystemExit("--npt-grid does not support --resume")
        state0, cfg, d, ck_seed = _resumed(args, load_npt_checkpoint, "NPT",
                                           cfg)
        seed = ck_seed if ck_seed is not None else seed
        n_ch = state0.n_chains
    if args.npt_grid:
        return _run_npt_isobars(args, cfg, params, key, d, seed)
    devices = _chain_devices(args.device, n_ch, 1, "NPT")
    v_floor = (2.0 * cfg.lj_cutoff) ** 3
    print(f"Constant-pressure MC: P = {args.npt:g}, {n_ch} chain(s), dlnV "
          f"{args.npt_dlnv:g}, rc {cfg.lj_cutoff:g} (hard volume floor "
          f"{v_floor:g}), starting box {cfg.box_l:g}^3")
    with profiled(args):
        nstate, nres = simulate_npt(
            cfg, args.npt, 0 if state0 is not None else params.eqsteps,
            params.maxsteps, key, n_chains=n_ch, dlnv=args.npt_dlnv,
            gr_bins=args.gr_bins, state0=state0, seed=seed,
            device=args.device, devices=devices)
    print("\n###  Constant-pressure results  ###")
    print(f"Mean density: {nres.mean_density:f} ± {nres.err_density:f}  "
          f"(<V> = {nres.mean_v:f})")
    print(f"Mean potential energy: {nres.mean_energy:f}  (configurational "
          f"enthalpy {nres.enthalpy:f})")
    if np.isfinite(nres.kappa_t):
        ideal = 1.0 / max(nres.mean_density * cfg.temperature, 1e-12)
        print(f"Isothermal compressibility (volume fluctuations): "
              f"kappa_T = {nres.kappa_t:0.6g}  (ideal-gas 1/(rho T) = "
              f"{ideal:0.6g})")
    print(f"Acceptance (displace/volume): {nres.disp_acceptance:0.4f} / "
          f"{nres.vol_acceptance:0.4f}")
    print(f"Smallest volume {nres.volume_trace.min():0.6g} (floor "
          f"{v_floor:g})")
    _rate(nres)
    path = write_npt_csv(d, cfg, args.npt, nres)
    print(f"Written to {path}")
    if args.checkpoint:
        ck = save_npt_checkpoint(args.checkpoint, nstate, cfg,
                                 stream_seed=seed)
        print(f"Full NPT state checkpointed to {ck}")
    return 0


def _run_npt_isobars(args, cfg, params, key, d, seed) -> int:
    """--npt-grid: the whole P -> rho(P) equation of state as one
    ensemble, with --npt-reweight's MBAR curve (tpu_smc/cli.py:
    1457-1540)."""
    from . import io as smcio
    from .npt import reweight_isobars, simulate_npt, write_npt_reweight_csv
    from .reweight import parse_t_grid

    grid = _grid(args.npt_grid, "pressure")
    if (grid <= 0).any():
        raise SystemExit("pressures must be positive")
    pg = None
    if args.npt_reweight:
        try:
            pg = parse_t_grid(args.npt_reweight)
        except ValueError as e:
            raise SystemExit(f"--npt-reweight: {e}")
    reps = max(1, args.chains)
    p_c = np.repeat(grid, reps)
    print(f"Equation of state: {len(grid)} pressures x {reps} replicas, "
          f"one ensemble (dlnV {args.npt_dlnv:g}, rc {cfg.lj_cutoff:g}, "
          f"starting box {cfg.box_l:g}^3)")
    devices = _chain_devices(args.device, len(p_c), 1, "NPT isobar")
    with profiled(args):
        _, res = simulate_npt(cfg, p_c, params.eqsteps, params.maxsteps,
                              key, n_chains=len(p_c), dlnv=args.npt_dlnv,
                              seed=seed, device=args.device, devices=devices)
    v_tr = res.volume_trace
    rho_chain = (cfg.n / v_tr).mean(axis=0).reshape(len(grid), reps)
    rho_mean = rho_chain.mean(axis=1)
    rho_err = (rho_chain.std(axis=1) / np.sqrt(max(1, reps - 1))
               if reps > 1 else np.zeros(len(grid)))
    v_grp = v_tr.reshape(v_tr.shape[0], len(grid), reps)
    v_mean = v_grp.mean(axis=(0, 2))
    kappa = (v_grp.var(axis=(0, 2))
             / (cfg.temperature * np.maximum(v_mean, 1e-12)))
    _rate(res)
    print("\n###  Equation of state  ###")
    print("P         rho        +-err     <V>        kappa_T")
    for i, p in enumerate(grid):
        print(f"{p:8.4f}  {rho_mean[i]:9.6f}  {rho_err[i]:8.6f}  "
              f"{v_mean[i]:9.3f}  {kappa[i]:9.5f}")
    v_floor = (2.0 * cfg.lj_cutoff) ** 3
    print(f"Smallest volume {v_tr.min():0.6g} (floor {v_floor:g})")
    if v_mean.min() < 1.3 * v_floor:
        print(f"WARNING: <V> within 30% of the hard volume floor "
              f"{v_floor:g} — the top of the isobar is compressed against "
              "2*rc; rerun with a smaller --lj-cutoff")
    path = smcio._fname(d, "npt_isobar", cfg)
    with open(path, "w") as f:
        f.write("P, rho_mean, rho_err, V_mean, kappa_T\n")
        for i, p in enumerate(grid):
            f.write(f"{p:0.6f}, {rho_mean[i]:0.9f}, {rho_err[i]:0.9f}, "
                    f"{v_mean[i]:0.6f}, {kappa[i]:0.9f}\n")
    print(f"\nWritten to {path}")
    if pg is not None:
        rw = reweight_isobars(res.energy_trace, res.volume_trace, p_c,
                              cfg.temperature, pg, cfg.n,
                              device=args.device)
        print(f"\nMBAR over the pressure axis ({len(grid)} sampled states "
              f"-> {len(pg)} targets):")
        print("P         rho        kappa_T    H_conf      ess")
        for i, p in enumerate(pg):
            print(f"{p:8.4f}  {rw.rho[i]:9.6f}  {rw.kappa_t[i]:9.5f}  "
                  f"{rw.enthalpy[i]:9.3f}  {rw.ess[i]:8.0f}")
        lo, hi = grid.min(), grid.max()
        if (pg < lo).any() or (pg > hi).any():
            print(f"WARNING: targets outside the sampled bracket "
                  f"[{lo:g}, {hi:g}] are extrapolations — check ess")
        prw = write_npt_reweight_csv(d, cfg, rw)
        print(f"Written to {prw}")
    return 0


def _run_gibbs(args, cfg, params, d, seed, key) -> int:
    """--gibbs / --gibbs-temps (tpu_smc/cli.py:763-836)."""
    from .gibbs import (load_gibbs_checkpoint, save_gibbs_checkpoint,
                        simulate_gibbs, write_gibbs_csv)

    for flag, name in ((args.widom, "--widom"),
                       (args.ptensor_bins, "--ptensor-bins"),
                       (args.z_bins, "--z-bins"),
                       (args.gr_bins, "--gr-bins")):
        if flag:
            print(f"Note: {name} does not apply to Gibbs runs; ignored.")
    if cfg.proposal_a < 1e-4:
        print("Note: the bulk reference mobility freezes displacements; "
              "pass --gamma (e.g. --gamma 0.05).")
    n_ch = args.chains
    state0 = None
    if args.gibbs_temps:
        if args.resume:
            raise SystemExit("--gibbs-temps does not support --resume")
        return _run_gibbs_binodal(args, cfg, params, key, d, seed)
    if args.resume:
        state0, cfg, d, ck_seed = _resumed(args, load_gibbs_checkpoint,
                                           "Gibbs", cfg)
        seed = ck_seed if ck_seed is not None else seed
        n_ch = state0.n_chains
    cap = (state0.active.shape[2] if state0 is not None
           else args.gibbs_cap or cfg.n)
    n_tr = args.gibbs_transfers or max(1, cfg.n // 4)
    rho_all = cfg.n / (2.0 * cfg.box_l ** 3)
    print(f"Gibbs-ensemble MC: N = {cfg.n} total, overall rho = "
          f"{rho_all:g}, per-box start {cfg.box_l:g}^3, capacity "
          f"{cap}/box, {n_tr} transfers/sweep, dlnV {args.npt_dlnv:g}, "
          f"{n_ch} chain(s)")
    devices = _chain_devices(args.device, n_ch, 1, "Gibbs")
    with profiled(args):
        gstate, gres = simulate_gibbs(
            cfg, 0 if state0 is not None else params.eqsteps,
            params.maxsteps, key, cap, n_chains=n_ch, dlnv=args.npt_dlnv,
            n_transfer=n_tr, state0=state0, seed=seed, device=args.device,
            devices=devices)
    print("\n###  Gibbs-ensemble results  ###")
    print(f"Branch densities (sorted per sweep): vapor {gres.rho_lo:f} ± "
          f"{gres.err_lo:f}, liquid {gres.rho_hi:f} ± {gres.err_hi:f}")
    if gres.rho_hi > 2.0 * gres.rho_lo:
        print("Two-phase: the boxes bifurcated (coexistence).")
    else:
        print("One-phase: densities coincide (supercritical or "
              "single-phase state point).")
    print(f"In-run chemical potentials (T ln rho + Widom mu_ex from "
          f"transfer ghosts): box1 {gres.mu_box[0]:0.4f}, box2 "
          f"{gres.mu_box[1]:0.4f}")
    print(f"Acceptance (displace/volume/transfer): "
          f"{gres.disp_acceptance:0.4f} / {gres.vol_acceptance:0.4f} / "
          f"{gres.transfer_acceptance:0.4f}")
    v_sum = (gres.l_final.astype(np.float64) ** 3).sum(-1)
    vtot = 2.0 * cfg.box_l ** 3
    print(f"Conservation: N1 + N2 = {cfg.n} at every sweep: "
          f"{gres.n_conserved}; largest |V1 + V2 - Vtot| / Vtot at the "
          f"end {np.abs(v_sum - vtot).max() / vtot:0.3g}")
    _rate(gres)
    path = write_gibbs_csv(d, cfg, gres)
    print(f"Written to {path}")
    if args.checkpoint:
        ck = save_gibbs_checkpoint(args.checkpoint, gstate, cfg,
                                   stream_seed=seed)
        print(f"Full Gibbs state checkpointed to {ck}")
    return 0


def _run_gibbs_binodal(args, cfg, params, key, d, seed) -> int:
    """--gibbs-temps: the coexistence curve as one ladder (per-chain
    temperatures; tpu_smc/cli.py:1398-1437)."""
    from .gibbs import (binodal_from_results, simulate_gibbs,
                        write_gibbs_binodal_csv)
    from .reweight import parse_t_grid

    try:
        grid = parse_t_grid(args.gibbs_temps)
    except ValueError as e:
        raise SystemExit(f"--gibbs-temps: {e}")
    reps = max(1, args.chains)
    temps_c = np.repeat(grid, reps)
    cap = args.gibbs_cap or cfg.n
    n_tr = args.gibbs_transfers or max(1, cfg.n // 4)
    rho_all = cfg.n / (2.0 * cfg.box_l ** 3)
    print(f"Gibbs coexistence curve: {len(grid)} temperatures x {reps} "
          f"replicas, N = {cfg.n} total, overall rho = {rho_all:g}, "
          f"capacity {cap}/box, {n_tr} transfers/sweep, one ensemble")
    devices = _chain_devices(args.device, len(temps_c), 1, "Gibbs ladder")
    with profiled(args):
        state, res = simulate_gibbs(
            cfg, params.eqsteps, params.maxsteps, key, cap,
            n_chains=len(temps_c), dlnv=args.npt_dlnv, n_transfer=n_tr,
            temperatures=temps_c, seed=seed, device=args.device,
            devices=devices)
    rows = binodal_from_results(state, res, temps_c, cfg)
    _rate(res)
    print("\n###  Coexistence curve  ###")
    print("T        rho_v      +-err     rho_l      +-err     |dmu|"
          "   phase")
    for r in rows:
        print(f"{r['t']:6.3f}  {r['rho_v']:9.5f}  {r['err_v']:8.5f}  "
              f"{r['rho_l']:9.5f}  {r['err_l']:8.5f}  {r['dmu']:6.3f}   "
              f"{'two-phase' if r['two_phase'] else 'one-phase'}")
    p = write_gibbs_binodal_csv(d, cfg, rows)
    print(f"\nWritten to {p}")
    return 0

