"""MBAR reweighting across the temperature ladder (counterpart of
tpu_smc.reweight).

The ladder drivers (tsweep.py, pt.py) collect per-gather potential-energy
samples at every temperature at once; MBAR (Shirts & Chodera 2008)
combines them into E(T), c_v(T), f(T) and, from paired samples taken at
engine-call boundaries, P(T), the fields g(r; T), rho(z; T), S(k; T),
P_N/P_T(z; T) with the wall tension gamma(T), and the Widom mu_ex(T), at
ANY temperature inside or near the ladder; rho(z; T) also gives the
potential of mean force F(z; T) = -T ln rho(z; T). The self-consistent
equations are a dense [K states x M samples] log-sum-exp fixed point,
solved in float32 with plain torch ops, as the JAX package solves them.

Conventions: samples are per-gather POTENTIAL energies, the 3NT/2
kinetic offset is added at output (SMC.c:210-211); cv = var(E)/T^2 under
the reweighted ensemble (SMC.c:249-250); the effective sample size per
target (1/sum w^2) shows where the ladder's support ends.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .config import SMCConfig

_F32 = torch.float32


class ReweightResults(NamedTuple):
    temps: np.ndarray          # [G] target temperatures
    mean_energy: np.ndarray    # [G] incl. the 3NT/2 kinetic offset
    cv: np.ndarray             # [G] var(E)/T^2 under the reweighted ensemble
    ess: np.ndarray            # [G] effective sample size 1/sum(w^2)
    free_energy: np.ndarray    # [G] dimensionless f = -ln Z, f(temps[0]) = 0
    ladder_f: np.ndarray       # [K] converged MBAR free energies (f[0] = 0)
    iterations: int            # self-consistent iterations used
    # replica-bootstrap standard errors (None unless n_boot > 0)
    err_energy: np.ndarray | None = None   # [G]
    err_cv: np.ndarray | None = None       # [G]
    err_f: np.ndarray | None = None        # [G]
    # P(T) incl. ideal rho*T from paired (P, E) samples
    pressure: np.ndarray | None = None     # [G]
    err_pressure: np.ndarray | None = None  # [G]
    # fields from paired per-configuration samples (None unless sampled)
    gr: np.ndarray | None = None           # [G, gr_bins]
    zprofile: np.ndarray | None = None     # [G, z_bins]
    err_gr: np.ndarray | None = None
    err_zprofile: np.ndarray | None = None
    sk: np.ndarray | None = None           # [G, shells]
    err_sk: np.ndarray | None = None
    # P_N/P_T(z; T) with the ideal term at the target T, and the wall
    # tension gamma(T) = 1/2 int (P_N - P_T) dz
    pn: np.ndarray | None = None           # [G, nb]
    pt: np.ndarray | None = None           # [G, nb]
    gamma: np.ndarray | None = None        # [G]
    err_gamma: np.ndarray | None = None
    # Widom mu_ex(T) (widom.mu_ex_reweighted)
    mu_ex: np.ndarray | None = None        # [G]
    err_mu_ex: np.ndarray | None = None


def _mbar_fixed_point(u_kn: torch.Tensor, log_n_k: torch.Tensor, tol: float,
                      max_iter: int):
    """Self-consistent MBAR iteration on u_kn [K, M] (reduced potential of
    every pooled sample under every state) and log sample counts [K].
    Returns (f_k [K] with f[0] = 0, iterations)."""

    def log_denom(f_k):
        # log sum_k N_k exp(f_k - u_kn[k, m])  -> [M]
        return torch.logsumexp(log_n_k[:, None] + f_k[:, None] - u_kn, dim=0)

    f_k = torch.zeros(u_kn.shape[0], dtype=u_kn.dtype, device=u_kn.device)
    it = 0
    resid = float("inf")
    while it < max_iter and resid > tol:
        f_new = -torch.logsumexp(-u_kn - log_denom(f_k)[None, :], dim=1)
        f_new = f_new - f_new[0]
        resid = float((f_new - f_k).abs().max())
        f_k = f_new
        it += 1
    return f_k, it


def mbar_free_energies(e_k: Sequence[np.ndarray], betas,
                       tol: float = 2e-6, max_iter: int = 5_000):
    """Solve the MBAR equations for a temperature ladder.

    e_k: per-state 1-D arrays of potential-energy samples (lengths may
    differ); betas [K]. Returns (f_k, log_denom_m, e_shifted, shift,
    iterations): f_k in the unshifted energy convention (f[0] = 0,
    float64); e_shifted the pooled samples minus `shift` (float32, the
    form every weight computation uses); shift the pooled float64 mean,
    subtracted so that beta*E keeps its mantissa at |E| ~ 1e4. The solve
    runs in float32, so the residual plateaus near 1e-6 and the default
    tol stops there."""
    betas64 = np.asarray(betas, np.float64)
    betas = torch.as_tensor(betas64, dtype=_F32)
    e_all = [np.asarray(e, np.float64).reshape(-1) for e in e_k]
    n_k = np.asarray([e.size for e in e_all], np.int64)
    if (n_k <= 0).any():
        raise ValueError("every ladder state needs at least one sample")
    shift = float(np.mean(np.concatenate(e_all)))
    e_shifted = torch.cat([torch.as_tensor(e - shift, dtype=_F32)
                           for e in e_all])
    log_n_k = torch.as_tensor(np.log(n_k), dtype=_F32)
    u_kn = betas[:, None] * e_shifted[None, :]          # [K, M]
    f_s, iters = _mbar_fixed_point(u_kn, log_n_k, tol, max_iter)
    log_denom = torch.logsumexp(log_n_k[:, None] + f_s[:, None] - u_kn,
                                dim=0)                   # [M]
    # Z(beta) = exp(-beta*shift) Z_shifted(beta): restore the physical
    # energy zero in float64
    f_k = f_s.double().numpy() + (betas64 - betas64[0]) * shift
    return f_k, log_denom, e_shifted, shift, iters


def _weights(beta: float, e_pooled: torch.Tensor, log_denom: torch.Tensor):
    """Normalized MBAR weights [M] at one target beta, and -ln Z."""
    logw = -torch.tensor(beta, dtype=_F32) * e_pooled - log_denom
    f = -torch.logsumexp(logw, dim=0)
    return torch.exp(logw + f), f


def reweight_observables(e_k: Sequence[np.ndarray], temps, t_grid,
                         cfg: SMCConfig | None = None,
                         max_samples_per_state: int = 1 << 17
                         ) -> ReweightResults:
    """MBAR estimates of E(T), c_v(T), f(T) on `t_grid` from ladder
    samples `e_k` taken at `temps`. Samples beyond max_samples_per_state
    are strided down; mean energy includes 3NT/2 when cfg is given."""
    temps = np.asarray(temps, np.float64)
    t_grid = np.atleast_1d(np.asarray(t_grid, np.float64))
    e_k = [np.asarray(e).reshape(-1) for e in e_k]
    e_k = [e[::max(1, -(-len(e) // max_samples_per_state))] for e in e_k]
    f_k, log_denom, e_shifted, shift, iters = mbar_free_energies(
        e_k, 1.0 / temps)
    means, cvs, esss, fs = [], [], [], []
    for t in t_grid:
        w, f = _weights(1.0 / t, e_shifted, log_denom)
        e_mean = torch.sum(w * e_shifted)
        e_var = torch.sum(w * (e_shifted - e_mean) ** 2)
        # e_mean / f are in the shifted convention; var / ess are not
        means.append(float(e_mean) + shift)
        cvs.append(float(e_var) / t ** 2)
        esss.append(float(1.0 / torch.sum(w * w)))
        fs.append(float(f) + shift / t)
    kinetic = 1.5 * cfg.n * t_grid if cfg is not None else 0.0
    fs = np.asarray(fs)
    return ReweightResults(
        temps=t_grid, mean_energy=np.asarray(means) + kinetic,
        cv=np.asarray(cvs), ess=np.asarray(esss), free_energy=fs - fs[0],
        ladder_f=np.asarray(f_k), iterations=iters)


def reweight_paired_observable(e_k: Sequence[np.ndarray],
                               o_k: Sequence[np.ndarray], temps,
                               t_grid) -> np.ndarray:
    """<O>(T) on `t_grid` from PAIRED samples: o_k[k][m] was measured on
    the configuration of e_k[k][m]; MBAR is solved on the pairs' own
    energies."""
    temps = np.asarray(temps, np.float64)
    t_grid = np.atleast_1d(np.asarray(t_grid, np.float64))
    _, log_denom, e_shifted, _, _ = mbar_free_energies(e_k, 1.0 / temps)
    o_pooled = torch.cat([torch.as_tensor(np.asarray(o, np.float64),
                                          dtype=_F32).reshape(-1)
                          for o in o_k])
    return np.asarray([float(torch.sum(_weights(1.0 / t, e_shifted,
                                                log_denom)[0] * o_pooled))
                       for t in t_grid])


def reweight_paired_field(e_k: Sequence[np.ndarray],
                          f_k: Sequence[np.ndarray], temps,
                          t_grid) -> np.ndarray:
    """<F(x)>(T) on `t_grid` of a vector observable: f_k[k] [M_k, B] with
    row m the field (a rho(z) or g(r) histogram) measured on the
    configuration of e_k[k][m]. Returns [G, B]: the scalar case's MBAR
    weights applied to every bin at once (one [G, M] x [M, B] product)."""
    temps = np.asarray(temps, np.float64)
    t_grid = np.atleast_1d(np.asarray(t_grid, np.float64))
    _, log_denom, e_shifted, _, _ = mbar_free_energies(e_k, 1.0 / temps)
    f_pooled = torch.cat([torch.as_tensor(np.asarray(f, np.float64),
                                          dtype=_F32).reshape(
                                              -1, np.shape(f)[-1])
                          for f in f_k])                       # [M, B]
    betas = torch.as_tensor(1.0 / t_grid, dtype=_F32)
    logw = -betas[:, None] * e_shifted[None, :] - log_denom[None, :]
    logw = logw - torch.logsumexp(logw, dim=1, keepdim=True)
    return (torch.exp(logw) @ f_pooled).double().numpy()    # [G, B]


def pmf_from_profile(temps, field, err=None):
    """Potential of mean force F(x; T) = -T ln rho(x; T) of a density
    surface [G, B], shifted so min_x F = 0 per T; empty bins (rho <= 0)
    are NaN. err_F = T err_rho / rho (delta method). Returns (pmf [G, B],
    err_pmf [G, B] or None)."""
    temps = np.atleast_1d(np.asarray(temps, np.float64))
    field = np.asarray(field, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        pmf = np.where(field > 0.0,
                       -temps[:, None] * np.log(np.where(field > 0.0,
                                                         field, 1.0)),
                       np.nan)
        if np.isnan(pmf).all(axis=1).any():
            raise ValueError("a target temperature has an all-empty "
                             "density profile; cannot form a PMF")
        pmf = pmf - np.nanmin(pmf, axis=1, keepdims=True)
        err_pmf = None
        if err is not None:
            err = np.asarray(err, np.float64)
            err_pmf = np.where(field > 0.0,
                               temps[:, None] * err
                               / np.where(field > 0.0, field, 1.0),
                               np.nan)
    return pmf, err_pmf


def reweight_from_ladder(res, cfg: SMCConfig, t_grid, n_boot: int = 0,
                         seed: int = 0) -> ReweightResults:
    """Reweight from a TSweepResults / PTResults carrying energy_samples
    [gathers, n_t, chains_per_t] (and paired pressure samples, when the
    run took them). n_boot > 0 adds replica-bootstrap standard errors:
    whole ladder replicas (the unit that stays independent under
    parallel tempering) are resampled with np.random.default_rng(seed)
    and the full estimate recomputed per draw."""
    ts = getattr(res, "tsweep", res)
    if ts.energy_samples is None or ts.energy_samples.size == 0:
        raise ValueError("ladder results carry no energy samples")
    e_s = ts.energy_samples                     # [gathers, n_t, R]
    e_p = ts.energy_at_pressure

    def paired(arr):
        return arr is not None and e_p is not None and arr.size > 0

    have_p = paired(ts.pressure_samples)
    fields = [(name, arr) for name, arr in (
        ("gr", ts.gr_samples), ("zprofile", ts.zprofile_samples),
        ("sk", ts.sk_samples)) if paired(arr)]
    have_wd = paired(ts.widom_samples)
    have_pt2 = paired(ts.ptensor_n_samples)
    t_grid = np.atleast_1d(np.asarray(t_grid, np.float64))
    ideal = cfg.rho * t_grid   # ideal-gas term, like data.csv (SMC.c:207)

    def split(arr, idx=None):
        a = arr if idx is None else arr[:, :, idx]
        tail = a.shape[3:]     # field samples carry a trailing [bins] axis
        return [a[:, k].reshape((-1,) + tail) for k in range(a.shape[1])]

    def estimate(idx=None):
        out = reweight_observables(split(e_s, idx), ts.temps, t_grid,
                                   cfg=cfg)
        ep = split(e_p, idx) if e_p is not None else None
        if have_p:
            pv = reweight_paired_observable(
                ep, split(ts.pressure_samples, idx), ts.temps, t_grid)
            out = out._replace(pressure=pv + ideal)
        for name, arr in fields:
            out = out._replace(**{name: reweight_paired_field(
                ep, split(arr, idx), ts.temps, t_grid)})
        if have_wd:
            from .widom import mu_ex_reweighted

            out = out._replace(mu_ex=mu_ex_reweighted(
                split(ts.widom_samples, idx), ep, ts.temps, t_grid)[0])
        if have_pt2:
            # the virial parts reweight as fields; the ideal term is
            # rho(z; T') T' at the TARGET temperature
            pn_g, pt_g, rho_g = (reweight_paired_field(
                ep, split(arr, idx), ts.temps, t_grid) for arr in (
                    ts.ptensor_n_samples, ts.ptensor_t_samples,
                    ts.ptensor_rho_samples))
            ideal_z = rho_g * t_grid[:, None]
            pn_g, pt_g = ideal_z + pn_g, ideal_z + pt_g
            dz = cfg.box_lz / pn_g.shape[1]
            out = out._replace(pn=pn_g, pt=pt_g,
                               gamma=0.5 * (pn_g - pt_g).sum(axis=1) * dz)
        return out

    out = estimate()
    if n_boot <= 0:
        return out
    r = e_s.shape[2]
    rng = np.random.default_rng(seed)
    draws = [estimate(rng.integers(0, r, size=r)) for _ in range(n_boot)]

    def sd(name, have=True):
        return (np.std([getattr(d, name) for d in draws], axis=0)
                if have else None)

    return out._replace(
        err_energy=sd("mean_energy"), err_cv=sd("cv"),
        err_f=sd("free_energy"), err_pressure=sd("pressure", have_p),
        err_mu_ex=sd("mu_ex", have_wd), err_gamma=sd("gamma", have_pt2),
        **{f"err_{name}": sd(name) for name, _ in fields})


def subset_ladder_replicas(res, sl):
    """Restrict a TSweepResults' sample arrays to a replica slice
    ([gathers, n_t, R] -> [gathers, n_t, R[sl]]): one quenched wall
    realization at a time (the realization lives in the replica index)."""
    ts = getattr(res, "tsweep", res)

    def cut(a):
        return None if a is None else a[:, :, sl]

    from .tsweep import FIELD_NAMES

    return ts._replace(**{name: cut(getattr(ts, name)) for name in (
        "energy_samples", "pressure_samples", "energy_at_pressure")
        + FIELD_NAMES})


def reweight_disorder_ladder(res, cfg: SMCConfig, t_grid, k_real: int
                             ) -> tuple[ReweightResults, list]:
    """Quenched-disorder MBAR: one solve PER wall realization (each is
    its own Hamiltonian, so mixing them in a level would break MBAR's
    same-state assumption), then the average over realizations, with
    the between-realization standard errors in err_*; ESS summed.
    Returns (combined, per-realization list)."""
    ts = getattr(res, "tsweep", res)
    r = ts.energy_samples.shape[2]
    if k_real < 1 or r % k_real:
        raise ValueError(f"replicas per level ({r}) must divide by the "
                         f"realization count ({k_real})")
    g = r // k_real
    parts = [reweight_from_ladder(
        subset_ladder_replicas(ts, slice(i * g, (i + 1) * g)), cfg, t_grid)
        for i in range(k_real)]

    def avg_se(name):
        vals = [getattr(p, name) for p in parts]
        if any(v is None for v in vals):
            return None, None
        s = np.stack(vals)
        se = (s.std(axis=0, ddof=1) / np.sqrt(k_real) if k_real > 1
              else np.zeros_like(s[0]))
        return s.mean(axis=0), se

    e, e_se = avg_se("mean_energy")
    cv, cv_se = avg_se("cv")
    f, f_se = avg_se("free_energy")
    p, p_se = avg_se("pressure")
    gr, gr_se = avg_se("gr")
    zp, zp_se = avg_se("zprofile")
    sk, sk_se = avg_se("sk")
    mu, mu_se = avg_se("mu_ex")
    gm, gm_se = avg_se("gamma")
    combined = ReweightResults(
        temps=parts[0].temps, mean_energy=e, cv=cv,
        ess=np.stack([pt.ess for pt in parts]).sum(axis=0),
        free_energy=f,
        ladder_f=np.stack([pt.ladder_f for pt in parts]).mean(axis=0),
        iterations=max(pt.iterations for pt in parts),
        err_energy=e_se, err_cv=cv_se, err_f=f_se,
        pressure=p, err_pressure=p_se, gr=gr, err_gr=gr_se,
        zprofile=zp, err_zprofile=zp_se, sk=sk, err_sk=sk_se,
        pn=avg_se("pn")[0], pt=avg_se("pt")[0], gamma=gm, err_gamma=gm_se,
        mu_ex=mu, err_mu_ex=mu_se)
    return combined, parts


def parse_t_grid(spec: str) -> np.ndarray:
    """CLI grid spec: 'tmin:tmax:num' (inclusive linspace) or a comma
    list 'T1,T2,...'."""
    if ":" in spec:
        parts = spec.split(":")
        if len(parts) != 3:
            raise ValueError(f"bad T grid spec {spec!r} "
                             "(want tmin:tmax:num or T1,T2,...)")
        lo, hi, num = float(parts[0]), float(parts[1]), int(parts[2])
        if num < 1 or hi < lo or lo <= 0:
            raise ValueError(f"bad T grid spec {spec!r} "
                             "(need 0 < tmin <= tmax, num >= 1)")
        return np.linspace(lo, hi, num)
    grid = np.asarray([float(v) for v in spec.split(",")], np.float64)
    if (grid <= 0).any():
        # beta = 1/T at T <= 0 would poison the whole free-energy column
        raise ValueError(f"temperatures must be positive: {spec!r}")
    return grid


def write_reweight_csv(d, cfg: SMCConfig, res: ReweightResults):
    """reweight_*.csv, header-driven: optional columns appear when
    computed (tpu_smc's schema for the columns the port computes)."""
    from .io import _fname

    p = _fname(d, "reweight", cfg)
    cols = [("T", res.temps, "0.4f"), ("E_mean", res.mean_energy, "0.9f")]
    if res.err_energy is not None:
        cols.append(("E_err", res.err_energy, "0.9f"))
    cols.append(("cv", res.cv, "0.9f"))
    if res.err_cv is not None:
        cols.append(("cv_err", res.err_cv, "0.9f"))
    if res.pressure is not None:
        cols.append(("P", res.pressure, "0.9f"))
        if res.err_pressure is not None:
            cols.append(("P_err", res.err_pressure, "0.9f"))
    if res.mu_ex is not None:
        cols.append(("mu_ex", res.mu_ex, "0.9f"))
        if res.err_mu_ex is not None:
            cols.append(("mu_ex_err", res.err_mu_ex, "0.9f"))
    if res.gamma is not None:
        cols.append(("gamma", res.gamma, "0.9f"))
        if res.err_gamma is not None:
            cols.append(("gamma_err", res.err_gamma, "0.9f"))
    cols += [("ess", res.ess, "0.1f"), ("f", res.free_energy, "0.9f")]
    with open(p, "w") as f:
        f.write(", ".join(name for name, _, _ in cols) + "\n")
        for i in range(len(res.temps)):
            f.write(", ".join(format(vals[i], fmt)
                              for _, vals, fmt in cols) + "\n")
    return p


def write_reweight_disorder_csv(d, cfg: SMCConfig, parts):
    """Long-format per-realization curves behind the quenched average:
    one row per (realization k, target T)."""
    from .io import _fname

    p = _fname(d, "reweight_disorder", cfg)
    have_p = all(pt.pressure is not None for pt in parts)
    have_mu = all(pt.mu_ex is not None for pt in parts)
    with open(p, "w") as f:
        f.write("k, T, E_mean, cv" + (", P" if have_p else "")
                + (", mu_ex" if have_mu else "") + ", ess, f\n")
        for k, pt in enumerate(parts):
            for g in range(len(pt.temps)):
                row = (f"{k}, {pt.temps[g]:0.4f}, "
                       f"{pt.mean_energy[g]:0.9f}, {pt.cv[g]:0.9f}")
                if have_p:
                    row += f", {pt.pressure[g]:0.9f}"
                if have_mu:
                    row += f", {pt.mu_ex[g]:0.9f}"
                row += f", {pt.ess[g]:0.1f}, {pt.free_energy[g]:0.9f}"
                f.write(row + "\n")
    return p


def write_reweight_profile_csv(d, cfg: SMCConfig, stem: str, axis_name: str,
                               centers, res: ReweightResults,
                               field: np.ndarray, err: np.ndarray | None):
    """Long-format reweighted field, one row per (target T, bin), header
    `T, <axis>, value[, err]` (reweight_zprofile, reweight_pmf, ...)."""
    from .io import _fname

    p = _fname(d, stem, cfg)
    with open(p, "w") as f:
        f.write(f"T, {axis_name}, value" + (", err" if err is not None
                                            else "") + "\n")
        for g in range(len(res.temps)):
            for b in range(field.shape[1]):
                row = (f"{res.temps[g]:0.4f}, {centers[b]:0.6f}, "
                       f"{field[g, b]:0.9f}")
                if err is not None:
                    row += f", {err[g, b]:0.9f}"
                f.write(row + "\n")
    return p
