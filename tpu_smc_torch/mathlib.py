"""Math utility toolbox — the matematicose.c/.h equivalent (counterpart
of tpu_smc.mathlib, in torch).

The reference ships a personal numerics library (matematicose.h:6-28):
sums/means/variances, Hadamard product, argmin/argmax, approximate
equality, secant and bracketing root finders, a spherical-Bessel upward
recurrence, 3/5-point derivative stencils, Simpson integration and 1-D
(stochastic) gradient descent. Most of it is unused by the simulation,
but it is part of the reference's API surface. Each of tpu_smc's
lax.while_loop / lax.scan iterations is a loop on tensors here; a
function `f` passed in takes and returns tensors (elementwise where a
grid of points is evaluated at once).

Reference cites per function in the docstrings. The known `zeros()`
off-by-one (matematicose.c:65-69) has no analog — torch.zeros is safe.
"""

from __future__ import annotations

from typing import Callable

import torch


def _t(x, dtype=torch.float64) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(x, dtype=dtype)


# --- simple reductions (matematicose.c:17-104) -------------------------

def mean(a: torch.Tensor) -> torch.Tensor:
    """mean (matematicose.c:51-54)."""
    return torch.mean(a)


def variance(a: torch.Tensor) -> torch.Tensor:
    """Population variance via E[x^2] - E[x]^2, exactly the reference's
    formula (matematicose.c:97-104)."""
    m = torch.mean(a)
    return torch.mean(a * a) - m * m


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dot (matematicose.c:35-43)."""
    return torch.sum(a * b)


def elforel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hadamard ("element for element") product (matematicose.c:45-49)."""
    return a * b


def argmin(a: torch.Tensor) -> torch.Tensor:
    """double_min_index (matematicose.c:87-94)."""
    return torch.argmin(a)


def argmax(a: torch.Tensor) -> torch.Tensor:
    """double_max_index (matematicose.c:79-86)."""
    return torch.argmax(a)


def is_pico_equal(a, b) -> torch.Tensor:
    """|a-b| < 1e-12 (matematicose.c:8-14)."""
    return torch.abs(_t(a) - _t(b)) < 1e-12


# --- root finding (matematicose.c:107-169) ------------------------------

def secant(
    f: Callable, c: float, x1, x2,
    inf: float = -1e-10, sup: float = 1e-10, max_iter: int = 200,
) -> torch.Tensor:
    """Secant iteration for f(x) = c with the reference's stopping band
    inf < f(x)-c < sup (matematicose.c:132-156)."""

    def g(x):
        return f(x) - c

    x1 = _t(x1)
    x2 = _t(x2, x1.dtype)
    it = 0
    while it < max_iter:
        val = g(x2)
        if not bool((val < inf) | (val > sup)):
            break
        x1, x2 = x2, x2 - val * (x2 - x1) / (val - g(x1))
        it += 1
    return x2


def find_zero_last(
    f: Callable, c: float, x1: float, x2: float, steps: int = 1000, **kw
) -> torch.Tensor:
    """Scan from x2 down to x1 for the LAST sign change of f(x)-c, then
    polish with the secant method (findzero_last, matematicose.c:158-169).
    f is evaluated on the whole grid at once."""
    xs = torch.linspace(x2, x1, steps + 1, dtype=torch.float64)
    vals = f(xs) - c
    sign_change = vals[:-1] * vals[1:] < 0
    # first sign change when scanning downward from x2 = last in x
    idx = int(torch.argmax(sign_change.to(torch.int8)))
    lo, hi = xs[idx + 1], xs[idx]
    return secant(f, c, lo, hi, **kw)


# --- special functions / calculus (matematicose.c:171-231) ---------------

def fast_bessel(x, lmax: int, j0: torch.Tensor) -> torch.Tensor:
    """Spherical-Bessel upward recurrence J_{l+1} = ((2l+1)/x) J_l - J_{l-1}
    (matematicose.c:172-176). j0 supplies the first two values."""
    x = _t(x, j0.dtype)
    jm1, jl = j0[0], j0[1]
    rest = []
    for l in range(1, lmax):
        jp1 = ((2.0 * l + 1.0) / x) * jl - jm1
        rest.append(jp1)
        jm1, jl = jl, jp1
    if not rest:
        return j0[:2].clone()
    return torch.cat([j0[:2], torch.stack(rest)])


def der3(f_vals: torch.Tensor, h: float) -> torch.Tensor:
    """3-point central derivative on a sampled grid (matematicose.c:204-207);
    endpoints are zero-padded."""
    out = (torch.roll(f_vals, -1) - torch.roll(f_vals, 1)) / (2.0 * h)
    out[0] = 0.0
    out[-1] = 0.0
    return out


def der5(f_vals: torch.Tensor, h: float) -> torch.Tensor:
    """5-point central derivative (matematicose.c:209-212)."""
    out = (
        -torch.roll(f_vals, -2) + 8.0 * torch.roll(f_vals, -1)
        - 8.0 * torch.roll(f_vals, 1) + torch.roll(f_vals, 2)
    ) / (12.0 * h)
    out[:2] = 0.0
    out[-2:] = 0.0
    return out


def der5_c(f: Callable, x, h: float):
    """5-point derivative of a callable (matematicose.c:214-217)."""
    return (-f(x + 2 * h) + 8.0 * f(x + h) - 8.0 * f(x - h) + f(x - 2 * h)) / (
        12.0 * h
    )


def simpson(f_vals: torch.Tensor, h: float) -> torch.Tensor:
    """Composite Simpson over an odd-length uniformly sampled grid
    (simpson_integral, matematicose.c:222-231)."""
    odd = f_vals[1:-1:2]
    even_in = f_vals[2:-1:2]
    return h / 3.0 * (f_vals[0] + f_vals[-1] + 4.0 * torch.sum(odd)
                      + 2.0 * torch.sum(even_in))


def _descend(f: Callable, x0: torch.Tensor, h: float, lr, tol: float,
             max_iter: int) -> torch.Tensor:
    """Gradient descent of every element of x0 at once; an element stops
    where its 5-point gradient is within tol (a vmapped lax.while_loop:
    finished lanes keep their value). An iteration that changes neither
    x nor g is a fixed point of the loop body, so the loop ends there
    with the result the remaining iterations would give (the reference's
    default lr is 0 when x1 = -x2)."""
    x = x0
    g = torch.full_like(x0, 10.0)
    it = 0
    while it < max_iter:
        live = torch.abs(g) > tol
        if not bool(live.any()):
            break
        g_new = der5_c(f, x, h)
        x_next = torch.where(live, x - lr * g_new, x)
        g_next = torch.where(live, g_new, g)
        if torch.equal(x_next, x) and torch.equal(g_next, g):
            break
        x, g = x_next, g_next
        it += 1
    return x


def grad_descent_1d(
    f: Callable, x1: float, x2: float, lr: float | None = None,
    tol: float = 1e-7, max_iter: int = 100_000,
) -> torch.Tensor:
    """1-D gradient descent with the reference's 5-point numerical gradient
    (grad_descent_1D, matematicose.c:237-253), from the reference's start
    (x2 - x1) / 2."""
    h = (x2 - x1) / 5e4
    if lr is None:
        scale = torch.abs(_t(f(_t(x2)) - f(_t((x2 - x1) / 2))))
        lr = scale / 200.0
    return _descend(f, _t((x2 - x1) / 2.0), h, lr, tol, max_iter)


def stochastic_grad_descent_1d(
    f: Callable, x1: float, x2: float, n_starts: int = 64,
    generator: torch.Generator | None = None, **kw,
) -> torch.Tensor:
    """Multi-start variant (stochastic_grad_descent_1D,
    matematicose.c:255-278): descend from n_starts uniform points of
    [x1, x2) drawn with `generator` (default: seeded 42), return the x
    with the lowest f. (The reference's version is broken — its
    rand()/RAND_MAX integer division collapses every start to x1 — this
    one draws real uniforms.)"""
    if generator is None:
        generator = torch.Generator().manual_seed(42)
    starts = x1 + (x2 - x1) * torch.rand(n_starts, generator=generator,
                                         dtype=torch.float64)
    h = (x2 - x1) / 5e4
    lr = kw.get("lr") or torch.abs(_t(f(_t(x2)) - f(_t((x2 - x1) / 2)))) \
        / 200.0
    xs = _descend(f, starts, h, lr, kw.get("tol", 1e-7), 100_000)
    return xs[torch.argmin(f(xs))]
