"""tpu_smc_torch.mathlib (the matematicose toolbox in torch) against
tpu_smc.mathlib on the same inputs: the reductions and stencils to
float64 round-off, the iterative solvers to tests/test_mathlib.py's
tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_smc import mathlib as J
from tpu_smc_torch import mathlib as T

RNG = np.random.default_rng(12)
A = RNG.normal(size=257)
B = RNG.normal(size=257)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


@pytest.mark.parametrize("name", ["mean", "variance", "argmin", "argmax"])
def test_reductions(name):
    got = _np(getattr(T, name)(torch.tensor(A)))
    want = np.asarray(getattr(J, name)(jnp.asarray(A)))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("name", ["dot", "elforel"])
def test_products(name):
    got = _np(getattr(T, name)(torch.tensor(A), torch.tensor(B)))
    want = np.asarray(getattr(J, name)(jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


def test_is_pico_equal():
    a = np.array([1.0, 1.0, 2.0, -3.0])
    b = np.array([1.0 + 5e-13, 1.0 + 5e-12, 2.0, -3.0 - 1e-11])
    got = _np(T.is_pico_equal(torch.tensor(a), torch.tensor(b)))
    want = np.asarray(J.is_pico_equal(jnp.asarray(a), jnp.asarray(b)))
    assert got.tolist() == want.tolist() == [True, False, True, False]
    assert bool(T.is_pico_equal(0.1 + 0.2, 0.3))


@pytest.mark.parametrize("f,c,x1,x2,root", [
    ("sq", 0.0, 1.0, 2.0, np.sqrt(2.0)),
    ("cube", 8.0, 1.0, 3.0, 2.0),
])
def test_secant(f, c, x1, x2, root):
    fj = {"sq": lambda x: x * x - 2.0, "cube": lambda x: x ** 3}[f]
    got = float(T.secant(fj, c, x1, x2))
    want = float(J.secant(fj, c, x1, x2))
    assert got == pytest.approx(root, abs=1e-8)
    assert got == pytest.approx(want, abs=1e-12)


def test_find_zero_last():
    got = float(T.find_zero_last(torch.sin, 0.0, 2.0, 7.0))
    want = float(J.find_zero_last(jnp.sin, 0.0, 2.0, 7.0))
    assert got == pytest.approx(2 * np.pi, abs=1e-6)
    assert got == pytest.approx(want, abs=1e-12)


@pytest.mark.parametrize("x,lmax", [(1.0, 4), (2.5, 6), (0.7, 2)])
def test_fast_bessel(x, lmax):
    j0 = np.array([np.sin(x) / x, np.sin(x) / x**2 - np.cos(x) / x])
    got = _np(T.fast_bessel(x, lmax, torch.tensor(j0)))
    want = np.asarray(J.fast_bessel(jnp.asarray(x), lmax, jnp.asarray(j0)))
    assert got.shape == want.shape == (lmax + 1,)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name", ["der3", "der5"])
def test_stencils(name):
    xs = np.linspace(0.0, 3.0, 61)
    vals = np.sin(xs) * np.exp(-xs)
    h = xs[1] - xs[0]
    got = _np(getattr(T, name)(torch.tensor(vals), h))
    want = np.asarray(getattr(J, name)(jnp.asarray(vals), h))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)


def test_der5_c_and_simpson():
    f = lambda x: x ** 3
    assert float(T.der5_c(f, 2.0, 1e-3)) == pytest.approx(
        float(J.der5_c(f, 2.0, 1e-3)), rel=1e-13)
    xs = np.linspace(0, np.pi, 101)
    got = float(T.simpson(torch.tensor(np.sin(xs)), xs[1] - xs[0]))
    want = float(J.simpson(jnp.asarray(np.sin(xs)), xs[1] - xs[0]))
    assert got == pytest.approx(2.0, rel=1e-6)
    assert got == pytest.approx(want, rel=1e-13)


def test_grad_descent_1d():
    f = lambda x: (x - 1.5) ** 2
    got = float(T.grad_descent_1d(f, 0.0, 4.0))
    want = float(J.grad_descent_1d(f, 0.0, 4.0))
    assert got == pytest.approx(1.5, abs=1e-4)
    assert got == pytest.approx(want, abs=1e-10)
    g = lambda x: (x - 0.3) ** 4 + 0.5 * x * x
    got = float(T.grad_descent_1d(g, -1.0, 2.0, lr=0.05))
    want = float(J.grad_descent_1d(g, -1.0, 2.0, lr=0.05))
    assert got == pytest.approx(want, abs=1e-10)


def test_stochastic_grad_descent_1d():
    """Both packages find the double well's global minimum from 16 starts
    at an explicit rate; at the reference's default rate (0 here: x1 =
    -x2) every start stays put and the best start wins, as in tpu_smc."""
    f = lambda x: (x * x - 1) ** 2 * 0.1 + (x - 3) ** 2 * 0.05
    xs = np.linspace(-4, 4, 400001)
    x_min = xs[np.argmin(f(xs))]
    gen = torch.Generator().manual_seed(7)
    got = float(T.stochastic_grad_descent_1d(f, -4.0, 4.0, n_starts=16,
                                             generator=gen, lr=0.02))
    want = float(J.stochastic_grad_descent_1d(f, -4.0, 4.0, n_starts=16,
                                              lr=0.02))
    assert got == pytest.approx(x_min, abs=1e-4)
    assert got == pytest.approx(want, abs=1e-5)
    gen = torch.Generator().manual_seed(3)
    starts = -4.0 + 8.0 * torch.rand(16, generator=gen, dtype=torch.float64)
    best = float(starts[torch.argmin(f(starts))])
    got = float(T.stochastic_grad_descent_1d(
        f, -4.0, 4.0, n_starts=16, generator=torch.Generator().manual_seed(3)))
    assert got == best
    assert np.isfinite(float(J.stochastic_grad_descent_1d(
        f, -4.0, 4.0, n_starts=16)))
