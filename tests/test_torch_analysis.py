"""python -m tpu_smc_torch.analysis's module against tpu_smc.analysis on
one run directory of the port's CLI (tests/test_analysis_cli.py's run,
`30 120 12 1.1 --dtype float64 --gr-bins 16 --z-bins 16`, cut to 2 + 12
sweeps with its 12 gathers kept: the plain engine on the CPU takes ~30 s
for the full depth): the loaders and summaries, the HTML viewers byte for
byte, and the S(k) panel's numbers (CPU)."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_smc import analysis as ja
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc.observables import structure_factor as jstructure_factor
from tpu_smc_torch import analysis as ta

BOX = (33.0, 200.0)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    from tpu_smc_torch.cli import main

    td = tmp_path_factory.mktemp("cli")
    rc = main(["2", "12", "12", "1.1", "--dtype", "float64", "--device",
               "cpu", "--seed", "7", "--gr-bins", "16", "--z-bins", "16",
               "--data-dir", str(td / "Data")])
    assert rc == 0
    runs = list((td / "Data").iterdir())
    assert len(runs) == 1
    return runs[0]


@pytest.fixture(scope="module")
def runs(run_dir):
    return ta.load_run(run_dir), ja.load_run(run_dir)


def test_load_run_equal(runs):
    a, b = runs
    assert (a.key, a.n, a.m, a.rho, a.temperature, a.local_dims, a.info) \
        == (b.key, b.n, b.m, b.rho, b.temperature, b.local_dims, b.info)
    assert a.n == 108 and a.energy.shape == (12,)
    assert a.positions.shape[1:] == (108, 3)
    for f in ("positions", "energy", "pressure", "accepted", "local", "acf",
              "wall"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=0,
                                   atol=1e-12, err_msg=f)


def test_summaries_equal(runs):
    a, b = runs
    za, zb = ta.z_band_maps(a), ja.z_band_maps(b)
    assert za.keys() == zb.keys()
    for k in za:
        np.testing.assert_allclose(za[k], zb[k], rtol=0, atol=1e-12)
    assert za["density"].sum() == 12 * 108
    for x, y in zip(ta.spectrum(a), ja.spectrum(b)):
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12)
    for k_max in (5, 200):
        np.testing.assert_allclose(ta.acf_check(a, k_max),
                                   ja.acf_check(b, k_max), rtol=0,
                                   atol=1e-12)
    wa, wb = ta.load_local_windows(a), ja.load_local_windows(b)
    assert wa.shape == wb.shape and wa.shape[0] >= 1
    np.testing.assert_allclose(wa, wb, rtol=0, atol=1e-12)


def test_volume_html_byte_identical(runs, tmp_path):
    a, b = runs
    pa = ta.render_volume_html(a, tmp_path / "a")
    pb = ja.render_volume_html(b, tmp_path / "b")
    assert pa.name == pb.name
    assert pa.read_bytes() == pb.read_bytes()


def test_reweight_html_byte_identical(run_dir, tmp_path):
    """The rho(z; T) viewer on a reweight_zprofile CSV (seeded values, a
    NaN error among them) beside the run's files."""
    d = tmp_path / run_dir.name
    shutil.copytree(run_dir, d)
    key = ta.load_run(d).key
    rng = np.random.default_rng(5)
    with open(d / f"reweight_zprofile_{key}.csv", "w") as f:
        f.write("T, z, rho, rho_err\n")
        for t in (1.0, 1.1, 1.2):
            for z in np.linspace(-5, 5, 7):
                e = float("nan") if (t, z) == (1.1, 0.0) else rng.uniform()
                f.write(f"{t:0.4f}, {z:0.6f}, {rng.uniform():0.9f}, "
                        f"{e:0.9f}\n")
    pa = ta.render_reweight_html(ta.load_run(d), tmp_path / "a")
    pb = ja.render_reweight_html(ja.load_run(d), tmp_path / "b")
    assert pa is not None and pa.name == pb.name
    assert pa.read_bytes() == pb.read_bytes()
    assert b"NaN" in pa.read_bytes()


def test_sk_panel_matches_tpu_smc(runs):
    """The port's S(k) panel (observables.structure_factor batched over
    the snapshots, float32) within 1e-5 of tpu_smc's (its jitted vmap of
    tpu_smc.observables.structure_factor over the same float32
    snapshots, averaged)."""
    a, b = runs
    ks, sk = ta.sk_panel(a, BOX, device="cpu")
    cfg = JConfig(n=b.n, box_l=BOX[0], box_lz=BOX[1])
    fn = jax.jit(jax.vmap(lambda r: jstructure_factor(r, cfg),
                          out_axes=(None, 0)))
    jk, jsk = fn(jnp.asarray(b.positions, jnp.float32))
    assert ks.dtype == np.float32 and ks.shape == np.asarray(jk).shape
    np.testing.assert_allclose(ks, np.asarray(jk), rtol=0, atol=1e-5)
    np.testing.assert_allclose(sk, np.asarray(jsk).mean(axis=0), rtol=0,
                               atol=1e-5)
    assert np.all(np.isfinite(sk))


def test_headless_summaries(runs, tmp_path, monkeypatch):
    """Without matplotlib both write the .npz summaries (the port adds
    the S(k) panel's numbers when --box is given)."""
    a, b = runs
    monkeypatch.setattr(ta, "HAVE_MPL", False)
    monkeypatch.setattr(ja, "HAVE_MPL", False)
    pa = ta.render_all(a, tmp_path / "a", box=BOX, device="cpu")
    pb = ja.render_all(b, tmp_path / "b", box=BOX)
    assert [p.name for p in pa] == [p.name for p in pb]
    za, zb = np.load(pa[0]), np.load(pb[0])
    assert set(za.files) == set(zb.files) | {"sk_k", "sk"}
    for k in zb.files:
        np.testing.assert_allclose(za[k], zb[k], rtol=0, atol=1e-12)
    assert np.all(np.isfinite(za["sk"])) and za["sk"].shape == za["sk_k"].shape
