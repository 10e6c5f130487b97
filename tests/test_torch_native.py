"""The port's C++ CSV formatters (tpu_smc_torch/native) byte for byte
against tpu_smc's writers and formatters and against their plain Python
twins: voxel rows, position rows (half-way cases, signed zeros,
non-finite and huge values), last_state; the measurement layer's
profile, disorder-profile and Widom CSVs on the same arrays; the build
keyed by the source's hash, a failed build raising with the compiler's
log, and no writer falling back to Python."""

import shutil

import numpy as np
import pytest

import tpu_smc.io as jio
from tpu_smc import native as jnative
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc_torch import io as tio
from tpu_smc_torch import native
from tpu_smc_torch.config import SMCConfig as TConfig

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ unavailable")

TIES = np.array([0.0, -0.0, -4e-4, 5e-4, -5e-4, 0.0625, -0.0625, 1.0005,
                 -1.0005, 2.5e-4, -999.9995, 0.1235, 1e13, -1e13, 1e30,
                 np.inf, -np.inf, np.nan, 2.0 ** -30, -(2.0 ** -30)])


def _values(seed=0):
    rng = np.random.default_rng(seed)
    halves = rng.integers(-10 ** 6, 10 ** 6, 3000) / 2000.0
    r32 = rng.normal(0.0, 60.0, 3000).astype(np.float32).astype(np.float64)
    return np.concatenate([TIES, halves, r32])


def test_positions_and_last_state_bytes():
    v = _values()
    row = native.format_positions_row(v)
    assert row == jnative.format_positions_row(v)
    finite = v[np.isfinite(v)]
    assert native.format_positions_row(finite) == \
        (tio.fixed3_csv(finite) + "\n").encode()
    assert native.format_positions_row(finite) == \
        ("".join(f"{x:0.3f}," for x in finite) + "\n").encode()
    last = native.format_last_state(v)
    assert last == jnative.format_last_state(v)
    assert native.format_last_state(finite) == \
        "".join(f"{x:0.12f}," for x in finite).encode()
    assert native.format_positions_row(np.zeros(0)) == b"\n"
    assert native.format_last_state(np.zeros(0)) == b""


@pytest.mark.parametrize("n", [32, 108])
def test_local_rows_bytes(n):
    cfg = TConfig.for_n(n)
    rng = np.random.default_rng(n)
    d = rng.integers(0, 10 ** 12, cfg.n_voxels)
    m = rng.integers(0, 10 ** 6, cfg.n_voxels)
    blob = native.format_local_rows(d, m, cfg.ncx, cfg.ncz)
    assert blob == jnative.format_local_rows(d.astype(np.uint64),
                                             m.astype(np.uint64),
                                             cfg.ncx, cfg.ncz)
    assert blob == tio.local_rows_plain(d, m, cfg.ncx, cfg.ncz).encode()
    with pytest.raises(ValueError):
        native.format_local_rows(d[:-1], m[:-1], cfg.ncx, cfg.ncz)


def test_writers_match_tpu_smc_files(tmp_path):
    """PositionsWriter, LocalWriter, write_last_state and the
    measurement layer's writers give tpu_smc's files byte for byte."""
    n = 108
    jc, tc = JConfig.for_n(n), TConfig.for_n(n)
    rng = np.random.default_rng(3)
    r = rng.normal(0.0, 40.0, (2, n, 3)).astype(np.float32)
    r[0, 0] = [0.0005, -0.0005, -0.0]
    d_t, d_j = tmp_path / "t", tmp_path / "j"
    d_t.mkdir()
    d_j.mkdir()
    dens = rng.integers(0, 5000, tc.n_voxels)
    mob = rng.integers(0, 500, tc.n_voxels)
    centers = np.linspace(-99.0, 99.0, 17)
    vals = rng.normal(0.0, 1.0, 17)
    prof = rng.random((3, 17))
    mu, err = vals.copy(), np.abs(vals) / 10
    mu[2] = np.nan
    cnts = rng.integers(0, 100, 17)
    for io_, cfg, d in ((tio, tc, d_t), (jio, jc, d_j)):
        pw = io_.PositionsWriter(d, cfg, rank=1)
        pw.append(r[0])
        pw.append(r[1])
        lw = io_.LocalWriter(d, cfg, "local_temp", rank=0)
        lw.append(dens, mob)
        lw.append(mob, dens)
        io_.write_last_state(d, cfg, r[1].astype(np.float64) / 3.0)
        io_.write_profile_csv(d, cfg, "zprofile", centers, vals,
                              "z, density")
        io_.write_profile_csv(d, cfg, "gr", centers, vals, "r, g")
        io_.write_disorder_profile_csv(d, cfg, "zprofile_disorder", "z",
                                       centers, prof)
        io_.write_widom_csv(d, cfg, centers, mu, err, cnts, -0.25, 0.01)
    files = sorted(p.name for p in d_j.iterdir())
    assert files == sorted(p.name for p in d_t.iterdir()) and len(files) == 7
    for name in files:
        assert (d_t / name).read_bytes() == (d_j / name).read_bytes(), name


def test_build_is_keyed_by_the_source_and_failures_raise(tmp_path,
                                                         monkeypatch):
    lib = native.build()
    assert native._Lib.path.name.startswith("smc_native_")
    assert native.build() is lib
    bad = tmp_path / "smc_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(native._Lib, "lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    # a writer does not fall back to Python when the library fails
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tio.PositionsWriter(tmp_path, TConfig.for_n(32)).append(
            np.zeros((32, 3)))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()
