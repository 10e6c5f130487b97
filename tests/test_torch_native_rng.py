"""The port's native glibc generator and CNA oracle (tpu_smc_torch/native,
C++ through ctypes) bit for bit against the port's Python GlibcRandom and
tpu_smc.native, and the wall table and lattice, which now draw through
it, bit for bit tpu_smc's (CPU)."""

import numpy as np
import pytest

from tpu_smc import native as jnative
from tpu_smc import system as jsystem
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc_torch import native, rng, system
from tpu_smc_torch.config import SMCConfig


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_generator_bitwise(seed):
    nat = native.NativeGlibcRandom(seed)
    py = rng.GlibcRandom(seed)
    first = [nat.rand() for _ in range(5)]
    assert first == [py.rand() for _ in range(5)]
    arr = nat.rand_array(2000)
    assert arr.dtype == np.uint32
    assert arr.tolist() == [py.rand() for _ in range(2000)]
    ref = jnative.NativeGlibcRandom(seed)
    ref.rand_array(5)
    np.testing.assert_array_equal(arr, ref.rand_array(2000))
    for length in (9, 10, 1):
        bm = nat.box_muller(0.7, length)
        np.testing.assert_array_equal(bm, py.box_muller(0.7, length))
        np.testing.assert_array_equal(bm, ref.box_muller(0.7, length))


def test_seed_zero_and_wide_seeds():
    for seed in (0, 2**32 + 5, -1):
        a = native.NativeGlibcRandom(seed).rand_array(50)
        b = rng.GlibcRandom(seed)
        assert a.tolist() == [b.rand() for _ in range(50)]


@pytest.mark.parametrize("m", [3, 10])
def test_walls_and_lattice_bitwise(m):
    cfg, jcfg = SMCConfig(m=m), JConfig(m=m)
    w, x0, ym = system.build_walls(cfg)
    jw, jx0, jym = jsystem.build_walls(jcfg)
    for a, b in ((w, jw), (x0, jx0), (ym, jym)):
        np.testing.assert_array_equal(a, b)
    for seed in (43, 99):
        np.testing.assert_array_equal(system.build_walls(cfg, seed)[0],
                                      jsystem.build_walls(jcfg, seed)[0])
    np.testing.assert_array_equal(system.fcc_lattice(cfg),
                                  jsystem.fcc_lattice(jcfg))
    # the plain version draws the same table
    g = rng.GlibcRandom(42)
    x0p = g.box_muller(cfg.wall_x0_sigma, m * m) + cfg.wall_x0_mean
    np.testing.assert_array_equal(x0, x0p)


@pytest.mark.parametrize("n,box,cut", [(40, 6.0, 1.5), (108, 12.0, 1.5),
                                       (64, 8.0, 2.2)])
def test_cna_oracle_bitwise(n, box, cut):
    r = np.random.default_rng(n).uniform(-box / 2, box / 2, size=(n, 3))
    r[:, 2] *= 0.3
    got = native.cluster_analysis_ref(r, n, box, cut)
    want = jnative.cluster_analysis_ref(r, n, box, cut)
    assert got.shape == ((n * n - n) // 2, 3) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[:, 0].sum() > 0 and got[:, 1].max() > 0


def test_cna_oracle_on_lattice():
    cfg, jcfg = SMCConfig(), JConfig()
    r = system.fcc_lattice(cfg)
    np.testing.assert_array_equal(
        native.cluster_analysis_ref(r, cfg.n, cfg.box_l, cfg.lca_cutoff),
        jnative.cluster_analysis_ref(jsystem.fcc_lattice(jcfg), jcfg.n,
                                     jcfg.box_l, jcfg.lca_cutoff))
    with pytest.raises(ValueError):
        native.cluster_analysis_ref(r[:-1], cfg.n, cfg.box_l, 1.5)
