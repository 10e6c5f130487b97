"""tpu_smc_torch.profiling against tpu_smc.profiling: the timers, the
ideal z-skip band, the port's kernel band against the plain z-skip
engine's visited rows and a loop oracle, and the CPU trace (CPU, small
N; --profile-dir in the CLI: test_torch_profile_dir.py)."""

import json

import numpy as np
import pytest

from tpu_smc import profiling as jprof
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc_torch import profiling as prof
from tpu_smc_torch.config import SMCConfig


def test_timers_and_eta_match_tpu_smc(monkeypatch):
    phases = {"thermalization": 12.34, "production": 56.78, "post": 0.05}
    sweeps = {"thermalization": 2000, "production": 8000}
    a, b = prof.PhaseTimer(), jprof.PhaseTimer()
    a.phases.update(phases)
    b.phases.update(phases)
    assert a.report(sweeps) == b.report(sweeps)
    assert a.report() == b.report()
    assert a.seconds("production") == b.seconds("production")
    with a.phase("post"):
        pass
    assert a.seconds("post") >= 0.05
    # the same clock readings give the same rate
    clock = iter([10.0, 10.0, 14.0, 14.0])
    monkeypatch.setattr(prof.time, "perf_counter", lambda: next(clock))
    monkeypatch.setattr(jprof.time, "perf_counter", lambda: next(clock))
    ma, mb = prof.ThroughputMeter(), jprof.ThroughputMeter()
    for m in (ma, mb):
        m.add(100, chains=8)
        m.add(50)
    assert ma.chain_sweeps == mb.chain_sweeps == 850
    assert ma.sweeps_per_second == mb.sweeps_per_second == 850 / 4.0
    for args in ((10.0, 2000, 8000), (3.3, 7, 11, 1.1), (1.0, 0, 10)):
        x, y = prof.estimate_completion(*args), \
            jprof.estimate_completion(*args)
        assert x == y or (np.isnan(x) and np.isnan(y))


@pytest.mark.parametrize("n,c,lz,rb,drift", [(64, 3, 120.0, 8, 0.0),
                                             (256, 4, 200.0, 8, 2.0),
                                             (512, 2, 200.0, 128, 1.5),
                                             (24, 1, 80.0, 16, 0.5)])
def test_ideal_band_equals_tpu_smc(n, c, lz, rb, drift):
    rng = np.random.default_rng(n + c)
    r = rng.uniform(-1, 1, size=(c, n, 3))
    r[:, :, 2] *= lz / 2.1
    r_post = r + rng.normal(scale=drift, size=r.shape)
    want = jprof.zskip_processed_fraction_band(
        r, r_post, JConfig(n=n, box_lz=lz), row_block_rows=rb)
    got = prof.zskip_processed_fraction_band(
        r, r_post, SMCConfig(n=n, box_lz=lz), row_block_rows=rb)
    assert got == pytest.approx(want, abs=1e-12)


def _loop_kernel_rows(r, cfg):
    """Oracle of the port's kernel envelope at a sort point, with loops:
    each chain sorted by z, 128-row blocks over n_pad rows (pads in no
    bound), both passes at the particle's own z +- cutoff (1 + 1e-5),
    rows of [b_lo, b_hi) clamped to n_pad."""
    c, n = r.shape[0], r.shape[1]
    n_pad = -(-n // 8) * 8
    nb = -(-n_pad // 128)
    cut = cfg.lj_cutoff * (1.0 + 1e-5)
    total = 0.0
    for ci in range(c):
        z = np.sort(r[ci, :, 2])
        blocks = [z[b * 128:(b + 1) * 128] for b in range(nb)]
        for zi in z:
            b_lo, b_hi = nb, 0
            for b, blk in enumerate(blocks):
                if len(blk) and blk.min() <= zi + cut and \
                        blk.max() >= zi - cut:
                    b_lo = min(b_lo, b)
                    b_hi = max(b_hi, b + 1)
            if b_hi > b_lo:
                total += min(b_hi * 128, n_pad) - b_lo * 128
    return total / (c * n), n_pad


@pytest.mark.parametrize("n,c,lz", [(300, 2, 120.0), (256, 3, 60.0),
                                    (100, 2, 40.0)])
def test_kernel_band_matches_loop_oracle(n, c, lz):
    rng = np.random.default_rng(n)
    r = rng.uniform(-1, 1, size=(c, n, 3))
    r[:, :, 2] *= lz / 2.1
    cfg = SMCConfig(n=n, box_lz=lz)
    rows, n_pad = _loop_kernel_rows(r, cfg)
    lo, hi = prof.zskip_kernel_fraction_band(r, r, cfg)
    assert lo * n_pad == pytest.approx(rows, abs=1e-9)
    assert hi == pytest.approx(lo, abs=1e-12)     # r_post == r_pre
    # drift only widens the upper edge
    _, hi2 = prof.zskip_kernel_fraction_band(
        r, r + rng.normal(scale=1.0, size=r.shape), cfg)
    assert hi2 >= lo - 1e-12


def test_kernel_band_brackets_plain_zskip_visits():
    """The plain z-skip engine (kernels/sweep.py, the kernel's semantics)
    over one sort cadence at N = 256 x 4 chains visits, per pass, a row
    count inside the model's [lo, hi] band (4 sweeps between sorts, the
    shortest cadence chip_smoke times)."""
    from tpu_smc_torch.state import init_ensemble_state, seed_words

    cfg = SMCConfig.for_n(256, dtype="float32")
    st, w = init_ensemble_state(cfg, seed_words(3), 4, device="cpu")
    out = prof.zskip_cadence_rows(st, w, cfg, cfg.proposal_a,
                                  n_sweeps=4, seed=5)
    lo, hi = prof.zskip_kernel_fraction_band(out["r_pre"], out["r_post"],
                                             cfg)
    n_pad = out["n_pad"]
    rows = out["rows_per_pass"]
    assert n_pad == 256 and rows.shape == (4,)
    assert lo < hi < 1.0
    assert np.all(rows >= lo * n_pad) and np.all(rows <= hi * n_pad), \
        (rows, lo * n_pad, hi * n_pad)
    # the ideal per-chain band (tpu_smc's blocks) is no wider
    ilo, ihi = prof.zskip_processed_fraction_band(out["r_pre"],
                                                  out["r_post"], cfg)
    assert ilo <= lo + 1e-12


def test_inplane_headroom_ordering():
    rng = np.random.default_rng(9)
    cfg = SMCConfig(n=512, box_lz=200.0)
    r = rng.uniform(-1, 1, size=(4, 512, 3))
    r[:, :, 0] *= 16.0
    r[:, :, 1] *= 16.0
    r[:, :, 2] *= 95.0
    h = prof.zskip_inplane_headroom(r, cfg, sample_i=64, seed=2)
    assert h["sphere_rows"] <= h["box_rows"] + 1e-9
    assert h["box_rows"] <= h["z_rows"] + 1e-9
    assert h["z_rows"] <= h["admitted_rows"] + 1e-9
    assert 0.0 < h["box_over_admitted"] <= 1.0
    assert h["row_block"] == 128 and h["n_pad"] == 512
    # a tight cluster admits every row: all ratios 1
    t = prof.zskip_inplane_headroom(rng.normal(size=(2, 32, 3)) * 0.3,
                                    SMCConfig(n=32), sample_i=32)
    assert t["admitted_rows"] == 32.0 and t["box_over_admitted"] == 1.0


def test_timeline_summary_union_and_gaps():
    dev = [("k1", 10.0, 5.0), ("k2", 12.0, 6.0), ("copy", 30.0, 10.0),
           ("k1", 60.0, 5.0)]
    host = [("outer", 0.0, 100.0), ("sync", 18.0, 12.0),
            ("csv", 41.0, 18.0)]
    s = prof.timeline_summary(dev, host, (0.0, 100.0), top=3)
    assert s["busy_us"] == 8.0 + 10.0 + 5.0
    assert s["idle_share"] == pytest.approx(1.0 - 23.0 / 100.0)
    assert s["top_ops"][0] == {"name": "k1", "us": 10.0, "count": 2}
    assert [g["us"] for g in s["gaps"]] == [35.0, 20.0, 12.0]
    # the innermost host range open at each gap's midpoint
    assert s["gaps"][0]["host"] == "outer"
    assert s["gaps"][1]["host"] == "csv"
    assert s["gaps"][2]["host"] == "sync"


def test_cpu_trace_parses(tmp_path):
    import torch

    with prof.trace(tmp_path / "t", device="cpu") as rec:
        x = torch.ones(64, 64)
        for _ in range(3):
            x = x @ x / 64.0
    assert rec.path == tmp_path / "t" / "trace.json"
    data = json.loads(rec.path.read_text())
    assert any(e.get("name", "").startswith("aten::")
               for e in data["traceEvents"])
    assert rec.device_events == 0
    assert "aten::" in rec.table_path.read_text()
    tl = prof.device_timeline(rec.path)
    assert tl["host"] and not tl["device"]
    assert tl["window"][1] > tl["window"][0]
