"""The single-chain run (the reference's main.c) in the port against
tpu_smc: driver.simulate is bitwise chain 0 of simulate_ensemble,
samples what tpu_smc.driver.simulate samples, hands --acf-mode to the
ACF, and the CLI without --chains writes tpu_smc's single-chain file
set."""

import jax
import numpy as np
import pytest
import torch

import tpu_smc.driver as jdriver
import tpu_smc.io as jio
from tpu_smc.config import RunParams
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc.state import init_chain_state as j_init
from tpu_smc_torch import cli as tcli
from tpu_smc_torch.config import SMCConfig as TConfig
from tpu_smc_torch.driver import ObservableOptions, simulate
from tpu_smc_torch.driver_ensemble import simulate_ensemble
from tpu_smc_torch.observables import autocorrelation
from tpu_smc_torch.state import batch_chain_state, init_chain_state, seed_words

# tiny tensors: keep torch's intra-op pool from competing with the
# other test workers for cores
torch.set_num_threads(1)

N = 32


def _slab(n: int = N) -> np.ndarray:
    """A condensed 4 x 4 x 2 slab on the lower wall (at N = 32 the default
    box is a dilute gas whose energy hardly depends on anything)."""
    lz = TConfig.for_n(n).box_lz
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(2),
                             indexing="ij"), -1).reshape(-1, 3)
    return g * 1.5 - [2.25, 2.25, lz / 2 - 1.6]


@pytest.mark.parametrize("chains,seed", [(3, 5), (3, None), (4, 5),
                                         (8, 5)])
def test_single_chain_is_chain0_of_ensemble(chains, seed):
    """One chain from batch_chain_state(seed state, 1) is bitwise chain 0
    of an ensemble from the same seed state, through the whole driver
    (thermalization, gathers, resync, observables), on the plain engine:
    each chain's draws depend on (run seed or chain 0's key, absolute
    sweep, chain index) only, and its sums run over particles, in an
    order set by N alone. (The kernels' plain versions add their 128
    lane sums in a fixed order, so a chain's result does not depend on
    the chain count there either, tests/test_torch_distributed.py; the
    kernels hold the property on the card, tests/test_torch_cuda.py.)"""
    cfg = TConfig.for_n(N, storage_time=2, lca_time=2)
    params = RunParams(eqsteps=2, maxsteps=8, numdata=4)
    opts = ObservableOptions(stream_seed=seed)
    s0, w = init_chain_state(cfg, seed_words(21), r0=_slab(), device="cpu")
    st1, one = simulate(cfg, params, batch_chain_state(s0, 1), w, opts=opts)
    st3, ens = simulate_ensemble(cfg, params,
                                 batch_chain_state(s0, chains), w, opts=opts)
    c0 = ens.chains[0]
    for f in ("r_final", "energy_trace_full", "accept_trace",
              "pressure_trace", "density", "mobility", "l2", "l3", "acf"):
        np.testing.assert_array_equal(getattr(one, f), getattr(c0, f), f)
    assert (one.mean_energy, one.acceptance_ratio, one.tau) == \
        (c0.mean_energy, c0.acceptance_ratio, c0.tau)
    assert torch.equal(st1.r[0], st3.r[0])
    assert not np.array_equal(ens.chains[1].r_final, c0.r_final)
    with pytest.raises(ValueError, match="one chain"):
        simulate(cfg, params, batch_chain_state(s0, 2), w, opts=opts)


def test_single_chain_statistics_match_jax():
    """driver.simulate in both packages, one chain at N = 32, T = 0.8,
    80 sweeps from the condensed slab on the lower wall, where mean E and
    acceptance depend on T and drift as the slab relaxes: the port's
    chain (plain engine) against 16 chains of tpu_smc.driver.simulate
    (XLA, own keys) under the same protocol. Its mean E and acceptance
    lie within 4 combined standard deviations of tpu_smc's mean (the
    spread of one chain's result, from tpu_smc's 16, and the error of
    their mean), the counterpart of tests/test_driver.py's single-chain
    statistics."""
    params = RunParams(0, 80, 40)
    jc = JConfig.for_n(N, temperature=0.8, dtype="float64", lca_time=1000)
    tc = TConfig.for_n(N, temperature=0.8, dtype="float64", lca_time=1000)
    k = 16
    jres = []
    for i in range(k):
        js, jw = j_init(jc, jax.random.key(100 + i), r0=_slab())
        _, jr = jdriver.simulate(jc, params, js, jw,
                                 opts=jdriver.ObservableOptions(clusters=False))
        jres.append((jr.mean_energy, jr.acceptance_ratio))
    jres = np.asarray(jres)
    ts, tw = init_chain_state(tc, seed_words(3), r0=_slab(), device="cpu")
    _, tr = simulate(tc, params, batch_chain_state(ts, 1), tw,
                     opts=ObservableOptions(stream_seed=3))
    sd = jres.std(axis=0, ddof=1) * np.sqrt(1.0 + 1.0 / k)
    got = np.asarray([tr.mean_energy, tr.acceptance_ratio])
    assert (np.abs(got - jres.mean(axis=0)) < 4 * sd).all(), \
        (got, jres.mean(axis=0), sd)
    # the slab is condensed at this T: far from the dilute gas's ~0.95
    assert tr.acceptance_ratio < 0.7 and jres[:, 1].max() < 0.7


@pytest.mark.parametrize("mode", ["reference", "circular", "unbiased"])
def test_acf_mode_reaches_the_acf(mode):
    """simulate(acf_mode=...) computes the ACF of E[0..] in that mode,
    and tau is its sum."""
    cfg = TConfig(n=16, box_l=12.0, box_lz=40.0)
    s0, w = init_chain_state(cfg, seed_words(4), device="cpu")
    _, res = simulate(cfg, RunParams(0, 12, 4), batch_chain_state(s0, 1), w,
                      opts=ObservableOptions(stream_seed=4), acf_mode=mode)
    want = autocorrelation(res.energy_trace_full, cfg.kmax, mode=mode)
    np.testing.assert_array_equal(res.acf, want)
    assert res.tau == float(np.sum(want))


def test_cli_single_chain_writes_jax_file_set(tmp_path, capsys):
    """`python -m tpu_smc_torch EQ MAX NUM T` without --chains runs one
    chain and writes the file names and CSV headers that tpu_smc's
    single-chain run writes (its writers, called as tpu_smc/cli.py
    calls them for one chain), with local_temp holding one voxel block
    per storage window, and prints the final results block."""
    argv = ["2", "8", "4", "1.1", "--n", str(N), "--device", "cpu",
            "--sampler", "torch", "--seed", "3", "--storage-time", "2",
            "--lca-time", "2", "--data-dir", str(tmp_path / "port")]
    assert tcli.main(argv) == 0
    out = capsys.readouterr().out
    for line in ("Ensemble sweep engine: torch", "Time-equivalent throughput",
                 "###  Final results  ###", "Average autocorrelation time:",
                 "Average acceptance ratio:"):
        assert line in out, line
    jc = JConfig.for_n(N)
    d = jio.run_dir(jc, tmp_path / "jax")
    from tpu_smc.system import build_walls

    _, x0, ym = build_walls(jc)
    jio.write_wall_csv(d, jc, x0, ym)
    jio.PositionsWriter(d, jc)
    jio.LocalWriter(d, jc, "local_temp")
    res = type("R", (), dict(
        mean_energy=0.0, std_energy=0.0, mean_pressure=0.0,
        std_pressure=0.0, cv=0.0, tau=0.0, acceptance_ratio=0.0,
        l2=np.zeros(7), l3=np.zeros(7)))()
    jio.write_data_csv(d, jc, np.zeros(9), np.zeros(4), np.zeros(8), 2)
    jio.LocalWriter(d, jc, "local")
    jio.write_total_clusters_csv(d, jc, 0.0, res.l2, res.l3)
    jio.write_autocorrelation_csv(d, jc, np.zeros(3))
    jio.write_info_csv(d, jc, RunParams(2, 8, 4), res)
    jio.write_last_state(d, jc, np.zeros((N, 3)))
    port = tmp_path / "port" / jc.run_name()
    assert sorted(p.name for p in port.iterdir()) == \
        sorted(p.name for p in d.iterdir())
    assert len(list(d.iterdir())) == 9
    for p in d.iterdir():
        q = port / p.name
        if p.name.startswith("last_state"):
            assert len(q.read_text().split(",")) == 3 * N + 1
        elif p.name.startswith("info"):
            assert [ln.split(":")[0] for ln in q.read_text().splitlines()] \
                == [ln.split(":")[0] for ln in p.read_text().splitlines()]
        else:
            assert q.read_text().splitlines()[0] == \
                p.read_text().splitlines()[0], p.name
    key = jc.file_key()
    nvox = jc.ncx * jc.ncx * jc.ncz
    temp = (port / f"local_temp_{key}_rank0.csv").read_text().splitlines()
    assert len(temp) == 1 + 2 * nvox
    blocks = np.asarray([[int(v) for v in ln.split(",")] for ln in temp[1:]])
    local = np.asarray([[int(v) for v in ln.split(",")] for ln in
                        (port / f"local_{key}_rank0.csv").read_text()
                        .splitlines()[1:]])
    # the window increments add up to the cumulative counts
    np.testing.assert_array_equal(
        blocks[:nvox, 3:] + blocks[nvox:, 3:], local[:, 3:])
    assert local[:, 3].sum() == 4 * N
    rows = (port / f"positions_{key}_rank0.csv").read_text().splitlines()
    assert len(rows) == 1 + 1 + 2
