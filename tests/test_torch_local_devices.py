"""The batched drivers with their chains split over a list of devices, as
tpu_smc splits them over a host's devices (tests/test_ladder_mesh.py,
tests/test_npt.py:278-314, tests/test_gibbs.py:126-160): on ("cpu",
"cpu") every run is bitwise the one-device run of the same seed, on the
plain engine and on the kernel engines' plain versions. The temperature
sweep, parallel tempering with its swap counts and the auto probe, the
mobility tuning, NPT and Gibbs (one block, the driver, resume), the
pair sums at C and C/2 chains, the CLI runs with the device helper
patched, and the CLI's messages and prompts against tpu_smc's."""

import argparse
import io

import jax
import numpy as np
import pytest
import torch

import tpu_smc.cli as jcli
import tpu_smc.ensemble as jens
from tpu_smc_torch import cli as tcli
from tpu_smc_torch import cli_ensembles as tcle
from tpu_smc_torch import gcmc as tgc
from tpu_smc_torch import gibbs as tgb
from tpu_smc_torch import npt as tnpt
from tpu_smc_torch import potentials as tpot
from tpu_smc_torch import pt as tpt
from tpu_smc_torch import tsweep as tts
from tpu_smc_torch import tuning as ttune
from tpu_smc_torch.config import RunParams, SMCConfig
from tpu_smc_torch.state import init_ensemble_state, seed_words

# tiny tensors: keep torch's intra-op pool from competing with the
# other test workers for cores
torch.set_num_threads(1)

TWO = ["cpu", "cpu"]
TEMPS = [1.0, 1.3]
ENGINES = ["torch", "dense", "zsorted"]


def _equal(a, b) -> bool:
    """Results (NamedTuples of arrays, floats, ints and None) equal to
    the bit, the measured rate aside."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "sweeps_per_second":
            continue
        if x is None or y is None:
            if x is not y:
                return False
        elif hasattr(x, "_fields"):
            if not _equal(x, y):
                return False
        elif not np.array_equal(np.asarray(x), np.asarray(y),
                                equal_nan=np.asarray(x).dtype.kind == "f"):
            return False
    return True


def _states_equal(s1, s2) -> bool:
    import dataclasses

    return all(torch.equal(getattr(s1, f.name), getattr(s2, f.name))
               for f in dataclasses.fields(s1))


@pytest.mark.parametrize("sampler", ENGINES)
def test_tsweep_two_devices_bitwise(sampler):
    """tsweep over 2 devices: per-chain rows, fields and the returned
    state bitwise one device's (tests/test_ladder_mesh.py:22-44)."""
    cfg = SMCConfig.for_n(16)
    kw = dict(chains_per_t=4, sampler=sampler, device="cpu",
              fields=tts.FieldOptions(gr_bins=4, z_bins=4))
    s1, r1 = tts.simulate_temperature_sweep(cfg, RunParams(4, 12, 4), TEMPS,
                                            seed_words(3), **kw)
    s2, r2 = tts.simulate_temperature_sweep(cfg, RunParams(4, 12, 4), TEMPS,
                                            seed_words(3), devices=TWO, **kw)
    assert _equal(r1, r2) and _states_equal(s1, s2)


@pytest.mark.parametrize("sampler", ENGINES)
def test_pt_two_devices_bitwise(sampler):
    """PT over 2 devices, each exchange gathered to the first: swap
    counts, samples and state bitwise one device's
    (tests/test_ladder_mesh.py:46-63)."""
    cfg = SMCConfig.for_n(16)
    kw = dict(chains_per_t=4, exchange_interval=4, sampler=sampler,
              device="cpu")
    s1, r1 = tpt.simulate_parallel_tempering(cfg, RunParams(4, 12, 4), TEMPS,
                                             seed_words(3), **kw)
    s2, r2 = tpt.simulate_parallel_tempering(cfg, RunParams(4, 12, 4), TEMPS,
                                             seed_words(3), devices=TWO, **kw)
    assert r1.swap_attempts.sum() > 0
    assert _equal(r1, r2) and _states_equal(s1, s2)


def test_pt_auto_probe_two_devices_bitwise():
    """--pt-exchange auto over 2 devices: the probe's swap acceptance and
    the chosen interval bitwise one device's."""
    cfg = SMCConfig.for_n(4)
    kw = dict(chains_per_t=2, exchange_interval="auto", sampler="torch",
              device="cpu")
    _, r1 = tpt.simulate_parallel_tempering(cfg, RunParams(0, 4, 4), TEMPS,
                                            seed_words(5), **kw)
    _, r2 = tpt.simulate_parallel_tempering(cfg, RunParams(0, 4, 4), TEMPS,
                                            seed_words(5), devices=TWO, **kw)
    assert r1.probe_acceptance is not None and _equal(r1, r2)


@pytest.mark.parametrize("sampler", ENGINES)
def test_tune_mobility_two_devices_bitwise(sampler):
    """Every probe block sharded, the acceptance pooled in chain order:
    the tuned A, its search history and the burnt-in state bitwise one
    device's."""
    cfg = SMCConfig.for_n(16)
    st, w = init_ensemble_state(cfg, seed_words(5), 8, device="cpu")
    kw = dict(target=0.6, sampler=sampler, seed=9, sweeps_per_block=3,
              max_blocks=4)
    s1, t1 = ttune.tune_mobility(cfg, st, w, **kw)
    s2, t2 = ttune.tune_mobility(cfg, st, w, devices=TWO, **kw)
    assert len(t1.history) > 1
    assert t1 == t2 and _states_equal(s1, s2)


def _npt_cfg():
    return SMCConfig.bulk(n=12, temperature=2.0, rho=0.25, gamma=0.02,
                          lj_shift=True, lj_cutoff=1.8)


def _gibbs_cfg():
    return SMCConfig.bulk(n=16, temperature=1.2, rho=0.6, gamma=0.02,
                          lj_shift=True, lj_cutoff=1.3)


def test_npt_block_halves_bitwise():
    """One npt_block on each half of the chains, with its chain0 and the
    global chain 0's key, is bitwise those chains of the whole block
    (tests/test_npt.py:278-298)."""
    cfg = _npt_cfg()
    st = tgc.batch_state(tnpt.init_npt_state(cfg, seed_words(3),
                                             device="cpu"), 6)
    ps = np.repeat([0.3, 1.0, 2.5], 2)
    seed = st.key[0]
    whole, tr = tnpt.npt_block(st, cfg, ps, 0.05, 0.2, 4, seed=seed,
                               track_virial=True)
    from tpu_smc_torch.ensemble import shard_ensemble

    for part, c0 in shard_ensemble(st, TWO):
        half, trh = tnpt.npt_block(part, cfg, ps[c0:c0 + 3], 0.05, 0.2, 4,
                                   seed=seed, chain0=c0, track_virial=True)
        sl = slice(c0, c0 + 3)
        assert torch.equal(half.r, whole.r[sl])
        assert torch.equal(half.l, whole.l[sl])
        assert torch.equal(half.vol_acc, whole.vol_acc[sl])
        for a, b in zip(trh, tr):
            assert a is None and b is None or torch.equal(a, b[:, sl])
    assert int(whole.vol_acc.sum()) > 0


@pytest.mark.parametrize("kw", [dict(), dict(gr_bins=4, track_virial=True)])
def test_npt_driver_two_devices_bitwise(kw):
    """simulate_npt over 2 and 3 devices, the pressures cut with their
    chains, the exact-energy resync at absolute multiples of chunk:
    bitwise one device's (the traces, drift, g(r), virial, state)."""
    cfg = _npt_cfg()
    ps = np.repeat([0.3, 1.0, 2.5], 2)
    args = (cfg, ps, 4, 10, seed_words(3))
    run = dict(n_chains=6, dlnv=0.1, chunk=4, seed=7, device="cpu", **kw)
    s1, r1 = tnpt.simulate_npt(*args, **run)
    for devs in (TWO, ["cpu"] * 3):
        s2, r2 = tnpt.simulate_npt(*args, devices=devs, **run)
        assert _equal(r1, r2) and _states_equal(s1, s2)


def test_npt_resume_two_devices_bitwise():
    """A sharded run resumed from its returned state (eqsteps 0, the
    resync off the block boundary) ends bitwise the one-device
    continuation; the seedless streams are the global chain 0's."""
    cfg = _npt_cfg()
    run = dict(n_chains=4, dlnv=0.1, chunk=4, device="cpu")
    ends = []
    for devs in (None, TWO):
        s, _ = tnpt.simulate_npt(cfg, 1.0, 4, 6, seed_words(3),
                                 devices=devs, **run)
        ends.append(tnpt.simulate_npt(cfg, 1.0, 0, 6, seed_words(3),
                                      state0=s, devices=devs, **run))
    (s1, r1), (s2, r2) = ends
    assert int(s1.sweeps[0]) == 16
    assert _equal(r1, r2) and _states_equal(s1, s2)


def test_gibbs_block_halves_bitwise():
    """One gibbs_block on each half of the chains (the displacement
    stream's chain word 2 chain0 + box, the volume and transfer streams'
    chain0) is bitwise those chains of the whole block
    (tests/test_gibbs.py:126-141)."""
    cfg = _gibbs_cfg()
    st = tgc.batch_state(tgb.init_gibbs_state(cfg, seed_words(3), 16,
                                              device="cpu"), 4)
    seed = st.key[0]
    whole, tr = tgb.gibbs_block(st, cfg, 0.05, 0.2, 4, 4, seed=seed)
    from tpu_smc_torch.ensemble import shard_ensemble

    for part, c0 in shard_ensemble(st, TWO):
        half, trh = tgb.gibbs_block(part, cfg, 0.05, 0.2, 4, 4, seed=seed,
                                    chain0=c0)
        sl = slice(c0, c0 + 2)
        assert torch.equal(half.r, whole.r[sl])
        assert torch.equal(half.active, whole.active[sl])
        assert torch.equal(half.boltz_sum, whole.boltz_sum[sl])
        for a, b in zip(trh, tr):
            assert torch.equal(a, b[:, sl])
    assert int(whole.tr_acc.sum()) > 0 and int(whole.vol_acc.sum()) > 0


@pytest.mark.parametrize("temps", [None, np.repeat([0.9, 1.6], 2)])
def test_gibbs_driver_two_devices_bitwise(temps):
    """simulate_gibbs over 2 devices (and the coexistence curve's
    per-chain temperatures): bitwise one device's, N1 + N2 = N at every
    sweep and V1 + V2 = Vtot (tests/test_gibbs.py:143-160)."""
    cfg = _gibbs_cfg()
    run = dict(n_chains=4, chunk=4, seed=5, device="cpu", temperatures=temps)
    s1, r1 = tgb.simulate_gibbs(cfg, 4, 10, seed_words(3), 16, **run)
    s2, r2 = tgb.simulate_gibbs(cfg, 4, 10, seed_words(3), 16, devices=TWO,
                                **run)
    assert _equal(r1, r2) and _states_equal(s1, s2)
    assert r2.n_conserved
    v = (s2.l.double() ** 3).sum(-1)
    np.testing.assert_allclose(v.numpy(), 2.0 * cfg.box_l ** 3, rtol=1e-5)


@pytest.mark.parametrize("shape", ["nvt", "box", "gibbs"])
def test_pair_sum_bits_equal_at_c_and_half(monkeypatch, shape):
    """The pair sums of C chains, and of each half alone, agree to the
    bit once the chains outgrow one row chunk (PAIR_BUDGET lowered so
    that 4 chains fill it): the chain blocks of potentials._pair_sum.
    Without them the row chunk follows the chain count. Under a box the
    rows add in potentials.fixed_order_sum's order, within float64
    round-off of torch's sum."""
    cfg = (SMCConfig.for_n(32) if shape == "nvt"
           else SMCConfig.bulk(n=32, temperature=2.0, rho=0.5,
                               lj_shift=True, lj_cutoff=1.5))
    monkeypatch.setattr(tpot, "PAIR_BUDGET", 4 * 32 * 32)
    rng = np.random.default_rng(1)
    c = 16
    lead = (c, 2) if shape == "gibbs" else (c,)
    half = slice(0, c // 2), slice(c // 2, c)
    from tpu_smc_torch.system import fcc_lattice

    r0 = fcc_lattice(cfg) if shape == "nvt" else tnpt.cubic_grid(cfg, 32)
    r = torch.as_tensor(r0 + rng.normal(0.0, 0.05, lead + (32, 3)),
                        dtype=torch.float32)
    if shape == "nvt":
        def fn(sl):
            return tpot.pair_energy_total(r[sl], cfg), \
                tpot.pair_virial_pressure(r[sl], cfg)
    else:
        box = torch.as_tensor(cfg.box_l * rng.uniform(0.97, 1.03, lead),
                              dtype=torch.float32)
        active = torch.as_tensor(rng.uniform(size=lead + (32,)) < 0.8)

        def fn(sl):
            return (tgc.total_energy_masked(r[sl], active[sl],
                                            r.new_zeros((0,)), cfg,
                                            box=box[sl]),
                    tpot.pair_virial_pressure(r[sl], cfg, box=box[sl]))
    whole = fn(slice(None))
    for a, b in zip(whole, zip(*(fn(sl) for sl in half))):
        assert torch.equal(a, torch.cat(b))
    x = torch.as_tensor(rng.normal(size=(3, 37)))
    np.testing.assert_allclose(tpot.fixed_order_sum(x).numpy(),
                               x.sum(-1).numpy(), rtol=1e-13)


# ----------------------------------------------------------------------
# The CLI
# ----------------------------------------------------------------------

def _run_cli(argv, tmp, patch_devices, monkeypatch, capsys):
    """cli.main on argv into tmp; with patch_devices the device helper
    of every mode returns ("cpu", "cpu"). --target-acceptance tunes in
    short blocks (both runs alike). Returns (the run's CSV files, name ->
    bytes; the devices the tuning was given)."""
    def two(device, n, nproc, label=""):
        return tuple(torch.device(d) for d in TWO)

    tuned_on = []
    real_tune = ttune.tune_mobility

    def short_tune(*args, **kw):
        tuned_on.append(kw["devices"])
        return real_tune(*args, **{**kw, "sweeps_per_block": 3,
                                   "max_blocks": 3})

    with monkeypatch.context() as m:
        if patch_devices:
            m.setattr(tcli, "_chain_devices", two)
            m.setattr(tcle, "_chain_devices", two)
        m.setattr(ttune, "tune_mobility", short_tune)
        assert tcli.main(argv + ["--data-dir", str(tmp), "--device", "cpu",
                                 "--seed", "3"]) == 0
    capsys.readouterr()
    return ({p.name: p.read_bytes() for p in sorted(tmp.rglob("*.csv"))},
            tuned_on)


@pytest.mark.parametrize("argv", [
    ["4", "12", "4", "1.1", "--n", "16", "--temperatures", "1.0,1.3",
     "--chains-per-t", "4", "--pt-exchange", "4", "--sampler", "torch",
     "--reweight", "1.0:1.3:3"],
    ["4", "12", "4", "1.1", "--n", "16", "--chains", "4", "--sampler",
     "torch", "--target-acceptance", "0.6"],
    ["4", "10", "5", "2.0", "--npt-grid", "0.3:2.5:3", "--n", "12", "--rho",
     "0.25", "--gamma", "0.02", "--chains", "2"],
    ["4", "10", "5", "1.2", "--gibbs", "--gibbs-temps", "0.9,1.6", "--n",
     "16", "--rho", "0.3", "--gamma", "0.02", "--chains", "2"],
], ids=["pt_ladder", "tuned_plain_ensemble", "npt_isobars", "gibbs_ladder"])
def test_cli_sharded_csvs_byte_identical(argv, tmp_path, monkeypatch,
                                         capsys):
    """The CLI with its device helper patched to two devices writes the
    CSVs of the unpatched run byte for byte: a PT ladder with MBAR, the
    plain engine's ensemble tuned on the devices it then runs on, the
    NPT isobars and the Gibbs coexistence curve."""
    one, tuned1 = _run_cli(argv, tmp_path / "one", False, monkeypatch,
                           capsys)
    two, tuned2 = _run_cli(argv, tmp_path / "two", True, monkeypatch, capsys)
    assert one and one == two
    if "--target-acceptance" in argv:
        assert tuned1 == [None] and tuned2 == [tuple(map(torch.device,
                                                           TWO))]


class _FakeMesh:
    """tpu_smc's make_mesh stand-in: records the device count."""

    def __init__(self, n, axis_names=("chains",), local=False):
        self.n = n


def _tpu_smc_lines(monkeypatch, capsys, n, label, n_dev):
    """What tpu_smc's _auto_chain_mesh prints for n chains on a host
    showing n_dev devices."""
    monkeypatch.setattr(jax, "devices", lambda: list(range(n_dev)))
    monkeypatch.setattr(jens, "make_mesh", _FakeMesh)
    capsys.readouterr()
    mesh = jcli._auto_chain_mesh(n, label)
    return mesh, capsys.readouterr().out


def _port_lines(monkeypatch, capsys, device, n, nproc, label, n_dev):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_dev)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    capsys.readouterr()
    devs = tcli._chain_devices(device, n, nproc, label)
    return devs, capsys.readouterr().out


@pytest.mark.parametrize("label", ["NPT", "NPT isobar", "Gibbs",
                                   "Gibbs ladder"])
@pytest.mark.parametrize("n", [8, 7])
def test_device_helper_lines_match_tpu_smc(monkeypatch, capsys, label, n):
    """On a host with two cards the helper shards NPT, the isobars,
    Gibbs and the coexistence curve when their chains divide, and prints
    what tpu_smc's _auto_chain_mesh prints, divide or not."""
    mesh, want = _tpu_smc_lines(monkeypatch, capsys, n, label, 2)
    devs, got = _port_lines(monkeypatch, capsys, "cuda", n, 1, label, 2)
    assert got == want
    assert (devs is None) == (mesh is None)
    if devs is not None:
        assert devs == (torch.device("cuda:0"), torch.device("cuda:1"))


@pytest.mark.parametrize("label, n, want", [
    ("ladder", 16, "Sharding 16 ladder chains over 2 devices\n"),
    ("ladder", 15, "Note: 15 ladder chains do not divide over 2 devices; "
                   "running on one device\n"),
    ("", 8, "Sharding 8 chains over 2 devices\n"),
    ("", 7, "Note: 7 chains do not divide over 2 devices; running on one "
            "device\n"),
])
def test_device_helper_ladder_and_ensemble_lines(monkeypatch, capsys, label,
                                                 n, want):
    """The ladder's and the ensemble's lines, which tpu_smc prints inline
    (tpu_smc/cli.py:958-962, :1688-1692): the same words, whose
    templates stand in tpu_smc's source."""
    import inspect

    src = inspect.getsource(jcli)
    for template in ('f"Sharding {ladder_c} ladder chains over "',
                     'f"Note: {ladder_c} ladder chains do not divide over "',
                     'f"Sharding {c} chains over {n_dev} "',
                     'f"Note: {c} chains do not divide over {n_dev} '
                     'devices; "'):
        assert template in src
    devs, got = _port_lines(monkeypatch, capsys, "cuda", n, 1, label, 2)
    assert got == want
    assert (devs is None) == want.startswith("Note")


@pytest.mark.parametrize("device, nproc, n_dev", [
    ("cpu", 1, 2), ("cuda", 1, 1), ("cuda", 2, 2)])
def test_device_helper_silent_cases(monkeypatch, capsys, device, nproc,
                                    n_dev):
    """None and no line on the CPU, on one card and in a process of a
    multi-process run holding one card (_take_cards); tpu_smc
    says nothing on one device either."""
    devs, got = _port_lines(monkeypatch, capsys, device, 8, nproc, "NPT",
                            n_dev)
    assert devs is None and got == ""
    if n_dev == 1:
        mesh, want = _tpu_smc_lines(monkeypatch, capsys, 8, "NPT", 1)
        assert mesh is None and want == ""


@pytest.mark.parametrize("given", [[], ["100"], ["100", "200", "10"],
                                   ["100", "200", "10", "1.1"]])
def test_prompts_match_tpu_smc(monkeypatch, capsys, given):
    """Left-out positionals are asked for on stdin: the same stdin into
    both CLIs' prompt functions prints the same prompts and parses the
    same values."""
    names = ("eqsteps", "maxsteps", "numdata", "temperature")
    stdin = "".join(v + "\n" for v in ["100", "200", "10", "1.1"][len(given):])
    out = []
    for fn in (jcli._prompt_missing, tcli._prompt_missing):
        ns = argparse.Namespace(**{k: None for k in names})
        parsed = tcli.build_parser().parse_args(given)
        for k in names[:len(given)]:
            setattr(ns, k, getattr(parsed, k))
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
        capsys.readouterr()
        fn(ns)
        out.append((capsys.readouterr().out, vars(ns)))
    assert out[0] == out[1]
    assert out[1][1] == {"eqsteps": 100, "maxsteps": 200, "numdata": 10,
                         "temperature": 1.1}
    assert out[1][0].count("Enter the") == 4 - len(given)
