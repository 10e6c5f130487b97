"""Multi-process and multi-device runs of tpu_smc_torch on the CPU.

Every engine keys its draws by the GLOBAL chain index (`chain0`), so a
split of a seeded run over processes or devices is bitwise the one-process
run: two gloo processes of `python -m tpu_smc_torch` against the same
command run in-process through `cli.main` (the ensemble and one ladder
spanning the processes), the sharded engines against the unsharded call,
and a chain run alone with chain0 = k against chain k of a wider call.
Against tpu_smc: the pooling of per-process ladders (its allgather
patched to concatenate two halves handed over between two threads),
the particle-sharded energy, the checkpoint suffix and the usage errors.

Each process pair runs with a free port, the rendezvous and collective
timeouts of `distributed.init_distributed`, and communicate(timeout=120);
on any failure the children are killed. Nothing here can hang.
"""

import os
import re
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_smc.cli as jcli
import tpu_smc.ensemble as jens
import tpu_smc.pt as jpt
import tpu_smc.tsweep as jts
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc_torch import cli as tcli
from tpu_smc_torch import distributed as tdist
from tpu_smc_torch import ensemble as ten
from tpu_smc_torch import io as tio
from tpu_smc_torch import pt as tpt
from tpu_smc_torch import tsweep as tts
from tpu_smc_torch.config import SMCConfig
from tpu_smc_torch.kernels import sweep as ks
from tpu_smc_torch.state import init_ensemble_state, seed_words

REPO = Path(__file__).resolve().parent.parent
ENSEMBLE_ARGS = ["20", "60", "12", "1.10", "--n", "16", "--chains", "8",
                 "--seed", "7", "--device", "cpu", "--dtype", "float64",
                 "--gr-bins", "8", "--z-bins", "8", "--widom", "4",
                 "--widom-bins", "8"]
LADDER_ARGS = ["4", "24", "4", "1.1", "--n", "12", "--temperatures",
               "1.0,1.2", "--chains-per-t", "4", "--pt-exchange", "4",
               "--seed", "7", "--device", "cpu", "--dtype", "float64"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_pair(args, cwd: Path):
    """Two ranks of `python -m tpu_smc_torch args` on a free port."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    base = [sys.executable, "-m", "tpu_smc_torch", *args, "--coordinator",
            f"127.0.0.1:{_free_port()}", "--num-processes", "2"]
    return [subprocess.Popen(base + ["--process-id", str(i)], cwd=cwd,
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for i in range(2)]


def _finish(procs) -> list:
    """Both ranks' output; both must exit 0. Kills the pair on failure."""
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _slab(cfg) -> np.ndarray:
    """cfg.n particles in condensed 4 x 4 layers on the lower wall: the
    pair and wall sums all act, unlike the dilute default lattice."""
    g = (np.arange(4) - 1.5) * 1.12
    z = -cfg.box_lz / 2 + 1.3 + np.arange(-(-cfg.n // 16)) * 1.12
    r = np.stack(np.meshgrid(z, g, g, indexing="ij"), -1).reshape(-1, 3)
    return r[:cfg.n, ::-1].copy()


def _run_dir(data: Path) -> Path:
    return next(data.iterdir())


def test_ensemble_split_over_two_processes_bitwise(tmp_path):
    """`--chains 8 --seed 7` split over two gloo processes writes the
    one-process run's per-rank CSVs, data_ensemble, last_state and
    widom byte for byte; g(r) and rho(z) (the mean of the ranks' means)
    within 1e-6."""
    cfg = SMCConfig.for_n(16, temperature=1.1, dtype="float64")
    for sub in ("one", "two"):
        tio.write_last_state(tio.run_dir(cfg, tmp_path / sub), cfg,
                             _slab(cfg))
    procs = _spawn_pair(ENSEMBLE_ARGS + ["--data-dir",
                                         str(tmp_path / "two")], tmp_path)
    assert tcli.main(ENSEMBLE_ARGS + ["--data-dir",
                                      str(tmp_path / "one")]) == 0
    outs = _finish(procs)
    assert "Multi-process run: process 0/2, 4 of 8 chains" in outs[0]
    assert "Multi-process run: process 1/2, 4 of 8 chains" in outs[1]
    one, two = _run_dir(tmp_path / "one"), _run_dir(tmp_path / "two")
    names = sorted(p.name for p in one.iterdir())
    assert sorted(p.name for p in two.iterdir()) == names
    assert sum("_rank7" in n for n in names) == 5
    for name in names:
        a, b = (one / name).read_bytes(), (two / name).read_bytes()
        if name.startswith(("gr_", "zprofile_")):
            np.testing.assert_allclose(
                np.genfromtxt(two / name, delimiter=",", skip_header=1),
                np.genfromtxt(one / name, delimiter=",", skip_header=1),
                rtol=1e-6)
        else:
            assert a == b, name
    # the pooled summary lines of both ranks are the one-process run's
    summary = [ln for ln in outs[0].splitlines()
               if ln.startswith(("Mean energy", "Average acceptance"))]
    assert len(summary) == 2
    assert all(ln in outs[1] for ln in summary)


def test_global_ladder_over_two_processes_bitwise(tmp_path):
    """One PT ladder split over two processes (--global-ladder): the
    exchanges cross the process boundary, and tsweep, pt, reweight and
    reweight_zprofile are the one-process run's byte for byte, as is the
    gathered checkpoint."""
    args = LADDER_ARGS + ["--reweight", "1.0:1.2:3", "--z-bins", "8"]
    procs = _spawn_pair(args + ["--global-ladder", "--data-dir",
                                str(tmp_path / "two"), "--checkpoint",
                                str(tmp_path / "two.npz")], tmp_path)
    assert tcli.main(args + ["--data-dir", str(tmp_path / "one"),
                             "--checkpoint", str(tmp_path / "one.npz")]) == 0
    outs = _finish(procs)
    assert "chains 4..7 here" in outs[1]
    one, two = _run_dir(tmp_path / "one"), _run_dir(tmp_path / "two")
    for stem in ("tsweep", "pt", "reweight", "reweight_zprofile"):
        name = next(one.glob(f"{stem}_N*")).name
        assert (two / name).read_bytes() == (one / name).read_bytes(), stem
    with np.load(tmp_path / "one.npz") as a, np.load(tmp_path / "two.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_per_process_ladders_pool(tmp_path):
    """Complete PT ladders per process (their streams salted per rank),
    pooled: the pooled swap attempts equal the one-process run's
    exactly, each level's E within 6 combined SE + 0.3 of it
    (tests/test_distributed.py's criterion), process 0 writes the CSVs,
    and each rank its own .p{rank} checkpoint."""
    procs = _spawn_pair(LADDER_ARGS + ["--data-dir", str(tmp_path / "two"),
                                       "--checkpoint",
                                       str(tmp_path / "ck.npz")], tmp_path)
    assert tcli.main(LADDER_ARGS + ["--data-dir",
                                    str(tmp_path / "one")]) == 0
    outs = _finish(procs)
    assert "2 of 4 replica ladders" in outs[0]
    one, two = _run_dir(tmp_path / "one"), _run_dir(tmp_path / "two")
    read = lambda d, stem: np.genfromtxt(next(d.glob(f"{stem}_N*")),
                                         delimiter=",", skip_header=1,
                                         ndmin=2)
    assert np.array_equal(read(one, "pt")[:, 3], read(two, "pt")[:, 3])
    s, m = read(one, "tsweep"), read(two, "tsweep")
    for row in range(2):
        tol = 6 * (s[row, 2] ** 2 + m[row, 2] ** 2) ** 0.5 + 0.3
        assert abs(s[row, 1] - m[row, 1]) < tol
    for rank in (0, 1):
        with np.load(tmp_path / f"ck.p{rank}.npz") as ck:
            assert ck["r"].shape == (4, 12, 3)


def test_dead_peer_fails_the_other_rank(tmp_path):
    """No rank carries on alone: one rank of a global ladder killed
    mid-run makes the other exit non-zero at its next exchange."""
    procs = _spawn_pair(["2", "4000", "4", "1.1", "--n", "12",
                         "--temperatures", "1.0,1.2", "--chains-per-t",
                         "2", "--pt-exchange", "2", "--seed", "7",
                         "--device", "cpu", "--global-ladder",
                         "--data-dir", str(tmp_path / "d")], tmp_path)
    try:
        for line in procs[1].stdout:
            if line.startswith("Temperature sweep"):
                break
        procs[1].kill()
        out = procs[0].communicate(timeout=120)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    assert procs[0].returncode != 0
    assert "Temperature sweep" in out            # it failed after the start
    assert any(w in out for w in ("Connection closed by peer",
                                  "Connection reset", "Broken pipe",
                                  "gloo"))


# ----------------------------------------------------------------------
# In one process: chain0, the sharded engines, particle-sharded energy
# ----------------------------------------------------------------------

def _state(n=16, c=8, dtype="float32"):
    cfg = SMCConfig.for_n(n, temperature=1.1, dtype=dtype)
    state, w = init_ensemble_state(cfg, seed_words(5), c, r0=_slab(cfg),
                                   device="cpu")
    return cfg, state, w


def _chains(state, sl):
    return ten.concat_states([ten._map_leaves(state, lambda x: x[sl])],
                             "cpu")


@pytest.mark.parametrize("engine", ["torch", "dense", "zsorted", "stream",
                                    "banded"])
def test_chain0_is_chain_k_of_the_wider_call(engine):
    """Chains 4..7 run alone with chain0 = 4 are bitwise those chains of
    the 8-chain call, on every engine's plain version."""
    cfg, state, w = _state()
    a = cfg.proposal_a
    calls = {
        "torch": lambda s, c0: ten.ensemble_sweeps(
            s, w, cfg, a, 3, collect_trace=True, stream_seed=7, chain0=c0),
        "dense": lambda s, c0: ten.ensemble_sweeps_dense(
            s, w, cfg, a, 3, seed=7, chain0=c0),
        "zsorted": lambda s, c0: ten.ensemble_sweeps_zsorted(
            s, w, cfg, a, 3, seed=7, chain0=c0),
        "stream": lambda s, c0: ten.ensemble_sweeps_zsorted(
            s, w, cfg, a, 3, seed=7, chain0=c0, hbm_stream=True),
        "banded": lambda s, c0: ten.ensemble_sweeps_banded(
            s, w, cfg, a, 2, window=8, seed=7, chain0=c0)[:2]}
    full, fs = calls[engine](state, 0)
    part, ps = calls[engine](_chains(state, slice(4, 8)), 4)
    assert torch.equal(full.r[4:], part.r)
    assert torch.equal(fs.energy[:, 4:], ps.energy)
    assert torch.equal(fs.accepted[:, 4:], ps.accepted)
    base, _ = calls[engine](_chains(state, slice(4, 8)), 0)
    assert not torch.equal(base.r, part.r)    # chain0 = 0 repeats 0..3


def test_chain0_in_the_plain_draws():
    """The draws of chains [k, k + C) are columns k.. of the wider
    draws: move uniforms, pair uniforms, the K5 plane, the stream
    uniforms."""
    words = torch.tensor([123, 456])
    u = ks.move_uniforms(words, 10, 8)
    assert torch.equal(ks.move_uniforms(words, 10, 3, chain0=5), u[:, 5:])
    p = ks.pair_uniforms(words, 6, 8)
    assert torch.equal(ks.pair_uniforms(words, 6, 2, chain0=6), p[:, 6:])
    k5 = ks.debug_reference_noise(words, 12, 8, 1.3, "cpu")
    assert torch.equal(ks.debug_reference_noise(words, 12, 4, 1.3, "cpu",
                                                chain0=4), k5[:, 4:])
    s = ten.stream_uniforms(words, 5, 8, 1, torch.float64)
    assert torch.equal(ten.stream_uniforms(words, 5, 3, 1, torch.float64,
                                           chain0=5), s[5:])


@pytest.mark.parametrize("per_chain", [False, True])
def test_sharded_engines_bitwise_unsharded(per_chain):
    """The engines over make_mesh(devices=["cpu", "cpu"]) are bitwise
    the unsharded call, with per-chain (A, T) rows and per-chain walls
    going with their chains."""
    cfg, state, w = _state()
    mesh = ten.make_mesh(devices=["cpu", "cpu"])
    kw = {}
    if per_chain:
        t = torch.linspace(0.9, 1.6, 8, dtype=torch.float64)
        kw = dict(a_per_chain=cfg.gamma * t, t_per_chain=t)
        w = w.expand(8, *w.shape).clone()
        w[4:, :, 0] *= 1.5
    for sharded, plain in ((ten.ensemble_sweeps_dense_sharded,
                            ten.ensemble_sweeps_dense),
                           (ten.ensemble_sweeps_zsorted_sharded,
                            ten.ensemble_sweeps_zsorted)):
        s1, t1 = sharded(state, w, cfg, cfg.proposal_a, 3, 7, mesh, **kw)
        s2, t2 = plain(state, w, cfg, cfg.proposal_a, 3, seed=7, **kw)
        for f in ("r", "energy", "key", "sweeps", "accepted"):
            assert torch.equal(getattr(s1, f), getattr(s2, f)), f
        assert torch.equal(t1.energy, t2.energy)
        assert torch.equal(t1.accepted, t2.accepted)


def test_shard_and_gather_round_trip():
    cfg, state, w = _state()
    parts = ten.shard_ensemble(state, ten.make_mesh(devices=["cpu"] * 4), 8)
    assert [c0 for _, c0 in parts] == [8, 10, 12, 14]
    whole = ten.gather_global_state([p for p, _ in parts])
    for f in ("r", "energy", "key", "rbin", "density"):
        assert torch.equal(getattr(whole, f), getattr(state, f))
    with pytest.raises(ValueError, match="divide"):
        ten.shard_ensemble(state, ten.make_mesh(devices=["cpu"] * 3))


def test_allgather_single_process_keeps_dtype():
    for x in (np.arange(6, dtype=np.int64).reshape(3, 2),
              np.linspace(0, 1, 4), np.zeros((0, 3))):
        g = tdist.allgather_chain_axis(x)
        assert g.dtype == x.dtype and np.array_equal(g, x)
    assert tdist.chain_range(8, 2, 1) == (4, 4)
    with pytest.raises(ValueError):
        tdist.chain_range(7, 2, 0)


def test_particle_sharded_energy_against_jax():
    """Against tpu_smc.ensemble.particle_sharded_energy on a one-device
    mesh (float64, N = 64; 1e-12 relative), and against the port's full
    recompute over 4 CPU shards."""
    from tpu_smc_torch.potentials import total_energy

    cfg, state, w = _state(n=32, c=1, dtype="float64")
    r = state.r[0].double()
    w = w.double()
    jc = JConfig.for_n(32, temperature=1.1, dtype="float64")
    mesh = jens.make_mesh(1, axis_names=("particles",))
    e_jax = float(jens.particle_sharded_energy(r.numpy(), w.numpy(), jc,
                                               mesh))
    e4 = ten.particle_sharded_energy(r, w, cfg, ten.make_mesh(
        devices=["cpu"] * 4))
    e_full = float(total_energy(r[None], w, cfg)[0])
    assert abs(e4 - e_jax) <= 1e-12 * abs(e_jax)
    assert abs(e4 - e_full) <= 1e-12 * abs(e_full)
    assert e4 < 0.0                                  # the slab binds
    with pytest.raises(ValueError, match="divide"):
        ten.particle_sharded_energy(r, w, cfg, ["cpu"] * 3)


# ----------------------------------------------------------------------
# Against tpu_smc: pooling, suffix, usage errors
# ----------------------------------------------------------------------

class _TwoThreads:
    """allgather_chain_axis between two threads: each hands over its
    array, both receive the concatenation (rank order)."""

    def __init__(self):
        self.barrier = threading.Barrier(2, timeout=30)
        self.slots = [None, None]
        self.local = threading.local()

    def allgather(self, x):
        self.slots[self.local.rank] = np.asarray(x)
        self.barrier.wait()
        out = np.concatenate(self.slots)
        self.barrier.wait()
        return out

    def run(self, fn, args_per_rank):
        out = [None, None]

        def body(rank):
            self.local.rank = rank
            out[rank] = fn(*args_per_rank[rank])

        threads = [threading.Thread(target=body, args=(k,)) for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert all(o is not None for o in out)
        return out


def _ladder_halves(rng, mod, n_t=3, r_local=4, gathers=5, bins=6):
    """Two per-process TSweepResults of module `mod` on the same random
    samples."""
    halves = []
    for k in range(2):
        f = lambda *shape: rng.normal(size=shape)
        halves.append(mod.TSweepResults(
            temps=np.array([1.0, 1.2, 1.4]), mean_energy=f(n_t),
            err_energy=f(n_t), acceptance=rng.uniform(size=n_t), cv=f(n_t),
            energy_samples=f(gathers, n_t, r_local),
            pressure_samples=f(2, n_t, r_local),
            energy_at_pressure=f(2, n_t, r_local),
            zprofile_samples=f(2, n_t, r_local, bins),
            widom_samples=f(2, n_t, r_local, 3),
            sweeps_per_second=100.0 + k))
    return halves


def _assert_same(a, b, rtol=1e-12):
    for name in a._fields:
        va, vb = getattr(a, name), getattr(b, name)
        if va is None or vb is None:
            assert va is None and vb is None, name
        else:
            np.testing.assert_allclose(np.asarray(va, np.float64),
                                       np.asarray(vb, np.float64), rtol=rtol,
                                       atol=1e-300, err_msg=name)


def test_pool_tsweep_and_pt_against_jax(monkeypatch):
    """pool_tsweep_across_processes and pool_pt_across_processes of two
    per-process results agree with tpu_smc's to 1e-12, each package's
    allgather patched to concatenate the two threads' halves."""
    jc = JConfig.for_n(12, temperature=1.1, dtype="float64")
    tc = SMCConfig.for_n(12, temperature=1.1, dtype="float64")
    tj = _TwoThreads()
    tt = _TwoThreads()
    monkeypatch.setattr(jens, "allgather_chain_axis", tj.allgather)
    monkeypatch.setattr(tdist, "allgather_chain_axis", tt.allgather)
    jh = _ladder_halves(np.random.default_rng(3), jts)
    th = _ladder_halves(np.random.default_rng(3), tts)
    pj = tj.run(jts.pool_tsweep_across_processes, [(h, jc) for h in jh])
    pt = tt.run(tts.pool_tsweep_across_processes, [(h, tc) for h in th])
    for a, b in zip(pj, pt):
        _assert_same(a, b)
    assert pt[0].energy_samples.shape == (5, 3, 8)

    def pt_half(mod, ts, k):
        return mod.PTResults(
            tsweep=ts, pair_t_lo=ts.temps[:-1], pair_t_hi=ts.temps[1:],
            swap_acceptance=np.array([0.25, 0.5]) + 0.1 * k,
            swap_attempts=np.array([8, 12]) + 4 * k, exchange_interval=4)
    qj = tj.run(jpt.pool_pt_across_processes,
                [(pt_half(jpt, h, k), jc) for k, h in enumerate(jh)])
    qt = tt.run(tpt.pool_pt_across_processes,
                [(pt_half(tpt, h, k), tc) for k, h in enumerate(th)])
    for a, b in zip(qj, qt):
        _assert_same(a.tsweep, b.tsweep)
        np.testing.assert_array_equal(a.swap_attempts, b.swap_attempts)
        np.testing.assert_allclose(a.swap_acceptance, b.swap_acceptance,
                                   rtol=1e-12)


@pytest.mark.parametrize("ck, suffix", [
    ("autosave.npz", ".p1"), ("ck", ".p0"), ("a.b.npz", ".p2"),
    ("autosave.npz", "")])
def test_ck_with_suffix_against_jax(ck, suffix):
    assert tcli._ck_with_suffix(ck, suffix) == jcli._ck_with_suffix(ck,
                                                                    suffix)


COMMON = ["1", "2", "1", "1.1", "--device", "cpu"]
MP = ["--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "0", "--seed", "3"]


@pytest.mark.parametrize("argv, words", [
    (["--global-ladder", "--temperatures", "1.0,1.2"],
     "--global-ladder needs --coordinator"),
    (["--coordinator", "127.0.0.1:1"],
     "--coordinator needs --num-processes and --process-id"),
    (MP + ["--resume", "ck.npz"],
     "--coordinator with --resume is not supported"),
    (MP + ["--global-ladder"], "--global-ladder needs a --temperatures"),
    (MP + ["--temperatures", "1.0,1.2", "--pt-exchange", "auto"],
     "--coordinator ladders need a fixed --pt-exchange"),
    (MP + ["--temperatures", "1.0,1.2", "--chains-per-t", "3"],
     "--chains-per-t 3 must divide evenly over 2 processes"),
    (MP + ["--chains", "3"], "--chains 3 must divide evenly over 2"),
    (MP[:-2] + ["--chains", "4"], "--coordinator needs an explicit --seed"),
])
def test_usage_errors_before_the_rendezvous(argv, words):
    """Every refusal fires before init_distributed (a port that nothing
    listens on would otherwise time out), with tpu_smc's words; tpu_smc
    gives the same words for the same arguments."""
    with pytest.raises(SystemExit) as exc:
        tcli.main(COMMON + argv)
    assert words in str(exc.value.code)
    with pytest.raises(SystemExit) as jexc:
        jcli.main(["1", "2", "1", "1.1", "--platform", "cpu"] + argv)
    assert words in str(jexc.value.code)


@pytest.mark.parametrize("argv, words", [
    (["--coordinator", "127.0.0.1", "--num-processes", "2", "--process-id",
      "0", "--seed", "3"], "need HOST:PORT"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "2", "--seed", "3"], "--process-id 2 outside [0, 2)"),
])
def test_address_errors_before_the_rendezvous(argv, words):
    """A malformed address or rank fails before the rendezvous too."""
    with pytest.raises(SystemExit) as exc:
        tcli.main(COMMON + argv)
    assert words in str(exc.value.code)


@pytest.mark.parametrize("argv", [
    ("127.0.0.1", 2, 0), ("127.0.0.1:x", 2, 0), ("127.0.0.1:1", 2, -1),
])
def test_init_distributed_checks_before_the_rendezvous(argv):
    """init_distributed refuses what the CLI refuses, with the same
    check (check_coordinator), before it opens a socket."""
    with pytest.raises(ValueError, match="HOST:PORT|outside"):
        tdist.init_distributed(*argv)


def test_cards_of_a_process(monkeypatch, capsys):
    """On a host with two cards: a one-process run shards its chains over
    both when they divide (and says so, in tpu_smc's words), on every
    engine, stays on one with a note when they do not, and never on the
    CPU; processes of a multi-process run that outnumber their host's
    cards keep to one card each, rank mod cards (three ranks on one
    host here; tests/test_torch_shard_family.py has the other layouts)."""
    taken = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", taken.append)
    monkeypatch.setattr(tdist, "allgather_object", lambda obj: [obj] * 3)
    monkeypatch.setattr(tcli, "_RANK_CARDS", None)
    assert tcli._chain_devices("cuda", 8, 1) == (
        torch.device("cuda:0"), torch.device("cuda:1"))
    assert "Sharding 8 chains over 2 devices" in capsys.readouterr().out
    assert tcli._chain_devices("cuda", 7, 1) is None
    assert ("7 chains do not divide over 2 devices; running on one device"
            in capsys.readouterr().out)
    for args in (("cuda", 8, 2), ("cpu", 8, 1)):
        assert tcli._chain_devices(*args) is None
    assert capsys.readouterr().out == ""
    notes = [tcli._take_cards("cuda", r) for r in range(3)]
    assert taken == [0, 1, 0]
    assert notes[1] == ", this process on cuda:1"
    assert tcli._chain_devices("cuda", 8, 3) is None
    assert tcli._take_cards("cpu", 1) == "" and taken == [0, 1, 0]


@pytest.mark.parametrize("argv, words", [
    (["--gcmc", "-6", "--bulk", "--n", "8", "--chains", "2"],
     "--gcmc is single-process (scale with --chains)"),
    (["--npt", "0.7", "--n", "8", "--chains", "2"],
     "--npt is single-process (scale with --chains)"),
    (["--gibbs", "--n", "8", "--chains", "2"],
     "--gibbs is single-process (scale with --chains)"),
    (["--umbrella=-8:8:2", "--chains", "2"],
     "--umbrella is single-process (scale with --umbrella-replicas)"),
    (["--temperatures", "1.0,1.2", "--chains-per-t", "4",
      "--pt-exchange", "2", "--wall-realizations", "2"],
     "--wall-realizations ladders are single-process (use more "
     "chains-per-t instead)"),
])
def test_single_process_modes_refused(argv, words):
    """The modes tpu_smc runs single-process are refused in its words
    (checked against its source, its string literals joined), before the
    rendezvous."""
    src = re.sub(r'"\s*\n\s*f?"', "", (REPO / "tpu_smc" / "cli.py")
                 .read_text())
    assert words in src
    with pytest.raises(SystemExit) as exc:
        tcli.main(COMMON + MP + argv)
    assert words in str(exc.value.code)


def test_simulate_ensemble_over_devices_bitwise():
    """simulate_ensemble with a device list (ObservableOptions.devices,
    the CLI's route on a machine with several cards) and with a chain
    base is bitwise the one-device run of the same chains."""
    from tpu_smc_torch.config import RunParams
    from tpu_smc_torch.driver import ObservableOptions
    from tpu_smc_torch.driver_ensemble import simulate_ensemble

    cfg, state, w = _state(n=16, c=8)
    params = RunParams(2, 4, 2)
    runs = {}
    for name, kw in (("one", {}), ("two", {"devices": ("cpu", "cpu")})):
        opts = ObservableOptions(sampler="dense", stream_seed=7, **kw)
        runs[name] = simulate_ensemble(cfg, params, state, w, opts=opts,
                                       max_fault_retries=0)
    (s1, r1), (s2, r2) = runs["one"], runs["two"]
    assert torch.equal(s1.r, s2.r) and r1.mean_energy == r2.mean_energy
    half = _chains(state, slice(4, 8))
    s3, r3 = simulate_ensemble(
        cfg, params, half, w, max_fault_retries=0,
        opts=ObservableOptions(sampler="dense", stream_seed=7, chain0=4))
    assert torch.equal(s3.r, s1.r[4:])
    assert [c.mean_energy for c in r3.chains] == \
        [c.mean_energy for c in r1.chains[4:]]


def test_particle_sharded_energy_over_a_group():
    """With a process group the blocks are numbered by rank and the
    ranks' sums all-reduced: a one-rank gloo group gives the local sum."""
    import torch.distributed as dist

    cfg, state, w = _state(n=32, c=1, dtype="float64")
    r, w = state.r[0].double(), w.double()
    local = ten.particle_sharded_energy(r, w, cfg, ["cpu"] * 2)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        grouped = ten.particle_sharded_energy(r, w, cfg, ["cpu"] * 2,
                                              group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    assert grouped == local
