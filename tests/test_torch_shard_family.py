"""The GCMC isotherm family and the umbrella/REUS windows split over a
list of devices, as tpu_smc shards them (__graft_entry__.py:297-360),
each rank's cards, and the wall-parameter helpers. On ("cpu", "cpu")
every split run is bitwise the one-device run of the same seed:
gc_block with chain0, simulate_gcmc with per-chain mu (resync,
histograms, resume), simulate_umbrella with REUS with a shard boundary
inside a window. gc_block at per-chain mu is held against tpu_smc's
vmapped gc_block under its own draws; the rank-card helper and the
device helper of a multi-process rank under a monkeypatched card count
and host list; make_wall_params against tpu_smc in float64 and
sample_wall_params to its moments."""

import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_smc import gcmc as jg
from tpu_smc import potentials as jpot
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc_torch import cli as tcli
from tpu_smc_torch import distributed as tdist
from tpu_smc_torch import ensemble as ten
from tpu_smc_torch import gcmc as tg
from tpu_smc_torch import potentials as tpot
from tpu_smc_torch import umbrella as tu
from tpu_smc_torch.config import RunParams
from tpu_smc_torch.config import SMCConfig as TConfig
from tpu_smc_torch.state import (gcmc_state_from_jax, init_ensemble_state,
                                 seed_words)

torch.set_num_threads(1)

TWO = ["cpu", "cpu"]
CAP, X = 24, 6


def _cfg(kind, cls=TConfig):
    """The slab (walls) and bulk GCMC systems of tests/test_torch_gcmc.py
    in float64 (the port's, or tpu_smc's with cls), with a per-chain mu
    ladder around each one's mu."""
    if kind == "slab":
        cfg = dataclasses.replace(
            cls.for_n(16, temperature=1.3, dtype="float64"), box_l=7.0,
            box_lz=20.0)
        return cfg, np.linspace(-3.0, -1.0, 4)
    cfg = cls.bulk(n=16, temperature=1.5, rho=0.05, gamma=0.02,
                   dtype="float64")
    mu = 1.5 * math.log(4.0 / (cfg.box_l * cfg.box_l * cfg.box_lz))
    return cfg, mu + np.linspace(-1.0, 1.0, 4)


def _results_equal(a, b) -> list:
    """The fields of two results that differ to the bit, the rate aside."""
    bad = []
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "sweeps_per_second":
            continue
        if (x is None) != (y is None) or x is not None and not np.array_equal(
                np.asarray(x), np.asarray(y),
                equal_nan=np.asarray(x).dtype.kind == "f"):
            bad.append(f)
    return bad


def _states_differ(a, b) -> list:
    return [f.name for f in dataclasses.fields(a)
            if not torch.equal(getattr(a, f.name), getattr(b, f.name))]


# ----------------------------------------------------------------------
# GCMC
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["slab", "bulk"])
def test_gc_block_chain0_halves_bitwise(kind):
    """gc_block over 4 chains at per-chain mu is bitwise its two halves
    run alone with chain0 = 0, 2 on the global chain 0's streams: the
    states, the N and E traces side by side, the z and g(r) counts and
    the pair counts added."""
    cfg, mu = _cfg(kind)
    cc = tg._with_n(cfg, CAP)
    st, w = tg.init_gcmc_state(cfg, torch.tensor([0, 4]), CAP, device="cpu")
    st = tg.batch_state(st, 4)
    mus = torch.as_tensor(mu)
    seed = st.key[0]
    kw = dict(z_bins=5, gr_bins=6, seed=seed)
    one, tr1 = tg.gc_block(st, w, cc, mus, cfg.proposal_a, 3, X, **kw)
    halves = [tg.gc_block(s, w, cc, mus[c0:c0 + 2], cfg.proposal_a, 3, X,
                          chain0=c0, **kw)
              for s, c0 in ten.shard_ensemble(st, TWO)]
    two = ten.concat_states([h[0] for h in halves], "cpu")
    assert not _states_differ(one, two)
    for i in (0, 1):
        assert torch.equal(tr1[i], torch.cat([h[1][i] for h in halves], 1))
    for i in (2, 3, 4):
        assert torch.equal(tr1[i], halves[0][1][i] + halves[1][1][i])
    assert int(one.ins_acc.sum() + one.del_acc.sum()) > 0


def test_gc_block_chain0_keys_the_draws():
    """A half run with chain0 = 0 instead of its global index draws
    another chain's streams: chain0 is what makes the split bitwise."""
    cfg, mu = _cfg("bulk")
    cc = tg._with_n(cfg, CAP)
    st, w = tg.init_gcmc_state(cfg, torch.tensor([0, 4]), CAP, device="cpu")
    st = tg.batch_state(st, 4)
    one, _ = tg.gc_block(st, w, cc, torch.as_tensor(mu), cfg.proposal_a, 2,
                         X, seed=st.key[0])
    top = tg.GCMCState(**{f.name: getattr(st, f.name)[2:]
                          for f in dataclasses.fields(st)})
    good, _ = tg.gc_block(top, w, cc, torch.as_tensor(mu[2:]),
                          cfg.proposal_a, 2, X, seed=st.key[0], chain0=2)
    bad, _ = tg.gc_block(top, w, cc, torch.as_tensor(mu[2:]),
                         cfg.proposal_a, 2, X, seed=st.key[0], chain0=0)
    assert torch.equal(good.r, one.r[2:])
    assert not torch.equal(bad.r, one.r[2:])


def _jax_key_draws(key, cfg, a, sweeps: int):
    """gc_sweep's draws of `sweeps` consecutive sweeps from one tpu_smc
    key (tpu_smc/gcmc.py:152-175), the key advancing as gc_sweep's."""
    dtype = cfg.jnp_dtype
    out = []
    for _ in range(sweeps):
        key, k_noise, k_unif, k_off, k_ex = jax.random.split(key, 5)
        noise = jnp.sqrt(2.0 * jnp.asarray(a, dtype)) * jax.random.normal(
            k_noise, (CAP, 3), dtype)
        unif = jax.random.uniform(k_unif, (CAP,), dtype)
        offset = jax.random.randint(k_off, (), 0, CAP)
        kind = jax.random.bernoulli(jax.random.fold_in(k_ex, 0), 0.5, (X,))
        xy = jax.random.uniform(jax.random.fold_in(k_ex, 1), (X, 2), dtype,
                                -cfg.box_l / 2.0, cfg.box_l / 2.0)
        z = jax.random.uniform(jax.random.fold_in(k_ex, 2), (X,), dtype,
                               -cfg.box_lz / 2.0, cfg.box_lz / 2.0)
        eu = jax.random.uniform(jax.random.fold_in(k_ex, 3), (X,), dtype)
        pick = jax.random.uniform(jax.random.fold_in(k_ex, 4), (X,), dtype)
        out.append((noise, unif, offset, kind,
                    jnp.concatenate([xy, z[:, None]], axis=1), eu, pick))
    return out


@pytest.mark.parametrize("kind", ["slab", "bulk"])
def test_gc_block_per_chain_mu_matches_jax(kind):
    """tpu_smc's gc_block vmapped over 3 chains, each its own start and
    mu (its isotherm family, __graft_entry__.py:297-313), one key for
    all (vmap gives each chain its own visiting offset; the port's
    batched sweep shares one), against the port's gc_block under the
    same draws: positions and energies within 1e-10, masks, counters,
    N traces and the chain-summed z and g(r) counts equal."""
    jcfg, _ = _cfg(kind, JConfig)
    cfg, mu = _cfg(kind)
    mu = mu[:3]
    jcc, tcc = jg._with_n(jcfg, CAP), tg._with_n(cfg, CAP)
    a, sweeps, zb, gb = jcfg.proposal_a, 3, 5, 6
    key = jax.random.key(31)
    rng = np.random.default_rng(8)
    sts = []
    for c in range(3):
        st, w = jg.init_gcmc_state(jcfg, key, CAP, n0=8 + 4 * c)
        r = np.asarray(st.r) + rng.normal(0.0, 0.05, (CAP, 3))
        sts.append(st._replace(r=jnp.asarray(r), energy=jg.total_energy_masked(
            jnp.asarray(r), st.active, w, jcc)))
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *sts)
    jst2, (jn, je, jz, jgr, jnp_) = jax.jit(jax.vmap(
        lambda s, m: jg.gc_block(s, w, jcc, m, a, sweeps, X, zb, gb)))(
            jst, jnp.asarray(mu))
    arrays = {f: np.asarray(getattr(jst, f)) for f in jst._fields
              if f != "key"}
    arrays["key"] = np.asarray(jax.random.key_data(jst.key))
    ts = gcmc_state_from_jax(arrays, cfg, device="cpu")
    draws = [tuple(int(v) if np.ndim(v) == 0 else torch.as_tensor(
        np.array(v))[None].expand((3,) + np.shape(v)) for v in dr)
        for dr in _jax_key_draws(key, jcc, a, sweeps)]
    ts2, (tn, te, tz, tgr, tnp) = tg.gc_block(
        ts, torch.as_tensor(np.array(w)), tcc, torch.as_tensor(mu), a,
        sweeps, X, zb, gb, draws=draws)
    np.testing.assert_array_equal(ts2.active.numpy(), np.asarray(jst2.active))
    np.testing.assert_allclose(ts2.r.numpy(), np.asarray(jst2.r), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(ts2.energy.numpy(), np.asarray(jst2.energy),
                               rtol=1e-10, atol=1e-10)
    for f in tg.COUNTERS:
        np.testing.assert_allclose(getattr(ts2, f).numpy(),
                                   np.asarray(getattr(jst2, f)), rtol=1e-10,
                                   err_msg=f)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn).T)
    np.testing.assert_allclose(te.numpy(), np.asarray(je).T, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz).sum(0))
    np.testing.assert_array_equal(tgr.numpy(), np.asarray(jgr).sum(0))
    np.testing.assert_array_equal(tnp.numpy(), np.asarray(jnp_).sum(0))
    assert len({int(v) for v in np.asarray(jn)[:, -1]}) > 1


@pytest.mark.parametrize("kind", ["slab", "bulk"])
def test_simulate_gcmc_two_devices_bitwise(kind):
    """The isotherm family over two devices: 5 + 20 sweeps at four mu,
    resyncs every 7 (inside thermalization and production), z and g(r)
    profiles: the state and every result bitwise the one-device run."""
    cfg, mu = _cfg(kind)
    kw = dict(n_chains=4, n_exchange=X, chunk=7, z_bins=4, gr_bins=5,
              device="cpu")
    s1, r1 = tg.simulate_gcmc(cfg, mu, CAP, 5, 20, torch.tensor([0, 9]),
                              **kw)
    s2, r2 = tg.simulate_gcmc(cfg, mu, CAP, 5, 20, torch.tensor([0, 9]),
                              devices=TWO, **kw)
    assert not _states_differ(s1, s2) and not _results_equal(r1, r2)
    assert 0 < r1.resync_drift < 1e-9
    assert r1.zprofile is not None and r1.gr is not None
    # the chains of the family sit at different densities
    assert len(set(np.round(r1.n_trace.mean(0), 3))) > 1


def test_simulate_gcmc_resume_two_devices_bitwise(tmp_path):
    """10 + 30 sweeps over two devices, the gathered checkpoint, 30 more
    over two devices: bitwise the unbroken one-device 10 + 60 (the
    counters restart with each run's production)."""
    cfg, mu = _cfg("bulk")
    kw = dict(n_chains=4, n_exchange=X, chunk=25, seed=9, device="cpu")
    key = torch.tensor([0, 9])
    st_a, _ = tg.simulate_gcmc(cfg, mu, CAP, 10, 60, key, **kw)
    st_b, _ = tg.simulate_gcmc(cfg, mu, CAP, 10, 30, key, devices=TWO, **kw)
    p = tg.save_gcmc_checkpoint(tmp_path / "ck", st_b, cfg, stream_seed=9)
    st_l, cfg_l, seed = tg.load_gcmc_checkpoint(p, device="cpu")
    assert seed == 9 and st_l.n_chains == 4
    st_c, _ = tg.simulate_gcmc(cfg_l, mu, CAP, 0, 30, None, state0=st_l,
                               devices=TWO, **kw)
    assert set(_states_differ(st_a, st_c)) <= set(tg.COUNTERS)
    assert torch.equal(st_a.sweeps, st_c.sweeps)


def test_resync_in_each_shard_under_the_split(monkeypatch):
    """The sharded driver's exact recompute runs on each shard's chains,
    inside split_of over the whole family, so that its sums take the
    one-device call's order on the card."""
    cfg, mu = _cfg("bulk")
    seen = []
    real = tg.total_energy_masked

    def spy(r, active, w, cfg, box=None):
        seen.append((r.shape[0], tpot.split_chains()))
        return real(r, active, w, cfg, box)

    monkeypatch.setattr(tg, "total_energy_masked", spy)
    tg.simulate_gcmc(cfg, mu, CAP, 0, 14, torch.tensor([0, 9]), n_chains=4,
                     n_exchange=X, chunk=7, device="cpu", devices=TWO)
    assert seen[1:] == [(2, 4)] * 4


# ----------------------------------------------------------------------
# Sums of a split call (potentials.split_of, chain_sum)
# ----------------------------------------------------------------------

SPLIT_CASES = {
    # name: (chains per block of the pair sums, whole, the splits in
    # force, chains of the call, what a row of each chain sums beside)
    "the whole run": (None, 16, [], 8, 8),
    "a shard of 8 of 16": (None, 16, [(16, 2)], 8, 16),
    "one share": (None, 16, [(16, 1)], 8, 8),
    "a rank's shard": (None, 16, [(16, 2), (8, 2)], 4, 16),
    "blocks of 4 (N = 4000)": (4, 16, [(16, 2)], 8, 4),
    "blocks of 1 (N = 32768)": (1, 4, [(4, 2)], 2, 1),
    "3 of 5 in blocks of 4": (4, 5, [(5, 2)], 3, 4),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
@pytest.mark.parametrize("fn", ["pair energy", "batched pressure"])
def test_split_sums_pad_to_the_unsplit_calls(monkeypatch, case, fn):
    """Under split_of each chain's row of pair terms (the outer sum of
    pair_energy_total; the wall sum of the pressure in wall_obs_chains'
    batches, as the drivers take it) is summed beside as many chains as
    the unsplit call's, up to 16: in blocks of 4 or 1 chains (the pair
    budget at N = 4000 and 32768) no more than the block. On the CPU the
    values stay those of the plain call."""
    from tpu_smc_torch.observables import wall_obs_chains

    block, whole, splits, c, want = SPLIT_CASES[case]
    n = 12
    if block:
        monkeypatch.setattr(tpot, "PAIR_BUDGET", block * n * n)
    cfg = TConfig.for_n(n, dtype="float64")
    st, w = init_ensemble_state(cfg, seed_words(3), whole, device="cpu")
    r = st.r[:c]
    seen = []
    real = tpot.chain_sum

    def spy(x, dim=-1):
        if x.dim() == 2 and dim == -1 and x.shape[-1] in (n, w.shape[0]):
            seen.append(tpot.padded_chains(x, dim) or x.shape[0])
        return real(x, dim)

    def run():
        if fn == "pair energy":
            return tpot.pair_energy_total(r, cfg)
        return wall_obs_chains(lambda rb, wb: tpot.total_pressure(
            rb, wb, cfg), r, w, n)

    plain = run()
    monkeypatch.setattr(tpot, "chain_sum", spy)
    with contextlib.ExitStack() as stack:
        for chains, shares in splits:
            stack.enter_context(tpot.split_of(chains, shares))
        out = run()
    assert torch.equal(out, plain)
    assert seen and set(seen) == {want}, seen


def test_a_particles_force_pads_under_a_split(monkeypatch):
    """A particle's pair force sums over the particle axis, not the last:
    under split_of(16, 2) a call of 8 chains sums beside 16 chains."""
    cfg = TConfig.for_n(12, dtype="float64")
    st, _ = init_ensemble_state(cfg, seed_words(3), 8, device="cpu")
    seen = []
    real = tpot.chain_sum

    def spy(x, dim=-1):
        seen.append((dim, tpot.padded_chains(x, dim)))
        return real(x, dim)

    plain = tpot.pair_energy_force_single(st.r, 3, st.r[:, 3], cfg)
    monkeypatch.setattr(tpot, "chain_sum", spy)
    with tpot.split_of(16, 2):
        out = tpot.pair_energy_force_single(st.r, 3, st.r[:, 3], cfg)
    assert all(torch.equal(u, v) for u, v in zip(out, plain))
    assert seen == [(-1, 16), (-2, 16)]


# ----------------------------------------------------------------------
# Umbrella windows with REUS
# ----------------------------------------------------------------------

UCFG = TConfig.for_n(16, dtype="float64")


@pytest.mark.parametrize("interval", [None, 2])
def test_umbrella_two_devices_bitwise(interval):
    """3 windows x 2 replicas over two devices (3 chains each: the shard
    boundary falls inside window 1), with and without the window
    exchange: the state, the z samples, acceptances and swap rates
    bitwise the one-device run."""
    kw = dict(replicas=2, exchange_interval=interval, device="cpu",
              k_spring=2.0)
    centers = np.linspace(-3.0, 3.0, 3)
    s1, u1 = tu.simulate_umbrella(UCFG, RunParams(4, 12, 4), centers,
                                  seed_words(5), **kw)
    s2, u2 = tu.simulate_umbrella(UCFG, RunParams(4, 12, 4), centers,
                                  seed_words(5), devices=TWO, **kw)
    assert not _states_differ(s1, s2) and not _results_equal(u1, u2)
    if interval:
        assert u1.swap_acceptance is not None


def test_ensemble_sweeps_sharded_umbrella_rows():
    """ensemble_sweeps_sharded(umbrella=) gives each shard its rows of
    the centers: bitwise the unsharded biased call, also from a chain0
    other than 0; a wrong row would pull another window."""
    state, w = init_ensemble_state(UCFG, seed_words(2), 6, device="cpu")
    z0 = torch.as_tensor(np.repeat([-4.0, 0.0, 4.0], 2))
    bias = (0, 3.0, z0)
    one, t1 = ten.ensemble_sweeps(state, w, UCFG, UCFG.proposal_a, 3,
                                  collect_trace=True, chain0=6,
                                  stream_seed=state.key[0], umbrella=bias)
    two, t2 = ten.ensemble_sweeps_sharded(
        state, w, UCFG, UCFG.proposal_a, 3, state.key[0], TWO,
        collect_trace=True, chain0=6, umbrella=bias)
    assert not _states_differ(one, two)
    assert torch.equal(t1.energy, t2.energy)
    flat, _ = ten.ensemble_sweeps(state, w, UCFG, UCFG.proposal_a, 3,
                                  chain0=6, stream_seed=state.key[0])
    assert not torch.equal(flat.energy, one.energy)


# ----------------------------------------------------------------------
# Each rank's cards, the device helper of a rank
# ----------------------------------------------------------------------

@pytest.mark.parametrize("hosts, cards, want", [
    (["a", "a"], 4, [[0, 1], [2, 3]]),
    (["a", "a"], 2, [[0], [1]]),
    (["a", "a"], 3, [[0], [1]]),
    (["a"], 4, [[0, 1, 2, 3]]),
    (["a", "b", "a", "b"], 4, [[0, 1], [0, 1], [2, 3], [2, 3]]),
    (["a", "a", "a"], 2, [[0], [1], [0]]),
    (["a", "a", "b"], 2, [[0], [1], [0, 1]]),
])
def test_host_cards(hosts, cards, want):
    """Each rank takes a disjoint contiguous set of its host's cards,
    its host's ranks in rank order; when they outnumber the cards, card
    rank mod cards (the earlier rule)."""
    assert [tcli._host_cards(r, hosts, cards)
            for r in range(len(hosts))] == want


def _fake_host(monkeypatch, hosts, n_cards, rank):
    taken = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", taken.append)
    monkeypatch.setattr(tdist, "allgather_object", lambda obj: list(hosts))
    monkeypatch.setattr(tcli, "_RANK_CARDS", None)
    return taken, tcli._take_cards("cuda", rank)


@pytest.mark.parametrize("rank, note", [
    (0, ", this process on cuda:0, cuda:1"),
    (1, ", this process on cuda:2, cuda:3")])
def test_take_cards_records_a_ranks_cards(monkeypatch, rank, note):
    """Two ranks on a host with four cards: each takes two, the first
    made current, and says so on the multi-process line."""
    taken, got = _fake_host(monkeypatch, ["h", "h"], 4, rank)
    assert got == note
    assert taken == [2 * rank]
    assert tcli._RANK_CARDS == (f"cuda:{2 * rank}", f"cuda:{2 * rank + 1}")
    monkeypatch.setattr(tcli, "_RANK_CARDS", ("cuda:5",))
    assert tcli._take_cards("cpu", rank) == ""
    assert tcli._RANK_CARDS is None


@pytest.mark.parametrize("label, n, want", [
    ("", 8, "Sharding 8 chains over 2 local devices\n"),
    ("ladder", 16, "Sharding 16 ladder chains over 2 local devices\n"),
    ("", 7, "Note: 7 chains do not divide over 2 devices; running on one "
            "device\n"),
    ("ladder", 15, "Note: 15 ladder chains do not divide over 2 devices; "
                   "running on one device\n"),
])
def test_chain_devices_of_a_rank(monkeypatch, capsys, label, n, want):
    """A rank of a multi-process run (nproc > 1) shards its chains over
    its own cards, in tpu_smc's words for local devices
    (tpu_smc/cli.py:958-962, :1688-1692)."""
    _fake_host(monkeypatch, ["h", "h"], 4, 1)
    capsys.readouterr()
    devs = tcli._chain_devices("cuda", n, 2, label)
    assert capsys.readouterr().out == want
    if want.startswith("Sharding"):
        assert devs == (torch.device("cuda:2"), torch.device("cuda:3"))
    else:
        assert devs is None


def test_chain_devices_of_a_rank_with_one_card(monkeypatch, capsys):
    """Ranks that outnumber their host's cards keep one each: no shard,
    no line; the CPU never shards."""
    _fake_host(monkeypatch, ["h"] * 3, 2, 2)
    capsys.readouterr()
    assert tcli._RANK_CARDS == ("cuda:0",)
    assert tcli._chain_devices("cuda", 8, 3) is None
    assert tcli._chain_devices("cpu", 8, 3) is None
    assert capsys.readouterr().out == ""


# A rank of `python -m tpu_smc_torch` whose cards are ("cpu", "cpu"), as
# _take_cards records a rank's share of a host's cards
RANK_OF_TWO = r"""
import sys
sys.path.insert(0, sys.argv[1])
from tpu_smc_torch import cli
def take(device, rank):
    cli._RANK_CARDS = ("cpu", "cpu")
    return ", this process on cpu, cpu"
cli._take_cards = take
sys.exit(cli.main(sys.argv[2:]))
"""


def _ranks_of_two_cards(args, cwd):
    """Two ranks of cli.main on a free port, each with two CPU "cards";
    both must exit 0 within 120 s (killed otherwise). Their outputs."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_OF_TWO, str(repo), *args,
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(i)], cwd=cwd, env=dict(os.environ),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
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


def _csvs(d):
    return {p.relative_to(d): p.read_bytes() for p in d.rglob("*.csv")}


def test_ranks_shard_over_their_cards_bitwise(tmp_path):
    """`--chains 8` over 2 ranks x 2 "cards" each (the plain engine,
    every chain's sums as the one-process call's, split_of): every
    CSV byte-identical to the one-process run, each rank saying so in
    tpu_smc's words."""
    args = ["6", "18", "6", "1.1", "--n", "16", "--chains", "8",
            "--sampler", "torch", "--seed", "7", "--device", "cpu",
            "--dtype", "float64"]
    outs = _ranks_of_two_cards(args + ["--data-dir", str(tmp_path / "two")],
                               tmp_path)
    assert tcli.main(args + ["--data-dir", str(tmp_path / "one")]) == 0
    for out in outs:
        assert "Sharding 4 chains over 2 local devices" in out
        assert "this process on cpu, cpu" in out
    one, two = _csvs(tmp_path / "one"), _csvs(tmp_path / "two")
    assert len(one) > 8 and one == two


def test_global_ladder_over_ranks_cards_bitwise(tmp_path):
    """One PT ladder over 2 ranks x 2 "cards" (--global-ladder, each
    rank's share split over its cards): tsweep, pt and reweight byte for
    byte the one-process run's, and the gathered checkpoint equal."""
    args = ["4", "16", "4", "1.1", "--n", "12", "--temperatures", "1.0,1.2",
            "--chains-per-t", "4", "--pt-exchange", "4", "--reweight",
            "1.0:1.2:3", "--seed", "7", "--device", "cpu", "--dtype",
            "float64"]
    outs = _ranks_of_two_cards(args + [
        "--global-ladder", "--data-dir", str(tmp_path / "two"),
        "--checkpoint", str(tmp_path / "two.npz")], tmp_path)
    assert tcli.main(args + ["--data-dir", str(tmp_path / "one"),
                             "--checkpoint", str(tmp_path / "one.npz")]) == 0
    for out in outs:
        assert ("Global ladder: 8 chains sharded over 4 devices across 2 "
                "processes") in out
        assert "a device shard of the ONE global ladder" in out
    one, two = _csvs(tmp_path / "one"), _csvs(tmp_path / "two")
    assert len(one) >= 3 and one == two
    with np.load(tmp_path / "one.npz") as a, np.load(tmp_path / "two.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_global_ladder_must_divide_over_the_jobs_devices(monkeypatch):
    """tpu_smc's exit when the ladder does not divide over the job's
    devices (tpu_smc/cli.py:941-944): 2 x 3 chains over 2 ranks with two
    cards each."""
    monkeypatch.setattr(tcli, "_RANK_CARDS", ("cpu", "cpu"))
    monkeypatch.setattr(tdist, "allgather_object", lambda obj: [obj, obj])
    args = tcli.build_parser().parse_args(
        ["4", "8", "4", "1.1", "--n", "12", "--temperatures", "1.0,1.2",
         "--chains-per-t", "3", "--global-ladder", "--device", "cpu"])
    with pytest.raises(SystemExit, match=r"--global-ladder: 6 ladder chains "
                       r"\(= 2 temps x 3\) must divide over the job's 4 "
                       r"devices"):
        tcli._run_ladder(args, TConfig.for_n(12), RunParams(4, 8, 4), None,
                         None, None, "torch", 7, None, nproc=2, rank=0)


# ----------------------------------------------------------------------
# Wall parameters
# ----------------------------------------------------------------------

@pytest.mark.parametrize("m", [3, 10])
def test_make_wall_params_matches_jax(m):
    """a = x0^12 ym, b = x0^6 ym per site against tpu_smc's in float64
    (round-off only: pow may take another path)."""
    jcfg = JConfig.for_n(16, m=m, dtype="float64")
    tcfg = TConfig.for_n(16, m=m, dtype="float64")
    rng = np.random.default_rng(m)
    x0 = rng.normal(1.6, 0.1, m * m)
    ym = rng.normal(3.0, 0.5, m * m)
    want = np.asarray(jpot.make_wall_params(jnp.asarray(x0), jnp.asarray(ym),
                                            jcfg))
    got = tpot.make_wall_params(x0, ym, tcfg)
    assert got.dtype == torch.float64 and got.shape == (m * m, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)
    f32 = tpot.make_wall_params(x0, ym, TConfig.for_n(16, m=m))
    assert f32.dtype == torch.float32
    np.testing.assert_array_equal(f32.numpy(), want.astype(np.float32))


def test_sample_wall_params_moments():
    """x0 and ym drawn per site from the port's Philox stream: the same
    words give the same table on any call, other words another; over
    M = 100 (10^4 sites) the means and spreads within 4 standard errors
    of the configured ones, and a sigma of 0 pins the mean."""
    cfg = dataclasses.replace(TConfig.for_n(16, m=100, dtype="float64"),
                              wall_x0_sigma=0.1)
    w = tpot.sample_wall_params(seed_words(3), cfg, device="cpu")
    assert torch.equal(w, tpot.sample_wall_params(seed_words(3), cfg,
                                                  device="cpu"))
    assert not torch.equal(w, tpot.sample_wall_params(seed_words(4), cfg,
                                                      device="cpu"))
    x0 = (w[:, 0] / w[:, 1]).numpy() ** (1.0 / 6.0)
    ym = w[:, 1].numpy() / x0 ** 6
    n = len(x0)
    for v, mean, sd in ((x0, cfg.wall_x0_mean, cfg.wall_x0_sigma),
                        (ym, cfg.wall_ym_mean, cfg.wall_ym_sigma)):
        assert abs(v.mean() - mean) < 4 * sd / math.sqrt(n)
        assert abs(v.std() - sd) < 4 * sd / math.sqrt(2 * n)
    pinned = tpot.sample_wall_params(seed_words(3), TConfig.for_n(
        16, dtype="float64"), device="cpu")
    np.testing.assert_allclose(pinned[:, 0].numpy() / pinned[:, 1].numpy(),
                               1.6 ** 6, rtol=1e-12)
