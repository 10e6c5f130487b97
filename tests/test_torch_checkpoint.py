"""Checkpoint, resume, graceful stop, fault replay and health checks in the
port against tpu_smc: the checkpoint format both ways, bitwise resume at a
window boundary (one chain, ensembles on the plain engine and the plain
versions of the dense and z-skip kernels, tsweep and PT ladders), the
CLI's SIGTERM stop and resume, the transactional window's replay, the
fault classification, and state_health / check_state against
tpu_smc.guards."""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_smc.guards as jguards
import tpu_smc.io as jio
from tpu_smc.config import RunParams
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc.state import init_chain_state as j_init
from tpu_smc.state import init_ensemble_state as j_init_ens
from tpu_smc_torch import cli as tcli
from tpu_smc_torch import driver_ensemble as tde
from tpu_smc_torch import guards as tguards
from tpu_smc_torch import io as tio
from tpu_smc_torch.config import SMCConfig as TConfig
from tpu_smc_torch.driver import (ObservableOptions, is_device_fault,
                                  simulate)
from tpu_smc_torch.driver_ensemble import simulate_ensemble
from tpu_smc_torch.kernels.sweep import KernelLaunchError
from tpu_smc_torch.pt import simulate_parallel_tempering
from tpu_smc_torch.state import (ChainState, batch_chain_state,
                                 broadcast_resumed_chain, from_jax_state,
                                 init_chain_state, init_ensemble_state,
                                 seed_words)
from tpu_smc_torch.tsweep import simulate_temperature_sweep

# tiny tensors: keep torch's intra-op pool from competing with the
# other test workers for cores
torch.set_num_threads(1)

N = 32
LEAVES = ("r", "energy", "key", "sweeps", "accepted", "rbin", "density",
          "mobility")


def _equal(a: ChainState, b: ChainState):
    for f in LEAVES:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


def _advanced(c: int, cfg=None):
    """A C-chain state with nonzero counters: 3 sweeps and one gather."""
    cfg = cfg or TConfig.for_n(N, storage_time=1)
    state, w = init_ensemble_state(cfg, seed_words(2), c, device="cpu")
    state, _ = simulate_ensemble(cfg, RunParams(1, 2, 1), state, w,
                                 opts=ObservableOptions(stream_seed=2))
    return cfg, state, w


def test_checkpoint_round_trip(tmp_path, capsys):
    """save then load returns the state, config and stream seed exactly;
    '.npz' is appended to a bare path; a second save keeps the first as
    <stem>.prev.npz; a one-chain checkpoint without its chain axis loads
    as a single chain."""
    cfg, state, _ = _advanced(3)
    assert int(state.density.sum()) > 0 and int(state.sweeps[0]) == 3
    p = tio.save_checkpoint(tmp_path / "ck", state, cfg, stream_seed=77)
    assert p == tmp_path / "ck.npz" and p.exists()
    ck = tio.load_checkpoint(p, device="cpu")
    _equal(ck.state, state)
    assert ck.cfg == cfg and ck.batched and ck.stream_seed == 77
    first = p.read_bytes()
    state2 = state.replace(sweeps=state.sweeps + 1)
    assert tio.save_checkpoint(p, state2, cfg) == p
    assert (tmp_path / "ck.prev.npz").read_bytes() == first
    back = tio.load_checkpoint(p, device="cpu")
    _equal(back.state, state2)
    assert back.stream_seed is None
    one = batch_chain_state(ChainState(**{f: getattr(state, f)[:1]
                                          for f in LEAVES}), 1)
    p1 = tio.save_checkpoint(tmp_path / "one.npz", one, cfg,
                             chain_axis=False)
    with np.load(p1) as data:
        assert data["r"].shape == (N, 3) and data["key"].dtype == np.uint32
    ck1 = tio.load_checkpoint(p1, device="cpu")
    assert not ck1.batched
    _equal(ck1.state, one)
    with pytest.raises(ValueError, match="one chain"):
        tio.save_checkpoint(tmp_path / "x", state, cfg, chain_axis=False)
    assert "dropped" not in capsys.readouterr().out


@pytest.mark.parametrize("batched", [False, True])
def test_jax_checkpoint_loads_like_from_jax_state(tmp_path, capsys, batched):
    """A checkpoint written by tpu_smc.io.save_checkpoint (int32/uint32
    counters, max_gathers_per_call in its config) loads into the port
    with the arrays from_jax_state makes of the same state, the TPU-only
    config field dropped with a note; a single chain gains its chain
    axis."""
    jc = JConfig.for_n(N, storage_time=3)
    if batched:
        js, jw = j_init_ens(jc, jax.random.key(4), 3)
    else:
        js, jw = j_init(jc, jax.random.key(4))
    js = js._replace(
        r=js.r + 0.25, sweeps=js.sweeps + 40, accepted=js.accepted + 7,
        density=js.density.at[..., 5].set(11),
        mobility=js.mobility.at[..., 9].set(3))
    path = jio.save_checkpoint(tmp_path / "jax.npz", js, jc)
    ck = tio.load_checkpoint(path, device="cpu")
    assert "max_gathers_per_call" in capsys.readouterr().out
    arrays = {f: np.asarray(getattr(js, f)) for f in js._fields
              if f != "key"}
    arrays["key"] = np.asarray(jax.random.key_data(js.key))
    if not batched:
        arrays = {k: v[None] for k, v in arrays.items()}
    want, _ = from_jax_state(arrays, np.asarray(jw), ck.cfg, device="cpu")
    _equal(ck.state, want)
    assert ck.batched == batched and ck.stream_seed is None
    assert ck.cfg == TConfig.for_n(N, storage_time=3)
    # and the other way: tpu_smc reads the port's checkpoint
    back = tio.save_checkpoint(tmp_path / "port", ck.state, ck.cfg,
                               chain_axis=batched)
    js2, jc2 = jio.load_checkpoint(back)
    np.testing.assert_array_equal(np.asarray(js2.r), np.asarray(js.r))
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(js2.key)),
                                  np.asarray(jax.random.key_data(js.key)))
    assert jc2.n == N and jc2.storage_time == 3


def test_broadcast_resumed_chain_keeps_counters_once():
    """A resumed chain broadcast to C chains keeps its density/mobility
    history in chain 0 only; positions, energy and sweeps replicate and
    the keys fold by chain index as batch_chain_state's."""
    cfg, state, _ = _advanced(1)
    b = broadcast_resumed_chain(state, 4)
    plain = batch_chain_state(state, 4)
    assert torch.equal(b.density[0], state.density[0])
    assert torch.equal(b.mobility[0], state.mobility[0])
    assert int(b.density[1:].abs().sum()) == int(b.mobility[1:].abs().sum()) \
        == 0
    assert int(b.density.sum()) == int(state.density.sum()) > 0
    for f in ("r", "energy", "key", "sweeps", "rbin"):
        assert torch.equal(getattr(b, f), getattr(plain, f)), f
    assert int(state.density.sum()) > 0   # the source is left untouched


def _stop_after(k):
    """on_window hook ending the run after k windows."""
    return lambda widx, st, outs: "stop" if widx + 1 == k else None


@pytest.mark.parametrize("chains,sampler", [(1, "torch"), (2, "torch"),
                                            (2, "dense"), (2, "zsorted")])
def test_resume_at_window_boundary_is_bitwise(tmp_path, chains, sampler):
    """A run stopped after its first storage window, checkpointed,
    reloaded and resumed with eqsteps 0 and the remaining gathers ends
    bitwise where the uninterrupted run ends, with the same energy,
    pressure and acceptance rows from the split on and the same voxel
    counts; for one chain through driver.simulate, for ensembles through
    simulate_ensemble on each engine (the kernels' plain versions)."""
    cfg = TConfig.for_n(N, storage_time=2, lca_time=2)
    opts = ObservableOptions(sampler=sampler, stream_seed=6)
    run = simulate if chains == 1 else simulate_ensemble
    s0, w = init_chain_state(cfg, seed_words(6), device="cpu")
    start = batch_chain_state(s0, chains)
    full = RunParams(2, 12, 6)
    end_a, res_a = run(cfg, full, start, w, opts=opts)
    mid, _ = run(cfg, full, start, w, opts=opts, on_window=_stop_after(1))
    assert int(mid.sweeps[0]) == 2 + 2 * 2
    path = tio.save_checkpoint(tmp_path / "ck", mid, cfg,
                               chain_axis=chains > 1, stream_seed=6)
    ck = tio.load_checkpoint(path, device="cpu")
    end_c, res_c = run(ck.cfg, RunParams(0, 8, 4), ck.state, w, opts=opts)
    _equal(end_c, end_a.replace(accepted=end_c.accepted))
    pairs = [(res_a, res_c)] if chains == 1 else \
        list(zip(res_a.chains, res_c.chains))
    for a, c in pairs:
        np.testing.assert_array_equal(a.energy_trace_full[4:],
                                      c.energy_trace_full)
        np.testing.assert_array_equal(a.pressure_trace[2:], c.pressure_trace)
        np.testing.assert_array_equal(a.accept_trace[4:], c.accept_trace)
        np.testing.assert_array_equal(a.density, c.density)
        np.testing.assert_array_equal(a.mobility, c.mobility)


@pytest.mark.parametrize("ladder", ["tsweep", "pt"])
def test_ladder_resume_is_bitwise(tmp_path, ladder):
    """A ladder run of 2 + 4 sweeps, checkpointed, reloaded and resumed
    with state0 for 4 more sweeps (eqsteps 0) ends bitwise where the
    2 + 8 sweep run ends; PT's exchange attempts are numbered from the
    state's absolute sweep counter, so its swaps continue too. A state
    of another chain count is refused."""
    cfg = TConfig.for_n(N)
    temps = [0.9, 1.3]
    kw = dict(sampler="torch", device="cpu")
    if ladder == "pt":
        def run(params, state0=None, cpt=2):
            return simulate_parallel_tempering(
                cfg, params, temps, seed_words(8), chains_per_t=cpt,
                exchange_interval=2, state0=state0, **kw)
    else:
        def run(params, state0=None, cpt=2):
            return simulate_temperature_sweep(
                cfg, params, temps, seed_words(8), chains_per_t=cpt,
                state0=state0, **kw)
    end_a, _ = run(RunParams(2, 8, 4))
    mid, _ = run(RunParams(2, 4, 2))
    ck = tio.load_checkpoint(tio.save_checkpoint(tmp_path / "l", mid, cfg),
                             device="cpu")
    end_c, _ = run(RunParams(0, 4, 2), state0=ck.state)
    assert torch.equal(end_c.r, end_a.r) and \
        torch.equal(end_c.energy, end_a.energy)
    assert torch.equal(end_c.sweeps, end_a.sweeps)
    with pytest.raises(ValueError, match="chains"):
        run(RunParams(0, 2, 1), state0=ck.state, cpt=3)


def _cli(argv, tmp_path, sub):
    return tcli.main(argv + ["--data-dir", str(tmp_path / sub / "Data")])


def _run_dir(root):
    (d,) = (root / "Data").iterdir()
    return d


@pytest.mark.parametrize("chains", [1, 2])
def test_cli_sigterm_stop_and_resume(tmp_path, monkeypatch, capsys, chains):
    """scripts/resume_drill.py's protocol in-process: A uninterrupted; B
    with --auto-checkpoint 1 gets SIGTERM once its first checkpoint has
    landed, finishes the window, checkpoints and stops; C resumes B's
    checkpoint with the remaining steps into B's directory. last_state
    and local are byte-identical to A's; the (E, P) columns of data and
    the positions rows of C are A's tail."""
    common = ["2", "8", "4", "1.1", "--n", str(N), "--chains", str(chains),
              "--device", "cpu", "--sampler", "torch", "--seed", "33",
              "--storage-time", "1"]
    assert _cli(common, tmp_path, "A") == 0
    save = tio.save_checkpoint
    fired = []

    def save_then_signal(*args, **kw):
        path = save(*args, **kw)
        if not fired:
            fired.append(path)
            signal.raise_signal(signal.SIGTERM)
        return path

    handler = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(tio, "save_checkpoint", save_then_signal)
    ck = tmp_path / "ckB.npz"
    assert _cli(common + ["--auto-checkpoint", "1", "--checkpoint", str(ck)],
                tmp_path, "B") == 0
    monkeypatch.setattr(tio, "save_checkpoint", save)
    assert signal.getsignal(signal.SIGTERM) == handler   # restored
    out = capsys.readouterr().out
    assert "[signal" in out and f"Checkpoint written to {ck}" in out
    with np.load(ck) as data:
        done = int(data["sweeps"].reshape(-1)[0])
    assert done == 2 + 2, done            # stopped after window 1 of 4
    assert _cli(["0", "6", "3", "1.1", "--n", str(N), "--chains",
                 str(chains), "--device", "cpu", "--sampler", "torch",
                 "--storage-time", "1", "--resume", str(ck)],
                tmp_path, "B") == 0
    assert "Resumed full" in capsys.readouterr().out
    da, db = _run_dir(tmp_path / "A"), _run_dir(tmp_path / "B")
    for pat in ("last_state_*.csv", "local_N*_rank*.csv"):
        fa, fb = sorted(da.glob(pat)), sorted(db.glob(pat))
        assert [f.name for f in fa] == [f.name for f in fb] and fa
        for a, b in zip(fa, fb):
            assert a.read_bytes() == b.read_bytes(), a.name
    for pat, cols in (("data_N*_rank*.csv", 2), ("positions_*_rank*.csv",
                                                  None)):
        fa, fb = sorted(da.glob(pat)), sorted(db.glob(pat))
        assert len(fa) == len(fb) == chains
        for a, b in zip(fa, fb):
            ra = [",".join(ln.split(",")[:cols]) for ln in
                  a.read_text().splitlines()]
            rb = [",".join(ln.split(",")[:cols]) for ln in
                  b.read_text().splitlines()]
            assert ra[0] == rb[0] and ra[-(len(rb) - 1):] == rb[1:], a.name


class _FaultOnce:
    """Wrap the per-gather function: raise `exc` from the chosen call on,
    `times` times, then delegate."""

    def __init__(self, fn, exc, fail_on_call=2, times=1):
        self.fn, self.exc, self.fail_on, self.times = fn, exc, fail_on_call, \
            times
        self.calls = 0

    def __call__(self, *a, **k):
        self.calls += 1
        if self.calls >= self.fail_on and self.times > 0:
            self.times -= 1
            raise self.exc
        return self.fn(*a, **k)


CFG_F = TConfig(n=16, box_l=12.0, box_lz=40.0, storage_time=2, lca_time=2)
PARAMS_F = RunParams(eqsteps=2, maxsteps=8, numdata=8)


def _fresh(chains):
    s0, w = init_chain_state(CFG_F, seed_words(11), device="cpu")
    return batch_chain_state(s0, chains), w


@pytest.mark.parametrize("chains,exc", [
    (1, KernelLaunchError("smc_sweep_launch", 2)),
    (3, torch.cuda.OutOfMemoryError("CUDA out of memory (injected)"))])
def test_fault_replay_is_bitwise(monkeypatch, capsys, chains, exc):
    """A retryable fault mid-window (the window's second gather) drops
    the window's partial gathers, restores the window-start snapshot and
    replays it: results and final state bitwise those of a clean run,
    and one [elastic] retry reported."""
    opts = ObservableOptions(stream_seed=5)
    run = simulate if chains == 1 else simulate_ensemble
    st, w = _fresh(chains)
    clean_state, clean = run(CFG_F, PARAMS_F, st, w, opts=opts)
    inj = _FaultOnce(tde._gather_step_batched, exc, fail_on_call=4)
    monkeypatch.setattr(tde, "_gather_step_batched", inj)
    st, w = _fresh(chains)
    state, faulted = run(CFG_F, PARAMS_F, st, w, opts=opts)
    assert inj.times == 0 and inj.calls == 10
    assert capsys.readouterr().out.count("[elastic] device fault in window "
                                         "1 (retry 1/2)") == 1
    _equal(state, clean_state)
    pairs = [(clean, faulted)] if chains == 1 else \
        list(zip(clean.chains, faulted.chains))
    for a, b in pairs:
        for f in ("energy_trace_full", "accept_trace", "pressure_trace",
                  "density", "r_final", "l2"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        assert a.acceptance_ratio == b.acceptance_ratio


def test_retry_budget_exhaustion_reraises(monkeypatch):
    st, w = _fresh(1)
    inj = _FaultOnce(tde._gather_step_batched,
                     KernelLaunchError("smc_sweep_launch", 2),
                     fail_on_call=1, times=99)
    monkeypatch.setattr(tde, "_gather_step_batched", inj)
    with pytest.raises(KernelLaunchError, match="cudaError 2"):
        simulate(CFG_F, PARAMS_F, st, w, max_fault_retries=2)
    assert inj.calls == 3   # initial + 2 retries


def test_non_fault_errors_are_not_swallowed(monkeypatch):
    st, w = _fresh(1)

    def boom(*a, **k):
        raise TypeError("a programming error, not a device fault")

    monkeypatch.setattr(tde, "_gather_step_batched", boom)
    with pytest.raises(TypeError):
        simulate(CFG_F, PARAMS_F, st, w)


def test_disabled_retries_reraise_immediately(monkeypatch):
    st, w = _fresh(1)
    inj = _FaultOnce(tde._gather_step_batched,
                     KernelLaunchError("smc_sweep_launch", 2),
                     fail_on_call=1)
    monkeypatch.setattr(tde, "_gather_step_batched", inj)
    with pytest.raises(KernelLaunchError):
        simulate(CFG_F, PARAMS_F, st, w, max_fault_retries=0)
    assert inj.calls == 1


def test_is_device_fault_classification():
    """Retryable: launch errors a live context survives and CUDA out of
    memory. Not: sticky errors (illegal address, launch failure), torch's
    own CUDA errors seen at a synchronisation, programming errors."""
    for code in (1, 2, 9, 98, 209, 701):
        assert is_device_fault(KernelLaunchError("smc_sweep_launch", code))
    for code in (700, 702, 714, 715, 716, 717, 718, 719):
        assert not is_device_fault(KernelLaunchError("smc_sweep_launch",
                                                     code))
    assert is_device_fault(torch.cuda.OutOfMemoryError("out of memory"))
    assert not is_device_fault(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    assert not is_device_fault(ValueError("cudaError 2"))


def test_state_health_matches_jax_guards(capsys):
    """state_health and check_state against tpu_smc.guards on the same
    3-chain state (float64): a particle beyond the periodic box, one
    through a wall, a carried energy off by 0.5; then a NaN."""
    jc = JConfig.for_n(N, dtype="float64")
    tc = TConfig.for_n(N, dtype="float64")
    js, jw = j_init_ens(jc, jax.random.key(9), 3)
    r = js.r.at[1, 3, 0].set(jc.box_l / 2 + 0.5)
    r = r.at[2, 5, 2].set(-jc.box_lz / 2 - 0.1)
    js = js._replace(r=r, energy=js.energy.at[0].add(0.5))
    arrays = {f: np.asarray(getattr(js, f)) for f in js._fields
              if f != "key"}
    arrays["key"] = np.asarray(jax.random.key_data(js.key))
    ts, tw = from_jax_state(arrays, np.asarray(jw), tc, device="cpu")
    jh = jguards.state_health(js, jw, jc)
    th = tguards.state_health(ts, tw, tc)
    assert bool(th.finite) == bool(jh.finite) is True
    assert int(th.escaped_xy) == int(jh.escaped_xy) == 1
    assert int(th.through_wall) == int(jh.through_wall) == 1
    np.testing.assert_allclose(float(th.energy_drift), float(jh.energy_drift),
                               rtol=1e-9)
    assert float(th.energy_drift) >= 0.5
    with pytest.raises(tguards.HealthError, match="Valhalla") as te:
        tguards.check_state(ts, tw, tc)
    with pytest.raises(jguards.HealthError) as je:
        jguards.check_state(js, jw, jc)
    assert str(te.value) == str(je.value)
    tguards.check_state(ts, tw, tc, strict=False)
    assert "WARNING: 1 particles escaping" in capsys.readouterr().out
    bad = ts.replace(energy=ts.energy.clone())
    bad.energy[2] = float("nan")
    jbad = js._replace(energy=js.energy.at[2].set(jnp.nan))
    assert not bool(tguards.state_health(bad, tw, tc).finite)
    assert not bool(jguards.state_health(jbad, jw, jc).finite)
    ok, okw = init_ensemble_state(tc, seed_words(1), 2, device="cpu")
    h = tguards.check_state(ok, okw, tc)
    assert bool(h.finite) and int(h.escaped_xy) == int(h.through_wall) == 0
