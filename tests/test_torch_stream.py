"""The streamed sweep path (K3) and the memory-bounded observables against
tpu_smc, on the CPU: the streamed kernel's plain version move for move
against tpu_smc.sampler.sweep in float64 and bitwise against the resident
z-skip plain version; the zsorted engine's streamed route bitwise its
resident route and its auto routing; row-chunked pair energy and pressure
and neighbour-list CNA against tpu_smc with the chunk budget forced small;
the numpy positions formatter byte for byte against Python's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_smc.observables as jobs
import tpu_smc.potentials as jpot
import tpu_smc.sampler as jsam
from tpu_smc.config import SMCConfig as JConfig
from tpu_smc.system import build_walls, fcc_lattice
from tpu_smc_torch import ensemble as ten
from tpu_smc_torch import io as tio
from tpu_smc_torch import observables as tobs
from tpu_smc_torch import potentials as tpot
from tpu_smc_torch.config import SMCConfig as TConfig
from tpu_smc_torch.kernels import sweep as ks
from tpu_smc_torch.state import init_ensemble_state, seed_words

# tiny tensors: keep torch's intra-op pool from competing with the
# other test workers for cores
torch.set_num_threads(1)


def _sorted_start(n, c, seed, dtype="float64"):
    """c chains of a jittered FCC start, rows sorted by z per chain."""
    cfg = TConfig.for_n(n, dtype=dtype)
    rng = np.random.default_rng(seed)
    r = fcc_lattice(cfg)[None] + rng.normal(0.0, 0.3, (c, n, 3))
    return np.take_along_axis(r, np.argsort(r[..., 2], axis=1)[..., None],
                              axis=1)


def test_stream_plain_matches_jax_sweep_float64():
    """sweep_block_stream_plain in float64 is tpu_smc.sampler.sweep move
    for move under the same injected noise, uniforms and offset (the
    method and tolerance of test_plain_kernel_matches_jax_sweep_float64).
    N = 256 gives two blocks, so passes read one or both."""
    n, c, off = 256, 2, 77
    jc, tc = JConfig.for_n(n, dtype="float64"), \
        TConfig.for_n(n, dtype="float64")
    w = build_walls(jc)[0]
    r = _sorted_start(n, c, 1)
    rng = np.random.default_rng(2)
    noise = rng.normal(0.0, np.sqrt(2 * jc.proposal_a), (c, n, 3))
    unif = rng.uniform(0.0, 1.0, (c, n))
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(
        jnp.arange(c))
    e0 = jax.vmap(lambda x: jpot.total_energy(x, jnp.asarray(w), jc))(
        jnp.asarray(r))

    def jsweep(x, e, k, nz, u):
        # tpu_smc.sampler.sweep with its draws replaced by the injected ones
        import unittest.mock as um
        with um.patch.object(jax.random, "normal",
                             lambda *a, **kw: nz / jnp.sqrt(2.0 * jc.proposal_a)), \
                um.patch.object(jax.random, "uniform", lambda *a, **kw: u):
            return jsam.sweep(x, e, k, jnp.asarray(w), jc, jc.proposal_a,
                              offset=jnp.int32(off))

    outs = [jsweep(jnp.asarray(r[i]), e0[i], keys[i], jnp.asarray(noise[i]),
                   jnp.asarray(unif[i])) for i in range(c)]
    rj = np.stack([np.asarray(o[0]) for o in outs])
    ej = np.asarray([float(o[1]) for o in outs])
    accj = np.asarray([int(o[3]) for o in outs])

    rt = torch.as_tensor(r)
    planes = [rt[..., k].T.contiguous() for k in range(3)]   # n = N_pad
    wa = torch.as_tensor(w[:, 0])[None]
    wb = torch.as_tensor(w[:, 1])[None]
    g = torch.roll(torch.as_tensor(noise), -off, dims=1).permute(1, 0, 2)
    u = torch.as_tensor(unif).T
    diag = {}
    x, y, z, e, etr, atr = ks.sweep_block_stream_plain(
        *planes, torch.as_tensor(np.array(e0))[None], wa, wb,
        torch.tensor([off]), torch.zeros((1, 2), dtype=torch.int64), tc, 1,
        tc.proposal_a, draws=(g[None], u[None]), diag=diag)
    np.testing.assert_array_equal(atr[0].numpy(), accj)
    assert 0 < accj.min() and accj.max() < n
    np.testing.assert_allclose(ks.from_planes(x, y, z, tc).numpy(), rj,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(e[0].numpy(), ej, rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(etr[0].numpy(), e[0].numpy())
    assert (diag["visited"].numpy() < 2 * n * n).all()


def _kernel_args(n, c, seed, walls=None, sweeps=2):
    """float32 kernel inputs of c chains from a z-sorted jittered start."""
    cfg = TConfig.for_n(n)
    state, w = init_ensemble_state(cfg, seed_words(seed), c,
                                   r0=_sorted_start(n, 1, seed)[0], w=walls,
                                   device="cpu")
    x, y, z, e, wa, wb = ten._kernel_inputs(state, w, cfg)
    words, offsets = ten._per_sweep_randomness(state, cfg, seed, sweeps)
    return cfg, w, (x, y, z, e, wa, wb, offsets, words)


def test_stream_plain_bitwise_zskip_plain():
    """On the same z-sorted rows the streamed plain version, which reads
    only each pass's envelope rows and masks the mover by its row id, is
    bitwise the resident z-skip plain version, which masks all rows and
    parks the mover; both visit the same rows. N = 260 gives 3 blocks."""
    cfg, _, args = _kernel_args(260, 2, 9)
    dz, ds = {}, {}
    skip = ks.sweep_block_plain(*args, cfg, 2, cfg.proposal_a, zskip=True,
                                diag=dz)
    stream = ks.sweep_block_stream_plain(*args, cfg, 2, cfg.proposal_a,
                                         diag=ds)
    for a, b in zip(skip, stream):
        assert torch.equal(a, b)
    assert torch.equal(dz["visited"], ds["visited"])
    assert bool((ds["visited"] < 2 * 2 * 260 * 264).all())
    assert 0 < int(stream[5].sum()) < 2 * 2 * 260


def test_sweep_block_stream_cpu_is_plain_and_adapters():
    """CPU tensors take the plain version (no launch counted); the
    chain-major adapter is its own inverse."""
    cfg, _, args = _kernel_args(140, 2, 3)
    before = dict(ks.sweep_block.launches)
    out = ks.sweep_block_stream(*args, cfg, 1, cfg.proposal_a)
    ref = ks.sweep_block_stream_plain(*args, cfg, 1, cfg.proposal_a)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert ks.sweep_block.launches == before
    xc, yc, zc = ks.chain_major(*args[:3])
    assert xc.shape == (2, args[0].shape[0]) and xc.is_contiguous()
    assert torch.equal(xc[1], args[0][:, 1])
    assert all(torch.equal(a, b) for a, b in
               zip(ks.chain_major(xc, yc, zc), args[:3]))


def test_stream_uniform_rows_and_identical_walls_bitwise():
    """Uniform per-chain (A, T) rows and identical per-chain wall tables
    through the streamed path equal the scalar, shared-row call."""
    cfg, w, args = _kernel_args(140, 3, 5, sweeps=1)
    x, y, z, e, wa, wb, offsets, words = args
    scalar = ks.sweep_block_stream(*args, cfg, 1, cfg.proposal_a)
    full = lambda v: torch.full((3,), v, dtype=torch.float64)
    rows = ks.sweep_block_stream(*args, cfg, 1, full(cfg.proposal_a),
                                 temperature=full(cfg.temperature))
    tab = ks.wall_coeff_rows(w.expand(3, -1, -1), cfg)
    same = ks.sweep_block_stream(x, y, z, e, *tab, offsets, words, cfg, 1,
                                 cfg.proposal_a)
    for u, v, s in zip(scalar, rows, same):
        assert torch.equal(u, v) and torch.equal(u, s)


def test_zsorted_hbm_stream_bitwise():
    """ensemble_sweeps_zsorted(hbm_stream=True) is bitwise the resident
    route through the whole wrapper: sort chunks (4 sweeps at cadence 3:
    a full chunk and a remainder), identity carry, traces."""
    cfg = TConfig.for_n(200)
    rng = np.random.default_rng(4)
    r0 = fcc_lattice(cfg) + rng.normal(0.0, 0.3, (200, 3))
    state, w = init_ensemble_state(cfg, seed_words(6), 2, r0=r0,
                                   device="cpu")
    kw = dict(seed=7, sweeps_per_sort=3)
    res, tr1 = ten.ensemble_sweeps_zsorted(state, w, cfg, cfg.proposal_a, 4,
                                           hbm_stream=False, **kw)
    st, tr2 = ten.ensemble_sweeps_zsorted(state, w, cfg, cfg.proposal_a, 4,
                                          hbm_stream=True, **kw)
    for a, b in ((res.r, st.r), (res.energy, st.energy),
                 (tr1.energy, tr2.energy), (tr1.accepted, tr2.accepted),
                 (res.accepted, st.accepted)):
        assert torch.equal(a, b)
    assert tr1.energy.shape == (4, 2) and int(tr1.accepted.sum()) > 0


def test_zsorted_auto_streams_when_resident_does_not_fit(monkeypatch):
    """hbm_stream=None streams exactly when resident_fits says no; True
    and False force either route. Capacity is set to 512 rows here and
    the sweep calls are captured, not run."""
    seen = []

    def capture(route):
        def fn(*a, **kw):
            seen.append(route)
            raise RuntimeError("stop after capture")
        return fn

    monkeypatch.setattr(ks, "resident_fits",
                        lambda n_pad, device=None, sites=0: n_pad <= 512)
    monkeypatch.setattr(ks, "sweep_block", capture("resident"))
    monkeypatch.setattr(ks, "sweep_block_stream", capture("stream"))
    for n, force, route in ((520, None, "stream"), (512, None, "resident"),
                            (200, True, "stream"), (520, False, "resident")):
        cfg = TConfig.for_n(n)
        state, w = init_ensemble_state(cfg, seed_words(0), 2, device="cpu")
        with pytest.raises(RuntimeError, match="stop after capture"):
            ten.ensemble_sweeps_zsorted(state, w, cfg, cfg.proposal_a, 4,
                                        hbm_stream=force)
        assert seen[-1] == route, (n, force)


# ----------------------------------------------------------------------
# Memory-bounded observables
# ----------------------------------------------------------------------

def _configs(n, bulk=False):
    """Two chains of n particles: jammed (a dense random blob, ~20 bonds
    per particle within lca_cutoff, across the periodic x edge) and
    gas-like (uniform in a slab, a few bonds). bulk: in the rho = 0.5
    cube of _config(n, True), the blob across the x and the z edge and
    the second chain uniform in the cube."""
    cfg = _config(JConfig, n, bulk)
    rng = np.random.default_rng(n)
    if bulk:
        side = (n / 0.9) ** (1.0 / 3.0)
        jam = rng.uniform(-side / 2, side / 2, (n, 3)) + cfg.box_l / 2
        jam[:, 1] -= cfg.box_l / 2
        jam -= cfg.box_l * np.round(jam / cfg.box_l)
        gas = rng.uniform(-0.5, 0.5, (n, 3)) * cfg.box_l
        return np.stack([jam, gas])
    side = (n / 0.9) ** (1.0 / 3.0)
    jam = rng.uniform(-side / 2, side / 2, (n, 3))
    jam[:, 0] += cfg.box_l / 2
    jam[:, :2] -= cfg.box_l * np.round(jam[:, :2] / cfg.box_l)
    gas = rng.uniform(-0.5, 0.5, (n, 3)) * [cfg.box_l, cfg.box_l,
                                             0.15 * cfg.box_lz]
    return np.stack([jam, gas])


def _config(cls, n, bulk):
    """The default box for n, or the bulk fluid at rho = 0.5 (z periodic,
    no walls); float64."""
    if bulk:
        return cls.bulk(n=n, temperature=1.5, rho=0.5, dtype="float64")
    return cls.for_n(n, dtype="float64")


def _z_image_pairs(r, cfg, cut):
    """Pairs within `cut` of each other only through the periodic z
    image, over the chains of r [C, N, 3]."""
    d = r[:, :, None, :] - r[:, None, :, :]
    d[..., :2] -= cfg.box_l * np.round(d[..., :2] / cfg.box_l)
    dz = d[..., 2] - cfg.box_lz * np.round(d[..., 2] / cfg.box_lz)
    near = d[..., 0] ** 2 + d[..., 1] ** 2 + dz ** 2 < cut * cut
    return int((near & (np.abs(d[..., 2]) > cfg.box_lz / 2)).sum())


# N, bulk: the default box (ids "108", "1024" as before) and the bulk
# fluid at rho 0.5 with pairs across the z boundary
OBS_CASES = pytest.mark.parametrize(
    "n, bulk", [(108, False), (1024, False), (108, True), (256, True)],
    ids=["108", "1024", "bulk108", "bulk256"])


def _small_budget(monkeypatch, n):
    """A pair budget of 0.4 N^2 elements: row chunks of 0.2 N rows for
    two chains and pair batches of 0.4 N^2 / K^2 pairs."""
    monkeypatch.setattr(tpot, "PAIR_BUDGET", 2 * n * n // 5)


@OBS_CASES
def test_chunked_energy_pressure_match_jax(n, bulk, monkeypatch):
    """Row-chunked pair energy, pair virial pressure and total energy
    equal tpu_smc's within 1e-10 relative; in the bulk cases z takes the
    minimum image and there is no wall term."""
    _small_budget(monkeypatch, n)
    jc, tc = _config(JConfig, n, bulk), _config(TConfig, n, bulk)
    r = _configs(n, bulk)
    if bulk:
        assert tc.pbc_z and not tc.use_walls
        assert _z_image_pairs(r, tc, tc.lj_cutoff) > n
    w = build_walls(jc)[0]
    rt, wt = torch.as_tensor(r), torch.as_tensor(w)
    assert tpot.pair_row_chunk(2, n) < n
    for tf, jf in ((tpot.pair_energy_total, jpot.pair_energy_total),
                   (tpot.pair_virial_pressure, jpot.pair_virial_pressure)):
        got = tf(rt, tc).numpy()
        want = np.asarray(jax.vmap(lambda x: jf(x, jc))(jnp.asarray(r)))
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    got = tpot.total_energy(rt, wt, tc).numpy()
    want = np.asarray(jax.vmap(lambda x: jpot.total_energy(
        x, jnp.asarray(w), jc))(jnp.asarray(r)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


@OBS_CASES
def test_cna_neighbour_lists_match_jax(n, bulk, monkeypatch):
    """Neighbour-list CNA counts exactly tpu_smc's histograms on a jammed
    and a gas-like chain, through several row chunks and pair batches; in
    the bulk cases bonds also form through the z image."""
    _small_budget(monkeypatch, n)
    jc, tc = _config(JConfig, n, bulk), _config(TConfig, n, bulk)
    r = _configs(n, bulk)
    if bulk:
        assert _z_image_pairs(r, tc, tc.lca_cutoff) > n
    got = tobs.cluster_histograms_chains(torch.as_tensor(r), tc)
    analyse = jax.jit(lambda x: jobs.cluster_histograms(
        jobs.cluster_analysis(x, jc)))
    for ci in range(2):
        want = analyse(jnp.asarray(r[ci]))
        for k in range(3):
            np.testing.assert_array_equal(got[k][ci].numpy(),
                                          np.asarray(want[k]))
    nbr = tobs.neighbour_lists(torch.as_tensor(r[0]), tc)
    assert nbr.shape[1] > 10 and int(got[0][0]) > 5 * n   # jammed
    if not bulk:
        assert 0 < int(got[0][1]) < n                      # gas-like


def test_cluster_analysis_all_pairs_match_jax(monkeypatch):
    """The all-pairs CNA (num1, num2, num3 of every pair) on neighbour
    lists equals tpu_smc's pair for pair."""
    _small_budget(monkeypatch, 108)
    jc, tc = JConfig.for_n(108, dtype="float64"), \
        TConfig.for_n(108, dtype="float64")
    r = _configs(108)[0]
    want = jobs.cluster_analysis(jnp.asarray(r), jc)
    got = tobs.cluster_analysis(torch.as_tensor(r), tc)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_positions_rows_byte_identical(tmp_path):
    """fixed3_csv and PositionsWriter rows equal Python's '%0.3f,' text
    byte for byte: float32 positions, exact decimal ties in float64,
    signed zeros, tiny negatives, non-finite and huge values."""
    rng = np.random.default_rng(0)
    ties = rng.integers(-10 ** 6, 10 ** 6, 4000) / 2000.0
    edge = np.array([0.0, -0.0, -4e-4, 5e-4, 0.0625, -999.9995, 1e13,
                     np.inf, -np.inf, np.nan, 2.5e-4, -1.0005])
    r32 = rng.normal(0.0, 60.0, (2, 500, 3)).astype(np.float32)
    for values in (r32, ties, edge, np.zeros(0)):
        flat = np.asarray(values, np.float64).reshape(-1).tolist()
        assert tio.fixed3_csv(values) == "".join(f"{v:0.3f}," for v in flat)
    cfg = TConfig.for_n(500)
    wr = tio.PositionsWriter(tmp_path, cfg, rank=0)
    wr.append(r32[0])
    wr.append(r32[1])
    lines = wr.path.read_text().split("\n")
    for ci in range(2):
        flat = np.asarray(r32[ci], np.float64).reshape(-1).tolist()
        assert lines[1 + ci] == "".join(f"{v:0.3f}," for v in flat)


def test_cli_routes_large_n_to_the_streamed_engine(monkeypatch):
    """Beyond the resident kernel's capacity the CLI prints the streamed
    engine for zsorted and refuses --sampler dense by naming it; within
    it nothing changes (capacity set to 1024 rows on a CUDA device here;
    none on the CPU, as in resident_fits)."""
    from tpu_smc_torch import cli as tcli

    monkeypatch.setattr(ks, "resident_fits", lambda n_pad, device=None,
                        sites=0: (
        torch.device(device or "cuda").type != "cuda" or n_pad <= 1024))
    big, small = TConfig.for_n(2048), TConfig.for_n(1024)
    assert tcli._resolve_sampler("auto", big, "cuda") == "zsorted"
    assert tcli._engine_label("zsorted", big, "cuda") == "zsorted (streamed)"
    assert tcli._engine_label("zsorted", small, "cuda") == "zsorted"
    assert tcli._engine_label("zsorted", big, "cpu") == "zsorted"
    assert tcli._resolve_sampler("dense", small, "cuda") == "dense"
    with pytest.raises(SystemExit, match="streamed"):
        tcli._resolve_sampler("dense", big, "cuda")
