"""The CUDA whole-sweep kernels on the card: against their plain version
with identical Philox draws, z-skip on/off bitwise, the streamed kernel
(K3) bitwise the resident one, the capacity routing, and the wrapper's
checks; one chain bitwise chain 0 of eight (a launch, and the single-
chain driver), and a checkpoint round trip of a card state; K4 on a sweep
that draws a row twice in a row, and K5 on planes with a ragged tail;
the plain engine and the batched drivers (tsweep, PT, tuning, NPT,
Gibbs) with their chains split over [cuda:0, cuda:0], bitwise one call.

Needs an NVIDIA GPU and nvcc (the kernel has no CPU mode); skips
elsewhere. Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_smc_torch import ensemble as ten
from tpu_smc_torch.config import SMCConfig
from tpu_smc_torch.kernels import sweep as ks
from tpu_smc_torch.state import init_ensemble_state, seed_words

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(n, c, device, sort):
    cfg = SMCConfig.for_n(n)
    rng = np.random.default_rng(n)
    state, w = init_ensemble_state(cfg, seed_words(1), c, device=device)
    r = state.r + torch.as_tensor(rng.normal(0.0, 0.3, state.r.shape),
                                  dtype=torch.float32, device=device)
    if sort:
        r = torch.take_along_dim(r, r[..., 2].argsort(1)[..., None], 1)
    state = state.replace(r=r)
    words, offsets = ten._per_sweep_randomness(state, cfg, 5, 2)
    x, y, z, _, wa, wb = ten._kernel_inputs(state, w, cfg)
    from tpu_smc_torch.potentials import total_energy

    e = total_energy(r, w, cfg).reshape(1, -1)
    return cfg, (x, y, z, e, wa, wb, offsets, words)


@pytest.mark.parametrize("zskip", [False, True])
def test_kernel_matches_plain(cuda, zskip):
    cfg, args = _inputs(300, 32, cuda, zskip)
    dk, dp = {"uniforms": True}, {"uniforms": True}
    before = dict(ks.sweep_block.launches)
    outk = ks.sweep_block(*args, cfg, 2, cfg.proposal_a, zskip=zskip,
                          diag=dk)
    outp = ks.sweep_block_plain(*args, cfg, 2, cfg.proposal_a, zskip=zskip,
                                diag=dp)
    torch.cuda.synchronize()
    mode = "zskip" if zskip else "dense"
    assert ks.sweep_block.launches[mode] == before[mode] + 1
    assert torch.equal(dk["uniforms"], dp["uniforms"])
    same = (outk[5] == outp[5]).all(0)
    assert int(same.sum()) >= 30            # near-tie flips stay rare
    for k in range(3):
        np.testing.assert_allclose(outk[k][:, same].cpu().numpy(),
                                   outp[k][:, same].cpu().numpy(), atol=1e-2)
    np.testing.assert_allclose(outk[3][:, same].cpu().numpy(),
                               outp[3][:, same].cpu().numpy(),
                               rtol=1e-4, atol=5e-2)


def test_zskip_on_off_bitwise(cuda):
    cfg, args = _inputs(300, 32, cuda, True)
    dense = ks.sweep_block(*args, cfg, 2, cfg.proposal_a, zskip=False)
    dz = {}
    skip = ks.sweep_block(*args, cfg, 2, cfg.proposal_a, zskip=True, diag=dz)
    for a, b in zip(dense, skip):
        assert torch.equal(a, b)
    assert int(dz["visited"].max()) < 2 * 2 * 300 * 304


def test_wrapper_rejects_bad_inputs(cuda):
    cfg, args = _inputs(108, 4, cuda, False)
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(ValueError):
        ks.sweep_block(*bad, cfg, 2, cfg.proposal_a)
    bad = list(args)
    bad[1] = args[1].t().contiguous().t()[:, :3]
    with pytest.raises(ValueError):
        ks.sweep_block(*bad, cfg, 2, cfg.proposal_a)


def _ladder_rows(c, device):
    """Per-chain (A, T) of a 4-level ladder, temperature-major, float64."""
    temps = torch.repeat_interleave(
        torch.tensor([0.9, 1.1, 1.3, 1.5], dtype=torch.float64), c // 4)
    return temps.to(device) * 1.0, temps.to(device)


@pytest.mark.parametrize("zskip", [False, True])
def test_uniform_rows_bitwise_scalar(cuda, zskip):
    """Uniform per-chain (A, T) rows give bitwise the scalar call; a real
    ladder differs from it."""
    cfg, args = _inputs(300, 32, cuda, zskip)
    a = cfg.proposal_a
    scalar = ks.sweep_block(*args, cfg, 2, a, zskip=zskip)
    rows = ks.sweep_block(
        *args, cfg, 2, torch.full((32,), a, dtype=torch.float64,
                                  device=cuda),
        zskip=zskip, temperature=torch.full((32,), cfg.temperature,
                                            dtype=torch.float64, device=cuda))
    for u, v in zip(scalar, rows):
        assert torch.equal(u, v)
    a_c, t_c = _ladder_rows(32, cuda)
    ladder = ks.sweep_block(*args, cfg, 2, a_c, zskip=zskip, temperature=t_c)
    assert not torch.equal(ladder[0], scalar[0])


def test_per_chain_walls_vs_split_runs(cuda):
    """Per-chain wall tables [w0, w0, w1, w1] follow bitwise the runs with
    the shared row w0 (chains 0, 1) and w1 (chains 2, 3); identical tables
    are bitwise the shared row."""
    from tpu_smc_torch.system import build_wall_ensemble

    cfg, args = _inputs(108, 4, cuda, False)
    w_k = torch.as_tensor(build_wall_ensemble(cfg, 2)[0], device=cuda)
    x, y, z, e, _, _, offsets, words = args
    rows = [ks.wall_coeff_rows(w_k[g], cfg) for g in range(2)]
    table = ks.wall_coeff_rows(w_k.repeat_interleave(2, dim=0), cfg)
    comb = ks.sweep_block(x, y, z, e, *table, offsets, words, cfg, 2,
                          cfg.proposal_a)
    for g in range(2):
        split = ks.sweep_block(x, y, z, e, *rows[g], offsets, words, cfg, 2,
                               cfg.proposal_a)
        for u, v in zip(comb, split):
            assert torch.equal(u[..., 2 * g:2 * g + 2],
                               v[..., 2 * g:2 * g + 2])
    same = ks.wall_coeff_rows(w_k[0].expand(4, -1, -1), cfg)
    out = ks.sweep_block(x, y, z, e, *same, offsets, words, cfg, 2,
                         cfg.proposal_a)
    shared = ks.sweep_block(x, y, z, e, *rows[0], offsets, words, cfg, 2,
                            cfg.proposal_a)
    for u, v in zip(out, shared):
        assert torch.equal(u, v)


def test_stream_kernel_bitwise_resident(cuda):
    """K3 against the resident z-skip kernel on the same sorted rows at
    N = 4096 x 128: every output bitwise, both visiting the same rows."""
    cfg, args = _inputs(4096, 128, cuda, True)
    before = dict(ks.sweep_block.launches)
    dr, ds = {}, {}
    resident = ks.sweep_block(*args, cfg, 2, cfg.proposal_a, zskip=True,
                              diag=dr)
    stream = ks.sweep_block_stream(*args, cfg, 2, cfg.proposal_a, diag=ds)
    torch.cuda.synchronize()
    for u, v in zip(resident, stream):
        assert torch.equal(u, v)
    assert torch.equal(dr["visited"], ds["visited"])
    assert ks.sweep_block.launches["stream"] == before["stream"] + 1
    assert int(stream[5].sum()) > 0


def test_stream_engine_vs_resident_engine(cuda):
    """ensemble_sweeps_zsorted forced onto the streamed kernel equals its
    resident route bitwise (sort chunks, a remainder chunk, identity
    carry) at N = 4096 x 128."""
    cfg = SMCConfig.for_n(4096)
    state, w = init_ensemble_state(cfg, seed_words(3), 128, device=cuda)
    kw = dict(seed=4, sweeps_per_sort=2)
    res, tr1 = ten.ensemble_sweeps_zsorted(state, w, cfg, cfg.proposal_a, 3,
                                           hbm_stream=False, **kw)
    st, tr2 = ten.ensemble_sweeps_zsorted(state, w, cfg, cfg.proposal_a, 3,
                                          hbm_stream=True, **kw)
    for u, v in ((res.r, st.r), (res.energy, st.energy),
                 (tr1.energy, tr2.energy), (tr1.accepted, tr2.accepted)):
        assert torch.equal(u, v)


def test_resident_refuses_beyond_capacity(cuda):
    """The resident kernel's capacity is read from the device; beyond it
    sweep_block raises and names the streamed kernel, and the zsorted
    engine routes there by itself."""
    res_rows, stream_rows = ks.capacity(cuda)
    assert 16384 <= res_rows < 32768 < stream_rows
    # the wall coefficients share the budget: 8 bytes per site
    res9, stream9 = ks.capacity(cuda, 9)
    res100, stream100 = ks.capacity(cuda, 100)
    assert res100 < res9 <= res_rows and stream100 < stream9 <= stream_rows
    assert ks.resident_fits(16384, cuda) and not ks.resident_fits(32768, cuda)
    cfg = SMCConfig.for_n(32768)
    state, w = init_ensemble_state(cfg, seed_words(1), 2, device=cuda)
    x, y, z, e, wa, wb = ten._kernel_inputs(state, w, cfg)
    words, offsets = ten._per_sweep_randomness(state, cfg, 1, 1)
    with pytest.raises(ValueError, match="streamed"):
        ks.sweep_block(x, y, z, e, wa, wb, offsets, words, cfg, 1,
                       cfg.proposal_a, zskip=True)
    with pytest.raises(ValueError, match="streamed"):
        ten.ensemble_sweeps_dense(state, w, cfg, cfg.proposal_a, 1, seed=1)


def _agree(outk, outp, min_same):
    """Kernel against plain: accept counts equal on at least `min_same`
    chains (near-tie flips stay rare), positions within 1e-2 and energies
    within rtol 1e-4, atol 5e-2 on those (the tolerances of
    test_kernel_matches_plain)."""
    same = (outk[5] == outp[5]).all(0)
    assert int(same.sum()) >= min_same
    for k in range(3):
        np.testing.assert_allclose(outk[k][:, same].cpu().numpy(),
                                   outp[k][:, same].cpu().numpy(), atol=1e-2)
    np.testing.assert_allclose(outk[3][:, same].cpu().numpy(),
                               outp[3][:, same].cpu().numpy(),
                               rtol=1e-4, atol=5e-2)


def _cfg_inputs(cfg, c, device, r0=None, seed=5):
    state, w = init_ensemble_state(cfg, seed_words(seed), c, r0=r0,
                                   device=device)
    words, offsets = ten._per_sweep_randomness(state, cfg, seed, 2)
    x, y, z, e, wa, wb = ten._kernel_inputs(state, w, cfg)
    return (x, y, z, e, wa, wb, offsets, words)


@pytest.mark.parametrize("stream", [False, True])
def test_wall_grid_m10_matches_plain(cuda, stream):
    """M = 10 (100 wall sites, all in the launch's dynamic shared
    memory) on the resident dense kernel (K1) and on the streamed
    kernel (K3) against the plain version, identical uniforms; it used to
    fail to launch (cudaError 1)."""
    cfg = SMCConfig(n=108, m=10, box_l=10.0, box_lz=24.0)
    args = _cfg_inputs(cfg, 32, cuda)
    if stream:
        kernel, plain = ks.sweep_block_stream, ks.sweep_block_stream_plain
    else:
        kernel, plain = ks.sweep_block, ks.sweep_block_plain
    dk, dp = {"uniforms": True}, {"uniforms": True}
    outk = kernel(*args, cfg, 2, cfg.proposal_a, diag=dk)
    outp = plain(*args, cfg, 2, cfg.proposal_a, diag=dp)
    torch.cuda.synchronize()
    assert torch.equal(dk["uniforms"], dp["uniforms"])
    _agree(outk, outp, 30)


@pytest.mark.parametrize("n", [12, 256])
def test_pbc_kernel_matches_plain(cuda, n):
    """K1-pbc (z periodic, no walls, pads and self masked by row id)
    against the plain version: at N = 12 (4 pad rows, random start in a
    10^3 box, cutoff 3) and N = 256 (the bulk lattice at rho 0.5); a
    pbc_z and a no_walls launch counted; z-skip refused."""
    if n == 12:
        cfg = SMCConfig(n=12, box_l=10.0, box_lz=10.0, use_walls=False,
                        pbc_z=True, lj_cutoff=3.0)
        r0 = np.random.default_rng(5).uniform(-4.5, 4.5, (12, 3))
    else:
        cfg, r0 = SMCConfig.bulk(n=256, temperature=1.5, rho=0.5,
                                 gamma=0.01, lj_cutoff=2.5), None
    args = _cfg_inputs(cfg, 64, cuda, r0=r0)
    before = dict(ks.sweep_block.launches)
    dk, dp = {"uniforms": True}, {"uniforms": True}
    outk = ks.sweep_block(*args, cfg, 2, cfg.proposal_a, diag=dk)
    outp = ks.sweep_block_plain(*args, cfg, 2, cfg.proposal_a, diag=dp)
    torch.cuda.synchronize()
    for key in ("dense", "pbc_z", "no_walls"):
        assert ks.sweep_block.launches[key] == before[key] + 1
    assert torch.equal(dk["uniforms"], dp["uniforms"])
    _agree(outk, outp, 60)
    z = outk[2][:cfg.n]
    assert bool((z.abs() <= cfg.box_lz / 2).all())
    with pytest.raises(NotImplementedError, match="pbc_z"):
        ks.sweep_block(*args, cfg, 2, cfg.proposal_a, zskip=True)


def test_refnoise_kernel_matches_plain(cuda):
    """K1-rn (the reference's dependent noise pairs, by particle id)
    against the plain version at N = 108 x 64: the dumped pair and
    acceptance uniforms bitwise equal, trajectories within the
    tolerances; a reference_noise launch counted."""
    cfg = SMCConfig.for_n(108, reference_noise=True)
    args = _cfg_inputs(cfg, 64, cuda)
    before = ks.sweep_block.launches["reference_noise"]
    dk, dp = {"uniforms": True}, {"uniforms": True}
    outk = ks.sweep_block(*args, cfg, 2, cfg.proposal_a, diag=dk)
    outp = ks.sweep_block_plain(*args, cfg, 2, cfg.proposal_a, diag=dp)
    torch.cuda.synchronize()
    assert ks.sweep_block.launches["reference_noise"] == before + 1
    assert torch.equal(dk["uniforms"], dp["uniforms"])
    _agree(outk, outp, 60)
    iid = ks.sweep_block(*args, SMCConfig.for_n(108), 2, cfg.proposal_a)
    assert not torch.equal(iid[0], outk[0])


def test_debug_reference_noise_matches_plane(cuda):
    """K5 against reference_noise_plane on the same words: within 1e-6
    (the same uniforms bitwise; sqrt, log1p, cos, sin may round
    differently on the card), and a launch counted."""
    before = ks.sweep_block.launches["debug_reference_noise"]
    d = ks.debug_reference_noise((12345, 678), 4096, 256, 0.3, cuda)
    p = ks.reference_noise_plane((12345, 678), 4096, 256, 0.3, cuda)
    torch.cuda.synchronize()
    assert ks.sweep_block.launches["debug_reference_noise"] == before + 1
    assert d.shape == (12288, 256)
    assert float((d - p).abs().max()) <= 1e-6


@pytest.mark.parametrize("n,c", [(7, 37), (5000, 301)])
def test_debug_reference_noise_ragged_tail(cuda, n, c):
    """K5 on planes that end in a ragged tail: 12 pairs x 37 chains
    (the last block of 32 chains holds 5; two pairs a thread over 8 pair
    rows a step leave 4 of the second step's 8 rows past the end) and
    7500 pairs x 301 chains, more than one wave of blocks covers, so the
    grid-stride loop turns over and ends mid-step: within 1e-6 of
    reference_noise_plane; seed words in a tensor on the card (read by
    the kernel) give bitwise the plane of host words."""
    words = (2024, 99)
    before = ks.sweep_block.launches["debug_reference_noise"]
    d = ks.debug_reference_noise(words, n, c, 0.3, cuda)
    on_card = ks.debug_reference_noise(
        torch.tensor(words, dtype=torch.int32, device=cuda), n, c, 0.3, cuda)
    p = ks.reference_noise_plane(words, n, c, 0.3, cuda)
    torch.cuda.synchronize()
    assert ks.sweep_block.launches["debug_reference_noise"] == before + 2
    assert d.shape == (ks.noise_rows(n), c)
    assert float((d - p).abs().max()) <= 1e-6
    assert torch.equal(d, on_card)


def _xsorted_args(n, c, k, device, r0=None, seed=5):
    """Kernel inputs of one sweep on rows sorted by z-band of 128 k rows
    and by x within each band (ensemble.xsort_perm)."""
    cfg = SMCConfig.for_n(n)
    x, y, z, e, wa, wb, offsets, words = _cfg_inputs(cfg, c, device, r0=r0,
                                                     seed=seed)
    perm = ten.xsort_perm(x, z, n, k)
    x, y, z = (torch.take_along_dim(p, perm, 0) for p in (x, y, z))
    return cfg, (x, y, z, e, wa, wb, offsets[:1], words[:1])


def _seam(n, seed=12):
    """n particles with every x within 1.5 of the periodic seam +-L/2."""
    rng = np.random.default_rng(seed)
    x = np.where(rng.uniform(size=n) < 0.5, -16.5 + rng.uniform(0, 1.5, n),
                 16.5 - rng.uniform(0, 1.5, n))
    return np.stack([x, rng.uniform(-16.5, 16.5, n),
                     rng.uniform(-60.0, 60.0, n)], axis=1)


def test_xskip_kernel_matches_plain(cuda):
    """K1-xs (the 2-D pass, k = 2) against its plain version at N = 256 x
    32 on 2-D-sorted rows: identical uniforms and visited rows, the
    trajectories within the tolerances; an xskip launch counted."""
    cfg, args = _xsorted_args(256, 32, 2, cuda)
    before = ks.sweep_block.launches["xskip"]
    dk, dp = {"uniforms": True}, {"uniforms": True}
    outk = ks.sweep_block(*args, cfg, 1, cfg.proposal_a, zskip=True,
                          xslices=2, diag=dk)
    outp = ks.sweep_block_plain(*args, cfg, 1, cfg.proposal_a, zskip=True,
                                xslices=2, diag=dp)
    torch.cuda.synchronize()
    assert ks.sweep_block.launches["xskip"] == before + 1
    assert torch.equal(dk["uniforms"], dp["uniforms"])
    _agree(outk, outp, 30)
    same = (outk[5] == outp[5]).all(0)
    assert torch.equal(dk["visited"][same], dp["visited"][same])


@pytest.mark.parametrize("n,k,seam", [(512, 2, False), (512, 4, False),
                                      (256, 2, True)])
def test_xskip_kernel_bitwise_dense(cuda, n, k, seam):
    """On the same 2-D-sorted rows K1-xs equals the dense kernel K1
    bitwise (every output), also on a cluster at the x seam; it visits
    fewer rows."""
    cfg, args = _xsorted_args(n, 32, k, cuda, r0=_seam(n) if seam else None)
    dd, dx = {}, {}
    dense = ks.sweep_block(*args, cfg, 1, cfg.proposal_a, diag=dd)
    xskip = ks.sweep_block(*args, cfg, 1, cfg.proposal_a, zskip=True,
                           xslices=k, diag=dx)
    for u, v in zip(dense, xskip):
        assert torch.equal(u, v)
    assert bool((dx["visited"] < dd["visited"]).all())


def _banded_against_plain(cuda, cfg, state, w, window, d_z, words=None,
                          diag=None):
    """K4 and its plain version on one sweep from `state`: the same
    schedule, a banded launch counted, per-chain fallback counts equal
    where the trajectories agree, positions and energies within the
    tolerances, carried E against a recompute. words: the sweep's seed
    words (default: the state's stream under seed 3); diag: filled by
    the plain version. Returns the fallback counts [C]."""
    from tpu_smc_torch.kernels import banded as kb
    from tpu_smc_torch.potentials import total_energy

    c = state.n_chains
    x, y, z, margin = kb.sort_and_margin(state.r, cfg, window)
    wa, wb = ks.wall_coeff_rows(w, cfg)
    e = state.energy.reshape(1, -1).float()
    if words is None:
        words = ten._per_sweep_randomness(state, cfg, 3, 1)[0][0]
    args = (x, y, z, e, wa, wb, margin, words, cfg, cfg.proposal_a, window,
            d_z)
    before = ks.sweep_block.launches["banded"]
    dk = {}
    outk = kb.banded_sweep_block(*args, diag=dk)
    outp = kb.banded_sweep_plain(*args, diag=diag)
    torch.cuda.synchronize()
    assert ks.sweep_block.launches["banded"] == before + 1
    assert torch.equal(dk["rows"].long(), kb.banded_rows(words, cfg.n, cuda))
    same = outk[4][0] == outp[4][0]
    assert int(same.sum()) >= c - 2
    assert torch.equal(outk[5][0][same], outp[5][0][same])
    for q in range(3):
        np.testing.assert_allclose(outk[q][:, same].cpu().numpy(),
                                   outp[q][:, same].cpu().numpy(), atol=1e-2)
    exact = total_energy(ks.from_planes(*outk[:3], cfg), w, cfg)
    np.testing.assert_allclose(outk[3][0].cpu().numpy(), exact.cpu().numpy(),
                               rtol=1e-4, atol=5e-2)
    return outk[5][0]


@pytest.mark.parametrize("window", [32, 512])
def test_banded_kernel_matches_plain(cuda, window):
    """K4 against its plain version at N = 512 x 32, one sweep, d_z = 12
    (`_banded_against_plain`). W = 32: moves fall back to the full pass
    (all of them, from this start); W = 512 >= n: every margin is
    clipped, every move takes the window (all rows)."""
    cfg = SMCConfig.for_n(512)
    state, w = init_ensemble_state(cfg, seed_words(2), 32, device=cuda)
    state, _ = ten.ensemble_sweeps_dense(state, w, cfg, cfg.proposal_a, 2,
                                         seed=2)
    fallback = int(_banded_against_plain(cuda, cfg, state, w, window,
                                         12.0).sum())
    assert fallback > 0 if window == 32 else fallback == 0


def _clusters(seed):
    """32 particles in 8 groups of 4 along z, 14 apart (squares of side
    1.12, jittered), in a 10 x 10 x 120 box: [32, 3] float64."""
    rng = np.random.default_rng(seed)
    sq = np.array([[0, 0], [1.12, 0], [0, 1.12], [1.12, 1.12]])
    r = []
    for g in range(8):
        xy = rng.uniform(-4.0, 3.0, 2) + sq
        z = -49.0 + 14.0 * g + rng.uniform(-0.3, 0.3, 4)
        r.append(np.column_stack([xy + rng.normal(0, 0.05, (4, 2)), z]))
    return np.concatenate(r)


def test_banded_kernel_partial_window(cuda):
    """K4 against its plain version where moves take a real partial
    window (rows [j0, j0 + 2W) with j0 > 0 or j0 + 2W < n_pad) and others
    fall back: 32 chains of z-separated clusters, W = 8, d_z = 24.5."""
    cfg = SMCConfig(n=32, box_l=10.0, box_lz=120.0, gamma=0.02)
    state, w = init_ensemble_state(cfg, seed_words(5), 32, r0=_clusters(5),
                                   device=cuda)
    fallback = _banded_against_plain(cuda, cfg, state, w, 8, 24.5)
    assert 0 < int(fallback.sum()) < cfg.n * 32
    # some chains take the window on most moves
    assert int(fallback.min()) < cfg.n // 2


def test_banded_kernel_repeated_row(cuda):
    """K4 against its plain version on a sweep whose schedule draws row
    13 at moves 2 and 3 (the words (3, 7) at N = 32; test_torch_banded.py
    pins it), with walls: the kernel takes the second move's position
    and wall terms from the first's proposal when it accepted and from
    its slots when it rejected; here move 2 accepts on some chains and
    rejects on others, and moves take the window or fall back."""
    cfg = SMCConfig(n=32, box_l=10.0, box_lz=120.0, gamma=0.02)
    state, w = init_ensemble_state(cfg, seed_words(5), 32, r0=_clusters(5),
                                   device=cuda)
    dp = {}
    fallback = _banded_against_plain(cuda, cfg, state, w, 8, 24.5,
                                     words=(3, 7), diag=dp)
    assert int(dp["rows"][2]) == int(dp["rows"][3]) == 13
    assert 0 < int(dp["accept"][2].sum()) < 32
    assert 0 < int(fallback.sum()) < cfg.n * 32


def test_banded_refuses_beyond_capacity(cuda):
    """K4 holds its planes in shared memory: N_pad beyond the resident
    capacity raises."""
    from tpu_smc_torch.kernels import banded as kb

    cfg = SMCConfig.for_n(32768)
    rows = ks.capacity(cuda, ks.wall_sites(cfg))[0]
    r = torch.zeros((1, 32768, 3), device=cuda)
    r[..., 2] = torch.linspace(-100, 100, 32768, device=cuda)
    x, y, z, margin = kb.sort_and_margin(r, cfg, 128)
    wa, wb = ks.wall_coeff_rows(torch.zeros((9, 2), device=cuda), cfg)
    e = torch.zeros((1, 1), device=cuda)
    with pytest.raises(ValueError, match=f"at most {rows} rows"):
        kb.banded_sweep_block(x, y, z, e, wa, wb, margin, (1, 2), cfg, 1.1)


# The pass keeps ROWS = 4 of a thread's rows in flight (csrc/sweep.cu
# `pair_rows`), the wall terms run in one warp beside the pass and the
# draws in another; the cases below hold that design at its edges.

def _layers(n, gap=3.6, side=12, spacing=1.5, jitter=0.05, seed=3):
    """n particles in z-layers of 128 rows (the last holds the rest),
    layer k at z = gap (k - (layers - 1) / 2) on a jittered side x side
    grid of the given spacing: row block b is layer b, and no other layer
    lies within the cutoff (3) of it, so a mover's first envelope is its
    own block."""
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    pos, layers = k % 128, -(-n // 128)
    r = np.stack([(pos % side - side / 2 + 0.5) * spacing,
                  (pos // side - side / 2 + 0.5) * spacing,
                  (k // 128 - (layers - 1) / 2) * gap], axis=1)
    return r + rng.normal(0.0, jitter, (n, 3))


# moves of a window at A = 8 (test_grouped_rows_edges): the kernel and
# the plain version start each window from the same planes
A8_WINDOW = 512


def _held_against_plain(args, cfg, a, close):
    """One z-skip sweep of `cfg` (its first cfg.n rows move) against the
    plain version on identical draws, as in chip_smoke: on every chain
    without a near-tie move the same accepted moves, visited rows within
    1 %; close: positions and energies too (_agree). Returns the plain
    version's diagnostics."""
    dk, dp = {"uniforms": True}, {"uniforms": True, "tie_margin": 1e-3}
    outk = ks.sweep_block(*args, cfg, 1, a, zskip=True, diag=dk)
    outp = ks.sweep_block_plain(*args, cfg, 1, a, zskip=True, diag=dp)
    torch.cuda.synchronize()
    assert torch.equal(dk["uniforms"], dp["uniforms"])
    clean = dp["near_ties"] == 0
    assert int(clean.sum()) >= 8
    assert torch.equal(outk[5][:, clean], outp[5][:, clean])
    vk, vp = dk["visited"][clean], dp["visited"][clean]
    assert bool(((vk - vp).abs() <= 0.01 * vp).all())
    if close:
        _agree([o[..., clean] for o in outk],
               [o[..., clean] for o in outp], int(clean.sum()))
    return dp


@pytest.mark.parametrize("n", [108, 1000, 4096])
def test_grouped_rows_edges(cuda, n):
    """The grouped row loop at its edges, on layers whose envelope is one
    block (_layers, 12 empty units above and below the stack), at the
    default mobility and at A = 4 and 8, whose proposals leave the stack
    (an empty envelope: at N = 108, one block, fewer rows visited than
    every pass over it); n_pad = 112, 1000 (not multiples of 128 x 4) and
    4096. At every mobility: z-skip bitwise the dense pass over the
    sweep, and against the plain version on identical draws as in
    chip_smoke: on every chain without a near-tie move (|min(log_ap, 0) -
    log u| < 1e-3, where float32 rounding may flip a decision) the same
    accepted moves and visited rows within 1 % (a block whose bound lies
    within rounding of a window's edge may count on one side only). At
    the default mobility and at A = 4 over the sweep, with positions
    within 1e-2 and energies within rtol 1e-4, atol 5e-2 on those chains.
    At A = 8 the step's F A/T term carries the float32 rounding of large
    forces into the positions, and over a sweep of 4096 moves the two
    versions' movers drift apart by up to 1.7e-2; a later decision can
    then flip far from a tie (scripts/torch_lane_order.py), which the
    margin does not cover. So at A = 8 the sweep's moves are held against
    plain in windows of A8_WINDOW moves that each start from the same
    planes (rolled by a multiple of 128 rows so the window's rows lead; a
    config with n = the window moves them, every row still interacts),
    decisions and visited rows only; the positions only bitwise against
    the dense pass."""
    layers = -(-n // 128)
    cfg = SMCConfig(n=n, box_l=18.0, box_lz=layers * 3.6 + 24.0)
    x, y, z, e, wa, wb, offsets, words = _cfg_inputs(cfg, 64, cuda,
                                                     r0=_layers(n))
    args = (x, y, z, e, wa, wb, offsets[:1], words[:1])
    n_pad = x.shape[0]
    for a, close in ((cfg.proposal_a, True), (4.0, True), (8.0, False)):
        outk = ks.sweep_block(*args, cfg, 1, a, zskip=True)
        dense = ks.sweep_block(*args, cfg, 1, a)
        for u, v in zip(dense, outk):
            assert torch.equal(u, v)
        assert int(outk[5].sum()) > 0
        win = n if close else A8_WINDOW
        for k0 in range(0, n, win):
            part = dataclasses.replace(cfg, n=min(win, n - k0))
            wargs = tuple(torch.roll(p, -k0, 0) for p in args[:3]) + args[3:]
            dp = _held_against_plain(wargs, part, a, close)
        if n == 108 and a > cfg.proposal_a:
            assert float(dp["visited"].double().mean()) < 2 * n * n_pad


@pytest.mark.parametrize("stream", [False, True])
def test_m10_per_chain_walls_match_plain(cuda, stream):
    """M = 10 (100 sites: the wall warp's site loop, not the unrolled M = 3
    grid) with per-chain wall tables of 4 realizations, on the resident
    dense kernel (K1-w) and on the streamed kernel (K3), against the plain
    version on identical draws; four identical tables are bitwise the
    shared row."""
    from tpu_smc_torch.system import build_wall_ensemble

    cfg = SMCConfig(n=108, m=10, box_l=10.0, box_lz=24.0)
    w4 = build_wall_ensemble(cfg, 4)[0]
    state, w = init_ensemble_state(cfg, seed_words(5), 32,
                                   w=np.repeat(w4, 8, axis=0), device=cuda)
    words, offsets = ten._per_sweep_randomness(state, cfg, 5, 2)
    x, y, z, e, wa, wb = ten._kernel_inputs(state, w, cfg)
    assert wa.shape[0] == 32
    if stream:
        kernel, plain = ks.sweep_block_stream, ks.sweep_block_stream_plain
    else:
        kernel, plain = ks.sweep_block, ks.sweep_block_plain
    args = (x, y, z, e, wa, wb, offsets, words)
    dk, dp = {"uniforms": True}, {"uniforms": True}
    outk = kernel(*args, cfg, 2, cfg.proposal_a, diag=dk)
    outp = plain(*args, cfg, 2, cfg.proposal_a, diag=dp)
    torch.cuda.synchronize()
    assert torch.equal(dk["uniforms"], dp["uniforms"])
    _agree(outk, outp, 28)
    w0 = torch.as_tensor(w4[0], device=cuda)
    same = ks.wall_coeff_rows(w0.expand(32, -1, -1), cfg)
    shared = ks.wall_coeff_rows(w0, cfg)
    out_same = kernel(x, y, z, e, *same, offsets, words, cfg, 2,
                      cfg.proposal_a)
    out_shared = kernel(x, y, z, e, *shared, offsets, words, cfg, 2,
                        cfg.proposal_a)
    for u, v in zip(out_same, out_shared):
        assert torch.equal(u, v)


@pytest.mark.parametrize("n", [1100, 2400])
def test_stream_kernel_bitwise_resident_odd_blocks(cuda, n):
    """K3 against the resident z-skip kernel on the same sorted rows at an
    odd number of row blocks (N = 1100: 9 blocks, the last of 76 rows;
    N = 2400: 19 blocks, with per-chain (A, T) of 4 levels): every output
    and the visited rows bitwise."""
    cfg, args = _inputs(n, 64, cuda, True)
    assert -(-args[0].shape[0] // 128) % 2 == 1
    a, t = (_ladder_rows(64, cuda) if n == 2400
            else (cfg.proposal_a, None))
    dr, ds = {}, {}
    resident = ks.sweep_block(*args, cfg, 2, a, zskip=True, diag=dr,
                              temperature=t)
    stream = ks.sweep_block_stream(*args, cfg, 2, a, diag=ds, temperature=t)
    torch.cuda.synchronize()
    for u, v in zip(resident, stream):
        assert torch.equal(u, v)
    assert torch.equal(dr["visited"], ds["visited"])
    assert int(stream[5].sum()) > 0


@pytest.mark.parametrize("zskip", [False, True])
def test_one_chain_launch_is_chain0(cuda, zskip):
    """A launch of one chain (C = 1, one CTA) is bitwise chain 0 of a
    launch of 8 chains on the same inputs, for K1 and K2: a chain's work
    and draws depend on its index only."""
    cfg, args = _inputs(1024 if zskip else 108, 8, cuda, zskip)
    x, y, z, e, wa, wb, offsets, words = args
    one = (x[:, :1].contiguous(), y[:, :1].contiguous(),
           z[:, :1].contiguous(), e[:, :1].contiguous(), wa, wb, offsets,
           words)
    before = dict(ks.sweep_block.launches)
    out8 = ks.sweep_block(*args, cfg, 2, cfg.proposal_a, zskip=zskip)
    out1 = ks.sweep_block(*one, cfg, 2, cfg.proposal_a, zskip=zskip)
    torch.cuda.synchronize()
    mode = "zskip" if zskip else "dense"
    assert ks.sweep_block.launches[mode] == before[mode] + 2
    for u, v in zip(out1, out8):
        assert torch.equal(u, v[:, :1])
    assert int(out1[5].sum()) > 0


@pytest.mark.parametrize("sampler,n", [("dense", 108), ("zsorted", 1024)])
def test_simulate_one_chain_is_chain0_on_card(cuda, sampler, n):
    """driver.simulate of one chain on the card is bitwise chain 0 of
    simulate_ensemble of 8 chains from the same seeded start, through
    thermalization, gathers, resyncs and observables."""
    from tpu_smc_torch.config import RunParams
    from tpu_smc_torch.driver import ObservableOptions, simulate
    from tpu_smc_torch.driver_ensemble import simulate_ensemble
    from tpu_smc_torch.state import batch_chain_state, init_chain_state

    cfg = SMCConfig.for_n(n, storage_time=2, lca_time=2)
    params = RunParams(16, 64, 4)
    opts = ObservableOptions(sampler=sampler, stream_seed=7)
    s0, w = init_chain_state(cfg, seed_words(7), device=cuda)
    st1, one = simulate(cfg, params, batch_chain_state(s0, 1), w, opts=opts)
    st8, ens = simulate_ensemble(cfg, params, batch_chain_state(s0, 8), w,
                                 opts=opts)
    c0 = ens.chains[0]
    for f in ("r_final", "energy_trace_full", "accept_trace",
              "pressure_trace", "density", "mobility", "l2"):
        np.testing.assert_array_equal(getattr(one, f), getattr(c0, f), f)
    assert torch.equal(st1.r[0], st8.r[0])


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """save_checkpoint then load_checkpoint of a card state returns card
    tensors equal to it."""
    from tpu_smc_torch import io as tio

    cfg = SMCConfig.for_n(108)
    state, _ = init_ensemble_state(cfg, seed_words(3), 4, device=cuda)
    state = state.replace(r=state.r + 0.125, sweeps=state.sweeps + 9,
                          density=state.density + 2)
    path = tio.save_checkpoint(tmp_path / "card", state, cfg, stream_seed=3)
    ck = tio.load_checkpoint(path, device=cuda)
    assert ck.batched and ck.stream_seed == 3 and ck.cfg == cfg
    for f in ("r", "energy", "key", "sweeps", "accepted", "rbin", "density",
              "mobility"):
        got, want = getattr(ck.state, f), getattr(state, f)
        assert got.is_cuda and got.dtype == want.dtype, f
        assert torch.equal(got, want), f


def _cluster_on(device, c=3, n=256, seed=0):
    """A dense jittered cluster on the lower wall (float32)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n] * 1.15
    r = g[None] - np.array([4.0, 4.0, 98.8]) \
        + rng.normal(0.0, 0.08, (c, n, 3))
    return torch.as_tensor(r, dtype=torch.float32, device=device)


def test_structure_observables_on_card_match_cpu(cuda):
    """g(r) (the same integer pair counts), rho(z), P_N/P_T(z) and S(k)
    on the card against the CPU on the same float32 positions: counts
    equal, profiles within 1e-5 of their largest value."""
    from tpu_smc_torch import observables as tobs

    cfg = SMCConfig.for_n(256)
    r = _cluster_on(cuda)
    rc = r.cpu()
    np.testing.assert_array_equal(
        tobs.radial_distribution(r, cfg, nbins=32)[1].cpu().numpy(),
        tobs.radial_distribution(rc, cfg, nbins=32)[1].numpy())
    vol = cfg.box_l ** 2 * cfg.box_lz / 40      # the counts, then rho(z)
    zg = tobs.z_density_profile(r, cfg, nbins=40)[1].cpu().numpy()
    zc = tobs.z_density_profile(rc, cfg, nbins=40)[1].numpy()
    np.testing.assert_array_equal(np.rint(zg * vol), np.rint(zc * vol))
    np.testing.assert_allclose(zg, zc, rtol=1e-6)
    for fn in (lambda x: tobs.pressure_tensor_profile(x, cfg, nbins=24)[1],
               lambda x: tobs.pressure_tensor_profile(x, cfg, nbins=24)[2],
               lambda x: tobs.structure_factor(x, cfg, n_kmax=4)[1]):
        a, b = fn(r).cpu().numpy(), fn(rc).numpy()
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def test_widom_delta_u_on_card_matches_cpu(cuda):
    """The ghost stream and the ghost energies on the card against the
    CPU (float32): the same ghosts, energies within 1e-4 relative where
    finite, per-chain walls included."""
    from tpu_smc_torch import widom
    from tpu_smc_torch.system import build_wall_ensemble, build_walls

    cfg = SMCConfig.for_n(256)
    r = _cluster_on(cuda, seed=1)
    key = torch.tensor([[1, 2], [3, 4], [5, 6]], device=cuda)
    g = widom.ghost_positions(key, 9, cfg, 500)
    gc = widom.ghost_positions(key.cpu(), 9, cfg, 500)
    assert torch.equal(g.cpu(), gc)
    g[:, :50] = r[:, :50] + 0.9        # ghosts inside the cluster
    for w_np in (build_walls(cfg)[0], build_wall_ensemble(cfg, 3)[0]):
        w = torch.as_tensor(w_np, dtype=torch.float32)
        du = widom.widom_delta_u(r, w.to(cuda), cfg, g).cpu().numpy()
        du_c = widom.widom_delta_u(r.cpu(), w, cfg, g.cpu()).numpy()
        ok = np.isfinite(du_c)
        np.testing.assert_array_equal(np.isfinite(du), ok)
        np.testing.assert_allclose(du[ok], du_c[ok], rtol=1e-4, atol=1e-6)


def test_native_formatters_build_on_the_card_machine(tmp_path):
    """The C++ formatters build with this machine's g++ and write the
    plain twins' bytes (runs with or without a card)."""
    from tpu_smc_torch import io as tio
    from tpu_smc_torch import native

    native.build()
    rng = np.random.default_rng(0)
    v = rng.normal(0.0, 50.0, 3000).astype(np.float32)
    assert native.format_positions_row(v) == (tio.fixed3_csv(v)
                                              + "\n").encode()
    d = rng.integers(0, 10 ** 6, 33 * 33 * 33)
    assert native.format_local_rows(d, d[::-1], 33, 33) == \
        tio.local_rows_plain(d, d[::-1], 33, 33).encode()


@pytest.mark.parametrize("mode", ["plain", "umbrella", "ladder_walls"])
def test_sweep_graph_replays_the_eager_sweep(cuda, mode):
    """The plain engine on the card (ensemble_sweeps: each sweep a
    replayed CUDA graph, sampler.run_step) is bitwise the eager sweeps
    under the same injected draws over several calls: uniform (A, T), the
    umbrella bias, per-chain (A, T) rows with per-chain walls; one graph
    per (shape, A, T, umbrella tag), w and the rows copied in."""
    from tpu_smc_torch import ensemble as en
    from tpu_smc_torch import sampler as tsam
    from tpu_smc_torch.system import build_wall_ensemble

    cfg = SMCConfig.for_n(108)
    c, s_n = 16, 3
    st, w = init_ensemble_state(cfg, seed_words(3), c, device=cuda)
    kw, bias = {}, None
    if mode == "umbrella":
        bias = (0, 4.0, torch.linspace(-20.0, 20.0, c, device=cuda))
    if mode == "ladder_walls":
        w = torch.as_tensor(np.repeat(build_wall_ensemble(cfg, 4)[0], 4, 0),
                            dtype=torch.float32, device=cuda)
        t = torch.linspace(1.0, 1.6, c, dtype=torch.float64, device=cuda)
        kw = dict(a_per_chain=cfg.gamma * t, t_per_chain=t)
    gen = torch.Generator(device="cpu").manual_seed(5)
    tsam._STEPS.clear()
    graph_st = eager = st
    for call in range(2):
        draws = (0.5 * torch.randn((s_n, c, cfg.n, 3), generator=gen),
                 torch.rand((s_n, c, cfg.n), generator=gen),
                 [7 * call + k for k in range(s_n)])
        draws = (draws[0].to(cuda), draws[1].to(cuda), draws[2])
        graph_st, _ = en.ensemble_sweeps(graph_st, w, cfg, cfg.proposal_a,
                                         s_n, draws=draws, umbrella=bias,
                                         **kw)
        a, t = en._chain_at(cfg.proposal_a, cfg, kw.get("a_per_chain"),
                            kw.get("t_per_chain"))
        for k in range(s_n):
            eager, _ = tsam.sweep_state(eager, w, cfg, a, draws[0][k],
                                        draws[1][k], draws[2][k],
                                        temperature=t, umbrella=bias)
    for f in ("r", "energy", "accepted", "sweeps"):
        assert torch.equal(getattr(graph_st, f), getattr(eager, f)), f
    assert len(tsam._STEPS) == 1


@pytest.mark.parametrize("mode", ["gcmc_slab", "gcmc_mu_per_chain", "npt",
                                  "npt_tp", "gibbs", "gibbs_temps"])
def test_ensemble_family_graphs_replay_the_eager_sweeps(cuda, mode,
                                                        monkeypatch):
    """The ensemble family on the card (each sweep a replayed CUDA graph,
    sampler.run_step, the box and masks copied in on every replay) is
    bitwise the same sweeps run eagerly: GCMC in the slab and with a
    per-chain mu, NPT with one pressure and with a per-chain (T, P) grid,
    Gibbs with one temperature and a per-chain ladder; across a resync
    and the thermalization / production switch of A."""
    from tpu_smc_torch import gcmc as tg
    from tpu_smc_torch import gibbs as tgb
    from tpu_smc_torch import npt as tn
    from tpu_smc_torch import sampler as tsam

    c = 8
    key = seed_words(4)

    def run():
        if mode.startswith("gcmc"):
            cfg = (SMCConfig.for_n(32) if mode == "gcmc_slab" else
                   SMCConfig.bulk(n=16, temperature=1.5, rho=0.05,
                                  gamma=0.02))
            mu = -8.0 if mode == "gcmc_slab" else np.linspace(-8, -5, c)
            st, _ = tg.simulate_gcmc(cfg, mu, 48, 3, 5, key, n_chains=c,
                                     chunk=4, z_bins=4, seed=4, device=cuda)
            return st, ("r", "active", "energy", "boltz_sum", "ins_acc")
        if mode.startswith("npt"):
            cfg = SMCConfig.bulk(n=32, temperature=2.0, rho=0.3, gamma=0.02,
                                 lj_cutoff=1.8, lj_shift=True)
            temps = np.linspace(1.6, 2.4, c) if mode == "npt_tp" else None
            st, _ = tn.simulate_npt(cfg, np.linspace(0.5, 1.5, c), 3, 5, key,
                                    n_chains=c, dlnv=0.2, chunk=4,
                                    temperatures=temps, seed=4, device=cuda)
            return st, ("r", "l", "energy", "vol_acc")
        cfg = SMCConfig.bulk(n=32, temperature=1.2, rho=0.6, gamma=0.02,
                             lj_cutoff=1.5, lj_shift=True)
        temps = np.linspace(0.8, 1.6, c) if mode == "gibbs_temps" else None
        st, _ = tgb.simulate_gibbs(cfg, 3, 5, key, 32, n_chains=c, dlnv=0.2,
                                   n_transfer=6, chunk=4, temperatures=temps,
                                   seed=4, device=cuda)
        return st, ("r", "active", "l", "energy", "boltz_sum", "tr_acc")

    tsam._STEPS.clear()
    graphed, fields = run()
    assert tsam._STEPS, "no graph captured"
    for mod in (tg, tn, tgb):
        monkeypatch.setattr(mod, "run_step", lambda key, fn, args: fn(*args))
    eager, _ = run()
    for f in fields:
        assert torch.equal(getattr(graphed, f), getattr(eager, f)), f


def _cols(args, lo, hi):
    """Columns lo..hi-1 of a launch's planes and energy row."""
    x, y, z, e, wa, wb, offsets, words = args
    return tuple(p[:, lo:hi].contiguous() for p in (x, y, z, e)) + (
        wa, wb, offsets, words)


@pytest.mark.parametrize("kind", ["dense", "zskip", "stream", "refnoise"])
def test_chain0_kernel_matches_plain(cuda, kind):
    """K1, K2, K3 and K1-rn with chain base chain0 = 256 against their
    plain versions with the same base: the dumped uniforms bitwise,
    trajectories within test_kernel_matches_plain's tolerances; and
    columns 4..7 launched alone with chain0 = 4 bitwise those columns of
    the 8-column launch."""
    if kind == "refnoise":
        cfg = SMCConfig.for_n(108, reference_noise=True)
        args = _cfg_inputs(cfg, 32, cuda)
    else:
        cfg, args = _inputs(300, 32, cuda, kind != "dense")
    kernel, plain = {
        "stream": (ks.sweep_block_stream, ks.sweep_block_stream_plain)}.get(
        kind, (ks.sweep_block, ks.sweep_block_plain))
    kw = {"zskip": True} if kind == "zskip" else {}
    dk, dp = {"uniforms": True}, {"uniforms": True}
    outk = kernel(*args, cfg, 2, cfg.proposal_a, diag=dk, chain0=256, **kw)
    outp = plain(*args, cfg, 2, cfg.proposal_a, diag=dp, chain0=256, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dk["uniforms"], dp["uniforms"])
    _agree(outk, outp, 28)
    base = kernel(*args, cfg, 2, cfg.proposal_a, **kw)
    assert not torch.equal(base[0], outk[0])
    wide = kernel(*_cols(args, 0, 8), cfg, 2, cfg.proposal_a, **kw)
    part = kernel(*_cols(args, 4, 8), cfg, 2, cfg.proposal_a, chain0=4,
                  **kw)
    for u, v in zip(part, wide):
        assert torch.equal(u, v[:, 4:])


def test_debug_reference_noise_chain0(cuda):
    """K5 with a chain base: columns of global chains 100..163, within
    1e-6 of reference_noise_plane with the same base, and bitwise the
    columns 100.. of a plane from chain 0."""
    d = ks.debug_reference_noise((12345, 678), 512, 64, 0.3, cuda,
                                 chain0=100)
    p = ks.reference_noise_plane((12345, 678), 512, 64, 0.3, cuda,
                                 chain0=100)
    assert float((d - p).abs().max()) <= 1e-6
    wide = ks.debug_reference_noise((12345, 678), 512, 164, 0.3, cuda)
    assert torch.equal(d, wide[:, 100:])


@pytest.mark.parametrize("engine", ["dense", "zsorted", "stream"])
def test_two_shards_on_one_card_bitwise(cuda, engine):
    """The sharded engines over [cuda:0, cuda:0] (two launches, each with
    its chain0) are bitwise the single call."""
    n = 108 if engine == "dense" else 1024
    cfg = SMCConfig.for_n(n)
    state, w = init_ensemble_state(cfg, seed_words(3), 64, device=cuda)
    mesh = ten.make_mesh(devices=[cuda, cuda])
    if engine == "dense":
        one = ten.ensemble_sweeps_dense(state, w, cfg, cfg.proposal_a, 4,
                                        seed=9)
        two = ten.ensemble_sweeps_dense_sharded(state, w, cfg,
                                                cfg.proposal_a, 4, 9, mesh)
    else:
        kw = dict(hbm_stream=engine == "stream", sweeps_per_sort=2)
        one = ten.ensemble_sweeps_zsorted(state, w, cfg, cfg.proposal_a, 4,
                                          seed=9, **kw)
        two = ten.ensemble_sweeps_zsorted_sharded(state, w, cfg,
                                                  cfg.proposal_a, 4, 9,
                                                  mesh, **kw)
    for u, v in ((one[0].r, two[0].r), (one[0].energy, two[0].energy),
                 (one[1].energy, two[1].energy),
                 (one[1].accepted, two[1].accepted)):
        assert torch.equal(u, v)


def _same(a, b) -> bool:
    """Results (NamedTuples of arrays, floats and None, nested) equal to
    the bit, the measured rate aside."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "sweeps_per_second":
            continue
        if hasattr(x, "_fields"):
            if not _same(x, y):
                return False
        elif (x is None) != (y is None) or x is not None and not \
                np.array_equal(np.asarray(x), np.asarray(y), equal_nan=(
                    np.asarray(x).dtype.kind == "f")):
            return False
    return True


def test_plain_engine_two_shards_on_one_card_bitwise(cuda):
    """The plain engine's CUDA graphs over [cuda:0, cuda:0] (one graph
    per shard's chain0 range, the same shapes), uniform and with
    per-chain (A, T) rows: bitwise the single call, traces included."""
    cfg = SMCConfig.for_n(108)
    state, w = init_ensemble_state(cfg, seed_words(3), 64, device=cuda)
    mesh = ten.make_mesh(devices=[cuda, cuda])
    t_c = torch.linspace(1.0, 1.3, 64, dtype=torch.float64, device=cuda)
    for rows in ({}, dict(a_per_chain=cfg.gamma * t_c, t_per_chain=t_c)):
        one = ten.ensemble_sweeps(state, w, cfg, cfg.proposal_a, 3,
                                  collect_trace=True, stream_seed=9, **rows)
        two = ten.ensemble_sweeps_sharded(state, w, cfg, cfg.proposal_a, 3,
                                          9, mesh, collect_trace=True,
                                          **rows)
        for u, v in ((one[0].r, two[0].r), (one[0].energy, two[0].energy),
                     (one[1].energy, two[1].energy),
                     (one[1].accepted, two[1].accepted)):
            assert torch.equal(u, v)


@pytest.mark.parametrize("driver", ["tsweep", "pt", "tune", "npt", "gibbs"])
def test_drivers_on_two_shards_of_one_card_bitwise(cuda, driver):
    """tsweep, PT (swap counts), tune_mobility, NPT and Gibbs with their
    chains split over [cuda:0, cuda:0]: bitwise the one-device run,
    results and state."""
    import dataclasses as dc

    from tpu_smc_torch import gibbs as tgb
    from tpu_smc_torch import npt as tnpt
    from tpu_smc_torch import pt as tpt
    from tpu_smc_torch import tsweep as tts
    from tpu_smc_torch import tuning as ttune
    from tpu_smc_torch.config import RunParams

    two = [cuda, cuda]
    temps = [1.0, 1.2, 1.4, 1.6]
    if driver in ("tsweep", "pt"):
        cfg = SMCConfig.for_n(1024 if driver == "pt" else 108)
        kw = dict(chains_per_t=32, device=cuda,
                  sampler="zsorted" if driver == "pt" else "dense")
        if driver == "pt":
            fn, kw["exchange_interval"] = tpt.simulate_parallel_tempering, 4
        else:
            fn = tts.simulate_temperature_sweep
        runs = [fn(cfg, RunParams(8, 16, 2), temps, seed_words(4),
                   devices=d, **kw) for d in (None, two)]
    elif driver == "tune":
        cfg = SMCConfig.for_n(108)
        st, w = init_ensemble_state(cfg, seed_words(5), 128, device=cuda)
        runs = [ttune.tune_mobility(cfg, st, w, target=0.5, sampler="dense",
                                    seed=9, sweeps_per_block=4,
                                    max_blocks=4, devices=d)
                for d in (None, two)]
    elif driver == "npt":
        cfg = SMCConfig.bulk(n=108, temperature=2.0, rho=0.3, gamma=0.02,
                             lj_cutoff=1.8, lj_shift=True)
        p_c = np.repeat([0.3, 1.0, 2.5, 0.7], 32)
        runs = [tnpt.simulate_npt(cfg, p_c, 6, 10, seed_words(9),
                                  n_chains=128, dlnv=0.1, seed=9, chunk=8,
                                  gr_bins=8, track_virial=True, device=cuda,
                                  devices=d) for d in (None, two)]
    else:
        cfg = SMCConfig.bulk(n=96, temperature=0.75, rho=0.6, gamma=0.02,
                             lj_cutoff=1.8, lj_shift=True)
        runs = [tgb.simulate_gibbs(cfg, 6, 10, seed_words(7), 96,
                                   n_chains=128, dlnv=0.08, n_transfer=24,
                                   seed=7, chunk=8, device=cuda, devices=d)
                for d in (None, two)]
    (s1, r1), (s2, r2) = runs
    assert r1 == r2 if driver == "tune" else _same(r1, r2)
    for f in dc.fields(s1):
        assert torch.equal(getattr(s1, f.name), getattr(s2, f.name)), f.name


@pytest.mark.parametrize("n", [108, 1024])
def test_box_pair_sums_do_not_follow_the_chain_count(cuda, n):
    """Under a per-chain box (NPT, Gibbs) a chain's pair energy and
    virial are the same bits whether 1, 8 or all 64 chains share the
    call (potentials.fixed_order_sum; torch's own sum over the rows
    changes its order below 16 chains)."""
    from tpu_smc_torch import potentials as tp

    cfg = SMCConfig.bulk(n=n, temperature=2.0, rho=0.3, gamma=0.02,
                         lj_cutoff=1.8, lj_shift=True)
    rng = np.random.default_rng(n)
    r = torch.as_tensor(rng.uniform(-cfg.box_l / 2, cfg.box_l / 2,
                                    (64, n, 3)), dtype=torch.float32,
                        device=cuda)
    box = torch.as_tensor(cfg.box_l * rng.uniform(0.98, 1.02, 64),
                          dtype=torch.float32, device=cuda)
    for fn in (tp.pair_energy_total, tp.pair_virial_pressure):
        whole = fn(r, cfg, box=box)
        for c in (1, 8):
            parts = torch.cat([fn(r[i:i + c], cfg, box=box[i:i + c])
                               for i in range(0, 64, c)])
            assert torch.equal(parts, whole)


@pytest.mark.parametrize("n,c,shares", [
    (12, 64, (64, 32, 16, 8)), (32, 64, (64, 32, 16, 8)),
    (96, 64, (64, 32, 16, 8)), (108, 64, (64, 32, 16, 8)),
    (216, 64, (64, 32, 16, 8)), (256, 64, (64, 32, 16, 8)),
    (1024, 64, (64, 32, 16, 8)), (4000, 16, (2,)), (32768, 4, (2,))])
def test_row_sums_under_split_of_are_the_whole_calls(cuda, n, c, shares):
    """torch's sum over a contiguous last axis of n terms, and the fixed
    box's pair energy, pressure (also in wall_obs_chains' batches, as the
    drivers take it), wall energy and one particle's pair energy and
    force (potentials.chain_sum): c chains summed in each of `shares`
    calls under split_of(c, shares) are the bits of the c-chain call.
    At N = 4000 and 32768 the pair sums and the batches cut the c-chain
    call into blocks of 4 and 1 chains."""
    from tpu_smc_torch import potentials as tp
    from tpu_smc_torch.observables import wall_obs_chains

    cfg = SMCConfig.for_n(n)
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.normal(0.0, 1.0, (c, n)), dtype=torch.float32,
                        device=cuda)
    state, w = init_ensemble_state(cfg, seed_words(n), c, device=cuda)
    r = state.r + torch.as_tensor(rng.normal(0.0, 0.2, state.r.shape),
                                  dtype=torch.float32, device=cuda)
    fns = {"row sum": lambda s: tp.chain_sum(x[s]),
           "pair energy": lambda s: tp.pair_energy_total(r[s], cfg),
           "wall energy": lambda s: tp.wall_energy_total(r[s], w, cfg),
           "pressure": lambda s: tp.total_pressure(r[s], w, cfg),
           "batched pressure": lambda s: wall_obs_chains(
               lambda rb, wb: tp.total_pressure(rb, wb, cfg), r[s], w, n),
           "particle": lambda s: torch.cat([
               t.reshape(len(t), -1) for t in tp.pair_energy_force_single(
                   r[s], 3, r[s][:, 3], cfg)], 1)}
    for name, fn in fns.items():
        whole = fn(slice(0, c))
        for k in shares:
            b = c // k
            with tp.split_of(c, k):
                parts = torch.cat([fn(slice(i, i + b))
                                   for i in range(0, c, b)])
            assert torch.equal(parts, whole), (name, k)


@pytest.mark.parametrize("n", [108, 1024])
def test_plain_engine_two_shards_of_eight_bitwise(cuda, n):
    """The plain engine over [cuda:0, cuda:0] with 8 chains a shard: the
    slab at N = 108 (a move's pair energy sums 108 terms a chain) and a
    dense bulk fluid at N = 1024 (its pair force, over the particle
    axis, takes another order below 11 chains a call): bitwise the
    16-chain call."""
    cfg = (SMCConfig.for_n(108) if n == 108 else SMCConfig.bulk(
        n=n, temperature=1.5, rho=0.5, lj_cutoff=2.5, gamma=0.01))
    state, w = init_ensemble_state(cfg, seed_words(3), 16, device=cuda)
    one = ten.ensemble_sweeps(state, w, cfg, cfg.proposal_a, 3,
                              collect_trace=True, stream_seed=9)
    two = ten.ensemble_sweeps_sharded(state, w, cfg, cfg.proposal_a, 3, 9,
                                      [cuda, cuda], collect_trace=True)
    for u, v in ((one[0].r, two[0].r), (one[0].energy, two[0].energy),
                 (one[1].energy, two[1].energy)):
        assert torch.equal(u, v)


# a dense bulk fluid whose mu keeps a cap of 96 nearly full: a move sums
# 96 terms a chain, most of them nonzero
DENSE_GCMC = SMCConfig.bulk(n=96, temperature=1.5, rho=0.6, lj_cutoff=2.5,
                            gamma=0.01)
DENSE_GCMC_MU = 2.0


@pytest.mark.parametrize("case", ["family", "eight", "umbrella"])
def test_gcmc_and_umbrella_on_two_shards_of_one_card_bitwise(cuda, case):
    """The GCMC isotherm family (slab, cap 216 x 32, per-chain mu, z and
    g(r) profiles, resyncs), dense bulk GCMC at 8 + 8 chains with cap 96
    (a sum of 96 terms a chain below 16 chains a call) and umbrella
    windows with REUS (4 x 4), split over [cuda:0, cuda:0]: bitwise the
    one-device run, results and state."""
    import dataclasses as dc

    from tpu_smc_torch import gcmc as tg
    from tpu_smc_torch import umbrella as tu
    from tpu_smc_torch.config import RunParams

    two = [cuda, cuda]
    if case == "umbrella":
        cfg = SMCConfig.for_n(108)
        runs = [tu.simulate_umbrella(
            cfg, RunParams(6, 12, 3), np.linspace(-99.0, -93.0, 4),
            seed_words(8), k_spring=4.0, replicas=4, exchange_interval=3,
            device=cuda, devices=d) for d in (None, two)]
    elif case == "family":
        cfg = SMCConfig.for_n(108)
        cap, n0, c = 216, 108, 32
        mu = np.linspace(-9.5, -8.5, c)
    else:
        cfg, mu, (cap, n0, c) = DENSE_GCMC, DENSE_GCMC_MU, (96, 88, 16)
    if case != "umbrella":
        runs = [tg.simulate_gcmc(cfg, mu, cap, 4, 8, seed_words(6),
                                 n_chains=c, n0=n0, chunk=5, z_bins=8,
                                 gr_bins=8, device=cuda, devices=d)
                for d in (None, two)]
    (s1, r1), (s2, r2) = runs
    assert _same(r1, r2)
    for f in dc.fields(s1):
        assert torch.equal(getattr(s1, f.name), getattr(s2, f.name)), f.name
