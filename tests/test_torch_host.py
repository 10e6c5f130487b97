"""tpu_smc_torch host side against tpu_smc: configuration, FCC lattice and
wall table (bit-exact), the CLI surface, and that the port and
chip_smoke.py import without JAX."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import tpu_smc.cli as jcli
import tpu_smc.config as jconfig
import tpu_smc.rng as jrng
import tpu_smc.system as jsystem
import tpu_smc_torch.cli as tcli
import tpu_smc_torch.config as tconfig
import tpu_smc_torch.rng as trng
import tpu_smc_torch.system as tsystem

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n", [32, 108, 1024])
def test_config_lattice_walls_array_equal(n):
    jc, tc = jconfig.SMCConfig.for_n(n), tconfig.SMCConfig.for_n(n)
    fields = tc.__dataclass_fields__
    # the port leaves out only the TPU watchdog's call-length cap
    assert (jc.__dataclass_fields__.keys() - fields.keys()
            == {"max_gathers_per_call"})
    assert all(getattr(jc, f) == getattr(tc, f) for f in fields)
    for prop in ("proposal_a", "rho", "cutoff2", "contact_dz", "n_voxels"):
        assert getattr(jc, prop) == getattr(tc, prop)
    assert jc.run_name() == tc.run_name() and jc.file_key() == tc.file_key()
    np.testing.assert_array_equal(jsystem.fcc_lattice(jc),
                                  tsystem.fcc_lattice(tc))
    for a, b in zip(jsystem.build_walls(jc), tsystem.build_walls(tc)):
        np.testing.assert_array_equal(a, b)
    r = tsystem.fcc_lattice(tc)
    assert jsystem.bounds_check(r, jc) == tsystem.bounds_check(r, tc)


def test_glibc_stream_and_rounding_equal():
    gj, gt = jrng.GlibcRandom(42), trng.GlibcRandom(42)
    assert [gj.rand() for _ in range(500)] == [gt.rand() for _ in range(500)]
    for v in (-2.5, -0.5, 0.5, 1.5, 2.4999):
        assert jrng.round_half_away(v) == trng.round_half_away(v)


def test_cli_covers_every_jax_option():
    """Every option of `python -m tpu_smc` is either ported or refused by
    name; none is silently ignored."""
    def options(parser):
        return {s for a in parser._actions for s in a.option_strings
                if s.startswith("--")}

    ported = options(tcli.build_parser()) - set(tcli.NOT_PORTED)
    assert options(jcli.build_parser()) <= ported | set(tcli.NOT_PORTED)
    assert ported - {"--help", "--device"} == {
        "--n", "--m", "--gamma", "--dtype", "--data-dir", "--seed",
        "--chains", "--lca-time", "--storage-time", "--no-trace",
        "--sampler", "--temperatures", "--chains-per-t", "--pt-exchange",
        "--target-acceptance", "--reweight", "--wall-seed",
        "--wall-realizations", "--bulk", "--rho", "--lj-cutoff",
        "--checkpoint", "--resume", "--acf-mode", "--auto-checkpoint",
        "--fault-retries", "--health-checks", "--nonuniform-z", "--gr-bins",
        "--z-bins", "--ptensor-bins", "--sk-kmax", "--widom", "--widom-bins",
        "--umbrella", "--umbrella-spring", "--umbrella-tag",
        "--umbrella-replicas", "--umbrella-bins", "--umbrella-exchange",
        "--gcmc", "--gcmc-cap", "--gcmc-exchanges", "--gcmc-grid", "--npt",
        "--npt-grid", "--npt-dlnv", "--npt-reweight", "--gibbs",
        "--gibbs-transfers", "--gibbs-cap", "--gibbs-temps",
        "--profile-dir", "--coordinator", "--num-processes",
        "--process-id", "--global-ladder"}
    assert set(tcli.NOT_PORTED) == {"--platform", "--x64"}


@pytest.mark.parametrize("flag", [
    "--bulk", "--temperatures=1.0,1.2",
    pytest.param("--profile-dir=trace", id="--profile-dir"), "--gr-bins=8"])
def test_cli_refuses_unported_options(flag, capsys):
    """Unported options exit 2 by name; so does a ported mode or option
    (the temperature ladder, the bulk fluid, the device trace, g(r))
    combined with one (--x64, --platform)."""
    extra = {"--temperatures=1.0,1.2": ["--x64"],
             "--bulk": ["--x64"],
             "--profile-dir=trace": ["--platform=cpu"],
             "--gr-bins=8": ["--platform"]}.get(flag, [])
    with pytest.raises(SystemExit) as exc:
        tcli.main(["1", "2", "1", "1.1", "--device", "cpu", flag] + extra)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err and (flag if not extra else extra[0]) \
        .split("=")[0] in err


def test_resolve_sampler_routing(monkeypatch):
    """tpu_smc's routing: zsorted from N = 1024 on a card, dense below;
    bulk and reference-noise runs on dense at every N (the resident
    kernel's capacity set to 4096 rows on a CUDA device here); torch on
    the CPU and in float64; and the refusals."""
    import tpu_smc_torch.kernels.sweep as ks

    monkeypatch.setattr(ks, "resident_fits", lambda n_pad, device=None,
                        sites=0: (
        str(device or "cuda") != "cuda" or n_pad <= 4096))
    c = tconfig.SMCConfig.for_n
    assert tcli._resolve_sampler("auto", c(108), "cuda") == "dense"
    assert tcli._resolve_sampler("auto", c(1024), "cuda") == "zsorted"
    assert tcli._resolve_sampler("auto", c(1024), "cpu") == "torch"
    assert tcli._resolve_sampler("auto", c(1024, dtype="float64"),
                                 "cuda") == "torch"
    with pytest.raises(SystemExit):
        tcli._resolve_sampler("zsorted", c(1024, reference_noise=True),
                              "cuda")
    with pytest.raises(SystemExit):
        tcli._resolve_sampler("dense", c(108, dtype="float64"), "cuda")
    bulk = tconfig.SMCConfig.bulk
    for n in (108, 1024, 4000):
        assert tcli._resolve_sampler("auto", bulk(n=n), "cuda") == "dense"
        assert tcli._resolve_sampler("auto", c(n, reference_noise=True),
                                     "cuda") == "dense"
    assert tcli._resolve_sampler("auto", bulk(n=4000), "cpu") == "torch"
    assert tcli._resolve_sampler("dense", c(108, m=10), "cuda") == "dense"
    with pytest.raises(SystemExit, match="confined z"):
        tcli._resolve_sampler("zsorted", bulk(n=1024), "cuda")


def test_port_imports_without_jax():
    """tpu_smc_torch, chip_smoke.py and kernel_ab.py import with jax and
    tpu_smc made unimportable, and no line of them imports either."""
    files = [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"] + sorted(
        (ROOT / "tpu_smc_torch").rglob("*.py"))
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "tpu_smc"), (f, name)
    # every module, and every subpackage through its __init__ (native)
    mods = sorted(
        "tpu_smc_torch." + ".".join(
            (p.parent if p.name == "__init__.py" else p.with_suffix(""))
            .relative_to(ROOT / "tpu_smc_torch").parts)
        for p in (ROOT / "tpu_smc_torch").rglob("*.py")
        if p.name != "__main__.py"
        and p != ROOT / "tpu_smc_torch" / "__init__.py")
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'tpu_smc'):\n"
            "    sys.modules[m] = None\n"
            "import importlib, tpu_smc_torch, chip_smoke, kernel_ab\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
