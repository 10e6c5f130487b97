"""The port's examples (examples/torch_*.py): every one imports without
jax (one subprocess: the test process has jax loaded), drives only
tpu_smc_torch, and one runs end to end at a reduced depth through its
main(...) arguments on the CPU."""

import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
# tpu_smc's examples, every one
PORTED = ("adsorption_isotherm", "chemical_potential", "coexistence",
          "equation_of_state", "large_n_sharded", "parallel_tempering",
          "phase_curve", "run_ensemble", "temperature_sweep", "umbrella_pmf",
          "wall_disorder")


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_example_ported_and_torch_only():
    assert [p.stem for p in EXAMPLES] == [f"torch_{n}" for n in PORTED]
    for p in EXAMPLES:
        src = p.read_text()
        assert not re.search(r"^\s*(import|from) (jax|tpu_smc)\b", src,
                             re.M), p.name
        assert "def main(argv=None)" in src and "--device" in src, p.name


def test_examples_import_without_jax():
    code = (
        "import importlib.util, sys\n"
        f"for p in {[str(p) for p in EXAMPLES]!r}:\n"
        "    s = importlib.util.spec_from_file_location('ex', p)\n"
        "    m = importlib.util.module_from_spec(s)\n"
        "    s.loader.exec_module(m)\n"
        "    assert callable(m.main), p\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'tpu_smc'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chemical_potential_runs_reduced(capsys):
    mod = _load(ROOT / "examples" / "torch_chemical_potential.py")
    (mu, err), rw = mod.main(["--device", "cpu", "--scale", "0.005"])
    out = capsys.readouterr().out
    assert "volume-averaged mu_ex" in out and "mu_ex(T) via MBAR" in out
    assert np.isfinite(mu) and np.isfinite(err)
    assert len(rw.mu_ex) == 7 and np.all(np.isfinite(rw.mu_ex))


def test_large_n_sharded_runs_small(capsys):
    """The particle-sharded energy over 4 CPU shards equals the full
    recompute (float32 positions, float64 sums) at N = 64."""
    mod = _load(ROOT / "examples" / "torch_large_n_sharded.py")
    e, full = mod.main(["--device", "cpu", "--n", "64", "--chains", "2"])
    out = capsys.readouterr().out
    assert "shards: 4" in out and "particle-sharded total energy" in out
    assert np.isfinite(e) and abs(e - full) <= 1e-6 * max(1.0, abs(full))
