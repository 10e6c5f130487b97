"""The plot set of python -m tpu_smc_torch.analysis against
tpu_smc.analysis on one small run directory of the port's CLI: the same
artifact names (matplotlib renders when present), and the command line
(--device cpu) writing the headless summaries (CPU)."""

import numpy as np
import pytest

from tpu_smc import analysis as ja
from tpu_smc_torch import analysis as ta

BOX = (33.0, 200.0)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    from tpu_smc_torch.cli import main

    td = tmp_path_factory.mktemp("cli")
    rc = main(["1", "4", "4", "1.1", "--n", "32", "--dtype", "float64",
               "--device", "cpu", "--seed", "2", "--gr-bins", "8",
               "--z-bins", "8", "--storage-time", "2",
               "--data-dir", str(td / "Data")])
    assert rc == 0
    return next((td / "Data").iterdir())


def test_artifact_names_equal(run_dir, tmp_path, monkeypatch):
    """The port's plot set is drawn for real; tpu_smc's (whose drawing
    its own tests cover) builds every figure but saves a stub file, which
    is all the names need."""
    wa = ta.render_all(ta.load_run(run_dir), tmp_path / "a", box=BOX,
                       device="cpu")
    if ja.HAVE_MPL:
        from pathlib import Path

        from matplotlib.figure import Figure

        real = Figure.savefig

        def stub(self, p, **kw):
            # files get a stub; animation frames (buffers) still draw
            if isinstance(p, (str, Path)):
                Path(p).write_bytes(b"x")
            else:
                real(self, p, **kw)

        monkeypatch.setattr(Figure, "savefig", stub)
    wb = ja.render_all(ja.load_run(run_dir), tmp_path / "b", box=BOX)
    assert sorted(p.name for p in wa) == sorted(p.name for p in wb)
    assert len(wa) >= 5
    for p in wa:
        assert p.exists() and p.stat().st_size > 0
    if ta.HAVE_MPL:
        assert any(p.name.startswith("sk_") for p in wa)
        assert any(p.name.startswith("structure_") for p in wa)


def test_cli_main_headless(run_dir, tmp_path, capsys, monkeypatch):
    """The command line with --box on the CPU, without matplotlib: the
    .npz summaries with the S(k) panel's numbers, path printed."""
    monkeypatch.setattr(ta, "HAVE_MPL", False)
    out = tmp_path / "plots"
    assert ta.main([str(run_dir), "--out", str(out), "--box", "33", "200",
                    "--device", "cpu"]) == 0
    printed = capsys.readouterr().out.split()
    assert [p.split("/")[-1] for p in printed] == \
        [f"analysis_{ta.load_run(run_dir).key}.npz"]
    z = np.load(out / printed[0].split("/")[-1])
    assert np.all(np.isfinite(z["sk"])) and z["sk"].size > 0
    with pytest.raises(SystemExit):
        ta.main([str(run_dir), "--device", "tpu"])
