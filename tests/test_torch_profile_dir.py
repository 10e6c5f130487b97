"""`python -m tpu_smc_torch ... --profile-dir DIR` on the CPU: the
trace parses, and mean E, acceptance and every CSV are bitwise those of
the same run without the flag."""

import json


def test_cli_profile_dir_leaves_results_bitwise(tmp_path, capsys):
    from tpu_smc_torch.cli import main

    base = ["1", "2", "1", "1.1", "--n", "4", "--chains", "2", "--device",
            "cpu", "--seed", "3"]
    outs = []
    for tag, extra in (("plain", []),
                       ("prof", ["--profile-dir", str(tmp_path / "trace")])):
        assert main(base + ["--data-dir", str(tmp_path / tag)] + extra) == 0
        outs.append(capsys.readouterr().out)
    pick = [[ln for ln in o.splitlines()
             if ln.startswith(("Mean energy", "Average acceptance"))]
            for o in outs]
    assert len(pick[0]) == 2 and pick[0] == pick[1]
    assert "Device trace written to" in outs[1]
    json.loads((tmp_path / "trace" / "trace.json").read_text())
    run_a = next((tmp_path / "plain").iterdir())
    run_b = next((tmp_path / "prof").iterdir())
    for f in sorted(run_a.iterdir()):
        assert f.read_bytes() == (run_b / f.name).read_bytes(), f.name
