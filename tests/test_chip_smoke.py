"""chip_smoke.py, the proof that the main path runs on the GPU, rehearsed
on the CPU: its contract is a JSON last line naming the device, and a
non-zero exit with no result line whenever anything is missing or fails.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(args, script=REPO / "chip_smoke.py", cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, str(script), *args],
                          capture_output=True, text=True, env=env, cwd=cwd,
                          timeout=900)


def test_rehearse_reaches_the_last_line():
    r = _run(["--rehearse"])
    assert r.returncode == 0, r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last == {"ok": True, "device": {
        "platform": "cpu", "kind": "cpu", "count": 1}}
    for n in range(1, 8):  # every phase printed its result line
        assert f"\n[{n} " in "\n" + r.stdout, n


def test_without_rehearse_the_cpu_is_refused():
    r = _run([])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_script_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run([], script=tmp_path / "chip_smoke.py", cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_a_failing_phase_exits_nonzero(monkeypatch, capsys):
    """A phase whose CLI run fails ends the script: exit code 1, nothing
    after it runs, no result line."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    from cloudsc2jax import cli

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    monkeypatch.setattr(cli, "main", lambda argv: 1)
    assert chip_smoke.run(["--rehearse"]) == 1
    captured = capsys.readouterr()
    assert "[1 device]" in captured.out
    assert "[2 " not in captured.out and '"ok"' not in captured.out
    assert "FAILED" in captured.err
