"""chip_smoke.py's refusal to run anywhere but on a GPU."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            pass
    return False


def test_refuses_cpu():
    r = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert r.returncode != 0
    assert not _printed_result(r.stdout)
    assert "needs a GPU" in r.stderr


def test_refuses_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert not _printed_result(r.stdout)
