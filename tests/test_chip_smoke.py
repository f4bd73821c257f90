"""The GPU-only entry scripts refuse to run without a GPU: they exit
non-zero and print no result line, instead of measuring the CPU."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_exits_nonzero_without_gpu(script):
    r = _run(REPO / script, REPO)
    assert r.returncode != 0
    assert "{" not in r.stdout, r.stdout
    assert "GPU" in r.stderr


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script fails rather than reporting anything."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert "{" not in r.stdout, r.stdout
