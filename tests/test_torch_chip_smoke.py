"""chip_smoke.py's refusals, on the CPU: without a CUDA device, and copied
alone into a directory that holds nothing else of the repository, it exits
non-zero and prints no result line."""

import os
import shutil
import subprocess
import sys

import pytest

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")

# Runs the script as __main__ with torch.cuda.is_available() forced true: the
# card check passes and the script goes on to look for the port beside it.
_AS_IF_CUDA = (
    "import runpy, sys, torch; torch.cuda.is_available = lambda: True; "
    "sys.argv = ['chip_smoke.py']; runpy.run_path('chip_smoke.py', run_name='__main__')"
)


@pytest.mark.parametrize("case,rc,says", [("no_cuda", 2, "no CUDA device"),
                                          ("alone", 3, "not next to this script")])
def test_chip_smoke_refuses(tmp_path, case, rc, says):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if case == "no_cuda":
        cmd, cwd = [sys.executable, os.path.abspath(SCRIPT)], os.path.dirname(os.path.abspath(SCRIPT))
        env["CUDA_VISIBLE_DEVICES"] = ""
    else:
        shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
        cmd, cwd = [sys.executable, "-c", _AS_IF_CUDA], str(tmp_path)
    res = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == rc, (res.returncode, res.stderr[-2000:])
    assert says in res.stderr
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
