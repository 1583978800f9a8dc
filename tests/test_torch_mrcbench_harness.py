"""The benchmark's own tests of `mrcbench/tests/test_mrcbench_harness.py`,
collected with the port's tests: each case runs here under its own id, so
a change to the port that breaks what the benchmark uses of it fails
here."""
import os
import subprocess
import sys

from mrcbench.tests.conftest import card  # noqa: F401
from mrcbench.tests.test_mrcbench_harness import *  # noqa: F401,F403

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_forbidden_modules_compares_whole_top_level_names():
    """The benchmark's case, in a process of its own: it needs a process
    that has loaded no JAX, and the port's tests load it (conftest.py)."""
    case = ("mrcbench/tests/test_mrcbench_harness.py::"
            "test_forbidden_modules_compares_whole_top_level_names")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         case], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "1 passed" in out.stdout
