"""The benchmark's own tests of `mrcbench/tests/test_mrcbench_reference.py`,
collected with the port's tests: each case runs here under its own id, so
a change to the port that breaks what the benchmark uses of it fails
here."""
from mrcbench.tests.conftest import card  # noqa: F401
from mrcbench.tests.test_mrcbench_reference import *  # noqa: F401,F403
