"""Shared pytest configuration for the tier-1 suite.

Registers the `slow` mark (long dry-run/e2e tests) and keeps the default
profile fast: slow tests are skipped unless explicitly requested with
``--runslow`` or an ``-m`` expression that mentions ``slow``.

Also implements a dependency-free ``timeout`` mark: thread-backed cluster
tests carry ``@pytest.mark.timeout(N)`` so a wedged engine (a worker that
never drains after a unit kill) fails the test instead of hanging the
whole run. Enforced with ``signal.setitimer`` where SIGALRM exists
(POSIX main thread); elsewhere the mark is a no-op — the tests still
pass, they just lose the hang guard.
"""
import signal
import sys
from pathlib import Path

import pytest

# make the in-repo package and the tests/ helpers importable regardless of
# how pytest was invoked (PYTHONPATH=src is the documented way, this is the
# safety net for bare `pytest` runs)
_ROOT = Path(__file__).resolve().parent.parent
for p in (str(_ROOT / "src"), str(_ROOT / "tests"), str(_ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="also run tests marked `slow`")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running dry-run/e2e test (excluded from the "
                   "default fast profile; enable with --runslow or -m slow)")
    config.addinivalue_line(
        "markers", "timeout(seconds): hard per-test wall-clock limit, "
                   "SIGALRM-enforced where available")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere "
                   "(run on the card: python -m pytest -m cuda tests)")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    mark = item.get_closest_marker("timeout")
    if mark is None or not hasattr(signal, "SIGALRM"):
        yield
        return
    seconds = float(mark.args[0]) if mark.args else 60.0

    def _expired(signum, frame):
        raise TimeoutError(
            f"{item.nodeid} exceeded its {seconds:g}s timeout mark")

    previous = signal.signal(signal.SIGALRM, _expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, previous)


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    if "slow" in (config.getoption("-m") or ""):
        return
    skip = pytest.mark.skip(reason="slow test: pass --runslow to include")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
