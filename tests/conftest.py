"""Shared test environment.

Forced host device count: the TP/sharding suites need a multi-device
CPU mesh, and ``--xla_force_host_platform_device_count`` only takes
effect if it is in ``XLA_FLAGS`` before the jax backend initializes —
i.e. at conftest import time, before any test module imports jax.  The
flag is APPENDED to any caller-provided XLA_FLAGS and the original
value is restored at session end (pytest_sessionfinish), so nothing
leaks into the invoking shell or into subprocesses spawned after the
run.  Single-device tests are unaffected: unsharded computation runs on
device 0 regardless of how many host devices exist.  (The 512-way
forcing remains dryrun.py-only; tests force 8.)
"""

import os

import pytest

FORCED_DEVICES = 8
FORCE_FLAG = f"--xla_force_host_platform_device_count={FORCED_DEVICES}"

_PREV_XLA_FLAGS = os.environ.get("XLA_FLAGS")

if FORCE_FLAG not in (_PREV_XLA_FLAGS or ""):
    os.environ["XLA_FLAGS"] = (f"{_PREV_XLA_FLAGS} {FORCE_FLAG}"
                               if _PREV_XLA_FLAGS else FORCE_FLAG)

# Smoke tests and benches run on CPU regardless of the host's accelerators.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_sessionfinish(session, exitstatus):
    # proper save/restore: put XLA_FLAGS back exactly as we found it
    if _PREV_XLA_FLAGS is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = _PREV_XLA_FLAGS


@pytest.fixture
def forced_xla_env():
    """Environment dict for subprocess tests that need the forced
    multi-device CPU platform (the test_sharding.py pjit run): current
    env + the force flag + PYTHONPATH=src, without mutating
    ``os.environ``."""
    env = dict(os.environ)
    if FORCE_FLAG not in env.get("XLA_FLAGS", ""):
        env["XLA_FLAGS"] = (env["XLA_FLAGS"] + " " + FORCE_FLAG
                            if env.get("XLA_FLAGS") else FORCE_FLAG)
    env["PYTHONPATH"] = "src" + (os.pathsep + env["PYTHONPATH"]
                                 if env.get("PYTHONPATH") else "")
    return env


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")
