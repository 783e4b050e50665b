"""Test harness config: a virtual 8-device CPU mesh with x64 enabled.

Multi-chip sharding is validated on the forced host-platform device mesh;
numerical parity tests against the reference algorithms require float64,
hence jax_enable_x64.

The suite runs on the CPU unless ``JAX_PLATFORMS`` names another platform
first: ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs the
card-only tests (marker ``gpu``, see tests/test_gpu.py) on the GPU.
"""
import os

# must run before jax import
_PLATFORM = os.environ.get("JAX_PLATFORMS", "").split(",")[0].strip()
if _PLATFORM in ("", "cpu"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if _PLATFORM in ("", "cpu"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from pathlib import Path  # noqa: E402

import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """Apply the ``slow`` marker from the checked-in duration ledger.

    ``tests/slow_tests.txt`` lists every test measured > ~20 s on the
    single-core reference host (regenerate from a full-suite
    ``--durations=0`` run; bare ``file::test`` entries cover all
    parametrizations). The default CI gate runs ``-m "not slow"``
    (< 15 min); the full suite is the nightly tier.
    """
    ledger = Path(__file__).parent / "slow_tests.txt"
    if not ledger.exists():
        return
    slow = set()
    for line in ledger.read_text().splitlines():
        entry = line.split("#", 1)[0].strip()   # inline '# 123s' notes
        if entry:
            slow.add(entry)
    for item in items:
        nodeid = item.nodeid
        if nodeid in slow or nodeid.split("[")[0] in slow:
            item.add_marker(pytest.mark.slow)
