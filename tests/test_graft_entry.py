"""The driver contract (__graft_entry__.py) must stay importable and
runnable: `entry()` compile-checks the flagship forward step and
`dryrun_multichip(8)` certifies both sharded estimation tiers. The driver
only exercises these between rounds, so the suite pins them too — in a
subprocess with the driver's own environment (no x64: the dryrun's exact
valid-count assert is an f32 contract, and the conftest's x64 flips
domain-edge samples)."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=540)


def test_entry_and_dryrun_driver_env():
    proc = _run(
        "import jax\n"
        "import numpy as np\n"
        "import __graft_entry__ as g\n"
        "fn, args = g.entry()\n"
        "out = jax.jit(fn)(*args)\n"
        "flat, _ = jax.tree.flatten(jax.tree.map(np.asarray, out))\n"
        "assert all(np.all(np.isfinite(x)) for x in flat)\n"
        "g.dryrun_multichip(8)\n"
        "print('GRAFT_ENTRY_OK')\n")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "GRAFT_ENTRY_OK" in proc.stdout
    assert "stored-sample tier" in proc.stdout  # both tiers actually ran
