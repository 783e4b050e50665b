"""The flagship device workflow: storage-free adaptive MLMC to a PDF.

No sample ever touches storage: each adaptive round streams new samples
through the fused on-device estimator (continuing each level's PRNG stream),
the allocator sizes levels by measured cost, and the maxent PDF comes
straight from the accumulated moment/covariance state.

Run:          python examples/fused_pipeline.py           (GPU)
CPU mesh:     JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
              python examples/fused_pipeline.py
"""
import time

import numpy as np
import jax

from mlmc_tpu import Legendre
from mlmc_tpu.fused_driver import FusedMLMC
from mlmc_tpu.random.distributions import Norm
from mlmc_tpu.sim.synth_simulation import SynthSimulation


def main():
    steps = [0.5, 0.125, 0.03125]
    fns = [SynthSimulation.scalar_batch_fn(
        h, 0.0 if i == 0 else steps[i - 1], Norm())
        for i, h in enumerate(steps)]
    moments_fn = Legendre(25, (-5.0, 5.0))

    driver = FusedMLMC(fns, moments_fn, jax.random.key(0))
    t0 = time.perf_counter()
    est = driver.run(target_var=1e-7, initial_n=(65536, 4096))
    print("adaptive run: {:.1f}s, {} rounds, n = {}".format(
        time.perf_counter() - t0, len(est["history"]),
        est["n_samples"].astype(int)))
    print("max moment variance: {:.2e} (target 1e-7)".format(
        float(np.max(est["var"][1:]))))

    # checkpoint (resume continues the same sample streams)
    driver.save_state("/tmp/fused_mlmc_state.npz")

    # maxent PDF from the accumulated state
    d, info, result, orto = driver.construct_density(tol=1e-8)
    x = np.linspace(-2, 2, 9)
    print("density({}) = {}".format(x, d.density(x).round(4)))
    print("kept {} of {} moments; converged: {}".format(
        orto.size, moments_fn.size, result.success))


if __name__ == "__main__":
    main()
