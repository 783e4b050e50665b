"""Sample-mesh parallelism: sharded pool, sharded estimation step,
multihost helpers — on the virtual 8-device CPU mesh.
"""
import numpy as np
import jax

from mlmc_tpu import Memory, SynthSimulation, DeviceBatchPool, Sampler, Legendre
from mlmc_tpu import estimator as est_mod
from mlmc_tpu.quantity.quantity import make_root_quantity
from mlmc_tpu.random.distributions import Norm
from mlmc_tpu.parallel import SampleMesh, sharded_mlmc_step, multihost
from mlmc_tpu.ops.fused_estimate import accumulators_to_estimates
from mlmc_tpu.sim.synth_simulation import SynthSimulation as Synth


def test_sharded_device_pool():
    """DeviceBatchPool with an 8-device mesh produces the same results as
    the single-device pool (same root key => same per-sample draws)."""
    assert len(jax.devices()) == 8
    distr = Norm()
    sim = SynthSimulation(dict(distr=distr, complexity=2))

    results = []
    for sharding in [None, SampleMesh()]:
        storage = Memory()
        pool = DeviceBatchPool(seed=21, sharding=sharding, min_bucket=64)
        sampler = Sampler(storage, pool, sim, [[0.1], [0.01]])
        sampler.set_initial_n_samples([100, 40])
        sampler.schedule_samples()
        sampler.ask_sampling_pool_for_samples()
        results.append(storage.sample_pairs())

    for a, b in zip(*results):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-12)


def test_sharded_device_pool_transport():
    """A scan-heavy application sim (solute transport: CG solve + CFL time
    stepping per sample) shards over the mesh identically to the
    single-device pool — the partitioned batch axis must not perturb the
    per-sample physics."""
    from mlmc_tpu.sim.transport import TransportSimulation

    obs = tuple(np.linspace(0.05, 0.2, 4))
    sim = TransportSimulation(dict(sigma=0.3, corr_length=0.3,
                                   field_method="circulant",
                                   obs_times=obs, steps_per_cell=16,
                                   observe_points=((0.75, 0.5),)))
    results = []
    for sharding in [None, SampleMesh()]:
        storage = Memory()
        pool = DeviceBatchPool(seed=4, sharding=sharding, min_bucket=8)
        sampler = Sampler(storage, pool, sim, [[1 / 8], [1 / 16]])
        sampler.set_initial_n_samples([16, 8])
        sampler.schedule_samples()
        sampler.ask_sampling_pool_for_samples()
        results.append(storage.sample_pairs())
    for a, b in zip(*results):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        assert np.allclose(a, b, atol=1e-10, equal_nan=True)


def test_sharded_step_mesh_invariance():
    """Estimates are identical (up to reduction order) for 1 vs 8 devices."""
    mfn = Legendre(7, (-4.0, 4.0))
    steps = [0.5, 0.25]
    fns = [Synth.scalar_batch_fn(h, 0.0 if i == 0 else steps[i - 1], Norm())
           for i, h in enumerate(steps)]
    n_per = [4096, 1024]

    out = {}
    for n_dev in [1, 8]:
        mesh = SampleMesh(jax.devices()[:n_dev])
        step = sharded_mlmc_step(mesh, fns, mfn, n_per, chunk_size=256)
        accs = step(jax.random.key(3))
        out[n_dev] = accumulators_to_estimates(jax.tree.map(np.asarray, accs))

    assert np.allclose(out[1]["mean"], out[8]["mean"], atol=1e-12)
    assert np.allclose(out[1]["cov"], out[8]["cov"], atol=1e-12)
    assert out[1]["n_samples"].tolist() == out[8]["n_samples"].tolist()


def test_multihost_helpers_single_process():
    multihost.initialize(num_processes=1)
    assert multihost.is_coordinator()
    assert multihost.n_hosts() == 1
    mesh = multihost.global_sample_mesh()
    assert mesh.n_devices == 8
    assert multihost.local_sample_mesh().n_devices == 8
    assert mesh.pad_to_shards(13) == 16


def test_sharded_pallas_pipeline_interpret():
    """Mesh-scale noise-input path: shard_map + psum around the packed
    stored-sample pipeline on the 8-device CPU mesh equals the same noise
    on one device (counts exactly, sums to f32 reduction order)."""
    import pytest
    from mlmc_tpu.parallel.sharded_estimate import (
        sharded_synth_pipeline_from_noise)

    R, chunk = 5, 256
    level_steps = (0.5, 0.25)
    domain = (-4.0, 4.0)
    noise = [np.asarray(jax.random.normal(jax.random.key(lvl), (8 * 2 * chunk,),
                                          dtype=jax.numpy.float32))
             for lvl in range(2)]

    out = {}
    for n_dev in (1, 8):
        mesh = SampleMesh(jax.devices()[:n_dev])
        step = sharded_synth_pipeline_from_noise(
            mesh, R, level_steps, domain=domain, chunk=chunk)
        out[n_dev] = jax.tree.map(np.asarray, step(*noise))
    for r1, r8 in zip(out[1], out[8]):
        assert int(r1.n_valid) == int(r8.n_valid) > 0
        assert np.allclose(r8.sums, r1.sums, rtol=1e-5, atol=1e-3)
        assert np.allclose(r8.cov_fine, r1.cov_fine, rtol=1e-5, atol=1e-2)
    # P0 telescopes to exactly one
    mean0 = sum(float(r.sums[0]) / float(r.n_valid) for r in out[8])
    assert abs(mean0 - 1.0) < 1e-6

    # noise that does not split over the mesh is rejected loudly
    step = sharded_synth_pipeline_from_noise(
        SampleMesh(), R, level_steps, domain=domain, chunk=chunk)
    with pytest.raises(ValueError):
        step(noise[0][:1001], noise[1][:1001])
