"""Sampler scheduling counters + add-fraction rule (mirrors reference test_sampler.py)."""
import numpy as np
import pytest

from mlmc_tpu import Memory, SynthSimulation, OneProcessPool, DeviceBatchPool, Sampler


@pytest.mark.parametrize("pool_factory", [OneProcessPool, DeviceBatchPool])
def test_sampler_counters(pool_factory):
    failed_fraction = 0.1
    simulation_config = dict(distr="norm", complexity=2, nan_fraction=failed_fraction)
    simulation = SynthSimulation(simulation_config)
    storage = Memory()
    sampling_pool = pool_factory()

    step_range = [[0.1], [0.01], [0.001]]
    sampler = Sampler(
        sample_storage=storage,
        sampling_pool=sampling_pool,
        sim_factory=simulation,
        level_parameters=step_range,
    )

    assert len(sampler._level_sim_objects) == len(step_range)
    for step, level_sim in zip(step_range, sampler._level_sim_objects):
        assert step[0] == level_sim.config_dict["fine_step"]

    init_samples = list(np.ones(len(step_range)) * 10)
    sampler.set_initial_n_samples(init_samples)
    assert np.allclose(sampler._n_target_samples, init_samples)
    assert 0 == sampler.ask_sampling_pool_for_samples()
    sampler.schedule_samples()
    assert np.allclose(sampler._n_scheduled_samples, init_samples)

    n_estimated = np.array([100, 50, 20])
    sampler.process_adding_samples(n_estimated, 0, 0.1)
    assert np.allclose(sampler._n_target_samples, init_samples + (n_estimated * 0.1), atol=1)


def test_renew_failed_samples():
    simulation = SynthSimulation(dict(distr="norm", complexity=2, nan_fraction=0.3))
    storage = Memory()
    pool = DeviceBatchPool(seed=3)
    sampler = Sampler(storage, pool, simulation, [[0.1], [0.01]])
    sampler.set_initial_n_samples([50, 50])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()

    failed = storage.failed_samples()
    n_failed = sum(len(v) for v in failed.values())
    assert n_failed > 0  # nan_fraction=0.3 over 100 samples

    # renewal re-runs failed ids with a fresh attempt salt until all succeed
    for _ in range(20):
        sampler.renew_failed_samples()
        sampler.ask_sampling_pool_for_samples()
        if sum(len(v) for v in storage.failed_samples().values()) == 0:
            break
    assert sum(len(v) for v in storage.failed_samples().values()) == 0
    assert storage.get_n_collected() == [50, 50]


def test_sample_range():
    sampler = Sampler(
        Memory(), DeviceBatchPool(), SynthSimulation(dict(distr="norm", complexity=2)),
        [[0.1], [0.01], [0.001], [0.0001]],
    )
    rng = sampler.sample_range(1000, 10)
    assert rng[0] == 1000 and rng[-1] == 10
    ratios = rng[:-1] / rng[1:]
    assert np.allclose(ratios, ratios[0], rtol=0.1)  # geometric


def test_device_pool_max_batch_slicing():
    """Batches beyond max_batch execute in slices with identical results."""
    import numpy as np
    from mlmc_tpu import Memory, SynthSimulation, DeviceBatchPool, Sampler
    from mlmc_tpu.random.distributions import Norm

    sim = SynthSimulation(dict(distr=Norm(), complexity=2))
    results = []
    for max_batch in [10_000, 128]:
        storage = Memory()
        pool = DeviceBatchPool(seed=6, min_bucket=64, max_batch=max_batch)
        sampler = Sampler(storage, pool, sim, [[0.1], [0.01]])
        sampler.set_initial_n_samples([500, 100])
        sampler.schedule_samples()
        sampler.ask_sampling_pool_for_samples()
        results.append(storage.sample_pairs())
    for a, b in zip(*results):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-14)


def test_device_pool_range_mode_bit_parity():
    """The scalar-start (range) dispatch derives indices ON DEVICE; it must
    produce bitwise the results of the explicit index-array path (same
    fold_in(level_key, index) keys)."""
    import numpy as np
    from mlmc_tpu import Memory, SynthSimulation, DeviceBatchPool, Sampler
    from mlmc_tpu.random.distributions import Norm

    sim = SynthSimulation(dict(distr=Norm(), complexity=2))
    results = []
    for as_range in (True, False):
        storage = Memory()
        pool = DeviceBatchPool(seed=6, min_bucket=64, max_batch=256)
        sampler = Sampler(storage, pool, sim, [[0.1], [0.01]])
        if as_range:
            sampler.set_initial_n_samples([500, 100])
            sampler.schedule_samples()
        else:
            # bypass the sampler's range hand-off: explicit index arrays
            for lvl, n in ((0, 500), (1, 100)):
                pool.schedule_level_batch(
                    sampler._level_sim_objects[lvl],
                    np.arange(n, dtype=np.int64))
        sampler.ask_sampling_pool_for_samples()
        results.append(storage.sample_pairs())
    for a, b in zip(*results):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def test_device_pool_async_wave_parity_and_roundtrips():
    """The asynchronous wave collection (all buckets enqueued back-to-back,
    failure masks drained in ONE pipelined fetch) is bit-identical to a
    single-round dispatch of the same indices, AND a warm adaptive round
    costs exactly one blocking device fetch instead of one per dispatch."""
    import numpy as np
    from mlmc_tpu import Memory, SynthSimulation, DeviceBatchPool, Sampler
    from mlmc_tpu.random.distributions import Norm

    sim = SynthSimulation(dict(distr=Norm(), complexity=2))

    # run A: two adaptive rounds, async wave collection
    storage_a = Memory()
    pool_a = DeviceBatchPool(seed=6, min_bucket=64, max_batch=128)
    sampler_a = Sampler(storage_a, pool_a, sim, [[0.1], [0.01]])
    sampler_a.set_initial_n_samples([500, 300])
    sampler_a.schedule_samples()
    sampler_a.ask_sampling_pool_for_samples()
    fetches_round1 = pool_a.n_blocking_fetches
    # round 1 pays the C_l probes (cold + first warm per (level, bucket))
    # plus one pipelined flush
    assert fetches_round1 <= 5, fetches_round1

    sampler_a.set_level_target_n_samples([1000, 600])
    sampler_a.schedule_samples()
    sampler_a.ask_sampling_pool_for_samples()
    warm_round_fetches = pool_a.n_blocking_fetches - fetches_round1
    # warm executables + probes done: the whole 7-dispatch round drains in
    # ONE pipelined device_get
    assert warm_round_fetches == 1, warm_round_fetches
    assert pool_a.n_dispatches == 7 + 7  # 4+3 slices per round

    # run B: same totals in one round (different wave shape)
    storage_b = Memory()
    pool_b = DeviceBatchPool(seed=6, min_bucket=64, max_batch=128)
    sampler_b = Sampler(storage_b, pool_b, sim, [[0.1], [0.01]])
    sampler_b.set_initial_n_samples([1000, 600])
    sampler_b.schedule_samples()
    sampler_b.ask_sampling_pool_for_samples()

    for a, b in zip(storage_a.sample_pairs(), storage_b.sample_pairs()):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def test_device_pool_inflight_budget_parity():
    """A tiny in-flight byte budget forces the wave to drain in several
    pipelined fetches; results stay bit-identical and every sample still
    lands exactly once."""
    import numpy as np
    from mlmc_tpu import Memory, SynthSimulation, DeviceBatchPool, Sampler
    from mlmc_tpu.random.distributions import Norm

    sim = SynthSimulation(dict(distr=Norm(), complexity=2))
    results = []
    for budget in (None, 1):   # default vs degenerate flush-every-batch
        storage = Memory()
        pool = DeviceBatchPool(seed=6, min_bucket=64, max_batch=128,
                               inflight_bytes=budget)
        sampler = Sampler(storage, pool, sim, [[0.1], [0.01]])
        sampler.set_initial_n_samples([700, 300])
        sampler.schedule_samples()
        sampler.ask_sampling_pool_for_samples()
        results.append(storage.sample_pairs())
    for a, b in zip(*results):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def test_device_pool_cost_model_survives_async():
    """C_l (n_ops ratio) comes from the designated warm probes only and
    stays a sane per-sample wall time even though most dispatches are
    untimed asynchronous batches."""
    from mlmc_tpu import Memory, SynthSimulation, DeviceBatchPool, Sampler
    from mlmc_tpu.random.distributions import Norm

    sim = SynthSimulation(dict(distr=Norm(), complexity=2))
    storage = Memory()
    pool = DeviceBatchPool(seed=9, min_bucket=64, max_batch=128)
    sampler = Sampler(storage, pool, sim, [[0.1], [0.01]])
    sampler.set_initial_n_samples([500, 300])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()

    n_ops = storage.get_n_ops()
    assert len(n_ops) == 2
    # warm probes ran for both levels -> both costs positive, and counted
    # samples never exceed what was dispatched
    assert all(c > 0 for c in n_ops)
    for lvl, t in pool.times.items():
        assert t[1] <= 500  # only probe batches contribute to the counter
        assert (lvl, 128, True) in pool._timed


def test_vectorized_scheduling_cost():
    """Scheduling is O(1) per level, not O(n) per sample: queueing a
    MILLION samples per level costs milliseconds (the reference's
    per-sample string/dispatch loop costs seconds at this scale) —
    the SURVEY §7 step-4 design requirement."""
    import time
    from mlmc_tpu.sim.simulation import Simulation
    from mlmc_tpu.quantity.quantity_spec import QuantitySpec
    from mlmc_tpu.level_simulation import LevelSimulation

    class _NoRun(Simulation):
        """Sim whose levels never execute (pool only queues)."""

        def level_instance(self, fine, coarse):
            return LevelSimulation(config_dict={"fine_step": fine[0]},
                                   task_size=0.0)

        @staticmethod
        def calculate(config, seed):  # pragma: no cover
            raise AssertionError("must not run")

        def result_format(self):
            return [QuantitySpec(name="q", unit="", shape=(1,), times=[0],
                                 locations=["s"])]

    class _QueueOnlyPool:
        """Batch-capable pool that records ranges without executing."""

        def __init__(self):
            self.queued = []

        def schedule_level_batch(self, level_sim, indices, renew=False):
            self.queued.append((level_sim.level_id, len(indices)))

        def have_permanent_samples(self, ids):
            return False

        def get_finished(self):
            return {}, {}, 0, []

    pool = _QueueOnlyPool()
    sampler = Sampler(Memory(), pool, _NoRun(), [[0.5], [0.25], [0.125]])
    n = 1_000_000
    t0 = time.perf_counter()
    sampler.set_initial_n_samples([n, n, n])
    sampler.schedule_samples(timeout=0)
    wall = time.perf_counter() - t0

    assert [cnt for _lvl, cnt in pool.queued] == [n, n, n]
    assert np.array_equal(sampler.l_scheduled_samples(), [n, n, n])
    # generous bound for the 1-core CI VM; measured ~1-5 ms
    assert wall < 0.5, "scheduling 3e6 samples took {:.3f}s".format(wall)

    # the storage-side schedule log is lazy too: counters come back
    # without materializing 3e6 tag strings
    t0 = time.perf_counter()
    loaded = sampler.sample_storage.load_scheduled_samples()
    assert {int(k): len(v) for k, v in loaded.items()} == {0: n, 1: n, 2: n}
    assert time.perf_counter() - t0 < 0.5
