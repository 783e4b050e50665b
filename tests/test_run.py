"""End-to-end adaptive MLMC matrix (mirrors reference test/test_run.py:43-107).

The reference runs {SynthSimulation, SynthSimulationWorkspace} x
{Memory, SampleStorageHDF} x {OneProcessPool, ProcessPool(4)} through the
full target-variance loop. This matrix additionally covers the device-native
DeviceBatchPool and the native binary storage: every storage backend
{Memory, HDF, Bin}, every pool {OneProcessPool, ProcessPool(4),
DeviceBatchPool} and both simulations appear in the curated combinations
below, plus an HDF kill-and-resume pass and a renew-failed pass through the
adaptive loop.
"""
import numpy as np
import pytest
import yaml

import mlmc_tpu
from mlmc_tpu import (Memory, SynthSimulation, SynthSimulationWorkspace,
                      OneProcessPool, ProcessPool, DeviceBatchPool, Sampler,
                      Legendre)
from mlmc_tpu import estimator as est_mod
from mlmc_tpu.quantity.quantity import make_root_quantity
import mlmc_tpu.quantity.quantity_estimate as qe
from mlmc_tpu.random.distributions import Norm
from mlmc_tpu.sample_storage_hdf import SampleStorageHDF
from mlmc_tpu.sample_storage_bin import SampleStorageBin


def _make_storage(kind, tmp_path):
    if kind == "memory":
        return Memory()
    if kind == "hdf":
        return SampleStorageHDF(file_path=str(tmp_path / "mlmc.hdf5"))
    if kind == "bin":
        return SampleStorageBin(dir_path=str(tmp_path / "binstore"))
    raise ValueError(kind)


def _make_pool(kind, tmp_path, need_workspace):
    work = dict(work_dir=str(tmp_path / "work")) if need_workspace else {}
    if kind == "one":
        return OneProcessPool(**work)
    if kind == "process4":
        return ProcessPool(4, **work)
    if kind == "device":
        return DeviceBatchPool(min_bucket=64, **work)
    raise ValueError(kind)


def _make_sim(kind, tmp_path):
    if kind == "synth":
        return SynthSimulation(dict(distr="norm", complexity=2)), False
    if kind == "workspace":
        cfg = tmp_path / "synth_sim_config.yaml"
        with open(cfg, "w") as f:
            yaml.safe_dump({"distr": "norm", "nan_fraction": 0.0}, f)
        return SynthSimulationWorkspace(dict(config_yaml=str(cfg))), True
    raise ValueError(kind)


def _adaptive_loop(sampler, estimator, target_var=1e-3, max_rounds=100):
    variances, n_ops = estimator.estimate_diff_vars_regression(
        sampler._n_scheduled_samples)
    n_estimated = est_mod.estimate_n_samples_for_target_variance(
        target_var, variances, n_ops, n_levels=sampler.n_levels)
    n_rounds = 0
    while not sampler.process_adding_samples(n_estimated, 0, 0.1):
        variances, n_ops = estimator.estimate_diff_vars_regression(
            sampler._n_scheduled_samples)
        n_estimated = est_mod.estimate_n_samples_for_target_variance(
            target_var, variances, n_ops, n_levels=sampler.n_levels)
        n_rounds += 1
        assert n_rounds < max_rounds
    return n_estimated


# curated combinations: every storage, every pool, both sims appear
MATRIX = [
    ("memory", "one", "synth"),
    ("memory", "device", "synth"),
    ("hdf", "device", "synth"),
    ("hdf", "process4", "synth"),
    ("bin", "device", "synth"),
    ("bin", "one", "synth"),
    ("memory", "one", "workspace"),
    ("hdf", "one", "workspace"),
]


@pytest.mark.parametrize("storage_kind,pool_kind,sim_kind", MATRIX)
def test_mlmc_adaptive(tmp_path, storage_kind, pool_kind, sim_kind):
    np.random.seed(1234)
    n_moments = 5
    step_range = [[0.1], [0.001]]

    sim, need_workspace = _make_sim(sim_kind, tmp_path)
    sample_storage = _make_storage(storage_kind, tmp_path)
    sampling_pool = _make_pool(pool_kind, tmp_path, need_workspace)

    sampler = Sampler(
        sample_storage=sample_storage,
        sampling_pool=sampling_pool,
        sim_factory=sim,
        level_parameters=step_range,
    )

    # workspace sim draws from norm(1, 2); plain synth from norm(0, 1)
    import scipy.stats as stats
    base = stats.norm(1, 2) if sim_kind == "workspace" else stats.norm(0, 1)
    moments_fn = Legendre(n_moments, base.ppf([0.0001, 0.9999]))

    sampler.set_initial_n_samples([50, 50])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()

    quantity = make_root_quantity(sample_storage, q_specs=sim.result_format())
    value_quantity = quantity["length"][1]["10"][0]
    estimator = est_mod.Estimate(value_quantity, sample_storage, moments_fn)

    _adaptive_loop(sampler, estimator, target_var=1e-3)

    means, vars = estimator.estimate_moments(moments_fn)
    assert means[0] == 1
    assert vars[0] == 0
    assert np.abs(means[1]) < 0.1
    # the adaptive loop actually grew the schedule beyond the initial 50
    assert np.any(np.asarray(sampler._n_scheduled_samples) > 50)


def test_hdf_kill_and_resume_adaptive(tmp_path):
    """Run the initial round, 'kill' the process (drop all objects), reopen
    the HDF file and finish the adaptive loop from the stored schedule
    (reference checkpoint semantics: the HDF5 file IS the checkpoint)."""
    path = str(tmp_path / "resume.hdf5")
    sim = SynthSimulation(dict(distr="norm", complexity=2))
    step_range = [[0.1], [0.001]]

    storage = SampleStorageHDF(file_path=path)
    sampler = Sampler(storage, DeviceBatchPool(min_bucket=64), sim, step_range)
    sampler.set_initial_n_samples([60, 40])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    n_before = np.array(storage.get_n_collected())
    del sampler, storage  # "kill"

    storage2 = SampleStorageHDF(file_path=path)
    assert list(storage2.get_n_collected()) == list(n_before)
    sampler2 = Sampler(storage2, DeviceBatchPool(min_bucket=64), sim, step_range)
    # resume: scheduled counters continue from the stored schedule log
    assert np.all(np.asarray(sampler2._n_scheduled_samples) == [60, 40])

    distr = Norm()
    moments_fn = Legendre(5, distr.ppf([0.0001, 0.9999]))
    quantity = make_root_quantity(storage2, q_specs=sim.result_format())
    vq = quantity["length"][1]["10"][0]
    estimator = est_mod.Estimate(vq, storage2, moments_fn)
    _adaptive_loop(sampler2, estimator, target_var=1e-3)

    means, vars = estimator.estimate_moments(moments_fn)
    assert means[0] == 1 and vars[0] == 0
    assert np.array(storage2.get_n_collected()).sum() > n_before.sum()


def test_renew_failed_through_adaptive(tmp_path):
    """Failure injection + renewal inside the adaptive run (HDF storage):
    failed samples are re-dispatched with attempt salts until none remain."""
    storage = SampleStorageHDF(file_path=str(tmp_path / "renew.hdf5"))
    sim = SynthSimulation(dict(distr="norm", complexity=2, nan_fraction=0.2))
    sampler = Sampler(storage, DeviceBatchPool(seed=5, min_bucket=64), sim,
                      [[0.1], [0.001]])
    sampler.set_initial_n_samples([80, 40])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    assert sum(len(v) for v in storage.failed_samples().values()) > 0

    for _ in range(25):
        sampler.renew_failed_samples()
        sampler.ask_sampling_pool_for_samples()
        if sum(len(v) for v in storage.failed_samples().values()) == 0:
            break
    assert sum(len(v) for v in storage.failed_samples().values()) == 0
    assert storage.get_n_collected() == [80, 40]

    # estimates over the renewed store still satisfy the invariants
    mfn = Legendre(4, Norm().ppf([0.0001, 0.9999]))
    quantity = make_root_quantity(storage, q_specs=sim.result_format())
    vq = quantity["length"][1]["10"][0]
    means, vars = est_mod.Estimate(vq, storage, mfn).estimate_moments(mfn)
    assert means[0] == 1 and vars[0] == 0


def test_moment_accuracy_large_batch():
    """Device pool at larger scale: estimate matches exact Legendre moments.

    Single level, no numerical error (h=tiny), normal distribution: moment
    means must match quadrature values within CLT tolerance.
    """
    import scipy.integrate as integrate

    distr = Norm()
    sim = SynthSimulation(dict(distr=distr, complexity=2))
    storage = Memory()
    pool = DeviceBatchPool(seed=11)
    sampler = Sampler(storage, pool, sim, [[1e-8]])
    n = 200000
    sampler.set_initial_n_samples([n])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()

    domain = distr.ppf([1e-8, 1 - 1e-8])
    mfn = Legendre(8, domain)
    quantity = make_root_quantity(storage, q_specs=sim.result_format())
    value_q = quantity["length"][1]["10"][0]
    estimator = est_mod.Estimate(value_q, storage, mfn)
    means, variances = estimator.estimate_moments(mfn)

    exact = np.array(
        [
            integrate.quad(
                lambda x, i=i: np.asarray(mfn.eval_all(np.array([x]))[0, i]) * distr.pdf(x),
                domain[0],
                domain[1],
            )[0]
            for i in range(8)
        ]
    )
    err = np.abs(np.asarray(means) - exact)
    tol = 5 * np.sqrt(np.asarray(variances)) + 1e-8
    assert np.all(err < np.maximum(tol, 5e-3)), (err, tol)


@pytest.mark.parametrize("storage_kind", ["hdf", "bin"])
def test_bucket_padded_bulk_results_file_storages(tmp_path, storage_kind):
    """DeviceBatchPool(device_results=True) hands over whole bucket-padded
    batches; file-backed storages must slice to len(ids) or padding rows
    corrupt counts, resume ids, and estimates (round-3 review finding).
    Estimates must match the Memory path bit for bit."""
    res = []
    for storage in (Memory(), _make_storage(storage_kind, tmp_path)):
        sim = SynthSimulation(dict(distr="norm", complexity=2))
        pool = DeviceBatchPool(seed=11, min_bucket=64, device_results=True)
        sampler = Sampler(sample_storage=storage, sampling_pool=pool,
                          sim_factory=sim,
                          level_parameters=[[0.1], [0.01]])
        # 50/30 are NOT multiples of the 64 bucket: padding rows exist
        sampler.set_initial_n_samples([50, 30])
        sampler.schedule_samples()
        sampler.ask_sampling_pool_for_samples()
        assert list(storage.get_n_collected()) == [50, 30]

        quantity = make_root_quantity(storage, q_specs=sim.result_format())
        q = quantity["length"][1]["10"][0]
        m = qe.estimate_mean(qe.moments(q, Legendre(4, (-4, 4))))
        res.append((np.asarray(m.mean), list(m.n_samples)))
    assert np.array_equal(res[0][0], res[1][0])
    assert res[0][1] == res[1][1]


def test_all_failed_level_still_reports_cost():
    """A level whose every sample raises must still appear in the cost
    vector (a missing level desynchronizes the allocation formula)."""
    def _boom(config, seed):
        raise RuntimeError("injected failure")

    sim = SynthSimulation(dict(distr="norm", complexity=2))
    storage = Memory()
    pool = OneProcessPool()
    sampler = Sampler(storage, pool, sim, [[0.1], [0.01]])
    # break level 1 after Sampler wired the level sims
    sampler._level_sim_objects[1].calculate = _boom
    sampler.set_initial_n_samples([8, 4])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    assert sum(len(v) for v in storage.failed_samples().values()) == 4
    n_ops = storage.get_n_ops()
    assert len(n_ops) == 2, n_ops          # both levels present
    assert n_ops[0] > 0 and n_ops[1] == 0.0


def test_variance_regression_ignores_inf_levels():
    """An infinite level variance (n_valid <= 1) must not poison the
    log-space regression — the fit uses only finite positive entries."""
    raw = np.array([1e-2, 1e-3, np.inf, 1e-5, 3e-6, 1e-6])
    steps = np.array([0.5, 0.25, 0.125, 0.0625, 0.03125, 0.015625])
    out = est_mod.Estimate._moment_variance_regression(raw, steps)
    assert np.all(np.isfinite(out)), out
    assert np.all(out[1:] > 0)
    assert out[0] == raw[0]  # level 0 untouched
