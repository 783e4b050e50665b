"""Plot layer, CLI driver, stats-test helpers — smoke + behavior tests."""
import os
import numpy as np
import pytest

import mlmc_tpu
from mlmc_tpu import Memory, SynthSimulation, DeviceBatchPool, Sampler, Legendre
from mlmc_tpu import estimator as est_mod
from mlmc_tpu.quantity.quantity import make_root_quantity
from mlmc_tpu.random.distributions import Norm
from mlmc_tpu.tool.stats_tests import t_test, chi2_test, anova


@pytest.fixture(scope="module")
def run_small_mlmc():
    distr = Norm()
    sim = SynthSimulation(dict(distr=distr, complexity=2))
    storage = Memory()
    sampler = Sampler(storage, DeviceBatchPool(seed=8, min_bucket=64), sim,
                      [[0.1], [0.01]])
    sampler.set_initial_n_samples([300, 80])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    quantity = make_root_quantity(storage, q_specs=sim.result_format())
    vq = quantity["length"][1]["10"][0]
    mfn = Legendre(5, distr.ppf([0.001, 0.999]))
    est = est_mod.Estimate(vq, storage, mfn)
    return storage, est, mfn, vq


def test_stats_helpers():
    rng = np.random.default_rng(0)
    samples = rng.normal(2.0, 1.5, size=5000)
    t_test(2.0, samples)
    chi2_test(1.5 ** 2, samples)
    with pytest.raises(AssertionError):
        t_test(3.0, samples)
    # ANOVA: same-mean groups accepted, different-mean rejected
    assert anova([rng.normal(0, 1, 200) for _ in range(4)])
    assert not anova([rng.normal(i, 1, 200) for i in range(4)])


def test_plots_smoke(tmp_path, run_small_mlmc):
    """Every plot class renders + saves without error."""
    import scipy.stats as stats
    from mlmc_tpu.plot import plots
    import mlmc_tpu.tool.simple_distribution as sd

    storage, est, mfn, vq = run_small_mlmc

    # Distribution plot with a reconstructed density
    distr_obj, info, result, _ = est.construct_density(tol=1e-7)
    dp = plots.Distribution(exact_distr=stats.norm(), title="test")
    dp.add_distribution(distr_obj)
    dp.add_raw_samples(np.asarray(
        est.get_level_samples(level_id=0))[0, :, 0])
    dp.show(file=str(tmp_path / "distribution"))

    # Eigenvalues
    ev = plots.Eigenvalues(title="eigs")
    ev.add_values(info[0], threshold=info[1], label="cov spectrum")
    ev.add_linear_fit(np.abs(info[0]))
    ev.show(file=str(tmp_path / "eigs"))

    # moments basis
    plots.moments(mfn, title="moments", file=str(tmp_path / "moments"))

    # variance breakdown + level variances
    l_vars, n_samples = est.estimate_diff_vars(mfn)
    vb = plots.VarianceBreakdown()
    vb.add_variances(l_vars, n_samples)
    vb.show(file=str(tmp_path / "varbreak"))

    var_plot = plots.Variance()
    var_plot.add_level_variances(
        np.squeeze(np.asarray(storage.get_level_parameters())), l_vars)
    var_plot.show(file=str(tmp_path / "vars"))

    # BSplots
    est.est_bootstrap(n_subsamples=10, sample_vector=[100, 40])
    bs = plots.BSplots(n_samples=[300, 80], bs_n_samples=[100, 40],
                       n_moments=5, ref_level_var=l_vars)
    bs.plot_bootstrap_variance_compare(est.mean_bs_l_vars,
                                       file=str(tmp_path / "bscmp"))
    bs.plot_means_and_vars(est.mean_bs_mean, est.var_bs_mean, 2,
                           file=str(tmp_path / "bsmv"))
    bs.plot_var_regression(est, 2, mfn, file=str(tmp_path / "bsreg"))

    # module-level plots
    plots.plot_vars(est.mean_bs_mean, est.var_bs_mean, 2,
                    file=str(tmp_path / "pv"))
    plots.plot_diff_var(l_vars, 5, np.squeeze(
        np.asarray(storage.get_level_parameters())), file=str(tmp_path / "pdv"))

    for f in ["distribution.pdf", "eigs.pdf", "moments.pdf", "varbreak.pdf",
              "vars.pdf", "bscmp.pdf", "bsmv.pdf", "bsreg.pdf"]:
        assert (tmp_path / f).exists(), f


def test_violinplot(tmp_path, run_small_mlmc):
    storage, est, mfn, vq = run_small_mlmc
    import pandas as pd
    from mlmc_tpu.plot import violinplot

    rng = np.random.default_rng(0)
    df = pd.DataFrame({
        "samples": rng.normal(size=200),
        "type": ["fine", "coarse"] * 100,
        "level": ["0 F  1 C"] * 200,
    })
    out = str(tmp_path / "violin.pdf")
    violinplot.fine_coarse_violinplot(df, file=out)
    assert os.path.exists(out)


def test_process_base_cli(tmp_path):
    """run + renew + process verbs against a synthetic simulation."""
    from mlmc_tpu.tool.process_base import ProcessBase

    class SynthProcess(ProcessBase):
        def create_simulation(self):
            return SynthSimulation(dict(distr=Norm(), complexity=2))

        def initial_n_samples(self):
            return [50, 10]

        def target_var(self):
            return 5e-2

    work_dir = str(tmp_path / "cli_run")
    p = SynthProcess(argv=["run", work_dir, "--clean"])
    assert os.path.exists(os.path.join(work_dir, "mlmc_2.hdf5"))

    means, variances = SynthProcess(
        argv=["process", work_dir]).process()
    assert np.asarray(means)[0] == 1.0

    # renew on the existing storage
    SynthProcess(argv=["renew", work_dir])


def test_config_front_end(tmp_path):
    from mlmc_tpu.tool.config import load_config, validate_config, apply_overrides

    base = tmp_path / "base.yaml"
    base.write_text("sim:\n  sigma: 1.0\n  corr_length: 0.2\nlevels: 3\n")
    main = tmp_path / "main.yaml"
    main.write_text(
        "include: base.yaml\nsim:\n  sigma: 0.5\ntarget_var: 1.0e-4\n")

    cfg = load_config(str(main), overrides=["sim.corr_length=0.3",
                                            "levels=5"])
    assert cfg["sim"]["sigma"] == 0.5          # include overridden by file
    assert cfg["sim"]["corr_length"] == 0.3    # dotted override
    assert cfg["levels"] == 5
    assert cfg["target_var"] == 1e-4

    validate_config(cfg, {"sim": {"sigma": float, "corr_length": float},
                          "levels": int, "missing?": int})
    import pytest as _pytest
    with _pytest.raises(ValueError):
        validate_config(cfg, {"nonexistent": int})


def test_structured_logging(capsys):
    import io
    from mlmc_tpu.tool import log as mlog

    buf = io.StringIO()
    logger = mlog.configure(stream=buf)
    lg = mlog.get_logger("test")
    mlog.event(lg, "collected", level=1, n=512)
    out = buf.getvalue()
    assert "collected" in out and "level=1" in out and "n=512" in out


def test_new_plot_functions(tmp_path, run_small_mlmc):
    from mlmc_tpu.plot import plots, violinplot

    plots.plot_diff_var_subsample(np.abs(np.random.default_rng(0).normal(
        size=(3, 5))), 2, file=str(tmp_path / "dvs"))
    plots.plot_error(np.random.default_rng(0).normal(size=100),
                     file=str(tmp_path / "err"))
    plots.plot_regression_diffs(np.abs(np.random.default_rng(0).normal(
        size=(4, 3))), 5, file=str(tmp_path / "rd"))
    for f in ["dvs.pdf", "err.pdf", "rd.pdf"]:
        assert (tmp_path / f).exists()

    vp = violinplot.ViolinPlotter()
    rng = np.random.default_rng(1)
    vp.add_level("0 F  1 C", rng.normal(size=50), rng.normal(size=50))
    out = str(tmp_path / "vp.pdf")
    vp.show(file=out)
    assert os.path.exists(out)
    violinplot.violinplot(rng.normal(size=80), file=str(tmp_path / "v1.pdf"))
    assert (tmp_path / "v1.pdf").exists()


def test_plot_level_costs(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    from mlmc_tpu.plot.plots import plot_level_costs

    plot_level_costs([[0.1], [0.05], [0.025]], [0.01, 0.05, 0.3],
                     n_elements=[100, 400, 1600],
                     file=str(tmp_path / "costs.pdf"))
    assert (tmp_path / "costs.pdf").exists()


def test_distribution_plot_error_axes(tmp_path):
    """Distribution plot with exact overlay + kl error twin-axes."""
    import matplotlib
    matplotlib.use("Agg")
    import scipy.stats as stats
    from mlmc_tpu.plot.plots import Distribution

    class FakeDistr:
        domain = (-3, 3)

        class moments_fn:
            size = 7

        def density(self, x):
            return stats.norm.pdf(x) * 1.02

        def cdf(self, x):
            return stats.norm.cdf(x)

    d = Distribution(exact_distr=stats.norm(), error_plot="kl", log_x=False)
    d.add_distribution(FakeDistr())
    assert d.ax_pdf_err is not None
    d.show(file=str(tmp_path / "distr.pdf"))
    assert (tmp_path / "distr.pdf").exists()


def test_process_base_analysis_recipes(tmp_path, run_small_mlmc):
    """The remaining reference analysis verbs, as working implementations
    (the reference bodies target its removed CompareLevels API)."""
    from mlmc_tpu.tool.process_base import ProcessBase

    storage, est, mfn, vq = run_small_mlmc
    pb = ProcessBase.__new__(ProcessBase)  # recipes don't touch CLI state

    reg_vars = pb.analyze_regression_of_variance(
        est, None, out_file=str(tmp_path / "reg_var"))
    assert np.all(np.isfinite(reg_vars)) and reg_vars.shape[1] == mfn.size

    bs_l_vars = pb.analyze_error_of_level_variances(
        est, None, out_file=str(tmp_path / "lvl_var_err"))
    assert np.all(np.isfinite(bs_l_vars))
    assert (tmp_path / "reg_var.pdf").exists()
    assert (tmp_path / "lvl_var_err.pdf").exists()

    # round-3 additions: the three legacy regression/log-variance recipes
    # (reference process_base.py:306-404)
    rv = pb.analyze_error_of_regression_variance(
        est, None, out_file=str(tmp_path / "reg_var_err"), n_subsamples=8)
    assert np.all(np.isfinite(rv))
    rlv = pb.analyze_error_of_regression_level_variances(
        est, None, out_file=str(tmp_path / "reg_lvl_var_err"),
        n_subsamples=5)
    assert np.all(np.isfinite(rlv))
    lv = pb.analyze_error_of_log_variance(
        est, None, out_file=str(tmp_path / "log_var_err"), n_subsamples=8)
    assert np.all(np.isfinite(lv))
    for f in ("reg_var_err", "reg_lvl_var_err", "log_var_err"):
        assert (tmp_path / (f + ".pdf")).exists()

    # complexity-theorem diagnostics (new recipe): the 2-level fixture has
    # a single diff level, so rates degrade to NaN gracefully while the
    # (un-extrapolatable) mean stays finite; >=3-level rate recovery is
    # covered in tests/test_validation.py
    rates, extrap = pb.analyze_convergence_rates(est)
    assert rates["n_fit_levels"] == 1 and np.isnan(rates["alpha"]), rates
    assert np.isfinite(extrap)


def test_variance_of_variance_closed_form_matches_quadrature():
    """The closed-form Var[log chi2_df] = trigamma(df/2) must agree with
    the reference's numerical quadrature of the log-chi2 pdf
    (reference estimator.py:136-169)."""
    import scipy.stats as st
    import scipy.integrate as integrate
    from mlmc_tpu.estimator import Estimate

    def quadrature_var(ns):
        df = ns - 1

        def log_chi_pdf(x):
            return np.exp(x) * df * st.chi2.pdf(np.exp(x) * df, df=df)

        def moment(m):
            std = np.sqrt(2 / df)
            return integrate.quad(lambda x: x ** m * log_chi_pdf(x),
                                  -100 * std, 100 * std)[0]

        return moment(2) - moment(1) ** 2

    est = Estimate.__new__(Estimate)
    ns = np.array([3, 10, 50, 400, 5000])
    closed = est._variance_of_variance(n_samples=ns)
    quad = np.array([quadrature_var(n) for n in ns])
    assert np.allclose(closed, quad, rtol=1e-6), (closed, quad)


def test_compile_cache_platform_decision():
    """The persistent compile cache: whatever JAX_COMPILATION_CACHE_DIR
    names (JAX reads it; the package sets nothing), none for a CPU-only
    process (keyed off the PRIMARY platform of a priority list), and
    otherwise one fixed directory inside the checkout."""
    import os
    from mlmc_tpu import _compile_cache_dir

    repo_cache = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(mlmc_tpu.__file__))), ".jax_cache")
    assert _compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x"},
                              "cuda") is None
    assert _compile_cache_dir({}, "cpu") is None
    assert _compile_cache_dir({}, " cpu , cuda") is None
    assert _compile_cache_dir({}, "cuda,cpu") == repo_cache
    assert _compile_cache_dir({}, "") == repo_cache
    assert _compile_cache_dir({}, None) == repo_cache


def _run_python(code, env, args=()):
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(
        mlmc_tpu.__file__)))
    return subprocess.run([sys.executable, "-c", code, *args], cwd=repo,
                          env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_placement_in_process(tmp_path, env_dir):
    """What ``import mlmc_tpu`` leaves in jax.config: the directory
    JAX_COMPILATION_CACHE_DIR names, or else the checkout's .jax_cache
    (an accelerator-or-default process; nothing compiles here)."""
    import os

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    proc = _run_python(
        "import jax, mlmc_tpu\n"
        "print('CACHE=' + str(jax.config.jax_compilation_cache_dir))\n",
        env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = proc.stdout.strip().splitlines()[-1]
    want = (str(tmp_path / "cc") if env_dir else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(mlmc_tpu.__file__))),
        ".jax_cache"))
    assert got == "CACHE=" + want


_WITHOUT_OPTIONAL = """
import sys


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("h5py", "yaml"):
            raise ImportError("blocked " + name)


sys.meta_path.insert(0, Block())
import mlmc_tpu
from mlmc_tpu import (DeviceMemory, SynthSimulation, DeviceBatchPool,
                      Sampler, Legendre, make_root_quantity, Estimate)
from mlmc_tpu.tool.config import apply_overrides

sim = SynthSimulation(dict(distr="norm", complexity=2))
store = DeviceMemory()
pool = DeviceBatchPool(seed=1, min_bucket=256, device_results=True)
smp = Sampler(store, pool, sim, [[0.5], [0.25]])
smp.set_initial_n_samples([512, 256])
smp.schedule_samples()
smp.ask_sampling_pool_for_samples()
q = make_root_quantity(store, sim.result_format())["length"][1]["10"][0, 0]
mean, _var = Estimate(q, store, Legendre(5, (-4.0, 4.0))
                      ).estimate_moments_fast()
assert abs(mean[0] - 1.0) < 1e-6, mean

hdf = mlmc_tpu.SampleStorageHDF(file_path=sys.argv[1])
for mod, call in (("h5py", lambda: hdf.save_global_data([[0.5]], [])),
                  ("yaml", lambda: apply_overrides({}, ["a=1"]))):
    try:
        call()
    except ImportError as exc:
        assert repr(mod) in str(exc), exc
    else:
        raise AssertionError(mod + " was not needed")
assert "h5py" not in sys.modules and "yaml" not in sys.modules
print("OPTIONAL_IMPORTS_OK")
"""


def test_import_without_optional_packages(tmp_path):
    """``import mlmc_tpu`` and a small adaptive-path estimate need neither
    h5py nor yaml; the HDF storage and the YAML config fail at use with
    an ImportError naming the package."""
    import os

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = _run_python(_WITHOUT_OPTIONAL, env,
                       args=(str(tmp_path / "s.hdf5"),))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OPTIONAL_IMPORTS_OK" in proc.stdout


def test_variance_regression_nonpositive_guard():
    """f32 cancellation can hand the log-space variance regression a zero
    or negative deep-level entry (esp. bootstrap replicates); the fit must
    skip those rows and still return finite predictions everywhere."""
    from mlmc_tpu.estimator import Estimate

    steps = np.array([0.5, 0.25, 0.125, 0.0625, 0.03125, 0.015625])
    v = np.array([1e-2, 4e-3, 1e-3, 2.5e-4, 0.0, -1e-12])
    out = Estimate._moment_variance_regression(v, steps)
    assert np.all(np.isfinite(out))
    assert out[0] == v[0]                     # level 0 untouched
    assert np.all(out[1:] > 0)                # predictions replace the junk

    # too few positive points to fit: raw values pass through unchanged
    v2 = np.array([1e-2, 4e-3, 1e-3, 0.0, 0.0, -1e-12])
    assert np.array_equal(Estimate._moment_variance_regression(v2, steps), v2)
