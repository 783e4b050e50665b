"""CLI application driver.

Re-design of reference mlmc/tool/process_base.py:8-394: the same verbs
``run | collect | renew | process`` over a work dir, as a subclassable
driver. Subclasses implement ``setup_config(n_levels, clean)`` returning a
(sampler, estimator-inputs) bundle and optionally ``process_analysis``.

The PBS environment switcheroo of the reference (:105-138) is replaced by
device selection: samples execute on whatever jax.devices() provides
(GPU(s) or the CPU mesh) through DeviceBatchPool.
"""
import argparse
import os
import shutil
import sys

import numpy as np

from mlmc_tpu.sample_storage_hdf import SampleStorageHDF
from mlmc_tpu.sampling_pool import DeviceBatchPool
from mlmc_tpu.sampler import Sampler
from mlmc_tpu import estimator as est_mod


class ProcessBase:
    """Subclassable CLI driver with run/collect/renew/process verbs."""

    def __init__(self, argv=None):
        args = ProcessBase.get_arguments(
            sys.argv[1:] if argv is None else argv)
        # defaults only if the subclass did not set them before super().__init__
        self.step_range = getattr(self, "step_range", (1, 0.01))
        self.n_levels = getattr(self, "n_levels", 2)
        self.n_moments = getattr(self, "n_moments", 25)
        self.work_dir = os.path.abspath(args.work_dir)
        self.append = False
        self.clean = args.clean
        self.debug = args.debug

        if args.command == "run":
            self.run()
        elif args.command == "renew":
            self.append = True
            self.clean = False
            self.run(renew=True)
        elif args.command == "collect":
            self.append = True
            self.clean = False
            self.run()
        else:  # process
            self.process()

    @staticmethod
    def get_arguments(arguments):
        """Parse the CLI argument vector (run|collect|renew|process)."""
        parser = argparse.ArgumentParser()
        parser.add_argument(
            "command", choices=["run", "collect", "renew", "process"],
            help="run - new execution; collect - append existing HDF file; "
                 "renew - re-run failed samples (same ids => same seeds); "
                 "process - analyze collected data")
        parser.add_argument("work_dir", help="Work directory")
        parser.add_argument("-c", "--clean", default=False, action="store_true",
                            help="Clean before run (only with 'run')")
        parser.add_argument("-d", "--debug", default=False, action="store_true",
                            help="Keep sample directories")
        return parser.parse_args(arguments)

    # ------------------------------------------------------------------ #
    # subclass hooks
    # ------------------------------------------------------------------ #
    def create_simulation(self):
        """:return: Simulation factory. Subclasses must override."""
        raise NotImplementedError

    def create_moments_fn(self, quantity, storage):
        """Moment basis over the estimated domain of ``quantity``."""
        from mlmc_tpu.moments import Legendre

        domain = est_mod.Estimate.estimate_domain(quantity, storage,
                                                  quantile=0.001)
        return Legendre(self.n_moments, domain)

    def get_quantity(self, storage, sim_factory):
        """Root quantity of the stored results (override point)."""
        from mlmc_tpu.quantity.quantity import make_root_quantity

        return make_root_quantity(storage, q_specs=sim_factory.result_format())

    def initial_n_samples(self):
        """Per-level initial sample counts (override point)."""
        return [100, 10]

    def target_var(self):
        """Target total estimator variance (override point)."""
        return 1e-3

    # ------------------------------------------------------------------ #
    def setup_config(self, n_levels, clean):
        """Build (sampler, sim_factory) over HDF storage in the work dir."""
        os.makedirs(self.work_dir, mode=0o775, exist_ok=True)
        hdf_path = os.path.join(self.work_dir,
                                "mlmc_{}.hdf5".format(n_levels))
        if clean and os.path.exists(hdf_path):
            os.remove(hdf_path)
        sim_factory = self.create_simulation()
        storage = SampleStorageHDF(file_path=hdf_path)
        pool = DeviceBatchPool(work_dir=self.work_dir if self.debug else None,
                               debug=self.debug)
        level_parameters = est_mod.determine_level_parameters(
            n_levels, self.step_range)
        sampler = Sampler(sample_storage=storage, sampling_pool=pool,
                          sim_factory=sim_factory,
                          level_parameters=level_parameters)
        return sampler, sim_factory

    def run(self, renew=False):
        """Execute the sampling workflow (fresh or renew-failed mode)."""
        os.makedirs(self.work_dir, mode=0o775, exist_ok=True)
        sampler_list = []
        for nl in [self.n_levels]:
            sampler, sim_factory = self.setup_config(nl, clean=self.clean)
            if renew:
                sampler.ask_sampling_pool_for_samples()
                sampler.renew_failed_samples()
                sampler.ask_sampling_pool_for_samples()
            else:
                self.generate_jobs(sampler, sim_factory,
                                   n_samples=self.initial_n_samples())
            sampler_list.append((sampler, sim_factory))
        self.all_collect(sampler_list)
        return sampler_list

    def generate_jobs(self, sampler, sim_factory, n_samples=None):
        """Initial scheduling + adaptive refinement to the target variance."""
        if n_samples is not None:
            sampler.set_initial_n_samples(n_samples)
        sampler.schedule_samples()
        sampler.ask_sampling_pool_for_samples()

        quantity = self.get_quantity(sampler.sample_storage, sim_factory)
        q_scalar = self.scalar_quantity(quantity)
        moments_fn = self.create_moments_fn(q_scalar, sampler.sample_storage)
        estimator = est_mod.Estimate(q_scalar, sampler.sample_storage,
                                     moments_fn)
        target_var = self.target_var()
        variances, n_ops = estimator.estimate_diff_vars_regression(
            sampler._n_scheduled_samples)
        n_estimated = est_mod.estimate_n_samples_for_target_variance(
            target_var, variances, n_ops, n_levels=sampler.n_levels)
        while not sampler.process_adding_samples(n_estimated, 0, 0.1):
            variances, n_ops = estimator.estimate_diff_vars_regression(
                sampler._n_scheduled_samples)
            n_estimated = est_mod.estimate_n_samples_for_target_variance(
                target_var, variances, n_ops, n_levels=sampler.n_levels)

    def scalar_quantity(self, root_quantity):
        """First scalar component; subclasses pick their QoI."""
        # walk Dict -> TimeSeries -> Field -> Array -> scalar
        q = root_quantity
        import mlmc_tpu.quantity.quantity_types as qt

        while not isinstance(q.qtype, qt.ScalarType):
            t = q.qtype
            if isinstance(t, qt.DictType):
                q = q[next(iter(t._dict.keys()))]
            elif isinstance(t, qt.TimeSeriesType):
                q = q[t._times[0]]
            elif isinstance(t, qt.FieldType):
                q = q[next(iter(t._dict.keys()))]
            elif isinstance(t, qt.ArrayType):
                q = q[(0,) * len(t._shape)]
            else:
                break
        return q

    def all_collect(self, sampler_list):
        """Wait for all samplers to drain (reference :218-229)."""
        running = 1
        while running > 0:
            running = 0
            for sampler, _ in sampler_list:
                running += sampler.ask_sampling_pool_for_samples()
            print("N running: ", running)

    # ------------------------------------------------------------------ #
    # analysis recipes (reference process_base.py:231-394)
    # ------------------------------------------------------------------ #
    def set_moments(self, quantity, storage, n_moments=None, quantile=0.001):
        """Build the Legendre basis from the sampled domain (reference API)."""
        from mlmc_tpu.moments import Legendre

        domain = est_mod.Estimate.estimate_domain(quantity, storage,
                                                  quantile=quantile)
        return Legendre(n_moments or self.n_moments, domain)

    def n_sample_estimate(self, sampler, estimator, target_var=None):
        """Variance-optimal n_l for the target variance (reference API)."""
        variances, n_ops = estimator.estimate_diff_vars_regression(
            sampler._n_scheduled_samples)
        return est_mod.estimate_n_samples_for_target_variance(
            target_var or self.target_var(), variances, n_ops,
            n_levels=sampler.n_levels)

    def analyze_error_of_variance(self, estimator, sampler, out_file=None):
        """Bootstrap spread of the level variances (reference :231-290)."""
        estimator.est_bootstrap(n_subsamples=50)
        from mlmc_tpu.plot import plots

        raw_vars, n_samples = estimator.estimate_diff_vars()
        bs = plots.BSplots(
            n_samples=n_samples, bs_n_samples=n_samples,
            n_moments=estimator.n_moments, ref_level_var=raw_vars)
        bs.plot_bs_variances(estimator.var_bs_l_vars, file=out_file or "")
        return estimator.var_bs_l_vars

    def analyze_pdf_approx(self, estimator, out_file=None, tol=1e-7):
        """Maxent PDF reconstruction + diagnostic plot (reference :330-394)."""
        from mlmc_tpu.plot import plots

        distr_obj, info, result, orto = estimator.construct_density(tol=tol)
        dp = plots.Distribution(title="pdf_approx")
        dp.add_distribution(distr_obj)
        dp.show(file=out_file or "")
        return distr_obj, result

    def analyze_regression_of_variance(self, estimator, sampler,
                                       out_file=None):
        """Raw level variances against their log-quadratic regression
        (working version of reference :268-280, whose body targets the
        removed CompareLevels API)."""
        from mlmc_tpu.plot import plots

        raw_vars, n_samples = estimator.estimate_diff_vars()
        steps = np.squeeze(np.asarray(
            estimator._sample_storage.get_level_parameters()))
        reg_vars = estimator._all_moments_variance_regression(raw_vars, steps)
        plots.plot_var_regression(raw_vars, reg_vars,
                                  n_levels=len(n_samples),
                                  n_moments=estimator.n_moments,
                                  file=out_file or "")
        return reg_vars

    def analyze_error_of_level_variances(self, estimator, sampler,
                                         out_file=None):
        """Bootstrap error of the per-level variance estimates
        (working version of reference :283-290)."""
        from mlmc_tpu.plot import plots

        estimator.est_bootstrap(n_subsamples=50)
        raw_vars, n_samples = estimator.estimate_diff_vars()
        bs = plots.BSplots(n_samples=n_samples, bs_n_samples=n_samples,
                           n_moments=estimator.n_moments,
                           ref_level_var=raw_vars)
        bs.plot_bs_level_variances_error(estimator.mean_bs_l_vars,
                                         file=out_file or "")
        return estimator.mean_bs_l_vars

    def analyze_error_of_regression_variance(self, estimator, sampler,
                                             out_file=None,
                                             n_subsamples=50):
        """Bootstrap error of the REGRESSED variance estimates: each
        replicate's level variances run through the log-quadratic variance
        regression before aggregation, demonstrating how much the
        regression stabilizes the allocation inputs
        (reference process_base.py:306-324 against the live API).
        """
        from mlmc_tpu.plot import plots

        estimator.est_bootstrap(n_subsamples=n_subsamples, regression=True)
        raw_vars, n_samples = estimator.estimate_diff_vars()
        bs = plots.BSplots(n_samples=n_samples, bs_n_samples=n_samples,
                           n_moments=estimator.n_moments,
                           ref_level_var=raw_vars)
        bs.plot_bs_var_error_contributions(
            estimator.var_bs_l_means, file=out_file or "")
        return estimator.var_bs_l_vars

    def analyze_error_of_regression_level_variances(self, estimator,
                                                    sampler, out_file=None,
                                                    n_subsamples=10):
        """Per-level spread of the REGRESSED bootstrap variances
        (reference process_base.py:353-378 against the live API; the
        reference uses only 10 replicates here — regression makes each one
        expensive but smooth)."""
        from mlmc_tpu.plot import plots

        estimator.est_bootstrap(n_subsamples=n_subsamples, regression=True)
        raw_vars, n_samples = estimator.estimate_diff_vars()
        bs = plots.BSplots(n_samples=n_samples, bs_n_samples=n_samples,
                           n_moments=estimator.n_moments,
                           ref_level_var=raw_vars)
        bs.plot_bs_level_variances_error(estimator.mean_bs_l_vars,
                                         file=out_file or "")
        return estimator.mean_bs_l_vars

    def analyze_error_of_log_variance(self, estimator, sampler,
                                      out_file=None, n_subsamples=50):
        """Bootstrap spread of the LOG level variances — the quantity the
        variance regression actually fits, so its spread is what the
        log-chi-squared model predicts (reference process_base.py:380-394
        against the live API)."""
        from mlmc_tpu.plot import plots

        estimator.est_bootstrap(n_subsamples=n_subsamples, log=True)
        raw_vars, n_samples = estimator.estimate_diff_vars()
        bs = plots.BSplots(n_samples=n_samples, bs_n_samples=n_samples,
                           n_moments=estimator.n_moments,
                           ref_level_var=raw_vars)
        bs.plot_bs_var_log_var(estimator.var_bs_log_l_vars,
                               file=out_file or "")
        return estimator.var_bs_log_l_vars

    def analyze_convergence_rates(self, estimator, sampler=None):
        """Giles complexity-theorem rates from the collected levels: alpha
        (weak), beta (variance), gamma (cost) plus the Richardson-
        extrapolated mean (new diagnostic; the reference only smooths the
        level variances, estimator.py:87-134, without extracting rates)."""
        import mlmc_tpu.quantity.quantity_estimate as qe

        storage = estimator._sample_storage
        m = qe.estimate_mean(estimator.quantity)
        rates = est_mod.estimate_convergence_rates(
            m.l_means, m.l_vars, storage.get_level_parameters(),
            storage.get_n_ops())
        extrap, bias = est_mod.richardson_extrapolation(
            m.l_means, storage.get_level_parameters(), rates["alpha"])
        print("rates: alpha=%.3g beta=%.3g gamma=%s" % (
            rates["alpha"], rates["beta"],
            "%.3g" % rates["gamma"] if "gamma" in rates else "n/a"))
        print("mean %.6g, Richardson-extrapolated %.6g (bias est. %.2g)"
              % (float(np.sum(np.asarray(m.l_means, dtype=float))),
                 extrap, bias))
        return rates, extrap

    def rm_files(self, work_dir):
        """Clean a work dir (reference rm_files)."""
        if os.path.isdir(work_dir):
            shutil.rmtree(work_dir)
        os.makedirs(work_dir, mode=0o775, exist_ok=True)

    def process_analysis(self, *args, **kwargs):
        """Subclass hook for custom analyses (reference :100-101)."""

    def process(self):
        """Analyze collected data (subclass hook; default: print moments)."""
        assert os.path.isdir(self.work_dir)
        sampler, sim_factory = self.setup_config(self.n_levels, clean=False)
        quantity = self.get_quantity(sampler.sample_storage, sim_factory)
        q_scalar = self.scalar_quantity(quantity)
        moments_fn = self.create_moments_fn(q_scalar, sampler.sample_storage)
        estimator = est_mod.Estimate(q_scalar, sampler.sample_storage,
                                     moments_fn)
        means, variances = estimator.estimate_moments(moments_fn)
        print("moment means:", np.asarray(means))
        print("moment vars: ", np.asarray(variances))
        return means, variances
