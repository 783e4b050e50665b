"""mlmc_tpu — multilevel Monte Carlo estimation framework on accelerators.

A from-scratch JAX/XLA re-design of the capabilities of GeoMop/MLMC
(https://github.com/GeoMop/MLMC): sample scheduling across levels, estimation
of generalized moment functions, maximum-entropy PDF reconstruction, and a
lazy Quantity array-algebra — with samples as a sharded device axis instead
of scheduler work items.

The public facade mirrors the reference package facade
(reference mlmc/__init__.py:108-117) so user scripts port directly.
"""
import os as _os


def _compile_cache_dir(environ, platforms):
    """Where this process keeps JAX's persistent compilation cache.

    :param environ: the process environment
    :param platforms: the ``jax_platforms`` setting ('' when unset)
    :return: the directory to configure, or None to configure nothing:
        ``JAX_COMPILATION_CACHE_DIR`` is read by JAX itself; a CPU-only
        process keeps no cache (XLA:CPU entries bake in the host's CPU
        features and CPU compiles are cheap); otherwise a fixed directory
        inside the checkout (the path is part of the cache key, so it must
        not move between runs)
    """
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if (platforms or "").split(",")[0].strip() == "cpu":
        return None
    return _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), ".jax_cache")


def _enable_persistent_compile_cache():
    """Compile each executable once per checkout, not once per process:
    the adaptive loop builds a handful of them (per-level batch runners,
    the packed estimation program) and a cold run pays every compile."""
    import jax

    cache_dir = _compile_cache_dir(
        _os.environ, jax.config.jax_platforms
        or _os.environ.get("JAX_PLATFORMS", ""))
    if cache_dir is not None:
        jax.config.update("jax_compilation_cache_dir", cache_dir)


_enable_persistent_compile_cache()

from mlmc_tpu.moments import Moments, Legendre, Monomial, Fourier, TransformedMoments
# NOTE: quantity_estimate's functions (estimate_mean, moments, covariance)
# are NOT re-exported at package level: `moments` would shadow the
# mlmc_tpu.moments module attribute. Import them from
# mlmc_tpu.quantity.quantity_estimate (same path as the reference).
from mlmc_tpu.quantity.quantity import (
    Quantity,
    QuantityConst,
    QuantityMean,
    QuantityStorage,
    make_root_quantity,
)
from mlmc_tpu.quantity.quantity_spec import QuantitySpec, ChunkSpec
from mlmc_tpu.quantity.quantity_types import (
    QType,
    ScalarType,
    BoolType,
    ArrayType,
    TimeSeriesType,
    FieldType,
    DictType,
)
from mlmc_tpu.sample_storage import SampleStorage, Memory, DeviceMemory
from mlmc_tpu.sample_storage_hdf import SampleStorageHDF
try:  # native engine is optional (needs a C++ toolchain at first use)
    from mlmc_tpu.sample_storage_bin import SampleStorageBin
except Exception:  # pragma: no cover
    SampleStorageBin = None
from mlmc_tpu.level_simulation import LevelSimulation
from mlmc_tpu.sampling_pool import (
    SamplingPool,
    OneProcessPool,
    ProcessPool,
    ThreadPool,
    DeviceBatchPool,
)
from mlmc_tpu.sampler import Sampler


class SamplingPoolPBS(DeviceBatchPool):
    """API-parity shim for reference PBS-cluster scripts.

    The PBS batch backend (reference mlmc/sampling_pool_pbs.py:48) has no
    device analogue — cluster fan-out is a device-mesh axis here. Scripts that
    constructed ``SamplingPoolPBS(work_dir, clean=...)`` get a
    DeviceBatchPool sharded over all available devices; see
    mlmc_tpu.parallel.multihost for multi-host pods.
    """

    def __init__(self, work_dir=None, clean=None, debug=False, **pbs_kwargs):
        import warnings

        from mlmc_tpu.parallel import SampleMesh

        warnings.warn(
            "SamplingPoolPBS is a compatibility shim: samples run as a "
            "sharded device batch, PBS options are ignored",
            DeprecationWarning, stacklevel=2)
        del clean, pbs_kwargs
        super().__init__(work_dir=work_dir, debug=debug,
                         sharding=SampleMesh())
from mlmc_tpu.estimator import Estimate
from mlmc_tpu.sim.simulation import Simulation
from mlmc_tpu.sim.synth_simulation import SynthSimulation
from mlmc_tpu.sim.synth_simulation_workspace import SynthSimulationWorkspace
from mlmc_tpu.sim.shooting import ShootingSimulation1D, ShootingSimulation2D
from mlmc_tpu.sim.diffusion import DiffusionSimulation
from mlmc_tpu.sim.diffusion3d import DiffusionSimulation3D
from mlmc_tpu.sim.transport import TransportSimulation
from mlmc_tpu.sim.flow_sim import FlowSim
from mlmc_tpu.sim.sde import (
    SDESimulation, SDEModel, gbm, ornstein_uhlenbeck, cir,
    black_scholes_call, sde_qmc_level_fns, gbm_call_shift)
from mlmc_tpu.sim.jumps import (JumpDiffusion, JumpDiffusionSimulation,
                                merton, merton_call_price)
from mlmc_tpu.sim.reactions import (ReactionNetwork, ReactionSimulation,
                                    mass_action, immigration_death,
                                    dimerization, schlogl, tau_leap,
                                    coupled_tau_leap, ssa_exact)
from mlmc_tpu.sim.rough import (RBergomi, rbergomi, RBergomiSimulation,
                                coupled_rbergomi_paths, rl_fbm_cov)
from mlmc_tpu.sim.spde import (SPDE1D, stochastic_heat, allen_cahn,
                               coupled_spde_paths, SPDESimulation,
                               heat_spde_l2_moment)
from mlmc_tpu.sim.levy import (VarianceGamma, variance_gamma,
                               VarianceGammaSimulation, vg_call_price)
from mlmc_tpu.tool.fourier_pricing import (cos_price, cf_gbm, cf_merton,
                                           cf_vg, cf_heston)
from mlmc_tpu.bsde import solve_bsde
from mlmc_tpu.qmc import (
    MLQMC, synth_qmc_level_fns, shooting_qmc_level_fns,
    darcy_qmc_level_fns, qmc_level_fns_from_normals,
    moments_qmc_level_fns)
from mlmc_tpu.ops.lattice import lattice_estimate, cbc_vector
from mlmc_tpu.sensitivity import (sobol_indices, sobol_indices_mlmc,
                                  active_subspace)
from mlmc_tpu.mimc import (MIMC, total_degree_set, full_tensor_set,
                           heat_mimc_value_fn)
from mlmc_tpu.unbiased import (UnbiasedMLMC, GeometricLevels,
                               sde_unbiased_level_fn)
from mlmc_tpu.cdf_estimate import MultilevelCDF, simulation_pair_fn
from mlmc_tpu.multifidelity import MFMC
from mlmc_tpu.mlblue import mlblue, default_groups
from mlmc_tpu.pod import pod_darcy_surrogate
from mlmc_tpu.nested import nested_level_fn, evppi_level_fn
from mlmc_tpu.mcmc import (MLMCMC, run_pcn, run_coupled, run_mlda,
                           run_unbiased, make_darcy_inverse)
from mlmc_tpu.eki import esmda, hierarchical_esmda
from mlmc_tpu.smc import smc_tempering, hierarchical_smc
from mlmc_tpu.rare import subset_simulation, cross_entropy_is
from mlmc_tpu.collocation import (AdaptiveSparseGrid, SparseGrid,
                                  multilevel_collocation)
from mlmc_tpu.pce import PCE, pce_control_variate, total_degree_indices
from mlmc_tpu.gp import GP, MultilevelGP, bayes_opt
from mlmc_tpu.oed import (eig_nmc, expected_information_gain,
                          linear_gaussian_eig)
from mlmc_tpu.filter import (enkf, multilevel_enkf, kalman_filter,
                              lorenz96_step)
from mlmc_tpu.particle import particle_filter, multilevel_particle_filter
from mlmc_tpu.risk import (cvar_empirical, cvar_mlmc, mlmc_gradient,
                           optimize_expectation, optimize_cvar)
from mlmc_tpu.cmlmc import cmlmc
from mlmc_tpu.ml2r import ml2r, ml2r_weights
from mlmc_tpu.sim.american import (lsmc_price, lsmc_dual_bound,
                                   lsmc_dual_bound_ml, lsmc_swing,
                                   bermudan_binomial, put_payoff,
                                   call_payoff)

__version__ = "0.1.0"
