"""Synthetic benchmark simulation — the first device-native forward model.

Re-design of reference mlmc/sim/synth_simulation.py:11-145. Semantics kept:

* ``sample_fn(x, h) = x + h·sqrt(1e-4 + |x|)``  (reference :38-46),
* fine and coarse share the same random draw (:76-92),
* level 0 coarse result is zeros (coarse step == 0, :110-112),
* result format: 2 quantities x 3 times x 2 locations x shape (2,1),
  locations get ``result + i`` offsets (:119-131),
* ``nan_fraction`` failure injection -> failed samples (:88-91, 115-116).

Device re-design: ``calculate_batch(config, keys, attempt)`` computes a whole
level batch from PRNG keys in one fused jnp computation — the host pools'
per-sample loop collapses into a vmapped expression. Failure injection is a
per-(key, attempt) Bernoulli so renewing a failed sample can succeed, like
the reference's counter-based injection.
"""
import numpy as np
import jax
import jax.numpy as jnp
from typing import List

from mlmc_tpu.sim.simulation import Simulation
from mlmc_tpu.quantity.quantity_spec import QuantitySpec
from mlmc_tpu.level_simulation import LevelSimulation
from mlmc_tpu.random.distributions import as_jax_distr, JaxDistr


class SynthSimulation(Simulation):
    """Artificial simulation: random parameter + step-dependent numerical error."""

    def __init__(self, config=None):
        """
        :param config: dict with keys
            distr: JaxDistr | scipy frozen distr | name str
            complexity: cost exponent for n_ops_estimate (default 2)
            nan_fraction: fraction of samples to fail (default 0)
        """
        super().__init__()
        if config is None:
            config = dict(distr="norm", complexity=2)
        self.config = dict(config)
        self.config.setdefault("complexity", 2)
        self.nan_fraction = float(config.get("nan_fraction", 0.0))
        self._distr = as_jax_distr(self.config["distr"])
        self.need_workspace = False

    #: config entries that vary per level as plain scalars — pools may pass
    #: them as TRACED arguments so ONE compiled executable serves every
    #: level (the structural level-0 difference is the static ``is_level0``
    #: flag set by level_instance)
    DYNAMIC_CONFIG = ("fine_step", "coarse_step")

    # ------------------------------------------------------------------ #
    @staticmethod
    def sample_fn(x, h):
        """Simulated QoI for parameter x at step h."""
        return x + h * jnp.sqrt(1e-4 + jnp.abs(x))

    @staticmethod
    def sample_fn_no_error(x, h):
        return x

    def level_instance(self, fine_level_params: List[float], coarse_level_params: List[float]):
        config = dict(
            fine_step=float(fine_level_params[0]),
            coarse_step=float(coarse_level_params[0]),
            is_level0=float(coarse_level_params[0]) == 0.0,
            distr=self._distr,
            nan_fraction=self.nan_fraction,
            res_format=self.result_format(),
        )
        return LevelSimulation(
            config_dict=config, task_size=self.n_ops_estimate(fine_level_params[0])
        )

    @staticmethod
    def generate_random_samples(distr, seed, size):
        """Host RNG draw shared by fine and coarse (reference :70-92)."""
        key = jax.random.key(np.uint32(seed))
        y = as_jax_distr(distr).sample(key, (int(size),))
        return y, y

    # ------------------------------------------------------------------ #
    # host single-sample path (parity with the reference contract)
    # ------------------------------------------------------------------ #
    @staticmethod
    def calculate(config, seed):
        """Single-sample calculation from an integer seed (host/debug path)."""
        key = jax.random.key(np.uint32(seed))
        fine, coarse, failed = SynthSimulation._calculate_one(config, key, attempt=0)
        if bool(failed):
            raise Exception("result is nan")
        return np.asarray(fine), np.asarray(coarse)

    # ------------------------------------------------------------------ #
    # device batch path — THE hot path
    # ------------------------------------------------------------------ #
    @staticmethod
    def _base_samples(config, key):
        distr: JaxDistr = config["distr"]
        quantity_format = config["res_format"]
        size = int(np.prod(quantity_format[0].shape))
        return distr.sample(key, (size,))

    @staticmethod
    def _expand_results(config, fine_res, coarse_res):
        """Tile base results into the flattened result format.

        For each quantity spec: locations get ``result + i`` (i = location
        index; level0/coarse0 uses plain result), replicated over times.
        Returns flat arrays of length sum_q prod(shape)·n_times·n_locs.
        """
        quantity_format = config["res_format"]
        is_l0 = SynthSimulation._is_level0(config)

        def build(result):
            quantities = []
            for q in quantity_format:
                n_loc = len(q.locations)
                n_times = len(q.times)
                if is_l0:
                    locations = jnp.stack([result for _ in range(n_loc)])
                else:
                    locations = jnp.stack([result + i for i in range(n_loc)])
                times = jnp.stack([locations for _ in range(n_times)])
                quantities.append(times.reshape(-1))
            return jnp.concatenate(quantities)

        return build(fine_res), build(coarse_res)

    @staticmethod
    def _is_level0(config):
        """Static level-0 flag; with traced steps it MUST come from the
        config (level_instance sets it) — the step value itself is not
        usable in Python control flow under jit."""
        flag = config.get("is_level0")
        if flag is None:
            flag = config["coarse_step"] == 0
        return bool(flag)

    @staticmethod
    def _calculate_one(config, key, attempt=0):
        """One sample from one PRNG key: returns (fine, coarse, failed)."""
        value_key, fail_key = jax.random.split(key)
        y = SynthSimulation._base_samples(config, value_key)

        fine_step = config["fine_step"]
        coarse_step = config["coarse_step"]
        fine_result = SynthSimulation.sample_fn(y, fine_step)
        if SynthSimulation._is_level0(config):
            coarse_result = jnp.zeros_like(fine_result)
        else:
            coarse_result = SynthSimulation.sample_fn(y, coarse_step)

        fine_flat, coarse_flat = SynthSimulation._expand_results(config, fine_result, coarse_result)

        nan_fraction = config.get("nan_fraction", 0.0)
        if nan_fraction > 0:
            fail_key = jax.random.fold_in(fail_key, attempt)
            failed = jax.random.uniform(fail_key, ()) < nan_fraction
        else:
            failed = jnp.asarray(False)
        return fine_flat, coarse_flat, failed

    @staticmethod
    def calculate_batch(config, keys, attempts=None):
        """Whole level batch: keys [B] -> (fine [B, M], coarse [B, M], failed [B]).

        Pure jnp; pools wrap this in jit with a static config closure.
        :param attempts: [B] per-sample retry counts salting the failure draw
        """
        if attempts is None:
            attempts = jnp.zeros(keys.shape[0], dtype=jnp.uint32)
        one = lambda k, a: SynthSimulation._calculate_one(config, k, a)
        return jax.vmap(one)(keys, attempts)

    @staticmethod
    def scalar_batch_fn(fine_step, coarse_step, distr, nan_fraction=0.0):
        """Scalar-QoI batch simulation for the fused estimation pipeline.

        :return: ``f(keys [C]) -> (fine [C], coarse [C], failed [C])`` pure
            jnp, suitable for ops.fused_estimate / parallel.sharded_mlmc_step.
        """

        def one(key):
            value_key, fail_key = jax.random.split(key)
            y = distr.sample(value_key, ())
            fine = SynthSimulation.sample_fn(y, fine_step)
            if coarse_step == 0:
                coarse = jnp.zeros_like(fine)
            else:
                coarse = SynthSimulation.sample_fn(y, coarse_step)
            if nan_fraction > 0:
                failed = jax.random.uniform(fail_key, ()) < nan_fraction
            else:
                failed = jnp.asarray(False)
            return fine, coarse, failed

        return jax.vmap(one)

    # ------------------------------------------------------------------ #
    def n_ops_estimate(self, step):
        return (1 / step) ** self.config["complexity"] * np.log(max(1 / step, 2.0))

    def result_format(self) -> List[QuantitySpec]:
        spec1 = QuantitySpec(name="length", unit="m", shape=(2, 1), times=[1, 2, 3],
                             locations=["10", "20"])
        spec2 = QuantitySpec(name="width", unit="mm", shape=(2, 1), times=[1, 2, 3],
                             locations=["30", "40"])
        return [spec1, spec2]
