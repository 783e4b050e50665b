"""Workspace-based synthetic simulation (host path).

Re-design of reference mlmc/sim/synth_simulation.py:148-296
(SynthSimulationWorkspace): the simulation reads its configuration from a
YAML file copied into a per-sample workspace directory — the pattern used
by external-binary simulations (FlowSim). Exercises the host pools'
workspace machinery (copy common files, chdir, failed-dir moves); it is
deliberately NOT a device simulation.
"""
import os
from typing import List

import numpy as np

from mlmc_tpu.sim.synth_simulation import SynthSimulation
from mlmc_tpu.level_simulation import LevelSimulation
from mlmc_tpu.tool import require


class SynthSimulationWorkspace(SynthSimulation):
    """Synthetic sample computed from a config YAML in the sample workspace."""

    n_nans = 0
    nan_fraction = 0
    len_results = 0

    CONFIG_FILE = "synth_sim_config.yaml"

    def __init__(self, config):
        """:param config: dict with key config_yaml (path to the YAML file
        with keys distr ('norm'), nan_fraction)"""
        self.config_yaml = config["config_yaml"]
        SynthSimulationWorkspace.n_nans = 0
        SynthSimulationWorkspace.nan_fraction = config.get("nan_fraction", 0.0)
        SynthSimulationWorkspace.len_results = 0
        self.need_workspace = True

    @staticmethod
    def sample_fn(x, h):
        return x + h * np.sqrt(1e-4 + np.abs(x))

    @staticmethod
    def sample_fn_no_error(x, h):
        return x

    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]) -> LevelSimulation:
        config = dict()
        config["fine"] = {"step": fine_level_params[0]}
        config["coarse"] = {"step": coarse_level_params[0]}
        config["res_format"] = self.result_format()
        job_weight = 20000
        return LevelSimulation(config_dict=config,
                               common_files=[self.config_yaml],
                               task_size=1.0 / job_weight,
                               need_sample_workspace=True)

    @staticmethod
    def generate_random_samples(distr, seed, size):
        """Host RNG draw (fine and coarse share it); injects NaN failures
        whenever the realized failure rate trails the configured one."""
        cls = SynthSimulationWorkspace
        cls.len_results += 1
        if distr != "norm":
            raise NotImplementedError(
                "workspace synth sim only draws from 'norm'")
        y = np.random.RandomState(seed).normal(loc=1.0, scale=2.0, size=size)
        if cls.n_nans < cls.nan_fraction * cls.len_results:
            cls.n_nans += 1
            y = np.full(size, np.nan)
        return y, y

    @staticmethod
    def _structured(base, quantity_format, shift_locations):
        """Expand a base vector into the flat structured result layout:
        each spec contributes a [n_times, n_locations, prod(shape)] block,
        location k holding ``base + k`` (or ``base`` when not shifting);
        blocks are concatenated in spec order along the flat M axis."""
        parts = []
        for spec in quantity_format:
            n_loc, n_times = len(spec.locations), len(spec.times)
            offsets = np.arange(n_loc) if shift_locations else np.zeros(n_loc)
            block = base[None, :] + offsets[:, None]        # [loc, size]
            parts.append(np.broadcast_to(
                block, (n_times,) + block.shape).ravel())
        return np.concatenate(parts)

    @staticmethod
    def calculate(config, seed):
        """Runs INSIDE the sample workspace (cwd holds the config YAML)."""
        cls = SynthSimulationWorkspace
        config_file = cls._read_config()
        cls.nan_fraction = config_file["nan_fraction"]
        quantity_format = config["res_format"]

        draw, _ = cls.generate_random_samples(
            config_file["distr"], seed, int(np.prod(quantity_format[0].shape)))

        coarse_step = config["coarse"]["step"]
        fine_result = cls.sample_fn(draw, config["fine"]["step"])
        coarse_result = (np.zeros_like(fine_result) if coarse_step == 0
                         else cls.sample_fn(draw, coarse_step))

        if np.isnan(fine_result).any() or np.isnan(coarse_result).any():
            raise Exception("result is nan")

        shift = coarse_step != 0
        return (cls._structured(fine_result, quantity_format, shift),
                cls._structured(coarse_result, quantity_format, shift))

    # workspace simulations have no device batch path
    calculate_batch = None

    def n_ops_estimate(self, step):
        return (1 / step) ** 2 * np.log(max(1 / step, 2.0))

    @staticmethod
    def _read_config():
        with open(os.path.join(os.getcwd(),
                               SynthSimulationWorkspace.CONFIG_FILE)) as f:
            return require("yaml", "SynthSimulationWorkspace").safe_load(f)
