"""Simulation contract (reference mlmc/sim/simulation.py:7-33) + device batch path.

A simulation provides per-level instances and two calculate entry points:

* ``calculate(config, seed)``     — single-sample host path (parity with the
  reference; used by the process/thread pools and external-binary sims),
* ``calculate_batch(config, keys)`` — device path: a pure jnp function over a
  batch of PRNG keys, vmapped/jitted by the device pools. Simulations that
  implement it run at device speed; others fall back to the host loop.
"""
from abc import ABC, abstractmethod
from typing import List

from mlmc_tpu.level_simulation import LevelSimulation
from mlmc_tpu.quantity.quantity_spec import QuantitySpec


class Simulation(ABC):

    @abstractmethod
    def level_instance(
        self, fine_level_params: List[float], coarse_level_params: List[float]
    ) -> LevelSimulation:
        """Create the LevelSimulation descriptor for one level."""

    @abstractmethod
    def result_format(self) -> List[QuantitySpec]:
        """Define the simulation result format."""

    @staticmethod
    @abstractmethod
    def calculate(config_dict, seed):
        """Single-sample calculation: -> (fine result, coarse result), flat arrays."""

    # Device batch path — override in device-native simulations.
    CALCULATE_BATCH = None

    @classmethod
    def has_batch_path(cls):
        return getattr(cls, "calculate_batch", None) is not None
