"""Shooting ODE simulations — device-native (BASELINE.json config 2).

Re-design of reference examples/shooting/simulation_shooting_{1,2}D.py:
a projectile with state (X, V) integrated by explicit Euler under a random
force field F(t), QoI = final y (1D) or final position (2D); leaving the
area borders poisons the sample with NaN (reference
simulation_shooting_1D.py:86-121).

Device re-design:

* the random force field is a spectral GRF (random Fourier features):
  ``F(t) = sigma*sqrt(2/M) sum_m cos(k_m t + phi_m)``; phases are drawn
  per-sample from the PRNG key, so fine and coarse trajectories of one
  sample share EXACTLY the same field realization evaluated on their own
  time grids (the reference shares one field sampled on concatenated
  point sets, simulation_shooting_1D.py:76-82),
* the field evaluation is a matmul: by angle addition
  ``cos(t k + phi) = cos(tk) cos(phi) - sin(tk) sin(phi)`` and the
  ``cos(tk)/sin(tk)`` matrices are SAMPLE-INDEPENDENT, so a whole level
  batch is one ``[B, M] @ [M, T]`` matmul — 2M transcendentals per
  sample instead of T*M,
* explicit Euler is LINEAR in the force sequence:
  ``X_j = X0 + j dt V0 + dt^2 sum_i (j-i)_+ f_i`` — a matmul with the
  fixed weight matrix ``W[j, i] = max(j-i, 0)`` replaces the T-step
  sequential ``lax.scan``; for non-log fields it composes with the
  angle-addition split so the whole trajectory batch is ONE
  ``[B, M] @ [M, T]`` matmul against precomputed Euler-weighted mode
  matrices. The out-of-borders test is an ``any`` over the trajectory
  (the reference's data-dependent ``break``,
  simulation_shooting_1D.py:86-121),
* ``calculate_batch`` is one fused XLA program per level batch.
"""
import copy
from typing import List

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.sim.simulation import Simulation
from mlmc_tpu.quantity.quantity_spec import QuantitySpec
from mlmc_tpu.level_simulation import LevelSimulation


def _spectral_wave_numbers(model, corr_length, mode_no, seed=0):
    """Wave numbers for the 1-D spectral force field (see
    random/correlated_field.SpectralCorrelatedField for the derivation)."""
    key = jax.random.key(seed)
    if model == "exp":
        y = jax.random.normal(key, (mode_no,))
        w = jax.random.chisquare(jax.random.fold_in(key, 1), 1.0, (mode_no,))
        k = y / jnp.sqrt(w) / corr_length
    else:  # gauss
        k = jax.random.normal(key, (mode_no,)) * (np.sqrt(2.0) / corr_length)
    return k


class ShootingSimulation1D(Simulation):
    """1D shooting: QoI = final height y."""

    N_MODES = 512
    result_dim = 1

    def __init__(self, config):
        """:param config: dict with keys
        start_position [2], start_velocity [2], area_borders [4],
        max_time, complexity (n_elements = complexity / step),
        fields_params: dict(model='gauss'|'exp', corr_length, sigma, log)
        """
        super().__init__()
        self._config = config
        self.need_workspace = False

    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]) -> LevelSimulation:
        config = copy.deepcopy(self._config)
        config["fine"] = {"step": float(fine_level_params[0])}
        config["coarse"] = {"step": float(coarse_level_params[0])}
        config["res_format"] = self.result_format()
        config["fine"]["n_elements"] = int(config["complexity"] / config["fine"]["step"])
        if config["coarse"]["step"] > 0:
            config["coarse"]["n_elements"] = int(
                config["complexity"] / config["coarse"]["step"])
        else:
            config["coarse"]["n_elements"] = 0
        fp = config.get("fields_params", {})
        config["_wave_numbers"] = _spectral_wave_numbers(
            fp.get("model", "gauss"), fp.get("corr_length", 0.1),
            config.get("n_modes", self.N_MODES), seed=fp.get("seed", 0))
        return LevelSimulation(config_dict=config,
                               task_size=self.n_ops_estimate(fine_level_params[0]),
                               nan_result_is_failure=False)

    # ------------------------------------------------------------------ #
    #: uniforms consumed per sample by the QMC path (n_modes * force axes)
    N_FORCE_AXES = 1

    @classmethod
    def _phase_trig(cls, config, keys):
        """Per-sample phase trig: keys [B] -> (cos phi, sin phi) [B, M, A]
        with A independent force axes (1 here, 2 in the 2-D subclass)."""
        M = config["_wave_numbers"].shape[0]
        phases = jax.vmap(
            lambda k: jax.random.uniform(k, (M,), maxval=2 * np.pi))(keys)
        return jnp.cos(phases)[..., None], jnp.sin(phases)[..., None]

    @classmethod
    def _phase_trig_from_uniforms(cls, config, u):
        """QMC entry: uniforms [B, M*A] -> (cos phi, sin phi) [B, M, A].
        The phases are the sim's ONLY per-sample randomness, so driving
        them from low-discrepancy points makes the whole trajectory QoI a
        QMC integrand (additive across modes for non-log fields — ideal
        scrambling territory)."""
        M = config["_wave_numbers"].shape[0]
        phases = 2 * np.pi * u.reshape(u.shape[0], M, cls.N_FORCE_AXES)
        return jnp.cos(phases), jnp.sin(phases)

    @classmethod
    def _force_field_batch(cls, config, keys, times, trig=None):
        """Spectral GRF as a matmul: ``cos(tk + phi)`` splits into
        sample-independent ``cos(tk)/sin(tk)`` [M, T] matrices contracted
        with per-sample phase trig — ONE [B, M*A] x [M*A-ish, T] matmul
        per level batch. :return: [B, T, A] force values.

        :param trig: optional precomputed (cos phi, sin phi) [B, M, A] —
            shared by fine+coarse (the level coupling) and by the QMC path
        """
        k = config["_wave_numbers"]
        fp = config.get("fields_params", {})
        sigma = fp.get("sigma", 1.0)
        log = fp.get("log", True)
        tk = times[None, :] * k[:, None]                     # [M, T]
        C, S = jnp.cos(tk), jnp.sin(tk)
        cosp, sinp = trig if trig is not None \
            else cls._phase_trig(config, keys)               # [B, M, A]
        # einsum over modes; HIGHEST: a default-precision f32 dot may run
        # in TF32
        field = (jnp.einsum("bma,mt->bta", cosp, C,
                            precision=jax.lax.Precision.HIGHEST)
                 - jnp.einsum("bma,mt->bta", sinp, S,
                              precision=jax.lax.Precision.HIGHEST))
        field = sigma * jnp.sqrt(2.0 / k.shape[0]) * field
        return jnp.exp(field) if log else field

    @classmethod
    def _force_field(cls, config, key, times):
        """Single-sample convenience wrapper (tests/diagnostics)."""
        out = cls._force_field_batch(config, key[None], times)[0]
        return out[:, 0] if out.shape[1] == 1 else out

    @staticmethod
    def _euler_weights(n_elements, dtype):
        """Explicit Euler is linear in the force sequence: the recurrence
        ``X += dt V; V += dt f`` telescopes to
        ``X_j = X0 + j dt V0 + dt^2 sum_i (j-i)_+ f_i`` — the whole
        trajectory is one matmul with the fixed weight matrix
        ``W[j, i] = max(j-i, 0)`` (rows j = 1..T)."""
        j = np.arange(1, n_elements + 1)
        return jnp.asarray(
            np.maximum(j[:, None] - np.arange(1, n_elements + 1)[None, :], 0),
            dtype)

    @classmethod
    def _finals_from_acc(cls, config, acc, n_elements):
        """Assemble trajectories from the force-integral term and apply
        the border test.

        ``acc`` [B, T, A] is ``dt^2 sum_i (j-i)_+ f_i`` (any
        factorization); A=1 applies the one force to both velocity
        components (the 1-D sim's contract), A=2 is per-axis — either
        way the A axis broadcasts against the [2] start vectors.
        :return: X_final [B, 2] with NaN rows where any step left the
        area borders."""
        dt = config["max_time"] / n_elements
        borders = config["area_borders"]
        X0 = jnp.asarray(config["start_position"], dtype=acc.dtype)
        V0 = jnp.asarray(config["start_velocity"], dtype=acc.dtype)
        j_dt = dt * jnp.arange(1, n_elements + 1, dtype=acc.dtype)
        X = (X0[None, None] + j_dt[None, :, None] * V0[None, None]
             + acc)                                          # [B, T, 2]
        oob = ((X[..., 0] < borders[0]) | (X[..., 0] > borders[1])
               | (X[..., 1] < borders[2]) | (X[..., 1] > borders[3]))
        out = jnp.any(oob, axis=1)                           # [B]
        return jnp.where(out[:, None], jnp.nan, X[:, -1])

    @classmethod
    def _trajectory_finals(cls, config, forces, n_elements):
        """Closed-form explicit Euler over a [B, T, A] force batch."""
        dt = config["max_time"] / n_elements
        W = cls._euler_weights(n_elements, forces.dtype)
        acc = dt * dt * jnp.einsum("bia,ji->bja", forces, W,
                                   precision=jax.lax.Precision.HIGHEST)
        return cls._finals_from_acc(config, acc, n_elements)

    @classmethod
    def _calculate_level(cls, config, keys, which, trig=None):
        n = config[which]["n_elements"]
        times = jnp.linspace(0.0, config["max_time"], n)
        fp = config.get("fields_params", {})
        if not fp.get("log", True):
            # Non-log fields keep the force LINEAR in the phase trig, so
            # the Euler weights compose with the angle-addition split:
            # X_traj = X0 + j dt V0 + cos(phi) @ Cw - sin(phi) @ Sw with
            # Cw/Sw = dt^2 sigma sqrt(2/M) cos/sin(t k) @ W^T — the whole
            # trajectory batch is ONE [B, M] x [M, T] matmul, no force
            # array ever materializes.
            k = config["_wave_numbers"]
            dt = config["max_time"] / n
            scale = fp.get("sigma", 1.0) * jnp.sqrt(2.0 / k.shape[0]) * dt * dt
            tk = times[None, :] * k[:, None]                 # [M, T]
            W = cls._euler_weights(n, tk.dtype)
            hi = jax.lax.Precision.HIGHEST
            Cw = scale * jnp.matmul(jnp.cos(tk), W.T, precision=hi)
            Sw = scale * jnp.matmul(jnp.sin(tk), W.T, precision=hi)
            cosp, sinp = trig if trig is not None \
                else cls._phase_trig(config, keys)           # [B, M, A]
            acc = (jnp.einsum("bma,mt->bta", cosp, Cw, precision=hi)
                   - jnp.einsum("bma,mt->bta", sinp, Sw, precision=hi))
            finals = cls._finals_from_acc(config, acc, n)
        else:
            forces = cls._force_field_batch(config, keys, times, trig=trig)
            finals = cls._trajectory_finals(config, forces, n)
        return cls._extract_result(finals)

    @classmethod
    def _extract_result(cls, X):
        return X[:, 1:2]  # final y

    @classmethod
    def calculate(cls, config, seed):
        """Host single-sample path (reference calculate contract)."""
        key = jax.random.key(np.uint32(seed))
        fine, coarse, _ = cls.calculate_batch(config, key[None])
        return np.asarray(fine[0]), np.asarray(coarse[0])

    @classmethod
    def calculate_batch(cls, config, keys, attempts=None):
        """Level batch: keys [B] -> (fine [B, M], coarse [B, M], failed [B])."""
        trig = cls._phase_trig(config, keys)  # drawn ONCE: the coupling
        fine = cls._calculate_level(config, keys, "fine", trig=trig)
        if config["coarse"]["n_elements"] > 0:
            coarse = cls._calculate_level(config, keys, "coarse", trig=trig)
        else:
            coarse = jnp.zeros_like(fine)
        # NaN QoI (out of borders) is a valid stored result in the reference,
        # masked during estimation — never a failed sample
        failed = jnp.zeros(keys.shape[0], dtype=bool)
        return fine, coarse, failed

    def n_ops_estimate(self, step):
        return self._config["complexity"] / step

    def result_format(self) -> List[QuantitySpec]:
        return [QuantitySpec(name="target", unit="m", shape=(1,), times=[10],
                             locations=["0"])]


class ShootingSimulation2D(ShootingSimulation1D):
    """2D shooting: QoI = final position (x, y); independent force per axis."""

    result_dim = 2
    N_FORCE_AXES = 2

    @classmethod
    def _phase_trig(cls, config, keys):
        """Independent phases per axis: [B, M, 2]."""
        M = config["_wave_numbers"].shape[0]

        def phases(key):
            k1, k2 = jax.random.split(key)
            return jnp.stack(
                [jax.random.uniform(k1, (M,), maxval=2 * np.pi),
                 jax.random.uniform(k2, (M,), maxval=2 * np.pi)], axis=-1)

        ph = jax.vmap(phases)(keys)                          # [B, M, 2]
        return jnp.cos(ph), jnp.sin(ph)

    @classmethod
    def _extract_result(cls, X):
        return X  # final (x, y)

    def result_format(self) -> List[QuantitySpec]:
        return [QuantitySpec(name="target", unit="m", shape=(2,), times=[10],
                             locations=["0"])]
