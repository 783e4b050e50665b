"""Jump-diffusion MLMC: compound-Poisson (Merton-style) jumps coupled
across levels — beyond-reference tier (GeoMop/MLMC has no jump-process
capability; completes the SDE family of mlmc_tpu/sim/sde.py).

Dynamics: a continuous SDE part integrated by Euler substeps plus
multiplicative lognormal jumps

    dS = a(S, t) dt + b(S, t) dW + S_( (e^Y - 1) ) dN,
    N ~ Poisson(lam),  Y ~ N(jump_mean, jump_std^2) iid,

i.e. each fine substep applies the continuous Euler increment and then
multiplies the state by ``exp(L_j)`` where ``L_j`` is the summed log
jump over that substep. :func:`merton` builds the risk-neutral Merton
(1976) model — GBM continuous part with the compensated drift
``mu - lam*kappa``, ``kappa = E[e^Y] - 1`` — whose European call price
has the classic Poisson-mixture closed form
(:func:`merton_call_price`), the validation anchor.

Device-first coupling (the jump analogue of the shared Brownian path in
``coupled_path_functionals``, sde.py:416): per fine substep the scan
draws counter-derived ``N_j ~ Poisson(lam h_f)`` and ONE standard
normal ``Z_j``, forming the substep log jump ``L_j = N_j*jump_mean +
jump_std*sqrt(N_j)*Z_j`` — exact given the count, no per-jump loop or
dynamic shapes. The coarse path consumes the SUMS: ``dW_c = sum dW_j``
and ``L_c = sum L_j``, whose conditional law ``N(jm*sum N_j,
jv^2*sum N_j)`` with ``sum N_j ~ Poisson(lam h_c)`` is EXACTLY the
coarse-grid jump law — the coarse marginal is undistorted, so the
telescope stays consistent while fine and coarse share every jump.

Functionals mirror :class:`~mlmc_tpu.sim.sde.PathFunctionals`
(terminal/average/maximum/minimum at the post-jump substep nodes), so
the sde payoff helpers (``european_call``, ``asian_call``, ...)
compose unchanged. The Brownian-bridge extras (BGK extrema shift,
barrier survival, digital smoothing) are NOT extended here: between
jumps they would be valid, but jump overshoot changes barrier/extrema
semantics and a wrong "refinement" would be silent bias — use the raw
grid functionals, whose O(h) bias the telescope handles.

No reference analogue; literature: Merton (J. Fin. Econ. 3, 1976),
Xia & Giles (MCQMC 2012) for MLMC with jumps.
"""
import dataclasses
from typing import Callable, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.quantity.quantity_spec import QuantitySpec
from mlmc_tpu.sim.sde import (PathFunctionals, SDESimulation,
                              black_scholes_call)

__all__ = ["JumpDiffusion", "merton", "coupled_jump_functionals",
           "JumpDiffusionSimulation", "merton_call_price"]


@dataclasses.dataclass(frozen=True)
class JumpDiffusion:
    """Continuous SDE part (``drift``/``diffusion`` as in
    :class:`~mlmc_tpu.sim.sde.SDEModel`) plus multiplicative
    compound-Poisson lognormal jumps."""
    drift: Callable
    diffusion: Callable
    lam: float
    jump_mean: float
    jump_std: float
    s0: float

    @property
    def kappa(self):
        """Mean relative jump size ``E[e^Y] - 1``."""
        return float(np.expm1(self.jump_mean + 0.5 * self.jump_std ** 2))


def merton(mu=0.05, sigma=0.2, lam=0.5, jump_mean=-0.1, jump_std=0.15,
           s0=1.0):
    """Risk-neutral Merton jump-diffusion: GBM continuous part with the
    compensated drift ``mu - lam*kappa`` so ``E[S_T] = s0 e^(mu T)``
    (the discounted price is a martingale under ``mu = r``)."""
    kappa = float(np.expm1(jump_mean + 0.5 * jump_std ** 2))
    drift_rate = mu - lam * kappa
    return JumpDiffusion(drift=lambda s, t: drift_rate * s,
                         diffusion=lambda s, t: sigma * s,
                         lam=lam, jump_mean=jump_mean,
                         jump_std=jump_std, s0=s0)


def merton_call_price(s0, strike, rate, sigma, lam, jump_mean,
                      jump_std, T, n_terms=60):
    """Merton (1976) closed-form European call: Poisson mixture of
    Black-Scholes prices conditioned on the jump count."""
    m = jump_mean + 0.5 * jump_std ** 2        # log(1 + kappa)
    kappa = np.expm1(m)
    lam_bar = lam * (1.0 + kappa)
    if lam_bar * T == 0.0:
        n_terms = 1                            # only the k=0 term
    price, log_w = 0.0, -lam_bar * T
    for k in range(n_terms):
        sig_k = np.sqrt(sigma ** 2 + k * jump_std ** 2 / T)
        r_k = rate - lam * kappa + k * m / T
        price += np.exp(log_w) * black_scholes_call(s0, strike, r_k,
                                                    sig_k, T)
        if k + 1 < n_terms:
            log_w += np.log(lam_bar * T) - np.log1p(k)
    return float(price)


def coupled_jump_functionals(config, keys):
    """Integrate a coupled (fine, coarse) jump-diffusion level batch.

    :param config: dict with ``model`` (:class:`JumpDiffusion`),
        ``total_time``, ``n_fine``, ``n_coarse`` (0 on level 0);
        optional ``dtype``.
    :param keys: [B] PRNG keys — Brownian increments, Poisson counts
        and jump normals all derive counter-style inside the scan.
    :return: (fine, coarse | None) as
        :class:`~mlmc_tpu.sim.sde.PathFunctionals`.
    """
    model = config["model"]
    if not isinstance(model, JumpDiffusion):
        raise ValueError("model must be a JumpDiffusion")
    T = float(config["total_time"])
    n_f = int(config["n_fine"])
    n_c = int(config["n_coarse"])
    is_l0 = n_c == 0
    m = 1 if is_l0 else n_f // n_c
    if not is_l0 and n_f != m * n_c:
        raise ValueError("n_fine=%d must be a multiple of n_coarse=%d"
                         % (n_f, n_c))
    trips = n_f if is_l0 else n_c
    dt_f = T / n_f
    dt_c = dt_f * m
    dtype = jnp.dtype(config["dtype"]) if "dtype" in config \
        else jnp.result_type(float)
    B = keys.shape[0]
    sqrt_dt = jnp.asarray(np.sqrt(dt_f), dtype)
    lam_f = jnp.asarray(model.lam * dt_f, dtype)
    jm = jnp.asarray(model.jump_mean, dtype)
    jv = jnp.asarray(model.jump_std, dtype)

    def draws_at(c):
        """[B, m] Brownian increments, [B, m] substep log jumps."""
        def one(k):
            kk = jax.random.fold_in(k, c)
            ka, kb, kc = jax.random.split(kk, 3)
            dw = sqrt_dt * jax.random.normal(ka, (m,), dtype)
            n = jax.random.poisson(kb, lam_f, (m,)).astype(dtype)
            z = jax.random.normal(kc, (m,), dtype)
            return dw, n * jm + jv * jnp.sqrt(n) * z

        return jax.vmap(one)(keys)

    s0 = jnp.full((B,), model.s0, dtype)
    zero = jnp.zeros((B,), dtype)
    init = (s0, zero, s0, s0)          # (state, sum-of-nodes, max, min)

    def substeps(st, dws, ljs, t0, dt, n_sub):
        s, sm, mx, mn = st
        for j in range(n_sub):
            t = t0 + j * dt
            s = s + model.drift(s, t) * dt + model.diffusion(s, t) \
                * dws[:, j]
            s = s * jnp.exp(ljs[:, j])
            sm = sm + s
            mx = jnp.maximum(mx, s)
            mn = jnp.minimum(mn, s)
        return (s, sm, mx, mn)

    def body(carry, c):
        fine, coarse = carry
        dws, ljs = draws_at(c)
        t0 = c.astype(dtype) * dt_c
        fine = substeps(fine, dws, ljs, t0, dt_f, m)
        if not is_l0:
            coarse = substeps(coarse, jnp.sum(dws, axis=1,
                                              keepdims=True),
                              jnp.sum(ljs, axis=1, keepdims=True),
                              t0, dt_c, 1)
        return (fine, coarse), None

    (fine, coarse), _ = jax.lax.scan(body, (init, init),
                                     jnp.arange(trips))

    def functionals(st, n_nodes):
        s, sm, mx, mn = st
        return PathFunctionals(terminal=s,
                               average=(s0 + sm) / (n_nodes + 1),
                               maximum=mx, minimum=mn)

    return (functionals(fine, n_f),
            None if is_l0 else functionals(coarse, n_c))


class JumpDiffusionSimulation(SDESimulation):
    """Jump-diffusion MLMC under the standard Simulation contract —
    the jump analogue of :class:`~mlmc_tpu.sim.sde.SDESimulation`
    (level parameters ``[h]``, shared Brownian AND jump draws across
    the coupling). Config keys: ``model`` (:class:`JumpDiffusion`,
    default :func:`merton` defaults), ``total_time``, ``payoff``,
    ``qoi`` as in the parent; ``scheme`` is Euler-only and
    ``antithetic``/``path_extras``/``drift_shift`` are rejected (the
    Giles-Szpruch twin and the Brownian-bridge refinements assume
    continuous paths; the Girsanov tilt lacks the jump-measure
    likelihood ratio)."""

    def __init__(self, config=None):
        config = dict(config or {})
        config.setdefault("model", merton())
        if not isinstance(config["model"], JumpDiffusion):
            raise ValueError("model must be a JumpDiffusion")
        if config.get("antithetic"):
            raise ValueError("antithetic twins assume continuous "
                             "dynamics; not supported with jumps")
        if config.get("path_extras"):
            raise ValueError("Brownian-bridge path extras are not "
                             "extended to jump dynamics")
        if config.get("drift_shift"):
            # the Girsanov tilt in coupled_jump_functionals would need a
            # jump-measure likelihood ratio as well; without it the IS
            # weight would silently no-op (and result_format would
            # declare a log_weight column the batch never emits)
            raise ValueError("drift_shift (Girsanov importance "
                             "sampling) is not implemented for "
                             "jump-diffusions; the jump-measure "
                             "likelihood ratio is missing")
        if config.get("scheme", "euler") != "euler":
            raise ValueError("jump-diffusions integrate with Euler "
                             "substeps")
        super().__init__(config)

    @staticmethod
    def calculate_batch(config, keys, attempts=None):
        pf_f, pf_c = coupled_jump_functionals(config, keys)
        fine = SDESimulation._assemble(config, pf_f, None)
        if pf_c is None:
            coarse = jnp.zeros_like(fine)
        else:
            coarse = SDESimulation._assemble(config, pf_c, None)
        return fine, coarse, jnp.zeros(fine.shape[0], dtype=bool)

    @staticmethod
    def calculate(config, seed):
        key = jax.random.key(np.uint32(seed))
        fine, coarse, _ = JumpDiffusionSimulation.calculate_batch(
            config, key[None])
        return np.asarray(fine[0]), np.asarray(coarse[0])
