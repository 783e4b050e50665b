"""Infinite-activity Lévy MLMC: variance gamma — beyond-reference tier
(completes the price-process family of sim/sde.py + sim/jumps.py with
a pure-jump infinite-activity exponent; GeoMop/MLMC has no
price-process capability at all).

The variance-gamma process (Madan, Carr & Seneta, "The variance gamma
process and option pricing", Eur. Finance Rev. 2, 1998): Brownian
motion with drift ``theta`` and volatility ``sigma`` time-changed by a
gamma subordinator ``G_t ~ Gamma(t/nu, nu)``:

    ln S_t = ln S_0 + (r + omega) t + theta G_t + sigma W_{G_t},
    omega = ln(1 - theta nu - sigma^2 nu / 2) / nu   (martingale drift).

Device-first coupling — EXACT increments at every grid: VG increments are
available in closed form at any step (gamma + conditionally-normal
draw), so the fine path has NO time-discretization error in its state
and the coarse path is the RESTRICTION of the very same path to every
m-th node (gamma additivity: the sum of the fine subordinator
increments IS a coarse subordinator draw, and the summed conditional
normals are the coarse conditional normal — both marginals exact, the
paths literally identical at shared nodes). What MLMC telescopes here
is therefore MONITORING frequency: discretely-monitored path payoffs
(Asian averages, lookback extrema, barriers) converging to their
continuous-monitoring limits as the grid refines, with the terminal
payoff exactly level-independent (pinned bitwise in tests — a
degenerate-telescope sanity check the framework handles gracefully).

Functionals mirror :class:`~mlmc_tpu.sim.sde.PathFunctionals`, so the
sde payoff helpers compose unchanged. Validation anchor: the European
call against the COS characteristic-function price
(tool/fourier_pricing.py — itself pinned at machine precision to
Black-Scholes/Merton/Heston closed forms), the martingale identity,
and the coarse-restriction exactness.

No reference analogue; literature: Madan-Carr-Seneta (1998),
Fang & Oosterlee (2008) for the COS anchor.
"""
import dataclasses
from typing import Callable, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.quantity.quantity_spec import QuantitySpec
from mlmc_tpu.sim.sde import PathFunctionals, SDESimulation
from mlmc_tpu.tool.fourier_pricing import cf_vg, cos_price, vg_omega

__all__ = ["VarianceGamma", "variance_gamma", "coupled_vg_functionals",
           "VarianceGammaSimulation", "vg_call_price"]


@dataclasses.dataclass(frozen=True)
class VarianceGamma:
    """Risk-neutral VG exponent: ``rate`` drift (plus the martingale
    compensator omega), Brownian ``theta``/``sigma`` over a gamma
    clock of variance rate ``nu``."""
    rate: float = 0.05
    sigma: float = 0.12
    theta: float = -0.14
    nu: float = 0.2
    s0: float = 1.0


def variance_gamma(rate=0.05, sigma=0.12, theta=-0.14, nu=0.2, s0=1.0):
    """Madan-Carr-Seneta-shaped defaults; validates the martingale
    constraint ``theta nu + sigma^2 nu/2 < 1`` eagerly."""
    vg_omega(sigma, theta, nu)
    return VarianceGamma(rate=rate, sigma=sigma, theta=theta, nu=nu,
                         s0=s0)


def vg_call_price(s0, strike, rate, sigma, theta, nu, T,
                  n_terms=1024):
    """European VG call via the COS method (exact up to the
    exponentially-small truncation error)."""
    cf = cf_vg(rate, sigma, theta, nu, T)
    return cos_price(cf, s0, strike, rate, T, c1=cf.cumulants[0],
                     c2=cf.cumulants[1], c4=cf.cumulants[2],
                     n_terms=n_terms)


def coupled_vg_functionals(config, keys):
    """Integrate a coupled (fine, coarse-monitoring) VG level batch.

    :param config: dict with ``model`` (:class:`VarianceGamma`),
        ``total_time``, ``n_fine``, ``n_coarse`` (0 on level 0);
        optional ``dtype``.
    :param keys: [B] PRNG keys.
    :return: (fine, coarse | None) as
        :class:`~mlmc_tpu.sim.sde.PathFunctionals` — ONE exact path,
        monitored at n_fine vs n_coarse nodes.
    """
    model = config["model"]
    if not isinstance(model, VarianceGamma):
        raise ValueError("model must be a VarianceGamma")
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
    dtype = jnp.dtype(config["dtype"]) if "dtype" in config \
        else jnp.result_type(float)
    B = keys.shape[0]
    omega = vg_omega(model.sigma, model.theta, model.nu)
    drift = (model.rate + omega) * dt_f
    shape = dt_f / model.nu
    theta, sig, nu = model.theta, model.sigma, model.nu

    def draws_at(c):
        """[B, m] subordinator increments and standard normals."""
        def one(k):
            kk = jax.random.fold_in(k, c)
            kg, kz = jax.random.split(kk)
            g = nu * jax.random.gamma(kg, shape, (m,), dtype)
            z = jax.random.normal(kz, (m,), dtype)
            return g, z

        return jax.vmap(one)(keys)

    s0 = jnp.full((B,), model.s0, dtype)
    zero = jnp.zeros((B,), dtype)
    init_f = (s0, zero, s0, s0)        # (state, sum, max, min)
    init_c = (zero, s0, s0)            # (sum, max, min) — state shared

    def body(carry, c):
        (s, sm, mx, mn), coarse = carry
        g, z = draws_at(c)
        for j in range(m):
            logi = drift + theta * g[:, j] \
                + sig * jnp.sqrt(g[:, j]) * z[:, j]
            s = s * jnp.exp(logi)
            sm = sm + s
            mx = jnp.maximum(mx, s)
            mn = jnp.minimum(mn, s)
        if not is_l0:
            csm, cmx, cmn = coarse
            coarse = (csm + s, jnp.maximum(cmx, s), jnp.minimum(cmn, s))
        return ((s, sm, mx, mn), coarse), None

    ((s, sm, mx, mn), coarse), _ = jax.lax.scan(
        body, (init_f, init_c), jnp.arange(trips))
    fine = PathFunctionals(terminal=s, average=(s0 + sm) / (n_f + 1),
                           maximum=mx, minimum=mn)
    if is_l0:
        return fine, None
    csm, cmx, cmn = coarse
    return fine, PathFunctionals(terminal=s,
                                 average=(s0 + csm) / (n_c + 1),
                                 maximum=cmx, minimum=cmn)


class VarianceGammaSimulation(SDESimulation):
    """VG MLMC under the standard Simulation contract — exact
    increments, monitoring-frequency telescope (see module docstring).
    Config keys: ``model`` (:class:`VarianceGamma`, default
    :func:`variance_gamma`), ``total_time``, ``payoff``, ``qoi`` as in
    the parent; ``scheme``/``antithetic``/``path_extras`` are rejected
    (there is no discretization scheme to choose — increments are
    exact — and the Brownian-path refinements do not apply to a
    pure-jump exponent)."""

    def __init__(self, config=None):
        config = dict(config or {})
        config.setdefault("model", variance_gamma())
        if not isinstance(config["model"], VarianceGamma):
            raise ValueError("model must be a VarianceGamma")
        for opt in ("antithetic", "path_extras", "drift_shift"):
            if config.get(opt):
                raise ValueError(f"{opt} does not apply to the exact "
                                 "pure-jump VG increments")
        if config.get("scheme", "exact") not in ("exact", "euler"):
            raise ValueError("VG increments are exact; no scheme "
                             "choice applies")
        config["scheme"] = "euler"     # parent validation placeholder
        super().__init__(config)

    @staticmethod
    def calculate_batch(config, keys, attempts=None):
        pf_f, pf_c = coupled_vg_functionals(config, keys)
        fine = SDESimulation._assemble(config, pf_f, None)
        if pf_c is None:
            coarse = jnp.zeros_like(fine)
        else:
            coarse = SDESimulation._assemble(config, pf_c, None)
        return fine, coarse, jnp.zeros(fine.shape[0], dtype=bool)

    @staticmethod
    def calculate(config, seed):
        key = jax.random.key(np.uint32(seed))
        fine, coarse, _ = VarianceGammaSimulation.calculate_batch(
            config, key[None])
        return np.asarray(fine[0]), np.asarray(coarse[0])
