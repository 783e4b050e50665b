"""SDE path simulation — the workload multilevel Monte Carlo was invented
for (Giles, "Multilevel Monte Carlo path simulation", Oper. Res. 56(3),
2008). Beyond-reference capability: GeoMop/MLMC ships synthetic, shooting
and PDE forward models only (reference mlmc/sim/, examples/shooting/) and
has no stochastic-differential-equation family; this module adds it with
the same Simulation contract (reference mlmc/sim/simulation.py:7-33), so
every estimator, storage, pool, QMC and density tier applies unchanged.

The model is ``dS = a(S, t) dt + b(S, t) dW`` on [0, T]; level l
integrates with ``n_l = round(T / h_l)`` steps and the MLMC coupling
shares ONE Brownian path: each coarse increment is the sum of its
``m = n_fine / n_coarse`` fine increments.

Device-first design:

* a whole level batch advances as ``[B]`` state vectors inside one
  ``lax.scan`` over coarse steps (fine substeps unrolled — the refine
  factor is a small static int); nothing per-sample ever runs on host,
* Brownian increments are derived counter-style from per-sample PRNG keys
  (``normal(fold_in(key, step))``) inside the scan — no ``[B, T]``
  increment array is materialized, so million-sample level batches fit
  in HBM at any path length,
* path functionals (terminal, running average/max/min) accumulate in the
  carry, so Asian/lookback payoffs cost nothing extra,
* the antithetic estimator (Giles & Szpruch, "Antithetic multilevel Monte
  Carlo estimation for multi-dimensional SDEs without Levy area
  simulation", Ann. Appl. Prob. 24(4), 2014) reverses each coarse
  interval's fine increments for a twin fine path and averages the two
  payoffs — same Brownian budget, one extra elementwise stream. The gain exists
  where increment ORDER matters (path averages/extrema, additive-noise
  models: measured ~3-4x per level); it is an exact no-op for terminal
  payoffs of multiplicative schemes like GBM, whose per-step factors
  commute,
* the QMC adapter maps low-discrepancy points through a Brownian-bridge
  construction (one precomputed ``[n, n]`` matmul — matmul work) so the
  early Sobol' dimensions carry the large-scale path structure, the
  classical recipe for making path integrals low-effective-dimension.

Schemes: Euler-Maruyama (weak order 1, MLMC variance decay beta ~ 1 for
Lipschitz payoffs) and Milstein (beta ~ 2; needs ``diffusion_ds``).
"""
import dataclasses
from collections import deque
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.sim.simulation import Simulation
from mlmc_tpu.quantity.quantity_spec import QuantitySpec
from mlmc_tpu.level_simulation import LevelSimulation

__all__ = [
    "SDEModel", "gbm", "ornstein_uhlenbeck", "cir",
    "PathFunctionals", "european_call", "european_put", "asian_call",
    "lookback_call", "digital_call", "terminal_value",
    "lookback_call_bb", "barrier_call_down_out", "digital_call_smoothed",
    "black_scholes_call", "black_scholes_digital", "lookback_call_price",
    "barrier_down_out_call_price", "BGK_BETA", "gbm_call_shift",
    "SDESimulation", "sde_qmc_level_fns",
    "brownian_bridge_increments",
    "SDESystem", "heston", "heston_call_price", "SDESystemSimulation",
]


# ---------------------------------------------------------------------- #
# models
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SDEModel:
    """Scalar SDE ``dS = drift(S, t) dt + diffusion(S, t) dW``.

    :param drift/diffusion: pure jnp callables ``(s, t) -> value``
    :param diffusion_ds: ``d diffusion / d s`` — required by Milstein
    :param s0: initial value
    """

    drift: Callable
    diffusion: Callable
    diffusion_ds: Optional[Callable] = None
    s0: float = 1.0


def gbm(mu=0.05, sigma=0.2, s0=1.0):
    """Geometric Brownian motion ``dS = mu S dt + sigma S dW`` — the
    Black-Scholes asset; closed-form option prices make it the standard
    MLMC validation model (Giles 2008 §5)."""
    return SDEModel(drift=lambda s, t: mu * s,
                    diffusion=lambda s, t: sigma * s,
                    diffusion_ds=lambda s, t: jnp.full_like(s, sigma),
                    s0=s0)


def ornstein_uhlenbeck(kappa=1.0, theta=0.0, sigma=0.5, s0=1.0):
    """Mean-reverting OU ``dS = kappa (theta - S) dt + sigma dW``; the
    exact terminal law is Gaussian with
    ``mean = theta + (s0-theta) e^{-kappa T}``,
    ``var = sigma^2 (1 - e^{-2 kappa T}) / (2 kappa)``."""
    return SDEModel(drift=lambda s, t: kappa * (theta - s),
                    diffusion=lambda s, t: jnp.full_like(s, sigma),
                    diffusion_ds=lambda s, t: jnp.zeros_like(s),
                    s0=s0)


def cir(kappa=1.0, theta=1.0, sigma=0.5, s0=1.0):
    """Cox-Ingersoll-Ross ``dS = kappa (theta - S) dt + sigma sqrt(S) dW``
    in the full-truncation Euler form (Lord, Koekkoek & van Dijk 2010):
    coefficients consume ``max(S, 0)`` so paths stay finite even when the
    discrete iterate dips negative. The sqrt diffusion is not Lipschitz at
    0 — use the Euler scheme (Milstein's ``b b'`` blows up there)."""
    return SDEModel(drift=lambda s, t: kappa * (theta - jnp.maximum(s, 0.0)),
                    diffusion=lambda s, t: sigma * jnp.sqrt(
                        jnp.maximum(s, 0.0)),
                    diffusion_ds=None,
                    s0=s0)


# ---------------------------------------------------------------------- #
# payoffs
# ---------------------------------------------------------------------- #
class PathFunctionals(NamedTuple):
    """Per-sample path functionals over the discrete grid (incl. S0).

    The last five fields are the CONTINUOUS-MONITORING corrections
    (Giles 2008 §5; populated only under ``path_extras=True`` in the
    config, else None): discrete grid extrema/indicators estimate their
    continuous counterparts with O(sqrt(h)) weak error, which both
    biases the estimate and (for indicators) destroys the MLMC variance
    decay — these fields carry the standard fixes, computed in-kernel
    from each path's OWN nodes so payoffs stay separable per level.

    * ``shifted_minimum`` / ``shifted_maximum``: extrema of
      ``S_n -/+ beta* |b(S_n)| sqrt(h)`` — the Broadie-Glasserman-Kou
      continuity correction (Math. Finance 7, 1997; beta* =
      -zeta(1/2)/sqrt(2pi) ~ 0.5826) Giles uses for lookback payoffs:
      weak error O(h), and the shift is pathwise-smooth so coupled
      corrections keep the scheme's variance decay.
    * ``log_survival``: sum over steps of the log Brownian-bridge
      non-crossing probability of the ``barrier`` config key —
      ``exp(log_survival)`` is the conditional expectation of the
      continuous knock-out indicator given the grid nodes (Glasserman
      2004 §6.4), replacing the 0/1 crossing indicator with a smooth
      functional.
    * ``digital_mu`` / ``digital_sd``: the Gaussian law of the terminal
      value CONDITIONED on the penultimate node (one Euler step) — and,
      on the COARSE path of a coupled level, additionally on the fine
      increments over all but the last fine substep of its final step
      (Giles 2008 §5.3), so both paths smooth at the SAME width
      ``|b| sqrt(h_fine)`` and the tower property keeps the telescope
      exact. A digital payoff becomes the smooth ``Phi((mu - K)/sd)``
      with measured variance decay beta ~ 3/2 (the raw indicator gives
      ~ 1/2-1).
    """

    terminal: jnp.ndarray
    average: jnp.ndarray
    maximum: jnp.ndarray
    minimum: jnp.ndarray
    shifted_minimum: Optional[jnp.ndarray] = None
    shifted_maximum: Optional[jnp.ndarray] = None
    log_survival: Optional[jnp.ndarray] = None
    digital_mu: Optional[jnp.ndarray] = None
    digital_sd: Optional[jnp.ndarray] = None
    #: Girsanov log likelihood-ratio under ``drift_shift`` (else None):
    #: payoffs must be multiplied by ``exp(log_weight)`` —
    #: :meth:`SDESimulation._assemble` does it for payoff QoIs.
    log_weight: Optional[jnp.ndarray] = None


#: Broadie-Glasserman-Kou continuity-correction constant
#: ``-zeta(1/2)/sqrt(2 pi)``.
BGK_BETA = 0.5825971579390107


def european_call(strike, discount=1.0):
    return lambda pf: discount * jnp.maximum(pf.terminal - strike, 0.0)


def european_put(strike, discount=1.0):
    return lambda pf: discount * jnp.maximum(strike - pf.terminal, 0.0)


def asian_call(strike, discount=1.0):
    """Arithmetic-average Asian call on the discrete grid average."""
    return lambda pf: discount * jnp.maximum(pf.average - strike, 0.0)


def lookback_call(discount=1.0):
    """Floating-strike lookback: ``S_T - min_t S_t``."""
    return lambda pf: discount * (pf.terminal - pf.minimum)


def digital_call(strike, discount=1.0):
    """Cash-or-nothing: pays 1 if ``S_T > K``. Discontinuous — MLMC
    variance decays at beta ~ 1/2 per level (Giles 2008 §5.3); expect to
    need more levels/samples than the smooth payoffs."""
    return lambda pf: discount * (pf.terminal > strike).astype(
        pf.terminal.dtype)


def terminal_value():
    return lambda pf: pf.terminal


def _need_extras(pf, who):
    if pf.shifted_minimum is None:
        raise ValueError(
            f"{who} needs the continuous-monitoring functionals — set "
            "path_extras=True (and 'barrier' for knock-outs) in the "
            "SDE config")


def lookback_call_bb(discount=1.0):
    """Floating-strike lookback on the CONTINUOUS minimum: ``S_T -
    min_{[0,T]} S_t`` via the BGK-shifted grid minimum (weak error
    O(h) instead of the raw grid minimum's O(sqrt(h)); Giles 2008
    §5.2). Needs ``path_extras=True``."""

    def payoff(pf):
        _need_extras(pf, "lookback_call_bb")
        return discount * (pf.terminal - pf.shifted_minimum)

    return payoff


def barrier_call_down_out(strike, discount=1.0):
    """Down-and-out call under CONTINUOUS barrier monitoring:
    ``(S_T - K)+ * P[no crossing | grid nodes]`` with the product of
    per-step Brownian-bridge survival probabilities (Glasserman 2004
    §6.4; Giles 2008 §5.4) — smooth in the nodes, so the coupled MLMC
    corrections keep decaying where a 0/1 crossing indicator would
    stall at beta ~ 1/2. Needs ``path_extras=True`` and the
    ``barrier`` config key (the barrier enters the kernel)."""

    def payoff(pf):
        _need_extras(pf, "barrier_call_down_out")
        if pf.log_survival is None:
            raise ValueError("barrier_call_down_out needs the "
                             "'barrier' config key")
        return (discount * jnp.maximum(pf.terminal - strike, 0.0)
                * jnp.exp(pf.log_survival))

    return payoff


def digital_call_smoothed(strike, discount=1.0):
    """Cash-or-nothing call by CONDITIONAL EXPECTATION over the final
    step: ``Phi((mu - K)/sd)`` with the one-step Gaussian law from the
    penultimate node; the coarse path of a coupled level conditions on
    the shared fine increments up to its last fine substep (Giles 2008
    §5.3), so both smoothing widths are ``|b| sqrt(h_fine)`` — measured
    variance decay beta ~ 3/2 on Milstein GBM (an own-width coarse
    smoothing decorrelates near the strike and decays at only ~ 1/2;
    the tower property keeps the telescope exact either way). Needs
    ``path_extras=True``."""

    def payoff(pf):
        _need_extras(pf, "digital_call_smoothed")
        if pf.digital_mu is None:
            raise ValueError(
                "digital_call_smoothed is incompatible with drift_shift: "
                "the likelihood ratio depends on the final increment "
                "that the smoothing integrates out, so the weighted "
                "smoothed payoff would be biased — use digital_call (the "
                "raw indicator weights exactly) or drop the shift")
        z = (pf.digital_mu - strike) / pf.digital_sd
        return discount * 0.5 * (1.0 + jax.lax.erf(
            z * (1.0 / np.sqrt(2.0))))

    return payoff


def black_scholes_call(s0, strike, rate, sigma, T):
    """Closed-form Black-Scholes European call price (host helper for
    validating GBM MLMC runs with ``mu = rate`` and
    ``european_call(strike, discount=exp(-rate T))``)."""
    import scipy.stats as st

    if sigma <= 0 or T <= 0:
        return max(s0 - strike * np.exp(-rate * T), 0.0)
    d1 = (np.log(s0 / strike) + (rate + 0.5 * sigma ** 2) * T) \
        / (sigma * np.sqrt(T))
    d2 = d1 - sigma * np.sqrt(T)
    return float(s0 * st.norm.cdf(d1)
                 - strike * np.exp(-rate * T) * st.norm.cdf(d2))


def black_scholes_digital(s0, strike, rate, sigma, T):
    """Closed-form cash-or-nothing call price ``exp(-rT) Phi(d2)``."""
    import scipy.stats as st

    d2 = ((np.log(s0 / strike) + (rate - 0.5 * sigma ** 2) * T)
          / (sigma * np.sqrt(T)))
    return float(np.exp(-rate * T) * st.norm.cdf(d2))


def lookback_call_price(s0, rate, sigma, T):
    """Closed-form floating-strike lookback call ``E[e^{-rT}(S_T -
    min_{[0,T]} S_t)]`` (Goldman-Sosin-Gatto 1979), continuous
    monitoring, strike = running minimum from t=0."""
    import scipy.stats as st

    a1 = (rate + 0.5 * sigma ** 2) * np.sqrt(T) / sigma
    a2 = a1 - sigma * np.sqrt(T)
    k = 2.0 * rate / sigma ** 2
    # Hull's c_fl at S_min = S0 (Y1 = 0, N(-a3) = N(a2)):
    #   S0 [N(a1) - e^{-rT} N(a2) - N(-a1)/k + e^{-rT} N(a2)/k]
    return float(s0 * (st.norm.cdf(a1)
                       - np.exp(-rate * T) * st.norm.cdf(a2)
                       - st.norm.cdf(-a1) / k
                       + np.exp(-rate * T) * st.norm.cdf(a2) / k))


def barrier_down_out_call_price(s0, strike, barrier, rate, sigma, T):
    """Closed-form down-and-out call (continuous barrier ``B <= K``,
    ``B < s0``; Merton 1973): ``C(s0) - (s0/B)^(1 - 2r/sigma^2)
    C(B^2/s0)``."""
    if not (barrier < s0 and barrier <= strike):
        raise ValueError("formula needs barrier < s0 and "
                         "barrier <= strike")
    lam = 1.0 - 2.0 * rate / sigma ** 2
    return float(black_scholes_call(s0, strike, rate, sigma, T)
                 - (s0 / barrier) ** lam * black_scholes_call(
                     barrier ** 2 / s0, strike, rate, sigma, T))


# ---------------------------------------------------------------------- #
# coupled-path kernel
# ---------------------------------------------------------------------- #
def gbm_call_shift(mu, sigma, s0, strike, total_time):
    """Girsanov ``drift_shift`` centering a GBM's log-terminal at the
    strike — the standard importance-sampling tilt for deep
    out-of-the-money payoffs (Glasserman 2004 §4.6): under the shifted
    measure ``ln S_T ~ N(ln K, sigma^2 T)``, so roughly half the paths
    land in the money instead of ~Phi(d2) of them.

        theta = (ln(K/s0) - (mu - sigma^2/2) T) / (sigma T)
    """
    T = float(total_time)
    return float((np.log(strike / s0) - (mu - 0.5 * sigma ** 2) * T)
                 / (sigma * T))


def _scheme_increment(model, scheme, s, t, dw, dt):
    """One integration INCREMENT of a [B] state batch."""
    a = model.drift(s, t)
    b = model.diffusion(s, t)
    incr = a * dt + b * dw
    if scheme == "milstein":
        bp = model.diffusion_ds(s, t)
        incr = incr + 0.5 * b * bp * (dw * dw - dt)
    return incr


def _df_add(hi, lo, x):
    """Add ``x`` to the double-float pair ``(hi, lo)`` (two_sum + quick
    renormalization): the state keeps ~2x the mantissa bits, so path
    increments far below ``ulp(state)`` are never swallowed — the error
    that otherwise FLOORS deep-level corrections on f32 hardware (at
    ~1e6 steps the plain-f32 per-path noise reaches 1e-4-1e-3, orders
    above the true O(h) correction scale)."""
    s = hi + x
    b = s - hi
    err = (hi - (s - b)) + (x - b)
    lo = lo + err
    t = s + lo
    return t, lo - (t - s)


def _extras_step(model, ex, s_node, s_new, t, dt, cfg):
    """Advance the continuous-monitoring accumulators over one substep
    (node value ``s_node`` -> ``s_new``): BGK-shifted extrema at the
    new node, the barrier bridge log-survival over the interval, and
    the penultimate-node tracker."""
    prev, smn, smx, lsv = ex
    sqrt_dt, barrier, bdir = cfg
    b_new = jnp.abs(model.diffusion(s_new, t + dt))
    shift = BGK_BETA * sqrt_dt * b_new
    smn = jnp.minimum(smn, s_new - shift)
    smx = jnp.maximum(smx, s_new + shift)
    if barrier is not None:
        # bridge non-crossing probability over [s_node, s_new]: the
        # relu product is 0 when either node is past the barrier, so
        # p = 1 - exp(0) = 0 there by construction (log -> -inf)
        b = model.diffusion(s_node, t)
        b2 = jnp.maximum(b * b, 1e-30)
        d0 = jax.nn.relu(bdir * (s_node - barrier))
        d1 = jax.nn.relu(bdir * (s_new - barrier))
        p = 1.0 - jnp.exp(-2.0 * d0 * d1 / (b2 * dt))
        lsv = lsv + jnp.log(p)
    return (s_node, smn, smx, lsv)


def _run_substeps(model, scheme, state, dws, t0, dt, m, reverse, df,
                  extras_cfg=None):
    """Advance one path-functional carry through ``m`` unrolled substeps
    fed by the [B, m] increment block (reversed for the antithetic
    twin). ``df=False``: carry (s, sum, max, min); ``df=True``: carry
    (s_hi, s_lo, sum_hi, sum_lo, max, min) with double-float state and
    running-sum accumulation (coefficients still evaluate on the f32
    ``hi`` — the 2x-mantissa pair only needs to protect the ADDITIONS,
    which is where long-horizon f32 integration loses its accuracy).
    With ``extras_cfg`` the carry additionally holds the
    continuous-monitoring accumulators (prev node, shifted min/max,
    barrier log-survival) appended as a 4-tuple."""
    ex = None
    if extras_cfg is not None:
        state, ex = state[:-4], state[-4:]
    if not df:
        s, sm, mx, mn = state
        for i in range(m):
            dw = dws[:, m - 1 - i] if reverse else dws[:, i]
            t = t0 + i * dt
            s_new = s + _scheme_increment(model, scheme, s, t, dw, dt)
            if ex is not None:
                ex = _extras_step(model, ex, s, s_new, t, dt, extras_cfg)
            s = s_new
            sm = sm + s
            mx = jnp.maximum(mx, s)
            mn = jnp.minimum(mn, s)
        out = (s, sm, mx, mn)
        return out if ex is None else out + ex
    s, sl, sm, sml, mx, mn = state
    for i in range(m):
        dw = dws[:, m - 1 - i] if reverse else dws[:, i]
        t = t0 + i * dt
        incr = _scheme_increment(model, scheme, s, t, dw, dt)
        s_node = s
        s, sl = _df_add(s, sl, incr)
        if ex is not None:
            ex = _extras_step(model, ex, s_node, s, t, dt, extras_cfg)
        sm, sml = _df_add(sm, sml, s)
        sm, sml = _df_add(sm, sml, sl)
        mx = jnp.maximum(mx, s)
        mn = jnp.minimum(mn, s)
    out = (s, sl, sm, sml, mx, mn)
    return out if ex is None else out + ex


def coupled_path_functionals(config, keys=None, z=None):
    """Integrate a coupled (fine, coarse) level batch and return its path
    functionals.

    :param config: dict with ``model`` (SDEModel), ``scheme``
        ('euler' | 'milstein'), ``total_time``, ``n_fine``, ``n_coarse``
        (0 on level 0), ``antithetic`` (bool)
    :param keys: [B] PRNG keys — increments derive counter-style inside
        the scan (``normal(fold_in(key, coarse_step))``), nothing [B, T]
        is materialized
    :param z: alternatively, explicit standard-normal increments
        [B, n_fine] (the QMC path; mutually exclusive with ``keys``)

    Extra config keys: ``precision`` — ``'float'`` (default, native
    dtype) or ``'df64'`` (double-float state/sum accumulation: protects
    long-horizon integration on f32 hardware, where plain-f32 per-path
    rounding noise floors at ~1e-4 around 1e6 steps — required for the
    deep levels of :class:`~mlmc_tpu.unbiased.UnbiasedMLMC`); ``dtype``
    — element dtype override for the keys path; ``drift_shift`` —
    Girsanov importance-sampling tilt ``theta`` (constant): paths
    integrate under the drift ``a + b*theta`` and
    :attr:`PathFunctionals.log_weight` carries the EXACT log
    likelihood-ratio ``-theta W_T - theta^2 T/2`` (a function of the
    shared raw-increment sum, so fine/coarse/antithetic all weight by
    the same factor and the telescope stays consistent; see
    :func:`gbm_call_shift` for the classic deep-OTM tilt).

    :return: (fine, fine_antithetic | None, coarse | None) as
        :class:`PathFunctionals`
    """
    model = config["model"]
    scheme = config.get("scheme", "euler")
    if scheme not in ("euler", "milstein"):
        raise ValueError("scheme must be 'euler' or 'milstein'")
    if scheme == "milstein" and model.diffusion_ds is None:
        raise ValueError("Milstein needs SDEModel.diffusion_ds")
    precision = config.get("precision", "float")
    if precision not in ("float", "df64"):
        raise ValueError("precision must be 'float' or 'df64'")
    df = precision == "df64"
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
    anti = bool(config.get("antithetic", False)) and m > 1
    theta = float(config.get("drift_shift", 0.0) or 0.0)
    if not np.isfinite(theta):
        raise ValueError("drift_shift must be finite")

    if (keys is None) == (z is None):
        raise ValueError("pass exactly one of keys / z")
    if z is not None:
        if z.ndim != 2 or z.shape[1] != n_f:
            # dynamic_slice would silently CLAMP a too-narrow z, reusing
            # the last increments — a correctness trap, not a shape error
            raise ValueError("z must be [B, n_fine=%d], got %s"
                             % (n_f, z.shape))
        dtype = z.dtype
        B = z.shape[0]
        sqrt_dt = jnp.asarray(np.sqrt(dt_f), dtype)

        def dw_at(c):
            return sqrt_dt * jax.lax.dynamic_slice_in_dim(z, c * m, m, 1)
    else:
        dtype = jnp.dtype(config["dtype"]) if "dtype" in config \
            else jnp.result_type(float)
        B = keys.shape[0]
        sqrt_dt = jnp.asarray(np.sqrt(dt_f), dtype)

        def dw_at(c):
            return sqrt_dt * jax.vmap(
                lambda k: jax.random.normal(jax.random.fold_in(k, c), (m,),
                                            dtype))(keys)

    extras = bool(config.get("path_extras", False))
    barrier = config.get("barrier")
    if barrier is not None and not extras:
        raise ValueError("'barrier' needs path_extras=True")
    bdir = {"down": 1.0, "up": -1.0}[config.get("barrier_type", "down")]

    s0 = jnp.full((B,), model.s0, dtype)
    zero = jnp.zeros((B,), dtype)
    if df:
        init = (s0, zero, zero, zero, s0, s0)
    else:
        init = (s0, zero, s0, s0)    # (state, sum-of-nodes, max, min)
    if extras:
        def init_ex(sqrt_dt):
            shift0 = BGK_BETA * sqrt_dt * jnp.abs(
                model.diffusion(s0, jnp.zeros((), dtype)))
            return init + (s0, s0 - shift0, s0 + shift0, zero)

        cfg_f = (jnp.asarray(np.sqrt(dt_f), dtype), barrier, bdir)
        cfg_c = (jnp.asarray(np.sqrt(dt_c), dtype), barrier, bdir)
        init_f, init_c = init_ex(cfg_f[0]), init_ex(cfg_c[0])
    else:
        cfg_f = cfg_c = None
        init_f = init_c = init

    def body(carry, c):
        fine, fine_a, coarse, dwh, wsum = carry
        dws = dw_at(c)               # [B, m]
        if theta:
            # Girsanov: simulate under the shifted drift a + b*theta by
            # feeding dW + theta*dt into the SCHEME (Euler and the
            # Milstein correction alike see the driving increment of
            # the shifted representation); the raw-increment sum wsum
            # carries the exact log likelihood-ratio
            # -theta*W_T - theta^2 T/2 — a function of W_T alone, so
            # fine, coarse and the antithetic twin share ONE weight and
            # the telescope stays exactly consistent.
            wsum = wsum + jnp.sum(dws, axis=1)
            dws = dws + jnp.asarray(theta * dt_f, dtype)
        t0 = c.astype(dtype) * dt_c
        fine = _run_substeps(model, scheme, fine, dws, t0, dt_f, m, False,
                             df, cfg_f)
        if anti:
            fine_a = _run_substeps(model, scheme, fine_a, dws, t0, dt_f, m,
                                   True, df, cfg_f)
        if not is_l0:
            coarse = _run_substeps(model, scheme, coarse,
                                   jnp.sum(dws, axis=1, keepdims=True),
                                   t0, dt_c, 1, False, df, cfg_c)
            if extras:
                # the final trip's value survives the scan: the fine
                # Brownian increment over the first m-1 substeps of the
                # LAST coarse step, conditioning the coarse digital
                # smoothing (Giles 2008 §5.3)
                dwh = jnp.sum(dws[:, :m - 1], axis=1)
        return (fine, fine_a, coarse, dwh, wsum), None

    steps = jnp.arange(trips)        # int: feeds fold_in / dynamic_slice
    (fine, fine_a, coarse, dwh, wsum), _ = jax.lax.scan(
        body, (init_f, init_f, init_c, zero, zero), steps)
    logw = None
    if theta:
        logw = -theta * wsum - jnp.asarray(0.5 * theta * theta * T, dtype)

    def functionals(st, n_nodes, dt, dw_head=None):
        ex = None
        if extras:
            st, ex = st[:-4], st[-4:]
        if df:
            s, sl, sm, sml, mx, mn = st
            s = s + sl
            sm = sm + sml
        else:
            s, sm, mx, mn = st
        kw = {}
        if ex is not None:
            prev, smn, smx, lsv = ex
            # digital conditional-expectation law of the terminal given
            # the penultimate node — and, for the COARSE path, given the
            # fine increments over all but the last fine substep of its
            # final step (Giles 2008 §5.3): both paths' smoothing widths
            # are then b*sqrt(h_fine), and the tower property makes the
            # coarse functional's mean EXACTLY the previous level's fine
            # one (E_W[Phi((x + bW)/(b sqrt(hf)))] = Phi(x/(b sqrt(hc)))
            # for W ~ N(0, hc - hf))
            t_pen = jnp.asarray(T - dt, dtype)
            b_pen = model.diffusion(prev, t_pen)
            mu = prev + model.drift(prev, t_pen) * dt
            if dw_head is not None:
                mu = mu + b_pen * dw_head
            sd = jnp.abs(b_pen) * np.sqrt(dt_f)
            kw = dict(shifted_minimum=smn, shifted_maximum=smx,
                      log_survival=lsv if barrier is not None else None,
                      digital_mu=mu,
                      digital_sd=jnp.maximum(sd, 1e-30))
            if theta:
                # the BGK extrema shift and the bridge survival are
                # conditional expectations given ALL grid increments —
                # the log-LR is increments-measurable, so weighting
                # stays exact. The digital smoothing is NOT: it
                # integrates out the FINAL increment, which the LR also
                # depends on, so E[LR * 1{.}] != LR_partial * Phi(.) —
                # disabled loudly (digital_call_smoothed explains).
                kw["digital_mu"] = kw["digital_sd"] = None
        return PathFunctionals(terminal=s, average=(s0 + sm) / (n_nodes + 1),
                               maximum=mx, minimum=mn, log_weight=logw,
                               **kw)

    return (functionals(fine, n_f, dt_f),
            functionals(fine_a, n_f, dt_f) if anti else None,
            None if is_l0 else functionals(coarse, n_c, dt_c, dwh))


# ---------------------------------------------------------------------- #
# Simulation integration
# ---------------------------------------------------------------------- #
class SDESimulation(Simulation):
    """MLMC over SDE paths under the standard Simulation contract: level
    parameters are time steps ``[h]``, ``n_l = round(T / h_l)``, the
    coupling shares one Brownian path, and the payoff (or the raw path
    functionals) is the stored QoI.

    Config keys:

    * ``model``: :class:`SDEModel` (or ``'gbm' | 'ou' | 'cir'`` with
      defaults)
    * ``total_time``: horizon T (default 1.0)
    * ``scheme``: ``'euler'`` (default) or ``'milstein'``
    * ``payoff``: callable ``PathFunctionals -> [B]`` (default terminal
      value)
    * ``antithetic``: Giles-Szpruch twin-path fine estimator (default
      False; payoff QoI only — averaging FUNCTIONALS before a nonlinear
      payoff would bias the telescope)
    * ``qoi``: ``'payoff'`` (default) or ``'functionals'`` — the latter
      stores (terminal, average, maximum, minimum) so payoffs can be
      composed post-hoc in the Quantity algebra
    * ``drift_shift``: Girsanov importance-sampling tilt (see
      :func:`coupled_path_functionals`); payoff QoIs are weighted by
      ``exp(log_weight)`` in-kernel, functionals QoIs store
      ``log_weight`` as a fifth quantity for post-hoc composition
    """

    _MODELS = {"gbm": gbm, "ou": ornstein_uhlenbeck, "cir": cir}

    def __init__(self, config=None):
        super().__init__()
        config = dict(config or {})
        model = config.get("model", "gbm")
        if isinstance(model, str):
            model = self._MODELS[model.lower()]()
        config["model"] = model
        config.setdefault("total_time", 1.0)
        config.setdefault("scheme", "euler")
        config.setdefault("payoff", terminal_value())
        config.setdefault("antithetic", False)
        config.setdefault("qoi", "payoff")
        if config["qoi"] not in ("payoff", "functionals"):
            raise ValueError("qoi must be 'payoff' or 'functionals'")
        if config["qoi"] == "functionals" and config["antithetic"]:
            raise ValueError(
                "antithetic applies to payoff QoIs: the twin paths must be "
                "averaged AFTER the payoff, which post-hoc composition "
                "cannot do")
        self.config = config
        self.need_workspace = False

    # -------------------------------------------------------------- #
    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]) -> LevelSimulation:
        T = float(self.config["total_time"])
        n_f = int(round(T / float(fine_level_params[0])))
        h_c = float(coarse_level_params[0])
        n_c = 0 if h_c == 0 else int(round(T / h_c))
        if n_f < 1 or (n_c and (n_f % n_c or n_f <= n_c)):
            raise ValueError(
                "fine step must refine the coarse step by an integer "
                "factor > 1 (got n_fine=%d, n_coarse=%d)" % (n_f, n_c))
        config = dict(self.config, n_fine=n_f, n_coarse=n_c,
                      res_format=self.result_format())
        return LevelSimulation(config_dict=config,
                               task_size=self.n_ops_estimate(
                                   fine_level_params[0]),
                               nan_result_is_failure=False)

    # -------------------------------------------------------------- #
    @staticmethod
    def _assemble(config, pf, pf_anti):
        """Apply the payoff (averaging the antithetic twin) or stack the
        functionals; returns a [B, M] result block."""
        if config["qoi"] == "payoff":
            payoff = config["payoff"]
            v = payoff(pf)
            if pf_anti is not None:
                v = 0.5 * (v + payoff(pf_anti))
            if pf.log_weight is not None:
                # Girsanov weight — shared by the antithetic twin (same
                # raw-increment sum), so weighting after averaging is
                # exact
                v = v * jnp.exp(pf.log_weight)
            return v[:, None]
        cols = [pf.terminal, pf.average, pf.maximum, pf.minimum]
        if pf.log_weight is not None:
            # post-hoc Quantity-algebra composition needs the weight as
            # its own stored quantity: exp(log_weight) * payoff(...)
            cols.append(pf.log_weight)
        return jnp.stack(cols, axis=1)

    @staticmethod
    def calculate_batch(config, keys, attempts=None):
        """Level batch: keys [B] -> (fine [B, M], coarse [B, M], failed [B]).

        NaN/inf results (a model escaping its domain) are stored and
        masked during estimation, like the shooting sims' out-of-border
        paths — never failed samples.
        """
        pf_f, pf_fa, pf_c = coupled_path_functionals(config, keys=keys)
        fine = SDESimulation._assemble(config, pf_f, pf_fa)
        if pf_c is None:
            coarse = jnp.zeros_like(fine)
        else:
            coarse = SDESimulation._assemble(config, pf_c, None)
        return fine, coarse, jnp.zeros(fine.shape[0], dtype=bool)

    @staticmethod
    def calculate(config, seed):
        """Host single-sample path (reference calculate contract)."""
        key = jax.random.key(np.uint32(seed))
        fine, coarse, _ = SDESimulation.calculate_batch(config, key[None])
        return np.asarray(fine[0]), np.asarray(coarse[0])

    # -------------------------------------------------------------- #
    def n_ops_estimate(self, step):
        return float(self.config["total_time"]) / float(step)

    def result_format(self) -> List[QuantitySpec]:
        T = self.config["total_time"]
        if self.config["qoi"] == "payoff":
            return [QuantitySpec(name="payoff", unit="1", shape=(1,),
                                 times=[T], locations=["-"])]
        names = ["terminal", "average", "maximum", "minimum"]
        if self.config.get("drift_shift"):
            names.append("log_weight")
        return [QuantitySpec(name=n, unit="1", shape=(1,), times=[T],
                             locations=["-"])
                for n in names]


# ---------------------------------------------------------------------- #
# multi-dimensional systems
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SDESystem:
    """Vector SDE ``dS = drift(S, t) dt + diffusion(S, t) dW`` with state
    ``S in R^dim`` and ``n_drivers`` independent Brownian drivers
    (correlations live INSIDE the diffusion matrix — mix the columns).

    :param drift: ``(s [B, dim], t) -> [B, dim]`` pure jnp
    :param diffusion: ``(s [B, dim], t) -> [B, dim, n_drivers]``
    :param s0: initial state, length ``dim``
    """

    drift: Callable
    diffusion: Callable
    s0: Tuple = (1.0,)
    n_drivers: int = 1

    @property
    def dim(self):
        return len(self.s0)


def heston(mu=0.05, kappa=2.0, theta=0.04, xi=0.3, rho=-0.7,
           s0=1.0, v0=0.04):
    """Heston stochastic-volatility model (Heston 1993)

        ``dS = mu S dt + sqrt(v) S dW_1``
        ``dv = kappa (theta - v) dt + xi sqrt(v) (rho dW_1 +
        sqrt(1-rho^2) dW_2)``

    in full-truncation Euler form (``v`` enters coefficients as
    ``max(v, 0)``; Lord, Koekkoek & van Dijk 2010). The driver
    correlation is folded into the diffusion matrix, so the kernel's
    ``dW`` stays i.i.d. standard. Validate against
    :func:`heston_call_price`."""
    sq1 = float(np.sqrt(1.0 - rho ** 2))

    def drift(s, t):
        v = jnp.maximum(s[..., 1], 0.0)
        return jnp.stack([mu * s[..., 0], kappa * (theta - v)], axis=-1)

    def diffusion(s, t):
        sv = jnp.sqrt(jnp.maximum(s[..., 1], 0.0))
        zero = jnp.zeros_like(sv)
        row_s = jnp.stack([sv * s[..., 0], zero], axis=-1)
        row_v = jnp.stack([xi * rho * sv, xi * sq1 * sv], axis=-1)
        return jnp.stack([row_s, row_v], axis=-2)      # [B, 2, 2]

    return SDESystem(drift=drift, diffusion=diffusion, s0=(s0, v0),
                     n_drivers=2)


def heston_call_price(s0, strike, rate, kappa, theta, xi, rho, v0, T):
    """Semi-analytic Heston European call via the Gil-Pelaez inversion of
    the 'little Heston trap' characteristic function (Albrecher, Mayer,
    Schoutens & Tistaert 2007) — the host-side validation anchor for the
    MLMC Heston runs. Risk-neutral drift ``mu = rate``."""
    from scipy.integrate import quad

    def phi(u, j):
        # j=1: measure under S numeraire (b = kappa - rho xi), j=2: plain
        a = kappa * theta
        b = kappa - rho * xi if j == 1 else kappa
        up = 0.5 if j == 1 else -0.5
        d = np.sqrt((rho * xi * 1j * u - b) ** 2
                    - xi ** 2 * (2 * up * 1j * u - u ** 2))
        g = (b - rho * xi * 1j * u - d) / (b - rho * xi * 1j * u + d)
        exp_dT = np.exp(-d * T)
        C = (rate * 1j * u * T + a / xi ** 2 * (
            (b - rho * xi * 1j * u - d) * T
            - 2 * np.log((1 - g * exp_dT) / (1 - g))))
        D = ((b - rho * xi * 1j * u - d) / xi ** 2
             * (1 - exp_dT) / (1 - g * exp_dT))
        return np.exp(C + D * v0 + 1j * u * np.log(s0))

    def prob(j):
        integrand = lambda u: (np.exp(-1j * u * np.log(strike))
                               * phi(u, j) / (1j * u)).real
        return 0.5 + quad(integrand, 1e-10, 200.0, limit=400)[0] / np.pi

    return float(s0 * prob(1) - strike * np.exp(-rate * T) * prob(2))


def _system_step(model, s, t, dw, dt):
    """Euler-Maruyama step for a [B, dim] state batch; dw [B, n_drivers]."""
    a = model.drift(s, t)
    b = model.diffusion(s, t)
    return s + a * dt + jnp.einsum("bkm,bm->bk", b, dw)


def coupled_system_functionals(config, keys):
    """Vector analogue of :func:`coupled_path_functionals` (Euler scheme;
    per-component path functionals with [B, dim] leaves). The antithetic
    twin reverses each coarse interval's [refine, n_drivers] increment
    BLOCK in time (driver columns stay aligned — the twin must share the
    same marginal law per substep)."""
    model = config["model"]
    if config.get("drift_shift"):
        raise ValueError("drift_shift (Girsanov importance sampling) is "
                         "scalar-SDE only for now")
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
    anti = bool(config.get("antithetic", False)) and m > 1
    dtype = jnp.result_type(float)
    B = keys.shape[0]
    nd = model.n_drivers
    sqrt_dt = jnp.asarray(np.sqrt(dt_f), dtype)

    s0 = jnp.broadcast_to(jnp.asarray(model.s0, dtype), (B, model.dim))
    zero = jnp.zeros_like(s0)
    init = (s0, zero, s0, s0)

    def substeps(state, dws, t0, reverse):
        s, sm, mx, mn = state
        for i in range(m):
            dw = dws[:, m - 1 - i] if reverse else dws[:, i]
            s = _system_step(model, s, t0 + i * dt_f, dw, dt_f)
            sm = sm + s
            mx = jnp.maximum(mx, s)
            mn = jnp.minimum(mn, s)
        return (s, sm, mx, mn)

    def body(carry, c):
        fine, fine_a, coarse = carry
        dws = sqrt_dt * jax.vmap(
            lambda k: jax.random.normal(jax.random.fold_in(k, c), (m, nd),
                                        dtype))(keys)       # [B, m, nd]
        t0 = c.astype(dtype) * dt_c
        fine = substeps(fine, dws, t0, False)
        if anti:
            fine_a = substeps(fine_a, dws, t0, True)
        if not is_l0:
            s, sm, mx, mn = coarse
            s = _system_step(model, s, t0, jnp.sum(dws, axis=1), dt_c)
            coarse = (s, sm + s, jnp.maximum(mx, s), jnp.minimum(mn, s))
        return (fine, fine_a, coarse), None

    (fine, fine_a, coarse), _ = jax.lax.scan(body, (init, init, init),
                                             jnp.arange(trips))

    def functionals(st, n_nodes):
        s, sm, mx, mn = st
        return PathFunctionals(terminal=s, average=(s0 + sm) / (n_nodes + 1),
                               maximum=mx, minimum=mn)

    return (functionals(fine, n_f),
            functionals(fine_a, n_f) if anti else None,
            None if is_l0 else functionals(coarse, n_c))


class SDESystemSimulation(SDESimulation):
    """MLMC over vector SDE paths (Euler-Maruyama): same contract as
    :class:`SDESimulation` but ``model`` is an :class:`SDESystem` and
    payoffs act on [B, dim]-leaved :class:`PathFunctionals` (e.g.
    ``lambda pf: jnp.maximum(pf.terminal[:, 0] - K, 0.0)`` for a Heston
    call on the asset component). ``qoi='functionals'`` stores all four
    functionals of every component (4*dim quantities)."""

    _MODELS = {"heston": heston}

    def __init__(self, config=None):
        config = dict(config or {})
        config.setdefault("scheme", "euler")
        if config["scheme"] != "euler":
            raise ValueError(
                "systems integrate with Euler-Maruyama (general Milstein "
                "needs Levy areas; use the scalar SDESimulation for "
                "scalar Milstein)")
        super().__init__(config)

    @staticmethod
    def _assemble(config, pf, pf_anti):
        if config["qoi"] == "payoff":
            payoff = config["payoff"]
            v = payoff(pf)
            if pf_anti is not None:
                v = 0.5 * (v + payoff(pf_anti))
            return v[:, None]
        return jnp.concatenate([pf.terminal, pf.average, pf.maximum,
                                pf.minimum], axis=1)

    @staticmethod
    def calculate_batch(config, keys, attempts=None):
        pf_f, pf_fa, pf_c = coupled_system_functionals(config, keys)
        fine = SDESystemSimulation._assemble(config, pf_f, pf_fa)
        if pf_c is None:
            coarse = jnp.zeros_like(fine)
        else:
            coarse = SDESystemSimulation._assemble(config, pf_c, None)
        return fine, coarse, jnp.zeros(fine.shape[0], dtype=bool)

    @staticmethod
    def calculate(config, seed):
        key = jax.random.key(np.uint32(seed))
        fine, coarse, _ = SDESystemSimulation.calculate_batch(config,
                                                              key[None])
        return np.asarray(fine[0]), np.asarray(coarse[0])

    def result_format(self) -> List[QuantitySpec]:
        T = self.config["total_time"]
        if self.config["qoi"] == "payoff":
            return [QuantitySpec(name="payoff", unit="1", shape=(1,),
                                 times=[T], locations=["-"])]
        dim = self.config["model"].dim
        return [QuantitySpec(name=n, unit="1", shape=(dim,), times=[T],
                             locations=["-"])
                for n in ("terminal", "average", "maximum", "minimum")]


# ---------------------------------------------------------------------- #
# quasi-Monte Carlo adapter
# ---------------------------------------------------------------------- #
def brownian_bridge_increments(n):
    """Brownian-bridge construction matrix ``R [n, n]``: for BB-ordered
    i.i.d. standard normals ``z`` (dimension 0 = the terminal value, then
    breadth-first midpoints), ``z @ R.T`` are the n standard-normal PATH
    increments. ``R @ R.T = I`` exactly (the bridge is an orthogonal
    re-parametrization), but the low-index dimensions carry the path's
    large-scale structure — which is what makes Sobol' points effective
    on path integrals (Moskowitz & Caflisch 1996).
    """
    n = int(n)
    rows = np.zeros((n + 1, n))       # W(t_i)/sqrt(dt) as combos of z
    rows[n, 0] = np.sqrt(n)
    k = 1
    queue = deque([(0, n)])
    while queue:
        lo, hi = queue.popleft()
        if hi - lo < 2:
            continue
        mid = (lo + hi) // 2
        rows[mid] = ((hi - mid) * rows[lo] + (mid - lo) * rows[hi]) \
            / (hi - lo)
        rows[mid, k] += np.sqrt((mid - lo) * (hi - mid) / (hi - lo))
        k += 1
        queue.append((lo, mid))
        queue.append((mid, hi))
    return np.diff(rows, axis=0)


def sde_qmc_level_fns(sim, level_parameters, bridge=True):
    """QMC level functions for :class:`SDESimulation`: each point
    dimension drives one Brownian increment of the fine path (the coarse
    path consumes their sums — the same coupling as the MC path), with an
    optional Brownian-bridge reordering so the leading Sobol' dimensions
    set the terminal value and the large-scale path shape.

    The payoff QoI must be finite everywhere (QMC points cannot be
    dropped without bias — MLQMC.extend raises loudly otherwise).

    :param sim: an :class:`SDESimulation` (``qoi='payoff'``)
    :param level_parameters: as for Sampler (``[[h0], [h1], ...]``)
    :param bridge: route points through the Brownian-bridge matrix
        (one [n, n] matmul per batch); False = raw increment order
    :return: (level_fns, dims) for :class:`~mlmc_tpu.qmc.MLQMC`
    """
    if sim.config["qoi"] != "payoff":
        raise ValueError("QMC drives scalar payoffs; build the sim with "
                         "qoi='payoff'")
    fns, dims = [], []
    for lev, params in enumerate(level_parameters):
        coarse = [0] if lev == 0 else level_parameters[lev - 1]
        cfg = sim.level_instance(params, coarse).config_dict
        n_f = cfg["n_fine"]
        R = brownian_bridge_increments(n_f) if bridge else None

        def fn(u, cfg=cfg, R=R):
            z = jax.scipy.special.ndtri(u)
            if R is not None:
                z = jnp.matmul(z, jnp.asarray(R.T, z.dtype),
                               precision=jax.lax.Precision.HIGHEST)
            pf_f, pf_fa, pf_c = coupled_path_functionals(cfg, z=z)
            fine = SDESimulation._assemble(cfg, pf_f, pf_fa)[:, 0]
            if pf_c is None:
                return fine, jnp.zeros_like(fine)
            return fine, SDESimulation._assemble(cfg, pf_c, None)[:, 0]

        fns.append(fn)
        dims.append(n_f)
    return fns, dims
