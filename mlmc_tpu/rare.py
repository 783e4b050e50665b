"""Rare-event probability estimation by subset simulation —
beyond-reference tier.

Estimates tail probabilities ``P[g(theta) > gamma]`` that are far too
small for plain Monte Carlo (1e-5 .. 1e-12) at O(log 1/P) cost: subset
simulation (Au & Beck, "Estimation of small failure probabilities in
high dimensions by subset simulation", Prob. Eng. Mech. 16, 2001)
factors the rare event through an adaptive ladder of intermediate
thresholds

    P[g > gamma] = prod_j P[g > gamma_{j+1} | g > gamma_j],

each conditional probability ~``p0`` (default 0.1) estimated from a
population kept in the conditional distribution by MCMC. Structurally
this is the SMC sampler of mlmc_tpu/smc.py with indicator potentials:
resample the exceeders, rejuvenate with CONDITIONAL pCN moves — the pCN
proposal preserves the N(0, I) prior exactly, so the Metropolis accept
is simply ``g(proposal) > gamma_j`` (Papaioannou et al. 2015, "MCMC
algorithms for subset simulation").

The reference framework has no rare-event capability; its nearest tool
(and this module's natural companion) is the multilevel CDF estimator
(mlmc_tpu/cdf_estimate.py), which telescopes DISCRETIZATION bias of
moderate tail probabilities — subset simulation handles SMALLNESS.
Compose them by subset-simulating the finest model and correcting with
coupled coarse levels, or simply by choosing ``g`` as the finest-level
functional (the per-stage populations are device batches, so fine
solves are cheap).

Device-first design: the population IS the device batch, shaped
``[n_islands, m]``. Each stage is ONE jitted program — systematic
resampling of the per-island exceeders + a ``lax.scan`` of conditional
pCN moves — with the per-island thresholds an OPERAND (one executable
serves every stage). Only the [I, m] response vector crosses to the
host per stage, where the next thresholds are read off island
quantiles: a decision, not a computation. Error bars are across-island
CLT errors (populations interact through resampling, so the naive
binomial variance understates the error; islands are independent end
to end).
"""
import time
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["subset_simulation", "cross_entropy_is"]


def subset_simulation(g_fn: Callable, gamma: float, d: int,
                      n_particles: int = 2048, p0: float = 0.1,
                      n_moves: int = 6, beta: float = 0.5, key=None,
                      max_stages: int = 60, prior_sampler=None,
                      qoi_fn: Optional[Callable] = None, dtype=None,
                      n_islands: int = 8):
    """Estimate ``P[g_fn(theta) > gamma]`` under a N(0, I_d) prior.

    :param g_fn: ``theta [d] -> scalar`` response, pure jnp (vmapped
        over the population). For a non-Gaussian prior, absorb the
        transform into ``g_fn`` (e.g. uniform: ``Phi(theta)``) — the
        conditional pCN kernel is exact only for the standard normal.
    :param gamma: the rare threshold.
    :param p0: per-stage conditional probability level (the ladder
        steps at the per-island (1-p0) population quantile).
    :param n_moves: conditional pCN rejuvenation sweeps per stage.
        ``beta`` is Robbins-Monro-adapted ON DEVICE after every sweep
        toward the 0.44 acceptance recommended for conditional sampling
        (Papaioannou et al. 2015), carrying across rungs.
    :param prior_sampler: optional ``key -> theta [N, d]`` override for
        the initial population (must still be N(0, I) for the kernel to
        be exact; use this only to inject antithetic/QMC initial draws).
    :param qoi_fn: optional ``theta [d] -> q [q]``; when given, the
        returned dict carries the conditional expectation
        ``E[qoi | g > gamma]`` with island errors — the "what does the
        failure domain look like" diagnostic.
    :return: dict with ``p`` (the probability), ``log_p``, ``log_p_se``
        (across-island CLT error of log p), ``p_lo``/``p_hi`` (1-sigma
        band), ``thresholds`` (the adaptive ladder), ``acc_rates``,
        ``n_forward``, ``cond_qoi``/``cond_qoi_se`` (when ``qoi_fn``),
        ``theta`` [N, d] final conditional population, ``wall_s``.
    """
    if key is None:
        key = jax.random.key(0)
    dtype = dtype or jnp.asarray(1.0).dtype
    if n_particles % n_islands:
        raise ValueError(f"n_particles must be divisible by {n_islands} "
                         "(islands)")
    if not 0.0 < p0 < 1.0:
        raise ValueError("p0 must be in (0, 1)")
    m = n_particles // n_islands
    if int(np.ceil((1.0 - p0) * m)) >= m:
        raise ValueError("p0 too small for the island size: need "
                         f"p0 * {m} >= 1 exceeder per island")
    batch_g = jax.vmap(g_fn)

    k_init, k_run = jax.random.split(key)
    if prior_sampler is not None:
        theta0 = prior_sampler(k_init)
    else:
        theta0 = jax.random.normal(k_init, (n_particles, d), dtype=dtype)
    theta = jnp.asarray(theta0, dtype).reshape(n_islands, m, d)

    def flat_g(theta):
        return batch_g(theta.reshape(n_islands * m, d)).reshape(
            n_islands, m)

    def resample_exceeders(g, thr, k):
        """Systematic resampling of the per-island exceeder sets
        (uniform weights on {g > thr}); g [I, m], thr [I] -> idx [I, m].
        """
        w = (g > thr[:, None]).astype(dtype)
        w = w / jnp.sum(w, axis=1, keepdims=True)
        cum = jnp.cumsum(w, axis=1)
        u = (jax.random.uniform(k, (n_islands, 1), dtype)
             + jnp.arange(m, dtype=dtype)[None, :]) / m
        idx = jax.vmap(lambda c, uu: jnp.searchsorted(c, uu))(cum, u)
        return jnp.clip(idx, 0, m - 1)

    @jax.jit
    def stage(theta, g, thr, beta0, k):
        """One subset stage at per-island thresholds thr [I]: resample
        the exceeders, then n_moves conditional pCN sweeps (accept iff
        the proposal still exceeds — pCN preserves the prior). beta
        adapts ON DEVICE after each sweep (Robbins-Monro on logit(beta)
        toward the 0.44 conditional-sampling target, Papaioannou et al.
        2015) and carries across rungs."""
        k_r, k_m = jax.random.split(k)
        idx = resample_exceeders(g, thr, k_r)
        theta = jnp.take_along_axis(theta, idx[:, :, None], axis=1)
        g = jnp.take_along_axis(g, idx, axis=1)

        def move(carry, kk):
            th, g_c, beta_c, acc = carry
            xi = jax.random.normal(kk, th.shape, dtype)
            prop = (jnp.sqrt(1.0 - beta_c * beta_c) * th + beta_c * xi)
            g_p = flat_g(prop)
            accept = g_p > thr[:, None]
            th = jnp.where(accept[:, :, None], prop, th)
            g_c = jnp.where(accept, g_p, g_c)
            a = jnp.mean(accept.astype(dtype))
            logit = jnp.log(beta_c) - jnp.log1p(-beta_c)
            beta_c = jax.nn.sigmoid(logit + 0.5 * (a - 0.44))
            return (th, g_c, beta_c, acc + a), None

        (theta, g, beta_c, acc), _ = jax.lax.scan(
            move, (theta, g, beta0, jnp.zeros((), dtype)),
            jax.random.split(k_m, n_moves))
        return theta, g, acc / n_moves, beta_c

    t0 = time.perf_counter()
    g = flat_g(theta)
    g_h = np.asarray(jax.device_get(g), dtype=np.float64)
    log_p_island = np.zeros(n_islands)
    done = np.zeros(n_islands, dtype=bool)
    thresholds, acc_rates = [], []
    beta_c = float(beta)
    n_fwd = n_particles
    for stage_i in range(max_stages):
        # per-island ladder step: the (1-p0) quantile, capped at gamma
        thr = np.minimum(np.quantile(g_h, 1.0 - p0, axis=1), gamma)
        frac = np.mean(g_h > thr[:, None], axis=1)
        reached = thr >= gamma
        newly = reached & ~done
        if np.any(frac[newly] <= 0):
            # quantile >= gamma yet no STRICT exceeders: the response
            # ties at gamma (e.g. clipped at the threshold) — the
            # conditional kernel and the final refresh would divide by
            # zero; fail loudly rather than return p ~ 0 silently
            raise RuntimeError(
                "an island reached gamma with zero strict exceeders — "
                "the response ties at the threshold (clipped?); use a "
                "strictly smaller gamma or perturb the response")
        # islands finishing this stage: final conditional factor
        log_p_island[newly] += np.log(frac[newly])
        done |= reached
        if done.all():
            thresholds.append(float(gamma))
            break
        if np.any(frac[~done] <= 0):
            raise RuntimeError(
                "an island lost all exceeders — increase n_particles or "
                "p0 (per-island quantile produced an empty subset)")
        # continuing islands accumulate their ~p0 factor; finished
        # islands keep moving at gamma (their estimate is frozen, the
        # moves only enrich the conditional population)
        log_p_island[~done] += np.log(frac[~done])
        thr[done] = gamma
        thresholds.append(float(np.median(thr)))
        theta, g, acc, beta_d = stage(theta, g, jnp.asarray(thr, dtype),
                                      jnp.asarray(beta_c, dtype),
                                      jax.random.fold_in(k_run, stage_i))
        n_fwd += n_particles * n_moves
        # one bundled fetch: responses for the next rung decision plus
        # the diagnostics and the in-kernel-adapted beta
        g_h, acc, beta_c = jax.device_get((g, acc, beta_d))
        g_h = np.asarray(g_h, dtype=np.float64)
        acc, beta_c = float(acc), float(beta_c)
        acc_rates.append(acc)
    else:
        raise RuntimeError(
            f"threshold ladder did not reach gamma={gamma} within "
            f"{max_stages} stages (last ladder rung {thresholds[-1]:.4g})"
            " — the response may be bounded below gamma")

    # one final refresh AT gamma: the estimate above is already fixed,
    # but islands finishing on the last rung carry populations
    # conditioned on the PREVIOUS rung — resample the gamma-exceeders
    # and move so the returned theta/qoi are conditional on the event
    theta, g, _, _ = stage(theta, g,
                           jnp.asarray(np.full(n_islands, gamma), dtype),
                           jnp.asarray(beta_c, dtype),
                           jax.random.fold_in(k_run, max_stages + 1))
    n_fwd += n_particles * n_moves

    wall = time.perf_counter() - t0
    log_p_se = float(log_p_island.std(ddof=1) / np.sqrt(n_islands))
    log_p = float(np.mean(log_p_island))
    out = {"p": float(np.exp(log_p)), "log_p": log_p,
           "log_p_se": log_p_se,
           "p_lo": float(np.exp(log_p - log_p_se)),
           "p_hi": float(np.exp(log_p + log_p_se)),
           "thresholds": thresholds, "acc_rates": acc_rates,
           "n_stages": len(acc_rates) + 1, "beta": beta_c,
           "n_forward": n_fwd, "wall_s": wall,
           "theta": np.asarray(
               jax.device_get(theta)).reshape(n_particles, d)}
    if qoi_fn is not None:
        q = jax.vmap(qoi_fn)(theta.reshape(n_islands * m, d))
        q_np = np.asarray(jax.device_get(q), dtype=np.float64).reshape(
            n_islands, m, -1)
        island_means = q_np.mean(axis=1)
        out["cond_qoi"] = island_means.mean(axis=0)
        out["cond_qoi_se"] = (island_means.std(axis=0, ddof=1)
                              / np.sqrt(n_islands))
    return out


# --------------------------------------------------------------------- #
# Cross-entropy importance sampling: the parametric complement
# --------------------------------------------------------------------- #
def cross_entropy_is(g_fn: Callable, gamma: float, d: int,
                     n_per_stage: int = 4096, n_final: int = 1 << 15,
                     rho: float = 0.1, key=None, max_stages: int = 30,
                     tilt: str = "mean",
                     qoi_fn: Optional[Callable] = None, dtype=None):
    """Estimate ``P[g_fn(theta) > gamma]`` under a N(0, I_d) prior by
    the cross-entropy method (Rubinstein 1999; de Boer et al., "A
    tutorial on the cross-entropy method", Ann. OR 134, 2005):
    adaptively tilt a Gaussian proposal toward the failure domain —
    each stage fits the tilt to the elite top-``rho`` fraction of its
    samples with LIKELIHOOD-RATIO weights (the closed-form CE update
    for Gaussian families is weighted elite moments; the weights refer
    the fit back to the PRIOR, since stage samples come from the
    previous tilt) and raises the working threshold to the elite
    quantile until it clears ``gamma`` — then one LARGE
    importance-sampling stage estimates

        p = E_q[ 1{g > gamma} N(theta; 0, I) / q(theta) ],

    with the likelihood-ratio CLT standard error and the IS weight ESS
    as the quality diagnostic.

    ``tilt="mean"`` (default) shifts the MEAN only (exponential
    tilting, ``N(mu, I)``): the prior/proposal ratio stays bounded on
    light-tailed problems, so the IS variance is finite by
    construction. ``tilt="full"`` also fits a diagonal sigma — sharper
    when the failure domain is genuinely anisotropic, but any fitted
    ``sigma_i < 1`` makes the weight UNBOUNDED along that axis (fitted
    sigmas are floored at 1 unless you know better; floor documented
    in code).

    vs :func:`subset_simulation`: CE is cheaper per decade and gives a
    plain-MC-style iid error bar when ONE Gaussian tilt captures the
    failure domain (a dominant design point); subset simulation is the
    robust choice for multimodal/irregular domains — run CE first and
    fall back if ``weight_ess`` collapses. Each stage is one jitted
    program with (mu, sigma, key) as operands — two executables total
    (stage size and final size); only elite moments cross the host.

    :return: dict with ``p``, ``log_p``, ``p_se``, ``weight_ess``
        (ESS fraction of the final IS weights in the failure region),
        ``thresholds``, ``mu``/``sigma`` (final tilt), ``n_forward``,
        ``cond_qoi`` (importance-weighted conditional mean of
        ``qoi_fn`` given failure, if provided), ``wall_s``.
    """
    if not 0.0 < rho < 1.0:
        raise ValueError("rho must be in (0, 1)")
    if tilt not in ("mean", "full"):
        raise ValueError("tilt must be 'mean' or 'full'")
    if key is None:
        key = jax.random.key(0)
    dtype = dtype or jnp.asarray(1.0).dtype
    flat_g = jax.vmap(g_fn)
    batch_qoi = jax.vmap(qoi_fn) if qoi_fn is not None else None

    def make_stage(n):
        @jax.jit
        def stage(mu, sigma, k):
            xi = jax.random.normal(k, (n, d), dtype)
            theta = mu[None, :] + sigma[None, :] * xi
            g = flat_g(theta)
            # log prior/proposal ratio (diagonal Gaussian tilt)
            logw = (-0.5 * jnp.sum(theta * theta, axis=1)
                    + 0.5 * jnp.sum(xi * xi, axis=1)
                    + jnp.sum(jnp.log(sigma)))
            return theta, g, logw

        return stage

    stage = make_stage(n_per_stage)
    mu = jnp.zeros((d,), dtype)
    sigma = jnp.ones((d,), dtype)
    thresholds = []
    n_forward = 0
    t0 = time.perf_counter()
    for it in range(max_stages):
        theta, g, logw = stage(mu, sigma, jax.random.fold_in(key, it))
        n_forward += n_per_stage
        g_h = np.asarray(jax.device_get(g), np.float64)
        thr = min(float(np.quantile(g_h, 1.0 - rho)), float(gamma))
        thresholds.append(thr)
        elite = jnp.asarray(g_h >= thr)
        # CE update: LIKELIHOOD-RATIO-weighted elite moments (the
        # weighted fit targets prior|{g > thr}, not proposal|elite)
        lw = jnp.where(elite, logw, -jnp.inf)
        w = jnp.exp(lw - jnp.max(lw))
        wsum = jnp.maximum(jnp.sum(w), 1e-300)
        mu = jnp.sum(w[:, None] * theta, 0) / wsum
        if tilt == "full":
            var = jnp.sum(w[:, None] * (theta - mu[None, :]) ** 2,
                          0) / wsum
            # floor at 1: sigma_i < 1 makes prior/proposal unbounded
            # along axis i (IS variance blows up); the tilt may widen,
            # never narrow below the prior
            sigma = jnp.maximum(jnp.sqrt(var), 1.0)
        if thr >= gamma:
            break
    else:
        raise RuntimeError(
            f"cross-entropy tilt did not reach gamma={gamma} within "
            f"{max_stages} stages (reached {thresholds[-1]:.4g}) — "
            "raise max_stages/n_per_stage, or use subset_simulation "
            "for irregular failure domains")

    final = make_stage(n_final)
    theta, g, logw = final(mu, sigma, jax.random.fold_in(key, 10_000))
    n_forward += n_final
    g_h, logw_h = jax.device_get((g, logw))
    g_h = np.asarray(g_h, np.float64)
    logw_h = np.asarray(logw_h, np.float64)
    fail = g_h > gamma
    lw = np.where(fail, logw_h, -np.inf)
    mx = lw.max()
    if not np.isfinite(mx):
        raise RuntimeError(
            "no failure samples in the final IS stage — the CE tilt "
            "collapsed; use subset_simulation")
    w = np.exp(lw - mx)
    p = float(np.mean(w) * np.exp(mx))
    se = float(np.std(w, ddof=1) / np.sqrt(n_final) * np.exp(mx))
    wsum = w.sum()
    ess = float(wsum ** 2 / max((w ** 2).sum(), 1e-300) / n_final)
    out = {"p": p, "log_p": float(np.log(max(p, 1e-300))),
           "p_se": se, "weight_ess": ess,
           "thresholds": thresholds,
           "mu": np.asarray(jax.device_get(mu), np.float64),
           "sigma": np.asarray(jax.device_get(sigma), np.float64),
           "n_forward": n_forward,
           "wall_s": time.perf_counter() - t0}
    if batch_qoi is not None:
        q = np.asarray(jax.device_get(batch_qoi(theta)), np.float64)
        out["cond_qoi"] = (w[:, None] * q).sum(0) / max(wsum, 1e-300)
    return out
