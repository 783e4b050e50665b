"""Tempered sequential Monte Carlo — posterior sampling AND model
evidence, beyond-reference tier.

Completes the Bayesian toolbox (mlmc_tpu/mcmc.py gives asymptotically
exact chains, mlmc_tpu/eki.py a cheap Kalman approximation): an SMC
sampler (Del Moral, Doucet & Jasra, "Sequential Monte Carlo samplers",
JRSS-B 68, 2006) that anneals a particle population from the prior to
the posterior through tempered bridges

    pi_lambda(theta) ~ prior(theta) * L(theta)^lambda,   0 -> 1,

with ADAPTIVE tempering (each increment chosen so the effective sample
size hits a fixed fraction — Jasra et al. 2011), systematic resampling
and pCN-rejuvenation moves. Two things MCMC alone cannot give:

* the **model evidence** Z = integral prior * L: each stage's mean
  incremental weight estimates Z_{lambda'}/Z_lambda, so
  ``log Z = sum_stages logmeanexp((lambda'-lambda) * ll)`` — the
  quantity for Bayesian model comparison; validated against the
  conjugate-Gaussian closed form in tests/test_smc.py,
* population sampling that is robust to multimodality (a particle
  population tempered from the prior does not need to tunnel).

Device-first design: the particle population IS the device batch. Each
stage is one jitted program: log-weight update + systematic resampling
(sorted-cumsum + searchsorted, static shapes) + a lax.scan of pCN moves
at the tempered target, with the temperature an OPERAND (one executable
serves every stage). Only the [N] log-likelihood vector crosses to the
host per stage, where the next temperature is found by bisection on the
closed-form ESS(lambda) curve — a decision, not a computation.

The hierarchical variant anneals early stages on coarse forward models
(MLMC economics; the bridge between models is itself an importance
step, so the evidence stays consistent: the model-switch stage
reweights by ``ll_fine - ll_coarse`` at the CURRENT temperature).
"""
import time
from typing import Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["smc_tempering", "hierarchical_smc"]


def _ess_fraction(log_w):
    """ESS/N of normalized-able log weights (host numpy)."""
    w = np.exp(log_w - log_w.max())
    return float((w.sum() ** 2) / (len(w) * (w * w).sum()))


def _next_lambda(lam, ll, target_frac):
    """Largest lambda' in (lam, 1] whose increment keeps
    ESS(incremental weights) >= target_frac * N, by bisection — the
    ESS of ``(lam'-lam) ll`` is continuous and decreasing in lam'."""
    if _ess_fraction((1.0 - lam) * ll) >= target_frac:
        return 1.0
    lo, hi = lam, 1.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if _ess_fraction((mid - lam) * ll) >= target_frac:
            lo = mid
        else:
            hi = mid
    return lo


def _logmeanexp(x):
    m = np.max(x)
    return float(m + np.log(np.mean(np.exp(x - m))))


def _systematic_resample(log_w, u01, m, dtype):
    """Per-island systematic resampling; log_w [I, m], u01 [I, 1]
    uniforms -> idx [I, m]."""
    w = jax.nn.softmax(log_w, axis=1)
    cum = jnp.cumsum(w, axis=1)
    u = (u01 + jnp.arange(m, dtype=dtype)[None, :]) / m
    idx = jax.vmap(lambda c, uu: jnp.searchsorted(c, uu))(cum, u)
    return jnp.clip(idx, 0, m - 1)


def _make_stage(flat_ll, n_islands, m, d, dtype, n_moves,
                acc_target=0.234, rm_gain=0.5):
    """One jitted SMC stage shared by the plain and hierarchical
    drivers: systematic resampling at the given log-weights, then
    ``n_moves`` pCN sweeps at the tempered target ``lam * ll``. The
    temperature, step size and log-weights are OPERANDS — one
    executable serves every stage of a run.

    beta adapts ON DEVICE after every sweep (Robbins-Monro on
    logit(beta) toward ``acc_target``; the acceptance signal is an
    N-particle mean, nearly noiseless, so a large gain is safe) — a
    sharpening posterior can demand an order of magnitude smaller steps
    within ONE tempering stage, which per-stage host adaptation cannot
    deliver (measured on the Darcy bench: final-stage acceptance 0.03
    with host RM vs 0.15 in-kernel, 4.8x the solve throughput).
    Returns the adapted beta for the next stage to continue from."""

    @jax.jit
    def stage(theta, ll, log_w, lam, beta0, k):
        k_r, k_m = jax.random.split(k)
        u01 = jax.random.uniform(k_r, (n_islands, 1), dtype)
        idx = _systematic_resample(log_w, u01, m, dtype)
        theta = jnp.take_along_axis(theta, idx[:, :, None], axis=1)
        ll = jnp.take_along_axis(ll, idx, axis=1)

        def move(carry, kk):
            th, ll_c, beta_c, acc = carry
            k_xi, k_u = jax.random.split(kk)
            flat = th.reshape(n_islands * m, d)
            xi = jax.random.normal(k_xi, flat.shape, dtype)
            prop = _pcn(flat, xi, beta_c).reshape(n_islands, m, d)
            ll_p = flat_ll(prop)
            log_u = jnp.log(jax.random.uniform(
                k_u, (n_islands, m), dtype,
                minval=jnp.finfo(dtype).tiny))
            accept = log_u < lam * (ll_p - ll_c)
            th = jnp.where(accept[:, :, None], prop, th)
            ll_c = jnp.where(accept, ll_p, ll_c)
            a = jnp.mean(accept.astype(dtype))
            logit = jnp.log(beta_c) - jnp.log1p(-beta_c)
            beta_c = jax.nn.sigmoid(logit + rm_gain * (a - acc_target))
            return (th, ll_c, beta_c, acc + a), None

        (theta, ll, beta_c, acc), _ = jax.lax.scan(
            move, (theta, ll, beta0, jnp.zeros((), dtype)),
            jax.random.split(k_m, n_moves))
        return theta, ll, acc / n_moves, beta_c

    return stage


def _result_dict(theta, qoi, log_z_island, lambdas, acc_rates, beta_c,
                 wall, n_particles, d, n_islands, extra=None):
    """Assemble the common result payload (island CLT errors)."""
    qoi_np = np.asarray(qoi, dtype=np.float64)
    island_means = qoi_np.mean(axis=1)                   # [I, q]
    out = {"theta": np.asarray(theta).reshape(n_particles, d),
           "qoi": qoi_np.reshape(n_particles, -1),
           "mean": qoi_np.reshape(n_particles, -1).mean(axis=0),
           "se": island_means.std(axis=0, ddof=1) / np.sqrt(n_islands),
           "log_evidence": float(np.mean(log_z_island)),
           "log_evidence_se": float(log_z_island.std(ddof=1)
                                    / np.sqrt(n_islands)),
           "lambdas": lambdas, "acc_rates": acc_rates,
           "beta": beta_c, "wall_s": wall}
    out.update(extra or {})
    return out


def smc_tempering(loglik_qoi: Callable, d: int, n_particles: int = 256,
                  n_moves: int = 5, beta: float = 0.3,
                  ess_target: float = 0.5, key=None, max_stages: int = 200,
                  theta0=None, dtype=None):
    """Anneal ``n_particles`` from the prior N(0, I_d) to the posterior.

    :param loglik_qoi: ``theta [d] -> (loglik, qoi [q])`` pure jnp.
    :param n_moves: pCN rejuvenation steps per stage (at the tempered
        target ``lambda * loglik``); beta is Robbins-Monro-adapted
        ON DEVICE after every sweep toward 0.234 acceptance and carries
        across stages.
    :param ess_target: ESS fraction kept by each tempering increment.
    :return: dict with ``theta`` [N, d] posterior particles (equally
        weighted), ``qoi`` [N, q], ``mean``/``se`` (QoI mean with a
        resampling-aware jackknife-free se: population sd / sqrt(ESS_mh)
        is NOT reported; se comes from ``n_runs`` independent islands —
        see below), ``log_evidence``, ``lambdas`` (the adaptive
        schedule), ``acc_rates``, ``wall_s``.

    Island CLT: particles interact through resampling, so the naive
    population variance understates the error. The population is split
    into 8 independent ISLANDS (separate resampling + moves — disjoint
    sub-populations from the start), and ``se``/``log_evidence_se`` are
    across-island CLT errors. Mean estimates use the full population.
    """
    if key is None:
        key = jax.random.key(0)
    dtype = dtype or jnp.asarray(1.0).dtype
    n_islands = 8
    if n_particles % n_islands:
        raise ValueError("n_particles must be divisible by 8 (islands)")
    m = n_particles // n_islands
    batch = jax.vmap(loglik_qoi)

    k_init, k_run = jax.random.split(key)
    if theta0 is None:
        theta0 = jax.random.normal(k_init, (n_particles, d), dtype=dtype)
    theta = jnp.asarray(theta0, dtype).reshape(n_islands, m, d)

    def flat_ll(theta):
        ll, qoi = batch(theta.reshape(n_islands * m, d))
        return (ll.reshape(n_islands, m),
                qoi.reshape(n_islands, m, -1))

    # the unused qoi output is dead-code-eliminated inside the move
    stage = _make_stage(lambda th: flat_ll(th)[0], n_islands, m, d,
                        dtype, n_moves)

    t0 = time.perf_counter()
    ll, qoi = flat_ll(theta)
    ll_h = np.asarray(jax.device_get(ll), dtype=np.float64)
    lam = 0.0
    lambdas, acc_rates = [0.0], []
    log_z_island = np.zeros(n_islands)
    beta_c = float(beta)
    for stage_i in range(max_stages):
        lam_next = _next_lambda(lam, ll_h.ravel(), ess_target)
        for i in range(n_islands):
            log_z_island[i] += _logmeanexp((lam_next - lam) * ll_h[i])
        theta, ll, acc, beta_d = stage(
            theta, ll, jnp.asarray(lam_next - lam, dtype) * ll,
            jnp.asarray(lam_next, dtype), jnp.asarray(beta_c, dtype),
            jax.random.fold_in(k_run, stage_i))
        # one bundled fetch: ll for the next temperature decision, the
        # acceptance diagnostic and the in-kernel-adapted beta
        ll_h, acc, beta_c = jax.device_get((ll, acc, beta_d))
        ll_h = np.asarray(ll_h, dtype=np.float64)
        acc, beta_c = float(acc), float(beta_c)
        acc_rates.append(acc)
        lam = lam_next
        lambdas.append(lam)
        if lam >= 1.0:
            break
    else:
        raise RuntimeError("tempering did not reach lambda=1 within "
                           f"{max_stages} stages")
    ll_fin, qoi = flat_ll(theta)
    theta_np, qoi_np = jax.device_get((theta, qoi))
    wall = time.perf_counter() - t0
    return _result_dict(
        theta_np, qoi_np, log_z_island, lambdas, acc_rates, beta_c,
        wall, n_particles, d, n_islands,
        extra={"n_forward": (len(acc_rates) * n_moves + 2)
               * n_particles})


def _pcn(theta, xi, beta):
    return jnp.sqrt(1.0 - beta * beta) * theta + beta * xi


def hierarchical_smc(loglik_qoi_fns: Sequence[Callable], d: int,
                     switch_lambdas: Optional[Sequence[float]] = None,
                     **kwargs):
    """Tempered SMC over a model hierarchy: anneal on the COARSE model
    first, switch models mid-schedule with an importance bridge.

    The temper path visits ``(model l, lambda)`` pairs; at a model
    switch the incremental weight is ``lambda * (ll_{l+1} - ll_l)`` —
    an exact importance step, so the final particles target the FINE
    posterior and ``log_evidence`` estimates the FINE model's evidence
    (consistency does not rely on the models agreeing; only the
    VARIANCE depends on their closeness).

    :param switch_lambdas: temperatures at which to hand over to the
        next model (length L-1, increasing; default: equally spaced).

    Implementation: runs :func:`smc_tempering` segments with shifted
    likelihoods is not possible (the bridge re-weights), so this driver
    re-implements the loop calling the same staged kernel; for L == 1 it
    is exactly :func:`smc_tempering`.
    """
    L = len(loglik_qoi_fns)
    if L == 1:
        return smc_tempering(loglik_qoi_fns[0], d, **kwargs)
    if switch_lambdas is None:
        switch_lambdas = [(l + 1) / L for l in range(L - 1)]
    if len(switch_lambdas) != L - 1 or \
            any(b <= a for a, b in zip(switch_lambdas, switch_lambdas[1:])) \
            or switch_lambdas[0] <= 0 or switch_lambdas[-1] >= 1:
        raise ValueError("switch_lambdas must be increasing in (0, 1), "
                         "one per model handover")
    return _hier_smc_impl(loglik_qoi_fns, d, list(switch_lambdas),
                          **kwargs)


def _hier_smc_impl(fns, d, switches, n_particles=256, n_moves=5,
                   beta=0.3, ess_target=0.5, key=None, max_stages=200,
                   theta0=None, dtype=None):
    if key is None:
        key = jax.random.key(0)
    dtype = dtype or jnp.asarray(1.0).dtype
    n_islands = 8
    if n_particles % n_islands:
        raise ValueError("n_particles must be divisible by 8 (islands)")
    m = n_particles // n_islands
    batches = [jax.vmap(fn) for fn in fns]

    k_init, k_run = jax.random.split(key)
    if theta0 is None:
        theta0 = jax.random.normal(k_init, (n_particles, d), dtype=dtype)
    theta = jnp.asarray(theta0, dtype).reshape(n_islands, m, d)

    def flat_ll(theta, lvl):
        ll, qoi = batches[lvl](theta.reshape(n_islands * m, d))
        return ll.reshape(n_islands, m), qoi.reshape(n_islands, m, -1)

    # one jitted stage kernel PER LEVEL (log_w passed in, temperatures
    # as operands — executables are reused across that level's stages)
    stages = [_make_stage(lambda th, l=l: flat_ll(th, l)[0], n_islands,
                          m, d, dtype, n_moves)
              for l in range(len(fns))]
    t0 = time.perf_counter()
    lvl = 0
    ll, _ = flat_ll(theta, lvl)
    ll_h = np.asarray(jax.device_get(ll), dtype=np.float64)
    lam = 0.0
    lambdas, acc_rates, levels = [0.0], [], [0]
    log_z_island = np.zeros(n_islands)
    beta_c = float(beta)
    n_fwd = [0] * len(fns)
    n_fwd[0] += n_particles
    for stage_i in range(max_stages):
        bound = switches[lvl] if lvl < len(switches) else 1.0
        lam_next = min(_next_lambda(lam, ll_h.ravel(), ess_target), bound)
        log_w_h = (lam_next - lam) * ll_h
        switching = lam_next >= bound and lvl < len(switches)
        if switching:
            # importance bridge to the next model at temperature lam_next
            ll_new, _ = flat_ll(theta, lvl + 1)
            ll_new_h = np.asarray(jax.device_get(ll_new),
                                  dtype=np.float64)
            n_fwd[lvl + 1] += n_particles
            log_w_h = log_w_h + lam_next * (ll_new_h - ll_h)
        for i in range(n_islands):
            log_z_island[i] += _logmeanexp(log_w_h[i])
        if switching:
            lvl += 1
            ll_h = ll_new_h
            ll = jnp.asarray(ll_new_h, dtype)
        theta, ll, acc, beta_d = stages[lvl](
            theta, ll, jnp.asarray(log_w_h, dtype),
            jnp.asarray(lam_next, dtype), jnp.asarray(beta_c, dtype),
            jax.random.fold_in(k_run, stage_i))
        n_fwd[lvl] += n_particles * n_moves
        ll_h, acc, beta_c = jax.device_get((ll, acc, beta_d))
        ll_h = np.asarray(ll_h, dtype=np.float64)
        acc, beta_c = float(acc), float(beta_c)
        acc_rates.append(acc)
        lam = lam_next
        lambdas.append(lam)
        levels.append(lvl)
        if lam >= 1.0:
            break
    else:
        raise RuntimeError("tempering did not reach lambda=1 within "
                           f"{max_stages} stages")
    ll_fin, qoi = flat_ll(theta, len(fns) - 1)
    n_fwd[-1] += n_particles
    theta_np, qoi_np = jax.device_get((theta, qoi))
    wall = time.perf_counter() - t0
    return _result_dict(
        theta_np, qoi_np, log_z_island, lambdas, acc_rates, beta_c,
        wall, n_particles, d, n_islands,
        extra={"levels": levels, "n_forward": n_fwd})
