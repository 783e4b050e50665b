"""Ensemble Kalman inversion (EKI / ES-MDA) — derivative-free Bayesian
calibration, beyond-reference tier.

Companion to the multilevel MCMC tier (mlmc_tpu/mcmc.py): where MCMC
gives asymptotically exact posteriors at many-forward-solve cost, the
ensemble Kalman family gives a cheap derivative-free APPROXIMATION from
a few dozen forward evaluations per iteration — the standard tool for
expensive PDE calibration (Iglesias, Law & Stuart, "Ensemble Kalman
methods for inverse problems", Inverse Problems 29, 2013). The reference
framework has no inversion capability at all.

Implemented:

* **ES-MDA** (Emerick & Reynolds, "Ensemble smoother with multiple data
  assimilation", Computers & Geosciences 55, 2013): T damped Kalman
  updates with inflation factors ``alpha_t``, ``sum 1/alpha_t = 1``.
  For a LINEAR forward map and Gaussian prior/noise the scheme samples
  the EXACT posterior in the large-ensemble limit — the conjugate
  linear-Gaussian test pins mean and covariance against the closed
  form; for nonlinear maps it is the classic practical approximation.
* **hierarchical schedule**: spend the early, large-step updates on
  coarse models and only the last refinements on the fine model —
  the multilevel-economics version used with model hierarchies (cf.
  multilevel EKI, Hoel-Law-Tempone-style coupling economics). An
  approximation (the schedule mixes models), validated empirically
  against the fine-only run.

Device-first design: the ensemble IS the batch. One jitted ``lax.scan``
over assimilation steps; each step is ``vmap(forward)`` over the [J, d]
ensemble plus pure dense linear algebra — anomaly matmuls for the
cross-covariances and a Cholesky solve in observation space (K x K,
K = #observations, small). No adjoints, no per-particle control flow.
"""
import time
from typing import Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["esmda", "hierarchical_esmda"]


def _as_alphas(n_steps, alphas, validate=True):
    if alphas is None:
        alphas = [float(n_steps)] * int(n_steps)
    alphas = [float(a) for a in alphas]
    if len(alphas) != int(n_steps):
        raise ValueError(
            f"len(alphas) = {len(alphas)} must equal n_steps = "
            f"{n_steps} — a shorter schedule would silently drop the "
            "tail updates")
    s = sum(1.0 / a for a in alphas)
    if validate and abs(s - 1.0) > 1e-8:
        raise ValueError(
            "ES-MDA inflation factors must satisfy sum(1/alpha) = 1 "
            f"(got {s:.6f}); e.g. alphas=[4,4,4,4]")
    return alphas


def _esmda_update(theta, G, data, noise_std, alpha, key, jitter):
    """One damped Kalman update of the ensemble.

    theta [J, d], G [J, K] forward values, data [K]; observation noise
    is diagonal ``noise_std**2`` (pass a [K] vector for heteroscedastic
    observations)."""
    J = theta.shape[0]
    dtype = theta.dtype
    noise = jnp.broadcast_to(jnp.asarray(noise_std, dtype), data.shape)
    th_c = theta - jnp.mean(theta, axis=0, keepdims=True)
    g_c = G - jnp.mean(G, axis=0, keepdims=True)
    c_tg = th_c.T @ g_c / (J - 1)                      # [d, K]
    c_gg = g_c.T @ g_c / (J - 1)                       # [K, K]
    gamma = jnp.diag(noise ** 2)
    A = c_gg + alpha * gamma
    A = A + jitter * jnp.trace(A) / A.shape[0] * jnp.eye(
        A.shape[0], dtype=dtype)
    # perturbed observations, inflated by sqrt(alpha)
    xi = jax.random.normal(key, G.shape, dtype)
    y_pert = data[None, :] + jnp.sqrt(alpha) * noise[None, :] * xi
    resid = y_pert - G                                 # [J, K]
    L = jnp.linalg.cholesky(A)
    # K x K solve in observation space, then lift with C_tg
    sol = jax.scipy.linalg.cho_solve((L, True), resid.T)   # [K, J]
    return theta + (c_tg @ sol).T


def esmda(forward: Callable, data, noise_std, n_ens: int = 64,
          n_steps: int = 4, alphas: Optional[Sequence[float]] = None,
          prior_sampler: Optional[Callable] = None, d: Optional[int] = None,
          key=None, theta0=None, jitter: float = 1e-9, dtype=None,
          final_obs: bool = True, _validate_alphas: bool = True):
    """Ensemble smoother with multiple data assimilation.

    :param forward: ``theta [d] -> obs [K]`` pure jnp (vmapped over the
        ensemble).
    :param data: observed values [K].
    :param noise_std: observation noise sd (scalar or [K]).
    :param alphas: inflation schedule with ``sum 1/alpha = 1`` (default:
        ``n_steps`` equal factors).
    :param prior_sampler: ``key -> theta [J, d]`` drawing the prior
        ensemble; default standard normal (requires ``d``).
    :param theta0: explicit initial ensemble [J, d] (overrides both).
    :param final_obs: evaluate the forward once more on the FINAL
        ensemble for ``obs`` and the closing ``misfit`` entry (skip for
        intermediate hierarchical stages — it would be J wasted solves).
    :return: dict with ``theta`` [J, d] final ensemble, ``mean``/``std``
        [d], ``obs`` [J, K] final forward values (None when
        ``final_obs=False``), ``misfit`` per-step mean data misfit (in
        noise sds, RMS over observations; includes the post-update
        misfit only with ``final_obs``), ``n_forward`` actual forward
        evaluations, ``wall_s``.
    """
    alphas = _as_alphas(n_steps, alphas, validate=_validate_alphas)
    if key is None:
        key = jax.random.key(0)
    dtype = dtype or jnp.asarray(1.0).dtype
    data = jnp.asarray(data, dtype)
    k_init, k_run = jax.random.split(key)
    if theta0 is None:
        if prior_sampler is not None:
            theta0 = prior_sampler(k_init)
        else:
            if d is None:
                raise ValueError("need d (or prior_sampler/theta0)")
            theta0 = jax.random.normal(k_init, (n_ens, d), dtype=dtype)
    theta0 = jnp.asarray(theta0, dtype)
    batch_fwd = jax.vmap(forward)
    noise = jnp.broadcast_to(jnp.asarray(noise_std, dtype), data.shape)

    def step(theta, xs):
        alpha, k = xs
        G = batch_fwd(theta)
        rms = jnp.sqrt(jnp.mean(((G - data[None, :]) / noise) ** 2))
        theta = _esmda_update(theta, G, data, noise, alpha, k, jitter)
        return theta, rms

    @jax.jit
    def run(theta0):
        theta, rms = jax.lax.scan(
            step, theta0,
            (jnp.asarray(alphas, dtype), jax.random.split(k_run,
                                                          len(alphas))))
        return theta, rms, (batch_fwd(theta) if final_obs else None)

    t0 = time.perf_counter()
    theta, rms, G = run(theta0)
    theta_np, rms_np, G_np = jax.device_get((theta, rms, G))
    wall = time.perf_counter() - t0
    misfit = list(np.asarray(rms_np))
    if final_obs:
        misfit.append(float(np.sqrt(np.mean(
            ((G_np - np.asarray(data)[None, :])
             / np.asarray(noise)) ** 2))))
    return {"theta": np.asarray(theta_np),
            "mean": np.asarray(theta_np).mean(axis=0),
            "std": np.asarray(theta_np).std(axis=0, ddof=1),
            "obs": np.asarray(G_np) if final_obs else None,
            "misfit": misfit,
            "n_forward": (len(alphas) + int(final_obs))
            * theta_np.shape[0],
            "wall_s": wall}


def hierarchical_esmda(forwards: Sequence[Callable], data, noise_std,
                       steps_per_level: Optional[Sequence[int]] = None,
                       n_ens: int = 64, n_steps: int = 4, key=None,
                       alphas: Optional[Sequence[float]] = None,
                       prior_sampler: Optional[Callable] = None,
                       d: Optional[int] = None, theta0=None,
                       jitter: float = 1e-9, dtype=None):
    """ES-MDA over a model hierarchy: early inflated updates run on the
    COARSE forwards, only the final ones on the fine model.

    One alpha schedule (``sum 1/alpha = 1`` overall) split across the
    levels, coarsest first — the assimilation economics of MLMC applied
    to calibration. This mixes models inside one schedule, so the exact
    linear-Gaussian limit holds only when the models agree; the test
    suite validates it empirically against the fine-only run and the
    bench reports the fine-solve count saved.

    :param forwards: per-level ``theta -> obs [K]``, coarsest first.
    :param steps_per_level: how many of the ``n_steps`` updates each
        level takes (default: spread evenly with the remainder on the
        coarse end, but ALWAYS at least one fine step).
    :return: the :func:`esmda` result dict of the final (fine) stage
        with ``misfit`` concatenated across stages and ``n_forward``
        per level.
    """
    L = len(forwards)
    if L < 1:
        raise ValueError("need at least one forward model")
    if steps_per_level is None:
        base = n_steps // L
        steps_per_level = [base] * L
        for i in range(n_steps - base * L):
            steps_per_level[i] += 1
        if steps_per_level[-1] == 0:
            steps_per_level[-1] = 1
            steps_per_level[0] -= 1
    if len(steps_per_level) != L or sum(steps_per_level) != n_steps \
            or steps_per_level[-1] < 1 or min(steps_per_level) < 0:
        raise ValueError("steps_per_level must sum to n_steps with >=1 "
                         "fine step")
    if key is None:
        key = jax.random.key(0)
    alphas = _as_alphas(n_steps, alphas)
    keys = jax.random.split(key, L + 1)
    theta = theta0
    misfit, n_forward = [], []
    out = None
    pos = 0
    last_lvl = max(lv for lv, t in enumerate(steps_per_level) if t > 0)
    for lvl, (fwd, t) in enumerate(zip(forwards, steps_per_level)):
        if t == 0:
            n_forward.append(0)
            continue
        # this stage runs its alpha slice; sum(1/alpha) over all stages=1
        stage_alphas = alphas[pos:pos + t]
        pos += t
        out = esmda(fwd, data, noise_std, n_ens=n_ens, n_steps=t,
                    alphas=stage_alphas, _validate_alphas=False,
                    key=keys[lvl + 1], theta0=theta, d=d,
                    prior_sampler=prior_sampler, jitter=jitter,
                    dtype=dtype, final_obs=(lvl == last_lvl))
        theta = out["theta"]
        misfit.extend(out["misfit"])
        n_forward.append(out["n_forward"])
    out["misfit"] = misfit
    out["n_forward"] = n_forward
    return out
