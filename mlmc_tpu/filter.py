"""Sequential data assimilation — ensemble Kalman filtering,
beyond-reference tier.

Completes the data-assimilation story (mlmc_tpu/eki.py calibrates
STATIC parameters; this module tracks a DYNAMIC state): given a
state-space model

    x_{t+1} = M(x_t, w_t),      y_t = h(x_t) + v_t,  v_t ~ N(0, R),

the ensemble Kalman filter (Evensen 1994) propagates a J-member
ensemble through the model and assimilates each observation with a
Kalman update built from ensemble statistics. Two analysis schemes:

* ``method="perturbed"`` — the stochastic perturbed-observation update
  (Burgers-van Leeuwen-Evensen 1998): exactly the ES-MDA update of
  mlmc_tpu/eki.py at inflation alpha = 1 (shared code);
* ``method="etkf"`` — the deterministic ensemble transform filter
  (Bishop-Etherton-Majumdar 2001): a symmetric square-root transform
  in the J-dimensional ensemble space, no observation noise draws —
  lower sampling error at small J.

Also produced: the INNOVATION log-likelihood ``sum_t log N(y_t;
h_mean_forecast, H P_f H' + R)`` (ensemble plug-in) — the quantity
maximized for model-parameter estimation, exact for linear-Gaussian
models as J -> inf (validated against the closed-form Kalman filter,
:func:`kalman_filter`).

Device-first design: the ensemble IS the device batch and the WHOLE
filter pass is ONE jitted ``lax.scan`` over time — per step a batched
model propagation, two anomaly matmuls and a small (K x K or J x J)
solve; nothing crosses to the host until the trajectory statistics are
fetched in one transfer at the end.
"""
import time
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.eki import _esmda_update
from mlmc_tpu.particle import _island_se

__all__ = ["enkf", "multilevel_enkf", "kalman_filter", "lorenz96_step"]


def kalman_filter(M, H, Q, R, m0, P0, data):
    """Exact Kalman filter for ``x' = M x + w``, ``y = H x + v``
    (host numpy, the validation reference).

    :return: dict with ``means`` [T, d], ``covs`` [T, d, d] (filtered),
        ``loglik`` (the exact innovation log-likelihood).
    """
    M, H = np.asarray(M, np.float64), np.asarray(H, np.float64)
    Q, R = np.asarray(Q, np.float64), np.asarray(R, np.float64)
    m, P = np.asarray(m0, np.float64), np.asarray(P0, np.float64)
    data = np.asarray(data, np.float64)
    K_obs = H.shape[0]
    means, covs, loglik = [], [], 0.0
    for y in data:
        m = M @ m
        P = M @ P @ M.T + Q
        S = H @ P @ H.T + R
        innov = y - H @ m
        sol = np.linalg.solve(S, innov)
        loglik += -0.5 * (K_obs * np.log(2 * np.pi)
                          + np.linalg.slogdet(S)[1] + innov @ sol)
        K = P @ H.T @ np.linalg.inv(S)
        m = m + K @ innov
        P = (np.eye(len(m)) - K @ H) @ P
        means.append(m.copy())
        covs.append(P.copy())
    return {"means": np.array(means), "covs": np.array(covs),
            "loglik": float(loglik)}


def _etkf_update(x, hx, y, noise, jitter):
    """Deterministic ensemble-transform analysis (symmetric square
    root): x [J, d], hx [J, K], y [K], diagonal noise [K].

    Worked in OBSERVATION space via the thin SVD of the scaled obs
    anomalies S [J, K]: with S = U diag(s) V^T (rank r = min(J-1, K)),

        (I + S S^T/(J-1))^-1    = I - U diag(t/(1+t)) U^T,
        (I + S S^T/(J-1))^-1/2  = I + U diag((1+t)^-1/2 - 1) U^T,

    t = s^2/(J-1) — O(J K^2) instead of the O(J^3) eigh of the [J, J]
    Gram matrix (K << J in every assimilation workload), and perfectly
    conditioned (eigenvalues >= 1, no jitter needed). Both operators
    fix the ones-vector (S^T 1 = 0), so the transform preserves the
    zero anomaly mean by construction."""
    J = x.shape[0]
    xm = jnp.mean(x, axis=0)
    hm = jnp.mean(hx, axis=0)
    A = x - xm                                    # [J, d]
    S = (hx - hm) / noise[None, :]                # [J, K] R^-1/2 scaled
    U, s, _ = jnp.linalg.svd(S, full_matrices=False)   # U [J, r]
    t = s * s / (J - 1)
    d_scaled = (y - hm) / noise                    # [K]
    Sd = S @ d_scaled / (J - 1)                    # [J]
    # mean update: xm + A^T (I+C)^-1 Sd
    wbar = Sd - U @ ((t / (1.0 + t)) * (U.T @ Sd))
    xm_a = xm + A.T @ wbar
    # anomaly transform: A + U ((1+t)^-1/2 - 1) U^T A
    A_a = A + U @ ((1.0 / jnp.sqrt(1.0 + t) - 1.0)[:, None]
                   * (U.T @ A))
    return xm_a[None, :] + A_a - jnp.mean(A_a, axis=0, keepdims=True)


def enkf(transition: Callable, observe: Callable, data, noise_std,
         n_ens: int, d: int, key=None, x0=None,
         x0_sampler: Optional[Callable] = None, inflation: float = 1.0,
         method: str = "perturbed", jitter: float = 1e-9, dtype=None):
    """Run the ensemble Kalman filter over ``data`` [T, K].

    :param transition: ``(x [J, d], key, t) -> x' [J, d]`` batched
        stochastic model step, pure jnp (draw model noise from ``key``).
    :param observe: ``x [d] -> obs [K]`` per-member observation
        operator (vmapped inside).
    :param noise_std: observation noise sd (scalar or [K], diagonal R).
    :param x0 / x0_sampler: initial ensemble [J, d], or ``key -> [J, d]``
        (default N(0, I)).
    :param inflation: multiplicative anomaly inflation (> 1 combats
        sampling-noise covariance collapse in chaotic models).
    :param method: "perturbed" (stochastic update; shares the ES-MDA
        update) or "etkf" (deterministic square-root transform).
    :return: dict with ``means`` [T, d] (analysis means), ``spread``
        [T] (mean analysis ensemble sd), ``forecast_means`` [T, d],
        ``loglik`` (ensemble innovation log-likelihood), ``ensemble``
        [J, d] final, ``wall_s``.
    """
    if method not in ("perturbed", "etkf"):
        raise ValueError(f"unknown method {method!r}; "
                         "choose 'perturbed' or 'etkf'")
    if inflation < 1.0:
        raise ValueError("inflation must be >= 1")
    if key is None:
        key = jax.random.key(0)
    dtype = dtype or jnp.asarray(1.0).dtype
    data = jnp.asarray(data, dtype)
    T, K = data.shape
    noise = jnp.broadcast_to(jnp.asarray(noise_std, dtype), (K,))
    k_init, k_run = jax.random.split(key)
    if x0 is None:
        x0 = (x0_sampler(k_init) if x0_sampler is not None
              else jax.random.normal(k_init, (n_ens, d), dtype=dtype))
    x0 = jnp.asarray(x0, dtype)
    batch_obs = jax.vmap(observe)
    infl = jnp.asarray(np.sqrt(inflation), dtype)

    def step(x, xs):
        y, k, t = xs
        k_prop, k_upd = jax.random.split(k)
        x = transition(x, k_prop, t)
        xm = jnp.mean(x, axis=0)
        x = xm[None, :] + infl * (x - xm[None, :])
        hx = batch_obs(x)
        # innovation loglik at the forecast (ensemble plug-in)
        hm = jnp.mean(hx, axis=0)
        hc = hx - hm
        S = hc.T @ hc / (n_ens - 1) + jnp.diag(noise ** 2)
        innov = y - hm
        sol = jnp.linalg.solve(S, innov)
        ll = -0.5 * (K * jnp.log(2 * jnp.pi * jnp.ones((), dtype))
                     + jnp.linalg.slogdet(S)[1] + innov @ sol)
        fm = jnp.mean(x, axis=0)
        if method == "perturbed":
            x = _esmda_update(x, hx, y, noise, jnp.asarray(1.0, dtype),
                              k_upd, jitter)
        else:
            x = _etkf_update(x, hx, y, noise, jitter)
        am = jnp.mean(x, axis=0)
        spread = jnp.mean(jnp.std(x, axis=0, ddof=1))
        return x, (am, fm, spread, ll)

    @jax.jit
    def run(x0, data):
        keys = jax.random.split(k_run, T)
        ts = jnp.arange(T)
        x, (am, fm, spread, ll) = jax.lax.scan(
            step, x0, (data, keys, ts))
        return x, am, fm, spread, jnp.sum(ll)

    t0 = time.perf_counter()
    x, am, fm, spread, ll = jax.device_get(run(x0, data))
    wall = time.perf_counter() - t0
    return {"means": np.asarray(am), "forecast_means": np.asarray(fm),
            "spread": np.asarray(spread), "loglik": float(ll),
            "ensemble": np.asarray(x), "wall_s": wall}


def multilevel_enkf(transition_level: Callable, observe: Callable,
                    data, noise_std, n_levels: int, d: int,
                    n_ens=64, key=None,
                    x0_sampler: Optional[Callable] = None,
                    inflation: float = 1.0, method: str = "etkf",
                    n_replicates: int = 8,
                    phi: Optional[Callable] = None,
                    jitter: float = 1e-9, dtype=None):
    """Multilevel ensemble Kalman filter (Hoel, Law & Tempone, SIAM J.
    Numer. Anal. 54, 2016): filtered expectations telescoped over a
    transition-kernel hierarchy,

        E_L[phi_t] = E_0[phi_t] + sum_l (E_l[phi_t] - E_{l-1}[phi_t]),

    with each correction from a COUPLED pair of EnKFs — fine and
    coarse kernels consume the SAME propagation key, and the analysis
    couples by construction: ETKF is deterministic in the ensemble,
    and the perturbed-observation update shares its perturbation draw
    within the pair. EnKF has no resampling, so no coupled-resampling
    machinery is needed (contrast
    :func:`~mlmc_tpu.particle.multilevel_particle_filter`) — identical
    fine/coarse kernels give EXACTLY zero correction under "etkf".

    Error bars: ensemble members interact through the gain, so the
    honest error unit is an independent filter REPLICATE —
    ``n_replicates`` pairs run per level (one vmapped scan) and the
    across-replicate scatter is reported, the same policy as the
    particle/SMC island tiers.

    :param transition_level: ``level -> (x [J, d], key, t) -> x' [J, d]``
        factory, coarsest 0; same-key fine/coarse propagations must be
        pathwise close (counter-derived noise).
    :param n_ens: ensemble size per replicate — int or per-level list
        (MLEnKF theory wants decaying J_l).
    :param phi: ``x [d] -> [q]`` test function (default identity).
    :return: dict with ``means`` [T, q] telescoped, ``means_se``
        (levels combined in quadrature), ``level_means`` /
        ``level_ses``, ``correction_l1`` [n_levels-1] decay
        diagnostic, ``wall_s``.
    """
    if n_levels < 1:
        raise ValueError("n_levels must be >= 1")
    if method not in ("perturbed", "etkf"):
        raise ValueError(f"unknown method {method!r}")
    if key is None:
        key = jax.random.key(0)
    dtype = dtype or jnp.asarray(1.0).dtype
    data = jnp.asarray(data, dtype)
    T, K = data.shape
    noise = jnp.broadcast_to(jnp.asarray(noise_std, dtype), (K,))
    n_per = ([int(n_ens)] * n_levels if np.isscalar(n_ens)
             else list(n_ens))
    if len(n_per) != n_levels:
        raise ValueError(f"n_ens gives {len(n_per)} levels, expected "
                         f"{n_levels}")
    phi = phi if phi is not None else (lambda x: x)
    batch_phi = jax.vmap(jax.vmap(phi))            # [R, J, d] -> [R, J, q]
    R = int(n_replicates)
    infl = jnp.asarray(np.sqrt(max(inflation, 1.0)), dtype)
    one = jnp.asarray(1.0, dtype)
    t0 = time.perf_counter()

    def draw_x0(kk, J):
        if x0_sampler is not None:
            # per-level ensemble sizes: the sampler receives the size
            # (``(key, n) -> [n, d]``, unlike enkf's fixed-size hook)
            return jnp.stack([x0_sampler(jax.random.fold_in(kk, r), J)
                              for r in range(R)])
        return jax.random.normal(kk, (R, J, d), dtype)

    def analysis(x, y, k_upd):
        """Vmapped-over-replicates analysis update, [R, J, d]."""
        hx = jax.vmap(jax.vmap(observe))(x)
        if method == "etkf":
            return jax.vmap(
                lambda xr, hr: _etkf_update(xr, hr, y, noise, jitter)
            )(x, hx)
        keys = jax.random.split(k_upd, R)
        return jax.vmap(
            lambda xr, hr, kk: _esmda_update(xr, hr, y, noise, one,
                                             kk, jitter))(x, hx, keys)

    def run_level(lev, kk):
        """One jitted scan: level-0 plain filter or a coupled pair;
        returns per-step replicate means of phi, [T, R, q] (and the
        coarse stream for lev > 0)."""
        J = n_per[lev]
        fine = transition_level(lev)
        coarse = transition_level(lev - 1) if lev > 0 else None
        k_init, k_run = jax.random.split(jax.random.fold_in(key, kk))
        x0 = jnp.asarray(draw_x0(k_init, J), dtype)

        def prop(f, x, k_prop, t):
            keys = jax.random.split(k_prop, R)
            x = jax.vmap(lambda xr, kr: f(xr, kr, t))(x, keys)
            xm = jnp.mean(x, axis=1, keepdims=True)
            return xm + infl * (x - xm)

        def step(carry, xs):
            xf, xc = carry
            y, k, t = xs
            k_prop, k_upd = jax.random.split(k)
            xf = prop(fine, xf, k_prop, t)
            xf = analysis(xf, y, k_upd)
            mf = jnp.mean(batch_phi(xf), axis=1)       # [R, q]
            if coarse is None:
                return (xf, xc), (mf, mf)
            xc = prop(coarse, xc, k_prop, t)
            xc = analysis(xc, y, k_upd)
            mc = jnp.mean(batch_phi(xc), axis=1)
            return (xf, xc), (mf, mc)

        @jax.jit
        def go(x0, data):
            keys = jax.random.split(k_run, T)
            _, (mf, mc) = jax.lax.scan(step, (x0, x0),
                                       (data, keys, jnp.arange(T)))
            return mf, mc

        return jax.device_get(go(x0, data))

    level_means, level_ses, corr_l1 = [], [], []
    for lev in range(n_levels):
        mf, mc = run_level(lev, lev)
        vals = (np.asarray(mf, np.float64) if lev == 0
                else np.asarray(mf, np.float64)
                - np.asarray(mc, np.float64))          # [T, R, q]
        mean, se = _island_se(np.swapaxes(vals, 0, 1))
        level_means.append(mean)
        level_ses.append(se)
        if lev > 0:
            corr_l1.append(float(np.mean(np.abs(mean))))

    means = np.sum(level_means, axis=0)
    means_se = np.sqrt(np.sum(np.square(level_ses), axis=0))
    return {"means": means, "means_se": means_se,
            "level_means": level_means, "level_ses": level_ses,
            "correction_l1": np.asarray(corr_l1),
            "wall_s": time.perf_counter() - t0}


def lorenz96_step(dt: float = 0.05, forcing: float = 8.0,
                  model_noise: float = 0.0):
    """The 40-variable Lorenz-96 transition (RK4, one assimilation
    window per call) — THE standard chaotic EnKF testbed.

    :return: ``(x [J, d], key, t) -> x' [J, d]`` for :func:`enkf`.
    """
    def rhs(x):
        return ((jnp.roll(x, -1, axis=-1) - jnp.roll(x, 2, axis=-1))
                * jnp.roll(x, 1, axis=-1) - x + forcing)

    def transition(x, key, t):
        k1 = rhs(x)
        k2 = rhs(x + 0.5 * dt * k1)
        k3 = rhs(x + 0.5 * dt * k2)
        k4 = rhs(x + dt * k3)
        x = x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        if model_noise > 0.0:
            x = x + model_noise * jax.random.normal(key, x.shape,
                                                    x.dtype)
        return x

    return transition
