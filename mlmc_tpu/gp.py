"""Gaussian-process emulation and multilevel cokriging —
beyond-reference tier.

Completes the surrogate family: mlmc_tpu/pce.py gives SPECTRAL
surrogates (global polynomials, closed-form Sobol'), this module gives
the NONPARAMETRIC one — Gaussian-process regression with calibrated
predictive uncertainty — plus the multifidelity version that is this
framework's identity: Kennedy & O'Hagan's autoregressive cokriging
(Biometrika 87, 2000) in Le Gratiet's recursive formulation (IJUQ 4,
2014),

    f_l(x) = rho_l f_{l-1}(x) + delta_l(x),    delta_l ~ GP,

so a handful of fine-model runs plus many coarse runs give a
fine-accuracy emulator — the surrogate analogue of the MLMC telescope.

Device-first design: the fit is one jitted Cholesky of the [n, n] kernel
matrix (matmul pairwise-distance expansion and triangular solves);
hyperparameters (ARD log lengthscales, signal, noise unless fixed, a
constant mean, and the autoregressive rho at coupled levels — rho is
just the coefficient of a known offset regressor, so it rides the SAME
optimization) maximize the exact log marginal likelihood by its
``jax.grad`` inside ONE jitted optax scan — no host round trips in the
loop. Prediction is two matmuls per query batch. The emulator plugs
straight into :class:`~mlmc_tpu.multifidelity.MFMC` as a near-free
model, into :mod:`~mlmc_tpu.oed` as a forward map, and into the
EKI/SMC pilots.

The reference framework has no surrogate capability (its closest
object is the moment-based maxent density — a distribution, not a
response surface).
"""
import time
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["GP", "MultilevelGP", "bayes_opt", "rbf_kernel",
           "matern52_kernel"]


def _sqdist(a, b, inv_ls):
    """Scaled pairwise squared distances: a [n, d], b [m, d] -> [n, m]
    via the matmul-friendly |a|^2 + |b|^2 - 2 a.b expansion."""
    a = a * inv_ls[None, :]
    b = b * inv_ls[None, :]
    d2 = (jnp.sum(a * a, 1)[:, None] + jnp.sum(b * b, 1)[None, :]
          - 2.0 * jnp.matmul(a, b.T,
                             precision=jax.lax.Precision.HIGHEST))
    return jnp.maximum(d2, 0.0)


def rbf_kernel(a, b, log_ls, log_sf):
    """Squared-exponential: sf^2 exp(-d2/2), ARD lengthscales."""
    d2 = _sqdist(a, b, jnp.exp(-log_ls))
    return jnp.exp(2.0 * log_sf) * jnp.exp(-0.5 * d2)


def matern52_kernel(a, b, log_ls, log_sf):
    """Matern 5/2 (twice-differentiable samples), ARD lengthscales."""
    r = jnp.sqrt(_sqdist(a, b, jnp.exp(-log_ls)) + 1e-30)
    s = np.sqrt(5.0) * r
    return (jnp.exp(2.0 * log_sf) * (1.0 + s + s * s / 3.0)
            * jnp.exp(-s))


_KERNELS = {"rbf": rbf_kernel, "matern52": matern52_kernel}


class GP:
    """Exact Gaussian-process regression with on-device
    marginal-likelihood hyperparameter optimization.

    :param kernel: "rbf" | "matern52" | a callable
        ``(a, b, log_ls, log_sf) -> [n, m]``.
    :param noise: observation noise sd; a float FIXES it, None learns
        it (log-parameterized, initialized at 1e-2 * sd(y)).
    """

    def __init__(self, kernel="rbf", noise: Optional[float] = None,
                 dtype=None):
        self._kernel = (_KERNELS[kernel]
                        if isinstance(kernel, str) else kernel)
        self._noise = noise
        self._dtype = jnp.dtype(dtype or jnp.result_type(float))
        self._state = None

    def fit(self, X, y, offset=None, n_steps: int = 250,
            learning_rate: float = 0.05):
        """Fit to X [n, d], y [n]: optimize (ARD lengthscales, signal,
        noise unless fixed, constant mean — and the coefficient rho of
        the known ``offset`` regressor, if given: the residual model is
        ``y - rho*offset - mean ~ GP``) by Adam on the exact marginal
        likelihood, the whole loop one jitted lax.scan."""
        import optax

        X = jnp.asarray(X, self._dtype)
        y = jnp.asarray(y, self._dtype)
        if X.ndim != 2 or y.shape != (X.shape[0],):
            raise ValueError("need X [n, d], y [n]")
        has_offset = offset is not None
        b = (jnp.asarray(offset, self._dtype) if has_offset
             else jnp.zeros_like(y))
        if b.shape != y.shape:
            raise ValueError("offset must match y's shape")
        n, d = X.shape
        y_sd = jnp.maximum(jnp.std(y), 1e-12)
        span = jnp.maximum(jnp.max(X, 0) - jnp.min(X, 0), 1e-6)
        fixed_noise = self._noise is not None
        # rho initialized at its least-squares value against the
        # offset regressor (the joint likelihood is multimodal in rho
        # — a bad basin flips its sign with few data points), mean at
        # the residual mean, noise at 10% of sd(y) (a tiny init sits
        # in the basin of the zero-noise interpolation optimum)
        if has_offset:
            bc = b - jnp.mean(b)
            rho0 = (bc @ (y - jnp.mean(y))
                    / jnp.maximum(bc @ bc, 1e-12))
        else:
            rho0 = jnp.asarray(0.0, self._dtype)
        r0 = y - rho0 * b
        r_sd = jnp.maximum(jnp.std(r0), 1e-12)
        params0 = (jnp.log(0.3 * span),                 # log_ls [d]
                   jnp.log(r_sd),                       # log_sf
                   jnp.log(jnp.asarray(self._noise, self._dtype))
                   if fixed_noise else jnp.log(0.1 * r_sd),
                   jnp.mean(r0),                        # mean
                   jnp.asarray(rho0, self._dtype))      # rho
        kernel = self._kernel
        opt = optax.adam(learning_rate)
        # dtype-aware jitter, scaled by the signal variance: a fixed
        # 1e-10 is below f32 resolution and the Cholesky of a smooth
        # (near-rank-deficient) kernel goes NaN on f32 hardware
        jit_eps = 1e-10 if jnp.finfo(self._dtype).bits >= 64 else 1e-5

        def nll(p):
            log_ls, log_sf, log_sn, mean, rho = p
            if fixed_noise:                   # freeze exactly
                log_sn = jax.lax.stop_gradient(log_sn)
            if not has_offset:
                rho = jax.lax.stop_gradient(rho)
            K = kernel(X, X, log_ls, log_sf)
            K = K + (jnp.exp(2.0 * log_sn)
                     + jit_eps * jnp.exp(2.0 * log_sf)) * jnp.eye(
                n, dtype=K.dtype)
            L = jnp.linalg.cholesky(K)
            r = y - mean - rho * b
            alpha = jax.scipy.linalg.cho_solve((L, True), r)
            val = (0.5 * r @ alpha + jnp.sum(jnp.log(jnp.diag(L)))
                   + 0.5 * n * jnp.log(2.0 * jnp.pi))
            return val, (L, alpha)

        @jax.jit
        def run(params0):
            def step(carry, _):
                params, opt_state = carry
                (val, _), g = jax.value_and_grad(
                    nll, has_aux=True)(params)
                updates, opt_state = opt.update(g, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), val

            (params, _), nlls = jax.lax.scan(
                step, (params0, opt.init(params0)), None,
                length=n_steps)
            _, (L, alpha) = nll(params)       # final factorization
            return params, L, alpha, nlls

        t0 = time.perf_counter()
        params, L, alpha, nlls = run(params0)
        self._state = dict(X=X, params=params, L=L, alpha=alpha)
        self.nll_trace = np.asarray(jax.device_get(nlls), np.float64)
        self.wall_s = time.perf_counter() - t0
        if not np.isfinite(self.nll_trace[-1]):
            raise FloatingPointError(
                "marginal-likelihood optimization diverged — scale the "
                "inputs/outputs or fix the noise level")
        return self

    def predict(self, Xs, include_noise: bool = False):
        """Posterior mean and sd of the RESIDUAL model at Xs [m, d]
        (one jitted pass). With an ``offset`` fit, add
        ``rho * offset(Xs)`` yourself — :class:`MultilevelGP` does."""
        if self._state is None:
            raise RuntimeError("fit() first")
        st = self._state
        Xs = jnp.asarray(Xs, self._dtype)
        kernel = self._kernel

        @jax.jit
        def run(Xs):
            log_ls, log_sf, log_sn, mean, _ = st["params"]
            Ks = kernel(Xs, st["X"], log_ls, log_sf)     # [m, n]
            mu = mean + Ks @ st["alpha"]
            V = jax.scipy.linalg.solve_triangular(
                st["L"], Ks.T, lower=True)               # [n, m]
            var = jnp.exp(2.0 * log_sf) - jnp.sum(V * V, axis=0)
            if include_noise:
                var = var + jnp.exp(2.0 * log_sn)
            return mu, jnp.sqrt(jnp.maximum(var, 1e-30))

        mu, sd = jax.device_get(run(Xs))
        return np.asarray(mu), np.asarray(sd)

    @property
    def hyperparameters(self):
        log_ls, log_sf, log_sn, mean, rho = jax.device_get(
            self._state["params"])
        return {"lengthscales": np.exp(np.asarray(log_ls)),
                "signal_sd": float(np.exp(log_sf)),
                "noise_sd": float(np.exp(log_sn)),
                "mean": float(mean), "rho": float(rho)}


class MultilevelGP:
    """Recursive autoregressive cokriging (Kennedy-O'Hagan 2000, Le
    Gratiet 2014): level l's data is regressed as ``y_l = rho_l *
    m_{l-1}(X_l) + delta_l(X_l)`` where ``m_{l-1}`` is the ALREADY
    FITTED previous emulator's posterior mean (a known offset
    regressor, so ``rho_l`` is learned inside the same jitted
    marginal-likelihood scan) and ``delta_l ~ GP``.

    Predictions compose recursively: ``mean_l = rho_l mean_{l-1} +
    delta-mean``, ``var_l = rho_l^2 var_{l-1} + delta-var``
    (independence of the discrepancy from the coarse emulator — Le
    Gratiet's decomposition). Designs need NOT be nested.
    """

    def __init__(self, kernel="rbf", noise: Optional[float] = None,
                 dtype=None):
        self._kernel_name = kernel
        self._noise = noise
        self._dtype = jnp.dtype(dtype or jnp.result_type(float))
        self.gps = []
        self.rhos = []

    def fit(self, levels: Sequence, n_steps: int = 250,
            learning_rate: float = 0.05):
        """:param levels: list of (X_l [n_l, d], y_l [n_l]) pairs,
        coarse first."""
        if len(levels) < 1:
            raise ValueError("need at least one level")
        t0 = time.perf_counter()
        self.gps, self.rhos = [], []
        for lev, (X, y) in enumerate(levels):
            gp = GP(self._kernel_name, self._noise, self._dtype)
            if lev == 0:
                gp.fit(X, y, n_steps=n_steps,
                       learning_rate=learning_rate)
                self.rhos.append(0.0)
            else:
                m_prev, _ = self.predict(np.asarray(X, np.float64),
                                         upto=lev)
                gp.fit(X, y, offset=m_prev, n_steps=n_steps,
                       learning_rate=learning_rate)
                self.rhos.append(gp.hyperparameters["rho"])
            self.gps.append(gp)
        self.wall_s = time.perf_counter() - t0
        return self

    def predict(self, Xs, upto: Optional[int] = None):
        """Finest-level posterior mean/sd at Xs (or the composition of
        the first ``upto`` levels)."""
        if not self.gps:
            raise RuntimeError("fit() first")
        upto = len(self.gps) if upto is None else upto
        mu, var = None, None
        for lev in range(upto):
            m, s = self.gps[lev].predict(Xs)
            if lev == 0:
                mu, var = m, s ** 2
            else:
                rho = self.rhos[lev]
                mu = rho * mu + m
                var = rho * rho * var + s ** 2
        return mu, np.sqrt(var)


def bayes_opt(fn, bounds, n_init: int = 8, n_iter: int = 25,
              key=None, kernel="matern52",
              noise: Optional[float] = None, n_candidates: int = 4096,
              xi: float = 0.01, fit_steps: int = 200, dtype=None):
    """Bayesian optimization: MINIMIZE an expensive black box over a
    box domain with a GP surrogate and the expected-improvement
    acquisition (Jones-Schonlau-Welch 1998).

    Per iteration: refit the GP on all data (one jitted scan), score EI
    on an Owen-scrambled Sobol' candidate set (`ops.sobol` — the same
    space-filling engine as the QMC tier; fresh scrambling each round
    so candidates never repeat), evaluate the argmax, append. The
    expensive-model evaluation is the only non-device work.

    :param fn: ``x [d] -> scalar`` objective (called on one point at a
        time — it is the EXPENSIVE model).
    :param bounds: [d, 2] array of (lo, hi) per dimension.
    :param noise: observation noise sd — None learns it; pass a small
        float (e.g. 1e-6) for noiseless computer experiments.
    :param xi: EI exploration offset (in units of the observed y sd).
    :return: dict with ``x_best`` [d], ``y_best``, ``X`` [n, d] /
        ``y`` [n] (all evaluations), ``ei_trace``, ``wall_s``.
    """
    from mlmc_tpu.ops import sobol

    bounds = np.asarray(bounds, np.float64)
    if bounds.ndim != 2 or bounds.shape[1] != 2 or np.any(
            bounds[:, 1] <= bounds[:, 0]):
        raise ValueError("bounds must be [d, 2] with hi > lo")
    d = bounds.shape[0]
    if key is None:
        key = jax.random.key(0)
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    lo, span = bounds[:, 0], bounds[:, 1] - bounds[:, 0]
    dv = sobol.direction_numbers(d)

    def draw(k, n, start=0):
        u = np.asarray(sobol.sobol_uniforms(
            dv, start, n, seeds=sobol.scramble_seeds(k, d)),
            np.float64)
        return lo[None, :] + span[None, :] * u

    t0 = time.perf_counter()
    X = draw(jax.random.fold_in(key, 0), n_init)
    y = np.array([float(fn(jnp.asarray(x, dtype))) for x in X])
    ei_trace = []
    for it in range(1, n_iter + 1):
        gp = GP(kernel, noise, dtype).fit(X, y, n_steps=fit_steps)
        cand = draw(jax.random.fold_in(key, it), n_candidates)
        mu, sd = gp.predict(cand)
        y_best = y.min()
        imp = y_best - mu - xi * y.std()
        z = imp / np.maximum(sd, 1e-12)
        # closed-form EI for minimization
        phi = np.exp(-0.5 * z * z) / np.sqrt(2 * np.pi)
        Phi = 0.5 * (1.0 + _erf_np(z / np.sqrt(2.0)))
        ei = imp * Phi + sd * phi
        j = int(np.argmax(ei))
        ei_trace.append(float(ei[j]))
        x_new = cand[j]
        y_new = float(fn(jnp.asarray(x_new, dtype)))
        X = np.vstack([X, x_new[None, :]])
        y = np.append(y, y_new)
    i = int(np.argmin(y))
    return {"x_best": X[i], "y_best": float(y[i]), "X": X, "y": y,
            "ei_trace": np.asarray(ei_trace),
            "wall_s": time.perf_counter() - t0}


def _erf_np(x):
    """Vectorized erf without scipy (Abramowitz-Stegun 7.1.26 is not
    accurate enough for EI tails — use math.erf elementwise; the
    candidate sets are small host arrays)."""
    import math
    return np.vectorize(math.erf)(x)
