"""Backward SDE solver: regression-based probabilistic solution of
semilinear parabolic PDEs — beyond-reference tier (GeoMop/MLMC has no
backward-equation capability; this completes the forward SDE family of
sim/sde.py with the Feynman-Kac NONLINEAR direction).

The BSDE

    dX_t = mu(X_t, t) dt + sigma(X_t, t) dW_t,      X_0 = x0,
    -dY_t = f(t, X_t, Y_t, Z_t) dt - Z_t dW_t,      Y_T = g(X_T),

has ``Y_t = u(t, X_t)``, ``Z_t = sigma ∂x u(t, X_t)`` for the
semilinear PDE ``u_t + mu u_x + 1/2 sigma^2 u_xx + f(t, x, u,
sigma u_x) = 0``, ``u(T, .) = g`` (Pardoux-Peng). The solver is the
Gobet-Lemor-Warin least-squares scheme (Ann. Appl. Prob. 15(3),
2005): simulate a forward path panel once, then one backward
``lax.scan`` over dates computing the conditional expectations

    E_i[Y_{i+1}]           (continuation),
    Z_i = E_i[Y_{i+1} DW_i] / dt     (martingale representation),

by polynomial regression on X_i, upgraded in three measured ways:

* TRAPEZOIDAL (Crank-Nicolson) driver quadrature — the left-Riemann
  variant's O(dt) bias was measured at ~0.3 dt on the manufactured
  test (10 sigma at n=16); the theta-scheme evaluates half the driver
  weight at the (pathwise known) right endpoint, with the IMPLICIT
  left half resolved by Picard iteration (a dt-Lipschitz contraction —
  3 sweeps default);
* two-fold CROSS-FITTING of the regressions (fit on one half of the
  paths, predict the other) — removes the O(K/B)-per-date in-sample
  bias a nonlinear driver would rectify across the cascade;
* HONEST error bars: in-sample OLS preserves the batch mean exactly
  (the constant is in the basis; verified to 1e-13 through a 64-date
  chain), so the estimator telescopes to the mean of a PATHWISE
  accumulator ``g(X_T) + sum w_i f_i`` whose variance/B is the true
  CLT error — the variance of the smoothed values understates it ~10x
  (measured), which once masqueraded as a 24-sigma "bias".

At date 0 the state is deterministic, so plain means replace the
regressions and ``(Y_0, Z_0)`` come with CLT standard errors.

Device-first: the whole backward pass is one jitted scan (per date: one
basis Vandermonde, two blocked [K, K] normal-equation solves
shared by BOTH regression targets, the Picard sweep as a tiny
unrolled loop); the regressions reuse the f32-hardened machinery of
sim/american.py (bounded accumulation windows, Jacobi-equilibrated
solves) plus per-date basis standardization (early-date state clouds
are tight — a fixed-center basis is (spread/scale)^(-2K)
ill-conditioned).

Validation anchors (tests/test_bsde.py): f = 0 reduces to plain
Feynman-Kac (GBM call expectation); the linear driver ``f = -r y``
discounts it; the classic Black-Scholes driver
``f = -r y - z (mu - r)/sigma`` recovers the r-discounted price from
a MISPRICED drift (the Z term does the measure change — the sharpest
test of the martingale-representation regression); and a MANUFACTURED
nonlinear driver with known exact solution pins (Y_0, Z_0) including
the quadratic nonlinearity.

No reference analogue; literature: Pardoux & Peng (1990),
Gobet-Lemor-Warin (2005), Bouchard & Touzi (2004).
"""
import time
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.sim.american import _blocked_normal_eq, _equilibrated_solve
from mlmc_tpu.sim.sde import SDEModel

__all__ = ["solve_bsde"]


def solve_bsde(model: SDEModel, terminal: Callable, driver: Callable,
               T: float, n_steps: int, n_paths: int = 1 << 16,
               degree: int = 4, scale: Optional[float] = None,
               picard: int = 3, key=None, dtype=None):
    """Solve the scalar BSDE; returns the time-0 pair.

    :param model: forward :class:`~mlmc_tpu.sim.sde.SDEModel`
        (``drift``/``diffusion``/``s0``).
    :param terminal: ``g(x) -> y`` pure jnp callable.
    :param driver: ``f(t, x, y, z) -> value`` pure jnp callable.
    :param T/n_steps: horizon and Euler grid.
    :param degree: regression basis degree (centered monomials).
    :param scale: basis scale (default ``|x0|`` or 1).
    :param picard: implicit-update fixed-point sweeps.
    :return: dict with ``y0``, ``z0``, ``y0_se`` (CLT error of the
        date-0 mean), ``wall_s``.
    """
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    if picard < 1:
        raise ValueError("picard must be >= 1")
    if key is None:
        key = jax.random.key(0)
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    B = int(n_paths)
    dt = float(T) / int(n_steps)
    x0 = float(model.s0)
    sc = float(scale if scale is not None else (abs(x0) or 1.0))
    K = degree + 1
    sqdt = np.sqrt(dt)

    def basis(x):
        """Per-date STANDARDIZED monomials: at early dates the state
        cloud is tight (std ~ sqrt(t_i)), so a fixed-center basis is
        severely collinear (cond ~ (spread/scale)^(-2K)).
        Standardizing spans the same space — predictions are
        affine-reparametrization-invariant — while keeping the Gram
        condition O(1) at every date, so the f32 path stays usable at
        any date count."""
        mu = jnp.mean(x)
        sd = jnp.maximum(jnp.std(x), 1e-12 * sc)
        return ((x - mu) / sd)[:, None] ** jnp.arange(K, dtype=dtype)

    half = B // 2

    def fit_predict(x, y2):
        """Two-fold CROSS-FITTED regression of both targets
        (continuation and Z numerator): coefficients fit on one half
        of the (iid) paths predict the other half, so the prediction
        noise is independent of the fit noise — the standard guard
        against the O(K/B)-per-date in-sample regression bias, which
        a NONLINEAR driver would otherwise rectify across the
        backward cascade. y2 [B, 2] -> pred [B, 2]."""
        G = basis(x)
        eps = 1e-6 if jnp.finfo(dtype).bits < 64 else 1e-12
        hi = jax.lax.Precision.HIGHEST
        A1, b1 = _blocked_normal_eq(G[:half], y2[:half])
        A2, b2 = _blocked_normal_eq(G[half:], y2[half:])
        c1 = _equilibrated_solve(A1, b1, eps)
        c2 = _equilibrated_solve(A2, b2, eps)
        return jnp.concatenate([jnp.matmul(G[:half], c2, precision=hi),
                                jnp.matmul(G[half:], c1, precision=hi)])

    @jax.jit
    def run(k):
        k_w = jax.random.split(k, n_steps)

        # forward panel: states X_0..X_{n-1} paired with their DW
        def fwd_step(carry, xs):
            x, i = carry
            kk = xs
            t = i.astype(dtype) * dt
            dw = sqdt * jax.random.normal(kk, (B,), dtype)
            x_next = x + model.drift(x, t) * dt \
                + model.diffusion(x, t) * dw
            return (x_next, i + 1), (x, dw)

        (x_T, _), (xs, dws) = jax.lax.scan(
            fwd_step, (jnp.full((B,), x0, dtype), jnp.zeros((), jnp.int32)),
            k_w)
        y = terminal(x_T)

        # trapezoidal (Crank-Nicolson) theta-scheme: per interval the
        # driver integral is split dt/2 left + dt/2 right, with the
        # right endpoint evaluated PATHWISE from the previous backward
        # step's (Y, Z); the terminal interval (no Z_T available
        # without g') keeps its full weight on the left — one O(dt^2)
        # interval, O(dt^2) total quadrature (vs the measured ~0.3 dt
        # bias of the left-Riemann variant on the manufactured test).
        # acc telescopes the ESTIMATOR pathwise: in-sample OLS keeps
        # the batch mean exactly (the constant is in the basis), so
        # mean(Y_i-fitted) == mean(rhs) at every date and
        # y0 == mean(acc) + the deterministic date-0 driver term. The
        # estimator's sampling variance is therefore var(acc)/B — the
        # variance of the SMOOTHED values would understate it by the
        # conditional-variance factor (measured 10x on the f=0 chain).
        def bwd_step(carry, step):
            y, z, acc, x_next, w = carry     # pathwise at date i+1
            x, dw, i = step                  # date i in 1..n_steps-1
            t = i.astype(dtype) * dt
            f_right = driver(t + dt, x_next, y, z)
            rhs = y + w * f_right
            pred = fit_predict(x, jnp.stack([rhs, y * dw], axis=1))
            ey, z_new = pred[:, 0], pred[:, 1] / dt
            y_new = ey
            for _ in range(picard):
                y_new = ey + (dt - w) * driver(t, x, y_new, z_new)
            acc = acc + w * f_right \
                + (dt - w) * driver(t, x, y_new, z_new)
            return (y_new, z_new, acc, x,
                    jnp.asarray(dt / 2, dtype)), None

        # dates n_steps-1 .. 1 regress; date 0 is deterministic
        (y, z, acc, x1, w), _ = jax.lax.scan(
            bwd_step,
            (y, jnp.zeros((B,), dtype), y, x_T, jnp.asarray(0.0, dtype)),
            (xs[1:][::-1], dws[1:][::-1],
             jnp.arange(1, n_steps, dtype=jnp.int32)[::-1]))
        f1 = driver(jnp.asarray(dt, dtype), x1, y, z)
        ey0 = jnp.mean(y + w * f1)
        z0 = jnp.mean(y * dws[0]) / dt
        y0 = ey0
        for _ in range(picard):
            y0 = ey0 + (dt - w) * driver(jnp.zeros((), dtype),
                                         jnp.full((), x0, dtype),
                                         y0, z0)
        acc = acc + w * f1
        var0 = jnp.mean((acc - jnp.mean(acc)) ** 2)
        # z0's own CLT variance: Var[Y_1 DW_0] / dt^2
        varz = jnp.mean((y * dws[0] / dt - z0) ** 2)
        return y0, z0, var0, varz

    t0 = time.perf_counter()
    y0, z0, var0, varz = [float(v) for v in jax.device_get(run(key))]
    return {"y0": y0, "z0": z0,
            "y0_se": float(np.sqrt(var0 / B)),
            "z0_se": float(np.sqrt(varz / B)),
            "wall_s": time.perf_counter() - t0}
