"""Maximum-entropy PDF reconstruction from moments — on-device solver.

Re-design of reference mlmc/tool/simple_distribution.py:9-841. The density
model is identical::

    rho(x) = exp( - sum_i lambda_i * phi_i(x) / sigma_i )

and the Lagrange multipliers solve the convex program

    min_lambda  sum_i mu_i lambda_i / sigma_i  +  int_D rho(x) dx

whose gradient is exactly the moment residual ``mu/sigma - int rho phi/sigma``
(reference :259-327). Differences from the reference:

* the Newton iteration runs as a SINGLE jitted ``lax.while_loop`` on device
  in float64 (scoped ``jax.enable_x64``, whatever the global flag):
  functional / gradient / Hessian are quadrature dot-products over a fixed
  Gauss-Legendre panel grid, so each iteration is two small matmuls plus a
  solve of an R x R system,
* scipy's adaptive quadrature (reference :198-238 reuses ``info['alist']``)
  is replaced by a host-side h-adaptive panel builder (Gauss-21 per panel,
  bisect-worst-first on the same integrand ``rho * phi_last``); the panel set
  is refreshed between Newton restarts under the same guard
  ``|grad| * |dlambda| < quad_tol`` as the reference (:204-212),
* the exp argument is clipped to +-200 exactly like the reference (:104).

API parity: ``SimpleDistribution`` (estimate_density_minimize, density, cdf),
``compute_exact_moments``/``compute_semiexact_moments``, ``compute_exact_cov``
/``compute_semiexact_cov``, ``KL_divergence``, ``L2_distance``,
``detect_treshold_slope_change``/``best_p1_fit``/``best_fit_all``,
``lsq_reconstruct`` and ``construct_ortogonal_moments``.
"""
import functools
import types

import numpy as np
import scipy.integrate as integrate
import scipy.linalg
import scipy.optimize

import jax
import jax.numpy as jnp

import mlmc_tpu.moments

EXACT_QUAD_LIMIT = 1000

_GAUSS_DEGREE = 21
# leggauss on [-1, 1]
_G_PTS, _G_WTS = np.polynomial.legendre.leggauss(_GAUSS_DEGREE)


# ===================================================================== #
# host-side h-adaptive Gauss panel builder
# ===================================================================== #
def adaptive_panels(f, a, b, tol=1e-10, max_panels=256, init_panels=8):
    """h-adaptive panelization: bisect panels until the estimated error is
    below tol (compare one Gauss-21 panel against its two halves).

    Fully VECTORIZED: each refinement round evaluates ``f`` on the points of
    ALL panels in one call, so ``f`` may be a traced/batched device function
    without per-panel dispatch overhead.

    :param f: vectorized integrand, maps 1-D array -> 1-D array
    :return: (breakpoints array [K+1], integral estimate)
    """
    panels = np.stack([np.linspace(a, b, init_panels + 1)[:-1],
                       np.linspace(a, b, init_panels + 1)[1:]], axis=1)

    def _estimates(pan):
        pa, pb = pan[:, 0:1], pan[:, 1:2]
        mid = 0.5 * (pa + pb)

        def pts(lo, hi):
            return (_G_PTS[None, :] + 1) / 2 * (hi - lo) + lo

        K = len(pan)
        X = np.concatenate([pts(pa, pb), pts(pa, mid), pts(mid, pb)], axis=0)
        FX = np.asarray(f(X.ravel()), dtype=float).reshape(3 * K, _GAUSS_DEGREE)
        w_full = _G_WTS[None, :] * (pb - pa) / 2
        w_h = _G_WTS[None, :] * (mid - pa) / 2  # halves have equal width
        i1 = np.sum(FX[:K] * w_full, axis=1)
        i2 = np.sum(FX[K:2 * K] * w_h, axis=1) + np.sum(FX[2 * K:] * w_h, axis=1)
        return i1, i2

    i1, i2 = _estimates(panels)
    err = np.abs(i2 - i1)
    for _round in range(40):
        K = len(panels)
        total_err = float(np.sum(err))
        if total_err < tol or K >= max_panels:
            break
        # split every panel holding a non-negligible share of the error
        # (at least the worst one), capped by the panel budget
        budget = max_panels - K
        thresh = min(tol / (2 * K), float(np.max(err)))
        split_idx = np.nonzero(err >= thresh)[0]
        if len(split_idx) > budget:
            split_idx = split_idx[np.argsort(err[split_idx])[::-1][:budget]]
        keep = np.ones(K, dtype=bool)
        keep[split_idx] = False

        pa, pb = panels[split_idx, 0], panels[split_idx, 1]
        mid = 0.5 * (pa + pb)
        new_panels = np.concatenate(
            [np.stack([pa, mid], axis=1), np.stack([mid, pb], axis=1)], axis=0)
        n1, n2 = _estimates(new_panels)

        panels = np.concatenate([panels[keep], new_panels], axis=0)
        i2 = np.concatenate([i2[keep], n2])
        err = np.concatenate([err[keep], np.abs(n2 - n1)])

    order = np.argsort(panels[:, 0])
    panels = panels[order]
    breaks = np.concatenate([panels[:, 0], panels[-1:, 1]])
    return breaks, float(np.sum(i2))


def panels_to_quadrature(breaks):
    """Expand panel breakpoints into flat Gauss-21 (points, weights)."""
    a = breaks[:-1, None]
    b = breaks[1:, None]
    points = (_G_PTS[None, :] + 1) / 2 * (b - a) + a
    weights = _G_WTS[None, :] * (b - a) / 2
    return points.flatten(), weights.flatten()


# ===================================================================== #
# jitted Newton core
# ===================================================================== #
@functools.partial(jax.jit, static_argnames=("max_iter",))
def _newton_solve(q_mom, q_weights, mu_scaled, lam0, tol, max_iter=40):
    """Damped Newton for the maxent dual on a fixed quadrature grid.

    :param q_mom: [Q, R] moment values at quad points, PRE-divided by sigma
    :param q_weights: [Q]
    :param mu_scaled: [R] moment means / sigma
    :param lam0: [R] initial multipliers
    :param tol: gradient-norm stopping tolerance
    :return: (lam, grad_norm, n_iter)

    The functional F = mu_scaled . lam + int exp(-q_mom . lam) is smooth and
    convex; Newton + backtracking converges globally. H is SPD (weighted
    Gram matrix of the moment basis), solved via Cholesky with a tiny
    Levenberg regularization for near-singular bases.
    """
    R = q_mom.shape[1]
    eye = jnp.eye(R, dtype=q_mom.dtype)

    def density_w(lam):
        power = -(q_mom @ lam)
        power = jnp.clip(power, -200.0, 200.0)
        return jnp.exp(power) * q_weights

    def functional(lam):
        return mu_scaled @ lam + jnp.sum(density_w(lam))

    def gradient(lam):
        return mu_scaled - q_mom.T @ density_w(lam)

    def hessian(lam):
        rho_w = density_w(lam)
        return (q_mom.T * rho_w[None, :]) @ q_mom

    def body(state):
        lam, _, it = state
        g = gradient(lam)
        H = hessian(lam)
        nu = 1e-13 * jnp.trace(H) / R + 1e-300
        d = jax.scipy.linalg.solve(H + nu * eye, -g, assume_a="pos")
        f0 = functional(lam)
        slope = g @ d

        # backtracking line search: largest 2^-k with Armijo decrease
        def ls_body(k, carry):
            alpha, accepted = carry
            step = jnp.where(accepted, alpha, 2.0 ** (-k.astype(lam.dtype)))
            f1 = functional(lam + step * d)
            ok = f1 <= f0 + 1e-4 * step * slope
            return (jnp.where(accepted, alpha, jnp.where(ok, step, alpha)),
                    accepted | ok)

        alpha, accepted = jax.lax.fori_loop(
            0, 40, ls_body, (jnp.asarray(0.0, lam.dtype), jnp.asarray(False))
        )
        # no acceptable step (already at machine-precision optimum): stay put
        lam_new = lam + alpha * d
        g_new = gradient(lam_new)
        return lam_new, jnp.linalg.norm(g_new), it + 1

    def cond(state):
        _, gnorm, it = state
        return (gnorm > tol) & (it < max_iter)

    lam0 = jnp.asarray(lam0)
    g0 = jnp.linalg.norm(gradient(lam0))
    lam, gnorm, n_it = jax.lax.while_loop(cond, body, (lam0, g0, jnp.asarray(0)))
    return lam, gnorm, n_it


def _newton_solve_f64(q_mom, q_weights, mu_scaled, lam0, tol, max_iter=40):
    """``_newton_solve`` on the device in float64, whatever the global x64
    flag: the tolerances go down to 1e-10, and outside the scoped flag
    ``jnp.asarray`` would narrow the host f64 inputs to float32.

    The quad axis is padded to a power-of-two bucket (zero rows with zero
    weights are exact no-ops) so jit compiles once per bucket size.

    :return: (lam, grad_norm, n_iter) as host values
    """
    q = q_mom.shape[0]
    bucket = 1 << max(q - 1, 1).bit_length()
    q_mom_p = np.zeros((bucket, q_mom.shape[1]))
    q_mom_p[:q] = q_mom
    w_p = np.zeros(bucket)
    w_p[:q] = q_weights
    with jax.enable_x64(True):
        return jax.device_get(_newton_solve(
            jnp.asarray(q_mom_p), jnp.asarray(w_p), jnp.asarray(mu_scaled),
            jnp.asarray(lam0), tol, max_iter=max_iter))


def _newton_solve_np(q_mom, q_weights, mu_scaled, lam0, tol, max_iter=40):
    """Host-numpy mirror of ``_newton_solve`` (identical math).

    Selectable via ``solver_backend='numpy'`` and used as the parity
    reference for the device solvers in tests.
    """
    R = q_mom.shape[1]
    eye = np.eye(R)

    def density_w(lam):
        power = np.clip(-(q_mom @ lam), -200.0, 200.0)
        return np.exp(power) * q_weights

    def functional(lam):
        return mu_scaled @ lam + np.sum(density_w(lam))

    def gradient(lam):
        return mu_scaled - q_mom.T @ density_w(lam)

    def hessian(lam):
        rho_w = density_w(lam)
        return (q_mom.T * rho_w[None, :]) @ q_mom

    lam = np.array(lam0, dtype=float)
    gnorm = np.linalg.norm(gradient(lam))
    it = 0
    while gnorm > tol and it < max_iter:
        g = gradient(lam)
        H = hessian(lam)
        nu = 1e-13 * np.trace(H) / R + 1e-300
        d = np.linalg.solve(H + nu * eye, -g)
        f0 = functional(lam)
        slope = g @ d
        alpha = 1.0
        for _ in range(40):
            if functional(lam + alpha * d) <= f0 + 1e-4 * alpha * slope:
                break
            alpha *= 0.5
        else:
            alpha = 0.0
        lam = lam + alpha * d
        gnorm = np.linalg.norm(gradient(lam))
        it += 1
    return lam, gnorm, it


class SimpleDistribution:
    """Maxent density from (moment means, moment variances).

    Parity contract with reference SimpleDistribution (:9-327): the fitted
    ``multipliers`` satisfy the same first-order conditions on the same
    density model, so reconstructed pdfs agree to quadrature tolerance.
    """

    def __init__(self, moments_obj, moment_data, domain=None, force_decay=(True, True),
                 verbose=False, solver_backend="auto"):
        """
        :param moments_obj: moment basis (mlmc_tpu.moments.Moments)
        :param moment_data: array [R, 2] of (moment mean, moment var)
        :param domain: explicit reconstruction domain; None = moments domain
        :param force_decay: enforce pdf decay at each endpoint (penalty)
        """
        if domain is None:
            domain = moments_obj.domain
        self.domain = domain
        self.decay_penalty = force_decay
        self._verbose = verbose

        if moment_data is not None:
            self.moment_means = np.asarray(moment_data[:, 0], dtype=float)
            self.moment_errs = np.sqrt(np.asarray(moment_data[:, 1], dtype=float))

        self.multipliers = None
        self.approx_size = len(self.moment_means)
        assert moments_obj.size >= self.approx_size
        self.moments_fn = moments_obj

        self._gauss_degree = _GAUSS_DEGREE
        self._penalty_coef = 0  # reference default: endpoint penalty off
        self._max_newton_iter = 40
        self._max_panels = 256
        # 'jax' = jitted float64 device Newton; 'numpy' = host mirror
        if solver_backend == "auto":
            solver_backend = "jax"
        if solver_backend not in ("jax", "numpy"):
            raise ValueError("solver_backend must be 'auto', 'jax' or "
                             "'numpy', not %r" % (solver_backend,))
        self._solver_backend = solver_backend

    # ------------------------------------------------------------------ #
    def eval_moments(self, x):
        # numpy path: the adaptive quadrature calls this with many small
        # batches; host evaluation avoids device round-trips (the Newton
        # solve itself runs on device over the assembled grid)
        return np.asarray(self.moments_fn.eval_all_np(np.asarray(x, dtype=float),
                                                      self.approx_size))

    def density(self, value):
        """Density rho(x) = exp(-sum lambda_i phi_i(x) / sigma_i)."""
        value = np.atleast_1d(np.asarray(value, dtype=float))
        moms = self.eval_moments(value)
        power = -np.sum(moms * self.multipliers / self._moment_errs, axis=-1)
        power = np.minimum(np.maximum(power, -200), 200)
        return np.exp(power)

    def density_log(self, value):
        moms = self.eval_moments(value)
        return -np.sum(moms * self.multipliers / self._moment_errs, axis=-1)

    def cdf(self, values):
        """CDF at arbitrary query points (reference :108-125 semantics).

        All panels integrate in ONE vectorized 10-point Gauss-Legendre
        sweep: the sorted in-domain queries split [a, x_k] into adjacent
        panels whose increments cumulative-sum to the CDF; results scatter
        back to the input positions, out-of-domain queries clamp to 0/1.
        """
        values = np.atleast_1d(values).astype(float)
        a, b = self.domain
        order = np.argsort(values, kind="stable")
        svals = values[order]
        # panel breakpoints: domain start, then each clipped query; zero
        # length panels (clamped queries) contribute nothing
        pts = np.concatenate(([a], np.clip(svals, a, b)))
        gx, gw = np.polynomial.legendre.leggauss(10)
        half = 0.5 * (pts[1:] - pts[:-1])
        mid = 0.5 * (pts[1:] + pts[:-1])
        nodes = mid[:, None] + half[:, None] * gx[None, :]
        dens = np.asarray(self.density(nodes.ravel())).reshape(nodes.shape)
        cdf_sorted = np.cumsum(half * (dens @ gw))
        cdf_sorted[svals <= a] = 0.0
        cdf_sorted[svals >= b] = 1.0
        out = np.empty(len(values))
        out[order] = cdf_sorted
        return out

    # ------------------------------------------------------------------ #
    def _initialize_params(self, size, tol=None):
        assert self.domain is not None
        assert tol is not None
        self._quad_tolerance = 1e-10
        self._moment_errs = self.moment_errs

        # uniform density start
        self.multipliers = np.zeros(size)
        self.multipliers[0] = -np.log(1 / (self.domain[1] - self.domain[0]))
        self._quad_log = []

        self._end_point_diff = self.end_point_derivatives()
        self._update_quadrature(self.multipliers, force=True)

    def end_point_derivatives(self):
        """One-sided finite-difference moment derivatives at the domain
        endpoints, used by the decay penalty (reference :240-252): inward
        difference at the left end, outward at the right, zero where the
        endpoint carries no penalty."""
        eps = 1e-10
        diffs = np.zeros((2, self.approx_size))
        for side, (edge, inward) in enumerate(
                [(self.domain[0], eps), (self.domain[1], -eps)]):
            if self.decay_penalty[side]:
                # inward difference (f(edge + inward) - f(edge)) / eps —
                # the reference's left/right one-sided stencils (:244-249)
                diffs[side] = (self.eval_moments(edge + inward)
                               - self.eval_moments(edge))[0]
        return diffs / eps / self._moment_errs[None, :]

    def _density_integrand_last_mom(self, multipliers):
        """rho(x) * phi_{R-1}(x): the panel-refinement driver (:213-216)."""
        errs = self._moment_errs

        def f(x):
            moms = self.eval_moments(x)
            power = -np.sum(moms * multipliers / errs, axis=-1)
            power = np.minimum(np.maximum(power, -200), 200)
            return np.exp(power) * np.abs(moms[:, -1])

        return f

    def _update_quadrature(self, multipliers, force=False):
        """Rebuild the Gauss panel grid for the current multipliers.

        Skipped when the previous grid is still accurate (same guard as
        reference :204-212).
        """
        if not force:
            # the grid only needs rebuilding when the multipliers moved far
            # enough for the OLD grid's gradient to mispredict the density
            # mass by more than the quad tolerance — both the coarse
            # norm-product bound and the directional first-order estimate
            # must exceed it (same guard semantics as reference :204-212)
            step = multipliers - self._last_multipliers
            grad = self._last_gradient
            if np.linalg.norm(grad) * np.linalg.norm(step) \
                    < self._quad_tolerance:
                return False
            if abs(float(np.dot(grad, step))) < self._quad_tolerance:
                return False

        f = self._density_integrand_last_mom(multipliers)
        breaks, _ = adaptive_panels(
            f, self.domain[0], self.domain[1],
            tol=self._quad_tolerance, max_panels=self._max_panels,
        )
        pts, wts = panels_to_quadrature(breaks)
        self._quad_points = pts
        self._quad_weights = wts
        self._quad_moments = self.eval_moments(pts)

        power = -np.dot(self._quad_moments, multipliers / self._moment_errs)
        power = np.minimum(np.maximum(power, -200), 200)
        q_gradient = self._quad_moments.T * np.exp(power)
        integral = np.dot(q_gradient, self._quad_weights) / self._moment_errs
        self._last_multipliers = multipliers
        self._last_gradient = integral
        return True

    # ------------------------------------------------------------------ #
    # host-side functional / gradient / jacobian on the panel grid.
    # Shared building blocks: the quad-grid density, the linear term
    # mu.lambda/sigma, and the positive part of the endpoint decay
    # directions. The solver itself uses the jitted versions of the same
    # quantities; these numpy twins back the scipy-compatible interface
    # and the parity tests (reference simple_distribution.py:259-327).
    # ------------------------------------------------------------------ #
    def _density_in_quads(self, multipliers):
        power = -np.dot(self._quad_moments, multipliers / self._moment_errs)
        return np.exp(np.clip(power, -200, 200))

    def _linear_term(self, multipliers):
        return float(np.dot(self.moment_means / self._moment_errs,
                            multipliers))

    def _active_decay(self, multipliers):
        """Positive part of the endpoint decay directions (the penalty is
        one-sided: only growth toward an endpoint is punished)."""
        return np.maximum(self._end_point_diff @ multipliers, 0.0)

    def _calculate_functional(self, multipliers):
        self._update_quadrature(multipliers)
        mass = np.dot(self._density_in_quads(multipliers),
                      self._quad_weights)
        fun = self._linear_term(multipliers) + mass
        penalty = np.sum(self._active_decay(multipliers) ** 2)
        return fun + np.abs(fun) * self._penalty_coef * penalty

    def _calculate_gradient(self, multipliers):
        self._update_quadrature(multipliers)
        weighted = self._density_in_quads(multipliers) * self._quad_weights
        integral = (self._quad_moments.T @ weighted) / self._moment_errs
        # the functional value enters the penalty scale; its mass term is
        # recovered from the zeroth integral (phi_0 == 1 on the grid)
        fun = self._linear_term(multipliers) \
            + integral[0] * self._moment_errs[0]
        penalty_grad = 2 * (self._active_decay(multipliers)
                            @ self._end_point_diff)
        return (self.moment_means / self._moment_errs - integral
                + np.abs(fun) * self._penalty_coef * penalty_grad)

    def _calculate_jacobian_matrix(self, multipliers):
        self._update_quadrature(multipliers)
        weighted = self._density_in_quads(multipliers) * self._quad_weights
        scaled_moms = self._quad_moments / self._moment_errs
        jac = (scaled_moms.T * weighted) @ scaled_moms
        fun = self._linear_term(multipliers) \
            + jac[0, 0] * self._moment_errs[0] ** 2
        if self._penalty_coef:
            active = self._active_decay(multipliers) > 0
            for direction in self._end_point_diff[active]:
                jac = jac + (2 * np.abs(fun) * self._penalty_coef
                             * np.outer(direction, direction))
        return jac

    def _calculate_exact_moment(self, multipliers, m=0, full_output=0):
        """Adaptive-quad moment of the current density (normalization)."""
        errs = self._moment_errs

        def integrand(x):
            moms = self.eval_moments(np.atleast_1d(x))
            power = -np.sum(moms * multipliers / errs, axis=-1)
            power = np.minimum(np.maximum(power, -200), 200)
            return float((np.exp(power) * moms[:, m])[0])

        result = integrate.quad(integrand, self.domain[0], self.domain[1],
                                epsabs=self._quad_tolerance, full_output=full_output)
        return result[0], result

    # ------------------------------------------------------------------ #
    def estimate_density_minimize(self, tol=1e-5, reg_param=0.01):
        """Fit the Lagrange multipliers.

        Outer host loop: jitted Newton solve on the current panel grid,
        then re-adapt the grid; stop when the grid is already accurate
        for the solution (usually 2-3 rounds).

        :return: result object with fields x, nit, success, fun_norm,
            eigvals, solver_res, jac (parity with scipy OptimizeResult
            fields the reference consumers read).
        """
        self._initialize_params(self.approx_size, tol)

        mu_scaled = self.moment_means / self._moment_errs
        lam = np.array(self.multipliers)
        total_nit = 0
        gnorm = np.inf
        for _round in range(8):
            q_mom = self._quad_moments / self._moment_errs[None, :]
            if self._solver_backend == "numpy":
                lam_j, gnorm_j, nit = _newton_solve_np(
                    q_mom, self._quad_weights, mu_scaled, lam, tol,
                    max_iter=self._max_newton_iter)
            else:
                lam_j, gnorm_j, nit = _newton_solve_f64(
                    q_mom, self._quad_weights, mu_scaled, lam, tol,
                    max_iter=self._max_newton_iter)
            lam = np.array(lam_j)
            gnorm = float(gnorm_j)
            total_nit += int(nit)
            changed = self._update_quadrature(lam)
            if not changed:
                break
            # re-check the gradient on the refreshed grid
            gnorm = float(np.linalg.norm(self._calculate_gradient(lam)))
            if gnorm <= tol:
                break

        self.multipliers = lam

        result = types.SimpleNamespace()
        result.x = lam
        result.nit = max(total_nit, 1)
        result.fun_norm = gnorm
        result.success = gnorm <= tol * 8  # reference accepts jac_norm < tol
        result.message = "converged" if result.success else \
            "gradient norm {:g} > tol {:g}".format(gnorm, tol)
        jac = self._calculate_jacobian_matrix(lam)
        result.jac = self._calculate_gradient(lam)
        result.solver_res = result.jac
        result.eigvals = np.linalg.eigvalsh(jac)

        # Fix normalization: lambda_0 -= log(moment_0) (reference :82-86)
        moment_0, _ = self._calculate_exact_moment(self.multipliers, m=0)
        self.multipliers[0] -= np.log(moment_0)
        if self._verbose:
            print("size: {} nits: {} tol: {:5.3g} res: {:5.3g}".format(
                self.approx_size, result.nit, tol, gnorm))
        return result


# ===================================================================== #
# exact / semi-exact moment helpers (host diagnostics)
# ===================================================================== #
def compute_exact_moments(moments_fn, density, tol=1e-10):
    """Moments of an exact density via adaptive quadrature (:330-346)."""
    a, b = moments_fn.domain
    integral = np.zeros(moments_fn.size)
    for i in range(moments_fn.size):
        def fn(x, i=i):
            phi = np.asarray(moments_fn.eval_all_np(np.atleast_1d(x)))[..., i][0]
            return float(phi * np.squeeze(density(x)))

        integral[i] = integrate.quad(fn, a, b, epsabs=tol, limit=EXACT_QUAD_LIMIT)[0]
    return integral


def compute_semiexact_moments(moments_fn, density, tol=1e-10):
    """All moments on one adaptive panel grid (:349-377)."""
    a, b = moments_fn.domain

    def driver(x):
        moms = np.asarray(moments_fn.eval_all_np(x))
        return density(x) * np.abs(moms[..., -1])

    breaks, _ = adaptive_panels(driver, a, b, tol=tol, max_panels=256)
    pts, wts = panels_to_quadrature(breaks)
    quad_moments = np.asarray(moments_fn.eval_all_np(pts))
    q_density_w = density(pts) * wts
    return q_density_w @ quad_moments


def compute_exact_cov(moments_fn, density, tol=1e-10):
    """Covariance of exact density, pairwise adaptive quad (:381-399)."""
    a, b = moments_fn.domain
    integral = np.zeros((moments_fn.size, moments_fn.size))
    for i in range(moments_fn.size):
        for j in range(i + 1):
            def fn(x, i=i, j=j):
                m = np.asarray(moments_fn.eval_all_np(np.atleast_1d(x)))[0]
                return float(m[i] * m[j] * np.squeeze(density(x)))

            integral[j][i] = integral[i][j] = integrate.quad(
                fn, a, b, epsabs=tol, limit=EXACT_QUAD_LIMIT)[0]
    return integral


def compute_semiexact_cov(moments_fn, density, tol=1e-10):
    """Covariance on one adaptive panel grid (:402-440)."""
    a, b = moments_fn.domain

    def driver(x):
        moms = np.asarray(moments_fn.eval_all_np(x))
        return density(x) * moms[..., -1] ** 2

    breaks, _ = adaptive_panels(driver, a, b, tol=tol, max_panels=256)
    pts, wts = panels_to_quadrature(breaks)
    quad_moments = np.asarray(moments_fn.eval_all_np(pts))
    q_density_w = density(pts) * wts
    return (quad_moments.T * q_density_w) @ quad_moments


def KL_divergence(prior_density, posterior_density, a, b):
    """D_KL(P|Q) with the normalization-robust integrand (:443-459)."""

    def integrand(x):
        p = float(np.squeeze(prior_density(x)))
        q = max(float(np.squeeze(posterior_density(x))), 1e-300)
        return p * np.log(p / q) - p + q

    value = integrate.quad(integrand, a, b, epsabs=1e-10, limit=EXACT_QUAD_LIMIT)
    return max(value[0], 1e-10)


def L2_distance(prior_density, posterior_density, a, b):
    integrand = lambda x: float(
        np.squeeze((posterior_density(x) - prior_density(x)) ** 2))
    return np.sqrt(integrate.quad(integrand, a, b, limit=EXACT_QUAD_LIMIT))[0]


# ===================================================================== #
# eigenvalue threshold detection + orthogonalization
# ===================================================================== #
def best_fit_all(values, range_a, range_b):
    """Best linear fit over candidate index windows [a, b).

    Same selection criterion as the reference (:556-578): residual sum of
    squares divided by (b-a)^2 — but evaluated for ALL candidate windows at
    once with closed-form least-squares from prefix sums instead of one
    np.polyfit call per window.

    :return: (a, b, [slope, intercept]) of the best window, or None
    """
    values = np.asarray(values, dtype=float)
    n = len(values)
    a_cand = np.asarray(list(range_a), dtype=int)
    b_cand = np.asarray(list(range_b), dtype=int)
    a = np.repeat(a_cand, len(b_cand))
    b = np.tile(b_cand, len(a_cand))
    ok = (a >= 0) & (a + 2 < b) & (b < n)
    if not ok.any():
        return None
    a, b = a[ok], b[ok]

    # prefix sums with a leading zero: S[b] - S[a] sums over [a, b)
    x = np.arange(n, dtype=float)
    zero = np.zeros(1)
    cy, cyy = (np.concatenate([zero, np.cumsum(v)]) for v in (values, values**2))
    cx, cxx, cxy = (np.concatenate([zero, np.cumsum(v)])
                    for v in (x, x * x, x * values))

    m = (b - a).astype(float)
    sy, syy = cy[b] - cy[a], cyy[b] - cyy[a]
    sx, sxx, sxy = cx[b] - cx[a], cxx[b] - cxx[a], cxy[b] - cxy[a]
    var_x = sxx - sx * sx / m
    cov_xy = sxy - sx * sy / m
    slope = cov_xy / var_x
    sse = np.maximum(syy - sy * sy / m - slope * cov_xy, 0.0)

    k = int(np.argmin(sse / (m * m)))
    intercept = (sy[k] - slope[k] * sx[k]) / m[k]
    return int(a[k]), int(b[k]), np.array([slope[k], intercept])


def best_p1_fit(values):
    """Longest low-residual linear window via hierarchical coarsening:
    average point pairs while >12 points remain, then refine the coarse
    window boundaries +-1 at full resolution (reference :560-580)."""
    if len(values) <= 12:
        every = range(len(values))
        return best_fit_all(values, every, every)
    paired = values[: len(values) // 2 * 2].reshape(-1, 2).mean(axis=1)
    a2, b2, _ = best_p1_fit(paired)
    a, b = 2 * a2, 2 * b2
    return best_fit_all(values, (a - 1, a, a + 1), (b - 1, b, b + 1))


def detect_treshold_slope_change(values, log=True):
    """Index where the sorted spectrum leaves its dominant linear trend.

    Fits the longest low-residual line to the (log-)spectrum and
    extrapolates it below the window start; entries under the extrapolated
    trend count as noise (reference :584-608).

    :return: (threshold index, trend-repaired spectrum)
    """
    values = np.asarray(values, dtype=float)
    first_pos = int(np.argmax(values > 0)) if log else 0
    work = np.log(values[first_pos:]) if log else values[first_pos:].copy()

    a, _b, fit = best_p1_fit(work)
    threshold = first_pos + int(a)
    trend = np.polyval(fit, np.arange(-first_pos, a))
    repaired = np.concatenate([trend, work[int(a):]])
    if log:
        repaired = np.exp(repaired)
    return threshold, repaired


def lsq_reconstruct(cov, eval, evec, treshold):
    """Re-fit the cut eigenvector block so the completed basis stays
    orthogonal and diagonalizes cov (L1 penalties, reference :725-752)."""
    keep = evec[:, :treshold]
    free0 = evec[:, treshold:]
    target = np.diag(eval)
    eye = np.eye(cov.shape[0])
    orto_weight = 2.0

    def residual(flat):
        basis = np.hstack([keep, flat.reshape(free0.shape)])
        diag_err = np.abs(basis.T @ cov @ basis - target).sum()
        orto_err = np.abs(basis @ basis.T - eye).sum()
        return diag_err + orto_weight * orto_err

    sol = scipy.optimize.least_squares(residual, free0.ravel())
    return np.hstack([keep, sol.x.reshape(free0.shape)])


def _rq(mat):
    """RQ decomposition mat = R @ Q via QR of the row-flipped transpose
    (replaces scipy.linalg.rq; same triangular structure)."""
    q1, r1 = np.linalg.qr(np.flipud(mat).T)
    return np.flipud(r1.T)[:, ::-1], np.flipud(q1.T)


def construct_ortogonal_moments(moments, cov, tol=None):
    """Orthogonalize the moment basis w.r.t. a sampled covariance.

    Procedure (the math is the spec, reference :756-841):

    1. fold the mean into the basis so the zeroth function stays ~1
       (center = I with first column -cov[:, 0])
    2. eigendecompose the centered covariance; cut the noise floor of the
       spectrum (slope-change detection, or an explicit ``tol``)
    3. whiten with the kept spectrum, largest eigenvalues first
    4. triangularize by RQ so each new function mixes only lower-order
       originals; fix the overall sign via L[0, 0] > 0

    :return: (orthogonal moments object, info=(eigenvalues, threshold, L))
    """
    cov = np.asarray(cov, dtype=float)
    center = np.eye(moments.size)
    center[:, 0] = -cov[:, 0]
    cov_centered = center @ cov @ center.T
    eigvals, eigvecs = np.linalg.eigh(cov_centered)  # ascending order

    if tol is None:
        cut, trend = detect_treshold_slope_change(eigvals, log=True)
        cut = int(np.argmax(eigvals - trend[0] > 0))
    else:
        cut = int(np.argmax(eigvals > tol))

    lead_vals = eigvals[cut:][::-1]  # descending, noise floor dropped
    lead_vecs = eigvecs[:, cut:][:, ::-1]
    whitener = center.T @ (lead_vecs / np.sqrt(lead_vals)[None, :])
    r_tri, _q = _rq(whitener)
    L = r_tri.T
    if L[0, 0] < 0:
        L = -L

    ortogonal_moments = mlmc_tpu.moments.TransformedMoments(moments, L)
    return ortogonal_moments, (eigvals, cut, L)
