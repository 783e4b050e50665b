"""Polynomial chaos expansion (PCE) — spectral surrogates with
closed-form statistics, beyond-reference tier.

Expands a QoI in an orthonormal polynomial basis of the random inputs
(Wiener 1938; Ghanem & Spanos 1991; Xiu & Karniadakis 2002):

    f(theta) ~ sum_alpha c_alpha Psi_alpha(theta),
    Psi_alpha(theta) = prod_k psi_{alpha_k}(theta_k),

with psi orthonormal under the input law — probabilists' Hermite for
N(0,1) inputs, Legendre for U(-1,1). Orthonormality turns the
coefficient vector into the statistics: ``mean = c_0``,
``var = sum_{alpha != 0} c_alpha^2``, and Sobol' sensitivity indices
are coefficient-group sums (Sudret 2008) — no sampling error at all
once the expansion is built. The fitted expansion is itself a jittable
device surrogate: use it as an MFMC low-fidelity model
(mlmc_tpu/multifidelity.py) or a cheap outer model anywhere a
``theta -> value`` function is accepted.

Two fits:

* **regression** (point collocation): least squares on sampled
  ``(theta, y)`` pairs — one device ``lstsq`` on the [N, P] design
  matrix (matmul work), optional ridge ``reg``;
* **projection**: ``c_alpha = E[f Psi_alpha]`` on a Smolyak sparse
  grid (mlmc_tpu/collocation.py) — exact when the rule's polynomial
  exactness covers ``degree(f) + degree``.

Device-first design: the three-term recurrences build all 1-D polynomial
values in one pass ([N, d, p+1]); the multivariate design matrix is a
gather+product, the fit one batched linear solve, and the surrogate one
``[N, P] @ [P, q]`` matmul per batch — every hot step matmul-shaped.

Cite: reference has no surrogate/PCE capability; nearest neighbours are
its moment bases (reference mlmc/moments.py:1-), which this module
deliberately mirrors in recurrence style (mlmc_tpu/moments.py).
"""
import functools
import itertools
import math
from typing import Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["PCE", "total_degree_indices", "pce_control_variate"]


def total_degree_indices(d: int, degree: int) -> np.ndarray:
    """All multi-indices alpha in N^d with |alpha| <= degree,
    graded-lexicographically ordered; shape [P, d], P = C(d+p, p)."""
    out = []
    for total in range(degree + 1):
        for c in itertools.combinations_with_replacement(range(d), total):
            alpha = [0] * d
            for k in c:
                alpha[k] += 1
            out.append(alpha)
    return np.asarray(out, dtype=np.int32)


def _orthonormal_1d_all(x, degree, basis):
    """All orthonormal 1-D polynomial values up to `degree`:
    x [...,] -> [..., degree+1]."""
    vals = [jnp.ones_like(x)]
    if degree >= 1:
        vals.append(x)
    if basis == "hermite":
        # He_{n+1} = x He_n - n He_{n-1}; orthonormal: He_n / sqrt(n!)
        for n in range(1, degree):
            vals.append(x * vals[n] - n * vals[n - 1])
        scale = [1.0 / math.sqrt(math.factorial(n))
                 for n in range(degree + 1)]
    elif basis == "legendre":
        # (n+1) P_{n+1} = (2n+1) x P_n - n P_{n-1}; orthonormal under
        # the UNIFORM probability measure on [-1,1]: sqrt(2n+1) P_n
        for n in range(1, degree):
            vals.append(((2 * n + 1) * x * vals[n] - n * vals[n - 1])
                        / (n + 1))
        scale = [math.sqrt(2 * n + 1) for n in range(degree + 1)]
    else:
        raise ValueError(f"unknown basis {basis!r}; "
                         "choose 'hermite' or 'legendre'")
    return jnp.stack([v * s for v, s in zip(vals, scale)], axis=-1)


class PCE:
    """Total-degree polynomial chaos expansion.

    :param d: input dimension.
    :param degree: total polynomial degree p (P = C(d+p, p) terms).
    :param basis: "hermite" (theta ~ N(0,1)^d) or "legendre"
        (theta ~ U(-1,1)^d). Map other laws into these (e.g.
        U(0,1) -> 2u-1, lognormal -> exp of a Hermite input).
    :param indices: optional explicit multi-index set [P, d] overriding
        the total-degree set (for anisotropic/sparse truncations).
    """

    def __init__(self, d: int, degree: int, basis: str = "hermite",
                 indices: Optional[np.ndarray] = None):
        if d < 1 or degree < 0:
            raise ValueError("need d >= 1 and degree >= 0")
        if basis not in ("hermite", "legendre"):
            raise ValueError(f"unknown basis {basis!r}; "
                             "choose 'hermite' or 'legendre'")
        self.d, self.degree, self.basis = d, degree, basis
        self.indices = (total_degree_indices(d, degree)
                        if indices is None
                        else np.asarray(indices, dtype=np.int32))
        if self.indices.ndim != 2 or self.indices.shape[1] != d:
            raise ValueError("indices must be [P, d]")
        self.n_terms = len(self.indices)
        self.coefficients = None          # [P, q] after a fit

    # ---- design matrix -------------------------------------------
    def design_matrix(self, theta):
        """Psi [N, P] for theta [N, d]; jittable."""
        theta = jnp.atleast_2d(theta)
        H = _orthonormal_1d_all(theta, int(self.indices.max(initial=0)),
                                self.basis)            # [N, d, p+1]
        # gather g[n, p, k] = H[n, k, indices[p, k]], product over k
        g = H[:, jnp.arange(self.d)[None, :], jnp.asarray(self.indices)]
        return jnp.prod(g, axis=-1)                    # [N, P]

    # ---- fits ------------------------------------------------------
    def fit_regression(self, theta, y, reg: float = 0.0):
        """Least-squares fit from samples theta [N, d], y [N] or [N, q].
        N >= n_terms required (use `reg` > 0 to ridge-stabilize)."""
        theta = jnp.atleast_2d(theta)
        y2 = jnp.asarray(y)
        y2 = y2[:, None] if y2.ndim == 1 else y2
        if theta.shape[0] < self.n_terms and reg == 0.0:
            raise ValueError(
                f"regression needs N >= P = {self.n_terms} samples "
                f"(got {theta.shape[0]}); pass reg > 0 to ridge")

        @jax.jit
        def solve(theta, y2):
            Psi = self.design_matrix(theta)
            if reg > 0.0:
                A = Psi.T @ Psi + reg * jnp.eye(self.n_terms,
                                                dtype=Psi.dtype)
                return jnp.linalg.solve(A, Psi.T @ y2)
            return jnp.linalg.lstsq(Psi, y2)[0]

        self.coefficients = solve(theta, y2)
        self._scalar = (jnp.asarray(y).ndim == 1)
        return self

    def fit_sparse(self, theta, y, lam: Optional[float] = None,
                   lam_grid=None, n_folds: int = 5,
                   max_iter: int = 400, debias: bool = True,
                   seed: int = 0):
        """Compressive-sensing fit: LASSO on the PCE coefficients
        (Doostan & Owhadi, JCP 230, 2011; Blatman & Sudret's sparse-PCE
        program) — recovers a SPARSE expansion from far fewer model
        evaluations than basis terms (N << P), where least squares is
        underdetermined and ridge smears energy over every term:

            min_c  1/(2N) ||Psi c - y||^2 + lam ||c_{alpha != 0}||_1

        (the constant term is never penalized). Solved by FISTA
        (Beck-Teboulle 2009) entirely on device: the iteration is two
        [N, P] matmuls + a soft threshold, the step from a power-method
        bound of ||Psi^T Psi||/N — matmul work with static shapes. When
        ``lam`` is None it is selected by k-fold cross-validation over
        ``lam_grid`` (default: lam_max * logspace(-4, -0.5, 16)); folds
        are mask-weighted, so every (fold, lambda) cell reuses ONE
        compiled FISTA program via vmap. With ``debias`` (default) the
        selected support is refit by restricted least squares — the
        standard bias correction that restores exact recovery on
        noiseless data.

        :param y: scalar samples [N] (sparse recovery targets one QoI).
        :return: self; diagnostics in ``self.sparse_info`` (chosen
            ``lam``, ``cv_rmse`` per grid point, ``support_size``).
        """
        theta = jnp.atleast_2d(theta)
        yv = jnp.asarray(y)
        if yv.ndim != 1:
            raise ValueError("fit_sparse targets one scalar QoI: y [N]")
        if n_folds < 2:
            raise ValueError("n_folds must be >= 2")
        N = theta.shape[0]
        P = self.n_terms
        pen = jnp.asarray(self.indices.sum(axis=1) > 0, yv.dtype)

        Psi = self.design_matrix(theta)                 # [N, P]

        def power_L(Psi):
            v = jnp.full((P,), 1.0 / np.sqrt(P), Psi.dtype)
            def step(v, _):
                w = Psi.T @ (Psi @ v)
                return w / jnp.linalg.norm(w), None
            v, _ = jax.lax.scan(step, v, None, length=24)
            return jnp.vdot(v, Psi.T @ (Psi @ v)) / N

        def fista(lam, w):
            """Weighted-sample LASSO; w [N] in {0,1} masks CV folds."""
            nw = jnp.maximum(jnp.sum(w), 1.0)
            Pw = Psi * w[:, None]
            L = power_L(Pw) * (N / nw) + 1e-12
            thr = lam * pen / L

            def step(carry, _):
                c, z, t = carry
                grad = Pw.T @ (Psi @ z - yv) / nw
                u = z - grad / L
                c_new = jnp.sign(u) * jnp.maximum(jnp.abs(u) - thr, 0.0)
                t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
                z_new = c_new + ((t - 1.0) / t_new) * (c_new - c)
                return (c_new, z_new, t_new), None

            z0 = jnp.zeros((P,), yv.dtype)
            (c, _, _), _ = jax.lax.scan(
                step, (z0, z0, jnp.ones((), yv.dtype)), None,
                length=max_iter)
            return c

        if lam is None:
            lam_max = float(jnp.max(jnp.abs(Psi.T @ yv) * pen) / N)
            grid = (np.asarray(lam_grid, np.float64) if lam_grid
                    is not None else
                    lam_max * np.logspace(-4, -0.5, 16))
            folds = np.asarray(
                jax.random.permutation(jax.random.key(seed),
                                       np.arange(N) % n_folds))
            fold_masks = jnp.asarray(
                np.stack([(folds != f).astype(float)
                          for f in range(n_folds)]), yv.dtype)

            @jax.jit
            def cv_errors(grid_j):
                def one(lam_w):
                    lam_, w = lam_w
                    c = fista(lam_, w)
                    r = (Psi @ c - yv) * (1.0 - w)
                    return jnp.sum(r * r) / jnp.maximum(
                        jnp.sum(1.0 - w), 1.0)
                lam_rep = jnp.repeat(grid_j, n_folds)
                w_rep = jnp.tile(fold_masks, (len(grid), 1))
                errs = jax.vmap(one)((lam_rep, w_rep))
                return errs.reshape(len(grid), n_folds).mean(axis=1)

            errs = np.asarray(jax.device_get(cv_errors(
                jnp.asarray(grid, yv.dtype))))
            lam = float(grid[int(np.argmin(errs))])
            cv_rmse = np.sqrt(errs)
        else:
            grid, cv_rmse = np.array([lam]), None

        ones = jnp.ones((N,), yv.dtype)
        c = jax.jit(fista)(jnp.asarray(lam, yv.dtype), ones)
        if debias:
            m = (jnp.abs(c) > 1e-12 * jnp.maximum(
                jnp.max(jnp.abs(c)), 1e-300)) | (pen == 0)

            @jax.jit
            def restricted_ls(m):
                mf = m.astype(Psi.dtype)
                A = (Psi.T @ Psi) * jnp.outer(mf, mf) \
                    + jnp.diag(1.0 - mf)
                b = mf * (Psi.T @ yv)
                return mf * jnp.linalg.solve(A, b)

            if int(jnp.sum(m)) <= N:   # refit only when well-posed
                c = restricted_ls(m)
        self.coefficients = c[:, None]
        self._scalar = True
        self.sparse_info = {
            "lam": float(lam), "lam_grid": np.asarray(grid),
            "cv_rmse": cv_rmse,
            "support_size": int(np.sum(np.abs(np.asarray(c)) > 0)),
        }
        return self

    def fit_projection(self, fn: Callable, level: int,
                       rule: Optional[str] = None, grid=None):
        """Spectral projection ``c = Psi(nodes)^T (w * f(nodes))`` on a
        Smolyak grid of the matching rule. Exact when the grid
        integrates degree ``degree(fn) + self.degree`` (Gauss-Hermite:
        level w is exact to total degree 2w+1)."""
        from mlmc_tpu.collocation import SparseGrid
        if grid is None:
            rule = rule or ("gauss-hermite" if self.basis == "hermite"
                            else "gauss-legendre")
            grid = SparseGrid(self.d, level, rule=rule)
        nodes = jnp.asarray(grid.nodes)
        w = jnp.asarray(grid.weights, nodes.dtype)
        self._scalar = (jax.eval_shape(fn, jnp.zeros(self.d)).ndim == 0)

        @jax.jit
        def project(nodes, w):
            y = jax.vmap(fn)(nodes)
            y2 = y[:, None] if y.ndim == 1 else y
            Psi = self.design_matrix(nodes)
            return Psi.T @ (w[:, None] * y2)

        self.coefficients = project(nodes, w)
        return self

    # ---- surrogate + statistics -----------------------------------
    def _need_fit(self):
        if self.coefficients is None:
            raise RuntimeError("fit the expansion first "
                               "(fit_regression / fit_projection)")

    def __call__(self, theta):
        """Surrogate evaluation: theta [d] or [N, d] -> [q]/[N, q]
        (scalar squeezed when fitted on scalar y); jittable/vmappable."""
        self._need_fit()
        single = jnp.asarray(theta).ndim == 1
        out = self.design_matrix(theta) @ self.coefficients
        if self._scalar:
            out = out[:, 0]
        return out[0] if single else out

    def _zero_mask(self):
        """Rows of the index set that are the alpha = 0 (constant)
        term — not guaranteed present/first for custom index sets."""
        return self.indices.sum(axis=1) == 0

    def mean(self):
        self._need_fit()
        z = self._zero_mask()
        c = np.asarray(self.coefficients)
        c0 = c[z].sum(axis=0) if z.any() else np.zeros(c.shape[1:])
        return float(c0[0]) if self._scalar else c0

    def var(self):
        self._need_fit()
        z = self._zero_mask()
        v = np.asarray(self.coefficients[~z] ** 2).sum(axis=0)
        return float(v[0]) if self._scalar else v

    def sobol(self):
        """Closed-form Sobol' indices from the coefficient groups
        (Sudret 2008): dict with ``first_order`` [d(, q)],
        ``total_effect``, ``mean``, ``variance``. The alpha=0 term is
        excluded from all variance sums."""
        self._need_fit()
        c2 = np.asarray(self.coefficients) ** 2          # [P, q]
        nz = self.indices > 0                            # [P, d]
        active = nz.sum(axis=1)
        var = c2[active > 0].sum(axis=0)
        var = np.where(var > 0, var, np.inf)             # S := 0 if flat
        first = np.empty((self.d,) + c2.shape[1:])
        total = np.empty_like(first)
        for k in range(self.d):
            only_k = nz[:, k] & (active == 1)
            first[k] = c2[only_k].sum(axis=0) / var
            total[k] = c2[nz[:, k]].sum(axis=0) / var
        if self._scalar:
            first, total = first[:, 0], total[:, 0]
        return {"first_order": first, "total_effect": total,
                "mean": self.mean(), "variance": self.var()}


def pce_control_variate(f_fn: Callable, pce: PCE, n: int, key=None,
                        split: float = 0.5, chunk_size: int = 1 << 13,
                        dtype=None):
    """Estimate ``E[f]`` with the fitted expansion as a control variate
    whose mean is EXACT:

        est = mean_n[ f(theta) - beta (g(theta) - E[g]) ],

    where ``g`` is the PCE surrogate and ``E[g] = c_0`` comes from the
    coefficients with zero error (orthonormality) — unlike MFMC, no
    budget is spent estimating the surrogate's own mean. ``beta`` is
    the regression-optimal ``Cov(f, g)/Var(g)`` fitted on the FIRST
    ``split`` fraction of the samples and FROZEN on the rest, so the
    reported estimate is exactly unbiased (a same-sample beta carries
    the classical O(1/n) plug-in bias). Variance shrinks by
    ``1 - rho^2`` of the evaluation half — a rho = 0.995 surrogate
    cuts the sample budget ~100x.

    Everything runs as chunked jitted device passes: the surrogate is
    one [C, P] design matmul riding the same batch as ``f``.

    :param f_fn: pure jnp ``theta [d] -> scalar``.
    :param pce: a FITTED scalar :class:`PCE` (its basis fixes the input
        law: hermite -> N(0,1)^d, legendre -> U(-1,1)^d).
    :param n: total model evaluations (split between beta fit and
        estimate).
    :return: dict with ``mean``, ``se``, ``beta``, ``rho`` (fit-half
        correlation), ``var_reduction`` (plain-MC variance of the
        evaluation half / CV variance), ``n_fit``, ``n_eval``.
    """
    pce._need_fit()
    if not pce._scalar:
        raise ValueError("control variates target one scalar QoI")
    if not 0.0 < split < 1.0:
        raise ValueError("split must be in (0, 1)")
    if key is None:
        key = jax.random.key(0)
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    d = pce.d
    g_mean = float(pce.mean())
    n_fit = max(int(n * split), 2)
    n_eval = max(int(n) - n_fit, 2)
    k_fit, k_eval = jax.random.split(key)

    def draw(k, m):
        if pce.basis == "hermite":
            return jax.random.normal(k, (m, d), dtype)
        return jax.random.uniform(k, (m, d), dtype, -1.0, 1.0)

    @functools.partial(jax.jit, static_argnums=1)
    def moments(k, m_static):
        theta = draw(k, m_static)
        f = jax.vmap(f_fn)(theta).astype(dtype)
        g = pce(theta).astype(dtype)
        return jnp.stack([jnp.sum(f), jnp.sum(g), jnp.sum(f * g),
                          jnp.sum(f * f), jnp.sum(g * g)])

    def accumulate(k, m):
        total = np.zeros(5)
        done = 0
        i = 0
        while done < m:
            take = min(chunk_size, m - done)
            total += np.asarray(jax.device_get(
                moments(jax.random.fold_in(k, i), take)), np.float64)
            done += take
            i += 1
        return total, done

    (sf, sg, sfg, sff, sgg), m = accumulate(k_fit, n_fit)
    mf, mg = sf / m, sg / m
    cov = sfg / m - mf * mg
    var_g = max(sgg / m - mg * mg, 1e-300)
    var_f = max(sff / m - mf * mf, 1e-300)
    beta = cov / var_g
    rho = cov / np.sqrt(var_f * var_g)

    @functools.partial(jax.jit, static_argnums=1)
    def cv_moments(k, m_static):
        theta = draw(k, m_static)
        f = jax.vmap(f_fn)(theta).astype(dtype)
        g = pce(theta).astype(dtype)
        z = f - beta * (g - g_mean)
        return jnp.stack([jnp.sum(z), jnp.sum(z * z),
                          jnp.sum(f), jnp.sum(f * f)])

    total = np.zeros(4)
    done = 0
    i = 0
    while done < n_eval:
        take = min(chunk_size, n_eval - done)
        total += np.asarray(jax.device_get(cv_moments(
            jax.random.fold_in(k_eval, i), take)), np.float64)
        done += take
        i += 1
    sz, szz, sf2, sff2 = total
    mean = sz / done
    var_z = max(szz / done - mean * mean, 0.0)
    var_plain = max(sff2 / done - (sf2 / done) ** 2, 1e-300)
    return {"mean": float(mean),
            "se": float(np.sqrt(var_z / done)),
            "beta": float(beta), "rho": float(rho),
            "var_reduction": float(var_plain / max(var_z, 1e-300)),
            "n_fit": int(m), "n_eval": int(done)}
