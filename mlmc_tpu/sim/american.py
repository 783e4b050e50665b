"""American/Bermudan option pricing by Longstaff-Schwartz regression —
beyond-reference tier.

Optimal stopping completes the SDE family (mlmc_tpu/sim/sde.py prices
EUROPEAN-style path payoffs): a Bermudan claim may be exercised at any
of N dates, so its value is a backward dynamic program over the
continuation value E[V_{i+1} | S_i]. Longstaff & Schwartz (Rev. Fin.
Stud. 14, 2001) estimate that conditional expectation by least-squares
regression of realized discounted cashflows onto basis functions of
the state, restricted to in-the-money paths.

Device-first design: the whole backward induction is ONE jitted
``lax.scan`` over exercise dates — per date a basis Vandermonde
[B, K], a weighted least-squares fit by QR on the column-equilibrated
panel (cond(G), not the normal equations' cond(G)^2 — degree 6-7
stays f32-stable even at the tight early-date state clouds), and a
masked cashflow update; the path panel [B, N] is simulated forward in
the same program (exact GBM transitions or Euler/Milstein substeps).
Nothing touches the host until the final price statistics. With a
``mesh``, paths shard across devices as a textbook TSQR: local QR per
shard, the [K, K] R factors all-gather over ICI, every shard solves
the identical stacked problem — the regression is EXACTLY the pooled
one, not an average of per-shard fits.

Foresight-bias control is the standard two-pass scheme: the stopping
rule (regression coefficients) is FIT on one path set, then FROZEN and
applied to an independent set — the reported ``price`` is that
out-of-sample estimate (a true lower bound in expectation, up to the
CLT error); the in-sample value is returned alongside as the
optimistic side of the bracket.

Validated against a host CRR binomial Bermudan backward induction on
the same exercise dates (:func:`bermudan_binomial`), the
American-call-equals-European-call identity on non-dividend GBM, and
the early-exercise premium ordering (tests/test_american.py).

Companions: :func:`lsmc_dual_bound` (Rogers martingale upper bound —
a tree-free two-sided certificate with the lower bound),
:func:`lsmc_dual_bound_ml` (the nested dual's inner-sample count
telescoped MLMC-style), and :func:`lsmc_swing` (multiple-stopping
swing contracts).

No reference analogue: GeoMop/MLMC has no optimal-stopping capability.
"""
import time
from math import comb as _comb
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["lsmc_price", "lsmc_dual_bound", "lsmc_dual_bound_ml",
           "lsmc_swing", "put_payoff", "call_payoff",
           "bermudan_binomial"]


def put_payoff(strike):
    return lambda s: jnp.maximum(strike - s, 0.0)


def call_payoff(strike):
    return lambda s: jnp.maximum(s - strike, 0.0)


def _poly_basis(x, degree):
    """Monomials of the normalized state, [B] -> [B, degree + 1]."""
    return jnp.stack([x ** k for k in range(degree + 1)], axis=1)


def _poly_basis_multi(x, indices):
    """Total-degree monomials of a normalized [B, dim] state:
    ``G[b, p] = prod_k x[b, k] ** indices[p, k]`` -> [B, P]."""
    return jnp.prod(x[:, None, :] ** indices[None, :, :], axis=-1)


def _blocked_normal_eq(G, y, blk=2048):
    """``(G^T G, G^T y)`` with BOUNDED f32 accumulation windows.

    A single [B, K]x[K, B] contraction accumulates the whole sample
    axis into one f32 running sum: at B = 131072 the rounding random
    walk reaches ~2e-5 relative on the Gram entries, which a
    raw-monomial cond(A) ~ 2e5 turns into O(1)
    coefficient error — the 50-date global LSMC fit silently bled 8% of
    the option value, worsening WITH more paths. Two-stage contraction
    (per-2048-block partials, then a short cross-block sum) bounds the
    window to ~3e-6 at any B. y may be [B] or [B, Q].
    """
    B, K = G.shape
    y2 = y[:, None] if y.ndim == 1 else y
    blk = min(blk, B)
    nb = -(-B // blk)
    pad = nb * blk - B
    if pad:
        G = jnp.concatenate(
            [G, jnp.zeros((pad, K), G.dtype)], axis=0)
        y2 = jnp.concatenate(
            [y2, jnp.zeros((pad, y2.shape[1]), y2.dtype)], axis=0)
    Gb = G.reshape(nb, blk, K)
    yb = y2.reshape(nb, blk, y2.shape[1])
    hi = jax.lax.Precision.HIGHEST
    A = jnp.einsum("nbi,nbj->nij", Gb, Gb, precision=hi).sum(axis=0)
    b = jnp.einsum("nbi,nbq->niq", Gb, yb, precision=hi).sum(axis=0)
    return A, (b[:, 0] if y.ndim == 1 else b)


def _equilibrated_solve(A, b, eps):
    """Solve the normal equations after Jacobi equilibration
    ``D A D (x/D) = D b``, D = diag(A)^-1/2 — with a CENTERED basis
    this drops the lognormal-state monomial Gram's condition number
    from ~2e5 (raw, un-equilibrated) to ~20 at degree 3 / ~500 at
    degree 5 (measured), so f32 solves keep ~4 significant digits of
    the coefficients. The ridge acts on the equilibrated (unit
    diagonal) scale."""
    d = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(A), 1e-30))
    Ae = A * d[:, None] * d[None, :] \
        + eps * jnp.eye(A.shape[0], dtype=A.dtype)
    be = b * (d[:, None] if b.ndim == 2 else d)
    x = jnp.linalg.solve(Ae, be)
    return x * (d[:, None] if b.ndim == 2 else d)


def bermudan_binomial(s0, strike, rate, sigma, T, n_dates,
                      n_steps=4096, kind="put"):
    """Host CRR binomial Bermudan price (exercise allowed only at the
    ``n_dates`` equispaced dates h, 2h, ..., T): the validation
    reference for :func:`lsmc_price`. ``n_steps`` must be a multiple
    of ``n_dates``."""
    if n_steps % n_dates:
        raise ValueError("n_steps must be a multiple of n_dates")
    if kind not in ("put", "call"):
        raise ValueError("kind must be 'put' or 'call'")
    dt = T / n_steps
    u = np.exp(sigma * np.sqrt(dt))
    d = 1.0 / u
    disc = np.exp(-rate * dt)
    p = (np.exp(rate * dt) - d) / (u - d)
    j = np.arange(n_steps + 1)
    s = s0 * u ** j * d ** (n_steps - j)
    v = np.maximum(strike - s, 0.0) if kind == "put" \
        else np.maximum(s - strike, 0.0)
    per_date = n_steps // n_dates
    for step in range(n_steps - 1, -1, -1):
        v = disc * (p * v[1:] + (1 - p) * v[:-1])
        if step and step % per_date == 0:
            s = s0 * u ** j[:step + 1] * d ** (step - j[:step + 1])
            ex = (np.maximum(strike - s, 0.0) if kind == "put"
                  else np.maximum(s - strike, 0.0))
            v = np.maximum(v, ex)
    return float(v[0])


def lsmc_price(payoff: Callable, s0: float, rate: float, T: float,
               n_dates: int, sigma: Optional[float] = None,
               model=None, scheme: str = "euler", n_sub: int = 1,
               degree: int = 3, n_paths: int = 1 << 16,
               key=None, scale: Optional[float] = None,
               itm_only: bool = True, dtype=None, mesh=None):
    """Price a Bermudan claim ``payoff(S_t)`` exercisable at the dates
    ``h, 2h, ..., T`` (h = T/n_dates) by Longstaff-Schwarz regression.

    Dynamics: exact GBM transitions under the risk-neutral drift when
    ``sigma`` is given (no discretization error), an
    :class:`~mlmc_tpu.sim.sde.SDEModel` integrated with ``n_sub``
    Euler/Milstein substeps per date, or an
    :class:`~mlmc_tpu.sim.sde.SDESystem` (e.g. Heston stochastic
    volatility) — vector states regress on the TOTAL-DEGREE monomial
    basis over all components (K = C(dim + degree, degree) terms, e.g.
    the Heston (S, v) pair at degree 3 gives K = 10), so the stopping
    rule conditions on the full Markov state, not just the asset.

    :param payoff: immediate exercise value pure jnp — ``s [B] -> [B]``
        (scalar dynamics) or ``s [B, dim] -> [B]`` (SDESystem; e.g.
        ``lambda s: jnp.maximum(K - s[..., 0], 0.0)``).
    :param degree: polynomial regression degree in ``s / scale``
        (basis size K = degree + 1 scalar / total-degree count vector).
    :param scale: state normalization for the basis (default ``s0`` /
        the system's ``model.s0`` with zeros replaced by 1).
    :param itm_only: restrict the regression to in-the-money paths
        (the Longstaff-Schwartz recommendation; exercise decisions are
        only ever made there).
    :param mesh: optional :class:`~mlmc_tpu.parallel.mesh.SampleMesh`
        — paths shard across devices; the per-date normal equations
        are ``psum``-pooled so the fit is exactly the global one.
    :return: dict with ``price`` (out-of-sample, the honest lower
        bound), ``price_se``, ``price_insample``, ``european`` (same
        paths, no early exercise — a paired control), ``coef``
        [n_dates - 1, K] frozen stopping rule, ``exercise_frac``,
        ``wall_s``.
    """
    if n_dates < 1:
        raise ValueError("n_dates must be >= 1")
    if (sigma is None) == (model is None):
        raise ValueError("pass exactly one of sigma (exact GBM) / model")
    if key is None:
        key = jax.random.key(0)
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    is_system = model is not None and hasattr(model, "n_drivers")
    h = T / n_dates
    disc = float(np.exp(-rate * h))
    B = int(n_paths)
    k_fit, k_eval = jax.random.split(key)

    if is_system:
        # vector state (e.g. Heston): total-degree regression basis
        # over all components, Euler-Maruyama substeps
        from mlmc_tpu.pce import total_degree_indices
        from mlmc_tpu.sim.sde import _system_step

        if scheme != "euler":
            raise ValueError("SDESystem pricing integrates with Euler "
                             "substeps; pass scheme='euler'")
        dim = model.dim
        sc = np.asarray(scale if scale is not None else model.s0,
                        np.float64).ravel()
        if sc.shape != (dim,):
            raise ValueError(f"scale must have {dim} components")
        sc = jnp.asarray(np.where(sc == 0.0, 1.0, np.abs(sc)), dtype)
        basis_idx = jnp.asarray(total_degree_indices(dim, degree),
                                dtype)
        K = basis_idx.shape[0]
        make_G = lambda s: _poly_basis_multi(s / sc - 1.0, basis_idx)
        s0_state = jnp.asarray(model.s0, dtype)
        dt = h / n_sub

        def date_step(s, kk, i):
            dws = np.sqrt(dt) * jax.random.normal(
                kk, (n_sub,) + s.shape[:-1] + (model.n_drivers,), dtype)
            for j in range(n_sub):
                t = i * h + j * dt
                s = _system_step(model, s, t, dws[j], dt)
            return s
    else:
        scale = float(scale if scale is not None else s0)
        K = degree + 1
        make_G = lambda s: _poly_basis(s / scale - 1.0, degree)

    if sigma is not None:
        drift_h = float((rate - 0.5 * sigma ** 2) * h)
        vol_h = float(sigma * np.sqrt(h))

        def date_step(s, kk, i):
            z = jax.random.normal(kk, s.shape, dtype)
            return s * jnp.exp(drift_h + vol_h * z)
    elif not is_system:
        from mlmc_tpu.sim.sde import _scheme_increment

        if scheme == "milstein" and model.diffusion_ds is None:
            raise ValueError("Milstein needs SDEModel.diffusion_ds")
        dt = h / n_sub

        def date_step(s, kk, i):
            z = jax.random.normal(kk, (n_sub,) + s.shape, dtype)
            for j in range(n_sub):
                t = i * h + j * dt
                s = s + _scheme_increment(model, scheme, s, t,
                                          np.sqrt(dt) * z[j], dt)
            return s

    def _mark(z):
        """Tag a value as device-varying inside shard_map (scan carries
        must enter with their steady-state vma type)."""
        if mesh is None:
            return z
        if hasattr(jax.lax, "pcast"):
            return jax.lax.pcast(z, (axis,), to="varying")
        return jax.lax.pvary(z, (axis,))

    def simulate(kr, n_loc):
        """Forward panel: [n_dates, n_loc(, dim)] states at the dates."""
        keys = jax.random.split(kr, n_dates)
        s0v = _mark(jnp.broadcast_to(s0_state, (n_loc, dim))
                    if is_system else jnp.full((n_loc,), s0, dtype))

        def fwd(s, xs):
            kk, i = xs
            s = date_step(s, kk, i)
            return s, s

        _, panel = jax.lax.scan(fwd, s0v, (keys, jnp.arange(n_dates)))
        return panel

    psum = (jax.lax.psum if mesh is not None else
            lambda x, axis_name: x)
    axis = mesh.axis_name if mesh is not None else None

    def normal_fit(G, w, y):
        """Pooled weighted least squares across shards by TSQR.

        The earlier normal-equation route squares the basis condition
        number (cond(G^T G) = cond(G)^2): the centered-monomial Gram at
        early dates (tight state clouds, u-spread ~ sigma sqrt(t))
        keeps a Hilbert-like cond ~ 5.8^K even after Jacobi
        equilibration, which capped stable f32 fits at degree 5
        (BASELINE.md american row). QR factorization works at cond(G)
        itself, lifting degree 6-7 into the f32-stable regime.

        Mesh path = textbook TSQR: each shard QR-factors its local
        weighted panel, the tiny [K, K] R factors and [K] projected
        rhs all-gather over ICI (K^2 floats per shard — negligible),
        and every shard solves the identical stacked least-squares
        problem, so the fit is exactly the global one. Ridge rows
        sqrt(eps) I on the column-equilibrated scale match the old
        solver's regularization."""
        Gw = G * w[:, None]
        yw = y * w
        hi = jax.lax.Precision.HIGHEST
        # global column equilibration (the Jacobi diagonal of the old
        # solver): diagonal, so it folds back into the coefficients
        # exactly — the emitted rule stays in the centered-monomial
        # basis that lsmc_dual_bound's closed-form CV consumes
        cn = psum(jnp.sum(Gw * Gw, axis=0), axis_name=axis)
        d = jax.lax.rsqrt(jnp.maximum(cn, 1e-30))
        q, r = jnp.linalg.qr(Gw * d[None, :])
        c = jnp.matmul(q.T, yw, precision=hi)
        if mesh is not None:
            r = jax.lax.all_gather(r, axis).reshape(-1, K)
            c = jax.lax.all_gather(c, axis).reshape(-1)
        eps = (1e-6 if jnp.finfo(dtype).bits < 64 else 1e-12)
        rr = jnp.concatenate(
            [r, jnp.sqrt(eps) * jnp.eye(K, dtype=dtype)], axis=0)
        cc = jnp.concatenate([c, jnp.zeros((K,), dtype)], axis=0)
        q2, r2 = jnp.linalg.qr(rr)
        x = jax.scipy.linalg.solve_triangular(
            r2, jnp.matmul(q2.T, cc, precision=hi), lower=False)
        return x * d

    def backward(panel, coefs, fit):
        """Backward induction over dates n_dates-1 .. 1. ``fit``
        (static): regress and emit coefficients; else apply the frozen
        [n_dates - 1, K] stack."""
        v = payoff(panel[-1])                       # value at T
        xs = (panel[:-1][::-1], coefs[::-1])

        def bwd(v, xs):
            s, c = xs
            v = disc * v
            G = make_G(s)
            ex = payoff(s)
            w = ((ex > 0).astype(dtype) if itm_only
                 else jnp.ones_like(ex))
            if fit:
                c = normal_fit(G, w, v)
            cont = jnp.matmul(G, c,
                              precision=jax.lax.Precision.HIGHEST)
            take = (ex > 0) & (ex > cont)
            v = jnp.where(take, ex, v)
            return v, (c, take.astype(dtype))

        v, (cs, takes) = jax.lax.scan(bwd, v, xs)
        price = disc * v                             # discount to t=0
        return price, cs[::-1], takes

    def make_run(fit):
        def run(kr, coefs):
            n_loc = B // mesh.n_devices if mesh is not None else B
            panel = simulate(kr, n_loc)
            price, cs, takes = backward(panel, coefs, fit)
            euro = (disc ** n_dates) * payoff(panel[-1])
            stats = jnp.stack([
                psum(jnp.sum(price), axis_name=axis),
                psum(jnp.sum(price * price), axis_name=axis),
                psum(jnp.sum(euro), axis_name=axis),
                psum(jnp.mean(takes, axis=1).sum(), axis_name=axis)
                / (mesh.n_devices if mesh is not None else 1.0),
            ])
            return stats, cs

        if mesh is None:
            return jax.jit(run)
        from jax.sharding import PartitionSpec as P

        from mlmc_tpu.parallel.mesh import shard_map_norep

        if B % mesh.n_devices:
            raise ValueError(f"n_paths={B} must divide by the mesh's "
                             f"{mesh.n_devices} devices")

        def sharded(kr, coefs):
            kr = jax.random.fold_in(kr, jax.lax.axis_index(axis))
            return run(kr, coefs)

        # replication check waived: the TSQR coefficients ARE replicated
        # (every shard solves the identical stacked system of all-gathered
        # R factors) but static vma inference cannot see through the
        # gather + local QR
        return jax.jit(shard_map_norep(
            sharded, mesh.mesh, in_specs=(P(), P()),
            out_specs=(P(), P())))

    t0 = time.perf_counter()
    dummy = jnp.zeros((max(n_dates - 1, 1), K), dtype)[:n_dates - 1]
    if n_dates == 1:
        stats, _ = jax.device_get(make_run(False)(k_eval, dummy))
        s_sum, s_sq, e_sum, _ = [float(x) for x in np.asarray(stats)]
        price = s_sum / B
        se = float(np.sqrt(max(s_sq / B - price ** 2, 0.0) / B))
        return {"price": price, "price_se": se,
                "price_insample": price, "european": e_sum / B,
                "coef": np.zeros((0, K)), "exercise_frac": 0.0,
                "wall_s": time.perf_counter() - t0}
    # pass 1: fit the stopping rule; in-sample price rides along
    stats_in, coefs = make_run(True)(k_fit, dummy)
    # pass 2: frozen rule on independent paths
    stats, _ = make_run(False)(k_eval, coefs)
    (stats_in, stats), coefs = jax.device_get(
        ((stats_in, stats), coefs))
    s_sum, s_sq, e_sum, takes = [float(x) for x in np.asarray(stats)]
    price = s_sum / B
    se = float(np.sqrt(max(s_sq / B - price ** 2, 0.0) / B))
    return {"price": price, "price_se": se,
            "price_insample": float(np.asarray(stats_in)[0]) / B,
            "european": e_sum / B,
            "coef": np.asarray(coefs, np.float64),
            "exercise_frac": takes / max(n_dates - 1, 1),
            "wall_s": time.perf_counter() - t0}


def lsmc_dual_bound(payoff: Callable, s0: float, rate: float, T: float,
                    n_dates: int, coef, sigma: Optional[float] = None,
                    model=None, scheme: str = "euler", n_sub: int = 1,
                    degree: Optional[int] = None,
                    scale: Optional[float] = None,
                    n_paths: int = 1 << 14, n_inner: int = 64,
                    key=None, dtype=None):
    """TRUE upper bound on the Bermudan price by the dual (martingale)
    method — Rogers (Math. Finance 12, 2002) with Glasserman's
    approximate-value-function martingale (Monte Carlo Methods in
    Financial Engineering §8.7): for ANY martingale ``M`` with
    ``M_0 = 0``,

        price <= E[ max_i ( disc^i h(S_i) - M_i ) ],

    and a tight choice is ``M_i = sum_{k<=i} (V_k(S_k) -
    E[V_k(S_k) | S_{k-1}])`` with ``V_k(s) = max(h(s), C_k(s))`` built
    from the FROZEN regression surface ``coef`` of :func:`lsmc_price`.
    The conditional expectation is estimated with ``n_inner`` one-step
    antithetic sub-samples per (path, date) — fully batched, no nested
    path simulation — with the continuation polynomial as an EXACT
    control variate: under GBM the monomial basis has closed-form
    lognormal conditional moments ``E[(S_i/scale)^k | S_{i-1}] =
    (S_{i-1}/scale)^k exp(k mu h + k^2 sigma^2 h / 2)``, so the inner
    Monte Carlo only has to average the residual ``V_i - C_i =
    relu(h - C_i)``, which vanishes in the continuation region. The
    estimate stays unbiased, and since max is convex, Jensen noise only
    ever INCREASES the bound — it remains a valid upper bound in
    expectation while the CV removes nearly all of the inflation.

    Dynamics (match the fit): exact GBM (``sigma``) gets the closed-form
    control variate above; an :class:`~mlmc_tpu.sim.sde.SDEModel` or
    :class:`~mlmc_tpu.sim.sde.SDESystem` (e.g. Heston — pass the SAME
    ``n_sub`` as the fit) estimates the one-date inner expectation by
    plain ANTITHETIC nested MC instead: without the CV the Jensen
    inflation shrinks only as ~1/n_inner, so budget more inner samples
    (256+) — the bound stays VALID (noise can only raise it), just
    looser. The surface must be valid EVERYWHERE, not just in the
    money: fit it with ``itm_only=False`` (an ITM-only polynomial
    extrapolates wildly out of the money, where ``V = max(0, C)`` then
    inflates the martingale increments — observed to blow the duality
    gap from ~2% to ~60% of the price on an at-the-money put).

    :param coef: [n_dates - 1, K] regression coefficients from
        ``lsmc_price(..., itm_only=False)["coef"]``.
    :param degree: basis degree; default infers it from K (scalar:
        K - 1; system: the total degree with C(dim + p, p) = K).
    :return: dict with ``upper``, ``upper_se``, ``wall_s``.
    """
    if (sigma is None) == (model is None):
        raise ValueError("pass exactly one of sigma (exact GBM) / model")
    if key is None:
        key = jax.random.key(1)
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    coef_np = np.asarray(coef, np.float64)
    coef = jnp.asarray(coef, dtype)
    K = coef.shape[1]
    if n_inner % 2:
        raise ValueError("n_inner must be even (antithetic pairs)")
    if model is not None:
        return _dual_bound_model(payoff, s0, rate, T, n_dates, coef,
                                 model, scheme, n_sub, degree, scale,
                                 int(n_paths), int(n_inner), key, dtype)
    if degree is None:
        degree = K - 1
    if degree + 1 != K:
        raise ValueError("degree+1 must match coef's second dim")
    scale = float(scale if scale is not None else s0)
    h = T / n_dates
    disc = float(np.exp(-rate * h))
    drift_h = float((rate - 0.5 * sigma ** 2) * h)
    vol_h = float(sigma * np.sqrt(h))
    B = int(n_paths)
    k_path, k_inner = jax.random.split(key)

    def cont_poly(s, i):
        """Frozen continuation surface C_i(s); jnp index clamping makes
        the terminal date reuse the last regression row (used only as a
        control variate there, so any unbiased surrogate is valid)."""
        return jnp.matmul(_poly_basis(s / scale - 1.0, degree),
                          coef[i - 1],
                          precision=jax.lax.Precision.HIGHEST)

    def value(s, i):
        """V_i(s) in date-i money: exercise vs the frozen continuation
        surface (dates 1..n_dates-1); terminal = payoff."""
        ex = payoff(s)
        return jnp.where(i == n_dates, ex, jnp.maximum(ex, cont_poly(s, i)))

    # closed-form conditional moments of the CENTERED basis, expanded
    # back IN the centered basis of s_prev: with u = S_{i-1}/scale - 1
    # and G = exp(mu h + sigma sqrt(h) Z),
    #   E[((1+u) G - 1)^k | u] = sum_l u^l Q[k, l],
    #   Q[k, l] = sum_j C(k,j) (-1)^(k-j) C(j,l) m_j,
    # m_j the raw lognormal moments. Q -> identity as h -> 0 (binomial
    # inversion at m = 1), so folding it into the coefficients
    # (w_i = Q^T coef_i, in f64 ON HOST) keeps the device dot in the
    # same well-conditioned centered basis the surface itself uses.
    # The earlier raw-monomial route was measured fatally f32-hostile:
    # narrow early-date state distributions give degree-5 centered fits
    # coefficients ~1e3, whose raw-basis image needs ~9 cancelling
    # digits (+/-1.3e4 terms summing to 0.05) — the martingale drifted
    # and the 50-date dual collapsed to 0 in float32.
    ks = np.arange(K)
    raw_mom = np.exp(ks * drift_h + 0.5 * (ks * vol_h) ** 2)
    Qmat = np.zeros((K, K))
    for k in range(K):
        for l in range(k + 1):
            Qmat[k, l] = sum(
                _comb(k, j) * (-1.0) ** (k - j) * _comb(j, l)
                * raw_mom[j] for j in range(l, k + 1))
    cv_w = jnp.asarray(Qmat.T @ coef_np.T, dtype)
    # cv_w [K(centered l), n_dates - 1]

    @jax.jit
    def run():
        s0v = jnp.full((B,), s0, dtype)
        keys = jax.random.split(k_path, n_dates)
        ikeys = jax.random.split(k_inner, n_dates)

        def step(carry, xs):
            s_prev, M, best = carry
            kk, ik, i = xs
            z = jax.random.normal(kk, (B,), dtype)
            s = s_prev * jnp.exp(drift_h + vol_h * z)
            d_i = disc ** i.astype(dtype)
            v_here = d_i * value(s, i)
            # one-step inner conditional expectation of V_i from
            # S_{i-1}: exact E[C_i | S_{i-1}] + antithetic MC residual
            exact_ec = jnp.matmul(
                _poly_basis(s_prev / scale - 1.0, degree),
                cv_w[:, jnp.minimum(i - 1, cv_w.shape[1] - 1)],
                precision=jax.lax.Precision.HIGHEST)
            zh = jax.random.normal(ik, (n_inner // 2, B), dtype)
            zi = jnp.concatenate([zh, -zh], axis=0)
            s_in = s_prev[None, :] * jnp.exp(drift_h + vol_h * zi)
            resid = jax.vmap(
                lambda sr: value(sr, i) - cont_poly(sr, i))(s_in)
            M = M + v_here - d_i * (exact_ec + jnp.mean(resid, axis=0))
            best = jnp.maximum(best, d_i * payoff(s) - M)
            return (s, M, best), None

        best0 = payoff(s0v)                       # i = 0 term, M_0 = 0
        (s, M, best), _ = jax.lax.scan(
            step, (s0v, jnp.zeros((B,), dtype), best0),
            (keys, ikeys, jnp.arange(1, n_dates + 1)))
        return jnp.sum(best), jnp.sum(best * best)

    t0 = time.perf_counter()
    sm, sq = [float(x) for x in jax.device_get(run())]
    upper = sm / B
    se = float(np.sqrt(max(sq / B - upper ** 2, 0.0) / B))
    return {"upper": upper, "upper_se": se,
            "wall_s": time.perf_counter() - t0}


def _dual_model_machinery(payoff, s0, rate, T, n_dates, coef, model,
                          scheme, n_sub, degree, scale, dtype):
    """Shared setup of the model-dynamics dual estimators: date
    transition kernel, per-date Brownian draw, frozen value surface.
    Returns a dict of closures used by both the single-level
    (:func:`_dual_bound_model`) and multilevel
    (:func:`lsmc_dual_bound_ml`) nested-MC duals."""
    is_system = hasattr(model, "n_drivers")
    K = coef.shape[1]
    h = T / n_dates
    disc = float(np.exp(-rate * h))
    dt = h / n_sub
    if is_system:
        from mlmc_tpu.pce import total_degree_indices
        from mlmc_tpu.sim.sde import _system_step

        if scheme != "euler":
            raise ValueError("SDESystem duals integrate with Euler "
                             "substeps; pass scheme='euler'")
        dim = model.dim
        if degree is None:
            degree = next(
                (p for p in range(1, 16)
                 if len(total_degree_indices(dim, p)) == K), None)
            if degree is None:
                raise ValueError(
                    f"no total degree matches K={K} in dim {dim}; "
                    "pass degree explicitly")
        basis_idx_np = total_degree_indices(dim, degree)
        if len(basis_idx_np) != K:
            raise ValueError("degree/coef mismatch: total degree "
                             f"{degree} has {len(basis_idx_np)} terms, "
                             f"coef has {K}")
        sc = np.asarray(scale if scale is not None else model.s0,
                        np.float64).ravel()
        if sc.shape != (dim,):
            raise ValueError(f"scale must have {dim} components")
        sc = jnp.asarray(np.where(sc == 0.0, 1.0, np.abs(sc)), dtype)
        basis_idx = jnp.asarray(basis_idx_np, dtype)
        make_G = lambda s: _poly_basis_multi(s / sc - 1.0, basis_idx)
        s0_state = jnp.asarray(model.s0, dtype)

        def date_step(s, dws, i):
            # s [..., dim], dws [n_sub, ..., n_drivers]
            flat = s.reshape((-1, dim))
            for j in range(n_sub):
                t = i * h + j * dt
                flat = _system_step(model, flat,
                                    t, dws[j].reshape((-1,
                                                       model.n_drivers)),
                                    dt)
            return flat.reshape(s.shape)

        def draw(kk, shape):
            return np.sqrt(dt) * jax.random.normal(
                kk, (n_sub,) + shape + (model.n_drivers,), dtype)
    else:
        from mlmc_tpu.sim.sde import _scheme_increment

        if degree is None:
            degree = K - 1
        if degree + 1 != K:
            raise ValueError("degree+1 must match coef's second dim")
        if scheme == "milstein" and model.diffusion_ds is None:
            raise ValueError("Milstein needs SDEModel.diffusion_ds")
        dim = 1
        sc_f = float(scale if scale is not None else s0)
        make_G = lambda s: _poly_basis(s / sc_f - 1.0, degree)
        s0_state = jnp.asarray(model.s0, dtype)

        def date_step(s, dws, i):
            for j in range(n_sub):
                t = i * h + j * dt
                s = s + _scheme_increment(model, scheme, s, t, dws[j],
                                          dt)
            return s

        def draw(kk, shape):
            return np.sqrt(dt) * jax.random.normal(
                kk, (n_sub,) + shape, dtype)

    def cont_poly(s, i):
        flat = s.reshape((-1, dim) if is_system else (-1,))
        out = jnp.matmul(make_G(flat), coef[i - 1],
                         precision=jax.lax.Precision.HIGHEST)
        return out.reshape(s.shape[:-1] if is_system else s.shape)

    def value(s, i):
        ex = payoff(s)
        return jnp.where(i == n_dates, ex,
                         jnp.maximum(ex, cont_poly(s, i)))

    return dict(date_step=date_step, draw=draw, value=value,
                disc=disc, dim=dim, is_system=is_system,
                s0_state=s0_state)


def _dual_bound_model(payoff, s0, rate, T, n_dates, coef, model, scheme,
                      n_sub, degree, scale, B, n_inner, key, dtype):
    """Model-dynamics branch of :func:`lsmc_dual_bound`: Euler(/Milstein)
    substep transitions, plain antithetic nested inner expectation (no
    closed-form control variate — the Jensen inflation of the max only
    ever RAISES the bound, so validity is preserved)."""
    mk = _dual_model_machinery(payoff, s0, rate, T, n_dates, coef,
                               model, scheme, n_sub, degree, scale,
                               dtype)
    date_step, draw, value = mk["date_step"], mk["draw"], mk["value"]
    disc, dim, is_system = mk["disc"], mk["dim"], mk["is_system"]
    s0_state = mk["s0_state"]

    k_path, k_inner = jax.random.split(key)

    @jax.jit
    def run():
        shape0 = (B, dim) if is_system else (B,)
        s0v = jnp.broadcast_to(s0_state, shape0) if is_system \
            else jnp.full((B,), float(s0), dtype)
        keys = jax.random.split(k_path, n_dates)
        ikeys = jax.random.split(k_inner, n_dates)

        def step(carry, xs):
            s_prev, M, best = carry
            kk, ik, i = xs
            s = date_step(s_prev, draw(kk, (B,)), i - 1)
            d_i = disc ** i.astype(dtype)
            v_here = d_i * value(s, i)
            # antithetic one-date inner transitions from s_prev
            half = draw(ik, (n_inner // 2, B))
            dws = jnp.concatenate([half, -half], axis=1)
            s_prev_rep = jnp.broadcast_to(
                s_prev[None], (n_inner,) + s_prev.shape)
            s_in = date_step(s_prev_rep, dws, i - 1)
            e_v = jnp.mean(jax.vmap(lambda sr: value(sr, i))(s_in),
                           axis=0)
            M = M + v_here - d_i * e_v
            best = jnp.maximum(best, d_i * payoff(s) - M)
            return (s, M, best), None

        best0 = payoff(s0v)
        (s, M, best), _ = jax.lax.scan(
            step, (s0v, jnp.zeros((B,), dtype), best0),
            (keys, ikeys, jnp.arange(1, n_dates + 1)))
        return jnp.sum(best), jnp.sum(best * best)

    t0 = time.perf_counter()
    sm, sq = [float(x) for x in jax.device_get(run())]
    upper = sm / B
    se = float(np.sqrt(max(sq / B - upper ** 2, 0.0) / B))
    return {"upper": upper, "upper_se": se,
            "wall_s": time.perf_counter() - t0}


def lsmc_dual_bound_ml(payoff: Callable, s0: float, rate: float,
                       T: float, n_dates: int, coef, model,
                       scheme: str = "euler", n_sub: int = 1,
                       degree: Optional[int] = None,
                       scale=None, n0_inner: int = 8,
                       n_levels: int = 4, n_paths=1 << 13,
                       min_paths: int = 256, key=None, dtype=None):
    """MULTILEVEL nested dual: the Rogers upper bound of
    :func:`lsmc_dual_bound` (model-dynamics branch) with the
    inner-sample count telescoped MLMC-style (Giles & Goda, "Multilevel
    Monte Carlo for nested expectations", and Belomestny et al.'s
    multilevel dual): level ``l`` uses ``n_l = n0_inner * 2**l`` inner
    transitions per (path, date), and the coupled correction at level
    ``l`` is

        D_l = U(n_l) - ( U_A(n_l/2) + U_B(n_l/2) ) / 2

    computed on the SAME outer paths with the fine level's inner draws
    SPLIT into two half-estimators (each half keeps its own antithetic
    pairing, so each is an exact copy of the level-(l-1) estimator in
    distribution — the telescope is exactly consistent). The pathwise
    dual value ``U = max_i(disc^i h(S_i) - M_i)`` is a max of
    inner-sample means, so the halves' noise cancels against the full
    mean and ``Var[D_l]`` decays geometrically (measured ~2^-1.5 l on
    the Heston put) while a SINGLE-level run at ``n_L = n0 * 2^L``
    inner samples pays ``n_L`` on every path. The telescoped sum
    estimates ``E[U(n_L)]`` UNBIASEDLY — the same (valid, Jensen-
    inflated-from-above) upper bound the plain estimator reaches only
    by spending ``n_L`` inner samples on all of its paths — and the
    remaining inflation beyond ``n_L`` is bounded by the tail of the
    geometric ``mean(D_l)`` sequence (reported as ``bias_indicator``).

    GBM duals don't need this: the closed-form control variate of
    :func:`lsmc_dual_bound` already removes the inner-noise inflation,
    so this function requires ``model`` dynamics (the branch with no
    closed form — e.g. Heston).

    :param n_paths: outer paths at level 0 (halved per level, floored
        at ``min_paths``), or an explicit ``n_levels + 1``-long
        sequence.
    :return: dict with ``upper`` (telescoped), ``upper_se``,
        ``bias_indicator`` (|mean D_L|), ``levels`` (per-level
        n_inner/n_paths/mean/var/cost), ``inner_evals`` /
        ``single_level_evals`` (coupled-vs-plain inner-transition
        budgets at the same outer-path counts), ``wall_s``.
    """
    if n0_inner < 2 or n0_inner % 2:
        raise ValueError("n0_inner must be even and >= 2")
    if n_levels < 0:
        raise ValueError("n_levels must be >= 0")
    if key is None:
        key = jax.random.key(1)
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    coef = jnp.asarray(coef, dtype)
    if np.isscalar(n_paths) or np.ndim(n_paths) == 0:
        paths = [max(int(n_paths) >> l, int(min_paths))
                 for l in range(n_levels + 1)]
    else:
        paths = [int(p) for p in n_paths]
        if len(paths) != n_levels + 1:
            raise ValueError(f"n_paths must have {n_levels + 1} "
                             "entries")
    mk = _dual_model_machinery(payoff, s0, rate, T, n_dates, coef,
                               model, scheme, n_sub, degree, scale,
                               dtype)
    date_step, draw, value = mk["date_step"], mk["draw"], mk["value"]
    disc, dim, is_system = mk["disc"], mk["dim"], mk["is_system"]
    s0_state = mk["s0_state"]

    def make_run(nl, Bl, coupled, kl):
        """One jitted program per level: pathwise dual values for the
        full-``nl`` estimator and (coupled levels) the two half
        estimators sharing its inner draws."""
        k_path, k_inner = jax.random.split(kl)
        m = 3 if coupled else 1

        @jax.jit
        def run():
            shape0 = (Bl, dim) if is_system else (Bl,)
            s0v = jnp.broadcast_to(s0_state, shape0) if is_system \
                else jnp.full((Bl,), float(s0), dtype)
            keys = jax.random.split(k_path, n_dates)
            ikeys = jax.random.split(k_inner, n_dates)

            def step(carry, xs):
                s_prev, M, best = carry          # M, best: [m, Bl]
                kk, ik, i = xs
                s = date_step(s_prev, draw(kk, (Bl,)), i - 1)
                d_i = disc ** i.astype(dtype)
                v_here = d_i * value(s, i)
                if coupled:
                    ika, ikb = jax.random.split(ik)
                    q = nl // 4
                    qa = draw(ika, (q, Bl))
                    qb = draw(ikb, (q, Bl))
                    dws = jnp.concatenate([qa, -qa, qb, -qb], axis=1)
                else:
                    hf = draw(ik, (nl // 2, Bl))
                    dws = jnp.concatenate([hf, -hf], axis=1)
                s_prev_rep = jnp.broadcast_to(
                    s_prev[None], (nl,) + s_prev.shape)
                s_in = date_step(s_prev_rep, dws, i - 1)
                v_in = jax.vmap(lambda sr: value(sr, i))(s_in)
                if coupled:
                    e_a = jnp.mean(v_in[:nl // 2], axis=0)
                    e_b = jnp.mean(v_in[nl // 2:], axis=0)
                    e = jnp.stack([0.5 * (e_a + e_b), e_a, e_b])
                else:
                    e = jnp.mean(v_in, axis=0)[None]
                M = M + (v_here[None] - d_i * e)
                best = jnp.maximum(best, (d_i * payoff(s))[None] - M)
                return (s, M, best), None

            best0 = jnp.broadcast_to(payoff(s0v)[None], (m, Bl))
            (s, M, best), _ = jax.lax.scan(
                step, (s0v, jnp.zeros((m, Bl), dtype), best0),
                (keys, ikeys, jnp.arange(1, n_dates + 1)))
            y = (best[0] - 0.5 * (best[1] + best[2])) if coupled \
                else best[0]
            return jnp.sum(y), jnp.sum(y * y)

        return run

    t0 = time.perf_counter()
    lkeys = jax.random.split(key, n_levels + 1)
    levels, upper, var_sum = [], 0.0, 0.0
    last_mean = 0.0
    for l in range(n_levels + 1):
        nl = n0_inner << l
        Bl = paths[l]
        sm, sq = [float(x) for x in jax.device_get(
            make_run(nl, Bl, l > 0, lkeys[l])())]
        mean = sm / Bl
        var = max(sq / Bl - mean ** 2, 0.0)
        levels.append({"n_inner": nl, "n_paths": Bl, "mean": mean,
                       "var": var, "cost": Bl * nl * n_dates})
        upper += mean
        var_sum += var / Bl
        last_mean = mean
    inner_evals = sum(lv["cost"] for lv in levels)
    single = paths[0] * (n0_inner << n_levels) * n_dates
    return {"upper": upper, "upper_se": float(np.sqrt(var_sum)),
            "bias_indicator": abs(last_mean), "levels": levels,
            "inner_evals": inner_evals, "single_level_evals": single,
            "wall_s": time.perf_counter() - t0}


def lsmc_swing(payoff: Callable, s0: float, rate: float, T: float,
               n_dates: int, n_rights: int, sigma: float,
               degree: int = 3, n_paths: int = 1 << 16, key=None,
               scale: Optional[float] = None, dtype=None):
    """Swing (multiple-stopping) option: up to ``n_rights`` exercises,
    at most one per date — the standard energy-market extension of the
    Bermudan contract (Meinshausen & Hambly, Math. Finance 14, 2004,
    LSMC form). Backward induction carries one continuation surface
    PER remaining-rights count q:

        V_{i,q} = max( C_{i,q},  h(S_i) + C_{i,q-1} ),
        C_{i,q} = E[ disc * V_{i+1,q} | S_i ],

    each C estimated by Longstaff-Schwartz regression of the realized
    discounted cashflow stack [Q, B] — the whole induction is still ONE
    jitted ``lax.scan`` over dates (the q-loop is a small static
    unroll; per date Q normal equations). Two-pass foresight-bias
    control as in :func:`lsmc_price`: the frozen [n_dates-1, Q, K]
    surface prices an independent path set.

    Exact closed-form anchors (pinned in tests): ``n_rights = 1`` is
    the Bermudan; ``n_rights = n_dates`` removes scarcity, so the value
    is the SUM of European puts across all dates; marginal right values
    decrease in q.

    Exact GBM dynamics (``sigma``). Global regression (no ITM
    restriction): with multiple rights the continuation value is
    nonzero far out of the money.

    :return: dict with ``price`` (out-of-sample), ``price_se``,
        ``price_insample``, ``prices_by_rights`` [Q] (out-of-sample
        value at every rights count — the whole value curve falls out
        of one run), ``coef`` [n_dates - 1, Q, K], ``wall_s``.
    """
    if n_dates < 1 or not 1 <= n_rights <= n_dates:
        raise ValueError("need n_dates >= 1 and 1 <= n_rights <= "
                         "n_dates")
    if key is None:
        key = jax.random.key(0)
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    scale_f = float(scale if scale is not None else s0)
    h = T / n_dates
    disc = float(np.exp(-rate * h))
    drift_h = float((rate - 0.5 * sigma ** 2) * h)
    vol_h = float(sigma * np.sqrt(h))
    K = degree + 1
    Q = int(n_rights)
    B = int(n_paths)
    k_fit, k_eval = jax.random.split(key)

    def simulate(kr):
        keys = jax.random.split(kr, n_dates)

        def fwd(s, kk):
            s = s * jnp.exp(drift_h + vol_h
                            * jax.random.normal(kk, s.shape, dtype))
            return s, s

        _, panel = jax.lax.scan(fwd, jnp.full((B,), s0, dtype), keys)
        return panel                                 # [n_dates, B]

    def normal_fit(G, y):
        # Column-equilibrated QR least squares, multi-RHS (y [B, Q]) —
        # the same cond(G)-not-cond(G)^2 route as lsmc_price's TSQR
        # (one factorization serves all Q rights levels); HIGHEST
        # precision matmuls guard the measured bf16 failure mode
        # (default passes bled the 50-date q=1 value 0.0561 -> 0.0418)
        hi = jax.lax.Precision.HIGHEST
        d = jax.lax.rsqrt(jnp.maximum(jnp.sum(G * G, axis=0), 1e-30))
        q, r = jnp.linalg.qr(G * d[None, :])
        c = jnp.matmul(q.T, y, precision=hi)
        eps = (1e-6 if jnp.finfo(dtype).bits < 64 else 1e-12)
        rr = jnp.concatenate(
            [r, jnp.sqrt(eps) * jnp.eye(K, dtype=dtype)], axis=0)
        cc = jnp.concatenate(
            [c, jnp.zeros((K, y.shape[1]), dtype)], axis=0)
        q2, r2 = jnp.linalg.qr(rr)
        x = jax.scipy.linalg.solve_triangular(
            r2, jnp.matmul(q2.T, cc, precision=hi), lower=False)
        return x * d[:, None]

    def backward(panel, coefs, fit):
        ex_T = payoff(panel[-1])
        # terminal date: exercising is free value for every q >= 1
        cf = jnp.broadcast_to(ex_T, (Q, B))          # [Q, B] cashflows
        xs = (panel[:-1][::-1], coefs[::-1])

        def bwd(cf, xs):
            s, c = xs
            cf = disc * cf
            G = _poly_basis(s / scale_f - 1.0, degree)
            if fit:
                c = normal_fit(G, cf.T).T            # [Q, K]
            cont = jnp.matmul(c, G.T,
                              precision=jax.lax.Precision.HIGHEST)
            ex = payoff(s)
            # rights q = 1..Q (index q-1); continuation with q-1
            # rights after exercising NOW (index q-2; zero for q = 1)
            cont_below = jnp.concatenate(
                [jnp.zeros((1, B), dtype), cont[:-1]], axis=0)
            cf_below = jnp.concatenate(
                [jnp.zeros((1, B), dtype), cf[:-1]], axis=0)
            take = (ex > 0) & (ex[None, :] + cont_below > cont)
            cf = jnp.where(take, ex[None, :] + cf_below, cf)
            return cf, c

        cf, cs = jax.lax.scan(bwd, cf, xs)
        return disc * cf, cs[::-1]                   # [Q, B], coefs

    def run(fit):
        @jax.jit
        def go(kr, coefs):
            panel = simulate(kr)
            values, cs = backward(panel, coefs, fit)
            return jnp.stack([jnp.sum(values, axis=1),
                              jnp.sum(values * values, axis=1)]), cs

        return go

    t0 = time.perf_counter()
    dummy = jnp.zeros((max(n_dates - 1, 1), Q, K), dtype)[:n_dates - 1]
    stats_in, coefs = run(True)(k_fit, dummy)
    stats, _ = run(False)(k_eval, coefs)
    (stats_in, stats), coefs = jax.device_get(((stats_in, stats),
                                               coefs))
    sums, sqs = np.asarray(stats, np.float64)
    prices = sums / B
    ses = np.sqrt(np.maximum(sqs / B - prices ** 2, 0.0) / B)
    return {"price": float(prices[-1]), "price_se": float(ses[-1]),
            "price_insample": float(np.asarray(stats_in[0],
                                               np.float64)[-1]) / B,
            "prices_by_rights": prices,
            "prices_by_rights_se": ses,
            "coef": np.asarray(coefs, np.float64),
            "wall_s": time.perf_counter() - t0}
