"""Variance-based global sensitivity analysis (Sobol' indices) — beyond
the reference, which has no sensitivity-analysis capability at all.

A UQ framework that estimates E[Q] and reconstructs densities is usually
asked the next question too: WHICH inputs drive the variance of Q?
First-order indices ``S_i = Var(E[Q|x_i])/Var(Q)`` and total-effect
indices ``S_Ti = 1 − Var(E[Q|x_~i])/Var(Q)`` answer it, and the standard
estimators (Saltelli's pick-freeze design with Jansen's 1999 difference
estimators — the configuration recommended by Saltelli et al. 2010,
"Variance based sensitivity analysis of model output") are a perfect device
workload: one design matrix of ``n·(d+2)`` model evaluations, reduced to
``2d+4`` accumulator scalars, all inside one jitted program.

Two estimators:

- :func:`sobol_indices` — single model, the standard pick-freeze run;
- :func:`sobol_indices_mlmc` — a level hierarchy ``f_0 … f_L`` (the
  MLMC contract: each level evaluates fine AND coarse on the same
  input): every pick-freeze expectation telescopes across levels
  (Mycek & Le Maître 2019, "Multilevel Monte Carlo estimators for
  Sobol' indices"), so most design evaluations hit the cheap levels.

Device-first design (mirrors `mlmc_tpu.qmc.MLQMC`'s streaming economics):

- the pick-freeze blocks A and B are the first/last ``d`` columns of ONE
  ``2d``-dimensional Owen-scrambled Sobol' sequence (`ops.sobol`), so
  the design itself converges at QMC rates;
- ``R`` independent scramblings run vmapped in one dispatch; indices are
  estimated per scrambling and the spread across scramblings gives
  honest standard errors (the same randomization story as MLQMC);
- the chunk loop has a traced trip count — ONE executable serves every
  ``n`` — and only ``[R, 2d+4]`` accumulators cross the host link;
- f32 accumulation is compensated with the fusion-hardened two_sum
  (`ops/df64`), as in the MLQMC driver.

Estimators (per scrambling; f_A, f_B, f_ABi are the model on the A / B /
"A with column i from B" blocks):

- variance: pooled unbiased variance of (f_A, f_B)
- first order (Jansen):  V_i  = V − Σ_j (f_B − f_ABi)² / (2n)
- total effect (Jansen): VT_i =      Σ_j (f_A − f_ABi)² / (2n)
"""
from typing import Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.ops import sobol

__all__ = ["sobol_indices", "sobol_indices_mlmc", "SobolIndices",
           "active_subspace"]


class SobolIndices(dict):
    """Result mapping with attribute access (``res.first_order`` ==
    ``res["first_order"]``)."""

    __getattr__ = dict.__getitem__


def _check_args(dim, n_randomizations, chunk_size):
    if dim < 1:
        raise ValueError("dim must be >= 1")
    if n_randomizations < 2:
        raise ValueError("need >= 2 randomizations for standard errors")
    if chunk_size & (chunk_size - 1):
        raise ValueError("chunk_size must be a power of two")


def _round_to_chunks(n, chunk_size):
    chunk = min(int(chunk_size), max(64, 1 << (int(n) - 1).bit_length()))
    n_chunks = -(-int(n) // chunk)
    return chunk, n_chunks, n_chunks * chunk


_PROGRAM_CACHE = {}


def _design_program_cached(level_fn, dim, chunk, work_dtype, transform,
                           single=False):
    """Per-process program cache: a fresh ``jax.jit`` closure per call
    would re-trace and re-fetch the executable every time, even with the
    persistent compile cache. Keyed on the
    function objects, so repeat calls with the same model hit.
    ``single`` wraps a scalar model as a zero-coarse level INSIDE the
    builder, keeping the cache key on the user's function object."""
    key = (level_fn, transform, dim, chunk, str(work_dtype), single)
    run = _PROGRAM_CACHE.get(key)
    if run is None:
        if len(_PROGRAM_CACHE) >= 128:
            _PROGRAM_CACHE.pop(next(iter(_PROGRAM_CACHE)))
        run = _design_program(level_fn, dim, chunk, work_dtype, transform,
                              single)
        _PROGRAM_CACHE[key] = run
    return run


def _design_program(level_fn, dim, chunk, work_dtype, transform,
                    single=False):
    """Jittable ``(n_chunks, seeds [R, 2d]) -> six accumulators`` running
    the pick-freeze design through ``level_fn(x) -> (fine, coarse)`` and
    accumulating the TELESCOPED terms (single-level callers return
    ``coarse = 0`` and XLA folds the zero subtractions away):

    ``sa = Σ Δ(A)``, ``sa2 = Σ Δ²(A)`` (Δ² meaning fine² − coarse²),
    same for B, and per input factor i
    ``d1_i = Σ [(f_B − f_ABi)² − (c_B − c_ABi)²]``,
    ``dt_i = Σ [(f_A − f_ABi)² − (c_A − c_ABi)²]``.
    """
    if single:
        scalar_fn = level_fn

        def level_fn(x):  # noqa: F811 — zero coarse, folded away by XLA
            y = scalar_fn(x)
            return y, jnp.zeros_like(y)

    dv = jnp.asarray(sobol.direction_numbers(2 * dim))
    eye = jnp.eye(dim, dtype=bool)

    if work_dtype == jnp.float32:
        from mlmc_tpu.ops.df64 import two_sum
    else:
        def two_sum(a, b):
            return a + b, jnp.zeros_like(a)

    def eval_blocks(start, sds):
        u = sobol.sobol_uniforms(dv, start, chunk, sds, dtype=work_dtype)
        a, b = u[:, :dim], u[:, dim:]
        if transform is not None:
            a, b = transform(a), transform(b)
        f_a, c_a = level_fn(a)
        f_b, c_b = level_fn(b)
        # AB_i: A with column i taken from B — [d, chunk, dim]
        ab = jnp.where(eye[:, None, :], b[None], a[None])
        f_ab, c_ab = level_fn(ab.reshape(dim * chunk, dim))
        return ((f_a, c_a), (f_b, c_b),
                (f_ab.reshape(dim, chunk), c_ab.reshape(dim, chunk)))

    def one_rand(n_chunks, sds):
        zs = jnp.zeros((), work_dtype)
        zd = jnp.zeros((dim,), work_dtype)
        init = ((zs, zs), (zs, zs), (zs, zs), (zs, zs), (zd, zd), (zd, zd))

        def add(c, x):
            s, e = two_sum(c[0], x.astype(work_dtype))
            return s, c[1] + e

        def body(c, carry):
            sa, sa2, sb, sb2, d1, dt = carry
            (f_a, c_a), (f_b, c_b), (f_ab, c_ab) = eval_blocks(
                jnp.uint32(c) * jnp.uint32(chunk), sds)
            sa = add(sa, jnp.sum(f_a - c_a))
            sa2 = add(sa2, jnp.sum(f_a * f_a - c_a * c_a))
            sb = add(sb, jnp.sum(f_b - c_b))
            sb2 = add(sb2, jnp.sum(f_b * f_b - c_b * c_b))
            d1 = add(d1, jnp.sum((f_b[None] - f_ab) ** 2
                                 - (c_b[None] - c_ab) ** 2, axis=1))
            dt = add(dt, jnp.sum((f_a[None] - f_ab) ** 2
                                 - (c_a[None] - c_ab) ** 2, axis=1))
            return sa, sa2, sb, sb2, d1, dt

        out = jax.lax.fori_loop(0, n_chunks, body, init)
        return tuple(s + e for s, e in out)

    @jax.jit
    def run(n_chunks, seeds):
        return jax.vmap(lambda sd: one_rand(n_chunks, sd))(seeds)

    return run


def _fetch_accumulators(run, n_chunks, seeds):
    out = jax.device_get(run(n_chunks, seeds))
    out = tuple(np.asarray(x, np.float64) for x in out)
    if not all(np.all(np.isfinite(x)) for x in out):
        raise FloatingPointError(
            "model produced non-finite values on the design; Sobol-index "
            "estimators cannot drop points without bias")
    return out


def _aggregate(s1, st, var, m, n, R, n_evaluations):
    def agg(x):
        return (np.mean(x, axis=0),
                np.std(x, axis=0, ddof=1) / np.sqrt(R))

    s1_m, s1_se = agg(s1)
    st_m, st_se = agg(st)
    return SobolIndices(
        first_order=s1_m, first_order_se=s1_se,
        total_effect=st_m, total_effect_se=st_se,
        variance=float(np.mean(var)), mean=float(np.mean(m)),
        n=n, n_randomizations=R, n_evaluations=n_evaluations)


def sobol_indices(fn: Callable, dim: int, n: int = 1 << 13,
                  n_randomizations: int = 8, seed: int = 0,
                  chunk_size: int = 1 << 11, dtype=None,
                  transform: Optional[Callable] = None) -> SobolIndices:
    """Estimate first-order and total-effect Sobol' indices of ``fn``.

    :param fn: pure jnp model ``f(x [m, dim]) -> y [m]`` over the unit
        hypercube (after ``transform``, if given)
    :param dim: number of input factors
    :param n: pick-freeze design size per randomization (rounded up to a
        multiple of the chunk; total model evaluations are
        ``n_randomizations · n · (dim + 2)``)
    :param n_randomizations: independent Owen scramblings; indices are
        estimated per scrambling and reported as mean ± standard error
        across them
    :param seed: scramble master seed
    :param chunk_size: design points per scan step inside the dispatch
    :param dtype: accumulation dtype (default: jnp.result_type(float))
    :param transform: optional pointwise map applied to the uniform
        design columns before ``fn`` (e.g.
        ``mlmc_tpu.ops.sobol.normals_from_uniforms`` for Gaussian
        factors) — applied to A and B once, so frozen columns are
        bit-identical across the AB_i blocks
    :return: :class:`SobolIndices` with ``first_order`` / ``total_effect``
        ``[dim]`` arrays, their ``*_se`` standard errors, ``variance``,
        ``mean``, ``n`` and ``n_evaluations``
    """
    dim = int(dim)
    R = int(n_randomizations)
    _check_args(dim, R, int(chunk_size))
    chunk, n_chunks, n = _round_to_chunks(n, chunk_size)
    work_dtype = jnp.dtype(dtype or jnp.result_type(float))

    run = _design_program_cached(fn, dim, chunk, work_dtype, transform,
                                 single=True)
    seeds = jax.vmap(lambda k: sobol.scramble_seeds(k, 2 * dim))(
        jax.random.split(jax.random.key(seed), R))
    sa, sa2, sb, sb2, d1, dt = _fetch_accumulators(run, n_chunks, seeds)

    m = (sa + sb) / (2 * n)                       # [R]
    var = ((sa2 + sb2) / (2 * n) - m * m) * (2 * n) / (2 * n - 1)
    if np.any(var <= 0):
        raise ValueError("model variance is zero on the design; "
                         "Sobol' indices are undefined")
    s1 = (var[:, None] - d1 / (2 * n)) / var[:, None]      # [R, d]
    st = (dt / (2 * n)) / var[:, None]
    return _aggregate(s1, st, var, m, n, R, R * n * (dim + 2))


def sobol_indices_mlmc(level_fns: Sequence[Callable], dim: int,
                       n_per_level: Sequence[int],
                       n_randomizations: int = 8, seed: int = 0,
                       chunk_size: int = 1 << 11, dtype=None,
                       transform: Optional[Callable] = None
                       ) -> SobolIndices:
    """Multilevel Sobol' indices: telescope every pick-freeze expectation
    across a model hierarchy (Mycek & Le Maître 2019), so the accuracy of
    the finest model costs mostly coarse-level evaluations.

    Each level function follows the MLMC contract of `mlmc_tpu.qmc`:
    ``level_fns[l](x [m, dim]) -> (fine [m], coarse [m])`` with BOTH
    models evaluated on the same input (level 0 returns ``coarse == 0``).
    Every estimator ingredient — E[f], E[f²] and the Jansen difference
    terms E[(f_B − f_ABi)²], E[(f_A − f_ABi)²] — is a plain expectation,
    so each telescopes as ``Σ_l E[g_l − g_{l−1}]`` with independent
    scrambled designs per level.

    The variance uses the population form ``V = E[f²] − E[f]²``
    (an unbiased cross-level correction does not exist in closed form;
    the O(1/n) bias is far below the index standard errors at any
    reasonable design size).

    :param n_per_level: design size per level (decreasing, like MLMC
        sample allocations); each is rounded up to a chunk multiple
    :return: :class:`SobolIndices`; ``n`` and ``level_terms`` hold the
        per-level design sizes and the per-level telescoped contributions
        to (V, mean) for diagnostics
    """
    dim = int(dim)
    R = int(n_randomizations)
    _check_args(dim, R, int(chunk_size))
    L = len(level_fns)
    if len(n_per_level) != L:
        raise ValueError("n_per_level must match level_fns")
    work_dtype = jnp.dtype(dtype or jnp.result_type(float))
    key = jax.random.key(seed)

    m = np.zeros(R)
    ef2 = np.zeros(R)
    t1 = np.zeros((R, dim))
    tt = np.zeros((R, dim))
    ns, level_v, level_m = [], [], []
    n_evaluations = 0
    for lev, (fn, n_l) in enumerate(zip(level_fns, n_per_level)):
        chunk, n_chunks, n_l = _round_to_chunks(n_l, chunk_size)
        ns.append(n_l)
        n_evaluations += 2 * R * n_l * (dim + 2)  # fine + coarse
        run = _design_program_cached(fn, dim, chunk, work_dtype, transform)
        seeds = jax.vmap(lambda k: sobol.scramble_seeds(k, 2 * dim))(
            jax.random.split(jax.random.fold_in(key, lev), R))
        sa, sa2, sb, sb2, d1, dt = _fetch_accumulators(run, n_chunks,
                                                       seeds)
        m += (sa + sb) / (2 * n_l)
        ef2 += (sa2 + sb2) / (2 * n_l)
        t1 += d1 / (2 * n_l)
        tt += dt / (2 * n_l)
        level_v.append(float(np.mean((sa2 + sb2) / (2 * n_l))))
        level_m.append(float(np.mean((sa + sb) / (2 * n_l))))

    var = ef2 - m * m                              # [R], population form
    if np.any(var <= 0):
        raise ValueError(
            "telescoped variance is not positive — coarse levels "
            "overwhelm the fine correction at these design sizes")
    s1 = (var[:, None] - t1) / var[:, None]
    st = tt / var[:, None]
    out = _aggregate(s1, st, var, m, np.asarray(ns), R, n_evaluations)
    out["level_terms"] = dict(e_f2=level_v, mean=level_m)
    return out


# --------------------------------------------------------------------- #
# Active subspaces: gradient-based dimension reduction
# --------------------------------------------------------------------- #
def active_subspace(fn: Callable, dim: int, n_samples: int = 8192,
                    key=None, sampler: Optional[Callable] = None,
                    chunk_size: int = 2048, dtype=None):
    """Constantine's active subspaces (SIAM Spotlights 2, 2015):
    eigendecomposition of the gradient covariance

        C = E[ grad f(x) grad f(x)^T ],

    whose dominant eigenspace is the subspace along which ``f``
    actually varies — the gradient-based complement to the Sobol'
    indices above (axis-aligned attribution vs arbitrary directions).
    Pathwise gradients come from ``jax.grad`` — the reference's numpy
    pipeline has no differentiation capability at all.

    Device-first design: gradients evaluate as vmapped [C, d] blocks and
    C accumulates as one ``G^T G`` per chunk inside a jitted
    fori_loop; even/odd chunks feed two INDEPENDENT half-estimates
    whose per-k principal-subspace distance is the stability
    diagnostic (Constantine's bootstrap, split-half form). Only the
    two [d, d] matrices cross to the host, where the symmetric
    eigendecomposition runs (d is small by the time a subspace is
    sought).

    :param fn: ``x [d] -> scalar`` pure jnp, differentiable.
    :param sampler: ``(key, n) -> x [n, d]`` input draw (default
        N(0, I) — match it to the distribution your Sobol'/moment
        workloads integrate against).
    :return: dict with ``eigvals`` [d] (descending), ``W`` [d, d]
        (columns = directions), ``activity`` [d] per-INPUT scores
        ``sum_j lam_j W_ij^2`` (ranks raw inputs like total-effect
        indices), ``explained`` [d] cumulative eigenvalue fraction
        (Constantine's projection-error bound is ~ sqrt(1 -
        explained[k])), ``subspace_dist`` [d-1] split-half principal
        subspace distances per retained k, ``n_samples``, ``wall_s``.
    """
    import time as _time

    if dim < 1:
        raise ValueError("dim must be >= 1")
    if key is None:
        key = jax.random.key(0)
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    chunk = int(min(chunk_size, n_samples))
    n_chunks = -(-int(n_samples) // chunk)
    if n_chunks < 2:
        n_chunks = 2                       # two halves for stability
    grad_fn = jax.vmap(jax.grad(fn))

    def draw(kk):
        if sampler is not None:
            return jnp.asarray(sampler(kk, chunk), dtype)
        return jax.random.normal(kk, (chunk, dim), dtype)

    @jax.jit
    def run(k0):
        def body(c, carry):
            c_even, c_odd = carry
            g = grad_fn(draw(jax.random.fold_in(k0, c)))   # [C, d]
            gram = jnp.matmul(g.T, g,
                              precision=jax.lax.Precision.HIGHEST)
            even = (c % 2) == 0
            return (c_even + jnp.where(even, 1.0, 0.0) * gram,
                    c_odd + jnp.where(even, 0.0, 1.0) * gram)

        z = jnp.zeros((dim, dim), dtype)
        return jax.lax.fori_loop(0, n_chunks, body, (z, z))

    t0 = _time.perf_counter()
    c_even, c_odd = [np.asarray(a, np.float64)
                     for a in jax.device_get(run(key))]
    n_even = chunk * ((n_chunks + 1) // 2)
    n_odd = chunk * (n_chunks // 2)
    C = (c_even + c_odd) / (n_even + n_odd)
    lam, W = np.linalg.eigh(C)
    order = np.argsort(lam)[::-1]
    lam, W = np.maximum(lam[order], 0.0), W[:, order]
    total = max(lam.sum(), np.finfo(float).tiny)
    # split-half principal-subspace distance per retained k
    dists = []
    _, W1 = np.linalg.eigh(c_even / max(n_even, 1))
    _, W2 = np.linalg.eigh(c_odd / max(n_odd, 1))
    W1, W2 = W1[:, ::-1], W2[:, ::-1]
    for k in range(1, dim):
        P1 = W1[:, :k] @ W1[:, :k].T
        P2 = W2[:, :k] @ W2[:, :k].T
        dists.append(float(np.linalg.norm(P1 - P2, 2)))
    return {"eigvals": lam, "W": W,
            "activity": (W ** 2 @ lam),
            "explained": np.cumsum(lam) / total,
            "subspace_dist": np.asarray(dists),
            "C": C, "n_samples": n_even + n_odd,
            "wall_s": _time.perf_counter() - t0}
