"""Multilevel Richardson-Romberg extrapolation (ML2R) — beyond-reference
tier.

Lemaire & Pagès ("Multilevel Richardson-Romberg extrapolation",
Bernoulli 23(4A), 2017): when the weak bias expands in powers of the
step,

    E[Y_h] = I + c_1 h^alpha + c_2 h^{2 alpha} + ... ,

the plain MLMC telescope (reference mlmc/sampler.py + estimator.py
adaptive loop) still carries the FINEST level's bias ``c_1 h_L^alpha``
— driving it down costs geometrically deeper levels. ML2R instead
re-weights the same telescoped corrections,

    I_ML2R = sum_l  W_l * mean(Y_l - Y_{l-1}),     W_l = sum_{j>=l} w_j,

with weights solving the Vandermonde system ``sum_j w_j = 1``,
``sum_j w_j h_j^{k alpha} = 0`` for k = 1..L — every expansion term up
to order ``h^{(L+1) alpha}`` cancels IDENTICALLY, so a shallow cheap
hierarchy reaches accuracies the unweighted telescope needs many more
(and much finer) levels for. Statistical cost: the level variances pick
up the factors ``W_l^2`` (W_0 = 1 always; deeper weights approach 1
from above), so the CLT allocation simply uses ``W_l^2 V_l``.

Device-first design: reuses the one-executable-per-level Kahan-compensated
streaming programs of the continuation driver (mlmc_tpu/cmlmc.py) — a
dynamic trip count per level, sample identity (level, position) ->
fold_in, two scalars + a count crossing the link per extension. The
weight solve is a tiny host-side f64 Vandermonde (a decision, not a
computation).

Level contract (shared with the CDF/risk/unbiased/CMLMC tiers):
``pair_fn(level, keys [C]) -> (fine [C], coarse [C], valid [C])``;
adapt any Simulation via
:func:`mlmc_tpu.cdf_estimate.simulation_pair_fn`.

Both estimates come back from the SAME samples: ``mean`` (ML2R) and
``mean_mlmc`` (unweighted telescope) — the bias gap is directly
observable, which the tests pin against a closed-form expansion.

No reference analogue: GeoMop/MLMC has no extrapolation capability.
"""
import time
from typing import Callable, Optional, Sequence

import numpy as np
import jax.numpy as jnp
import jax

from mlmc_tpu.cmlmc import _mean_program

__all__ = ["ml2r_weights", "ml2r"]


def ml2r_weights(level_steps: Sequence[float], alpha: float = 1.0):
    """Solve the ML2R weight system for an arbitrary decreasing step
    hierarchy: ``sum_j w_j = 1`` and ``sum_j w_j h_j^{k alpha} = 0``
    for k = 1..L (L+1 levels kill L expansion terms).

    :return: (w, W) — the per-level weights ``w`` [L+1] and their tail
        sums ``W_l = sum_{j>=l} w_j`` [L+1] applied to the telescoped
        corrections (``W[0] == 1`` identically).

    The system is a Vandermonde in ``h^alpha`` — well-conditioned for
    the usual geometric hierarchies up to ~8-10 levels (the f64 host
    solve's residual is checked at 1e-8 and raises beyond).
    """
    h = np.asarray(level_steps, np.float64).ravel()
    if len(h) < 1:
        raise ValueError("need at least one level")
    if np.any(h <= 0) or np.any(h[1:] >= h[:-1]):
        raise ValueError("level_steps must be positive and decrease "
                         "(finest last)")
    if alpha <= 0:
        raise ValueError("alpha must be positive")
    n = len(h)
    # scale nodes by the coarsest step for conditioning
    x = (h / h[0]) ** float(alpha)
    V = np.vander(x, n, increasing=True).T        # row k: x^k
    rhs = np.zeros(n)
    rhs[0] = 1.0
    # conditioning guard BEFORE solving: the f64 solve's residual stays
    # deceptively small even when the weights themselves lose all
    # digits (measured: geometric M=2 hierarchies are fine through ~9
    # levels at alpha=1, cond 1.6e8 at 8; 16 levels at alpha=0.25 hit
    # cond 1e15 with |w| ~ 2e4)
    cond = float(np.linalg.cond(V))
    if not np.isfinite(cond) or cond > 1e12:
        raise ValueError(
            "ML2R weight system ill-conditioned (cond %.2e > 1e12) — "
            "hierarchy too deep or steps too close for f64 weights; "
            "reduce the level count" % cond)
    w = np.linalg.solve(V, rhs)
    W = np.cumsum(w[::-1])[::-1]
    return w, W


def ml2r(pair_fn: Callable, level_steps: Sequence[float],
         target_var: float, alpha: float = 1.0, seed: int = 0,
         cost_fn: Optional[Callable] = None, chunk_size: int = 1 << 12,
         n_pilot: int = 1 << 12, max_rounds: int = 30, dtype=None,
         mesh=None):
    """Run the ML2R estimator to a statistical variance target.

    :param pair_fn: level contract above, pure jnp.
    :param level_steps: steps ``h_l``, coarsest first — ALL levels are
        used (the weights are tied to the full hierarchy).
    :param target_var: allocation target for
        ``sum_l W_l^2 V_l / n_l``.
    :param alpha: weak-expansion exponent (Euler-Maruyama: 1.0;
        Milstein/weak-2nd-order schemes: match the scheme).
    :param cost_fn: optional ``level -> relative cost``; measured wall
        per sample otherwise.
    :param mesh: optional :class:`~mlmc_tpu.parallel.mesh.SampleMesh` —
        chunks shard across the devices (chunk_size must divide by the
        device count), one psum per extension, device-count-invariant
        sample identity.
    :return: dict with ``mean`` (ML2R), ``mean_mlmc`` (unweighted
        telescope on the same samples), ``var`` (weighted estimator
        variance), ``se``, ``weights`` (w, tail W), ``n_per_level``,
        ``level_means``, ``level_vars``, ``target_met``, ``n_forward``,
        ``wall_s``.
    """
    h = np.asarray(level_steps, np.float64).ravel()
    if len(h) < 2:
        raise ValueError("need at least a 2-level hierarchy")
    if target_var <= 0:
        raise ValueError("target_var must be positive")
    w, W = ml2r_weights(h, alpha)
    L = len(h)
    if mesh is not None and chunk_size % mesh.n_devices:
        raise ValueError(
            "chunk_size=%d must divide by the mesh's %d devices"
            % (chunk_size, mesh.n_devices))
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    root = jax.random.key(seed)
    programs = [_mean_program(pair_fn, lv, chunk_size, dtype, root,
                              mesh=mesh)
                for lv in range(L)]
    sums = np.zeros(L)
    sums2 = np.zeros(L)
    nval = np.zeros(L)
    ndrawn = np.zeros(L, dtype=np.int64)
    elapsed = np.zeros(L)
    t0 = time.perf_counter()

    def extend(lv, n_add):
        n_chunks = -(-int(n_add) // chunk_size)
        if n_chunks <= 0:
            return
        start = ndrawn[lv] // chunk_size
        tt = time.perf_counter()
        flat = np.asarray(jax.device_get(programs[lv](
            jnp.uint32(start), jnp.uint32(n_chunks))), np.float64)
        elapsed[lv] += time.perf_counter() - tt
        sums[lv] += flat[0]
        sums2[lv] += flat[1]
        nval[lv] += flat[2]
        ndrawn[lv] += n_chunks * chunk_size

    def stats():
        n = np.maximum(nval, 1.0)
        m = sums / n
        v = np.maximum(sums2 / n - m * m, 1e-300)
        return m, v

    def costs():
        if cost_fn is not None:
            return np.array([float(cost_fn(lv)) for lv in range(L)])
        return np.maximum(elapsed / np.maximum(ndrawn, 1), 1e-12)

    for lv in range(L):
        extend(lv, n_pilot)
    rounds = 0
    while rounds < max_rounds:
        m, v = stats()
        wv = W * W * v
        est_var = float(np.sum(wv / np.maximum(nval, 1.0)))
        if est_var <= target_var:
            break
        c = costs()
        lam = float(np.sum(np.sqrt(wv * c))) / target_var
        n_opt = np.ceil(lam * np.sqrt(wv / c)).astype(np.int64)
        gaps = n_opt - ndrawn
        if not np.any(gaps > 0):
            break
        for lv in range(L):
            if gaps[lv] > 0:
                extend(lv, int(gaps[lv]))
        rounds += 1
    m, v = stats()
    est_var = float(np.sum(W * W * v / np.maximum(nval, 1.0)))
    return {"mean": float(np.sum(W * m)),
            "mean_mlmc": float(np.sum(m)),
            "var": est_var, "se": float(np.sqrt(est_var)),
            "weights": (w, W), "n_per_level": ndrawn.copy(),
            "level_means": m, "level_vars": v, "rounds": rounds,
            "target_met": bool(est_var <= target_var),
            "n_forward": int(ndrawn.sum()),
            "wall_s": time.perf_counter() - t0}
