"""Multilevel best linear unbiased estimators (MLBLUE) —
beyond-reference tier.

Schaden & Ullmann ("On multilevel best linear unbiased estimators",
SIAM/ASA JUQ 8, 2020): given M coupled models with unknown mean vector
``m`` (model 0 = the high-fidelity target), draw independent sample
GROUPS — group k evaluates the model subset ``S_k`` on ``n_k`` SHARED
keys — and form the generalized-least-squares estimate

    m_hat = Psi^{-1} sum_k n_k R_k^T C_k^{-1} ybar_k,
    Psi   = sum_k n_k R_k^T C_k^{-1} R_k,

where ``ybar_k`` is group k's sample-mean vector, ``C_k`` the model
covariance restricted to ``S_k`` and ``R_k`` the coordinate selector.
``m_hat[0]`` is the BLUE of the high-fidelity mean: the minimum-
variance estimator among ALL linear unbiased combinations of group
means — MLMC's telescope and MFMC's control variates are particular
(generally suboptimal) points of its feasible set, and
``Var = [Psi^{-1}]_00`` is available in closed form for any
allocation, which makes sample allocation a small convex program.

Device-first design: each group is ONE dynamic-trip-count executable
(Kahan-compensated sums of every member model and their cross
products on shared keys — the within-group coupling), the pilot is
the all-models group; the tiny M x M algebra (GLS solve, allocation
descent) runs on the host. Sample identity is (group, position) ->
fold_in so repeated calls and allocation growth never redraw.

Caveats stated: ``C_k`` comes from the pilot (plug-in BLUE — Schaden-
Ullmann's setting assumes known covariances; the pilot noise enters
the weights, not the unbiasedness-in-the-limit), and allocation
optimality is on the continuous relaxation, rounded up.

The reference has no multi-model estimation at all; within this repo,
:class:`~mlmc_tpu.multifidelity.MFMC` covers the control-variate
special case and this module the general groups setting.
"""
import itertools
import time
from typing import Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["mlblue", "default_groups", "blue_variance"]


def default_groups(n_models: int):
    """Practical default group set: singletons, adjacent pairs (the
    MLMC couplings) and the full set (the pilot-style group)."""
    groups = [(i,) for i in range(n_models)]
    groups += [(i, i + 1) for i in range(n_models - 1)]
    if n_models > 2:
        groups.append(tuple(range(n_models)))
    return groups


def _psi(groups, C, n):
    M = C.shape[0]
    psi = np.zeros((M, M))
    for k, g in enumerate(groups):
        if n[k] <= 0:
            continue
        idx = np.asarray(g)
        Ck_inv = np.linalg.inv(C[np.ix_(idx, idx)])
        psi[np.ix_(idx, idx)] += n[k] * Ck_inv
    return psi


def blue_variance(groups, C, n, hifi: int = 0):
    """Model-predicted BLUE variance ``[Psi(n)^{-1}]_hifi,hifi`` for a
    given allocation (the allocation objective)."""
    psi = _psi(groups, C, np.asarray(n, float))
    e = np.zeros(C.shape[0])
    e[hifi] = 1.0
    return float(e @ np.linalg.solve(psi, e))


def _allocate(groups, C, costs, budget, hifi, n_iter=400):
    """Continuous allocation: minimize [Psi(n)^{-1}]_00 over the cost
    simplex ``sum_k n_k c_k = budget`` by exponentiated (mirror)
    gradient descent — the objective is convex in n (Schaden-Ullmann
    Thm. 3.4) and the multiplicative update stays feasible."""
    K = len(groups)
    gc = np.array([sum(costs[i] for i in g) for g in groups])
    n = np.full(K, budget / K) / gc          # equal cost share start
    M = C.shape[0]
    e = np.zeros(M)
    e[hifi] = 1.0
    best_n, best_v = n.copy(), np.inf
    for it in range(n_iter):
        psi = _psi(groups, C, n)
        try:
            v = np.linalg.solve(psi, e)
        except np.linalg.LinAlgError:
            break
        var = float(e @ v)
        if var < best_v:
            best_v, best_n = var, n.copy()
        # d var / d n_k = -(v_k)^T C_k^{-1} v_k (restricted to group k)
        grad = np.empty(K)
        for k, g in enumerate(groups):
            idx = np.asarray(g)
            vk = v[idx]
            grad[k] = -float(vk @ np.linalg.solve(
                C[np.ix_(idx, idx)], vk))
        # mirror step on the cost simplex
        step = 0.5 / (1.0 + it / 40.0)
        w = n * gc / budget
        scores = -grad * n / np.maximum(w, 1e-300)  # per unit cost
        scores = scores / max(scores.max(), 1e-300)
        w = w * np.exp(step * scores)
        w = w / w.sum()
        n = w * budget / gc
    return best_n, best_v


def mlblue(model_fns: Sequence[Callable], costs: Sequence[float],
           budget: Optional[float] = None,
           target_var: Optional[float] = None,
           groups: Optional[Sequence] = None, hifi: int = 0,
           n_pilot: int = 1 << 12, seed: int = 0,
           chunk_size: int = 1 << 12, min_group: int = 32,
           dtype=None):
    """BLUE of the high-fidelity mean from coupled model groups.

    :param model_fns: ``model(keys [C]) -> [C]`` pure jnp, one per
        model, coupled by the shared key chunk (same contract as
        :class:`~mlmc_tpu.multifidelity.MFMC`).
    :param costs: relative cost per evaluation of each model.
    :param budget: total cost to spend (exclusive with target_var).
    :param target_var: variance target — the optimal shape is scaled
        until the model-predicted variance meets it.
    :param groups: model-index subsets to sample (default
        :func:`default_groups`); every model must appear in some group.
    :param min_group: evaluate at least this many samples in every
        group with positive allocation (guards tiny rounded counts).
    :return: dict with ``mean`` (BLUE of model ``hifi``), ``var``
        (plug-in [Psi^{-1}]_00), ``means`` [M] (all model means),
        ``n_per_group``, ``groups``, ``pilot_cov``, ``mlmc_var`` /
        ``efficiency_vs_mlmc`` (same-budget telescope comparison when
        the MLMC pair groups are available), ``n_evaluations``,
        ``wall_s``.
    """
    M = len(model_fns)
    if M < 2:
        raise ValueError("need at least two models")
    if len(costs) != M:
        raise ValueError("need one cost per model")
    if (budget is None) == (target_var is None):
        raise ValueError("pass exactly one of budget / target_var")
    groups = ([tuple(sorted(g)) for g in groups] if groups is not None
              else default_groups(M))
    covered = set(itertools.chain.from_iterable(groups))
    if covered != set(range(M)):
        raise ValueError(f"groups must cover every model 0..{M - 1}; "
                         f"missing {sorted(set(range(M)) - covered)}")
    if not 0 <= hifi < M:
        raise ValueError("hifi out of range")
    costs = np.asarray(costs, float)
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    root = jax.random.key(seed)
    t0 = time.perf_counter()

    def group_program(gi, g):
        """Kahan sums of each member model and the cross-product
        matrix over shared keys — dynamic trip count AND an exact
        total-count operand (the final chunk masks its tail, so
        allocations are never rounded up to whole chunks: a 1.06-cost
        full group rounded to 1024s once blew a 200-budget run to
        ~1200 spent)."""
        gkey = jax.random.fold_in(root, 10_000 + gi)
        gl = list(g)

        @jax.jit
        def run(start, n_chunks, n_total):
            def body(c, carry):
                (s, cs), (xp, cxp) = carry
                idx = (c * jnp.uint32(chunk_size)
                       + jnp.arange(chunk_size, dtype=jnp.uint32))
                keys = jax.vmap(
                    lambda i: jax.random.fold_in(gkey, i))(idx)
                vals = jnp.stack([model_fns[i](keys).astype(dtype)
                                  for i in gl])          # [|g|, C]
                vals = jnp.where((idx < n_total)[None, :], vals, 0.0)
                x = jnp.sum(vals, axis=1)
                y = x - cs
                t = s + y
                s, cs = t, (t - s) - y
                xpc = jnp.matmul(
                    vals, vals.T,
                    precision=jax.lax.Precision.HIGHEST)
                y2 = xpc - cxp
                t2 = xp + y2
                xp, cxp = t2, (t2 - xp) - y2
                return (s, cs), (xp, cxp)

            z = jnp.zeros((len(gl),), dtype)
            zz = jnp.zeros((len(gl), len(gl)), dtype)
            (s, _), (xp, _) = jax.lax.fori_loop(
                start, start + n_chunks, body, ((z, z), (zz, zz)))
            return s, xp

        return run

    # ---- pilot: the all-models group estimates the covariance ------ #
    all_g = tuple(range(M))
    pilot_prog = group_program(len(groups) + 1, all_g)
    n_p = max(int(n_pilot), 2 * M + 2)
    n_pc = -(-n_p // chunk_size)
    s, xp = jax.device_get(pilot_prog(jnp.uint32(0), jnp.uint32(n_pc),
                                      jnp.uint32(n_p)))
    mu_p = np.asarray(s, np.float64) / n_p
    C = (np.asarray(xp, np.float64) / n_p
         - np.outer(mu_p, mu_p)) * n_p / (n_p - 1)
    # SPD guard for near-deterministic surrogates
    C = C + 1e-12 * np.trace(C) / M * np.eye(M)

    # ---- allocation -------------------------------------------------- #
    if budget is None:
        n1, v1 = _allocate(groups, C, costs, 1.0, hifi)
        scale = v1 / target_var          # var scales as 1/n
        n_opt = n1 * scale
    else:
        n_opt, _ = _allocate(groups, C, costs, float(budget), hifi)
    n_int = np.zeros(len(groups), dtype=np.int64)
    for k, nk in enumerate(n_opt):
        if nk >= 0.5:
            n_int[k] = max(int(np.ceil(nk)), min_group)
    # identifiability guard: Psi is singular unless every model sits in
    # some POSITIVE group — the optimizer may legally zero a model out
    # (e.g. a useless surrogate); bump its cheapest covering group
    for i in range(M):
        if not any(n_int[k] > 0 and i in g
                   for k, g in enumerate(groups)):
            k_min = min((k for k, g in enumerate(groups) if i in g),
                        key=lambda k: sum(costs[j] for j in groups[k]))
            n_int[k_min] = max(n_int[k_min], min_group)

    # ---- evaluate the groups ---------------------------------------- #
    ybars = []
    n_eval = n_p * M
    for k, g in enumerate(groups):
        if n_int[k] == 0:
            ybars.append(None)
            continue
        prog = group_program(k, g)
        n_chunks = -(-int(n_int[k]) // chunk_size)
        s, _ = jax.device_get(prog(jnp.uint32(0), jnp.uint32(n_chunks),
                                   jnp.uint32(n_int[k])))
        ybars.append(np.asarray(s, np.float64) / n_int[k])
        n_eval += int(n_int[k]) * len(g)

    # ---- GLS solve --------------------------------------------------- #
    psi = _psi(groups, C, n_int.astype(float))
    rhs = np.zeros(M)
    for k, g in enumerate(groups):
        if ybars[k] is None:
            continue
        idx = np.asarray(g)
        rhs[idx] += n_int[k] * np.linalg.solve(C[np.ix_(idx, idx)],
                                               ybars[k])
    m_hat = np.linalg.solve(psi, rhs)
    e = np.zeros(M)
    e[hifi] = 1.0
    var = float(e @ np.linalg.solve(psi, e))

    # same-budget MLMC comparison on the pair-telescope groups
    mlmc_var = None
    spent = float(np.sum([n_int[k] * sum(costs[i] for i in g)
                          for k, g in enumerate(groups)]))
    pair_ok = all((i, i + 1) in groups for i in range(M - 1))
    if pair_ok:
        # telescope m_0 = E[f_{M-1}] + sum (E[f_i] - E[f_{i+1}]) needs
        # variances of the pair differences and of the coarsest model
        dvar = np.array([C[i, i] + C[i + 1, i + 1] - 2 * C[i, i + 1]
                         for i in range(M - 1)]
                        + [C[M - 1, M - 1]])
        dcost = np.array([costs[i] + costs[i + 1]
                          for i in range(M - 1)] + [costs[M - 1]])
        lam = np.sum(np.sqrt(dvar * dcost))
        mlmc_var = float(lam ** 2 / max(spent, 1e-300))
    out = {"mean": float(m_hat[hifi]), "var": var, "means": m_hat,
           "n_per_group": n_int, "groups": groups, "pilot_cov": C,
           "n_evaluations": int(n_eval), "cost_spent": spent,
           "wall_s": time.perf_counter() - t0}
    if mlmc_var is not None:
        out["mlmc_var"] = mlmc_var
        out["efficiency_vs_mlmc"] = mlmc_var / max(var, 1e-300)
    return out
