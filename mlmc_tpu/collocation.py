"""Sparse-grid stochastic collocation (Smolyak) — beyond-reference tier.

The deterministic counterpart to the sampling estimators: for QoIs that
are SMOOTH in the random parameters, a Smolyak sparse quadrature
(Smolyak 1963; Novak & Ritter 1996; Gerstner & Griebel 1998) converges
spectrally in the number of model evaluations — orders of magnitude
fewer solves than MC/MLMC at moderate dimension (d <~ 20), and the
classic comparison partner for MLMC in the UQ literature (the reference
framework has no collocation capability).

    E[f(theta)]  ~  A(w, d) f = sum_{|i| <= d+w} c_i (Q_{i_1} x ... x Q_{i_d}) f

* **Rules**: probabilists' Gauss-Hermite (N(0,1) inputs, linear growth
  m(i) = i — Novak-Ritter: exact for total degree 2w+1), nested
  Clenshaw-Curtis (uniform inputs on [-1,1], doubling growth
  m(i) = 2^(i-1)+1 — node reuse across levels), Gauss-Legendre.
* **Combination technique**: only multi-indices in the Smolyak band
  ``q-d+1 <= |i| <= q`` contribute, with closed-form coefficients
  ``(-1)^(q-|i|) C(d-1, q-|i|)``.
* **Multilevel collocation** (Teckentrup-Jantsch-Webster-Gunzburger
  2015): spend high sparse-grid levels on coarse models and low levels
  on fine corrections — the MLMC telescope with collocation as the
  level estimator.

Device-first design: grid construction is host-side integer/area work
(a decision, not a computation); the device sees ONE batched evaluation
``vmap(f)`` over the deduplicated node set [N, d] followed by a
weight dot — matmul-shaped, one dispatch per chunk, vector QoIs free.
Variance comes from integrating ``(f, f^2)`` in the same pass.
"""
import itertools
import math
from typing import Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["SparseGrid", "AdaptiveSparseGrid", "multilevel_collocation"]


def _gauss_hermite_1d(n):
    """Probabilists' Gauss-Hermite: exact for N(0,1) moments < 2n.
    hermegauss weights sum to sqrt(2 pi); normalize to probability."""
    x, w = np.polynomial.hermite_e.hermegauss(n)
    return x, w / w.sum()


def _gauss_legendre_1d(n):
    """Gauss-Legendre on [-1, 1] with the UNIFORM probability weight."""
    x, w = np.polynomial.legendre.leggauss(n)
    return x, w / 2.0


def _clenshaw_curtis_1d(n):
    """Clenshaw-Curtis nodes/weights on [-1, 1], uniform probability
    weight (weights sum to 1). n = 1 gives the midpoint rule."""
    if n == 1:
        return np.zeros(1), np.ones(1)
    j = np.arange(n)
    x = np.cos(np.pi * j / (n - 1))[::-1]
    # exact CC weights by cosine-moment summation
    w = np.zeros(n)
    for k in range(n):
        s = 1.0
        for m in range(1, (n - 1) // 2 + 1):
            term = 2.0 / (1.0 - 4.0 * m * m) * np.cos(
                2.0 * m * np.pi * k / (n - 1))
            if 2 * m == n - 1:
                term *= 0.5
            s += term
        w[k] = 2.0 * s / (n - 1)
    w[0] *= 0.5
    w[-1] *= 0.5
    return x, (w / 2.0)[::-1]


_RULES = {
    "gauss-hermite": (_gauss_hermite_1d, lambda i: i),
    "gauss-legendre": (_gauss_legendre_1d, lambda i: i),
    "clenshaw-curtis": (_clenshaw_curtis_1d,
                        lambda i: 1 if i == 1 else 2 ** (i - 1) + 1),
}


class SparseGrid:
    """Smolyak sparse quadrature over d i.i.d. inputs.

    :param d: input dimension.
    :param level: Smolyak level w >= 0 (w = 0 is the single-node rule).
    :param rule: "gauss-hermite" (N(0,1) inputs), "clenshaw-curtis" or
        "gauss-legendre" (uniform on [-1, 1]).

    Attributes: ``nodes`` [N, d], ``weights`` [N] (sum to 1 within
    roundoff; individual weights may be negative — Smolyak is not a
    positive rule), ``n_nodes``, ``n_tensor`` (the full-tensor count the
    sparse construction avoided).
    """

    def __init__(self, d: int, level: int, rule: str = "gauss-hermite"):
        if rule not in _RULES:
            raise ValueError(f"unknown rule {rule!r}; "
                             f"choose from {sorted(_RULES)}")
        if d < 1 or level < 0:
            raise ValueError("need d >= 1 and level >= 0")
        self.d, self.level, self.rule = d, level, rule
        make_1d, growth = _RULES[rule]
        cache = {}

        def rule_1d(i):
            if i not in cache:
                cache[i] = make_1d(growth(i))
            return cache[i]

        q = d + level
        acc = {}
        # Smolyak band: q-d+1 <= |i| <= q, i_k >= 1
        for excess in range(min(level, q - d) + 1):
            s = q - excess                       # |i|
            coeff = (-1.0) ** excess * math.comb(d - 1, excess)
            for comp in _compositions(s, d):
                xs, ws = zip(*(rule_1d(i) for i in comp))
                for idx in itertools.product(*(range(len(x))
                                               for x in xs)):
                    node = tuple(round(float(xs[k][idx[k]]), 14)
                                 for k in range(d))
                    wgt = coeff
                    for k in range(d):
                        wgt *= ws[k][idx[k]]
                    acc[node] = acc.get(node, 0.0) + wgt
        nodes = np.array(sorted(acc), dtype=np.float64)
        self.nodes = nodes.reshape(len(acc), d)
        self.weights = np.array([acc[tuple(n)] for n in
                                 self.nodes.tolist()])
        self.n_nodes = len(self.weights)
        self.n_tensor = growth(level + 1) ** d

    def integrate(self, fn: Callable, chunk_size: int = 1 << 14,
                  dtype=None):
        """``E[fn(theta)]`` — one vmapped device evaluation over the
        node batch, weight-reduced on device. fn: [d] -> scalar or [q].
        Returns a numpy scalar/vector."""
        dtype = dtype or jnp.asarray(1.0).dtype
        nodes = jnp.asarray(self.nodes, dtype)
        w = jnp.asarray(self.weights, dtype)
        batch = jax.jit(lambda x, ww: jnp.tensordot(
            ww, jax.vmap(fn)(x), axes=1))
        total = None
        for s in range(0, self.n_nodes, chunk_size):
            part = batch(nodes[s:s + chunk_size],
                         w[s:s + chunk_size])
            total = part if total is None else total + part
        return np.asarray(jax.device_get(total))

    def mean_and_var(self, fn: Callable, **kw):
        """(E[f], Var[f]) through one pass integrating (f, f^2).
        Var can come out slightly negative for an under-resolved grid
        (Smolyak weights are signed) — clipped at 0."""
        def f2(theta):
            v = jnp.atleast_1d(fn(theta))
            return jnp.concatenate([v, v * v])
        both = self.integrate(f2, **kw)
        q = both.shape[0] // 2
        mean, second = both[:q], both[q:]
        return mean, np.maximum(second - mean ** 2, 0.0)


class AdaptiveSparseGrid:
    """Dimension-adaptive sparse quadrature (Gerstner & Griebel,
    "Dimension-adaptive tensor-product quadrature", Computing 71, 2003).

    The fixed Smolyak band treats every input dimension equally; real
    UQ problems (KL/RFF field coefficients, decaying mode variances)
    are strongly ANISOTROPIC — most of the refinement budget belongs to
    the first few dimensions. This estimator discovers that structure
    on the fly: it grows a downward-closed multi-index set greedily by
    the hierarchical-surplus error indicator,

        Delta_i f = (x)_k (Q_{i_k} - Q_{i_k - 1}) f
                  = sum_{z subset supp(i > 1)} (-1)^{|z|} Q_{i - z} f,

    accepting the active index with the largest |surplus| and opening
    its admissible forward neighbors, until the summed indicator of the
    active frontier drops below ``tol`` or the evaluation budget runs
    out. The running estimate is the sum of ALL computed surpluses
    (old + active), exactly the combination-technique value of the
    final index set.

    Device-first mapping (same stance as :class:`SparseGrid`): the index
    bookkeeping is host-side integer work — a decision, not a
    computation; model evaluations happen in deduplicated batched
    ``vmap(fn)`` dispatches, padded to power-of-two buckets so the whole
    adaptive run reuses a handful of compiled executables (each distinct
    jit shape is a compile). Node
    values are cached across tensor products, so nested rules
    (clenshaw-curtis) and the shared low-order Gauss rules never pay
    for a point twice.

    No reference analogue: GeoMop/MLMC has no collocation capability at
    all, let alone an adaptive one.
    """

    def __init__(self, d: int, rule: str = "gauss-hermite"):
        if rule not in _RULES:
            raise ValueError(f"unknown rule {rule!r}; "
                             f"choose from {sorted(_RULES)}")
        if d < 1:
            raise ValueError("need d >= 1")
        self.d, self.rule = d, rule
        self._make_1d, self._growth = _RULES[rule]
        self._rule_cache = {}

    def _rule_1d(self, i):
        if i not in self._rule_cache:
            self._rule_cache[i] = self._make_1d(self._growth(i))
        return self._rule_cache[i]

    def integrate(self, fn: Callable, tol: float = 1e-8,
                  max_evals: int = 1 << 14, chunk_size: int = 1 << 11,
                  indicator: str = "surplus", min_level: int = 1,
                  dtype=None):
        """Adaptively integrate ``E[fn(theta)]``, theta ~ rule measure.

        :param fn: pure jnp ``[d] -> scalar or [q]`` (vector QoIs share
            the node set; the indicator is the max-abs component).
        :param tol: stop when the summed active-frontier indicator
            drops below this (an estimate of the remaining error).
        :param max_evals: hard budget of model evaluations.
        :param indicator: "surplus" (Gerstner-Griebel g_i = |Delta_i|)
            or "surplus_per_eval" (cost-aware: |Delta_i| divided by the
            new evaluations the index cost — favors cheap directions).
        :param min_level: seed the index set with the full isotropic
            Smolyak band ``|i| <= d + min_level`` before going greedy.
            The greedy indicator inherits Gerstner-Griebel's known blind
            spot: an index whose OWN surplus is exactly zero (symmetric
            integrands against the 1-node root rule annihilate mixed
            terms, e.g. ``E[x0^2 x1^2]``) is never accepted, hiding its
            nonzero descendants. ``min_level=2`` forces every pairwise
            mixed index to be probed once, which resolves the classical
            quadratic-coupling case at O(d^2) extra cheap evaluations.
        :return: dict with ``mean`` (np scalar/[q]), ``error_est``
            (summed active indicator), ``n_evals``, ``indices``
            (downward-closed, sorted), ``converged``, ``history``
            (accepted index, its indicator, cumulative evals).
        """
        if indicator not in ("surplus", "surplus_per_eval"):
            raise ValueError("indicator must be 'surplus' or "
                             "'surplus_per_eval'")
        d = self.d
        dtype = dtype or jnp.asarray(1.0).dtype
        node_vals = {}                     # node tuple -> np [q] value
        tensor_vals = {}                   # comp tuple -> np [q] value
        evaluator = _BucketedEval(fn, d, chunk_size, dtype)
        state = {"n_evals": 0}

        def tensor_nodes(comp):
            """Tensor-grid nodes/weights of Q_comp as python lists."""
            xs, ws = zip(*(self._rule_1d(i) for i in comp))
            nodes, wgts = [], []
            for idx in itertools.product(*(range(len(x)) for x in xs)):
                node = tuple(round(float(xs[k][idx[k]]), 14)
                             for k in range(d))
                w = 1.0
                for k in range(d):
                    w *= ws[k][idx[k]]
                nodes.append(node)
                wgts.append(w)
            return nodes, wgts

        def tensor_value(comp):
            """Q_comp f, filling the node cache in one batched call."""
            if comp in tensor_vals:
                return tensor_vals[comp]
            nodes, wgts = tensor_nodes(comp)
            missing = [n for n in nodes if n not in node_vals]
            if missing:
                vals = evaluator(np.array(missing, np.float64))
                state["n_evals"] += len(missing)
                for n, v in zip(missing, vals):
                    node_vals[n] = v
            out = sum(w * node_vals[n] for n, w in zip(nodes, wgts))
            tensor_vals[comp] = out
            return out

        def surplus(index):
            """Delta_index f by the difference combination, and the
            evaluations it newly spent."""
            before = state["n_evals"]
            big = [k for k in range(d) if index[k] > 1]
            total = None
            for r in range(len(big) + 1):
                for sub in itertools.combinations(big, r):
                    comp = tuple(index[k] - (1 if k in sub else 0)
                                 for k in range(d))
                    term = ((-1.0) ** r) * tensor_value(comp)
                    total = term if total is None else total + term
            return total, state["n_evals"] - before

        if min_level < 1:
            raise ValueError("min_level must be >= 1")
        est = None
        active, old = {}, set()
        history = []
        converged = False
        # isotropic seed band |i| <= d + min_level: interior accepted,
        # the |i| = d + min_level shell forms the initial frontier
        for s in range(d, d + min_level + 1):
            for comp in _compositions(s, d):
                delta, cost = surplus(comp)
                dlt = np.asarray(delta, np.float64)
                est = dlt if est is None else est + dlt
                g = (float(np.max(np.abs(dlt))), max(cost, 1))
                if s < d + min_level:
                    old.add(comp)
                    history.append((comp, g[0], state["n_evals"]))
                else:
                    active[comp] = g
        while active:
            def score(item):
                g, c = item[1]
                return g / c if indicator == "surplus_per_eval" else g
            err = sum(g for g, _ in active.values())
            # never trust the indicator before the root is expanded: a
            # symmetric integrand gives the 1-node root a ZERO surplus
            # while its neighbors are not (f(0) vs E[f])
            if err <= tol and old:
                converged = True
                break
            if state["n_evals"] >= max_evals:
                break
            best = max(active.items(), key=score)
            idx = best[0]
            old.add(idx)
            history.append((idx, best[1][0], state["n_evals"]))
            del active[idx]
            for k in range(d):
                fwd = tuple(idx[j] + (j == k) for j in range(d))
                admissible = all(
                    fwd[j] == 1
                    or tuple(fwd[m] - (m == j) for m in range(d)) in old
                    for j in range(d))
                if admissible and fwd not in active:
                    dlt, cst = surplus(fwd)
                    est = est + np.asarray(dlt, np.float64)
                    active[fwd] = (float(np.max(np.abs(dlt))),
                                   max(cst, 1))
        err = sum(g for g, _ in active.values())
        indices = sorted(old | set(active))
        mean = est if est.shape[0] > 1 else float(est[0])
        return {"mean": mean, "error_est": float(err),
                "n_evals": state["n_evals"],
                "n_indices": len(indices), "indices": indices,
                "converged": converged or err <= tol,
                "history": history}


class _BucketedEval:
    """Batched ``vmap(fn)`` over [N, d] node arrays, padded to
    power-of-two buckets capped at ``chunk_size`` so one adaptive run
    compiles O(log) executables instead of one per ragged batch."""

    def __init__(self, fn, d, chunk_size, dtype):
        self.d, self.chunk, self.dtype = d, int(chunk_size), dtype
        self._jit = jax.jit(jax.vmap(
            lambda x: jnp.atleast_1d(fn(x))))

    def __call__(self, nodes):
        n = len(nodes)
        out = []
        s = 0
        while s < n:
            take = min(self.chunk, n - s)
            pad = 1 << max(0, (take - 1).bit_length())
            block = np.zeros((pad, self.d), np.float64)
            block[:take] = nodes[s:s + take]
            vals = np.asarray(jax.device_get(
                self._jit(jnp.asarray(block, self.dtype))),
                np.float64)
            out.append(vals[:take])
            s += take
        return np.concatenate(out, axis=0)


def _compositions(total, parts):
    """All tuples of `parts` positive ints summing to `total`."""
    if parts == 1:
        yield (total,)
        return
    for first in range(1, total - parts + 2):
        for rest in _compositions(total - first, parts - 1):
            yield (first,) + rest


def multilevel_collocation(fns: Sequence[Callable], d: int,
                           levels: Optional[Sequence[int]] = None,
                           rule: str = "gauss-hermite",
                           chunk_size: int = 1 << 14):
    """Multilevel stochastic collocation: sparse-grid level w_l on the
    MLMC correction ``f_l - f_{l-1}`` (Teckentrup et al. 2015) — the
    smoother and smaller the correction, the cruder its grid.

    :param fns: per-discretization-level ``theta [d] -> scalar/[q]``,
        coarsest first, all over the SAME parametrization (the coupling
        is by shared collocation nodes — exact, no statistical error).
    :param levels: sparse-grid level per MLMC level, defaults to
        ``[L-1+base, ..., base]`` decreasing to base=1.
    :return: dict with ``mean``, per-level ``corrections``, ``n_nodes``
        per level, ``n_nodes_total`` and the single-level equivalent
        count ``n_nodes_single`` (finest model at the richest grid).
    """
    L = len(fns)
    if levels is None:
        levels = [L - lvl for lvl in range(L)]
    if len(levels) != L:
        raise ValueError("need one sparse-grid level per model level")
    corrections, n_nodes = [], []
    grids = {}                      # grid construction is host-side and
    for w in set(levels):           # slow on 1 core: build each w once
        grids[w] = SparseGrid(d, w, rule=rule)
    for lvl, (fn, w) in enumerate(zip(fns, levels)):
        grid = grids[w]
        if lvl == 0:
            contrib = grid.integrate(
                lambda th: jnp.atleast_1d(fn(th)), chunk_size=chunk_size)
        else:
            prev = fns[lvl - 1]
            contrib = grid.integrate(
                lambda th: jnp.atleast_1d(fn(th))
                - jnp.atleast_1d(prev(th)), chunk_size=chunk_size)
        corrections.append(contrib)
        n_nodes.append(grid.n_nodes)
    return {"mean": sum(corrections), "corrections": corrections,
            "n_nodes": n_nodes, "n_nodes_total": int(np.sum(n_nodes)),
            "n_nodes_single": grids[max(levels)].n_nodes,
            "levels": list(levels)}
