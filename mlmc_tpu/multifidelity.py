"""Multifidelity Monte Carlo (MFMC) — beyond-reference tier.

MLMC's control variates are the SAME model at coarser discretizations.
MFMC (Peherstorfer, Willcox & Gunzburger, "Optimal model management for
multifidelity Monte Carlo estimation", SIAM J. Sci. Comput. 38(5), 2016)
generalizes the variance reduction to ARBITRARY surrogate models —
reduced-order models, response surfaces, simplified physics — that need
share nothing with the high-fidelity model except correlation:

    ``s = ybar_0(m_0) + sum_k alpha_k (ybar_k(m_k) - ybar_k(m_{k-1}))``

with all models evaluated on nested prefixes of ONE common input stream
(``m_0 <= m_1 <= ... <= m_K``). The estimator is unbiased for
``E[f_0]`` for ANY coefficients and ANY surrogate bias — surrogate means
cancel between the two prefix averages — and with

    ``alpha_k = rho_k sigma_0 / sigma_k``  (regression coefficients)
    ``r_k = m_k/m_0 = sqrt(w_0 (rho_k^2 - rho_{k+1}^2)
                           / (w_k (1 - rho_1^2)))``

the variance for a cost budget ``p = sum_k w_k m_k`` is provably optimal
over allocations AND over model subsets (ibid. Thm. 3.4), reducing MC
variance by ~ ``(1 - rho_1^2)``-type factors when cheap well-correlated
surrogates exist.

Device-first design:

* the pilot evaluates ALL models on one shared key chunk inside a single
  jitted chunk loop and reduces the full ``[K+1, K+1]`` cross-moment
  matrix on device (one ``V V^T`` per chunk, one flat fetch total) —
  correlations, variances and the allocation follow on the host at
  ``O(K^2)``,
* the main stage gives each model ONE compiled interval executable
  ``(start, stop) -> (sum, sum^2)`` with a dynamic trip count and an
  in-kernel validity mask (the economics of
  :class:`~mlmc_tpu.unbiased.UnbiasedMLMC`); the two prefix averages of
  model k are two disjoint interval calls on the same stream, so
  nothing is recomputed and only scalars cross the link,
* model subset selection enumerates the ``2^K`` admissible subsets on
  the host (K is small) with the closed-form variance, exactly the
  reference treatment of its allocation problem (reference
  mlmc/estimator.py n-sample optimization) lifted to model space.

Contract: ``model(keys [C]) -> values [C]`` pure jnp; the SAME keys must
map to the same underlying random input omega in every model (shared
stream = the coupling). Model 0 is the high-fidelity target.
"""
import time
from typing import Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["MFMC", "synth_fidelity_models"]


class MFMC:
    """Multifidelity Monte Carlo estimator with optimal model selection.

    :param models: ``[f_0, f_1, ..., f_K]`` pure jnp batch callables
        (``f(keys [C]) -> [C]``); f_0 is the high-fidelity model
    :param costs: per-evaluation relative costs ``[w_0, ..., w_K]``;
        measured pilot wall time per sample is used if omitted
    :param seed: PRNG root; pilot and main stages use disjoint stream
        ranges of one key sequence
    :param chunk_size: samples per device loop step
    """

    def __init__(self, models: Sequence[Callable],
                 costs: Optional[Sequence[float]] = None, seed: int = 0,
                 chunk_size: int = 1 << 12, dtype=None):
        self._models = list(models)
        if len(self._models) < 2:
            raise ValueError("need the high-fidelity model plus at least "
                             "one surrogate")
        self.K = len(self._models) - 1
        if costs is not None:
            costs = np.asarray(costs, dtype=float)
            if costs.shape != (self.K + 1,) or np.any(costs <= 0):
                raise ValueError("costs must be %d positive numbers"
                                 % (self.K + 1))
        self._given_costs = costs
        self._chunk = int(chunk_size)
        self._dtype = jnp.dtype(dtype or jnp.result_type(float))
        self._root = jax.random.key(seed)
        self._pilot_stats = None
        self._pilot_n = 0
        self._interval_programs = {}
        self._pilot_program = None

    # -------------------------------------------------------------- #
    # pilot: joint moments of all models on a shared stream
    # -------------------------------------------------------------- #
    def reseed(self, seed: int):
        """Fresh input stream (clears pilot statistics); compiled pilot
        and interval programs are reused — the PRNG root is an operand,
        so repeated studies (e.g. variance validation) pay no re-jit."""
        self._root = jax.random.key(seed)
        self._pilot_stats = None
        self._pilot_n = 0

    def _build_pilot(self):
        if self._pilot_program is not None:
            return self._pilot_program
        models = self._models
        chunk = self._chunk
        dtype = self._dtype
        Kp1 = self.K + 1

        @jax.jit
        def run(root, n_chunks):
            def body(c, carry):
                # Kahan-compensated cross-chunk accumulation
                s, cs, xx, cxx = carry
                idx = c * jnp.uint32(chunk) + jnp.arange(chunk,
                                                         dtype=jnp.uint32)
                keys = jax.vmap(lambda i: jax.random.fold_in(root, i))(idx)
                v = jnp.stack([m(keys).astype(dtype) for m in models])

                def kadd(acc, comp, x):
                    y = x - comp
                    t = acc + y
                    return t, (t - acc) - y

                s, cs = kadd(s, cs, jnp.sum(v, 1))
                xx, cxx = kadd(xx, cxx, jnp.matmul(
                    v, v.T, precision=jax.lax.Precision.HIGHEST))
                return (s, cs, xx, cxx)

            zv = jnp.zeros((Kp1,), dtype)
            zm = jnp.zeros((Kp1, Kp1), dtype)
            s, cs, xx, cxx = jax.lax.fori_loop(
                jnp.uint32(0), n_chunks, body, (zv, zv, zm, zm))
            # one flat fetch
            return jnp.concatenate([s - cs, (xx - cxx).reshape(-1)])

        self._pilot_program = run
        return run

    def pilot(self, n_pilot: int = 4096):
        """Estimate model variances, correlations with f_0, and (if not
        given) per-sample costs from ``n_pilot`` shared-input
        evaluations of every model.

        Pilot draws occupy stream positions [0, n_pilot); the main stage
        continues AFTER them, so pilot noise never correlates with the
        estimator's samples.

        :return: dict(sigma, rho, costs, n_pilot, mean)
        """
        n_chunks = max(-(-int(n_pilot) // self._chunk), 2)
        run = self._build_pilot()
        t0 = time.perf_counter()
        flat = np.asarray(run(self._root, jnp.uint32(n_chunks)))
        elapsed = time.perf_counter() - t0
        n = n_chunks * self._chunk
        Kp1 = self.K + 1
        if not np.all(np.isfinite(flat)):
            raise FloatingPointError("pilot produced non-finite moments")
        s = flat[:Kp1]
        xx = flat[Kp1:].reshape(Kp1, Kp1)
        mean = s / n
        cov = xx / n - np.outer(mean, mean)
        cov *= n / (n - 1)
        sigma = np.sqrt(np.maximum(np.diag(cov), 1e-300))
        rho = cov[0] / (sigma[0] * sigma)
        rho[0] = 1.0
        if self._given_costs is not None:
            costs = self._given_costs.astype(float)
        else:
            # one shared-timing pilot cannot split per-model costs;
            # spread the measured wall equally unless told otherwise
            costs = np.full(Kp1, elapsed / (n * Kp1))
        self._pilot_stats = dict(sigma=sigma, rho=rho, costs=costs,
                                 n_pilot=n, mean=mean)
        self._pilot_n = n
        return dict(self._pilot_stats)

    # -------------------------------------------------------------- #
    # allocation and model selection (host, closed forms)
    # -------------------------------------------------------------- #
    @staticmethod
    def _subset_variance(sigma, rho, costs, budget, subset):
        """Closed-form optimal variance of the MFMC estimator restricted
        to model subset (always containing 0), or None if the subset
        violates the admissibility ordering (ibid. Lemma 3.3)."""
        idx = list(subset)
        r2 = rho[idx] ** 2                     # rho_0 = 1 by construction
        w = costs[idx]
        if np.any(np.diff(r2) >= 0):           # need strictly decreasing
            return None, None
        denom = 1.0 - r2[1] if len(idx) > 1 else 1.0
        if denom <= 0 or not np.isfinite(denom):
            return None, None
        r2_next = np.append(r2[1:], 0.0)
        r = np.sqrt(w[0] * (r2 - r2_next) / (w * denom))   # r_0 = 1 exactly
        if np.any(np.diff(r) <= 0):            # cost-ratio admissibility
            return None, None
        m0 = budget / float(np.dot(w, r))
        m = m0 * r
        # Var = sigma0^2/m0 - sum_k (1/m_{k-1} - 1/m_k) rho_k^2 sigma0^2
        var = sigma[0] ** 2 / m0
        for k in range(1, len(idx)):
            var -= (1.0 / m[k - 1] - 1.0 / m[k]) * r2[k] * sigma[0] ** 2
        return float(var), m

    def select_models(self, budget: float = 1.0):
        """Enumerate admissible model subsets (K is small) and return
        the variance-optimal one for the given budget, with its
        allocation and the corresponding plain-MC variance.

        :return: dict(subset, m, var, var_mc, alpha)
        """
        st = self._require_pilot()
        sigma, rho, costs = st["sigma"], st["rho"], st["costs"]
        best = None
        from itertools import combinations
        surr = range(1, self.K + 1)
        for size in range(0, self.K + 1):
            for combo in combinations(surr, size):
                subset = (0,) + combo
                var, m = self._subset_variance(sigma, rho, costs,
                                               float(budget), subset)
                if var is None:
                    continue
                if best is None or var < best[0]:
                    best = (var, subset, m)
        if best is None:
            raise RuntimeError("no admissible model subset (pilot "
                               "correlations degenerate?)")
        var, subset, m = best
        idx = list(subset)
        alpha = rho[idx] * sigma[0] / np.maximum(sigma[idx], 1e-300)
        var_mc = sigma[0] ** 2 * costs[0] / float(budget)
        return dict(subset=subset, m=m, var=var, var_mc=var_mc,
                    alpha=alpha)

    def _require_pilot(self):
        if self._pilot_stats is None:
            raise ValueError("run pilot() first")
        return self._pilot_stats

    # -------------------------------------------------------------- #
    # main stage
    # -------------------------------------------------------------- #
    def _interval(self, model_idx):
        run = self._interval_programs.get(model_idx)
        if run is not None:
            return run
        fn = self._models[model_idx]
        chunk = self._chunk
        dtype = self._dtype

        @jax.jit
        def run(root, start, stop):
            def body(c, carry):
                s, cs, s2, cs2 = carry
                idx = c * jnp.uint32(chunk) + jnp.arange(chunk,
                                                         dtype=jnp.uint32)
                keys = jax.vmap(lambda i: jax.random.fold_in(root, i))(idx)
                d = fn(keys).astype(dtype)
                d = jnp.where((idx >= start) & (idx < stop), d, 0)

                def kadd(acc, comp, x):
                    y = x - comp
                    t = acc + y
                    return t, (t - acc) - y

                s, cs = kadd(s, cs, jnp.sum(d))
                s2, cs2 = kadd(s2, cs2, jnp.sum(d * d))
                return (s, cs, s2, cs2)

            z = jnp.zeros((), dtype)
            s, cs, s2, cs2 = jax.lax.fori_loop(
                start // jnp.uint32(chunk),
                (stop + jnp.uint32(chunk - 1)) // jnp.uint32(chunk),
                body, (z, z, z, z))
            return s - cs, s2 - cs2

        self._interval_programs[model_idx] = run
        return run

    def _interval_mean(self, model_idx, start, stop):
        if stop <= start:
            return 0.0, 0.0, 0
        run = self._interval(model_idx)
        s, s2 = run(self._root, jnp.uint32(start), jnp.uint32(stop))
        s, s2 = float(s), float(s2)
        if not (np.isfinite(s) and np.isfinite(s2)):
            raise FloatingPointError("model %d produced non-finite values"
                                     % model_idx)
        n = int(stop - start)
        return s / n, s2 / n, n

    def estimate(self, budget: float, n_pilot: int = 4096):
        """Full MFMC pipeline: pilot -> model selection -> optimal
        allocation -> prefix-coupled estimate.

        ``budget`` is in cost units (``sum_k w_k m_k``); the pilot cost
        is NOT deducted (report it separately if needed). Main-stage
        samples start at stream position ``n_pilot`` so pilot noise is
        independent of the estimate.

        :return: dict(mean, var, m, subset, alpha, var_mc, speedup)
        """
        if self._pilot_stats is None:
            self.pilot(n_pilot)
        sel = self.select_models(budget)
        subset, alpha = sel["subset"], sel["alpha"]
        m = np.maximum(np.ceil(sel["m"]).astype(np.int64), 2)
        base = self._pilot_n
        # high-fidelity prefix
        mean0, _, _ = self._interval_mean(subset[0], base, base + int(m[0]))
        total = mean0
        for k in range(1, len(subset)):
            mu_full, _, _ = self._interval_mean(subset[k], base,
                                                base + int(m[k]))
            mu_prev, _, _ = self._interval_mean(subset[k], base,
                                                base + int(m[k - 1]))
            total += float(alpha[k]) * (mu_full - mu_prev)
        return dict(mean=float(total), var=sel["var"], m=m,
                    subset=subset, alpha=alpha, var_mc=sel["var_mc"],
                    speedup=sel["var_mc"] / max(sel["var"], 1e-300))


# ---------------------------------------------------------------------- #
# synthetic fixture
# ---------------------------------------------------------------------- #
def synth_fidelity_models(mean=1.0, sigma0=1.0, rhos=(0.95, 0.8),
                          biases=(0.3, -0.5)):
    """Model family with EXACT correlations for validation: with (Z, U_k)
    independent standard normals shared per key,

        ``f_0 = mean + sigma0 Z``
        ``f_k = bias_k + rho_k Z + sqrt(1 - rho_k^2) U_k``

    so ``corr(f_0, f_k) = rho_k`` and ``Var f_k = 1`` exactly, and the
    surrogate biases must NOT leak into the estimate (MFMC unbiasedness).

    :return: list of model callables for :class:`MFMC`
    """
    rhos = [float(r) for r in rhos]
    biases = [float(b) for b in biases]
    if len(biases) != len(rhos):
        raise ValueError("need one bias per surrogate")

    def hi(keys):
        def one(k):
            z = jax.random.normal(jax.random.fold_in(k, 0))
            return mean + sigma0 * z

        return jax.vmap(one)(keys)

    models = [hi]
    for j, (r, b) in enumerate(zip(rhos, biases)):
        def surrogate(keys, r=r, b=b, j=j):
            def one(k):
                z = jax.random.normal(jax.random.fold_in(k, 0))
                u = jax.random.normal(jax.random.fold_in(k, j + 1))
                return b + r * z + np.sqrt(1.0 - r * r) * u

            return jax.vmap(one)(keys)

        models.append(surrogate)
    return models
