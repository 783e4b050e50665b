"""Multi-index Monte Carlo (MIMC) — beyond-reference tier.

The reference framework telescopes over ONE discretization parameter
(reference mlmc/sampler.py level hierarchy). MIMC (Haji-Ali, Nobile &
Tempone, "Multi-index Monte Carlo: when sparsity meets sampling", Numer.
Math. 132, 2016) generalizes the level scalar to a multi-index
``alpha in N^d`` over independent discretization axes (spatial x/y
resolution, time step, ...) and telescopes with FIRST-ORDER MIXED
DIFFERENCES:

    E[f_inf] ~ sum_{alpha in I} E[ Delta f(alpha) ],
    Delta = tensor_i Delta_i,   Delta_i f(alpha) = f(alpha) - f(alpha-e_i)

For problems whose error expands in a PRODUCT of per-axis terms, the
mixed-difference means/variances decay at product rates and a
total-degree index set recovers the optimal O(eps^-2) complexity where
single-axis MLMC (refining all axes together) degrades — sparse grids'
economics applied to sampling.

Device-first design (mirrors MLQMC's streaming economics):

* one compiled program per index evaluates ALL active corners of the
  mixed difference on a shared key chunk (same keys => same random
  inputs omega — the coupling), reduces to (sum, sum^2) on device, and
  loops chunks with a DYNAMIC trip count, so one executable per index
  serves the whole adaptive run and only two scalars cross the
  host<->device link per extension,
* per-index sample streams are independent (`fold_in(root, index_id)`),
  extensions continue them (start-index arithmetic), so no work is
  repeated across adaptive rounds,
* the sample allocation is the CLT-optimal ``n_alpha ~ sqrt(V/C)`` rule
  — the same formula as the MLMC estimator (reference
  mlmc/estimator.py:366-385), summed over the index set.

Contract: ``value_fn(alpha: tuple[int], keys [C]) -> values [C]`` pure
jnp; the SAME keys must map to the same underlying random realization at
every alpha (resolution-independent parametrizations — RFF phases,
Brownian increments by bisection — make this natural).
"""
import itertools
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["MIMC", "total_degree_set", "full_tensor_set",
           "mixed_difference_terms", "synth_mimc_value_fn",
           "heat_mimc_value_fn", "darcy_mimc_value_fn"]


# ---------------------------------------------------------------------- #
# index sets and the mixed-difference expansion
# ---------------------------------------------------------------------- #
def total_degree_set(d, level, weights=None):
    """Anisotropic total-degree index set
    ``{alpha : sum_i weights_i alpha_i <= level}`` (weights default 1 —
    the standard simplex). Returned sorted, lexicographic."""
    w = np.ones(d) if weights is None else np.asarray(weights, dtype=float)
    if w.shape != (d,) or np.any(w <= 0):
        raise ValueError("weights must be %d positive numbers" % d)
    out = []
    maxes = [int(level / w[i]) for i in range(d)]
    for alpha in itertools.product(*(range(m + 1) for m in maxes)):
        if float(np.dot(w, alpha)) <= level + 1e-12:
            out.append(tuple(alpha))
    return sorted(out)


def full_tensor_set(maxes):
    """Full tensor-product index set ``prod_i {0..maxes_i}``."""
    return sorted(itertools.product(*(range(int(m) + 1) for m in maxes)))


def mixed_difference_terms(alpha):
    """Corners and signs of the first-order mixed difference at ``alpha``:
    ``Delta f(alpha) = sum (sign_j * f(corner_j))`` where the difference
    is taken only along axes with ``alpha_i > 0`` (at the boundary
    ``Delta_i f = f``). Returns a list of (corner tuple, +-1)."""
    active = [i for i, a in enumerate(alpha) if a > 0]
    terms = []
    for bits in itertools.product((0, 1), repeat=len(active)):
        corner = list(alpha)
        for i, b in zip(active, bits):
            corner[i] -= b
        terms.append((tuple(corner), -1 if sum(bits) % 2 else 1))
    return terms


# ---------------------------------------------------------------------- #
class _IndexState:
    def __init__(self):
        self.n = 0
        self.sum = 0.0
        self.sum_sq = 0.0
        self.elapsed = 0.0


class MIMC:
    """Adaptive multi-index Monte Carlo over a static index set.

    :param value_fn: ``f(alpha, keys [C]) -> [C]`` pure jnp; same keys
        must reproduce the same random realization at every alpha
    :param index_set: iterable of d-tuples (see :func:`total_degree_set`)
    :param seed: PRNG root; index streams are ``fold_in(root, index_id)``
    :param cost_fn: optional ``alpha -> relative cost`` for the
        allocation rule; measured wall time per sample is used if omitted
    :param chunk_size: samples per device loop step
    :param mesh: optional :class:`~mlmc_tpu.parallel.mesh.SampleMesh` —
        each chunk's samples shard across the mesh (chunk_size must
        divide by the device count) with a psum of the two accumulator
        scalars; the sample-index -> key mapping is IDENTICAL for any
        device count, so estimates are bit-reproducible across pod sizes
    """

    def __init__(self, value_fn: Callable, index_set: Sequence[Tuple[int, ...]],
                 seed: int = 0, cost_fn: Optional[Callable] = None,
                 chunk_size: int = 1 << 13, dtype=None, mesh=None):
        self._fn = value_fn
        self._set = [tuple(int(a) for a in alpha) for alpha in index_set]
        if not self._set:
            raise ValueError("index_set is empty")
        d = len(self._set[0])
        if any(len(a) != d or min(a) < 0 for a in self._set):
            raise ValueError("index_set entries must be equal-length "
                             "non-negative tuples")
        if len(set(self._set)) != len(self._set):
            raise ValueError("index_set has duplicates")
        # downward closedness: every Delta corner must be representable
        need = {c for a in self._set for c, _ in mixed_difference_terms(a)}
        missing = need - set(self._set)
        if missing:
            raise ValueError(
                "index_set is not downward closed (telescoping would be "
                "biased); missing %s" % sorted(missing)[:4])
        self.d = d
        self._chunk = int(chunk_size)
        self._mesh = mesh
        if mesh is not None and self._chunk % mesh.n_devices:
            raise ValueError(
                "chunk_size=%d must divide by the mesh's %d devices"
                % (self._chunk, mesh.n_devices))
        self._dtype = jnp.dtype(dtype or jnp.result_type(float))
        self._root = jax.random.key(seed)
        self._states = {a: _IndexState() for a in self._set}
        self._cost_fn = cost_fn
        self._eval_cache = {}

    # -------------------------------------------------------------- #
    @property
    def index_set(self):
        return list(self._set)

    @property
    def n_samples(self):
        return np.array([self._states[a].n for a in self._set])

    def _program(self, alpha):
        """Compiled extension: ``(start, n_chunks) -> (sum, sum2)`` with a
        dynamic trip count — one executable per index for the whole run."""
        cached = self._eval_cache.get(alpha)
        if cached is not None:
            return cached
        terms = mixed_difference_terms(alpha)
        chunk = self._chunk
        dtype = self._dtype
        fn = self._fn
        mesh = self._mesh
        sub = chunk if mesh is None else chunk // mesh.n_devices
        idx_key = jax.random.fold_in(self._root, self._set.index(alpha))

        def body(c, carry, offset):
            # Kahan-compensated cross-chunk accumulation: at millions of
            # samples in f32 the naive running sum loses ~3e-5 relative
            # (ulp of the accumulator), comparable to the target se
            s, cs, s2, cs2 = carry
            base = jax.vmap(lambda i: jax.random.fold_in(idx_key, i))(
                c * chunk + offset + jnp.arange(sub, dtype=jnp.uint32))
            delta = jnp.zeros((sub,), dtype)
            for corner, sign in terms:
                delta = delta + sign * fn(corner, base).astype(dtype)

            def kadd(acc, comp, x):
                y = x - comp
                t = acc + y
                return t, (t - acc) - y

            s, cs = kadd(s, cs, jnp.sum(delta))
            s2, cs2 = kadd(s2, cs2, jnp.sum(delta * delta))
            return (s, cs, s2, cs2)

        if mesh is None:
            @jax.jit
            def run(start, n_chunks):
                z = jnp.zeros((), dtype)
                s, cs, s2, cs2 = jax.lax.fori_loop(
                    start, start + n_chunks,
                    lambda c, carry: body(c, carry, jnp.uint32(0)),
                    (z, z, z, z))
                return s - cs, s2 - cs2
        else:
            from jax.sharding import PartitionSpec as P
            try:
                from jax import shard_map
            except ImportError:           # older jax
                from jax.experimental.shard_map import shard_map
            axis = mesh.axis_name

            def mark(z):
                # the fori_loop carry becomes device-varying after the
                # first chunk; mark the zero initializer accordingly
                if hasattr(jax.lax, "pcast"):
                    return jax.lax.pcast(z, (axis,), to="varying")
                return jax.lax.pvary(z, (axis,))

            def sharded(start, n_chunks):
                offset = (jax.lax.axis_index(axis).astype(jnp.uint32)
                          * jnp.uint32(sub))
                z = mark(jnp.zeros((), dtype))
                s, cs, s2, cs2 = jax.lax.fori_loop(
                    start, start + n_chunks,
                    lambda c, carry: body(c, carry, offset), (z, z, z, z))
                return (jax.lax.psum(s - cs, axis),
                        jax.lax.psum(s2 - cs2, axis))

            run = jax.jit(shard_map(sharded, mesh=mesh.mesh,
                                    in_specs=(P(), P()),
                                    out_specs=(P(), P())))

        self._eval_cache[alpha] = run
        return run

    def extend(self, alpha, n_add):
        """Draw ``n_add`` more mixed-difference samples at ``alpha``
        (rounded up to whole chunks), continuing its stream."""
        alpha = tuple(alpha)
        state = self._states[alpha]
        n_chunks = -(-int(n_add) // self._chunk)
        if n_chunks <= 0:
            return
        run = self._program(alpha)
        start = state.n // self._chunk
        t0 = time.perf_counter()
        s, s2 = run(jnp.uint32(start), jnp.uint32(n_chunks))
        s, s2 = float(s), float(s2)
        state.elapsed += time.perf_counter() - t0
        if not (np.isfinite(s) and np.isfinite(s2)):
            raise FloatingPointError(
                "index %s produced non-finite values" % (alpha,))
        state.sum += s
        state.sum_sq += s2
        state.n += n_chunks * self._chunk

    # -------------------------------------------------------------- #
    def estimates(self):
        """Per-index (means, variances-per-sample, counts) arrays aligned
        with ``index_set``."""
        means, pvars, ns = [], [], []
        for a in self._set:
            st = self._states[a]
            n = max(st.n, 1)
            mu = st.sum / n
            means.append(mu)
            pvars.append(max(st.sum_sq / n - mu * mu, 0.0)
                         * (n / max(n - 1, 1)))
            ns.append(st.n)
        return np.array(means), np.array(pvars), np.array(ns)

    def _costs(self):
        if self._cost_fn is not None:
            return np.array([float(self._cost_fn(a)) for a in self._set])
        measured = np.array([self._states[a].elapsed / max(self._states[a].n, 1)
                             for a in self._set])
        if not np.all(measured > 0):
            measured = np.ones(len(self._set))
        return measured

    def boundary_bias_estimate(self):
        """Heuristic truncation-bias bound: ``sum |E[Delta]|`` over the
        outer boundary of the index set (indices with no successor in any
        axis inside the set) — the standard MIMC remainder surrogate."""
        means, _, _ = self.estimates()
        in_set = set(self._set)
        total = 0.0
        for mu, a in zip(means, self._set):
            succs = [tuple(np.add(a, np.eye(self.d, dtype=int)[i]))
                     for i in range(self.d)]
            if not any(s in in_set for s in succs):
                total += abs(mu)
        return float(total)

    def add_index(self, alpha):
        """Grow the index set by one index (downward closure enforced —
        sample-id streams of existing indices are positional and stay
        untouched, so estimates already drawn remain bit-identical)."""
        alpha = tuple(int(a) for a in alpha)
        if len(alpha) != self.d or min(alpha) < 0:
            raise ValueError("alpha must be a non-negative %d-tuple"
                             % self.d)
        if alpha in self._states:
            raise ValueError("index %s already in the set" % (alpha,))
        need = {c for c, _ in mixed_difference_terms(alpha)} - {alpha}
        missing = need - set(self._set)
        if missing:
            raise ValueError(
                "adding %s breaks downward closure; missing %s"
                % (alpha, sorted(missing)))
        self._set.append(alpha)
        self._states[alpha] = _IndexState()

    def _allocate_to_target(self, target_var, max_rounds):
        """CLT-optimal sample allocation over the CURRENT index set:
        extend gaps until ``sum V_alpha / n_alpha <= target_var``."""
        rounds = 0
        while rounds < max_rounds:
            means, pvars, ns = self.estimates()
            est_var = float(np.sum(pvars / np.maximum(ns, 1)))
            if est_var <= target_var:
                break
            costs = self._costs()
            lam = float(np.sum(np.sqrt(pvars * costs))) / target_var
            n_opt = np.maximum(np.ceil(lam * np.sqrt(
                pvars / costs)), 2 * self._chunk)
            gaps = n_opt - ns
            if not np.any(gaps > 0):
                break
            for a, gap in zip(self._set, gaps):
                if gap > 0:
                    self.extend(a, int(gap))
            rounds += 1
        return rounds

    def run(self, target_var, n_init: int = None, max_rounds: int = 30):
        """Adaptive loop: estimate per-index variances, allocate
        ``n_alpha = sqrt(V/C) * sum sqrt(V C) / eps^2`` (clamped below by
        2 chunks), extend the gaps, iterate until the estimator variance
        ``sum V_alpha / n_alpha`` meets the target.

        :return: dict with the telescoped mean, estimator variance,
            per-index breakdown and the boundary bias surrogate
        """
        n_init = int(n_init or 2 * self._chunk)
        for a in self._set:
            if self._states[a].n == 0:
                self.extend(a, n_init)
        rounds = self._allocate_to_target(target_var, max_rounds)
        means, pvars, ns = self.estimates()
        est_var = float(np.sum(pvars / np.maximum(ns, 1)))
        return dict(mean=float(np.sum(means)), var=est_var,
                    index_set=list(self._set), index_means=means,
                    index_vars=pvars, n_samples=ns, rounds=rounds,
                    target_met=bool(est_var <= target_var),
                    boundary_bias=self.boundary_bias_estimate(),
                    total_work=float(np.sum(self._costs() * ns)))

    def run_adaptive(self, target_var, bias_tol: float = None,
                     n_pilot: int = None, max_indices: int = 64,
                     max_rounds: int = 30, profit: str = "bias_per_cost"):
        """Dimension-adaptive MIMC: GROW the index set greedily instead
        of fixing it a priori (Gerstner-Griebel index growth carried to
        sampling estimators — cf. Robbe, Nuyens & Vandewalle, SIAM J.
        Sci. Comput. 39(5), 2017). Start from the current
        (downward-closed) set, pilot-sample the admissible frontier, and
        repeatedly accept the frontier index with the largest profit,
        opening its admissible forward neighbors, until the frontier's
        summed |mean| — the truncation-bias surrogate — drops below
        ``bias_tol``. Every pilot-sampled index already contributes to
        the telescoped sum (any downward-closed set is consistent), so
        exploration is never wasted work. Then allocate samples to
        ``target_var`` over the final set.

        :param bias_tol: frontier-bias stop (default ``sqrt(target_var)``
            — bias and statistical error of the same order). Pilot
            means are noisy at ~sqrt(V/n_pilot); a bias_tol far below
            that noise floor cannot be certified — raise n_pilot with it.
        :param max_indices: hard cap on the index-set size.
        :param profit: "bias_per_cost" — ``|E_alpha| / C_alpha``, the
            Gerstner-Griebel error-per-cost indicator; the right greedy
            for a BIAS-driven stop (default). "bias_per_work" —
            ``|E_alpha| / sqrt(V_alpha C_alpha)``: balances against the
            sampling work the index will later demand, but is
            scale-free (constant!) on models with E^2 ~ V along an
            axis, where it wanders instead of descending the bias.
        :return: the :meth:`run` dict plus ``accepted`` (growth order),
            ``bias_est``, ``bias_tol``, ``bias_converged``.
        """
        if profit not in ("bias_per_cost", "bias_per_work"):
            raise ValueError("profit must be 'bias_per_cost' or "
                             "'bias_per_work'")
        bias_tol = float(np.sqrt(target_var) if bias_tol is None
                         else bias_tol)
        n_pilot = int(n_pilot or 2 * self._chunk)
        for a in self._set:
            if self._states[a].n == 0:
                self.extend(a, n_pilot)

        def admissible_neighbors(of):
            s = set(self._set)
            out = []
            for a in of:
                for i in range(self.d):
                    f = tuple(a[j] + (j == i) for j in range(self.d))
                    if f in s or f in out:
                        continue
                    if all(tuple(f[j] - (j == k) for j in range(self.d))
                           in s for k in range(self.d) if f[k] > 0):
                        out.append(f)
            return out

        active = []
        for f in admissible_neighbors(list(self._set)):
            if len(self._set) >= max_indices:
                break
            self.add_index(f)
            self.extend(f, n_pilot)
            active.append(f)
        accepted = []
        bias_converged = False
        while active:
            means, pvars, ns = self.estimates()
            pos = {a: i for i, a in enumerate(self._set)}
            bias = sum(abs(means[pos[a]]) for a in active)
            if bias <= bias_tol:
                bias_converged = True
                break
            if len(self._set) >= max_indices:
                break
            costs = self._costs()

            def score(a):
                i = pos[a]
                if profit == "bias_per_work":
                    return abs(means[i]) / max(
                        np.sqrt(max(pvars[i], 1e-300) * costs[i]),
                        1e-300)
                return abs(means[i]) / max(costs[i], 1e-300)

            best = max(active, key=score)
            active.remove(best)
            accepted.append(best)
            for f in admissible_neighbors([best]):
                if len(self._set) >= max_indices:
                    break
                self.add_index(f)
                self.extend(f, n_pilot)
                active.append(f)
        out = self.run(target_var, n_init=n_pilot, max_rounds=max_rounds)
        means, _, _ = self.estimates()
        pos = {a: i for i, a in enumerate(self._set)}
        out.update(accepted=accepted,
                   bias_est=float(sum(abs(means[pos[a]])
                                      for a in active)),
                   bias_tol=bias_tol,
                   bias_converged=bias_converged or not active)
        return out


# ---------------------------------------------------------------------- #
# adapters
# ---------------------------------------------------------------------- #
def synth_mimc_value_fn(mean=1.0, c=0.5, rates=(1.0, 1.5), rho=0.5,
                        noise=1.0):
    """Synthetic 2-axis model with an exact tensor error expansion:

    ``f_alpha(w) = noise*Z + c (hx^p1 Ax + hy^p2 Ay + rho hx^p1 hy^p2 Axy)``

    with ``h_i = 2^-alpha_i`` and Z/Ax/Ay/Axy unit-mean normals derived
    from the key. Mixed differences kill the single-axis terms for
    ``alpha > (0, 0)``, so |E[Delta]| and V[Delta] decay at the PRODUCT
    rate — the regime where MIMC beats single-axis MLMC. The exact limit
    is ``E[f_inf] = mean``.

    :param rates: per-axis error decay exponents (V[Delta_i] ~ 4^-p_i a_i);
        p_i < 0.5 on a unit-cost-doubling axis puts single-axis MLMC in
        its divergent-work regime while MIMC stays O(eps^-2)
    :param noise: std of the discretization-independent sample noise Z
    :return: (value_fn, d=2) for :class:`MIMC`
    """
    p1, p2 = float(rates[0]), float(rates[1])

    def value_fn(alpha, keys):
        hx, hy = 2.0 ** -alpha[0], 2.0 ** -alpha[1]

        def one(k):
            z, ax, ay, axy = jax.random.normal(k, (4,))
            return (mean + noise * z
                    + c * (hx ** p1 * (1 + ax) + hy ** p2 * (1 + ay)
                           + rho * hx ** p1 * hy ** p2 * (1 + axy)))

        return jax.vmap(one)(keys)

    return value_fn, 2


def heat_mimc_value_fn(sigma=0.5, corr_length=0.4, n_modes=64, n0=(4, 4),
                       total_time=0.25, seed=0):
    """1-D heat equation with random log-normal conductivity over the
    two discretization axes MIMC was built for — spatial resolution
    (axis 0) and time step (axis 1):

        ``u_t = (a(x, w) u_x)_x`` on [0, 1], u(0)=u(1)=0,
        ``u(x, 0) = sin(pi x)``,  QoI = mean_x u(x, T).

    Implicit Euler (unconditionally stable — the axes stay independent,
    no CFL tie) with one batched tridiagonal solve per step
    (``jax.lax.linalg.tridiagonal_solve`` vmapped over samples);
    ``a = exp(sigma g)``, g a 1-D RFF field whose modes are fixed and
    whose per-sample phases derive from the key — the SAME key gives the
    same field at every resolution (the MIMC coupling). Spatial error is
    O(hx^2), temporal O(dt): mixed differences decay at the product rate.

    :param n0: base grid (n_x, n_t) at alpha = (0, 0); axis i refines as
        ``n0_i * 2^alpha_i``
    :return: (value_fn, d=2) for :class:`MIMC`
    """
    k_modes = np.asarray(jax.random.normal(jax.random.key(seed), (n_modes,))
                         ) * (np.sqrt(2.0) / corr_length)

    def value_fn(alpha, keys):
        nx = int(n0[0]) << alpha[0]
        nt = int(n0[1]) << alpha[1]
        dt = total_time / nt
        h = 1.0 / nx
        centers = (jnp.arange(nx) + 0.5) * h               # cell centers
        tk = centers[:, None] * jnp.asarray(k_modes)[None, :]   # [nx, M]

        def one(key):
            phases = jax.random.uniform(key, (n_modes,), maxval=2 * np.pi)
            g = jnp.sqrt(2.0 / n_modes) * jnp.sum(
                jnp.cos(tk + phases[None, :]), axis=1)
            a = jnp.exp(sigma * g)                         # [nx] cell K
            # interior face conductivities (harmonic) + Dirichlet halves
            af = 2.0 * a[:-1] * a[1:] / (a[:-1] + a[1:])   # [nx-1]
            a_lo = 2.0 * a[0]
            a_hi = 2.0 * a[-1]
            # FV Laplacian: (I - dt A) u = u_prev, A tridiagonal / h^2
            r = dt / (h * h)
            lower = jnp.concatenate([jnp.zeros(1), -r * af])
            upper = jnp.concatenate([-r * af, jnp.zeros(1)])
            mid = 1.0 + r * (
                jnp.concatenate([af, jnp.zeros(1)])
                + jnp.concatenate([jnp.zeros(1), af])
                + jnp.zeros(nx).at[0].add(a_lo).at[-1].add(a_hi))
            u0 = jnp.sin(np.pi * centers)

            def step(u, _):
                u_new = jax.lax.linalg.tridiagonal_solve(
                    lower, mid, upper, u[:, None])[:, 0]
                return u_new, None

            u_T, _ = jax.lax.scan(step, u0, None, length=nt)
            return jnp.mean(u_T)

        return jax.vmap(one)(keys)

    return value_fn, 2


def darcy_mimc_value_fn(sigma=1.0, corr_length=0.3, n_modes=128,
                        n0=(4, 4), model="gauss", seed=0, cg_tol=1e-10,
                        dtype=None):
    """MIMC on the flagship 2-D Darcy problem (VERDICT r3 item 8):
    ANISOTROPIC spatial refinement — axis 0 refines the x resolution,
    axis 1 the y resolution, independently:

        ``-div(K grad u) = 1`` on the unit square, u = 0 on the
        boundary, ``K = exp(sigma g)``, QoI = mean_x u (~ int u dx).

    This is the regime MIMC exists for: the reference's scalar level
    hierarchy (reference mlmc/sampler.py) can only refine hx = hy
    together, paying nx*ny ~ 4^level per sample; mixed differences pay
    the product-rate decay O(hx^2 hy^2) at additive per-axis cost, so
    anisotropic solution features (e.g. a short correlation length in
    one direction) stop forcing the tensor grid.

    Device-first: per index one jitted program builds the lognormal RFF
    conductivity at the CELL CENTERS of the ``(n0_x 2^a0) x (n0_y 2^a1)``
    grid (fixed modes + key-derived phases — the SAME key reproduces
    the same continuum realization at every resolution: the MIMC
    coupling), assembles the 5-point FV operator with harmonic-mean
    face conductivities (Dirichlet via half-cell boundary faces), and
    solves by Jacobi-preconditioned matrix-free CG
    (jax.scipy.sparse.linalg.cg) vmapped over the sample batch — all
    stencil work is elementwise [B, nx, ny] elementwise math.

    ``cg_tol`` must sit far below the mixed-difference magnitudes
    (~1e-4 and falling at product rate): the default 1e-10 needs f64
    (tests); in float32 pass ``cg_tol=1e-6`` and treat deep indices as
    solver-noise-limited.

    :param n0: base grid (n_x, n_y) at alpha = (0, 0); axis i refines
        as ``n0_i * 2^alpha_i``.
    :return: (value_fn, d=2) for :class:`MIMC`
    """
    from mlmc_tpu.sim.diffusion import _wave_vectors_2d

    kvec = np.asarray(_wave_vectors_2d(model, corr_length, n_modes,
                                       seed=seed))        # [M, 2]
    amp = np.sqrt(2.0 / n_modes)

    def value_fn(alpha, keys):
        dt = jnp.dtype(dtype or jnp.result_type(float))
        nx = int(n0[0]) << alpha[0]
        ny = int(n0[1]) << alpha[1]
        hx, hy = 1.0 / nx, 1.0 / ny
        xc = (jnp.arange(nx, dtype=dt) + 0.5) * hx
        yc = (jnp.arange(ny, dtype=dt) + 0.5) * hy
        kv = jnp.asarray(kvec, dt)
        # phase argument x.k at every cell center: [nx, ny, M]
        tkx = xc[:, None] * kv[None, :, 0]                 # [nx, M]
        tky = yc[:, None] * kv[None, :, 1]                 # [ny, M]

        def one(key):
            phases = jax.random.uniform(key, (n_modes,), dtype=dt,
                                        maxval=2 * np.pi)
            g = amp * jnp.sum(
                jnp.cos(tkx[:, None, :] + tky[None, :, :]
                        + phases[None, None, :]), axis=-1)  # [nx, ny]
            K = jnp.exp(jnp.asarray(sigma, dt) * g)
            # harmonic-mean interior faces; Dirichlet half-cell faces
            ax_i = 2.0 * K[:-1] * K[1:] / (K[:-1] + K[1:])  # [nx-1, ny]
            ay_i = (2.0 * K[:, :-1] * K[:, 1:]
                    / (K[:, :-1] + K[:, 1:]))               # [nx, ny-1]
            zx = jnp.zeros((1, ny), dt)
            zy = jnp.zeros((nx, 1), dt)
            aW = jnp.concatenate([2.0 * K[:1], ax_i], 0)    # [nx, ny]
            aE = jnp.concatenate([ax_i, 2.0 * K[-1:]], 0)
            aS = jnp.concatenate([2.0 * K[:, :1], ay_i], 1)
            aN = jnp.concatenate([ay_i, 2.0 * K[:, -1:]], 1)
            rx, ry = 1.0 / (hx * hx), 1.0 / (hy * hy)
            diag = rx * (aW + aE) + ry * (aS + aN)

            def op(u):
                uW = jnp.concatenate([zx, u[:-1]], 0)
                uE = jnp.concatenate([u[1:], zx], 0)
                uS = jnp.concatenate([zy, u[:, :-1]], 1)
                uN = jnp.concatenate([u[:, 1:], zy], 1)
                return (diag * u - rx * (aW * uW + aE * uE)
                        - ry * (aS * uS + aN * uN))

            b = jnp.ones((nx, ny), dt)
            u, _ = jax.scipy.sparse.linalg.cg(
                op, b, tol=cg_tol, maxiter=20 * max(nx, ny),
                M=lambda r: r / diag)
            return jnp.mean(u)

        return jax.vmap(one)(keys)

    return value_fn, 2
