"""Unbiased randomized MLMC (Rhee-Glynn) — beyond-reference tier.

The reference framework (and the plain :class:`~mlmc_tpu.sampler.Sampler`
hierarchy) truncates the level telescope at a finite L, leaving a
discretization bias ``sum_{l>L} E[Delta_l]`` that the adaptive loop must
balance against the statistical error (reference mlmc/estimator.py's
n-level selection). Rhee & Glynn ("Unbiased estimation with square root
convergence for SDE models", Oper. Res. 63(5), 2015) remove the bias
entirely by RANDOMIZING the truncation level: with level corrections
``Delta_l`` (``Delta_0 = f_0``, ``Delta_l = f_l - f_{l-1}`` coupled
within the level) and a level distribution ``p_l > 0`` on all of N,

* single-term estimator:  ``Z = Delta_L / p_L``,  ``L ~ p``
* coupled-sum estimator:  ``Z = sum_{l<=N} Delta_l / tail_l``,
  ``tail_l = P(N >= l)``, ``N ~ p``

both satisfy ``E[Z] = sum_l E[Delta_l] = lim_l E[f_l]`` EXACTLY — any
budget gives a bias-free estimate of the continuous-limit quantity, and
when the level variances decay faster than costs grow (beta > gamma in
MLMC rate language) the estimator has finite variance AND finite
expected cost per draw.

Device-first design (the dispatch economics of :class:`~mlmc_tpu.mimc.MIMC`):

* the random per-draw levels are NEVER materialized per sample on
  device: level counts are drawn HOST-side by exact sequential
  conditioning (``N_l ~ Binomial(B_rem, p_l / tail_l)`` for the
  single-term multinomial; ``M_{l+1} ~ Binomial(M_l, tail_{l+1}/tail_l)``
  for the coupled-sum survivor counts), O(max observed level) host work
  with no B-sized arrays,
* each level owns ONE compiled chunk-loop executable
  ``(start, stop) -> (sum, sum^2)`` with a dynamic trip count and an
  in-kernel ``start <= idx < stop`` validity mask, so arbitrary
  (random!) per-round counts reuse the same program and only two
  scalars cross the host<->device link per level per round,
* per-level sample streams are independent (``fold_in(root, level)``)
  and continue across adaptive rounds (start-index arithmetic), so no
  draw is ever repeated or discarded,
* estimator variance comes from CLOSED FORMS in the per-level moment
  accumulators (derivations in :meth:`UnbiasedMLMC.estimates`) — no
  replay, no per-sample Z buffer.

Contract: ``level_fn(level: int, keys [C]) -> Delta_l values [C]`` pure
jnp, exactly :class:`~mlmc_tpu.mimc.MIMC`'s corner contract restricted
to one axis; the fine/coarse coupling lives INSIDE the function (same
key => same underlying randomness for both resolutions of level l).
Streams are independent ACROSS levels, which the variance formulas
assume — the estimators stay unbiased either way.
"""
import time
import weakref
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["GeometricLevels", "UnbiasedMLMC", "synth_unbiased_level_fn",
           "sde_unbiased_level_fn"]

# level programs are cached per (level_fn, chunk, dtype, level) with the
# stream key as a runtime OPERAND, so independent estimator instances
# (different seeds — e.g. repeated studies, bootstrap replications) share
# one compiled executable per level instead of re-jitting
_PROGRAM_CACHE = weakref.WeakKeyDictionary()


class GeometricLevels:
    """Geometric level distribution ``p_l = (1 - r) r^l`` on l = 0, 1, ...

    The Rhee-Glynn optimum for MLMC rates ``E[Delta_l^2] ~ 2^{-beta l}``,
    ``C_l ~ 2^{gamma l}`` is ``p_l ~ 2^{-(beta+gamma) l / 2}``, i.e.
    ``r = 2^{-(beta+gamma)/2}`` — use :meth:`from_rates`. Finite variance
    requires ``r > 2^{-beta}`` and finite expected cost ``r < 2^{-gamma}``;
    both exist iff beta > gamma (Rhee & Glynn Thm. 1 conditions).
    """

    def __init__(self, r: float):
        r = float(r)
        if not 0.0 < r < 1.0:
            raise ValueError("geometric ratio r must be in (0, 1)")
        self.r = r

    @classmethod
    def from_rates(cls, beta: float, gamma: float):
        if beta <= gamma:
            raise ValueError(
                "beta=%.3g <= gamma=%.3g: no geometric ratio gives finite "
                "variance AND finite expected cost (Rhee-Glynn needs the "
                "level variances to decay faster than costs grow); use a "
                "higher-order coupling (e.g. Milstein) or truncated MLMC"
                % (beta, gamma))
        return cls(2.0 ** (-(beta + gamma) / 2.0))

    def p(self, levels):
        """``p_l`` for an int array of levels."""
        lv = np.asarray(levels)
        return (1.0 - self.r) * self.r ** lv

    def tail(self, levels):
        """``P(L >= l) = r^l``."""
        return self.r ** np.asarray(levels)


class _LevelState:
    __slots__ = ("n", "sum", "sum_sq", "elapsed")

    def __init__(self):
        self.n = 0
        self.sum = 0.0
        self.sum_sq = 0.0
        self.elapsed = 0.0


class UnbiasedMLMC:
    """Adaptive unbiased randomized MLMC over an infinite level hierarchy.

    :param level_fn: ``f(level, keys [C]) -> Delta_l [C]`` pure jnp
        (``Delta_0 = f_0``; within-level fine/coarse coupling inside)
    :param levels: a :class:`GeometricLevels` (or duck-typed object with
        ``p(l)``, ``tail(l)`` over int arrays and attribute-free sampling
        handled through them)
    :param estimator: ``'single'`` (single-term) or ``'coupled'``
        (coupled-sum); both unbiased — single-term touches one level per
        draw (cheaper per draw), coupled-sum reuses each draw on every
        level ``<= N`` (lower variance when the ``E[Delta_l]`` tail is
        the dominant variance contribution)
    :param seed: PRNG root; level streams are ``fold_in(root, level)``,
        count draws use an independent numpy generator
    :param cost_fn: optional ``level -> relative cost``; measured wall
        time per sample is used if omitted
    :param chunk_size: samples per device loop step — an int, or a
        callable ``level -> int`` (counts are NOT rounded up — the
        in-kernel mask keeps the realized counts exact, which
        unbiasedness requires). Deep levels draw exponentially few
        samples while costing exponentially more per sample, so a fixed
        chunk wastes a nearly-empty masked chunk there; shrink it, e.g.
        ``lambda lv: max(8192 >> lv, 256)``.
    :param max_level: optional hard cap; a count draw beyond it raises
        (never silently truncates — that would reintroduce the bias this
        estimator exists to remove). With geometric ``r`` the excess
        probability is ``r^(max_level+1)``; pick it astronomically small
        or leave None.
    :param mesh: optional :class:`~mlmc_tpu.parallel.mesh.SampleMesh` —
        each chunk's positions shard across the mesh (chunk_size must
        divide by the device count) with a psum of the two accumulator
        scalars; the position -> key mapping is IDENTICAL for any device
        count, so estimates are bit-reproducible across pod sizes
    """

    def __init__(self, level_fn: Callable, levels: GeometricLevels,
                 estimator: str = "single", seed: int = 0,
                 cost_fn: Optional[Callable] = None,
                 chunk_size: int = 1 << 12, dtype=None,
                 max_level: Optional[int] = None, mesh=None):
        if estimator not in ("single", "coupled"):
            raise ValueError("estimator must be 'single' or 'coupled'")
        self._fn = level_fn
        self._dist = levels
        self._mode = estimator
        if callable(chunk_size):
            self._chunk_fn = lambda lv: int(chunk_size(lv))
        else:
            self._chunk_fn = lambda lv, c=int(chunk_size): c
        self._chunk = self._chunk_fn(0)
        self._mesh = mesh
        if mesh is not None and self._chunk % mesh.n_devices:
            raise ValueError(
                "chunk_size=%d must divide by the mesh's %d devices"
                % (self._chunk, mesh.n_devices))
        self._dtype = jnp.dtype(dtype or jnp.result_type(float))
        self._root = jax.random.key(seed)
        self._rng = np.random.default_rng(np.uint32(seed) ^ 0x5DEECE66)
        self._cost_fn = cost_fn
        self._max_level = None if max_level is None else int(max_level)
        self._states = {}
        self._local_programs = {}     # mesh-bound: not globally shareable
        self.n_draws = 0              # total randomized draws B

    # -------------------------------------------------------------- #
    def _state(self, level):
        st = self._states.get(level)
        if st is None:
            st = self._states[level] = _LevelState()
        return st

    def _program(self, level):
        """One executable per level: ``(lkey, start, stop) -> (sum, sum^2)``
        over stream positions [start, stop) — dynamic trip count, masked
        chunk tails, so every random count reuses it (and the stream key
        is an operand, so instances with different seeds share it too).
        With a mesh, each chunk's positions shard across devices (the
        position -> key mapping is unchanged) and the scalars psum."""
        if self._mesh is None:
            per_fn = _PROGRAM_CACHE.get(self._fn)
            if per_fn is None:
                per_fn = _PROGRAM_CACHE[self._fn] = {}
        else:
            per_fn = self._local_programs       # mesh-bound closure
        chunk = self._chunk_fn(level)
        if chunk < 1:
            raise ValueError("chunk_size(level=%d) must be >= 1" % level)
        if self._mesh is not None and chunk % self._mesh.n_devices:
            raise ValueError(
                "chunk_size(level=%d)=%d must divide by the mesh's %d "
                "devices" % (level, chunk, self._mesh.n_devices))
        sig = (chunk, self._dtype.name, level)
        run = per_fn.get(sig)
        if run is not None:
            return run
        fn = self._fn
        dtype = self._dtype
        mesh = self._mesh
        sub = chunk if mesh is None else chunk // mesh.n_devices

        def body(c, carry, lkey, start, stop, offset):
            # Kahan-compensated cross-chunk accumulation: the in-chunk
            # jnp.sum is a tree reduction, but naively adding chunk sums
            # onto a growing scalar loses low bits at millions of draws
            s, cs, s2, cs2 = carry
            idx = (c * jnp.uint32(chunk) + offset
                   + jnp.arange(sub, dtype=jnp.uint32))
            keys = jax.vmap(lambda i: jax.random.fold_in(lkey, i))(idx)
            d = fn(level, keys).astype(dtype)
            d = jnp.where((idx >= start) & (idx < stop), d, 0)

            def kadd(acc, comp, x):
                y = x - comp
                t = acc + y
                return t, (t - acc) - y

            s, cs = kadd(s, cs, jnp.sum(d))
            s2, cs2 = kadd(s2, cs2, jnp.sum(d * d))
            return (s, cs, s2, cs2)

        def bounds(start, stop):
            return (start // jnp.uint32(chunk),
                    (stop + jnp.uint32(chunk - 1)) // jnp.uint32(chunk))

        if mesh is None:
            @jax.jit
            def run(lkey, start, stop):
                z = jnp.zeros((), dtype)
                c0, c1 = bounds(start, stop)
                s, cs, s2, cs2 = jax.lax.fori_loop(
                    c0, c1, lambda c, carry: body(
                        c, carry, lkey, start, stop, jnp.uint32(0)),
                    (z, z, z, z))
                return s - cs, s2 - cs2
        else:
            from jax.sharding import PartitionSpec as P
            try:
                from jax import shard_map
            except ImportError:               # older jax
                from jax.experimental.shard_map import shard_map
            axis = mesh.axis_name

            def mark(z):
                # the fori_loop carry becomes device-varying after the
                # first chunk; mark the zero initializer accordingly
                if hasattr(jax.lax, "pcast"):
                    return jax.lax.pcast(z, (axis,), to="varying")
                return jax.lax.pvary(z, (axis,))

            def sharded(lkey, start, stop):
                offset = (jax.lax.axis_index(axis).astype(jnp.uint32)
                          * jnp.uint32(sub))
                z = mark(jnp.zeros((), dtype))
                c0, c1 = bounds(start, stop)
                s, cs, s2, cs2 = jax.lax.fori_loop(
                    c0, c1, lambda c, carry: body(
                        c, carry, lkey, start, stop, offset),
                    (z, z, z, z))
                return (jax.lax.psum(s - cs, axis),
                        jax.lax.psum(s2 - cs2, axis))

            run = jax.jit(shard_map(sharded, mesh=mesh.mesh,
                                    in_specs=(P(), P(), P()),
                                    out_specs=(P(), P())))

        per_fn[sig] = run
        return run

    def _extend(self, level, n_add):
        """Evaluate ``n_add`` more Delta_level draws, continuing the
        level's stream; accumulates (n, sum, sum^2) host-side."""
        if n_add <= 0:
            return
        st = self._state(level)
        if st.n + n_add >= (1 << 32) - self._chunk_fn(level):
            raise OverflowError("level %d stream exceeds uint32 positions"
                                % level)
        run = self._program(level)
        lkey = jax.random.fold_in(self._root, level)
        t0 = time.perf_counter()
        s, s2 = run(lkey, jnp.uint32(st.n), jnp.uint32(st.n + n_add))
        s, s2 = float(s), float(s2)
        st.elapsed += time.perf_counter() - t0
        if not (np.isfinite(s) and np.isfinite(s2)):
            raise FloatingPointError(
                "level %d produced non-finite values" % level)
        st.sum += s
        st.sum_sq += s2
        st.n += int(n_add)

    # -------------------------------------------------------------- #
    def _draw_counts(self, n_draws):
        """Host-side exact level counts for ``n_draws`` randomized draws.

        single: multinomial over the infinite support by sequential
        conditioning — ``N_l ~ Binomial(B_rem, p_l / tail_l)``.
        coupled: survivor counts — ``M_0 = B``,
        ``M_{l+1} ~ Binomial(M_l, tail_{l+1} / tail_l)``.
        Returns a dense list ``counts[l]`` up to the last positive count.
        """
        counts = []
        lv = 0
        if self._mode == "single":
            rem = int(n_draws)
            while rem > 0:
                q = float(self._dist.p(lv) / self._dist.tail(lv))
                n_l = int(self._rng.binomial(rem, min(q, 1.0)))
                counts.append(n_l)
                rem -= n_l
                lv += 1
                self._check_level(lv, rem > 0)
        else:
            m = int(n_draws)
            while m > 0:
                counts.append(m)
                lv += 1
                q = float(self._dist.tail(lv) / self._dist.tail(lv - 1))
                m = int(self._rng.binomial(m, min(q, 1.0)))
                self._check_level(lv, m > 0)
        return counts

    def _check_level(self, level, active):
        if active and self._max_level is not None \
                and level > self._max_level:
            raise RuntimeError(
                "a draw exceeded max_level=%d (probability ~%.2g); raising "
                "rather than truncating, which would bias the estimator"
                % (self._max_level, float(self._dist.tail(level))))

    def sample(self, n_draws):
        """Run ``n_draws`` more randomized draws (both estimators batch
        them into per-level extensions of the level streams)."""
        for lv, n_l in enumerate(self._draw_counts(n_draws)):
            self._extend(lv, n_l)
        self.n_draws += int(n_draws)

    # -------------------------------------------------------------- #
    def _level_moments(self):
        levels = sorted(lv for lv, st in self._states.items() if st.n)
        n = np.array([self._states[lv].n for lv in levels], dtype=float)
        s = np.array([self._states[lv].sum for lv in levels])
        s2 = np.array([self._states[lv].sum_sq for lv in levels])
        mu = s / n
        m2 = s2 / n
        return np.array(levels), n, mu, m2

    def estimates(self):
        """Point estimate, per-draw variance and expected per-draw cost.

        The estimate aggregates ALL draws so far. With per-level weights
        ``w_l = 1/p_l`` (single) or ``1/tail_l`` (coupled) and realized
        counts, ``est = (1/B) sum_l w_l sum_i Delta_{l,i}`` — the exact
        sample mean of B i.i.d. copies of Z, so ``Var(est) = Var(Z)/B``.

        Closed forms (independent level streams, counts from one draw
        batch):

        * single-term: ``Var(Z) = sum_l E[Delta_l^2]/p_l - mu^2``
          (standard importance-sampling second moment).
        * coupled-sum: conditioning on the survivor counts M and using
          ``E[M_l] = B tail_l``, ``Cov(M_l, M_k) = B (tail_max(l,k)
          - tail_l tail_k)``:
          ``Var(Z) = sum_l V_l/tail_l + sum_{l,k} mu_l mu_k
          (tail_max(l,k)/(tail_l tail_k) - 1)``.

        Plug-in: per-level moments from the realized samples. The
        coupled form's DIAGONAL ``mu_l^2`` terms carry a huge
        ``~1/tail_l`` weight, and ``E[mu_hat^2] = mu^2 + V/n`` — at
        deep, rarely-visited levels the ``V/n`` noise would explode the
        estimate (and the adaptive allocation with it), so the diagonal
        uses the DEBIASED ``max(mu_hat^2 - V_hat/n, 0)`` (zero below 2
        samples; such levels are revisited as B grows). Off-diagonal
        products are unbiased as-is (independent level streams).

        :return: dict(mean, var, var_per_draw, cost_per_draw, levels,
            level_means, level_m2, n_samples, n_draws)
        """
        levels, n, mu, m2 = self._level_moments()
        if len(levels) == 0:
            raise ValueError("no draws yet — call sample() first")
        if self._mode == "single":
            w = 1.0 / self._dist.p(levels)
            total = float(np.sum(mu * n * w)) / self.n_draws
            var_z = float(np.sum(m2 * w)) - total ** 2
        else:
            tails = self._dist.tail(levels)
            w = 1.0 / tails
            total = float(np.sum(mu * n * w)) / self.n_draws
            v = np.maximum(m2 - mu * mu, 0.0)
            var_z = float(np.sum(v / tails))
            # P(N >= l, N >= k) is the tail of the LATER level:
            # tail_max(l,k) = min(tail_l, tail_k)
            t_joint = np.minimum(tails[:, None], tails[None, :])
            cross = (t_joint / (tails[:, None] * tails[None, :])) - 1.0
            diag = np.diag(cross).copy()
            np.fill_diagonal(cross, 0.0)
            var_z += float(mu @ cross @ mu)
            v_bessel = v * (n / np.maximum(n - 1, 1))
            mu2 = np.where(n >= 2,
                           np.maximum(mu * mu - v_bessel / n, 0.0), 0.0)
            var_z += float(np.sum(mu2 * diag))
        var_z = max(var_z, 0.0)
        costs = self._level_costs(levels)
        if self._mode == "single":
            cost = float(np.sum(self._dist.p(levels) * costs))
        else:
            cost = float(np.sum(self._dist.tail(levels) * costs))
        return dict(mean=total, var=var_z / self.n_draws, var_per_draw=var_z,
                    cost_per_draw=cost, levels=levels, level_means=mu,
                    level_m2=m2, n_samples=n.astype(int),
                    n_draws=self.n_draws)

    def _level_costs(self, levels):
        if self._cost_fn is not None:
            return np.array([float(self._cost_fn(int(lv))) for lv in levels])
        measured = np.array([self._states[int(lv)].elapsed
                             / max(self._states[int(lv)].n, 1)
                             for lv in levels])
        if not np.all(measured > 0):
            measured = np.ones(len(levels))
        return measured

    # -------------------------------------------------------------- #
    def run(self, target_var, n_init: int = None, max_rounds: int = 20,
            growth_cap: float = 16.0):
        """Adaptive loop: grow the draw count until ``Var(Z)/B`` meets
        the target. The level DISTRIBUTION stays fixed (reweighting
        mid-run would break the aggregate estimator), so tuning ``r``
        belongs to a pilot: construct with
        :meth:`GeometricLevels.from_rates` or measure rates with a small
        run first.

        :return: the :meth:`estimates` dict + rounds/target_met
        """
        n_init = int(n_init or 4 * self._chunk)
        if self.n_draws == 0:
            self.sample(n_init)
        rounds = 0
        while rounds < max_rounds:
            est = self.estimates()
            if est["var"] <= target_var:
                break
            need = int(np.ceil(est["var_per_draw"] / target_var)) \
                - self.n_draws
            need = min(need, int(growth_cap * self.n_draws))
            # stay inside the uint32 stream guard (the coupled estimator
            # touches level 0 on every draw) instead of dying mid-run
            headroom = (1 << 32) - 2 * self._chunk - self.n_draws
            need = min(need, headroom)
            if need <= 0:
                break
            self.sample(max(need, self._chunk))
            rounds += 1
        est = self.estimates()
        est.update(rounds=rounds, target_met=bool(est["var"] <= target_var))
        return est


# ---------------------------------------------------------------------- #
# adapters
# ---------------------------------------------------------------------- #
def synth_unbiased_level_fn(mean=1.0, c=0.5, rate=1.0, noise=1.0):
    """Synthetic hierarchy with a closed-form limit and exact moments:
    ``f_l = mean + noise Z + c 2^{-rate l} (1 + A)`` with (Z, A) standard
    normals shared within a key, so

        ``Delta_0 = mean + noise Z + c (1 + A)``,
        ``Delta_l = c (2^{-rate l} - 2^{-rate (l-1)}) (1 + A)``,

    ``sum_l E[Delta_l] = mean + c - c = mean`` exactly, and
    ``E[Delta_l^2] = d_l^2 * 2`` for l >= 1 with
    ``d_l = c (2^{-rate l} - 2^{-rate(l-1)})`` — the test fixture for the
    unbiasedness and variance-formula assertions.

    :return: (level_fn, exact_mean)
    """

    def fn(level, keys):
        def one(k):
            z, a = jax.random.normal(k, (2,))
            if level == 0:
                return mean + noise * z + c * (1.0 + a)
            d = c * (2.0 ** (-rate * level) - 2.0 ** (-rate * (level - 1)))
            return d * (1.0 + a)

        return jax.vmap(one)(keys)

    return fn, float(mean)


def sde_unbiased_level_fn(sim, n0: int = 2, refine: int = 2,
                          precision: str = "df64"):
    """Level-correction function for an
    :class:`~mlmc_tpu.sim.sde.SDESimulation` (``qoi='payoff'``): level l
    integrates with ``n0 * refine^l`` steps, the within-level fine/coarse
    coupling is the shared-Brownian-path scan, and the scheme's weak
    convergence makes ``lim_l E[f_l]`` the CONTINUOUS-time expectation —
    so the unbiased estimate targets the exact (e.g. Black-Scholes)
    value with zero discretization bias at any budget.

    Rates guidance: Euler has beta ~ 1 = gamma (borderline — infinite
    variance-work product); Milstein's beta ~ 2 > gamma = 1 puts the
    estimator in its square-root-convergence regime with
    ``r = 2^{-3/2}`` optimal.

    :param precision: integration accumulation mode (default ``'df64'``:
        double-float state sums). The unbiased ladder is UNBOUNDED, and
        plain-f32 path integration noise floors the level corrections at
        ~1e-5-1e-3 beyond ~1e4 steps; the ``1/p_l`` weights amplify that
        floor exponentially, corrupting both the estimate and its
        variance on f32 hardware. ``'float'`` restores the raw native
        path (fine on f64 backends).
    :return: level_fn for :class:`UnbiasedMLMC`
    """
    if sim.config["qoi"] != "payoff":
        raise ValueError("unbiased estimation drives scalar payoffs; "
                         "build the sim with qoi='payoff'")
    T = float(sim.config["total_time"])
    n0 = int(n0)
    refine = int(refine)
    if n0 < 1 or refine < 2:
        raise ValueError("need n0 >= 1 and refine >= 2")
    configs = {}

    def fn(level, keys):
        cfg = configs.get(level)
        if cfg is None:
            n_f = n0 * refine ** level
            fine = [T / n_f]
            coarse = [0.0] if level == 0 else [T / (n_f // refine)]
            cfg = dict(sim.level_instance(fine, coarse).config_dict,
                       precision=precision)
            configs[level] = cfg
        fine_v, coarse_v, _ = type(sim).calculate_batch(cfg, keys)
        return fine_v[:, 0] - coarse_v[:, 0]

    return fn
