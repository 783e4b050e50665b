"""Multilevel quasi-Monte Carlo (MLQMC) driver — beyond-reference tier.

The reference framework is plain Monte Carlo: its estimator variance
decays as 1/N and its adaptive loop (reference mlmc/sampler.py:195-229 +
mlmc/estimator.py:366-385) allocates samples by the sqrt(V/C) rule. For
smooth QoIs the randomized-QMC estimator variance decays close to 1/N²,
so the same target variance needs orders of magnitude fewer samples.
This driver implements the Giles-Waterhouse multilevel QMC algorithm
("Multilevel quasi-Monte Carlo path simulation", 2009): each level runs
R independent Owen-scramblings of one Sobol' sequence, the level
estimator variance is measured ACROSS the randomizations, and the level
whose variance is cheapest to reduce gets its point count doubled until
the total meets the target.

Design (device-first, mirrors FusedMLMC's streaming economics):
- points are generated on device (`ops.sobol`: XOR/hash integer work),
  pushed through the level function and reduced to per-randomization
  sums in ONE dispatch per extension — nothing but [R]-vectors ever
  crosses the host<->device link;
- doubling EXTENDS the sequence (Sobol' prefixes nest, and a fixed
  scramble seed keeps the extension consistent), so no work is repeated
  and every evaluated point contributes to the final estimate;
- ONE executable per level serves the whole adaptive run: the chunk
  shape is fixed and the trip count is a traced operand (the fused
  driver's dynamic-trip-count economics), so a run costs L compiles
  total and the persistent compilation cache serves later processes.

Contract: ``level_fns[l](u [n, d_l]) -> (fine [n], coarse [n])`` pure
jnp (level 0 returns coarse == 0). QMC points cannot be dropped without
bias, so level functions must be total — non-finite results fail the
run loudly instead of being masked (plain MC with renewals is the tool
for failure-prone simulations).
"""
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.ops import sobol
from mlmc_tpu.random.distributions import as_jax_distr

__all__ = ["MLQMC", "QMCLevelState", "synth_qmc_level_fns",
           "shooting_qmc_level_fns", "darcy_qmc_level_fns",
           "qmc_level_fns_from_normals", "moments_qmc_level_fns"]


class QMCLevelState:
    """Per-level accumulators: R randomization sums over the point prefix
    (shape [R] for scalar QoIs, [R, K] for vector QoIs)."""

    def __init__(self, n_rand, dtype, qoi_dim=None):
        shape = (n_rand,) if qoi_dim is None else (n_rand, qoi_dim)
        self.n = 0
        self.sums = np.zeros(shape, dtype=dtype)     # Σ_i diff_i per r(,k)
        self.sums_sq = np.zeros(shape, dtype=dtype)  # Σ_i diff_i² per r(,k)
        self.elapsed = 0.0


class MLQMC:
    """Adaptive multilevel QMC over Owen-scrambled Sobol' points.

    :param level_fns: per-level ``f(u [n, d_l]) -> (fine [n], coarse [n])``
    :param dims: per-level point dimension d_l (int or per-level list)
    :param n_randomizations: independent scramblings per level (the
        variance sample size; Giles-Waterhouse use 32)
    :param seed: scramble master seed
    :param cost_per_sample: optional per-level relative costs for the
        allocation rule; measured wall time is used when omitted
    :param chunk_size: points per scan step inside an extension dispatch
    :param qoi_dim: None for scalar level functions (``fine/coarse [n]``);
        an int K makes the driver vector-valued (``fine/coarse [n, K]``,
        e.g. a moment vector) — the adaptive loop then targets the WORST
        component (max_k Σ_l V_{l,k} <= target_var), matching the
        reference sampler's max-over-moments allocation rule
        (reference mlmc/sampler.py:195-229 via estimator n_estimated)
    :param mesh: optional :class:`~mlmc_tpu.parallel.mesh.SampleMesh` —
        the R randomizations are embarrassingly parallel, so each
        extension shard_maps them across the mesh (R must divide by the
        device count); per-device work and the host<->device traffic
        ([R]-vectors) are unchanged, wall time divides by the pod size
    :param point_set: ``'sobol'`` (default — Owen-scrambled Sobol') or
        ``'lattice'`` — an EXTENSIBLE rank-1 lattice sequence
        (ops/lattice.py: fast-CBC generating vector for
        ``lattice_n_max`` points, bit-reversed enumeration so every
        power-of-two prefix is exactly the embedded lattice rule) with
        a RANDOM SHIFT per randomization replacing the scramble.
        Generation is one multiply-mod per coordinate (no
        direction-number tables); the baker's/tent transform is applied
        by default (``lattice_tent``) to periodize smooth non-periodic
        integrands, keeping the higher lattice rate.
    :param lattice_n_max: lattice sequence capacity (power of two;
        points beyond it raise, like Sobol's 2^30 cap)
    :param lattice_tent: apply the tent transform on the lattice path
    """

    def __init__(self, level_fns: Sequence[Callable], dims,
                 n_randomizations: int = 32, seed: int = 0,
                 cost_per_sample: Optional[Sequence[float]] = None,
                 chunk_size: int = 1 << 15, dtype=None,
                 qoi_dim: Optional[int] = None, mesh=None,
                 point_set: str = "sobol",
                 lattice_n_max: int = 1 << 20,
                 lattice_tent: bool = True):
        self._fns = list(level_fns)
        n_levels = len(self._fns)
        if np.isscalar(dims):
            dims = [int(dims)] * n_levels
        if len(dims) != n_levels:
            raise ValueError("dims must match level_fns")
        self._dims = [int(d) for d in dims]
        self._R = int(n_randomizations)
        if self._R < 2:
            raise ValueError("need >= 2 randomizations to estimate variance")
        self._chunk = int(chunk_size)
        if self._chunk & (self._chunk - 1):
            raise ValueError("chunk_size must be a power of two")
        self._dtype = jnp.dtype(dtype or jnp.result_type(float))
        if point_set not in ("sobol", "lattice"):
            raise ValueError("point_set must be 'sobol' or 'lattice'")
        if point_set == "sobol" and (lattice_n_max != 1 << 20
                                     or lattice_tent is not True):
            # a lattice option on the Sobol' engine would silently
            # no-op — the failure class the composition sweep exists
            # to keep out
            raise ValueError("lattice_n_max/lattice_tent apply to "
                             "point_set='lattice' only")
        self._point_set = point_set
        key = jax.random.key(seed)
        if point_set == "sobol":
            self._capacity = 1 << 30
            self._dvs = {d: jnp.asarray(sobol.direction_numbers(d))
                         for d in set(self._dims)}
            self._seeds = [
                jax.vmap(lambda k, d=d: sobol.scramble_seeds(k, d))(
                    jax.random.split(jax.random.fold_in(key, lev),
                                     self._R))
                for lev, d in enumerate(self._dims)]     # [R, d_l] uint32
        else:
            from mlmc_tpu.ops.lattice import cbc_vector

            n_max = int(lattice_n_max)
            if n_max < 2 or n_max & (n_max - 1):
                raise ValueError("lattice_n_max must be a power of two")
            self._capacity = n_max
            self._lat_n_max = n_max
            self._lat_tent = bool(lattice_tent)
            # one fast-CBC vector per distinct dimension, built for the
            # full capacity (every embedded power-of-two prefix shares it)
            self._zs = {d: jnp.asarray(cbc_vector(n_max, d) % n_max,
                                       jnp.uint32)
                        for d in set(self._dims)}
            # randomization = independent uniform shift per level
            self._seeds = [
                jax.random.uniform(jax.random.fold_in(key, lev),
                                   (self._R, d), self._dtype)
                for lev, d in enumerate(self._dims)]     # [R, d_l] shifts
        self._qoi_dim = None if qoi_dim is None else int(qoi_dim)
        self._mesh = mesh
        if mesh is not None and self._R % mesh.n_devices:
            raise ValueError(
                "n_randomizations=%d must divide by the mesh's %d devices"
                % (self._R, mesh.n_devices))
        self._levels = [QMCLevelState(self._R, self._dtype, self._qoi_dim)
                        for _ in range(n_levels)]
        self._fixed_cost = (None if cost_per_sample is None
                            else np.asarray(cost_per_sample, dtype=float))
        self._eval_cache = {}

    # ------------------------------------------------------------------ #
    @property
    def n_levels(self):
        return len(self._fns)

    @property
    def n_samples(self):
        """Per-level point counts (each counted once; every randomization
        re-uses the same sequence positions under a different scramble)."""
        return np.array([s.n for s in self._levels])

    def _eval_fn(self, level, n):
        """Compiled extension program for one level:
        ``(start, n_chunks, seeds [R, d]) -> (sums, sums_sq) [R]``.

        ONE executable per level serves every extension size: the chunk
        shape is fixed on first use (min(chunk_size, first n)) and the
        trip count is a traced operand of a ``fori_loop`` — the same
        dynamic-trip-count economics as the fused driver (a doubling
        schedule would otherwise mint one remote AOT compile per size).
        """
        cached = self._eval_cache.get(level)
        if cached is not None:
            return cached
        if self._point_set == "sobol":
            dv = self._dvs[self._dims[level]]
        else:
            from mlmc_tpu.ops.lattice import (lattice_points_extensible,
                                              tent as tent_fn)

            lat_z = self._zs[self._dims[level]]
            lat_n_max = self._lat_n_max
            lat_tent = self._lat_tent
        level_fn = self._fns[level]
        chunk = min(self._chunk, n)
        dtype = self._dtype

        if dtype == jnp.float32:
            # compensated cross-chunk carry via the fusion-hardened EFT
            # (ops/df64) — the randomization spread being measured is far
            # below sqrt(n)·eps32 random-walk noise at bench sizes
            from mlmc_tpu.ops.df64 import two_sum
        else:
            def two_sum(a, b):
                return a + b, jnp.zeros_like(a)

        qoi_shape = () if self._qoi_dim is None else (self._qoi_dim,)
        if self._mesh is not None:
            # inside shard_map the carry depends on the per-shard seeds:
            # mark the zero initializer as varying over the mesh axis
            axis_names = (self._mesh.axis_name,)

            def mark(z):
                if hasattr(jax.lax, "pcast"):
                    return jax.lax.pcast(z, axis_names, to="varying")
                return jax.lax.pvary(z, axis_names)
        else:
            def mark(z):
                return z

        def one_rand(start, n_chunks, seeds):
            def body(c, carry):
                s, cs, s2, cs2 = carry
                pos = start + c.astype(jnp.uint32) * jnp.uint32(chunk)
                if self._point_set == "sobol":
                    u = sobol.sobol_uniforms(dv, pos, chunk, seeds,
                                             dtype=dtype)
                else:
                    u = lattice_points_extensible(
                        lat_z, lat_n_max, shift=seeds, start=pos,
                        count=chunk, dtype=dtype)
                    if lat_tent:
                        u = tent_fn(u)
                    # strictly inside (0, 1): the f32 shift-mod (and
                    # the tent's fold) can land EXACTLY on 0/1, which
                    # ndtri-based level fns turn into +-inf — the same
                    # open-interval guarantee sobol.uniforms_from_bits
                    # provides via its half-ulp centering
                    tiny = (2.0 ** -32 if dtype == jnp.float64
                            else 2.0 ** -24)
                    u = jnp.clip(u, tiny, 1.0 - tiny)
                fine, coarse = level_fn(u)
                d = (fine - coarse).astype(dtype)
                s, e = two_sum(s, jnp.sum(d, axis=0))
                s2, e2 = two_sum(s2, jnp.sum(d * d, axis=0))
                return (s, cs + e, s2, cs2 + e2)

            z = mark(jnp.zeros(qoi_shape, dtype))
            s, cs, s2, cs2 = jax.lax.fori_loop(
                0, n_chunks, body, (z, z, z, z))
            return s + cs, s2 + cs2

        def batch(start, n_chunks, seeds):
            return jax.vmap(lambda sd: one_rand(start, n_chunks, sd))(seeds)

        if self._mesh is not None:
            from jax.sharding import PartitionSpec as P
            try:
                from jax import shard_map
            except ImportError:           # older jax
                from jax.experimental.shard_map import shard_map
            axis = self._mesh.axis_name
            batch = shard_map(
                batch, mesh=self._mesh.mesh,
                in_specs=(P(), P(), P(axis)),   # seeds [R, d] fan out
                out_specs=(P(axis), P(axis)))   # [R]-vector sums gather

        cached = (jax.jit(batch), chunk)
        self._eval_cache[level] = cached
        return cached

    def extend(self, level, n_add):
        """Evaluate points [n, n + n_add) of level ``level``'s sequence
        under every randomization and fold them into the accumulators."""
        state = self._levels[level]
        n_add = int(n_add)
        if state.n + n_add > self._capacity:
            raise ValueError(
                "%d points exceed the sequence capacity %d (%s)"
                % (state.n + n_add, self._capacity,
                   "Sobol' direction numbers carry 30 bits"
                   if self._point_set == "sobol"
                   else "raise lattice_n_max — the CBC vector serves "
                        "every embedded power-of-two size"))
        fn, chunk = self._eval_fn(level, n_add)
        n_chunks, rem = divmod(n_add, chunk)
        if rem:
            raise ValueError(
                "extension size %d is not a multiple of this level's "
                "chunk %d (extensions after the first must be multiples; "
                "run() keeps everything power-of-two)" % (n_add, chunk))
        t0 = time.perf_counter()
        sums, sums_sq = fn(jnp.uint32(state.n), n_chunks,
                           self._seeds[level])
        sums, sums_sq = np.asarray(sums), np.asarray(sums_sq)
        state.elapsed += time.perf_counter() - t0
        if not (np.all(np.isfinite(sums)) and np.all(np.isfinite(sums_sq))):
            raise FloatingPointError(
                "level %d produced non-finite results; QMC points cannot be "
                "dropped without bias — fix the level function or use the "
                "MC drivers (FusedMLMC / Sampler) with failure renewal"
                % level)
        state.sums += sums
        state.sums_sq += sums_sq
        state.n += int(n_add)

    # ------------------------------------------------------------------ #
    def level_estimates(self):
        """(means [L(,K)], est_vars [L(,K)]) — per-level estimator mean and
        the variance OF THAT MEAN measured across randomizations."""
        means, est_vars = [], []
        for s in self._levels:
            y_r = s.sums / max(s.n, 1)
            means.append(np.mean(y_r, axis=0))
            est_vars.append(np.var(y_r, axis=0, ddof=1) / self._R)
        return np.array(means), np.array(est_vars)

    def point_variances(self):
        """Per-level plain-MC per-point variances (pooled across
        randomizations) — what a pseudo-random estimator's variance per
        sample would be; the QMC gain factor is
        ``point_var / (n · est_var · R)``. Shape [L] or [L, K]."""
        out = []
        for s in self._levels:
            n = max(s.n, 2)
            v_r = (s.sums_sq / n - (s.sums / n) ** 2) * n / (n - 1)
            out.append(np.mean(v_r, axis=0))
        return np.array(out)

    def _costs(self):
        if self._fixed_cost is not None:
            return self._fixed_cost
        measured = np.array([s.elapsed / max(s.n, 1) for s in self._levels])
        if not np.all(measured > 0):
            measured = np.ones(self.n_levels)
        return measured

    def _worst(self, per_level):
        """Collapse [L(,K)] per-level values to [L]: vector QoIs are
        driven by their worst component (the reference's max-over-moments
        allocation rule)."""
        per_level = np.asarray(per_level)
        return per_level if per_level.ndim == 1 else per_level.max(axis=-1)

    def run(self, target_var, n_init: int = 256, max_rounds: int = 60):
        """Adaptive loop: double the point count of the level whose
        estimator variance is cheapest to halve until Σ_l V_l <= target
        (for vector QoIs: until max_k Σ_l V_{l,k} <= target).

        :return: dict with mean, estimator variance, per-level breakdown
            and the measured QMC-vs-MC variance-reduction factors
        """
        n_init = max(2, int(n_init))
        n_init = 1 << (n_init - 1).bit_length()   # next power of two
        for lev in range(self.n_levels):
            if self._levels[lev].n == 0:
                self.extend(lev, n_init)
        rounds = 0
        while rounds < max_rounds:
            _, est_vars = self.level_estimates()
            if float(np.max(np.sum(est_vars, axis=0))) <= target_var:
                break
            costs = self._costs()
            ns = self.n_samples
            # doubling level l removes ~V_l/2 variance at cost C_l·n_l
            payoff = self._worst(est_vars) / (costs * ns)
            lev = int(np.argmax(payoff))
            self.extend(lev, int(ns[lev]))
            rounds += 1
        means, est_vars = self.level_estimates()
        point_vars = self.point_variances()
        ns = self.n_samples
        total = ns * self._R
        var = np.sum(est_vars, axis=0)
        total_b = total if est_vars.ndim == 1 else total[:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            gain = point_vars / (est_vars * total_b)
        scalar = est_vars.ndim == 1
        return dict(mean=float(np.sum(means)) if scalar
                    else np.sum(means, axis=0),
                    var=float(var) if scalar else var,
                    level_means=means, level_vars=est_vars,
                    n_samples=ns, n_evaluations=total,
                    n_randomizations=self._R, rounds=rounds,
                    target_met=bool(np.max(var) <= target_var),
                    mc_variance_reduction=gain)


# ---------------------------------------------------------------------- #
# adapters
# ---------------------------------------------------------------------- #
def synth_qmc_level_fns(level_parameters, distr="norm", nan_fraction=0.0):
    """QMC level functions for the synthetic benchmark QoI
    ``y + h·sqrt(1e-4 + |y|)`` (reference mlmc/sim/synth_simulation.py:
    38-46, fine and coarse sharing the draw).

    :return: (level_fns, dims) for :class:`MLQMC`
    """
    if nan_fraction:
        raise ValueError("QMC has no unbiased failure-renewal story; "
                         "use the MC drivers for nan_fraction > 0")
    from mlmc_tpu.sim.synth_simulation import SynthSimulation

    d = as_jax_distr(distr)
    fns = []
    for lev, params in enumerate(level_parameters):
        fine_step = float(params[0])
        coarse_step = 0.0 if lev == 0 else float(level_parameters[lev - 1][0])

        def fn(u, fine_step=fine_step, coarse_step=coarse_step):
            y = d.sample_uniforms(u)
            fine = SynthSimulation.sample_fn(y, fine_step)
            coarse = (jnp.zeros_like(fine) if coarse_step == 0
                      else SynthSimulation.sample_fn(y, coarse_step))
            return fine, coarse

        fns.append(fn)
    return fns, [d.qmc_dim] * len(fns)


def shooting_qmc_level_fns(sim, level_parameters, component=0):
    """QMC level functions for the shooting ODE sims: the per-sample
    randomness is a block of spectral-mode phases (uniform on [0, 2pi)),
    so the low-discrepancy points drive the phases directly. For non-log
    force fields the QoI is ADDITIVE across modes, so scrambled Sobol'
    collapses the variance even at d = n_modes (superposition dimension
    one); log fields remain smooth integrands.

    The QoI is NaN when a trajectory leaves ``area_borders``; QMC cannot
    drop points unbiasedly, so configure borders the trajectories cannot
    reach (MLQMC.extend raises loudly otherwise).

    :param sim: a ShootingSimulation1D/2D instance
    :param level_parameters: as for Sampler ([[fine_step], ...])
    :param component: index into the flattened result (0 = final y / x)
    :return: (level_fns, dims) for :class:`MLQMC`
    """
    cls = type(sim)
    fns, dims = [], []
    for lev, params in enumerate(level_parameters):
        coarse = [0] if lev == 0 else level_parameters[lev - 1]
        cfg = sim.level_instance(params, coarse).config_dict
        d = cfg["_wave_numbers"].shape[0] * cls.N_FORCE_AXES

        def fn(u, cfg=cfg):
            trig = cls._phase_trig_from_uniforms(cfg, u)
            fine = cls._calculate_level(cfg, None, "fine", trig=trig)
            if cfg["coarse"]["n_elements"] > 0:
                coarse_r = cls._calculate_level(cfg, None, "coarse",
                                                trig=trig)
            else:
                coarse_r = jnp.zeros_like(fine)
            return fine[:, component], coarse_r[:, component]

        fns.append(fn)
        dims.append(d)
    return fns, dims


def darcy_qmc_level_fns(sim, level_parameters):
    """QMC level functions for :class:`DiffusionSimulation` with the RFF
    field (``field_method='rff'``): the per-sample randomness is the
    block of spectral mode phases, driven directly by the points. The
    outflow flux is a smooth functional of the phases (through exp and
    the CG pressure solve — fixed iteration budget, no data-dependent
    control flow), so scrambled points reduce the variance of the PDE
    MLMC estimator itself.

    :param sim: a DiffusionSimulation (field_method='rff'; the circulant
        path has no phase parametrization and is rejected) or a
        :class:`~mlmc_tpu.sim.diffusion3d.DiffusionSimulation3D` — the
        adapter is generic over the `_calculate_one(cfg, None,
        phases=...)` hook (tests/test_diffusion3d.py::test_darcy3d_qmc)
    :param level_parameters: as for Sampler ([[fine_step], ...])
    :return: (level_fns, dims) for :class:`MLQMC`
    """
    cls = type(sim)
    fns, dims = [], []
    for lev, params in enumerate(level_parameters):
        coarse = [0] if lev == 0 else level_parameters[lev - 1]
        cfg = sim.level_instance(params, coarse).config_dict
        if "_wave_vectors" not in cfg:
            raise ValueError(
                "darcy_qmc_level_fns needs field_method='rff' "
                "(got %r)" % (cfg.get("field_method", "rff"),))

        def fn(u, cfg=cfg):
            phases = 2 * np.pi * u                      # [n, M]
            fine, coarse_r = jax.vmap(
                lambda ph: cls._calculate_one(cfg, None, phases=ph))(phases)
            return fine[:, 0], coarse_r[:, 0]

        fns.append(fn)
        dims.append(int(cfg["_wave_vectors"].shape[0]))
    return fns, dims


def _without_safe_eval(moments):
    """Rebuild a moment basis with ``safe_eval=False`` (no NaN clipping),
    recursing through :class:`~mlmc_tpu.moments.TransformedMoments`."""
    from mlmc_tpu.moments import TransformedMoments

    if isinstance(moments, TransformedMoments):
        return TransformedMoments(_without_safe_eval(moments._origin),
                                  moments._transform_mat)
    return type(moments)(moments.size, moments.domain,
                         log=moments._is_log, safe_eval=False)


def moments_qmc_level_fns(level_fns, dims, moments, out_of_domain="error"):
    """Lift scalar QMC level functions to MOMENT-VECTOR level functions,
    so the full maxent density pipeline rides the QMC tier: the driver
    then estimates all R moment means (with cross-randomization error
    bars) in one adaptive run, and ``(means, vars)`` feed
    :class:`~mlmc_tpu.tool.simple_distribution.SimpleDistribution`
    directly — the reference's density workflow
    (reference mlmc/estimator.py:116-134) at QMC convergence rates.

    Level-0 coarse results are identically zero in the scalar contract;
    the lifted function zeroes the coarse moment BLOCK there (phi(0) is
    not the zero vector), matching the estimators' telescoping
    convention (reference mlmc/quantity/quantity_estimate.py:64-77).

    :param level_fns: scalar level functions, as produced by the other
        adapters in this module
    :param dims: their per-level point dimensions
    :param moments: a :class:`~mlmc_tpu.moments.Moments` basis; its
        domain must cover the reachable QoI range
    :param out_of_domain: ``"error"`` — values outside the moment domain
        become NaN and fail the run loudly (QMC points cannot be dropped
        without bias); ``"clip"`` — clamp values to the domain edges
        first (bias bounded by P(outside)·max|phi|; same order as the
        reference's quantile-domain NaN masking, but deterministic)
    :return: (vector_level_fns, dims, qoi_dim) for :class:`MLQMC`
    """
    if out_of_domain not in ("error", "clip"):
        raise ValueError("out_of_domain must be 'error' or 'clip'")
    if out_of_domain == "clip":
        # a non-NaN evaluator + explicit clamp: no NaN path at all
        moments = _without_safe_eval(moments)
        lo, hi = moments.domain

        def prep(v):
            return jnp.clip(v, lo, hi)
    else:
        def prep(v):
            return v

    out_fns = []
    for lev, fn in enumerate(level_fns):
        def qfn(u, fn=fn, lev=lev):
            fine, coarse = fn(u)
            fine_m = moments.eval_all(prep(fine))
            if lev == 0:
                coarse_m = jnp.zeros_like(fine_m)
            else:
                coarse_m = moments.eval_all(prep(coarse))
            return fine_m, coarse_m

        out_fns.append(qfn)
    return out_fns, list(dims), moments.size


def qmc_level_fns_from_normals(normal_fns: List[Callable], n_normals):
    """Adapt level functions written over standard-normal blocks:
    ``normal_fns[l](z [n, m_l]) -> (fine, coarse)`` — the natural shape
    for GRF/spectral sims whose randomness is a fixed block of normals.

    :return: (level_fns, dims) for :class:`MLQMC`
    """
    if np.isscalar(n_normals):
        n_normals = [int(n_normals)] * len(normal_fns)

    fns = []
    for fn, m in zip(normal_fns, n_normals):
        def qfn(u, fn=fn):
            return fn(sobol.normals_from_uniforms(u))

        fns.append(qfn)
    return fns, [int(m) for m in n_normals]
