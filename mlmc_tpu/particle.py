"""Particle filtering — non-Gaussian sequential inference and the
multilevel particle filter, beyond-reference tier.

Completes the data-assimilation story: :mod:`mlmc_tpu.filter` (EnKF)
assumes near-Gaussian analysis updates; this module is exact for ANY
state-space model as N -> inf. Given

    x_t ~ M_l(. | x_{t-1}),     y_t ~ g(. | x_t),

:func:`particle_filter` is the bootstrap filter (Gordon-Salmond-Smith
1993): propagate a particle population through the model, reweight by
the observation likelihood, and systematically resample when the
effective sample size degenerates. It returns filtered means, the
UNBIASED marginal-likelihood estimate (the quantity particle MCMC
builds on), and island-structured standard errors (resampling couples
particles, so the naive population variance is wrong — same policy as
mlmc_tpu/smc.py).

:func:`multilevel_particle_filter` is the MLPF of Jasra, Kamatani, Law
& Zhou (SIAM J. Numer. Anal. 55, 2017): when the transition kernel is a
discretized SDE, filtered expectations telescope over the
discretization hierarchy

    E_L[phi_t] = E_0[phi_t] + sum_{l=1..L} (E_l[phi_t] - E_{l-1}[phi_t]),

with each correction estimated by a COUPLED pair of particle filters —
shared driving noise in the propagation plus MAXIMALLY COUPLED
systematic resampling (with probability ``sum_i min(w^f_i, w^c_i)``
both filters pick the same ancestor), so fine and coarse particles stay
glued and the correction variance decays at the coupling's strong rate
instead of O(1). Identical fine/coarse kernels give EXACTLY zero
correction (the coupling degenerates to equality) — pinned by test.

Device-first design: the particle population IS the device batch
([islands, m, d] resident in HBM) and each filter pass is ONE jitted
``lax.scan`` over time — per step a batched transition, a vmapped
log-likelihood, softmax/cumsum/searchsorted resampling (static shapes;
adaptive resampling is a ``where``, not a branch) — nothing crosses to
the host until the trajectory statistics are fetched in one transfer.

No reference analogue: GeoMop/MLMC has no sequential-inference
capability (forward UQ only).
"""
import time
from typing import Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.smc import _systematic_resample

__all__ = ["particle_filter", "multilevel_particle_filter"]


def _island_se(vals):
    """Across-island standard error of the island means, last axis
    first: vals [I, ...] -> (mean [...], se [...])."""
    vals = np.asarray(vals, np.float64)
    mean = vals.mean(axis=0)
    n = vals.shape[0]
    se = vals.std(axis=0, ddof=1) / np.sqrt(n) if n > 1 else 0.0 * mean
    return mean, se


def particle_filter(transition: Callable, loglik_obs: Callable, data,
                    n_particles: int, d: int, key=None, x0=None,
                    x0_sampler: Optional[Callable] = None,
                    n_islands: int = 8, ess_threshold: float = 0.5,
                    phi: Optional[Callable] = None, dtype=None,
                    mesh=None):
    """Bootstrap particle filter over ``data`` [T, K].

    :param transition: ``(x [J, d], key, t) -> x' [J, d]`` batched
        stochastic model kernel, pure jnp (same contract as
        :func:`mlmc_tpu.filter.enkf`).
    :param loglik_obs: ``(x [d], y [K]) -> scalar`` per-particle
        observation log-density (vmapped inside).
    :param n_particles: total population; split into ``n_islands``
        independent islands of m = n_particles // n_islands (resampling
        couples particles within an island, so across-island scatter is
        the honest error).
    :param ess_threshold: resample an island when its ESS/m drops below
        this (1.0 = every step, 0.0 = never).
    :param phi: optional ``x [d] -> [q]`` test function; filtered
        ``E[phi(x_t) | y_{1:t}]`` is returned as ``means`` (default
        identity, q = d).
    :param mesh: optional :class:`~mlmc_tpu.parallel.mesh.SampleMesh` —
        islands shard across the devices (``n_islands`` must divide by
        the device count; islands never communicate, so the filter
        scales linearly). Per-shard key streams are salted by the
        device index, so mesh and single-device runs are statistically
        equivalent but not bit-identical.
    :return: dict with ``means`` [T, q] (+ ``means_se``), ``loglik``
        (log-mean of the per-island unbiased likelihood estimates) and
        ``loglik_islands`` [I], ``ess`` [T] (island-mean ESS fraction),
        ``resample_frac``, ``particles`` [I, m, d] + ``log_weights``
        [I, m] final, ``wall_s``.
    """
    if not 0.0 <= ess_threshold <= 1.0:
        raise ValueError("ess_threshold must be in [0, 1]")
    if n_particles % n_islands:
        raise ValueError(f"n_particles={n_particles} must be a "
                         f"multiple of n_islands={n_islands}")
    if mesh is not None and n_islands % mesh.n_devices:
        raise ValueError(f"n_islands={n_islands} must divide by the "
                         f"mesh's {mesh.n_devices} devices")
    m = n_particles // n_islands
    if key is None:
        key = jax.random.key(0)
    dtype = dtype or jnp.asarray(1.0).dtype
    data = jnp.asarray(data, dtype)
    T = data.shape[0]
    k_init, k_run = jax.random.split(key)
    if x0 is None:
        x0 = (x0_sampler(k_init) if x0_sampler is not None
              else jax.random.normal(k_init, (n_particles, d), dtype))
    x0 = jnp.asarray(x0, dtype).reshape(n_islands, m, d)
    phi = phi if phi is not None else (lambda x: x)
    batch_ll = jax.vmap(jax.vmap(loglik_obs, in_axes=(0, None)),
                        in_axes=(0, None))
    batch_phi = jax.vmap(jax.vmap(phi))
    thr = jnp.asarray(ess_threshold, dtype)

    def make_step(n_isl):
        def step(carry, xs):
            x, logw = carry                   # [I, m, d], [I, m] norm.
            y, k, t = xs
            k_prop, k_res = jax.random.split(k)
            x = transition(x.reshape(n_isl * m, d), k_prop, t
                           ).reshape(n_isl, m, d)
            ll = batch_ll(x, y)               # [I, m]
            inc = jax.nn.logsumexp(logw + ll, axis=1)  # [I] evidence
            logw = logw + ll - inc[:, None]
            w = jnp.exp(logw)
            ess = 1.0 / (m * jnp.sum(w * w, axis=1))   # [I] fraction
            mean_t = jnp.einsum("im,imq->iq", w, batch_phi(x))
            do = ess < thr                              # [I]
            u01 = jax.random.uniform(k_res, (n_isl, 1), dtype)
            idx = _systematic_resample(logw, u01, m, dtype)
            x_res = jnp.take_along_axis(x, idx[:, :, None], axis=1)
            x = jnp.where(do[:, None, None], x_res, x)
            logw = jnp.where(do[:, None],
                             jnp.full_like(logw, -np.log(m)), logw)
            return (x, logw), (mean_t, inc, ess, do.astype(dtype))

        return step

    def scan_filter(x0, data, kr, n_isl, mark=lambda z: z):
        logw0 = mark(jnp.full((n_isl, m), -np.log(m), dtype))
        keys = jax.random.split(kr, T)
        (x, logw), (means, incs, ess, resamp) = jax.lax.scan(
            make_step(n_isl), (x0, logw0),
            (data, keys, jnp.arange(T)))
        return x, logw, means, jnp.sum(incs, axis=0), ess, resamp

    if mesh is None:
        run = jax.jit(lambda x0, data: scan_filter(x0, data, k_run,
                                                   n_islands))
    else:
        from jax.sharding import PartitionSpec as P
        try:
            from jax import shard_map
        except ImportError:                           # older jax
            from jax.experimental.shard_map import shard_map
        axis = mesh.axis_name
        n_loc = n_islands // mesh.n_devices

        def mark(z):
            if hasattr(jax.lax, "pcast"):
                return jax.lax.pcast(z, (axis,), to="varying")
            return jax.lax.pvary(z, (axis,))

        def sharded(x0, data):
            kr = jax.random.fold_in(k_run, jax.lax.axis_index(axis))
            return scan_filter(x0, data, kr, n_loc, mark)

        run = jax.jit(shard_map(
            sharded, mesh=mesh.mesh, in_specs=(P(axis), P()),
            out_specs=(P(axis), P(axis), P(None, axis), P(axis),
                       P(None, axis), P(None, axis))))
        x0 = jax.device_put(x0, mesh.batch_sharding())

    t0 = time.perf_counter()
    x, logw, means, ll_isl, ess, resamp = jax.device_get(run(x0, data))
    wall = time.perf_counter() - t0
    means = np.asarray(means, np.float64)           # [T, I, q]
    mean, se = _island_se(np.swapaxes(means, 0, 1))
    ll_isl = np.asarray(ll_isl, np.float64)
    mx = ll_isl.max()
    return {"means": mean, "means_se": se,
            "loglik": float(mx + np.log(np.mean(np.exp(ll_isl - mx)))),
            "loglik_islands": ll_isl,
            "ess": np.asarray(ess).mean(axis=1),
            "resample_frac": float(np.mean(np.asarray(resamp))),
            "particles": np.asarray(x), "log_weights": np.asarray(logw),
            "wall_s": wall}


def _coupled_resample(logwf, logwc, key, m, dtype):
    """Maximally coupled per-island resampling: with probability
    ``alpha = sum_i min(wf_i, wc_i)`` both filters draw the SAME
    ancestor from ``min(wf, wc)/alpha``; otherwise each draws
    independently from its normalized residual (Jasra et al. 2017,
    Sec. 3.1). Marginals are exactly wf / wc either way.

    logwf/logwc [I, m] normalized -> (idxf, idxc) [I, m] each.
    """
    k_b, k_common, k_f, k_c = jax.random.split(key, 4)
    wf = jax.nn.softmax(logwf, axis=1)
    wc = jax.nn.softmax(logwc, axis=1)
    nu = jnp.minimum(wf, wc)                       # [I, m]
    alpha = jnp.sum(nu, axis=1, keepdims=True)     # [I, 1]
    tiny = jnp.asarray(np.finfo(np.dtype(dtype)).tiny, dtype)
    p_common = nu / jnp.maximum(alpha, tiny)
    p_f = (wf - nu) / jnp.maximum(1.0 - alpha, tiny)
    p_c = (wc - nu) / jnp.maximum(1.0 - alpha, tiny)

    def cat(p, k):
        cum = jnp.cumsum(p, axis=1)
        u = jax.random.uniform(k, (p.shape[0], m), dtype)
        idx = jax.vmap(lambda c, uu: jnp.searchsorted(c, uu))(cum, u)
        return jnp.clip(idx, 0, m - 1)

    same = jax.random.uniform(k_b, (alpha.shape[0], m), dtype) < alpha
    idx_common = cat(p_common, k_common)
    idxf = jnp.where(same, idx_common, cat(p_f, k_f))
    idxc = jnp.where(same, idx_common, cat(p_c, k_c))
    return idxf, idxc


def multilevel_particle_filter(
        transition_level: Callable, loglik_obs: Callable, data,
        n_levels: int, d: int, n_particles=4096, key=None,
        x0_sampler: Optional[Callable] = None, n_islands: int = 8,
        phi: Optional[Callable] = None, dtype=None, mesh=None):
    """Multilevel particle filter: telescoped filtered expectations
    ``E_L[phi(x_t) | y_{1:t}]`` over a transition-kernel hierarchy.

    :param transition_level: ``level -> (x [J, d], key, t) -> x' [J, d]``
        factory of batched transition kernels, coarsest level 0. The
        COUPLING at level l >= 1 runs ``transition_level(l)`` and
        ``transition_level(l-1)`` on the SAME key — kernels must consume
        driving noise so that same-key fine/coarse propagations are
        pathwise close (e.g. counter-derived Brownian increments, as in
        mlmc_tpu/sim/sde.py).
    :param n_particles: int (all levels) or per-level sequence — MLPF
        theory wants decaying N_l, e.g. ``N_l ~ N_0 2^{-l}``.
    :param phi: ``x [d] -> [q]`` test function (default identity).
    :param mesh: optional :class:`~mlmc_tpu.parallel.mesh.SampleMesh` —
        each level's islands shard across the devices (see
        :func:`particle_filter`; coupled pairs live on one shard, so
        the coupling needs no collectives).
    :return: dict with ``means`` [T, q] telescoped (+ ``means_se``
        combined across levels in quadrature), ``level_means`` list of
        [T, q] (level 0, then corrections), ``level_ses`` matching,
        ``correction_l1`` [n_levels-1] (time-mean |correction| per
        coupled level, the decay diagnostic), ``loglik`` (level-0
        filter's evidence estimate), ``wall_s``.
    """
    if n_levels < 1:
        raise ValueError("n_levels must be >= 1")
    if key is None:
        key = jax.random.key(0)
    if mesh is not None and n_islands % mesh.n_devices:
        raise ValueError(f"n_islands={n_islands} must divide by the "
                         f"mesh's {mesh.n_devices} devices")
    dtype = dtype or jnp.asarray(1.0).dtype
    n_per = ([int(n_particles)] * n_levels
             if np.isscalar(n_particles) else list(n_particles))
    if len(n_per) != n_levels:
        raise ValueError(f"n_particles gives {len(n_per)} levels, "
                         f"expected {n_levels}")
    data_j = jnp.asarray(data, dtype)
    T = data_j.shape[0]
    phi = phi if phi is not None else (lambda x: x)
    t0 = time.perf_counter()

    k0, key = jax.random.split(jax.random.fold_in(key, 0))
    pf0 = particle_filter(
        transition_level(0), loglik_obs, data_j, n_per[0], d, key=k0,
        x0_sampler=x0_sampler, n_islands=n_islands, ess_threshold=1.0,
        phi=phi, dtype=dtype, mesh=mesh)
    level_means = [pf0["means"]]
    level_ses = [pf0["means_se"]]
    corr_l1 = []

    batch_phi = jax.vmap(jax.vmap(phi))

    for lev in range(1, n_levels):
        if n_per[lev] % n_islands:
            raise ValueError(f"n_particles[{lev}]={n_per[lev]} must be "
                             f"a multiple of n_islands={n_islands}")
        m = n_per[lev] // n_islands
        fine, coarse = transition_level(lev), transition_level(lev - 1)
        batch_ll = jax.vmap(jax.vmap(loglik_obs, in_axes=(0, None)),
                            in_axes=(0, None))

        def make_step(n_isl, fine=fine, coarse=coarse, m=m,
                      batch_ll=batch_ll):
            def step(carry, xs):
                xf, xc = carry
                y, k, t = xs
                k_prop, k_res = jax.random.split(k)
                xf = fine(xf.reshape(n_isl * m, d), k_prop, t
                          ).reshape(n_isl, m, d)
                xc = coarse(xc.reshape(n_isl * m, d), k_prop, t
                            ).reshape(n_isl, m, d)
                logwf = jax.nn.log_softmax(batch_ll(xf, y), axis=1)
                logwc = jax.nn.log_softmax(batch_ll(xc, y), axis=1)
                corr_t = (jnp.einsum("im,imq->iq", jnp.exp(logwf),
                                     batch_phi(xf))
                          - jnp.einsum("im,imq->iq", jnp.exp(logwc),
                                       batch_phi(xc)))
                idxf, idxc = _coupled_resample(logwf, logwc, k_res, m,
                                               dtype)
                xf = jnp.take_along_axis(xf, idxf[:, :, None], axis=1)
                xc = jnp.take_along_axis(xc, idxc[:, :, None], axis=1)
                return (xf, xc), corr_t

            return step

        k_lev = jax.random.fold_in(key, 1000 + lev)

        def scan_level(x0, data, kr, n_isl):
            keys = jax.random.split(kr, T)
            _, corr = jax.lax.scan(make_step(n_isl), (x0, x0),
                                   (data, keys, jnp.arange(T)))
            return corr                                  # [T, I, q]

        if mesh is None:
            run = jax.jit(lambda x0, data: scan_level(
                x0, data, k_lev, n_islands))
        else:
            from jax.sharding import PartitionSpec as P
            try:
                from jax import shard_map
            except ImportError:                          # older jax
                from jax.experimental.shard_map import shard_map
            axis = mesh.axis_name
            n_loc = n_islands // mesh.n_devices

            def sharded(x0, data, k_lev=k_lev, n_loc=n_loc):
                kr = jax.random.fold_in(k_lev,
                                        jax.lax.axis_index(axis))
                return scan_level(x0, data, kr, n_loc)

            run = jax.jit(shard_map(
                sharded, mesh=mesh.mesh, in_specs=(P(axis), P()),
                out_specs=P(None, axis)))

        k_init = jax.random.fold_in(key, 2000 + lev)
        x0 = (x0_sampler(k_init) if x0_sampler is not None
              else jax.random.normal(k_init, (n_per[lev], d), dtype))
        x0 = jnp.asarray(x0, dtype).reshape(n_islands, m, d)
        if mesh is not None:
            x0 = jax.device_put(x0, mesh.batch_sharding())
        corr = np.asarray(jax.device_get(run(x0, data_j)), np.float64)
        mean, se = _island_se(np.swapaxes(corr, 0, 1))
        level_means.append(mean)
        level_ses.append(se)
        corr_l1.append(float(np.mean(np.abs(mean))))

    means = np.sum(level_means, axis=0)
    means_se = np.sqrt(np.sum(np.square(level_ses), axis=0))
    return {"means": means, "means_se": means_se,
            "level_means": level_means, "level_ses": level_ses,
            "correction_l1": np.asarray(corr_l1),
            "loglik": pf0["loglik"],
            "wall_s": time.perf_counter() - t0}
