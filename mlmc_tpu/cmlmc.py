"""Continuation multilevel Monte Carlo (CMLMC) — beyond-reference tier.

Collier, Haji-Ali, Nobile, von Schwerin & Tempone ("A continuation
multilevel Monte Carlo algorithm", BIT 55, 2015): instead of one
adaptive loop at the final accuracy, solve a SEQUENCE of relaxed
tolerances ``eps_i = r_tol^(k-i) * eps`` — each stage re-fits the weak
(alpha), variance (beta) and cost (gamma) rates from everything
measured so far, picks the level count L from the EXTRAPOLATED
remaining bias, and re-allocates optimally. The loose early stages are
cheap and act as self-calibrating pilots for the expensive final one,
so the total work tracks the MLMC complexity theorem without hand-tuned
pilot sizes or a fixed L.

Error contract: ``|bias| + z * se <= eps`` with the split
``bias <= (1 - theta) eps``, ``z * se <= theta eps`` (theta
configurable, 0.5 default; z the CLT confidence factor). The bias at
the chosen L is the Richardson-style extrapolation
``|Y_L| / (r_h^alpha - 1)`` of the fitted geometric decay (the same
identity estimator.richardson_extrapolation uses).

Device-first design: one masked-chunk executable per level with a DYNAMIC
trip count and Kahan-compensated accumulators — the sample-count
operand changes per stage but the compiled program never does (the
fused_driver/unbiased discipline); sample identity is (level, position)
-> fold_in, so stage extensions never redraw.

Level contract (shared with the CDF/risk/unbiased tiers):
``pair_fn(level, keys [C]) -> (fine [C], coarse [C], valid [C])``;
adapt any Simulation via
:func:`mlmc_tpu.cdf_estimate.simulation_pair_fn`.

The reference's adaptive loop (mlmc/sampler.py target-variance
iteration) keeps L FIXED and re-estimates variances only; CMLMC
subsumes it and additionally chooses L and balances bias against
statistical error.
"""
import time
from typing import Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.estimator import estimate_convergence_rates

__all__ = ["cmlmc"]


def _mean_program(pair_fn, level, chunk, dtype, root, mesh=None):
    """One executable per level: Kahan sums of the correction and its
    square over a dynamic number of chunks, one flat fetch. With a
    ``mesh``, each chunk's samples shard across the devices with the
    IDENTICAL sample-index -> key mapping (offset by device position),
    so estimates are bit-reproducible across pod sizes up to the psum
    reduction order."""
    lkey = jax.random.fold_in(root, level)
    is_l0 = level == 0
    sub = chunk if mesh is None else chunk // mesh.n_devices

    def body(c, carry, offset):
        (s, cs), (s2, cs2), nv = carry
        idx = (c * jnp.uint32(chunk) + offset
               + jnp.arange(sub, dtype=jnp.uint32))
        keys = jax.vmap(lambda i: jax.random.fold_in(lkey, i))(idx)
        fine, coarse, valid = pair_fn(level, keys)
        d = fine.astype(dtype)
        valid = valid & jnp.isfinite(d)
        if not is_l0:
            c_ = coarse.astype(dtype)
            valid = valid & jnp.isfinite(c_)
            d = d - c_
        d = jnp.where(valid, d, 0.0)
        out = []
        for acc, comp, x in ((s, cs, jnp.sum(d)),
                             (s2, cs2, jnp.sum(d * d))):
            y = x - comp
            t = acc + y
            out.append((t, (t - acc) - y))
        return out[0], out[1], nv + jnp.sum(valid).astype(jnp.uint32)

    if mesh is None:
        @jax.jit
        def run(start, n_chunks):
            z = jnp.zeros((), dtype)
            (s, cs), (s2, cs2), nv = jax.lax.fori_loop(
                start, start + n_chunks,
                lambda c, carry: body(c, carry, jnp.uint32(0)),
                ((z, z), (z, z), jnp.zeros((), jnp.uint32)))
            return jnp.stack([s, s2, nv.astype(dtype)])

        return run

    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:                            # older jax
        from jax.experimental.shard_map import shard_map
    axis = mesh.axis_name

    def mark(z):
        # fori_loop carries become device-varying after the first chunk
        if hasattr(jax.lax, "pcast"):
            return jax.lax.pcast(z, (axis,), to="varying")
        return jax.lax.pvary(z, (axis,))

    def sharded(start, n_chunks):
        offset = (jax.lax.axis_index(axis).astype(jnp.uint32)
                  * jnp.uint32(sub))
        z = mark(jnp.zeros((), dtype))
        (s, cs), (s2, cs2), nv = jax.lax.fori_loop(
            start, start + n_chunks,
            lambda c, carry: body(c, carry, offset),
            ((z, z), (z, z), mark(jnp.zeros((), jnp.uint32))))
        return jnp.stack([
            jax.lax.psum(s - cs, axis),
            jax.lax.psum(s2 - cs2, axis),
            jax.lax.psum(nv, axis).astype(dtype)])

    return jax.jit(shard_map(sharded, mesh=mesh.mesh,
                             in_specs=(P(), P()), out_specs=P()))


def cmlmc(pair_fn: Callable, level_steps: Sequence[float], eps: float,
          theta: float = 0.5, z: float = 2.0, r_tol: float = 2.0,
          n_stages: int = 4, seed: int = 0,
          cost_fn: Optional[Callable] = None, chunk_size: int = 1 << 12,
          n_pilot: int = 1 << 12, min_levels: int = 2,
          alpha_floor: float = 0.25, dtype=None, mesh=None):
    """Run the continuation algorithm to total error ``eps``.

    :param pair_fn: level contract above, pure jnp.
    :param mesh: optional :class:`~mlmc_tpu.parallel.mesh.SampleMesh` —
        each chunk's samples shard across the devices (chunk_size must
        divide by the device count) with one psum per level extension;
        the sample-index -> key mapping is device-count-invariant.
    :param level_steps: discretization steps ``h_l`` of the AVAILABLE
        hierarchy, finest last — the driver activates a prefix of it.
    :param eps: final error target for ``|bias| + z * se``.
    :param theta: error split (bias share ``1 - theta``).
    :param z: CLT confidence factor on the statistical half.
    :param r_tol / n_stages: tolerance sequence
        ``eps * r_tol^(n_stages - 1 - i)``, i = 0..n_stages-1.
    :param cost_fn: optional ``level -> relative cost``; measured wall
        per sample otherwise.
    :param alpha_floor: lower bound for the fitted weak rate (guards
        the bias extrapolation against noisy early fits — Collier et
        al. use a Bayesian prior to the same effect).
    :return: dict with ``mean``, ``bias`` (extrapolated remainder),
        ``se``, ``error_bound`` (|bias| + z se), ``n_levels``,
        ``n_per_level``, ``level_means``, ``level_vars``, ``rates``,
        ``stage_history``, ``n_forward``, ``wall_s``.
    """
    h = np.asarray(level_steps, np.float64).ravel()
    max_l = len(h)
    if max_l < 2:
        raise ValueError("need at least a 2-level hierarchy")
    if np.any(h[1:] >= h[:-1]):
        raise ValueError("level_steps must decrease (finest last)")
    if not 0.0 < theta < 1.0:
        raise ValueError("theta must be in (0, 1)")
    if eps <= 0:
        raise ValueError("eps must be positive")
    if mesh is not None and chunk_size % mesh.n_devices:
        raise ValueError(
            "chunk_size=%d must divide by the mesh's %d devices"
            % (chunk_size, mesh.n_devices))
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    root = jax.random.key(seed)
    programs = [_mean_program(pair_fn, lv, chunk_size, dtype, root,
                              mesh=mesh)
                for lv in range(max_l)]
    sums = np.zeros(max_l)
    sums2 = np.zeros(max_l)
    nval = np.zeros(max_l)
    ndrawn = np.zeros(max_l, dtype=np.int64)
    elapsed = np.zeros(max_l)
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

    def stats(L):
        n = np.maximum(nval[:L], 1.0)
        m = sums[:L] / n
        v = np.maximum(sums2[:L] / n - m * m, 1e-300)
        return m, v

    def costs(L):
        if cost_fn is not None:
            return np.array([cost_fn(lv) for lv in range(L)])
        return np.maximum(elapsed[:L] / np.maximum(ndrawn[:L], 1),
                          1e-12)

    # bootstrap: pilot the minimal hierarchy
    L = max(min_levels, 2)
    for lv in range(L):
        extend(lv, n_pilot)

    history = []
    for stage in range(n_stages):
        eps_i = eps * r_tol ** (n_stages - 1 - stage)
        m, v = stats(L)
        rates = estimate_convergence_rates(m, v, h[:L])
        alpha = rates["alpha"]
        if not np.isfinite(alpha) or alpha < alpha_floor:
            alpha = alpha_floor
        r_h = float(h[L - 2] / h[L - 1])
        # grow L until the extrapolated remaining bias fits the split;
        # predict |Y_L| for candidate levels from the fitted decay
        y_last = abs(m[L - 1])
        while (y_last / (r_h ** alpha - 1.0) > (1 - theta) * eps_i
               and L < max_l):
            ratio = float(h[L] / h[L - 1])
            y_last = y_last * ratio ** alpha
            L += 1
            if ndrawn[L - 1] == 0:
                extend(L - 1, n_pilot)
            m, v = stats(L)
            if np.isfinite(m[L - 1]) and nval[L - 1] > 0:
                y_last = abs(m[L - 1])     # replace prediction
            r_h = float(h[L - 2] / h[L - 1])
        # optimal allocation for the statistical half
        m, v = stats(L)
        c = costs(L)
        target_var = (theta * eps_i / z) ** 2
        lam = np.sum(np.sqrt(v * c)) / target_var
        n_opt = np.ceil(lam * np.sqrt(v / c)).astype(np.int64)
        for lv in range(L):
            extend(lv, n_opt[lv] - ndrawn[lv])
        m, v = stats(L)
        se = float(np.sqrt(np.sum(v / np.maximum(nval[:L], 1.0))))
        bias = float(abs(m[L - 1]) / (r_h ** alpha - 1.0))
        history.append(dict(eps=eps_i, n_levels=L, alpha=float(alpha),
                            beta=float(rates["beta"]), se=se,
                            bias=bias,
                            n_per_level=ndrawn[:L].copy()))

    m, v = stats(L)
    rates = estimate_convergence_rates(m, v, h[:L], n_ops=costs(L))
    se = float(np.sqrt(np.sum(v / np.maximum(nval[:L], 1.0))))
    alpha = rates["alpha"]
    if not np.isfinite(alpha) or alpha < alpha_floor:
        alpha = alpha_floor
    bias = float(abs(m[L - 1]) / ((h[L - 2] / h[L - 1]) ** alpha - 1.0))
    bias_target_met = bias <= (1 - theta) * eps * 1.05
    if not bias_target_met:
        import warnings
        warnings.warn(
            f"CMLMC exhausted the {max_l}-level hierarchy with "
            f"extrapolated bias {bias:.3g} > the (1-theta)*eps = "
            f"{(1 - theta) * eps:.3g} budget — extend level_steps or "
            "loosen eps; the returned error_bound is honest",
            RuntimeWarning)
    return {"mean": float(np.sum(m)), "bias": bias, "se": se,
            "error_bound": bias + z * se, "n_levels": L,
            "bias_target_met": bool(bias_target_met),
            "n_per_level": ndrawn[:L].copy(),
            "level_means": m, "level_vars": v, "rates": rates,
            "stage_history": history,
            "n_forward": int(ndrawn.sum()),
            "wall_s": time.perf_counter() - t0}
