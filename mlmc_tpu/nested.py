"""Nested-expectation MLMC (EVPPI / conditional-expectation functionals)
— beyond-reference tier.

Quantities of the form

    ``theta = E_Y[ g( E_X[ f(X, Y) | Y ] ) ]``

(expected value of partial perfect information, probability of a
conditional expectation exceeding a threshold, CVA-style nested risk
measures) defeat plain Monte Carlo: the inner expectation must itself be
sampled, and for nonlinear ``g`` the inner noise leaks O(1/N) bias into
the outer average, driving naive cost to O(eps^-3) or worse.

MLMC over the INNER sample count fixes the economics (Giles, "MLMC for
nested expectations", 2018; Giles & Goda, "Decision-making under
uncertainty: using MLMC for efficient estimation of EVPPI", Stat.
Comput. 29, 2019): level l gives each outer sample ``N_l = n0 2^l``
inner draws, and the ANTITHETIC correction

    ``Delta_l = g(mean of N_l) - (g(mean of first half)
                                  + g(mean of second half)) / 2``

is self-coupled — both terms consume the same inner draws, so smooth
``g`` gives ``V_l ~ N_l^-2`` (beta = 2) and the kinked ``max(0, .)`` of
EVPPI gives beta ~ 1.5, against gamma = 1 cost growth: O(eps^-2)
overall. For ``g = identity`` the correction is EXACTLY zero — the
telescope collapses to the unnested estimator (pinned by test).

The construction emits the standard ``fn(level, keys [C]) -> Delta_l``
contract, so every Delta-driver in the package applies unchanged:

* :class:`~mlmc_tpu.unbiased.UnbiasedMLMC` — randomized truncation
  gives an UNBIASED nested estimator (Goda, Hironaka & Iwamoto 2020),
* :class:`~mlmc_tpu.mimc.MIMC` with the 1-D prefix-coupled VALUE form
  (:func:`nested_value_fn`) — a truncated adaptive driver with its
  boundary-bias surrogate,
* both mesh-shard via their ``mesh=`` options.

Device-first: the [C, N_l] inner block evaluates inside the driver's
chunk-loop executable (pure vmapped work, one executable per level);
above ``block`` inner draws the level function accumulates half-sums
over static-size blocks instead of materializing [C, N_l], bounding
memory at any depth.

Contract: ``inner_fn(outer_keys [C], inner_offsets [n] uint32) ->
[C, n]`` pure jnp — the outer scenario Y derives from the key, inner
draw j from ``fold_in(key, 1 + offset_j)`` (or any scheme where the
same (key, offset) reproduces the same draw). Multi-decision problems
return [C, n, D] and reduce through ``g`` over per-decision means.
"""
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["nested_level_fn", "nested_value_fn", "g_max0", "evppi_level_fn",
           "gaussian_information_fn", "evppi_gaussian_exact"]


def g_max0(m):
    """The EVPPI outer functional ``max(0, m)`` (elementwise)."""
    return jnp.maximum(m, 0.0)


def _half_means(inner_fn, keys, N, block):
    """(mean of all N, mean of first half, mean of second half) per
    outer key, accumulating static-size blocks through a fori_loop —
    [C, block] is the largest live intermediate and the trace stays one
    block body at any level."""
    if N == 1:
        v = inner_fn(keys, jnp.zeros((1,), jnp.uint32))
        m = jnp.sum(v, axis=1)
        return m, m, m
    half = N // 2
    blk = min(block, half)
    if half % blk:
        blk = half                      # tiny levels: one block per half
    n_blocks = half // blk

    def block_sum(start):
        offs = start + jnp.arange(blk, dtype=jnp.uint32)
        return jnp.sum(inner_fn(keys, offs), axis=1)

    def half_sum(base):
        first = block_sum(jnp.uint32(base))
        if n_blocks == 1:
            return first

        def body(i, carry):
            # Kahan-compensated: thousands of block sums accumulate at
            # deep levels and the correction scale is ~1/N — far below
            # ulp of a naive f32 running sum
            acc, comp = carry
            x = block_sum(jnp.uint32(base)
                          + i.astype(jnp.uint32) * jnp.uint32(blk))
            y = x - comp
            t = acc + y
            return t, (t - acc) - y

        acc, comp = jax.lax.fori_loop(1, n_blocks, body,
                                      (first, jnp.zeros_like(first)))
        return acc - comp

    sa = half_sum(0)
    sb = half_sum(half)
    return (sa + sb) / N, sa / half, sb / half


def nested_level_fn(inner_fn: Callable, g: Callable = g_max0,
                    n0: int = 2, block: int = 1024):
    """Antithetic nested-MLMC correction function.

    :param inner_fn: ``(outer_keys [C], inner_offsets [n]) -> [C, n]``
        (or ``[C, n, D]`` for multi-decision problems — ``g`` then maps
        the [C, D] decision means to [C])
    :param g: outer functional applied to inner means (default
        :func:`g_max0`; must be pure jnp, vectorized over [C] or [C, D])
    :param n0: inner draws at level 0 (must be even or 1-at-level-0
        semantics apply: level 0 uses ``n0`` draws, corrections start at
        level 1)
    :param block: static inner block size bounding [C, block] memory
    :return: ``fn(level, keys) -> Delta_l`` for any Delta-driver
    """
    n0 = int(n0)
    if n0 < 1:
        raise ValueError("need n0 >= 1")
    if n0 > 1 and n0 % 2:
        raise ValueError("n0 must be 1 or even (antithetic halves)")

    def fn(level, keys):
        N = n0 << level
        m_all, m_a, m_b = _half_means(inner_fn, keys, N, block)
        if level == 0:
            return g(m_all)
        return g(m_all) - 0.5 * (g(m_a) + g(m_b))

    return fn


def nested_value_fn(inner_fn: Callable, g: Callable = g_max0,
                    n0: int = 2, block: int = 1024):
    """Prefix-coupled VALUE form ``F_l = g(mean of first n0 2^l inner
    draws)`` for drivers that difference values themselves (e.g. 1-D
    :class:`~mlmc_tpu.mimc.MIMC`): consecutive levels share the inner
    draw prefix through the (key, offset) contract, giving the
    non-antithetic Giles 2018 coupling (beta ~ 1 for kinked g — prefer
    :func:`nested_level_fn` when the driver accepts corrections).

    :return: ``f(alpha, keys) -> [C]`` (alpha a 1-tuple) for MIMC
    """
    n0 = int(n0)
    if n0 < 1:
        raise ValueError("need n0 >= 1")

    def fn(alpha, keys):
        (level,) = tuple(alpha)
        N = n0 << level
        m_all, _, _ = _half_means(inner_fn, keys, N, block)
        return g(m_all)

    return fn


def evppi_level_fn(inner_fn: Callable, n0: int = 2, block: int = 1024):
    """EVPPI correction function for multi-decision problems: inner_fn
    returns [C, n, D] per-decision values; the outer functional is
    ``max_d`` of the D decision means (Giles & Goda 2019). The
    information value itself is ``E[max_d E[f_d|Y]] - max_d E[f_d]`` —
    estimate the first term with this function and subtract the plain
    means (a by-product of any level-0 run).
    """

    def g(m):
        if m.ndim != 2:
            raise ValueError(
                "evppi_level_fn expects multi-decision inner values "
                "[C, n, D]; the inner_fn returned per-key means of rank "
                "%d — for a scalar decision use nested_level_fn(g=g_max0)"
                % m.ndim)
        return jnp.max(m, axis=-1)

    return nested_level_fn(inner_fn, g=g, n0=n0, block=block)


# ---------------------------------------------------------------------- #
# validation fixture: jointly Gaussian information problem
# ---------------------------------------------------------------------- #
def gaussian_information_fn(sigma_y=1.0, sigma_x=2.0, mu=0.0):
    """The canonical closed-form nested problem: ``f(X, Y) = mu + Y + X``
    with ``Y ~ N(0, sigma_y^2)`` (the information) and
    ``X ~ N(0, sigma_x^2)`` (residual noise), so

        ``E[f | Y] = mu + Y``
        ``E[max(0, E[f|Y])] = mu Phi(mu/sigma_y)
                              + sigma_y phi(mu/sigma_y)``

    (:func:`evppi_gaussian_exact`). The outer key draws Y; inner offset
    j draws ``X_j = sigma_x * normal(fold_in(key, 1 + j))``.

    :return: inner_fn for :func:`nested_level_fn`
    """

    def inner_fn(keys, offsets):
        def one(k):
            y = sigma_y * jax.random.normal(jax.random.fold_in(k, 0))
            xs = jax.vmap(lambda o: jax.random.normal(
                jax.random.fold_in(k, 1 + o)))(offsets)
            return mu + y + sigma_x * xs

        return jax.vmap(one)(keys)

    return inner_fn


def evppi_gaussian_exact(sigma_y=1.0, mu=0.0):
    """``E[max(0, mu + Y)]`` for ``Y ~ N(0, sigma_y^2)``."""
    import scipy.stats as st

    z = mu / sigma_y
    return float(mu * st.norm.cdf(z) + sigma_y * st.norm.pdf(z))
