"""On-device scrambled Sobol' sequences — the QMC point engine.

The reference framework is plain Monte Carlo end to end (every sampler
seeds a pseudo-random generator: reference mlmc/sampling_pool.py:75-84,
mlmc/sim/synth_simulation.py:78-86); it has no quasi-Monte Carlo story.
This module goes beyond parity: randomized QMC points generated entirely
on device, feeding the MLQMC driver (`mlmc_tpu.qmc`) that reaches a
target estimator variance with far fewer samples on smooth integrands.

Device mapping: Sobol' generation and Owen scrambling are pure 32-bit
integer ops (XOR reductions, bit reversals, wrapping multiplies) — ideal
elementwise device work with no transcendentals and no host round trips. The uniform
floats keep the top 23 bits in f32 (all 32 in f64), strictly inside
(0, 1); normal variates come from a single `ndtri` evaluation per point.

Direction numbers: the generator consumes the Joe-Kuo table that scipy
ships (``scipy.stats.qmc.Sobol`` — data for 21201 dimensions), read once
on the host at setup. Point ``i`` of the sequence is
``XOR_{b set in gray(i)} v[:, b]`` (Antonov-Saleev Gray-code ordering,
matching scipy's draw order bit-for-bit — pinned by tests).

Owen scrambling uses the hash-based nested-uniform scramble (Laine-Karras
construction as refined by Burley, 2020): reverse the bits, apply a
per-dimension seeded avalanche hash whose bit ``b`` depends only on bits
``<= b`` of the input (in reversed order), reverse back. That is exactly
an Owen tree of random flips, evaluated in O(1) per point, and it
preserves the (t, s)-net property — tests assert one point per dyadic
box after scrambling.
"""
import numpy as np
import jax
import jax.numpy as jnp

_MAXBIT = 30  # scipy's Joe-Kuo table stores 30-bit direction numbers

__all__ = [
    "direction_numbers", "sobol_bits", "sobol_uniforms", "sobol_normals",
    "owen_scramble", "scramble_seeds", "uniforms_from_bits",
    "normals_from_uniforms",
]


def direction_numbers(dim):
    """Joe-Kuo direction numbers for ``dim`` dimensions as a [dim, 32]
    uint32 matrix scaled so points are ``bits * 2**-32``.

    Host-side, one scipy call at setup; the result is a device constant.
    """
    if dim < 1:
        raise ValueError("dim must be >= 1, got %r" % (dim,))
    from scipy.stats import qmc as _scipy_qmc

    sob = _scipy_qmc.Sobol(d=int(dim), scramble=False)
    sv = np.asarray(sob._sv, dtype=np.uint64)[:, :_MAXBIT]
    if int(sv.max()).bit_length() > _MAXBIT:
        raise RuntimeError("unexpected scipy Sobol table scale")
    dv = np.zeros((int(dim), 32), dtype=np.uint32)
    dv[:, :_MAXBIT] = (sv << (32 - _MAXBIT)).astype(np.uint32)
    return dv


def _reverse_bits32(x):
    m1 = jnp.uint32(0x55555555)
    m2 = jnp.uint32(0x33333333)
    m4 = jnp.uint32(0x0F0F0F0F)
    m8 = jnp.uint32(0x00FF00FF)
    x = ((x & m1) << 1) | ((x >> 1) & m1)
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    return (x << 16) | (x >> 16)


def _laine_karras(x, seed):
    """Avalanche hash whose output bit b depends only on input bits <= b
    (plus the seed) — a valid nested-uniform scramble in reversed-bit
    order (Burley 2020, 'Practical hash-based Owen scrambling')."""
    x = x + seed
    x = x ^ (x * jnp.uint32(0x6C50B47C))
    x = x ^ (x * jnp.uint32(0xB82F1E52))
    x = x ^ (x * jnp.uint32(0xC7AFE638))
    x = x ^ (x * jnp.uint32(0x8D22F6E6))
    return x


def sobol_bits(dv, start, n):
    """Raw Sobol' integers: points ``start .. start+n`` of the sequence.

    :param dv: [d, 32] uint32 direction numbers (``direction_numbers``)
    :param start: scalar first point index (may be traced)
    :param n: static number of points
    :return: [n, d] uint32, point value = bits * 2**-32
    """
    idx = jnp.uint32(start) + jnp.arange(n, dtype=jnp.uint32)
    gray = idx ^ (idx >> 1)
    acc = jnp.zeros((n, dv.shape[0]), dtype=jnp.uint32)
    for b in range(32):
        take = ((gray >> b) & jnp.uint32(1)).astype(bool)
        acc = acc ^ jnp.where(take[:, None], dv[None, :, b], jnp.uint32(0))
    return acc


def scramble_seeds(key, dim):
    """Independent per-dimension scramble words from one PRNG key."""
    return jax.random.bits(key, (dim,), dtype=jnp.uint32)


def owen_scramble(bits, seeds):
    """Owen-scramble raw Sobol' integers.

    :param bits: [..., d] uint32 points
    :param seeds: [d] uint32 per-dimension scramble words
    """
    x = _reverse_bits32(bits)
    x = _laine_karras(x, seeds)
    return _reverse_bits32(x)


def uniforms_from_bits(bits, dtype=None):
    """Map uint32 points to floats strictly inside (0, 1).

    f32 keeps the top 23 bits: ``top + 0.5`` with ``top < 2^23`` is
    exactly representable, so the centered half-ulp offset survives and
    the range is [2^-24, 1 - 2^-24] — keeping 24 bits would round
    ``(2^24 - 1) + 0.5`` up to ``2^24`` and hand ``u == 1.0`` (an inf)
    to ``ndtri``. f64 keeps all 32 bits.
    """
    dtype = dtype or jnp.result_type(float)
    if jnp.dtype(dtype) == jnp.float64:
        return (bits.astype(jnp.float64) + 0.5) * jnp.float64(2.0 ** -32)
    top = (bits >> 9).astype(jnp.int32).astype(jnp.float32)
    return (top + jnp.float32(0.5)) * jnp.float32(2.0 ** -23)


def normals_from_uniforms(u):
    """Standard normals via the inverse CDF (one transcendental/point)."""
    return jax.scipy.special.ndtri(u)


def sobol_uniforms(dv, start, n, seeds=None, dtype=None):
    """Scrambled (or raw, if ``seeds`` is None) Sobol' uniforms [n, d]."""
    bits = sobol_bits(dv, start, n)
    if seeds is not None:
        bits = owen_scramble(bits, seeds)
    return uniforms_from_bits(bits, dtype=dtype)


def sobol_normals(dv, start, n, seeds=None, dtype=None):
    """Scrambled Sobol' standard normals [n, d]."""
    return normals_from_uniforms(sobol_uniforms(dv, start, n, seeds, dtype))
