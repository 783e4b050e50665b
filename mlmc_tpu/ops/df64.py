"""Double-float (two-f32) arithmetic.

A double-float ("df") number is an unevaluated pair of f32s ``(hi, lo)``
with ``hi = fl(hi + lo)``, carrying ~49 significant bits — enough to track
an all-f64 computation to ~1e-14 relative per operation while every
operation stays float32.

This module is the shared primitive layer:

* error-free transforms: ``two_sum`` (Knuth), ``fast_two_sum`` (Dekker),
  ``two_prod`` via 12-bit Dekker splits — branch-free, contraction-safe
  (an FMA formed by the compiler only sharpens the error terms),
* df ring ops (``df_add``/``df_sub``/``df_mul``/``df_div`` and the
  exact-f32-operand shortcuts), accurate to ~2^-48 relative,
* pairwise-halving reductions and dot products along an axis,
* ``df_exp``: range-reduced Taylor evaluation in df arithmetic with an
  EXACT power-of-two rescale (bit-constructed, no transcendental
  ``exp2``), ~1e-13 relative over |x| <= 80,
* host-side f64 <-> df conversion helpers.

Everything is plain jnp and runs identically under jit on every backend.
Division is safe on hardware with approximate dividers: the quotient is
refined from an exactly-computed remainder.

The library uses ``two_sum`` for the compensated float32 sums of the QMC
and sensitivity drivers (qmc.py, sensitivity.py); the df ring, reductions,
``df_exp`` and ``df_sincos`` are tested building blocks with no caller in
the estimation path.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp


# ------------------------------------------------------------------ #
# error-free transformations
#
# EFT identities assume every written step is ONE correctly-rounded f32
# operation. XLA's CPU pipeline violates that in two ways (measured, see
# tests/test_df64.py::test_eft_survives_fusion_composition):
#
# * cheap values (a product, a rounded sum) are REMATERIALIZED into each
#   consumer fusion, and the backend contracts a recomputed mul feeding
#   an add into an FMA — so the "same" HLO value takes DIFFERENT numeric
#   values at different use sites, silently breaking the (hi, lo) pair
#   (observed: 1-ulp-of-hi errors, ~3e-8 relative, in a df square the
#   moment a second consumer fusion appears);
# * ``lax.optimization_barrier`` and every value-preserving laundering
#   (x+0, min(x, inf), bitcast round-trips) are stripped before fusion,
#   so none of them help.
#
# The fix: snap each EFT-critical intermediate (the product p, the split
# anchor c, the rounded sum s) through ``lax.reduce_precision(x, 8, 23)``
# — numerically the identity on every f32 value (full exponent + full
# mantissa, NaN/inf/denormal preserving) but opaque to the simplifier
# and the contraction pass, pinning those values to one set of bits.
# Every other step is adds/subs of already-pinned values (contraction
# needs a mul operand) or an error-magnitude term where a sharper FMA
# is harmless.
# ------------------------------------------------------------------ #
def _snap(x):
    """Identity on every f32 value, opaque to XLA (see note above)."""
    return jax.lax.reduce_precision(x, exponent_bits=8, mantissa_bits=23)


def _build_eft(snap):
    """Build the EFT + df ring namespace with ``snap`` pinning the
    EFT-critical intermediates."""

    def two_sum(a, b):
        """Exact addition: fl(a+b) plus its rounding error (Knuth)."""
        s = snap(a + b)
        bb = s - a
        return s, (a - (s - bb)) + (b - bb)

    def fast_two_sum(a, b):
        """Exact addition assuming |a| >= |b|."""
        s = snap(a + b)
        return s, b - (s - a)

    def split12(a):
        """Dekker split into 12-bit halves."""
        c = snap(a * 4097.0)
        ah = c - (c - a)
        return ah, a - ah

    def two_prod(a, b):
        """Exact product: fl(a*b) plus its rounding error (Dekker; an FMA
        contraction of any sub-term only makes the error term sharper)."""
        p = snap(a * b)
        ah, al = split12(a)
        bh, bl = split12(b)
        return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl

    def df_add(ahi, alo, bhi, blo):
        """df + df (Joldes et al. accurate DW+DW, ~2^-48 relative)."""
        sh, sl = two_sum(ahi, bhi)
        th, tl = two_sum(alo, blo)
        vh, vl = fast_two_sum(sh, sl + th)
        return fast_two_sum(vh, vl + tl)

    def df_neg(hi, lo):
        return -hi, -lo

    def df_sub(ahi, alo, bhi, blo):
        return df_add(ahi, alo, -bhi, -blo)

    def df_mul(ahi, alo, bhi, blo):
        """df * df (products of the lows dropped: O(2^-49) relative)."""
        p, e = two_prod(ahi, bhi)
        return fast_two_sum(p, e + (ahi * blo + alo * bhi))

    def df_mul_f32(ahi, alo, c):
        """df * exact-f32 scalar."""
        p, e = two_prod(ahi, c)
        return fast_two_sum(p, e + alo * c)

    def df_div_f32(ahi, alo, c):
        """df / exact-f32 scalar via one Newton correction step.

        Tolerates an approximate hardware divider: the initial quotient's
        remainder is computed exactly (two_prod) and re-divided once."""
        q0 = snap(ahi / c)
        p, e = two_prod(q0, c)
        r_hi, r_lo = df_add(ahi, alo, -p, -e)
        return fast_two_sum(q0, (r_hi + r_lo) / c)

    def df_div(ahi, alo, bhi, blo):
        """df / df via quotient refinement from the exact remainder."""
        q0 = snap(ahi / bhi)
        p, e = two_prod(q0, bhi)
        r_hi, r_lo = df_add(ahi, alo, -p, -e)
        r = (r_hi + r_lo) - q0 * blo
        return fast_two_sum(q0, r / bhi)

    import types as _types

    return _types.SimpleNamespace(
        two_sum=two_sum, fast_two_sum=fast_two_sum, split12=split12,
        two_prod=two_prod, df_add=df_add, df_neg=df_neg, df_sub=df_sub,
        df_mul=df_mul, df_mul_f32=df_mul_f32, df_div_f32=df_div_f32,
        df_div=df_div)


_default = _build_eft(_snap)

two_sum = _default.two_sum
fast_two_sum = _default.fast_two_sum
split12 = _default.split12
two_prod = _default.two_prod
df_add = _default.df_add
df_neg = _default.df_neg
df_sub = _default.df_sub
df_mul = _default.df_mul
df_mul_f32 = _default.df_mul_f32
df_div_f32 = _default.df_div_f32
df_div = _default.df_div


# ------------------------------------------------------------------ #
# reductions
# ------------------------------------------------------------------ #
def _pow2_at_least(n):
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def df_sum(hi, lo, axis=-1):
    """df reduction along ``axis`` as ONE variadic ``lax.reduce`` whose
    combiner is a df add.

    A hand-built halving tree of sliced df_adds triggers pathological
    XLA:CPU compile/runtime behavior when composed with a non-trivial
    producer (measured 30 ms / compile hangs vs 0.1 ms for this form on a
    [256] reduction fed by an exp chain; optimization_barrier does not
    help). The variadic reduce is a single HLO op, so fusion heuristics
    never see the tree. XLA may apply the combiner in any association;
    df_add keeps ~2^-48 relative error per fold in every order, so the
    result error is bounded the same way (n*2^-48*max|term| worst case,
    random-sign in practice)."""
    zero = jnp.zeros((), dtype=hi.dtype)

    def comb(a, b):
        return df_add(a[0], a[1], b[0], b[1])

    return jax.lax.reduce((hi, lo), (zero, zero), comb, (axis % hi.ndim,))


def df_sum_pairwise(hi, lo, axis=-1):
    """Deterministic pairwise-halving df reduction (zero-padded to a
    power of two). Bit-reproducible association; prefer ``df_sum`` in
    compiled code (see its note on XLA pathology)."""
    hi = jnp.moveaxis(hi, axis, -1)
    lo = jnp.moveaxis(lo, axis, -1)
    n = hi.shape[-1]
    m = _pow2_at_least(n)
    if m != n:
        pad = [(0, 0)] * (hi.ndim - 1) + [(0, m - n)]
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
    while m > 1:
        half = m // 2
        hi, lo = df_add(hi[..., :half], lo[..., :half],
                        hi[..., half:], lo[..., half:])
        m = half
    return hi[..., 0], lo[..., 0]


def df_dot(ahi, alo, bhi, blo, axis=-1):
    """df dot product along ``axis`` (broadcasting elementwise df_mul,
    then a pairwise df reduction)."""
    ph, plo = df_mul(ahi, alo, bhi, blo)
    return df_sum(ph, plo, axis=axis)


# ------------------------------------------------------------------ #
# exponential
# ------------------------------------------------------------------ #
_LN2 = float(np.log(np.float64(2.0)))
_LN2_HI = float(np.float32(_LN2))
_LN2_LO = float(np.float64(_LN2) - np.float64(np.float32(_LN2)))
_INV_LN2 = float(np.float32(1.0 / _LN2))
#: Taylor coefficients 1/12! .. 1/0! as df pairs (Horner order)
_EXP_COEFS = [
    (float(np.float32(1.0 / math.factorial(k))),
     float(np.float64(1.0 / math.factorial(k))
           - np.float64(np.float32(1.0 / math.factorial(k)))))
    for k in range(12, -1, -1)
]


def _exact_pow2(k):
    """2^k for integer-valued f32 k in [-126, 127], constructed from the
    exponent bits (a backend's exp2 may approximate; this is exact)."""
    ki = k.astype(jnp.int32)
    return jax.lax.bitcast_convert_type((ki + 127) << 23, jnp.float32)


def df_exp(hi, lo, clip=80.0):
    """exp of a df argument, ~1e-13 relative over clipped |x| <= ``clip``.

    Range reduction x = k*ln2 + r with a df ln2 (both products exact via
    two_prod), degree-12 df Taylor on |r| <= ln2/2 (tail < 2^-52), exact
    2^k rescale. Arguments beyond +-clip saturate (their lo is dropped);
    80 keeps every intermediate far from f32 overflow — the maxent solver
    caps its exponents the same way the reference clips to +-200
    (reference simple_distribution.py:104), and converged densities live
    at O(1) exponents.

    Relative accuracy degrades for results below ~1e-26 (the lo limb
    underflows into f32 denormals; measured 6e-8 relative at exp(-80)) —
    ABSOLUTE error stays tiny (< 1e-33), which is what integral
    accumulation needs from the far tails.
    """
    clip = jnp.float32(clip)
    out_of_range = (hi > clip) | (hi < -clip)
    hi = jnp.clip(hi, -clip, clip)
    lo = jnp.where(out_of_range, jnp.float32(0.0), lo)

    k = jnp.round(hi * jnp.float32(_INV_LN2))
    p1, e1 = two_prod(k, jnp.float32(_LN2_HI))
    p2, e2 = two_prod(k, jnp.float32(_LN2_LO))
    r_hi, r_lo = df_add(hi, lo, -p1, -e1)
    r_hi, r_lo = df_add(r_hi, r_lo, -p2, -e2)

    c0 = _EXP_COEFS[0]
    acc_hi = jnp.full_like(r_hi, jnp.float32(c0[0]))
    acc_lo = jnp.full_like(r_hi, jnp.float32(c0[1]))
    for c_hi, c_lo in _EXP_COEFS[1:]:
        acc_hi, acc_lo = df_mul(acc_hi, acc_lo, r_hi, r_lo)
        acc_hi, acc_lo = df_add(acc_hi, acc_lo,
                                jnp.full_like(r_hi, jnp.float32(c_hi)),
                                jnp.full_like(r_hi, jnp.float32(c_lo)))
    s = _exact_pow2(k)
    return acc_hi * s, acc_lo * s


# ------------------------------------------------------------------ #
# trigonometry
# ------------------------------------------------------------------ #
_PI2 = float(np.pi / 2)
_PI2_A = float(np.float32(_PI2))
_PI2_B = float(np.float32(np.float64(_PI2) - np.float64(np.float32(_PI2))))
_PI2_C = float(np.float64(_PI2) - np.float64(_PI2_A) - np.float64(_PI2_B))
_INV_PI2 = float(np.float32(2.0 / np.pi))


def _df_coef_table(values):
    return [(float(np.float32(v)),
             float(np.float64(v) - np.float64(np.float32(v))))
            for v in values]


#: sin(r)/r = sum (-1)^n r^2n / (2n+1)!  (Horner order, highest first)
_SIN_COEFS = _df_coef_table(
    [(-1.0) ** n / math.factorial(2 * n + 1) for n in range(8, -1, -1)])
#: cos(r)   = sum (-1)^n r^2n / (2n)!
_COS_COEFS = _df_coef_table(
    [(-1.0) ** n / math.factorial(2 * n) for n in range(9, -1, -1)])


def _df_horner_x2(coefs, x2_hi, x2_lo):
    acc_hi = jnp.full_like(x2_hi, jnp.float32(coefs[0][0]))
    acc_lo = jnp.full_like(x2_hi, jnp.float32(coefs[0][1]))
    for c_hi, c_lo in coefs[1:]:
        acc_hi, acc_lo = df_mul(acc_hi, acc_lo, x2_hi, x2_lo)
        acc_hi, acc_lo = df_add(acc_hi, acc_lo,
                                jnp.full_like(x2_hi, jnp.float32(c_hi)),
                                jnp.full_like(x2_hi, jnp.float32(c_lo)))
    return acc_hi, acc_lo


def df_sincos(hi, lo):
    """(sin, cos) of a df argument to ~2^-44 relative, |x| <= ~1e4.

    Triple-limb pi/2 range reduction (the quadrant count k stays exactly
    representable and both two_prods are exact; the third limb rides as a
    plain product, error O(k * 2^-72)), degree-17/18 df Taylor on
    |r| <= pi/4, quadrant swap by k mod 4. Uses only mul/add/round/where
    — independent of whether a backend's transcendentals are correctly
    rounded.

    :return: ((sin_hi, sin_lo), (cos_hi, cos_lo))
    """
    k = jnp.round(hi * jnp.float32(_INV_PI2))
    p1, e1 = two_prod(k, jnp.float32(_PI2_A))
    p2, e2 = two_prod(k, jnp.float32(_PI2_B))
    r_hi, r_lo = df_add(hi, lo, -p1, -e1)
    r_hi, r_lo = df_add(r_hi, r_lo, -p2, -e2)
    r_hi, r_lo = fast_two_sum(r_hi, r_lo - k * jnp.float32(_PI2_C))

    x2_hi, x2_lo = df_mul(r_hi, r_lo, r_hi, r_lo)
    s_hi, s_lo = _df_horner_x2(_SIN_COEFS, x2_hi, x2_lo)
    s_hi, s_lo = df_mul(s_hi, s_lo, r_hi, r_lo)   # sin(r) = r * S(r^2)
    c_hi, c_lo = _df_horner_x2(_COS_COEFS, x2_hi, x2_lo)

    q = jnp.mod(k, jnp.float32(4.0))

    def pick(q0, q1, q2, q3):
        return jnp.where(q == 0, q0, jnp.where(q == 1, q1,
                         jnp.where(q == 2, q2, q3)))

    sin = (pick(s_hi, c_hi, -s_hi, -c_hi), pick(s_lo, c_lo, -s_lo, -c_lo))
    cos = (pick(c_hi, -s_hi, -c_hi, s_hi), pick(c_lo, -s_lo, -c_lo, s_lo))
    return sin, cos


# ------------------------------------------------------------------ #
# host-side conversions
# ------------------------------------------------------------------ #
def df_split_array(x):
    """Split a host f64 array into (hi, lo) f32 numpy arrays."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def df_to_f64(hi, lo):
    """Recombine a df pair into a host f64 array."""
    return np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)
