"""Double-float (two-f32) arithmetic library tests.

The df layer (mlmc_tpu/ops/df64.py) backs the double-float SDE path
accumulation and the compensated f32 sums of the QMC/sensitivity drivers;
these tests pin every primitive against f64 on CPU (the ops are plain
IEEE f32 add/mul/div, identical on every backend — transcendentals, whose
rounding a backend need not get right, are never used).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mlmc_tpu.ops import df64


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(1234)


def _split(x):
    return tuple(map(jnp.asarray, df64.df_split_array(x)))


def test_df_split_roundtrip(rng):
    x = rng.standard_normal(1000) * np.exp(rng.uniform(-20, 20, 1000))
    hi, lo = df64.df_split_array(x)
    rel = np.abs(df64.df_to_f64(hi, lo) - x) / np.abs(x)
    assert rel.max() < 2**-48


def test_df_mul_div_accuracy(rng):
    a = rng.standard_normal(5000) * 10
    b = rng.standard_normal(5000) + 3.0
    ah, al = _split(a)
    bh, bl = _split(b)
    ph, plo = jax.jit(df64.df_mul)(ah, al, bh, bl)
    rel = np.abs(df64.df_to_f64(ph, plo) - a * b) / np.abs(a * b)
    assert rel.max() < 1e-13
    qh, ql = jax.jit(df64.df_div)(ah, al, bh, bl)
    rel = np.abs(df64.df_to_f64(qh, ql) - a / b) / np.abs(a / b)
    assert rel.max() < 1e-13


def test_df_exp_accuracy(rng):
    # relative accuracy holds while the result's lo limb stays a NORMAL
    # f32 (results >= ~1e-26, i.e. arguments >= ~-58); further down the lo
    # limb underflows gradually and only absolute accuracy remains
    # (documented in df_exp)
    x = rng.uniform(-55, 80, 20000)
    eh, el = jax.jit(df64.df_exp)(*_split(x))
    rel = np.abs(df64.df_to_f64(eh, el) - np.exp(x)) / np.exp(x)
    assert rel.max() < 1e-12, rel.max()
    # far tail: absolute error only
    x = rng.uniform(-200, -55, 2000)
    eh, el = jax.jit(df64.df_exp)(*_split(x))
    assert np.abs(df64.df_to_f64(eh, el) - np.exp(np.maximum(x, -80.0))).max() < 1e-24


def test_df_sum_dot_accuracy(rng):
    # ill-conditioned alternating series: plain f32 loses ~6 digits here
    a = rng.standard_normal(8192) * np.exp(rng.uniform(0, 6, 8192))
    b = rng.standard_normal(8192)
    ah, al = _split(a)
    bh, bl = _split(b)
    sh, sl = jax.jit(lambda h, l: df64.df_sum(h, l, axis=0))(ah, al)
    ref = np.sum(a)
    assert abs(df64.df_to_f64(sh, sl) - ref) < 1e-10 * np.sum(np.abs(a))
    dh, dl = jax.jit(lambda *t: df64.df_dot(*t, axis=0))(ah, al, bh, bl)
    ref = float(a @ b)
    assert abs(df64.df_to_f64(dh, dl) - ref) < 1e-10 * float(np.abs(a) @ np.abs(b))
    # pairwise variant agrees to df resolution
    ph, pl = jax.jit(lambda h, l: df64.df_sum_pairwise(h, l, axis=0))(ah, al)
    assert abs(df64.df_to_f64(ph, pl) - df64.df_to_f64(sh, sl)) \
        < 2**-40 * np.sum(np.abs(a))


def test_df_sum_axis_shapes(rng):
    m = rng.standard_normal((37, 13))
    mh, ml = _split(m)
    for axis in (0, 1, -1):
        sh, sl = jax.jit(lambda h, l, ax=axis: df64.df_sum(h, l, axis=ax))(mh, ml)
        ref = m.sum(axis=axis)
        assert sh.shape == ref.shape
        assert np.abs(df64.df_to_f64(sh, sl) - ref).max() < 1e-11


def test_exact_pow2():
    k = jnp.arange(-126, 128, dtype=jnp.float32)
    s = np.asarray(jax.jit(df64._exact_pow2)(k), dtype=np.float64)
    assert np.array_equal(s, 2.0 ** np.arange(-126, 128, dtype=np.float64))


def test_df_sincos_accuracy(rng):
    x = rng.uniform(0, 2 * np.pi, 20000)
    (sh, sl), (ch, cl) = jax.jit(df64.df_sincos)(*_split(x))
    assert np.abs(df64.df_to_f64(sh, sl) - np.sin(x)).max() < 1e-13
    assert np.abs(df64.df_to_f64(ch, cl) - np.cos(x)).max() < 1e-13
    # wider range: error grows ~3e-15 * (1 + |k|) with the quadrant count
    x = rng.uniform(-200, 200, 20000)
    (sh, sl), (ch, cl) = jax.jit(df64.df_sincos)(*_split(x))
    assert np.abs(df64.df_to_f64(sh, sl) - np.sin(x)).max() < 1e-12
    assert np.abs(df64.df_to_f64(ch, cl) - np.cos(x)).max() < 1e-12


def test_eft_survives_fusion_composition(rng):
    """Regression for an XLA:CPU miscompilation class: once a df value
    gains a second consumer fusion, cheap products/sums are
    REMATERIALIZED per fusion and contracted into FMAs inconsistently,
    silently costing ~1 ulp of the hi limb (3e-8 relative — measured on
    exactly this composition before the reduce_precision snapping in
    ops/df64). optimization_barrier and value-preserving launderings are
    stripped by this XLA version and do NOT help."""
    x = rng.uniform(0, 2 * np.pi, 4000)
    th, tl = _split(x)

    def chain(th, tl):
        (s, c) = df64.df_sincos(th, tl)
        cc = df64.df_mul(c[0], c[1], c[0], c[1])
        ss = df64.df_mul(s[0], s[1], s[0], s[1])
        # cos(2t) = cos^2 - sin^2: full cancellation near odd pi/4
        out = df64.df_add(*cc, *df64.df_neg(*ss))
        return out, cc, ss

    out, cc, ss = jax.jit(chain)(th, tl)
    c64 = np.cos(x)
    assert np.abs(df64.df_to_f64(*cc) - c64 * c64).max() < 1e-13
    assert np.abs(df64.df_to_f64(*out) - np.cos(2 * x)).max() < 1e-13
