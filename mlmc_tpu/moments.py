"""Generalized moment-function bases, device-native.

Re-design of the reference moment layer (``/root/reference/mlmc/moments.py:6-274``)
as pure-functional JAX evaluators:

* every basis evaluates a whole sample batch at once (``eval_all`` is a
  traced jnp function usable under ``jit``/``vmap``/``pjit``),
* the Vandermonde construction is expressed so XLA can fuse it into the
  downstream moment/covariance matmuls,
* ``safe_eval`` outlier clipping produces NaN lanes (masked later by the
  estimators) instead of numpy masked arrays,
* ``TransformedMoments`` composes as a single matrix multiply.

Behavioral parity targets (checked by ``tests/test_moments.py``):
  Monomial   == numpy.polynomial.polynomial.polyvander on the transformed value
  Legendre   == numpy.polynomial.legendre.legvander (same three-term recurrence)
  Fourier    == [1, cos(kx), sin(kx) interleaved]  (reference moments.py:145-162)
  Legendre.eval_diff / eval_diff2 use the odd-index derivative matrices
  (reference moments.py:185-188).
"""
import numpy as np
import jax
import jax.numpy as jnp


class Moments:
    """Base class: domain transform + optional log + safe clipping to NaN.

    Mirrors the contract of the reference ``Moments`` (moments.py:6-108):
    ``size``, ``domain``, ``transform``/``inv_transform``, ``eval_all``,
    ``eval``, ``eval_single_moment``, ``eval_all_der``, ``eval_diff``,
    ``eval_diff2``, ``change_size`` and ``__eq__``.
    """

    # subclasses set a class-level default; instances may override via ctor
    ref_domain = (0.0, 1.0)

    def __init__(self, size, domain, log=False, safe_eval=True):
        assert size > 0
        self.size = int(size)
        self.domain = (float(domain[0]), float(domain[1]))
        self._is_log = bool(log)
        self._is_clip = bool(safe_eval)

        if log:
            lin_domain = (np.log(self.domain[0]), np.log(self.domain[1]))
        else:
            lin_domain = self.domain

        diff = lin_domain[1] - lin_domain[0]
        assert diff > 0
        diff = max(diff, 1e-15)
        self._linear_scale = (self.ref_domain[1] - self.ref_domain[0]) / diff
        self._linear_shift = lin_domain[0]

    # ------------------------------------------------------------------ #
    # value transforms (pure jnp; traceable)
    # ------------------------------------------------------------------ #
    def linear(self, value):
        """Affine map from the user domain onto the reference domain."""
        return (value - self._linear_shift) * self._linear_scale + self.ref_domain[0]

    def inv_linear(self, value):
        """Inverse of :meth:`linear` (reference -> user domain)."""
        return (value - self.ref_domain[0]) / self._linear_scale + self._linear_shift

    def clip(self, value):
        """Replace values outside the reference domain with NaN."""
        lo, hi = self.ref_domain
        bad = (value < lo) | (value > hi)
        return jnp.where(bad, jnp.nan, value)

    def transform(self, value):
        """Full forward transform: optional log, affine map, optional
        out-of-domain clipping to NaN (``safe_eval``)."""
        value = jnp.asarray(value)
        if self._is_log:
            value = jnp.log(value)
        value = self.linear(value)
        if self._is_clip:
            value = self.clip(value)
        return value

    def inv_transform(self, ref):
        """Map reference-domain values back to the user domain."""
        ref = jnp.asarray(ref)
        out = self.inv_linear(ref)
        if self._is_log:
            out = jnp.exp(out)
        return out

    # ------------------------------------------------------------------ #
    # protocol
    # ------------------------------------------------------------------ #
    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self.size == other.size
            and np.all(np.array(self.domain) == np.array(other.domain))
            and self._is_log == other._is_log
            and self._is_clip == other._is_clip
        )

    def __hash__(self):
        return hash((type(self).__name__, self.size, self.domain, self._is_log, self._is_clip))

    def change_size(self, size):
        """Same basis/domain/flags with a different moment count."""
        # keyword args: subclass signatures insert ref_domain positionally
        # (the reference's positional call is broken for its subclasses);
        # a custom ref_domain must survive the resize (review finding)
        kwargs = dict(log=self._is_log, safe_eval=self._is_clip)
        import inspect

        if "ref_domain" in inspect.signature(self.__class__.__init__).parameters:
            kwargs["ref_domain"] = self.ref_domain
        return self.__class__(size, self.domain, **kwargs)

    def __call__(self, value):
        return self._eval_all(value, self.size)

    def eval(self, i, value):
        """Value of the i-th moment function (reference moments.py:34)."""
        return self._eval_all(value, i + 1)[..., -1]

    def eval_single_moment(self, i, value):
        """i-th moment values, broadcasting over ``value``'s shape."""
        return self._eval_all(value, i + 1)[..., i]

    def eval_all(self, value, size=None):
        """Vandermonde of the first ``size`` moment functions:
        ``[*value.shape, size]`` (traceable jnp path)."""
        return self._eval_all(value, self.size if size is None else size)

    def eval_all_der(self, value, size=None, degree=1):
        """``degree``-th derivatives of the moment functions
        (reference moments.py:199-229)."""
        return self._eval_all_der(
            value, self.size if size is None else size, degree)

    def eval_diff(self, value, size=None):
        """First finite-difference matrix application (reference :185)."""
        return self._eval_diff(value, self.size if size is None else size)

    def eval_diff2(self, value, size=None):
        """Second finite-difference matrix application (reference :188)."""
        return self._eval_diff2(value, self.size if size is None else size)

    # hook for fused kernels: evaluate on already-transformed values
    def _eval_ref(self, t, size):
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # numpy evaluation path — host-side consumers (maxent quadrature,
    # plots) that would otherwise dispatch thousands of tiny ops to the
    # device. Semantics identical to the jnp path.
    # ------------------------------------------------------------------ #
    def transform_np(self, value):
        """Host-numpy twin of :meth:`transform` (same semantics)."""
        value = np.asarray(value, dtype=float)
        if self._is_log:
            value = np.log(value)
        value = (value - self._linear_shift) * self._linear_scale + self.ref_domain[0]
        if self._is_clip:
            lo, hi = self.ref_domain
            value = np.where((value < lo) | (value > hi), np.nan, value)
        return value

    def eval_all_np(self, value, size=None):
        """Host-numpy twin of :meth:`eval_all` for maxent/plot consumers."""
        if size is None:
            size = self.size
        t = self.transform_np(np.atleast_1d(value))
        return self._eval_ref_np(t, size)

    def _eval_ref_np(self, t, size):
        raise NotImplementedError


def _matmul(a, b):
    """Basis transform product at full precision: a float32 matmul may
    otherwise run in TF32 (10-bit mantissa) on the GPU."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _atleast_1d(value):
    value = jnp.asarray(value)
    if value.ndim == 0:
        value = value[None]
    if not jnp.issubdtype(value.dtype, jnp.floating):
        value = value.astype(jnp.result_type(float))
    return value


def legvander(x, deg):
    """Legendre Vandermonde [..., deg+1] via the three-term recurrence.

    Identical recurrence to ``numpy.polynomial.legendre.legvander``
    (P_{n} = ((2n-1)·x·P_{n-1} - (n-1)·P_{n-2}) / n), unrolled at trace
    time (deg is static, typically 24-34) so XLA fuses it into one kernel.
    """
    x = jnp.asarray(x)
    # x*0 + 1 (not ones_like) so NaN lanes poison the constant column,
    # matching numpy.polynomial behavior relied on by safe_eval clipping
    cols = [x * 0 + 1]
    if deg > 0:
        cols.append(x)
    for n in range(2, deg + 1):
        cols.append((cols[-1] * x * (2 * n - 1) - cols[-2] * (n - 1)) / n)
    return jnp.stack(cols, axis=-1)


def polyvander(x, deg):
    """Monomial Vandermonde [..., deg+1]: 1, x, x², ... (NaN-propagating)."""
    x = jnp.asarray(x)
    cols = [x * 0 + 1]
    for _ in range(deg):
        cols.append(cols[-1] * x)
    return jnp.stack(cols, axis=-1)


def fourier_vander(t, size):
    """Fourier Vandermonde [..., size]: 1, then cos kt at odd and sin kt
    at even columns (reference moments.py:145-162 order)."""
    t = jnp.asarray(t)
    R = size // 2
    shorter_sin = 1 - size % 2
    k = jnp.arange(1, R + 1, dtype=t.dtype)
    kx = t[..., None] * k  # [..., R]
    out = jnp.empty(t.shape + (size,), dtype=t.dtype)
    # t*0 + 1 keeps the NaN-poisoning invariant for clipped inputs even
    # when size == 1 and no sin/cos column exists to carry the NaN
    out = out.at[..., 0].set(t * 0.0 + 1.0)
    out = out.at[..., 1::2].set(jnp.cos(kx))
    out = out.at[..., 2::2].set(jnp.sin(kx[..., : R - shorter_sin]))
    return out


def legendre_diff_mat(size):
    """d/dx in the Legendre-Vandermonde representation.

    ``vander @ diff_mat`` evaluates derivatives of P_0..P_{size-1}
    (reference moments.py:185-188: diff_mat[n, n+1::2] = 2n+1).
    """
    mat = np.zeros((size, size))
    for n in range(size - 1):
        mat[n, n + 1::2] = 2 * n + 1
    return mat


class Monomial(Moments):
    """Monomial moments (reference moments.py:111-130)."""

    def __init__(self, size, domain=(0, 1), ref_domain=None, log=False, safe_eval=True):
        self.ref_domain = tuple(ref_domain) if ref_domain is not None else (0.0, 1.0)
        super().__init__(size, domain, log=log, safe_eval=safe_eval)

    def _eval_ref(self, t, size):
        return polyvander(t, size - 1)

    def _eval_ref_np(self, t, size):
        return np.polynomial.polynomial.polyvander(t, size - 1)

    def _eval_all(self, value, size):
        t = self.transform(_atleast_1d(value))
        return polyvander(t, size - 1)

    def eval(self, i, value):
        """i-th monomial ``t**i`` on the transformed value."""
        t = self.transform(_atleast_1d(value))
        return t ** i


class Fourier(Moments):
    """Fourier moments [1, cos kx, sin kx] (reference moments.py:133-171)."""

    def __init__(self, size, domain=(0, 2 * np.pi), ref_domain=None, log=False, safe_eval=True):
        self.ref_domain = tuple(ref_domain) if ref_domain is not None else (0.0, 2 * np.pi)
        super().__init__(size, domain, log=log, safe_eval=safe_eval)

    def _eval_ref(self, t, size):
        return fourier_vander(t, size)

    def _eval_ref_np(self, t, size):
        R = size // 2
        shorter_sin = 1 - size % 2
        k = np.arange(1, R + 1, dtype=float)
        kx = t[..., None] * k
        out = np.empty(t.shape + (size,), dtype=float)
        out[..., 0] = t * 0.0 + 1.0
        out[..., 1::2] = np.cos(kx)
        out[..., 2::2] = np.sin(kx[..., : R - shorter_sin])
        return out

    def _eval_all(self, value, size):
        t = self.transform(_atleast_1d(value))
        return self._eval_ref(t, size)

    def eval(self, i, value):
        """i-th Fourier mode (1, cos kx at odd i, sin kx at even i)."""
        t = self.transform(_atleast_1d(value))
        if i == 0:
            return jnp.ones_like(t)
        elif i % 2 == 1:
            # NOTE: parity with reference moments.py:169-171 (sin((i-1)/2·x), cos(i/2·x))
            return jnp.sin((i - 1) / 2 * t)
        else:
            return jnp.cos(i / 2 * t)


class Legendre(Moments):
    """Legendre moments (reference moments.py:174-229)."""

    def __init__(self, size, domain, ref_domain=None, log=False, safe_eval=True):
        self.ref_domain = tuple(ref_domain) if ref_domain is not None else (-1.0, 1.0)
        self.diff_mat = legendre_diff_mat(size)
        self.diff2_mat = self.diff_mat @ self.diff_mat
        super().__init__(size, domain, log, safe_eval)

    def _eval_ref(self, t, size):
        return legvander(t, size - 1)

    def _eval_ref_np(self, t, size):
        return np.polynomial.legendre.legvander(t, size - 1)

    def _eval_all(self, value, size):
        t = self.transform(_atleast_1d(value))
        return legvander(t, size - 1)

    def _eval_all_der(self, value, size, degree=1):
        t = self.transform(_atleast_1d(value))
        vander = legvander(t, size - 1)
        dmat = np.linalg.matrix_power(legendre_diff_mat(size), degree)
        return _matmul(vander, jnp.asarray(dmat, dtype=vander.dtype))

    def _eval_diff(self, value, size):
        t = self.transform(_atleast_1d(value))
        vander = legvander(t, size - 1)
        return _matmul(vander, jnp.asarray(self.diff_mat[:size, :size],
                                           dtype=vander.dtype))

    def _eval_diff2(self, value, size):
        t = self.transform(_atleast_1d(value))
        vander = legvander(t, size - 1)
        return _matmul(vander, jnp.asarray(self.diff2_mat[:size, :size],
                                           dtype=vander.dtype))


class TransformedMoments(Moments):
    """new_moments = matrix · old_moments (reference moments.py:232-274)."""

    def __init__(self, other_moments, matrix):
        n, m = np.asarray(matrix).shape
        assert m == other_moments.size
        self.size = int(n)
        self.domain = other_moments.domain
        self._origin = other_moments
        self._transform_mat = np.asarray(matrix)

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self.size == other.size
            and self._origin == other._origin
            and np.all(self._transform_mat == other._transform_mat)
        )

    def __hash__(self):
        return hash((type(self).__name__, self.size, hash(self._origin)))

    def _apply(self, orig):
        return _matmul(orig, jnp.asarray(self._transform_mat.T,
                                         dtype=orig.dtype))

    def _eval_ref(self, t, size):
        orig = self._origin._eval_ref(t, self._origin.size)
        return self._apply(orig)[..., :size]

    def eval_all_np(self, value, size=None):
        """Host-numpy path: origin Vandermonde times the transform."""
        if size is None:
            size = self.size
        orig = self._origin.eval_all_np(value, self._origin.size)
        return (orig @ self._transform_mat.T)[..., :size]

    def _eval_all(self, value, size):
        orig = self._origin._eval_all(value, self._origin.size)
        return self._apply(orig)[..., :size]

    def _eval_all_der(self, value, size, degree=1):
        orig = self._origin._eval_all_der(value, self._origin.size, degree=degree)
        return self._apply(orig)[..., :size]

    def _eval_diff(self, value, size):
        orig = self._origin.eval_diff(value, self._origin.size)
        return self._apply(orig)[..., :size]

    def _eval_diff2(self, value, size):
        orig = self._origin.eval_diff2(value, self._origin.size)
        return self._apply(orig)[..., :size]

    def transform(self, value):
        """Delegates to the origin basis (same domain handling)."""
        return self._origin.transform(value)

    def inv_transform(self, ref):
        """Delegates to the origin basis."""
        return self._origin.inv_transform(ref)
