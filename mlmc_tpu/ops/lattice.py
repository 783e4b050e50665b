"""Rank-1 lattice rules — the second randomized-QMC family beside the
Owen-scrambled Sobol' sequences of `ops/sobol.py` (beyond-reference
tier; the reference framework has no QMC capability at all, reference
mlmc/sampler.py:195-229 is plain MC).

A rank-1 lattice rule with ``n`` points and generating vector
``z in Z^d`` integrates over the unit cube with the node set
``x_i = frac(i z / n)``; a RANDOM SHIFT ``Delta ~ U[0,1)^d`` makes the
rule unbiased (``x_i = frac(i z / n + Delta)``) and R independent
shifts give honest CLT errors across shift estimates — the exact
analogue of Sobol' scramblings. For integrands in the weighted Korobov
space of smoothness ``alpha`` the shift-averaged error decays at
``O(n^{-alpha/2 + eps})`` when ``z`` is built by the COMPONENT-BY-
COMPONENT construction (Sloan-Kuo-Joe 2002; Nuyens & Cools 2006), vs
MC's ``O(n^{-1/2})``; the TENT (baker's) transform
``phi(x) = 1 - |2x - 1|`` periodizes smooth non-periodic integrands
while preserving uniformity (Hickernell 2002), recovering the higher
rate without touching the integrand.

Why lattices next to Sobol': the point set is ONE fused-multiply-mod
per coordinate (no direction-number tables, no bit hacking — pure elementwise
arithmetic, generation is effectively free at any dimension), the rule
is exact on every dual-lattice Fourier mode (``h . z = 0 mod n`` — an
ALGEBRAIC pin the tests use), and shift randomization preserves the
lattice group structure where scrambling cannot.

Device-first: the CBC construction runs once on host (vectorized numpy
O(d n^2), cached per (n, d, weights)); point generation and the whole
R-shift estimate run on device as one jitted program (integer index
times integer z mod n in exact f64/f32 range, shifts as operands), so
repeated calls with the same shapes share one executable.

Design anchors (tests/test_lattice.py): the character identity
(1/n) sum_i e^{2 pi i h.x_i} = e^{2 pi i h.Delta} [h in dual lattice]
checked exactly for in-dual and out-of-dual h; CBC's worst-case
P_alpha beats random generating vectors; shift-averaged unbiasedness
at 6 sigma; measured convergence ~n^{-2} on smooth periodic products
(and on non-periodic ones under the tent transform) vs MC's n^{-1}.
"""
import functools
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["cbc_vector", "lattice_points", "lattice_points_extensible",
           "p_alpha", "lattice_estimate", "tent"]


def _bernoulli2_kernel(x):
    """``omega(x) = 2 pi^2 B_2(x) = 2 pi^2 (x^2 - x + 1/6)`` — the
    alpha=2 Korobov worst-case kernel: ``1 + gamma*omega`` products
    give the squared shift-averaged worst-case error."""
    return 2.0 * np.pi ** 2 * (x * x - x + 1.0 / 6.0)


def cbc_vector(n, dim, weights=None, method="auto"):
    """Component-by-component generating vector for the weighted
    Korobov space with alpha=2 and product weights.

    Greedy per dimension: keep ``prod_j (1 + gamma_j omega({k z_j/n}))``
    over the points ``k`` and pick the next component ``z_d`` (odd, so
    coprime with the power-of-two ``n``) minimizing the squared
    worst-case error. The CBC average argument guarantees the result
    achieves the optimal ``O(n^{-alpha/2+eps})`` rate (Kuo 2003).

    Two constructions of the same greedy choice:

    - ``direct``: the blocked O(d n^2) candidate sweep (the omega
      table is tiled to bound memory at ~32 MB).
    - ``fft``: the Nuyens-Cools fast CBC (SIAM J. Sci. Comput. 27,
      2006) specialized to power-of-two n — the candidate errors are
      group correlations over ``(Z/2^t)* = {+-3^i}``, evaluated with
      FFTs per dyadic block in O(n log n) per dimension, so n = 2^16+
      generating vectors build in milliseconds on this host where the
      direct sweep needs minutes.
    - ``auto``: fft for n >= 512, direct otherwise.

    :param n: points (power of two).
    :param dim: dimensions.
    :param weights: per-dimension product weights ``gamma_j`` (default
        ``0.9^j`` — mild decay; any summable choice works).
    :return: ``z [dim]`` int64 (z[0] = 1 by convention).
    """
    n, dim = int(n), int(dim)
    if n < 2 or n & (n - 1):
        raise ValueError("n must be a power of two >= 2")
    if dim < 1:
        raise ValueError("dim must be >= 1")
    if weights is None:
        weights = 0.9 ** np.arange(1, dim + 1)
    gamma = np.asarray(weights, np.float64)
    if gamma.shape != (dim,) or np.any(gamma <= 0):
        raise ValueError("weights must be %d positive floats" % dim)
    if method not in ("auto", "direct", "fft"):
        raise ValueError("method must be auto|direct|fft")
    if method == "auto":
        method = "fft" if n >= 512 else "direct"
    if method == "fft" and n >= 16:
        return _cbc_vector_fft(n, dim, gamma)
    k = np.arange(n, dtype=np.int64)
    cand = np.arange(1, n, 2, dtype=np.int64)          # odd = coprime
    z = np.empty(dim, np.int64)
    z[0] = 1
    prod = 1.0 + gamma[0] * _bernoulli2_kernel(k / float(n))  # [n]
    # candidate blocks bound the omega({k z / n}) table at ~32 MB
    # (the full [n/2, n] table is O(n^2) — 1 GB at n = 2^14)
    blk = max(1, min(cand.shape[0], (1 << 22) // n))
    for d in range(1, dim):
        best, best_err = 1, np.inf
        for s in range(0, cand.shape[0], blk):
            cb = cand[s:s + blk]
            om = _bernoulli2_kernel((k[None, :] * cb[:, None] % n)
                                    / float(n))        # [blk, n]
            err = (1.0 + gamma[d] * om) @ prod         # [blk]
            j = int(np.argmin(err))
            if err[j] < best_err:
                best, best_err = int(cb[j]), float(err[j])
        z[d] = best
        prod = prod * (1.0 + gamma[d]
                       * _bernoulli2_kernel((k * best % n) / float(n)))
    return z


def _cbc_vector_fft(n, dim, gamma):
    """Fast CBC for n = 2^m: per candidate z the error term is
    ``E(z) = sum_k p[k] omega({k z / n})``. Split k by its dyadic part
    ``k = 2^(m-t) j`` (j odd mod 2^t): within a block only ``z mod 2^t``
    matters, and for t >= 3 the odd residues form the group
    ``{eps 3^i} ~= Z2 x Z_{2^(t-2)}`` — writing candidates as
    ``z = sigma 3^u mod n``, each block contribution is a cyclic
    CORRELATION in the exponent u, computed by FFT and tiled up to the
    full exponent range (z mod 2^t = sigma 3^(u mod 2^(t-2)), exact for
    t >= 3 since ord(3 mod 2^t) = 2^(t-2)). Blocks t <= 2 and k = 0
    are handled directly (t = 2 is special: 3 = -1 mod 4, so
    z mod 4 = sigma (-1)^u)."""
    m = int(n - 1).bit_length()
    U = n >> 2                                  # 2^(m-2) exponents
    # global discrete-log table: 3^u mod n, u in [0, U)
    pow3 = np.empty(U, np.int64)
    acc = 1
    for u in range(U):
        pow3[u] = acc
        acc = (acc * 3) % n
    z_of = np.stack([pow3, n - pow3])           # [sigma, u] -> candidate
    sign_u = np.where(np.arange(U) % 2 == 0, 1, -1)

    k = np.arange(n, dtype=np.int64)
    z = np.empty(dim, np.int64)
    z[0] = 1
    prod = 1.0 + gamma[0] * _bernoulli2_kernel(k / float(n))

    for d in range(1, dim):
        E = np.zeros((2, U))
        E += prod[0] * _bernoulli2_kernel(0.0)            # k = 0
        if m >= 1:                                         # t=1: j=1
            E += prod[n >> 1] * _bernoulli2_kernel(0.5)
        if m >= 2:                                         # t=2: j in {1,3}
            a = m - 2
            q1, q3 = prod[1 << a], prod[3 << a]
            w1, w3 = (_bernoulli2_kernel(0.25),
                      _bernoulli2_kernel(0.75))
            # z mod 4 = sigma * (-1)^u (3 = -1 mod 4)
            zmod4_is1 = np.stack([sign_u == 1, sign_u == -1])
            E += np.where(zmod4_is1, q1 * w1 + q3 * w3,
                          q1 * w3 + q3 * w1)
        for t in range(3, m + 1):
            a = m - t
            P = 1 << (t - 2)
            mod = 1 << t
            p3t = pow3[:P] % mod                # 3^i mod 2^t
            j_pos = p3t                         # eps = +1
            j_neg = mod - p3t                   # eps = -1
            qp = prod[j_pos << a]
            qn = prod[j_neg << a]
            wp = _bernoulli2_kernel(j_pos / float(mod))
            wn = _bernoulli2_kernel(j_neg / float(mod))
            # C[sigma](u) = sum_i q[s,i] w[s*sigma, (i+u) mod P]
            fqp, fqn = np.fft.rfft(qp), np.fft.rfft(qn)
            fwp, fwn = np.fft.rfft(wp), np.fft.rfft(wn)
            corr = lambda fa, fb: np.fft.irfft(np.conj(fa) * fb, P)
            c_pos = corr(fqp, fwp) + corr(fqn, fwn)
            c_neg = corr(fqp, fwn) + corr(fqn, fwp)
            reps = U // P
            E[0] += np.tile(c_pos, reps)
            E[1] += np.tile(c_neg, reps)
        si, ui = np.unravel_index(np.argmin(E), E.shape)
        best = int(z_of[si, ui])
        z[d] = best
        prod = prod * (1.0 + gamma[d]
                       * _bernoulli2_kernel((k * best % n) / float(n)))
    return z


def p_alpha(z, n, weights=None):
    """Squared shift-averaged worst-case error of the lattice ``(z, n)``
    in the alpha=2 weighted Korobov space (closed form):
    ``-1 + (1/n) sum_k prod_j (1 + gamma_j omega({k z_j / n}))``."""
    z = np.asarray(z, np.int64)
    n = int(n)
    if weights is None:
        weights = 0.9 ** np.arange(1, z.shape[0] + 1)
    gamma = np.asarray(weights, np.float64)
    k = np.arange(n, dtype=np.int64)
    prod = np.prod(1.0 + gamma[None, :] * _bernoulli2_kernel(
        (k[:, None] * z[None, :] % n) / float(n)), axis=1)
    return float(prod.mean() - 1.0)


def _check_exact_range(n, dtype):
    """The node formula divides the EXACT integer residue ``i z mod n``
    by ``n`` in ``dtype``; residues above the dtype's exact-integer
    range (2^24 for f32) would round and the 'integer-exact nodes'
    property — which the dual-lattice character tests rely on — would
    silently degrade. Refuse loudly instead."""
    # f64 could represent residues exactly to 2^53, but the node formula's
    # index arithmetic is uint32 (i*z wraps mod 2^32, exact only while n
    # divides 2^32) — so 2^32 is the hard ceiling regardless of dtype
    # (advisor r4: admitting larger n would silently wrap, not raise)
    exact = {4: 1 << 24, 8: 1 << 32}.get(jnp.dtype(dtype).itemsize, 0)
    if n > exact:
        raise ValueError(
            "n=%d exceeds the exact range for %s lattices (%d): f32 "
            "residues would round past 2^24; beyond 2^32 the uint32 "
            "index arithmetic itself wraps; pass dtype=float64 "
            "(requires x64) for n in (2^24, 2^32]"
            % (n, jnp.dtype(dtype).name, exact))


def lattice_points(z, n, shift=None, start=0, count=None, dtype=None):
    """Device-side lattice nodes ``frac(i z / n + shift)`` for
    ``i = start .. start+count-1`` — pure elementwise arithmetic (exact integer
    product mod n, one multiply-add per coordinate).

    :param z: ``[d]`` generating vector (host ints or device array).
    :param shift: ``[d]`` (one shift) or ``[R, d]`` (a batch — returns
        ``[R, count, d]``); None = no shift (the raw, biased rule).
    :return: ``[count, d]`` (or ``[R, count, d]``) uniforms.
    """
    n = int(n)
    if n < 1 or n & (n - 1):
        raise ValueError("n must be a power of two")
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    _check_exact_range(n, dtype)
    if count is None:
        count = n
    if isinstance(z, jax.Array) and z.dtype == jnp.uint32:
        pass                                  # device/traced, pre-reduced
    else:
        z = jnp.asarray(np.asarray(z, np.int64) % n, jnp.uint32)
    i = jnp.asarray(start).astype(jnp.uint32) \
        + jnp.arange(count, dtype=jnp.uint32)
    # i*z mod n: uint32 product of values < n <= 2^31 wraps mod 2^32,
    # and n | 2^32 makes the mask exact
    frac = (i[:, None] * z[None, :] & jnp.uint32(n - 1)).astype(dtype) \
        / dtype.type(n)
    if shift is None:
        return frac
    shift = jnp.asarray(shift, dtype)
    if shift.ndim == 1:
        return jnp.mod(frac + shift[None, :], 1.0)
    return jnp.mod(frac[None] + shift[:, None, :], 1.0)


def lattice_points_extensible(z, n_max, shift=None, start=0, count=None,
                              dtype=None):
    """Prefix-extensible lattice SEQUENCE: enumerate the ``n_max``-point
    lattice in BIT-REVERSED index order, so every power-of-two prefix
    is exactly the smaller lattice rule with the same ``z`` — the first
    ``2^k`` sequence positions are the indices ``j * n_max / 2^k``,
    i.e. the nodes ``frac(j z / 2^k)`` (Hickernell-Hong-L'Ecuyer-Lemieux
    2000 extensible lattice sequences, base-2 embedded form). This is
    the lattice analogue of the Sobol' prefix property MLQMC's doubling
    schedule rides: doubling a budget EXTENDS the point set and every
    evaluated point keeps contributing.

    :param z: generating vector built for ``n_max`` (a CBC vector for
        the largest anticipated size serves all the embedded sizes).
    :param n_max: lattice modulus (power of two) — the sequence length.
    :param start/count: sequence positions (defaults: the whole
        sequence).
    :return: as :func:`lattice_points`.
    """
    n_max = int(n_max)
    if n_max < 2 or n_max & (n_max - 1):
        raise ValueError("n_max must be a power of two")
    _check_exact_range(n_max, dtype or jnp.result_type(float))
    if count is None:
        count = n_max - int(start)
    bits = int(n_max - 1).bit_length()
    i = jnp.asarray(start).astype(jnp.uint32) \
        + jnp.arange(count, dtype=jnp.uint32)
    # bit-reverse within the bits-wide index field
    rev = jnp.zeros_like(i)
    for b in range(bits):
        rev = rev | (((i >> b) & 1) << (bits - 1 - b))
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    if isinstance(z, jax.Array) and z.dtype == jnp.uint32:
        zz = z
    else:
        zz = jnp.asarray(np.asarray(z, np.int64) % n_max, jnp.uint32)
    frac = (rev[:, None] * zz[None, :] & jnp.uint32(n_max - 1)) \
        .astype(dtype) / dtype.type(n_max)
    if shift is None:
        return frac
    shift = jnp.asarray(shift, dtype)
    if shift.ndim == 1:
        return jnp.mod(frac + shift[None, :], 1.0)
    return jnp.mod(frac[None] + shift[:, None, :], 1.0)


def tent(u):
    """Baker's transform ``1 - |2u - 1|``: maps U[0,1) to U[0,1) while
    periodizing smooth integrands — composes the lattice rule's
    ``O(n^{-alpha/2})`` rate onto non-periodic smooth functions
    (Hickernell 2002)."""
    return 1.0 - jnp.abs(2.0 * u - 1.0)


@functools.lru_cache(maxsize=64)
def _estimate_program(fn, dim, n, chunk, use_tent, str_dtype):
    dtype = jnp.dtype(str_dtype)
    n_chunks = n // chunk

    def one_shift(z, shift):
        def body(c, acc):
            s, s2 = acc
            u = lattice_points(z, n, shift, start=c * chunk,
                               count=chunk, dtype=dtype)
            y = fn(tent(u) if use_tent else u)
            return s + jnp.sum(y), s2 + jnp.sum(y * y)

        zero = jnp.zeros((), dtype)
        s, s2 = jax.lax.fori_loop(0, n_chunks, body, (zero, zero))
        return s / n, s2 / n

    @jax.jit
    def run(z, shifts):
        return jax.vmap(lambda sh: one_shift(z, sh))(shifts)

    return run


def lattice_estimate(fn: Callable, dim: int, n: int = 1 << 12,
                     n_shifts: int = 16, z=None, seed: int = 0,
                     use_tent: bool = False, weights=None,
                     chunk_size: int = 1 << 14, dtype=None, mesh=None):
    """Randomly-shifted lattice estimate of ``E[fn(U)]`` over the unit
    cube — the lattice twin of a Sobol'-scrambled mean, with honest
    errors across the R independent shifts.

    :param fn: pure jnp ``f(u [m, dim]) -> y [m]``.
    :param n: points per shift (power of two; total evals
        ``n_shifts * n``).
    :param z: generating vector (default: CBC-built for ``(n, dim)``).
    :param use_tent: apply the baker's transform (periodizes smooth
        non-periodic integrands — usually a free accuracy win).
    :param mesh: optional :class:`~mlmc_tpu.parallel.mesh.SampleMesh` —
        the R shifts shard across the devices (each shift estimate is
        independent, so input sharding alone partitions the vmap; the
        per-shift results are identical to the single-device run).
    :return: dict with ``mean``, ``se`` (spread across shifts),
        ``per_shift`` [R], ``within_shift_var`` [R] (descriptive spread
        of ``fn`` over each shifted node set — not an error estimate),
        ``z``, ``n``, ``n_shifts``.
    """
    dim, n, R = int(dim), int(n), int(n_shifts)
    if R < 2:
        raise ValueError("need >= 2 shifts for a standard error")
    if n & (n - 1):
        raise ValueError("n must be a power of two")
    if z is None:
        z = cbc_vector(n, dim, weights)
    z = np.asarray(z, np.int64)
    if z.shape != (dim,):
        raise ValueError("z must have shape [dim]")
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    chunk = min(int(chunk_size), n)
    if n % chunk:
        raise ValueError("chunk_size must divide n")
    run = _estimate_program(fn, dim, n, chunk, bool(use_tent),
                            str(dtype))
    shifts = jax.random.uniform(jax.random.key(seed), (R, dim), dtype)
    zd = jnp.asarray(z % n, jnp.uint32)
    if mesh is not None:
        if R % mesh.n_devices:
            raise ValueError("n_shifts=%d must divide by the mesh's %d "
                             "devices" % (R, mesh.n_devices))
        shifts = mesh.shard_batch(shifts)
        zd = jax.device_put(zd, mesh.replicated())
    means, m2 = jax.device_get(run(zd, shifts))
    means = np.asarray(means, np.float64)
    m2 = np.asarray(m2, np.float64)
    if not np.all(np.isfinite(means)):
        raise FloatingPointError(
            "integrand produced non-finite values on the lattice; QMC "
            "points cannot be dropped without bias")
    # within-shift spread of fn over the lattice nodes — descriptive
    # (lattice points are correlated, so this is NOT an error estimate;
    # `se` across shifts is) but free: the kernel accumulates sum(y^2)
    # anyway, and it quantifies how much variance the rule integrates out
    within = np.maximum(m2 - means * means, 0.0) * (n / max(n - 1, 1))
    return {"mean": float(means.mean()),
            "se": float(means.std(ddof=1) / np.sqrt(R)),
            "per_shift": means, "within_shift_var": within,
            "z": z, "n": n, "n_shifts": R}
