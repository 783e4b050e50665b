"""f64 host references + derived error bounds for the estimation tiers.

The float32 fast tier (ops/fused_estimate: stored-sample pipeline)
accumulates in f32 with Kahan compensation across chunks
(fused_estimate._chunk_loop). It consumes f32 sample values, so the right
precision question is: how far can its sums drift from an EXACT (f64)
summation of the same f32 per-sample values?

Error model (standard compensated-summation analysis):

* per-sample basis values differ from the host's by rounding inside the
  three-term recurrence — at most ``K_REC`` roundings of magnitude
  ``eps32 * |phi|`` each (the recurrence is stable for |t| <= 1, values
  bounded by 1);
* each within-chunk reduction (sums, and the covariance contraction at
  ``Precision.HIGHEST``, i.e. true f32 rather than TF32) contributes
  ~``log2(chunk)`` roundings of the running partial — bounded by
  ``eps32 * K_SUM * sum|term|``;
* Kahan across chunks leaves ONE rounding of the final value instead of
  O(n_chunks) — this is what makes the bound independent of sample count.

Together:  |fast tier - f64_ref|  <=  eps32 * C_BOUND * S_abs
with S_abs = sum of |terms| and C_BOUND a conservative constant covering
recurrence depth (R <= 32), reduction trees and margin. The bound is
asserted by tests/test_pallas_kernel.py, by bench.py and by chip_smoke.py
on the device.

The extended tier runs the same pipeline in float64; it is held to
``f64_error_bound`` against the all-f64 reference
``f64_reference_moments_strict``.
"""
import numpy as np

from mlmc_tpu.ops.fused_estimate import STORED_CHUNK

EPS32 = np.float32(np.finfo(np.float32).eps)  # 1.19e-7
# recurrence (<=2 roundings x 32 steps) + reduction tree (log2 32768 = 15)
# + Kahan residual + 4x margin; the covariance shares the bound (its
# contraction runs at HIGHEST precision, the same f32 rounding model)
C_BOUND = 4 * (2 * 32 + 15 + 2)


def f64_reference_moments(noise, n_moments, *, fine_step, coarse_step,
                          domain, is_level0=False, chunk=262144,
                          include_cov=True):
    """Exact-summation reference for the synthetic noise-input level.

    Per-sample values are computed in f32 (matching the fast tier's value
    path), sums in f64. Returns the accumulators plus the absolute-value
    sums S_abs that scale the error bound. ``include_cov=False`` skips the
    covariance matmuls (the host-side cost driver) — used by bench.py's
    >=1e7 check where the unit tests already cover covariance.

    :return: dict(sums, sums2, cov_fine, cov_coarse, n_valid,
                  abs_sums, abs_sums2, abs_cov_fine, abs_cov_coarse)
    """
    noise = np.asarray(noise, dtype=np.float32)
    n = noise.shape[0]
    R = n_moments
    a, b = domain
    t_scale = np.float32(2.0 / (b - a))
    t_shift = np.float32((a + b) / 2.0)
    f_step = np.float32(fine_step)
    c_step = np.float32(coarse_step)

    sums = np.zeros(R)
    sums2 = np.zeros(R)
    cov_f = np.zeros((R, R))
    cov_c = np.zeros((R, R))
    abs_sums = np.zeros(R)
    abs_sums2 = np.zeros(R)
    abs_cov_f = np.zeros((R, R))
    abs_cov_c = np.zeros((R, R))
    n_valid = 0

    def legendre_f32(t, valid):
        """f32 three-term recurrence, invalid columns zeroed like the tier."""
        t = np.where(valid, t, np.float32(0.0)).astype(np.float32)
        phi = np.zeros((R, t.shape[0]), dtype=np.float32)
        phi[0] = valid.astype(np.float32)
        if R > 1:
            phi[1] = t
        for k in range(2, R):
            phi[k] = ((np.float32(2 * k - 1) * t * phi[k - 1]
                       - np.float32(k - 1) * phi[k - 2]) / np.float32(k))
        return phi

    for start in range(0, n, chunk):
        x = noise[start:start + chunk]
        err = np.sqrt(np.float32(1e-4) + np.abs(x), dtype=np.float32)
        fine = (x + f_step * err).astype(np.float32)
        coarse = (x + c_step * err).astype(np.float32)
        t_f = ((fine - t_shift) * t_scale).astype(np.float32)
        t_c = ((coarse - t_shift) * t_scale).astype(np.float32)
        valid = (t_f >= -1) & (t_f <= 1)
        if not is_level0:
            valid &= (t_c >= -1) & (t_c <= 1)

        pf32 = legendre_f32(t_f, valid)
        if is_level0:
            pc32 = None
            dphi = pf32.astype(np.float64)
        else:
            pc32 = legendre_f32(t_c, valid)
            # the tier subtracts in f32; difference of exact f32 values
            # is itself computed here in f64 of those f32 values
            dphi = pf32.astype(np.float64) - pc32.astype(np.float64)

        sums += dphi.sum(axis=1)
        sq = (dphi * dphi).sum(axis=1)
        sums2 += sq
        abs_sums += np.abs(dphi).sum(axis=1)
        abs_sums2 += sq  # squares are nonnegative: |terms| == terms
        if include_cov:
            pf = pf32.astype(np.float64)
            cov_f += pf @ pf.T
            abs_cov_f += np.abs(pf) @ np.abs(pf).T
            if pc32 is not None:
                pc = pc32.astype(np.float64)
                cov_c += pc @ pc.T
                abs_cov_c += np.abs(pc) @ np.abs(pc).T
        n_valid += int(valid.sum())

    return dict(sums=sums, sums2=sums2, cov_fine=cov_f, cov_coarse=cov_c,
                n_valid=n_valid, abs_sums=abs_sums, abs_sums2=abs_sums2,
                abs_cov_fine=abs_cov_f, abs_cov_coarse=abs_cov_c)


def accumulation_error_bound(abs_sums):
    """Derived bound on |f32-Kahan fast tier - f64 reference| (module doc)."""
    return float(EPS32) * C_BOUND * np.asarray(abs_sums)


# ------------------------------------------------------------------ #
# extended (float64) tier: strict all-f64 reference + f64 bound
# ------------------------------------------------------------------ #
#: float64 unit roundoff
EPS64 = float(2.0 ** -53)


def f64_error_bound(abs_sums, n_samples, chunk=STORED_CHUNK, basis_depth=32):
    """Deterministic bound on |extended tier - all-f64 reference|.

    Error sources, all O(2^-53) relative per operation:
    * basis recurrence: <= ~4 roundings x basis_depth per value,
    * within-chunk reductions: 2 log2(chunk) levels,
    * cross-chunk accumulation: 3 roundings per chunk of the running
      (<= final) magnitude.
    Worst-case sequential; measured deviations sit orders below.
    """
    n_chunks = -(-int(n_samples) // chunk)
    c = 4 * basis_depth + 2 * np.log2(chunk) + 3 * n_chunks
    return EPS64 * c * np.asarray(abs_sums)


def f64_reference_moments_strict(noise=None, n_moments=None, *,
                                 fine_step=None, coarse_step=None, domain,
                                 is_level0=False, chunk=262144,
                                 include_cov=True, fine32=None,
                                 coarse32=None):
    """ALL-f64 reference for the extended (float64) tier.

    Mirrors the reference library's own pipeline on identical f32 QoI
    inputs: the QoIs are f32 (what a store holds), then the domain
    transform, Legendre recurrence, and every sum run in f64 (reference
    mlmc/moments.py:195-197 + quantity_estimate.py:64-77 under an
    all-float64 numpy stack).

    Pass either ``noise`` + steps — the synth QoI transform is recomputed
    here in numpy f32 — or the QoI arrays ``fine32``/``coarse32``
    directly. The strict comparison REQUIRES bitwise-identical QoI bits on
    both sides; a device's f32 ``sqrt`` is not guaranteed bitwise equal to
    numpy's, so callers comparing against a device run of the noise
    pipeline must compute the QoIs once (on device), pull them to host,
    and pass them via ``fine32``/``coarse32``.

    :return: dict(sums, sums2, cov_fine, cov_coarse, n_valid, abs_*)
    """
    if fine32 is None:
        # f32 QoI path (bitwise identical to the device's QoI transform
        # when both run the same sqrt implementation)
        noise = np.asarray(noise, dtype=np.float32)
        err = np.sqrt(np.float32(1e-4) + np.abs(noise), dtype=np.float32)
        fine32 = (noise + np.float32(fine_step) * err).astype(np.float32)
        coarse32 = (noise + np.float32(coarse_step) * err).astype(
            np.float32)
    else:
        fine32 = np.asarray(fine32, dtype=np.float32)
        coarse32 = (np.zeros_like(fine32) if coarse32 is None
                    else np.asarray(coarse32, dtype=np.float32))
    R = n_moments
    a, b = (np.float64(domain[0]), np.float64(domain[1]))
    t_scale = 2.0 / (b - a)
    t_shift = (a + b) / 2.0

    sums = np.zeros(R)
    sums2 = np.zeros(R)
    cov_f = np.zeros((R, R))
    cov_c = np.zeros((R, R))
    abs_sums = np.zeros(R)
    abs_sums2 = np.zeros(R)
    abs_cov_f = np.zeros((R, R))
    abs_cov_c = np.zeros((R, R))
    n_valid = 0

    def legendre_f64(t, valid):
        t = np.where(valid, t, 0.0)
        phi = np.zeros((R, t.shape[0]))
        phi[0] = valid.astype(np.float64)
        if R > 1:
            phi[1] = t
        for k in range(2, R):
            phi[k] = ((2 * k - 1) * t * phi[k - 1]
                      - (k - 1) * phi[k - 2]) / k
        return phi

    n = fine32.shape[0]
    for start in range(0, n, chunk):
        t_f = (fine32[start:start + chunk].astype(np.float64)
               - t_shift) * t_scale
        t_c = (coarse32[start:start + chunk].astype(np.float64)
               - t_shift) * t_scale
        valid = (t_f >= -1) & (t_f <= 1)
        if not is_level0:
            valid &= (t_c >= -1) & (t_c <= 1)

        pf = legendre_f64(t_f, valid)
        if is_level0:
            dphi = pf
        else:
            pc = legendre_f64(t_c, valid)
            dphi = pf - pc

        sums += dphi.sum(axis=1)
        sq = (dphi * dphi).sum(axis=1)
        sums2 += sq
        abs_sums += np.abs(dphi).sum(axis=1)
        abs_sums2 += sq
        if include_cov:
            cov_f += pf @ pf.T
            abs_cov_f += np.abs(pf) @ np.abs(pf).T
            if not is_level0:
                cov_c += pc @ pc.T
                abs_cov_c += np.abs(pc) @ np.abs(pc).T
        n_valid += int(valid.sum())

    return dict(sums=sums, sums2=sums2, cov_fine=cov_f, cov_coarse=cov_c,
                n_valid=n_valid, abs_sums=abs_sums, abs_sums2=abs_sums2,
                abs_cov_fine=abs_cov_f, abs_cov_coarse=abs_cov_c)


def check_extended_against_f64(result, ref, n_samples, chunk=STORED_CHUNK,
                               include_cov=True, cov_rel_tol=1e-10):
    """Assert the extended tier against the strict all-f64 reference.

    sums/sums2 must meet the derived float64 bound (``f64_error_bound``);
    the covariance is held to ``cov_rel_tol`` relative to S_abs.

    :return: dict of measured max relative deviations
    """
    assert int(result.n_valid) == ref["n_valid"], \
        (int(result.n_valid), ref["n_valid"])
    report = {}
    for name in ("sums", "sums2"):
        got = np.asarray(getattr(result, name))
        want = ref[name]
        bound = f64_error_bound(ref["abs_" + name], n_samples, chunk=chunk)
        err = np.abs(got - want)
        report[name] = float(np.max(err / np.maximum(ref["abs_" + name],
                                                     1.0)))
        if not np.all(err <= bound + 1e-13):
            worst = int(np.argmax(err - bound))
            raise AssertionError(
                "extended %s exceeds f64 bound at %d: err=%.3g bound=%.3g"
                % (name, worst, err[worst], bound[worst]))
    if include_cov:
        for name in ("cov_fine", "cov_coarse"):
            got = np.asarray(getattr(result, name))
            want = ref[name]
            scale = np.maximum(ref["abs_" + name], 1.0)
            dev = float(np.max(np.abs(got - want) / scale))
            report[name] = dev
            assert dev <= cov_rel_tol, (name, dev, cov_rel_tol)
    return report


def check_against_f64(result, ref, include_cov=True):
    """Assert a fast-tier result against the f64 reference + derived bound.

    :param result: SynthMomentResult from the float32 fast tier
    :param ref: dict from f64_reference_moments
    :return: dict of measured max deviations (for reporting)
    """
    assert int(result.n_valid) == ref["n_valid"], \
        (int(result.n_valid), ref["n_valid"])
    report = {}
    pairs = [("sums", "abs_sums"), ("sums2", "abs_sums2")]
    if include_cov:
        pairs += [("cov_fine", "abs_cov_fine"),
                  ("cov_coarse", "abs_cov_coarse")]
    for name, abs_name in pairs:
        got = np.asarray(getattr(result, name), dtype=np.float64)
        want = ref[name]
        bound = accumulation_error_bound(ref[abs_name])
        err = np.abs(got - want)
        scale = np.maximum(ref[abs_name], 1.0)
        report[name] = float(np.max(err / scale))
        if not np.all(err <= bound + 1e-12):
            worst = np.unravel_index(np.argmax(err - bound), err.shape)
            raise AssertionError(
                "%s exceeds derived f32 bound at %s: err=%.3g bound=%.3g"
                % (name, worst, err[worst], bound[worst]))
    return report
