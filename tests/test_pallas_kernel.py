"""Stored-sample estimation pipeline correctness (ops/fused_estimate).

The deterministic body (QoI -> basis Vandermonde -> sums/cov) is tested
against numpy via the noise-input variant; the float32 fast tier against
the derived f32 bound of an f64 summation, the float64 extended tier
against the strict all-f64 reference. ``chip_smoke.py`` re-checks both on
the GPU at >= 1e7 samples.
"""
import numpy as np
import pytest
import jax

from mlmc_tpu.ops.fused_estimate import synth_moment_pipeline_from_noise
from mlmc_tpu.moments import Legendre


R = 8
DOMAIN = (-4.0, 4.0)
FINE, COARSE = 0.25, 0.5
N = 8192 * 2


def _numpy_reference(x):
    """Exact numpy mirror of the kernel body."""
    mfn = Legendre(R, DOMAIN, safe_eval=False)
    err = np.sqrt(1e-4 + np.abs(x))
    fine = x + FINE * err
    coarse = x + COARSE * err
    t_f = (fine - 0.0) * (2.0 / 8.0)
    t_c = (coarse - 0.0) * (2.0 / 8.0)
    valid = (np.abs(t_f) <= 1) & (np.abs(t_c) <= 1)
    pf = np.polynomial.legendre.legvander(t_f, R - 1) * valid[:, None]
    pc = np.polynomial.legendre.legvander(t_c, R - 1) * valid[:, None]
    d = pf - pc
    return dict(
        sums=d.sum(0), sums2=(d * d).sum(0),
        cov_f=pf.T @ pf, cov_c=pc.T @ pc, n_valid=valid.sum())


def test_kernel_exact_vs_numpy():
    rng = np.random.default_rng(0)
    # include values outside the domain to exercise the zero-column path
    x = np.concatenate([rng.normal(size=N - 64),
                        rng.uniform(3.2, 6.0, size=64)]).astype(np.float32)
    rng.shuffle(x)

    r = jax.tree.map(np.asarray, synth_moment_pipeline_from_noise(
        x, R, fine_step=FINE, coarse_step=COARSE, domain=DOMAIN,
        chunk=8192))
    ref = _numpy_reference(x.astype(np.float64))

    assert float(r.n_valid) == ref["n_valid"]
    assert np.allclose(r.sums, ref["sums"], rtol=1e-4, atol=1e-3)
    assert np.allclose(r.sums2, ref["sums2"], rtol=1e-4, atol=1e-3)
    assert np.allclose(r.cov_fine, ref["cov_f"], rtol=1e-4, atol=2e-2)
    assert np.allclose(r.cov_coarse, ref["cov_c"], rtol=1e-4, atol=2e-2)


def test_kernel_accumulates_across_chunks():
    """Two chunks == concatenation of per-chunk numpy results."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=N).astype(np.float32)
    r_all = jax.tree.map(np.asarray, synth_moment_pipeline_from_noise(
        x, R, fine_step=FINE, coarse_step=COARSE, domain=DOMAIN,
        chunk=8192))
    ref = _numpy_reference(x.astype(np.float64))
    assert np.allclose(r_all.sums, ref["sums"], rtol=1e-4, atol=1e-3)
    assert float(r_all.n_valid) == ref["n_valid"]


def test_precision_bound_vs_f64():
    """f32+Kahan fast tier vs exact f64 summation of the SAME f32
    per-sample values, asserted against the derived accumulation bound
    eps32 * C_BOUND * S_abs (ops/precision.py); bench.py and chip_smoke.py
    re-check the same bound at >= 1e7 samples on the device."""
    from mlmc_tpu.ops.precision import f64_reference_moments, check_against_f64

    n = 1 << 20
    x = np.random.default_rng(17).normal(size=n).astype(np.float32)
    r = jax.tree.map(np.asarray, synth_moment_pipeline_from_noise(
        x, 25, fine_step=0.25, coarse_step=0.5, domain=(-5, 5),
        chunk=8192))
    ref = f64_reference_moments(x, 25, fine_step=0.25, coarse_step=0.5,
                                domain=(-5, 5))
    report = check_against_f64(r, ref)  # raises if any bound is exceeded
    # empirical sanity on top of the formal bound
    assert max(report.values()) < 5e-6, report


def test_from_samples_generic():
    """Generic stored-sample pipeline vs numpy on arbitrary QoIs with NaNs."""
    from mlmc_tpu.ops.fused_estimate import moment_pipeline_from_samples

    rng = np.random.default_rng(5)
    n = 10000  # non-multiple of chunk -> tail padding path
    fine = rng.normal(0, 1.5, size=n)
    coarse = fine + rng.normal(0, 0.1, size=n)
    fine[::97] = np.nan  # masked results
    coarse[::131] = np.nan

    r = jax.tree.map(np.asarray, moment_pipeline_from_samples(
        fine, coarse, R, domain=DOMAIN, chunk=2048))

    mfn = Legendre(R, DOMAIN, safe_eval=False)
    t_f, t_c = fine / 4.0, coarse / 4.0
    valid = (~np.isnan(fine)) & (~np.isnan(coarse)) \
        & (np.abs(t_f) <= 1) & (np.abs(t_c) <= 1)
    pf = np.polynomial.legendre.legvander(np.nan_to_num(t_f), R - 1) \
        * valid[:, None]
    pc = np.polynomial.legendre.legvander(np.nan_to_num(t_c), R - 1) \
        * valid[:, None]
    d = pf - pc
    assert float(r.n_valid) == valid.sum()
    assert np.allclose(r.sums, d.sum(0), rtol=1e-4, atol=1e-3)
    assert np.allclose(r.cov_fine, pf.T @ pf, rtol=1e-4, atol=2e-2)


def test_from_samples_level0():
    from mlmc_tpu.ops.fused_estimate import moment_pipeline_from_samples

    rng = np.random.default_rng(8)
    fine = rng.normal(size=4096)
    r = jax.tree.map(np.asarray, moment_pipeline_from_samples(
        fine, np.zeros_like(fine), R, domain=DOMAIN, chunk=2048,
        is_level0=True))
    mfn_v = np.polynomial.legendre.legvander(fine / 4.0, R - 1)
    assert np.allclose(r.sums, mfn_v.sum(0), rtol=1e-4, atol=1e-3)
    assert np.allclose(r.cov_coarse, 0.0)


def test_samples_kernel_monomial_fourier():
    """Per-basis pipeline Vandermondes vs the Moments evaluators."""
    from mlmc_tpu.ops.fused_estimate import moment_pipeline_from_samples
    from mlmc_tpu.moments import Monomial, Fourier

    rng = np.random.default_rng(11)
    n = 4096
    fine = rng.uniform(0.5, 9.5, size=n)
    coarse = fine + rng.normal(0, 0.2, size=n)
    for mfn in [Monomial(7, (0, 10)), Fourier(7, (0, 10))]:
        basis = type(mfn).__name__.lower()
        r = jax.tree.map(np.asarray, moment_pipeline_from_samples(
            fine, coarse, mfn.size, domain=mfn.domain,
            ref_domain=tuple(mfn.ref_domain), basis=basis,
            chunk=2048))
        pf = np.asarray(mfn.eval_all(fine.astype(np.float32)))
        pc = np.asarray(mfn.eval_all(coarse.astype(np.float32)))
        valid = ~np.isnan(pf).any(1) & ~np.isnan(pc).any(1)
        d = np.nan_to_num(pf - pc) * valid[:, None]
        assert int(r.n_valid) == valid.sum(), basis
        assert np.allclose(r.sums, d.sum(0), rtol=1e-4, atol=1e-3), basis
        pf0 = np.nan_to_num(pf) * valid[:, None]
        assert np.allclose(r.cov_fine, pf0.T @ pf0, rtol=1e-4, atol=2e-2), basis


def test_fast_path_basis_guard():
    """estimate_moments_fast must reject bases the pipeline can't evaluate."""
    from mlmc_tpu import Memory, SynthSimulation, DeviceBatchPool, Sampler
    from mlmc_tpu import estimator as est_mod
    from mlmc_tpu.quantity.quantity import make_root_quantity
    from mlmc_tpu.moments import TransformedMoments

    sim = SynthSimulation(dict(distr="norm", complexity=2))
    storage = Memory()
    sampler = Sampler(storage, DeviceBatchPool(seed=3, min_bucket=64),
                      sim, [[0.1], [0.01]])
    sampler.set_initial_n_samples([64, 32])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    q = make_root_quantity(storage, q_specs=sim.result_format())
    vq = q["length"][1]["10"][0]

    mfn = Legendre(5, (-3, 3))
    est = est_mod.Estimate(vq, storage, mfn)
    with pytest.raises(NotImplementedError):
        est.estimate_moments_fast(TransformedMoments(mfn, np.eye(5)))
    with pytest.raises(NotImplementedError):
        est.estimate_moments_fast(Legendre(5, (0.1, 3), log=True))


def test_fast_path_vector_qoi():
    """Structured (time-series) quantity through the fused fast path."""
    from mlmc_tpu import Memory, SynthSimulation, DeviceBatchPool, Sampler
    from mlmc_tpu import estimator as est_mod
    from mlmc_tpu.quantity.quantity import make_root_quantity
    import mlmc_tpu.quantity.quantity_estimate as qe

    sim = SynthSimulation(dict(distr="norm", complexity=2))
    storage = Memory()
    sampler = Sampler(storage, DeviceBatchPool(seed=21, min_bucket=64),
                      sim, [[0.1], [0.01]])
    sampler.set_initial_n_samples([200, 60])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()

    q = make_root_quantity(storage, q_specs=sim.result_format())
    ts = q["length"]  # full time series x locations x (2,1) array, M=12
    mfn = Legendre(5, (-4, 4))
    est = est_mod.Estimate(ts, storage, mfn)
    means_fast, vars_fast = est.estimate_moments_fast(mfn)
    M = ts.qtype.size()
    assert means_fast.shape == (M, 5)

    ref = qe.estimate_mean(qe.moments(ts, mfn))
    ref_means = np.asarray(ref.mean).reshape(-1)
    assert np.allclose(means_fast.reshape(-1), ref_means, atol=5e-5)


def test_fused_level_moments_vector():
    """XLA fused tier with an M-component QoI vs per-component scalar runs."""
    import jax.numpy as jnp
    from mlmc_tpu.ops.fused_estimate import fused_level_moments

    mfn = Legendre(6, (-6, 6))
    level_key = jax.random.key(5)

    def vec_fn(keys):
        x = jax.vmap(lambda k: jax.random.normal(k, (3,)))(keys)
        scale = jnp.array([1.0, 2.0, 0.5])
        fine = x * scale
        coarse = fine + 0.1
        return fine, coarse, jnp.zeros(keys.shape[0], bool)

    acc = fused_level_moments(vec_fn, mfn, level_key, 4096, 1024,
                              is_level0=False)
    assert acc.sums.shape == (3, 6)
    assert acc.cov_fine.shape == (3, 6, 6)

    # component m of the vector run == a scalar run extracting component m
    for m in range(3):
        def scal_fn(keys, m=m):
            f, c, fl = vec_fn(keys)
            return f[:, m], c[:, m], fl
        acc_m = fused_level_moments(scal_fn, mfn, level_key, 4096, 1024,
                                    is_level0=False)
        # vector validity masks a sample when ANY component clips, so
        # compare on the no-clip components only (scale<=2 keeps |x|<6 for
        # nearly all draws; assert counts to catch real divergence)
        assert float(acc_m.n_valid) >= float(acc.n_valid)
        if float(acc_m.n_valid) == float(acc.n_valid):
            assert np.allclose(np.asarray(acc.sums[m]),
                               np.asarray(acc_m.sums), rtol=1e-10, atol=1e-8)


def test_estimate_moments_fast_matches_regular():
    """Fast path == regular estimate_mean on the same stored samples."""
    from mlmc_tpu import Memory, SynthSimulation, DeviceBatchPool, Sampler
    from mlmc_tpu import estimator as est_mod
    from mlmc_tpu.quantity.quantity import make_root_quantity
    from mlmc_tpu.random.distributions import Norm

    distr = Norm()
    sim = SynthSimulation(dict(distr=distr, complexity=2))
    storage = Memory()
    sampler = Sampler(storage, DeviceBatchPool(seed=13, min_bucket=64),
                      sim, [[0.1], [0.01]])
    sampler.set_initial_n_samples([300, 80])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()

    q = make_root_quantity(storage, q_specs=sim.result_format())
    vq = q["length"][1]["10"][0]
    mfn = Legendre(6, distr.ppf([0.001, 0.999]))
    est = est_mod.Estimate(vq, storage, mfn)
    means_ref, vars_ref = est.estimate_moments(mfn)
    means_fast, vars_fast = est.estimate_moments_fast(mfn)
    # fast path computes in f32 -> tolerance accordingly
    assert np.allclose(np.asarray(means_ref), means_fast, atol=5e-5)
    assert np.allclose(np.asarray(vars_ref), vars_fast, rtol=1e-3, atol=1e-7)


def test_fast_covariance_and_density():
    """Fast-tier covariance + full density pipeline vs the DAG path."""
    import mlmc_tpu.quantity.quantity_estimate as qe
    from mlmc_tpu import Memory, SynthSimulation, DeviceBatchPool, Sampler
    from mlmc_tpu import estimator as est_mod
    from mlmc_tpu.quantity.quantity import make_root_quantity
    from mlmc_tpu.random.distributions import Norm

    distr = Norm()
    sim = SynthSimulation(dict(distr=distr, complexity=2))
    storage = Memory()
    sampler = Sampler(storage, DeviceBatchPool(seed=31, min_bucket=64),
                      sim, [[0.2], [0.05]])
    sampler.set_initial_n_samples([800, 200])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()

    q = make_root_quantity(storage, q_specs=sim.result_format())
    vq = q["length"][1]["10"][0]
    mfn = Legendre(9, distr.ppf([0.0005, 0.9995]))
    est = est_mod.Estimate(vq, storage, mfn)

    cov_fast, mean_fast = est.estimate_covariance_fast(mfn)
    cov_ref = np.asarray(qe.estimate_mean(qe.covariance(vq, mfn)).mean)
    assert np.allclose(cov_fast, cov_ref, atol=5e-5)

    d_fast, info_f, res_f, _ = est.construct_density_fast(tol=1e-8)
    d_ref, info_r, res_r, _ = est.construct_density(tol=1e-8)
    xs = np.linspace(-2.5, 2.5, 101)
    pdf_f = np.asarray(d_fast.density(xs), dtype=float)
    pdf_r = np.asarray(d_ref.density(xs), dtype=float)
    assert np.max(np.abs(pdf_f - pdf_r)) < 5e-4, np.max(np.abs(pdf_f - pdf_r))


def test_multi_level_pipeline_pow2_padding():
    """pack_level_samples pads chunk counts to powers of two (executable
    reuse across adaptive rounds); results match per-level runs on
    non-pow2 multi-chunk levels."""
    from mlmc_tpu.ops.fused_estimate import (
        mlmc_moment_pipeline_from_samples, pack_level_samples,
        moment_pipeline_from_samples)

    rng = np.random.default_rng(3)
    lf = [rng.normal(size=3 * 1024 + 77), rng.normal(size=5 * 1024 + 5)]
    lc = [None, lf[1] + 0.1 * rng.normal(size=len(lf[1]))]
    f, c, counts = pack_level_samples(lf, lc, chunk=1024)
    assert f.shape[0] == (4 + 8) * 1024
    res = mlmc_moment_pipeline_from_samples(
        f, c, counts, 7, domain=(-4, 4), chunk=1024)
    for lvl in range(2):
        single = moment_pipeline_from_samples(
            lf[lvl],
            np.zeros_like(lf[lvl]) if lc[lvl] is None else lc[lvl], 7,
            domain=(-4, 4), chunk=1024, is_level0=(lvl == 0))
        assert int(res[lvl].n_valid) == int(single.n_valid)
        assert np.allclose(np.asarray(res[lvl].sums),
                           np.asarray(single.sums), atol=1e-4)


def test_fast_covariance_vector_qoi():
    """estimate_covariance_fast for a structured quantity: per-component
    [M, R, R] blocks from ONE packed dispatch, each block matching a
    scalar-view fast covariance of that component."""
    from mlmc_tpu import Memory, SynthSimulation, DeviceBatchPool, Sampler
    from mlmc_tpu import estimator as est_mod
    from mlmc_tpu.quantity.quantity import make_root_quantity
    from mlmc_tpu.random.distributions import Norm

    sim = SynthSimulation(dict(distr=Norm()))
    storage = Memory()
    sampler = Sampler(storage, DeviceBatchPool(seed=3), sim,
                      [[0.2], [0.05]])
    sampler.set_initial_n_samples([600, 200])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()

    root = make_root_quantity(storage, q_specs=sim.result_format())
    ts = root["length"][1]            # one time slice: 2 locations x (2,1)
    mfn = Legendre(6, (-10.0, 10.0))
    est = est_mod.Estimate(ts, storage, mfn)
    cov, mean = est.estimate_covariance_fast()
    M = ts.qtype.size()
    assert cov.shape == (M, 6, 6) and mean.shape == (M, 6)

    # component 0 as a scalar view reproduces block 0
    scalar_est = est_mod.Estimate(ts["10"][0], storage, mfn)
    cov0, mean0 = scalar_est.estimate_covariance_fast()
    assert np.allclose(cov0, cov[0], atol=1e-6)
    assert np.allclose(mean0, mean[0], atol=1e-6)
    # symmetric PSD-ish blocks with unit P0 diagonal
    for m in range(M):
        assert np.allclose(cov[m], cov[m].T, atol=1e-6)
        assert abs(cov[m][0, 0] - 1.0) < 1e-6


def test_stored_pipeline_executable_reuse():
    """Per-level counts are DYNAMIC: adaptive rounds with grown counts but
    the same pow2-padded chunk structure must reuse the compiled
    executable; a structure change recompiles (review finding)."""
    from mlmc_tpu.ops.fused_estimate import (
        mlmc_moment_pipeline_from_samples, pack_level_samples,
        _samples_mlmc_dispatch)

    def run(n0, n1):
        rng = np.random.default_rng(n0)
        f0, f1 = rng.normal(size=n0), rng.normal(size=n1)
        fine, coarse, counts = pack_level_samples(
            [f0, f1], [None, f1 * 0.9], chunk=1024)
        return mlmc_moment_pipeline_from_samples(
            fine, coarse, counts, 5, domain=(-5.0, 5.0), chunk=1024)

    run(900, 400)
    c1 = _samples_mlmc_dispatch._cache_size()
    res = run(1000, 700)          # grown counts, same padded structure
    assert _samples_mlmc_dispatch._cache_size() == c1
    assert [float(r.n_valid) for r in res] == [1000.0, 700.0]
    run(1500, 400)                # level 0 crosses a pow2 boundary
    assert _samples_mlmc_dispatch._cache_size() == c1 + 1


def test_packed_program_matches_eager_fallback():
    """The fully-fused packed program (DAG eval + packing + estimate in ONE
    dispatch) must agree with the eager non-traceable fallback, and
    estimate_diff_vars_fast must match estimate_diff_vars."""
    from mlmc_tpu import Memory, SynthSimulation, DeviceBatchPool, Sampler
    from mlmc_tpu import estimator as est_mod
    from mlmc_tpu.quantity.quantity import make_root_quantity
    from mlmc_tpu.random.distributions import Norm

    distr = Norm()
    sim = SynthSimulation(dict(distr=distr, complexity=2))
    storage = Memory()
    sampler = Sampler(storage, DeviceBatchPool(seed=47, min_bucket=64),
                      sim, [[0.2], [0.05], [0.01]])
    sampler.set_initial_n_samples([500, 150, 40])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()

    q = make_root_quantity(storage, q_specs=sim.result_format())
    vq = q["length"][1]["10"][0]
    mfn = Legendre(7, distr.ppf([0.001, 0.999]))

    est = est_mod.Estimate(vq, storage, mfn)
    assert vq.traceable()
    means_traced, vars_traced = est.estimate_moments_fast(mfn)

    # identical quantity with traceability broken -> eager fallback branch
    vq2 = q["length"][1]["10"][0]
    vq2._traceable = False
    est2 = est_mod.Estimate(vq2, storage, mfn)
    means_eager, vars_eager = est2.estimate_moments_fast(mfn)
    assert np.allclose(means_traced, means_eager, rtol=1e-6, atol=1e-7)
    assert np.allclose(vars_traced, vars_eager, rtol=1e-5, atol=1e-9)

    # diff vars fast vs the DAG path
    l_vars_fast, ns_fast = est.estimate_diff_vars_fast(mfn)
    l_vars_ref, ns_ref = est.estimate_diff_vars(mfn)
    assert l_vars_fast.shape == np.asarray(l_vars_ref).shape
    assert list(ns_fast) == list(ns_ref)
    assert np.allclose(l_vars_fast, np.asarray(l_vars_ref),
                       rtol=5e-4, atol=1e-8)


# ------------------------------------------------------------------ #
# extended (float64) precision tier
# ------------------------------------------------------------------ #
def test_extended_noise_kernel_meets_df_bound():
    """Float64 extended tier vs the strict ALL-f64 reference on identical
    f32 QoIs: sums/sums2 must meet the derived f64 bound (the 1e-10 north
    star, SURVEY §6), the covariance 1e-10 relative to S_abs."""
    from mlmc_tpu.ops.fused_estimate import (
        synth_moment_pipeline_from_noise_extended)
    from mlmc_tpu.ops.precision import (
        f64_reference_moments_strict, check_extended_against_f64)

    n = 24 * 8192
    x = np.random.default_rng(7).normal(size=n).astype(np.float32)
    r = synth_moment_pipeline_from_noise_extended(
        x, 25, fine_step=0.25, coarse_step=0.5, domain=(-4, 4))
    ref = f64_reference_moments_strict(
        x, 25, fine_step=0.25, coarse_step=0.5, domain=(-4, 4))
    report = check_extended_against_f64(r, ref, n)  # raises on violation
    assert report["sums"] < 1e-12
    assert report["sums2"] < 1e-12
    assert report["cov_fine"] < 1e-10


def test_extended_tier_float64_with_x64_off():
    """The extended tier scopes float64 to its own call: with the global
    x64 flag OFF (a user's default) it still returns float64 accumulators
    that meet the strict all-f64 reference at the same bound."""
    from mlmc_tpu.ops.fused_estimate import (
        synth_moment_pipeline_from_noise_extended)
    from mlmc_tpu.ops.precision import (
        f64_reference_moments_strict, check_extended_against_f64)

    n = 4 * 8192
    x = np.random.default_rng(9).normal(size=n).astype(np.float32)
    with jax.enable_x64(False):
        r = synth_moment_pipeline_from_noise_extended(
            x, 25, fine_step=0.25, coarse_step=0.5, domain=(-4, 4))
        assert not jax.config.jax_enable_x64
    assert r.sums.dtype == np.float64 and r.cov_fine.dtype == np.float64
    ref = f64_reference_moments_strict(
        x, 25, fine_step=0.25, coarse_step=0.5, domain=(-4, 4))
    report = check_extended_against_f64(r, ref, n)  # raises on violation
    assert report["sums"] < 1e-12
    assert report["cov_fine"] < 1e-10


def test_extended_from_samples_bases_and_nan():
    """From-samples extended path: legendre + monomial, NaN dropping,
    level-0 semantics, vs a direct all-f64 computation."""
    from mlmc_tpu.ops.fused_estimate import (
        moment_pipeline_from_samples_extended)

    rng = np.random.default_rng(11)
    n = 3000
    fine = rng.normal(0.2, 0.8, size=n).astype(np.float32)
    coarse = (fine + rng.normal(0, 0.05, size=n)).astype(np.float32)
    fine[::71] = np.nan
    domain = (-3.5, 3.5)
    a, b = domain

    for basis in ("legendre", "monomial"):
        ref_lo, ref_hi = (-1.0, 1.0) if basis == "legendre" else (0.0, 1.0)
        scale = (ref_hi - ref_lo) / (b - a)
        t_f = (fine.astype(np.float64) - a) * scale + ref_lo
        t_c = (coarse.astype(np.float64) - a) * scale + ref_lo
        valid = ((t_f >= ref_lo) & (t_f <= ref_hi)
                 & (t_c >= ref_lo) & (t_c <= ref_hi))
        R = 9

        def rows(t):
            t = np.where(valid, t, 0.0)
            phi = np.zeros((R, n))
            phi[0] = valid.astype(float)
            phi[1] = t
            for k in range(2, R):
                if basis == "legendre":
                    phi[k] = ((2 * k - 1) * t * phi[k - 1]
                              - (k - 1) * phi[k - 2]) / k
                else:
                    phi[k] = phi[k - 1] * t
            return phi

        dphi = rows(t_f) - rows(t_c)
        r = moment_pipeline_from_samples_extended(
            fine, coarse, R, domain=domain, ref_domain=(ref_lo, ref_hi),
            basis=basis, chunk=1024)
        assert r.n_valid == int(valid.sum())
        s_abs = np.abs(dphi).sum(axis=1)
        dev = np.abs(r.sums - dphi.sum(axis=1)) / np.maximum(s_abs, 1.0)
        assert np.max(dev) < 1e-11, (basis, np.max(dev))

    # level 0: fine only, coarse ignored
    r0 = moment_pipeline_from_samples_extended(
        fine, None, 5, domain=domain, is_level0=True, chunk=1024)
    t_f = (fine.astype(np.float64) - a) * (2 / (b - a)) - 1.0
    valid0 = (t_f >= -1) & (t_f <= 1)
    assert r0.n_valid == int(valid0.sum())
    assert abs(r0.sums[0] - valid0.sum()) < 1e-9


def test_extended_fourier_tracks_f64():
    """Fourier extended tier: float64 sin/cos of the transformed f32 QoIs
    track an all-f64 numpy pipeline on identical inputs."""
    from mlmc_tpu.ops.fused_estimate import (
        moment_pipeline_from_samples_extended)

    rng = np.random.default_rng(5)
    n = 3000
    fine = rng.normal(0.2, 0.8, size=n).astype(np.float32)
    coarse = (fine + rng.normal(0, 0.05, size=n)).astype(np.float32)
    fine[::97] = np.nan
    domain = (-3.5, 3.5)
    a, b = domain
    two_pi = 2.0 * np.pi
    R = 9

    scale = two_pi / (b - a)
    t_f = (fine.astype(np.float64) - a) * scale
    t_c = (coarse.astype(np.float64) - a) * scale
    valid = (t_f >= 0) & (t_f <= two_pi) & (t_c >= 0) & (t_c <= two_pi)

    def rows(t):
        t = np.where(valid, t, 0.0)
        phi = np.zeros((R, n))
        phi[0] = valid.astype(float)
        k = np.arange(1, R // 2 + 1)
        kx = t[None, :] * k[:, None]
        phi[1::2] = np.cos(kx)[: (R - 1 + 1) // 2] * valid
        phi[2::2] = np.sin(kx)[: (R - 1) // 2] * valid
        return phi

    dphi = rows(t_f) - rows(t_c)
    r = moment_pipeline_from_samples_extended(
        fine, coarse, R, domain=domain, ref_domain=(0.0, two_pi),
        basis="fourier", chunk=1024)
    assert r.n_valid == int(valid.sum())
    s_abs = np.abs(dphi).sum(axis=1)
    dev = np.abs(r.sums - dphi.sum(axis=1)) / np.maximum(s_abs, 1.0)
    assert np.max(dev) < 1e-11, np.max(dev)
    # covariance blocks too (8-bit split path needs |phi| <= 1: holds)
    pf = rows(t_f)
    cov_ref = pf @ pf.T
    dev_c = np.abs(r.cov_fine - cov_ref) / np.maximum(np.abs(pf) @ np.abs(pf).T, 1.0)
    assert np.max(dev_c) < 1e-9, np.max(dev_c)


def test_estimate_moments_extended_matches_f64_dag():
    """Production wrapper: the extended tier must match the f64 DAG path
    (tests run x64, so estimate_moments IS the all-f64 pipeline) to
    1e-10-grade — the SURVEY §6 parity target on stored samples.

    The tier consumes payloads as f32 (what a device store holds); under the
    x64 CPU test env the pool produces f64 values, so the store is
    quantized to f32 first to make both pipelines see identical inputs."""
    from mlmc_tpu import Memory, SynthSimulation, DeviceBatchPool, Sampler
    from mlmc_tpu import estimator as est_mod
    from mlmc_tpu.quantity.quantity import make_root_quantity
    from mlmc_tpu.random.distributions import Norm

    distr = Norm()
    sim = SynthSimulation(dict(distr=distr, complexity=2))
    storage = Memory()
    sampler = Sampler(storage, DeviceBatchPool(seed=29, min_bucket=64),
                      sim, [[0.2], [0.05]])
    sampler.set_initial_n_samples([4000, 1000])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    for st in storage._levels.values():
        st._segments = [np.float64(np.float32(seg))
                        for seg in st._segments]

    q = make_root_quantity(storage, q_specs=sim.result_format())
    vq = q["length"][1]["10"][0]
    mfn = Legendre(9, distr.ppf([0.001, 0.999]))
    est = est_mod.Estimate(vq, storage, mfn)

    means_ref, vars_ref = est.estimate_moments(mfn)     # f64 DAG (x64)
    means_ext, vars_ext = est.estimate_moments_extended(mfn)
    assert np.allclose(means_ext, np.asarray(means_ref),
                       rtol=1e-10, atol=1e-12)
    assert np.allclose(vars_ext, np.asarray(vars_ref),
                       rtol=1e-8, atol=1e-14)

    cov_ext, mean_ext = est.estimate_covariance_extended(mfn)
    cov_ref = np.asarray(est.estimate_covariance(mfn)[0])
    assert np.allclose(cov_ext, cov_ref, rtol=1e-8, atol=1e-10)


def test_strict_reference_accepts_qoi_bits():
    """f64_reference_moments_strict(fine32=, coarse32=) must equal the
    noise-derived path when the QoI transform matches bitwise (XLA:CPU
    sqrt == numpy sqrt); against a device run only the bits-passing form
    is valid (a device's f32 sqrt need not match numpy's)."""
    from mlmc_tpu.ops.precision import f64_reference_moments_strict

    x = np.random.default_rng(3).normal(size=50_000).astype(np.float32)
    err = np.sqrt(np.float32(1e-4) + np.abs(x), dtype=np.float32)
    fine = x + np.float32(0.25) * err
    coarse = x + np.float32(0.5) * err

    via_noise = f64_reference_moments_strict(
        x, 12, fine_step=0.25, coarse_step=0.5, domain=(-4, 4))
    via_bits = f64_reference_moments_strict(
        n_moments=12, domain=(-4, 4), fine32=fine, coarse32=coarse)
    assert via_bits["n_valid"] == via_noise["n_valid"]
    for key in ("sums", "sums2", "cov_fine", "cov_coarse", "abs_sums"):
        assert np.array_equal(via_bits[key], via_noise[key]), key


def test_structured_diff_vars_shared_validity():
    """Structured fast-tier diff vars share any-component validity with
    the DAG tier: a narrowed moment domain clips components differently,
    yet every stream must report the SAME per-level count — equal to the
    DAG path's — and matching variances (both fused and eager branches)."""
    from mlmc_tpu import Memory, SynthSimulation, DeviceBatchPool, Sampler
    from mlmc_tpu import estimator as est_mod
    from mlmc_tpu.quantity.quantity import make_root_quantity
    import mlmc_tpu.quantity.quantity_estimate as qe

    sim = SynthSimulation(dict(distr="norm", complexity=2))
    storage = Memory()
    sampler = Sampler(storage, DeviceBatchPool(seed=33, min_bucket=64),
                      sim, [[0.1], [0.01]])
    sampler.set_initial_n_samples([300, 80])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()

    q = make_root_quantity(storage, q_specs=sim.result_format())
    ts = q["length"]                       # M=12 structured quantity
    # narrow domain -> per-component clipping genuinely diverges
    mfn = Legendre(5, (-1.5, 1.5))
    dag = qe.estimate_mean(qe.moments(ts, mfn))
    ns_dag = np.asarray(dag.n_samples)
    assert ns_dag.min() > 1  # the scenario must keep some valid samples

    for force_eager in (False, True):
        est = est_mod.Estimate(ts, storage, mfn)
        if force_eager:
            ts_e = make_root_quantity(storage,
                                      q_specs=sim.result_format())["length"]
            ts_e.traceable = lambda: False   # exercise the eager branch
            est = est_mod.Estimate(ts_e, storage, mfn)
        raw_fast, ns_fast = est.estimate_diff_vars_fast()
        assert np.array_equal(ns_fast, ns_dag.astype(int)), (
            force_eager, ns_fast, ns_dag)
        dag_vars = np.asarray(dag.l_vars).reshape(raw_fast.shape)
        assert np.allclose(raw_fast, dag_vars, rtol=1e-3, atol=1e-7), (
            force_eager, np.abs(raw_fast - dag_vars).max())


def test_fast_tier_with_empty_trailing_level():
    """A scheduled-but-empty level must flow through the packed fast tier
    as an empty stream (inf diff-var, zero count) without misaligning the
    per-level split or the positional has-coarse flags."""
    from mlmc_tpu import DeviceMemory, SynthSimulation, DeviceBatchPool, Sampler
    from mlmc_tpu import estimator as est_mod
    from mlmc_tpu.quantity.quantity import make_root_quantity

    sim = SynthSimulation(dict(distr="norm", complexity=2))
    storage = DeviceMemory()
    sampler = Sampler(storage, DeviceBatchPool(seed=41, min_bucket=64,
                                               device_results=True),
                      sim, [[0.5], [0.25], [0.125], [0.0625], [0.03125]])
    # the last level becomes known to the storage (scheduled) but never
    # collects anything — the all-failed / not-yet-drained async scenario
    sampler.set_initial_n_samples([200, 120, 80, 60, 0])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    storage.save_scheduled_samples(4, ["L04_S0000000"])
    assert storage.get_n_levels() == 5
    assert storage.get_n_collected()[4] == 0

    q = make_root_quantity(storage, q_specs=sim.result_format())
    vq = q["length"][1]["10"][0, 0]
    mfn = Legendre(5, (-4.0, 4.0))
    est = est_mod.Estimate(vq, storage, mfn)
    raw, ns = est.estimate_diff_vars_fast()
    assert raw.shape[0] == 5
    assert ns.tolist() == [200, 120, 80, 60, 0]
    assert np.all(np.isinf(raw[4]))
    means, _vars = est.estimate_moments_fast(mfn)
    assert means[0] == 1.0 and np.all(np.isfinite(means))
    # the regression fills the empty level with a finite prediction
    vars_, _ = est.estimate_diff_vars_regression(
        [200, 120, 80, 60, 0], raw_vars=raw)
    assert np.all(np.isfinite(vars_))


def test_packed_results_cache_per_storage_state():
    """Fast moment/cov/diff-vars tiers within one adaptive round share
    ONE dispatch: results memoize per collected-count state, invalidate
    when the store grows, and cache=False forces a fresh dispatch
    (each avoided dispatch saves a device round trip)."""
    from mlmc_tpu import Memory, SynthSimulation, DeviceBatchPool, Sampler
    from mlmc_tpu import estimator as est_mod
    from mlmc_tpu.quantity.quantity import make_root_quantity
    from mlmc_tpu.random.distributions import Norm

    distr = Norm()
    sim = SynthSimulation(dict(distr=distr, complexity=2))
    storage = Memory()
    sampler = Sampler(storage, DeviceBatchPool(seed=5, min_bucket=64),
                      sim, [[0.1], [0.01]])
    sampler.set_initial_n_samples([256, 64])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()

    q = make_root_quantity(storage, q_specs=sim.result_format())
    vq = q["length"][1]["10"][0]
    mfn = Legendre(6, distr.ppf([0.001, 0.999]))
    est = est_mod.Estimate(vq, storage, mfn)

    means1, _ = est.estimate_moments_fast(mfn)
    keys1 = set(est._packed_results_cache)
    assert keys1
    flat1 = next(iter(est._packed_results_cache.values()))
    means2, _ = est.estimate_moments_fast(mfn)     # hit: same object back
    assert next(iter(est._packed_results_cache.values())) is flat1
    np.testing.assert_array_equal(means1, means2)
    dv1, ns1 = est.estimate_diff_vars_fast(mfn)    # same dispatch family

    # growing the store invalidates every cached result
    sampler.set_initial_n_samples([512, 128])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    dv2, ns2 = est.estimate_diff_vars_fast(mfn)
    assert ns2.sum() > ns1.sum()
    state = tuple(int(x) for x in storage.get_n_collected())
    assert all(k[0] == state for k in est._packed_results_cache)

    # bypass: cache=False recomputes without touching the cache
    n_keys = len(est._packed_results_cache)
    r = est._fast_results_packed(mfn, [0], cache=False)
    assert len(est._packed_results_cache) == n_keys
    assert np.isfinite(float(r[0][0].n_valid))


def test_zero_sample_level_returns_zeros_not_garbage():
    """A level with zero samples must come back as ZEROED accumulators
    (round-5 review finding); mismatched per-stream lengths must raise
    instead of silently truncating via zip."""
    from mlmc_tpu.ops.fused_estimate import (
        mlmc_moment_pipeline_from_samples, pack_level_samples,
        packed_level_moments)

    x = np.random.default_rng(3).normal(size=2048).astype(np.float32)
    fine, coarse, counts = pack_level_samples(
        [x, np.zeros(0, np.float32)], [None, np.zeros(0, np.float32)],
        chunk=1024)
    res = mlmc_moment_pipeline_from_samples(fine, coarse, counts, 8,
                                            domain=(-4.0, 4.0), chunk=1024)
    empty = res[1]
    assert int(empty.n_valid) == 0
    assert np.all(np.asarray(empty.sums) == 0.0)
    assert np.all(np.asarray(empty.cov_fine) == 0.0)
    assert int(res[0].n_valid) > 0

    with pytest.raises(ValueError, match="entries"):
        packed_level_moments(fine, coarse, np.asarray([2048, 0, 0]),
                             n_moments=8, chunks_per_level=(2, 1),
                             has_coarse=(False, True), domain=(-4.0, 4.0),
                             chunk=1024)
