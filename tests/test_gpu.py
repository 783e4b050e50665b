"""Checks that need an NVIDIA GPU (marker ``gpu``).

On the GPU a float32 contraction may run in TF32 (a 10-bit mantissa)
unless it asks for full precision, and the float64 tiers run natively.
Each test skips elsewhere. ``chip_smoke.py`` runs this file on the card;
so does ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _needs_gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


def test_fast_tier_covariance_within_f32_bound():
    """Float32 fast tier, covariance included, within eps32*C_BOUND*S_abs
    of an exact f64 summation at 4M samples: a TF32 covariance would be
    off by ~1e-3 relative."""
    from mlmc_tpu.ops.fused_estimate import synth_moment_pipeline_from_noise
    from mlmc_tpu.ops.precision import (check_against_f64,
                                        f64_reference_moments)

    n = 1 << 22
    x = jax.random.normal(jax.random.key(3), (n,), jnp.float32)
    with jax.enable_x64(False):
        r = jax.tree.map(np.asarray, synth_moment_pipeline_from_noise(
            x, 25, fine_step=0.25, coarse_step=0.5, domain=(-4, 4)))
    ref = f64_reference_moments(np.asarray(x), 25, fine_step=0.25,
                                coarse_step=0.5, domain=(-4, 4))
    report = check_against_f64(r, ref, include_cov=True)
    assert max(report.values()) < 5e-6, report


def test_extended_tier_native_f64():
    """The extended tier runs in native float64 on the card with the
    global x64 flag off and meets the strict all-f64 reference."""
    from mlmc_tpu.ops.fused_estimate import (
        moment_pipeline_from_samples_extended, synth_qoi)
    from mlmc_tpu.ops.precision import (check_extended_against_f64,
                                        f64_reference_moments_strict)

    n = 1 << 21
    x = jax.random.normal(jax.random.key(4), (n,), jnp.float32)
    with jax.enable_x64(False):
        fine, coarse = synth_qoi(x, 0.25, 0.5)
        r = moment_pipeline_from_samples_extended(fine, coarse, 25,
                                                  domain=(-4, 4))
    ref = f64_reference_moments_strict(
        n_moments=25, domain=(-4, 4), fine32=np.asarray(fine),
        coarse32=np.asarray(coarse))
    report = check_extended_against_f64(r, ref, n)
    assert report["sums"] < 1e-12 and report["cov_fine"] < 1e-10, report


def test_maxent_device_backend_is_f64():
    """The device maxent Newton (solver_backend 'auto' -> 'jax') matches
    the numpy f64 backend's density on the card with x64 off."""
    import scipy.stats as stats
    import mlmc_tpu.tool.simple_distribution as sd
    from mlmc_tpu.moments import Legendre

    domain = (-3.0, 3.0)
    mfn = Legendre(16, domain, safe_eval=False)
    pdf = stats.norm(0, 1).pdf
    cov = sd.compute_semiexact_cov(mfn, pdf, tol=1e-13)
    orto, _info = sd.construct_ortogonal_moments(mfn, cov, tol=1e-10)
    exact = sd.compute_semiexact_moments(orto, pdf, tol=1e-13)
    data = np.stack((exact, np.ones(orto.size)), axis=1)
    xs = np.linspace(*domain, 501)
    dens = {}
    for backend in ("auto", "numpy"):
        d = sd.SimpleDistribution(orto, data, domain=domain,
                                  solver_backend=backend)
        with jax.enable_x64(False):
            assert d.estimate_density_minimize(tol=1e-10).success
        dens[backend] = d.density(xs)
    assert np.abs(dens["auto"] - dens["numpy"]).max() < 1e-9


def test_basis_transform_full_precision():
    """Orthogonalized-basis evaluation (a float32 matmul) keeps float32
    accuracy on the card instead of TF32's ~1e-3."""
    from mlmc_tpu.moments import Legendre, TransformedMoments

    rng = np.random.default_rng(0)
    mat = rng.normal(size=(20, 20))
    tm = TransformedMoments(Legendre(20, (-1.0, 1.0)), mat)
    x = rng.uniform(-1, 1, size=4096)
    with jax.enable_x64(False):
        got = np.asarray(jax.jit(tm.eval_all)(jnp.asarray(x, jnp.float32)))
    want = np.polynomial.legendre.legvander(
        x.astype(np.float32).astype(np.float64), 19) @ mat.T
    scale = np.abs(np.polynomial.legendre.legvander(x, 19)) @ np.abs(mat.T)
    assert np.max(np.abs(got - want) / scale) < 1e-5
