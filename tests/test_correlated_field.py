"""Statistical convergence of the GRF generators.

Mirrors reference test/test_correlated_field.py (impl_test_mu_sigma :139,
impl_test_cov_func :271): MC convergence of pointwise mean/sigma and of the
covariance function, for SVD/KL, spectral, and circulant-embedding
generators.
"""
import numpy as np
import pytest
import jax

from mlmc_tpu.random.correlated_field import (
    SpatialCorrelatedField,
    SpectralCorrelatedField,
    CirculantEmbeddingField,
    Field,
    Fields,
    positive_to_range,
    kozeny_carman,
)


def _mc_moments(field, key, n_samples):
    """Pointwise MC mean and variance over n_samples realizations."""
    samples = np.stack([
        np.asarray(field.sample(jax.random.fold_in(key, i)))
        for i in range(n_samples)
    ])
    return samples.mean(axis=0), samples.var(axis=0), samples


def _points_2d(n, rng):
    return rng.uniform(0, 5, size=(n, 2))


@pytest.mark.parametrize("corr_exp", ["gauss", "exp"])
def test_svd_field_mu_sigma(corr_exp):
    rng = np.random.default_rng(0)
    pts = _points_2d(60, rng)
    f = SpatialCorrelatedField(corr_exp=corr_exp, dim=2, corr_length=1.5,
                               mu=2.0, sigma=0.5)
    f.set_points(pts)
    f.svd_dcmp(precision=1e-4, n_terms_range=(10, 60))
    mu, var, _ = _mc_moments(f, jax.random.key(1), 800)
    assert np.abs(mu - 2.0).max() < 0.15
    assert np.abs(np.sqrt(var) - 0.5).max() < 0.12


def test_svd_cov_func():
    """Empirical covariance matches c(r) = exp(-(r/L)^2)."""
    rng = np.random.default_rng(3)
    pts = _points_2d(40, rng)
    L = 1.2
    f = SpatialCorrelatedField(corr_exp="gauss", dim=2, corr_length=L)
    f.set_points(pts)
    f.svd_dcmp(precision=1e-6, n_terms_range=(10, 40))
    _, _, samples = _mc_moments(f, jax.random.key(2), 3000)
    emp_cov = np.cov(samples.T)
    d = pts[:, None, :] - pts[None, :, :]
    r2 = np.sum(d * d, axis=-1)
    exact = np.exp(-r2 / L ** 2)
    assert np.abs(emp_cov - exact).max() < 0.12


@pytest.mark.parametrize("corr_exp", ["gauss", "exp"])
def test_spectral_field_cov(corr_exp):
    rng = np.random.default_rng(5)
    pts = _points_2d(30, rng)
    L = 1.0
    f = SpectralCorrelatedField(corr_exp=corr_exp, dim=2, corr_length=L,
                                mode_no=2000, seed=42)
    f.set_points(pts)
    _, _, samples = _mc_moments(f, jax.random.key(7), 2500)
    emp_cov = np.cov(samples.T)
    d = pts[:, None, :] - pts[None, :, :]
    r = np.sqrt(np.sum(d * d, axis=-1))
    alpha = 2.0 if corr_exp == "gauss" else 1.0
    exact = np.exp(-(r / L) ** alpha)
    # spectral method has O(1/sqrt(modes)) bias + MC noise
    assert np.abs(emp_cov - exact).max() < 0.2, np.abs(emp_cov - exact).max()


@pytest.mark.parametrize("corr_exp", ["gauss", "exp"])
def test_circulant_embedding_exact_cov(corr_exp):
    """Circulant embedding is exact: tight covariance convergence on grid."""
    n = 16
    step = 0.3
    L = 0.9
    f = CirculantEmbeddingField(corr_exp=corr_exp, dim=2, corr_length=L,
                                grid_shape=(n, n), grid_step=step,
                                pad_factor=4 if corr_exp == "exp" else 2)
    key = jax.random.key(11)
    n_s = 4000
    samples = np.stack([
        np.asarray(f.sample(jax.random.fold_in(key, i))) for i in range(n_s)])
    emp_cov = np.cov(samples.T)
    pts = f.points
    d = pts[:, None, :] - pts[None, :, :]
    r = np.sqrt(np.sum(d * d, axis=-1))
    alpha = 2.0 if corr_exp == "gauss" else 1.0
    exact = np.exp(-(r / L) ** alpha)
    err = np.abs(emp_cov - exact).max()
    assert err < 0.15, err
    # mean/sigma
    assert np.abs(samples.mean(axis=0)).max() < 0.12
    assert np.abs(samples.std(axis=0) - 1).max() < 0.1


def test_circulant_vmap_jit():
    """Sampling is pure & traceable: vmapped batch of fields in one jit."""
    import jax.numpy as jnp

    f = CirculantEmbeddingField(corr_exp="gauss", dim=2, corr_length=1.0,
                                grid_shape=(8, 8), grid_step=0.5)
    keys = jax.random.split(jax.random.key(0), 32)
    batch = jax.jit(jax.vmap(f.sample))(keys)
    assert batch.shape == (32, 64)
    assert bool(jnp.all(jnp.isfinite(batch)))


def test_fields_composition():
    """Fields/Field dependency graph: derived fields + region restriction."""
    rng = np.random.default_rng(0)
    rf = SpatialCorrelatedField(corr_exp="gauss", dim=2, corr_length=2.0, log=True)
    fields = Fields([
        Field("por", rf, regions="ground"),
        Field("porosity", positive_to_range, ["por", 0.02, 0.1], regions="ground"),
        Field("conductivity", kozeny_carman, ["porosity", 1, 1e-8, 8.9e-4],
              regions="ground"),
    ])
    pts = _points_2d(25, rng)
    fields.set_points(pts, region_ids=[0] * 25, region_map={"ground": 0})
    fields.set_outer_fields(["conductivity"])
    out = fields.sample(jax.random.key(1))
    assert set(out.keys()) == {"conductivity"}
    assert out["conductivity"].shape == (25,)
    assert np.all(out["conductivity"] > 0)


def test_fields_forward_reference_rejected():
    """A derived field may only reference already-declared fields:
    evaluation follows declaration order, so a forward reference would
    read a stale or missing realization."""
    import pytest
    from mlmc_tpu.random.correlated_field import (Field, Fields,
                                                  SpectralCorrelatedField)

    rf = SpectralCorrelatedField(corr_exp="gauss", dim=2, corr_length=1.0,
                                 mode_no=16)
    with pytest.raises(KeyError, match="before its definition"):
        Fields([Field("K", np.exp, ["logk"]),
                Field("logk", rf)])


def test_fields_region_args_must_pair():
    """Passing region ids without the name->id map (or vice versa) is an
    error — defaulting one of them would silently select zero points."""
    import pytest
    from mlmc_tpu.random.correlated_field import (Field, Fields,
                                                  SpectralCorrelatedField)

    rf = SpectralCorrelatedField(corr_exp="gauss", dim=2, corr_length=1.0,
                                 mode_no=16)
    fields = Fields([Field("k", rf, regions="ground")])
    pts = np.random.default_rng(0).uniform(size=(10, 2))
    with pytest.raises(ValueError, match="together"):
        fields.set_points(pts, region_ids=[1] * 10)   # ids without map
    with pytest.raises(ValueError, match="together"):
        fields.set_points(pts, region_map={"ground": 1})  # map without ids
    fields.set_points(pts)  # no regions at all: every point, every field
    assert fields.sample()["k"].shape == (10,)


def test_circulant_matmul_dft_matches_fftn():
    """The matmul-DFT path of the circulant sampler must reproduce the
    fftn path exactly (same key, same eigenvalues): the six-matmul form is
    the SAME transform with the crop folded into the DFT row count, so any
    deviation beyond rounding is a construction bug (wrong sign convention,
    missing imaginary cross-term, bf16 matmul precision)."""
    import jax
    from mlmc_tpu.random.correlated_field import CirculantEmbeddingField

    def build():
        f = CirculantEmbeddingField(corr_length=0.3, dim=2,
                                    grid_shape=(64, 48), grid_step=1 / 64.0)
        f.set_points(mu=0.0, sigma=1.0)
        return f

    fm = build()
    assert fm._emb_size <= fm.DFT_MATMUL_MAX_EMB  # matmul path active
    ff = build()
    ff.DFT_MATMUL_MAX_EMB = 0  # force the fftn path
    key = jax.random.key(5)
    a = np.asarray(fm._sample(key))
    b = np.asarray(ff._sample(key))
    assert a.shape == b.shape == (64 * 48,)
    assert np.abs(a - b).max() < 1e-10  # x64 suite: rounding-level only
