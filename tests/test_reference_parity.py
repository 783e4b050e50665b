"""Cross-validation against the ACTUAL reference library.

Imports /root/reference/mlmc (shimmed for numpy 2 / py3.12, see
reference_shim.py), fills the reference's Memory storage and ours with
IDENTICAL samples, and asserts that the two frameworks produce the same
moment means/variances, covariance matrices, orthogonalized bases, and
maxent densities. This is the strongest parity evidence available —
the estimates must match to f64 accumulation noise (1e-10), per the
SURVEY §6 north star.

Reference call chain under test: quantity_estimate.py:22-156 (estimate_mean,
moments, covariance), simple_distribution.py:756-841 (orthogonalization),
simple_distribution.py:50-94 (maxent solve).
"""
import numpy as np
import pytest

# the REFERENCE library's adaptive-quad integrands return shape-(1,) arrays
# (numpy-2 deprecation, thousands of repeats per solve); our own quad paths
# are warning-clean and covered in test_distribution.py
pytestmark = pytest.mark.filterwarnings(
    "ignore:Conversion of an array with ndim:DeprecationWarning")

from tests.reference_shim import import_reference

mlmc_ref = import_reference()

import mlmc.quantity.quantity_estimate as ref_qe  # noqa: E402
import mlmc.tool.simple_distribution as ref_sd  # noqa: E402
from mlmc.moments import Legendre as RefLegendre  # noqa: E402
from mlmc.quantity.quantity import make_root_quantity as ref_make_root  # noqa: E402
from mlmc.quantity.quantity_spec import QuantitySpec as RefQSpec  # noqa: E402
from mlmc.sample_storage import Memory as RefMemory  # noqa: E402

import mlmc_tpu  # noqa: E402
import mlmc_tpu.quantity.quantity_estimate as dev_qe  # noqa: E402
import mlmc_tpu.tool.simple_distribution as dev_sd  # noqa: E402
from mlmc_tpu import Legendre, Memory, QuantitySpec, make_root_quantity  # noqa: E402

N_LEVELS = 3
N_SAMPLES = [400, 200, 100]
DOMAIN = (-5.0, 5.0)
R = 15


def _draw_level_samples(rng):
    """Identical per-level (fine, coarse) scalar draws for both frameworks."""
    data = []
    for lvl in range(N_LEVELS):
        n = N_SAMPLES[lvl]
        x = rng.normal(size=n)
        h_f, h_c = 0.5 ** (lvl + 1), 0.5 ** lvl
        fine = x + h_f * np.sqrt(1e-4 + np.abs(x))
        coarse = (np.zeros(n) if lvl == 0
                  else x + h_c * np.sqrt(1e-4 + np.abs(x)))
        data.append((fine, coarse))
    return data


def _q_spec(cls):
    # NB: location names must not have length 3 — the reference treats any
    # len-3 location as an (x, y, z) float triple (sample_storage_hdf.py:41)
    return [cls(name="value", unit="", shape=(1, 1), times=[0],
                locations=["spot"])]


def _fill(storage, spec, data, as_object_array=False):
    """``as_object_array`` pre-shapes the [N, 2] object layout the reference
    Memory expects (numpy 2 no longer infers it from nested tuples)."""
    storage.save_global_data(result_format=spec,
                             level_parameters=[[0.5 ** (l + 1)] for l in range(N_LEVELS)])
    successful = {}
    for lvl, (fine, coarse) in enumerate(data):
        rows = [
            ("L{:02d}_S{:07d}".format(lvl, i), (np.array([f]), np.array([c])))
            for i, (f, c) in enumerate(zip(fine, coarse))
        ]
        if as_object_array:
            arr = np.empty((len(rows), 2), dtype=object)
            for i, (sid, fc) in enumerate(rows):
                arr[i, 0], arr[i, 1] = sid, fc
            successful[lvl] = arr
        else:
            successful[lvl] = rows
    storage.save_samples(successful, {})
    return storage


@pytest.fixture(scope="module")
def both_quantities():
    data = _draw_level_samples(np.random.default_rng(4242))
    ref_storage = _fill(RefMemory(), _q_spec(RefQSpec), data, as_object_array=True)
    dev_storage = _fill(Memory(), _q_spec(QuantitySpec), data)
    ref_root = ref_make_root(ref_storage, _q_spec(RefQSpec))
    dev_root = make_root_quantity(dev_storage, _q_spec(QuantitySpec))
    # scalar view: value @ time 0 @ location -> [1,1] array -> scalar
    ref_scalar = ref_root["value"][0]["spot"][0, 0]
    dev_scalar = dev_root["value"][0]["spot"][0, 0]
    return ref_scalar, dev_scalar


def test_mean_parity(both_quantities):
    ref_q, dev_q = both_quantities
    ref_mean = ref_qe.estimate_mean(ref_q)
    dev_mean = dev_qe.estimate_mean(dev_q)
    assert np.allclose(ref_mean.mean, np.asarray(dev_mean.mean), atol=1e-12)
    assert np.allclose(ref_mean.var, np.asarray(dev_mean.var), atol=1e-12)


def test_moments_parity(both_quantities):
    ref_q, dev_q = both_quantities
    ref_m = ref_qe.estimate_mean(ref_qe.moments(ref_q, RefLegendre(R, DOMAIN)))
    dev_m = dev_qe.estimate_mean(dev_qe.moments(dev_q, Legendre(R, DOMAIN)))
    assert np.allclose(ref_m.mean, np.asarray(dev_m.mean), atol=1e-10)
    assert np.allclose(ref_m.var, np.asarray(dev_m.var), atol=1e-10)


def test_covariance_parity(both_quantities):
    ref_q, dev_q = both_quantities
    ref_c = ref_qe.estimate_mean(ref_qe.covariance(ref_q, RefLegendre(R, DOMAIN)))
    dev_c = dev_qe.estimate_mean(dev_qe.covariance(dev_q, Legendre(R, DOMAIN)))
    assert np.allclose(ref_c.mean, np.asarray(dev_c.mean), atol=1e-10)


def test_orthogonalization_parity(both_quantities):
    """Same covariance -> same threshold, eigenvalues and transform L."""
    ref_q, dev_q = both_quantities
    cov_ref = ref_qe.estimate_mean(
        ref_qe.covariance(ref_q, RefLegendre(R, DOMAIN))).mean
    cov_dev = np.asarray(dev_qe.estimate_mean(
        dev_qe.covariance(dev_q, Legendre(R, DOMAIN))).mean)
    assert np.allclose(cov_ref, cov_dev, atol=1e-10)

    ref_orth, ref_info = ref_sd.construct_ortogonal_moments(
        RefLegendre(R, DOMAIN), cov_ref, tol=1e-4)
    dev_orth, dev_info = dev_sd.construct_ortogonal_moments(
        Legendre(R, DOMAIN), cov_dev, tol=1e-4)

    assert ref_info[1] == dev_info[1]  # threshold
    assert np.allclose(ref_info[0], dev_info[0], atol=1e-9)  # eigenvalues
    L_ref, L_dev = ref_info[2], dev_info[2]
    assert L_ref.shape == L_dev.shape
    # RQ sign conventions may differ per row; the decomposition property
    # and row-wise agreement up to sign must hold exactly
    assert np.allclose(np.abs(L_ref), np.abs(L_dev), atol=1e-9)
    assert np.allclose(L_dev @ cov_dev @ L_dev.T,
                       np.eye(L_dev.shape[0]), atol=1e-10)

    # orthogonalized moment estimates agree (up to the same row signs)
    ref_m = ref_qe.estimate_mean(ref_qe.moments(ref_q, ref_orth)).mean
    dev_m = np.asarray(dev_qe.estimate_mean(dev_qe.moments(dev_q, dev_orth)).mean)
    signs = np.sign(np.diag(L_ref)) * np.sign(np.diag(L_dev))
    assert np.allclose(ref_m, signs * dev_m, atol=1e-9)


def test_density_parity(both_quantities):
    """Full construct_density chain: both maxent solvers converge to the
    same density (same convex optimum), compared pointwise."""
    ref_q, dev_q = both_quantities

    cov = ref_qe.estimate_mean(
        ref_qe.covariance(ref_q, RefLegendre(R, DOMAIN))).mean
    ref_orth, _ = ref_sd.construct_ortogonal_moments(
        RefLegendre(R, DOMAIN), cov, tol=1e-4)
    dev_orth, _ = dev_sd.construct_ortogonal_moments(
        Legendre(R, DOMAIN), np.asarray(cov), tol=1e-4)

    ref_means = ref_qe.estimate_mean(ref_qe.moments(ref_q, ref_orth)).mean
    dev_means = np.asarray(dev_qe.estimate_mean(
        dev_qe.moments(dev_q, dev_orth)).mean)

    ref_data = np.stack([ref_means, np.ones_like(ref_means)], axis=1)
    dev_data = np.stack([dev_means, np.ones_like(dev_means)], axis=1)

    ref_distr = ref_sd.SimpleDistribution(ref_orth, ref_data,
                                          domain=ref_orth.domain)
    ref_distr.estimate_density_minimize(tol=1e-9)
    dev_distr = dev_sd.SimpleDistribution(dev_orth, dev_data,
                                          domain=dev_orth.domain)
    dev_distr.estimate_density_minimize(tol=1e-9)

    xs = np.linspace(DOMAIN[0] + 0.1, DOMAIN[1] - 0.1, 501)
    pdf_ref = np.asarray(ref_distr.density(xs), dtype=float)
    pdf_dev = np.asarray(dev_distr.density(xs), dtype=float)
    err = np.max(np.abs(pdf_ref - pdf_dev))
    assert err < 5e-6, f"max pdf deviation {err}"
    kl = dev_sd.KL_divergence(lambda x: ref_distr.density(x),
                              lambda x: dev_distr.density(x), *DOMAIN)
    assert kl < 1e-9, f"KL(ref || dev) = {kl}"


def test_hdf_file_interop_both_directions(tmp_path):
    """HDF5 files written by either framework open and read back in the
    other — the schema-compatibility claim tested at the FILE level
    (reference sample_storage_hdf.py + tool/hdf5.py schema).
    """
    from mlmc.sample_storage_hdf import SampleStorageHDF as RefHDF
    from mlmc_tpu import SampleStorageHDF as DevHDF

    data = _draw_level_samples(np.random.default_rng(77))

    # ours -> reference
    ours_path = str(tmp_path / "ours.hdf5")
    _fill(DevHDF(file_path=ours_path), _q_spec(QuantitySpec), data)
    ref_reader = RefHDF(file_path=ours_path)
    ref_pairs = ref_reader.sample_pairs()
    fmt = ref_reader.load_result_format()
    assert [q.name for q in fmt] == ["value"]
    assert np.allclose(np.squeeze(np.asarray(
        ref_reader.get_level_parameters())), [0.5, 0.25, 0.125])

    # reference -> ours
    ref_path = str(tmp_path / "ref.hdf5")
    _fill(RefHDF(file_path=ref_path), _q_spec(RefQSpec), data,
          as_object_array=True)
    dev_reader = DevHDF(file_path=ref_path)
    dev_pairs = dev_reader.sample_pairs()
    assert [q.name for q in dev_reader.load_result_format()] == ["value"]

    for lvl, (fine, coarse) in enumerate(data):
        for pairs in (ref_pairs, dev_pairs):
            chunk = np.asarray(pairs[lvl])      # [M, N, 1|2]
            assert np.allclose(chunk[0, :, 0], fine, atol=0)
            if lvl > 0:
                assert np.allclose(chunk[0, :, 1], coarse, atol=0)

    # raw h5py structure spot-check of OUR file against the reference
    # schema (tool/hdf5.py:14-46): root attrs + per-level datasets
    import h5py

    with h5py.File(ours_path, "r") as f:
        assert "version" in f.attrs and "level_parameters" in f.attrs
        for lvl in range(N_LEVELS):
            grp = f["Levels/{}".format(lvl)]
            for dset in ("collected_values", "collected_ids", "scheduled"):
                assert dset in grp, (lvl, dset, list(grp))
            assert grp["collected_values"].shape[1:] == (2, 1)
