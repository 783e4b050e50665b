"""Maxent density reconstruction tests.

Mirrors reference test/test_distribution.py: exact-moment convergence
(KL decay with growing moment count), orthogonalization accuracy
``|L cov L^T - I| < 1e-10`` (reference :178-180), and normalization.
Uses exact moments computed by quadrature -> pure solver test (no MC noise).
"""
import numpy as np
import jax
import pytest
import scipy.stats as stats
import scipy.integrate as integrate

from mlmc_tpu.moments import Legendre
import mlmc_tpu.tool.simple_distribution as sd


class CutDistribution:
    """Renormalized scipy distribution on a quantile-cut domain
    (reference test_distribution.py:36-88)."""

    def __init__(self, distr, quantile=0.01):
        self.distr = distr
        self.quantile = quantile
        self.domain, self.force_decay = self.domain_for_quantile(distr, quantile)
        p0, p1 = distr.cdf(self.domain)
        self.shift = p0
        self.scale = 1 / (p1 - p0)

    @staticmethod
    def domain_for_quantile(distr, quantile):
        if quantile == 0:
            X = distr.rvs(size=1000)
            err = stats.norm.rvs(size=1000) * 0.0
            X = X + err
            domain = (np.min(X), np.max(X))
        else:
            domain = distr.ppf([quantile, 1 - quantile])
        eps = 1e-10
        force_decay = [False, False]
        for side in [0, 1]:
            if np.isfinite(domain[side]):
                diff = (distr.cdf(domain[side]) - distr.cdf(domain[side] - eps)) / eps
                if diff > 1e-8:
                    force_decay[side] = True
        return domain, force_decay

    def pdf(self, x):
        return self.distr.pdf(x) * self.scale

    def cdf(self, x):
        return (self.distr.cdf(x) - self.shift) * self.scale


TWO_GAUSSIANS = stats.norm(loc=0, scale=1)


def _two_gaussians_pdf():
    a, b = stats.norm(0, 1), stats.norm(5, 1)
    w = 0.8

    class TG:
        def pdf(self, x):
            return w * a.pdf(x) + (1 - w) * b.pdf(x)

        def cdf(self, x):
            return w * a.cdf(x) + (1 - w) * b.cdf(x)

        def ppf(self, q):
            from scipy.optimize import brentq
            q = np.atleast_1d(q)
            return np.array([brentq(lambda x, qq=qq: self.cdf(x) - qq, -15, 20)
                             for qq in q])

        def rvs(self, size=1):
            rng = np.random.default_rng(0)
            pick = rng.uniform(size=size) < w
            return np.where(pick, rng.normal(0, 1, size), rng.normal(5, 1, size))

    return TG()


@pytest.mark.parametrize("distr_factory", [
    lambda: stats.norm(loc=1, scale=2),
    lambda: stats.lognorm(s=0.5, scale=np.exp(1.0)),
    _two_gaussians_pdf,
])
def test_exact_convergence(distr_factory):
    """KL(exact || maxent) decays as the number of moments grows."""
    cut = CutDistribution(distr_factory(), quantile=0.001)
    a, b = cut.domain

    kls = []
    for n_moments in [8, 16, 28]:
        mfn = Legendre(n_moments, cut.domain, safe_eval=False)
        exact_moments = sd.compute_semiexact_moments(mfn, cut.pdf, tol=1e-13)
        moments_data = np.stack((exact_moments, np.ones(n_moments)), axis=1)
        distr_obj = sd.SimpleDistribution(mfn, moments_data, domain=cut.domain,
                                          force_decay=cut.force_decay)
        result = distr_obj.estimate_density_minimize(tol=1e-9)
        assert result.success, result.message
        kl = sd.KL_divergence(cut.pdf, distr_obj.density, a, b)
        kls.append(kl)

    # monotone-ish decay (both ends may sit at the 1e-10 KL floor) and
    # decent final accuracy
    assert kls[-1] <= kls[0]
    assert kls[-1] < 1e-4, kls


def test_density_normalization():
    cut = CutDistribution(stats.norm(0, 1), quantile=0.001)
    mfn = Legendre(12, cut.domain, safe_eval=False)
    exact_moments = sd.compute_semiexact_moments(mfn, cut.pdf, tol=1e-13)
    moments_data = np.stack((exact_moments, np.ones(12)), axis=1)
    d = sd.SimpleDistribution(mfn, moments_data, domain=cut.domain)
    d.estimate_density_minimize(tol=1e-9)
    m0 = integrate.quad(lambda x: float(np.squeeze(d.density(x))),
                        cut.domain[0], cut.domain[1], epsabs=1e-12)[0]
    assert abs(m0 - 1.0) < 1e-8

    # cdf endpoints
    cdfs = d.cdf(np.array([cut.domain[0] - 1, 0.0, cut.domain[1] + 1]))
    assert cdfs[0] == 0.0
    assert cdfs[-1] == 1.0


def test_orthogonalization_accuracy():
    """|L cov L^T - I| < 1e-10 on the kept subspace (reference :178-180)."""
    cut = CutDistribution(stats.norm(0, 1), quantile=0.001)
    n_moments = 20
    mfn = Legendre(n_moments, cut.domain, safe_eval=False)
    cov = sd.compute_semiexact_cov(mfn, cut.pdf, tol=1e-13)
    orto_moments, info = sd.construct_ortogonal_moments(mfn, cov, tol=1e-13)
    eval_, threshold, L = info
    # transformed covariance must be identity
    t_cov = L @ cov @ L.T
    n_keep = orto_moments.size
    err = np.linalg.norm(t_cov[:n_keep, :n_keep] - np.eye(n_keep))
    assert err < 1e-9, err


def test_inexact_convergence():
    """Noisy covariance: orthogonalization threshold keeps the fit stable
    (reference test_distribution.py:305-354, lighter parametrization)."""
    rng = np.random.default_rng(42)
    cut = CutDistribution(stats.norm(0, 1), quantile=0.001)
    n_moments = 25
    noise_level = 1e-6

    mfn = Legendre(n_moments, cut.domain, safe_eval=False)
    cov = sd.compute_semiexact_cov(mfn, cut.pdf, tol=1e-13)
    noise = rng.normal(0, noise_level, size=(n_moments, n_moments))
    noise = 0.5 * (noise + noise.T)
    noise[0, 0] = 0
    cov_noisy = cov + noise

    orto_moments, info = sd.construct_ortogonal_moments(
        mfn, cov_noisy, tol=10 * noise_level)
    exact_moments = sd.compute_semiexact_moments(orto_moments, cut.pdf, tol=1e-13)
    moments_data = np.stack(
        (exact_moments[: orto_moments.size], np.ones(orto_moments.size)), axis=1)
    d = sd.SimpleDistribution(orto_moments, moments_data, domain=orto_moments.domain)
    result = d.estimate_density_minimize(tol=1e-7)
    assert result.success
    kl = sd.KL_divergence(cut.pdf, d.density, *cut.domain)
    assert kl < 1e-3, kl


@pytest.mark.parametrize("basis", ["legendre", "fourier"])
def test_exact_convergence_basis_families(basis):
    """Maxent with different moment families (reference parametrizes over
    moment classes, test_distribution.py:374-380)."""
    from mlmc_tpu.moments import Fourier

    cut = CutDistribution(stats.norm(0, 1), quantile=0.001)
    n_moments = 15
    if basis == "legendre":
        mfn = Legendre(n_moments, cut.domain, safe_eval=False)
    else:
        mfn = Fourier(n_moments, cut.domain, safe_eval=False)
    exact_moments = sd.compute_semiexact_moments(mfn, cut.pdf, tol=1e-13)
    moments_data = np.stack((exact_moments, np.ones(n_moments)), axis=1)
    d = sd.SimpleDistribution(mfn, moments_data, domain=cut.domain,
                              force_decay=cut.force_decay)
    result = d.estimate_density_minimize(tol=1e-8)
    assert result.success
    kl = sd.KL_divergence(cut.pdf, d.density, *cut.domain)
    assert kl < 1e-4, kl


def test_config3_two_gaussians_35_moments():
    """BASELINE.json config 3 verbatim: 35 moments, two-Gaussian target."""
    cut = CutDistribution(_two_gaussians_pdf(), quantile=1e-4)
    n_moments = 35
    mfn = Legendre(n_moments, cut.domain, safe_eval=False)
    exact_moments = sd.compute_semiexact_moments(mfn, cut.pdf, tol=1e-13)
    moments_data = np.stack((exact_moments, np.ones(n_moments)), axis=1)
    d = sd.SimpleDistribution(mfn, moments_data, domain=cut.domain,
                              force_decay=cut.force_decay)
    import time
    t0 = time.perf_counter()
    result = d.estimate_density_minimize(tol=1e-9)
    solve_s = time.perf_counter() - t0
    assert result.success, result.message
    kl = sd.KL_divergence(cut.pdf, d.density, *cut.domain)
    assert kl < 5e-5, kl
    # both modes resolved
    dens = d.density(np.array([0.0, 2.5, 5.0]))
    assert dens[0] > dens[1] and dens[2] > dens[1]
    assert solve_s < 60


def test_df_solver_matches_f64_on_same_grid():
    """The device Newton (`solver_backend='jax'`) runs in float64 even with
    the global x64 flag OFF, and tracks the f64 host solve on an identical
    quadrature grid to ~1e-12 in the multipliers."""
    from mlmc_tpu.tool.simple_distribution import (
        _newton_solve_f64, _newton_solve_np)

    Q, R = 512, 10
    x = np.linspace(-1, 1, Q)
    w = np.full(Q, 2.0 / Q)
    q_mom = np.polynomial.legendre.legvander(x, R - 1)
    mu = np.zeros(R)
    mu[0], mu[1], mu[2] = 1.0, 0.3, 0.1
    lam0 = np.zeros(R)
    lam0[0] = -np.log(0.5)

    lam_np, gn_np, _ = _newton_solve_np(q_mom, w, mu, lam0, 1e-10)
    with jax.enable_x64(False):
        lam_j, gn_j, it = _newton_solve_f64(q_mom, w, mu, lam0, 1e-10)
    assert lam_j.dtype == np.float64
    assert float(gn_j) < 1e-9
    assert np.abs(lam_np - lam_j).max() < 1e-10, np.abs(lam_np - lam_j).max()


def test_df_solver_end_to_end_density_parity():
    """Orthogonalized-basis maxent fit: the device backend, run with the
    global x64 flag OFF, reproduces the f64 host backend's DENSITY to
    ~1e-12 (the production construct_density pipeline always
    orthogonalizes, which conditions the Hessian and makes the
    multipliers well-determined)."""
    cut = CutDistribution(stats.norm(0, 1), quantile=0.001)
    R = 16
    mfn = Legendre(R, cut.domain, safe_eval=False)
    cov = sd.compute_semiexact_cov(mfn, cut.pdf, tol=1e-13)
    orto, _info = sd.construct_ortogonal_moments(mfn, cov, tol=1e-10)
    exact = sd.compute_semiexact_moments(orto, cut.pdf, tol=1e-13)
    md = np.stack((exact, np.ones(orto.size)), axis=1)

    dens = {}
    for backend in ("numpy", "auto"):
        d = sd.SimpleDistribution(orto, md, domain=cut.domain,
                                  solver_backend=backend)
        with jax.enable_x64(False):
            res = d.estimate_density_minimize(tol=1e-10)
        assert res.success, (backend, res.message)
        xs = np.linspace(cut.domain[0], cut.domain[1], 501)
        dens[backend] = d.density(xs)
    assert d._solver_backend == "jax"
    diff = np.abs(dens["numpy"] - dens["auto"]).max()
    assert diff < 1e-11, diff
