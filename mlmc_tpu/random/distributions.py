"""Device-side sampling distributions for device-native simulations.

The reference passes scipy frozen distributions into simulation configs
(reference mlmc/sim/synth_simulation.py:29). On device we need pure,
key-driven samplers, so each distribution here is a small pytree-friendly
spec with ``sample(key, shape)`` (jnp, traceable) plus host-side helpers
(``rvs`` via numpy, ``ppf``/``pdf`` via scipy when available) so domain
estimation and exact-moment checks keep working.
"""
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp


class JaxDistr:
    """Base: pure key-driven sampler with scipy-compatible helpers."""

    #: uniforms consumed per variate by ``sample_uniforms`` (QMC dimension)
    qmc_dim = 1

    def sample(self, key, shape=()):
        """Draw variates of ``shape`` from a PRNG key (device path)."""
        raise NotImplementedError

    def sample_uniforms(self, u):
        """Traceable inverse-transform sampling: ``u [..., qmc_dim]`` in
        (0, 1) -> variates ``[...]``. Drives the quasi-Monte Carlo path
        (mlmc_tpu.qmc), where the low-discrepancy structure of ``u`` must
        survive the transform — hence inverse-CDF, not rejection."""
        raise NotImplementedError(
            "%s has no uniform-transform sampler (needed for QMC)"
            % type(self).__name__)

    def _scipy(self):
        raise NotImplementedError

    def rvs(self, size=1, random_state=None):
        """Host draws (scipy-compatible; tests and host tooling)."""
        return self._scipy().rvs(size=size, random_state=random_state)

    def ppf(self, q):
        """Quantile function (host scipy)."""
        return self._scipy().ppf(q)

    def pdf(self, x):
        """Probability density (host scipy)."""
        return self._scipy().pdf(x)

    def cdf(self, x):
        """Cumulative distribution (host scipy)."""
        return self._scipy().cdf(x)

    def mean(self):
        """Exact mean."""
        return self._scipy().mean()

    def var(self):
        """Exact variance."""
        return self._scipy().var()


@dataclasses.dataclass(frozen=True)
class Norm(JaxDistr):
    loc: float = 0.0
    scale: float = 1.0

    def sample(self, key, shape=()):
        return self.loc + self.scale * jax.random.normal(key, shape)

    def sample_uniforms(self, u):
        return self.loc + self.scale * jax.scipy.special.ndtri(u[..., 0])

    def _scipy(self):
        import scipy.stats as st

        return st.norm(loc=self.loc, scale=self.scale)


@dataclasses.dataclass(frozen=True)
class LogNorm(JaxDistr):
    """scipy.stats.lognorm(s, scale) parametrization: exp(log(scale) + s·N(0,1))."""

    s: float = 1.0
    scale: float = 1.0

    def sample(self, key, shape=()):
        return self.scale * jnp.exp(self.s * jax.random.normal(key, shape))

    def sample_uniforms(self, u):
        return self.scale * jnp.exp(self.s * jax.scipy.special.ndtri(u[..., 0]))

    def _scipy(self):
        import scipy.stats as st

        return st.lognorm(s=self.s, scale=self.scale)


@dataclasses.dataclass(frozen=True)
class Uniform(JaxDistr):
    lo: float = 0.0
    hi: float = 1.0

    def sample(self, key, shape=()):
        return jax.random.uniform(key, shape, minval=self.lo, maxval=self.hi)

    def sample_uniforms(self, u):
        return self.lo + (self.hi - self.lo) * u[..., 0]

    def _scipy(self):
        import scipy.stats as st

        return st.uniform(loc=self.lo, scale=self.hi - self.lo)


@dataclasses.dataclass(frozen=True)
class TwoGaussians(JaxDistr):
    """Mixture w·N(mu1, s1) + (1-w)·N(mu2, s2) (test_distribution target)."""

    w: float = 0.8
    mu1: float = 0.0
    s1: float = 1.0
    mu2: float = 5.0
    s2: float = 1.0

    qmc_dim = 2

    def sample(self, key, shape=()):
        k1, k2, k3 = jax.random.split(key, 3)
        pick = jax.random.uniform(k1, shape) < self.w
        a = self.mu1 + self.s1 * jax.random.normal(k2, shape)
        b = self.mu2 + self.s2 * jax.random.normal(k3, shape)
        return jnp.where(pick, a, b)

    def sample_uniforms(self, u):
        pick = u[..., 0] < self.w
        z = jax.scipy.special.ndtri(u[..., 1])
        return jnp.where(pick, self.mu1 + self.s1 * z, self.mu2 + self.s2 * z)

    def pdf(self, x):
        import scipy.stats as st

        return self.w * st.norm(self.mu1, self.s1).pdf(x) + (1 - self.w) * st.norm(
            self.mu2, self.s2
        ).pdf(x)

    def cdf(self, x):
        import scipy.stats as st

        return self.w * st.norm(self.mu1, self.s1).cdf(x) + (1 - self.w) * st.norm(
            self.mu2, self.s2
        ).cdf(x)

    def rvs(self, size=1, random_state=None):
        rng = np.random.default_rng(random_state)
        pick = rng.uniform(size=size) < self.w
        a = rng.normal(self.mu1, self.s1, size=size)
        b = rng.normal(self.mu2, self.s2, size=size)
        return np.where(pick, a, b)

    def mean(self):
        return self.w * self.mu1 + (1 - self.w) * self.mu2

    def var(self):
        m = self.mean()
        return (self.w * (self.s1 ** 2 + self.mu1 ** 2)
                + (1 - self.w) * (self.s2 ** 2 + self.mu2 ** 2) - m ** 2)

    def ppf(self, q):
        # numeric inversion over a generous bracket
        from scipy.optimize import brentq

        q = np.atleast_1d(q)
        lo = min(self.mu1 - 10 * self.s1, self.mu2 - 10 * self.s2)
        hi = max(self.mu1 + 10 * self.s1, self.mu2 + 10 * self.s2)
        return np.array([brentq(lambda x, qq=qq: self.cdf(x) - qq, lo, hi) for qq in q])


def as_jax_distr(distr):
    """Coerce strings / scipy frozen distrs / JaxDistr to a JaxDistr."""
    if isinstance(distr, JaxDistr):
        return distr
    if isinstance(distr, str):
        name = distr.lower()
        if name == "norm":
            return Norm()
        if name == "lognorm":
            return LogNorm()
        if name == "uniform":
            return Uniform()
        if name == "two_gaussians":
            return TwoGaussians()
        raise ValueError("Unknown distribution name: {}".format(distr))
    # scipy frozen distribution: map the common ones onto device samplers
    dist_name = getattr(getattr(distr, "dist", None), "name", None)
    if dist_name == "norm":
        loc, scale = distr.mean(), distr.std()
        return Norm(float(loc), float(scale))
    if dist_name == "lognorm":
        s = distr.kwds.get("s", distr.args[0] if distr.args else 1.0)
        scale = distr.kwds.get("scale", 1.0)
        return LogNorm(float(s), float(scale))
    if dist_name == "uniform":
        loc = distr.kwds.get("loc", 0.0)
        scale = distr.kwds.get("scale", 1.0)
        return Uniform(float(loc), float(loc) + float(scale))
    raise ValueError(
        "Cannot map scipy distribution {} onto a device sampler; pass a JaxDistr".format(distr)
    )
