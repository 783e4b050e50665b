"""Correlated Gaussian random field generators — device-native.

Re-design of reference mlmc/random/correlated_field.py:12-755. Same field
model: stationary covariance ``c(X) = sigma^2 exp(-|X^T K X|^(alpha/2))``
with ``K = (1/L^2) I`` (or an anisotropy tensor), alpha=2 'gauss' / 1 'exp',
optional log-field. Three generators:

* ``SpatialCorrelatedField`` — dense covariance + truncated SVD (KL
  expansion), sample = ``L @ N(0,1)`` (reference :390-498). Decomposition on
  host (scipy/sklearn randomized SVD for large N), sampling is a single
  device matmul, vmappable over keys.
* ``SpectralCorrelatedField`` — random-Fourier-feature (randomization)
  method, the native replacement for the gstools wrapper (reference
  :501-553): ``F(x) = sigma*sqrt(2/M) sum_m cos(k_m . x + phi_m)`` with
  ``k_m`` drawn from the spectral measure of the covariance (Gaussian for
  alpha=2, multivariate Student-t(1) for alpha=1). Evaluation is one
  ``[N_pts, d] @ [d, M]`` matmul + cos — matmul-friendly, works for arbitrary
  point sets, O(N*M) with no decomposition.
  ``GSToolsSpatialCorrelatedField`` and ``FourierSpatialCorrelatedField``
  are API aliases of this class.
* ``CirculantEmbeddingField`` — EXACT stationary GRF on regular grids via
  d-dimensional FFT circulant embedding; the workhorse for the cond_field
  diffusion benchmark (BASELINE.json config 5). O(N log N) per sample, all
  on device.

All generators support key-driven pure sampling (``sample(key)``) for jit/
vmap pipelines; calling ``sample()`` without a key uses a stateful host
counter (reference-compatible convenience).
"""
import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp


def kozeny_carman(porosity, m, factor, viscosity):
    """Kozeny-Carman porosity->conductivity law (reference :12-31)."""
    assert np.all(np.asarray(viscosity) > 1e-10)
    xp = jnp if isinstance(porosity, jnp.ndarray) else np
    porosity = xp.clip(porosity, 1e-10, 1 - 1e-10)
    cond = factor * porosity ** (2 + m) / (1 - porosity) ** 2 / viscosity
    return xp.maximum(cond, 1e-15)


def positive_to_range(exp, a, b):
    """Map a positive parameter to the interval (a, b) (reference :34-41)."""
    return b * (1 - (b - a) / (b + (b - a) * exp))


class RandomFieldBase:
    """Common stationary-covariance machinery (reference :234-366)."""

    #: named covariance families -> exponent alpha in exp(-r^alpha)
    _CORR_EXPONENTS = {"gauss": 2.0, "exp": 1.0}

    def __init__(self, corr_exp="gauss", dim=2, corr_length=1.0,
                 aniso_correlation=None, mu=0.0, sigma=1.0, log=False, **kwargs):
        self.dim = dim
        self.log = log
        self.correlation_exponent = self._CORR_EXPONENTS.get(corr_exp) \
            or float(corr_exp)
        self._corr_length = corr_length

        if aniso_correlation is not None:
            self.correlation_tensor = np.asarray(aniso_correlation)
            self._max_corr_length = np.linalg.norm(aniso_correlation, ord=2)
        else:
            if corr_length <= np.finfo(float).eps:
                raise ValueError("corr_length must be positive")
            self.correlation_tensor = np.eye(dim) / corr_length ** 2
            self._max_corr_length = corr_length

        self.points = None
        self.mu, self.sigma = mu, sigma
        self._host_key = jax.random.key(np.random.randint(0, 2 ** 31))
        self._initialize(**kwargs)

    def _initialize(self, **kwargs):
        pass

    def _pointwise(self, value, n_points, name):
        """Broadcast-check a scalar or per-point array parameter."""
        arr = np.asarray(value, dtype=float)
        if arr.shape not in ((), (n_points,)):
            raise ValueError(
                "{} must be scalar or shape ({},), got {}".format(
                    name, n_points, arr.shape))
        return arr

    def set_points(self, points, mu=None, sigma=None):
        points = np.asarray(points, dtype=float)
        points = points.reshape(len(points), -1)  # 1-D input -> [N, 1]
        if points.shape[1] != self.dim:
            raise ValueError("points must be [N, {}]".format(self.dim))
        self.n_points, self.dimension = points.shape
        self.points = points
        self.mu = self._pointwise(self.mu if mu is None else mu,
                                  len(points), "mu")
        self.sigma = self._pointwise(self.sigma if sigma is None else sigma,
                                     len(points), "sigma")
        self._set_points()

    def _set_points(self):
        pass

    def _next_host_key(self):
        self._host_key, sub = jax.random.split(self._host_key)
        return sub

    def sample(self, key=None):
        """Field realization at the set points. Pure given an explicit key."""
        if key is None:
            key = self._next_host_key()
        field = self._sample(key)
        field = jnp.asarray(self.sigma) * field + jnp.asarray(self.mu)
        if self.log:
            field = jnp.exp(field)
        return field

    def _sample(self, key):
        raise NotImplementedError

    # shared helper: anisotropic squared distance |X^T K X|
    def _sq_distance_matrix(self, points):
        d = points[:, None, :] - points[None, :, :]  # [N, N, dim]
        return np.einsum("ijk,kl,ijl->ij", d, self.correlation_tensor, d)


class SpatialCorrelatedField(RandomFieldBase):
    """Dense-covariance KL/SVD generator (reference :369-498)."""

    def _drop_factor(self):
        # any cached decomposition is invalid once points/params change
        self.cov_mat = self._cov_l_factor = None

    def _initialize(self, **kwargs):
        self._drop_factor()
        self._n_approx_terms = self._sqrt_ev = None

    def _set_points(self):
        self._drop_factor()

    def cov_matrix(self):
        """Dense covariance matrix at the set points (reference :390-412)."""
        assert self.points is not None
        sq = self._sq_distance_matrix(self.points)
        # c(X) = exp(-(X^T K X)^(alpha/2)) with sq = X^T K X
        self.cov_mat = np.exp(-np.abs(sq) ** (self.correlation_exponent / 2.0))
        return self.cov_mat

    def _eigen_value_estimate(self, m):
        """Schwab-Todor decay estimate of the m-th eigenvalue (:414-428)."""
        vol = np.prod(np.max(self.points, axis=0) - np.min(self.points, axis=0)) \
            + np.finfo(float).eps
        lam = self._max_corr_length
        alpha = lam / (2 * vol ** (1 / self.dim))
        return vol * (1.0 / alpha) ** (m ** (1 / self.dim)) if alpha > 1 else \
            vol * np.exp(-alpha * m ** (1 / self.dim) * np.log(m + 1))

    def svd_dcmp(self, precision=0.01, n_terms_range=(1, np.inf), random_state=None):
        """Truncated SVD of the covariance -> KL factor (reference :430-488).

        Keeps the smallest number of terms with relative singular-value
        tail below ``precision`` within ``n_terms_range``.
        """
        if self.cov_mat is None:
            self.cov_matrix()
        n = self.cov_mat.shape[0]
        hi = int(min(n_terms_range[1], n))
        lo = int(max(1, n_terms_range[0]))

        if hi < n // 2:
            from sklearn.utils.extmath import randomized_svd

            U, s, _ = randomized_svd(self.cov_mat, n_components=hi, n_iter=3,
                                     random_state=random_state)
        else:
            U, s, _ = np.linalg.svd(self.cov_mat)
            U, s = U[:, :hi], s[:hi]

        total = np.sum(s)
        tail = total - np.cumsum(s)
        keep = int(np.searchsorted(-tail, -precision * total)) + 1
        keep = int(np.clip(keep, lo, hi))

        self._sqrt_ev = np.sqrt(s[:keep])
        self._cov_l_factor = U[:, :keep] * self._sqrt_ev[None, :]
        self._n_approx_terms = keep
        return self._cov_l_factor, self._sqrt_ev

    @property
    def n_approx_terms(self):
        return self._n_approx_terms

    def _sample(self, key):
        if self._cov_l_factor is None:
            self.svd_dcmp()
        z = jax.random.normal(key, (self._n_approx_terms,))
        return jnp.asarray(self._cov_l_factor) @ z


class SpectralCorrelatedField(RandomFieldBase):
    """Random-Fourier-feature generator (gstools 'randomization' analogue).

    F(x) = sqrt(2/M) sum_m cos(k_m . x + phi_m); k_m drawn from the spectral
    measure of the covariance: N(0, 2/L^2 I) for alpha=2 (gauss),
    multivariate Student-t(nu=1)/L for alpha=1 (exp). Replaces the gstools
    SRF wrapper (reference :501-553) natively.
    """

    def _initialize(self, mode_no=1000, seed=None, **kwargs):
        self.mode_no = int(mode_no)
        key = jax.random.key(seed if seed is not None else np.random.randint(0, 2 ** 31))
        kk, kp = jax.random.split(key)
        d = self.dim
        alpha = self.correlation_exponent
        L = self._corr_length
        if alpha == 2.0:
            # FT of exp(-r^2/L^2): k ~ N(0, 2/L^2 I)
            k = jax.random.normal(kk, (self.mode_no, d)) * (np.sqrt(2.0) / L)
        elif alpha == 1.0:
            # FT of exp(-r/L): multivariate Student-t with nu=1, scale 1/L
            y = jax.random.normal(kk, (self.mode_no, d))
            w = jax.random.chisquare(jax.random.fold_in(kk, 1), 1.0, (self.mode_no, 1))
            k = y / jnp.sqrt(w) / L
        else:
            raise NotImplementedError(
                "spectral sampling implemented for alpha in {1, 2}, got {}".format(alpha))
        self._wave_vectors = k                       # [M, d]
        self._phases_key = kp

    def _sample(self, key):
        phases = jax.random.uniform(key, (self.mode_no,), maxval=2 * np.pi)
        proj = jnp.asarray(self.points) @ self._wave_vectors.T   # [N, M]
        return jnp.sqrt(2.0 / self.mode_no) * jnp.sum(
            jnp.cos(proj + phases[None, :]), axis=1)


class GSToolsSpatialCorrelatedField(SpectralCorrelatedField):
    """API-parity subclass of the spectral generator (reference :501-553
    wraps gstools.SRF's randomization method — the same algorithm this
    class implements natively). Accepts a gstools-like model object with
    ``len_scale``/``dim`` attributes or plain kwargs."""

    def __init__(self, model=None, **kwargs):
        if model is not None:
            kwargs.setdefault("corr_length", getattr(model, "len_scale", 1.0))
            kwargs.setdefault("dim", getattr(model, "dim", 2))
            name = type(model).__name__.lower()
            kwargs.setdefault("corr_exp",
                              "exp" if "exponential" in name else "gauss")
        super().__init__(**kwargs)


class FourierSpatialCorrelatedField(SpectralCorrelatedField):
    """API-parity subclass: the reference's deprecated in-repo spectral
    method (:556-755) is subsumed by the random-Fourier-feature generator."""



class CirculantEmbeddingField(RandomFieldBase):
    """Exact stationary GRF on a regular grid via FFT circulant embedding.

    The device-first generator (SURVEY.md §2 'Correlated random fields' row):
    eigenvalues of the embedded circulant = FFT of one covariance row; a
    sample is ``real(IFFT(sqrt(eig) * W))`` with complex white noise W.
    O(N log N), exact covariance, fully on device, vmappable over keys.

    :param grid_shape: points per dimension, e.g. (256, 256)
    :param grid_step: spacing per dimension (scalar or per-dim)
    """

    def _initialize(self, grid_shape=None, grid_step=1.0, pad_factor=2, **kwargs):
        assert grid_shape is not None, "CirculantEmbeddingField needs grid_shape"
        self.grid_shape = tuple(int(s) for s in grid_shape)
        step = np.broadcast_to(np.asarray(grid_step, dtype=float), (self.dim,))
        self.grid_step = step
        self._pad_factor = pad_factor
        self._build_eigenvalues()
        # implicit point set = the grid itself
        axes = [np.arange(s) * st for s, st in zip(self.grid_shape, step)]
        mesh = np.meshgrid(*axes, indexing="ij")
        self.points = np.stack([m.ravel() for m in mesh], axis=1)
        self.n_points = self.points.shape[0]
        self.mu = np.array(self.mu, dtype=float)
        self.sigma = np.array(self.sigma, dtype=float)

    def _build_eigenvalues(self):
        """FFT of the covariance kernel on the embedding torus."""
        emb_shape = tuple(self._pad_factor * s for s in self.grid_shape)
        # signed torus distances per axis
        axes = []
        for s, st in zip(emb_shape, self.grid_step):
            ix = np.arange(s)
            ix = np.minimum(ix, s - ix)  # wrap-around distance
            axes.append(ix * st)
        mesh = np.meshgrid(*axes, indexing="ij")
        d = np.stack([m.ravel() for m in mesh], axis=1)  # [prod(emb), dim]
        sq = np.einsum("ik,kl,il->i", d, self.correlation_tensor, d)
        cov = np.exp(-np.abs(sq) ** (self.correlation_exponent / 2.0))
        cov = cov.reshape(emb_shape)
        eig = np.fft.fftn(cov).real
        # tiny negative eigenvalues from imperfect embedding -> clip
        # (relative magnitude is ~1e-12 for pad_factor 2 with smooth covs)
        self._neg_fraction = float(np.abs(eig[eig < 0]).sum() / np.abs(eig).sum()) \
            if np.any(eig < 0) else 0.0
        eig = np.maximum(eig, 0.0)
        self._eig = jnp.asarray(eig)
        self._emb_shape = emb_shape
        self._emb_size = int(np.prod(emb_shape))
        self._dft_mats = None  # built lazily for the matmul-DFT path

    def set_points(self, points=None, mu=None, sigma=None):
        """Points are fixed to the grid; only mu/sigma may be updated."""
        if points is not None:
            raise ValueError(
                "CirculantEmbeddingField samples on its regular grid; "
                "use SpatialCorrelatedField / SpectralCorrelatedField for "
                "arbitrary point sets")
        if mu is not None:
            self.mu = np.array(mu, dtype=float)
        if sigma is not None:
            self.sigma = np.array(sigma, dtype=float)

    #: embedding sizes up to this use the matmul DFT (2D only): the crop
    #: to the grid folds into the DFT row count, so the whole transform is
    #: six matmuls. Past it the O(M^1.5) matmul flops overtake the
    #: O(M log M) FFT.
    DFT_MATMUL_MAX_EMB = 512 * 512

    def _dft_matrices(self):
        if self._dft_mats is None:
            dtype = self._eig.dtype  # follows the enabled precision
            mats = []
            for m, n in zip(self._emb_shape, self.grid_shape):
                jk = np.outer(np.arange(n), np.arange(m)) * (2 * np.pi / m)
                mats.append((jnp.asarray(np.cos(jk), dtype),
                             jnp.asarray(np.sin(jk), dtype)))
            self._dft_mats = mats
        return self._dft_mats

    def _sample(self, key):
        # X = Re(F sqrt(Lambda) xi)/sqrt(M), xi complex with unit-variance
        # real+imag parts (E[xi xi^H] = 2I)  =>  Cov(X) = C exactly
        kr, ki = jax.random.split(key)
        shape = self._emb_shape
        wr = jax.random.normal(kr, shape)
        wi = jax.random.normal(ki, shape)
        s = jnp.sqrt(self._eig)
        if len(shape) == 2 and self._emb_size <= self.DFT_MATMUL_MAX_EMB:
            # Re(F1c A F2c^T) with A = s*(wr + i wi), Fkc = (C - iS) cropped
            # to the grid rows — six real matmuls, all matmul-shaped:
            #   B = F1c A        = (C1 Ar + S1 Ai) + i (C1 Ai - S1 Ar)
            #   Re(B F2c^T)      = Br C2^T + Bi S2^T
            (c1, s1), (c2, s2) = self._dft_matrices()
            ar = s * wr
            ai = s * wi
            # HIGHEST: a default-precision f32 matmul may run in TF32 or
            # bf16 passes, which would corrupt the exact covariance
            mm = functools.partial(jnp.matmul,
                                   precision=jax.lax.Precision.HIGHEST)
            br = mm(c1, ar) + mm(s1, ai)
            bi = mm(c1, ai) - mm(s1, ar)
            field = (mm(br, c2.T) + mm(bi, s2.T)) / np.sqrt(self._emb_size)
            return field.reshape(-1)
        w = wr + 1j * wi
        field = jnp.fft.fftn(s * w).real / jnp.sqrt(self._emb_size)
        # crop embedding torus back to the grid
        slices = tuple(slice(0, s) for s in self.grid_shape)
        return field[slices].reshape(-1)

    def sample_grid(self, key=None):
        """Sample shaped as the grid (not flattened)."""
        return self.sample(key).reshape(self.grid_shape)


class Field:
    """Named field over an (optional) mesh-region subset.

    Three flavors (reference Field semantics, :44-109), classified once at
    construction into a ``kind`` tag:

    * ``const``   — ``Field("porosity", 0.3)``
    * ``random``  — ``Field("logK", SpatialCorrelatedField(...))``
    * ``derived`` — ``Field("K", kozeny_carman_fn, ["porosity", "visc"])``
      (a pure function of other fields' realizations, resolved by Fields)
    """

    def __init__(self, name, field=None, param_fields=[], regions=[]):
        self.name = name
        self.regions = [regions] if isinstance(regions, str) else list(regions)
        self.param_fields = list(param_fields)
        self.is_outer = True
        self._realization = None
        self.full_sample_ids = None

        if isinstance(field, (int, float)) and not isinstance(field, bool):
            self.kind = "const"
            self.generator = float(field)
        elif isinstance(field, RandomFieldBase):
            self.kind = "random"
            self.generator = field
        elif callable(field):
            self.kind = "derived"
            self.generator = field
            if not self.param_fields:
                raise ValueError(
                    "derived field {!r} needs param_fields to feed the "
                    "function".format(name))
            try:  # fail fast on arity/shape mismatches
                field(*(np.ones(2),) * len(self.param_fields))
            except Exception as exc:
                raise ValueError(
                    "derived field {!r}: function rejected probe "
                    "arguments".format(name)) from exc
        else:
            raise ValueError(
                "field {!r} must be a number, a RandomFieldBase, or a "
                "callable; got {!r}".format(name, field))
        if self.kind != "derived" and self.param_fields:
            raise ValueError(
                "param_fields only apply to derived (callable) fields")

    def set_points(self, points):
        if self.kind == "const":
            self._realization = np.full(len(points), self.generator)
        elif self.kind == "random":
            self.generator.set_points(points)
            if type(self.generator) is SpatialCorrelatedField:
                self.generator.svd_dcmp(n_terms_range=(10, 100))

    def sample(self, key=None):
        if self.kind == "random":
            self._realization = np.asarray(self.generator.sample(key))
        elif self.kind == "derived":
            self._realization = self.generator(
                *(pf._realization for pf in self.param_fields))
        return self._realization


class Fields:
    """Set of cross-dependent named fields over mesh regions.

    Same capability as reference Fields (:111-231): region restriction,
    derived-field dependency resolution by name, and outer-field selection
    of which realizations the simulation actually receives.
    """

    def __init__(self, fields):
        # fields register in declaration order and parameters resolve only
        # against ALREADY-DECLARED names: sample() evaluates in list order,
        # so a forward reference would read a stale (or missing)
        # realization — reject it at construction instead
        self.fields = []
        self.by_name = {}
        for f in fields:
            field = copy.copy(f)
            field.param_fields = [self._resolve(p, field.regions)
                                  for p in field.param_fields]
            self.fields.append(field)
            self.by_name[field.name] = field
        self._host_key = jax.random.key(np.random.randint(0, 2 ** 31))

    def _resolve(self, param, regions):
        """A derived field's parameter: an already-declared field name, or
        a bare number (auto-wrapped as an anonymous constant field)."""
        if isinstance(param, (int, float)) and not isinstance(param, bool):
            const = Field("const_{}".format(param), param, regions=regions)
            self.fields.insert(0, const)
            self.by_name[const.name] = const
            return const
        if param not in self.by_name:
            raise KeyError(
                "field {!r} referenced before its definition (evaluation "
                "follows declaration order); declared so far: {}".format(
                    param, sorted(self.by_name)))
        return self.by_name[param]

    @property
    def names(self):
        return self.by_name.keys()

    def set_outer_fields(self, outer):
        outer = set(outer)
        for f in self.fields:
            f.is_outer = f.name in outer

    def set_points(self, points, region_ids=[], region_map={}):
        """Attach mesh points; region-restricted fields only see the points
        whose region id maps into their region list.

        Omitting BOTH region arguments treats every point as belonging to
        every declared region; passing region ids without the name->id map
        (or vice versa) is an error — defaulting one of them would silently
        select zero points for region-restricted fields.
        """
        self.n_elements = len(points)
        restricted = any(f.regions for f in self.fields)
        if len(region_ids) == 0 and not region_map:
            region_ids = np.zeros(self.n_elements, dtype=int)
            region_map = {r: 0 for f in self.fields for r in f.regions}
        elif len(region_ids) == 0 or (not region_map and restricted):
            raise ValueError(
                "region_ids and region_map must be passed together "
                "(got {} ids, map {})".format(len(region_ids), region_map))
        region_ids = np.asarray(region_ids)
        if len(region_ids) != self.n_elements:
            raise ValueError("one region id per point required")

        for field in self.fields:
            if field.regions:
                wanted = np.asarray([region_map[r] for r in field.regions])
                ids = np.flatnonzero(np.isin(region_ids, wanted))
            else:
                ids = np.arange(self.n_elements)
            field.full_sample_ids = ids
            field.set_points(points[ids])

    def sample(self, key=None):
        """One realization of every outer field, scattered back onto the
        full element set (zeros outside a field's regions).

        :return: {field_name: [n_elements] array}
        """
        if key is None:
            self._host_key, key = jax.random.split(self._host_key)
        result = {}
        for i, field in enumerate(self.fields):
            values = field.sample(jax.random.fold_in(key, i))
            if field.is_outer:
                full = np.zeros(self.n_elements)
                full[field.full_sample_ids] = np.asarray(values)
                result[field.name] = full
        return result
