"""Quasi-Monte Carlo tier: Sobol' engine + MLQMC driver.

The reference has no QMC capability (plain pseudo-random sampling
throughout: reference mlmc/sampling_pool.py:75-84). These tests pin
(1) bit-exact parity of the device Sobol' generator with scipy's
Joe-Kuo sequence, (2) that hash-based Owen scrambling preserves the
digital-net structure, (3) the variance superiority over plain MC that
justifies the tier, and (4) the Giles-Waterhouse adaptive driver's
correctness against closed-form workload moments.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mlmc_tpu.ops import sobol
from mlmc_tpu.qmc import MLQMC, synth_qmc_level_fns, qmc_level_fns_from_normals


def test_sobol_matches_scipy_bit_exact():
    from scipy.stats import qmc as sq

    dim, n = 16, 512
    ref = sq.Sobol(dim, scramble=False).random(n)
    dv = jnp.asarray(sobol.direction_numbers(dim))
    ours = np.asarray(sobol.sobol_bits(dv, 0, n), dtype=np.uint64) / 2.0 ** 32
    assert np.array_equal(ours, ref)


def test_sobol_start_offset_continues_the_sequence():
    dv = jnp.asarray(sobol.direction_numbers(4))
    whole = np.asarray(sobol.sobol_bits(dv, 0, 64))
    tail = np.asarray(sobol.sobol_bits(dv, 40, 24))
    assert np.array_equal(whole[40:], tail)


def test_owen_scramble_preserves_net_property():
    """Nested-uniform scrambling keeps one point per dyadic interval:
    scrambled 2^k-point prefixes stay (0, m, s)-nets in every 1D
    projection (the property that makes RQMC variance collapse)."""
    dim, n = 8, 256
    dv = jnp.asarray(sobol.direction_numbers(dim))
    seeds = sobol.scramble_seeds(jax.random.key(7), dim)
    bits = sobol.owen_scramble(sobol.sobol_bits(dv, 0, n), seeds)
    u = np.asarray(sobol.uniforms_from_bits(bits, dtype=np.float64))
    assert u.min() > 0.0 and u.max() < 1.0
    for d in range(dim):
        cells = np.floor(u[:, d] * n).astype(int)
        assert len(np.unique(cells)) == n


def test_owen_scramble_randomizations_differ_and_are_uniform():
    dim, n = 4, 1024
    dv = jnp.asarray(sobol.direction_numbers(dim))
    means = []
    prev = None
    for r in range(4):
        seeds = sobol.scramble_seeds(jax.random.key(100 + r), dim)
        u = np.asarray(sobol.sobol_uniforms(dv, 0, n, seeds,
                                            dtype=np.float64))
        if prev is not None:
            assert np.abs(u - prev).max() > 0.01
        prev = u
        means.append(u.mean(axis=0))
    # QMC-tight uniformity: each randomization's mean error ~ O(1/n)
    assert np.abs(np.asarray(means) - 0.5).max() < 5e-3


def test_qmc_variance_beats_mc():
    """Randomization spread of a scrambled-Sobol mean must be far below
    the pseudo-random mean's standard error on a smooth integrand."""
    dim, n, n_rand = 2, 4096, 12
    dv = jnp.asarray(sobol.direction_numbers(dim))

    def integrand(u):
        return jnp.sin(u[:, 0] * 3.0) * jnp.exp(u[:, 1])

    q_means = []
    for r in range(n_rand):
        seeds = sobol.scramble_seeds(jax.random.key(r), dim)
        u = sobol.sobol_uniforms(dv, 0, n, seeds, dtype=jnp.float64)
        q_means.append(float(jnp.mean(integrand(u))))
    key = jax.random.key(0)
    mc = integrand(jax.random.uniform(key, (n, dim), dtype=jnp.float64))
    mc_se = float(jnp.std(mc)) / np.sqrt(n)
    qmc_se = np.std(q_means, ddof=1)
    assert qmc_se < mc_se / 20.0, (qmc_se, mc_se)


def test_uniforms_strictly_inside_01_in_f32():
    """Extreme bit patterns must stay strictly inside (0, 1) in f32.

    Regression: keeping 24 bits rounds ``(2^24 - 1) + 0.5`` up to
    ``2^24`` (not representable in f32), yielding u == 1.0 and an inf
    out of ndtri — hit on a device by a real scrambled point.
    """
    extremes = jnp.asarray([0, 1, 2 ** 23, 2 ** 32 - 1, 2 ** 32 - 256],
                           dtype=jnp.uint32)
    u = sobol.uniforms_from_bits(extremes, dtype=jnp.float32)
    assert u.dtype == jnp.float32
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    z = sobol.normals_from_uniforms(u)
    assert bool(jnp.all(jnp.isfinite(z)))
    u64 = sobol.uniforms_from_bits(extremes, dtype=jnp.float64)
    assert float(u64.min()) > 0.0 and float(u64.max()) < 1.0


def test_normals_from_uniforms_moments():
    dv = jnp.asarray(sobol.direction_numbers(1))
    seeds = sobol.scramble_seeds(jax.random.key(5), 1)
    z = np.asarray(sobol.sobol_normals(dv, 0, 4096, seeds,
                                       dtype=jnp.float64))[:, 0]
    assert abs(z.mean()) < 5e-3
    assert abs(z.std() - 1.0) < 5e-3
    assert abs((z ** 3).mean()) < 0.02


def test_mlqmc_driver_matches_closed_form_and_meets_target():
    from scipy import integrate, stats

    steps = [[0.9], [0.3], [0.1]]
    fns, dims = synth_qmc_level_fns(steps, distr="norm")
    ml = MLQMC(fns, dims, n_randomizations=16, seed=1, chunk_size=1 << 12)
    target = 1e-8
    res = ml.run(target_var=target, n_init=256)
    assert res["target_met"]
    assert res["rounds"] > 0                      # it actually adapted
    assert res["n_samples"][0] > res["n_samples"][-1]
    # telescoped mean == E[y + h_fine*sqrt(1e-4 + |y|)], y ~ N(0, 1)
    exact = 0.1 * integrate.quad(
        lambda y: np.sqrt(1e-4 + abs(y)) * stats.norm.pdf(y),
        -12, 12)[0]
    err = abs(res["mean"] - exact)
    assert err < 6.0 * np.sqrt(res["var"]) + 1e-12, (err, res["var"])
    # the headline claim: large measured variance reduction vs MC at the
    # same evaluation count, on every level
    assert np.all(res["mc_variance_reduction"] > 50.0), \
        res["mc_variance_reduction"]


def test_mlqmc_level_fns_from_normals_adapter():
    def normal_fn(z):
        y = z[:, 0] + 0.1 * z[:, 1]
        return y * y, jnp.zeros_like(y)

    fns, dims = qmc_level_fns_from_normals([normal_fn], 2)
    ml = MLQMC(fns, dims, n_randomizations=8, seed=2, chunk_size=1 << 10)
    ml.extend(0, 1024)
    means, est_vars = ml.level_estimates()
    assert abs(means[0] - 1.01) < 1e-2            # E[(z0 + 0.1 z1)^2]
    assert est_vars[0] < 1e-5


def test_shooting_qmc_matches_mc_and_collapses_variance():
    """The shooting adapter drives the spectral phases from scrambled
    Sobol' points: means must agree with the key-driven MC batch path
    within combined statistical error, and the measured RQMC variance
    reduction must be large (the non-log QoI is additive across modes)."""
    from mlmc_tpu.sim.shooting import ShootingSimulation1D
    from mlmc_tpu.qmc import shooting_qmc_level_fns

    config = dict(start_position=(0.0, 0.0), start_velocity=(10.0, 0.0),
                  area_borders=(-1000.0, 1000.0, -1000.0, 1000.0),
                  max_time=10.0, complexity=100,
                  n_modes=32, fields_params=dict(model="gauss",
                                                 corr_length=0.3,
                                                 sigma=0.5, log=False))
    sim = ShootingSimulation1D(config)
    level_params = [[1.0], [0.25]]
    fns, dims = shooting_qmc_level_fns(sim, level_params)
    assert dims == [32, 32]
    ml = MLQMC(fns, dims, n_randomizations=8, seed=4, chunk_size=1 << 10)
    res = ml.run(target_var=1e-6, n_init=1 << 10)
    assert res["target_met"]
    assert np.all(res["mc_variance_reduction"] > 20.0), \
        res["mc_variance_reduction"]

    # MC cross-check of the telescoped mean through calculate_batch
    ls = [sim.level_instance(p, [0] if i == 0 else level_params[i - 1])
          for i, p in enumerate(level_params)]
    key = jax.random.key(17)
    mc_mean, mc_var = 0.0, 0.0
    n_mc = 4096
    for lev, level_sim in enumerate(ls):
        keys = jax.random.split(jax.random.fold_in(key, lev), n_mc)
        fine, coarse, _ = ShootingSimulation1D.calculate_batch(
            level_sim.config_dict, keys)
        d = np.asarray(fine[:, 0] - coarse[:, 0])
        assert np.all(np.isfinite(d))
        mc_mean += d.mean()
        mc_var += d.var(ddof=1) / n_mc
    err = abs(res["mean"] - mc_mean)
    assert err < 6.0 * np.sqrt(res["var"] + mc_var), (res["mean"], mc_mean)


def test_darcy_qmc_matches_mc_and_reduces_variance():
    """PDE MLMC under QMC: the RFF phases come from scrambled Sobol'
    points; the outflow-flux estimate must agree with the key-driven MC
    batch path, with a real variance reduction."""
    from mlmc_tpu.sim.diffusion import DiffusionSimulation
    from mlmc_tpu.qmc import darcy_qmc_level_fns

    sim = DiffusionSimulation(dict(sigma=0.8, corr_length=0.4,
                                   field_method="rff", n_modes=32))
    level_params = [[1 / 4], [1 / 8]]
    fns, dims = darcy_qmc_level_fns(sim, level_params)
    assert dims == [32, 32]
    ml = MLQMC(fns, dims, n_randomizations=8, seed=6, chunk_size=1 << 8)
    res = ml.run(target_var=2e-6, n_init=1 << 8, max_rounds=10)
    assert np.isfinite(res["mean"]) and res["mean"] > 0
    # level 0 (the absolute-value level, where nearly all the variance
    # lives) gains an order of magnitude; the fine-coarse DIFFERENCE is a
    # rougher functional of the phases, so its gain is modest
    gains = res["mc_variance_reduction"]
    assert gains[0] > 10.0 and np.all(gains > 1.5), gains

    mc_mean, mc_var, key = 0.0, 0.0, jax.random.key(29)
    n_mc = 512
    for lev, params in enumerate(level_params):
        coarse = [0] if lev == 0 else level_params[lev - 1]
        cfg = sim.level_instance(params, coarse).config_dict
        keys = jax.random.split(jax.random.fold_in(key, lev), n_mc)
        fine, coarse_r, _ = DiffusionSimulation.calculate_batch(cfg, keys)
        d = np.asarray(fine[:, 0] - coarse_r[:, 0])
        mc_mean += d.mean()
        mc_var += d.var(ddof=1) / n_mc
    err = abs(res["mean"] - mc_mean)
    assert err < 6.0 * np.sqrt(res["var"] + mc_var), (res["mean"], mc_mean)

    # the circulant path has no phase parametrization: must refuse
    circ = DiffusionSimulation(dict(sigma=0.8, corr_length=0.4,
                                    field_method="circulant"))
    with pytest.raises(ValueError):
        darcy_qmc_level_fns(circ, level_params)


def test_mlqmc_rejects_failure_modes():
    with pytest.raises(ValueError):
        synth_qmc_level_fns([[0.5]], distr="norm", nan_fraction=0.1)
    with pytest.raises(ValueError):
        MLQMC([lambda u: (u[:, 0], u[:, 0])], 1, chunk_size=1000)
    with pytest.raises(ValueError):
        MLQMC([lambda u: (u[:, 0], u[:, 0])], 1, n_randomizations=1)

    def bad_fn(u):
        return jnp.log(u[:, 0] - 2.0), jnp.zeros(u.shape[0])  # NaN

    ml = MLQMC([bad_fn], 1, n_randomizations=4)
    with pytest.raises(FloatingPointError):
        ml.extend(0, 64)


def test_mlqmc_distribution_transforms():
    """Inverse-CDF samplers reproduce each distribution's mean/var
    through QMC points (ties sample_uniforms to the key-driven path)."""
    from mlmc_tpu.random.distributions import as_jax_distr

    dv_cache = {}
    for idx, name in enumerate(("norm", "lognorm", "uniform",
                                "two_gaussians")):
        d = as_jax_distr(name)
        dim = d.qmc_dim
        dv = dv_cache.setdefault(
            dim, jnp.asarray(sobol.direction_numbers(dim)))
        seeds = sobol.scramble_seeds(jax.random.key(idx), dim)
        u = sobol.sobol_uniforms(dv, 0, 8192, seeds, dtype=jnp.float64)
        y = np.asarray(d.sample_uniforms(u))
        assert abs(y.mean() - d.mean()) < 0.05 * max(1.0, abs(d.mean()) + d.var())
        assert abs(y.var() - d.var()) < 0.1 * max(1.0, d.var())


# ---------------------------------------------------------------------- #
# vector QoIs: moment vectors through the QMC tier
# ---------------------------------------------------------------------- #
def test_mlqmc_moment_vector_matches_quadrature():
    """The lifted moment-vector driver telescopes every Legendre moment
    to its exact (quadrature) value, with honest cross-randomization
    error bars, and the level-0 coarse moment block is zeroed (phi(0)
    is NOT the zero vector)."""
    from mlmc_tpu.moments import Legendre
    from mlmc_tpu.qmc import moments_qmc_level_fns

    def g0(u):
        x = u[:, 0]
        return x, jnp.zeros_like(x)

    def g1(u):
        x = u[:, 0]
        return x * x, x

    R = 8
    mfn = Legendre(R, (0.0, 1.0))
    fns, dims, K = moments_qmc_level_fns([g0, g1], [1, 1], mfn)
    assert K == R
    ml = MLQMC(fns, dims, n_randomizations=8, seed=3, qoi_dim=K,
               chunk_size=1 << 10, cost_per_sample=[1.0, 2.0])
    res = ml.run(target_var=1e-9, n_init=1024, max_rounds=20)
    assert res["target_met"]
    assert res["mean"].shape == (R,)

    # exact telescoped moments: E[phi_k(x^2)], x ~ U(0, 1)
    t, w = np.polynomial.legendre.leggauss(64)
    x = (t + 1.0) / 2.0
    phi = np.asarray(mfn.eval_all_np(x * x))
    exact = phi.T @ (w / 2.0)

    err = np.abs(res["mean"] - exact)
    bound = 6.0 * np.sqrt(res["var"]) + 1e-10
    assert np.all(err < bound), (err, bound)
    # the constant moment is exact and variance-free
    assert abs(res["mean"][0] - 1.0) < 1e-12
    assert res["var"][0] == 0.0
    # smooth 1D integrands: scrambled-net variance far below plain MC
    gain = np.asarray(res["mc_variance_reduction"])[:, 1:]
    assert np.median(gain[np.isfinite(gain)]) > 5.0


def test_mlqmc_moments_out_of_domain_error_and_clip():
    from mlmc_tpu.moments import Legendre
    from mlmc_tpu.qmc import moments_qmc_level_fns

    def g0(u):
        x = u[:, 0]
        return x, jnp.zeros_like(x)

    mfn = Legendre(4, (0.0, 0.5))          # half the points fall outside
    fns, dims, K = moments_qmc_level_fns([g0], [1], mfn)
    ml = MLQMC(fns, dims, n_randomizations=4, qoi_dim=K)
    with pytest.raises(FloatingPointError):
        ml.extend(0, 64)

    fns, dims, K = moments_qmc_level_fns([g0], [1], mfn,
                                         out_of_domain="clip")
    ml = MLQMC(fns, dims, n_randomizations=4, qoi_dim=K)
    ml.extend(0, 64)                       # clamps instead of failing
    means, _ = ml.level_estimates()
    assert np.all(np.isfinite(means))
    with pytest.raises(ValueError):
        moments_qmc_level_fns([g0], [1], mfn, out_of_domain="drop")

    # clip mode recurses through TransformedMoments (the orthogonalized
    # basis of the density workflow) instead of choking on its ctor
    from mlmc_tpu.moments import TransformedMoments

    tmfn = TransformedMoments(mfn, np.eye(4)[:3])
    fns, dims, K = moments_qmc_level_fns([g0], [1], tmfn,
                                         out_of_domain="clip")
    assert K == 3
    ml = MLQMC(fns, dims, n_randomizations=4, qoi_dim=K)
    ml.extend(0, 64)
    means, _ = ml.level_estimates()
    assert np.all(np.isfinite(means))


def test_mlqmc_moments_to_maxent_density_e2e():
    """The reference's density workflow (sample moments + variances ->
    maxent solve -> pdf; reference mlmc/estimator.py:116-134) rides the
    QMC tier end to end: a Gaussian QoI reconstructed from QMC moment
    estimates matches the exact pdf in KL."""
    from scipy import stats

    from mlmc_tpu.moments import Legendre
    from mlmc_tpu.qmc import moments_qmc_level_fns
    import mlmc_tpu.tool.simple_distribution as sd

    def normal_fn(z):
        return z[:, 0], jnp.zeros(z.shape[0])

    base_fns, dims = qmc_level_fns_from_normals([normal_fn], 1)
    mfn = Legendre(16, (-5.0, 5.0), safe_eval=False)
    fns, dims, K = moments_qmc_level_fns(base_fns, dims, mfn,
                                         out_of_domain="clip")
    ml = MLQMC(fns, dims, n_randomizations=8, seed=11, qoi_dim=K,
               chunk_size=1 << 12, cost_per_sample=[1.0])
    res = ml.run(target_var=1e-8, n_init=4096, max_rounds=14)

    # unit variances into the solve, like the reference density workflow
    # (estimator construct_density; the sigma column conditions the
    # Newton system rather than carrying statistics)
    moment_data = np.stack((res["mean"], np.ones(K)), axis=1)
    d = sd.SimpleDistribution(mfn, moment_data, domain=mfn.domain)
    result = d.estimate_density_minimize(tol=1e-7)
    assert result.success, result.message
    kl = sd.KL_divergence(stats.norm(0, 1).pdf, d.density, -5.0, 5.0)
    assert kl < 1e-3, kl


def test_mlqmc_sharded_randomizations_match_single_device():
    """The R randomizations shard_map across the pod: the sharded driver
    reproduces the single-device driver's accumulators (the reference's
    PBS fan-out, as one jitted program over the mesh)."""
    from mlmc_tpu.parallel.mesh import sample_mesh

    fns, dims = synth_qmc_level_fns([[0.5], [0.25]], distr="norm")
    kw = dict(n_randomizations=8, seed=21, chunk_size=1 << 9,
              cost_per_sample=[1.0, 2.0])
    single = MLQMC(fns, dims, **kw)
    sharded = MLQMC(fns, dims, mesh=sample_mesh(8), **kw)
    for ml in (single, sharded):
        ml.extend(0, 1024)
        ml.extend(1, 512)
        ml.extend(1, 512)           # extensions reuse the executable
    for s1, s2 in zip(single._levels, sharded._levels):
        np.testing.assert_allclose(s2.sums, s1.sums, rtol=1e-12)
        np.testing.assert_allclose(s2.sums_sq, s1.sums_sq, rtol=1e-12)
    m1, v1 = single.level_estimates()
    m2, v2 = sharded.level_estimates()
    np.testing.assert_allclose(m2, m1, rtol=1e-12)
    np.testing.assert_allclose(v2, v1, rtol=1e-10)

    with pytest.raises(ValueError):
        MLQMC(fns, dims, n_randomizations=6, mesh=sample_mesh(8))


def test_mlqmc_lattice_backend_matches_and_gains():
    """point_set='lattice': the extensible rank-1 lattice backend (fast
    CBC vector + random shifts + tent) agrees with the Sobol' backend
    within the combined randomization spread, shows a large measured
    gain over plain MC, and the prefix property makes split extensions
    bit-identical to one combined extension."""
    fns, dims = synth_qmc_level_fns([[0.5], [0.25]], distr="norm")
    kw = dict(n_randomizations=8, seed=3, chunk_size=1 << 9)

    lat = MLQMC(fns, dims, point_set="lattice", **kw)
    sob = MLQMC(fns, dims, **kw)
    for ml in (lat, sob):
        ml.extend(0, 1 << 12)
        ml.extend(1, 1 << 11)
    m_l, v_l = lat.level_estimates()
    m_s, v_s = sob.level_estimates()
    assert np.all(np.abs(m_l - m_s) < 6 * np.sqrt(v_l + v_s) + 1e-12), (
        m_l, m_s, v_l, v_s)
    gain = lat.point_variances() / (v_l * lat.n_samples * 8)
    assert np.all(gain > 10), gain

    # prefix/extension determinism: 2 x 512 == 1 x 1024
    a = MLQMC(fns, dims, point_set="lattice", **kw)
    b = MLQMC(fns, dims, point_set="lattice", **kw)
    a.extend(0, 512)
    a.extend(0, 512)
    b.extend(0, 1024)
    np.testing.assert_allclose(a._levels[0].sums, b._levels[0].sums,
                               rtol=1e-12)

    # adaptive run drives the same loop
    r = lat.run(target_var=1e-9)
    assert r["target_met"] and np.isfinite(r["mean"])


def test_mlqmc_lattice_capacity_and_validation():
    fns, dims = synth_qmc_level_fns([[0.5]], distr="norm")
    with pytest.raises(ValueError, match="point_set"):
        MLQMC(fns, dims, point_set="halton")
    with pytest.raises(ValueError, match="power of two"):
        MLQMC(fns, dims, point_set="lattice", lattice_n_max=1000)
    tiny = MLQMC(fns, dims, point_set="lattice", lattice_n_max=1 << 10,
                 n_randomizations=4, chunk_size=1 << 9)
    tiny.extend(0, 1 << 10)
    with pytest.raises(ValueError, match="capacity"):
        tiny.extend(0, 1 << 9)


def test_mlqmc_lattice_mesh_sharded_parity():
    from mlmc_tpu.parallel.mesh import sample_mesh

    fns, dims = synth_qmc_level_fns([[0.5], [0.25]], distr="norm")
    kw = dict(n_randomizations=8, seed=21, chunk_size=1 << 9,
              point_set="lattice")
    single = MLQMC(fns, dims, **kw)
    sharded = MLQMC(fns, dims, mesh=sample_mesh(8), **kw)
    for ml in (single, sharded):
        ml.extend(0, 1024)
        ml.extend(1, 512)
    for s1, s2 in zip(single._levels, sharded._levels):
        np.testing.assert_allclose(s2.sums, s1.sums, rtol=1e-12)


def test_mlqmc_option_guards():
    """Engine-specific options on the wrong engine are rejected loudly
    (a silently-ignored option is the worst failure mode)."""
    fns, dims = synth_qmc_level_fns([[0.5]], distr="norm")
    with pytest.raises(ValueError, match="lattice"):
        MLQMC(fns, dims, lattice_n_max=1 << 12)        # sobol default
    with pytest.raises(ValueError, match="lattice"):
        MLQMC(fns, dims, lattice_tent=False)
    MLQMC(fns, dims, point_set="lattice", lattice_n_max=1 << 12,
          lattice_tent=False)                           # valid combo


def test_lattice_mlqmc_prices_gbm_call():
    """Composition pin: the lattice engine through the SDE
    Brownian-bridge adapter prices the GBM European call to within the
    Euler weak bias of Black-Scholes, with large measured per-level
    RQMC gains — the lattice twin of the Sobol' pricing test."""
    import mlmc_tpu.sim.sde as sde
    from mlmc_tpu.sim.sde import sde_qmc_level_fns, black_scholes_call

    sim = sde.SDESimulation({"model": sde.gbm(0.05, 0.2, 1.0),
                             "payoff": sde.european_call(
                                 1.0, np.exp(-0.05))})
    fns, dims = sde_qmc_level_fns(sim, [[0.25], [0.125]])
    ml = MLQMC(fns, dims, n_randomizations=8, seed=5,
               chunk_size=1 << 10, point_set="lattice",
               lattice_n_max=1 << 16)
    res = ml.run(target_var=1e-8, n_init=1 << 10)
    assert res["target_met"]
    bs = black_scholes_call(1.0, 1.0, 0.05, 0.2, 1.0)
    err = abs(res["mean"] - bs)
    # Euler weak bias at n_fine = 8 dominates the 1e-4 statistical bar
    assert err < 6 * np.sqrt(res["var"]) + 5e-3, (res["mean"], bs)
    assert np.all(res["mc_variance_reduction"] > 20.0), \
        res["mc_variance_reduction"]
