"""Secondary benchmarks: BASELINE configs 2 (shooting), 3 (35-moment
two-Gaussian maxent), 4 (Quantity-algebra workload) and 5 (diffusion).
Not part of the driver's bench contract (bench.py stays the single-line
headline); run manually, numbers recorded in BASELINE.md.

Usage: python bench_extra.py [config ...]
"""
import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.sim.shooting import ShootingSimulation1D
from mlmc_tpu.sim.diffusion import DiffusionSimulation


def _timed_batches(batch_fn, B, reps):
    """Sustained throughput: ``reps`` coupled batches fused into ONE jitted
    dispatch (each call pays a dispatch and transfer latency regardless
    of work).

    :return: (dt_per_batch, stats dict) — stats carry the mean finite
        fine value and the NaN fraction of the last run, so a silently
        numerically-broken kernel cannot report a healthy number.
    """
    import jax.numpy as jnp

    @jax.jit
    def run(seed):
        def one(r):
            keys = jax.random.split(jax.random.fold_in(seed, r), B)
            fine, coarse, _ = batch_fn(keys)
            return fine, jnp.sum(fine) + jnp.sum(coarse)

        fine0, acc0 = one(0)
        mean = jnp.nanmean(fine0)
        nan_frac = jnp.mean(jnp.isnan(fine0).astype(jnp.float32))
        # fori_loop keeps the traced program ONE batch body regardless of
        # reps (an unrolled python loop made deep-rep dispatches over
        # heavy per-batch bodies like the Darcy CG prohibitively slow to
        # compile)
        acc = jax.lax.fori_loop(1, reps, lambda r, a: a + one(r)[1], acc0)
        # one [3] transfer forces completion without extra round trips
        return jnp.stack([acc.astype(jnp.float32).ravel()[0],
                          mean.astype(jnp.float32).ravel()[0], nan_frac])

    seed = jax.random.key(0)
    _ = np.asarray(run(seed))
    t0 = time.perf_counter()
    for i in range(3):
        out = np.asarray(run(jax.random.key(i + 1)))
    dt = (time.perf_counter() - t0) / 3 / reps
    return dt, {"mean_fine": round(float(out[1]), 5),
                "nan_fraction": round(float(out[2]), 5)}


def bench_shooting():
    sim = ShootingSimulation1D(dict(
        start_position=(0.0, 0.0), start_velocity=(10.0, 0.0),
        area_borders=(-100.0, 200.0, -300.0, 400.0), max_time=10.0,
        complexity=20.0, n_modes=256,
        fields_params=dict(model="gauss", corr_length=1.0, sigma=0.5,
                           log=False)))
    level_sim = sim.level_instance([0.02], [0.1])  # fine n=1000 steps
    cfg = level_sim.config_dict
    B = 8192
    # 32 batches/dispatch: the matmul-formulated sample body is cheap per
    # batch, so the per-dispatch latency needs more amortization than the
    # default 8 reps
    dt, stats = _timed_batches(
        lambda k: ShootingSimulation1D.calculate_batch(cfg, k), B, reps=32)
    return dict(workload="shooting 1D, 1000+200 Euler steps, 256 modes",
                samples_per_s=round(B / dt, 1), wall_s=round(dt, 4),
                **stats)


def bench_diffusion():
    # BASELINE config 5 names the circulant-embedding GRF explicitly
    sim = DiffusionSimulation(dict(sigma=1.0, corr_length=0.3,
                                   field_method="circulant"))
    level_sim = sim.level_instance([1 / 64], [1 / 16])
    cfg = level_sim.config_dict
    B = 1024  # the batched CG is latency-bound below ~1k samples/batch
    # 16 batches/dispatch amortize the per-dispatch latency
    dt, stats = _timed_batches(
        lambda k: DiffusionSimulation.calculate_batch(cfg, k), B, reps=16)
    return dict(workload="Darcy 64^2+16^2 grids, CG solve, "
                         "circulant-embedding GRF",
                samples_per_s=round(B / dt, 1), wall_s=round(dt, 4),
                **stats)


def bench_fractured3d():
    """3-D fractured Darcy (no reference-feasible analogue): 1e3-contrast
    penny-shaped disc networks rasterized into the 3-D GRF, solved by
    MG(2,2)-preconditioned CG with exact Galerkin coarse
    transmissibilities."""
    from mlmc_tpu.random.frac_geom import FracturedDiffusionSimulation3D

    sim = FracturedDiffusionSimulation3D(
        dict(sigma=1.0, corr_length=0.3, n_fractures=24,
             frac_contrast=1e3))
    cfg = sim.level_instance([1 / 32], [1 / 16]).config_dict
    B = 64
    dt, stats = _timed_batches(
        lambda k: FracturedDiffusionSimulation3D.calculate_batch(cfg, k),
        B, reps=4)
    return dict(workload="3-D fractured Darcy 32^3+16^3, 24 discs at "
                         "1e3 contrast, MG-CG",
                samples_per_s=round(B / dt, 1), wall_s=round(dt, 4),
                **stats)


def bench_darcy3d():
    """3-D Darcy (no reference-feasible analogue off-cluster): coupled
    32^3+16^3 CG solves under the DST/DCT spectral preconditioner,
    3-D RFF log-normal conductivity."""
    from mlmc_tpu.sim.diffusion3d import DiffusionSimulation3D

    sim = DiffusionSimulation3D(dict(sigma=1.0, corr_length=0.3))
    cfg = sim.level_instance([1 / 32], [1 / 16]).config_dict
    B = 256
    dt, stats = _timed_batches(
        lambda k: DiffusionSimulation3D.calculate_batch(cfg, k), B,
        reps=8)
    return dict(workload="3-D Darcy 32^3+16^3 grids, spectral-"
                         "preconditioned CG, RFF GRF",
                samples_per_s=round(B / dt, 1),
                cell_solves_per_s=round(B * (32 ** 3 + 16 ** 3) / dt, 0),
                wall_s=round(dt, 4), **stats)


def bench_fractured():
    """Fractured Darcy (the reference's geomop+flow123d fracture workflow,
    device-native): 1e3-contrast fracture network rasterized into the
    circulant GRF, solved by multigrid-preconditioned CG (the class
    default: the V-cycle's coarse-space correction takes the worst-sample
    iteration count from ~24n scaled-spectral to <=67 at 64^2; see
    sim/diffusion.py and tests/test_diffusion.py)."""
    from mlmc_tpu.random.frac_geom import FracturedDiffusionSimulation

    sim = FracturedDiffusionSimulation(dict(
        sigma=1.0, corr_length=0.3, field_method="circulant",
        n_fractures=24, frac_contrast=1e3))
    level_sim = sim.level_instance([1 / 64], [1 / 16])
    cfg = level_sim.config_dict
    B = 1024
    dt, stats = _timed_batches(
        lambda k: FracturedDiffusionSimulation.calculate_batch(cfg, k), B,
        reps=8)
    return dict(workload="fractured Darcy 64^2+16^2, contrast 1e3, "
                         "24 fractures, MG-CG",
                samples_per_s=round(B / dt, 1), wall_s=round(dt, 4),
                **stats)


def bench_transport():
    """Solute transport (the reference's 02_conc workflow, device-native):
    Darcy velocity field from a circulant log-normal GRF + upwind FV
    advection; QoI = 8-point breakthrough curve at the outflow edge."""
    from mlmc_tpu.sim.transport import TransportSimulation

    sim = TransportSimulation(dict(sigma=1.0, corr_length=0.3,
                                   field_method="circulant"))
    level_sim = sim.level_instance([1 / 64], [1 / 16])
    cfg = level_sim.config_dict
    B = 1024
    dt, stats = _timed_batches(
        lambda k: TransportSimulation.calculate_batch(cfg, k), B, reps=8)
    return dict(workload="transport 64^2+16^2, upwind FV breakthrough, "
                         "circulant GRF",
                samples_per_s=round(B / dt, 1), wall_s=round(dt, 4),
                **stats)


def bench_sde():
    """SDE path MLMC (no reference analogue — the reference has no SDE
    family): (a) coupled Milstein GBM level-batch throughput at 256+64
    steps, (b) the full MLQMC European-call pricing run (Brownian-bridge
    Sobol' points) with its error against Black-Scholes."""
    from mlmc_tpu.qmc import MLQMC
    from mlmc_tpu.sim.sde import (SDESimulation, black_scholes_call,
                                  european_call, gbm, sde_qmc_level_fns)

    rate, sigma = 0.05, 0.2
    discount = float(np.exp(-rate))
    sim = SDESimulation(dict(model=gbm(rate, sigma, 1.0), scheme="milstein",
                             payoff=european_call(1.0, discount)))
    cfg = sim.level_instance([1 / 256], [1 / 64]).config_dict
    B = 1 << 16
    dt, stats = _timed_batches(
        lambda k: SDESimulation.calculate_batch(cfg, k), B, reps=8)

    fns, dims = sde_qmc_level_fns(sim, [[1 / 8], [1 / 32], [1 / 128]])
    ml = MLQMC(fns, dims, n_randomizations=12, seed=7, chunk_size=1 << 11)
    ml.extend(0, 1 << 11)     # warm the executable set
    t0 = time.perf_counter()
    res = ml.run(target_var=1e-9, n_init=1 << 11)
    qmc_wall = time.perf_counter() - t0
    bs = black_scholes_call(1.0, 1.0, rate, sigma, 1.0)
    return dict(workload="GBM Milstein 256+64-step coupled batches + "
                         "MLQMC European call to target_var=1e-9",
                samples_per_s=round(B / dt, 1), wall_s=round(dt, 4),
                qmc_price_wall_s=round(qmc_wall, 2),
                qmc_evaluations=int(np.sum(res["n_evaluations"])),
                price=float(res["mean"]),
                black_scholes=bs,
                price_err=float(abs(res["mean"] - bs)),
                target_met=res["target_met"],
                **stats)


def bench_importance():
    """Girsanov importance sampling (drift_shift): deep-OTM GBM call
    (K = 1.8 S0, Black-Scholes price ~2.9e-4) — on-chip measured
    variance ratio of the plain vs the IS estimator at the same path
    count, the IS price against Black-Scholes, and coupled-batch
    throughput with the weight attached."""
    from mlmc_tpu.sim.sde import (SDESimulation, black_scholes_call,
                                  european_call, gbm, gbm_call_shift)

    r, sigma, s0, K, T = 0.05, 0.2, 1.0, 1.8, 1.0
    theta = gbm_call_shift(r, sigma, s0, K, T)
    disc = float(np.exp(-r * T))
    B = 1 << 17

    def make_cfg(shift):
        extra = {"drift_shift": shift} if shift else {}
        sim = SDESimulation(dict(model=gbm(r, sigma, s0),
                                 scheme="milstein", total_time=T,
                                 payoff=european_call(K, disc), **extra))
        return sim.level_instance([1.0 / 256], [0]).config_dict

    def mean_var(cfg, seed):
        @jax.jit
        def f(sd):
            keys = jax.random.split(sd, B)
            fine, _, _ = SDESimulation.calculate_batch(cfg, keys)
            v = fine[:, 0]
            m = jnp.mean(v)
            return jnp.stack([m, jnp.mean((v - m) ** 2)])

        _ = np.asarray(f(jax.random.key(seed)))           # warm
        t0 = time.perf_counter()
        out = np.asarray(f(jax.random.key(seed + 1)))
        return float(out[0]), float(out[1]), time.perf_counter() - t0

    m_is, v_is, wall = mean_var(make_cfg(theta), 11)
    m_pl, v_pl, _ = mean_var(make_cfg(None), 13)
    bs = black_scholes_call(s0, K, r, sigma, T)
    cfg_lvl = make_cfg(theta)
    cfg_lvl = dict(cfg_lvl, n_coarse=64)
    dt, stats = _timed_batches(
        lambda k: SDESimulation.calculate_batch(cfg_lvl, k),
        1 << 16, reps=8)
    return dict(workload="deep-OTM GBM call K=1.8, Milstein n=256, "
                         "IS tilt vs plain at B=2^17",
                theta=round(theta, 4),
                price_is=m_is, black_scholes=bs,
                rel_err_is=round(abs(m_is - bs) / bs, 5),
                se_is=float(np.sqrt(v_is / B)),
                plain_mean=m_pl,
                variance_ratio=round(v_pl / v_is, 1),
                wall_s_estimate=round(wall, 4),
                coupled_samples_per_s=round((1 << 16) / dt, 1), **stats)


def bench_lattice():
    """Rank-1 lattice rules: CBC construction wall, shifted-estimate
    accuracy against closed forms (periodic product and the tent-
    transformed exp product), and point-set throughput on the chip."""
    from mlmc_tpu.ops.lattice import cbc_vector, lattice_estimate

    d, n, R = 8, 1 << 12, 16
    t0 = time.perf_counter()
    z = cbc_vector(n, d)
    cbc_wall = time.perf_counter() - t0

    def f_periodic(u):
        return jnp.prod(1.0 + 0.25 * (u * u - u + 1.0 / 6.0), axis=1)

    def f_exp(u):
        return jnp.prod(jnp.exp(u), axis=1)

    out_p = lattice_estimate(f_periodic, d, n=n, n_shifts=R, z=z)
    t0 = time.perf_counter()
    out_p = lattice_estimate(f_periodic, d, n=n, n_shifts=R, z=z)
    wall_p = time.perf_counter() - t0
    truth_p = 1.0           # int_0^1 B2 = 0 -> the product integral
    out_e = lattice_estimate(f_exp, d, n=n, n_shifts=R, z=z,
                             use_tent=True)
    truth_e = (np.e - 1.0) ** d
    return dict(workload="d=8 CBC lattice, n=%d, R=%d shifts" % (n, R),
                cbc_wall_s=round(cbc_wall, 3),
                periodic_err=float(abs(out_p["mean"] - truth_p)),
                periodic_se=out_p["se"],
                tent_exp_rel_err=float(abs(out_e["mean"] - truth_e)
                                       / truth_e),
                tent_exp_se_rel=out_e["se"] / truth_e,
                points_per_s=round(R * n / max(wall_p, 1e-9), 1),
                warm_wall_s=round(wall_p, 4))


def bench_american():
    """Longstaff-Schwartz Bermudan put (no reference analogue): 50
    exercise dates, degree-3 regression, exact GBM transitions — wall
    time of the two-pass fit+eval (warm), price vs the CRR binomial
    Bermudan on the same dates."""
    from mlmc_tpu.sim.american import (bermudan_binomial, lsmc_dual_bound,
                                       lsmc_price, put_payoff)

    rate, sigma, n_dates, B = 0.06, 0.2, 50, 1 << 18
    kw = dict(sigma=sigma, degree=3, n_paths=B, key=jax.random.key(2))
    lsmc_price(put_payoff(1.0), 1.0, rate, 1.0, n_dates, **kw)  # warm
    res = lsmc_price(put_payoff(1.0), 1.0, rate, 1.0, n_dates, **kw)
    tree = bermudan_binomial(1.0, 1.0, rate, sigma, 1.0, n_dates,
                             n_steps=200 * n_dates)
    # dual (Rogers) TRUE upper bound from a globally-valid surface
    # (itm_only=False — an ITM-only fit extrapolates wildly OTM).
    # Degree 5 halved the 50-date duality gap vs 3 (measured 0.0064 vs
    # 0.023 — surface error accumulated over the dates, NOT inner-MC
    # noise: n_inner 64 -> 512 moved it by <3%). The TSQR fit (r4)
    # lifted the old degree-6 f32 normal-equation cap, so the surface
    # now fits at degree 7.
    kw_g = dict(kw, itm_only=False, degree=7, key=jax.random.key(5))
    glob = lsmc_price(put_payoff(1.0), 1.0, rate, 1.0, n_dates, **kw_g)
    dkw = dict(coef=glob["coef"], sigma=sigma, n_paths=1 << 14,
               n_inner=64, key=jax.random.key(6))
    lsmc_dual_bound(put_payoff(1.0), 1.0, rate, 1.0, n_dates, **dkw)
    dual = lsmc_dual_bound(put_payoff(1.0), 1.0, rate, 1.0, n_dates,
                           **dkw)
    return dict(workload=f"LSMC Bermudan put, {n_dates} dates, "
                         f"2x{B} paths, degree-3 two-pass",
                wall_s=round(res["wall_s"], 3),
                paths_per_s=round(2 * B / res["wall_s"], 1),
                price=res["price"], price_se=res["price_se"],
                price_insample=res["price_insample"],
                binomial=tree,
                gap_lower=round(tree - res["price"], 6),
                exercise_frac=round(res["exercise_frac"], 4),
                dual_upper=dual["upper"],
                dual_upper_se=dual["upper_se"],
                dual_wall_s=round(dual["wall_s"], 3),
                bracket_width=round(dual["upper"] - res["price"], 6),
                bracket_holds=bool(
                    res["price"] - 4 * res["price_se"] <= tree
                    <= dual["upper"] + 4 * dual["upper_se"]))


def bench_mimc():
    """Multi-index Monte Carlo (no reference analogue): the 1-D
    random-conductivity heat equation over (space x time) indices,
    adaptive run to a target variance, plus the measured optimal-work
    ratio against single-axis (diagonal) MLMC on the same problem."""
    import jax.numpy as jnp
    from mlmc_tpu.mimc import (MIMC, heat_mimc_value_fn,
                               mixed_difference_terms, total_degree_set)

    fn, d = heat_mimc_value_fn(sigma=0.5, n0=(4, 4), total_time=0.25)
    iset = total_degree_set(d, 4)
    m = MIMC(fn, iset, seed=3, chunk_size=1 << 12)
    for a in iset:           # warm every per-index executable
        m.extend(a, 1 << 12)
    t0 = time.perf_counter()
    res = m.run(target_var=1e-9)
    wall = time.perf_counter() - t0

    # work comparison at matched depth: cost model = nx * nt
    import jax
    keys = jax.random.split(jax.random.key(2), 4096)
    cost = lambda a: 2.0 ** (a[0] + a[1])
    mimc_sum = 0.0
    for alpha in iset:
        vals = 0
        for corner, sign in mixed_difference_terms(alpha):
            vals = vals + sign * np.asarray(fn(corner, keys))
        mimc_sum += np.sqrt(vals.var() * cost(alpha))
    mlmc_sum, prev = 0.0, None
    for lev in range(5):
        cur = np.asarray(fn((lev, lev), keys))
        diff = cur if prev is None else cur - prev
        mlmc_sum += np.sqrt(diff.var() * cost((lev, lev)))
        prev = cur
    return dict(workload="MIMC heat equation (space x time indices), "
                         "total-degree 4, target_var=1e-9",
                wall_s=round(wall, 2),
                mean=round(res["mean"], 6),
                var=float("%.3g" % res["var"]),
                n_total=int(np.sum(res["n_samples"])),
                n_indices=len(iset),
                rounds=res["rounds"],
                target_met=res["target_met"],
                work_ratio_vs_diag_mlmc=round(
                    float(mimc_sum ** 2 / mlmc_sum ** 2), 3))


def bench_mimc_darcy():
    """MIMC on the flagship 2-D Darcy PDE with ANISOTROPIC (hx, hy)
    refinement (VERDICT r3 item 8) — the regime where the reference's
    scalar hierarchy must pay nx*ny ~ 4^level per sample while mixed
    differences decay at the product rate. Adaptive run + measured
    optimal-work ratio vs diagonal (hx = hy) single-axis MLMC."""
    import jax
    from mlmc_tpu.mimc import (MIMC, darcy_mimc_value_fn,
                               mixed_difference_terms)

    # f32 device tier: CG to 1e-6 (the f32 plateau; mixed differences
    # at the depths below sit well above it)
    fn, d = darcy_mimc_value_fn(sigma=1.0, corr_length=0.3, n0=(4, 4),
                                cg_tol=1e-6)
    m = MIMC(fn, [(0, 0)], seed=3, chunk_size=1 << 9)
    t0 = time.perf_counter()
    res = m.run_adaptive(target_var=1e-8, bias_tol=3e-4,
                         n_pilot=1 << 9, max_indices=16)
    wall = time.perf_counter() - t0

    # work comparison: cost model = nx * ny = 2^(a0 + a1)
    keys = jax.random.split(jax.random.key(2), 512)
    cost = lambda a: 2.0 ** (a[0] + a[1])
    mimc_sum = 0.0
    for alpha in map(tuple, res["index_set"]):
        vals = 0
        for corner, sign in mixed_difference_terms(alpha):
            vals = vals + sign * np.asarray(fn(corner, keys))
        mimc_sum += np.sqrt(vals.var() * cost(alpha))
    depth = int(max(max(a) for a in res["index_set"]))
    mlmc_sum, prev = 0.0, None
    for lev in range(depth + 1):
        cur = np.asarray(fn((lev, lev), keys))
        diff = cur if prev is None else cur - prev
        mlmc_sum += np.sqrt(diff.var() * cost((lev, lev)))
        prev = cur
    return dict(workload="MIMC 2-D Darcy (hx x hy anisotropic "
                         "refinement), adaptive to target_var=1e-8",
                wall_s=round(wall, 2),
                mean=round(float(res["mean"]), 6),
                var=float("%.3g" % res["var"]),
                n_total=int(np.sum(res["n_samples"])),
                n_indices=len(res["index_set"]),
                max_depth=depth,
                target_met=bool(res["target_met"]),
                bias_converged=bool(res["bias_converged"]),
                bias_est=float("%.3g" % res["bias_est"]),
                work_ratio_vs_diag_mlmc=round(
                    float(mimc_sum ** 2 / mlmc_sum ** 2), 3))


def bench_maxent35():
    """BASELINE config 3: maxent PDF from 35 moments of a two-Gaussian
    mixture (reference harness: test/test_distribution.py:262-354 pattern —
    semiexact moments + covariance, orthogonalize, solve, KL vs exact)."""
    import scipy.stats as stats
    import mlmc_tpu.tool.simple_distribution as sd
    from mlmc_tpu.moments import Legendre

    w = (0.5, 0.5)
    comps = (stats.norm(-1.5, 0.6), stats.norm(2.0, 1.0))

    def pdf(x):
        return sum(wi * c.pdf(x) for wi, c in zip(w, comps))

    # quantile-cut domain like the reference CutDistribution (:36-88)
    lo = min(c.ppf(1e-8) for c in comps)
    hi = max(c.ppf(1 - 1e-8) for c in comps)
    R = 35
    mfn = Legendre(R, (lo, hi))

    cov = sd.compute_semiexact_cov(mfn, pdf)
    orto, info = sd.construct_ortogonal_moments(mfn, cov, tol=1e-13)
    mu = sd.compute_semiexact_moments(orto, pdf)
    moments_data = np.stack((mu, np.ones(orto.size)), axis=1)

    # warm pass: the device Newton jits one executable per (panel-bucket,
    # R) shape — per-process compile/deserialize stays outside the timed
    # solve (same discipline as bench.py and the kernel tiers)
    sd.SimpleDistribution(orto, moments_data,
                          domain=mfn.domain).estimate_density_minimize(
        tol=1e-10)
    t0 = time.perf_counter()
    d = sd.SimpleDistribution(orto, moments_data, domain=mfn.domain)
    result = d.estimate_density_minimize(tol=1e-10)
    solve_s = time.perf_counter() - t0

    kl = sd.KL_divergence(pdf, d.density, lo, hi)
    fitted = sd.compute_semiexact_moments(orto, d.density)
    residual = float(np.linalg.norm(fitted - mu))
    return dict(workload="maxent 35 moments, two-Gaussian mixture, tol 1e-10",
                solve_s=round(solve_s, 4),
                kl_vs_exact=float(kl),
                moment_residual=residual,
                n_orto_moments=int(orto.size),
                converged=bool(getattr(result, "success", True)))


BOOT_REPLICATES = 32


def bench_quantity_algebra():
    """BASELINE config 4: Quantity-algebra workload — a composite DAG
    (ufunc + arithmetic + getitem + select + moments) evaluated by
    estimate_mean over stored samples; reference library timed on the
    same DAG and data at reduced size for the per-sample comparison."""
    import mlmc_tpu.quantity.quantity_estimate as qe
    from mlmc_tpu import (Memory, SynthSimulation, DeviceBatchPool, Sampler,
                          Legendre, make_root_quantity)

    def run_device(n0):
        import jax
        from mlmc_tpu import DeviceMemory, Estimate

        sim = SynthSimulation(dict(distr="norm", complexity=2))
        # HBM-resident storage + device-resident pool results: the sample
        # payload never crosses the host<->device link
        storage = DeviceMemory()
        sampler = Sampler(storage,
                          DeviceBatchPool(seed=3, device_results=True,
                                          max_batch=1 << 20,
                                          min_bucket=1 << 18), sim,
                          [[0.1], [0.01], [0.001]])
        sampler.set_initial_n_samples([n0, n0 // 4, n0 // 16])
        sampler.schedule_samples()
        sampler.ask_sampling_pool_for_samples()
        total = sum(storage.get_n_collected())

        root = make_root_quantity(storage, sim.result_format())
        length, width = root["length"], root["width"]
        expr = np.sin(length[1]["10"]) * 2.0 + width[2]["30"] / 3.0
        # mask = traceable selection: the whole DAG fuses into one jitted
        # program (select would force eager per-node evaluation)
        sel = expr.mask(expr < 10.0)
        mfn = Legendre(8, (-10, 10))

        # tier 1: generic single-dispatch estimate_mean (works for ANY
        # traceable DAG/basis; auto-selected past the volume threshold)
        mq = qe.moments(sel, mfn)
        qe.estimate_mean(mq)  # warm (trace+compile)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            qe.cache_clear()
            m = qe.estimate_mean(mq)
        dt_generic = (time.perf_counter() - t0) / reps

        # tier 2: packed stored-sample tier — DAG eval + packing +
        # estimation compile into ONE dispatch; sustained = 8 back-to-back
        # dispatches enqueued asynchronously, one forced transfer at the
        # end (per-dispatch work is identical).
        # cache=False: repeated identical estimates are memoized per
        # storage state in production — here we time the dispatch itself
        est = Estimate(sel, storage, mfn)
        r = est._fast_results_packed(mfn, [0])[0]
        _ = float(r[-1].n_valid)  # warm + sync
        t0 = time.perf_counter()
        r = est._fast_results_packed(mfn, [0], cache=False)[0]
        _ = float(r[-1].n_valid)
        dt_packed = time.perf_counter() - t0
        reps = 8
        t0 = time.perf_counter()
        for _ in range(reps):
            r = est._fast_results_packed(mfn, [0], cache=False)[0]
        _ = float(r[-1].n_valid)
        dt_sustained = (time.perf_counter() - t0) / reps

        # tier 3: fused multi-round estimation — the multi-round analogue
        # of shooting/Darcy's batches-per-dispatch amortization. A SINGLE
        # estimate is one dispatch and cannot dodge the per-enqueue
        # latency; workloads that estimate REPEATEDLY — bootstrap
        # error bars — vmap all replicate estimates (distinct subsample
        # masks, so nothing CSEs away) inside the per-level program:
        # work per enqueue scales with B while enqueues stay at L.
        B = BOOT_REPLICATES
        est.est_bootstrap_fast(n_subsamples=B, moments_fn=mfn,
                               replace="poisson")  # warm
        t0 = time.perf_counter()
        est.est_bootstrap_fast(n_subsamples=B, moments_fn=mfn,
                               replace="poisson")
        dt_boot = time.perf_counter() - t0
        # each replicate re-estimates (essentially) every stored sample:
        # n_sub = n_valid <= n_collected, within the workload's <2%
        # mask/clip fraction
        boot_processed = float(B) * float(total)
        return (total, dt_generic, dt_packed, dt_sustained,
                dt_boot, boot_processed, np.asarray(m.mean))

    (total, dt_generic, dt_packed, dt_sust, dt_boot, boot_processed,
     mean) = run_device(1 << 21)
    out = dict(workload="quantity DAG: sin/mul/add/div/getitem/mask + "
                        "8 Legendre moments, 3 levels",
               n_samples=int(total),
               samples_per_s=round(total / dt_sust, 1),
               wall_s=round(dt_sust, 4),
               single_dispatch_samples_per_s=round(total / dt_packed, 1),
               generic_tier_samples_per_s=round(total / dt_generic, 1),
               fused_rounds_samples_per_s=round(boot_processed / dt_boot,
                                                1),
               fused_rounds_B=BOOT_REPLICATES,
               mean0=float(mean.ravel()[0]))

    # reference on the same DAG, smaller N (pure-numpy host path)
    try:
        import os
        sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tests"))
        from reference_shim import import_reference
        mlmc_ref = import_reference()
        import mlmc.quantity.quantity_estimate as ref_qe
        from mlmc.quantity.quantity import make_root_quantity as ref_root_fn
        from mlmc.moments import Legendre as RefLegendre
        from mlmc.sample_storage import Memory as RefMemory

        # fill with our DeviceBatchPool results at reduced size
        sim = SynthSimulation(dict(distr="norm", complexity=2))
        storage = Memory()
        sampler = Sampler(storage, DeviceBatchPool(seed=3), sim,
                          [[0.1], [0.01], [0.001]])
        n0 = 1 << 14
        sampler.set_initial_n_samples([n0, n0 // 4, n0 // 16])
        sampler.schedule_samples()
        sampler.ask_sampling_pool_for_samples()
        ref_storage = RefMemory()
        ref_storage.save_global_data(result_format=[
            __import__("mlmc.quantity.quantity_spec", fromlist=["QuantitySpec"])
            .QuantitySpec(name=s.name, unit=s.unit, shape=s.shape,
                          times=s.times, locations=s.locations)
            for s in sim.result_format()],
            level_parameters=[[0.1], [0.01], [0.001]])
        for lvl, pairs in enumerate(storage.sample_pairs()):
            arr = np.asarray(pairs)  # [M, N, 2 or 1]
            n = arr.shape[1]
            rows = np.empty((n, 2), dtype=object)
            for i in range(n):
                fine = arr[:, i, 0]
                coarse = arr[:, i, 1] if arr.shape[2] > 1 else np.zeros_like(fine)
                rows[i, 0] = "L%02d_S%07d" % (lvl, i)
                rows[i, 1] = (fine, coarse)
            ref_storage.save_samples({lvl: rows}, {})
        total_ref = sum(storage.get_n_collected())

        root = ref_root_fn(ref_storage, ref_storage.load_result_format())
        expr = np.sin(root["length"][1]["10"]) * 2.0 + root["width"][2]["30"] / 3.0
        sel = expr.select(expr < 10.0)
        mq = ref_qe.moments(sel, RefLegendre(8, (-10, 10)))
        t0 = time.perf_counter()
        m_ref = ref_qe.estimate_mean(mq)
        dt_ref = time.perf_counter() - t0
        out["reference_samples_per_s"] = round(total_ref / dt_ref, 1)
        out["reference_n_samples"] = int(total_ref)
        out["speedup_vs_reference"] = round(
            out["samples_per_s"] / out["reference_samples_per_s"], 1)
    except Exception as e:
        out["reference_error"] = str(e)[:200]
    return out


def bench_e2e_darcy():
    """End-to-end adaptive PDE MLMC: the full target-variance loop over
    the Darcy diffusion simulation (3 grid levels, circulant GRF, CG
    solves) plus convergence-rate diagnostics — the workload the
    reference runs through PBS-clustered flow123d jobs over hours/days
    (tool/flow_mc.py:213-217 budgets 10-20 min per FINE sample)."""
    import mlmc_tpu.estimator as est_mod
    import mlmc_tpu.quantity.quantity_estimate as qe
    from mlmc_tpu import (DeviceMemory, DeviceBatchPool, Sampler, Legendre,
                          DiffusionSimulation, make_root_quantity)

    t0 = time.perf_counter()
    sim = DiffusionSimulation(dict(sigma=1.0, corr_length=0.3,
                                   field_method="circulant"))
    storage = DeviceMemory()
    pool = DeviceBatchPool(seed=23, device_results=True,
                           min_bucket=1 << 12, max_batch=1 << 14)
    sampler = Sampler(storage, pool, sim, [[1 / 16], [1 / 32], [1 / 64]])
    sampler.set_initial_n_samples([2000, 500, 100])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()

    root = make_root_quantity(storage, sim.result_format())
    q = root["flux"][0]["outflow"][0]
    mfn = Legendre(15, (0.05, 8.0))
    est = est_mod.Estimate(q, storage, mfn)
    target_var = 1e-6
    rounds = 0
    while rounds < 12:
        raw_vars, _ns = est.estimate_diff_vars_fast()
        variances, n_ops = est.estimate_diff_vars_regression(
            sampler._n_scheduled_samples, raw_vars=raw_vars)
        n_est = est_mod.estimate_n_samples_for_target_variance(
            target_var, variances, n_ops, n_levels=sampler.n_levels)
        if sampler.process_adding_samples(n_est, 0, 0.3):
            break
        rounds += 1
    m = qe.estimate_mean(q)
    rates = est_mod.estimate_convergence_rates(
        m.l_means, m.l_vars, storage.get_level_parameters(),
        storage.get_n_ops())
    wall = time.perf_counter() - t0
    return dict(workload="adaptive Darcy MLMC to target_var=1e-6 "
                         "(16^2/32^2/64^2 grids, circulant GRF)",
                wall_s=round(wall, 2),
                n_samples=int(np.sum(storage.get_n_collected())),
                n_per_level=[int(v) for v in storage.get_n_collected()],
                adaptive_rounds=rounds,
                sample_dispatches=int(pool.n_dispatches),
                blocking_fetches=int(pool.n_blocking_fetches),
                mean_flux=float(np.ravel(np.asarray(m.mean))[0]),
                alpha=round(float(rates["alpha"]), 3),
                beta=round(float(rates["beta"]), 3),
                gamma=round(float(rates.get("gamma", np.nan)), 3))


def bench_e2e_adaptive():
    """End-to-end production path on one chip: adaptive target-variance
    loop (DeviceBatchPool + HBM-resident DeviceMemory) followed by the
    fast-tier maxent density from the stored samples.

    Round-3 shape (VERDICT r2 next #1): per-round estimation is ONE packed
    kernel dispatch (estimate_diff_vars_fast), sampling slices are 1M
    samples, and the persistent JAX compilation cache makes repeat runs
    skip the 10-30 s remote AOT compiles entirely."""
    import mlmc_tpu.estimator as est_mod
    from mlmc_tpu import (DeviceMemory, SynthSimulation, DeviceBatchPool,
                          Sampler, Legendre, make_root_quantity)

    t0 = time.perf_counter()
    sim = SynthSimulation(dict(distr="norm", complexity=2))
    storage = DeviceMemory()
    # min_bucket = max_batch: every executable is the same-bucket slice —
    # with DYNAMIC_CONFIG executable sharing that is ~2 compiles total
    # (level 0 + shared) instead of one per (level, bucket)
    pool = DeviceBatchPool(seed=17, device_results=True,
                           min_bucket=1 << 20, max_batch=1 << 20)
    sampler = Sampler(storage, pool, sim,
                      [[0.5], [0.25], [0.125], [0.0625], [0.03125]])
    sampler.set_initial_n_samples([200_000, 2_000])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()

    root = make_root_quantity(storage, sim.result_format())
    q = root["length"][1]["10"][0, 0]
    mfn = Legendre(25, (-4.0, 4.0))
    est = est_mod.Estimate(q, storage, mfn)

    target_var = 2e-8
    rounds = 0
    est_dispatches = 0
    while rounds < 20:
        raw_vars, _ns = est.estimate_diff_vars_fast()   # ONE kernel dispatch
        est_dispatches += 1
        variances, n_ops = est.estimate_diff_vars_regression(
            sampler._n_scheduled_samples, raw_vars=raw_vars)
        n_est = est_mod.estimate_n_samples_for_target_variance(
            target_var, variances, n_ops, n_levels=sampler.n_levels)
        if sampler.process_adding_samples(n_est, 0, 0.3):
            break
        rounds += 1
    _d, _i, result, _o = est.construct_density_fast(tol=1e-8)
    est_dispatches += 1
    wall = time.perf_counter() - t0
    n_total = int(np.sum(storage.get_n_collected()))
    return dict(workload="adaptive loop to target_var=2e-8 + fast maxent "
                         "density (DeviceMemory, 5 levels, 25 moments)",
                wall_s=round(wall, 2), n_samples=n_total,
                adaptive_rounds=rounds,
                sample_dispatches=int(pool.n_dispatches),
                blocking_fetches=int(pool.n_blocking_fetches),
                estimation_dispatches=est_dispatches,
                n_per_level=[int(v) for v in storage.get_n_collected()],
                density_converged=bool(getattr(result, "success", True)))


def bench_e2e_fused():
    """Storage-free end-to-end: the FusedMLMC adaptive driver (samples are
    generated, estimated, and discarded inside streaming accumulators) to
    the same target variance, then the maxent density from its state."""
    from mlmc_tpu.fused_driver import FusedMLMC, sim_level_chunk_fns
    from mlmc_tpu.moments import Legendre
    from mlmc_tpu.sim.synth_simulation import SynthSimulation

    t0 = time.perf_counter()
    sim = SynthSimulation(dict(distr="norm", complexity=2))
    level_params = [[0.5], [0.25], [0.125], [0.0625], [0.03125]]
    fns = sim_level_chunk_fns(sim, level_params, component=0)
    mfn = Legendre(25, (-4.0, 4.0))
    driver = FusedMLMC(fns, mfn, chunk_size=1 << 18)
    est = driver.run(target_var=2e-8, initial_n=(200_000, 2_000),
                     add_coeff=0.3)
    _d, _i, result, _o = driver.construct_density(tol=1e-8)
    wall = time.perf_counter() - t0
    return dict(workload="FusedMLMC adaptive loop to target_var=2e-8 + "
                         "maxent density (storage-free, 5 levels, 25 moments)",
                wall_s=round(wall, 2),
                n_samples=int(np.sum(est["n_samples"])),
                adaptive_rounds=len(est["history"]),
                n_per_level=[int(v) for v in est["n_samples"]],
                density_converged=bool(getattr(result, "success", True)))


def bench_qmc_compact():
    """Compact MLQMC evidence for the headline bench artifact: the
    5-level synth QoI to target_var=1e-12, reporting the evaluation
    count variance-optimally-allocated plain MC would need for the same
    target. One warm adaptive run, no throughput probe, no shooting
    workload — see ``bench_qmc`` for the full measurement."""
    from mlmc_tpu.qmc import MLQMC, synth_qmc_level_fns

    level_params = [[0.5], [0.25], [0.125], [0.0625], [0.03125]]
    fns, dims = synth_qmc_level_fns(level_params, distr="norm")
    target_var = 1e-12
    ml = MLQMC(fns, dims, n_randomizations=16, seed=11,
               chunk_size=1 << 16)
    ml.extend(0, 1 << 16)   # warm the executable set
    t0 = time.perf_counter()
    res = ml.run(target_var=target_var, n_init=1 << 14)
    wall = time.perf_counter() - t0
    point_vars = ml.point_variances()
    mc_required = float(np.sum(np.sqrt(point_vars))) ** 2 / target_var
    n_evals = int(np.sum(res["n_evaluations"]))

    # the SAME workload on the second RQMC family: the extensible
    # rank-1 lattice engine (fast-CBC vectors, random shifts, tent)
    lat = MLQMC(fns, dims, n_randomizations=16, seed=11,
                chunk_size=1 << 16, point_set="lattice")
    lat.extend(0, 1 << 16)
    t0 = time.perf_counter()
    res_l = lat.run(target_var=target_var, n_init=1 << 14)
    wall_l = time.perf_counter() - t0
    n_evals_l = int(np.sum(res_l["n_evaluations"]))
    return dict(target_var=target_var,
                wall_s=round(wall, 2),
                qmc_evaluations=n_evals,
                mc_optimal_evaluations=int(mc_required),
                mc_over_qmc=round(mc_required / max(n_evals, 1), 1),
                target_met=res["target_met"],
                lattice_wall_s=round(wall_l, 2),
                lattice_evaluations=n_evals_l,
                lattice_target_met=res_l["target_met"],
                sobol_minus_lattice_mean=float(
                    res["mean"] - res_l["mean"]))


def bench_qmc():
    """Multilevel quasi-Monte Carlo tier (no reference analogue — the
    reference is pseudo-random end to end): Owen-scrambled Sobol' points
    through the synthetic 5-level QoI, Giles-Waterhouse adaptive driver.

    Reports (a) on-chip point throughput (generation + QoI + reduction,
    all integer work in one dispatch), (b) the measured per-level
    variance-reduction factors vs plain MC at equal evaluation count and
    (c) the evaluation count MC would need for the same target variance.
    """
    from mlmc_tpu.qmc import MLQMC, synth_qmc_level_fns

    level_params = [[0.5], [0.25], [0.125], [0.0625], [0.03125]]
    fns, dims = synth_qmc_level_fns(level_params, distr="norm")
    target_var = 1e-12
    ml = MLQMC(fns, dims, n_randomizations=16, seed=11,
               chunk_size=1 << 16)
    # warm the executable set (pow2 extensions reuse compiled programs)
    ml.extend(0, 1 << 16)
    t0 = time.perf_counter()
    res = ml.run(target_var=target_var, n_init=1 << 14)
    wall = time.perf_counter() - t0

    # throughput probe: ONE deep dispatch (the dynamic trip count lets a
    # 2^21-point extension reuse the warm executable — 33.6M evaluations,
    # enough that the per-dispatch latency does not set the rate)
    big = int(np.argmax(res["n_samples"]))
    n_probe = 1 << 21
    ml.extend(big, n_probe)   # warms the level executable at this depth
    t1 = time.perf_counter()
    ml.extend(big, n_probe)
    dt = time.perf_counter() - t1
    evals_per_s = n_probe * res["n_randomizations"] / dt

    # MC with VARIANCE-OPTIMAL allocation (equal per-point costs here):
    # N_total = (sum_l sqrt(V_l))^2 / eps^2 — the fairest comparison
    point_vars = ml.point_variances()
    mc_required = float(np.sum(np.sqrt(point_vars))) ** 2 / target_var
    n_evals = int(np.sum(res["n_evaluations"]))

    # second workload: the shooting ODE (config 2) — phases from Sobol
    from mlmc_tpu.sim.shooting import ShootingSimulation1D
    from mlmc_tpu.qmc import shooting_qmc_level_fns

    shoot_cfg = dict(start_position=(0.0, 0.0), start_velocity=(10.0, 0.0),
                     area_borders=(-2000.0, 2000.0, -2000.0, 2000.0),
                     max_time=10.0, complexity=1000, n_modes=256,
                     fields_params=dict(model="gauss", corr_length=0.1,
                                        sigma=0.5, log=False))
    # steps give 200/500/1000 Euler elements (W is [n, n]: keep n ~1e3)
    sfns, sdims = shooting_qmc_level_fns(
        ShootingSimulation1D(shoot_cfg), [[5.0], [2.0], [1.0]])
    sml = MLQMC(sfns, sdims, n_randomizations=16, seed=13,
                chunk_size=1 << 13)
    t2 = time.perf_counter()
    sres = sml.run(target_var=1e-8, n_init=1 << 12)
    shoot_wall = time.perf_counter() - t2
    s_point_vars = sml.point_variances()
    s_mc = float(np.sum(np.sqrt(s_point_vars))) ** 2 / 1e-8
    s_evals = int(np.sum(sres["n_evaluations"]))

    return dict(workload="MLQMC (scrambled Sobol): 5-level synth QoI to "
                         "target_var=1e-12 + 3-level shooting ODE (256 "
                         "spectral phase dims) to 1e-8, 16 randomizations",
                wall_s=round(wall, 2),
                qmc_evaluations=n_evals,
                mc_optimal_evaluations=int(mc_required),
                mc_over_qmc=round(mc_required / max(n_evals, 1), 1),
                variance_reduction_per_level=[
                    round(float(g), 1) for g in res["mc_variance_reduction"]],
                target_met=res["target_met"],
                mean=res["mean"],
                points_per_s=float("%.3g" % evals_per_s),
                shooting=dict(
                    wall_s=round(shoot_wall, 2),
                    qmc_evaluations=s_evals,
                    mc_optimal_evaluations=int(s_mc),
                    mc_over_qmc=round(s_mc / max(s_evals, 1), 1),
                    variance_reduction_per_level=[
                        round(float(g), 1)
                        for g in sres["mc_variance_reduction"]],
                    target_met=sres["target_met"],
                    mean=sres["mean"]))


def bench_sensitivity():
    """Sobol' sensitivity indices on the Ishigami benchmark: accuracy vs
    the closed forms and sustained design throughput on chip (the whole
    pick-freeze design — generation, model, Jansen reductions — is one
    dispatch; n·(d+2) model evaluations per randomization)."""
    import jax.numpy as jnp

    from mlmc_tpu.sensitivity import sobol_indices

    a, b = 7.0, 0.1

    def ishigami(u):
        x = 2 * jnp.pi * u - jnp.pi
        return (jnp.sin(x[:, 0]) + a * jnp.sin(x[:, 1]) ** 2
                + b * x[:, 2] ** 4 * jnp.sin(x[:, 0]))

    v1 = 0.5 * (1 + b * np.pi ** 4 / 5) ** 2
    v2 = a ** 2 / 8
    v13 = 8 * b ** 2 * np.pi ** 8 / 225
    v = v1 + v2 + v13
    s_exact = np.array([v1, v2, 0.0]) / v
    st_exact = np.array([v1 + v13, v2, v13]) / v

    kw = dict(dim=3, n=1 << 17, n_randomizations=16, seed=4,
              chunk_size=1 << 13)
    res = sobol_indices(ishigami, **kw)       # warm (compile excluded)
    t0 = time.perf_counter()
    res = sobol_indices(ishigami, **kw)
    wall = time.perf_counter() - t0
    return dict(workload="Sobol' indices, Ishigami, n=2^17 x 16 "
                         "randomizations (10.5M model evaluations)",
                wall_s=round(wall, 3),
                model_evals_per_s=float("%.3g" % (res.n_evaluations / wall)),
                max_abs_err_first_order=float(
                    np.max(np.abs(res.first_order - s_exact))),
                max_abs_err_total_effect=float(
                    np.max(np.abs(res.total_effect - st_exact))),
                max_se=float(max(res.first_order_se.max(),
                                 res.total_effect_se.max())))


def bench_unbiased():
    """Unbiased randomized MLMC (no reference analogue): the coupled-sum
    Rhee-Glynn estimator pricing a GBM Milstein European call with ZERO
    discretization bias — the estimate targets Black-Scholes itself.
    refine=4 keeps the random level ladder short (variance drops 16x,
    cost 4x per level => geometric ratio 1/8)."""
    from mlmc_tpu.sim.sde import (SDESimulation, black_scholes_call,
                                  european_call, gbm)
    from mlmc_tpu.unbiased import GeometricLevels, UnbiasedMLMC, \
        sde_unbiased_level_fn

    rate, sigma, strike = 0.05, 0.2, 1.05
    sim = SDESimulation(dict(model=gbm(rate, sigma, 1.0), scheme="milstein",
                             payoff=european_call(strike,
                                                  float(np.exp(-rate)))))
    mc = UnbiasedMLMC(sde_unbiased_level_fn(sim, n0=8, refine=4),
                      GeometricLevels(0.125), estimator="coupled", seed=11,
                      # deep levels draw 8^-l of the samples at 4^l cost:
                      # shrink their chunks so a near-empty masked chunk
                      # doesn't dominate the wall
                      chunk_size=lambda lv: max((1 << 13) >> (2 * lv), 256),
                      cost_fn=lambda lv: 4.0 ** lv)
    mc.sample(1 << 14)        # warm the common executables
    t0 = time.perf_counter()
    out = mc.run(target_var=1e-8, n_init=1 << 15)
    wall = time.perf_counter() - t0
    bs = black_scholes_call(1.0, strike, rate, sigma, 1.0)
    err = abs(out["mean"] - bs)
    return dict(workload="Rhee-Glynn coupled-sum GBM Milstein call to "
                         "target_var=1e-8 (zero discretization bias)",
                wall_s=round(wall, 2),
                draws=int(out["n_draws"]),
                draws_per_s=round(out["n_draws"] / max(wall, 1e-9), 1),
                levels_explored=len(out["levels"]),
                price=float(out["mean"]), black_scholes=bs,
                price_err=float(err), se=float(np.sqrt(out["var"])),
                err_over_se=round(float(err / np.sqrt(out["var"])), 2),
                target_met=out["target_met"])


def bench_cdf():
    """Multilevel CDF/quantile estimation (no reference analogue): the
    GBM terminal-price distribution on a 257-point grid with the
    order-4 kernel; quantiles vs the exact lognormal (the residual is
    the finest level's Euler weak bias + smoothing, reported raw)."""
    import scipy.stats as stats
    from mlmc_tpu.cdf_estimate import MultilevelCDF, simulation_pair_fn
    from mlmc_tpu.sim.sde import SDESimulation, gbm, terminal_value

    rate, sigma = 0.05, 0.2
    sim = SDESimulation(dict(model=gbm(rate, sigma, 1.0),
                             payoff=terminal_value()))
    pair_fn, L = simulation_pair_fn(
        sim, [[1 / 4], [1 / 16], [1 / 64], [1 / 256]])
    ml = MultilevelCDF(pair_fn, L, grid=np.linspace(0.4, 2.4, 257),
                       bandwidth=0.02, kernel_order=4, seed=5,
                       chunk_size=1 << 13, cost_fn=lambda lv: 4.0 ** lv)
    ml.extend(0, 1 << 13)     # warm level 0
    t0 = time.perf_counter()
    est = ml.run(target_var=1e-6, n_init=1 << 14)
    wall = time.perf_counter() - t0
    ps = np.array([0.05, 0.5, 0.95])
    q, se = ml.quantiles(ps)
    exact_q = np.exp((rate - 0.5 * sigma ** 2) + sigma * stats.norm.ppf(ps))
    exact_cdf = stats.norm.cdf(
        (np.log(ml.grid) - (rate - 0.5 * sigma ** 2)) / sigma)
    n_total = int(est["n_samples"].sum())
    return dict(workload="GBM terminal CDF on 257 points, order-4 kernel, "
                         "target_var=1e-6 (worst grid point)",
                wall_s=round(wall, 2), n_pairs=n_total,
                pairs_per_s=round(n_total / max(wall, 1e-9), 1),
                cdf_sup_err=float(np.max(np.abs(est["cdf"] - exact_cdf))),
                quantile_err_max=float(np.max(np.abs(q - exact_q))),
                quantile_se_max=float(se.max()),
                target_met=est["target_met"])


def bench_risk():
    """Risk tier (no reference analogue): (a) 95% VaR + CVaR of the
    GBM terminal LOSS distribution at MLMC cost, checked against the
    exact lognormal closed forms; (b) CVaR-optimal hedging — minimize
    CVaR_0.9 of a hedged terminal loss over the hedge ratio with the
    whole-loop-jitted RU program."""
    import scipy.stats as stats
    from mlmc_tpu.cdf_estimate import simulation_pair_fn
    from mlmc_tpu.risk import cvar_mlmc, optimize_cvar
    from mlmc_tpu.sim.sde import SDESimulation, gbm, terminal_value

    rate, sigma, alpha = 0.05, 0.2, 0.95
    sim = SDESimulation(dict(model=gbm(rate, sigma, 1.0),
                             payoff=terminal_value()))
    fwd_pair, L = simulation_pair_fn(
        sim, [[1 / 4], [1 / 16], [1 / 64], [1 / 256]])

    def loss_pair(level, keys):       # loss = -S_T (short the asset)
        f, c, v = fwd_pair(level, keys)
        return -f, -c, v

    t0 = time.perf_counter()
    out = cvar_mlmc(loss_pair, L, alpha, target_se=2e-3,
                    bandwidth=[0.08, 0.04, 0.02, 0.01],
                    kernel_order=4, chunk_size=1 << 13, seed=7,
                    cost_fn=lambda lv: 4.0 ** lv)
    wall = time.perf_counter() - t0
    # exact: loss quantile at alpha is -S quantile at 1-alpha;
    # CVaR = -E[S | S < q_{1-alpha}(S)] (lognormal partial expectation)
    mu_ln = rate - 0.5 * sigma ** 2
    z = stats.norm.ppf(1 - alpha)
    var_exact = -np.exp(mu_ln + sigma * z)
    cvar_exact = -np.exp(mu_ln + 0.5 * sigma ** 2) * stats.norm.cdf(
        z - sigma) / (1 - alpha)
    # (b) hedge ratio h minimizing CVaR of -(S_T + h (K - S_T)+ - h p0)
    strike = 1.0

    def hedged(level, theta, keys):
        f, c, v = fwd_pair(level, keys)
        put_f = jnp.maximum(strike - f, 0.0)
        put_c = jnp.maximum(strike - c, 0.0)
        h = theta[0]
        return (-(f + h * put_f) + 0.08 * h,
                -(c + h * put_c) + 0.08 * h, v)

    t1 = time.perf_counter()
    opt = optimize_cvar(hedged, jnp.array([0.0]), alpha=0.9,
                        n_levels=L, n_per_level=[4096, 2048, 1024, 512],
                        n_steps=250, smoothing=0.01,
                        key=jax.random.key(8))
    wall_opt = time.perf_counter() - t1
    return dict(
        workload="GBM 95% VaR/CVaR at MLMC cost + CVaR-optimal hedge",
        var=round(out["var"], 4), var_exact=round(float(var_exact), 4),
        cvar=round(out["cvar"], 4),
        cvar_exact=round(float(cvar_exact), 4),
        cvar_se=float("%.2g" % out["cvar_se"]),
        n_per_level=[int(n) for n in out["n_per_level"]],
        wall_s=round(wall, 2),
        hedge_ratio=round(float(np.asarray(opt["theta"])[0]), 3),
        hedge_cvar=round(opt["cvar"], 4),
        unhedged_cvar=round(out["cvar"], 4),
        opt_wall_s=round(wall_opt, 2))


def bench_nested():
    """Nested-expectation MLMC (no reference analogue): unbiased EVPPI
    estimation of the Gaussian information problem — the Rhee-Glynn
    driver over Giles-Goda antithetic inner-count corrections, checked
    against the closed form E[max(0, mu+Y)]."""
    from mlmc_tpu.nested import (nested_level_fn, g_max0,
                                 gaussian_information_fn,
                                 evppi_gaussian_exact)
    from mlmc_tpu.unbiased import GeometricLevels, UnbiasedMLMC

    sigma_y, sigma_x, mu = 1.3, 2.0, 0.2
    inner = gaussian_information_fn(sigma_y, sigma_x, mu)
    fn = nested_level_fn(inner, g=g_max0, n0=4)
    mc = UnbiasedMLMC(fn, GeometricLevels(2.0 ** -1.25),
                      estimator="single", seed=7, chunk_size=1 << 12,
                      cost_fn=lambda lv: 2.0 ** lv)
    mc.sample(1 << 14)        # warm the common executables
    t0 = time.perf_counter()
    out = mc.run(target_var=1e-7, n_init=1 << 16)
    wall = time.perf_counter() - t0
    exact = evppi_gaussian_exact(sigma_y, mu)
    err = abs(out["mean"] - exact)
    return dict(workload="unbiased nested EVPPI (Gaussian info problem) "
                         "to target_var=1e-7",
                wall_s=round(wall, 2), draws=int(out["n_draws"]),
                draws_per_s=round(out["n_draws"] / max(wall, 1e-9), 1),
                levels_explored=len(out["levels"]),
                value=float(out["mean"]), exact=exact,
                err=float(err), se=float(np.sqrt(out["var"])),
                err_over_se=round(float(err / max(np.sqrt(out["var"]),
                                                  1e-300)), 2),
                target_met=out["target_met"])


def bench_mfmc():
    """Multifidelity Monte Carlo (no reference analogue): the 1-D
    random-conductivity heat equation at three resolutions as fidelity
    models — the RFF field parametrization is resolution-independent, so
    one key stream couples all fidelities. Reports pilot correlations,
    the selected allocation and the closed-form speedup vs plain MC."""
    from mlmc_tpu.mimc import heat_mimc_value_fn
    from mlmc_tpu.multifidelity import MFMC

    fn, _ = heat_mimc_value_fn(sigma=0.5, n0=(4, 4), total_time=0.25)
    fidelities = [(3, 3), (1, 1), (0, 0)]
    models = [lambda keys, a=a: fn(a, keys) for a in fidelities]
    # work ~ nx * nt solves => relative cost 2^(a0+a1)
    costs = [2.0 ** (a0 + a1) for a0, a1 in fidelities]
    mf = MFMC(models, costs=costs, seed=2, chunk_size=1 << 12)
    st = mf.pilot(1 << 13)
    budget = 5e5              # in cost units; m_0 ~ budget / (w . r)
    t0 = time.perf_counter()
    out = mf.estimate(budget=budget)
    wall = time.perf_counter() - t0
    return dict(workload="heat-equation MFMC: 32-cell x 32-step fine vs "
                         "8x8 / 4x4 surrogates, shared RFF fields",
                wall_s=round(wall, 2),
                rho=[round(float(r), 4) for r in st["rho"]],
                subset=list(out["subset"]),
                m=[int(v) for v in out["m"]],
                mean=float(out["mean"]),
                var=float("%.3g" % out["var"]),
                speedup_vs_mc=round(float(out["speedup"]), 1))


def bench_heston():
    """Multi-dimensional SDE MLMC (no reference analogue): the 2-D
    Heston stochastic-volatility system under full-truncation Euler,
    correlated Brownian drivers, 3 coupled levels to 512 fine steps —
    telescoped European call vs the semi-analytic characteristic-
    function price."""
    from mlmc_tpu.sim.sde import (coupled_system_functionals, heston,
                                  heston_call_price)

    params = dict(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    p_ref = heston_call_price(1.0, 1.0, 0.05, T=1.0, **params)
    model = heston(mu=0.05, s0=1.0, **params)
    disc = float(np.exp(-0.05))
    payoff = lambda pf: disc * jnp.maximum(pf.terminal[:, 0] - 1.0, 0.0)
    B = 1 << 17
    levels = [(32, 0), (128, 32), (512, 128)]
    fns = []
    for nf, nc in levels:
        cfg = dict(model=model, total_time=1.0, n_fine=nf, n_coarse=nc)
        fns.append(jax.jit(lambda k, cfg=cfg: coupled_system_functionals(
            cfg, k)))
    keys = jax.random.split(jax.random.key(0), B)
    for fn in fns:                                  # warm compiles
        jax.device_get(jax.tree.map(lambda x: x[:1], fn(keys)))
    t0 = time.perf_counter()
    total, var_total = 0.0, 0.0
    for fn in fns:
        pf_f, _, pf_c = fn(keys)
        d = np.asarray(payoff(pf_f)
                       - (payoff(pf_c) if pf_c is not None else 0.0),
                       np.float64)
        total += d.mean()
        var_total += d.var() / B
    wall = time.perf_counter() - t0
    se = float(np.sqrt(var_total))

    # Bermudan put under the SAME dynamics: LSMC on the full (S, v)
    # Markov state + nested-MC Rogers dual — a tree-free two-sided
    # certificate where NO closed form exists
    from mlmc_tpu.sim.american import lsmc_dual_bound, lsmc_price

    put = lambda s: jnp.maximum(1.0 - s[..., 0], 0.0)
    n_dates = 16
    kw = dict(model=model, n_sub=8, degree=3, n_paths=1 << 16)
    lo = lsmc_price(put, 1.0, 0.05, 1.0, n_dates,
                    key=jax.random.key(41), **kw)
    surf = lsmc_price(put, 1.0, 0.05, 1.0, n_dates, itm_only=False,
                      key=jax.random.key(42), **kw)
    up = lsmc_dual_bound(put, 1.0, 0.05, 1.0, n_dates,
                         coef=surf["coef"], model=model, n_sub=8,
                         n_paths=1 << 12, n_inner=512,
                         key=jax.random.key(43))
    return dict(workload=f"Heston 2-D MLMC call, levels {levels}, "
                         f"{B} coupled paths each",
                wall_s=round(wall, 3),
                coupled_paths_per_s=round(3 * B / wall, 1),
                price=round(float(total), 6),
                semi_analytic=round(float(p_ref), 6),
                err=round(abs(float(total) - float(p_ref)), 6),
                se=round(se, 6),
                within_6sigma_plus_bias=bool(
                    abs(float(total) - float(p_ref)) < 6 * se + 2e-4),
                bermudan_put_bracket=[round(lo["price"], 5),
                                      round(up["upper"], 5)],
                bermudan_bracket_width_pct=round(
                    100 * (up["upper"] - lo["price"]) / lo["price"], 2),
                bermudan_wall_s=round(
                    lo["wall_s"] + surf["wall_s"] + up["wall_s"], 2))


def bench_reactions():
    """Reaction-network MLMC (no reference analogue): Anderson-Higham
    coupled tau-leaping on the nonlinear dimerization CTMC, telescoped
    terminal monomer count cross-validated against batched exact SSA
    (Gillespie direct method), plus raw coupled level-batch throughput
    at 64+32 leap steps."""
    from mlmc_tpu.sim.reactions import (ReactionSimulation,
                                        coupled_tau_leap, dimerization,
                                        ssa_exact)

    net = dimerization()
    T = 1.0
    B = 1 << 15
    levels = [(4, 0), (8, 4), (16, 8), (32, 16), (64, 32)]
    fns = [jax.jit(lambda k, cfg=dict(network=net, total_time=T,
                                      n_fine=nf, n_coarse=nc):
                   coupled_tau_leap(cfg, k))
           for nf, nc in levels]
    keys = jax.random.split(jax.random.key(9), B)
    for fn in fns:
        jax.device_get(jax.tree.map(
            lambda x: x[:1], [v for v in fn(keys) if v is not None]))
    t0 = time.perf_counter()
    total, var_total, lvars = 0.0, 0.0, []
    for fn in fns:
        xf, xc = fn(keys)
        d = np.asarray(xf[:, 0], np.float64) \
            - (np.asarray(xc[:, 0], np.float64) if xc is not None
               else 0.0)
        total += d.mean()
        var_total += d.var() / B
        lvars.append(float(d.var()))
    wall = time.perf_counter() - t0
    se = float(np.sqrt(var_total))

    B_ssa = 1 << 13
    t1 = time.perf_counter()
    x_ref, overran = jax.jit(lambda k: ssa_exact(net, T, k, 512))(
        jax.random.split(jax.random.key(10), B_ssa))
    x_ref = np.asarray(x_ref[:, 0], np.float64)
    n_over = int(np.asarray(overran).sum())
    ssa_wall = time.perf_counter() - t1
    ref = x_ref.mean()
    se_ref = float(np.sqrt(x_ref.var() / B_ssa))
    sig = float(np.hypot(se, se_ref))

    cfg = dict(network=net, total_time=T, n_fine=64, n_coarse=32)
    dt, stats = _timed_batches(
        lambda k: ReactionSimulation.calculate_batch(cfg, k), B, reps=4)
    return dict(workload=f"dimerization CTMC tau-leap MLMC, levels "
                         f"{levels}, {B} coupled lanes each, "
                         f"exact-SSA cross-validation ({B_ssa} lanes)",
                wall_s=round(wall, 3),
                coupled_samples_per_s=round(len(levels) * B / wall, 1),
                batch_samples_per_s=round(B / dt, 1),
                telescoped_mean=round(float(total), 4),
                ssa_exact_mean=round(float(ref), 4),
                err=round(abs(float(total) - float(ref)), 4),
                se_joint=round(sig, 4),
                ssa_wall_s=round(ssa_wall, 3),
                ssa_overruns=n_over,
                level_var_ratios=[round(lvars[i + 1] / lvars[i], 3)
                                  for i in range(len(lvars) - 1)],
                within_6sigma_plus_bias=bool(
                    abs(float(total) - float(ref)) < 6 * sig + 1.5),
                **stats)


def bench_bsde():
    """BSDE solver (no reference analogue): the Black-Scholes
    measure-change driver — forward drift 0.15 != r, driver
    f = -r y - z (mu-r)/sigma — must recover the r-discounted price
    through the Z regression; plus the manufactured nonlinear exact
    anchor. Reports honest z-scores and throughput (paths x dates
    regressions per second)."""
    from mlmc_tpu.bsde import solve_bsde
    from mlmc_tpu.sim.sde import (SDEModel, black_scholes_call, gbm)

    mu, R, SIG, T = 0.15, 0.05, 0.2, 1.0
    g = lambda x: jnp.maximum(x - 1.0, 0.0)
    bs = black_scholes_call(1.0, 1.0, R, SIG, T)
    lam = (mu - R) / SIG
    n, B = 50, 1 << 17
    # warm pass excluded from the timed run
    solve_bsde(gbm(mu, SIG, 1.0), g,
               lambda t, x, y, z: -R * y - lam * z, T, n,
               n_paths=B, degree=5, key=jax.random.key(7))
    out = solve_bsde(gbm(mu, SIG, 1.0), g,
                     lambda t, x, y, z: -R * y - lam * z, T, n,
                     n_paths=B, degree=5, key=jax.random.key(3))

    alpha, c, x0 = 0.4, 0.5, 0.8
    model = SDEModel(drift=lambda x, t: jnp.zeros_like(x),
                     diffusion=lambda x, t: jnp.ones_like(x), s0=x0)
    u_ex = lambda t, x: jnp.exp(alpha * (T - t)) * jnp.sin(x)
    drv = lambda t, x, y, z: (alpha + 0.5) * y \
        + c * (y ** 2 - u_ex(t, x) ** 2)
    out2 = solve_bsde(model, lambda x: jnp.sin(x), drv, T, 32,
                      n_paths=1 << 16, degree=6, scale=1.0,
                      key=jax.random.key(8))
    y_ref = float(np.exp(alpha * T) * np.sin(x0))
    return dict(workload=f"BSDE regression solver: Black-Scholes "
                         f"measure-change driver ({n} dates, {B} "
                         f"paths) + manufactured nonlinear anchor",
                bs_y0=round(out["y0"], 6),
                bs_closed_form=round(bs, 6),
                bs_z=round((out["y0"] - bs) / out["y0_se"], 2),
                bs_within_6sigma=bool(abs(out["y0"] - bs)
                                      < 6 * out["y0_se"] + 1e-3),
                wall_s=round(out["wall_s"], 3),
                path_dates_per_s=round(B * n / out["wall_s"], 1),
                nonlinear_y_err=round(out2["y0"] - y_ref, 6),
                nonlinear_y_se=round(out2["y0_se"], 6),
                nonlinear_within=bool(abs(out2["y0"] - y_ref)
                                      < 6 * out2["y0_se"] + 5e-3))


def bench_vg():
    """Variance-gamma Lévy MLMC (no reference analogue): exact
    subordinated increments, terminal call pinned to the COS
    characteristic-function price (pure CLT — the terminal law has NO
    discretization error), Asian telescope over monitoring levels,
    batch throughput."""
    from mlmc_tpu.sim.levy import (VarianceGammaSimulation,
                                   coupled_vg_functionals,
                                   variance_gamma, vg_call_price)
    from mlmc_tpu.sim.sde import asian_call, european_call

    R, T = 0.05, 1.0
    vgp = dict(sigma=0.12, theta=-0.14, nu=0.2)
    model = variance_gamma(R, **vgp)
    disc = float(np.exp(-R * T))
    B = 1 << 17
    # terminal call: single exact level
    fn0 = jax.jit(lambda k: coupled_vg_functionals(
        dict(model=model, total_time=T, n_fine=4, n_coarse=0), k))
    keys = jax.random.split(jax.random.key(41), B)
    jax.device_get(fn0(keys)[0].terminal[:1])
    t0 = time.perf_counter()
    pf, _ = fn0(keys)
    v = disc * np.maximum(np.asarray(pf.terminal, np.float64) - 1.0, 0)
    wall0 = time.perf_counter() - t0
    ref = vg_call_price(1.0, 1.0, R, T=T, **vgp)
    se0 = float(v.std() / np.sqrt(B))

    # Asian monitoring telescope
    payoff = asian_call(0.95, disc)
    levels = [(8, 0), (16, 8), (32, 16), (64, 32)]
    fns = [jax.jit(lambda k, cfg=dict(model=model, total_time=T,
                                      n_fine=nf, n_coarse=nc):
                   coupled_vg_functionals(cfg, k))
           for nf, nc in levels]
    for fn in fns:
        jax.device_get(fn(keys)[0].terminal[:1])
    t1 = time.perf_counter()
    total, var_total, lvars = 0.0, 0.0, []
    for fn in fns:
        pf_f, pf_c = fn(keys)
        d = np.asarray(payoff(pf_f), np.float64) \
            - (np.asarray(payoff(pf_c), np.float64)
               if pf_c is not None else 0.0)
        total += d.mean()
        var_total += d.var() / B
        lvars.append(float(d.var()))
    wall = time.perf_counter() - t1

    sim = VarianceGammaSimulation(dict(model=model, total_time=T,
                                       payoff=european_call(1.0, disc)))
    cfg = sim.level_instance([T / 64], [T / 32]).config_dict
    dt, stats = _timed_batches(
        lambda k: VarianceGammaSimulation.calculate_batch(cfg, k),
        B, reps=8)
    return dict(workload=f"variance-gamma Levy MLMC (exact increments), "
                         f"terminal call vs COS + Asian monitoring "
                         f"telescope {levels}, {B} paths each",
                call=round(float(v.mean()), 6),
                cos_closed_form=round(float(ref), 6),
                call_err=round(abs(float(v.mean()) - ref), 6),
                call_se=round(se0, 6),
                call_within_6sigma=bool(abs(float(v.mean()) - ref)
                                        < 6 * se0),
                call_wall_s=round(wall0, 3),
                asian=round(float(total), 6),
                asian_se=round(float(np.sqrt(var_total)), 6),
                asian_wall_s=round(wall, 3),
                coupled_paths_per_s=round(len(levels) * B / wall, 1),
                batch_samples_per_s=round(B / dt, 1),
                monitoring_var_ratios=[round(lvars[i + 1] / lvars[i], 3)
                                       for i in range(1, len(lvars) - 1)],
                **stats)


def bench_spde():
    """SPDE MLMC (no reference analogue): stochastic heat equation
    with space-time white noise, 3 box-aggregated levels to a
    128-cell/256-step fine grid — telescoped energy E||u(T)||^2 vs the
    finest level's EXACT discrete Gaussian law (pure CLT check) and
    the continuum OU-mode sum, plus coupled batch throughput (the
    DST-II solves are matmuls)."""
    from mlmc_tpu.sim.spde import (SPDESimulation, coupled_spde_paths,
                                   discrete_heat_l2_moment,
                                   heat_spde_l2_moment,
                                   stochastic_heat)

    model = stochastic_heat(1.0, 1.0)
    T, B = 0.5, 1 << 13
    levels = [(32, 16, 0, 0), (64, 64, 32, 16), (128, 256, 64, 64)]
    fns = [jax.jit(lambda k, cfg=dict(model=model, total_time=T,
                                      n_cells_fine=Nf, n_steps_fine=nf,
                                      n_cells_coarse=Nc,
                                      n_steps_coarse=nc):
                   coupled_spde_paths(cfg, k))
           for Nf, nf, Nc, nc in levels]
    keys = jax.random.split(jax.random.key(31), B)
    for fn in fns:
        jax.device_get(jax.tree.map(
            lambda x: x[:1], [v for v in fn(keys) if v is not None]))

    def l2sq(u):
        return (np.asarray(u, np.float64) ** 2).sum(axis=1) / u.shape[1]

    t0 = time.perf_counter()
    total, var_total, lvars = 0.0, 0.0, []
    for fn in fns:
        uf, uc = fn(keys)
        d = l2sq(uf) - (l2sq(uc) if uc is not None else 0.0)
        total += d.mean()
        var_total += d.var() / B
        lvars.append(float(d.var()))
    wall = time.perf_counter() - t0
    se = float(np.sqrt(var_total))
    ref = discrete_heat_l2_moment(1.0, 1.0, T, 128, 256)
    cont = heat_spde_l2_moment(1.0, 1.0, T)

    sim = SPDESimulation(dict(model=model, total_time=T))
    cfg = sim.level_instance([1 / 128, T / 256],
                             [1 / 64, T / 64]).config_dict
    dt, stats = _timed_batches(
        lambda k: SPDESimulation.calculate_batch(cfg, k), B, reps=4)
    return dict(workload=f"stochastic heat SPDE MLMC energy, levels "
                         f"{[(l[0], l[1]) for l in levels]}, {B} "
                         f"coupled fields each",
                wall_s=round(wall, 3),
                coupled_samples_per_s=round(len(levels) * B / wall, 1),
                batch_samples_per_s=round(B / dt, 1),
                energy=round(float(total), 6),
                discrete_closed_form=round(float(ref), 6),
                err_vs_discrete=round(abs(float(total) - ref), 6),
                se=round(se, 6),
                continuum=round(float(cont), 6),
                finest_bias_vs_continuum=round(abs(ref - cont), 6),
                level_var_ratios=[round(lvars[i + 1] / lvars[i], 3)
                                  for i in range(len(lvars) - 1)],
                within_6sigma=bool(abs(float(total) - ref) < 6 * se),
                **stats)


def bench_rbergomi():
    """Rough volatility (no reference analogue): exact-Gaussian
    rBergomi at the Bayer-Friz-Gatheral calibration (H=0.1, eta=1.9,
    rho=-0.9), 4 restriction-coupled levels to 256 grid points — ATM
    call telescope + eta->0 Black-Scholes degeneration check (exact:
    constant v makes the Euler log-S step exact) + batch throughput
    (the [B, 2n]x[2n, 2n] path matmul is pure matmul work)."""
    from mlmc_tpu.sim.rough import (RBergomiSimulation,
                                    coupled_rbergomi_paths, rbergomi)
    from mlmc_tpu.sim.sde import black_scholes_call

    model = rbergomi()
    T, B = 1.0, 1 << 15
    payoff = lambda s: jnp.maximum(s - 1.0, 0.0)
    levels = [(32, 0), (64, 32), (128, 64), (256, 128)]
    fns = [jax.jit(lambda k, cfg=dict(model=model, total_time=T,
                                      n_fine=nf, n_coarse=nc):
                   coupled_rbergomi_paths(cfg, k))
           for nf, nc in levels]
    keys = jax.random.split(jax.random.key(21), B)
    for fn in fns:
        jax.device_get(jax.tree.map(
            lambda x: x[:1], [v for v in fn(keys) if v is not None]))
    t0 = time.perf_counter()
    total, var_total, lvars = 0.0, 0.0, []
    for fn in fns:
        s_f, s_c = fn(keys)
        d = np.asarray(payoff(s_f), np.float64) \
            - (np.asarray(payoff(s_c), np.float64)
               if s_c is not None else 0.0)
        total += d.mean()
        var_total += d.var() / B
        lvars.append(float(d.var()))
    wall = time.perf_counter() - t0
    se = float(np.sqrt(var_total))

    # exact anchor: eta = 0 collapses to Black-Scholes with NO bias
    m0 = rbergomi(xi0=0.04, eta=0.0, hurst=0.1, rho=-0.9)
    s_f, s_c = jax.jit(lambda k: coupled_rbergomi_paths(
        dict(model=m0, total_time=T, n_fine=64, n_coarse=0), k))(keys)
    d0 = np.asarray(payoff(s_f), np.float64)
    bs = black_scholes_call(1.0, 1.0, 0.0, 0.2, T)
    bs_err = abs(d0.mean() - bs)
    bs_se = float(np.sqrt(d0.var() / B))

    sim = RBergomiSimulation(dict(model=model, total_time=T,
                                  payoff=payoff))
    cfg = sim.level_instance([T / 256], [T / 128]).config_dict
    dt, stats = _timed_batches(
        lambda k: RBergomiSimulation.calculate_batch(cfg, k),
        B, reps=4)
    return dict(workload=f"rBergomi rough-vol MLMC ATM call, BFG "
                         f"params (H=0.1, eta=1.9, rho=-0.9), levels "
                         f"{levels}, {B} coupled paths each",
                wall_s=round(wall, 3),
                coupled_paths_per_s=round(len(levels) * B / wall, 1),
                batch_samples_per_s=round(B / dt, 1),
                price=round(float(total), 5),
                se=round(se, 5),
                level_var_ratios=[round(lvars[i + 1] / lvars[i], 3)
                                  for i in range(len(lvars) - 1)],
                eta0_vs_black_scholes_err=round(float(bs_err), 6),
                eta0_within_6sigma=bool(bs_err < 6 * bs_se),
                **stats)


def bench_merton():
    """Jump-diffusion MLMC (no reference analogue): Merton compound-
    Poisson lognormal jumps, shared-jump coupling (the coarse path
    consumes the summed log jumps), 4 coupled levels to 128 fine steps
    — telescoped European call vs the Poisson-mixture closed form, plus
    raw coupled level-batch throughput at 64+16 substeps."""
    from mlmc_tpu.sim.jumps import (JumpDiffusionSimulation,
                                    coupled_jump_functionals, merton,
                                    merton_call_price)
    from mlmc_tpu.sim.sde import european_call

    rate, sigma, lam, jm, jv = 0.05, 0.2, 0.8, -0.1, 0.15
    model = merton(rate, sigma, lam, jm, jv, 1.0)
    p_ref = merton_call_price(1.0, 1.0, rate, sigma, lam, jm, jv, 1.0)
    payoff = european_call(1.0, float(np.exp(-rate)))
    B = 1 << 17
    levels = [(16, 0), (32, 16), (64, 32), (128, 64)]
    fns = [jax.jit(lambda k, cfg=dict(model=model, total_time=1.0,
                                      n_fine=nf, n_coarse=nc):
                   coupled_jump_functionals(cfg, k))
           for nf, nc in levels]
    keys = jax.random.split(jax.random.key(3), B)
    for fn in fns:                                  # warm compiles
        jax.device_get(jax.tree.map(lambda x: x[:1], fn(keys)))
    t0 = time.perf_counter()
    total, var_total, lvars = 0.0, 0.0, []
    for fn in fns:
        pf_f, pf_c = fn(keys)
        d = np.asarray(payoff(pf_f)
                       - (payoff(pf_c) if pf_c is not None else 0.0),
                       np.float64)
        total += d.mean()
        var_total += d.var() / B
        lvars.append(float(d.var()))
    wall = time.perf_counter() - t0
    se = float(np.sqrt(var_total))

    sim = JumpDiffusionSimulation(dict(model=model, total_time=1.0,
                                       payoff=payoff))
    cfg = sim.level_instance([1 / 64], [1 / 16]).config_dict
    dt, stats = _timed_batches(
        lambda k: JumpDiffusionSimulation.calculate_batch(cfg, k),
        B, reps=8)
    return dict(workload=f"Merton jump-diffusion MLMC call, levels "
                         f"{levels}, {B} coupled paths each",
                wall_s=round(wall, 3),
                coupled_paths_per_s=round(len(levels) * B / wall, 1),
                batch_samples_per_s=round(B / dt, 1),
                price=round(float(total), 6),
                closed_form=round(float(p_ref), 6),
                err=round(abs(float(total) - float(p_ref)), 6),
                se=round(se, 6),
                level_var_ratios=[round(lvars[i + 1] / lvars[i], 3)
                                  for i in range(len(lvars) - 1)],
                within_6sigma_plus_bias=bool(
                    abs(float(total) - float(p_ref)) < 6 * se + 1e-3),
                **stats)


def bench_ml2r():
    """ML2R (multilevel Richardson-Romberg, no reference analogue): the
    Euler GBM European call on a deliberately SHALLOW 3-level hierarchy
    (finest h = 1/8) — the weight extrapolation cancels the weak-bias
    expansion the unweighted telescope carries in full; both estimates
    come from the SAME samples, so the gap is the pure reweighting
    gain."""
    from mlmc_tpu.cdf_estimate import simulation_pair_fn
    from mlmc_tpu.ml2r import ml2r
    from mlmc_tpu.sim.sde import (SDESimulation, black_scholes_call,
                                  european_call, gbm)

    rate, sigma = 0.05, 0.2
    sim = SDESimulation(dict(
        model=gbm(rate, sigma, 1.0), scheme="euler",
        payoff=european_call(1.0, float(np.exp(-rate)))))
    steps = [0.5, 0.25, 0.125]
    pair_fn, _ = simulation_pair_fn(sim, [[h] for h in steps])
    res = ml2r(pair_fn, steps, target_var=4e-10, alpha=1.0, seed=5,
               chunk_size=1 << 13)
    bs = black_scholes_call(1.0, 1.0, rate, sigma, 1.0)
    return dict(workload="ML2R Euler GBM call, 3 levels finest h=1/8, "
                         "target se 2e-5",
                wall_s=round(res["wall_s"], 2),
                n_paths=int(res["n_forward"]),
                err_ml2r=round(abs(res["mean"] - bs), 7),
                err_telescope=round(abs(res["mean_mlmc"] - bs), 7),
                se=round(res["se"], 7),
                tail_weights=[round(float(v), 4)
                              for v in res["weights"][1]],
                target_met=res["target_met"])


def bench_cmlmc():
    """Continuation MLMC (no reference analogue): the Euler GBM
    European call driven to eps=5e-4 total error with UNKNOWN rates —
    the tolerance sequence self-calibrates alpha/beta/gamma; reports
    the realized error vs Black-Scholes and the contract bound."""
    from mlmc_tpu.cdf_estimate import simulation_pair_fn
    from mlmc_tpu.cmlmc import cmlmc
    from mlmc_tpu.sim.sde import (SDESimulation, black_scholes_call,
                                  european_call, gbm)

    rate, sigma = 0.05, 0.2
    sim = SDESimulation(dict(
        model=gbm(rate, sigma, 1.0), scheme="euler",
        payoff=european_call(1.0, float(np.exp(-rate)))))
    steps = [2.0 ** -k for k in range(1, 11)]
    pair_fn, _ = simulation_pair_fn(sim, [[h] for h in steps])
    t0 = time.perf_counter()
    res = cmlmc(pair_fn, steps, eps=5e-4, seed=3, n_stages=4,
                n_pilot=1 << 12, chunk_size=1 << 12)
    wall = time.perf_counter() - t0
    bs = black_scholes_call(1.0, 1.0, rate, sigma, 1.0)
    return dict(workload="CMLMC Euler GBM call to eps=5e-4, rates "
                         "self-calibrated over 4 tolerance stages",
                wall_s=round(wall, 2),
                mean=float(res["mean"]), black_scholes=bs,
                realized_err=float(abs(res["mean"] - bs)),
                error_bound=float(res["error_bound"]),
                bias_target_met=res["bias_target_met"],
                n_levels=int(res["n_levels"]),
                n_per_level=[int(v) for v in res["n_per_level"]],
                alpha=round(float(res["rates"]["alpha"]), 3),
                beta=round(float(res["rates"]["beta"]), 3),
                n_forward=int(res["n_forward"]))


def bench_mlblue():
    """Multilevel BLUE (no reference analogue): the same heat-equation
    fidelity family as the MFMC row, estimated by the optimal linear
    unbiased combination over coupled model groups; reports the BLUE
    variance and its measured efficiency vs the same-budget
    optimally-allocated MLMC telescope."""
    from mlmc_tpu.mimc import heat_mimc_value_fn
    from mlmc_tpu.mlblue import mlblue

    fn, _ = heat_mimc_value_fn(sigma=0.5, n0=(4, 4), total_time=0.25)
    fidelities = [(3, 3), (1, 1), (0, 0)]
    models = [lambda keys, a=a: fn(a, keys) for a in fidelities]
    costs = [2.0 ** (a0 + a1) for a0, a1 in fidelities]
    t0 = time.perf_counter()
    res = mlblue(models, costs, budget=5e5, seed=4,
                 n_pilot=1 << 13, chunk_size=1 << 12)
    wall = time.perf_counter() - t0
    return dict(workload="heat-equation MLBLUE: 32x32 fine vs 8x8/4x4 "
                         "surrogate groups, shared RFF fields",
                wall_s=round(wall, 2), mean=float(res["mean"]),
                var=float("%.3g" % res["var"]),
                mlmc_var=float("%.3g" % res["mlmc_var"]),
                efficiency_vs_mlmc=round(
                    float(res["efficiency_vs_mlmc"]), 2),
                n_per_group=[int(v) for v in res["n_per_group"]],
                n_evaluations=int(res["n_evaluations"]))


def bench_mcmc():
    """Multilevel MCMC Bayesian inversion (no reference analogue): infer
    the Darcy log-conductivity field from 9 noisy pressure observations
    — pCN chains batched 256-wide on the chip, CRN-coupled corrections
    over a 16/32/64 grid hierarchy, telescoped posterior-mean flux."""
    from mlmc_tpu.mcmc import MLMCMC, make_darcy_inverse

    prob = make_darcy_inverse([16, 32, 64], n_modes=64, sigma=1.0,
                              noise_std=0.02)
    theta_true, clean, data = prob["synthetic"](3)
    fns = prob["loglik_qoi_fns"](jnp.asarray(data))
    ml = MLMCMC(fns, d=prob["d"])
    n_steps, n_chains = [4000, 600, 300], 256
    # warm the per-level executables so the wall is the chains, not AOT
    ml.run(n_steps=[3] * 3, n_chains=n_chains, burn=0,
           key=jax.random.key(0))
    out = ml.run(n_steps=n_steps, n_chains=n_chains,
                 key=jax.random.key(8))
    res = out["results"]
    solves = sum(r.n_forward if hasattr(r, "n_forward")
                 else r.n_forward_f + r.n_forward_c for r in res)
    # posterior check: the posterior-mean latent fits the data far
    # better than the prior mean (misfit in noise-sigma units per obs)
    th_hat = jnp.asarray(res[0].theta.mean(axis=0))
    ll_hat = float(fns[-1](th_hat)[0])
    ll_prior = float(fns[-1](jnp.zeros(prob["d"]))[0])
    return dict(workload="Bayesian Darcy inversion: 9 pressure obs, "
                         "16/32/64 hierarchy, 256 pCN chains, CRN-coupled"
                         " corrections",
                wall_s=round(out["wall_s"], 2),
                pde_solves=int(solves),
                solves_per_s=round(solves / max(out["wall_s"], 1e-9), 1),
                flux_mean=float(out["mean"][0]),
                flux_se=float(out["se"][0]),
                level_means=[float(m[0]) for m in out["level_means"]],
                level_ses=[float("%.3g" % s[0]) for s in out["level_ses"]],
                acc_rates=[round(a, 3) for a in out["acc_rates"]],
                mismatch_rates=[round(r.mismatch_rate, 4)
                                for r in res[1:]],
                ess_level0=round(res[0].ess, 1),
                rhat_level0=round(res[0].rhat, 3),
                misfit_fit_vs_prior=[round(-ll_hat, 1), round(-ll_prior, 1)])


def bench_bayes():
    """Derivative-free and population Bayesian calibration (no reference
    analogue): the same Darcy inverse problem as bench_mcmc solved by
    (a) hierarchical ES-MDA — ensemble Kalman calibration paying fine
    solves only for the tail updates — and (b) hierarchical tempered SMC
    annealing on the coarse models, reporting the fine-model EVIDENCE
    (with the Gaussian likelihood's normalizer restored host-side, so
    log_evidence is the true marginal likelihood)."""
    from mlmc_tpu.eki import hierarchical_esmda
    from mlmc_tpu.smc import hierarchical_smc
    from mlmc_tpu.mcmc import make_darcy_inverse

    noise = 0.02
    prob = make_darcy_inverse([16, 32, 64], n_modes=64, sigma=1.0,
                              noise_std=noise)
    theta_true, clean, data = prob["synthetic"](3)
    fwds = [lambda th, n=n: prob["forward"](th, n)[0]
            for n in prob["level_ns"]]

    cal = hierarchical_esmda(fwds, jnp.asarray(data), noise_std=noise,
                             n_ens=128, n_steps=6, d=prob["d"],
                             key=jax.random.key(1))

    fns = prob["loglik_qoi_fns"](jnp.asarray(data))
    t0 = time.perf_counter()
    smc = hierarchical_smc(fns, d=prob["d"], n_particles=1024,
                           n_moves=6, key=jax.random.key(2))
    smc_wall = time.perf_counter() - t0
    log_norm = -0.5 * len(data) * np.log(2 * np.pi * noise ** 2)
    n_solves = int(np.sum(smc["n_forward"]))
    return dict(workload="Bayesian Darcy calibration: ES-MDA ensemble "
                         "Kalman + tempered SMC with model evidence, "
                         "16/32/64 hierarchy, 9 pressure obs",
                esmda_misfit=[round(float(m), 2) for m in cal["misfit"]],
                esmda_n_forward=cal["n_forward"],
                esmda_wall_s=round(cal["wall_s"], 2),
                smc_wall_s=round(smc_wall, 2),
                smc_stages=len(smc["acc_rates"]),
                smc_solves=n_solves,
                smc_solves_per_s=round(n_solves / max(smc_wall, 1e-9), 1),
                smc_n_forward=smc["n_forward"],
                log_evidence=round(smc["log_evidence"] + log_norm, 2),
                log_evidence_se=round(smc["log_evidence_se"], 3),
                flux_mean=float(smc["mean"][0]),
                flux_se=float(smc["se"][0]),
                acc_final=round(smc["acc_rates"][-1], 3))


def bench_collocation():
    """Sparse-grid collocation (no reference analogue): E[Darcy flux]
    on a 32^2 grid with an 8-parameter RFF log-conductivity — the
    smooth-QoI regime where Smolyak beats sampling. Reports the level
    ladder's internal convergence and the plain-MC standard error at
    the SAME solve budget."""
    from mlmc_tpu.collocation import SparseGrid
    from mlmc_tpu.mcmc import make_darcy_inverse

    prob = make_darcy_inverse([32], n_modes=4, sigma=1.0)
    flux = lambda th: prob["forward"](th, 32)[1]
    vals, nodes, walls = [], [], []
    for w in (2, 3, 4):
        grid = SparseGrid(prob["d"], w, rule="gauss-hermite")
        t0 = time.perf_counter()
        vals.append(float(grid.integrate(flux)))
        walls.append(time.perf_counter() - t0)
        nodes.append(grid.n_nodes)
    # plain MC at the level-4 node budget
    mc = jax.vmap(flux)(jax.random.normal(jax.random.key(0),
                                          (nodes[-1], prob["d"])))
    mc = np.asarray(jax.device_get(mc), dtype=np.float64)
    return dict(workload="Darcy flux collocation: 8-d RFF, 32^2 grid, "
                         "Gauss-Hermite Smolyak w=2..4",
                n_nodes=nodes,
                values=[round(v, 6) for v in vals],
                ladder_deltas=[float("%.3g" % abs(b - a))
                               for a, b in zip(vals, vals[1:])],
                wall_s=[round(w_, 2) for w_ in walls],
                mc_same_budget_se=float("%.3g" % (mc.std(ddof=1)
                                                  / np.sqrt(len(mc)))),
                solves_per_s=round(nodes[-1] / max(walls[-1], 1e-9), 1))


def bench_pce():
    """Polynomial chaos (no reference analogue): degree-3 Hermite PCE
    of the 32^2 Darcy flux in 8 RFF dims fitted from 1024 solves, then
    (a) closed-form Sobol attribution from the coefficients and (b) the
    fitted surrogate plugged into MFMC as a ~free low-fidelity model —
    the surrogate-accelerated estimation loop."""
    from mlmc_tpu.pce import PCE
    from mlmc_tpu.multifidelity import MFMC
    from mlmc_tpu.mcmc import make_darcy_inverse

    prob = make_darcy_inverse([32], n_modes=4, sigma=1.0)
    d = prob["d"]
    flux = lambda th: prob["forward"](th, 32)[1]
    t0 = time.perf_counter()
    theta_fit = jax.random.normal(jax.random.key(0), (1024, d))
    y_fit = jax.vmap(flux)(theta_fit)
    pce = PCE(d, 3).fit_regression(theta_fit, y_fit)
    fit_wall = time.perf_counter() - t0
    sob = pce.sobol()

    def hi(keys):
        th = jax.vmap(lambda k: jax.random.normal(k, (d,)))(keys)
        return jax.vmap(flux)(th)

    def lo(keys):
        th = jax.vmap(lambda k: jax.random.normal(k, (d,)))(keys)
        return pce(th)

    mf = MFMC([hi, lo], costs=[1.0, 1e-3], seed=5)
    st = mf.pilot(1 << 12)
    t0 = time.perf_counter()
    out = mf.estimate(budget=2e4)
    mf_wall = time.perf_counter() - t0
    return dict(workload="Darcy flux PCE: 8-d RFF, 32^2, degree-3 "
                         "(165 terms) + PCE-surrogate MFMC",
                fit_wall_s=round(fit_wall, 2),
                pce_mean=round(pce.mean(), 6),
                pce_var=float("%.4g" % pce.var()),
                sobol_first=[round(float(s), 3)
                             for s in sob["first_order"]],
                surrogate_rho=round(float(st["rho"][1]), 4),
                mfmc_mean=float(out["mean"]),
                mfmc_speedup=round(float(out["speedup"]), 1),
                mfmc_wall_s=round(mf_wall, 2))


def bench_oed():
    """Optimal experimental design (no reference analogue): which
    pressure-observation layout to drill on the 16^2 Darcy cell —
    a 3x3 spread vs a center cluster, ranked by nested-MC expected
    information gain (each inner likelihood ratio is a PDE solve,
    batched on the chip)."""
    from mlmc_tpu.oed import eig_nmc
    from mlmc_tpu.mcmc import make_darcy_inverse

    g = np.linspace(0.2, 0.8, 3)
    spread = [[x, y] for x in g for y in g]
    c = np.linspace(0.45, 0.55, 3)
    cluster = [[x, y] for x in c for y in c]
    results = {}
    for name, pts in (("spread", spread), ("cluster", cluster)):
        prob = make_darcy_inverse([16], n_modes=8, sigma=1.0,
                                  obs_points=pts, noise_std=0.05)
        fwd = lambda th: prob["forward"](th, 16)[0]
        t0 = time.perf_counter()
        out = eig_nmc(fwd, 0.05, d=prob["d"], n_outer=1024, n_inner=256,
                      key=jax.random.key(3), chunk_size=1024)
        results[name] = dict(eig=round(out["eig"], 3),
                             se=round(out["se"], 4),
                             pde_solves=out["n_forward"],
                             wall_s=round(time.perf_counter() - t0, 2))
    better = max(results, key=lambda k: results[k]["eig"])
    return dict(workload="Darcy OED: 9-obs spread vs center cluster, "
                         "16-d RFF prior, nested-MC EIG",
                designs=results, preferred=better,
                separation_sigmas=round(
                    abs(results["spread"]["eig"]
                        - results["cluster"]["eig"])
                    / max(np.hypot(results["spread"]["se"],
                                   results["cluster"]["se"]), 1e-12), 1))


def bench_filter():
    """Ensemble Kalman filtering (no reference analogue): the Lorenz-96
    chaotic benchmark — 40 variables, 20 observed, ETKF at three
    ensemble sizes; reports tracking RMSE (vs obs noise 1.0) and
    assimilation throughput (member-steps/s: one RK4 model step +
    analysis per member per cycle)."""
    from mlmc_tpu.filter import enkf, lorenz96_step

    d, T = 40, 200
    step = lorenz96_step(dt=0.05)
    key = jax.random.key(2)
    x = 3.0 + jax.random.normal(jax.random.fold_in(key, 0), (1, d))
    for t in range(100):
        x = step(x, None, t)
    rng = np.random.default_rng(3)
    truth, ys = [], []
    xt = x
    for t in range(T):
        xt = step(xt, None, t)
        truth.append(np.asarray(xt[0]))
        ys.append(truth[-1][::2] + rng.normal(size=d // 2))
    truth, ys = np.array(truth), np.array(ys)
    results = {}
    for J in (64, 256, 1024):
        x0 = np.asarray(x) + np.random.default_rng(4).normal(
            size=(J, d))
        out = enkf(step, lambda xx: xx[::2], ys, noise_std=1.0,
                   n_ens=J, d=d, x0=x0, inflation=1.05, method="etkf",
                   key=jax.random.key(5))
        # warm pass for the timing (first call pays the AOT compile)
        out = enkf(step, lambda xx: xx[::2], ys, noise_std=1.0,
                   n_ens=J, d=d, x0=x0, inflation=1.05, method="etkf",
                   key=jax.random.key(6))
        rmse = float(np.sqrt(np.mean(
            (out["means"][T // 2:] - truth[T // 2:]) ** 2)))
        results[f"J{J}"] = dict(
            rmse=round(rmse, 3),
            spread=round(float(out["spread"][-1]), 3),
            wall_s=round(out["wall_s"], 3),
            member_steps_per_s=round(J * T / max(out["wall_s"], 1e-9)))
    return dict(workload="Lorenz-96 ETKF: 40 vars, 20 obs, 200 cycles, "
                         "inflation 1.05",
                obs_noise=1.0, **results)


def bench_particle():
    """Particle filter tier (no reference analogue): (a) bootstrap PF
    on the stochastic-volatility model (x' = phi x + sig w, y = eps
    exp(x/2) v — non-Gaussian observation, the EnKF's blind spot and
    the PF's home turf): latent-volatility tracking RMSE and
    particle-step throughput at 2^15 particles x 400 cycles; (b) the
    MLPF on a 4-level Euler OU hierarchy — correction decay across
    coupled levels and the fine-propagation savings vs a fine-only
    filter at matched counts."""
    from mlmc_tpu.particle import (particle_filter,
                                   multilevel_particle_filter)
    from tests.test_particle import _ou_levels

    T, N = 400, 2 ** 15
    phi, sig = 0.98, 0.16
    rng = np.random.default_rng(3)
    xs, truth, ys = 0.0, [], []
    for t in range(T):
        xs = phi * xs + sig * rng.standard_normal()
        truth.append(xs)
        ys.append(np.exp(0.5 * xs) * rng.standard_normal())
    truth, ys = np.array(truth), np.array(ys)[:, None]

    def trans(xx, key, t):
        return phi * xx + sig * jax.random.normal(key, xx.shape,
                                                  xx.dtype)

    def ll(xx, y):          # y | x ~ N(0, exp(x))
        return -0.5 * (xx[0] + y[0] * y[0] * jnp.exp(-xx[0]))

    pf = None
    for k in (5, 6):     # second pass = warm timing
        pf = particle_filter(
            trans, ll, ys, n_particles=N, d=1, key=jax.random.key(k),
            x0_sampler=lambda kk: sig / np.sqrt(1 - phi ** 2)
            * jax.random.normal(kk, (N, 1)))
    rmse = float(np.sqrt(np.mean(
        (pf["means"][T // 2:, 0] - truth[T // 2:]) ** 2)))
    prior_sd = sig / np.sqrt(1 - phi ** 2)

    # MLPF: OU hierarchy, data simulated from the fine discretization
    n_levels, T2, r = 4, 100, 0.5
    make = _ou_levels(n_levels)
    rng = np.random.default_rng(7)
    xs, ysou = 0.0, []
    for t in range(T2):
        for _ in range(8):
            xs = xs * (1.0 - 0.5 / 8) + np.sqrt(0.5 / 8) * \
                rng.standard_normal()
        ysou.append(xs + r * rng.standard_normal())
    ysou = np.array(ysou)[:, None]

    def llou(xx, y):
        return -0.5 * ((y[0] - xx[0]) / r) ** 2

    counts = [2 ** 15, 2 ** 14, 2 ** 13, 2 ** 12]
    ml = None
    for k in (8, 9):
        ml = multilevel_particle_filter(
            make, llou, ysou, n_levels=n_levels, d=1,
            n_particles=counts, key=jax.random.key(k))
    # fine-propagation cost: level-l filter runs 2^l Euler substeps
    fine_subs = sum(n * (2 ** l + (2 ** (l - 1) if l else 0))
                    for l, n in enumerate(counts))
    fine_only_subs = counts[0] * 2 ** (n_levels - 1)
    return dict(
        workload="bootstrap PF stochastic volatility (2^15 particles, "
                 "400 cycles) + MLPF 4-level Euler OU",
        pf_rmse=round(rmse, 3),
        pf_prior_sd=round(float(prior_sd), 3),
        pf_loglik=round(pf["loglik"], 1),
        pf_resample_frac=round(pf["resample_frac"], 3),
        pf_wall_s=round(pf["wall_s"], 3),
        pf_particle_steps_per_s=round(N * T / max(pf["wall_s"], 1e-9)),
        mlpf_correction_l1=[float("%.3g" % c)
                            for c in ml["correction_l1"]],
        mlpf_mean_se=float("%.3g" % np.mean(ml["means_se"])),
        mlpf_wall_s=round(ml["wall_s"], 3),
        mlpf_euler_substeps=fine_subs,
        fine_only_substeps_same_n0=fine_only_subs)


def bench_bayes_compact():
    """Compact on-chip closed-form evidence for the Bayesian/rare tiers
    (run by bench.py so it lands in the BENCH artifact): on the SAME
    3-d linear-Gaussian problem, (a) ES-MDA must land on the conjugate
    posterior mean, (b) tempered SMC must recover the marginal
    likelihood, and (c) subset simulation must reproduce the Gaussian
    tail Phi(-4) ~ 3.17e-5 — all measured on the live device."""
    from math import erfc, sqrt
    from mlmc_tpu.eki import esmda
    from mlmc_tpu.rare import subset_simulation
    from mlmc_tpu.smc import smc_tempering

    rng = np.random.default_rng(0)
    d, K, noise = 3, 5, 0.5
    A = jnp.asarray(rng.standard_normal((K, d)))
    y = A @ jnp.asarray(rng.standard_normal(d))
    An, yn = np.asarray(A, dtype=np.float64), np.asarray(y, np.float64)
    Sig = np.linalg.inv(np.eye(d) + An.T @ An / noise ** 2)
    mu = Sig @ An.T @ yn / noise ** 2
    S = An @ An.T + noise ** 2 * np.eye(K)
    log_z = -0.5 * (K * np.log(2 * np.pi) + np.linalg.slogdet(S)[1]
                    + yn @ np.linalg.solve(S, yn))
    const = -0.5 * K * np.log(2 * np.pi * noise ** 2)

    t0 = time.perf_counter()
    cal = esmda(lambda th: A @ th, y, noise, n_ens=2048, n_steps=4,
                d=d, key=jax.random.key(1))
    eki_err = float(np.max(np.abs(cal["mean"] - mu)))

    def fn(th):
        r = A @ th - y
        return const - 0.5 * jnp.sum(r * r) / noise ** 2, th[:1]

    smc = smc_tempering(fn, d=d, n_particles=1024, n_moves=6,
                        key=jax.random.key(2))
    smc_err_sig = (abs(smc["log_evidence"] - log_z)
                   / max(smc["log_evidence_se"], 1e-12))

    rare = subset_simulation(lambda th: th[0], gamma=4.0, d=d,
                             n_particles=1024, n_moves=6,
                             key=jax.random.key(3))
    p_exact = 0.5 * erfc(4.0 / sqrt(2.0))
    wall = time.perf_counter() - t0
    return dict(eki_mean_err=float("%.3g" % eki_err),
                eki_ok=bool(eki_err < 0.1),
                smc_log_evidence=round(smc["log_evidence"], 3),
                smc_log_evidence_exact=round(float(log_z), 3),
                smc_err_sigmas=round(float(smc_err_sig), 2),
                smc_stages=len(smc["acc_rates"]),
                subset_p=float("%.3g" % rare["p"]),
                subset_p_exact=float("%.3g" % p_exact),
                subset_log_err_sigmas=round(
                    abs(rare["log_p"] - np.log(p_exact))
                    / max(rare["log_p_se"], 1e-12), 2),
                wall_s=round(wall, 2))


def bench_rare():
    """Rare-event tier (no reference analogue): P[Darcy flux > gamma]
    on a 32^2 grid with an RFF log-conductivity prior — gamma set ~4.75
    log-sds above the pilot log-mean, so plain MC would need ~1e8
    solves for one hit; the subset ladder gets an island-CLT band from
    ~1e5."""
    from mlmc_tpu.rare import subset_simulation
    from mlmc_tpu.mcmc import make_darcy_inverse

    prob = make_darcy_inverse([32], n_modes=64, sigma=1.0)
    flux = lambda th: prob["forward"](th, 32)[1]
    pilot = jax.vmap(flux)(jax.random.normal(jax.random.key(0),
                                             (4096, prob["d"])))
    lg = jnp.log(pilot)
    gamma = float(jnp.exp(jnp.mean(lg) + 4.75 * jnp.std(lg)))
    out = subset_simulation(flux, gamma=gamma, d=prob["d"],
                            n_particles=2048, n_moves=6,
                            key=jax.random.key(1))
    return dict(workload="Darcy flux tail: P[flux > mu+4.75sd(log)] on "
                         "32^2, 128-d RFF prior, 2048-particle ladder",
                gamma=round(gamma, 3),
                p=float("%.3g" % out["p"]),
                p_band=[float("%.3g" % out["p_lo"]),
                        float("%.3g" % out["p_hi"])],
                n_stages=out["n_stages"],
                pde_solves=int(out["n_forward"]) + 4096,
                wall_s=round(out["wall_s"], 2),
                solves_per_s=round(out["n_forward"]
                                   / max(out["wall_s"], 1e-9), 1),
                acc_final=round(out["acc_rates"][-1], 3)
                if out["acc_rates"] else None)


BENCHES = {"shooting": bench_shooting, "diffusion": bench_diffusion,
           "fractured": bench_fractured, "transport": bench_transport,
           "darcy3d": bench_darcy3d,
           "fractured3d": bench_fractured3d,
           "maxent35": bench_maxent35, "quantity": bench_quantity_algebra,
           "e2e": bench_e2e_adaptive, "e2e_fused": bench_e2e_fused,
           "e2e_darcy": bench_e2e_darcy,
           "qmc": bench_qmc,
           "sde": bench_sde,
           "importance": bench_importance,
           "lattice": bench_lattice,
           "american": bench_american,
           "mimc": bench_mimc,
           "mimc_darcy": bench_mimc_darcy,
           "sensitivity": bench_sensitivity,
           "unbiased": bench_unbiased,
           "cdf": bench_cdf,
           "mfmc": bench_mfmc,
           "mlblue": bench_mlblue,
           "cmlmc": bench_cmlmc,
           "ml2r": bench_ml2r,
           "heston": bench_heston,
           "merton": bench_merton,
           "reactions": bench_reactions,
           "rbergomi": bench_rbergomi,
           "spde": bench_spde,
           "vg": bench_vg,
           "bsde": bench_bsde,
           "nested": bench_nested,
           "mcmc": bench_mcmc,
           "bayes": bench_bayes,
           "rare": bench_rare,
           "collocation": bench_collocation,
           "pce": bench_pce,
           "oed": bench_oed,
           "filter": bench_filter,
           "particle": bench_particle,
           "risk": bench_risk}

if __name__ == "__main__":
    picks = sys.argv[1:] or list(BENCHES)
    print(json.dumps({name: BENCHES[name]() for name in picks}))
