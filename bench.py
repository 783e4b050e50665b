"""Benchmark: moment+covariance estimation throughput on one GPU.

Workload = BASELINE.json config 1: 5-level SynthSimulation, 25 Legendre
moments, full mean/variance/covariance estimate over 10^8 telescoped
samples, through the XLA tier (``mlmc_tpu.ops.fused_estimate.
fused_mlmc_moments``: threefry sampling, QoI, Legendre Vandermonde and all
reductions in one jitted program). Further sections: the float32 fast
tier against an f64 summation bound at >= 1e7 samples, the float64
extended tier against the strict f64 reference, MLQMC and Bayesian
evidence, and a maxent PDF from the headline estimate.

Prints ONE JSON line with the headline, the extras and the device:
    {"metric": ..., "value": N, "unit": "samples/s", "vs_baseline": N,
     "device": {"platform", "kind", "count", "card"}, "extras": {...}}

vs_baseline compares against the strongest single-host numpy pipeline
(BASELINE.md, measured on a CPU host): the same math (gen + legvander(25)
+ diff sums + phi^T phi) vectorized and chunked — 6.98e5 samples/s.

Needs a GPU (``chip_smoke.check_gpu``); any failing section fails the run.
"""
import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import (DOMAIN, HEADLINE_CHUNK, HEADLINE_N, N_MOMENTS,
                        build_headline_step, check_gpu,
                        check_noise_precision)
from mlmc_tpu.moments import Legendre
from mlmc_tpu.ops.fused_estimate import accumulators_to_estimates

BASELINE_SAMPLES_PER_S = 6.98e5
METRIC = ("fused 5-level moment+cov estimate, 25 Legendre moments, "
          "1e8 samples")


def _log(note):
    print("bench: [%s]" % note, file=sys.stderr, flush=True)


def section_headline(extras):
    """XLA tier at 1e8 samples: best of 5 timed runs after a warm-up, each
    ended by block_until_ready. :return: (samples/s, estimate dict)"""
    total = float(sum(HEADLINE_N))
    _fns, _mfn, step = build_headline_step(HEADLINE_N)
    t0 = time.perf_counter()
    jax.block_until_ready(step(jax.random.key(2024)))
    extras["headline_compile_s"] = time.perf_counter() - t0
    walls = []
    for i in range(5):
        t0 = time.perf_counter()
        accs = jax.block_until_ready(step(jax.random.key(i)))
        walls.append(time.perf_counter() - t0)
    est = accumulators_to_estimates(jax.tree.map(np.asarray, accs))
    if abs(est["mean"][0] - 1.0) >= 1e-6:
        raise AssertionError("P0 telescoped mean %r" % est["mean"][0])
    extras.update(headline_wall_s=min(walls), headline_walls_s=walls,
                  chunk=HEADLINE_CHUNK, mean_p1=float(est["mean"][1]),
                  n_valid=est["n_samples"].tolist())
    return total / min(walls), est


def section_precision(extras):
    """f32 fast tier vs an exact f64 summation of the same f32 per-sample
    values at >= 1e7 samples, covariance included, against the derived
    bound eps32 * C_BOUND * S_abs (ops/precision.py); raises on failure."""
    n, report = check_noise_precision()
    extras["precision_vs_f64"] = dict(bound_holds=True, n=n,
                                      max_rel_dev_vs_f64=max(report.values()))


def section_extended(extras):
    """Float64 extended tier: the strict all-f64 reference on identical f32
    QoIs (computed once on the device), plus its time at 1e8 samples."""
    from mlmc_tpu.ops.fused_estimate import (
        moment_pipeline_from_samples_extended, synth_qoi)
    from mlmc_tpu.ops.precision import (check_extended_against_f64,
                                        f64_reference_moments_strict)

    n = 20_004_864
    x = jax.random.normal(jax.random.key(41), (n,), jnp.float32)
    fine, coarse = synth_qoi(x, 0.25, 0.5)
    r = moment_pipeline_from_samples_extended(fine, coarse, N_MOMENTS,
                                              domain=DOMAIN)
    ref = f64_reference_moments_strict(
        n_moments=N_MOMENTS, domain=DOMAIN, include_cov=True,
        fine32=np.asarray(fine), coarse32=np.asarray(coarse))
    report = check_extended_against_f64(r, ref, n)  # raises on fail

    n_thr = 100_007_936
    fine, coarse = synth_qoi(
        jax.random.normal(jax.random.key(42), (n_thr,), jnp.float32),
        0.25, 0.5)
    moment_pipeline_from_samples_extended(fine, coarse, N_MOMENTS,
                                          domain=DOMAIN)   # warm
    t0 = time.perf_counter()
    moment_pipeline_from_samples_extended(fine, coarse, N_MOMENTS,
                                          domain=DOMAIN)   # returns host
    wall = time.perf_counter() - t0
    extras["extended_precision"] = dict(
        bound_holds=True, checked_n=n,
        max_rel_dev_vs_strict_f64=max(report.values()),
        wall_s_1e8=wall, samples_per_s=n_thr / wall)


def section_maxent(extras, est):
    """Maxent PDF from the headline estimate (config 3), warm solve."""
    import mlmc_tpu.tool.simple_distribution as sd

    moments_fn = Legendre(N_MOMENTS, DOMAIN)
    orto, info = sd.construct_ortogonal_moments(moments_fn, est["cov"],
                                                tol=1e-7)
    mu = info[2] @ est["mean"]
    data = np.stack((mu, np.ones(orto.size)), axis=1)
    # warm pass: one Newton executable per (panel bucket, R) shape
    sd.SimpleDistribution(orto, data, domain=moments_fn.domain
                          ).estimate_density_minimize(tol=1e-9)
    t0 = time.perf_counter()
    d = sd.SimpleDistribution(orto, data, domain=moments_fn.domain)
    result = d.estimate_density_minimize(tol=1e-9)
    extras.update(maxent_solve_s=time.perf_counter() - t0,
                  maxent_converged=bool(result.success),
                  maxent_solver_backend=d._solver_backend,
                  maxent_grad_norm=float(result.fun_norm))
    if not result.success:
        raise AssertionError("maxent solve did not converge")


def main():
    card = check_gpu(1)
    dev = jax.devices()[0]
    extras = {}
    _log("headline")
    value, est = section_headline(extras)
    from bench_extra import bench_bayes_compact, bench_qmc_compact

    for name, run in (("precision", lambda: section_precision(extras)),
                      ("extended", lambda: section_extended(extras)),
                      ("qmc", lambda: extras.update(
                          qmc=bench_qmc_compact())),
                      ("bayes", lambda: extras.update(
                          bayes=bench_bayes_compact())),
                      ("maxent", lambda: section_maxent(extras, est))):
        _log(name)
        run()
    print(json.dumps({
        "metric": METRIC, "value": value, "unit": "samples/s",
        "vs_baseline": value / BASELINE_SAMPLES_PER_S,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "extras": extras}), flush=True)


if __name__ == "__main__":
    main()
