"""Smoke run of the main MLMC path on an NVIDIA GPU, in one process.

    python chip_smoke.py               # one card: adaptive, headline, darcy
    python chip_smoke.py --four-cards  # the mesh path on four cards only

Phases (one card):

* ``adaptive`` — the flagship workflow at its real size through the public
  API: SynthSimulation -> DeviceBatchPool (1M-sample slices) ->
  DeviceMemory -> the adaptive target-variance loop (5 levels, 25 Legendre
  moments, target_var 2e-8, ~1e7 stored samples) -> construct_density_fast.
  Checks every estimation tier against a strict f64 host reference over
  the same stored f32 samples, and the f64 maxent backend against the
  numpy one;
* ``headline`` — the XLA tier (``fused_mlmc_moments``) at 1e8 samples, and
  the float32 fast tier against the f64 summation bound at >= 1e7
  samples, covariance included;
* ``darcy`` — the adaptive Darcy campaign (16^2/32^2/64^2 grids,
  circulant GRF, target_var 1e-6); 64 samples per level recomputed on the
  CPU device in float64 from the same keys;
* ``gpu tests`` — tests/test_gpu.py, the card-only tests.

``--four-cards`` runs only the mesh path (``DeviceBatchPool(sharding=
SampleMesh())``, ``sharded_mlmc_step``, ``sharded_synth_pipeline_from_noise``)
on four cards against the same work on one card.

Every phase raises on a failed check, so the script then exits non-zero.
Without a GPU it fails at the device check. The last line of stdout is
the JSON result ``{"ok": true, "device": {...}}``.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

import mlmc_tpu.quantity.quantity_estimate as qe
import mlmc_tpu.tool.simple_distribution as sd
from mlmc_tpu import (DeviceBatchPool, DeviceMemory, DiffusionSimulation,
                      Estimate, Legendre, Sampler, SynthSimulation,
                      make_root_quantity)
from mlmc_tpu.estimator import estimate_n_samples_for_target_variance
from mlmc_tpu.ops.fused_estimate import (
    accumulators_to_estimates, fused_mlmc_moments,
    mlmc_moment_pipeline_from_samples, pack_level_samples,
    synth_moment_pipeline_from_noise)
from mlmc_tpu.ops.precision import (
    EPS32, C_BOUND, check_against_f64, f64_reference_moments,
    f64_reference_moments_strict)
from mlmc_tpu.parallel import (SampleMesh, sharded_mlmc_step,
                               sharded_synth_pipeline_from_noise)
from mlmc_tpu.random.distributions import Norm

LEVELS = [[0.5], [0.25], [0.125], [0.0625], [0.03125]]
N_MOMENTS = 25
DOMAIN = (-4.0, 4.0)
TARGET_VAR = 2e-8
SLICE = 1 << 20
HEADLINE_N = [64_000_000, 24_000_000, 8_000_000, 3_000_000, 1_000_000]
HEADLINE_CHUNK = 1 << 19   # fastest of 2^14..2^19 on an H100
EXT_REL_TOL = 1e-10     # extended tier vs strict f64, relative to S_abs
DENSITY_TOL = 1e-9      # jax vs numpy maxent backends, max abs density


def log(*parts):
    print(*parts, flush=True)


class CompileCounter:
    """Counts XLA backend compiles (and loads from the persistent cache)
    through JAX's monitoring events."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.n = 0
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == self.EVENT:
            self.n += 1
            self.seconds += duration

    def mark(self):
        return self.n, self.seconds

    def since(self, mark):
        return self.n - mark[0], self.seconds - mark[1]


def check_gpu(n_cards):
    """The device check: a GPU, with ``n_cards`` devices; prints the card's
    name and power limit as nvidia-smi reports them."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit("chip_smoke: JAX finds no GPU (platform %r)"
                         % devices[0].platform)
    if len(devices) < n_cards:
        raise SystemExit("chip_smoke: needs %d GPUs, JAX finds %d"
                         % (n_cards, len(devices)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log("card: %s" % card)
    log("jax %s, %d %s device(s)" % (jax.__version__, len(devices),
                                     devices[0].device_kind))
    return card


# ------------------------------------------------------------------ #
# adaptive
# ------------------------------------------------------------------ #
def run_adaptive(seed, sharding=None):
    """The adaptive loop and the fast maxent density, as a user runs them.

    :return: (estimate, storage, quantity, stats dict)
    """
    t0 = time.perf_counter()
    sim = SynthSimulation(dict(distr="norm", complexity=2))
    storage = DeviceMemory()
    pool = DeviceBatchPool(seed=seed, device_results=True, min_bucket=SLICE,
                           max_batch=SLICE, sharding=sharding)
    sampler = Sampler(storage, pool, sim, LEVELS)
    sampler.set_initial_n_samples([200_000, 2_000])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    q = make_root_quantity(storage, sim.result_format())["length"][1]["10"][
        0, 0]
    est = Estimate(q, storage, Legendre(N_MOMENTS, DOMAIN))
    rounds = 0
    while rounds < 20:
        raw_vars, _ = est.estimate_diff_vars_fast()
        variances, n_ops = est.estimate_diff_vars_regression(
            sampler._n_scheduled_samples, raw_vars=raw_vars)
        n_est = estimate_n_samples_for_target_variance(
            TARGET_VAR, variances, n_ops, n_levels=sampler.n_levels)
        if sampler.process_adding_samples(n_est, 0, 0.3):
            break
        rounds += 1
    _d, _i, result, _o = est.construct_density_fast(tol=1e-8)
    wall = time.perf_counter() - t0
    return est, storage, q, dict(
        wall_s=wall, rounds=rounds, result=result,
        n_per_level=[int(n) for n in storage.get_n_collected()])


def stored_levels(q, storage):
    """Per-level [N, 2] f32 host copies of the quantity's stored samples."""
    out = []
    for lvl in range(storage.get_n_levels()):
        parts = [np.asarray(q.samples(cs))
                 for cs in storage.chunks(level_id=lvl)]
        y = np.concatenate(parts, axis=1)[0]
        assert y.dtype == np.float32, y.dtype
        out.append(y)
    return out


def _bound(abs_sums):
    return float(EPS32) * C_BOUND * np.asarray(abs_sums)


def reference_estimates(levels):
    """Strict f64 estimates over the stored samples, with the f32 fast-tier
    bound eps32 * C_BOUND * S_abs of every accumulator carried into the
    estimates built from it (mean, estimator variance, covariance)."""
    R = N_MOMENTS
    mean, var, cov = np.zeros(R), np.zeros(R), np.zeros((R, R))
    b_mean, b_var, b_cov = np.zeros(R), np.zeros(R), np.zeros((R, R))
    s_mean, s_var, s_cov = np.zeros(R), np.zeros(R), np.zeros((R, R))
    n_valid = []
    for lvl, y in enumerate(levels):
        ref = f64_reference_moments_strict(
            n_moments=R, domain=DOMAIN, is_level0=lvl == 0,
            fine32=y[:, 0], coarse32=None if lvl == 0 else y[:, 1])
        n = ref["n_valid"]
        n_valid.append(n)
        s, s2 = ref["sums"], ref["sums2"]
        db, db2 = _bound(ref["abs_sums"]), _bound(ref["abs_sums2"])
        mean += s / n
        b_mean += db / n
        l_var = (s2 - s * s / n) / (n - 1)
        var += l_var / n
        b_var += (db2 + (2 * np.abs(s) * db + db * db) / n) / (n - 1) / n
        cov += (ref["cov_fine"] - ref["cov_coarse"]) / n
        b_cov += (_bound(ref["abs_cov_fine"])
                  + _bound(ref["abs_cov_coarse"])) / n
        s_mean += ref["abs_sums"] / n
        s_var += (ref["abs_sums2"] + s * s / n) / (n - 1) / n
        s_cov += (ref["abs_cov_fine"] + ref["abs_cov_coarse"]) / n
    return dict(mean=mean, var=var, cov=cov, b_mean=b_mean, b_var=b_var,
                b_cov=b_cov, s_mean=s_mean, s_var=s_var, s_cov=s_cov,
                n_valid=n_valid)


def within(name, got, want, bound):
    """Assert |got - want| <= bound elementwise; return max |err|/bound."""
    err = np.abs(np.asarray(got, np.float64) - want)
    ratio = float(np.max(err / np.maximum(bound, 1e-300)))
    log("  %-34s max|err| %.3e  max|err|/bound %.3f"
        % (name, float(err.max()), ratio))
    if not np.all(err <= bound):
        raise AssertionError("%s outside its bound (ratio %.3f)"
                             % (name, ratio))
    return ratio


def time_stored_pipeline(levels, reps=5):
    """Device time of the plain stored-sample pipeline over all levels of
    the adaptive store (one dispatch), as the adaptive loop calls it."""
    fine, coarse, counts = pack_level_samples(
        [jnp.asarray(y[:, 0]) for y in levels],
        [None] + [jnp.asarray(y[:, 1]) for y in levels[1:]])

    def run():
        return jax.block_until_ready(mlmc_moment_pipeline_from_samples(
            fine, coarse, counts, N_MOMENTS, domain=DOMAIN))

    run()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    return (time.perf_counter() - t0) / reps


def phase_adaptive(compiles):
    log("[adaptive] warm-up run (compiles)")
    mark = compiles.mark()
    run_adaptive(seed=16)
    n_c, s_c = compiles.since(mark)
    log("[adaptive] warm-up: %d compiles, %.1f s compiling" % (n_c, s_c))

    mark = compiles.mark()
    est, storage, q, st = run_adaptive(seed=17)
    n_c, s_c = compiles.since(mark)
    n_total = sum(st["n_per_level"])
    log("[adaptive] wall %.3f s, %d samples %s, %d rounds, %d compiles "
        "(%.2f s) inside the warm loop" % (st["wall_s"], n_total,
                                          st["n_per_level"], st["rounds"],
                                          n_c, s_c))
    result = st["result"]
    log("[adaptive] density: success=%s fun_norm=%.3e nit=%s"
        % (result.success, result.fun_norm, result.nit))
    if not (result.success and result.fun_norm <= 1e-8):
        raise AssertionError("density did not converge to fun_norm <= tol")

    mfn = Legendre(N_MOMENTS, DOMAIN)
    mean, var = est.estimate_moments_fast()
    cov, mean_c = est.estimate_covariance_fast()
    if abs(mean[0] - 1.0) >= 1e-6:
        raise AssertionError("telescoped P0 mean %r != 1" % mean[0])

    log("[adaptive] strict f64 host reference over the stored f32 samples")
    levels = stored_levels(q, storage)
    ref = reference_estimates(levels)
    if ref["n_valid"] != st["n_per_level"]:
        log("  valid counts %s of stored %s" % (ref["n_valid"],
                                                 st["n_per_level"]))
    within("fast mean", mean, ref["mean"], ref["b_mean"])
    within("fast estimator variance", var, ref["var"], ref["b_var"])
    within("fast covariance", cov, ref["cov"], ref["b_cov"])
    within("fast mean (covariance call)", mean_c, ref["mean"], ref["b_mean"])

    dag = qe.estimate_mean(qe.moments(q, mfn))
    dag_mean = np.ravel(np.asarray(dag.mean, np.float64))
    within("DAG mean", dag_mean, ref["mean"], ref["b_mean"])
    within("DAG mean vs fast mean", dag_mean, mean, ref["b_mean"])

    ext_mean, ext_var = est.estimate_moments_extended()
    ext_cov, _ = est.estimate_covariance_extended()
    within("extended mean (1e-10 rel)", ext_mean, ref["mean"],
           EXT_REL_TOL * np.maximum(ref["s_mean"], 1.0))
    within("extended covariance (1e-10 rel)", ext_cov, ref["cov"],
           EXT_REL_TOL * np.maximum(ref["s_cov"], 1.0))
    within("extended estimator variance (1e-10 rel)", ext_var, ref["var"],
           EXT_REL_TOL * ref["s_var"])

    orth, info = sd.construct_ortogonal_moments(mfn, cov, tol=1e-4)
    mu = info[2] @ mean
    data = np.stack((mu[:orth.size], np.ones(orth.size)), axis=1)
    xs = np.linspace(DOMAIN[0], DOMAIN[1], 1001)
    dens = {}
    for backend in ("jax", "numpy"):
        d = sd.SimpleDistribution(orth, data, domain=orth.domain,
                                  solver_backend=backend)
        t0 = time.perf_counter()
        res = d.estimate_density_minimize(tol=1e-10)
        log("  maxent %-5s: %.3f s, nit %s, fun_norm %.3e"
            % (backend, time.perf_counter() - t0, res.nit, res.fun_norm))
        if not res.success:
            raise AssertionError("maxent %s backend did not converge"
                                 % backend)
        dens[backend] = d.density(xs)
    within("maxent jax vs numpy density", dens["jax"], dens["numpy"],
           DENSITY_TOL)

    t = time_stored_pipeline(levels)
    log("[adaptive] stored-sample pipeline over %d samples: %.3f ms "
        "per dispatch" % (n_total, 1e3 * t))
    log("[adaptive] ok")


# ------------------------------------------------------------------ #
# headline
# ------------------------------------------------------------------ #
def build_headline_step(n_per_level, chunk=HEADLINE_CHUNK):
    distr = Norm()
    fns = [SynthSimulation.scalar_batch_fn(
        h, 0.0 if lvl == 0 else LEVELS[lvl - 1][0], distr)
        for lvl, (h,) in enumerate(LEVELS)]
    mfn = Legendre(N_MOMENTS, DOMAIN)
    return fns, mfn, jax.jit(lambda key: fused_mlmc_moments(
        fns, mfn, key, n_per_level, chunk_size=chunk, acc_dtype=jnp.float32))


def phase_headline(card):
    total = sum(HEADLINE_N)
    _fns, _mfn, step = build_headline_step(HEADLINE_N)
    t0 = time.perf_counter()
    jax.block_until_ready(step(jax.random.key(0)))
    log("[headline] compile + first run %.1f s" % (time.perf_counter() - t0))
    walls = []
    for i in range(3):
        t0 = time.perf_counter()
        accs = jax.block_until_ready(step(jax.random.key(i + 1)))
        walls.append(time.perf_counter() - t0)
    est = accumulators_to_estimates(jax.tree.map(np.asarray, accs))
    if abs(est["mean"][0] - 1.0) >= 1e-6 or not np.all(
            np.isfinite(est["mean"])):
        raise AssertionError("headline estimate: mean %r" % est["mean"][:3])
    if int(est["n_samples"].sum()) < 0.999 * total:
        raise AssertionError("headline valid counts %s" % est["n_samples"])
    best = min(walls)
    log("[headline] fused_mlmc_moments, %d samples: %.4f s "
        "(runs %s) -> %.4e samples/s on %s"
        % (total, best, ["%.4f" % w for w in walls], total / best, card))

    n, report = check_noise_precision()
    log("[headline] f32 fast tier vs f64 at %d samples, covariance "
        "included: within eps32*C_BOUND*S_abs; max rel dev %s"
        % (n, {k: "%.2e" % v for k, v in report.items()}))
    log("[headline] ok")


def check_noise_precision(n=10_010_624):
    """The f32 fast tier on >= 1e7 synthetic samples against an exact f64
    summation of the same f32 per-sample values, covariance included,
    within eps32 * C_BOUND * S_abs (raises otherwise).

    :return: (n, {accumulator: max relative deviation})"""
    x = jax.random.normal(jax.random.key(99), (n,), jnp.float32)
    r = jax.tree.map(np.asarray, synth_moment_pipeline_from_noise(
        x, N_MOMENTS, fine_step=0.25, coarse_step=0.5, domain=DOMAIN))
    ref = f64_reference_moments(np.asarray(x), N_MOMENTS, fine_step=0.25,
                                coarse_step=0.5, domain=DOMAIN,
                                include_cov=True)
    return n, check_against_f64(r, ref, include_cov=True)


# ------------------------------------------------------------------ #
# darcy
# ------------------------------------------------------------------ #
DARCY_LEVELS = [[1 / 16], [1 / 32], [1 / 64]]
#: margin on the CG-derived flux bound (``f64_fluxes``) for the f32 true
#: residual drifting above CG's recursive one and the f32 field rounding
DARCY_MARGIN = 2.0


def cg_iterations(cfg, Ks):
    """Worst-sample CG iteration count of the solves over a batch of
    conductivity fields (what a vmapped batch pays): the least maxiter at
    which every solution equals the unbounded solve's, by bisection (the
    solve stops once CG's residual meets its tolerance)."""
    n = Ks.shape[-1]

    @jax.jit
    def solve(Ks, k_iter):
        # maxiter is traced: one executable serves every bisection step
        c = dict(cfg, cg_maxiter_factor=k_iter / n)
        return jax.vmap(lambda K: DiffusionSimulation._solve_pressure(c, K))(
            Ks)

    def solves(k_iter):
        return solve(Ks, jnp.asarray(k_iter, Ks.dtype))

    lo, hi = 0, DiffusionSimulation.CG_MAXITER_FACTOR * n
    full = solves(hi)
    if bool(jnp.array_equal(solves(hi - 1), full)) is False:
        return hi   # some sample ran into the iteration cap
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if bool(jnp.array_equal(solves(mid), full)):
            hi = mid
        else:
            lo = mid
    return hi


def f64_fluxes(cfg, K32):
    """Outflow fluxes of the given f32 fields, solved on the CPU device in
    float64 to a CG residual of 1e-12, with the bound CG's own stopping
    test puts on a flux computed from its solution.

    The flux is linear in the pressure, ``flux = c . p``; a solve stopped
    at ``||r|| <= CG_TOL ||b||`` is off by ``c . A^-1 r``, at most
    ``CG_TOL ||b|| ||A^-1 c||`` (A symmetric). The coarse grid
    point-samples the fine field, as ``DiffusionSimulation`` couples them.

    :return: (fine fluxes, fine bounds, coarse fluxes, coarse bounds);
        the coarse pair is None on level 0
    """
    sim = DiffusionSimulation
    cpu = jax.devices("cpu")[0]

    def flux_and_bound(K):
        n = K.shape[0]
        Kx, Ky = sim._face_conductivities(K)
        Kl, Kr = 2.0 * K[:, 0], 2.0 * K[:, -1]
        p = sim._solve_pressure(dict(cfg, cg_tol=1e-12), K)
        c = jnp.zeros((n, n), K.dtype).at[:, -1].set(Kr)
        y, _ = jax.scipy.sparse.linalg.cg(
            lambda v: sim._stencil_matvec(v.reshape(n, n), Kx, Ky, Kl,
                                          Kr).reshape(-1),
            c.reshape(-1), tol=1e-10, maxiter=50 * n * n)
        return (jnp.sum(c * p), sim.CG_TOL * jnp.linalg.norm(Kl)
                * jnp.linalg.norm(y))

    with jax.enable_x64(True), jax.default_device(cpu):
        K = jnp.asarray(np.asarray(K32), jnp.float64)
        run = jax.jit(jax.vmap(flux_and_bound))
        fine, b_fine = map(np.asarray, run(K))
        if not cfg["coarse_n"]:
            return fine, b_fine, None, None
        Kc = jax.vmap(lambda k: sim._coarse_from_fine_K(cfg, k))(K)
        coarse, b_coarse = map(np.asarray, run(Kc))
    return fine, b_fine, coarse, b_coarse


def phase_darcy():
    t0 = time.perf_counter()
    sim = DiffusionSimulation(dict(sigma=1.0, corr_length=0.3,
                                   field_method="circulant"))
    storage = DeviceMemory()
    pool = DeviceBatchPool(seed=23, device_results=True, min_bucket=1 << 12,
                           max_batch=1 << 14)
    sampler = Sampler(storage, pool, sim, DARCY_LEVELS)
    sampler.set_initial_n_samples([2000, 500, 100])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    q = make_root_quantity(storage, sim.result_format())["flux"][0][
        "outflow"][0]
    est = Estimate(q, storage, Legendre(15, (0.05, 8.0)))
    rounds = 0
    while rounds < 12:
        raw_vars, _ = est.estimate_diff_vars_fast()
        variances, n_ops = est.estimate_diff_vars_regression(
            sampler._n_scheduled_samples, raw_vars=raw_vars)
        n_est = estimate_n_samples_for_target_variance(
            1e-6, variances, n_ops, n_levels=sampler.n_levels)
        if sampler.process_adding_samples(n_est, 0, 0.3):
            break
        rounds += 1
    m = qe.estimate_mean(q)
    wall = time.perf_counter() - t0
    n_per_level = [int(n) for n in storage.get_n_collected()]
    mean_flux = float(np.ravel(np.asarray(m.mean))[0])
    log("[darcy] wall %.2f s, %s samples, %d rounds, mean flux %.6f"
        % (wall, n_per_level, rounds, mean_flux))
    if not np.isfinite(mean_flux):
        raise AssertionError("darcy mean flux %r" % mean_flux)

    pairs = storage.sample_pairs()
    coarse_params = [[0]] + DARCY_LEVELS[:-1]
    worst = 0.0
    for lvl, (fine_p, coarse_p) in enumerate(zip(DARCY_LEVELS,
                                                 coarse_params)):
        # the first 64 stored rows are sample indices 0..63 (the initial
        # round's contiguous range); the fields are drawn from their keys
        # in f32 as on the card, the solves redone in f64
        cfg = sim.level_instance(fine_p, coarse_p).config_dict
        keys = jax.vmap(lambda i: pool.sample_key(lvl, i))(jnp.arange(64))
        K = jax.vmap(lambda k: DiffusionSimulation._conductivity(
            cfg, k, cfg["fine_n"]))(keys)
        got = np.asarray(pairs[lvl])[0, :64].astype(np.float64)
        fine, b_fine, coarse, b_coarse = f64_fluxes(cfg, K)
        want = fine[:, None] if coarse is None else np.stack(
            [fine, coarse], axis=1)
        bound = DARCY_MARGIN * (b_fine[:, None] if coarse is None
                                else np.stack([b_fine, b_coarse], axis=1))
        ratio = float(np.max(np.abs(got - want) / bound))
        worst = max(worst, ratio)
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        it_card = cg_iterations(cfg, K)
        with jax.enable_x64(True), jax.default_device(
                jax.devices("cpu")[0]):
            it_f64 = cg_iterations(cfg, jnp.asarray(np.asarray(K),
                                                    jnp.float64))
        log("  level %d (h=%s): max rel flux dev vs f64 %.3e, max "
            "dev/bound %.3f (bound: %g x CG_TOL ||b|| ||A^-1 c||, median "
            "%.2e rel); CG iterations of the worst fine sample: %d on %s "
            "in f32, %d on the CPU in f64"
            % (lvl, fine_p[0], rel, ratio, DARCY_MARGIN,
               float(np.median(bound / np.abs(want))), it_card,
               K.devices().pop().platform, it_f64))
    if worst > 1.0:
        raise AssertionError("darcy samples deviate from the f64 recompute "
                             "beyond the CG bound (ratio %.3f)" % worst)
    log("[darcy] ok")


def phase_gpu_tests():
    """The card-only tests (tests/test_gpu.py, marker ``gpu``) in this
    process: a second process could not take the card's memory. Last,
    since the test configuration turns on x64."""
    import os
    import pytest

    os.environ["JAX_PLATFORMS"] = "cuda"   # keeps conftest off the CPU
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "test_gpu.py")
    code = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", path])
    if code != 0:
        raise AssertionError("gpu tests failed (pytest exit %s)" % code)
    log("[gpu tests] ok")


# ------------------------------------------------------------------ #
# four cards
# ------------------------------------------------------------------ #
def phase_four_cards(compiles):
    devices = jax.devices()[:4]
    mesh = SampleMesh(devices)
    one = SampleMesh(devices[:1])

    log("[mesh] adaptive sampler sharded over 4 cards")
    est4, storage4, q4, st4 = run_adaptive(seed=17, sharding=mesh)
    log("[mesh] 4 cards: wall %.3f s, %s samples, %d rounds"
        % (st4["wall_s"], st4["n_per_level"], st4["rounds"]))
    sim = SynthSimulation(dict(distr="norm", complexity=2))
    storage1 = DeviceMemory()
    pool1 = DeviceBatchPool(seed=17, device_results=True, min_bucket=SLICE,
                            max_batch=SLICE)
    sampler1 = Sampler(storage1, pool1, sim, LEVELS)
    sampler1.set_initial_n_samples(st4["n_per_level"])
    sampler1.schedule_samples()
    sampler1.ask_sampling_pool_for_samples()
    if [int(n) for n in storage1.get_n_collected()] != st4["n_per_level"]:
        raise AssertionError("one-card rerun collected %s"
                             % storage1.get_n_collected())
    for lvl, (a, b) in enumerate(zip(storage4.sample_pairs(),
                                     storage1.sample_pairs())):
        a, b = np.asarray(a), np.asarray(b)
        dev = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))
        log("  level %d: %d stored samples, max rel dev 4 vs 1 card %.2e"
            % (lvl, a.shape[1], dev))
        if a.shape != b.shape or dev > 4 * float(EPS32):
            raise AssertionError("level %d samples differ across meshes"
                                 % lvl)
    q1 = make_root_quantity(storage1, sim.result_format())["length"][1][
        "10"][0, 0]
    mean4, var4 = est4.estimate_moments_fast()
    mean1, var1 = Estimate(q1, storage1,
                           Legendre(N_MOMENTS, DOMAIN)).estimate_moments_fast()
    ref = reference_estimates(stored_levels(q4, storage4))
    within("mean 4 cards vs 1 card", mean4, mean1, 2 * ref["b_mean"])
    within("variance 4 cards vs 1 card", var4, var1, 2 * ref["b_var"])

    log("[mesh] sharded_mlmc_step, %d samples" % sum(HEADLINE_N))
    fns, mfn, single = build_headline_step(HEADLINE_N)
    out = {}
    for name, m in (("1 card", one), ("4 cards", mesh)):
        step = sharded_mlmc_step(m, fns, mfn, HEADLINE_N,
                                 chunk_size=HEADLINE_CHUNK,
                                 acc_dtype=jnp.float32)
        jax.block_until_ready(step(jax.random.key(5)))
        t0 = time.perf_counter()
        accs = jax.block_until_ready(step(jax.random.key(5)))
        log("  %s: %.4f s" % (name, time.perf_counter() - t0))
        out[name] = jax.tree.map(np.asarray, accs)
    for lvl, (a, b) in enumerate(zip(out["4 cards"], out["1 card"])):
        n = float(b.n_valid)
        if float(a.n_valid) != n:
            raise AssertionError("level %d valid counts %s vs %s"
                                 % (lvl, a.n_valid, b.n_valid))
        # |P_k| <= 1 on the domain: S_abs <= 2n for sums, n for products
        within("level %d sums" % lvl, a.sums, np.asarray(b.sums, np.float64),
               2 * _bound(2 * n))
        within("level %d cov_fine" % lvl, a.cov_fine,
               np.asarray(b.cov_fine, np.float64), 2 * _bound(n))

    log("[mesh] sharded_synth_pipeline_from_noise")
    steps = [h for (h,) in LEVELS]
    chunk = 16384
    noise = [jax.random.normal(jax.random.key(100 + lvl), (4 * 64 * chunk,),
                               jnp.float32) for lvl in range(len(steps))]
    res = {}
    for name, m in (("1 card", one), ("4 cards", mesh)):
        step = sharded_synth_pipeline_from_noise(
            m, N_MOMENTS, steps, domain=DOMAIN, chunk=chunk)
        res[name] = jax.tree.map(np.asarray, step(*noise))
    for lvl, (a, b) in enumerate(zip(res["4 cards"], res["1 card"])):
        n = float(b.n_valid)
        if float(a.n_valid) != n:
            raise AssertionError("level %d valid counts differ" % lvl)
        within("noise level %d sums" % lvl, a.sums,
               np.asarray(b.sums, np.float64), 2 * _bound(2 * n))
        within("noise level %d cov_fine" % lvl, a.cov_fine,
               np.asarray(b.cov_fine, np.float64), 2 * _bound(n))
    mean0 = sum(float(r.sums[0]) / float(r.n_valid) for r in res["4 cards"])
    if abs(mean0 - 1.0) >= 1e-6:
        raise AssertionError("P0 telescoped mean %r" % mean0)
    log("[mesh] ok")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the mesh path on four cards")
    args = parser.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    compiles = CompileCounter()
    t0 = time.perf_counter()
    card = check_gpu(n_cards)
    if args.four_cards:
        phase_four_cards(compiles)
    else:
        phase_adaptive(compiles)
        phase_headline(card)
        phase_darcy()
        phase_gpu_tests()
    log("total %.1f s, %d compiles (%.1f s) in the process"
        % (time.perf_counter() - t0, compiles.n, compiles.seconds))
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
