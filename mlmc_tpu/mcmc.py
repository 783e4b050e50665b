"""Multilevel Markov chain Monte Carlo — Bayesian-inversion tier.

Beyond-reference capability: the reference framework estimates FORWARD
expectations E[Q(omega)] (reference mlmc/sampler.py, estimator.py); it has
no machinery for POSTERIOR expectations E[Q | y] given observed data. This
module adds the multilevel MCMC method of Dodwell, Ketelsen, Scheichl &
Teckentrup ("A hierarchical multilevel Markov chain Monte Carlo algorithm
with applications to uncertainty quantification in subsurface flow",
SIAM/ASA JUQ 3, 2015): posterior expectations over a discretization
hierarchy at MLMC cost, with the level-(l-1) chain acting as the proposal
generator for the level-l chain.

Building blocks:

* **pCN Metropolis-Hastings** (Cotter, Roberts, Stuart & White, "MCMC
  methods for functions", Stat. Sci. 28, 2013): for a standard-Gaussian
  prior on the latent vector theta, the proposal
  ``theta' = sqrt(1-beta^2) theta + beta xi`` is prior-reversible, so the
  acceptance ratio is the LIKELIHOOD ratio alone — dimension-robust for
  function-space priors (KL / random-Fourier-feature field coordinates).
* **Two-level coupled kernel** — two variants:

  - ``mode="crn"`` (default, EXACT): two pCN chains, one per level
    posterior, joined by the REFLECTION-MAXIMAL coupling of their
    proposal kernels plus a shared acceptance uniform (the coupling
    construction of Jacob, O'Leary & Atchade, "Unbiased Markov chain
    Monte Carlo methods with couplings", JRSS-B 82, 2020): the coarse
    proposal EQUALS the fine proposal with the maximal-coupling
    probability of the two Gaussians N(s theta_f, beta^2 I) /
    N(s theta_c, beta^2 I), and is the reflection of the shared
    innovation otherwise. Each chain alone is an untouched exact pCN
    chain, so both marginals are invariant and the correction estimator
    ``mean[Q_l(theta^f) - Q_{l-1}(theta^c)]`` is asymptotically
    unbiased with NO tuning parameter. The coupling is STICKY: chains
    that meet propose identically and accept/reject identically except
    with probability ~ the level likelihood difference, so they stay
    GLUED between rare mismatches and the reflection drives them back
    together after one — the correction variance decays as the levels
    converge, the MCMC analogue of MLMC variance decay.
  - ``mode="dodwell"`` (literature algorithm, Dodwell et al. Alg. 3):
    the level-l proposal is the current state of a FREE-RUNNING
    level-(l-1) chain advanced ``subsample`` sub-steps per fine step
    (independence-type sampler whose proposal density approaches the
    coarse posterior; prior and proposal densities cancel:
    ``log alpha = [ll_f(theta^c) - ll_f(theta^f)] -
    [ll_c(theta^c) - ll_c(theta^f)]``). EXACT ONLY in the limit of
    effectively independent proposals: at finite ``subsample`` the
    proposal is correlated with the fine state (on acceptance the fine
    state IS a recent coarse state) and the independence-sampler
    invariance argument breaks, leaving an O(rho^t) bias — the paper
    prescribes subsampling by the coarse integrated autocorrelation
    time. Offered for literature parity; prefer ``crn``.
* **Telescoping estimator**: ``E_{pi_L}[Q_L] = E_{pi_0}[Q_0] +
  sum_l ( E_{pi_l}[Q_l] - E_{pi_{l-1}}[Q_{l-1}] )`` — each correction
  estimated by one coupled chain, each expectation under ITS OWN level
  posterior (the coarse terms cancel exactly across levels).

Device-first design:

* ``n_chains`` chains advance in lockstep inside ONE jitted ``lax.scan``;
  every forward model evaluates as a [B, ...] batch (vmap), so the PDE
  solves arrive at the device in blocks and accept/reject is a
  ``jnp.where`` mask — no per-chain control flow, no Python loop.
* the chain batch doubles as the CLT engine: independent chains give an
  autocorrelation-free across-chain standard error (ESS / split-R-hat
  diagnostics are still computed from the per-chain series).
* proposal step size ``beta`` adapts during burn-in by a Robbins-Monro
  recursion ON DEVICE (carried scalar, frozen after burn-in), targeting
  the 0.234 optimal acceptance rate.
* one executable per level serves any chain length (the scan's trip
  count is static per call but shapes are [B, d] regardless of length).
"""
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["run_pcn", "run_coupled", "run_mlda", "run_unbiased",
           "MLMCMC", "ChainResult", "CoupledResult", "ess",
           "split_rhat", "make_darcy_inverse", "gaussian_loglik"]


# ---------------------------------------------------------------------- #
# diagnostics (host-side numpy: small [n_out, B] arrays)
# ---------------------------------------------------------------------- #
def ess(series):
    """Effective sample size of an MCMC series by Geyer's initial
    positive sequence, summed over chains.

    :param series: [n, B] per-step values of B chains.
    :return: scalar ESS estimate (<= n*B).
    """
    x = np.asarray(series, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n, B = x.shape
    x = x - x.mean(axis=0, keepdims=True)
    var = (x * x).mean(axis=0)          # [B]
    total = 0.0
    for b in range(B):
        if var[b] <= 0:
            total += n
            continue
        # autocovariance via FFT
        m = 1 << int(np.ceil(np.log2(2 * n)))
        f = np.fft.rfft(x[:, b], m)
        acov = np.fft.irfft(f * np.conj(f), m)[:n].real / n
        rho = acov / acov[0]
        # Geyer: sum consecutive pairs while positive
        tau = 1.0
        for k in range(1, n - 1, 2):
            pair = rho[k] + rho[k + 1]
            if pair <= 0:
                break
            tau += 2.0 * pair
        total += n / max(tau, 1.0)
    return total


def split_rhat(series):
    """Split-chain Gelman-Rubin potential scale reduction factor.

    Each chain is split in half (2B half-chains of length n//2); R-hat
    near 1 indicates the halves agree with each other and across chains.

    :param series: [n, B].
    """
    x = np.asarray(series, dtype=np.float64)
    n, B = x.shape
    h = n // 2
    if h < 2:
        return 1.0          # too short to diagnose
    halves = np.concatenate([x[:h], x[h:2 * h]], axis=1)   # [h, 2B]
    m = halves.shape[1]
    cm = halves.mean(axis=0)                               # [2B]
    cw = halves.var(axis=0, ddof=1)                        # [2B]
    W = cw.mean()
    Bvar = h * cm.var(ddof=1)
    if W <= 0:
        return 1.0
    var_plus = (h - 1) / h * W + Bvar / h
    return float(np.sqrt(var_plus / W))


# ---------------------------------------------------------------------- #
# single-level pCN
# ---------------------------------------------------------------------- #
class ChainResult:
    """Output of :func:`run_pcn`.

    Attributes: ``qoi`` [n_out, B, q] post-burn thinned QoI series,
    ``mean`` [q], ``se`` [q] (across-chain CLT), ``acc_rate``,
    ``beta`` (post-adaptation), ``theta`` [B, d] final states,
    ``ll`` [B] final log-likelihoods, ``ess``, ``rhat`` (first QoI
    component), ``n_forward`` forward evaluations performed.
    """

    def __init__(self, qoi, acc_rate, beta, theta, ll, n_forward):
        self.qoi = qoi
        self.acc_rate = float(acc_rate)
        self.beta = float(beta)
        self.theta = theta
        self.ll = ll
        self.n_forward = int(n_forward)
        chain_means = qoi.mean(axis=0)               # [B, q]
        self.mean = chain_means.mean(axis=0)
        B = qoi.shape[1]
        self.se = chain_means.std(axis=0, ddof=1) / np.sqrt(B)
        self.ess = ess(qoi[:, :, 0])
        self.rhat = split_rhat(qoi[:, :, 0])


def _pcn_propose(theta, xi, beta):
    return jnp.sqrt(1.0 - beta * beta) * theta + beta * xi


def _rm_beta(beta, acc_mean, step, burn, target=0.234, rate=0.5):
    """Robbins-Monro step-size adaptation, frozen after burn-in.

    Operates on logit(beta) so beta stays in (0, 1). The acceptance
    signal is a whole-batch mean (B chains), so it is nearly noiseless
    and a large gain is safe — beta must be able to fall an order of
    magnitude within the burn-in for concentrated high-dimensional
    posteriors (the Darcy bench posterior wants beta ~ 0.02 from a 0.3
    start)."""
    logit = jnp.log(beta) - jnp.log1p(-beta)
    gamma = rate / jnp.sqrt(1.0 + 0.1 * step)
    new = logit + gamma * (acc_mean - target)
    new_beta = 1.0 / (1.0 + jnp.exp(-new))
    return jnp.where(step < burn, new_beta, beta)


def run_pcn(loglik_qoi: Callable, d: int, n_steps: int, n_chains: int = 32,
            beta: float = 0.3, key=None, burn: Optional[int] = None,
            thin: int = 1, adapt: bool = True, theta0=None,
            dtype=None) -> ChainResult:
    """Run B parallel pCN chains targeting ``prior N(0,I_d) x likelihood``.

    :param loglik_qoi: ``theta [d] -> (loglik scalar, qoi [q])`` pure-jnp
        (vmapped over the chain batch inside the scan).
    :param d: latent dimension.
    :param burn: burn-in steps discarded from the series (default
        ``n_steps // 3``); beta adaptation runs only during burn-in.
    :param theta0: optional [B, d] initial states (default: prior draws).
    :return: :class:`ChainResult`.
    """
    if key is None:
        key = jax.random.key(0)
    if burn is None:
        burn = n_steps // 3
    dtype = dtype or jnp.asarray(1.0).dtype
    batch_ll = jax.vmap(loglik_qoi)

    k_init, k_run = jax.random.split(key)
    if theta0 is None:
        theta0 = jax.random.normal(k_init, (n_chains, d), dtype=dtype)
    theta0 = jnp.asarray(theta0, dtype)

    def step_fn(carry, step):
        theta, ll, qoi, beta_c, acc_sum = carry
        kp = jax.random.fold_in(k_run, step)
        k_xi, k_u = jax.random.split(kp)
        xi = jax.random.normal(k_xi, theta.shape, dtype)
        prop = _pcn_propose(theta, xi, beta_c)
        ll_p, qoi_p = batch_ll(prop)
        log_u = jnp.log(jax.random.uniform(
            k_u, (theta.shape[0],), dtype, minval=jnp.finfo(dtype).tiny))
        accept = log_u < (ll_p - ll)
        theta = jnp.where(accept[:, None], prop, theta)
        ll = jnp.where(accept, ll_p, ll)
        qoi = jnp.where(accept[:, None], qoi_p, qoi)
        acc_mean = jnp.mean(accept.astype(dtype))
        if adapt:
            beta_c = _rm_beta(beta_c, acc_mean, step, burn)
        return ((theta, ll, qoi, beta_c, acc_sum + acc_mean),
                (qoi, acc_mean))

    ll0, qoi0 = batch_ll(theta0)
    carry0 = (theta0, ll0, qoi0, jnp.asarray(beta, dtype),
              jnp.zeros((), dtype))

    @jax.jit
    def run(carry0):
        return jax.lax.scan(step_fn, carry0, jnp.arange(n_steps))

    (theta, ll, _, beta_f, acc_sum), (qoi_series, _) = run(carry0)
    qoi_np, acc_np, beta_np, theta_np, ll_np = jax.device_get(
        (qoi_series, acc_sum, beta_f, theta, ll))
    post = qoi_np[burn::thin]
    return ChainResult(np.asarray(post), acc_np / n_steps, beta_np,
                       theta_np, ll_np, n_forward=n_steps * n_chains)


# ---------------------------------------------------------------------- #
# two-level coupled kernel (Dodwell et al. Alg. 3)
# ---------------------------------------------------------------------- #
class CoupledResult:
    """Output of :func:`run_coupled`.

    ``diff`` [n_out, B, q] per-step coupled differences
    ``Q_f(theta^f) - Q_c(theta^c)``; ``mean``/``se`` across-chain CLT on
    the difference; ``acc_rate`` fine-chain acceptance;
    ``acc_rate_coarse`` the coarse chain's (crn) / sub-chain's (dodwell)
    acceptance; ``mismatch_rate`` the fraction of steps on which exactly
    one of the two crn chains accepted (the coupling's only decohering
    events; equals the dodwell fine-rejection rate ``1-acc_rate`` there);
    ``glued_rate`` the fraction of (step, chain) pairs whose two states
    were exactly equal (crn mode; None for dodwell);
    ``qoi_f``/``qoi_c`` the two marginal series (each under its own
    level posterior)."""

    glued_rate = None

    def __init__(self, qoi_f, qoi_c, acc_rate, acc_rate_coarse, beta,
                 mismatch_rate, n_forward_f, n_forward_c):
        self.qoi_f = qoi_f
        self.qoi_c = qoi_c
        self.diff = qoi_f - qoi_c
        self.acc_rate = float(acc_rate)
        self.acc_rate_coarse = float(acc_rate_coarse)
        self.beta = float(beta)
        self.mismatch_rate = float(mismatch_rate)
        self.n_forward_f = int(n_forward_f)
        self.n_forward_c = int(n_forward_c)
        chain_means = self.diff.mean(axis=0)         # [B, q]
        self.mean = chain_means.mean(axis=0)
        B = self.diff.shape[1]
        self.se = chain_means.std(axis=0, ddof=1) / np.sqrt(B)
        self.ess = ess(self.diff[:, :, 0])
        self.rhat = split_rhat(self.diff[:, :, 0])


def run_coupled(loglik_qoi_f: Callable, loglik_qoi_c: Callable, d: int,
                n_steps: int, n_chains: int = 32, beta: float = 0.3,
                subsample: int = 4, key=None, burn: Optional[int] = None,
                thin: int = 1, adapt: bool = True, theta0=None,
                mode: str = "crn", dtype=None) -> CoupledResult:
    """Coupled two-level chain estimating ``E_f[Q_f] - E_c[Q_c]``.

    ``mode="crn"`` (default): both chains take a pCN step EVERY outer
    step from the SAME innovation ``xi`` and the SAME acceptance uniform
    — each marginal is an exact pCN chain (unbiased), and the shared
    noise keeps the pair contracted (module docstring). One fine and one
    coarse forward solve per chain per step; ``subsample`` is ignored.

    ``mode="dodwell"``: the literature algorithm — a free-running coarse
    chain advanced ``subsample`` sub-steps per outer step feeds the fine
    chain's proposals; biased O(rho^subsample) at finite subsampling
    (module docstring). One fine + ``subsample`` coarse solves per step.

    With identical level likelihoods both modes are exact fixed points:
    the coupled difference is identically zero (crn: chains share init
    and every decision; dodwell: every proposal is accepted) — the
    fixed-point test in tests/test_mcmc.py.
    """
    if mode not in ("crn", "dodwell"):
        raise ValueError("mode must be 'crn' or 'dodwell'")
    if key is None:
        key = jax.random.key(0)
    if burn is None:
        burn = n_steps // 3
    dtype = dtype or jnp.asarray(1.0).dtype
    batch_f = jax.vmap(loglik_qoi_f)
    batch_c = jax.vmap(loglik_qoi_c)

    k_init, k_run = jax.random.split(key)
    if theta0 is None:
        theta0 = jax.random.normal(k_init, (n_chains, d), dtype=dtype)
    theta0 = jnp.asarray(theta0, dtype)

    if mode == "crn":
        return _run_coupled_crn(batch_f, batch_c, theta0, n_steps, beta,
                                k_run, burn, thin, adapt, dtype)

    def sub_step(carry, k):
        theta, ll, qoi, beta_c = carry
        k_xi, k_u = jax.random.split(k)
        xi = jax.random.normal(k_xi, theta.shape, dtype)
        prop = _pcn_propose(theta, xi, beta_c)
        ll_p, qoi_p = batch_c(prop)
        log_u = jnp.log(jax.random.uniform(
            k_u, (theta.shape[0],), dtype, minval=jnp.finfo(dtype).tiny))
        accept = log_u < (ll_p - ll)
        theta = jnp.where(accept[:, None], prop, theta)
        ll = jnp.where(accept, ll_p, ll)
        qoi = jnp.where(accept[:, None], qoi_p, qoi)
        return ((theta, ll, qoi, beta_c),
                jnp.mean(accept.astype(dtype)))

    def step_fn(carry, step):
        (th_c, ll_c, qoi_c,            # coarse chain (targets pi_c)
         th_f, ll_fc, ll_ff, qoi_f,    # fine chain + its ll under BOTH levels
         beta_c, acc_sum, acc_sub_sum) = carry
        kp = jax.random.fold_in(k_run, step)
        k_sub, k_u = jax.random.split(kp)
        # advance the coarse chain `subsample` sub-steps
        (th_c, ll_c, qoi_c, _), accs = jax.lax.scan(
            sub_step, (th_c, ll_c, qoi_c, beta_c),
            jax.random.split(k_sub, subsample))
        # offer the coarse state to the fine chain
        ll_pf, qoi_pf = batch_f(th_c)
        log_alpha = (ll_pf - ll_ff) - (ll_c - ll_fc)
        log_u = jnp.log(jax.random.uniform(
            k_u, (th_f.shape[0],), dtype, minval=jnp.finfo(dtype).tiny))
        accept = log_u < log_alpha
        th_f = jnp.where(accept[:, None], th_c, th_f)
        ll_ff = jnp.where(accept, ll_pf, ll_ff)
        ll_fc = jnp.where(accept, ll_c, ll_fc)
        qoi_f = jnp.where(accept[:, None], qoi_pf, qoi_f)
        acc_mean = jnp.mean(accept.astype(dtype))
        if adapt:
            beta_c = _rm_beta(beta_c, jnp.mean(accs), step, burn)
        return ((th_c, ll_c, qoi_c, th_f, ll_fc, ll_ff, qoi_f, beta_c,
                 acc_sum + acc_mean, acc_sub_sum + jnp.mean(accs)),
                (qoi_f, qoi_c))

    ll_c0, qoi_c0 = batch_c(theta0)
    ll_f0, qoi_f0 = batch_f(theta0)
    carry0 = (theta0, ll_c0, qoi_c0, theta0, ll_c0, ll_f0, qoi_f0,
              jnp.asarray(beta, dtype), jnp.zeros((), dtype),
              jnp.zeros((), dtype))

    @jax.jit
    def run(carry0):
        return jax.lax.scan(step_fn, carry0, jnp.arange(n_steps))

    carry, (qf_series, qc_series) = run(carry0)
    beta_f, acc_sum, acc_sub = carry[7], carry[8], carry[9]
    qf_np, qc_np, acc_np, accs_np, beta_np = jax.device_get(
        (qf_series, qc_series, acc_sum, acc_sub, beta_f))
    n_chains = theta0.shape[0]
    return CoupledResult(
        np.asarray(qf_np[burn::thin]), np.asarray(qc_np[burn::thin]),
        acc_np / n_steps, accs_np / n_steps, beta_np,
        mismatch_rate=1.0 - acc_np / n_steps,
        n_forward_f=n_steps * n_chains,
        n_forward_c=n_steps * subsample * n_chains)


def _run_coupled_crn(batch_f, batch_c, theta0, n_steps, beta, k_run,
                     burn, thin, adapt, dtype):
    """Reflection-maximal coupling of two exact pCN chains with a shared
    acceptance uniform (see run_coupled). Per step and chain:

    * fine proposal ``prop_f = s th_f + beta xi``, ``xi ~ N(0, I)``;
    * with the maximal-coupling probability
      ``min(1, N(prop_f; s th_c, beta^2) / N(prop_f; s th_f, beta^2))``
      the coarse proposal IS ``prop_f`` (chains can meet exactly);
      otherwise ``prop_c = s th_c + beta R xi`` with ``R`` the
      Householder reflection across the gap direction
      ``e = s(th_f - th_c)/|...|`` — the rejected-overlap residual, so
      the coarse proposal's marginal is exactly N(s th_c, beta^2 I);
    * both chains accept against the SAME uniform.

    Chains that have met (``th_f == th_c``) take the met branch with
    probability one (the log ratio is 0) and separate only on an
    accept/reject mismatch."""
    B = theta0.shape[0]

    def step_fn(carry, step):
        (th_f, ll_f, qoi_f, th_c, ll_c, qoi_c,
         beta_c, acc_f_sum, acc_c_sum, mis_sum, met_sum) = carry
        kp = jax.random.fold_in(k_run, step)
        k_xi, k_u, k_w = jax.random.split(kp, 3)
        xi = jax.random.normal(k_xi, th_f.shape, dtype)          # shared
        log_u = jnp.log(jax.random.uniform(
            k_u, (B,), dtype, minval=jnp.finfo(dtype).tiny))     # shared
        s = jnp.sqrt(1.0 - beta_c * beta_c)
        prop_f = s * th_f + beta_c * xi
        # maximal coupling: log N(prop_f; s th_c) - log N(prop_f; s th_f)
        #   = (|beta xi|^2 - |beta xi + z|^2) / (2 beta^2),  z = s(th_f-th_c)
        z = s * (th_f - th_c)                                    # [B, d]
        bxi = beta_c * xi
        log_ratio = (jnp.sum(bxi * bxi, axis=1)
                     - jnp.sum((bxi + z) ** 2, axis=1)) / (2 * beta_c ** 2)
        log_w = jnp.log(jax.random.uniform(
            k_w, (B,), dtype, minval=jnp.finfo(dtype).tiny))
        met = log_w < log_ratio                                  # [B]
        # reflection residual: xi' = xi - 2 (xi . e) e across the gap
        z_norm = jnp.sqrt(jnp.sum(z * z, axis=1, keepdims=True))
        e = z / jnp.where(z_norm > 0, z_norm, 1.0)
        xi_refl = xi - 2.0 * jnp.sum(xi * e, axis=1, keepdims=True) * e
        prop_c = jnp.where(met[:, None], prop_f,
                           s * th_c + beta_c * xi_refl)
        ll_pf, qoi_pf = batch_f(prop_f)
        ll_pc, qoi_pc = batch_c(prop_c)
        acc_f = log_u < (ll_pf - ll_f)
        acc_c = log_u < (ll_pc - ll_c)
        th_f = jnp.where(acc_f[:, None], prop_f, th_f)
        ll_f = jnp.where(acc_f, ll_pf, ll_f)
        qoi_f = jnp.where(acc_f[:, None], qoi_pf, qoi_f)
        th_c = jnp.where(acc_c[:, None], prop_c, th_c)
        ll_c = jnp.where(acc_c, ll_pc, ll_c)
        qoi_c = jnp.where(acc_c[:, None], qoi_pc, qoi_c)
        acc_fm = jnp.mean(acc_f.astype(dtype))
        acc_cm = jnp.mean(acc_c.astype(dtype))
        mis = jnp.mean((acc_f ^ acc_c).astype(dtype))
        glued = jnp.mean(jnp.all(th_f == th_c, axis=1).astype(dtype))
        if adapt:
            beta_c = _rm_beta(beta_c, 0.5 * (acc_fm + acc_cm), step, burn)
        return ((th_f, ll_f, qoi_f, th_c, ll_c, qoi_c, beta_c,
                 acc_f_sum + acc_fm, acc_c_sum + acc_cm, mis_sum + mis,
                 met_sum + glued),
                (qoi_f, qoi_c))

    ll_f0, qoi_f0 = batch_f(theta0)
    ll_c0, qoi_c0 = batch_c(theta0)
    z0 = jnp.zeros((), dtype)
    carry0 = (theta0, ll_f0, qoi_f0, theta0, ll_c0, qoi_c0,
              jnp.asarray(beta, dtype), z0, z0, z0, z0)

    @jax.jit
    def run(carry0):
        return jax.lax.scan(step_fn, carry0, jnp.arange(n_steps))

    carry, (qf_series, qc_series) = run(carry0)
    beta_f, acc_f_sum, acc_c_sum, mis_sum, met_sum = carry[6:11]
    qf_np, qc_np, af, ac, mis, met, beta_np = jax.device_get(
        (qf_series, qc_series, acc_f_sum, acc_c_sum, mis_sum, met_sum,
         beta_f))
    res = CoupledResult(
        np.asarray(qf_np[burn::thin]), np.asarray(qc_np[burn::thin]),
        af / n_steps, ac / n_steps, beta_np, mismatch_rate=mis / n_steps,
        n_forward_f=n_steps * B, n_forward_c=n_steps * B)
    res.glued_rate = float(met / n_steps)
    return res


# ---------------------------------------------------------------------- #
# Unbiased MCMC: coupled-pair debiasing (Jacob-O'Leary-Atchade 2020)
# ---------------------------------------------------------------------- #
def run_unbiased(loglik_qoi: Callable, d: int, k: int = 50,
                 m: Optional[int] = None, n_pairs: int = 64,
                 beta: float = 0.3, n_max: Optional[int] = None,
                 key=None, theta0_sampler: Optional[Callable] = None,
                 dtype=None):
    """COMPLETELY unbiased posterior expectations by coupled-chain
    debiasing (Jacob, O'Leary & Atchade, JRSS-B 82, 2020): a lag-1 pair
    of pCN chains (X_t, Y_{t-1}) of the SAME kernel, joined by the
    reflection-maximal proposal coupling + a shared acceptance uniform,
    meets exactly at a random time tau and stays glued; the
    time-averaged estimator

        H = mean_{t=k..m} Q(X_t)
            + sum_{t=k+1..tau-1} min(1, (t-k)/(m-k+1)) (Q(X_t) - Q(Y_{t-1}))

    satisfies ``E[H] = E[Q | data]`` EXACTLY — no burn-in bias at ANY
    k, so estimation parallelizes across pairs instead of along one
    long chain (the device trade: ``n_pairs`` iid replicates advance in
    one jitted scan, and the across-pair CLT standard error is honest
    without any autocorrelation correction). Post-meeting correction
    terms vanish identically (glued chains), so the fixed-length scan
    only truncates pairs with ``tau > n_max`` — reported as
    ``frac_unmet`` and a loud warning in the result; pick k ~ a high
    quantile of the meeting times (run a pilot), m ~ 5k.

    The kernel must stay FIXED for unbiasedness, so there is no
    Robbins-Monro adaptation here — tune ``beta`` on a pilot
    :func:`run_pcn`.

    :param loglik_qoi: ``theta [d] -> (loglik, qoi [q])`` pure jnp.
    :param k / m: burn-in and averaging horizon (m defaults to 5k).
    :param n_max: scan length >= m (default ``m + 4 k``) — also the
        meeting-time truncation bound.
    :param theta0_sampler: ``key -> [n, d]`` initial draw (default
        N(0, I), the pCN prior).
    :return: dict with ``mean`` [q], ``se`` [q] (iid across-pair CLT),
        ``H`` [n_pairs, q] per-pair estimators, ``tau`` [n_pairs]
        meeting times, ``frac_unmet``, ``acc_rate``, ``n_forward``,
        ``wall_s``.
    """
    if key is None:
        key = jax.random.key(0)
    if m is None:
        m = 5 * k
    if n_max is None:
        n_max = m + 4 * k
    if not 1 <= k <= m or n_max < m:
        raise ValueError(f"need 1 <= k <= m <= n_max, got "
                         f"k={k}, m={m}, n_max={n_max}")
    if not 0.0 < beta < 1.0:
        raise ValueError("beta must be in (0, 1)")
    dtype = dtype or jnp.asarray(1.0).dtype
    batch = jax.vmap(loglik_qoi)
    B = int(n_pairs)
    k_x0, k_y0, k_pre, k_run = jax.random.split(key, 4)
    if theta0_sampler is None:
        theta0_sampler = lambda kk, n=B: jax.random.normal(
            kk, (n, d), dtype)
    x0 = jnp.asarray(theta0_sampler(k_x0), dtype)
    y0 = jnp.asarray(theta0_sampler(k_y0), dtype)
    beta_c = jnp.asarray(beta, dtype)
    s = jnp.sqrt(1.0 - beta_c * beta_c)
    kk, mm = float(k), float(m)

    def pcn_step(th, ll, q, kstep):
        k_xi, k_u = jax.random.split(kstep)
        xi = jax.random.normal(k_xi, th.shape, dtype)
        prop = s * th + beta_c * xi
        ll_p, q_p = batch(prop)
        log_u = jnp.log(jax.random.uniform(
            k_u, (th.shape[0],), dtype, minval=jnp.finfo(dtype).tiny))
        acc = log_u < (ll_p - ll)
        return (jnp.where(acc[:, None], prop, th),
                jnp.where(acc, ll_p, ll),
                jnp.where(acc[:, None], q_p, q))

    def coupled_step(x, llx, qx, y, lly, qy, kstep):
        """(X_t, Y_{t-1}) -> (X_{t+1}, Y_t): reflection-maximal
        proposal coupling + shared acceptance uniform (same
        construction as _run_coupled_crn, same target both chains)."""
        k_xi, k_u, k_w = jax.random.split(kstep, 3)
        xi = jax.random.normal(k_xi, x.shape, dtype)
        log_u = jnp.log(jax.random.uniform(
            k_u, (B,), dtype, minval=jnp.finfo(dtype).tiny))
        prop_x = s * x + beta_c * xi
        z = s * (x - y)
        bxi = beta_c * xi
        log_ratio = (jnp.sum(bxi * bxi, axis=1)
                     - jnp.sum((bxi + z) ** 2, axis=1)) / (
                         2 * beta_c ** 2)
        log_w = jnp.log(jax.random.uniform(
            k_w, (B,), dtype, minval=jnp.finfo(dtype).tiny))
        prop_met = log_w < log_ratio
        z_norm = jnp.sqrt(jnp.sum(z * z, axis=1, keepdims=True))
        e = z / jnp.where(z_norm > 0, z_norm, 1.0)
        xi_refl = xi - 2.0 * jnp.sum(xi * e, axis=1, keepdims=True) * e
        prop_y = jnp.where(prop_met[:, None], prop_x,
                           s * y + beta_c * xi_refl)
        ll_px, q_px = batch(prop_x)
        ll_py, q_py = batch(prop_y)
        acc_x = log_u < (ll_px - llx)
        acc_y = log_u < (ll_py - lly)
        x = jnp.where(acc_x[:, None], prop_x, x)
        llx = jnp.where(acc_x, ll_px, llx)
        qx = jnp.where(acc_x[:, None], q_px, qx)
        y = jnp.where(acc_y[:, None], prop_y, y)
        lly = jnp.where(acc_y, ll_py, lly)
        qy = jnp.where(acc_y[:, None], q_py, qy)
        return x, llx, qx, y, lly, qy, jnp.mean(acc_x.astype(dtype))

    @jax.jit
    def run(x0, y0):
        llx, qx = batch(x0)
        y = y0
        lly, qy = batch(y)
        # X takes one solo step: the pair is (X_1, Y_0) entering t=1
        x, llx, qx = pcn_step(x0, llx, qx, k_pre)
        q_dim = qx.shape[1]
        zs = jnp.zeros((B, q_dim), dtype)

        def body(carry, t):
            x, llx, qx, y, lly, qy, S, BC, tau, acc = carry
            # accumulate AT time t using (X_t, Y_{t-1})
            in_avg = (t >= kk) & (t <= mm)
            S = S + jnp.where(in_avg, 1.0, 0.0) * qx
            wgt = jnp.minimum(1.0, (t - kk) / (mm - kk + 1.0))
            wgt = jnp.where(t >= kk + 1.0, wgt, 0.0)
            BC = BC + wgt * (qx - qy)
            glued = jnp.all(x == y, axis=1)
            tau = jnp.where((tau < 0) & glued, t, tau)
            x, llx, qx, y, lly, qy, a = coupled_step(
                x, llx, qx, y, lly, qy,
                jax.random.fold_in(k_run, t.astype(jnp.int32)))
            return (x, llx, qx, y, lly, qy, S, BC, tau, acc + a), None

        tau0 = jnp.full((B,), -1.0, dtype)
        (x, llx, qx, y, lly, qy, S, BC, tau, acc), _ = jax.lax.scan(
            body, (x, llx, qx, y, lly, qy, zs, zs, tau0,
                   jnp.zeros((), dtype)),
            jnp.arange(1, n_max + 1, dtype=dtype))
        # the t = n_max state never accumulated; close the window
        t_end = jnp.asarray(float(n_max + 1), dtype)
        S = S + jnp.where((t_end >= kk) & (t_end <= mm), 1.0, 0.0) * qx
        BC = BC + jnp.minimum(1.0, (t_end - kk) / (mm - kk + 1.0)) * (
            qx - qy)
        glued = jnp.all(x == y, axis=1)
        tau = jnp.where((tau < 0) & glued, t_end, tau)
        H = S / (mm - kk + 1.0) + BC
        return H, tau, acc / n_max

    t0 = time.perf_counter()
    H, tau, acc = jax.device_get(run(x0, y0))
    wall = time.perf_counter() - t0
    H = np.asarray(H, np.float64)
    tau = np.asarray(tau, np.float64)
    unmet = tau < 0
    if np.any(unmet):
        import warnings
        warnings.warn(
            f"{int(unmet.sum())}/{B} chain pairs did not meet within "
            f"n_max={n_max}; the estimator is truncation-biased — "
            "raise n_max or beta-tune on a pilot", RuntimeWarning)
    return {"mean": H.mean(axis=0),
            "se": H.std(axis=0, ddof=1) / np.sqrt(B),
            "H": H, "tau": tau, "frac_unmet": float(unmet.mean()),
            "acc_rate": float(acc),
            "n_forward": B * (2 * n_max + 3),
            "wall_s": wall}


# ---------------------------------------------------------------------- #
# MLDA: multilevel delayed acceptance (exact fine-posterior SAMPLER)
# ---------------------------------------------------------------------- #
def run_mlda(loglik_qoi_fns: Sequence[Callable], d: int, n_steps: int,
             n_chains: int = 32, subsamples=4, beta: float = 0.3,
             key=None, burn: Optional[int] = None, thin: int = 1,
             theta0=None, dtype=None) -> ChainResult:
    """Multilevel delayed acceptance: EXACT sampling of the FINEST
    posterior with most proposals screened by the coarse hierarchy
    (Lykkegaard, Dodwell et al., "Multilevel delayed acceptance MCMC",
    SIAM/ASA JUQ 11, 2023; two-level idea: Christen & Fox 2005).

    The level-l proposal is the end state of a level-(l-1) MLDA
    sub-chain of ``subsamples[l-1]`` steps STARTED AT THE CURRENT
    level-l state (recursion bottoms at pCN on level 0). Because each
    sub-chain kernel is reversible w.r.t. its own posterior, its t-step
    power is self-adjoint too, and the proposal density cancels in the
    Metropolis-Hastings ratio leaving only the two likelihood
    differences — the fine marginal is EXACTLY invariant at ANY
    subsampling (unlike the free-running Dodwell coarse chain, see
    run_coupled mode='dodwell'). Complements MLMCMC: MLMCMC telescopes
    posterior EXPECTATIONS across levels; MLDA produces exact
    fine-posterior SAMPLES (for densities, credible sets) while paying
    only ~acc_rate of the naive fine-solve count per effective sample.

    Whole-hierarchy chains advance batched [B, d] inside one jitted
    nested-scan program; step sizes are NOT adapted (the nested
    structure makes per-level Robbins-Monro ambiguous — tune beta on a
    level-0 pilot via run_pcn instead).

    :param subsamples: int or per-correction list (length L-1 for L
        levels): sub-chain length feeding each level above the first.
    :return: :class:`ChainResult` for the finest level (its ``qoi``
        series / mean / se / diagnostics all target pi_L; ``acc_rate``
        is the TOP-level acceptance).
    """
    L = len(loglik_qoi_fns)
    if L < 2:
        raise ValueError("MLDA needs at least two levels")
    if np.isscalar(subsamples):
        subsamples = [int(subsamples)] * (L - 1)
    if len(subsamples) != L - 1:
        raise ValueError("subsamples must be scalar or one per correction")
    if key is None:
        key = jax.random.key(0)
    if burn is None:
        burn = n_steps // 3
    dtype = dtype or jnp.asarray(1.0).dtype
    batched = [jax.vmap(fn) for fn in loglik_qoi_fns]
    beta = jnp.asarray(beta, dtype)

    k_init, k_run = jax.random.split(key)
    if theta0 is None:
        theta0 = jax.random.normal(k_init, (n_chains, d), dtype=dtype)
    theta0 = jnp.asarray(theta0, dtype)
    B = theta0.shape[0]

    def _tiny_log_u(k):
        return jnp.log(jax.random.uniform(
            k, (B,), dtype, minval=jnp.finfo(dtype).tiny))

    # step_l(theta, lls[0..l], key) -> (theta', lls'), acc_mean
    # lls is a tuple of [B] log-likelihoods, all valid at theta.
    def make_step(level):
        if level == 0:
            def step0(theta, lls, k):
                k_xi, k_u = jax.random.split(k)
                xi = jax.random.normal(k_xi, theta.shape, dtype)
                prop = _pcn_propose(theta, xi, beta)
                ll_p, _ = batched[0](prop)
                accept = _tiny_log_u(k_u) < (ll_p - lls[0])
                theta = jnp.where(accept[:, None], prop, theta)
                return (theta, (jnp.where(accept, ll_p, lls[0]),)), \
                    jnp.mean(accept.astype(dtype))
            return step0

        sub = make_step(level - 1)
        t = subsamples[level - 1]

        def step_l(theta, lls, k):
            k_sub, k_u = jax.random.split(k)

            def body(carry, kk):
                th, sub_lls = carry
                (th, sub_lls), acc = sub(th, sub_lls, kk)
                return (th, sub_lls), acc

            (prop, sub_end), _ = jax.lax.scan(
                body, (theta, lls[:level]), jax.random.split(k_sub, t))
            ll_p, qoi_p = batched[level](prop)
            # proposal kernel is pi_{l-1}-reversible => MH ratio:
            log_alpha = (ll_p - lls[level]) - (sub_end[-1] - lls[level - 1])
            accept = _tiny_log_u(k_u) < log_alpha
            theta = jnp.where(accept[:, None], prop, theta)
            new_lls = tuple(
                jnp.where(accept, se, old)
                for se, old in zip(sub_end, lls[:level])
            ) + (jnp.where(accept, ll_p, lls[level]),)
            return (theta, new_lls), (accept, qoi_p)
        return step_l

    top = make_step(L - 1)

    def outer(carry, step):
        theta, lls, qoi, acc_sum = carry
        k = jax.random.fold_in(k_run, step)
        (theta, lls), (accept, qoi_p) = top(theta, lls, k)
        qoi = jnp.where(accept[:, None], qoi_p, qoi)
        acc = jnp.mean(accept.astype(dtype))
        return (theta, lls, qoi, acc_sum + acc), qoi

    lls0 = tuple(b(theta0)[0] for b in batched)
    qoi0 = batched[-1](theta0)[1]
    carry0 = (theta0, lls0, qoi0, jnp.zeros((), dtype))

    @jax.jit
    def run(carry0):
        return jax.lax.scan(outer, carry0, jnp.arange(n_steps))

    (theta, lls, _, acc_sum), qoi_series = run(carry0)
    qoi_np, acc_np, theta_np, ll_np = jax.device_get(
        (qoi_series[burn::thin], acc_sum, theta, lls[-1]))
    n_sub = int(np.prod([1] + list(subsamples)))
    return ChainResult(np.asarray(qoi_np), acc_np / n_steps, float(beta),
                       theta_np, ll_np,
                       n_forward=n_steps * n_chains * (1 + n_sub))


# ---------------------------------------------------------------------- #
# the multilevel driver
# ---------------------------------------------------------------------- #
class MLMCMC:
    """Multilevel MCMC estimator of a posterior expectation.

    :param loglik_qoi_fns: one ``theta [d] -> (loglik, qoi [q])`` per
        level, coarsest first, all sharing the SAME latent theta
        parametrization (resolution-independent coordinates — e.g. RFF
        mode weights — exactly as the forward-MLMC couplings share keys).
    :param d: latent dimension.

    ``run`` estimates ``E_{pi_L}[Q_L]`` by the telescoped sum of a plain
    pCN chain on level 0 plus one coupled chain per correction; the
    standard error combines the independent across-chain CLT errors of
    the L+1 terms in quadrature.
    """

    def __init__(self, loglik_qoi_fns: Sequence[Callable], d: int,
                 subsample: int = 4, beta: float = 0.3,
                 mode: str = "crn"):
        if len(loglik_qoi_fns) < 1:
            raise ValueError("need at least one level")
        self.fns = list(loglik_qoi_fns)
        self.d = int(d)
        self.subsample = int(subsample)
        self.beta = float(beta)
        self.mode = mode

    def run(self, n_steps, n_chains=32, key=None, burn=None, thin=1,
            adapt=True, dtype=None):
        """:param n_steps: int or per-level list (coarser levels are
            cheaper — give them more steps, like MLMC allocation).
        :return: dict with ``mean`` [q], ``se`` [q], ``level_means``,
            ``level_ses``, ``results`` (the per-level Chain/Coupled
            result objects), ``acc_rates``, ``wall_s``."""
        if key is None:
            key = jax.random.key(7)
        L = len(self.fns)
        if np.isscalar(n_steps):
            n_steps = [int(n_steps)] * L
        if len(n_steps) != L:
            raise ValueError("n_steps must be scalar or one per level")
        keys = jax.random.split(key, L)
        t0 = time.perf_counter()
        results = [run_pcn(self.fns[0], self.d, n_steps[0],
                           n_chains=n_chains, beta=self.beta, key=keys[0],
                           burn=burn, thin=thin, adapt=adapt, dtype=dtype)]
        for l in range(1, L):
            results.append(run_coupled(
                self.fns[l], self.fns[l - 1], self.d, n_steps[l],
                n_chains=n_chains, beta=self.beta, mode=self.mode,
                subsample=self.subsample, key=keys[l], burn=burn,
                thin=thin, adapt=adapt, dtype=dtype))
        wall = time.perf_counter() - t0
        level_means = np.stack([r.mean for r in results])     # [L, q]
        level_ses = np.stack([r.se for r in results])
        return {
            "mean": level_means.sum(axis=0),
            "se": np.sqrt((level_ses ** 2).sum(axis=0)),
            "level_means": level_means,
            "level_ses": level_ses,
            "results": results,
            "acc_rates": [r.acc_rate for r in results],
            "wall_s": wall,
        }


# ---------------------------------------------------------------------- #
# forward-model adapters
# ---------------------------------------------------------------------- #
def gaussian_loglik(obs, data, noise_std):
    """Gaussian misfit ``-||data - obs||^2 / (2 noise^2)``."""
    r = (jnp.asarray(data) - obs) / noise_std
    return -0.5 * jnp.sum(r * r)


def make_darcy_inverse(level_ns: Sequence[int], n_modes: int = 32,
                       sigma: float = 1.0, corr_length: float = 0.2,
                       model: str = "gauss", obs_points=None,
                       noise_std: float = 0.02, modes_seed: int = 0):
    """Bayesian Darcy inversion: infer the log-conductivity field from
    noisy pressure observations (the inverse of the cond_field workflow,
    reference mlmc/tool/flow_mc.py:91-455 — which the reference can only
    run FORWARD).

    Latent parametrization: theta [2M] are the random-Fourier-feature
    weights ``G(x) = sqrt(1/M) sum_m theta_c[m] cos(k_m x) +
    theta_s[m] sin(k_m x)`` — an exact standard-Gaussian prior on theta
    induces the stationary GRF (resolution-independent: every level sees
    the same field realization for the same theta, the same coupling
    trick as DiffusionSimulation's shared phases). Conductivity
    ``K = exp(sigma G)``; pressure solves reuse DiffusionSimulation's
    spectral-preconditioned CG; observations are bilinear interpolations
    of cell-center pressures at ``obs_points``.

    :param level_ns: grid sizes per level, coarsest first (e.g.
        ``[8, 16, 32]``).
    :return: dict with ``loglik_qoi_fns(data)`` (builds the per-level
        MLMCMC functions for observed data), ``forward(theta, n)`` ->
        (obs [K], flux), ``d``, ``synthetic(key, theta_true=None)`` ->
        (theta_true, clean_obs, noisy_data).
    """
    from mlmc_tpu.sim.diffusion import DiffusionSimulation, _wave_vectors_2d

    if obs_points is None:
        g = np.linspace(0.2, 0.8, 3)
        obs_points = np.array([[x, y] for x in g for y in g])
    obs_points = jnp.asarray(np.asarray(obs_points, dtype=float))
    k_vec = _wave_vectors_2d(model, corr_length, n_modes, seed=modes_seed)
    d = 2 * n_modes
    solve_cfg = {"precond": "spectral"}

    def _field(theta, n):
        h = 1.0 / n
        centers = (jnp.arange(n) + 0.5) * h
        X, Y = jnp.meshgrid(centers, centers, indexing="ij")
        pts = jnp.stack([X.ravel(), Y.ravel()], axis=1)       # [n*n, 2]
        ang = pts @ jnp.asarray(k_vec, theta.dtype).T         # [n*n, M]
        th_c, th_s = theta[:n_modes], theta[n_modes:]
        g = (jnp.cos(ang) @ th_c + jnp.sin(ang) @ th_s) / np.sqrt(n_modes)
        return jnp.exp(sigma * g).reshape(n, n)

    def _observe(p, n):
        """Bilinear interpolation of cell-center pressures at obs_points
        (centers at (i+1/2)/n; clamped to the center hull)."""
        h = 1.0 / n
        # fractional index into the center grid
        fi = jnp.clip(obs_points / h - 0.5, 0.0, n - 1.0)
        i0 = jnp.clip(jnp.floor(fi).astype(jnp.int32), 0, n - 2)
        w = fi - i0
        ix, iy = i0[:, 0], i0[:, 1]
        wx, wy = w[:, 0], w[:, 1]
        p00 = p[ix, iy]
        p10 = p[ix + 1, iy]
        p01 = p[ix, iy + 1]
        p11 = p[ix + 1, iy + 1]
        return ((1 - wx) * (1 - wy) * p00 + wx * (1 - wy) * p10
                + (1 - wx) * wy * p01 + wx * wy * p11)

    def forward(theta, n):
        K = _field(theta, n)
        p = DiffusionSimulation._solve_pressure(solve_cfg, K)
        flux = jnp.sum(2.0 * K[:, -1] * p[:, -1])
        return _observe(p, n), flux

    def loglik_qoi_fns(data):
        fns = []
        for n in level_ns:
            def fn(theta, n=n):
                obs, flux = forward(theta, n)
                return gaussian_loglik(obs, data, noise_std), flux[None]
            fns.append(fn)
        return fns

    def synthetic(key, theta_true=None):
        k_th, k_noise = jax.random.split(jax.random.key(key)
                                         if np.isscalar(key) else key)
        if theta_true is None:
            theta_true = jax.random.normal(k_th, (d,))
        obs, _ = forward(theta_true, level_ns[-1])
        noise = noise_std * jax.random.normal(k_noise, obs.shape, obs.dtype)
        return (np.asarray(theta_true), np.asarray(obs),
                np.asarray(obs + noise))

    return {"loglik_qoi_fns": loglik_qoi_fns, "forward": forward,
            "observe_points": np.asarray(obs_points), "d": d,
            "synthetic": synthetic, "level_ns": list(level_ns)}
