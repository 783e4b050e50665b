"""Rough volatility: exact-Gaussian rBergomi MLMC — beyond-reference
tier (GeoMop/MLMC has no stochastic-volatility capability; this extends
the SDE family of mlmc_tpu/sim/sde.py to ROUGH, non-Markovian variance
dynamics under the same Simulation contract, reference
mlmc/sim/simulation.py:7-33).

The rBergomi model (Bayer, Friz & Gatheral, "Pricing under rough
volatility", Quant. Finance 16(6), 2016):

    v_t = xi0 * exp( eta * Y_t - eta^2/2 * t^(2H) ),
    dS  = S sqrt(v_t) ( rho dW + sqrt(1-rho^2) dZ ),

with ``Y_t = sqrt(2H) \\int_0^t (t-s)^(H-1/2) dW_s`` the
Riemann-Liouville fractional Brownian motion (``Var[Y_t] = t^(2H)``;
Hurst ``H ~ 0.05-0.2`` reproduces the observed roughness of realized
volatility). Y is NOT a semimartingale for ``H < 1/2`` — no Markovian
SDE scheme applies.

Device-first design — exact joint Gaussian by matmul: the vector
``(Y_{t_1..t_n}, DW_1..DW_n)`` is jointly Gaussian with closed-form
covariance (hypergeometric ``2F1`` for Cov[Y_s, Y_t], elementary powers
for Cov[Y_t, DW_j]); its Cholesky factor is built ONCE on host in f64
and every path batch is one ``[B, 2n] @ [2n, 2n]`` matmul — the heavy
op is exactly what matmul units are for, and the grid-time law of (Y, W) is
EXACT at any n (no kernel-discretization bias; the only bias left is
the Euler log-S step and the left-point freezing of v, both O(h)).

MLMC coupling by RESTRICTION: coarse grid times are a subset of fine
grid times, so the coarse path consumes the SAME Y values at its grid
times and the SUMS of the fine Brownian increments — the coarse
marginal is exactly the coarse-level scheme (zero telescope
distortion; the same argument as the jump coupling in sim/jumps.py)
while fine and coarse share every Gaussian draw.

MLMC rate, measured honestly: the remaining level difference is the
left-point freezing of v, whose within-step variation is Hölder-H —
coupled-correction variance decays at beta ~ 2H (measured ~2^-0.23
per level at the BFG H = 0.1, ~2^-0.9 at H = 0.4,
tests/test_rough.py). At very small H the telescope still converges
(beta > 0) and every level's GRID LAW is exact, so the bias being
telescoped is only the O(h) Euler/freezing weak error — but the
variance decay is slow; this is a property of rough dynamics, not of
the coupling (cf. Bayer-Friz-Gatheral §4 on the difficulty of
simulating rough models).

Validation anchors (tests/test_rough.py): Var[Y_t] = t^(2H) and the
2F1 covariance vs direct quadrature, E[v_t] = xi0 and
E[v_t^2] = xi0^2 exp(eta^2 t^(2H)) (lognormal moments), eta -> 0
degenerates to Black-Scholes, S-martingale identity, restriction
coupling exactness, coupled-variance decay.

No reference analogue; literature: Bayer-Friz-Gatheral (2016),
Bennedsen-Lunde-Pakkanen (Finance Stoch. 21, 2017) for simulation
schemes, McCrickerd & Pakkanen (2018) for the mixed/turbocharged
estimator (whose conditional-MC control is a possible later tier).
"""
import dataclasses
from typing import Callable, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.sim.simulation import Simulation
from mlmc_tpu.quantity.quantity_spec import QuantitySpec
from mlmc_tpu.level_simulation import LevelSimulation

__all__ = ["RBergomi", "rbergomi", "rl_fbm_cov", "rl_fbm_w_cov",
           "joint_cholesky", "joint_pca_factor",
           "coupled_rbergomi_paths", "rbergomi_qmc_level_fns",
           "RBergomiSimulation"]


@dataclasses.dataclass(frozen=True)
class RBergomi:
    """rBergomi parameters: flat forward variance ``xi0`` (i.e.
    ``E[v_t] = xi0``), vol-of-vol ``eta``, Hurst ``hurst``, spot/vol
    correlation ``rho``, spot ``s0``."""
    xi0: float = 0.235 ** 2
    eta: float = 1.9
    hurst: float = 0.1
    rho: float = -0.9
    s0: float = 1.0


def rbergomi(xi0=0.235 ** 2, eta=1.9, hurst=0.1, rho=-0.9, s0=1.0):
    """The Bayer-Friz-Gatheral calibration-shaped parameter set."""
    if not 0.0 < hurst < 1.0:
        raise ValueError("hurst must be in (0, 1)")
    if not -1.0 <= rho <= 1.0:
        raise ValueError("rho must be in [-1, 1]")
    return RBergomi(xi0=xi0, eta=eta, hurst=hurst, rho=rho, s0=s0)


def rl_fbm_cov(times, hurst):
    """Exact covariance of the Riemann-Liouville fBm at ``times``.

    For ``s <= t`` (Bayer-Friz-Gatheral eq. for the Volterra kernel):

        Cov[Y_s, Y_t] = 2H \\int_0^s (s-u)^(H-1/2) (t-u)^(H-1/2) du
                      = (2H s^(H+1/2) t^(H-1/2)) / (H+1/2)
                        * 2F1(1, 1/2-H; H+3/2; s/t),

    diagonal ``t^(2H)``. Host f64 (scipy hyp2f1); cross-checked
    against direct singularity-removing quadrature in the tests.
    """
    from scipy.special import hyp2f1
    t = np.asarray(times, np.float64)
    n = t.shape[0]
    H = float(hurst)
    g = H + 0.5
    C = np.empty((n, n))
    for i in range(n):
        s = t[i]
        tt = t[i:]
        C[i, i:] = (2.0 * H * s ** g * tt ** (H - 0.5) / g
                    * hyp2f1(1.0, 0.5 - H, H + 1.5, s / tt))
        C[i:, i] = C[i, i:]
        C[i, i] = s ** (2.0 * H)
    return C


def rl_fbm_w_cov(times, grid, hurst):
    """Exact ``Cov[Y_t, W_s] = sqrt(2H)/(H+1/2) (t^(H+1/2) -
    (t - min(s,t))^(H+1/2))`` assembled into increment covariances
    ``Cov[Y_{t_i}, DW_j]`` for the Brownian increments over ``grid``
    (``DW_j = W_{grid[j+1]} - W_{grid[j]}``)."""
    t = np.asarray(times, np.float64)[:, None]
    g = float(hurst) + 0.5

    def c(tv, sv):
        m = np.minimum(sv[None, :], tv)
        return np.sqrt(2.0 * float(hurst)) / g \
            * (tv ** g - (tv - m) ** g)

    grid = np.asarray(grid, np.float64)
    return c(t, grid[1:]) - c(t, grid[:-1])


def _joint_cov(n, total_time, hurst):
    """Joint covariance of ``(Y_{t_1..t_n}, DW_1..DW_n)`` on the
    uniform grid ``t_i = i T / n`` (host f64)."""
    T = float(total_time)
    times = T / n * np.arange(1, n + 1)
    grid = T / n * np.arange(0, n + 1)
    S = np.empty((2 * n, 2 * n))
    S[:n, :n] = rl_fbm_cov(times, hurst)
    S[:n, n:] = rl_fbm_w_cov(times, grid, hurst)
    S[n:, :n] = S[:n, n:].T
    S[n:, n:] = T / n * np.eye(n)
    return S, times


def joint_cholesky(n, total_time, hurst):
    """Cholesky factor (host f64, returned f64) of the joint
    (Y, DW) covariance — the one-time setup cost; every path batch is
    then a single ``[B, 2n] @ [2n, 2n]`` matmul."""
    S, times = _joint_cov(n, total_time, hurst)
    # tiny symmetric jitter guards the f64 factorization at large n
    w, _ = np.linalg.eigh(S)
    jitter = max(0.0, -w.min()) + 1e-14 * S.diagonal().max()
    return np.linalg.cholesky(S + jitter * np.eye(2 * n)), times


def joint_pca_factor(n, total_time, hurst):
    """PCA factor ``F = U sqrt(lam)`` (descending eigenvalues) of the
    joint (Y, DW) covariance — the same exact law as the Cholesky
    factor (``F F^T = S``), but the leading input dimensions carry the
    largest-variance directions, which is what makes Sobol' points
    effective (:func:`rbergomi_qmc_level_fns`)."""
    S, times = _joint_cov(n, total_time, hurst)
    w, U = np.linalg.eigh(S)
    w = np.clip(w[::-1], 0.0, None)
    return U[:, ::-1] * np.sqrt(w)[None, :], times


def coupled_rbergomi_paths(config, keys):
    """Integrate a coupled (fine, coarse) rBergomi level batch.

    :param config: dict with ``model`` (:class:`RBergomi`),
        ``total_time``, ``n_fine``, ``n_coarse`` (0 on level 0);
        optional ``dtype``. The Cholesky factor is computed at TRACE
        time (host, f64) and closed over as a constant.
    :param keys: [B] PRNG keys.
    :return: ``(s_fine [B], s_coarse [B] | None)`` terminal spots.
    """
    model = config["model"]
    if not isinstance(model, RBergomi):
        raise ValueError("model must be an RBergomi")
    T = float(config["total_time"])
    n_f = int(config["n_fine"])
    n_c = int(config["n_coarse"])
    is_l0 = n_c == 0
    m = 1 if is_l0 else n_f // n_c
    if not is_l0 and n_f != m * n_c:
        raise ValueError("n_fine=%d must be a multiple of n_coarse=%d"
                         % (n_f, n_c))
    dtype = jnp.dtype(config["dtype"]) if "dtype" in config \
        else jnp.result_type(float)
    L_np, times_np = joint_cholesky(n_f, T, model.hurst)
    B = keys.shape[0]
    h_f = T / n_f

    def draw(key):
        k1, k2 = jax.random.split(key)
        z = jax.random.normal(k1, (2 * n_f,), dtype)
        dz = jax.random.normal(k2, (n_f,), dtype) * np.sqrt(h_f)
        return z, dz

    z, dz = jax.vmap(draw)(keys)
    yw = jnp.matmul(z, jnp.asarray(L_np.T, dtype),
                    precision=jax.lax.Precision.HIGHEST)
    return _paths_from_gaussians(model, T, n_f, n_c, times_np, yw, dz,
                                 dtype)


def _paths_from_gaussians(model, T, n_f, n_c, times_np, yw, dz, dtype):
    """Shared integration core: ``yw [B, 2n]`` the CORRELATED (Y, DW)
    vector, ``dz [B, n]`` the orthogonal driver increments (already
    sqrt(h)-scaled). Used by both the PRNG path
    (:func:`coupled_rbergomi_paths`) and the Sobol' path
    (:func:`rbergomi_qmc_level_fns`)."""
    is_l0 = n_c == 0
    m = 1 if is_l0 else n_f // n_c
    B = yw.shape[0]
    h_f = T / n_f
    t2h = jnp.asarray(times_np ** (2.0 * model.hurst), dtype)
    eta = model.eta
    rho = model.rho
    rho_p = float(np.sqrt(max(1.0 - rho * rho, 0.0)))
    xi0 = model.xi0
    y, dw = yw[:, :n_f], yw[:, n_f:]             # [B, n], [B, n]

    def integrate(y_nodes, dws, dzs, h, t2h_nodes):
        """Euler log-S over one grid: v frozen at the LEFT node of
        each step (v at t=0 is xi0 — Y_0 = 0)."""
        v_nodes = xi0 * jnp.exp(eta * y_nodes
                                - 0.5 * eta * eta * t2h_nodes)
        v_left = jnp.concatenate(
            [jnp.full((B, 1), xi0, dtype), v_nodes[:, :-1]], axis=1)
        sq = jnp.sqrt(v_left)
        logs = jnp.sum(-0.5 * v_left * h
                       + sq * (rho * dws + rho_p * dzs), axis=1)
        return model.s0 * jnp.exp(logs)

    s_f = integrate(y, dw, dz, h_f, t2h[None, :])
    if is_l0:
        return s_f, None
    # restriction: coarse Y at coarse times, summed increments
    y_c = y[:, m - 1::m]
    dw_c = dw.reshape(B, n_c, m).sum(axis=2)
    dz_c = dz.reshape(B, n_c, m).sum(axis=2)
    s_c = integrate(y_c, dw_c, dz_c, h_f * m, t2h[None, m - 1::m])
    return s_f, s_c


def rbergomi_qmc_level_fns(model, total_time, levels, payoff,
                           dtype=None):
    """MLQMC level functions for rBergomi: per level the Sobol' point
    maps through ``[joint (Y, DW) PCA | Brownian-bridge dz]`` — the
    leading dimensions carry the largest-variance directions of the
    exact joint Gaussian (:func:`joint_pca_factor`) and the
    large-scale structure of the orthogonal driver, the classical
    recipe for low effective dimension. Same exact grid law and same
    restriction coupling as the PRNG path.

    :param levels: list of ``(n_fine, n_coarse)`` pairs (coarse 0 on
        level 0).
    :return: ``(level_fns, dims)`` for
        :class:`~mlmc_tpu.qmc.MLQMC` (``dims[l] = 3 n_fine``).
    """
    from mlmc_tpu.ops import sobol
    from mlmc_tpu.sim.sde import brownian_bridge_increments

    if not isinstance(model, RBergomi):
        raise ValueError("model must be an RBergomi")
    T = float(total_time)
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    fns, dims = [], []
    for n_f, n_c in levels:
        n_f, n_c = int(n_f), int(n_c)
        if n_c and (n_f % n_c or n_f <= n_c):
            raise ValueError("fine grid must refine the coarse grid "
                             "by an integer factor > 1")
        F, times_np = joint_pca_factor(n_f, T, model.hurst)
        Ft = jnp.asarray(F.T, dtype)
        Rb = jnp.asarray(
            brownian_bridge_increments(n_f).T * np.sqrt(T / n_f), dtype)

        def qfn(u, Ft=Ft, Rb=Rb, n_f=n_f, n_c=n_c, times_np=times_np):
            z = sobol.normals_from_uniforms(u).astype(dtype)
            hi = jax.lax.Precision.HIGHEST
            yw = jnp.matmul(z[:, :2 * n_f], Ft, precision=hi)
            dz = jnp.matmul(z[:, 2 * n_f:], Rb, precision=hi)
            s_f, s_c = _paths_from_gaussians(model, T, n_f, n_c,
                                             times_np, yw, dz, dtype)
            pf = payoff(s_f)
            return pf, (payoff(s_c) if s_c is not None
                        else jnp.zeros_like(pf))

        fns.append(qfn)
        dims.append(3 * n_f)
    return fns, dims


class RBergomiSimulation(Simulation):
    """rBergomi MLMC under the standard Simulation contract: level
    parameters are time steps ``[h]``, ``n_l = round(T / h_l)``, the
    coupling is the exact-Gaussian restriction, the stored QoI is
    ``payoff(S_T)`` (terminal spot by default).

    Config keys: ``model`` (:class:`RBergomi`, default
    :func:`rbergomi`), ``total_time`` (default 1.0), ``payoff``
    (callable ``s_T [B] -> [B]``, default identity).
    """

    def __init__(self, config=None):
        super().__init__()
        config = dict(config or {})
        config.setdefault("model", rbergomi())
        if not isinstance(config["model"], RBergomi):
            raise ValueError("model must be an RBergomi")
        config.setdefault("total_time", 1.0)
        config.setdefault("payoff", None)
        self.config = config
        self.need_workspace = False

    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]
                       ) -> LevelSimulation:
        T = float(self.config["total_time"])
        n_f = int(round(T / float(fine_level_params[0])))
        h_c = float(coarse_level_params[0])
        n_c = 0 if h_c == 0 else int(round(T / h_c))
        if n_f < 1 or (n_c and (n_f % n_c or n_f <= n_c)):
            raise ValueError(
                "fine step must refine the coarse step by an integer "
                "factor > 1 (got n_fine=%d, n_coarse=%d)" % (n_f, n_c))
        config = dict(self.config, n_fine=n_f, n_coarse=n_c,
                      res_format=self.result_format())
        return LevelSimulation(config_dict=config,
                               task_size=T / float(fine_level_params[0]),
                               nan_result_is_failure=False)

    @staticmethod
    def calculate_batch(config, keys, attempts=None):
        s_f, s_c = coupled_rbergomi_paths(config, keys)
        payoff = config.get("payoff") or (lambda s: s)
        fine = payoff(s_f)[:, None]
        coarse = jnp.zeros_like(fine) if s_c is None \
            else payoff(s_c)[:, None]
        return fine, coarse, jnp.zeros(fine.shape[0], dtype=bool)

    @staticmethod
    def calculate(config, seed):
        key = jax.random.key(np.uint32(seed))
        fine, coarse, _ = RBergomiSimulation.calculate_batch(
            config, key[None])
        return np.asarray(fine[0]), np.asarray(coarse[0])

    def result_format(self) -> List[QuantitySpec]:
        T = self.config["total_time"]
        return [QuantitySpec(name="payoff", unit="1", shape=(1,),
                             times=[T], locations=["-"])]
