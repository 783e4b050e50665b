"""SPDE MLMC: 1-D stochastic reaction-diffusion with space-time white
noise — beyond-reference tier (GeoMop/MLMC samples random FIELDS as PDE
coefficients but has no stochastic-PDE time-evolution capability; this
extends the PDE family of sim/diffusion*.py to noise-driven dynamics
under the same Simulation contract, reference
mlmc/sim/simulation.py:7-33).

The model on [0, 1] with homogeneous Dirichlet boundaries:

    du = ( nu u_xx + f(u) ) dt + sigma dW(t, x),

``W`` space-time white noise (function-valued solutions exist in d=1),
``f`` a pointwise reaction term (0 = stochastic heat equation;
``u - u^3`` = stochastic Allen-Cahn). Discretization: cell-centered
finite differences (N cells), SEMI-IMPLICIT Euler — the stiff Laplacian
is implicit and solved EXACTLY per step in its eigenbasis (the DST-II
rows ``sin(k pi (i+1/2)/N)`` diagonalize the cell-centered Dirichlet
Laplacian, cf. sim/diffusion.py:164), applied as a [B, N] x [N, N]
matmul — matmul work, unconditionally stable in the linear part; the
reaction term and the noise are explicit.

Noise: per cell-time box ``DW_i^n ~ N(0, dt/dx)`` (the L2-normalized
white-noise integral). MLMC couples levels by BOX AGGREGATION: the
coarse increment over an ``(m_x dx) x (m_t dt)`` box is the SUM of its
fine sub-box increments divided by ``m_x`` — exactly the coarse-grid
white-noise draw (Gaussian additivity; zero coarse-marginal
distortion, the same structure as the jump/restriction couplings in
sim/jumps.py and sim/rough.py), while fine and coarse share every
noise increment. Refinement is anisotropic: level parameters are
``[dx, dt]`` pairs (parabolic scaling ``dt ~ dx^2`` keeps the weak
errors balanced; any integer pair of factors is accepted).

Validation anchors (tests/test_spde.py): the LINEAR scheme's discrete
law is EXACTLY Gaussian with a closed-form per-mode variance recursion
(:func:`discrete_heat_l2_moment` — pins the integrator with the
discretization bias removed), the continuum energy
``E||u(T)||^2 = sum_k sigma^2 (1 - e^(-2 nu lam_k T)) / (2 nu lam_k)``
(:func:`heat_spde_l2_moment` — the telescope target), coarse-marginal
exactness, coupled-variance decay, and the sigma -> 0 deterministic
Allen-Cahn limit against a fine reference solve.

No reference analogue; literature: Davie & Gaines (Math. Comp. 70,
2001) for the FD scheme, Giles & Reisinger (2012) and Barth, Lang &
Schwab (BIT 53, 2013) for multilevel SPDE coupling.
"""
import dataclasses
from typing import Callable, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.sim.simulation import Simulation
from mlmc_tpu.quantity.quantity_spec import QuantitySpec
from mlmc_tpu.level_simulation import LevelSimulation

__all__ = ["SPDE1D", "stochastic_heat", "allen_cahn",
           "coupled_spde_paths", "SPDESimulation",
           "heat_spde_l2_moment", "discrete_heat_l2_moment"]


@dataclasses.dataclass(frozen=True)
class SPDE1D:
    """``du = (nu u_xx + f(u)) dt + sigma dW`` on [0, 1], Dirichlet.

    :param nu: diffusivity.
    :param sigma: noise amplitude.
    :param reaction: pointwise jnp callable ``u -> f(u)`` or None.
    :param ic: initial condition callable ``x -> u0(x)`` or None (zero).
    """
    nu: float = 1.0
    sigma: float = 1.0
    reaction: Optional[Callable] = None
    ic: Optional[Callable] = None


def stochastic_heat(nu=1.0, sigma=1.0):
    """The additive-noise stochastic heat equation — the linear anchor
    with closed-form Gaussian laws at both the discrete and continuum
    levels."""
    return SPDE1D(nu=nu, sigma=sigma, reaction=None, ic=None)


def allen_cahn(nu=0.01, sigma=0.5, ic=None):
    """Stochastic Allen-Cahn ``f(u) = u - u^3`` — the standard
    nonlinear (bistable) SPDE test problem."""
    if ic is None:
        ic = lambda x: np.sin(np.pi * x)
    return SPDE1D(nu=nu, sigma=sigma,
                  reaction=lambda u: u - u ** 3, ic=ic)


def heat_spde_l2_moment(nu, sigma, T, n_terms=100_000):
    """Continuum ``E ||u(T)||_{L2}^2`` for the zero-IC stochastic heat
    equation: each sine mode is an exact OU process, so
    ``sum_k sigma^2 (1 - e^(-2 nu (k pi)^2 T)) / (2 nu (k pi)^2)``."""
    k = np.arange(1, n_terms + 1, dtype=np.float64)
    lam = (k * np.pi) ** 2
    return float(np.sum(sigma ** 2 * -np.expm1(-2.0 * nu * lam * T)
                        / (2.0 * nu * lam)))


def discrete_heat_l2_moment(nu, sigma, T, n_cells, n_steps):
    """EXACT ``E ||u(T)||^2 = dx E sum_i u_i^2`` of the semi-implicit
    zero-IC discrete scheme itself (no discretization allowance): in
    the DST-II eigenbasis each mode is an AR(1)
    ``a' = (a + eta) r_k`` with ``eta ~ N(0, sigma^2 dt/dx)`` iid and
    ``r_k = 1/(1 + dt nu lam_k)``, so after n steps
    ``Var = sigma^2 dt/dx * r^2 (1 - r^(2n)) / (1 - r^2)`` and
    Parseval gives ``E||u||^2 = dx sum_k Var_k``."""
    N, n = int(n_cells), int(n_steps)
    dx, dt = 1.0 / N, float(T) / n
    k = np.arange(1, N + 1, dtype=np.float64)
    lam = 4.0 * np.sin(k * np.pi / (2 * N)) ** 2 / dx ** 2
    r2 = 1.0 / (1.0 + dt * nu * lam) ** 2
    var = sigma ** 2 * dt / dx * r2 * (1.0 - r2 ** n) / (1.0 - r2)
    return float(dx * np.sum(var))


def _dst_basis(N):
    """Orthonormal DST-II rows ``sin(k pi (i+1/2)/N)`` (exact
    eigenvectors of the cell-centered Dirichlet Laplacian, cf.
    sim/diffusion.py:164) + eigenvalues of ``-u_xx``."""
    i = np.arange(N)
    k = np.arange(1, N + 1)
    S = np.sin((i[None, :] + 0.5) * k[:, None] * np.pi / N)
    S /= np.linalg.norm(S, axis=1, keepdims=True)
    lam = 4.0 * np.sin(k * np.pi / (2 * N)) ** 2 * N * N
    return S, lam


def coupled_spde_paths(config, keys):
    """Integrate a coupled (fine, coarse) SPDE level batch.

    :param config: dict with ``model`` (:class:`SPDE1D`),
        ``total_time``, ``n_cells_fine``, ``n_steps_fine``,
        ``n_cells_coarse``, ``n_steps_coarse`` (0, 0 on level 0);
        optional ``dtype``.
    :param keys: [B] PRNG keys — all noise boxes derive counter-style
        inside the scan.
    :return: ``(u_fine [B, N_f], u_coarse [B, N_c] | None)`` terminal
        fields (cell averages).
    """
    model = config["model"]
    if not isinstance(model, SPDE1D):
        raise ValueError("model must be an SPDE1D")
    T = float(config["total_time"])
    N_f = int(config["n_cells_fine"])
    n_f = int(config["n_steps_fine"])
    N_c = int(config["n_cells_coarse"])
    n_c = int(config["n_steps_coarse"])
    is_l0 = N_c == 0 and n_c == 0
    if not is_l0:
        if N_c == 0 or n_c == 0:
            raise ValueError("coarse cells/steps must both be 0 "
                             "(level 0) or both be positive")
        if N_f % N_c or n_f % n_c:
            raise ValueError(
                "fine grid must refine the coarse grid by integer "
                "factors (cells %d/%d, steps %d/%d)"
                % (N_f, N_c, n_f, n_c))
    m_x = 1 if is_l0 else N_f // N_c
    m_t = 1 if is_l0 else n_f // n_c
    trips = n_f if is_l0 else n_c
    dtype = jnp.dtype(config["dtype"]) if "dtype" in config \
        else jnp.result_type(float)
    B = keys.shape[0]
    dx_f, dt_f = 1.0 / N_f, T / n_f
    nu, sigma = model.nu, model.sigma
    f = model.reaction

    def stepper(N, dt):
        S, lam = _dst_basis(N)
        r = 1.0 / (1.0 + dt * nu * lam)
        Fwd = jnp.asarray(S.T, dtype)             # u @ Fwd -> modes
        Bwd = jnp.asarray((S.T * r[None, :]).T, dtype)
        hi = jax.lax.Precision.HIGHEST

        def step(u, dw):
            rhs = u + sigma * dw
            if f is not None:
                rhs = rhs + dt * f(u)
            modes = jnp.matmul(rhs, Fwd, precision=hi)
            return jnp.matmul(modes, Bwd, precision=hi)

        return step

    step_f = stepper(N_f, dt_f)
    step_c = None if is_l0 else stepper(N_c, dt_f * m_t)

    if model.ic is None:
        u0_f = jnp.zeros((B, N_f), dtype)
        u0_c = jnp.zeros((B, N_c), dtype) if not is_l0 else None
    else:
        xf = (np.arange(N_f) + 0.5) * dx_f
        u0_f = jnp.broadcast_to(
            jnp.asarray(model.ic(xf), dtype), (B, N_f))
        if not is_l0:
            xc = (np.arange(N_c) + 0.5) * dx_f * m_x
            u0_c = jnp.broadcast_to(
                jnp.asarray(model.ic(xc), dtype), (B, N_c))
        else:
            u0_c = None

    sd = np.sqrt(dt_f / dx_f)

    def body(carry, c):
        uf, uc = carry
        kk = jax.vmap(lambda k: jax.random.fold_in(k, c))(keys)
        dw = sd * jax.vmap(
            lambda k: jax.random.normal(k, (m_t, N_f), dtype))(kk)
        for j in range(m_t):
            uf = step_f(uf, dw[:, j])
        if not is_l0:
            dw_c = dw.reshape(B, m_t, N_c, m_x).sum(axis=(1, 3)) / m_x
            uc = step_c(uc, dw_c)
        return (uf, uc), None

    (uf, uc), _ = jax.lax.scan(body, (u0_f, u0_c), jnp.arange(trips))
    return uf, (None if is_l0 else uc)


class SPDESimulation(Simulation):
    """SPDE MLMC under the standard Simulation contract: level
    parameters are ``[dx, dt]`` pairs, the coupling is box-aggregated
    shared noise, and the stored QoI is a functional of the terminal
    field.

    Config keys: ``model`` (:class:`SPDE1D`, default
    :func:`stochastic_heat`), ``total_time`` (default 0.5), ``qoi``:
    ``'l2sq'`` (default — ``dx sum u_i^2``), ``'point'`` (value of the
    cell containing ``qoi_x``, default 0.5), or a callable
    ``(u [B, N], dx) -> [B] or [B, M]``.
    """

    def __init__(self, config=None):
        super().__init__()
        config = dict(config or {})
        config.setdefault("model", stochastic_heat())
        if not isinstance(config["model"], SPDE1D):
            raise ValueError("model must be an SPDE1D")
        config.setdefault("total_time", 0.5)
        config.setdefault("qoi", "l2sq")
        config.setdefault("qoi_x", 0.5)
        if isinstance(config["qoi"], str) \
                and config["qoi"] not in ("l2sq", "point"):
            raise ValueError("qoi must be 'l2sq', 'point' or callable")
        self.config = config
        self.need_workspace = False

    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]
                       ) -> LevelSimulation:
        T = float(self.config["total_time"])
        dx_f, dt_f = (float(p) for p in fine_level_params[:2])
        N_f, n_f = int(round(1.0 / dx_f)), int(round(T / dt_f))
        if coarse_level_params and float(coarse_level_params[0]) != 0:
            dx_c, dt_c = (float(p) for p in coarse_level_params[:2])
            N_c, n_c = int(round(1.0 / dx_c)), int(round(T / dt_c))
        else:
            N_c = n_c = 0
        config = dict(self.config, n_cells_fine=N_f, n_steps_fine=n_f,
                      n_cells_coarse=N_c, n_steps_coarse=n_c,
                      res_format=self.result_format())
        return LevelSimulation(config_dict=config,
                               task_size=float(N_f * n_f),
                               nan_result_is_failure=False)

    @staticmethod
    def _assemble(config, u):
        qoi = config["qoi"]
        N = u.shape[1]
        dx = 1.0 / N
        if qoi == "l2sq":
            return (dx * jnp.sum(u * u, axis=1))[:, None]
        if qoi == "point":
            i = min(int(float(config["qoi_x"]) * N), N - 1)
            return u[:, i][:, None]
        v = qoi(u, dx)
        return v[:, None] if v.ndim == 1 else v

    @staticmethod
    def calculate_batch(config, keys, attempts=None):
        uf, uc = coupled_spde_paths(config, keys)
        fine = SPDESimulation._assemble(config, uf)
        coarse = jnp.zeros_like(fine) if uc is None \
            else SPDESimulation._assemble(config, uc)
        return fine, coarse, jnp.zeros(fine.shape[0], dtype=bool)

    @staticmethod
    def calculate(config, seed):
        key = jax.random.key(np.uint32(seed))
        fine, coarse, _ = SPDESimulation.calculate_batch(
            config, key[None])
        return np.asarray(fine[0]), np.asarray(coarse[0])

    def result_format(self) -> List[QuantitySpec]:
        T = self.config["total_time"]
        name = self.config["qoi"] if isinstance(self.config["qoi"],
                                                str) else "qoi"
        return [QuantitySpec(name=name, unit="1", shape=(1,),
                             times=[T], locations=["-"])]
