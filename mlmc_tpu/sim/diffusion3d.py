"""3-D Darcy flow with GRF conductivity — device-native.

Extends the 2-D cond_field re-design (mlmc_tpu/sim/diffusion.py, the
reference's flagship workflow: flow123d FEM subprocesses at ~10-20 min
per 2-4e6-element sample, reference mlmc/tool/flow_mc.py:213-217) to
the full 3-D problem the reference could only reach on a PBS cluster:
a unit cube, n^3 regular cells, log-normal conductivity from a 3-D
random-Fourier-feature GRF (fine/coarse share modes AND phases — the
same field realization on both grids), and the 7-point finite-volume
pressure solve

    -div(K grad p) = 0,   p=1 at x=0, p=0 at x=1, no-flux elsewhere,

by conjugate gradients under the diagonally-scaled SPECTRAL
preconditioner: the unit-coefficient 7-point operator separates into
three 1-D tridiagonals whose exact eigenbases are DST-II (Dirichlet
half-cell, x) and DCT-II (Neumann, y and z) — applied as three dense
[n, n] tensor contractions per CG iteration, i.e. batched matmuls
against [n, n^2] panels, with the Jacobi-like scaling
``W = sqrt(diag_C / diag_A)`` absorbing the field's local contrast
(same construction measured in 2-D to cut worst-sample CG iterations
~7x vs geometric-mean spectral; see diffusion.py:_solve_pressure).

QoI = total outflow through the x=1 face = the medium's effective
conductivity (homogeneous K=k0 gives exactly k0; the lognormal
ensemble mean sits near Matheron's 3-D estimate K_g exp(sigma^2/6)).

The whole coupled sample is ONE jitted program vmapped over the batch;
a 32^3+16^3 coupled pair is ~37k cells of stencil work per CG
iteration, entirely in dense device arithmetic.
"""
import copy
from typing import List

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.sim.simulation import Simulation
from mlmc_tpu.quantity.quantity_spec import QuantitySpec
from mlmc_tpu.level_simulation import LevelSimulation


def _wave_vectors_3d(model, corr_length, mode_no, seed=0):
    """3-D spectral-measure wave vectors (gauss / exp families; the
    exp spectrum is multivariate-Student via the chi-square mixture,
    matching random/correlated_field.py)."""
    key = jax.random.key(seed)
    if model == "exp":
        y = jax.random.normal(key, (mode_no, 3))
        w = jax.random.chisquare(jax.random.fold_in(key, 1), 1.0,
                                 (mode_no, 1))
        return y / jnp.sqrt(w) / corr_length
    return jax.random.normal(key, (mode_no, 3)) * (
        np.sqrt(2.0) / corr_length)


class DiffusionSimulation3D(Simulation):
    """3-D Darcy flow with random log-normal conductivity."""

    N_MODES = 256
    CG_TOL = 1e-6
    CG_MAXITER_FACTOR = 10

    def __init__(self, config=None):
        """:param config: dict with keys sigma (log-field std, default
        1), corr_length (default 0.3), model ('gauss'|'exp'), n_modes,
        cg_tol, cg_maxiter_factor."""
        super().__init__()
        self._config = dict(config or {})
        self.need_workspace = False

    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]) -> LevelSimulation:
        config = copy.deepcopy(self._config)
        fine_step = float(fine_level_params[0])
        coarse_step = float(coarse_level_params[0])
        config["fine_n"] = max(int(round(1.0 / fine_step)), 2)
        config["coarse_n"] = (max(int(round(1.0 / coarse_step)), 2)
                              if coarse_step > 0 else 0)
        config["res_format"] = self.result_format()
        config["_wave_vectors"] = _wave_vectors_3d(
            config.get("model", "gauss"), config.get("corr_length", 0.3),
            config.get("n_modes", self.N_MODES),
            seed=config.get("seed", 0))
        return LevelSimulation(config_dict=config,
                               task_size=self.n_ops_estimate(fine_step))

    # ------------------------------------------------------------------ #
    @classmethod
    def _conductivity(cls, config, key, n, phases=None):
        """K = exp(sigma * G) at the n^3 cell centers; same key (or
        explicit RFF ``phases`` — the QMC hook) => same realization on
        every grid, which is the level coupling."""
        sigma = config.get("sigma", 1.0)
        k_vec = config["_wave_vectors"]            # [M, 3]
        h = 1.0 / n
        c = (jnp.arange(n) + 0.5) * h
        X, Y, Z = jnp.meshgrid(c, c, c, indexing="ij")
        pts = jnp.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
        if phases is None:
            phases = jax.random.uniform(key, (k_vec.shape[0],),
                                        maxval=2 * np.pi)
        g = jnp.sqrt(2.0 / k_vec.shape[0]) * jnp.sum(
            jnp.cos(pts @ k_vec.T + phases[None, :]), axis=1)
        return jnp.exp(sigma * g).reshape(n, n, n)

    @staticmethod
    def _spectral_basis(n):
        """Eigen-bases of the unit-K 7-point operator: DST-II along the
        Dirichlet x axis, DCT-II along the Neumann y/z axes, and the
        separable eigenvalue tensor lam[i, j, k] (float64 numpy, cast
        at use site)."""
        j = np.arange(n)
        k = np.arange(1, n + 1)
        Sx = np.sin((j[None, :] + 0.5) * k[:, None] * np.pi / n)
        Sx *= np.where(k[:, None] == n, np.sqrt(1.0 / n),
                       np.sqrt(2.0 / n))
        lx = 4.0 * np.sin(k * np.pi / (2 * n)) ** 2
        ll = np.arange(n)
        Cn = np.cos((j[None, :] + 0.5) * ll[:, None] * np.pi / n)
        Cn *= np.where(ll[:, None] == 0, np.sqrt(1.0 / n),
                       np.sqrt(2.0 / n))
        ln = 4.0 * np.sin(ll * np.pi / (2 * n)) ** 2
        lam = (lx[:, None, None] + ln[None, :, None]
               + ln[None, None, :])
        return Sx, Cn, lam

    @staticmethod
    def _const_diag(n):
        """Diagonal of the unit-K constant-coefficient 7-point operator
        (x: Dirichlet half-cell, interior 2 / boundary 3; y, z:
        Neumann, interior 2 / boundary 1)."""
        dx = np.full(n, 2.0)
        dx[0] += 1.0
        dx[-1] += 1.0
        dn = np.full(n, 2.0)
        dn[0] -= 1.0
        dn[-1] -= 1.0
        return (dx[:, None, None] + dn[None, :, None]
                + dn[None, None, :])

    @staticmethod
    def _face_conductivities(K):
        """Harmonic averages on the three interior face families."""
        Kx = 2.0 * K[:-1] * K[1:] / (K[:-1] + K[1:])
        Ky = 2.0 * K[:, :-1] * K[:, 1:] / (K[:, :-1] + K[:, 1:])
        Kz = 2.0 * K[:, :, :-1] * K[:, :, 1:] / (K[:, :, :-1]
                                                 + K[:, :, 1:])
        return Kx, Ky, Kz

    @staticmethod
    def _stencil_matvec(p, Kx, Ky, Kz, Kin, Kout):
        """A @ p for the 7-point FV operator, p [n, n, n]; axis 0 is
        the Dirichlet x direction (half-cell boundary faces Kin/Kout
        [n, n]). Slice/concat assembly, as in 2-D (scatter-add
        lowers slowly)."""
        n = p.shape[0]
        zx = jnp.zeros((1, n, n), p.dtype)
        zy = jnp.zeros((n, 1, n), p.dtype)
        zz = jnp.zeros((n, n, 1), p.dtype)
        fx = Kx * (p[1:] - p[:-1])
        fy = Ky * (p[:, 1:] - p[:, :-1])
        fz = Kz * (p[:, :, 1:] - p[:, :, :-1])
        div = (jnp.concatenate([fx, zx], 0) - jnp.concatenate([zx, fx], 0)
               + jnp.concatenate([fy, zy], 1)
               - jnp.concatenate([zy, fy], 1)
               + jnp.concatenate([fz, zz], 2)
               - jnp.concatenate([zz, fz], 2))
        bnd = jnp.concatenate(
            [(Kin * p[0])[None], jnp.zeros((n - 2, n, n), p.dtype),
             (Kout * p[-1])[None]], 0)
        return -(div - bnd)

    @staticmethod
    def _stencil_diag(Kx, Ky, Kz, Kin, Kout, n):
        diag = jnp.zeros((n, n, n), Kx.dtype)
        diag = diag.at[:-1].add(Kx)
        diag = diag.at[1:].add(Kx)
        diag = diag.at[:, :-1].add(Ky)
        diag = diag.at[:, 1:].add(Ky)
        diag = diag.at[:, :, :-1].add(Kz)
        diag = diag.at[:, :, 1:].add(Kz)
        diag = diag.at[0].add(Kin)
        diag = diag.at[-1].add(Kout)
        return diag

    @staticmethod
    def _galerkin_coarsen(Kx, Ky, Kz, Kin, Kout):
        """Exact Galerkin (P^T A P) coarsening under 2x2x2 aggregation
        with piecewise-constant prolongation: the coarse operator is
        again a 7-point FV operator whose face transmissibilities are
        the SUMS of the fine faces crossing each aggregate interface
        (internal faces cancel — graph-Laplacian identity, same as the
        2-D version diffusion.py:_galerkin_coarsen). Preserves fracture
        channels exactly on the interfaces."""
        nc = Kin.shape[0] // 2
        # interior face family along an axis has n-1 planes; the coarse
        # interface I|I+1 collects the fine plane 2I+1's 2x2 footprint
        Kx_c = Kx[1::2].reshape(nc - 1, nc, 2, nc, 2).sum((2, 4))
        Ky_c = Ky[:, 1::2].reshape(nc, 2, nc - 1, nc, 2).sum((1, 4))
        Kz_c = Kz[:, :, 1::2].reshape(nc, 2, nc, 2, nc - 1).sum((1, 3))
        Kin_c = Kin.reshape(nc, 2, nc, 2).sum((1, 3))
        Kout_c = Kout.reshape(nc, 2, nc, 2).sum((1, 3))
        return Kx_c, Ky_c, Kz_c, Kin_c, Kout_c

    @classmethod
    def _mg_vcycle_preconditioner(cls, Kx, Ky, Kz, Kin, Kout, n,
                                  nu=2, omega=0.8, coarsest=4):
        """Geometric multigrid V-cycle as a linear SPD preconditioner
        (damped-Jacobi smoothing, 2x2x2 piecewise-constant aggregation,
        dense coarsest inverse) — the 3-D twin of
        diffusion.py:_mg_vcycle_preconditioner; needed where
        discontinuous-contrast fracture channels put eigenvalue
        clusters beyond any diagonal/spectral scaling."""
        levels = []
        while n > coarsest and n % 2 == 0:
            diag = cls._stencil_diag(Kx, Ky, Kz, Kin, Kout, n)
            levels.append((Kx, Ky, Kz, Kin, Kout, diag, n))
            Kx, Ky, Kz, Kin, Kout = cls._galerkin_coarsen(
                Kx, Ky, Kz, Kin, Kout)
            n = n // 2
        eye = jnp.eye(n ** 3, dtype=Kx.dtype)
        A_c = jax.vmap(
            lambda col: cls._stencil_matvec(
                col.reshape(n, n, n), Kx, Ky, Kz, Kin,
                Kout).reshape(-1), out_axes=1)(eye)
        A_c_inv = jnp.linalg.inv(A_c)
        c_n = n

        def vcycle(r, lvl):
            if lvl == len(levels):
                return (A_c_inv @ r.reshape(-1)).reshape(c_n, c_n, c_n)
            Kx_l, Ky_l, Kz_l, Ki_l, Ko_l, diag, n_l = levels[lvl]
            mv = lambda p: cls._stencil_matvec(p, Kx_l, Ky_l, Kz_l,
                                               Ki_l, Ko_l)
            x = (omega / diag) * r
            for _ in range(nu - 1):
                x = x + (omega / diag) * (r - mv(x))
            res = r - mv(x)
            r_c = res.reshape(n_l // 2, 2, n_l // 2, 2, n_l // 2,
                              2).sum(axis=(1, 3, 5))
            e_c = vcycle(r_c, lvl + 1)
            e = jnp.repeat(jnp.repeat(jnp.repeat(e_c, 2, 0), 2, 1),
                           2, 2)
            x = x + e
            for _ in range(nu):
                x = x + (omega / diag) * (r - mv(x))
            return x

        n0 = levels[0][6] if levels else c_n

        def M(r):
            return vcycle(r.reshape(n0, n0, n0), 0).reshape(-1)

        return M

    # default preconditioner; subclasses with rough media override
    PRECOND = "spectral"
    CG_MAXITER_FACTOR_MG = 4

    @classmethod
    def _solve_pressure(cls, config, K):
        """Preconditioned-CG solve on the n^3 grid (see module doc)."""
        n = K.shape[0]
        Kx, Ky, Kz = cls._face_conductivities(K)
        Kin = 2.0 * K[0]         # [n, n] half-cell faces at x=0
        Kout = 2.0 * K[-1]       # [n, n] at x=1

        def matvec(p):
            return cls._stencil_matvec(
                p.reshape(n, n, n), Kx, Ky, Kz, Kin, Kout).reshape(-1)

        b = jnp.zeros((n, n, n), K.dtype).at[0].add(Kin).reshape(-1)
        diag = cls._stencil_diag(Kx, Ky, Kz, Kin, Kout, n)

        precond = config.get("precond", cls.PRECOND)
        if precond == "mg":
            M = cls._mg_vcycle_preconditioner(
                Kx, Ky, Kz, Kin, Kout, n,
                nu=config.get("mg_nu", 2),
                omega=config.get("mg_omega", 0.8),
                coarsest=config.get("mg_coarsest", 4))
        elif precond == "spectral":
            Sx, Cn, lam = cls._spectral_basis(n)
            Sx = jnp.asarray(Sx, K.dtype)
            Cn = jnp.asarray(Cn, K.dtype)
            lam = jnp.asarray(lam, K.dtype)
            w = jnp.sqrt(jnp.asarray(cls._const_diag(n), K.dtype)
                         / diag)

            def transform(r, U0, U1, U2):
                r = jnp.einsum("ab,bjk->ajk", U0, r)
                r = jnp.einsum("ab,ibk->iak", U1, r)
                return jnp.einsum("ab,ijb->ija", U2, r)

            def M(r):
                r_hat = transform(w * r.reshape(n, n, n), Sx, Cn, Cn)
                return (w * transform(r_hat / lam, Sx.T, Cn.T, Cn.T)
                        ).reshape(-1)
        else:
            M = lambda r: r / diag.reshape(-1)

        default_factor = (cls.CG_MAXITER_FACTOR_MG if precond == "mg"
                          else cls.CG_MAXITER_FACTOR)
        maxiter = config.get("cg_maxiter_factor", default_factor) * n
        p, _ = jax.scipy.sparse.linalg.cg(
            matvec, b, tol=config.get("cg_tol", cls.CG_TOL),
            maxiter=maxiter, M=M)
        return p.reshape(n, n, n)

    # ------------------------------------------------------------------ #
    @classmethod
    def _sample_flux(cls, config, key, n, phases=None):
        """Outflow through x=1: boundary half-face transmissibility is
        2 K h^2 / (h/2) = 2 K h per face, so flux = (1/n) sum 2 K p —
        exactly k0 for homogeneous K=k0 (linear pressure)."""
        K = cls._conductivity(config, key, n, phases=phases)
        p = cls._solve_pressure(config, K)
        return jnp.sum(2.0 * K[-1] * p[-1]) / n

    @classmethod
    def _calculate_one(cls, config, key, phases=None):
        fine = cls._sample_flux(config, key, config["fine_n"],
                                phases=phases)
        if config["coarse_n"] > 0:
            coarse = cls._sample_flux(config, key, config["coarse_n"],
                                      phases=phases)
        else:
            coarse = jnp.zeros_like(fine)
        return fine[None], coarse[None]

    @classmethod
    def calculate(cls, config, seed):
        key = jax.random.key(np.uint32(seed))
        fine, coarse = cls._calculate_one(config, key)
        return np.asarray(fine), np.asarray(coarse)

    @classmethod
    def calculate_batch(cls, config, keys, attempts=None):
        fine, coarse = jax.vmap(
            lambda k: cls._calculate_one(config, k))(keys)
        failed = jnp.zeros(keys.shape[0], dtype=bool)
        return fine, coarse, failed

    def n_ops_estimate(self, step):
        n = 1.0 / step
        return n ** 3 * np.log(max(n, 2.0))

    def result_format(self) -> List[QuantitySpec]:
        return [QuantitySpec(name="flux", unit="m^3/s", shape=(1,),
                             times=[0], locations=["outflow"])]
