"""Darcy-flow diffusion simulation with GRF conductivity — device-native.

Re-design of the reference cond_field workflow (FlowSim,
reference mlmc/tool/flow_mc.py:91-455 + test/01_cond_field/process_simple.py):
there, each sample shells out to gmsh for a mesh and to the external
flow123d FEM binary, with conductivity from a correlated random field
evaluated at element centers. Here the whole sample is ONE jitted program
(BASELINE.json config 5):

* unit square, regular n x n cell grid (n = 1/step),
* log-normal conductivity ``K = exp(sigma * G)`` with G a stationary GRF
  evaluated at cell centers by the random-Fourier-feature method — fine and
  coarse grids of one sample share modes AND phases, giving the same
  underlying field realization (the reference couples levels by sampling
  one field on concatenated fine+coarse centers, flow_mc.py:279-335),
* pressure solve ``-div(K grad p) = 0`` with p=1 on the left edge, p=0 on
  the right, no-flux top/bottom: 5-point finite volumes with harmonic face
  conductivities, solved by conjugate gradients
  (jax.scipy.sparse.linalg.cg) under a diagonally-scaled spectral
  preconditioner (see ``_solve_pressure``) — matvec is a stencil and the
  preconditioner is batched matmuls, so the whole solve lives in
  dense device arithmetic and vmaps over the sample batch,
* QoI = total outflow flux through the right edge (the reference extracts
  ``.bc_outflow`` from flow123d's water_balance.yaml, flow_mc.py:412-445),
  which estimates the effective conductivity of the medium.
"""
import copy
from typing import List

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.sim.simulation import Simulation
from mlmc_tpu.quantity.quantity_spec import QuantitySpec
from mlmc_tpu.level_simulation import LevelSimulation


def _wave_vectors_2d(model, corr_length, mode_no, seed=0):
    """2-D spectral-measure wave vectors (see SpectralCorrelatedField)."""
    key = jax.random.key(seed)
    if model == "exp":
        y = jax.random.normal(key, (mode_no, 2))
        w = jax.random.chisquare(jax.random.fold_in(key, 1), 1.0, (mode_no, 1))
        k = y / jnp.sqrt(w) / corr_length
    else:
        k = jax.random.normal(key, (mode_no, 2)) * (np.sqrt(2.0) / corr_length)
    return k


class DiffusionSimulation(Simulation):
    """2-D Darcy flow with random log-normal conductivity."""

    N_MODES = 256
    # relative residual target: f32 CG plateaus ~1e-7; 1e-6 is reliably
    # reachable and far below the MLMC sampling error of any config
    CG_TOL = 1e-6
    # iteration cap = factor * n; CG stops at CG_TOL long before this on
    # smooth lognormal fields (~20-40 iterations at 64^2 with the scaled
    # spectral preconditioner), so the cap only pays when a field needs it
    CG_MAXITER_FACTOR = 10
    # default preconditioner (config key "precond" overrides): smooth
    # lognormal fields converge fastest under the scaled spectral inverse
    PRECOND = "spectral"
    # iteration cap factor under the multigrid preconditioner: MG-CG is
    # nearly n-independent (measured <=67 iterations at 64^2 over
    # 1e3-contrast fracture fields), so the cap is a small multiple of n
    CG_MAXITER_FACTOR_MG = 4

    def __init__(self, config=None):
        """:param config: dict with keys
        sigma (log-field std, default 1), corr_length (default 0.2),
        model ('gauss'|'exp'), n_modes, cg_maxiter_factor
        """
        super().__init__()
        self._config = dict(config or {})
        self.need_workspace = False

    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]) -> LevelSimulation:
        config = copy.deepcopy(self._config)
        fine_step = float(fine_level_params[0])
        coarse_step = float(coarse_level_params[0])
        config["fine_n"] = max(int(round(1.0 / fine_step)), 2)
        config["coarse_n"] = max(int(round(1.0 / coarse_step)), 2) if coarse_step > 0 else 0
        config["res_format"] = self.result_format()
        method = config.get("field_method", "rff")
        if method == "rff":
            config["_wave_vectors"] = _wave_vectors_2d(
                config.get("model", "gauss"), config.get("corr_length", 0.2),
                config.get("n_modes", self.N_MODES), seed=config.get("seed", 0))
        elif method == "circulant":
            # exact-covariance GRF on the FINE grid (BASELINE config 5);
            # the coarse grid point-samples the same realization, so the
            # coarse grid size must divide the fine one
            from mlmc_tpu.random.correlated_field import CirculantEmbeddingField

            if config["coarse_n"]:
                assert config["fine_n"] % config["coarse_n"] == 0, (
                    "circulant coupling needs coarse_n | fine_n")
            n = config["fine_n"]
            field = CirculantEmbeddingField(
                corr_exp=config.get("model", "gauss"),
                corr_length=config.get("corr_length", 0.2),
                grid_shape=(n, n), grid_step=1.0 / n)
            config["_circ_eig"] = field._eig
        else:
            raise ValueError("unknown field_method %r" % (method,))
        return LevelSimulation(config_dict=config,
                               task_size=self.n_ops_estimate(fine_step))

    # ------------------------------------------------------------------ #
    @classmethod
    def _conductivity(cls, config, key, n, phases=None):
        """K = exp(sigma * G) at cell centers of an n x n grid.

        Fine/coarse coupling: the SAME key produces the same underlying
        field realization on both grids — RFF shares modes+phases; the
        circulant method samples the fine grid exactly (FFT embedding) and
        the coarse grid point-samples that realization.

        :param phases: optional [M] RFF mode phases replacing the key draw
            — the QMC entry point (the phases are the sim's only
            per-sample randomness on the RFF path)."""
        sigma = config.get("sigma", 1.0)
        if phases is not None and "_circ_eig" in config:
            raise ValueError(
                "phase-driven (QMC) sampling needs field_method='rff'")
        if "_circ_eig" in config:
            eig = config["_circ_eig"]
            emb = eig.shape[0]
            kr, ki = jax.random.split(key)
            w = (jax.random.normal(kr, eig.shape)
                 + 1j * jax.random.normal(ki, eig.shape))
            g = (jnp.fft.fftn(jnp.sqrt(eig) * w).real
                 / jnp.sqrt(emb * eig.shape[1]))
            fine_n = config["fine_n"]
            g = g[:fine_n, :fine_n]
            if n < fine_n:  # coarse grid point-samples the fine realization
                stride = fine_n // n
                idx = (jnp.arange(n) + 0.5) * stride - 0.5
                idx = jnp.clip(jnp.round(idx).astype(jnp.int32), 0, fine_n - 1)
                g = g[idx][:, idx]
            return jnp.exp(sigma * g)
        k_vec = config["_wave_vectors"]          # [M, 2]
        h = 1.0 / n
        centers = (jnp.arange(n) + 0.5) * h
        X, Y = jnp.meshgrid(centers, centers, indexing="ij")
        pts = jnp.stack([X.ravel(), Y.ravel()], axis=1)      # [n*n, 2]
        if phases is None:
            phases = jax.random.uniform(key, (k_vec.shape[0],),
                                        maxval=2 * np.pi)
        g = jnp.sqrt(2.0 / k_vec.shape[0]) * jnp.sum(
            jnp.cos(pts @ k_vec.T + phases[None, :]), axis=1)
        return jnp.exp(sigma * g).reshape(n, n)

    @staticmethod
    def _spectral_basis(n):
        """Orthonormal eigen-basis of the CONSTANT-coefficient operator.

        The unit-K 5-point system of ``_solve_pressure`` separates into
        1-D tridiagonal operators: half-cell Dirichlet in x (boundary
        transmissibility 2 -> diagonal 3) and Neumann in y (boundary
        diagonal 1).  Their exact eigenvectors are the DST-II rows
        ``sin((j+1/2) k pi/n), k=1..n`` and the DCT-II rows
        ``cos((j+1/2) l pi/n), l=0..n-1`` with eigenvalues
        ``4 sin^2(k pi / 2n)``.  At benchmark sizes (n <= 64) applying
        the dense orthogonal matrices is a batched matmul — faster
        and simpler than an FFT factorization.

        :return: (Sx [n,n] DST-II, Cy [n,n] DCT-II, lam [n,n] with
            lam[l,k] = lambda_y(l) + lambda_x(k); all float64 numpy,
            cast at use site)
        """
        j = np.arange(n)
        k = np.arange(1, n + 1)
        Sx = np.sin((j[None, :] + 0.5) * k[:, None] * np.pi / n)
        Sx *= np.where(k[:, None] == n, np.sqrt(1.0 / n), np.sqrt(2.0 / n))
        lx = 4.0 * np.sin(k * np.pi / (2 * n)) ** 2
        ll = np.arange(n)
        Cy = np.cos((j[None, :] + 0.5) * ll[:, None] * np.pi / n)
        Cy *= np.where(ll[:, None] == 0, np.sqrt(1.0 / n), np.sqrt(2.0 / n))
        ly = 4.0 * np.sin(ll * np.pi / (2 * n)) ** 2
        return Sx, Cy, ly[:, None] + lx[None, :]

    @staticmethod
    def _const_diag(n):
        """Diagonal of the unit-K constant-coefficient 5-point operator.

        1-D Dirichlet half-cell operator in x: interior diagonal 2,
        boundary 3 (interior face + half-cell face transmissibility 2);
        1-D Neumann operator in y: interior 2, boundary 1. The 2-D
        diagonal is the sum of the two.
        """
        dx = np.full(n, 2.0)
        dx[0] += 1.0
        dx[-1] += 1.0
        dy = np.full(n, 2.0)
        dy[0] -= 1.0
        dy[-1] -= 1.0
        return dy[:, None] + dx[None, :]

    @staticmethod
    def _face_conductivities(K):
        """Harmonic averages on interior faces + boundary half-cell faces."""
        # x-direction faces between columns j and j+1: [n, n-1]
        Kx = 2.0 * K[:, :-1] * K[:, 1:] / (K[:, :-1] + K[:, 1:])
        # y-direction faces between rows i and i+1: [n-1, n]
        Ky = 2.0 * K[:-1, :] * K[1:, :] / (K[:-1, :] + K[1:, :])
        return Kx, Ky

    # ------------------------------------------------------------------ #
    # stencil operator pieces (shared by CG and the multigrid hierarchy)
    # ------------------------------------------------------------------ #
    @staticmethod
    def _stencil_matvec(p, Kx, Ky, Kleft, Kright):
        """A @ p for the 5-point FV operator given face transmissibilities.

        ``p`` is [n, n]; Dirichlet enters through the half-cell columns.
        Slice/concat assembly (scatter-add lowers slowly on accelerators)."""
        n = p.shape[0]
        zx = jnp.zeros((n, 1), p.dtype)
        zy = jnp.zeros((1, n), p.dtype)
        fx = Kx * (p[:, 1:] - p[:, :-1])
        fy = Ky * (p[1:, :] - p[:-1, :])
        div = (jnp.concatenate([fx, zx], 1) - jnp.concatenate([zx, fx], 1)
               + jnp.concatenate([fy, zy], 0) - jnp.concatenate([zy, fy], 0))
        bnd = jnp.concatenate(
            [(Kleft * p[:, 0])[:, None], jnp.zeros((n, n - 2), p.dtype),
             (Kright * p[:, -1])[:, None]], 1)
        return -(div - bnd)

    @staticmethod
    def _stencil_diag(Kx, Ky, Kleft, Kright, n):
        diag = jnp.zeros((n, n), Kx.dtype)
        diag = diag.at[:, :-1].add(Kx)
        diag = diag.at[:, 1:].add(Kx)
        diag = diag.at[:-1, :].add(Ky)
        diag = diag.at[1:, :].add(Ky)
        diag = diag.at[:, 0].add(Kleft)
        diag = diag.at[:, -1].add(Kright)
        return diag

    @staticmethod
    def _galerkin_coarsen(Kx, Ky, Kleft, Kright):
        """Exact Galerkin (P^T A P) coarsening under 2x2 aggregation.

        With piecewise-constant prolongation the coarse operator is again
        a 5-point FV operator whose face transmissibilities are the SUMS
        of the fine transmissibilities crossing each aggregate interface
        (internal faces cancel; graph-Laplacian aggregation identity).
        Preserves fracture channels exactly on the interfaces — unlike
        smearing the conductivity field itself.
        """
        # coarse x-face (I, J)|(I, J+1) = fine faces at column 2J+1
        Kx_i = Kx[:, 1::2]
        Kx_c = Kx_i[0::2] + Kx_i[1::2]
        # coarse y-face (I, J)|(I+1, J) = fine faces at row 2I+1
        Ky_i = Ky[1::2, :]
        Ky_c = Ky_i[:, 0::2] + Ky_i[:, 1::2]
        Kl_c = Kleft[0::2] + Kleft[1::2]
        Kr_c = Kright[0::2] + Kright[1::2]
        return Kx_c, Ky_c, Kl_c, Kr_c

    @classmethod
    def _mg_vcycle_preconditioner(cls, Kx, Ky, Kleft, Kright, n,
                                  nu=2, omega=0.8, coarsest=4):
        """Geometric multigrid V-cycle as a linear SPD preconditioner.

        Pure-jnp and vmappable: smoothing is damped Jacobi (diagonal =>
        the symmetric pre/post cycle with P = R^T Galerkin coarse
        operators is SPD, valid inside CG), aggregation is 2x2
        piecewise-constant, the coarsest grid solves densely (the
        [c^2, c^2] matrix assembles by matvec-on-identity and is a
        per-sample batched solve under vmap). High-contrast fracture
        fields cluster eigenvalues beyond any diagonal/spectral scaling's
        reach; the coarse-space correction removes the grid AND channel
        modes — measured at 64^2/1e3-contrast the CG iteration count
        drops from ~24n to O(30) (see bench_extra fractured).
        """
        # static level list: face arrays + diagonals per level
        levels = []
        while n > coarsest and n % 2 == 0:
            diag = cls._stencil_diag(Kx, Ky, Kleft, Kright, n)
            levels.append((Kx, Ky, Kleft, Kright, diag, n))
            Kx, Ky, Kleft, Kright = cls._galerkin_coarsen(Kx, Ky, Kleft, Kright)
            n = n // 2
        # dense coarsest operator via matvec on identity columns; invert
        # ONCE in setup — the coarsest correction inside the CG loop is
        # then a single [c^2, c^2] matvec (matmul-friendly; re-factorizing
        # per iteration would dominate the cycle cost), and the inverse of
        # the tiny SPD system is plenty accurate for a preconditioner
        eye = jnp.eye(n * n, dtype=Kx.dtype)
        A_c = jax.vmap(
            lambda col: cls._stencil_matvec(
                col.reshape(n, n), Kx, Ky, Kleft, Kright).reshape(-1),
            out_axes=1)(eye)
        A_c_inv = jnp.linalg.inv(A_c)
        c_n = n

        def vcycle(r, lvl):
            if lvl == len(levels):
                return (A_c_inv @ r.reshape(-1)).reshape(c_n, c_n)
            Kx_l, Ky_l, Kl_l, Kr_l, diag, n_l = levels[lvl]
            mv = lambda p: cls._stencil_matvec(p, Kx_l, Ky_l, Kl_l, Kr_l)
            x = (omega / diag) * r
            for _ in range(nu - 1):
                x = x + (omega / diag) * (r - mv(x))
            res = r - mv(x)
            r_c = res.reshape(n_l // 2, 2, n_l // 2, 2).sum(axis=(1, 3))
            e_c = vcycle(r_c, lvl + 1)
            x = x + jnp.repeat(jnp.repeat(e_c, 2, axis=0), 2, axis=1)
            for _ in range(nu):
                x = x + (omega / diag) * (r - mv(x))
            return x

        n0 = levels[0][5] if levels else c_n

        def M(r):
            return vcycle(r.reshape(n0, n0), 0).reshape(-1)

        return M

    @classmethod
    def _solve_pressure(cls, config, K):
        """CG solve of the 5-point finite-volume system on the n x n grid.

        Unknowns = cell pressures p [n, n]; Dirichlet p=1 at x=0 edge and
        p=0 at x=1 edge enter through half-cell transmissibilities; no-flux
        top/bottom. All transmissibilities are per unit h (the common h^0
        factor cancels in the flux QoI scaling below).
        """
        n = K.shape[0]
        Kx, Ky = cls._face_conductivities(K)
        # boundary half-faces (distance h/2 -> transmissibility 2K)
        Kleft = 2.0 * K[:, 0]     # [n]
        Kright = 2.0 * K[:, -1]   # [n]

        def matvec(p):
            return cls._stencil_matvec(
                p.reshape(n, n), Kx, Ky, Kleft, Kright).reshape(-1)

        b = jnp.zeros((n, n))
        b = b.at[:, 0].add(Kleft * 1.0)    # p=1 on the left edge
        b = b.reshape(-1)

        diag = cls._stencil_diag(Kx, Ky, Kleft, Kright, n)

        precond = config.get("precond", cls.PRECOND)
        if precond == "mg":
            M = cls._mg_vcycle_preconditioner(
                Kx, Ky, Kleft, Kright, n,
                nu=config.get("mg_nu", 2),
                omega=config.get("mg_omega", 0.8),
                coarsest=config.get("mg_coarsest", 4))
        elif precond == "spectral":
            # Diagonally-scaled spectral preconditioner
            #   M = W . C_1^{-1} . W,   W = diag( sqrt(diag_C / diag_A) )
            # where C_1 is the unit-coefficient 5-point operator (exact
            # inverse = two orthogonal transforms, matmuls, and a
            # spectral divide). The spectral part removes the O(n^2) grid
            # factor from the condition number; the Jacobi-like scaling
            # absorbs the field's LOCAL contrast, which the plain
            # geometric-mean constant-coefficient inverse cannot: measured
            # CG iterations to rtol 1e-6 at 64^2 (24 GRF draws, worst
            # sample — what a vmapped batch pays): jacobi 260, spectral @
            # geo-mean 144 (sigma=1) / >2000 (sigma=2), this form 20 / 38.
            # Any constant reference conductivity cancels algebraically
            # (W^2 carries c, the spectral divide carries 1/c), so no
            # geometric mean is needed. Exact for constant K by
            # construction (W^2 = c/K, M = C_K^{-1}).
            Sx, Cy, lam = cls._spectral_basis(n)
            Sx = jnp.asarray(Sx, K.dtype)
            Cy = jnp.asarray(Cy, K.dtype)
            lam = jnp.asarray(lam, K.dtype)
            w = jnp.sqrt(jnp.asarray(cls._const_diag(n), K.dtype) / diag)

            def M(r):
                r_hat = Cy @ (w * r.reshape(n, n)) @ Sx.T
                return (w * (Cy.T @ (r_hat / lam) @ Sx)).reshape(-1)
        else:
            M = lambda r: r / diag.reshape(-1)

        default_factor = (cls.CG_MAXITER_FACTOR_MG if precond == "mg"
                          else cls.CG_MAXITER_FACTOR)
        maxiter = config.get("cg_maxiter_factor", default_factor) * n
        p, _ = jax.scipy.sparse.linalg.cg(
            matvec, b, tol=config.get("cg_tol", cls.CG_TOL),
            maxiter=maxiter, M=M)
        return p.reshape(n, n)

    @classmethod
    def _sample_flux(cls, config, key, n, phases=None):
        """Total outflow through the right edge == effective conductivity.

        Transmissibility of a boundary half-face is 2K (face length h over
        distance h/2, the h's cancel), so flux = sum_i 2 K_i (p_i - 0).
        Homogeneous check: K=k0 gives linear p with p_last = h/2 and
        flux = n * 2 k0 h/2 = k0 — the Darcy value for a unit square.
        """
        K = cls._conductivity(config, key, n, phases=phases)
        p = cls._solve_pressure(config, K)
        return jnp.sum(2.0 * K[:, -1] * p[:, -1])

    @classmethod
    def _coarse_from_fine_K(cls, config, K_fine):
        """Coarse conductivity by point-sampling the FINE realization
        (exp is pointwise, so sampling K equals sampling g then exp)."""
        fine_n, n = config["fine_n"], config["coarse_n"]
        stride = fine_n // n
        idx = (jnp.arange(n) + 0.5) * stride - 0.5
        idx = jnp.clip(jnp.round(idx).astype(jnp.int32), 0, fine_n - 1)
        return K_fine[idx][:, idx]

    @classmethod
    def _calculate_one(cls, config, key, phases=None):
        if phases is not None and "_circ_eig" in config:
            raise ValueError(
                "phase-driven (QMC) sampling needs field_method='rff'")
        if "_circ_eig" in config and config["coarse_n"] > 0:
            # ONE embedding FFT per sample: the coarse grid point-samples
            # the fine realization instead of re-drawing it (the coupled
            # draw is identical; the second fftn was pure waste)
            K_fine = cls._conductivity(config, key, config["fine_n"])
            p = cls._solve_pressure(config, K_fine)
            fine = jnp.sum(2.0 * K_fine[:, -1] * p[:, -1])
            K_coarse = cls._coarse_from_fine_K(config, K_fine)
            pc = cls._solve_pressure(config, K_coarse)
            coarse = jnp.sum(2.0 * K_coarse[:, -1] * pc[:, -1])
        else:
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
        fine, coarse = jax.vmap(lambda k: cls._calculate_one(config, k))(keys)
        failed = jnp.zeros(keys.shape[0], dtype=bool)
        return fine, coarse, failed

    def n_ops_estimate(self, step):
        n = 1.0 / step
        return n * n * np.log(max(n, 2.0))

    def result_format(self) -> List[QuantitySpec]:
        return [QuantitySpec(name="flux", unit="m^3/s", shape=(1,), times=[0],
                             locations=["outflow"])]
