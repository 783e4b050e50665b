"""POD reduced-basis surrogates — physics-derived low-fidelity models,
beyond-reference tier.

Proper orthogonal decomposition (the method-of-snapshots reduced-basis
recipe): collect pressure-field snapshots from a pilot of FULL Darcy
solves, take the dominant left singular vectors ``V [n_cells, r]``,
and approximate every further sample by the Galerkin-reduced system

    (V^T A(K) V) p_r = V^T b(K),      p ~ V p_r,

an [r, r] solve instead of a preconditioned CG iteration on the full
grid. The reduced model sees the SAME conductivity realization as the
full model (shared key), so the (full, reduced) pair is strongly
correlated — exactly the coupled low-fidelity model
:class:`~mlmc_tpu.multifidelity.MFMC` and :func:`~mlmc_tpu.mlblue.
mlblue` consume; unlike the data-fit surrogates (PCE/GP tiers) it
needs no input parametrization and inherits the PDE's structure
(measured rho ~ 0.999 at r = 24 on the 32^2 benchmark field).

Device-first design: the snapshot pilot is one vmapped batch of the
existing spectral-preconditioned solves; the SVD runs once on the
host (an [n_cells, S] panel). Per surrogate sample the reduced
assembly is ``A(K) V`` — r stencil applications, slice/concat
work — followed by one [r, n_cells] x [n_cells, r] matmul contraction
and an [r, r] solve, all inside jit and vmapped over the batch.

No reference analogue (the reference has no surrogate capability).
"""
import time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.sim.diffusion import DiffusionSimulation

__all__ = ["pod_darcy_surrogate"]


def pod_darcy_surrogate(config=None, n: int = 32, rank: int = 24,
                        n_snapshots: int = 64, seed: int = 1000,
                        dtype=None):
    """Build a reduced-basis flux model for the 2-D Darcy problem.

    :param config: DiffusionSimulation config (sigma, corr_length,
        n_modes, ... — the RFF field path).
    :param n: grid resolution of the FULL model being reduced.
    :param rank: POD basis size r (snapshot energy beyond r is the
        irreducible surrogate error).
    :param n_snapshots: pilot full solves for the basis (keys derived
        from ``seed`` — keep it disjoint from estimation keys).
    :return: dict with ``model`` (``keys [C] -> flux [C]`` pure jnp —
        an MFMC/MLBLUE-ready surrogate), ``full_model`` (same contract,
        the full solve at resolution n), ``energy`` [S] singular-value
        energy fractions, ``rank``, ``wall_s``.
    """
    sim = DiffusionSimulation(dict(config or {}))
    ls = sim.level_instance([1.0 / n], [0])
    cfg = ls.config_dict
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    t0 = time.perf_counter()

    # ---- snapshot pilot: full solves ------------------------------- #
    root = jax.random.key(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(root, i))(
        jnp.arange(n_snapshots, dtype=jnp.uint32))

    @jax.jit
    def snap(keys):
        def one(k):
            K = DiffusionSimulation._conductivity(cfg, k, n)
            p = DiffusionSimulation._solve_pressure(cfg, K)
            return p.reshape(-1)

        return jax.vmap(one)(keys)

    P = np.asarray(jax.device_get(snap(keys)), np.float64)   # [S, n^2]
    # center on the snapshot mean so the basis spends its rank on the
    # FLUCTUATIONS; the mean field re-enters as a fixed basis vector
    p_mean = P.mean(axis=0)
    U, s, _ = np.linalg.svd((P - p_mean).T, full_matrices=False)
    r = min(int(rank), U.shape[1])
    V = np.concatenate([p_mean[:, None] / max(
        np.linalg.norm(p_mean), 1e-300), U[:, :r]], axis=1)
    # re-orthonormalize (the mean is not orthogonal to the modes)
    V, _ = np.linalg.qr(V)
    V = jnp.asarray(V, dtype)                                # [n^2, r+1]
    energy = np.cumsum(s ** 2) / max(np.sum(s ** 2), 1e-300)

    def reduced_flux(k):
        K = DiffusionSimulation._conductivity(cfg, k, n)
        Kx, Ky = DiffusionSimulation._face_conductivities(K)
        Kleft = 2.0 * K[:, 0]
        Kright = 2.0 * K[:, -1]
        AV = jax.vmap(
            lambda col: DiffusionSimulation._stencil_matvec(
                col.reshape(n, n), Kx, Ky, Kleft, Kright).reshape(-1),
            in_axes=1, out_axes=1)(V)                        # [n^2, r]
        A_r = jnp.matmul(V.T, AV,
                         precision=jax.lax.Precision.HIGHEST)
        b = jnp.zeros((n, n), K.dtype).at[:, 0].add(Kleft).reshape(-1)
        b_r = V.T @ b
        p = V @ jnp.linalg.solve(A_r, b_r)
        return jnp.sum(2.0 * K[:, -1] * p.reshape(n, n)[:, -1])

    def full_flux(k):
        K = DiffusionSimulation._conductivity(cfg, k, n)
        p = DiffusionSimulation._solve_pressure(cfg, K)
        return jnp.sum(2.0 * K[:, -1] * p[:, -1])

    return {"model": lambda keys: jax.vmap(reduced_flux)(keys),
            "full_model": lambda keys: jax.vmap(full_flux)(keys),
            "energy": energy, "rank": r,
            "wall_s": time.perf_counter() - t0}
