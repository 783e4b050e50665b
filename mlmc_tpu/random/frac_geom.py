"""Fracture geometry — device-native fracture networks (+ gated mesh path).

The reference (mlmc/random/frac_geom.py:1-139) builds fractured-domain
UNSTRUCTURED meshes through the external ``geomop`` package and the gmsh
binary, to be solved by the external flow123d FEM code. Neither external
exists here, and a Device-first design does not want an unstructured mesh at
all: the fracture network is generated ON DEVICE and rasterized into the
conductivity grid of the device Darcy solver (sim/diffusion.py) — one
jitted program per coupled fine/coarse sample, vmapped over the batch.

Provided:

* ``sample_fracture_network`` — random fracture set: uniform centers,
  truncated power-law (Pareto) lengths, uniform or concentrated
  orientations; pure jnp over a PRNG key (replayable per sample index),
* ``fracture_min_distance`` / ``fracture_indicator`` — vectorized
  point-to-segment distances of all grid cell centers to all fractures,
* ``fracture_conductivity`` — bulk conductivity boosted by a fracture
  contrast factor where a fracture crosses the cell,
* ``FracturedDiffusionSimulation`` — Darcy MLMC simulation whose
  conductivity = log-normal GRF bulk x fracture network; the network and
  the GRF phases derive from the same per-sample key, so fine and coarse
  grids of one sample see the SAME geology (level coupling).

The reference's mesh-based entry point ``make_frac_mesh`` is kept as a
gated API for users who have geomop+gmsh installed externally.
"""
from typing import List

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.quantity.quantity_spec import QuantitySpec
from mlmc_tpu.sim.diffusion import DiffusionSimulation
from mlmc_tpu.sim.diffusion3d import DiffusionSimulation3D


# ===================================================================== #
# device fracture networks
# ===================================================================== #
def sample_fracture_network(key, n_fractures, box=((0.0, 0.0), (1.0, 1.0)),
                            size_range=(0.1, 0.6), power=1.8,
                            mean_angle=0.0, concentration=0.0):
    """Random fracture set as line segments.

    :param key: PRNG key (per sample -> replayable network)
    :param n_fractures: static count
    :param box: ((x0, y0), (x1, y1)) domain
    :param size_range: (min, max) fracture lengths (truncated Pareto)
    :param power: Pareto exponent of the length distribution (>1)
    :param mean_angle: preferred orientation (radians)
    :param concentration: 0 = isotropic (uniform angles); larger values
        concentrate angles around ``mean_angle`` (wrapped-normal with
        std = 1/sqrt(concentration))
    :return: segments [n_fractures, 2, 2] (endpoint pairs)
    """
    (x0, y0), (x1, y1) = box
    k_c, k_l, k_a = jax.random.split(key, 3)

    centers = jax.random.uniform(
        k_c, (n_fractures, 2),
        minval=jnp.array([x0, y0]), maxval=jnp.array([x1, y1]))

    # truncated Pareto via inverse CDF
    lo, hi = size_range
    u = jax.random.uniform(k_l, (n_fractures,))
    a = power - 1.0
    cdf_hi = 1.0 - (lo / hi) ** a
    lengths = lo * (1.0 - u * cdf_hi) ** (-1.0 / a)

    if concentration > 0:
        angles = mean_angle + jax.random.normal(k_a, (n_fractures,)) \
            / jnp.sqrt(concentration)
    else:
        angles = jax.random.uniform(k_a, (n_fractures,), maxval=np.pi)

    half = 0.5 * lengths[:, None] * jnp.stack(
        [jnp.cos(angles), jnp.sin(angles)], axis=1)
    return jnp.stack([centers - half, centers + half], axis=1)


def fracture_min_distance(segments, points):
    """Min distance of each point to any segment.

    :param segments: [F, 2, 2]
    :param points: [P, 2]
    :return: [P] distances
    """
    p0 = segments[:, 0, :]                      # [F, 2]
    d = segments[:, 1, :] - p0                  # [F, 2]
    len2 = jnp.maximum(jnp.sum(d * d, axis=1), 1e-30)
    rel = points[:, None, :] - p0[None, :, :]   # [P, F, 2]
    t = jnp.clip(jnp.einsum("pfk,fk->pf", rel, d) / len2, 0.0, 1.0)
    closest = p0[None] + t[..., None] * d[None]
    return jnp.min(jnp.linalg.norm(points[:, None, :] - closest, axis=-1),
                   axis=1)


def fracture_indicator(segments, n, box=((0.0, 0.0), (1.0, 1.0)),
                       aperture=0.0):
    """[n, n] float mask of grid cells crossed by a fracture.

    A cell counts as fractured when its center lies within
    ``max(aperture, h) / 2`` of a segment (a fracture is always at least
    one cell wide — the coarse-grid inability to resolve thin fractures is
    exactly the discretization error MLMC telescopes over).
    """
    (x0, y0), (x1, y1) = box
    h = (x1 - x0) / n
    cx = x0 + (jnp.arange(n) + 0.5) * h
    cy = y0 + (jnp.arange(n) + 0.5) * ((y1 - y0) / n)
    X, Y = jnp.meshgrid(cx, cy, indexing="ij")
    pts = jnp.stack([X.ravel(), Y.ravel()], axis=1)
    dist = fracture_min_distance(segments, pts)
    radius = jnp.maximum(aperture, h) * 0.5
    return (dist <= radius).astype(jnp.float32).reshape(n, n)


def fracture_conductivity(segments, n, bulk_K, contrast,
                          box=((0.0, 0.0), (1.0, 1.0)), aperture=0.0):
    """Bulk conductivity boosted multiplicatively inside fractures."""
    ind = fracture_indicator(segments, n, box=box, aperture=aperture)
    return bulk_K * jnp.where(ind > 0, contrast, 1.0)


# ===================================================================== #
# MLMC simulation: fractured Darcy flow
# ===================================================================== #
class FracturedDiffusionSimulation(DiffusionSimulation):
    """Darcy flow through a fractured medium — device-native replacement of
    the reference's geomop+gmsh+flow123d fracture workflow.

    Config keys (on top of DiffusionSimulation's):
      n_fractures (default 24), frac_contrast (default 1e3),
      frac_size_range, frac_power, frac_mean_angle, frac_concentration,
      frac_aperture (physical; cells are at least one h wide).
    """

    # Discontinuous 1e3-contrast fracture channels put eigenvalue clusters
    # beyond any diagonal/spectral scaling's reach: measured CG at 64^2
    # needs up to ~24n scaled-spectral iterations (914 at the worst of 8
    # draws), and a vmapped batch pays its worst sample. The geometric
    # multigrid V-cycle preconditioner's coarse-space correction removes
    # the channel modes too: <=67 iterations on the same fields, so MG is
    # the class default. The spectral cap stays raised for users who
    # override precond (the smooth-field default of 10n silently returned
    # fluxes 3-43% off on these fields).
    PRECOND = "mg"
    CG_MAXITER_FACTOR = 32

    @classmethod
    def _conductivity(cls, config, key, n, phases=None):
        if phases is not None:
            raise ValueError(
                "fractured conductivity has key-driven geometry randomness "
                "beyond the field phases; no QMC parametrization")
        k_field, k_frac = jax.random.split(key)
        bulk = super()._conductivity(config, k_field, n)
        segments = sample_fracture_network(
            k_frac,
            n_fractures=config.get("n_fractures", 24),
            size_range=config.get("frac_size_range", (0.1, 0.5)),
            power=config.get("frac_power", 1.8),
            mean_angle=config.get("frac_mean_angle", 0.0),
            concentration=config.get("frac_concentration", 0.0))
        return fracture_conductivity(
            segments, n, bulk,
            contrast=config.get("frac_contrast", 1e3),
            aperture=config.get("frac_aperture", 0.0))


# ===================================================================== #
# 3-D fracture networks: penny-shaped discs
# ===================================================================== #
def sample_fracture_network_3d(key, n_fractures,
                               box=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
                               size_range=(0.1, 0.6), power=2.2,
                               mean_normal=None, concentration=0.0):
    """Random 3-D fracture set as penny-shaped discs (the standard DFN
    primitive): centers uniform in the box, radii truncated-Pareto
    (``power`` is the exponent of the RADIUS distribution), normals
    uniform on the sphere — or concentrated around ``mean_normal``
    (Gaussian perturbation with std 1/sqrt(concentration), then
    renormalized: a cheap Fisher-like family).

    :return: (centers [F, 3], normals [F, 3] unit, radii [F])
    """
    (x0, y0, z0), (x1, y1, z1) = box
    k_c, k_r, k_n = jax.random.split(key, 3)
    centers = jax.random.uniform(
        k_c, (n_fractures, 3),
        minval=jnp.array([x0, y0, z0]), maxval=jnp.array([x1, y1, z1]))
    lo, hi = size_range
    u = jax.random.uniform(k_r, (n_fractures,))
    a = power - 1.0
    cdf_hi = 1.0 - (lo / hi) ** a
    radii = 0.5 * lo * (1.0 - u * cdf_hi) ** (-1.0 / a)
    normals = jax.random.normal(k_n, (n_fractures, 3))
    if mean_normal is not None and concentration > 0:
        mu = jnp.asarray(mean_normal, normals.dtype)
        mu = mu / jnp.linalg.norm(mu)
        normals = mu[None, :] + normals / jnp.sqrt(concentration)
    normals = normals / jnp.maximum(
        jnp.linalg.norm(normals, axis=1, keepdims=True), 1e-30)
    return centers, normals, radii


def fracture_indicator_3d(discs, n,
                          box=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
                          aperture=0.0):
    """[n, n, n] float mask of grid cells crossed by a disc fracture:
    a cell counts when its center lies within ``max(aperture, h)/2`` of
    the disc plane AND inside the disc radius in-plane (a fracture is
    always at least one cell thick — the coarse grid's inability to
    resolve thin fractures is the discretization error MLMC telescopes
    over, exactly as in the 2-D variant)."""
    centers, normals, radii = discs
    (x0, y0, z0), (x1, y1, z1) = box
    h = (x1 - x0) / n
    X, Y, Z = jnp.meshgrid(
        x0 + (jnp.arange(n) + 0.5) * h,
        y0 + (jnp.arange(n) + 0.5) * ((y1 - y0) / n),
        z0 + (jnp.arange(n) + 0.5) * ((z1 - z0) / n),
        indexing="ij")
    pts = jnp.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    rel = pts[:, None, :] - centers[None, :, :]         # [P, F, 3]
    dist_n = jnp.einsum("pfk,fk->pf", rel, normals)     # signed normal
    inplane2 = jnp.sum(rel * rel, axis=2) - dist_n ** 2
    thick = jnp.maximum(aperture, h) * 0.5
    hit = ((jnp.abs(dist_n) <= thick)
           & (inplane2 <= radii[None, :] ** 2))
    return jnp.any(hit, axis=1).astype(jnp.float32).reshape(n, n, n)


def fracture_conductivity_3d(discs, n, bulk_K, contrast,
                             box=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
                             aperture=0.0):
    """Bulk conductivity boosted multiplicatively inside fractures."""
    ind = fracture_indicator_3d(discs, n, box=box, aperture=aperture)
    return bulk_K * jnp.where(ind > 0, contrast, 1.0)


class FracturedDiffusionSimulation3D(DiffusionSimulation3D):
    """3-D Darcy flow through a fractured medium: penny-shaped disc
    networks rasterized into the log-normal bulk conductivity, solved
    under the 3-D geometric-multigrid V-cycle (exact Galerkin coarse
    transmissibilities keep the fracture channels on the coarse
    interfaces — the same reason MG is the 2-D fractured default).

    Config keys (on top of DiffusionSimulation3D's):
      n_fractures (default 24), frac_contrast (default 1e3),
      frac_size_range, frac_power, frac_mean_normal,
      frac_concentration, frac_aperture.
    """

    PRECOND = "mg"
    CG_MAXITER_FACTOR = 32

    @classmethod
    def _conductivity(cls, config, key, n, phases=None):
        if phases is not None:
            raise ValueError(
                "fractured conductivity has key-driven geometry "
                "randomness beyond the field phases; no QMC "
                "parametrization")
        k_field, k_frac = jax.random.split(key)
        bulk = super()._conductivity(config, k_field, n)
        discs = sample_fracture_network_3d(
            k_frac,
            n_fractures=config.get("n_fractures", 24),
            size_range=config.get("frac_size_range", (0.15, 0.6)),
            power=config.get("frac_power", 2.2),
            mean_normal=config.get("frac_mean_normal"),
            concentration=config.get("frac_concentration", 0.0))
        return fracture_conductivity_3d(
            discs, n, bulk,
            contrast=config.get("frac_contrast", 1e3),
            aperture=config.get("frac_aperture", 0.0))


# ===================================================================== #
# external geomop mesh path: FORMALLY DESCOPED (see COMPONENTS.md)
# ===================================================================== #
def make_frac_mesh(box, mesh_step, fractures, frac_step):
    """DESCOPED: the reference's geomop-bridge mesh builder
    (reference mlmc/random/frac_geom.py:17-30).

    The reference function drives the external, pip-uninstallable
    ``geomop`` layer-geometry package plus the ``gmsh`` binary to produce a
    fractured-domain mesh for Flow123d. Neither external exists in any
    supported environment of this framework (the reference itself cannot
    run it outside the authors' cluster), so this surface is formally
    descoped rather than shipped as untestable code:

    * fractured-domain MLMC runs natively on device via
      :class:`FracturedDiffusionSimulation` (rasterized fracture
      conductivity, no meshing step),
    * externally produced fracture meshes load through
      ``mlmc_tpu.tool.gmsh_io.GmshIO`` and run through ``FlowSim``.
    """
    raise ImportError(
        "make_frac_mesh is descoped: it requires the external 'geomop' "
        "package + gmsh binary (reference mlmc/random/frac_geom.py:17-30), "
        "which are not installable. Use FracturedDiffusionSimulation "
        "(device-native) or load a pre-built mesh via "
        "mlmc_tpu.tool.gmsh_io.GmshIO. See COMPONENTS.md.")
