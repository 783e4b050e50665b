"""Multi-chip MLMC estimation step: shard_map over the ``samples`` axis.

The full "training step" of this framework — draw every level's sample
batch, push it through the fused moment/covariance pipeline, and reduce the
accumulators across the devices with psum — as ONE jitted program over a
``jax.sharding.Mesh``. This is what the reference spreads over PBS jobs +
YAML files + qstat polling (reference mlmc/sampling_pool_pbs.py:48-437,
mlmc/tool/pbs_job.py:14-384), collapsed into XLA collectives.
"""
import jax
from jax.sharding import PartitionSpec as P

from mlmc_tpu.ops.fused_estimate import fused_mlmc_moments
from mlmc_tpu.parallel.mesh import SampleMesh, shard_map_norep


def sharded_mlmc_step(
    sample_mesh: SampleMesh,
    sim_chunk_fns,
    moments_fn,
    n_samples_per_level,
    chunk_size: int = 65536,
    acc_dtype=None,
):
    """Build the jitted multi-chip MLMC step.

    :param sample_mesh: SampleMesh over the participating devices
    :param sim_chunk_fns: per-level ``f(keys [C]) -> (fine, coarse, failed)``
    :param moments_fn: moment basis
    :param n_samples_per_level: static per-level sample counts
    :return: ``step(root_key) -> list[MomentAccumulators]`` (jitted); the
        accumulators come back replicated (already psum-reduced).

    Chunks are strided over the mesh axis inside ``fused_level_moments`` so
    sample index -> PRNG key mapping is identical for any device count —
    results are bitwise mesh-shape-independent (up to reduction order).
    """
    axis = sample_mesh.axis_name
    mesh = sample_mesh.mesh

    def _step(root_key):
        return fused_mlmc_moments(
            sim_chunk_fns,
            moments_fn,
            root_key,
            n_samples_per_level,
            chunk_size=chunk_size,
            acc_dtype=acc_dtype,
            axis_name=axis,
        )

    sharded = shard_map_norep(
        _step,
        mesh,
        in_specs=(P(),),      # replicated key
        out_specs=P(),        # psum-reduced accumulators, replicated
    )
    return jax.jit(sharded)


def sharded_synth_pipeline_from_noise(
    sample_mesh: SampleMesh,
    n_moments,
    level_steps,
    *,
    domain,
    chunk: int = 1024,
):
    """Synthetic levels from given noise on the whole mesh: per-level noise
    arrays shard over the ``samples`` axis, every device runs the packed
    stored-sample pipeline (ops/fused_estimate) on its share, and the
    accumulators psum.

    :return: ``step(*noise_per_level) -> list[SynthMomentResult]`` (jitted,
        replicated / psum-reduced). Each noise array's length must divide
        by ``n_devices * chunk``.
    """
    from mlmc_tpu.ops.fused_estimate import (
        mlmc_moment_pipeline_from_samples, pack_level_samples, synth_qoi)

    axis = sample_mesh.axis_name
    mesh = sample_mesh.mesh
    L = len(level_steps)

    def _step(*noise_per_level):
        fine_l, coarse_l = [], []
        for lvl, (x, h) in enumerate(zip(noise_per_level, level_steps)):
            fine, coarse = synth_qoi(
                x, h, level_steps[lvl - 1] if lvl else 0.0)
            fine_l.append(fine)
            coarse_l.append(coarse if lvl else None)
        fine, coarse, counts = pack_level_samples(fine_l, coarse_l,
                                                  chunk=chunk)
        res = mlmc_moment_pipeline_from_samples(
            fine, coarse, counts, n_moments, domain=tuple(domain),
            chunk=chunk)
        return [type(r)(*(jax.lax.psum(field, axis) for field in r))
                for r in res]

    sharded = shard_map_norep(
        _step,
        mesh,
        in_specs=(P(axis),) * L,
        out_specs=P(),
    )
    return jax.jit(sharded)
