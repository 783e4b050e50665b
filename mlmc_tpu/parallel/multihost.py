"""Multi-host (pod / multi-slice) runtime glue.

The device-native replacement for the reference's PBS cluster backend
(reference mlmc/sampling_pool_pbs.py:48-437 + mlmc/tool/pbs_job.py:14-384):
where the reference packs samples into qsub jobs and polls qstat over a
shared filesystem, a pod run is ONE jax program over a global device mesh —
per-host shards of the sample axis execute locally, and the tiny per-level
accumulators ([R], [R, R]) reduce with psum over ICI within a slice and DCN
across slices. The HDF5/binary file is only a checkpoint, never the
transport.

Single-controller usage on each host::

    from mlmc_tpu.parallel import multihost
    multihost.initialize()            # jax.distributed handshake (no-op
                                      # for single-process runs)
    mesh = multihost.global_sample_mesh()
    step = sharded_mlmc_step(mesh, fns, moments_fn, n_per_level)
    accs = step(jax.random.key(0))    # identical on every host
    if multihost.is_coordinator():
        storage.save(...)             # host-side IO on process 0 only

Validated in-process on the forced 8-device CPU mesh (tests/conftest.py)
and via the driver's ``dryrun_multichip``; a real pod only changes
``jax.devices()``.
"""
import jax

from mlmc_tpu.parallel.mesh import SampleMesh


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """jax.distributed handshake; safe no-op for single-process runs.

    Pass the coordinator address (``localhost:<port>`` on one machine),
    process count and id explicitly where the environment names no
    cluster, as for CPU/GPU multi-process runs.
    """
    if num_processes is not None and num_processes <= 1:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError) as e:
        msg = str(e)
        # repeated handshake: idempotent no-op (jax phrases this as
        # 'should only be called once' / 'already initialized')
        if "already initialized" in msg or "only be called once" in msg:
            return
        # bare initialize() on a non-pod host: auto-detection finds no
        # cluster (no coordinator address) -> documented single-process
        # no-op rather than a crash
        if coordinator_address is None and num_processes is None \
                and "coordinator_address" in msg:
            return
        raise


def is_coordinator() -> bool:
    """True on the host that owns storage / scheduling (process 0)."""
    return jax.process_index() == 0


def n_hosts() -> int:
    return jax.process_count()


def global_sample_mesh() -> SampleMesh:
    """1-D ``samples`` mesh over ALL devices of all hosts."""
    return SampleMesh(jax.devices())


def local_sample_mesh() -> SampleMesh:
    """Mesh over this host's addressable devices only (per-host fan-out)."""
    return SampleMesh(jax.local_devices())
