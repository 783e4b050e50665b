"""Sample persistence contract + in-memory backend.

Re-design of reference mlmc/sample_storage.py:9-338. The contract (chunked
[M, N, 2] reads, scheduled/failed bookkeeping, n_ops cost accounting) is kept
so the Quantity layer and the Sampler are backend-agnostic. ``Memory`` holds
per-level contiguous numpy arrays (host pinned staging for the device
estimators); the HDF5 backend lives in sample_storage_hdf.py.
"""
import itertools
import numpy as np
from abc import ABCMeta, abstractmethod
from typing import List, Dict

from mlmc_tpu.quantity.quantity_spec import QuantitySpec, ChunkSpec


def _pow2_at_least(n, floor=1024):
    return max(floor, 1 << int(max(n, 1) - 1).bit_length())


def _device_append(buf, pairs, n):
    """Write ``pairs`` into the capacity buffer at row ``n`` (jitted once
    per (capacity, slice) shape pair — every device op in the append path
    must have bucket-stable shapes: over a remote-attached chip each NEW
    eager-op shape costs an executable compile/load, which dominated the
    adaptive loop's wall time in round 2)."""
    import jax
    import jax.numpy as jnp

    global _DEVICE_APPEND_JIT
    try:
        fn = _DEVICE_APPEND_JIT
    except NameError:
        def write(buf, pairs, n):
            zero = jnp.zeros((), n.dtype)
            return jax.lax.dynamic_update_slice(
                buf, pairs, (n,) + (zero,) * (pairs.ndim - 1))

        fn = _DEVICE_APPEND_JIT = jax.jit(write, donate_argnums=0)
    return fn(buf, pairs, jnp.asarray(n, jnp.int32))

# default number of samples per streamed chunk (Memory storage streams one
# chunk per level; chunking matters for the HDF/out-of-core backends)
DEFAULT_CHUNK_SAMPLES = 512 * 1024


class SampleStorage(metaclass=ABCMeta):
    """Store and retrieve sample data (results, schedules, costs)."""

    #: payloads live in RAM/HBM (whole-level gathers are cheap); out-of-core
    #: backends (HDF5, binary log) leave this False and stream chunks
    payload_resident = False

    @abstractmethod
    def save_samples(self, successful_samples, failed_samples):
        """Write results to storage."""

    def save_samples_bulk(self, level_id, ids, fine, coarse):
        """Bulk write path: whole level batch as arrays (no per-sample
        tuples). Default adapter wraps into the tuple contract; array-native
        backends override. fine/coarse: [N, M]."""
        res = [(sid, (f, c)) for sid, f, c in zip(ids, fine, coarse)]
        self.save_samples({level_id: res}, {})

    @abstractmethod
    def save_result_format(self, res_spec: List[QuantitySpec]):
        """Save result format."""

    @abstractmethod
    def load_result_format(self) -> List[QuantitySpec]:
        """Load result format."""

    @abstractmethod
    def save_global_data(self, result_format: List[QuantitySpec], level_parameters=None):
        """Save global data: result_format, level_parameters."""

    @abstractmethod
    def save_scheduled_samples(self, level_id, samples):
        """Save scheduled sample ids."""

    @abstractmethod
    def load_scheduled_samples(self):
        """:return: Dict[level_id, List[sample_id: str]]"""

    @abstractmethod
    def sample_pairs(self):
        """:return: List[Array[M, N, 2]]"""

    def chunks(self, level_id=None, n_samples=None):
        """Generator of ChunkSpec over levels (reference sample_storage.py:58-69)."""
        assert isinstance(n_samples, (type(None), int)), "n_samples param must be int"
        level_ids = self.get_level_ids()
        if level_id is not None:
            level_ids = [level_id]
        return itertools.chain(*[self._level_chunks(lid, n_samples) for lid in level_ids])

    @abstractmethod
    def _level_chunks(self, level_id, n_samples=None):
        """Generator of ChunkSpec for one level."""

    @abstractmethod
    def n_finished(self):
        """Number of finished samples per level."""

    @abstractmethod
    def save_n_ops(self, n_ops: Dict[int, List[float]]):
        """Save per-level cost accounting [total time, n samples]."""

    @abstractmethod
    def get_n_ops(self):
        """Cost (time) per sample for each level."""

    @abstractmethod
    def unfinished_ids(self):
        """Get unfinished sample ids."""

    @abstractmethod
    def get_level_ids(self):
        """List of level ids."""

    @abstractmethod
    def get_n_levels(self):
        """Number of levels."""

    @abstractmethod
    def get_level_parameters(self):
        """Level parameters (simulation steps)."""

    @abstractmethod
    def get_n_collected(self):
        """Number of collected results per level."""


class _LevelData:
    """One level's complete in-RAM state (results, identity, bookkeeping).

    The reference spreads this over seven parallel dicts keyed by level id
    (reference :144-158); keeping each level cohesive makes the append path
    one method and lets DeviceMemory swap just the array module.

    Host (numpy) appends collect SEGMENTS merged lazily on first read — an
    adaptive round writes many batches before the next estimate, and eager
    per-append concatenation would copy the whole store each time.

    Device (HBM) appends write into a power-of-two CAPACITY buffer via a
    single jitted dynamic_update_slice: appended slices may be LONGER than
    their valid count (bucket-padded device batches pass through without
    any eager slicing — every device op keeps bucket-stable shapes, so the
    remote-compile executable set stays O(log n) over a whole adaptive
    run). Rows past ``n`` are garbage by contract; estimation programs
    mask by position and legacy readers slice ``pairs``.
    """

    __slots__ = ("_segments", "_buf", "_n", "_reserve", "ids", "failed",
                 "scheduled", "n_ops", "n_finished")

    def __init__(self):
        self._segments = []        # host mode: list of [n_i, 2, M] numpy
        self._buf = None           # device mode: [cap, 2, M] jax array
        self._n = 0                # device mode: valid rows in _buf
        self._reserve = 0          # device mode: requested min capacity
        self.ids = None            # TagChain of successful sample ids
        self.failed = []           # [(sample_id, message)]
        self.scheduled = None      # TagChain of scheduled ids
        self.n_ops = None          # latest cumulative [total time, n] report
        self.n_finished = 0        # successful + failed

    def append_pairs(self, ids, pairs, xp=np, n_valid=None):
        from mlmc_tpu.tags import TagChain

        if self.ids is None:
            self.ids = TagChain()
        self.ids.extend(ids)
        n_valid = pairs.shape[0] if n_valid is None else int(n_valid)
        self.n_finished += n_valid
        if xp is np:
            self._segments.append(pairs[:n_valid])
            return
        # device mode: grow capacity so the whole (possibly padded) slice
        # fits without dynamic_update_slice clamping; honor any reservation
        # so the adaptive loop's buffer shape jumps straight to the final
        # power of two (fewer distinct estimation-program shapes -> fewer
        # remote AOT compiles / persistent-cache entries)
        need = max(self._n + pairs.shape[0], self._reserve)
        if self._buf is None:
            cap = _pow2_at_least(need)
            self._buf = xp.zeros((cap,) + pairs.shape[1:], pairs.dtype)
        elif pairs.dtype != self._buf.dtype:
            # mixed-precision batches on one level: the jitted
            # dynamic_update_slice rejects a dtype-mismatched update
            pairs = pairs.astype(self._buf.dtype)
        if need > self._buf.shape[0]:
            cap = _pow2_at_least(need, floor=2 * self._buf.shape[0])
            grown = xp.zeros((cap,) + self._buf.shape[1:], self._buf.dtype)
            self._buf = _device_append(grown, self._buf, 0)
        self._buf = _device_append(self._buf, pairs, self._n)
        self._n += n_valid

    def reserve(self, n_rows, xp=np):
        """Request capacity for ``n_rows`` total rows (device mode only).

        Called by the sampler when it schedules a new per-level target: the
        next append grows the buffer ONCE to the target's power-of-two
        instead of doubling through every intermediate capacity, so all
        later adaptive rounds share a single buffer shape (executable).
        """
        if xp is np:
            return  # host segments carry no shape-keyed programs
        self._reserve = max(self._reserve, int(n_rows))
        if (self._buf is not None
                and self._reserve > self._buf.shape[0]):
            cap = _pow2_at_least(self._reserve)
            grown = xp.zeros((cap,) + self._buf.shape[1:], self._buf.dtype)
            self._buf = _device_append(grown, self._buf, 0)

    @property
    def pairs(self):
        """[N, 2, M] valid payload (host segments merged + cached; device
        buffers sliced to the valid count)."""
        if self._buf is not None:
            return self._buf[:self._n]
        if not self._segments:
            return None
        if len(self._segments) > 1:
            self._segments = [np.concatenate(self._segments, axis=0)]
        return self._segments[0]

    @property
    def raw_payload(self):
        """(payload in native [N_cap, 2, M] layout, valid count) without
        slicing: device capacity buffers pass through whole (tail rows are
        garbage, mask by position)."""
        if self._buf is not None:
            return self._buf, self._n
        return self.pairs, self.n_collected

    @property
    def n_collected(self):
        if self._buf is not None:
            return int(self._n)
        return int(sum(seg.shape[0] for seg in self._segments))


class Memory(SampleStorage):
    """In-RAM storage: per-level [N, 2, M] float arrays (reference :135-338),
    each level held as one cohesive ``_LevelData`` record."""

    payload_resident = True

    #: array module for the result payload (DeviceMemory: jax.numpy)
    @staticmethod
    def _xp():
        return np

    def __init__(self, chunk_size=None):
        self._levels = {}          # level_id -> _LevelData
        self._result_specification = []
        self._level_parameters = []
        # in samples per chunk; None = single chunk per level
        self._chunk_size = chunk_size
        super().__init__()

    def _level(self, level_id) -> _LevelData:
        return self._levels.setdefault(level_id, _LevelData())

    def _levels_with_results(self):
        return [lid for lid, st in self._levels.items() if st.n_collected]

    def _level_span(self):
        """Number of KNOWN levels (scheduled, failed, costed or filled).

        Per-level vectors must span every known level, not just those
        that happen to have data yet — the sampler's wait loop and the
        estimator's ``range(get_n_levels())`` both index by level id, so
        an array sized by "levels with results" goes out of bounds (or
        silently drops a trailing level) whenever a high level is still
        empty or entirely failed."""
        return max(self._levels) + 1 if self._levels else 0

    # -------------------------------------------------------------- write
    def save_samples(self, successful_samples, failed_samples):
        self._save_successful(successful_samples)
        for level_id, res in failed_samples.items():
            if len(res):
                level = self._level(level_id)
                level.failed.extend(res)
                level.n_finished += len(res)

    def save_samples_bulk(self, level_id, ids, fine, coarse):
        """``fine``/``coarse`` rows past ``len(ids)`` are bucket padding
        (device pools hand over whole padded batches so no device op ever
        needs a batch-specific shape); only the first len(ids) rows count."""
        xp = self._xp()
        n_valid = len(ids)
        if xp is np:
            fine = np.asarray(fine)[:n_valid]
            coarse = np.asarray(coarse)[:n_valid]
        pairs = xp.stack([xp.asarray(fine), xp.asarray(coarse)], axis=1)
        if pairs.dtype != np.float64 and xp is np:
            pairs = pairs.astype(np.float64)
        self._level(level_id).append_pairs(ids, pairs, xp=xp,
                                           n_valid=n_valid)

    def raw_level_payload(self, level_id):
        """(native-layout payload [N_cap, 2, M], valid count) for the
        single-dispatch estimation tiers — device buffers are returned
        WHOLE (capacity tail is garbage, masked by position downstream) so
        no eager device slicing happens on the hot path."""
        return self._levels[int(level_id)].raw_payload

    def reserve_capacity(self, level_id, n_rows):
        """Hint the final per-level sample count (called by the sampler at
        scheduling time): device-resident levels grow their capacity buffer
        straight to the target's power of two, so every adaptive round after
        the first estimates over ONE buffer shape instead of recompiling at
        each intermediate doubling. Host mode is a no-op."""
        self._level(level_id).reserve(n_rows, xp=self._xp())

    def _save_successful(self, samples):
        """:param samples: Dict[level_id, List[Tuple[sample_id, (fine, coarse)]]]"""
        for level_id, res in samples.items():
            if len(res) == 0:
                continue
            ids = [s_id for s_id, _ in res]
            fine = np.stack([np.ravel(f) for _, (f, _c) in res])
            coarse = np.stack([np.ravel(c) for _, (_f, c) in res])
            self.save_samples_bulk(level_id, ids, fine, coarse)

    def save_global_data(self, result_format, level_parameters=None):
        self.save_result_format(result_format)
        self._level_parameters = level_parameters

    def save_result_format(self, res_spec: List[QuantitySpec]):
        self._result_specification = res_spec

    def save_scheduled_samples(self, level_id, samples):
        from mlmc_tpu.tags import TagChain

        level = self._level(level_id)
        if level.scheduled is None:
            level.scheduled = TagChain()
        level.scheduled.extend(samples)

    def save_n_ops(self, n_ops):
        """:param n_ops: iterable of (level_id, [total time, n_samples]).

        Pools report CUMULATIVE totals per drain, so the latest report
        REPLACES the record (the reference re-adds a rate on every poll,
        inflating C_l by the number of drains).
        """
        for level_id, (time, n_samples) in n_ops:
            self._level(level_id).n_ops = [float(time), float(n_samples)]

    # --------------------------------------------------------------- read
    def load_result_format(self) -> List[QuantitySpec]:
        return self._result_specification

    def load_scheduled_samples(self):
        return {lid: st.scheduled for lid, st in self._levels.items()
                if st.scheduled is not None}

    def n_finished(self):
        out = np.zeros(self._level_span())
        for lid, st in self._levels.items():
            out[lid] = st.n_finished
        return out

    def sample_pairs(self):
        # indexed by level id: a level whose samples ALL failed leaves a
        # None slot instead of shifting (or crashing) the later levels
        out = [None] * self._level_span()
        for lid in self._levels_with_results():
            out[lid] = self.sample_pairs_level(ChunkSpec(level_id=lid))
        return out

    def _level_chunks(self, level_id, n_samples=None):
        n_total = self._levels[level_id].n_collected
        if n_samples is not None:
            n_total = min(n_total, n_samples)
        chunk = self._chunk_size or n_total or 1
        for i, start in enumerate(range(0, max(n_total, 1), chunk)):
            yield ChunkSpec(
                chunk_id=i,
                chunk_slice=slice(start, min(start + chunk, n_total), 1),
                level_id=level_id,
            )

    def sample_pairs_level(self, chunk_spec):
        """:return: array [M, chunk size, 2] (level 0: [M, chunk size, 1])"""
        pairs = self._levels[int(chunk_spec.level_id)].pairs
        if pairs is None:
            # a known level with zero collected results (all failed or
            # still scheduled): an empty chunk, correctly shaped
            m = sum(int(np.prod(spec.shape)) * len(spec.times)
                    * len(spec.locations)
                    for spec in self._result_specification)
            pairs = np.zeros((0, 2, m))
        if chunk_spec.chunk_slice is not None:
            pairs = pairs[chunk_spec.chunk_slice]
        # level 0 has no coarse part: strip the auxiliary zero slot
        if chunk_spec.level_id == 0:
            pairs = pairs[:, :1, :]
        return pairs.transpose((2, 0, 1))  # [M, chunk size, 2]

    def get_n_ops(self):
        # every KNOWN level appears, including cost 0.0 for levels that
        # have not reported yet (a missing entry would desynchronize the
        # allocation formula's cost vector from the variance vector)
        out = [0.0] * self._level_span()
        for lid, st in self._levels.items():
            if st.n_ops is not None:
                t, n = st.n_ops
                out[lid] = t / n if n else 0.0
        return out

    def unfinished_ids(self):
        return []

    def failed_samples(self):
        return {str(lid): [s_id for s_id, _ in st.failed]
                for lid, st in self._levels.items() if st.failed}

    def clear_failed(self):
        for st in self._levels.values():
            st.failed = []

    def get_level_ids(self):
        return self._levels_with_results()

    def get_n_collected(self):
        out = [0] * self._level_span()
        for lid in self._levels_with_results():
            out[int(lid)] = self._levels[lid].n_collected
        return out

    def get_n_levels(self):
        # ALL known levels (reference: the HDF backend counts level
        # groups) — not just levels that already hold results
        return self._level_span()

    def get_level_parameters(self):
        return self._level_parameters


class DeviceMemory(Memory):
    """Device-resident storage: per-level results stay DEVICE arrays end to
    end.

    SURVEY §2's designated device equivalent of the reference Memory storage
    ("HBM-resident per-level ring buffers"). With a DeviceBatchPool running
    ``device_results=True``, samples are produced, stored, and estimated
    without ever crossing the host<->device link, which would otherwise
    carry every estimation pass (a 1e6-sample x 30-component chunk is
    ~0.1 GB per pass).

    The id/cost/failure bookkeeping stays on host (tiny); only the result
    payload lives in HBM — the only difference from Memory is the array
    module carrying ``pairs``.
    """

    @staticmethod
    def _xp():
        import jax.numpy as jnp

        return jnp
