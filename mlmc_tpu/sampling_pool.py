"""Sample execution runtimes (pools).

Re-design of reference mlmc/sampling_pool.py:16-337. The pool contract is
kept (``schedule_sample`` / ``get_finished`` / ``have_permanent_samples``)
but the center of gravity moves on-device:

* ``DeviceBatchPool`` — THE device runtime: scheduled sample ids become PRNG
  keys (``fold_in(level_key, sample_index)``), a whole level batch runs as
  one jitted vmapped computation, results stay as device arrays until the
  storage stages them. Failure injection/NaN results become failed samples
  with reproducible (level, index, attempt) provenance. Batches are padded
  to bucket sizes so XLA reuses compiled executables across adaptive rounds.
* ``OneProcessPool`` / ``ProcessPool`` / ``ThreadPool`` — host loops kept
  for simulations that cannot express a device batch path (external
  binaries, workspace simulations), matching reference semantics including
  md5(sample_id) seeding (reference sampling_pool.py:75-84).
"""
import collections
import os
import shutil
import sys
import time
import hashlib
import traceback
import numpy as np
import jax
import jax.numpy as jnp
from abc import ABC, abstractmethod

from mlmc_tpu.level_simulation import LevelSimulation


# bulk level results: arrays instead of per-sample tuples (storages with
# save_samples_bulk consume these without marshalling)
BulkResults = collections.namedtuple("BulkResults", ["ids", "fine", "coarse"])


def _round_up_bucket(n, min_bucket=256):
    """Next power-of-two bucket ≥ n (bounds the number of XLA compilations)."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


class _SampleWorkspace:
    """Per-sample scratch-directory lifecycle for host simulations.

    Mirrors the reference semantics (sampling_pool.py:26-51,128-204): each
    workspace sample runs in ``<output>/<sample_id>`` seeded with the
    simulation's common files; on completion the directory is dropped —
    except the first ``KEEP_SUCCESSFUL`` successful samples (archived for
    inspection) and every failed sample (archived for debugging).
    """

    FAILED_DIR = "failed"
    SUCCESSFUL_DIR = "several_successful"
    KEEP_SUCCESSFUL = 5

    def __init__(self, work_dir=None, debug=False):
        self.debug = debug
        self.output_dir = (os.path.join(os.path.abspath(work_dir), "output")
                           if work_dir is not None else None)
        for sub in ("", self.FAILED_DIR, self.SUCCESSFUL_DIR):
            self._fresh_dir(sub)

    def _fresh_dir(self, sub=""):
        if self.output_dir is None:
            return None
        path = os.path.join(self.output_dir, sub)
        if not self.debug and os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path, mode=0o775, exist_ok=True)
        return path

    def default_to_cwd(self):
        """Late-bind the output dir for pools created without work_dir."""
        if self.output_dir is None:
            self.output_dir = os.getcwd()

    def sample_dir(self, sample_id):
        path = os.path.join(self.output_dir, sample_id)
        os.makedirs(path, mode=0o775, exist_ok=True)
        return path

    def enter(self, sample_id, level_sim):
        """Create + populate the sample dir and chdir into it."""
        path = self.sample_dir(sample_id)
        for f in level_sim.common_files or ():
            shutil.copy(f, path)
        os.chdir(path)

    def _archive(self, sample_id, sub):
        target = os.path.join(self.output_dir, sub, sample_id)
        shutil.rmtree(target, ignore_errors=True)
        shutil.copytree(self.sample_dir(sample_id), target)

    def finish(self, sample_id, level_sim, failed):
        """Archive-or-drop the sample dir after the result is in."""
        if not level_sim.need_sample_workspace or self.output_dir is None:
            return
        if failed:
            self._archive(sample_id, self.FAILED_DIR)
        elif int(sample_id[-7:]) < self.KEEP_SUCCESSFUL:
            self._archive(sample_id, self.SUCCESSFUL_DIR)
        shutil.rmtree(self.sample_dir(sample_id), ignore_errors=True)


def _expected_result_len(result_format):
    return int(sum(np.prod(spec.shape) * len(spec.times) * len(spec.locations)
                   for spec in result_format))


class SamplingPool(ABC):
    """Runtime environment for samples (reference sampling_pool.py:16-126)."""

    # kept as class attrs for API parity with reference scripts
    FAILED_DIR = _SampleWorkspace.FAILED_DIR
    SEVERAL_SUCCESSFUL_DIR = _SampleWorkspace.SUCCESSFUL_DIR
    N_SUCCESSFUL = _SampleWorkspace.KEEP_SUCCESSFUL

    def __init__(self, work_dir=None, debug=False):
        self._workspace = _SampleWorkspace(work_dir, debug)
        self._debug = debug

    @property
    def _output_dir(self):
        return self._workspace.output_dir

    @abstractmethod
    def schedule_sample(self, sample_id, level_sim: LevelSimulation):
        """Queue one sample for calculation."""

    @abstractmethod
    def have_permanent_samples(self, sample_ids):
        """Inform the pool about scheduled-but-unfinished ids (resume)."""

    @abstractmethod
    def get_finished(self):
        """:return: (successful, failed, n_running, n_ops) per level."""

    @staticmethod
    def compute_seed(sample_id):
        """md5(sample_id) -> uint32 (parity with reference :75-84)."""
        digest = hashlib.md5(sample_id.encode("ascii")).digest()
        return np.frombuffer(digest, dtype="uint32")[0]

    @staticmethod
    def calculate_sample(sample_id, level_sim, work_dir=None, seed=None):
        """Single-sample wrapper: reproducible seed, wall-time measurement,
        result-shape validation, exception -> traceback string."""
        if seed is None:
            seed = SamplingPool.compute_seed(sample_id)
        if level_sim.need_sample_workspace:
            ws = _SampleWorkspace.__new__(_SampleWorkspace)
            ws.output_dir = work_dir
            ws.debug = True  # enter() only; lifecycle handled by the pool
            ws.enter(sample_id, level_sim)
        try:
            start = time.perf_counter()
            result = level_sim.calculate(level_sim.config_dict, seed)
            elapsed = time.perf_counter() - start
            fine, coarse = result[0], result[1]
            if isinstance(fine, np.ndarray) and isinstance(coarse, np.ndarray):
                want = _expected_result_len(level_sim.result_format)
                got = (fine.size, coarse.size)
                if got != (want, want):
                    raise ValueError(
                        "result shape mismatch: expected {} values per "
                        "part, got fine={} coarse={}".format(want, *got))
        except Exception:
            err = "".join(traceback.format_exception(*sys.exc_info()))
            return sample_id, (None, None), err, 0
        return sample_id, result, "", elapsed


class OneProcessPool(SamplingPool):
    """Everything runs inline in one process (reference :207-294).

    Collection is plain per-level lists — results are produced and drained
    on the pool-owner's thread only (ProcessPool/ThreadPool also process
    futures inside ``get_finished``), so no lock is needed.
    """

    def __init__(self, work_dir=None, debug=False):
        super().__init__(work_dir=work_dir, debug=debug)
        self._done = {}    # level_id -> [(sample_id, (fine, coarse))]
        self._errors = {}  # level_id -> [(sample_id, message)]
        self._n_running = 0
        self.times = {}    # level_id -> [total seconds, n samples]

    def schedule_sample(self, sample_id, level_sim):
        self._n_running += 1
        if level_sim.need_sample_workspace:
            self._workspace.default_to_cwd()
        self._process_result(
            *SamplingPool.calculate_sample(sample_id, level_sim,
                                           work_dir=self._output_dir),
            level_sim)

    def _process_result(self, sample_id, result, err_msg, elapsed, level_sim):
        lid = level_sim.level_id
        # always create the level's record — a level whose samples all fail
        # (elapsed=0) must still appear in the cost vector, or get_n_ops
        # returns fewer entries than n_levels and desynchronizes the
        # allocation formula
        t = self.times.setdefault(lid, [0, 0])
        if elapsed:
            t[0] += elapsed
            t[1] += 1
        if err_msg:
            self._errors.setdefault(lid, []).append((sample_id, err_msg))
            self._workspace.finish(sample_id, level_sim, failed=True)
        else:
            self._done.setdefault(lid, []).append(
                (sample_id, (result[0], result[1])))
            if not self._debug:
                self._workspace.finish(sample_id, level_sim, failed=False)

    def have_permanent_samples(self, sample_ids):
        return False

    def _drain(self, store):
        out = {lid: lst for lid, lst in store.items() if lst}
        for lid, lst in out.items():
            self._n_running -= len(lst)
        store.clear()
        return out

    def get_finished(self):
        return (self._drain(self._done), self._drain(self._errors),
                self._n_running, list(self.times.items()))


def _host_worker_init():
    """ProcessPool workers compute on the host CPU: the parent process may
    hold the accelerator, and a second JAX process on it fails for want of
    device memory."""
    jax.config.update("jax_platforms", "cpu")


class ProcessPool(OneProcessPool):
    """Multi-process local pool (reference :297-323) via concurrent.futures.

    Workers are spawned (a fork would copy the parent's JAX runtime and its
    threads) and run host-only (``_host_worker_init``)."""

    def __init__(self, n_processes, work_dir=None, debug=False):
        import concurrent.futures
        import multiprocessing

        super().__init__(work_dir=work_dir, debug=debug)
        self._executor = concurrent.futures.ProcessPoolExecutor(
            max_workers=n_processes,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_host_worker_init)
        self._futures = []

    def schedule_sample(self, sample_id, level_sim):
        self._n_running += 1
        if level_sim.need_sample_workspace:
            self._workspace.default_to_cwd()
        fut = self._executor.submit(
            SamplingPool.calculate_sample, sample_id, level_sim,
            self._output_dir)
        fut._mlmc_sample_id = sample_id
        self._futures.append((fut, level_sim))

    def get_finished(self):
        pending = []
        for fut, level_sim in self._futures:
            if not fut.done():
                pending.append((fut, level_sim))
                continue
            try:
                result = fut.result()
            except Exception as exc:
                # executor-level failure (worker died, unpicklable config):
                # report it as a failed sample instead of crashing collection
                # and leaving the future to be re-processed on retry
                sample_id = getattr(fut, "_mlmc_sample_id", "<unknown>")
                self._process_result(
                    sample_id, None,
                    "executor failure: {}".format(exc), 0, level_sim)
                continue
            self._process_result(*result, level_sim)
        self._futures = pending
        return super().get_finished()


class ThreadPool(ProcessPool):
    """Thread pool for external-binary simulations (reference :326-337):
    the workers block in subprocess calls, so threads are enough."""

    def __init__(self, n_thread, work_dir=None, debug=False):
        import concurrent.futures

        OneProcessPool.__init__(self, work_dir=work_dir, debug=debug)
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=n_thread)
        self._futures = []


def _config_equal(a, b):
    """Structural equality of static config dicts (arrays by value)."""
    if a is None or b is None or a.keys() != b.keys():
        return a is b
    for k in a:
        va, vb = a[k], b[k]
        try:
            if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
                if not np.array_equal(va, vb):
                    return False
            elif va != vb:
                return False
        except Exception:
            if va is not vb:
                return False
    return True


class DeviceBatchPool(SamplingPool):
    """device-native pool: a level's scheduled samples run as ONE device batch.

    Replaces the reference's per-sample process fan-out with data-parallel
    batch evaluation:

    * sample id ``L{l}_S{n}`` -> key ``fold_in(fold_in(root_key, l), n)`` —
      stable and replayable, mirroring the md5(sample_id) scheme,
    * `calculate_batch` jitted once per (level, bucket-size); batches padded
      to power-of-two buckets,
    * failed samples (simulation-raised NaN / injected failures) return to
      the sampler as failed ids; renewals re-run with attempt+1 salt,
    * per-level wall time recorded for the optimal-allocation formula C_l
      via designated synchronous probes (cold + first warm call per
      (level, bucket)); all other dispatches enqueue asynchronously and
      drain in ONE pipelined fetch per ``get_finished`` — the sampling hot
      loop pays ~1 device->host round trip per adaptive round, not per
      dispatch.

    Multi-chip: pass ``mesh_shard`` (see mlmc_tpu.parallel) to shard the
    batch axis across devices with psum-free independent evaluation.
    """

    #: byte budget for un-drained host-bound wave payloads: an async wave
    #: holds every dispatch's (fine, coarse) device buffers until the
    #: pipelined flush, so an unbounded wave over a host storage could
    #: hold the whole run's payload in device memory at once. Waves
    #: flush early past this budget (device_results pools are exempt —
    #: their payload stays in HBM by design and is owned by the storage).
    INFLIGHT_BYTES = 1 << 30

    def __init__(self, work_dir=None, debug=False, seed=0, min_bucket=256,
                 sharding=None, bulk=True, max_batch=65536,
                 device_results=False, inflight_bytes=None):
        super().__init__(work_dir=work_dir, debug=debug)
        self._bulk = bulk
        # keep result payloads as DEVICE arrays (pair with DeviceMemory to
        # avoid the host<->device round trip entirely); only the failure
        # mask crosses the link
        self._device_results = bool(device_results)
        self._max_batch = int(max_batch)
        self._inflight_bytes = int(inflight_bytes if inflight_bytes
                                   is not None else self.INFLIGHT_BYTES)
        self._root_key = jax.random.key(seed)
        self._pending = {}  # level_id -> list[(index array, attempt array)]
        self._attempts = {}  # level_id -> {index: times scheduled}
        self._level_sims = {}
        self.times = {}
        self._min_bucket = min_bucket
        self._sharding = sharding
        self._jit_cache = {}
        self._warm = set()  # (level, bucket) pairs that already compiled
        self._timed = set()  # (level, bucket) pairs with a warm C_l probe
        self._cold_times = {}  # compile-polluted first-call timings
        self.n_dispatches = 0  # device batch calls (observability)
        self.n_blocking_fetches = 0  # host-blocking device fetches (ditto)

    # ------------------------------------------------------------------ #
    def sample_key(self, level_id, sample_index):
        return jax.random.fold_in(jax.random.fold_in(self._root_key, level_id), sample_index)

    def schedule_level_batch(self, level_sim, indices, renew=False):
        """Queue a whole index array for one level — the Sampler's O(1)
        dispatch path (no per-sample strings). ``renew=True`` salts each
        index with its retry count so failed samples re-run with fresh
        randomness while staying replayable."""
        level_id = level_sim.level_id
        self._level_sims[level_id] = level_sim
        if isinstance(indices, range) and not renew and indices.step == 1:
            # contiguous fresh batch: keep the range lazy — execute_level
            # derives indices on device from the start scalar (no [count]
            # index/attempt upload per dispatch)
            self._pending.setdefault(level_id, []).append((indices, None))
            return
        indices = np.asarray(indices, dtype=np.int64)
        if renew:
            att_map = self._attempts.setdefault(level_id, {})
            attempts = np.empty(len(indices), dtype=np.uint32)
            for k, i in enumerate(indices.tolist()):
                n_prev = att_map.get(i, 1)  # scheduled at least once before
                att_map[i] = n_prev + 1
                attempts[k] = n_prev
        else:
            attempts = np.zeros(len(indices), dtype=np.uint32)
        self._pending.setdefault(level_id, []).append((indices, attempts))

    def schedule_sample(self, sample_id, level_sim):
        from mlmc_tpu.tags import parse_tag

        _, idx = parse_tag(sample_id)
        level_id = level_sim.level_id
        att_map = self._attempts.setdefault(level_id, {})
        attempt = att_map.get(idx, 0)
        att_map[idx] = attempt + 1
        self._level_sims[level_id] = level_sim
        self._pending.setdefault(level_id, []).append(
            (np.array([idx], dtype=np.int64), np.array([attempt], dtype=np.uint32)))

    def have_permanent_samples(self, sample_ids):
        return False

    def n_pending(self):
        return sum(sum(len(seg[0]) for seg in v) for v in self._pending.values())

    def _batch_fn(self, level_id, bucket, mode="array"):
        """jit-compiled batch executable.

        Cached per (level, bucket size); simulations declaring
        ``DYNAMIC_CONFIG`` (level-varying scalar config entries, e.g. the
        fine/coarse steps) share ONE executable per bucket across levels —
        the scalars become traced arguments. Each compile costs 10-30 s
        over a remote-attached chip, so sharing cuts the adaptive loop's
        startup from O(levels x buckets) to O(buckets) compiles.
        """
        level_sim = self._level_sims[level_id]
        config = level_sim.config_dict
        calc_batch = level_sim.calculate_batch
        dyn_names = getattr(level_sim, "dynamic_config", None)
        if dyn_names:
            # structural static differences (is_level0) keep separate keys
            cache_key = ("shared", getattr(level_sim, "shared_token", 0),
                         bucket, bool(config.get("is_level0", False)), mode)
        else:
            cache_key = (level_id, bucket, mode)
        static_cfg = None
        if dyn_names:
            static_cfg = {k: v for k, v in config.items()
                          if k not in dyn_names}
            cached = self._jit_cache.get(cache_key)
            if cached is not None and not _config_equal(cached[1], static_cfg):
                # a level-varying entry was NOT declared in DYNAMIC_CONFIG:
                # sharing would silently bake the first level's value into
                # every level — fall back to a per-level executable
                cache_key = (level_id, bucket, mode)
        if cache_key not in self._jit_cache:
            # the (level_key, index) -> sample key derivation AND the
            # NaN-failure detection run INSIDE the executable: one dispatch
            # per slice, and neither keys nor payload cross the host link
            nan_fails = getattr(level_sim, "nan_result_is_failure", True)

            def derive_keys(level_key, idxs):
                return jax.vmap(
                    lambda i: jax.random.fold_in(level_key, i))(idxs)

            def run(cfg, level_key, idxs, attempts):
                fine, coarse, failed = calc_batch(
                    cfg, derive_keys(level_key, idxs), attempts)
                if nan_fails:
                    # parity with sims that raise on NaN (SynthSimulation);
                    # sims with NaN-as-QoI (shooting) store NaNs, masked at
                    # estimation time
                    failed = (failed
                              | jnp.any(jnp.isnan(fine), axis=1)
                              | jnp.any(jnp.isnan(coarse), axis=1))
                return fine, coarse, failed

            if mode == "range":
                # contiguous fresh batch: only the start scalar crosses the
                # link; indices/attempts build on device (iota / zeros)
                def expand(start):
                    idxs = start + jax.lax.iota(jnp.uint32, bucket)
                    return idxs, jnp.zeros((bucket,), jnp.uint32)

                if dyn_names:
                    baked_cfg = dict(static_cfg)

                    def fn(dyn_vals, level_key, start):
                        cfg = dict(baked_cfg)
                        cfg.update(zip(dyn_names, dyn_vals))
                        return run(cfg, level_key, *expand(start))
                else:
                    def fn(level_key, start):
                        return run(config, level_key, *expand(start))
            elif dyn_names:
                baked_cfg = dict(static_cfg)

                def fn(dyn_vals, level_key, idxs, attempts):
                    cfg = dict(baked_cfg)
                    cfg.update(zip(dyn_names, dyn_vals))
                    return run(cfg, level_key, idxs, attempts)
            else:
                def fn(level_key, idxs, attempts):
                    return run(config, level_key, idxs, attempts)
            if self._sharding is not None:
                # data-parallel over the sample mesh: batch axis sharded,
                # XLA partitions the vmapped computation across devices
                # (range mode never reaches here: execute_level materializes
                # index arrays when a sharding is set)
                assert mode == "array", "sharded pools use array batches"
                in_sh = self._sharding.batch_sharding()
                shardings = ((None, None, in_sh, in_sh) if dyn_names
                             else (None, in_sh, in_sh))
                jitted = jax.jit(fn, in_shardings=shardings)
            else:
                jitted = jax.jit(fn)
            self._jit_cache[cache_key] = (jitted, static_cfg)
        fn_c, _ = self._jit_cache[cache_key]
        if dyn_names:
            # dtype follows the enabled precision: float32 by default, float64
            # under x64 — a hard f32 cast broke exact-tier bit parity with
            # the static-config pools (review finding)
            dyn_vals = tuple(jnp.asarray(config[k], dtype=float)
                             for k in dyn_names)
            return lambda *args: fn_c(dyn_vals, *args)
        return fn_c

    def _level_slices(self, level_id):
        """Pop a level's pending segments into padded dispatch slices.

        Batches larger than ``max_batch`` split so executable sizes
        (compile time, device memory) stay bounded; when a batch is
        sliced, every slice (incl. the remainder) uses the max bucket —
        padding waste is <=1 slice of masked samples, while a fresh
        remainder-sized bucket costs a 10-30 s remote compile per round.
        :return: list of (idxs, attempts-or-None, bucket) slices
        """
        segments = self._pending.pop(level_id, None)
        if not segments:
            return []
        if (self._sharding is None
                and all(isinstance(seg[0], range) for seg in segments)
                and all(segments[i][0].stop == segments[i + 1][0].start
                        for i in range(len(segments) - 1))):
            # contiguous fresh batches: indices are derived ON DEVICE from
            # the start scalar — no [count] index/attempt host->device
            # upload per dispatch
            idxs = range(segments[0][0].start, segments[-1][0].stop)
            attempts = None
        else:
            arrs = [np.arange(seg[0].start, seg[0].stop, dtype=np.int64)
                    if isinstance(seg[0], range) else seg[0]
                    for seg in segments]
            atts = [np.zeros(len(seg[0]), dtype=np.uint32)
                    if seg[1] is None else seg[1] for seg in segments]
            idxs = np.concatenate(arrs)
            attempts = np.concatenate(atts)
        force = self._max_batch if len(idxs) > self._max_batch else None
        slices = []
        for start in range(0, len(idxs), self._max_batch):
            sub = idxs[start:start + self._max_batch]  # range stays a range
            att = None if attempts is None \
                else attempts[start:start + self._max_batch]
            bucket = force or _round_up_bucket(len(sub), self._min_bucket)
            if self._sharding is not None:
                # bucket must tile evenly over the mesh's sample axis
                d = self._sharding.n_devices
                bucket = -(-bucket // d) * d
            slices.append((sub, att, bucket))
        return slices

    def execute_level(self, level_id):
        """Run all pending samples of one level as padded device batches."""
        recs = [self._dispatch_batch(level_id, *sl)
                for sl in self._level_slices(level_id)]
        return self._collect(recs)

    def _dispatch_batch(self, level_id, idxs, attempts, bucket):
        """Enqueue one padded device batch; keys from (level, index, attempt).

        JAX dispatch is ASYNCHRONOUS: the jitted call returns device
        futures immediately, so consecutive batches (across slices AND
        levels) overlap on device and the serialized per-dispatch
        round trip disappears — results are drained later in ONE pipelined
        ``jax.device_get`` (``_collect``). Synchronous completion happens
        only for the cold (compiling) call and the first warm call per
        (level, bucket), which are the designated C_l timing probes: a
        blocking fetch drains the device queue, so the probe that follows
        it measures its own compute, not queued predecessors.
        :return: pending-record dict (completed in ``_collect``)
        """
        n = len(idxs)
        is_range = isinstance(idxs, range)
        if is_range:
            start = idxs.start
            # host-side index vector only for ids/failure reporting below —
            # it never crosses the device link
            idxs = np.arange(start, idxs.stop, dtype=np.uint32)
        else:
            idxs = idxs.astype(np.uint32)
            # pad to bucket with repeats of the last sample (discarded later)
            pad = bucket - n
            idxs_p = np.concatenate([idxs, np.full(pad, idxs[-1] if n else 0, dtype=np.uint32)])
            att_p = np.concatenate([attempts, np.zeros(pad, dtype=np.uint32)])

        level_key = jax.random.fold_in(self._root_key, level_id)

        # build the executable wrapper BEFORE the timed region; whether
        # the first call of this (key, bucket) still compiles is tracked so
        # compile time never pollutes the C_l cost model (a remote AOT
        # compile costs 10-30 s vs milliseconds of sample compute)
        fn = self._batch_fn(level_id, bucket,
                            mode="range" if is_range else "array")
        warm_key = (level_id, bucket, is_range)
        first_call = warm_key not in self._warm
        self._warm.add(warm_key)
        timed = first_call or warm_key not in self._timed

        t0 = time.perf_counter()
        self.n_dispatches += 1
        if is_range:
            fine, coarse, failed = fn(level_key, jnp.uint32(start))
        else:
            fine, coarse, failed = fn(level_key, jnp.asarray(idxs_p),
                                      jnp.asarray(att_p))
        rec = dict(level_id=level_id, idxs=idxs, n=n, fine=fine,
                   coarse=coarse, failed=failed, first_call=first_call)
        if timed:
            # synchronous C_l probe: the timing ends with the batch
            # complete on the device
            self.n_blocking_fetches += 1
            if self._device_results:
                # payload stays in HBM; only the bool mask crosses the link
                rec["failed_host"] = np.asarray(failed)
            else:
                fine, coarse, failed_h = jax.device_get(
                    (fine, coarse, failed))
                rec.update(fine=fine, coarse=coarse, failed_host=failed_h)
            rec["elapsed"] = time.perf_counter() - t0
            if not first_call:
                self._timed.add(warm_key)
        return rec

    def _collect(self, recs):
        """Complete dispatched batches: fetch every still-pending failure
        mask (and, for host-resident pools, the payloads) in ONE pipelined
        ``jax.device_get`` — N sequential fetches pay N round trips; a
        pipelined fetch pays ~one."""
        pend = [r for r in recs if "failed_host" not in r]
        if pend:
            self.n_blocking_fetches += 1
            if self._device_results:
                masks = jax.device_get([r["failed"] for r in pend])
                for r, m in zip(pend, masks):
                    r["failed_host"] = np.asarray(m)
            else:
                outs = jax.device_get(
                    [(r["fine"], r["coarse"], r["failed"]) for r in pend])
                for r, (f, c, m) in zip(pend, outs):
                    r.update(fine=f, coarse=c, failed_host=m)
        succ_all, fail_all = {}, {}
        for rec in recs:
            s, f = self._finalize(rec)
            self._merge_results(succ_all, s)
            self._merge_results(fail_all, f)
        return succ_all, fail_all

    @staticmethod
    def _merge_results(dst, src):
        """Merge per-level result dicts; every value normalizes to a
        LIST — of per-slice BulkResults (one per device batch:
        concatenating device payloads would compile a fresh executable
        per (slice count, sizes) combination, storages append each slice
        instead) or of (id, payload) tuples. One merge implementation
        for batch-, wave- and drain-level accumulation (review finding:
        three hand-rolled copies carried a latent overwrite branch)."""
        for k, v in src.items():
            items = [v] if isinstance(v, BulkResults) else list(v)
            dst.setdefault(k, []).extend(items)

    def _finalize(self, rec):
        """Post-process one completed batch into (successful, failed)."""
        from mlmc_tpu.tags import TagArray, format_tags

        level_id, idxs, n = rec["level_id"], rec["idxs"], rec["n"]
        fine, coarse = rec["fine"], rec["coarse"]
        failed = rec["failed_host"][:n]
        if self._device_results:
            # payload stays in HBM at BUCKET shape — slicing a device array
            # to the batch-specific count would compile a fresh executable
            # per adaptive round over a remote-attached chip; consumers
            # count len(ids) valid rows instead.
            pass
        else:
            fine = fine[:n]
            coarse = coarse[:n]

        ok = ~failed
        failed_out = [(sid, "result is nan")
                      for sid in format_tags(level_id, idxs[failed]).tolist()]
        if self._bulk and not failed_out:
            # common case (no failures): skip the filtering gathers — on a
            # remote-attached device each variable-shape gather pays a
            # fresh compile (~1 s/slice measured). Device payloads stay
            # bucket-padded; consumers count len(ids) valid rows.
            successful = BulkResults(TagArray(level_id, idxs), fine, coarse)
        elif self._bulk:
            ok_ids = TagArray(level_id, idxs[ok])
            if self._device_results and len(ok_ids):
                ok_dev = jnp.asarray(ok)
                successful = BulkResults(ok_ids, fine[:n][ok_dev],
                                         coarse[:n][ok_dev])
            elif len(ok_ids):
                successful = BulkResults(ok_ids, fine[ok], coarse[ok])
            else:
                successful = []
        else:
            ok_pos = np.flatnonzero(ok)
            ok_ids = format_tags(level_id, idxs[ok_pos]).tolist()
            successful = [(sid, (fine[i], coarse[i]))
                          for sid, i in zip(ok_ids, ok_pos)]

        n_ok = int(np.count_nonzero(ok))
        if level_id not in self.times:
            self.times[level_id] = [0, 0]
        if n_ok and rec.get("elapsed") is not None:
            # charge wall time only to successful samples (reference
            # semantics) and only on the designated timing probes: the
            # cold call per (level, bucket) accumulates separately (its
            # elapsed includes the 10-30 s remote XLA compile) and only
            # stands in for C_l until the first warm measurement arrives.
            # Untimed async batches contribute NOTHING to [Σt, n] — C_l is
            # consumed as the ratio t/n (storage get_n_ops), which the
            # probe-only sums estimate without bias.
            target = self.times[level_id] if not rec["first_call"] \
                else self._cold_times.setdefault(level_id, [0, 0])
            target[0] += rec["elapsed"] * n_ok / max(n, 1)
            target[1] += n_ok
        return ({level_id: successful} if n_ok else {}), (
            {level_id: failed_out} if failed_out else {}
        )

    def get_finished(self):
        """Drain every pending level in one asynchronous wave.

        Two passes: (A) slices that still need a synchronous C_l timing
        probe (cold compile / first warm call per (level, bucket)) run
        first — each probe's blocking fetch drains the device queue, so
        probe timings stay clean of queued work; (B) every remaining slice
        of every level enqueues back-to-back and completes in ONE pipelined
        fetch. An adaptive round therefore costs ~1 device->host round
        trip once the executables are warm, instead of one per dispatch.
        """
        plans = [(lid, self._level_slices(lid))
                 for lid in sorted(self._pending.keys())]
        recs, deferred = [], []
        for level_id, slices in plans:
            for sl in slices:
                warm_key = (level_id, sl[2], isinstance(sl[0], range))
                if warm_key not in self._timed:
                    recs.append(self._dispatch_batch(level_id, *sl))
                else:
                    deferred.append((level_id, sl))
        successful, failed = {}, {}

        def drain(recs):
            s, f = self._collect(recs)
            self._merge_results(successful, s)
            self._merge_results(failed, f)

        pending_bytes = 0
        for level_id, sl in deferred:
            rec = self._dispatch_batch(level_id, *sl)
            recs.append(rec)
            if not self._device_results:
                pending_bytes += (rec["fine"].nbytes
                                  + rec["coarse"].nbytes)
                if pending_bytes >= self._inflight_bytes:
                    # host-bound payloads: drain the wave early so the
                    # un-fetched device buffers stay under the budget
                    drain(recs)
                    recs, pending_bytes = [], 0
        if recs:
            drain(recs)
        # warm (compile-free) timings win; compile-polluted cold timings
        # only stand in while a level has no warm measurement yet
        times = {lvl: list(t) for lvl, t in self._cold_times.items()}
        for lvl, t in self.times.items():
            if t[1]:
                times[lvl] = list(t)
        return successful, failed, self.n_pending(), list(times.items())
