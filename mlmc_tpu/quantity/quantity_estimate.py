"""MLMC estimators over Quantity DAGs — the read-side hot path.

Re-design of reference mlmc/quantity/quantity_estimate.py:6-156. Differences:

* NaN-sample masking keeps static shapes: invalid sample columns are zeroed
  and counted instead of removed (identical sums, jit-friendly),
* when the Quantity DAG is fully traceable, the per-chunk pipeline
  (DAG ops -> nan mask -> fine-coarse diff -> sum / sum-of-squares) is
  compiled ONCE per (level-kind, chunk-shape) and reused for every chunk —
  the moment Vandermonde and the reductions fuse into a single XLA kernel,
* cross-chunk accumulation: the eager/fused-per-chunk paths accumulate
  per-chunk device sums into host float64; the single-dispatch tier
  tree-reduces stacked per-chunk partials in the accumulator dtype
  (error ~eps·log2(n_chunks) above the per-chunk floor). The compensated
  (Kahan) float32 and the float64 guarantees live in the dedicated
  stored-sample tiers (ops/fused_estimate).

The one-pass telescoping estimator itself is unchanged:
    mean = sum_l mean(fine_l - coarse_l),  var = sum_l var_l / n_l
(reference quantity_estimate.py:43-80).
"""
import numpy as np
import jax
import jax.numpy as jnp

import mlmc_tpu.quantity.quantity as q_mod
import mlmc_tpu.quantity.quantity_types as qt


def mask_nan_samples(chunk):
    """Drop samples containing NaN in fine or coarse part (eager helper).

    :param chunk: array [M, N, 2]
    :return: (chunk without masked samples, number masked)
    """
    chunk = np.asarray(chunk)
    mask = np.any(np.isnan(chunk), axis=0).any(axis=1)
    return chunk[..., ~mask, :], int(np.count_nonzero(mask))


def cache_clear():
    q_mod.cache_clear()


def _accum_dtype():
    return jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32


def _chunk_sums_impl(chunk, n_true=None):
    """Per-chunk masked accumulation: (sum, sum_sq, n_valid).

    chunk: [M, N, C] with C==1 (level 0) or C==2. NaN-poisoned samples are
    zeroed out and counted, matching the drop-then-sum semantics of the
    reference (quantity_estimate.py:45-65). ``n_true`` (traced) marks the
    true sample count of a padded chunk: pad columns are EXCLUDED by
    position, never by NaN detection — a DAG with non-NaN-propagating ops
    (fmax, power(x, 0), ...) would otherwise launder pad columns into
    phantom valid samples.
    """
    chunk = jnp.asarray(chunk)
    if not jnp.issubdtype(chunk.dtype, jnp.floating):
        raise TypeError("estimate_mean requires float-valued quantities")
    acc = _accum_dtype()
    valid = ~jnp.any(jnp.isnan(chunk), axis=(0, 2))  # [N]
    if n_true is not None:
        valid &= jnp.arange(chunk.shape[1]) < n_true
    if chunk.shape[2] == 1:
        diff = chunk[:, :, 0]
    else:
        diff = chunk[:, :, 0] - chunk[:, :, 1]
    diff = jnp.where(valid[None, :], diff, 0.0).astype(acc)
    s = jnp.sum(diff, axis=1)
    sp = jnp.sum(diff * diff, axis=1)
    return s, sp, jnp.sum(valid)


_chunk_sums = jax.jit(_chunk_sums_impl)


# ---------------------------------------------------------------------- #
# single-dispatch tier: every chunk of every level in ONE device program
# ---------------------------------------------------------------------- #

#: auto-enable threshold (samples on the largest level); below it the
#: per-chunk path is cheaper than a dedicated executable
SINGLE_DISPATCH_MIN_SAMPLES = 1 << 15
#: budget for DAG-output intermediates materialized per scan step
_SD_BYTE_BUDGET = 1 << 27
#: in-flight input-buffer budget for the eager per-chunk loop's deferred
#: fetches (mirrors DeviceBatchPool.INFLIGHT_BYTES)
_INFLIGHT_BYTES = 1 << 30


def _sd_chunk_size(m_out):
    """Samples per scan step, bounding [m_out, chunk, 2] f64 intermediates
    to the byte budget (covariance quantities expand M by R^2)."""
    target = max(_SD_BYTE_BUDGET // (16 * max(int(m_out), 1)), 1 << 10)
    return min(1 << (int(target).bit_length() - 1), 1 << 16)


def _pow2_pad(n, floor=1 << 10):
    from mlmc_tpu.sample_storage import _pow2_at_least

    return _pow2_at_least(n, floor=floor)


def _gather_raw_leaves(quantity_storage):
    """Native-layout ``[N_pad, C, M]`` payload + true count per level.

    DEVICE capacity buffers (DeviceMemory) pass through WHOLE: power-of-two
    capacity, garbage tail masked by POSITION downstream — zero eager
    device ops on this path (over a remote-attached chip every new eager-op
    shape costs an executable compile/load, which dominated round 2's e2e
    wall time). Host payloads are NaN-padded to power-of-two buckets in
    numpy (free) and transferred at dispatch.

    :return: (list of leaves, list of true counts, tuple of level ids)
    """
    lids = tuple(sorted(quantity_storage.level_ids()))
    storage = getattr(quantity_storage, "_storage", None)
    raw_fn = getattr(storage, "raw_level_payload", None)
    leaves, n_trues = [], []
    for level_id in lids:
        payload = None
        if raw_fn is not None:
            payload, n = raw_fn(level_id)
            if isinstance(payload, jax.Array):
                leaves.append(payload)
                n_trues.append(int(n))
                continue
            payload = np.asarray(payload)
            n = int(n)
        if payload is None:
            # chunked fallback (out-of-core backends): [M, chunk, C] chunks
            # back to native [N, C, M]
            parts = [np.moveaxis(np.asarray(quantity_storage.samples(cs)),
                                 0, -1)
                     for cs in quantity_storage.chunks(level_id=level_id)]
            payload = (parts[0] if len(parts) == 1
                       else np.concatenate(parts, axis=0))
            n = payload.shape[0]
        n_pad = _pow2_pad(n)
        if n_pad - n:
            pad = np.full((n_pad - n,) + payload.shape[1:], np.nan,
                          dtype=payload.dtype if np.issubdtype(
                              payload.dtype, np.floating) else np.float64)
            payload = np.concatenate([payload, pad], axis=0)
        leaves.append(payload)
        n_trues.append(n)
    return _equalize_device_leaves(leaves), n_trues, lids


#: skip leaf equalization when it would allocate more than this many extra
#: bytes of transient HBM (structured quantities at large capacity)
_EQUALIZE_BYTE_BUDGET = 1 << 29


def _equalize_device_leaves(leaves):
    """Pad DEVICE leaves to one shared sample-axis capacity.

    The jitted estimation programs (single-dispatch tier, packed fast
    tier) re-trace per leaf-shape combination. Per-level pow2 capacities
    drift between runs — measured per-sample costs jitter the allocation,
    which flips borderline capacity doublings — so the COMBINATION rarely
    repeats and each adaptive run was paying fresh multi-second remote AOT
    compiles for programs the persistent cache had "already" seen at a
    sibling combo. Padding every level to the max capacity makes the
    executable key depend on ONE number (the max), which is stable.

    Device-only: the pads are HBM-to-HBM copies (sub-ms); padding HOST
    leaves would inflate the host->device transfer instead. Tails beyond
    n_true are excluded by position in every consumer, so the pad value
    (NaN) is never observed.
    """
    if len(leaves) <= 1 or not all(
            isinstance(leaf, jax.Array) for leaf in leaves):
        return leaves
    n_max = max(leaf.shape[0] for leaf in leaves)
    extra = sum((n_max - leaf.shape[0]) * int(np.prod(leaf.shape[1:]))
                for leaf in leaves)
    if extra * 4 > _EQUALIZE_BYTE_BUDGET:
        return leaves
    return [leaf if leaf.shape[0] == n_max else
            jnp.pad(leaf, [(0, n_max - leaf.shape[0])]
                    + [(0, 0)] * (leaf.ndim - 1),
                    constant_values=(np.nan if jnp.issubdtype(
                        leaf.dtype, jnp.floating) else 0))
            for leaf in leaves]


def _normalize_leaf(leaf, is_level0, acc):
    """Native [N_pad, C, M] -> estimation layout [M, N_pad, C] (level 0
    drops the auxiliary coarse slot, matching QuantityStorage.samples)."""
    leaf = jnp.transpose(leaf, (2, 0, 1))
    if is_level0 and leaf.shape[2] > 1:
        leaf = leaf[:, :, :1]
    if not jnp.issubdtype(leaf.dtype, jnp.floating):
        leaf = leaf.astype(acc)
    return leaf


def _build_single_dispatch(quantity, lids):
    """jitted ``f(leaves, n_trues) -> ((sum, sum_sq, n_valid) per level)``.

    The whole estimation — leaf normalization, DAG evaluation, NaN masking,
    fine-coarse diff, reductions, cross-chunk accumulation — runs as ONE
    device dispatch via ``lax.scan`` over fixed-size chunks per level. Pad
    columns are excluded by POSITION (n_true is traced), so neither NaN pads
    nor device-buffer garbage tails can leak into the estimate. Cross-chunk
    sums tree-reduce over the stacked per-chunk results (error
    ~eps.log2(n_chunks), far below the per-chunk floor).
    """
    dag_eval = quantity.build_eval()
    m_out = quantity.size()
    chunk_cap = _sd_chunk_size(m_out)

    def level_sums(leaf, n_true, is_level0):
        acc = _accum_dtype()
        leaf = _normalize_leaf(leaf, is_level0, acc)
        M, n_pad, C = leaf.shape
        chunk = min(chunk_cap, n_pad)
        n_chunks = n_pad // chunk
        bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk

        def body(nv, base):
            # slice per step instead of pre-stacking a transposed copy of
            # the whole leaf as scan operands (which kept leaf + copy live
            # simultaneously — ~2x peak HBM per level)
            x = jax.lax.dynamic_slice_in_dim(leaf, base, chunk, axis=1)
            y = dag_eval(x)
            if not jnp.issubdtype(y.dtype, jnp.floating):
                y = y.astype(acc)
            valid = ~jnp.any(jnp.isnan(y), axis=(0, 2))
            valid &= (base + jnp.arange(chunk)) < n_true
            d = y[:, :, 0] - y[:, :, 1] if y.shape[2] > 1 else y[:, :, 0]
            d = jnp.where(valid[None, :], d, 0.0).astype(acc)
            return (nv + jnp.sum(valid).astype(nv.dtype),
                    (jnp.sum(d, axis=1), jnp.sum(d * d, axis=1)))

        nv, (s_c, sp_c) = jax.lax.scan(
            body, jnp.zeros((), jnp.int32), bases)
        return jnp.sum(s_c, axis=0), jnp.sum(sp_c, axis=0), nv

    def program(leaves, n_trues):
        return tuple(level_sums(leaf, n, lid == 0)
                     for leaf, n, lid in zip(leaves, n_trues, lids))

    return jax.jit(program)


def _single_dispatch_sums(quantity, quantity_storage):
    """Run (building/caching as needed) the single-dispatch program.

    :return: list of (sum [M], sum_sq [M], n_valid, n_true) per level
    """
    leaves, n_trues, lids = _gather_raw_leaves(quantity_storage)
    cached = getattr(quantity, "_sd_program", None)
    if cached is None or cached[0] != lids:
        cached = (lids, _build_single_dispatch(quantity, lids))
        quantity._sd_program = cached
    program = cached[1]
    outs = program(tuple(leaves),
                   tuple(jnp.asarray(n, jnp.int32) for n in n_trues))
    # ONE pipelined fetch for the whole result structure: a per-leaf
    # np.asarray comprehension pays a device->host round trip for EACH of
    # the 3L tiny arrays
    outs = jax.device_get(outs)
    return [(np.asarray(s, dtype=np.float64),
             np.asarray(sp, dtype=np.float64), int(nv), n_true)
            for (s, sp, nv), n_true in zip(outs, n_trues)]


def estimate_mean(quantity, single_dispatch=None):
    """MLMC mean estimator (streaming over chunks, device accumulation).

    When the quantity's DAG is fully traceable (shape-static jnp ops), the
    WHOLE per-chunk pipeline — DAG evaluation, NaN mask, fine-coarse diff,
    sum / sum-of-squares — is composed via ``Quantity.build_eval`` and
    compiled ONCE per chunk shape, so XLA fuses the moment Vandermonde and
    the reductions into a single program per chunk instead of dispatching
    each DAG node separately.

    At production sample volumes the per-chunk loop still pays one device
    dispatch (plus a host sync) per chunk; the SINGLE-DISPATCH tier compiles
    every chunk of every level into one program (``lax.scan``) and runs the
    whole estimate in one device call. Auto-selected for traceable DAGs over
    RAM/HBM-resident storages past ``SINGLE_DISPATCH_MIN_SAMPLES``; force
    with ``single_dispatch=True`` / opt out with ``False``.

    :param quantity: Quantity
    :param single_dispatch: tri-state override of the single-dispatch tier
    :return: QuantityMean holding per-level means/vars and combined estimate
    """
    cache_clear()
    quantity_vec_size = quantity.size()
    quantity_storage = quantity.get_quantity_storage()
    level_ids = quantity_storage.level_ids()
    if len(level_ids) == 0:
        raise ValueError(
            "estimate_mean: storage holds no collected results yet")
    n_levels = int(np.max(level_ids)) + 1

    n_samples = [0] * n_levels
    n_rm_samples = [0] * n_levels

    if single_dispatch is None:
        try:
            largest = max(quantity_storage.n_collected())
        except ValueError:  # empty sequence only — real faults propagate
            largest = 0
        single_dispatch = (
            quantity.traceable()
            and getattr(quantity_storage, "payload_resident", lambda: False)()
            and largest >= SINGLE_DISPATCH_MIN_SAMPLES)
    if single_dispatch:
        sums = [np.zeros(quantity_vec_size, dtype=np.float64)
                for _ in range(n_levels)]
        sums_of_squares = [np.zeros(quantity_vec_size, dtype=np.float64)
                           for _ in range(n_levels)]
        per_level = _single_dispatch_sums(quantity, quantity_storage)
        for lid, (s, sp, nv, n_true) in zip(sorted(level_ids), per_level):
            sums[lid] += s
            sums_of_squares[lid] += sp
            n_samples[lid] += nv
            n_rm_samples[lid] += n_true - nv
        return _combine_level_sums(quantity, sums, sums_of_squares,
                                   n_samples, n_rm_samples)

    fused_eval = None
    # fusing the whole DAG costs one XLA compile per (DAG, chunk shape);
    # worth it for real sample volumes, not for tiny interactive queries
    try:
        n_collected = max(quantity_storage.n_collected())
    except ValueError:  # empty sequence only — real faults propagate
        n_collected = 0
    if quantity.traceable() and n_collected >= 8192:
        # cache the jitted composition on the node: repeated estimates over
        # the same DAG reuse the executable (jit caches per function object)
        fused_eval = getattr(quantity, "_fused_eval", None)
        if fused_eval is None:
            dag_eval = quantity.build_eval()
            fused_eval = jax.jit(
                lambda leaf, n_true: _chunk_sums_impl(dag_eval(leaf), n_true))
            quantity._fused_eval = fused_eval

    sums = [np.zeros(quantity_vec_size, dtype=np.float64)
            for _ in range(n_levels)]
    sums_of_squares = [np.zeros(quantity_vec_size, dtype=np.float64)
                       for _ in range(n_levels)]
    # per-chunk device results ([M] sums + scalars) are NOT fetched inside
    # the loop: each eager fetch pays its own device->host round trip,
    # so the loop enqueues every chunk's reduction and drains
    # them in ONE pipelined device_get below — the same discipline as the
    # sampling pool and the packed tiers. Enqueued-but-unexecuted chunks
    # keep their INPUT buffers alive in device memory, so waves drain
    # early past a byte budget (mirrors DeviceBatchPool.INFLIGHT_BYTES —
    # review finding: an unbounded wave of ~100 MB chunks could hold the
    # whole pass's payload in HBM at once).
    pending, done, inflight = [], [], 0

    def _drain():
        nonlocal pending, inflight
        if pending:
            done.extend(
                ((lid, n_true), outs) for (lid, n_true, _), outs in zip(
                    pending, jax.device_get([p[2] for p in pending])))
            pending, inflight = [], 0

    for chunk_spec in quantity_storage.chunks():
        if fused_eval is not None:
            leaf = jnp.asarray(quantity_storage.samples(chunk_spec))
            if not jnp.issubdtype(leaf.dtype, jnp.floating):
                # the eager path type-checks the DAG OUTPUT; match it by
                # lifting an integer leaf to float before evaluation
                leaf = leaf.astype(_accum_dtype())
            # pad the sample axis to a power-of-two bucket: growing storage
            # (adaptive rounds) then reuses the compiled executable instead
            # of recompiling per new chunk length (10-30 s per compile on a
            # remote-attached chip). Pad columns are excluded by POSITION
            # inside the kernel (n_true is a traced argument).
            n_true = leaf.shape[1]
            pad = _pow2_pad(n_true) - n_true
            if pad:
                leaf = jnp.pad(leaf, ((0, 0), (0, pad), (0, 0)),
                               constant_values=jnp.nan)
            s, sp, n_valid = fused_eval(leaf, n_true)
        else:
            samples = jnp.asarray(quantity.samples(chunk_spec))
            if not jnp.issubdtype(samples.dtype, jnp.floating):
                raise TypeError(
                    "estimate_mean supports float-valued quantities, "
                    "got dtype {}".format(samples.dtype))
            assert samples.shape[0] == quantity_vec_size
            n_true = samples.shape[1]
            s, sp, n_valid = _chunk_sums(samples)
        pending.append((chunk_spec.level_id, n_true, (s, sp, n_valid)))
        leaf_ref = leaf if fused_eval is not None else samples
        inflight += getattr(leaf_ref, "nbytes", 0)
        if inflight >= _INFLIGHT_BYTES:
            _drain()
    _drain()

    for (lid, n_true), (s, sp, n_valid) in done:
        n_valid = int(n_valid)
        n_samples[lid] += n_valid
        n_rm_samples[lid] += n_true - n_valid
        sums[lid] += np.asarray(s, dtype=np.float64)
        sums_of_squares[lid] += np.asarray(sp, dtype=np.float64)

    return _combine_level_sums(quantity, sums, sums_of_squares,
                               n_samples, n_rm_samples)


def _combine_level_sums(quantity, sums, sums_of_squares, n_samples,
                        n_rm_samples):
    """Per-level (sum, sum_sq, n) -> QuantityMean (one-pass unbiased var)."""
    if sum(n_samples) == 0:
        raise Exception("All samples were masked")

    l_means = []
    l_vars = []
    for s, sp, n in zip(sums, sums_of_squares, n_samples):
        if n == 0:
            l_means.append(np.zeros(len(s)))
            l_vars.append(np.full(len(s), np.inf))
            continue
        l_means.append(s / n)
        if n > 1:
            l_vars.append((sp - (s ** 2 / n)) / (n - 1))
        else:
            l_vars.append(np.full(len(s), np.inf))

    return q_mod.QuantityMean(
        quantity.qtype,
        l_means=l_means,
        l_vars=l_vars,
        n_samples=n_samples,
        n_rm_samples=n_rm_samples,
    )


def moment(quantity, moments_fn, i=0):
    """Quantity evaluating the i-th moment function (reference :83-93)."""

    def eval_moment(x):
        return moments_fn.eval_single_moment(i, value=jnp.asarray(x))

    return q_mod.Quantity(
        quantity_type=quantity.qtype, input_quantities=[quantity], operation=eval_moment
    )


def moments(quantity, moments_fn, mom_at_bottom=True):
    """Quantity evaluating all R moment functions (reference :96-119).

    Each scalar of the quantity becomes an array of R moment values; the
    Vandermonde evaluation is a traced jnp op so it fuses with the
    downstream sums under the jitted estimator path.
    """

    def eval_moments(x):
        x = jnp.asarray(x)
        mom = moments_fn.eval_all(x)  # [M, N, 2, R]
        if mom_at_bottom:
            mom = jnp.transpose(mom, (0, 3, 1, 2))  # [M, R, N, 2]
        else:
            mom = jnp.transpose(mom, (3, 0, 1, 2))  # [R, M, N, 2]
        return mom.reshape((int(np.prod(mom.shape[:-2])),) + mom.shape[-2:])

    if mom_at_bottom:
        moments_array_type = qt.ArrayType(shape=(moments_fn.size,), qtype=qt.ScalarType())
        moments_qtype = quantity.qtype.replace_scalar(moments_array_type)
    else:
        moments_qtype = qt.ArrayType(shape=(moments_fn.size,), qtype=quantity.qtype)
    return q_mod.Quantity(
        quantity_type=moments_qtype, input_quantities=[quantity], operation=eval_moments
    )


def covariance(quantity, moments_fn, cov_at_bottom=True):
    """Quantity evaluating the R x R moment outer products (reference :122-156)."""

    def eval_cov(x):
        x = jnp.asarray(x)
        mom = moments_fn.eval_all(x)  # [M, N, 2, R]
        mom_fine = mom[..., 0, :]
        cov_fine = mom_fine[..., :, None] * mom_fine[..., None, :]
        if mom.shape[-2] == 1:
            cov = cov_fine[None, ...]  # [1, M, N, R, R]
        else:
            mom_coarse = mom[..., 1, :]
            cov_coarse = mom_coarse[..., :, None] * mom_coarse[..., None, :]
            cov = jnp.stack([cov_fine, cov_coarse], axis=0)  # [2, M, N, R, R]
        if cov_at_bottom:
            cov = jnp.transpose(cov, (1, 3, 4, 2, 0))  # [M, R, R, N, 2]
        else:
            cov = jnp.transpose(cov, (3, 4, 1, 2, 0))  # [R, R, M, N, 2]
        return cov.reshape((int(np.prod(cov.shape[:-2])),) + cov.shape[-2:])

    if cov_at_bottom:
        moments_array_type = qt.ArrayType(
            shape=(moments_fn.size, moments_fn.size), qtype=qt.ScalarType()
        )
        moments_qtype = quantity.qtype.replace_scalar(moments_array_type)
    else:
        moments_qtype = qt.ArrayType(shape=(moments_fn.size, moments_fn.size), qtype=quantity.qtype)
    return q_mod.Quantity(
        quantity_type=moments_qtype, input_quantities=[quantity], operation=eval_cov
    )
