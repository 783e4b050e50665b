"""Fused sample->moment estimation pipeline — the device hot path.

The reference's read-side hot loop (reference mlmc/quantity/quantity_estimate.py:43-65)
streams stored samples from HDF5 through a numpy Vandermonde and accumulates
per-level sums. Here one jitted program per level runs

    samples --------------> (fine, coarse)             [C]
         --basis---------> (phi_f, phi_c)              [C, R]
         --diff/mask------> dphi                       [C, R]
         --reduce---------> sums [R], sums2 [R]
         --phi^T phi------> cov_f, cov_c [R, R]        (matmul, HIGHEST)

under ``lax.fori_loop`` over chunks, so device memory traffic per chunk is
the [C, R] basis block and the accumulators stay O(R^2). The samples come
from one of two sources, through the same chunk loop:

* ``fused_level_moments`` draws them inside the loop from PRNG keys
  (storage-free: samples are never materialized);
* ``moment_pipeline_from_samples`` / ``mlmc_moment_pipeline_from_samples``
  read stored QoIs (any simulation, e.g. a ``DeviceMemory`` store) — the
  fast tier behind ``Estimate.estimate_*_fast`` and the adaptive loop.

Accumulation precision: within a chunk partial sums are computed in the
compute dtype and every contraction asks for ``Precision.HIGHEST`` (a
float32 matmul may otherwise run in TF32, a 10-bit mantissa); the
cross-chunk running accumulators are Kahan-compensated, which bounds the
error by the within-chunk error independently of the sample count
(ops/precision.py derives the bound). The stored-sample fast tier computes
in float32 whatever the global x64 flag; its extended twin
(``moment_pipeline_from_samples_extended``) runs the same loop in float64
under a scoped ``jax.enable_x64(True)``.

Sharding: ``fused_mlmc_moments`` accepts an optional mesh axis name; the
chunk loop then runs data-parallel over the ``samples`` axis and the final
accumulators are reduced with ``psum`` — the entire MLMC communication
pattern (SURVEY.md §2 parallelism checklist).
"""
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.moments import fourier_vander, legvander, polyvander

_HIGHEST = jax.lax.Precision.HIGHEST


class MomentAccumulators(NamedTuple):
    """Per-level streaming state (parity: reference quantity_estimate.py:64-77)."""

    sums: jax.Array          # [R] sum of (phi_f - phi_c) over valid samples
    sums2: jax.Array         # [R] sum of squares of the diff
    cov_fine: jax.Array      # [R, R] sum of phi_f phi_f^T
    cov_coarse: jax.Array    # [R, R] sum of phi_c phi_c^T
    n_valid: jax.Array       # [] valid-sample count (integer)
    n_total: jax.Array       # [] processed-sample count (integer)


class SynthMomentResult(NamedTuple):
    """One level's accumulators from the stored-sample pipeline."""

    sums: jax.Array        # [R]
    sums2: jax.Array       # [R]
    cov_fine: jax.Array    # [R, R]
    cov_coarse: jax.Array  # [R, R]
    n_valid: jax.Array     # [] int32


class ExtendedMomentResult(NamedTuple):
    """Host-side float64 accumulators of the extended tier; fields mirror
    ``SynthMomentResult``."""

    sums: np.ndarray        # [R] f64
    sums2: np.ndarray       # [R] f64
    cov_fine: np.ndarray    # [R, R] f64
    cov_coarse: np.ndarray  # [R, R] f64
    n_valid: int


def _moment_chunk(phi_f, phi_c, valid, acc_dtype):
    """One chunk's contributions. phi_*: [C, ..., R] (scalar QoI: [C, R];
    M-component QoI: [C, M, R]); valid: [C] bool (a sample is dropped as a
    whole if ANY component is invalid — reference mask_nan semantics,
    quantity_estimate.py:6-14). The count comes back uncast."""
    vf = valid.reshape(valid.shape + (1,) * (phi_f.ndim - 1))
    phi_f = jnp.where(vf, phi_f, 0.0)
    phi_c = jnp.where(vf, phi_c, 0.0)
    dphi = phi_f - phi_c
    sums = jnp.sum(dphi, axis=0).astype(acc_dtype)
    sums2 = jnp.sum(dphi * dphi, axis=0).astype(acc_dtype)
    # contract at least in f32, in full acc_dtype when it is wider
    pet = acc_dtype if jnp.dtype(acc_dtype).itemsize > 4 else jnp.float32
    cov_f = jnp.einsum("c...r,c...s->...rs", phi_f, phi_f, precision=_HIGHEST,
                       preferred_element_type=pet).astype(acc_dtype)
    cov_c = jnp.einsum("c...r,c...s->...rs", phi_c, phi_c, precision=_HIGHEST,
                       preferred_element_type=pet).astype(acc_dtype)
    return sums, sums2, cov_f, cov_c, jnp.sum(valid)


def _chunk_loop(chunk_terms, trip, acc_shape, n_moments, acc_dtype,
                count_dtype):
    """Kahan-compensated accumulation over ``trip`` chunks (may be traced).

    :param chunk_terms: ``f(i) -> (phi_f, phi_c, valid, n_in_range)`` for
        chunk ``i``; invalid samples may carry any finite basis values
    :return: MomentAccumulators
    """
    R = n_moments

    def kadd(a, c, delta):
        # Kahan step: cross-chunk error stays at one rounding of the final
        # value (the documented 'compensated ordering' of the f32 tier)
        y = delta - c
        t = a + y
        return t, (t - a) - y

    def body(i, acc_comp):
        acc, comp = acc_comp
        phi_f, phi_c, valid, n_in = chunk_terms(i)
        s, s2, cf, cc, nv = _moment_chunk(phi_f, phi_c, valid, acc_dtype)
        sums, c_sums = kadd(acc.sums, comp.sums, s)
        sums2, c_sums2 = kadd(acc.sums2, comp.sums2, s2)
        cov_f, c_cov_f = kadd(acc.cov_fine, comp.cov_fine, cf)
        cov_c, c_cov_c = kadd(acc.cov_coarse, comp.cov_coarse, cc)
        new_acc = MomentAccumulators(
            sums=sums, sums2=sums2, cov_fine=cov_f, cov_coarse=cov_c,
            n_valid=acc.n_valid + nv.astype(count_dtype),
            n_total=acc.n_total + n_in.astype(count_dtype))
        new_comp = comp._replace(sums=c_sums, sums2=c_sums2,
                                 cov_fine=c_cov_f, cov_coarse=c_cov_c)
        return new_acc, new_comp

    init = MomentAccumulators(
        sums=jnp.zeros(acc_shape + (R,), acc_dtype),
        sums2=jnp.zeros(acc_shape + (R,), acc_dtype),
        cov_fine=jnp.zeros(acc_shape + (R, R), acc_dtype),
        cov_coarse=jnp.zeros(acc_shape + (R, R), acc_dtype),
        n_valid=jnp.zeros((), count_dtype),
        n_total=jnp.zeros((), count_dtype),
    )
    acc, comp = jax.lax.fori_loop(0, trip, body, (init, init))
    # fold the residual compensation (true total ~ a - c)
    return acc._replace(sums=acc.sums - comp.sums,
                        sums2=acc.sums2 - comp.sums2,
                        cov_fine=acc.cov_fine - comp.cov_fine,
                        cov_coarse=acc.cov_coarse - comp.cov_coarse)


def _ceil_div_u32(a, b):
    """Overflow-safe ceil(a / b) in uint32 (a may approach 2^32; adding
    b - 1 before dividing, or an int32 cast, would wrap)."""
    b = jnp.uint32(b)
    return a // b + (a % b != 0).astype(jnp.uint32)


def fused_level_moments(
    sample_chunk_fn,
    moments_fn,
    level_key,
    n_samples,
    chunk_size: int,
    *,
    is_level0: bool,
    acc_dtype=jnp.float64,
    axis_name: Optional[str] = None,
    start_index=0,
    n_alloc: Optional[int] = None,
):
    """Stream one level's samples through the fused moment pipeline.

    :param sample_chunk_fn: ``f(keys [C]) -> (fine, coarse, failed [C])``
        pure jnp batch simulation; fine/coarse are [C] for a scalar QoI or
        [C, M] for an M-component (vector / time-series) QoI — the QoI
        shape is probed via ``jax.eval_shape`` and the accumulators become
        [M, R] / [M, R, R] (reference treats M>1 as the normal case,
        quantity_estimate.py:105-110)
    :param moments_fn: moment basis (Moments instance)
    :param level_key: PRNG key for this level
    :param n_samples: total samples to draw on this level (static)
    :param chunk_size: samples per fori_loop step (static)
    :param is_level0: True -> coarse contributions are zero
    :param acc_dtype: cross-chunk accumulator dtype
    :param axis_name: mesh axis to psum accumulators over (None = single chip)
    :param start_index: first sample index (for reproducible continuation);
        may be a traced value
    :param n_alloc: static upper bound on n_samples (sets the loop bound so
        one executable serves any smaller dynamic n_samples); defaults to
        n_samples, which must then be a static int
    :return: MomentAccumulators (already psum-reduced if axis_name given)

    Sample seeds mirror the pool scheme: ``fold_in(level_key, sample_index)``
    so the same (level, index) always produces the same draw, on any chip or
    mesh layout (reference md5(sample_id) scheme, sampling_pool.py:75-84).
    Indices are uint32: a level's stream supports up to 2^32 samples.
    """
    if n_alloc is None:
        n_alloc = int(n_samples)
    n_chunks = -(-n_alloc // chunk_size)
    # probe the QoI trailing shape (scalar () or vector (M,)) without tracing
    key_struct = jax.eval_shape(lambda: jax.random.split(
        jax.random.key(0), chunk_size))
    fine_struct = jax.eval_shape(sample_chunk_fn, key_struct)[0]
    qoi_shape = tuple(fine_struct.shape[1:])
    n_samples = jnp.asarray(n_samples, dtype=jnp.uint32)
    start_index = jnp.asarray(start_index, dtype=jnp.uint32)

    if axis_name is not None:
        shard_ix = jax.lax.axis_index(axis_name)
        n_shards = jax.lax.axis_size(axis_name)
    else:
        shard_ix = 0
        n_shards = 1

    def chunk_terms(i):
        # global chunk index = i * n_shards + shard (stride layout keeps the
        # per-index key mapping identical regardless of mesh size)
        chunk_ix = i * n_shards + shard_ix
        base = start_index + (chunk_ix * chunk_size).astype(jnp.uint32)
        idx = base + jnp.arange(chunk_size, dtype=jnp.uint32)
        in_range = idx < (start_index + n_samples)
        keys = jax.vmap(lambda j: jax.random.fold_in(level_key, j))(idx)
        fine, coarse, failed = sample_chunk_fn(keys)
        comp_axes = tuple(range(1, fine.ndim))  # QoI component axes, if any
        valid = (in_range & ~failed
                 & ~jnp.any(jnp.isnan(fine), axis=comp_axes))
        if not is_level0:
            # level 0's coarse output is ignored entirely, so a NaN there
            # (a natural 'no coarse' marker) must not invalidate the sample
            valid = valid & ~jnp.any(jnp.isnan(coarse), axis=comp_axes)

        phi_f = moments_fn.eval_all(fine)       # [C, ..., R]
        if is_level0:
            phi_c = jnp.zeros_like(phi_f)
        else:
            phi_c = moments_fn.eval_all(coarse)
        # moment-domain clipping produces NaN lanes -> invalid sample
        phi_axes = tuple(range(1, phi_f.ndim))
        valid = valid & ~jnp.any(jnp.isnan(phi_f), axis=phi_axes)
        if not is_level0:
            valid = valid & ~jnp.any(jnp.isnan(phi_c), axis=phi_axes)
        return (jnp.nan_to_num(phi_f), jnp.nan_to_num(phi_c), valid,
                jnp.sum(in_range))

    # shards process interleaved chunks; ceil so every chunk is covered
    n_local_chunks = -(-n_chunks // n_shards)
    # dynamic trip count: run only the chunks the TRACED count needs, so
    # one executable (compiled at the static n_alloc bound) serves any
    # smaller count; the static bound stays a clamp
    needed = _ceil_div_u32(_ceil_div_u32(n_samples, chunk_size), n_shards)
    trip = jnp.minimum(jnp.uint32(n_local_chunks), needed).astype(jnp.int32)
    # counts in uint32 (the index range): a float32 count is inexact past
    # 2^24 samples, so mesh layouts would disagree on n_valid
    acc = _chunk_loop(chunk_terms, trip, qoi_shape, moments_fn.size,
                      acc_dtype, jnp.uint32)
    if axis_name is not None:
        acc = jax.tree.map(lambda x: jax.lax.psum(x, axis_name), acc)
    return acc


def accumulators_to_estimates(accs):
    """Combine per-level accumulators into MLMC estimates (host, numpy).

    :param accs: list of MomentAccumulators (one per level)
    :return: dict with l_means [L, R], l_vars [L, R], mean [R], var [R],
        cov [R, R] (telescoped fine-coarse), n_samples [L]
    """
    l_means, l_vars, ns, covs = [], [], [], []
    for lvl, a in enumerate(accs):
        s = np.asarray(a.sums, dtype=np.float64)
        s2 = np.asarray(a.sums2, dtype=np.float64)
        n = float(a.n_valid)
        ns.append(n)
        # explicit degenerate-count semantics (match quantity_estimate):
        # n == 0 -> zero mean / infinite variance, n == 1 -> infinite var
        safe_n = max(n, 1.0)
        mean = s / safe_n
        var = ((s2 - s * s / safe_n) / (n - 1) if n > 1
               else np.full_like(s, np.inf))
        if n == 0:
            mean = np.zeros_like(s)
        l_means.append(mean)
        l_vars.append(var)
        cf = np.asarray(a.cov_fine, dtype=np.float64) / safe_n
        cc = np.asarray(a.cov_coarse, dtype=np.float64) / safe_n
        covs.append(cf - cc if lvl > 0 else cf)
    l_means = np.stack(l_means)
    l_vars = np.stack(l_vars)
    ns = np.asarray(ns)
    return dict(
        l_means=l_means,
        l_vars=l_vars,
        mean=l_means.sum(axis=0),
        var=(l_vars / np.maximum(ns, 1.0)[:, None]).sum(axis=0),
        cov=np.sum(covs, axis=0),
        n_samples=ns,
    )


def fused_mlmc_moments(
    sim_chunk_fns,
    moments_fn,
    root_key,
    n_samples_per_level,
    chunk_size: int = 32768,
    acc_dtype=None,
    axis_name: Optional[str] = None,
):
    """All levels of the fused pipeline in ONE traced program.

    :param sim_chunk_fns: per-level ``f(keys) -> (fine, coarse, failed)``
    :param n_samples_per_level: static per-level counts (list of int)
    :return: list of MomentAccumulators, one per level

    Jit this (optionally inside ``shard_map`` over a ``samples`` axis) to get
    the whole telescoped estimate as a single executable.
    """
    if acc_dtype is None:
        acc_dtype = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32
    accs = []
    for lvl, (fn, n) in enumerate(zip(sim_chunk_fns, n_samples_per_level)):
        level_key = jax.random.fold_in(root_key, lvl)
        accs.append(
            fused_level_moments(
                fn,
                moments_fn,
                level_key,
                int(n),
                min(chunk_size, max(int(n), 1)),
                is_level0=(lvl == 0),
                acc_dtype=acc_dtype,
                axis_name=axis_name,
            )
        )
    return accs


# ------------------------------------------------------------------ #
# stored-sample pipeline (QoIs of ANY simulation, read from a store)
# ------------------------------------------------------------------ #
#: stored samples per chunk of the stored-sample pipeline: the fastest of
#: 2^13..2^18 on an H100 over ~1e7 stored samples in 5 levels (127 ms at
#: 2^13 down to 16.7 ms at 2^18); padding a small level to one chunk
#: costs less than the per-chunk loop overhead it saves
STORED_CHUNK = 1 << 18

_BASES = {"legendre": legvander, "monomial": polyvander,
          "fourier": lambda t, deg: fourier_vander(t, deg + 1)}


def _stored_level_moments(fine, coarse, n_true, *, n_moments, domain,
                          ref_domain, basis, chunk, has_coarse, dtype):
    """One level of stored QoIs through the chunk loop (traceable).

    :param fine/coarse: [n_chunks * chunk] padded QoI arrays (padding and
        NaN entries are invalid; ``coarse`` is ignored without a coarse part)
    :param n_true: true sample count (may be traced): the trip count is
        dynamic, so one executable serves every count up to the padding
    """
    a, b = domain
    ref_lo, ref_hi = ref_domain
    scale = (ref_hi - ref_lo) / (b - a)
    vander = _BASES[basis]
    n_chunks = fine.shape[0] // chunk
    n_true = jnp.asarray(n_true, jnp.int32)

    def transform(x):
        # Moments.linear: t = (x - domain_lo) * scale + ref_lo; NaN QoIs
        # (masked results) fail the range test below
        return (x.astype(dtype) - dtype(a)) * dtype(scale) + dtype(ref_lo)

    def chunk_terms(i):
        start = i * chunk
        idx = start + jnp.arange(chunk, dtype=jnp.int32)
        t_f = transform(jax.lax.dynamic_slice(fine, (start,), (chunk,)))
        valid = (t_f >= ref_lo) & (t_f <= ref_hi) & (idx < n_true)
        phi_f = vander(jnp.where(valid, t_f, 0.0), n_moments - 1)
        if not has_coarse:
            return phi_f, jnp.zeros_like(phi_f), valid, jnp.int32(0)
        # reference semantics: a sample is dropped if EITHER part clips
        t_c = transform(jax.lax.dynamic_slice(coarse, (start,), (chunk,)))
        valid = valid & (t_c >= ref_lo) & (t_c <= ref_hi)
        phi_c = vander(jnp.where(valid, t_c, 0.0), n_moments - 1)
        return phi_f, phi_c, valid, jnp.int32(0)

    trip = jnp.minimum((n_true + chunk - 1) // chunk, n_chunks)
    acc = _chunk_loop(chunk_terms, trip, (), n_moments, dtype, jnp.int32)
    return SynthMomentResult(sums=acc.sums, sums2=acc.sums2,
                             cov_fine=acc.cov_fine,
                             cov_coarse=acc.cov_coarse, n_valid=acc.n_valid)


def packed_level_moments(fine, coarse, counts, *, n_moments,
                         chunks_per_level, has_coarse, domain,
                         ref_domain=(-1.0, 1.0), basis="legendre",
                         chunk=STORED_CHUNK, dtype=jnp.float32):
    """All packed streams of a stored-sample estimate (traceable).

    :param fine/coarse: concatenated streams, stream ``l`` occupying
        ``chunks_per_level[l] * chunk`` entries (see ``pack_level_samples``)
    :param counts: [L] true per-stream sample counts (may be traced)
    :return: list of SynthMomentResult, one per stream
    """
    if not (len(chunks_per_level) == len(has_coarse) == len(counts)):
        raise ValueError(
            "chunks_per_level, has_coarse and counts have %d, %d and %d "
            "entries" % (len(chunks_per_level), len(has_coarse), len(counts)))
    assert fine.shape[0] == sum(chunks_per_level) * chunk, (
        fine.shape, chunks_per_level, chunk)
    out, offset = [], 0
    for lvl, n_chunks in enumerate(chunks_per_level):
        size = n_chunks * chunk
        out.append(_stored_level_moments(
            fine[offset:offset + size], coarse[offset:offset + size],
            counts[lvl], n_moments=n_moments, domain=domain,
            ref_domain=ref_domain, basis=basis, chunk=chunk,
            has_coarse=bool(has_coarse[lvl]), dtype=dtype))
        offset += size
    return out


_samples_mlmc_dispatch = jax.jit(
    packed_level_moments,
    static_argnames=("n_moments", "chunks_per_level", "has_coarse",
                     "domain", "ref_domain", "basis", "chunk", "dtype"))


def _pow2_chunks(n, chunk):
    """Power-of-two chunk count covering ``n`` samples (at least one): a
    growing store (adaptive rounds) then reuses the compiled executable
    instead of recompiling for every new total length."""
    return 1 << (max(-(-int(n) // chunk), 1) - 1).bit_length()


def pack_level_samples(level_fine, level_coarse, chunk=STORED_CHUNK):
    """Concatenate per-level QoI arrays, NaN-padding each level to a
    power-of-two count of chunks (helper for
    ``mlmc_moment_pipeline_from_samples``).

    Device arrays stay on device (DeviceMemory storage path — the payload
    must not round-trip through the host); numpy inputs stay numpy.

    :return: (fine [total_pad], coarse [total_pad], n_per_level tuple)
    """
    on_device = any(isinstance(f, jax.Array) for f in level_fine)
    xp = jnp if on_device else np
    f_parts, c_parts, counts = [], [], []
    for f, c in zip(level_fine, level_coarse):
        f = xp.asarray(f, dtype=xp.float32)
        c = (xp.zeros_like(f) if c is None
             else xp.asarray(c, dtype=xp.float32))
        n = f.shape[0]
        pad = _pow2_chunks(n, chunk) * chunk - n
        f_parts.append(xp.pad(f, (0, pad), constant_values=xp.nan))
        c_parts.append(xp.pad(c, (0, pad), constant_values=xp.nan))
        counts.append(n)
    return (xp.concatenate(f_parts), xp.concatenate(c_parts), tuple(counts))


def mlmc_moment_pipeline_from_samples(fine, coarse, n_per_level, n_moments,
                                      *, domain, ref_domain=(-1.0, 1.0),
                                      basis="legendre", chunk=STORED_CHUNK,
                                      has_coarse=None):
    """ALL levels of a stored-sample moment estimate in ONE dispatch.

    True per-level counts are DYNAMIC: adaptive rounds whose counts grow
    within the same power-of-two padded chunk structure reuse the compiled
    executable; only a change of padded structure (or of the static
    config) recompiles.

    :param fine/coarse: f32 arrays from ``pack_level_samples`` (level 0's
        coarse part is ignored)
    :param n_per_level: true per-level counts
    :param has_coarse: per-stream flags; default: every level but level 0
        (callers packing (level, component) streams pass them per entry)
    :return: list of SynthMomentResult (float32 accumulators), one per level
    """
    L = len(n_per_level)
    if has_coarse is None:
        has_coarse = tuple(lvl > 0 for lvl in range(L))
    return _samples_mlmc_dispatch(
        jnp.asarray(fine, jnp.float32), jnp.asarray(coarse, jnp.float32),
        jnp.asarray([int(n) for n in n_per_level], jnp.int32),
        n_moments=n_moments,
        chunks_per_level=tuple(_pow2_chunks(n, chunk) for n in n_per_level),
        has_coarse=tuple(bool(h) for h in has_coarse),
        domain=tuple(float(v) for v in domain),
        ref_domain=tuple(float(v) for v in ref_domain), basis=basis,
        chunk=chunk)


def moment_pipeline_from_samples(fine, coarse, n_moments, *, domain,
                                 ref_domain=(-1.0, 1.0), basis="legendre",
                                 chunk=STORED_CHUNK, is_level0=False):
    """One level of PRE-COMPUTED scalar QoIs of ANY simulation (e.g. read
    back from a SampleStorage) -> moment sums + covariance, for any of the
    legendre/monomial/fourier bases (reference mlmc/moments.py:111-229).
    NaN entries (masked results) are dropped per the reference semantics.

    :param fine/coarse: [N] float arrays (coarse ignored for level 0)
    :param ref_domain: the basis' reference domain (clip bounds)
    :return: SynthMomentResult (float32 accumulators)
    """
    return mlmc_moment_pipeline_from_samples(
        *pack_level_samples([fine], [None if is_level0 else coarse],
                            chunk=chunk),
        n_moments, domain=domain, ref_domain=ref_domain, basis=basis,
        chunk=chunk, has_coarse=(not is_level0,))[0]


def synth_qoi(noise, fine_step, coarse_step):
    """Synthetic QoI pair from standard-normal noise in float32
    (reference synth_simulation.py:38-46)."""
    x = jnp.asarray(noise, jnp.float32)
    err = jnp.sqrt(jnp.float32(1e-4) + jnp.abs(x))
    return x + jnp.float32(fine_step) * err, x + jnp.float32(coarse_step) * err


def synth_moment_pipeline_from_noise(noise, n_moments, *, fine_step,
                                     coarse_step, domain, chunk=STORED_CHUNK,
                                     is_level0=False):
    """Synthetic level from given noise: noise -> QoI -> the stored-sample
    pipeline. Exactly testable (feed known normals, compare against numpy
    or ``ops/precision.f64_reference_moments``).

    :return: SynthMomentResult (float32 accumulators)
    """
    fine, coarse = synth_qoi(noise, fine_step, coarse_step)
    return moment_pipeline_from_samples(
        fine, coarse, n_moments, domain=domain, chunk=chunk,
        is_level0=is_level0)


# ------------------------------------------------------------------ #
# extended tier: the same loop in float64
# ------------------------------------------------------------------ #
def moment_pipeline_from_samples_extended(fine, coarse, n_moments, *,
                                          domain, ref_domain=(-1.0, 1.0),
                                          basis="legendre", chunk=STORED_CHUNK,
                                          is_level0=False):
    """Float64 stored-sample pipeline (one level) for final 1e-10-grade
    estimates: the f32 QoIs (what a store holds) are widened on entry and
    the transform, basis and every sum run in float64, tracking the
    reference's all-f64 numpy pipeline (reference
    quantity_estimate.py:64-77, moments.py:195-197) to the bound of
    ``ops/precision.f64_error_bound``.

    Runs under a scoped ``jax.enable_x64(True)``: it needs no global flag.

    :return: ExtendedMomentResult (host float64)
    """
    n = int(np.shape(fine)[0])
    with jax.enable_x64(True):
        packed = pack_level_samples(
            [fine], [None if is_level0 else coarse], chunk=chunk)
        res = _samples_mlmc_dispatch(
            jnp.asarray(packed[0], jnp.float32),
            jnp.asarray(packed[1], jnp.float32),
            jnp.asarray([n], jnp.int32), n_moments=n_moments,
            chunks_per_level=(_pow2_chunks(n, chunk),),
            has_coarse=(not is_level0,),
            domain=tuple(float(v) for v in domain),
            ref_domain=tuple(float(v) for v in ref_domain), basis=basis,
            chunk=chunk, dtype=jnp.float64)[0]
        res = jax.device_get(res)
    return ExtendedMomentResult(
        sums=np.asarray(res.sums, np.float64),
        sums2=np.asarray(res.sums2, np.float64),
        cov_fine=np.asarray(res.cov_fine, np.float64),
        cov_coarse=np.asarray(res.cov_coarse, np.float64),
        n_valid=int(res.n_valid))


def synth_moment_pipeline_from_noise_extended(noise, n_moments, *,
                                              fine_step, coarse_step,
                                              domain, chunk=STORED_CHUNK,
                                              is_level0=False):
    """Extended-tier synthetic level: the f32 QoI transform, then the
    float64 stored-sample pipeline. A host reference must consume the
    same QoI bits (``precision.f64_reference_moments_strict(fine32=...,
    coarse32=...)``): a device's f32 ``sqrt`` need not match numpy's."""
    fine, coarse = synth_qoi(noise, fine_step, coarse_step)
    return moment_pipeline_from_samples_extended(
        fine, coarse, n_moments, domain=domain, chunk=chunk,
        is_level0=is_level0)
