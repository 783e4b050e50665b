"""Lazy, typed Quantity algebra over stored MLMC samples — device-native.

Re-design of reference mlmc/quantity/quantity.py:14-695. A Quantity is a DAG
node holding a *pure array operation* over level chunks ``[M, N, 2]``.
Differences from the reference:

* chunk operations are written against ``jax.numpy`` so a fully shape-static
  DAG composes into one traced function (see ``Quantity.traceable`` and
  ``quantity_estimate.estimate_mean``'s jitted accumulation path),
* shape-dynamic ops (``select`` row masking, ``subsample``) evaluate eagerly
  on host (they change the sample count per chunk, which XLA cannot trace);
  statistics downstream are unaffected,
* sample memoization is an explicit dict keyed like the reference
  (level, chunk, size, node-id) with a global ``cache_clear()``.
"""
import collections
import functools
import itertools
import operator
import numpy as np
import jax.numpy as jnp
from typing import List

import mlmc_tpu.quantity.quantity_types as qt
from mlmc_tpu.quantity.quantity_spec import QuantitySpec, ChunkSpec

_RNG = np.random.default_rng()

# global memoization of Quantity.samples evaluations (reference uses
# @cached with custom key (level_id, chunk_id, chunk_size, id(self));
# we use a monotonic per-node uid instead of id() — CPython reuses ids
# after GC, which would let stale cache entries alias new nodes).
# LRU-bounded: long interactive sessions chaining select/subsample would
# otherwise accumulate chunk arrays without limit.
_SAMPLE_CACHE = collections.OrderedDict()
_SAMPLE_CACHE_MAX = 512
_UID_COUNTER = itertools.count()


def cache_clear():
    """Drop the memoized per-chunk DAG evaluation cache."""
    _SAMPLE_CACHE.clear()


def _resolve_provenance(inputs):
    """One linear pass over already-constructed inputs -> (storage, selection).

    Mixing nodes that draw from different sample populations — two storages,
    or a ``select``-ed subset with its unselected parent — is rejected: row
    ``i`` of their chunks would no longer refer to the same sample.
    """
    storage = next(
        (s for s in (q.get_quantity_storage() for q in inputs) if s is not None),
        None)
    selections = {q.selection_id() for q in inputs} - {None}
    if len(selections) > 1:
        raise ValueError(
            "cannot combine quantities drawn from different sample "
            "populations (selection ids {})".format(sorted(selections)))
    return storage, (selections.pop() if selections else None)


def _fold_conditions(conditions):
    """AND together Bool-typed condition quantities into one [N] mask node."""
    for cond in conditions:
        if not isinstance(cond.qtype.base_qtype(), qt.BoolType):
            raise TypeError(
                "condition quantity must have a Bool base type, got {}".format(
                    cond.qtype.base_qtype()))
    combined = conditions[0]
    for extra in conditions[1:]:
        combined = np.logical_and(combined, extra)  # ufunc protocol -> node
    return combined


def make_root_quantity(storage, q_specs: List[QuantitySpec]):
    """Root quantity reading directly from a SampleStorage.

    Same structural result as reference quantity.py:14-32 — the flat M axis
    is typed Dict(name -> TimeSeries(time -> Field(location -> Array(shape))))
    — built here by folding each spec through its nesting levels.
    """
    def spec_type(spec):
        leaf = qt.ArrayType(spec.shape, qt.ScalarType(float))
        per_time = qt.FieldType([(loc, leaf) for loc in spec.locations])
        return qt.TimeSeriesType(spec.times, per_time)

    return QuantityStorage(
        storage, qt.DictType([(s.name, spec_type(s)) for s in q_specs]))


class Quantity:
    """Lazy typed node of the post-processing DAG: an operation over
    input quantities, evaluated per stored chunk (reference
    mlmc/quantity/quantity.py:35-513). Traceable nodes compose into one
    jitted program under the fused estimation tiers."""

    def __init__(self, quantity_type, operation, input_quantities=[], traceable=True):
        """
        :param quantity_type: QType instance
        :param operation: pure function over input chunk arrays
        :param input_quantities: List[Quantity]
        :param traceable: whether the operation is jnp-pure and shape-static
            (safe to trace under jit). Shape-changing ops must pass False.
        """
        self.qtype = quantity_type
        self._operation = operation
        self._input_quantities = input_quantities
        self._traceable = traceable
        self._uid = next(_UID_COUNTER)
        # Provenance is resolved ONCE at construction: inputs are already
        # built (the graph is acyclic), so one linear pass suffices — unlike
        # the reference, which re-walks the sub-DAG on every
        # get_quantity_storage()/selection_id() call (quantity.py:55-124).
        self._storage, self._selection_id = _resolve_provenance(input_quantities)

    # ------------------------------------------------------------------ #
    # DAG provenance accessors
    # ------------------------------------------------------------------ #
    def get_quantity_storage(self):
        """The QuantityStorage leaf this node reads from (None = constant)."""
        return self._storage

    def selection_id(self):
        """Identity of the sample population this node draws from.

        Every ``select`` creates a fresh population (its own uid); otherwise
        the population is the underlying storage leaf. Quantities from
        different populations cannot be combined.
        """
        if self._selection_id is not None:
            return self._selection_id
        return self._storage._uid if self._storage is not None else None

    def size(self) -> int:
        """Flattened length of this quantity along the M axis."""
        return self.qtype.size()

    def traceable(self):
        """True if the whole sub-DAG evaluates with static shapes under jit."""
        return self._traceable and all(q.traceable() for q in self._input_quantities)

    # ------------------------------------------------------------------ #
    # evaluation
    # ------------------------------------------------------------------ #
    def _cache_key(self, chunk_spec):
        chunk_size = None
        if chunk_spec.chunk_slice is not None:
            chunk_size = chunk_spec.chunk_slice.stop - chunk_spec.chunk_slice.start
        return (chunk_spec.level_id, chunk_spec.chunk_id, chunk_size, self._uid)

    def samples(self, chunk_spec):
        """Evaluate this node's chunk for one ChunkSpec (memoized)."""
        key = self._cache_key(chunk_spec)
        if key in _SAMPLE_CACHE:
            _SAMPLE_CACHE.move_to_end(key)
            return _SAMPLE_CACHE[key]
        chunks_quantity_level = [q.samples(chunk_spec) for q in self._input_quantities]
        result = self._operation(*chunks_quantity_level)
        _SAMPLE_CACHE[key] = result
        while len(_SAMPLE_CACHE) > _SAMPLE_CACHE_MAX:
            _SAMPLE_CACHE.popitem(last=False)
        return result

    def build_eval(self):
        """Compose the DAG into one pure function ``f(leaf_chunk) -> chunk``.

        Only valid when ``self.traceable()``; used by the jitted estimator
        path so the whole per-chunk pipeline compiles to a single XLA
        computation (moment Vandermonde, arithmetic, reshapes all fused).
        """
        storage_q = self.get_quantity_storage()

        def node_eval(node, leaf):
            if node is storage_q:
                return leaf
            if isinstance(node, QuantityConst):
                return node._value
            inputs = [node_eval(q, leaf) for q in node._input_quantities]
            return node._operation(*inputs)

        return lambda leaf: node_eval(self, leaf)

    # ------------------------------------------------------------------ #
    # algebra construction
    # ------------------------------------------------------------------ #
    def select(self, *conditions):
        """Sample selection based on Bool-typed condition quantities.

        Removes whole samples whose mask is False — shape dynamic, so this
        node (and everything above it) evaluates eagerly per chunk. The
        node starts a fresh sample population (own selection id).
        """
        combined = _fold_conditions(conditions)

        def drop_rows(x, keep):
            return np.asarray(x)[..., np.asarray(keep), :]

        q = Quantity(quantity_type=self.qtype, input_quantities=[self, combined],
                     operation=drop_rows, traceable=False)
        q._selection_id = q._uid
        return q

    def mask(self, *conditions):
        """Traceable counterpart of ``select`` for estimation workloads.

        Instead of REMOVING non-selected samples (shape-dynamic — forces
        eager per-node evaluation), the samples are NaN-poisoned in place:
        shapes stay static, the whole DAG fuses under jit, and
        ``estimate_mean``'s NaN masking drops them with identical estimates
        (they are counted in ``n_rm_samples``). Use ``select`` when you need
        the raw surviving samples; use ``mask`` when you only estimate.
        """
        combined = _fold_conditions(conditions)

        def poison_rows(x, keep):
            return jnp.where(jnp.asarray(keep)[None, :, None],
                             jnp.asarray(x), jnp.nan)

        return Quantity(quantity_type=self.qtype,
                        input_quantities=[self, combined], operation=poison_rows)

    def __array_ufunc__(self, ufunc, method, *args, **kwargs):
        return Quantity._method(ufunc, method, *args, **kwargs)

    # arithmetic dunders are GENERATED below the class body from the
    # operator module (one factory instead of ten hand-written methods);
    # the reference-named op aliases (add_op, ...) stay for API parity

    @staticmethod
    def create_quantity(quantities, operation):
        """Lift ``operation`` over DAG nodes; all-constant inputs fold
        eagerly to a new constant instead of a graph node."""
        live = [q for q in quantities if not isinstance(q, QuantityConst)]
        if not live:
            return QuantityConst(quantities[0].qtype,
                                 value=operation(*(q._value for q in quantities)))
        return Quantity(live[0].qtype, operation=operation,
                        input_quantities=quantities)

    # reference-API alias (reference quantity.py names this _reduction_op)
    def _reduction_op(self, quantities, operation):
        return Quantity.create_quantity(quantities, operation)

    # ------------------------------------------------------------------ #
    # comparisons -> Bool mask quantities (reference quantity.py:246-305)
    # ------------------------------------------------------------------ #
    @staticmethod
    def _process_mask(x, y, op):
        """All values of a sample (and both fine+coarse) must meet the
        condition -> [N] bool. Pure jnp (shape-static), so condition DAGs
        stay traceable; only ``select``'s row removal breaks tracing."""
        mask = jnp.asarray(op(x, y))
        return mask.all(axis=tuple(range(mask.ndim - 2))).all(axis=-1)

    def _mask_quantity(self, other, op):
        """Comparison node: Bool-typed, one [N] truth value per sample."""
        other = Quantity.wrap(other)
        for operand in (self, other):
            if not isinstance(operand.qtype.base_qtype(), qt.ScalarType):
                raise TypeError(
                    "only ScalarType-based quantities compare; got base "
                    "qtype {}".format(operand.qtype.base_qtype()))
        return Quantity(quantity_type=self.qtype.replace_scalar(qt.BoolType()),
                        input_quantities=[self, other], operation=op)

    def __lt__(self, other):
        return self._mask_quantity(other, lambda x, y: Quantity._process_mask(x, y, operator.lt))

    def __le__(self, other):
        return self._mask_quantity(other, lambda x, y: Quantity._process_mask(x, y, operator.le))

    def __gt__(self, other):
        return self._mask_quantity(other, lambda x, y: Quantity._process_mask(x, y, operator.gt))

    def __ge__(self, other):
        return self._mask_quantity(other, lambda x, y: Quantity._process_mask(x, y, operator.ge))

    def __eq__(self, other):
        return self._mask_quantity(other, lambda x, y: Quantity._process_mask(x, y, operator.eq))

    def __ne__(self, other):
        return self._mask_quantity(other, lambda x, y: Quantity._process_mask(x, y, operator.ne))

    # ------------------------------------------------------------------ #
    # subsampling (bootstrap support; reference quantity.py:307-364)
    # ------------------------------------------------------------------ #
    def subsample(self, sample_vec):
        """Streaming subsample: pick ~sample_vec[l] samples per level.

        Uses the hypergeometric streaming scheme of the reference
        (Vitter's method S analogue): for each chunk of a level draw
        ``Hypergeom(n_remaining, k_remaining, chunk_n)`` columns.
        Host-side RNG, shape-dynamic (eager path).
        """
        import scipy.stats

        n_collected = list(self.get_quantity_storage().n_collected())
        state = {}

        def reset(level_id):
            state[level_id] = {
                "k": int(sample_vec[level_id]),
                "n": int(n_collected[level_id]),
            }

        class _LevelParams:
            """Per-chunk handle delivering streaming state for its level."""

            def __init__(self, level_id, chunk_id):
                if chunk_id in (0, None) or level_id not in state:
                    reset(level_id)
                self.level_id = level_id

        params_quantity = _SubsampleParamsQuantity(_LevelParams)

        def pick_samples(chunk, level_params):
            chunk = np.asarray(chunk)
            st = state[level_params.level_id]
            n_chunk = chunk.shape[1]
            size = int(scipy.stats.hypergeom(st["n"], st["k"], n_chunk).rvs(size=1)[0])
            idx = _RNG.choice(n_chunk, size=size, replace=False) if size > 0 else np.empty(0, int)
            out = chunk[:, np.sort(idx), :]
            st["k"] -= out.shape[1]
            st["n"] -= n_chunk
            return out

        return Quantity(
            quantity_type=self.qtype.replace_scalar(qt.BoolType()),
            input_quantities=[self, params_quantity],
            operation=pick_samples,
            traceable=False,
        )

    # ------------------------------------------------------------------ #
    # structured access
    # ------------------------------------------------------------------ #
    def __getitem__(self, key):
        new_qtype, start = self.qtype.get_key(key)
        if not isinstance(self.qtype, qt.ArrayType):
            key = slice(start, start + new_qtype.size())

        def _make_getitem_op(y):
            return self.qtype._make_getitem_op(y, key=key)

        return Quantity(quantity_type=new_qtype, input_quantities=[self], operation=_make_getitem_op)

    def __getattr__(self, name):
        # unknown attributes forward to static QType helpers applied to
        # this quantity (e.g. q.time_interpolation(t))
        return functools.partial(getattr(self.qtype, name), self)

    @staticmethod
    def _concatenate(quantities, qtype, axis=0):
        def op_concatenate(*chunks):
            return jnp.concatenate(tuple(jnp.asarray(ch) for ch in chunks), axis=axis)

        return Quantity(qtype, input_quantities=[*quantities], operation=op_concatenate)

    @staticmethod
    def _get_base_qtype(args_quantities):
        """ScalarType if any quantity input carries scalars, else BoolType."""
        has_scalar = any(
            type(q.qtype.base_qtype()) is qt.ScalarType
            for q in args_quantities if isinstance(q, Quantity)
        )
        return qt.ScalarType() if has_scalar else qt.BoolType()

    @staticmethod
    def _method(ufunc, method, *args, **kwargs):
        """numpy ufunc protocol: evaluate the ufunc on chunk arrays.

        ``__call__`` of a known ufunc maps to the jnp equivalent (stays on
        device / traceable); other methods (reduce, …) fall back to host
        numpy (still correct, not fused).
        """
        jnp_fn = getattr(jnp, ufunc.__name__, None) if method == "__call__" else None
        if jnp_fn is not None and not kwargs:

            def _ufunc_call(*input_chunks):
                return jnp_fn(*[jnp.asarray(ch) for ch in input_chunks])

            traceable = True
        else:

            def _ufunc_call(*input_chunks):
                return getattr(ufunc, method)(*[np.asarray(ch) for ch in input_chunks], **kwargs)

            # numpy fallback converts chunks with np.asarray -> cannot trace
            traceable = False

        quantities = [Quantity.wrap(arg) for arg in args]
        result_qtype = Quantity._result_qtype(_ufunc_call, quantities)
        return Quantity(
            quantity_type=result_qtype,
            input_quantities=list(quantities),
            operation=_ufunc_call,
            traceable=traceable,
        )

    # host type -> QType factory for constant lifting
    _WRAP_RULES = (
        ((bool, np.bool_), lambda v: qt.BoolType()),
        ((int, float, np.integer, np.floating), lambda v: qt.ScalarType()),
        ((list, tuple, np.ndarray, jnp.ndarray),
         lambda v: qt.ArrayType(shape=np.shape(v), qtype=qt.ScalarType())),
    )

    @staticmethod
    def wrap(value):
        """Lift a host value into a QuantityConst; Quantities pass through."""
        if isinstance(value, Quantity):
            return value
        for types, make_qtype in Quantity._WRAP_RULES:
            if isinstance(value, types):
                if isinstance(value, (list, tuple, jnp.ndarray)):
                    value = np.asarray(value)
                return QuantityConst(quantity_type=make_qtype(value), value=value)
        raise ValueError(
            "cannot lift {!r} into a Quantity constant "
            "(expected bool, number, or array-like)".format(value))

    @staticmethod
    def _probe_chunk(quantity):
        """First stored chunk of a quantity (constants get a dummy spec)."""
        storage = quantity.get_quantity_storage()
        spec = ChunkSpec() if storage is None else next(storage.chunks())
        return quantity.samples(spec)

    @staticmethod
    def _result_qtype(method, quantities):
        """Result QType found by running the op on one probe chunk per input
        (reference quantity.py:459-479 semantics)."""
        probe = method(*(Quantity._probe_chunk(q) for q in quantities))
        base = Quantity._get_base_qtype(quantities)
        return qt.ArrayType(shape=probe.shape[0], qtype=base)

    # -------------------------------------------------------------- #
    # composite constructors: children stacked along the flat M axis
    # under the matching structural QType
    # -------------------------------------------------------------- #
    @staticmethod
    def QArray(quantities):
        """(Nested) lists of same-typed quantities -> ArrayType quantity."""
        grid = np.asarray(quantities, dtype=object)
        children = list(grid.ravel())
        elem_type = Quantity._check_same_qtype(children)
        return Quantity._concatenate(children, qt.ArrayType(grid.shape, elem_type))

    @staticmethod
    def QDict(key_quantity):
        """(name, quantity) pairs -> one DictType quantity (children
        concatenate along the M axis in declaration order)."""
        pairs = list(key_quantity)
        dict_type = qt.DictType([(key, q.qtype) for key, q in pairs])
        return Quantity._concatenate([q for _, q in pairs], dict_type)

    @staticmethod
    def QTimeSeries(time_quantity):
        """(time, quantity) pairs of one shared type -> TimeSeriesType."""
        pairs = list(time_quantity)
        children = [q for _, q in pairs]
        elem_type = Quantity._check_same_qtype(children)
        ts_type = qt.TimeSeriesType(times=[t for t, _ in pairs], qtype=elem_type)
        return Quantity._concatenate(children, ts_type)

    @staticmethod
    def QField(key_quantity):
        """(location, quantity) pairs of one shared type -> FieldType."""
        pairs = list(key_quantity)
        children = [q for _, q in pairs]
        Quantity._check_same_qtype(children)
        field_type = qt.FieldType([(key, q.qtype) for key, q in pairs])
        return Quantity._concatenate(children, field_type)

    @staticmethod
    def _check_same_qtype(quantities):
        """All children must share one QType; return it."""
        first = quantities[0].qtype
        if any(q.qtype != first for q in quantities[1:]):
            raise ValueError("Quantities don't have same QType")
        return first


def _install_arithmetic(cls):
    """Generate the binary arithmetic protocol from the operator module.

    Each dunder builds a traceable DAG node via create_quantity (constants
    fold eagerly); reflected variants swap the operand order. The
    reference-named staticmethod aliases (add_op, sub_op, mult_op,
    truediv_op, mod_op) point at the same operator functions.
    """
    table = {"add": operator.add, "sub": operator.sub, "mul": operator.mul,
             "truediv": operator.truediv, "mod": operator.mod}
    alias = {"add": "add_op", "sub": "sub_op", "mul": "mult_op",
             "truediv": "truediv_op", "mod": "mod_op"}

    def make(op, reflected):
        def binop(self, other):
            pair = [cls.wrap(other), self] if reflected else [self, cls.wrap(other)]
            return cls.create_quantity(pair, op)
        return binop

    for name, op in table.items():
        setattr(cls, "__{}__".format(name), make(op, False))
        setattr(cls, "__r{}__".format(name), make(op, True))
        setattr(cls, alias[name], staticmethod(op))
    return cls


_install_arithmetic(Quantity)


class _SubsampleParamsQuantity:
    """Internal pseudo-quantity delivering per-chunk subsample state."""

    _storage = None
    _selection_id = None

    def __init__(self, level_params_cls):
        self._cls = level_params_cls
        self.qtype = qt.ScalarType()
        self._input_quantities = []

    def samples(self, chunk_spec):
        return self._cls(chunk_spec.level_id, chunk_spec.chunk_id)

    def get_quantity_storage(self):
        return None

    def selection_id(self):
        return None

    def traceable(self):
        return False


class QuantityConst(Quantity):
    """Constant leaf: a host value broadcast as ``[M, 1, 1]`` against
    every chunk (reference quantity.py:515-565)."""

    def __init__(self, quantity_type, value):
        self.qtype = quantity_type
        self._uid = next(_UID_COUNTER)
        self._value = self._process_value(value)
        self._input_quantities = []
        self._selection_id = None
        self._traceable = True
        self._storage = None
        self._operation = None

    def _process_value(self, value):
        if isinstance(value, (int, float, bool, np.integer, np.floating)):
            value = np.array([value])
        value = np.asarray(value)
        return value[:, np.newaxis, np.newaxis]

    def selection_id(self):
        return self._selection_id

    def _adjust_value(self, value, level_id=None):
        return value

    def samples(self, chunk_spec):
        key = self._cache_key(chunk_spec)
        if key in _SAMPLE_CACHE:
            return _SAMPLE_CACHE[key]
        result = self._adjust_value(self._value, chunk_spec.level_id)
        _SAMPLE_CACHE[key] = result
        return result


class QuantityMean:
    """Result of estimate_mean: per-level moment sums telescoped on demand.

    Holds the raw per-level statistics (flat along the M axis) and combines
    them lazily: ``mean = Σ_l mean_l`` and ``var = Σ_l var_l / n_l`` — the
    MLMC telescope (same math as reference quantity.py:588-593). All public
    views are reshaped through the structural QType.
    """

    def __init__(self, quantity_type, l_means, l_vars, n_samples, n_rm_samples):
        self.qtype = quantity_type
        self._l_means = np.asarray(l_means)
        self._l_vars = np.asarray(l_vars)
        self._n_samples = np.asarray(n_samples)
        self._n_rm_samples = np.asarray(n_rm_samples)

    @functools.cached_property
    def _telescoped(self):
        """(combined mean, combined estimator variance), flat M axis."""
        return (self._l_means.sum(axis=0),
                (self._l_vars / self._n_samples[:, None]).sum(axis=0))

    @property
    def mean(self):
        return self.qtype.reshape(self._telescoped[0])

    @property
    def var(self):
        return self.qtype.reshape(self._telescoped[1])

    @property
    def l_means(self):
        return np.array([self.qtype.reshape(m) for m in self._l_means])

    @property
    def l_vars(self):
        return np.array([self.qtype.reshape(v) for v in self._l_vars])

    @property
    def n_samples(self):
        return self._n_samples

    @property
    def n_rm_samples(self):
        return self._n_rm_samples

    def __getitem__(self, key):
        """Structural indexing distributes over the per-level statistics."""
        new_qtype, start = self.qtype.get_key(key)
        if not isinstance(self.qtype, qt.ArrayType):
            key = slice(start, start + new_qtype.size())
        n_levels = self._l_means.shape[0]
        return QuantityMean(
            quantity_type=new_qtype,
            l_means=self.l_means[:, key].reshape((n_levels, -1)),
            l_vars=self.l_vars[:, key].reshape((n_levels, -1)),
            n_samples=self._n_samples,
            n_rm_samples=self._n_rm_samples,
        )


class QuantityStorage(Quantity):
    """DAG leaf reading level chunks straight from a SampleStorage
    (reference quantity.py:654-695); the root of every user DAG built by
    ``make_root_quantity``."""

    def __init__(self, storage, qtype):
        self._storage = storage
        self.qtype = qtype
        self._uid = next(_UID_COUNTER)
        self._input_quantities = []
        self._operation = None
        self._traceable = True
        self._selection_id = None

    def level_ids(self):
        """Level ids holding collected results in the backing storage."""
        return self._storage.get_level_ids()

    def selection_id(self):
        return self._uid

    def get_quantity_storage(self):
        return self

    def traceable(self):
        return True

    def chunks(self, level_id=None):
        """Iterate the storage's ChunkSpecs (one level or all levels)."""
        return self._storage.chunks(level_id)

    def samples(self, chunk_spec):
        return self._storage.sample_pairs_level(chunk_spec)  # [M, chunk size, 2]

    def n_collected(self):
        """Per-level collected sample counts from the backing storage."""
        return self._storage.get_n_collected()

    def payload_resident(self):
        """True when the backend holds payloads in RAM/HBM (gathering whole
        levels is cheap — enables the single-dispatch estimation tier)."""
        return getattr(self._storage, "payload_resident", False)
