"""Stochastic reaction networks: coupled tau-leaping MLMC + exact SSA
— the second canonical application domain of multilevel Monte Carlo
(Anderson & Higham, "Multilevel Monte Carlo for continuous time Markov
chains, with applications in biochemical kinetics", SIAM MMS 10(1),
2012). Beyond-reference capability: GeoMop/MLMC has no continuous-time
Markov-chain / chemical-kinetics family at all; this module adds it
under the standard Simulation contract (reference
mlmc/sim/simulation.py:7-33), so every estimator, storage, pool and
density tier applies unchanged.

The model is a CTMC on integer species counts ``x in Z^S``: reaction
channel ``k`` fires at propensity ``a_k(x)`` and shifts the state by
the stoichiometric vector ``nu_k``. Two integrators:

* :func:`tau_leap` — explicit tau-leaping: per step each channel fires
  ``Poisson(a_k(x) tau)`` times (weak order 1 in ``tau``). For LINEAR
  propensities the tau-leap mean/variance satisfy EXACT Euler-type
  recursions (pinned in tests — sharper than a CLT band).
* :func:`ssa_exact` — Gillespie's direct method, batched: one
  ``lax.scan`` over a static event budget with per-lane done masking;
  lanes that exhaust the budget before ``T`` are reported as failures
  (loud, never silently truncated). Unbiased — the validation anchor
  for nonlinear networks without closed forms.

Device-first MLMC coupling (:func:`coupled_tau_leap`, the Anderson-Higham
split): level ``l`` uses ``tau_l``; over each coarse step the coarse
propensities ``a_c`` are FROZEN at the step-start state while the fine
path re-evaluates ``a_f`` every substep; per substep and channel the
common firing intensity ``b = min(a_f, a_c)`` drives a SHARED Poisson
count and two independent remainder counts ``Poisson((a_f - b) tau_f)``
/ ``Poisson((a_c - b) tau_f)``. Poisson additivity makes BOTH marginals
exact tau-leap laws (the coarse substep counts sum to
``Poisson(a_c tau_c)``), so the telescope is exactly consistent, while
the shared common count couples the paths: ``Var[f(X_f) - f(X_c)] =
O(tau)`` (AH Thm. 3.3 regime; measured in tests/bench). Everything is
one ``lax.scan`` over coarse steps with the (small, static) refine
factor unrolled — no per-event host work, no dynamic shapes.

Counts are carried as floats (integer-valued; f32 is exact below 2^24).
Propensities are clamped at 0 before sampling, the standard guard for
the transient negative excursions explicit tau-leaping allows.

No reference analogue; literature: Gillespie (J. Phys. Chem. 81, 1977),
Gillespie (J. Chem. Phys. 115, 2001) for tau-leaping, Anderson & Higham
(SIAM MMS 2012) for the coupled-level construction.
"""
import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from mlmc_tpu.sim.simulation import Simulation
from mlmc_tpu.quantity.quantity_spec import QuantitySpec
from mlmc_tpu.level_simulation import LevelSimulation

__all__ = ["ReactionNetwork", "mass_action", "immigration_death",
           "dimerization", "schlogl", "tau_leap", "coupled_tau_leap",
           "ssa_exact", "ReactionSimulation",
           "immigration_death_moments"]


@dataclasses.dataclass(frozen=True)
class ReactionNetwork:
    """CTMC reaction system.

    :param stoich: ``[n_reactions, n_species]`` integer state changes
        (row ``k`` is ``nu_k``).
    :param propensity: pure jnp callable ``x [..., n_species] ->
        a [..., n_reactions]`` (nonnegative on the lattice; clamped at
        0 by the integrators).
    :param x0: ``[n_species]`` initial counts.
    :param species: optional names (defaults ``X0..``).
    """
    stoich: tuple
    propensity: Callable
    x0: tuple
    species: Optional[tuple] = None

    @property
    def n_species(self):
        return len(self.x0)

    @property
    def n_reactions(self):
        return len(self.stoich)

    @property
    def species_names(self):
        if self.species is not None:
            return list(self.species)
        return ["X%d" % i for i in range(self.n_species)]


def mass_action(rate_constants, reactants):
    """Stochastic mass-action propensities from reactant orders.

    ``a_k(x) = c_k * prod_i ff(x_i, r_ki)`` with ``ff(x, 0) = 1``,
    ``ff(x, 1) = x``, ``ff(x, 2) = x (x - 1) / 2`` (the number of
    distinct reactant combinations). Orders above 2 are rejected —
    true elementary reactions are at most bimolecular.

    :param rate_constants: ``[n_reactions]`` stochastic rate constants.
    :param reactants: ``[n_reactions, n_species]`` integer orders.
    :return: pure jnp propensity callable.
    """
    c = np.asarray(rate_constants, np.float64)
    r = np.asarray(reactants, np.int64)
    if r.max(initial=0) > 2:
        raise ValueError("mass_action supports reactant orders <= 2")
    if c.shape[0] != r.shape[0]:
        raise ValueError("one rate constant per reaction required")

    def propensity(x):
        xs = x[..., None, :]                      # [..., 1, S]
        ro = jnp.asarray(r)                       # [R, S]
        cs = jnp.asarray(c, x.dtype)
        term = jnp.where(ro == 0, 1.0,
                         jnp.where(ro == 1, xs,
                                   0.5 * xs * (xs - 1.0)))
        return cs * jnp.prod(term, axis=-1)       # [..., R]

    return propensity


def immigration_death(birth=10.0, death=1.0, x0=0):
    """Immigration-death process ``0 -> X`` (rate ``birth``),
    ``X -> 0`` (rate ``death * x``) — the linear validation network:
    the exact law at time t is ``Binomial(x0, e^{-death t}) +
    Poisson((birth/death)(1 - e^{-death t}))`` (closed-form mean AND
    variance, :func:`immigration_death_moments`), and for linear
    propensities the tau-leap mean/variance obey exact recursions."""
    return ReactionNetwork(
        stoich=((1,), (-1,)),
        propensity=mass_action([birth, death], [[0], [1]]),
        x0=(float(x0),), species=("X",))


def immigration_death_moments(birth, death, x0, t):
    """Exact (mean, var) of the immigration-death count at time t."""
    p = math.exp(-death * t)
    mean = birth / death * (1.0 - p) + x0 * p
    var = birth / death * (1.0 - p) + x0 * p * (1.0 - p)
    return mean, var


def dimerization(c_bind=0.005, c_unbind=0.5, a0=400, b0=0):
    """Reversible dimerization ``2A -> B`` / ``B -> 2A`` — the standard
    nonlinear (quadratic-propensity) test network; no closed form, so
    it cross-validates tau-leap MLMC against :func:`ssa_exact`."""
    return ReactionNetwork(
        stoich=((-2, 1), (2, -1)),
        propensity=mass_action([c_bind, c_unbind], [[2, 0], [0, 1]]),
        x0=(float(a0), float(b0)), species=("A", "B"))


def schlogl(c1=3e-7, c2=1e-4, c3=1e-3, c4=3.5, x0=250):
    """Schlögl bistable network (cubic effective drift) with the two
    buffered species folded into the rate constants — the classic
    hard case for moment-closure methods; MLMC needs no closure.
    Reactions: ``2X -> 3X`` (a = c1' x(x-1)), ``3X -> 2X``
    (a = c2' x(x-1)(x-2)), ``0 -> X`` (c3'), ``X -> 0`` (c4 x) with
    the standard parameter set (Gillespie 2001) scaled so both modes
    are reachable."""
    n1, n2 = 1e5, 2e5

    def propensity(x):
        v = x[..., 0]
        return jnp.stack([
            c1 * n1 * v * (v - 1.0) / 2.0,
            c2 * v * (v - 1.0) * (v - 2.0) / 6.0,
            jnp.full_like(v, c3 * n2),
            c4 * v], axis=-1)

    return ReactionNetwork(stoich=((1,), (-1,), (1,), (-1,)),
                           propensity=propensity, x0=(float(x0),),
                           species=("X",))


# ---------------------------------------------------------------------- #
# integrators
# ---------------------------------------------------------------------- #
def _clamped(network, x):
    return jnp.maximum(network.propensity(x), 0.0)


def coupled_tau_leap(config, keys):
    """Integrate a coupled (fine, coarse) tau-leap level batch.

    :param config: dict with ``network`` (:class:`ReactionNetwork`),
        ``total_time``, ``n_fine``, ``n_coarse`` (0 on level 0);
        optional ``dtype``.
    :param keys: [B] PRNG keys — all Poisson counts derive
        counter-style inside the scan.
    :return: ``(x_fine [B, S], x_coarse [B, S] | None)`` terminal
        counts.
    """
    network = config["network"]
    if not isinstance(network, ReactionNetwork):
        raise ValueError("network must be a ReactionNetwork")
    T = float(config["total_time"])
    n_f = int(config["n_fine"])
    n_c = int(config["n_coarse"])
    is_l0 = n_c == 0
    m = 1 if is_l0 else n_f // n_c
    if not is_l0 and n_f != m * n_c:
        raise ValueError("n_fine=%d must be a multiple of n_coarse=%d"
                         % (n_f, n_c))
    trips = n_f if is_l0 else n_c
    tau_f = T / n_f
    dtype = jnp.dtype(config["dtype"]) if "dtype" in config \
        else jnp.result_type(float)
    B = keys.shape[0]
    S = network.n_species
    R = network.n_reactions
    nu = jnp.asarray(np.asarray(network.stoich, np.float64), dtype)
    x0 = jnp.broadcast_to(jnp.asarray(network.x0, dtype), (B, S))

    def poi(key, lam):
        """[B, R] independent Poisson counts, one key per lane."""
        return jax.vmap(lambda k, la: jax.random.poisson(
            k, la, (R,)).astype(dtype))(key, lam)

    def body(carry, c):
        xf, xc = carry
        a_c = _clamped(network, xc) if not is_l0 else None
        for j in range(m):
            kk = jax.vmap(lambda k: jax.random.fold_in(k, c * m + j))(
                keys)
            a_f = _clamped(network, xf)
            if is_l0:
                n_fire = poi(kk, a_f * tau_f)
                xf = xf + n_fire @ nu
            else:
                k1, k2, k3 = [jax.vmap(
                    lambda k, s=s: jax.random.fold_in(k, s))(kk)
                    for s in range(3)]
                b = jnp.minimum(a_f, a_c)
                n_com = poi(k1, b * tau_f)
                n_fx = poi(k2, (a_f - b) * tau_f)
                n_cx = poi(k3, (a_c - b) * tau_f)
                xf = xf + (n_com + n_fx) @ nu
                xc = xc + (n_com + n_cx) @ nu
        return (xf, xc), None

    (xf, xc), _ = jax.lax.scan(body, (x0, x0), jnp.arange(trips))
    return xf, (None if is_l0 else xc)


def tau_leap(network, total_time, n_steps, keys, dtype=None):
    """Plain (single-level) explicit tau-leaping: terminal counts
    ``[B, S]`` after ``n_steps`` steps of ``tau = total_time /
    n_steps``."""
    cfg = dict(network=network, total_time=float(total_time),
               n_fine=int(n_steps), n_coarse=0)
    if dtype is not None:
        cfg["dtype"] = dtype
    xf, _ = coupled_tau_leap(cfg, keys)
    return xf


def ssa_exact(network, total_time, keys, max_steps, dtype=None):
    """Batched exact SSA (Gillespie direct method).

    One ``lax.scan`` over a STATIC budget of ``max_steps`` candidate
    events; each lane stops (done-masked) once its next event would
    pass ``total_time`` or the state absorbs (zero total propensity).
    Lanes still live after the budget are flagged — the caller must
    treat them as failed samples, never as data.

    :return: ``(x_T [B, S], overran [B] bool)``.
    """
    if not isinstance(network, ReactionNetwork):
        raise ValueError("network must be a ReactionNetwork")
    T = float(total_time)
    dtype = jnp.dtype(dtype) if dtype is not None \
        else jnp.result_type(float)
    B = keys.shape[0]
    S = network.n_species
    nu = jnp.asarray(np.asarray(network.stoich, np.float64), dtype)
    x0 = jnp.broadcast_to(jnp.asarray(network.x0, dtype), (B, S))

    def one_step(x, t, done, key, i):
        kk = jax.random.fold_in(key, i)
        ke, kc = jax.random.split(kk)
        a = _clamped(network, x)                  # [R]
        a0 = jnp.sum(a)
        tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
        dt = jax.random.exponential(ke, dtype=dtype) \
            / jnp.maximum(a0, tiny)
        # absorbed states (a0 == 0) jump past T and finish
        t_new = jnp.where(a0 > 0, t + dt, jnp.asarray(2.0 * T + 1.0,
                                                      dtype))
        r = jax.random.categorical(kc, jnp.log(jnp.maximum(a, tiny)))
        fire = (t_new <= T) & ~done
        x = jnp.where(fire, x + nu[r], x)
        t = jnp.where(fire, t_new, t)
        done = done | ~fire
        return x, t, done

    def body(carry, i):
        x, t, done = carry
        x, t, done = jax.vmap(one_step, in_axes=(0, 0, 0, 0, None))(
            x, t, done, keys, i)
        return (x, t, done), None

    init = (x0, jnp.zeros((B,), dtype), jnp.zeros((B,), bool))
    (x, _, done), _ = jax.lax.scan(body, init,
                                   jnp.arange(int(max_steps)))
    return x, ~done


# ---------------------------------------------------------------------- #
# Simulation adapter
# ---------------------------------------------------------------------- #
class ReactionSimulation(Simulation):
    """Tau-leap MLMC over a reaction network under the standard
    Simulation contract: level parameters are leap sizes ``[tau]``,
    ``n_l = round(T / tau_l)``, the coupling is the Anderson-Higham
    split, and the stored QoI is the terminal species-count vector (or
    a ``qoi`` callable over it).

    Config keys: ``network`` (:class:`ReactionNetwork`, default
    :func:`dimerization`), ``total_time`` (default 1.0), ``qoi``
    (callable ``x [B, S] -> [B] or [B, M]``; default identity —
    every species count is stored).
    """

    def __init__(self, config=None):
        super().__init__()
        config = dict(config or {})
        config.setdefault("network", dimerization())
        if not isinstance(config["network"], ReactionNetwork):
            raise ValueError("network must be a ReactionNetwork")
        config.setdefault("total_time", 1.0)
        config.setdefault("qoi", None)
        self.config = config
        self.need_workspace = False

    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]
                       ) -> LevelSimulation:
        T = float(self.config["total_time"])
        n_f = int(round(T / float(fine_level_params[0])))
        tau_c = float(coarse_level_params[0])
        n_c = 0 if tau_c == 0 else int(round(T / tau_c))
        if n_f < 1 or (n_c and (n_f % n_c or n_f <= n_c)):
            raise ValueError(
                "fine leap must refine the coarse leap by an integer "
                "factor > 1 (got n_fine=%d, n_coarse=%d)" % (n_f, n_c))
        config = dict(self.config, n_fine=n_f, n_coarse=n_c,
                      res_format=self.result_format())
        return LevelSimulation(config_dict=config,
                               task_size=T / float(fine_level_params[0]),
                               nan_result_is_failure=False)

    @staticmethod
    def _assemble(config, x):
        qoi = config.get("qoi")
        if qoi is None:
            return x
        v = qoi(x)
        return v[:, None] if v.ndim == 1 else v

    @staticmethod
    def calculate_batch(config, keys, attempts=None):
        xf, xc = coupled_tau_leap(config, keys)
        fine = ReactionSimulation._assemble(config, xf)
        coarse = jnp.zeros_like(fine) if xc is None \
            else ReactionSimulation._assemble(config, xc)
        return fine, coarse, jnp.zeros(fine.shape[0], dtype=bool)

    @staticmethod
    def calculate(config, seed):
        key = jax.random.key(np.uint32(seed))
        fine, coarse, _ = ReactionSimulation.calculate_batch(
            config, key[None])
        return np.asarray(fine[0]), np.asarray(coarse[0])

    def result_format(self) -> List[QuantitySpec]:
        T = self.config["total_time"]
        if self.config.get("qoi") is None:
            names = self.config["network"].species_names
        else:
            names = ["qoi"]
        return [QuantitySpec(name=n, unit="count", shape=(1,),
                             times=[T], locations=["-"])
                for n in names]
