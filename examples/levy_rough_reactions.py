"""Model-family tour: jumps, Lévy, rough volatility, reaction networks,
SPDEs and backward SDEs — the beyond-reference dynamics added on top of
the diffusion family, each validated against an exact anchor.

1. **Merton jump-diffusion** — shared-jump coupling; telescoped call vs
   the Poisson-mixture closed form.
2. **Variance gamma** — EXACT Lévy increments (no discretization error
   in the terminal law); call vs the COS characteristic-function price,
   Asian payoff telescoped over MONITORING frequency.
3. **rBergomi rough volatility** — exact joint-Gaussian grids by one
   matmul; the eta -> 0 limit is Black-Scholes exactly; Sobol'
   points through the joint-PCA map cut the variance further.
4. **Reaction network (dimerization CTMC)** — Anderson-Higham coupled
   tau-leaping cross-validated against batched exact Gillespie SSA.
5. **Stochastic heat SPDE** — telescoped energy vs the EXACT discrete
   Gaussian law of the scheme.
6. **BSDE** — the Black-Scholes measure-change driver recovers the
   r-discounted price from a deliberately wrong drift.

Run: python examples/levy_rough_reactions.py
"""
import numpy as np
import jax
import jax.numpy as jnp

RATE, T = 0.05, 1.0
DISC = float(np.exp(-RATE * T))


def merton_block():
    from mlmc_tpu.sim.jumps import (coupled_jump_functionals, merton,
                                    merton_call_price)
    from mlmc_tpu.sim.sde import european_call

    model = merton(RATE, 0.2, 0.8, -0.1, 0.15, 1.0)
    payoff = european_call(1.0, DISC)
    tot, var = 0.0, 0.0
    for lev, nf in enumerate((16, 32, 64, 128)):
        keys = jax.random.split(jax.random.key(lev), 1 << 14)
        pf_f, pf_c = jax.jit(lambda k, cfg=dict(
            model=model, total_time=T, n_fine=nf,
            n_coarse=0 if lev == 0 else nf // 2):
            coupled_jump_functionals(cfg, k))(keys)
        d = np.asarray(payoff(pf_f)) - (np.asarray(payoff(pf_c))
                                        if pf_c is not None else 0.0)
        tot += d.mean()
        var += d.var() / d.size
    ref = merton_call_price(1.0, 1.0, RATE, 0.2, 0.8, -0.1, 0.15, T)
    print(f"[merton]    call {tot:.5f}  closed form {ref:.5f}  "
          f"err {abs(tot - ref):.1e}  se {np.sqrt(var):.1e}")


def vg_block():
    from mlmc_tpu.sim.levy import (coupled_vg_functionals,
                                   variance_gamma, vg_call_price)

    model = variance_gamma(RATE, sigma=0.12, theta=-0.14, nu=0.2)
    keys = jax.random.split(jax.random.key(7), 1 << 15)
    pf, _ = jax.jit(lambda k: coupled_vg_functionals(
        dict(model=model, total_time=T, n_fine=4, n_coarse=0), k))(keys)
    v = DISC * np.maximum(np.asarray(pf.terminal) - 1.0, 0.0)
    ref = vg_call_price(1.0, 1.0, RATE, 0.12, -0.14, 0.2, T)
    print(f"[vg]        call {v.mean():.5f}  COS {ref:.5f}  "
          f"err {abs(v.mean() - ref):.1e}  (exact increments: "
          f"4 steps suffice)")


def rbergomi_block():
    from mlmc_tpu.ops import sobol
    from mlmc_tpu.sim.rough import (coupled_rbergomi_paths, rbergomi,
                                    rbergomi_qmc_level_fns)
    from mlmc_tpu.sim.sde import black_scholes_call

    m0 = rbergomi(xi0=0.04, eta=0.0, hurst=0.1, rho=-0.9)
    keys = jax.random.split(jax.random.key(9), 1 << 14)
    s, _ = jax.jit(lambda k: coupled_rbergomi_paths(
        dict(model=m0, total_time=T, n_fine=64, n_coarse=0), k))(keys)
    c0 = float(np.maximum(np.asarray(s) - 1.0, 0).mean())
    bs = black_scholes_call(1.0, 1.0, 0.0, 0.2, T)
    print(f"[rbergomi]  eta=0 call {c0:.5f}  Black-Scholes {bs:.5f}  "
          f"err {abs(c0 - bs):.1e} (exact — no bias term)")
    model = rbergomi(xi0=0.04, eta=1.0, hurst=0.1, rho=-0.7)
    payoff = lambda sv: jnp.maximum(sv - 1.0, 0.0)
    (qfn,), (d,) = rbergomi_qmc_level_fns(model, T, [(32, 0)], payoff)
    dv = sobol.direction_numbers(d)
    vals = [float(jnp.mean(qfn(sobol.sobol_uniforms(
        dv, 0, 1 << 11, sobol.scramble_seeds(jax.random.key(r), d)))[0]))
        for r in range(8)]
    sp, _ = jax.jit(lambda k: coupled_rbergomi_paths(
        dict(model=model, total_time=T, n_fine=32, n_coarse=0), k))(keys)
    vmc = np.asarray(payoff(sp)).var() / (1 << 11)
    print(f"[rbergomi]  QMC call {np.mean(vals):.5f} +/- "
          f"{np.std(vals, ddof=1) / np.sqrt(8):.1e}; variance "
          f"reduction vs MC at equal points: "
          f"{vmc / np.var(vals, ddof=1):.1f}x")


def reactions_block():
    from mlmc_tpu.sim.reactions import (coupled_tau_leap, dimerization,
                                        ssa_exact)

    net = dimerization()
    tot = 0.0
    for lev, nf in enumerate((4, 8, 16, 32, 64)):
        keys = jax.random.split(jax.random.key(20 + lev), 1 << 13)
        xf, xc = jax.jit(lambda k, cfg=dict(
            network=net, total_time=1.0, n_fine=nf,
            n_coarse=0 if lev == 0 else nf // 2):
            coupled_tau_leap(cfg, k))(keys)
        tot += float(np.asarray(xf[:, 0]).mean()
                     - (np.asarray(xc[:, 0]).mean()
                        if xc is not None else 0.0))
    x, over = jax.jit(lambda k: ssa_exact(net, 1.0, k, 512))(
        jax.random.split(jax.random.key(30), 1 << 12))
    assert not np.asarray(over).any()
    ref = float(np.asarray(x)[:, 0].mean())
    print(f"[reactions] tau-leap telescope E[A] {tot:.2f}  "
          f"exact SSA {ref:.2f}  (gap = remaining tau bias)")


def spde_block():
    from mlmc_tpu.sim.spde import (coupled_spde_paths,
                                   discrete_heat_l2_moment,
                                   stochastic_heat)

    tot = 0.0
    for lev, (Nf, nf, Nc, nc) in enumerate(
            [(8, 4, 0, 0), (16, 16, 8, 4), (32, 64, 16, 16)]):
        keys = jax.random.split(jax.random.key(40 + lev), 1 << 12)
        uf, uc = jax.jit(lambda k, cfg=dict(
            model=stochastic_heat(1.0, 1.0), total_time=0.5,
            n_cells_fine=Nf, n_steps_fine=nf, n_cells_coarse=Nc,
            n_steps_coarse=nc): coupled_spde_paths(cfg, k))(keys)
        e = lambda u: (np.asarray(u) ** 2).sum(axis=1) / u.shape[1]
        tot += float(e(uf).mean() - (e(uc).mean() if uc is not None
                                     else 0.0))
    ref = discrete_heat_l2_moment(1.0, 1.0, 0.5, 32, 64)
    print(f"[spde]      energy {tot:.5f}  exact discrete law {ref:.5f} "
          f"(pure CLT gap)")


def bsde_block():
    from mlmc_tpu.bsde import solve_bsde
    from mlmc_tpu.sim.sde import black_scholes_call, gbm

    mu, sig = 0.15, 0.2
    out = solve_bsde(gbm(mu, sig, 1.0),
                     lambda x: jnp.maximum(x - 1.0, 0.0),
                     lambda t, x, y, z: -RATE * y - (mu - RATE) / sig * z,
                     T, 50, n_paths=1 << 15, degree=5,
                     key=jax.random.key(3))
    bs = black_scholes_call(1.0, 1.0, RATE, sig, T)
    print(f"[bsde]      measure-change price {out['y0']:.5f}  "
          f"Black-Scholes {bs:.5f}  z {((out['y0'] - bs) / out['y0_se']):+.1f}")


def main():
    print("device:", jax.devices()[0].platform)
    merton_block()
    vg_block()
    rbergomi_block()
    reactions_block()
    spde_block()
    bsde_block()


if __name__ == "__main__":
    main()
