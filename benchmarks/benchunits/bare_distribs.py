"""Bare-distribution benchmark unit (reference: benchunits/bare_distribs.jl).

The reference's exact sweep: for each of 17 distribution configs, build the
model ``y = x * v; y ~ D`` (scalar parameter broadcast over a length-1000
vector), and time loglik eval, loglik+gradient, and 100 RWM steps
(bare_distribs.jl:22-47) — one benchlog row per (distribution, op).
Initial value = the distribution's mean (1.0 where undefined, e.g. Cauchy),
matching bench(ex) in the reference.
"""
import time

import numpy as np

VECTOR_SIZE = 1000


def _timeit(f, inner=20, repeats=5):
    import jax

    f()
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(inner):
            r = f()
        # a reduced fetch stops the clock.  Some timed fns return host
        # objects (MCMCChain) whose arrays are already materialized —
        # only device arrays need the fetch.
        import jax.numpy as jnp
        for leaf in jax.tree_util.tree_leaves(r):
            if hasattr(leaf, "dtype"):
                float(jnp.sum(leaf))
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


def _cases(mc):
    # the reference's 17 configs (bare_distribs.jl:30-47); init = mean of
    # the distribution where finite, else 1.0
    return [
        ("Normal(1,1)", lambda: mc.Normal(1.0, 1.0), 1.0),
        ("Normal(3,12)", lambda: mc.Normal(3.0, 12.0), 3.0),
        ("Weibull(1,1)", lambda: mc.Weibull(1.0, 1.0), 1.0),
        ("Weibull(3,1)", lambda: mc.Weibull(3.0, 1.0), 0.8930),
        ("Uniform(0,2)", lambda: mc.Uniform(0.0, 2.0), 1.0),
        ("TDist(2.2)", lambda: mc.TDist(2.2), 1.0),  # mean 0 is in-support
        ("TDist(4)", lambda: mc.TDist(4.0), 1.0),
        ("Beta(1,2)", lambda: mc.Beta(1.0, 2.0), 1.0 / 3.0),
        ("Beta(3,2)", lambda: mc.Beta(3.0, 2.0), 0.6),
        ("Gamma(1,2)", lambda: mc.Gamma(1.0, 2.0), 2.0),
        ("Gamma(3,0.2)", lambda: mc.Gamma(3.0, 0.2), 0.6),
        ("Cauchy(0,1)", lambda: mc.Cauchy(0.0, 1.0), 1.0),  # no mean -> 1.0
        ("Cauchy(-1,0.2)", lambda: mc.Cauchy(-1.0, 0.2), 1.0),
        ("Exponential(3)", lambda: mc.Exponential(3.0), 3.0),
        ("Exponential(0.2)", lambda: mc.Exponential(0.2), 0.2),
        ("LogNormal(-1,1)", lambda: mc.LogNormal(-1.0, 1.0),
         float(np.exp(-1 + 0.5))),
        ("LogNormal(2,0.1)", lambda: mc.LogNormal(2.0, 0.1),
         float(np.exp(2 + 0.005))),
    ]


def run():
    import jax.numpy as jnp

    import mcmc_jl as mc

    v = np.ones(VECTOR_SIZE)
    out = []
    for name, mk, x0 in _cases(mc):
        def ex(x, _mk=mk):
            y = x * jnp.asarray(v)
            mc.tilde(y, _mk())

        m = mc.model(ex, gradient=True, x=float(x0), check_init=False)
        label = f"{name} on vector of {VECTOR_SIZE}"
        t = _timeit(lambda m=m: m.eval(m.init))
        out.append((f"{label}: loglik eval", t * 1e3, "ms"))
        t = _timeit(lambda m=m: m.evalallg(m.init))
        out.append((f"{label}: loglik+grad", t * 1e3, "ms"))
        t = _timeit(
            lambda m=m: mc.run(m * mc.RWM(0.1) * mc.SerialMC(steps=100)),
            inner=1, repeats=3)
        out.append((f"{label}: 100 RWM steps", t * 1e3, "ms"))
    return out
