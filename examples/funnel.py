"""Neal's funnel (reference: test/test_ss.jl — its slice-sampler workload).

v ~ N(0, 3^2); x_i | v ~ N(0, e^v) for i = 1..9.  The classic
varying-curvature target: at the neck (v << 0) the conditional scale of x
is exp(v/2), so any fixed step size either diverges in the neck or crawls
in the mouth.  Three ways to sample it here:

- ``slice_sample`` — the reference's approach (step-out + shrink);
- ``NUTS`` — fixed-step; visibly biased away from the neck at this budget;
- ``WALNUTS`` — within-orbit adaptive micro steps resolve the neck
  (samplers/walnuts.py; arXiv:2506.18746-style).

Run: python examples/funnel.py
"""
import jax.numpy as jnp
import numpy as np

import mcmc_jl as mc

DIM_X = 9


def make_model(gradient=True):
    def logp(z):
        v, x = z[0], z[1:]
        return (-v * v / 18.0
                - 0.5 * jnp.sum(x * x) * jnp.exp(-v)
                - 0.5 * DIM_X * v)

    return mc.model(logp, gradient=gradient, init=jnp.zeros(DIM_X + 1),
                    check_init=False)


def main():
    m = make_model()
    runner = mc.SerialMC(steps=8000, burnin=2000)

    for name, sampler in [
        ("NUTS (fixed step)", mc.NUTS(maxdoublings=8)),
        ("WALNUTS", mc.WALNUTS(maxdoublings=8, max_halvings=5)),
    ]:
        chain = mc.run(m, sampler, runner, seed=0)
        v = chain.samples.values[:, 0]
        div = 100.0 * np.mean(np.asarray(chain.diagnostics["diverging"]))
        print(f"{name:18s} E[v]={v.mean():+.2f} (true 0)  "
              f"Var[v]={v.var():.1f} (true 9)  min v={v.min():+.1f}  "
              f"divergent {div:.1f}%")

    # the reference's sampler for this target (test_ss.jl)
    xs = mc.slice_sample(m.eval, jnp.zeros(DIM_X + 1), 8000, widths=5.0,
                         seed=0)
    v = np.asarray(xs)[2000:, 0]
    print(f"{'slice_sample':18s} E[v]={v.mean():+.2f} (true 0)  "
          f"Var[v]={v.var():.1f} (true 9)")


if __name__ == "__main__":
    main()
