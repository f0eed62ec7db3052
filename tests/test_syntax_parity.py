"""Line-by-line port of the reference's API-surface test
(test/test_syntax.jl) — every public call path the reference exercises,
in the same order, with the same configurations (sizes trimmed where the
original is pure smoke).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import mcmc_jl as mc


@pytest.fixture(scope="module")
def dataset():
    # test_syntax.jl:8-13: srand(1); logistic dataset 1000 x 10
    rng = np.random.default_rng(1)
    n, nbeta = 1000, 10
    X = np.column_stack([np.ones(n), rng.standard_normal((n, nbeta - 1))])
    beta0 = rng.standard_normal(nbeta)
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(X @ beta0))).astype(np.float64)
    return jnp.asarray(X), jnp.asarray(Y), nbeta


@pytest.fixture(scope="module")
def m(dataset):
    # test_syntax.jl:16-23: the logistic model expr with gradient
    X, Y, nbeta = dataset

    def ex(vars):
        mc.tilde(vars, mc.Normal(0.0, 1.0))
        prob = 1.0 / (1.0 + jnp.exp(X @ vars))
        mc.tilde(Y, mc.Bernoulli(prob))

    return mc.model(ex, vars=np.zeros(nbeta), gradient=True)


def test_different_samplers(m):
    # test_syntax.jl:26-30
    res = mc.run(m * mc.RWM(0.05) * mc.SerialMC(range(100, 1001)))
    assert res.samples.nrow == 901
    res = mc.run(m * mc.HMC(2, 0.1) * mc.SerialMC(range(100, 1001)))
    res = mc.run(m * mc.NUTS() * mc.SerialMC(range(100, 1001)))
    res = mc.run(m * mc.MALA(0.001) * mc.SerialMC(range(100, 1001)))
    assert np.all(np.isfinite(res.samples.values))


def test_different_syntax(m):
    # test_syntax.jl:33-35
    res = mc.run(m, mc.RWM(), mc.SerialMC(steps=1000, thinning=10, burnin=0))
    assert res.samples.nrow == 100
    res = mc.run(m, mc.HMC(2, 0.1), mc.SerialMC(thinning=10, burnin=0))
    res = mc.run(m, mc.HMC(2, 0.1), mc.SerialMC(burnin=20))
    assert res.samples.nrow == 80


def test_readme_examples():
    # test_syntax.jl:41-82
    mymodel1 = mc.model(lambda v: -jnp.dot(v, v), init=jnp.ones(3))
    mymodel2 = mc.model(lambda v: -jnp.dot(v, v), grad=lambda v: -2 * v,
                        init=jnp.ones(3))

    def modelxpr(v):
        mc.tilde(v, mc.Normal(0.0, 1.0))

    mymodel3 = mc.model(modelxpr, v=np.ones(3))
    mymodel4 = mc.model(modelxpr, gradient=True, v=np.ones(3))

    mychain = mc.run(mymodel1, mc.RWM(0.1), mc.SerialMC(steps=1000, burnin=100))
    mychain = mc.run(mymodel1, mc.RWM(0.1),
                     mc.SerialMC(steps=1000, burnin=100, thinning=5))
    mychain = mc.run(mymodel1, mc.RWM(0.1), mc.SerialMC(range(101, 1001, 5)))
    mychain1 = mc.run(mymodel1 * mc.RWM(0.1) * mc.SerialMC(range(101, 1001, 5)))

    mychain2 = mc.run(mymodel2, mc.HMC(0.75), mc.SerialMC(steps=3000, burnin=500))

    mychain2.samples.head()
    mychain2.gradients.head()

    mc.acceptance(mychain2)
    import io

    mc.describe(mychain2, io=io.StringIO())
    mc.ess(mychain2)
    mc.actime(mychain2)
    mc.var(mychain2)
    mc.var(mychain2, vtype="iid")
    mc.var(mychain2, vtype="ipse")
    mc.var(mychain2, vtype="bm")

    mychain1 = mc.resume(mychain1, steps=1000)
    assert mychain1.samples.nrow > 0

    # model/sampler mismatch must raise (test_syntax.jl:75)
    with pytest.raises(ValueError):
        mc.run(mymodel3 * mc.MALA(0.1) * mc.SerialMC(range(1, 1001)))

    mc.run(mymodel4 * mc.MALA(0.1) * mc.SerialMC(range(1, 1001)))

    mychain = mc.run(mymodel2 * [mc.RWM(0.1), mc.MALA(0.1), mc.HMC(3, 0.1)]
                     * mc.SerialMC(steps=1000))
    mychain[1].samples  # MALA(0.1) chain

    mychain = mc.run(mymodel2 * [mc.HMC(i, 0.1) for i in range(1, 6)]
                     * mc.SerialMC(steps=1000))
    assert len(mychain) == 5


def test_seqmc_block():
    # test_syntax.jl:84-101 (README Example 2)
    nmod = 10
    sts = np.logspace(1, -1, nmod)
    mods = []
    for i in range(nmod):
        def ex(x, _st=float(sts[i])):
            y = jnp.abs(x)
            mc.tilde(y, mc.Normal(1.0, _st))

        mods.append(mc.model(ex, x=0.0))

    targets = [mods[i] * mc.RWM(float(sts[i])) * mc.SeqMC(steps=10, burnin=0)
               for i in range(nmod)]
    particles = [np.random.default_rng(i).standard_normal(1) for i in range(1000)]

    mychain3 = mc.run(targets, particles=np.asarray(particles))
    mychain4 = mc.wsample(mychain3.samples["x"], mychain3.diagnostics["weigths"],
                          1000)
    est = np.mean(mychain4)
    assert np.isfinite(est)
