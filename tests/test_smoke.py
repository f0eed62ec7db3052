"""End-to-end smoke: README Example 1 of the reference (README.md:54-96)."""
import jax.numpy as jnp
import numpy as np
import pytest

import mcmc_jl as mc


def test_rwm_serialmc_basic():
    mymodel1 = mc.model(lambda v: -jnp.dot(v, v), init=jnp.ones(3))
    chain = mc.run(mymodel1 * mc.RWM(0.1) * mc.SerialMC(steps=1000, burnin=100))
    assert chain.samples.shape == (900, 3)
    assert chain.samples.columns == ["pars.1", "pars.2", "pars.3"]
    acc = mc.acceptance(chain)
    assert 0 < acc <= 100

    # thinning keeps every 5th of 101..1000
    chain = mc.run(mymodel1, mc.RWM(0.1), mc.SerialMC(steps=1000, burnin=100, thinning=5))
    assert chain.samples.shape == (180, 3)

    # range syntax
    chain = mc.run(mymodel1, mc.RWM(0.1), mc.SerialMC(range(101, 1001, 5)))
    assert chain.samples.shape == (180, 3)


def test_sampler_requires_gradient():
    m3 = mc.model(lambda v: -jnp.dot(v, v), init=jnp.ones(3))
    with pytest.raises(ValueError, match="gradient"):
        mc.run(m3 * mc.MALA(0.1) * mc.SerialMC(range(1, 1001)))


def test_model_arrays_and_resume():
    m = mc.model(lambda v: -jnp.dot(v, v), grad=lambda v: -2 * v, init=jnp.ones(3))
    chains = mc.run(m * [mc.RWM(0.1), mc.MALA(0.1), mc.HMC(3, 0.1)] * mc.SerialMC(steps=1000))
    assert len(chains) == 3
    assert chains[1].samples.shape == (1000, 3)

    chains = mc.run(m * [mc.HMC(i, 0.1) for i in range(1, 6)] * mc.SerialMC(steps=200))
    assert len(chains) == 5

    c = mc.run(m, mc.RWM(0.1), mc.SerialMC(range(101, 1001, 5)))
    c2 = mc.resume(c, steps=500)
    assert c2.samples.nrow > 0
    # resume continues the state exactly: first resumed sample differs from init
    assert not np.allclose(c2.samples.values[0], np.ones(3))


def test_out_of_support_init_raises():
    with pytest.raises(ValueError, match="support"):
        mc.model(lambda v: jnp.where(v.sum() > 0, -jnp.inf, 0.0), init=jnp.ones(2))


def test_chain_stat_methods():
    m = mc.model(lambda v: -jnp.dot(v, v), grad=lambda v: -2 * v, init=jnp.ones(2))
    c = mc.run(m * mc.HMC(5, 0.5) * mc.SerialMC(steps=600, burnin=100))
    np.testing.assert_allclose(c.mean(), mc.mean(c))
    np.testing.assert_allclose(c.ess(), mc.ess(c))
    np.testing.assert_allclose(c.var(), mc.var(c))
    assert c.acceptance() == mc.acceptance(c)
