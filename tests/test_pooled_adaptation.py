"""Cross-chain pooled adaptation (SURVEY §2.4: pooled step-size stats via
collectives — the capability the reference's share-nothing prun lacks)."""
import jax
import jax.numpy as jnp
import numpy as np

import mcmc_jl as mc
from mcmc_jl.parallel import default_mesh, run_chains


def test_pooled_step_sizes_are_shared():
    m = mc.model(lambda v: -jnp.dot(v, v), grad=lambda v: -2 * v,
                 init=jnp.ones(3))
    runner = mc.SerialMC(steps=600, burnin=500)
    sampler = mc.MALA(2.0, mc.EmpMCTuner(0.574, adapt_step=50))

    infos, states, _ = run_chains(m, sampler, runner, n_chains=8, seed=0,
                                  jitter=0.3, pool_adaptation=True,
                                  mesh=default_mesh())
    step_sizes = np.asarray(states.tune.step_size)
    # pooled: every chain carries the same adapted step size
    assert np.allclose(step_sizes, step_sizes[0])
    # and adaptation actually moved it off the initial value
    assert not np.allclose(step_sizes[0], 2.0)
    lp = np.asarray(infos["plogtarget"])
    assert np.all(np.isfinite(lp))


def test_unpooled_step_sizes_diverge():
    m = mc.model(lambda v: -jnp.dot(v, v), grad=lambda v: -2 * v,
                 init=jnp.ones(3))
    runner = mc.SerialMC(steps=600, burnin=500)
    sampler = mc.MALA(2.0, mc.EmpMCTuner(0.574, adapt_step=50))
    infos, states, _ = run_chains(m, sampler, runner, n_chains=8, seed=0,
                                  jitter=0.3, pool_adaptation=False)
    step_sizes = np.asarray(states.tune.step_size)
    assert not np.allclose(step_sizes, step_sizes[0])


def test_pooled_hmcda():
    m = mc.model(lambda v: -jnp.dot(v, v), grad=lambda v: -2 * v,
                 init=jnp.ones(3))
    runner = mc.SerialMC(steps=300, burnin=250)
    infos, states, _ = run_chains(m, mc.HMCDA(), runner, n_chains=4, seed=0,
                                  jitter=0.3, pool_adaptation=True)
    eps = np.asarray(states.leap_step)
    assert np.allclose(eps, eps[0])
    assert np.all(np.isfinite(np.asarray(infos["plogtarget"])))
