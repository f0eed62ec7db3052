"""Data-sharded likelihood engine on the virtual mesh
(mcmc_jl/parallel/sharded.py — the ('chains','data') 2-D mesh path the
driver's dryrun_multichip exercises).

The gradient test is a regression guard for the shard_map AD pitfall: inside
shard_map, theta is per-device, so ``grad(psum(f))`` yields only the local
shard's contribution — the gradient itself must be psum'd."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import mcmc_jl as mc
from mcmc_jl.parallel.sharded import (
    make_mesh, run_chains_sharded, sharded_glm_model,
)


def _setup(n_obs=64, nbeta=4):
    rng = np.random.default_rng(0)
    X = np.column_stack([np.ones(n_obs), rng.standard_normal((n_obs, nbeta - 1))])
    beta = rng.standard_normal(nbeta) * 0.5
    Y = (rng.random(n_obs) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return jnp.asarray(X), jnp.asarray(Y), nbeta


def _loglik_shard(theta, X_blk, Y_blk):
    logits = X_blk @ theta
    return jnp.dot(Y_blk, logits) - jnp.sum(jnp.logaddexp(0.0, logits))


def _prior(theta):
    return -0.5 * jnp.dot(theta, theta)


def test_sharded_logp_and_grad_match_full_data():
    X, Y, nbeta = _setup()
    mesh = make_mesh(4, 2)
    mk = sharded_glm_model(_loglik_shard, _prior, nbeta, jnp.zeros(nbeta))
    theta = jnp.asarray(np.random.default_rng(3).standard_normal(nbeta))

    def body(X_blk, Y_blk):
        model = mk(X_blk, Y_blk)
        lp, g = model.evalallg(theta)
        return lp[None], g[None]

    f = jax.shard_map(body, mesh=mesh, in_specs=(P("data", None), P("data")),
                      out_specs=(P("chains"), P("chains", None)),
                      check_vma=False)
    lp_s, g_s = f(X, Y)

    def logp(t):
        return _loglik_shard(t, X, Y) + _prior(t)

    lp_t, g_t = jax.value_and_grad(logp)(theta)
    np.testing.assert_allclose(np.asarray(lp_s), float(lp_t), rtol=1e-12)
    for row in np.asarray(g_s):
        np.testing.assert_allclose(row, np.asarray(g_t), rtol=1e-10)


def test_sharded_posterior_matches_reference_chain():
    X, Y, nbeta = _setup()
    mesh = make_mesh(4, 2)
    mk = sharded_glm_model(_loglik_shard, _prior, nbeta, jnp.zeros(nbeta))

    final, infos = run_chains_sharded(mk, (X, Y), mc.HMC(5, 0.2),
                                      mc.SerialMC(steps=3000), mesh,
                                      n_chains=8, seed=0)
    x = np.asarray(infos["ppars"])[1000:]
    acc = np.mean(np.asarray(infos["accept"]))
    assert acc > 0.5

    def logp(t):
        return _loglik_shard(t, X, Y) + _prior(t)

    m = mc.model(logp, gradient=True, init=jnp.zeros(nbeta), check_init=False)
    c = mc.run(m * mc.HMC(10, 0.25) * mc.SerialMC(steps=12000, burnin=2000),
               seed=9)
    se = np.sqrt(mc.var(c))
    diff = np.abs(x.mean(axis=(0, 1)) - mc.mean(c))
    assert np.all(diff < 8 * se + 0.05), (diff, se)


def test_run_chains_sugar():
    m = mc.model(lambda v: -jnp.dot(v, v), grad=lambda v: -2 * v, init=jnp.ones(2))
    chains = mc.run(m * mc.HMC(5, 0.3) * mc.SerialMC(steps=500, burnin=100),
                    chains=4)
    assert len(chains) == 4
    assert all(c.samples.nrow == 400 for c in chains)
    assert not np.allclose(chains[0].samples.values, chains[1].samples.values)
