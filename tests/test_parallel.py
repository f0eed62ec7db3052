"""Multi-device coverage on the 8-device virtual CPU mesh — the coverage the
reference lacks entirely (SURVEY §4: "prun is untested; no multi-node tests").

- sharded chain batches produce correct statistics
- same-seed equivalence between unsharded and mesh-sharded runs
- cross-chain diagnostics (R-hat style) across the mesh
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mcmc_jl as mc
from mcmc_jl.parallel import default_mesh, init_chains, run_chains


@pytest.fixture(scope="module")
def model():
    return mc.model(lambda v: -jnp.dot(v, v), grad=lambda v: -2 * v,
                    init=jnp.ones(3))


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_run_chains_batch(model):
    runner = mc.SerialMC(steps=1500, burnin=500)
    infos, states, _ = run_chains(model, mc.HMC(0.75), runner, n_chains=16,
                                  seed=0, jitter=0.5)
    x = np.asarray(infos["ppars"])  # (steps, chains, dim)
    assert x.shape == (1500, 16, 3)
    kept = x[500:]
    # pooled posterior: N(0, 1/2)
    assert abs(kept.mean()) < 0.05
    assert abs(kept.var() - 0.5) < 0.05


def test_sharded_equals_unsharded(model):
    """Same key => bitwise-identical chains with and without mesh sharding
    (the determinism test SURVEY §5 calls for)."""
    runner = mc.SerialMC(steps=300)
    mesh = default_mesh()
    infos_a, _, _ = run_chains(model, mc.MALA(0.5), runner, n_chains=8, seed=3)
    infos_b, _, _ = run_chains(model, mc.MALA(0.5), runner, n_chains=8, seed=3,
                               mesh=mesh)
    np.testing.assert_array_equal(np.asarray(infos_a["ppars"]),
                                  np.asarray(infos_b["ppars"]))


def test_states_actually_sharded(model):
    mesh = default_mesh()
    states = init_chains(model, mc.RWM(0.5), 8, jax.random.PRNGKey(0), mesh=mesh)
    sh = states.pars.sharding
    assert not sh.is_fully_replicated


def test_cross_chain_rhat(model):
    """Split-R-hat across sharded chains converges to ~1 on an easy target."""
    runner = mc.SerialMC(steps=2000, burnin=1000)
    infos, _, _ = run_chains(model, mc.HMC(0.75), runner, n_chains=8, seed=0,
                             jitter=1.0, mesh=default_mesh())
    x = np.asarray(infos["ppars"])[1000:]  # (steps, chains, dim)
    n, m_, d = x.shape
    chain_means = x.mean(0)
    W = x.var(0, ddof=1).mean(0)
    B = n * chain_means.var(0, ddof=1)
    rhat = np.sqrt(((n - 1) / n * W + B / n) / W)
    assert np.all(rhat < 1.05), rhat
