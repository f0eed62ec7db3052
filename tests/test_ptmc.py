"""Batched replica-exchange tempering (runners/ptmc.py) — the batched
ladder SURVEY §2.4 prescribes for SerialTempMC's workload."""
import jax.numpy as jnp
import numpy as np

import mcmc_jl as mc


def _bimodal(st=0.35):
    return mc.model(
        lambda v: jnp.sum(jnp.logaddexp(
            mc.Normal(-4.0, st).logpdf(v), mc.Normal(4.0, st).logpdf(v)
        )), grad=None, init=jnp.asarray([4.0]),
        gradient=True, check_init=True,
    )


def test_ptmc_crosses_modes_and_swaps():
    m = _bimodal()
    runner = mc.PTMC(steps=8000, burnin=1000, swap_period=5,
                     betas=(0.02, 0.08, 0.25, 0.6, 1.0))
    chain = mc.run(m * mc.RWM(0.5) * runner, seed=0)
    x = chain.samples.values[:, 0]
    frac_left = np.mean(x < 0)
    assert 0.2 < frac_left < 0.8, frac_left
    # swaps actually happen
    assert chain.diagnostics["nswaps"].sum() > 50
    # cold-rung marginal sd ~ sqrt(0.35^2 + 16) ~ 4.02 for the mode mixture
    assert 3.0 < x.std() < 5.0


def test_ptmc_gaussian_moments_with_hmc():
    m = mc.model(lambda v: -0.5 * jnp.dot(v, v), grad=lambda v: -v,
                 init=jnp.ones(3))
    runner = mc.PTMC(steps=4000, burnin=1000, swap_period=10,
                     betas=(0.3, 1.0))
    chain = mc.run(m * mc.HMC(5, 0.5) * runner, seed=1)
    x = chain.samples.values
    assert np.all(np.abs(x.mean(0)) < 0.15)
    np.testing.assert_allclose(x.std(0, ddof=1), 1.0, rtol=0.15)
    assert mc.acceptance(chain) > 50


def test_ptmc_validates_ladder():
    import pytest

    with pytest.raises(AssertionError):
        mc.PTMC(betas=(1.0, 0.5))
    with pytest.raises(AssertionError):
        mc.PTMC(betas=(0.2, 0.7))


def test_poisson_link_kernel():
    """Poisson-link GLM kernel lp/gradient match autodiff of the model's own
    log-density (kernel in the Pallas interpreter, f32)."""
    import jax
    from mcmc_jl.ops.pallas_glm import (
        glm_trajectory, pad_chains, pad_design, padded_dim,
    )

    rng = np.random.default_rng(2)
    n, d = 40, 4
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1)) * 0.3])
    Y = rng.poisson(2.0, n).astype(np.float64)
    with jax.enable_x64(False):
        model = mc.model(glm=("poisson", X, Y))
        theta = jnp.asarray(rng.standard_normal(d) * 0.1, jnp.float32)
        lp, g_auto = jax.value_and_grad(model.eval)(theta)
        XT, Y2, W, O = pad_design(X, Y)
        D = padded_dim(d)
        z = pad_chains(jnp.zeros((1, d), jnp.float32), D)
        th1, m1, g1, lp1 = glm_trajectory(
            XT, Y2, W, O, pad_chains(theta[None], D), z, z, n_obs=n,
            n_leaps=1, eps=0.0, kind="poisson", interpret=True)
    np.testing.assert_allclose(float(lp1[0]), float(lp), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(g1[0, :d]), np.asarray(g_auto),
                               rtol=2e-4, atol=2e-4)


def test_nuts_divergence_diagnostic():
    """A pathological step size must report diverging transitions."""
    m = mc.model(lambda v: -0.5 * jnp.dot(v, v) * 1e6, grad=lambda v: -1e6 * v,
                 init=jnp.zeros(2) + 0.01)
    chain = mc.run(m * mc.NUTS(4) * mc.SerialMC(steps=200), seed=0)
    assert "diverging" in chain.diagnostics
    # on a well-conditioned target, almost no divergences
    m2 = mc.model(lambda v: -0.5 * jnp.dot(v, v), grad=lambda v: -v,
                  init=jnp.ones(2))
    c2 = mc.run(m2 * mc.NUTS() * mc.SerialMC(steps=400), seed=0)
    assert np.mean(c2.diagnostics["diverging"]) < 0.05


def test_ptmc_walkers_batch():
    """walkers=W runs W independent ladders as one (W, K) vmapped batch
    (ROADMAP item 5: fully vectorized ladder tempering), optionally sharded
    over a mesh 'chains' axis."""
    import jax
    from jax.sharding import Mesh

    m = _bimodal()
    runner = mc.PTMC(steps=5000, burnin=500, swap_period=5,
                     betas=(0.02, 0.08, 0.25, 0.6, 1.0), walkers=4)
    mesh = Mesh(np.array(jax.devices()[:4]), ("chains",))
    chains = mc.run(m, mc.RWM(0.5), runner, seed=0, mesh=mesh)
    assert isinstance(chains, list) and len(chains) == 4
    # each walker's cold rung crosses both modes
    for c in chains:
        x = c.samples.values[:, 0]
        assert (x < -1).mean() > 0.03 and (x > 1).mean() > 0.03
    # pooled over walkers the mode masses balance
    xs = np.stack([c.samples.values[:, 0] for c in chains])
    assert 0.25 < (xs < 0).mean() < 0.75
    # walkers are independent (different draws)
    assert not np.allclose(chains[0].samples.values, chains[1].samples.values)


def test_ptmc_resume_exact():
    """resume(chain) continues the ladder from its exact final state: the
    resumed cold rung keeps mixing across modes, and a resume of a
    prior-tempered run still carries replica_ll for evidence updates."""
    m = _bimodal()
    runner = mc.PTMC(steps=3000, burnin=500, swap_period=5,
                     betas=(0.02, 0.1, 0.4, 1.0))
    chain = mc.run(m * mc.RWM(0.5) * runner, seed=0)
    more = mc.resume(chain, steps=2000)
    x = np.concatenate([chain.samples.values[:, 0], more.samples.values[:, 0]])
    assert more.samples.values.shape[0] == 2000
    assert 0.2 < np.mean(x < 0) < 0.8
    assert more.diagnostics["nswaps"].sum() > 10
    # resumed chain continues the SAME trajectory (first resumed state is a
    # valid continuation: finite, within the target's support)
    assert np.all(np.isfinite(more.samples.values))
