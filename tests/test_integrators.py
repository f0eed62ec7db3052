"""Higher-order symplectic integrators (samplers/integrators.py).

Beyond-reference (the reference integrates with leapfrog only,
HMC.jl:93-102): BCSS minimum-error two/three-stage schemes must be
(a) exactly time-reversible, (b) far more energy-accurate than leapfrog at
matched gradient budget, and (c) statistically exact under the unchanged
Metropolis test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mcmc_jl as mc
from mcmc_jl.samplers.integrators import (
    INTEGRATORS, get_integrator, hamiltonian,
)

A = np.array([[1.0, 0.3, 0.0], [0.3, 2.0, 0.2], [0.0, 0.2, 0.5]])
MU = np.array([0.5, -0.3, 0.2])


def _model():
    Aj = jnp.asarray(A)
    mu = jnp.asarray(MU)
    return mc.model(lambda v: -0.5 * (v - mu) @ Aj @ (v - mu),
                    gradient=True, init=jnp.asarray(MU + 0.5),
                    check_init=False)


def _integrate(step_fn, model, pars, m, eps, n):
    lp, g = model.evalallg(pars)
    for _ in range(n):
        pars, lp, g, m = step_fn(model, pars, m, g, eps)
    return pars, lp, g, m


@pytest.mark.parametrize("name", sorted(INTEGRATORS))
def test_reversibility(name):
    """Momentum flip at the endpoint must retrace the trajectory exactly
    (up to fp roundoff) — the property the Metropolis test relies on."""
    step_fn, _ = get_integrator(name)
    m0 = jnp.asarray([0.3, -0.8, 0.5])
    x0 = jnp.asarray(MU + 0.4)
    model = _model()
    x1, _, _, m1 = _integrate(step_fn, model, x0, m0, 0.3, 7)
    xb, _, _, mb = _integrate(step_fn, model, x1, -m1, 0.3, 7)
    np.testing.assert_allclose(np.asarray(xb), np.asarray(x0), atol=1e-10)
    np.testing.assert_allclose(np.asarray(-mb), np.asarray(m0), atol=1e-10)


def test_energy_error_at_matched_gradient_budget():
    """k-stage scheme at step k*eps costs the same gradients as leapfrog at
    eps; its energy error must be much smaller (BCSS 2014 Table 1)."""
    model = _model()
    x0 = jnp.asarray(MU + 0.4)
    eps, n_grads = 0.25, 24
    keys = jax.random.split(jax.random.PRNGKey(7), 32)

    errs = {}
    for name, (step_fn, k) in INTEGRATORS.items():
        tot = 0.0
        for kk in keys:  # endpoint |dH| oscillates: average over momenta
            m0 = jax.random.normal(kk, (3,))
            H0 = float(hamiltonian(model.evalallg(x0)[0], m0))
            _, lp, _, m = _integrate(step_fn, model, x0, m0, k * eps,
                                     n_grads // k)
            tot += abs(float(hamiltonian(lp, m)) - H0)
        errs[name] = tot / len(keys)
    assert errs["2stage"] < 0.35 * errs["leapfrog"], errs
    assert errs["3stage"] < 0.35 * errs["leapfrog"], errs


@pytest.mark.parametrize("integ", ["2stage", "3stage"])
def test_hmc_moments_with_multistage(integ):
    """Unchanged Metropolis test => exact invariant distribution."""
    m = _model()
    _, k = get_integrator(integ)
    # same ~60 gradients/transition as HMC(10, 0.4)'s 10+... budget scaled
    chain = mc.run(m, mc.HMC(max(2, 10 // k), 0.4 * k, integrator=integ),
                   mc.SerialMC(steps=6000, burnin=1000), seed=1)
    x = chain.samples.values
    assert np.all(np.isfinite(x))
    mcse = np.sqrt(mc.var(chain))
    z = np.abs(x.mean(axis=0) - MU) / np.maximum(mcse, 1e-12)
    assert np.all(z < 5), z
    cov = np.linalg.inv(A)
    v = x.var(axis=0, ddof=1)
    assert np.all(np.abs(v / np.diag(cov) - 1.0) < 0.2), v


def test_acceptance_gain_at_large_step():
    """At a step size where leapfrog acceptance collapses, the three-stage
    scheme (step 3*eps: same gradient cost) should still accept."""
    m = _model()
    runner = mc.SerialMC(steps=3000, burnin=500)
    a_leap = mc.acceptance(mc.run(m, mc.HMC(12, 0.9), runner, seed=2))
    a_3 = mc.acceptance(
        mc.run(m, mc.HMC(4, 0.9, integrator="3stage"), runner, seed=2)
    )
    assert a_3 > a_leap + 10, (a_leap, a_3)


def test_hmcda_with_multistage():
    m = _model()
    chain = mc.run(m, mc.HMCDA(len=2.0, integrator="2stage"),
                   mc.SerialMC(steps=4000, burnin=1000), seed=3)
    x = chain.samples.values
    mcse = np.sqrt(mc.var(chain))
    z = np.abs(x.mean(axis=0) - MU) / np.maximum(mcse, 1e-12)
    assert np.all(z < 5), z


def test_unknown_integrator_rejected():
    with pytest.raises(ValueError, match="unknown integrator"):
        mc.HMC(10, 0.1, integrator="4stage")
