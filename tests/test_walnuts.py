"""WALNUTS — within-orbit adaptive leapfrog NUTS (samplers/walnuts.py).

Beyond-reference (arXiv:2506.18746-style).  Gates: exactness on a
correlated Gaussian, micro-step selection behavior, and the headline
capability — unbiased traversal of Neal's funnel where fixed-step NUTS
at the same budget is visibly biased.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mcmc_jl as mc

A = np.array([[1.0, 0.3, 0.0], [0.3, 2.0, 0.2], [0.0, 0.2, 0.5]])
MU = np.array([0.5, -0.3, 0.2])


def _gauss_model():
    Aj, mu = jnp.asarray(A), jnp.asarray(MU)
    return mc.model(lambda v: -0.5 * (v - mu) @ Aj @ (v - mu),
                    gradient=True, init=jnp.asarray(MU + 0.5),
                    check_init=False)


@pytest.mark.parametrize("multinomial", [False, True])
def test_walnuts_moments(multinomial):
    m = _gauss_model()
    chain = mc.run(m, mc.WALNUTS(multinomial=multinomial),
                   mc.SerialMC(steps=6000, burnin=1500), seed=1)
    x = chain.samples.values
    assert np.all(np.isfinite(x))
    mcse = np.sqrt(mc.var(chain))
    z = np.abs(x.mean(axis=0) - MU) / np.maximum(mcse, 1e-12)
    assert np.all(z < 5), z
    cov = np.linalg.inv(A)
    v = x.var(axis=0, ddof=1)
    assert np.all(np.abs(v / np.diag(cov) - 1.0) < 0.25), v
    # eps self-regulates to order-1 on a unit-scale target (the H-G accept
    # statistic would have inflated it without bound — the bug this guards)
    eps = float(np.asarray(chain.diagnostics["epsilon"])[-1])
    assert 0.2 < eps < 4.0, eps


def test_leaf_selection_and_reversibility():
    """Small macro step -> l=0, never bad; stiff step -> halving kicks in."""
    s = mc.WALNUTS(delta=0.5, max_halvings=4)
    mod = types.SimpleNamespace(
        evalallg=lambda v: (-0.5 * jnp.dot(v, v), -v))
    key = jax.random.PRNGKey(0)
    for _ in range(20):
        k1, k2, key = jax.random.split(key, 3)
        x = jax.random.normal(k1, (3,))
        mm = jax.random.normal(k2, (3,))
        lp, g = mod.evalallg(x)
        # tiny step: l=0 passes, trivially reversible
        p, lp1, g1, m1, bad, halved = s._leaf_advance(
            mod, x, lp, mm, g, jnp.asarray(0.05), None)
        assert not bool(bad) and not bool(halved)
        # l=0 must be exactly one leapfrog of the macro step
        from mcmc_jl.samplers.integrators import leapfrog
        p_ref, lp_ref, _, m_ref = leapfrog(mod, x, mm, g, jnp.asarray(0.05))
        np.testing.assert_allclose(np.asarray(p), np.asarray(p_ref))
        np.testing.assert_allclose(np.asarray(m1), np.asarray(m_ref))

    # a macro step far beyond the stability limit must trigger halving
    x = jnp.asarray([1.0, -1.0, 0.5])
    mm = jnp.asarray([1.0, 0.3, -0.2])
    lp, g = mod.evalallg(x)
    _, _, _, _, bad, halved = s._leaf_advance(
        mod, x, lp, mm, g, jnp.asarray(3.0), None)
    assert bool(halved) or bool(bad)


def test_funnel_traversal_beats_fixed_step_nuts():
    """Neal's funnel (v ~ N(0,9), x_i|v ~ N(0, e^v), 9 dims): WALNUTS must
    recover the v-marginal where fixed-step NUTS at the same seed/budget is
    biased away from the neck (measured here: NUTS v-mean ~ +1.0,
    v-var ~ 5.4)."""

    def lp(z):
        v, x = z[0], z[1:]
        return -v * v / 18.0 - 0.5 * jnp.sum(x * x) * jnp.exp(-v) - 4.5 * v

    m = mc.model(lp, gradient=True, init=jnp.zeros(10), check_init=False)
    runner = mc.SerialMC(steps=8000, burnin=2000)

    cw = mc.run(m, mc.WALNUTS(maxdoublings=8, max_halvings=5), runner, seed=0)
    vw = cw.samples.values[:, 0]
    assert abs(vw.mean()) < 0.6, vw.mean()
    assert vw.var() > 6.5, vw.var()
    assert vw.min() < -5.0, vw.min()  # reaches the neck

    cn = mc.run(m, mc.NUTS(maxdoublings=8), runner, seed=0)
    vn = cn.samples.values[:, 0]
    # fixed-step NUTS is measurably worse on every neck metric
    assert vw.var() > vn.var() + 1.0
    assert vw.min() < vn.min() - 1.0


def test_walnuts_resume_exact():
    m = _gauss_model()
    t = m * mc.WALNUTS() * mc.SerialMC(steps=400, burnin=100)
    c1 = mc.run(t, seed=4)
    c2 = mc.resume(c1, steps=200)
    assert c2.samples.values.shape[0] == 200
    assert np.all(np.isfinite(c2.samples.values))


def test_walnuts_mass_adapt_and_irreversible_diag():
    """WALNUTS composes with the mass-warmup reparam; irreversible subtree
    rejections are reported separately from energy divergences."""
    rho = 0.9
    C = np.array([[1.0, rho], [rho, 1.0]]) * np.array([[1.0, 10.0],
                                                       [10.0, 100.0]])
    P = jnp.asarray(np.linalg.inv(C))
    m = mc.model(lambda v: -0.5 * v @ P @ v, gradient=True,
                 init=jnp.ones(2), check_init=False)
    c = mc.run(m, mc.WALNUTS(mass_adapt="diag", multinomial=True),
               mc.SerialMC(steps=5000, burnin=2000), seed=2)
    x = c.samples.values
    assert "irreversible" in c.diagnostics
    irr = np.asarray(c.diagnostics["irreversible"])
    dv = np.asarray(c.diagnostics["diverging"])
    assert irr.mean() <= dv.mean() + 1e-12  # irr is a subset of diverging
    v = x.var(axis=0, ddof=1)
    assert np.all(np.abs(v / np.diag(C) - 1.0) < 0.35), v
