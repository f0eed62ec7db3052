"""DSL layer tests — analog of reference test/dsl/ (unit_tests.jl,
test_diff.jl + helper_diff.jl).

- golden tests on the parameter-map layout (modelVars / vec2var semantics)
- finite-difference validation of jax.grad through every distribution's
  logpdf with scalar/vector parameter shapes (the reference's
  ``@test_combin`` cartesian sweep, helper_diff.jl:40-94)
- censoring statements, indexing/slicing inside models
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mcmc_jl as mc
from mcmc_jl.models.model import _model_vars


# ---------------------------------------------------------------------------
# modelVars / pmap golden tests (reference unit_tests.jl:6-35)
# ---------------------------------------------------------------------------
def test_model_vars_layout():
    size, pmap, init = _model_vars({"x": 3.0})
    assert size == 1 and pmap == {"x": (1, ())}
    np.testing.assert_array_equal(init, [3.0])

    size, pmap, init = _model_vars({"x": 3.0, "y": [1.0, 2.0]})
    assert size == 3
    assert pmap == {"x": (1, ()), "y": (2, (2,))}
    np.testing.assert_array_equal(init, [3.0, 1.0, 2.0])

    size, pmap, init = _model_vars({"x": 3.0, "y": [[1.0, 2.0], [3.0, 4.0]]})
    assert size == 5
    assert pmap == {"x": (1, ()), "y": (2, (2, 2))}
    # matrix flattened column-major like Julia
    np.testing.assert_array_equal(init, [3.0, 1.0, 3.0, 2.0, 4.0])


def test_unravel_roundtrip():
    def f(x, y):
        mc.tilde(x, mc.Normal(0.0, 1.0))
        mc.tilde(y, mc.Normal(0.0, 1.0))

    m = mc.model(f, x=1.0, y=np.array([[1.0, 2.0], [3.0, 4.0]]), check_init=True)
    vals = m.unravel(m.init)
    assert float(vals["x"]) == 1.0
    np.testing.assert_array_equal(np.asarray(vals["y"]), [[1.0, 2.0], [3.0, 4.0]])
    theta = m.ravel({"x": 1.0, "y": np.array([[1.0, 2.0], [3.0, 4.0]])})
    np.testing.assert_allclose(np.asarray(theta), np.asarray(m.init))
    assert m.column_names() == ["x", "y.1.1", "y.2.1", "y.1.2", "y.2.2"]


# ---------------------------------------------------------------------------
# finite-difference gradient sweep (reference test_diff.jl / helper_diff.jl)
# ---------------------------------------------------------------------------
def deriv_check(build, v0):
    """Reference deriv1 (helper_diff.jl:8-37): compare model gradient against
    central finite differences, relative error < 1e-4 (the reference uses
    one-sided 1e-9 perturbations and tolerance 2e-2 in Float64)."""
    m = mc.model(build, gradient=True, check_init=False, x=v0)
    lp0, g = m.evalallg(m.init)
    assert np.all(np.isfinite(np.asarray(g))), "gradient not finite"
    h = 1e-6
    for i in range(m.size):
        e = np.zeros(m.size)
        e[i] = h
        lp_p = float(m.eval(m.init + e))
        lp_m = float(m.eval(m.init - e))
        fd = (lp_p - lp_m) / (2 * h)
        got = float(g[i])
        denom = max(abs(fd), abs(got), 1e-3)
        assert abs(fd - got) / denom < 1e-4, (
            f"param {i}: fd={fd} vs ad={got} for {build}"
        )


DIST_CASES = [
    # distribution ctor (of x), valid x values (scalar + vector runs)
    (lambda x: mc.Normal(1.0, 2.0), 0.5),
    (lambda x: mc.Normal(jnp.array([0.0, 1.0, -1.0]), 2.0), None),
    (lambda x: mc.Uniform(-2.0, 4.0), 0.5),
    (lambda x: mc.Weibull(2.0, 1.0), 0.7),
    (lambda x: mc.Beta(2.0, 3.0), 0.3),
    (lambda x: mc.TDist(4.0), 0.5),
    (lambda x: mc.Exponential(2.0), 0.8),
    (lambda x: mc.Gamma(2.0, 1.5), 1.2),
    (lambda x: mc.Cauchy(0.0, 1.0), 0.3),
    (lambda x: mc.LogNormal(0.0, 1.0), 1.1),
    (lambda x: mc.Laplace(0.0, 1.0), 0.4),
]


@pytest.mark.parametrize("mk,x0", DIST_CASES, ids=lambda c: "case")
def test_fd_gradient_x_scalar(mk, x0):
    if x0 is None:
        x0 = np.array([0.5, 0.6, 0.7])

    def build(x):
        mc.tilde(x, mk(x))

    deriv_check(build, x0)


def test_fd_gradient_x_vector():
    for mk in [
        lambda: mc.Normal(1.0, 2.0),
        lambda: mc.Gamma(2.0, 1.5),
        lambda: mc.Beta(2.0, 3.0),
        lambda: mc.Laplace(0.0, 1.0),
    ]:
        def build(x):
            mc.tilde(x, mk())

        deriv_check(build, np.array([0.3, 0.5, 0.8]))


def test_fd_gradient_through_params():
    """Gradients w.r.t. distribution *parameters* (the reference's
    @dlogpdfd rules)."""
    data = np.array([0.5, 1.2, 2.0])

    def build_normal(x):
        mc.tilde(jnp.asarray(data), mc.Normal(x[0], jnp.exp(x[1])))

    deriv_check(build_normal, np.array([0.3, 0.1]))

    def build_pois(x):
        mc.tilde(jnp.asarray([1.0, 3.0, 2.0]), mc.Poisson(jnp.exp(x[0])))

    deriv_check(build_pois, np.array([0.4]))

    def build_bern(x):
        p = 1.0 / (1.0 + jnp.exp(-x))
        mc.tilde(jnp.asarray([1.0, 0.0, 1.0]), mc.Bernoulli(p))

    deriv_check(build_bern, np.array([0.2, -0.3, 0.5]))


def test_fd_gradient_indexing_exprs():
    """Indexing/slicing inside models (reference test_diff.jl:65-78)."""

    def build1(x):
        mc.tilde(x[0] - x[1], mc.Normal(0.0, 1.0))
        mc.tilde(x[1:3], mc.Normal(0.0, 2.0))

    deriv_check(build1, np.array([0.1, 0.2, 0.3]))

    def build2(x):
        y = jnp.sum(x * x)
        mc.tilde(y, mc.Gamma(2.0, 1.0))

    deriv_check(build2, np.array([0.5, 0.7]))


# ---------------------------------------------------------------------------
# censoring statements (reference expr_funcs.jl:18-22)
# ---------------------------------------------------------------------------
def test_censoring_in_model():
    y = 1.3

    def right(x):
        mc.tilde(y, +mc.Normal(x, 1.0))  # y ~ +Normal  -> logccdf

    def left(x):
        mc.tilde(y, -mc.Normal(x, 1.0))  # y ~ -Normal  -> logcdf

    mr = mc.model(right, x=0.0, check_init=False)
    ml = mc.model(left, x=0.0, check_init=False)
    import scipy.stats as st

    np.testing.assert_allclose(
        float(mr.eval(jnp.zeros(1))), st.norm.logsf(y), rtol=1e-8
    )
    np.testing.assert_allclose(
        float(ml.eval(jnp.zeros(1))), st.norm.logcdf(y), rtol=1e-8
    )
    deriv_check(lambda x: right(x), np.array([0.0]))


# ---------------------------------------------------------------------------
# out-of-support model evaluation -> (-inf, zero gradient)
# ---------------------------------------------------------------------------
def test_out_of_support_maps_to_neg_inf_and_zero_grad():
    def build(x):
        mc.tilde(x, mc.Gamma(2.0, 1.0))  # support x > 0

    m = mc.model(build, gradient=True, x=1.0, check_init=True)
    lp, g = m.evalallg(jnp.asarray([-1.0]))
    assert lp == -jnp.inf
    np.testing.assert_array_equal(np.asarray(g), [0.0])
    assert float(m.eval(jnp.asarray([-1.0]))) == -np.inf


def test_dsl_model_runs_end_to_end():
    """modelxpr of the README: v ~ Normal(0, 1) with v=ones(3)."""

    def modelxpr(v):
        mc.tilde(v, mc.Normal(0.0, 1.0))

    m3 = mc.model(modelxpr, v=np.ones(3))
    m4 = mc.model(modelxpr, gradient=True, v=np.ones(3))
    assert not m3.hasgradient and m4.hasgradient
    c = mc.run(m4 * mc.HMC(2, 0.5) * mc.SerialMC(steps=500, burnin=100))
    assert c.samples.shape == (400, 3)
    assert c.samples.columns == ["v.1", "v.2", "v.3"]
