"""Distribution catalog correctness vs scipy.stats.

Covers the 13-distribution catalog required by the reference
(src/dsl/definitions/DistributionsExtensions.jl) — logpdf/logcdf/logccdf
values, broadcasting over parameters (the reference's "vectorization on the
distribution parameter"), out-of-support -inf, and gradient cleanliness
(no NaNs leaking through the double-where guards).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st

import mcmc_jl.models.distributions as D

# (our distribution, scipy frozen, test points)
CASES = [
    (D.Normal(1.0, 2.0), st.norm(1.0, 2.0), [-3.0, 0.0, 2.5]),
    (D.Uniform(-1.0, 3.0), st.uniform(-1.0, 4.0), [-0.5, 0.0, 2.9]),
    (D.Exponential(3.0), st.expon(scale=3.0), [0.1, 1.0, 7.0]),
    (D.Gamma(3.0, 0.2), st.gamma(3.0, scale=0.2), [0.1, 0.5, 2.0]),
    (D.Weibull(3.0, 1.5), st.weibull_min(3.0, scale=1.5), [0.2, 1.0, 3.0]),
    (D.Cauchy(-1.0, 0.2), st.cauchy(-1.0, 0.2), [-2.0, -1.0, 5.0]),
    (D.LogNormal(-1.0, 1.0), st.lognorm(1.0, scale=np.exp(-1.0)), [0.1, 0.5, 4.0]),
    (D.Beta(3.0, 2.0), st.beta(3.0, 2.0), [0.1, 0.5, 0.9]),
    (D.Laplace(5.0, 0.1), st.laplace(5.0, 0.1), [4.5, 5.0, 5.3]),
    (D.TDist(4.0), st.t(4.0), [-2.0, 0.0, 1.5]),
    (D.Bernoulli(0.3), st.bernoulli(0.3), [0.0, 1.0]),
    (D.Binomial(10, 0.4), st.binom(10, 0.4), [0.0, 4.0, 10.0]),
    (D.Poisson(2.5), st.poisson(2.5), [0.0, 2.0, 7.0]),
]


@pytest.mark.parametrize("d,ref,xs", CASES, ids=lambda c: type(c).__name__)
def test_logpdf_matches_scipy(d, ref, xs):
    x = jnp.asarray(xs)
    got = np.asarray(d.logpdf(x))
    want = ref.logpmf(np.asarray(xs)) if hasattr(ref, "logpmf") else ref.logpdf(xs)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("d,ref,xs", CASES, ids=lambda c: type(c).__name__)
def test_cdf_matches_scipy(d, ref, xs):
    x = jnp.asarray(xs)
    got = np.asarray(d.cdf(x))
    want = ref.cdf(np.asarray(xs))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    # logccdf consistency
    got_cc = np.asarray(d.logccdf(x))
    want_cc = np.log(np.maximum(1.0 - want, 1e-300))
    mask = want < 1.0 - 1e-12
    np.testing.assert_allclose(got_cc[mask], want_cc[mask], rtol=1e-5, atol=1e-8)


def test_out_of_support_is_neg_inf():
    assert D.Uniform(0.0, 1.0).logpdf(2.0) == -jnp.inf
    assert D.Exponential(1.0).logpdf(-0.5) == -jnp.inf
    assert D.Gamma(2.0, 1.0).logpdf(-1.0) == -jnp.inf
    assert D.LogNormal(0.0, 1.0).logpdf(-3.0) == -jnp.inf
    assert D.Beta(2.0, 2.0).logpdf(1.5) == -jnp.inf
    assert D.Bernoulli(0.5).logpdf(0.5) == -jnp.inf
    # invalid parameters -> -inf too (LLAcc OutOfSupportError analog)
    assert D.Normal(0.0, -1.0).logpdf(0.0) == -jnp.inf
    assert D.Gamma(-2.0, 1.0).logpdf(1.0) == -jnp.inf


def test_param_broadcasting():
    """The reference vectorizes constructors over parameter arrays
    (DistributionsExtensions.jl:5-46); here it is plain jnp broadcasting."""
    mu = jnp.array([0.0, 1.0, 2.0])
    d = D.Normal(mu, 1.0)
    x = jnp.array([0.0, 1.0, 2.0])
    lp = d.logpdf(x)
    assert lp.shape == (3,)
    np.testing.assert_allclose(np.asarray(lp), st.norm(0, 1).logpdf(0.0) * np.ones(3))

    d2 = D.Normal(0.0, jnp.array([1.0, 2.0]))
    assert d2.logpdf(jnp.array([0.5, 0.5])).shape == (2,)


def test_gradients_clean_in_support():
    """Double-where: grads w.r.t. x and params are finite strictly inside
    the support even though out-of-support branches return -inf."""
    for d, wrt in [
        (lambda t: D.Gamma(t, 1.0).logpdf(2.0), 3.0),
        (lambda t: D.Gamma(3.0, t).logpdf(2.0), 1.0),
        (lambda t: D.Uniform(0.0, t).logpdf(0.5), 2.0),
        (lambda t: D.Exponential(t).logpdf(1.0), 2.0),
        (lambda t: D.Weibull(t, 1.0).logpdf(0.5), 2.0),
        (lambda t: D.Beta(t, 2.0).logpdf(0.3), 1.5),
        (lambda t: D.LogNormal(t, 1.0).logpdf(1.3), 0.2),
        (lambda t: D.Bernoulli(t).logpdf(1.0), 0.7),
        (lambda t: D.Poisson(t).logpdf(3.0), 2.0),
        (lambda t: D.Binomial(5, t).logpdf(3.0), 0.4),
        (lambda t: D.Normal(0.0, 1.0).logpdf(t), 0.7),
        (lambda t: D.Cauchy(0.0, 1.0).logpdf(t), 0.7),
        (lambda t: D.TDist(t).logpdf(0.5), 3.0),
        (lambda t: D.Laplace(t, 1.0).logpdf(0.3), 0.9),
    ]:
        g = jax.grad(d)(jnp.asarray(wrt))
        assert np.isfinite(np.asarray(g)), f"grad not finite for {d}"


def test_grad_matches_reference_analytic_rules():
    """Spot-check jax.grad against the hand-derived rules the reference
    installs in MCMCDerivRules.jl (used there as the AD engine; here as
    test oracles — SURVEY §2.2)."""
    x, mu, sigma = 1.3, 0.4, 2.0
    # Normal: dlogpdf/dx = (mu - x)/sigma^2 (MCMCDerivRules.jl:57)
    g = jax.grad(lambda v: D.Normal(mu, sigma).logpdf(v))(jnp.asarray(x))
    np.testing.assert_allclose(float(g), (mu - x) / sigma**2, rtol=1e-10)
    # Normal: d/dmu = (x - mu)/sigma^2; d/dsigma = ((x-mu)^2/sigma^2 - 1)/sigma
    g = jax.grad(lambda m: D.Normal(m, sigma).logpdf(x))(jnp.asarray(mu))
    np.testing.assert_allclose(float(g), (x - mu) / sigma**2, rtol=1e-10)
    g = jax.grad(lambda s: D.Normal(mu, s).logpdf(x))(jnp.asarray(sigma))
    np.testing.assert_allclose(
        float(g), ((x - mu) ** 2 / sigma**2 - 1.0) / sigma, rtol=1e-10
    )
    # Exponential(scale): dlogpdf/dx = -1/scale
    g = jax.grad(lambda v: D.Exponential(2.0).logpdf(v))(jnp.asarray(1.0))
    np.testing.assert_allclose(float(g), -0.5, rtol=1e-10)
    # Poisson: d/dlambda = x/lambda - 1 (MCMCDerivRules.jl:117)
    g = jax.grad(lambda l: D.Poisson(l).logpdf(3.0))(jnp.asarray(2.0))
    np.testing.assert_allclose(float(g), 3.0 / 2.0 - 1.0, rtol=1e-10)


def test_sampling_moments(key):
    n = 40000
    for d, mean, std in [
        (D.Normal(1.0, 2.0), 1.0, 2.0),
        (D.Exponential(3.0), 3.0, 3.0),
        (D.Gamma(3.0, 0.5), 1.5, np.sqrt(3.0) * 0.5),
        (D.Beta(3.0, 2.0), 0.6, np.sqrt(6.0 / (25 * 6))),
        (D.Laplace(1.0, 0.5), 1.0, np.sqrt(2) * 0.5),
        (D.Uniform(0.0, 2.0), 1.0, 2 / np.sqrt(12)),
        (D.Weibull(2.0, 1.0), 0.8862, 0.4633),
        (D.Poisson(2.5), 2.5, np.sqrt(2.5)),
        (D.Bernoulli(0.3), 0.3, np.sqrt(0.21)),
    ]:
        xs = np.asarray(d.sample(key, (n,)))
        assert abs(xs.mean() - mean) < 5 * std / np.sqrt(n) + 1e-3, type(d).__name__
        assert abs(xs.std() - std) < 0.05 * std + 1e-3, type(d).__name__


def test_censoring_wrappers():
    d = D.Normal(0.0, 1.0)
    x = jnp.asarray(0.7)
    np.testing.assert_allclose(float((+d).logpdf(x)), float(d.logccdf(x)))
    np.testing.assert_allclose(float((-d).logpdf(x)), float(d.logcdf(x)))


def test_mvnormal_batched_logpdf():
    """(k, d) batches with k != d must work and match per-row evaluation
    (review finding: solve_triangular treated the batch as an RHS matrix)."""
    rng = np.random.default_rng(3)
    d = 3
    A = rng.standard_normal((d, d))
    cov = A @ A.T + d * np.eye(d)
    mu = rng.standard_normal(d)
    Dm = D.MvNormal(jnp.asarray(mu), jnp.asarray(cov))
    X = rng.standard_normal((5, d))
    got = np.asarray(Dm.logpdf(jnp.asarray(X)))
    want = st.multivariate_normal(mu, cov).logpdf(X)
    np.testing.assert_allclose(got, want, rtol=1e-8)
    # square batch (k == d) used to silently compute the wrong densities
    Xd = rng.standard_normal((d, d))
    np.testing.assert_allclose(np.asarray(Dm.logpdf(jnp.asarray(Xd))),
                               st.multivariate_normal(mu, cov).logpdf(Xd),
                               rtol=1e-8)
    # scalar event unchanged
    np.testing.assert_allclose(float(Dm.logpdf(jnp.asarray(X[0]))),
                               st.multivariate_normal(mu, cov).logpdf(X[0]),
                               rtol=1e-8)


def test_truncated_matches_scipy():
    """Truncated(D, lo, hi) logpdf/logcdf vs scipy.stats.truncnorm; -inf
    outside bounds (package out-of-support convention)."""
    from scipy.stats import truncnorm
    import mcmc_jl as mc

    mu, sd, lo, hi = 0.5, 2.0, -1.0, 3.0
    d = mc.Truncated(mc.Normal(mu, sd), lo, hi)
    ref = truncnorm((lo - mu) / sd, (hi - mu) / sd, loc=mu, scale=sd)
    xs = np.linspace(-0.9, 2.9, 7)
    np.testing.assert_allclose(np.asarray(d.logpdf(jnp.asarray(xs))),
                               ref.logpdf(xs), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(d.logcdf(jnp.asarray(xs))),
                               ref.logcdf(xs), rtol=1e-6)
    assert d.logpdf(jnp.asarray(-1.5)) == -jnp.inf
    assert d.logpdf(jnp.asarray(3.5)) == -jnp.inf
    assert d.logcdf(jnp.asarray(-1.5)) == -jnp.inf
    assert float(d.logcdf(jnp.asarray(4.0))) == 0.0

    # one-sided: half-normal renormalizes by log(2)
    h = mc.Truncated(mc.Normal(0.0, 1.0), 0.0, None)
    x = jnp.asarray(0.7)
    np.testing.assert_allclose(float(h.logpdf(x)),
                               float(mc.Normal(0.0, 1.0).logpdf(x)) + np.log(2.0),
                               rtol=1e-12)
    # differentiable in the interior
    g = jax.grad(lambda t: h.logpdf(t))(x)
    assert np.isfinite(float(g))


def test_truncated_sampling_moment():
    """Half-normal target via Truncated in a model: E[x] = sqrt(2/pi)."""
    import mcmc_jl as mc

    def ex(v):
        mc.tilde(v, mc.Truncated(mc.Normal(0.0, 1.0), 0.0, None))

    m = mc.model(ex, v=np.asarray([0.5]))
    chain = mc.run(m, mc.RWM(0.5), mc.SerialMC(steps=20000, burnin=2000),
                   seed=0)
    x = chain.samples.values[:, 0]
    assert np.all(x >= 0)
    assert abs(x.mean() - np.sqrt(2 / np.pi)) < 0.03, x.mean()
