"""WAIC / PSIS-LOO (stats/ic.py) against a conjugate model's exact LOO.

Normal-normal model with known unit noise: y_i ~ N(theta, 1),
theta ~ N(0, 1).  Both the full posterior and every leave-one-out
posterior are analytic, so exact elpd_loo = sum_i log N(y_i; mu_-i, 1+v_-i)
is available in closed form.  Posterior draws are taken i.i.d. from the
exact posterior — the tests gate the *estimators*, not a sampler.
"""
import numpy as np
import pytest

import mcmc_jl as mc

rng = np.random.default_rng(3)
N, S = 50, 8000
y = rng.standard_normal(N) + 0.6

v_post = 1.0 / (N + 1.0)
mu_post = v_post * y.sum()
draws = (mu_post + np.sqrt(v_post) * rng.standard_normal(S))[:, None]


def _ll_matrix(theta, yy):
    # (S, 1) x (N,) -> (S, N) pointwise log-lik
    return -0.5 * (yy[None, :] - theta) ** 2 - 0.5 * np.log(2 * np.pi)


def _exact_elpd_loo():
    out = 0.0
    for i in range(N):
        v = 1.0 / (N - 1 + 1.0)
        mu = v * (y.sum() - y[i])
        s2 = 1.0 + v
        out += -0.5 * (y[i] - mu) ** 2 / s2 - 0.5 * np.log(2 * np.pi * s2)
    return out


LL = _ll_matrix(draws, y)


def test_psis_loo_matches_exact():
    r = mc.psis_loo(LL)
    exact = _exact_elpd_loo()
    assert abs(r["elpd_loo"] - exact) < 0.5, (r["elpd_loo"], exact)
    # one parameter, weak prior -> effective complexity ~1
    assert 0.3 < r["p_loo"] < 2.0
    assert np.all(r["pareto_k"] < 0.7)  # easy geometry: all tails light
    assert r["looic"] == pytest.approx(-2 * r["elpd_loo"])
    assert r["se"] > 0


def test_waic_close_to_loo():
    w = mc.waic(LL)
    r = mc.psis_loo(LL)
    assert abs(w["elpd_waic"] - r["elpd_loo"]) < 0.5
    assert 0.3 < w["p_waic"] < 2.0
    assert w["waic"] == pytest.approx(-2 * w["elpd_waic"])


def test_pointwise_loglik_device_path():
    import jax.numpy as jnp

    def ll_pw(theta):
        return -0.5 * (jnp.asarray(y) - theta[0]) ** 2 - 0.5 * np.log(2 * np.pi)

    out = mc.pointwise_loglik(ll_pw, draws)
    assert out.shape == (S, N)
    np.testing.assert_allclose(out, LL, rtol=1e-6)


def test_compare_ranks_better_model_first():
    # wrong model: fixed theta = 0 (no parameters) vs the fitted model
    ll_bad = _ll_matrix(np.zeros((S, 1)), y)
    good, bad = mc.psis_loo(LL), mc.psis_loo(ll_bad)
    ranked = mc.compare_elpd({"fitted": good, "null": bad})
    assert [r[0] for r in ranked] == ["fitted", "null"]
    assert ranked[0][2] == pytest.approx(0.0)      # d_elpd of best = 0
    assert ranked[1][2] > 0                        # null is worse
    assert ranked[1][3] > 0                        # with a positive SE


def test_psis_smooths_heavy_tail():
    # pathological importance geometry: draws from a much wider proposal
    # than the target -> raw ratios are heavy-tailed, khat should say so
    wide = (5.0 * rng.standard_normal(S))[:, None]
    ll_wide = _ll_matrix(wide, y)
    r = mc.psis_loo(ll_wide)
    assert np.all(np.isfinite(r["pointwise"]))
    assert np.any(r["pareto_k"] > 0.2)  # the diagnostic reacts
