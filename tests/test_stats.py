"""Output-analysis layer tests (reference: src/stats/, README.md:119-205)."""
import jax.numpy as jnp
import numpy as np
import pytest

import mcmc_jl as mc
from mcmc_jl.ops.acf import autocov
from mcmc_jl.stats.var import mcvar_bm, mcvar_iid, mcvar_imse, mcvar_ipse


def test_autocov_matches_numpy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(500)
    acv = np.asarray(autocov(x, maxlag=20))
    xc = x - x.mean()
    for k in range(21):
        want = np.dot(xc[: len(x) - k], xc[k:]) / len(x)
        np.testing.assert_allclose(acv[k], want, rtol=1e-8, atol=1e-10)


def test_mcvar_iid_on_white_noise():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((20000, 2))
    v = mcvar_iid(x)
    np.testing.assert_allclose(v, np.var(x, axis=0, ddof=1) / 20000, rtol=1e-12)
    # white noise: imse ~ iid
    vi = mcvar_imse(x)
    assert np.all(vi / v < 1.5) and np.all(vi / v > 0.5)


def test_mcvar_bm_requires_enough_batches():
    with pytest.raises(AssertionError):
        mcvar_bm(np.zeros((150, 1)), batchlen=100)


def test_geyer_on_ar1():
    """AR(1) with coefficient rho has asymptotic variance
    sigma^2/n * (1+rho)/(1-rho); IMSE should land near it."""
    rng = np.random.default_rng(2)
    rho, n = 0.6, 200000
    eps = rng.standard_normal(n)
    x = np.empty(n)
    x[0] = eps[0]
    for i in range(1, n):
        x[i] = rho * x[i - 1] + eps[i]
    marg_var = 1.0 / (1.0 - rho**2)
    want = marg_var * (1 + rho) / (1 - rho) / n
    got = mcvar_imse(x[:, None])[0]
    assert abs(got - want) / want < 0.1
    got_ipse = mcvar_ipse(x[:, None])[0]
    assert abs(got_ipse - want) / want < 0.1
    # ess/actime identities
    class FakeChain:  # minimal duck-type
        pass

    ess = n * mcvar_iid(x[:, None]) / got
    act = got / mcvar_iid(x[:, None])
    np.testing.assert_allclose(ess * act, n, rtol=1e-9)


def _gaussian_chain(steps=12000, burnin=2000, leap_step=0.75, store_leaps=False):
    m = mc.model(lambda v: -jnp.dot(v, v), grad=lambda v: -2 * v, init=jnp.ones(3))
    return mc.run(
        m * mc.HMC(leap_step, store_leaps) * mc.SerialMC(steps=steps, burnin=burnin)
    )


def test_readme_hmc_baseline():
    """The README statistical baseline (BASELINE.md): HMC(0.75) on N(0, I/2)
    -- acceptance ~80%, AC time ~1.7, ESS ~5.3k of 9k kept.

    (The reference's -dot(v,v) target is N(0, I/2); same as README.)"""
    chain = _gaussian_chain(steps=10000, burnin=1000)
    acc = mc.acceptance(chain)
    assert 70 < acc < 90, acc

    e = mc.ess(chain)
    act = mc.actime(chain)
    assert e.shape == (3,)
    # HMC(10 leaps, 0.75) on this target mixes fast: AC time close to ~1-2.5
    assert np.all(act < 3.5) and np.all(act > 0.5), act
    assert np.all(e > 2000), e

    v_imse = mc.var(chain)
    v_iid = mc.var(chain, vtype="iid")
    v_ipse = mc.var(chain, vtype="ipse")
    v_bm = mc.var(chain, vtype="bm")
    for v in (v_imse, v_iid, v_ipse, v_bm):
        assert v.shape == (3,) and np.all(v > 0)
    # describe runs and prints all columns
    import io

    buf = io.StringIO()
    mc.describe(chain, io=buf)
    out = buf.getvalue()
    for col in ("pars.1", "pars.2", "pars.3"):
        assert col in out
    assert "MC Error" in out and "ESS" in out and "AC Time" in out

    # posterior moments within MC error: mean ~ 0, var ~ 0.5
    x = chain.samples.values
    se = np.sqrt(v_imse)
    assert np.all(np.abs(x.mean(0)) < 5 * se + 0.05)
    assert np.all(np.abs(x.var(0) - 0.5) < 0.05)


def test_mean_rb_with_stored_leaps():
    chain = _gaussian_chain(steps=3000, burnin=500, store_leaps=True)
    assert "leaps_pars" in chain.diagnostics
    rb = mc.mean_rb(chain)
    plain = mc.mean(chain)
    assert rb.shape == plain.shape
    # both estimate the same mean (0); RB shouldn't be wildly off
    assert np.all(np.abs(rb) < 0.2)


def test_zv_variance_reduction():
    """ZV control variates must reduce marginal variance on a Gaussian
    (Mira et al. guarantee; reference stats/zv.jl)."""
    chain = _gaussian_chain(steps=6000, burnin=1000)
    z_lin, a = mc.linear_zv(chain)
    assert z_lin.shape == chain.samples.shape
    raw_var = chain.samples.values.var(0)
    zv_var = z_lin.var(0)
    assert np.all(zv_var < raw_var * 0.1), (raw_var, zv_var)

    z_quad, aq = mc.quadratic_zv(chain)
    assert np.all(z_quad.var(0) < raw_var * 0.1)
    # reference-spelling aliases
    assert mc.linearZv is mc.linear_zv and mc.quadraticZv is mc.quadratic_zv


def test_acceptance_lags_and_reject():
    chain = _gaussian_chain(steps=2000, burnin=500)
    a = mc.acceptance(chain)
    r = mc.acceptance(chain, reject=True)
    np.testing.assert_allclose(a + r, 100.0)
    a_first = mc.acceptance(chain, lags=range(1, 501))
    assert 0 <= a_first <= 100


def test_multichain_rhat_and_pooled_ess():
    """Cross-chain diagnostics on a well-mixed vmapped batch."""
    from mcmc_jl.parallel import run_chains

    m = mc.model(lambda v: -jnp.dot(v, v), grad=lambda v: -2 * v,
                 init=jnp.ones(2))
    infos, _, _ = run_chains(m, mc.HMC(0.75), mc.SerialMC(steps=1500, burnin=500),
                             8, seed=0, jitter=1.0)
    x = np.asarray(infos["ppars"])[500:]
    r = mc.rhat(x)
    assert r.shape == (2,) and np.all(r < 1.05), r
    e = mc.ess_pooled(x)
    assert np.all(e > 1000), e
    rep = mc.summarize_chains(x, param_names=["a", "b"])
    assert set(rep) == {"a", "b"}
    assert abs(rep["a"]["mean"]) < 0.1
    assert 1.0 > rep["a"]["rhat"] - 0.05


def test_wsample():
    vals = np.array([0.0, 1.0, 2.0])
    w = np.array([0.0, 0.0, 1.0])
    out = mc.wsample(vals, w, 50)
    assert np.all(out == 2.0)


def test_throughput_report():
    from mcmc_jl.utils.profiling import throughput_report, timed

    chain = _gaussian_chain(steps=1200, burnin=200)
    rep = throughput_report(chain, n_chains=1, n_leaps=10)
    assert rep["steps_per_sec"] > 0
    assert rep["leapfrog_per_sec"] == rep["steps_per_sec"] * 10
    assert "ess_per_sec" in rep and rep["ess_per_sec"] > 0

    sink = []
    with timed("block", sink=sink):
        pass
    assert sink and sink[0]["label"] == "block" and sink[0]["seconds"] >= 0


def test_mcmc_quantile_ar1():
    """FJN13 quantile estimator: AR(1) chain targeting N(0, 1) — point
    estimates near the true normal quantiles, MCSE honest (z-gate), and
    wider than the naive iid MCSE for a positively correlated chain."""
    from scipy import stats as sps

    rng = np.random.default_rng(7)
    rho, n = 0.5, 60000
    innov = np.sqrt(1 - rho**2)
    e = rng.standard_normal(n)
    x = np.empty(n)
    x[0] = e[0]
    for t in range(1, n):
        x[t] = rho * x[t - 1] + innov * e[t]

    qs = [0.025, 0.5, 0.975]
    est, se = mc.mcmc_quantile(x, qs)
    truth = sps.norm.ppf(qs)
    assert est.shape == (3, 1) and se.shape == (3, 1)
    for i in range(3):
        assert se[i, 0] > 0
        assert abs(est[i, 0] - truth[i]) < 5 * se[i, 0] + 1e-3, (i, est, se)
    # correlated chain: bm-based MCSE should exceed the iid-based one
    _, se_iid = mc.mcmc_quantile(x, 0.5, vtype="iid")
    assert se[1, 0] > se_iid[0]

    # scalar-q convenience shape
    e1, s1 = mc.mcmc_quantile(x, 0.5)
    assert e1.shape == (1,) and s1.shape == (1,)


def test_describe_includes_quantiles():
    import io

    chain = _gaussian_chain(steps=1500, burnin=300)
    buf = io.StringIO()
    mc.describe(chain, io=buf)
    out = buf.getvalue()
    assert "Q50%" in out and "Q2.5%" in out and "MCSE" in out
    # reference-exact field set still available
    buf2 = io.StringIO()
    mc.describe(chain, io=buf2, quantiles=())
    assert "Q50%" not in buf2.getvalue()


def test_geyer_floor_on_antithetic_chain():
    """Strongly antithetic sequence: IMSE/IPSE must stay positive (the
    floor caps implied ESS at ~n*log10(n)); iid variance unaffected."""
    rng = np.random.default_rng(9)
    n = 4000
    # AR(1) with rho ~ -0.95: wildly super-efficient for the mean
    rho = -0.95
    e = rng.standard_normal(n)
    x = np.empty(n)
    x[0] = e[0]
    for t in range(1, n):
        x[t] = rho * x[t - 1] + np.sqrt(1 - rho**2) * e[t]
    v_imse = mcvar_imse(x)
    v_ipse = mcvar_ipse(x)
    assert v_imse[0] > 0 and v_ipse[0] > 0
    ess = n * mcvar_iid(x) / v_imse
    assert ess[0] <= n * np.log10(n) * 1.2


def test_mean_rb_masks_adapted_trajectories():
    """With a tuner, trajectory buffers are max_step rows long but only the
    adapted n_leaps are live; mean_rb must mask the frozen endpoint copies
    (review finding: duplicates biased the RB mean toward endpoints)."""
    m = mc.model(lambda v: -jnp.dot(v, v), grad=lambda v: -2 * v,
                 init=jnp.ones(3))
    tuner = mc.EmpMCTuner(0.8, adapt_step=50, max_step=40)
    chain = mc.run(
        m * mc.HMC(5, 0.3, True, tuner) * mc.SerialMC(steps=2500, burnin=500)
    )
    assert "leaps_n" in chain.diagnostics
    nl = np.asarray(chain.diagnostics["leaps_n"])
    assert nl.max() <= 40 and nl.min() >= 1
    rb = mc.mean_rb(chain)
    # unbiased around the true zero mean
    assert np.all(np.abs(rb) < 0.15), rb


def test_rank_normalized_rhat():
    """Vehtari-2021 rank R-hat: ~1 when mixed; flags a variance-mismatched
    chain that classic split-R-hat (location-only) waves through."""
    rng = np.random.default_rng(0)
    # well-mixed: 8 iid N(0,1) chains
    good = rng.standard_normal((1000, 8, 2))
    r_good = mc.rhat(good, method="rank")
    assert r_good.shape == (2,) and np.all(r_good < 1.01), r_good

    # same means, one chain with 5x the spread (classic B ~ 0 -> R-hat ~ 1)
    bad = rng.standard_normal((1000, 8, 1))
    bad[:, 0, :] *= 5.0
    r_classic = mc.rhat(bad)
    r_rank = mc.rhat(bad, method="rank")
    assert r_classic[0] < 1.01, r_classic
    assert r_rank[0] > 1.05, r_rank

    rep = mc.summarize_chains(good[:, :, :1], param_names=["a"])
    assert rep["a"]["rhat_rank"] < 1.01
