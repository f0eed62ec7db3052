"""Diagonal mass-matrix warmup for HMC (mass_adapt=True) — a capability the
reference lacks (its only preconditioning is the static model.scale hint).

On a badly-scaled Gaussian (marginal sds 10, 1, 0.1), fixed-metric HMC with
a step small enough to accept is crippled on the wide coordinate; the
Welford-preconditioned version must sample all coordinates correctly and
dramatically improve the worst-coordinate ESS."""
import jax.numpy as jnp
import numpy as np

import mcmc_jl as mc

SDS = np.array([10.0, 1.0, 0.1])


def _model():
    prec = jnp.asarray(1.0 / SDS**2)
    return mc.model(lambda v: -0.5 * jnp.sum(prec * v * v), gradient=True,
                    init=jnp.asarray([1.0, 1.0, 0.1]), check_init=False)


def test_mass_adapt_posterior_and_ess_gain():
    m = _model()
    steps, burnin = 6000, 2000
    c_plain = mc.run(m * mc.HMC(10, 0.08) * mc.SerialMC(steps=steps, burnin=burnin),
                     seed=0)
    c_mass = mc.run(m * mc.HMC(10, 0.8, mass_adapt=True)
                    * mc.SerialMC(steps=steps, burnin=burnin), seed=0)

    x = c_mass.samples.values
    # correct marginals on every scale
    np.testing.assert_allclose(x.std(axis=0, ddof=1), SDS, rtol=0.25)
    z = np.abs(x.mean(axis=0)) / np.maximum(np.sqrt(mc.var(c_mass)), 1e-12)
    assert np.all(z < 5), z

    ess_plain = mc.ess(c_plain)
    ess_mass = mc.ess(c_mass)
    # the wide coordinate (index 0) is where fixed-metric HMC suffers
    assert ess_mass[0] > 3 * ess_plain[0], (ess_plain, ess_mass)
    assert mc.acceptance(c_mass) > 50


def test_mass_adapt_freezes_after_burnin():
    m = _model()
    c = mc.run(m * mc.HMC(10, 0.5, mass_adapt=True)
               * mc.SerialMC(steps=1500, burnin=500), seed=1)
    st = c.task.state
    assert int(st.w_count) == 500  # Welford stops at burnin
    # and resume keeps using the frozen metric exactly
    c2 = mc.resume(c, steps=300)
    assert int(c2.task.state.w_count) == 500
    assert np.all(np.isfinite(c2.samples.values))


def test_mass_adapt_off_keeps_identity_metric():
    m = _model()
    c = mc.run(m * mc.HMC(10, 0.08) * mc.SerialMC(steps=500, burnin=200), seed=2)
    assert int(c.task.state.w_count) == 0


def test_nuts_mass_adapt():
    m = _model()
    c_plain = mc.run(m * mc.NUTS() * mc.SerialMC(steps=3000, burnin=1500), seed=0)
    c_mass = mc.run(m * mc.NUTS(mass_adapt=True)
                    * mc.SerialMC(steps=3000, burnin=1500), seed=0)
    x = c_mass.samples.values
    np.testing.assert_allclose(x.std(axis=0, ddof=1), SDS, rtol=0.3)
    # min-coordinate ESS improves (DA alone must shrink eps for the 0.1-sd
    # coordinate, crippling the 10-sd coordinate)
    assert min(mc.ess(c_mass)) > 1.5 * min(mc.ess(c_plain)), (
        mc.ess(c_plain), mc.ess(c_mass))
    assert int(c_mass.task.state.w_count) == 1500


CORR = 0.95
SCALES = np.array([3.0, 1.0, 0.5, 2.0])


def _corr_model():
    d = len(SCALES)
    sig = (np.full((d, d), CORR) + (1 - CORR) * np.eye(d)) * np.outer(SCALES, SCALES)
    prec = jnp.asarray(np.linalg.inv(sig))
    return sig, mc.model(lambda v: -0.5 * v @ prec @ v, gradient=True,
                         init=jnp.zeros(d), check_init=False)


def test_dense_mass_beats_diag_on_correlated_target():
    """Windowed dense metric (Stan-style expanding windows) on a strongly
    correlated, badly scaled Gaussian: correct covariance and a large
    worst-coordinate ESS gain over the diagonal metric."""
    sig, m = _corr_model()
    r = mc.SerialMC(steps=6000, burnin=2000)
    c_diag = mc.run(m * mc.HMC(10, 0.25, mass_adapt=True) * r, seed=0)
    c_dense = mc.run(m * mc.HMC(10, 0.25, mass_adapt="dense") * r, seed=0)

    x = c_dense.samples.values
    relerr = np.abs(np.cov(x.T) - sig).max() / sig.max()
    assert relerr < 0.15, relerr
    assert min(mc.ess(c_dense)) > 5 * min(mc.ess(c_diag)), (
        mc.ess(c_diag), mc.ess(c_dense))
    assert mc.acceptance(c_dense) > 80

    # the adapted Cholesky factor reconstructs the target covariance
    L = np.asarray(c_dense.task.state.mass.scale)
    np.testing.assert_allclose(L @ L.T, sig, rtol=0.5, atol=0.3 * sig.max())


def test_nuts_dense_mass():
    sig, m = _corr_model()
    r = mc.SerialMC(steps=4000, burnin=2000)
    c_diag = mc.run(m * mc.NUTS(mass_adapt="diag-win") * r, seed=0)
    c_dense = mc.run(m * mc.NUTS(mass_adapt="dense") * r, seed=0)
    x = c_dense.samples.values
    relerr = np.abs(np.cov(x.T) - sig).max() / sig.max()
    assert relerr < 0.2, relerr
    assert min(mc.ess(c_dense)) > 3 * min(mc.ess(c_diag)), (
        mc.ess(c_diag), mc.ess(c_dense))


def test_windowed_diag_schedule_and_freeze():
    """diag-win: scale re-estimated at expanding window ends, frozen after
    burn-in; accumulators reset at each window close."""
    m = _model()
    c = mc.run(m * mc.HMC(10, 0.5, mass_adapt="diag-win")
               * mc.SerialMC(steps=2000, burnin=1000), seed=3)
    st = c.task.state
    s = np.asarray(st.mass.scale)
    # adapted scale should approximate the marginal sds (10, 1, 0.1)
    np.testing.assert_allclose(s, SDS, rtol=0.5)
    # post-burnin: accumulation stopped (count reset at last window close and
    # never incremented past adapt_end)
    assert int(st.mass.count) == 0
    # resume keeps the frozen metric bit-exact
    c2 = mc.resume(c, steps=200)
    np.testing.assert_array_equal(np.asarray(c2.task.state.mass.scale), s)
    x = c.samples.values
    np.testing.assert_allclose(x.std(axis=0, ddof=1), SDS, rtol=0.35)


def test_hmcda_mass_adapt():
    """HMCDA gets the same mass_adapt options as HMC (massadapt.py is
    sampler-agnostic; VERDICT r4 next #8): the dual-averaged step and the
    metric adapt side by side during burn-in, and the preconditioned run
    beats plain HMCDA on the worst coordinate of a badly-scaled target."""
    m = _model()
    r = mc.SerialMC(steps=5000, burnin=2000)
    c_plain = mc.run(m * mc.HMCDA(len=1.0) * r, seed=0)
    c_mass = mc.run(m * mc.HMCDA(len=1.0, mass_adapt="diag-win") * r, seed=0)

    x = c_mass.samples.values
    np.testing.assert_allclose(x.std(axis=0, ddof=1), SDS, rtol=0.3)
    z = np.abs(x.mean(axis=0)) / np.maximum(np.sqrt(mc.var(c_mass)), 1e-12)
    assert np.all(z < 5), z
    # plain HMCDA's DA shrinks eps for the 0.1-sd coordinate, crippling the
    # 10-sd coordinate; the metric decouples them
    assert min(mc.ess(c_mass)) > 1.5 * min(mc.ess(c_plain)), (
        mc.ess(c_plain), mc.ess(c_mass))
    # adapted scale approximates the marginal sds; frozen after burn-in
    st = c_mass.task.state
    np.testing.assert_allclose(np.asarray(st.mass.scale), SDS, rtol=0.5)
    c2 = mc.resume(c_mass, steps=200)
    np.testing.assert_array_equal(np.asarray(c2.task.state.mass.scale),
                                  np.asarray(st.mass.scale))


def test_hmcda_dense_mass():
    sig, m = _corr_model()
    r = mc.SerialMC(steps=5000, burnin=2000)
    c_diag = mc.run(m * mc.HMCDA(len=2.0, mass_adapt="diag-win") * r, seed=0)
    c_dense = mc.run(m * mc.HMCDA(len=2.0, mass_adapt="dense") * r, seed=0)
    x = c_dense.samples.values
    relerr = np.abs(np.cov(x.T) - sig).max() / sig.max()
    assert relerr < 0.2, relerr
    assert min(mc.ess(c_dense)) > 3 * min(mc.ess(c_diag)), (
        mc.ess(c_diag), mc.ess(c_dense))


def test_mass_adapt_flag_validation():
    import pytest

    with pytest.raises(ValueError):
        mc.HMC(10, 0.5, mass_adapt="bogus")
    with pytest.raises(ValueError):
        mc.NUTS(mass_adapt="bogus")
    with pytest.raises(ValueError):
        mc.HMCDA(mass_adapt="bogus")


def test_windowed_adapts_with_short_burnin():
    """Short adaptation spans shrink the init/term buffers (Stan-style)
    instead of silently never adapting (review finding: burnin<=125 used to
    leave the identity metric untouched)."""
    m = _model()
    for kind in ("diag-win", "dense"):
        c = mc.run(m * mc.HMC(10, 0.5, mass_adapt=kind)
                   * mc.SerialMC(steps=300, burnin=100), seed=5)
        st = c.task.state
        s = np.asarray(st.mass.scale)
        if kind == "dense":
            s = np.diag(s)
        assert not np.allclose(s, 1.0), (kind, s)  # metric actually adapted
