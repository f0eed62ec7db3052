"""Convergence-gated runner (runners/convergence.py)."""
import jax.numpy as jnp
import numpy as np

import mcmc_jl as mc


def _gauss_model(d=3, sigma=2.0):
    def logp(v):
        return -0.5 * jnp.sum((v / sigma) ** 2)

    return mc.model(logp, gradient=True, init=jnp.zeros(d), check_init=False)


def test_run_until_converges_on_gaussian():
    m = _gauss_model()
    res = mc.run_until(m, mc.HMC(6, 0.8), n_chains=8, rhat_target=1.02,
                       min_ess=300, check_every=250, max_steps=4000, seed=0)
    assert res.converged, res.history
    assert res.max_rhat <= 1.02
    assert res.min_ess >= 300
    assert res.samples.ndim == 3 and res.samples.shape[1] == 8
    # posterior check on the retained window
    pooled = res.samples.reshape(-1, 3)
    se = 2.0 / np.sqrt(res.min_ess)
    assert np.all(np.abs(pooled.mean(0)) < 5 * se)
    assert np.all(np.abs(pooled.std(0) - 2.0) < 0.35)
    # history is monotone in steps and ends at the stopping point
    steps = [h[0] for h in res.history]
    assert steps == sorted(steps) and steps[-1] == res.steps_run


def test_run_until_respects_max_steps():
    m = _gauss_model()
    res = mc.run_until(m, mc.HMC(4, 0.8), n_chains=4, rhat_target=1.0001,
                       min_ess=10**7, check_every=200, max_steps=600, seed=1)
    assert not res.converged
    assert res.steps_run == 600
    assert len(res.history) >= 1


def test_run_until_states_resume():
    """Final states are resume-ready: continuing with run_chains works and
    advances from the stored positions."""
    from mcmc_jl.parallel.pchains import run_chains

    m = _gauss_model()
    res = mc.run_until(m, mc.HMC(4, 0.8), n_chains=4, rhat_target=1.05,
                       min_ess=100, check_every=200, max_steps=2000, seed=2)
    infos, states, _ = run_chains(m, mc.HMC(4, 0.8), mc.SerialMC(steps=50),
                                  4, key=res.key, states=res.states)
    assert np.asarray(infos["ppars"]).shape == (50, 4, 3)
    assert np.all(np.isfinite(np.asarray(infos["plogtarget"])))


def test_run_until_adaptive_glm_blocks():
    """Adaptive HMC on a model(glm=...) posterior: the burn-in blocks adapt,
    the later blocks run frozen on the generic engine, and the gates pass
    with draws that agree with a fixed-step generic run."""
    rng = np.random.default_rng(7)
    X = np.column_stack([np.ones(80), rng.standard_normal((80, 2))])
    Y = (rng.random(80) < 1.0 / (1.0 + np.exp(-X @ [0.3, 1.0, -0.5]))
         ).astype(float)
    m = mc.model(glm=("logistic", X, Y))
    s = mc.HMC(5, 0.05, mc.EmpMCTuner(0.8, adapt_step=50))
    res = mc.run_until(m, s, n_chains=4, rhat_target=1.1, min_ess=50,
                       check_every=200, max_steps=2000, seed=0)
    assert res.converged
    assert np.all(np.isfinite(res.samples))
    # the tuner froze after warmup: every chain carries its adapted step
    assert np.all(np.asarray(res.states.tune.step_size) != 0.05)
    res_g = mc.run_until(m, mc.HMC(5, 0.1), n_chains=4, rhat_target=1.1,
                         min_ess=50, check_every=200, max_steps=2000, seed=1)
    assert abs(res.samples.mean() - res_g.samples.mean()) < 0.2
