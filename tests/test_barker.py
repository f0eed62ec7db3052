"""Barker proposal (samplers/barker.py) — correctness + the robustness
property it exists for (Livingstone & Zanella 2022): acceptance degrades
gracefully under step-size mis-tuning where MALA collapses."""
import jax.numpy as jnp
import numpy as np

import mcmc_jl as mc


def _gauss1d():
    return mc.model(lambda v: -0.5 * v[0] ** 2, gradient=True,
                    init=jnp.asarray([1.5]), check_init=False)


def test_barker_exact_1d():
    """Skew-corrected acceptance leaves N(0,1) invariant: moment + tail
    gates tight enough to catch a wrong q-ratio sign."""
    chain = mc.run(_gauss1d(), mc.Barker(1.2),
                   mc.SerialMC(steps=30000, burnin=2000), seed=0)
    x = chain.samples.values[:, 0]
    n_eff = float(mc.ess(chain)[0])
    se = 1.0 / np.sqrt(n_eff)
    assert abs(x.mean()) < 5 * se, (x.mean(), se)
    assert abs(x.std(ddof=1) - 1.0) < 0.05
    # P(|X|>1.96) = 0.05; a missing Bernoulli correction skews this hard
    assert abs(np.mean(np.abs(x) > 1.96) - 0.05) < 0.012


def test_barker_robust_to_overshoot():
    """At 10x the optimal scale Barker still moves; MALA's acceptance
    collapses (the headline robustness result of the paper)."""
    m = _gauss1d()
    big = 50.0  # far past MALA's Euler stability limit (eps = 2 for N(0,1))
    cb = mc.run(m, mc.Barker(big), mc.SerialMC(steps=4000, burnin=500), seed=1)
    cm = mc.run(m, mc.MALA(big), mc.SerialMC(steps=4000, burnin=500), seed=1)
    acc_b = mc.acceptance(cb)
    acc_m = mc.acceptance(cm)
    # note Barker's jumps here are sd=50 vs MALA's sd=sqrt(50)~7: bigger
    # moves, yet it keeps accepting while MALA flatlines
    assert acc_b > 3.0, acc_b  # percent
    assert acc_m < 0.5, acc_m


def test_barker_respects_model_scale():
    """Proposal scale multiplies model.scale (reference RWM.jl:52 layout
    parity): a mis-scaled target sampled fine once scale matches."""
    m = mc.model(
        lambda v: -0.5 * (v[0] ** 2 / 100.0 + v[1] ** 2),
        gradient=True, init=jnp.asarray([5.0, 1.0]), check_init=False,
    ).with_scale(jnp.asarray([10.0, 1.0]))
    chain = mc.run(m, mc.Barker(1.0),
                   mc.SerialMC(steps=20000, burnin=2000), seed=2)
    x = chain.samples.values
    assert abs(x[:, 0].std(ddof=1) - 10.0) < 1.2
    assert abs(x[:, 1].std(ddof=1) - 1.0) < 0.12
