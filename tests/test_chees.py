"""ChEES-HMC (samplers/chees.py) — cross-chain adaptive trajectory lengths,
the SIMD-friendly alternative to NUTS (beyond the reference's capability set).

Adaptation happens in the engine-level pool hook, so these run through the
multi-chain engine (`run(task, chains=N)` / `run_chains`)."""
import jax
import jax.numpy as jnp
import numpy as np

import mcmc_jl as mc
from mcmc_jl.parallel import run_chains


def _gauss_model(sd):
    prec = 1.0 / sd**2
    return mc.model(lambda v: -0.5 * prec * jnp.sum(v * v), gradient=True,
                    init=jnp.zeros(3), check_init=False)


def test_chees_adapts_trajectory_length_and_samples():
    """On N(0, sd^2 I) the Hamiltonian flow has period 2*pi*sd; ChEES must
    grow the trajectory length from a deliberately tiny start towards the
    O(sd) optimum, and the posterior must be correct."""
    sd = 3.0
    m = _gauss_model(sd)
    s = mc.ChEESHMC(len0=0.3)
    r = mc.SerialMC(steps=3000, burnin=1500)
    chains = mc.run(m * s * r, chains=16, seed=0)

    st = chains[0].task.state
    T = float(np.exp(np.asarray(st.log_len)))
    eps = float(np.asarray(st.dual_leap_step))
    assert T > 1.5, f"trajectory length failed to grow: T={T}"
    # (on a Gaussian the 0.651-acceptance step size is itself O(sd), so T/eps
    # stays small — the meaningful check is T approaching the O(pi*sd) optimum)
    assert T > eps, (T, eps)

    x = np.concatenate([c.samples.values for c in chains], axis=0)
    np.testing.assert_allclose(x.std(axis=0, ddof=1), sd, rtol=0.15)
    assert np.all(np.abs(x.mean(axis=0)) < 0.3)

    # pooled dual averaging hits the target acceptance rate
    acc = np.mean([np.mean(np.asarray(c.diagnostics["alpha"])) for c in chains])
    assert 0.45 < acc < 0.9, acc

    # adapted scalars are shared (broadcast-equal) across chains
    eps_all = [float(np.asarray(c.task.state.dual_leap_step)) for c in chains]
    T_all = [float(np.asarray(c.task.state.log_len)) for c in chains]
    assert np.ptp(eps_all) == 0.0
    assert np.ptp(T_all) == 0.0


def test_chees_frozen_after_burnin():
    m = _gauss_model(1.0)
    s = mc.ChEESHMC(len0=0.5)
    r = mc.SerialMC(steps=600, burnin=300)
    infos, states, _ = run_chains(m, s, r, 8, seed=1, jitter=0.2)
    # epsilon diagnostic is constant over the post-burn-in half
    epshist = np.asarray(infos["epsilon"])[:, 0]
    post = epshist[300:]
    assert np.ptp(post) == 0.0, "step size not frozen after burn-in"
    assert not np.ptp(epshist[:300]) == 0.0, "no adaptation during burn-in"
    assert np.all(np.isfinite(np.asarray(infos["ppars"])))


def test_chees_single_chain_fallback():
    """SerialMC single-chain path has no pool hook: must still sample with
    the init-heuristic step size (no NaNs, reasonable acceptance)."""
    m = _gauss_model(1.0)
    c = mc.run(m * mc.ChEESHMC(len0=1.0) * mc.SerialMC(steps=800, burnin=200),
               seed=2)
    x = c.samples.values
    assert np.all(np.isfinite(x))
    np.testing.assert_allclose(x.std(axis=0, ddof=1), 1.0, rtol=0.35)
    assert mc.acceptance(c) > 40


def test_chees_beats_fixed_hmc_on_wide_scales():
    """Ill-scaled Gaussian: the cost-normalized criterion (ascend
    log ChEES - log T) optimizes effective samples per gradient; ChEES must
    beat a fixed mistuned HMC at the same step scale by a wide margin there,
    without giving up raw min-coordinate ESS."""
    sds = np.array([8.0, 1.0])
    prec = jnp.asarray(1.0 / sds**2)
    m = mc.model(lambda v: -0.5 * jnp.sum(prec * v * v), gradient=True,
                 init=jnp.zeros(2), check_init=False)
    r = mc.SerialMC(steps=3000, burnin=1500)
    chains = mc.run(m * mc.ChEESHMC(len0=0.5) * r, chains=8, seed=3)
    x = np.concatenate([c.samples.values for c in chains], axis=0)
    np.testing.assert_allclose(x.std(axis=0, ddof=1), sds, rtol=0.2)

    ess_chees = np.mean([np.min(mc.ess(c)) for c in chains])
    grads_chees = np.mean(
        [np.sum(np.asarray(c.diagnostics["nleaps"])) for c in chains])
    fixed = mc.run(m * mc.HMC(3, 0.5) * r, chains=8, seed=3)
    ess_fixed = np.mean([np.min(mc.ess(c)) for c in fixed])
    grads_fixed = 3.0 * r.len
    # measured ~12 vs ~2 ESS/kgrad (stable across seeds); gate at 3x
    eff_chees = ess_chees / grads_chees
    eff_fixed = ess_fixed / grads_fixed
    assert eff_chees > 3.0 * eff_fixed, (eff_fixed, eff_chees)
    # and not at the price of raw per-step quality
    assert ess_chees > 0.8 * ess_fixed, (ess_fixed, ess_chees)


def test_halton_sequence_properties():
    from mcmc_jl.samplers.chees import halton2

    idx = jnp.arange(1, 129, dtype=jnp.int32)
    u = np.asarray(jax.vmap(halton2)(idx))
    assert np.all((u > 0) & (u < 1))
    # low-discrepancy: first 128 values nearly uniform on (0,1)
    assert abs(u.mean() - 0.5) < 0.01
    assert len(np.unique(u)) == 128
