"""XLA driver around the GPU GLM trajectory kernel.

Per transition, momenta are drawn and the Metropolis test is taken in XLA,
and the whole ``n_leaps`` trajectory runs in one launch of
:func:`mcmc_jl.ops.pallas_glm.glm_trajectory`.  The chain law is that of
``HMC(n_leaps, eps)`` on the same model (same integrator, same accept rule
``ratio > 0 || ratio > log(u)`` with NaN rejecting — reference
HMC.jl:136-165); the random stream differs from the generic engine's.

Momenta are drawn only on the ``d`` live columns, so padded coordinates
stay exactly zero and ``plogtarget`` is the model's own log-density in IEEE
f32.  Plain MALA runs as one-leapfrog HMC (:func:`fused_mala_chains`).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .pallas_glm import glm_trajectory, pad_chains, pad_design, padded_dim


def _logp_grad(XT, Y, W, O, theta, *, n_obs, kind, lam, interpret):
    """Log-density and gradient of padded chains from the kernel's own
    trajectory end point (one zero-length step), so that a chain's first
    transition compares two points evaluated by the same code."""
    z = jnp.zeros_like(theta)
    _, _, g, lp = glm_trajectory(XT, Y, W, O, theta, z, z, n_obs=n_obs,
                                 n_leaps=1, eps=0.0, kind=kind, lam=lam,
                                 interpret=interpret)
    return lp, g


@partial(jax.jit, static_argnames=("n_chains", "n_obs", "d", "steps",
                                   "n_leaps", "eps", "kind", "lam",
                                   "integrator", "interpret"))
def _run(XT, Y, W, O, theta0, key, *, n_chains, n_obs, d, steps, n_leaps,
         eps, kind, lam, integrator, interpret):
    """Scan ``steps`` transitions of all (padded) chains.  Infos hold the
    post-accept rows of the ``n_chains`` real chains only: ppars, pgrads
    (live columns), plogtarget and accept."""
    C, D = theta0.shape
    lp0, g0 = _logp_grad(XT, Y, W, O, theta0, n_obs=n_obs, kind=kind,
                         lam=lam, interpret=interpret)

    def step(carry, k):
        theta, lp, g = carry
        k_mom, k_acc = jax.random.split(k)
        m0 = jnp.pad(jax.random.normal(k_mom, (C, d), theta.dtype),
                     ((0, 0), (0, D - d)))
        p_theta, p_m, p_g, p_lp = glm_trajectory(
            XT, Y, W, O, theta, m0, g, n_obs=n_obs, n_leaps=n_leaps,
            eps=eps, kind=kind, lam=lam, integrator=integrator,
            interpret=interpret)
        ratio = (-lp + 0.5 * jnp.sum(m0 * m0, axis=1)) - (
            -p_lp + 0.5 * jnp.sum(p_m * p_m, axis=1))
        logu = jnp.log(jax.random.uniform(k_acc, (C,), theta.dtype))
        accept = jnp.where(jnp.isnan(ratio), False,
                           (ratio > 0) | (ratio > logu))
        theta = jnp.where(accept[:, None], p_theta, theta)
        g = jnp.where(accept[:, None], p_g, g)
        lp = jnp.where(accept, p_lp, lp)
        info = {"ppars": theta[:n_chains, :d], "pgrads": g[:n_chains, :d],
                "plogtarget": lp[:n_chains], "accept": accept[:n_chains]}
        return (theta, lp, g), info

    keys = jax.random.split(key, steps)
    return jax.lax.scan(step, (theta0, lp0, g0), keys)


def final_hmc_states(model, sampler, n_chains, steps_done, thetaF):
    """Batched HMCState after a kernel run, with logp/grad re-evaluated by
    the model itself so that resume continues on the generic engine."""
    from ..samplers.base import tuner_init
    from ..samplers.hmc import HMCState
    from ..samplers.massadapt import mass_init

    d = model.size
    mdt = model.init.dtype
    bcast = lambda a: jnp.broadcast_to(a, (n_chains,) + a.shape)  # noqa: E731
    pars = thetaF[:n_chains, :d].astype(mdt)
    states = HMCState(
        pars=pars, logtarget=jnp.zeros((n_chains,), mdt),
        grad=jnp.zeros_like(pars),
        tune=jax.tree_util.tree_map(
            bcast, tuner_init(sampler.leap_step, sampler.n_leaps)),
        i=jnp.full((n_chains,), steps_done + 1, jnp.int32),
        mass=jax.tree_util.tree_map(bcast, mass_init(None, d, mdt)),
    )
    return jax.vmap(lambda s, th: sampler.reset(model, s, th))(states,
                                                               states.pars)


def fused_hmc_chains(model, sampler, runner, n_chains, key, interpret=False):
    """Run ``n_chains`` plain-HMC chains of a ``model(glm=...)`` posterior
    through the kernel; returns ``(infos, final_states)`` in the protocol of
    :func:`mcmc_jl.parallel.run_chains` (post-accept keys only)."""
    spec = model.glm_spec
    assert spec is not None, "fused_hmc_chains requires a model(glm=...)"
    d = model.size
    XT, Y, W, O = pad_design(spec.X, spec.Y, spec.weights, spec.offsets)
    inits = jnp.broadcast_to(jnp.asarray(model.init, jnp.float32),
                             (n_chains, d))
    (thetaF, _, _), infos = _run(
        XT, Y, W, O, pad_chains(inits, padded_dim(d)), key,
        n_chains=n_chains, n_obs=int(spec.X.shape[0]), d=d,
        steps=runner.len, n_leaps=sampler.n_leaps,
        eps=float(sampler.leap_step), kind=spec.kind,
        lam=float(spec.prior_prec), integrator=sampler.integrator,
        interpret=interpret)
    return infos, final_hmc_states(model, sampler, n_chains, runner.len,
                                   thetaF)


def fused_mala_chains(model, sampler, runner, n_chains, key,
                      interpret=False):
    """Plain MALA with drift step ``s`` is one-leapfrog HMC at
    ``eps = sqrt(s)``: the proposal ``theta + (s/2) g + sqrt(s) m`` is
    ``N(theta + (s/2) g, s I)`` and the Hamiltonian ratio equals MALA's
    q-corrected ratio (reference MALA.jl:65-126 vs HMC.jl:93-102).  Final
    states are MALAStates."""
    from ..samplers.base import tuner_init
    from ..samplers.hmc import HMC
    from ..samplers.mala import MALAState

    shim = HMC(1, float(np.sqrt(sampler.scale)))
    infos, h = fused_hmc_chains(model, shim, runner, n_chains, key,
                                interpret=interpret)
    bcast = lambda a: jnp.broadcast_to(a, (n_chains,) + a.shape)  # noqa: E731
    tune = jax.tree_util.tree_map(bcast, tuner_init(sampler.scale))
    return infos, MALAState(pars=h.pars, logtarget=h.logtarget, grad=h.grad,
                            tune=tune, i=h.i)
