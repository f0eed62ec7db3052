"""Position-dependent MALA (reference: src/samplers/PMALA.jl; Xifara et al.
2013).

Like SMMALA but the drift subtracts the metric-derivative correction
``sum_i (G^{-1} dG_i G^{-1})_{:, i}`` (PMALA.jl:77-80, 94).  Requires
gradient + tensor + dtensor.

Batched layout (as samplers/smmala.py): the current point's
geometry — Cholesky factor, inverse metric, full drift vector — is carried
in the state (it was computed when that point was the proposal), so each
transition pays exactly one ``evalalldt``, one batched Cholesky and one
triangular-solve-based inverse for the PROPOSED point; the reference
recomputes ``inv(G)`` and ``chol(eps G^{-1})`` for both endpoints every
step (PMALA.jl:76-100).  Carrying the drift instead of the raw ``dG``
also drops the (d, d, d) tensor from the state pytree.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from .base import (
    EmpMCTuner, RunCtx, Sampler, TuneState, metropolis_accept,
    pytree_dataclass, tuner_init, tuner_update,
)
from .smmala import _logdet_chol, chol_inverse


@pytree_dataclass
class PMALAState:
    pars: jnp.ndarray
    logtarget: jnp.ndarray
    grad: jnp.ndarray
    chol: jnp.ndarray   # lower Cholesky factor of G(pars)
    drift: jnp.ndarray  # G^{-1} grad - sum_i (G^{-1} dG_i G^{-1})_{:, i}
    tune: TuneState
    i: jnp.ndarray


def _geometry(grad, G, dG):
    """(L, drift) with drift = G^{-1}grad - sum_i (G^{-1} dG_i G^{-1})_{:,i}
    (PMALA.jl:76-80) from one Cholesky; the inverse comes from two
    triangular solves against the identity."""
    L = jnp.linalg.cholesky(G)
    invG = chol_inverse(L)
    first = invG @ grad
    # second[a] = sum_i (invG @ dG[:, :, i] @ invG)[a, i]
    second = jnp.einsum("ab,bci,ci->a", invG, dG, invG)
    return L, first - second


@dataclasses.dataclass(frozen=True, repr=False)
class PMALA(Sampler):
    scale: float = 1.0  # driftStep
    tuner: Optional[EmpMCTuner] = None

    needs_gradient = True
    needs_tensor = True
    needs_dtensor = True

    def __post_init__(self):
        assert self.scale > 0, "PMALA drift step should be > 0"

    def init(self, model, theta0, key):
        lp, g, G, dG = model.evalalldt(theta0)
        L, drift = _geometry(g, G, dG)
        return PMALAState(
            pars=theta0, logtarget=lp, grad=g, chol=L, drift=drift,
            tune=tuner_init(self.scale),
            i=jnp.asarray(1, dtype=jnp.int32),
        )

    def reset(self, model, state, theta):
        lp, g, G, dG = model.evalalldt(theta)
        L, drift = _geometry(g, G, dG)
        return state.replace(pars=theta, logtarget=lp, grad=g, chol=L,
                             drift=drift)

    def step(self, model, ctx: RunCtx, state, key):
        k_prop, k_acc = jax.random.split(key)
        dtype = state.pars.dtype
        eps = (
            state.tune.step_size.astype(dtype)
            if self.tuner is not None
            else jnp.asarray(self.scale, dtype=dtype)
        )

        L = state.chol
        pars_mean = state.pars + (eps / 2.0) * state.drift

        noise = jax.random.normal(k_prop, state.pars.shape, dtype=dtype)
        proposed = pars_mean + jnp.sqrt(eps) * solve_triangular(
            L.T, noise, lower=False)

        plp, pgrad, pG, pdG = model.evalalldt(proposed)
        pL, p_drift = _geometry(pgrad, pG, pdG)

        # log q up to the common -d/2 log eps (cancels in the ratio);
        # diff' G diff = ||L' diff||^2 — see samplers/smmala.py
        diff = pars_mean - proposed
        prob_new_given_old = (
            _logdet_chol(L) - 0.5 / eps * jnp.sum((L.T @ diff) ** 2))

        rev_mean = proposed + (eps / 2.0) * p_drift
        rdiff = rev_mean - state.pars
        prob_old_given_new = (
            _logdet_chol(pL) - 0.5 / eps * jnp.sum((pL.T @ rdiff) ** 2))

        ratio = plp + prob_old_given_new - state.logtarget - prob_new_given_old
        accept = metropolis_accept(k_acc, ratio)

        new_pars = jnp.where(accept, proposed, state.pars)
        new_lp = jnp.where(accept, plp, state.logtarget)
        new_grad = jnp.where(accept, pgrad, state.grad)
        new_chol = jnp.where(accept, pL, state.chol)
        new_drift = jnp.where(accept, p_drift, state.drift)

        tune = tuner_update(self.tuner, state.tune, state.i, accept, ctx.burnin)

        info = {
            "ppars": new_pars,
            "plogtarget": new_lp,
            "pgrads": new_grad,
            "pars": state.pars,
            "logtarget": state.logtarget,
            "grads": state.grad,
            "accept": accept,
        }
        return (
            PMALAState(pars=new_pars, logtarget=new_lp, grad=new_grad,
                       chol=new_chol, drift=new_drift, tune=tune,
                       i=state.i + 1),
            info,
        )
