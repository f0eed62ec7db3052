"""Simplified manifold MALA (reference: src/samplers/SMMALA.jl).

Drift ``(eps/2) G^{-1} grad``, proposal covariance ``eps G^{-1}``,
position-dependent q-ratio with log-det terms (SMMALA.jl:81-100).  Requires
gradient + metric tensor.

Batched layout: the reference recomputes ``inv(G)`` and a
Cholesky of ``eps G^{-1}`` for BOTH endpoints every step (SMMALA.jl:81-100).
Here the current point's factorization is *carried in the state* (it was
already computed when that point was the proposal), and all dense linear
algebra rides ONE Cholesky of the proposed ``G`` plus triangular solves:

- drift       ``G^{-1} grad = L^{-T} L^{-1} grad``   (two triangular solves)
- sampling    ``x ~ N(0, G^{-1})``: ``x = L^{-T} z`` (one triangular solve;
  ``L^{-T} L^{-1} = G^{-1}`` — any square root works for sampling)
- q-density   ``diff' G diff = ||L' diff||^2`` and
  ``log det(eps G^{-1}) = d log eps - 2 sum log diag L`` (the common
  ``d/2 log eps`` term cancels between the forward/reverse densities and
  is dropped)

Per transition: one ``evalallt`` + one batched ``cholesky`` + O(d^2)
triangular work, vs one ``evalallt`` + two ``inv`` + two ``cholesky`` in
the reference's layout.  Its speed on the GPU is not measured
(benchmarks/benchunits/manifold.py times it).
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


@pytree_dataclass
class SMMALAState:
    pars: jnp.ndarray
    logtarget: jnp.ndarray
    grad: jnp.ndarray
    chol: jnp.ndarray   # lower Cholesky factor of G(pars)
    drift: jnp.ndarray  # G(pars)^{-1} grad
    tune: TuneState
    i: jnp.ndarray


def _logdet_chol(L):
    return jnp.sum(jnp.log(jnp.diagonal(L)))


def _chol_drift(G, grad):
    """(L, G^{-1} grad) from one Cholesky + two triangular solves."""
    L = jnp.linalg.cholesky(G)
    drift = solve_triangular(
        L.T, solve_triangular(L, grad, lower=True), lower=False)
    return L, drift


def chol_inverse(L):
    """``G^{-1}`` from the lower Cholesky factor of ``G`` (two triangular
    solves against the identity — shared by the manifold family in place
    of ``jnp.linalg.inv``)."""
    eye = jnp.eye(L.shape[0], dtype=L.dtype)
    return solve_triangular(
        L.T, solve_triangular(L, eye, lower=True), lower=False)


@dataclasses.dataclass(frozen=True, repr=False)
class SMMALA(Sampler):
    scale: float = 1.0  # driftStep
    tuner: Optional[EmpMCTuner] = None

    needs_gradient = True
    needs_tensor = True

    def __post_init__(self):
        assert self.scale > 0, "SMMALA drift step should be > 0"

    def init(self, model, theta0, key):
        lp, g, G = model.evalallt(theta0)
        L, drift = _chol_drift(G, g)
        return SMMALAState(
            pars=theta0, logtarget=lp, grad=g, chol=L, drift=drift,
            tune=tuner_init(self.scale),
            i=jnp.asarray(1, dtype=jnp.int32),
        )

    def reset(self, model, state, theta):
        lp, g, G = model.evalallt(theta)
        L, drift = _chol_drift(G, g)
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

        # proposal ~ N(pars_mean, eps G^{-1}) via x = sqrt(eps) L^{-T} z
        noise = jax.random.normal(k_prop, state.pars.shape, dtype=dtype)
        proposed = pars_mean + jnp.sqrt(eps) * solve_triangular(
            L.T, noise, lower=False)

        plp, pgrad, pG = model.evalallt(proposed)
        pL, p_drift = _chol_drift(pG, pgrad)

        # log q up to the common -d/2 log eps (cancels in the ratio):
        # +logdet L - diff' (G / eps) diff / 2, with diff' G diff = |L'diff|^2
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
            SMMALAState(pars=new_pars, logtarget=new_lp, grad=new_grad,
                        chol=new_chol, drift=new_drift,
                        tune=tune, i=state.i + 1),
            info,
        )
