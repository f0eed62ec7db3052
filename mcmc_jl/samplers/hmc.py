"""Hamiltonian Monte Carlo (reference: src/samplers/HMC.jl).

The leapfrog x ``evalallg`` loop is >95% of HMC runtime (SURVEY §3.2) and is
the framework's primary performance kernel: here it is a ``lax.fori_loop``
of fused XLA ops (one ``value_and_grad`` per leapfrog), vmappable over
thousands of chains; a whole-trajectory GPU kernel for ``model(glm=...)``
posteriors lives in :mod:`mcmc_jl.ops.pallas_glm`.

Semantics matched to the reference:
- leapfrog update (HMC.jl:93-102), Hamiltonian ``-logp + |m|^2/2`` (HMC.jl:91)
- accept test ``rand() < exp(H0 - H)`` (HMC.jl:154)
- optional EmpMCTuner adapting (leapStep, nLeaps) during burn-in
  (HMC.jl:37-47, 167-173)
- ``store_leaps`` records the whole trajectory for Rao-Blackwellized means
  (HMC.jl:144-151) — as shape-static (n_leaps+1) buffers of (pars, H).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from .base import (
    EmpMCTuner, RunCtx, Sampler, TuneState, metropolis_accept,
    pytree_dataclass, tuner_init, tuner_update,
)
from .massadapt import (
    MassAccum, dense_transforms, mass_init, mass_kind, mass_update,
    mass_vector_scale,
)


# canonical home of the integrator family (leapfrog + BCSS multi-stage);
# re-exported here because hmcda/nuts import from hmc
from .integrators import get_integrator, hamiltonian, leapfrog  # noqa: F401


@pytree_dataclass
class HMCState:
    pars: jnp.ndarray
    logtarget: jnp.ndarray
    grad: jnp.ndarray
    tune: TuneState
    i: jnp.ndarray
    # Mass-matrix warmup accumulators (massadapt.py): diagonal Welford
    # (mass_adapt=True/"diag"), Stan-style windowed diagonal ("diag-win") or
    # windowed dense metric ("dense").  Beyond the reference, whose only
    # preconditioning is the static model.scale hint.
    mass: MassAccum

    # back-compat accessors for the original flat Welford fields
    @property
    def w_count(self):
        return self.mass.count

    @property
    def w_mean(self):
        return self.mass.mean

    @property
    def w_m2(self):
        return self.mass.m2


@dataclasses.dataclass(frozen=True, repr=False)
class HMC(Sampler):
    n_leaps: int = 10
    leap_step: float = 0.1
    store_leaps: bool = False
    tuner: Optional[EmpMCTuner] = None
    #: False | True/"diag" (continuous Welford) | "diag-win" | "dense"
    mass_adapt: object = False
    #: "leapfrog" (reference parity) | "2stage" | "3stage" — BCSS
    #: minimum-error splitting schemes (samplers/integrators.py); n_leaps
    #: counts macro steps, each costing 1/2/3 gradient evaluations
    integrator: str = "leapfrog"

    needs_gradient = True

    def __init__(self, *args, n_leaps=None, leap_step=None, store_leaps=None,
                 tuner=None, init=None, scale=None, leaps=None,
                 mass_adapt=False, integrator="leapfrog"):
        """Positional-convenience constructors mirroring the reference's
        overloads (HMC.jl:70-80): ``HMC()``, ``HMC(n)``, ``HMC(eps)``,
        ``HMC(n, eps)``, trailing tuner allowed; plus the kwargs form
        ``HMC(init=10, scale=0.1, leaps=False, tuner=None)``."""
        pos = list(args)
        if pos and isinstance(pos[-1], EmpMCTuner):
            assert tuner is None
            tuner = pos.pop()
        for a in pos:
            if isinstance(a, bool):
                assert store_leaps is None
                store_leaps = a
            elif isinstance(a, int):
                assert n_leaps is None
                n_leaps = a
            elif isinstance(a, float):
                assert leap_step is None
                leap_step = a
            else:
                raise TypeError(f"unexpected HMC argument {a!r}")
        n_leaps = n_leaps if n_leaps is not None else (init if init is not None else 10)
        leap_step = leap_step if leap_step is not None else (
            scale if scale is not None else 0.1
        )
        store_leaps = store_leaps if store_leaps is not None else (
            leaps if leaps is not None else False
        )
        assert n_leaps > 0, "inner steps should be > 0"
        assert leap_step > 0, "inner steps scaling should be > 0"
        object.__setattr__(self, "n_leaps", int(n_leaps))
        object.__setattr__(self, "leap_step", float(leap_step))
        object.__setattr__(self, "store_leaps", bool(store_leaps))
        object.__setattr__(self, "tuner", tuner)
        mass_kind(mass_adapt)  # validate early
        object.__setattr__(self, "mass_adapt", mass_adapt)
        get_integrator(integrator)  # validate early
        object.__setattr__(self, "integrator", integrator)

    @property
    def _kind(self):
        return mass_kind(self.mass_adapt)

    # -- protocol ----------------------------------------------------------
    def init(self, model, theta0, key):
        lp, g = model.evalallg(theta0)
        return HMCState(
            pars=theta0, logtarget=lp, grad=g,
            tune=tuner_init(self.leap_step, self.n_leaps),
            i=jnp.asarray(1, dtype=jnp.int32),
            mass=mass_init(self._kind, theta0.shape[0], theta0.dtype),
        )

    def reset(self, model, state, theta):
        lp, g = model.evalallg(theta)
        return state.replace(pars=theta, logtarget=lp, grad=g)

    def _max_leaps(self):
        return self.tuner.max_step if self.tuner is not None else self.n_leaps

    def step(self, model, ctx: RunCtx, state, key):
        k_mom, k_acc = jax.random.split(key)
        dtype = state.pars.dtype
        if self.tuner is not None:
            eps = state.tune.step_size.astype(dtype)
            nl = state.tune.n_leaps
        else:
            eps = jnp.asarray(self.leap_step, dtype=dtype)
            nl = jnp.asarray(self.n_leaps, dtype=jnp.int32)
        kind = self._kind
        if kind == "dense":
            # standardized coordinates theta = L z (unit-metric dynamics in z
            # == dense inverse-mass Sigma-hat = L L' in theta)
            import types

            L = state.mass.scale.astype(dtype)
            fwd, inv, gfwd, ginv = dense_transforms(L)
            work_model = types.SimpleNamespace(
                evalallg=lambda z: (lambda lp_g: (lp_g[0], gfwd(lp_g[1])))(
                    model.evalallg(fwd(z))
                )
            )
            pars0, grad0 = inv(state.pars), gfwd(state.grad)
        else:
            if kind is not None:
                # vector leapfrog step = eps * scale: diagonal mass
                # preconditioning folded into the integrator
                eps = eps * mass_vector_scale(kind, state.mass, dtype)
            work_model = model
            pars0, grad0 = state.pars, state.grad

        m0 = jax.random.normal(k_mom, state.pars.shape, dtype=dtype)
        H0 = hamiltonian(state.logtarget, m0)
        step_fn, _ = get_integrator(self.integrator)

        if not self.store_leaps:
            def body(j, carry):
                pars, lp, g, m = carry
                return step_fn(work_model, pars, m, g, eps)

            pars, lp, g, m = jax.lax.fori_loop(
                0, nl, body, (pars0, state.logtarget, grad0, m0)
            )
            extra = {}
        else:
            max_leaps = self._max_leaps()

            def sbody(carry, j):
                pars, lp, g, m = carry
                new = step_fn(work_model, pars, m, g, eps)
                carry2 = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(j < nl, b, a), carry, new
                )
                p2, lp2, g2, m2 = carry2
                return carry2, (p2, hamiltonian(lp2, m2))

            (pars, lp, g, m), (traj_pars, traj_H) = jax.lax.scan(
                sbody,
                (pars0, state.logtarget, grad0, m0),
                jnp.arange(max_leaps),
            )
            if kind == "dense":  # trajectories back to theta-space
                traj_pars = traj_pars @ L.T
            extra = {
                "leaps_pars": jnp.concatenate([state.pars[None], traj_pars], axis=0),
                "leaps_H": jnp.concatenate([H0[None], traj_H], axis=0),
                # live trajectory length: with a tuner, rows past nl are
                # frozen endpoint copies that mean_rb must mask out
                "leaps_n": jnp.asarray(nl, jnp.int32),
            }
        if kind == "dense":  # back to theta-space
            pars, g = fwd(pars), ginv(g)

        H = hamiltonian(lp, m)
        ratio = H0 - H
        accept = metropolis_accept(k_acc, ratio)

        new_pars = jnp.where(accept, pars, state.pars)
        new_lp = jnp.where(accept, lp, state.logtarget)
        new_grad = jnp.where(accept, g, state.grad)

        tune = tuner_update(self.tuner, state.tune, state.i, accept, ctx.burnin,
                            with_leaps=True)

        # mass-warmup accumulator transition on the post-accept position
        mass = mass_update(kind, state.mass, new_pars, state.i, ctx.burnin)

        info = {
            "ppars": new_pars,
            "plogtarget": new_lp,
            "pgrads": new_grad,
            "pars": state.pars,
            "logtarget": state.logtarget,
            "grads": state.grad,
            "accept": accept,
            **extra,
        }
        return (
            HMCState(pars=new_pars, logtarget=new_lp, grad=new_grad, tune=tune,
                     i=state.i + 1, mass=mass),
            info,
        )
