"""ChEES-HMC: cross-chain adaptive trajectory lengths (beyond the reference).

Hoffman, Radul & Sountsov 2021, "An Adaptive-MCMC Scheme for Setting
Trajectory Lengths in Hamiltonian Monte Carlo" (AISTATS).  The reference
package's only dynamic-length sampler is NUTS (src/samplers/NUTS.jl), whose
per-chain recursive tree building is the worst possible shape for a SIMD
machine: under vmap every chain pays for the deepest tree in the batch.
ChEES is the SIMD-friendly alternative: ALL chains run plain fixed-step
leapfrog trajectories of ONE shared, jittered length, and the length is
adapted from cross-chain statistics — maximizing the Change in the
Estimator of the Expected Square jump distance

    ChEES = (1/4) E[ (||q' - E q'||^2 - ||q - E q||^2)^2 ]

by stochastic gradient ascent (Adam) on log trajectory time, while the step
size is dual-averaged (Hoffman-Gelman constants, as NUTS.jl:121-125) on the
POOLED mean acceptance probability.  Because every chain executes the same
instruction stream, throughput matches plain HMC; the cross-chain reductions
are two tiny `mean`s that XLA lowers to psum when the chain axis is sharded
over a mesh.

Adaptation runs through the engine-level pooling hook
(:func:`mcmc_jl.parallel.pchains._scan_chains` calls ``sampler.pool``
after each vmapped step), i.e. under ``run(task, chains=N)``, ``prun``, or
``run_chains``.  A single-chain `SerialMC` run still samples correctly but
keeps the init-heuristic step size and the initial trajectory length
(centered expected-square-jump statistics degenerate at one chain).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .base import RunCtx, Sampler, metropolis_accept, pytree_dataclass
from .hmcda import find_reasonable_step
from .integrators import get_integrator, hamiltonian
from .massadapt import (
    MassAccum, mass_init, mass_kind, mass_update, mass_vector_scale,
)


def halton2(i):
    """Radical-inverse base 2 of the integer step index — the paper's
    quasi-random jitter sequence for trajectory lengths (low-discrepancy,
    and identical across chains since it depends only on the step count)."""
    bits = jnp.arange(32)
    digits = (i.astype(jnp.uint32) >> bits.astype(jnp.uint32)) & 1
    return jnp.sum(digits * 0.5 ** (bits + 1.0))


@pytree_dataclass
class ChEESState:
    pars: jnp.ndarray
    logtarget: jnp.ndarray
    grad: jnp.ndarray
    # shared adapted scalars (identical across chains after pooling)
    leap_step: jnp.ndarray        # current eps (dual-averaging iterate)
    dual_leap_step: jnp.ndarray   # exp(log eps-bar): frozen post-burn-in eps
    dual_h: jnp.ndarray           # dual-averaging error accumulator
    mu: jnp.ndarray               # log(10 * eps0)
    log_len: jnp.ndarray          # log total integration time T
    adam_m: jnp.ndarray           # Adam first moment for log_len
    adam_v: jnp.ndarray           # Adam second moment for log_len
    i: jnp.ndarray
    # diagonal mass-matrix warmup accumulator (massadapt.py); ChEES measures
    # jump distances in theta-space, which stays valid under the folded
    # per-coordinate preconditioning (velocity rescaled accordingly)
    mass: MassAccum
    # per-step stash read by the cross-chain pool hook (carried, not stacked)
    p_prev: jnp.ndarray           # q   (position before the step)
    p_prop: jnp.ndarray           # q'  (trajectory endpoint, pre-MH)
    p_vel: jnp.ndarray            # dq'/dt (final momentum, unit mass)
    p_alpha: jnp.ndarray          # min(1, exp(H0-H))
    p_time: jnp.ndarray           # realized integration time n_leaps * eps


@dataclasses.dataclass(frozen=True, repr=False)
class ChEESHMC(Sampler):
    rate: float = 0.651           # pooled-acceptance target for dual averaging
    len0: float = 1.0             # initial total integration time T
    max_leaps: int = 1024         # hard cap on leapfrogs per step (device safety)
    lr: float = 0.025             # Adam learning rate on log T
    #: work-normalization exponent: ascend log(ChEES) - cost_penalty*log(T).
    #: Beyond the optimum the raw criterion goes flat in T, so pure ascent
    #: (cost_penalty=0, the paper's form) random-walks into over-rotated
    #: trajectories that burn gradients without ESS gain; penalizing by the
    #: per-transition cost (linear in T) restores a stationary optimum at
    #: "largest relative ESJD gain per extra gradient" (measured on the
    #: logistic 10x1000 posterior: T converges ~0.5 instead of drifting to
    #: 3.3, 5x fewer gradients per effective sample)
    cost_penalty: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    shrinkage: float = 0.05       # dual-averaging gamma (NUTS.jl:121-125)
    t0: float = 10.0
    step_pow: float = 0.75        # kappa
    integrator: str = "leapfrog"  # "leapfrog" | "2stage" | "3stage"
    #: False | True/"diag" (continuous Welford) | "diag-win" (Stan windows);
    #: the dense metric is not offered here (the criterion would need the
    #: standardized-coordinate transform of hmc.py's dense path)
    mass_adapt: object = False

    needs_gradient = True

    def __post_init__(self):
        assert 0.0 < self.rate < 1.0, "target acceptance rate should be in (0, 1)"
        assert self.len0 > 0, "len0 must be positive"
        assert self.max_leaps > 0, "max_leaps must be positive"
        get_integrator(self.integrator)  # validate early
        if mass_kind(self.mass_adapt) == "dense":
            raise ValueError("ChEESHMC supports mass_adapt False/'diag'/"
                             "'diag-win' (dense not offered)")

    @property
    def _kind(self):
        return mass_kind(self.mass_adapt)

    # -- protocol ----------------------------------------------------------
    def init(self, model, theta0, key):
        lp, g = model.evalallg(theta0)
        m = jax.random.normal(key, theta0.shape, dtype=theta0.dtype)
        eps = find_reasonable_step(model, theta0, lp, g, m, key)
        f = lambda v: jnp.asarray(v, dtype=theta0.dtype)
        return ChEESState(
            pars=theta0, logtarget=lp, grad=g,
            leap_step=eps,
            dual_leap_step=eps,   # sane unadapted fallback (vs HMCDA's 1.0)
            dual_h=f(0.0),
            mu=jnp.log(10.0 * eps),
            log_len=jnp.log(f(self.len0)),
            adam_m=f(0.0), adam_v=f(0.0),
            i=jnp.asarray(1, dtype=jnp.int32),
            mass=mass_init(self._kind, theta0.shape[0], theta0.dtype),
            p_prev=theta0, p_prop=theta0, p_vel=jnp.zeros_like(theta0),
            p_alpha=f(0.0), p_time=f(0.0),
        )

    def reset(self, model, state, theta):
        lp, g = model.evalallg(theta)
        return state.replace(pars=theta, logtarget=lp, grad=g)

    def step(self, model, ctx: RunCtx, state, key):
        k_mom, k_acc = jax.random.split(key)
        dtype = state.pars.dtype

        in_warm = state.i <= ctx.burnin
        eps = jnp.where(in_warm, state.leap_step, state.dual_leap_step)
        T = jnp.exp(state.log_len)
        u = halton2(state.i).astype(dtype)
        t_target = u * T
        nl = jnp.clip(jnp.ceil(t_target / eps), 1, self.max_leaps).astype(jnp.int32)

        kind = self._kind
        if kind is not None:
            # per-coordinate preconditioning folded into the integrator
            # (vector step = eps * scale); T keeps counting scalar-eps time
            svec = mass_vector_scale(kind, state.mass, dtype)
            eps_step = eps * svec
        else:
            svec = None
            eps_step = eps

        m0 = jax.random.normal(k_mom, state.pars.shape, dtype=dtype)
        H0 = hamiltonian(state.logtarget, m0)
        step_fn, _ = get_integrator(self.integrator)

        def body(j, carry):
            pars, lp, g, m = carry
            return step_fn(model, pars, m, g, eps_step)

        pars, lp, g, m = jax.lax.fori_loop(
            0, nl, body, (state.pars, state.logtarget, state.grad, m0)
        )
        H = hamiltonian(lp, m)
        ratio = H0 - H
        alpha = jnp.where(
            jnp.isnan(ratio), 0.0,
            jnp.exp(jnp.minimum(ratio, 0.0)),
        ).astype(dtype)
        accept = metropolis_accept(k_acc, ratio)

        new_pars = jnp.where(accept, pars, state.pars)
        new_lp = jnp.where(accept, lp, state.logtarget)
        new_grad = jnp.where(accept, g, state.grad)

        info = {
            "ppars": new_pars,
            "plogtarget": new_lp,
            "pgrads": new_grad,
            "pars": state.pars,
            "logtarget": state.logtarget,
            "grads": state.grad,
            "accept": accept,
            "alpha": alpha,
            "epsilon": eps,
            "nleaps": nl,
        }
        new_state = state.replace(
            pars=new_pars, logtarget=new_lp, grad=new_grad,
            i=state.i + 1,
            p_prev=state.pars, p_prop=pars, p_vel=m, p_alpha=alpha,
            p_time=nl.astype(dtype) * eps,
        )
        return new_state, info

    # -- cross-chain adaptation (engine pool hook) ---------------------------
    def pool(self, ctx: RunCtx, states, info):
        """One pooled adaptation transition on the batched (C, ...) states.

        Called by the multi-chain engine after every vmapped step.  The two
        chain-axis reductions (alpha-weighted proposal mean, plain current
        mean) become psum collectives when the chain axis is mesh-sharded.
        """
        dtype = states.log_len.dtype
        i = (states.i[0] - 1).astype(dtype)  # the step just completed
        do = (states.i[0] - 1) <= ctx.burnin

        alpha = states.p_alpha                     # (C,)
        q, qp, v = states.p_prev, states.p_prop, states.p_vel  # (C, d)
        wsum = jnp.maximum(jnp.sum(alpha), jnp.asarray(1e-20, dtype))
        w = alpha / wsum
        qbar = jnp.mean(q, axis=0)
        qpbar = jnp.sum(w[:, None] * qp, axis=0)
        qc2 = jnp.sum((q - qbar) ** 2, axis=1)
        qpc = qp - qpbar
        qpc2 = jnp.sum(qpc**2, axis=1)
        delta = qpc2 - qc2
        # ChEES = (1/4) E[delta^2]; d/d(logT) uses dq'/d(logT) = t * v'
        chees = jnp.sum(w * delta**2) / 4.0
        dchees = jnp.sum(w * delta * jnp.sum(qpc * v, axis=1) * states.p_time) / 2.0
        # ascend log(ChEES) - cost_penalty * log(T): relative criterion gain
        # minus the (linear-in-T) gradient-evaluation cost
        grad = dchees / jnp.maximum(chees, 1e-20) - self.cost_penalty

        # Adam ascent on log trajectory time
        m_t = self.b1 * states.adam_m[0] + (1 - self.b1) * grad
        v_t = self.b2 * states.adam_v[0] + (1 - self.b2) * grad**2
        mhat = m_t / (1 - self.b1**i)
        vhat = v_t / (1 - self.b2**i)
        step = self.lr * mhat / (jnp.sqrt(vhat) + 1e-8)
        eps_now = states.leap_step[0]
        new_log_len = jnp.clip(
            states.log_len[0] + step,
            jnp.log(eps_now),
            jnp.log(self.max_leaps * eps_now),
        )

        # dual averaging of eps on the pooled mean acceptance probability
        abar = jnp.mean(alpha)
        h = (1.0 - 1.0 / (i + self.t0)) * states.dual_h[0] + (
            self.rate - abar
        ) / (i + self.t0)
        # mu is set per chain at init (jittered inits => slightly different
        # heuristic eps0); the pooled DA anchors on the cross-chain mean
        log_eps = jnp.mean(states.mu) - jnp.sqrt(i) / self.shrinkage * h
        eta = i**-self.step_pow
        log_ebar = eta * log_eps + (1.0 - eta) * jnp.log(states.dual_leap_step[0])

        def upd(new, old):
            return jnp.broadcast_to(jnp.where(do, new, old[0]), old.shape)

        return states.replace(
            leap_step=upd(jnp.exp(log_eps), states.leap_step),
            dual_leap_step=upd(jnp.exp(log_ebar), states.dual_leap_step),
            dual_h=upd(h, states.dual_h),
            log_len=upd(new_log_len, states.log_len),
            adam_m=upd(m_t, states.adam_m),
            adam_v=upd(v_t, states.adam_v),
        )
