"""Common sampler machinery.

The reference implements every sampler as an infinite Julia coroutine
(``SamplerTask``) that ``produce``s ``MCMCSample`` records and is resumed by
the runner's ``consume`` loop (reference: src/samplers/samplers.jl:10-53).
Under JAX the coroutine substrate disappears (SURVEY §3.1): a sampler is a pure
transition kernel

    ``init(model, theta0, key) -> state``          (pytree)
    ``step(model, ctx, state, key) -> (state, info)``

that the runners drive under ``jax.lax.scan`` and batch across chains with
``vmap``.  ``info`` plays the role of ``MCMCSample`` + its diagnostics dict
(samplers.jl:10-29): a flat dict of arrays with static structure so the scan
carry/ys stay shape-stable.

The "remote reset" hook the ensemble runners rely on
(``t.task.storage[:reset]``, reference src/MCMC.jl:39) becomes the functional
:meth:`Sampler.reset`: replace the position in the state pytree and refresh
cached logp/grads — no live-coroutine surgery needed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp


def pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree (all fields are leaves)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]

    def flatten(d):
        return tuple(getattr(d, f) for f in fields), None

    def unflatten(aux, children):
        return cls(*children)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    cls.replace = dataclasses.replace
    return cls


@dataclasses.dataclass(frozen=True)
class RunCtx:
    """Static per-run context handed to ``step`` (burn-in length for
    adaptation gating — the role runner.burnin plays in e.g. HMC.jl:167)."""

    burnin: int = 0


def metropolis_accept(key, ratio):
    """The reference's accept test ``ratio > 0 || ratio > log(rand())``
    (e.g. RWM.jl:63), made NaN-safe: a NaN ratio (e.g. -inf - -inf) rejects."""
    u = jnp.log(jax.random.uniform(key, (), dtype=ratio.dtype))
    return jnp.where(jnp.isnan(ratio), False, (ratio > 0) | (ratio > u))


def mh_select(accept, proposed, current):
    """Select proposed/current pytree fields elementwise on acceptance
    (the `if accepted` branch of every reference sampler, as a select)."""
    return jax.tree_util.tree_map(
        lambda p, c: jnp.where(accept, p, c), proposed, current
    )


class Sampler:
    """Base sampler configuration (hyper-parameters are static)."""

    #: capability requirements checked against the model
    needs_gradient = False
    needs_tensor = False
    needs_dtensor = False

    def check(self, model):
        name = type(self).__name__
        if self.needs_gradient and not model.hasgradient:
            raise ValueError(f"{name} sampler requires model with gradient function")
        if self.needs_tensor and not model.hastensor:
            raise ValueError(f"{name} sampler requires model with tensor function")
        if self.needs_dtensor and not model.hasdtensor:
            raise ValueError(
                f"{name} sampler requires model with function of tensor derivatives"
            )

    # -- protocol ----------------------------------------------------------
    def init(self, model, theta0, key):
        raise NotImplementedError

    def step(self, model, ctx: RunCtx, state, key):
        raise NotImplementedError

    def reset(self, model, state, theta):
        """Functional replacement of the coroutine reset hook (MCMC.jl:39)."""
        raise NotImplementedError

    # -- composition sugar: model * sampler * runner ------------------------
    def __rmul__(self, other):
        from ..core.task import product

        return product(other, self)

    def __repr__(self):
        if dataclasses.is_dataclass(self):
            args = ", ".join(
                f"{f.name}={getattr(self, f.name)!r}" for f in dataclasses.fields(self)
            )
            return f"{type(self).__name__}({args})"
        return type(self).__name__


# =========================================================================
# Empirical tuner (reference samplers.jl:31-50) — shared by MALA/HMC/manifold
# =========================================================================


@dataclasses.dataclass(frozen=True)
class EmpMCTuner:
    """Empirical burn-in tuner: every ``adapt_step`` iterations rescale the
    step by a logistic factor of the realized acceptance rate
    (reference samplers.jl:31-50; adapt rule MALA.jl:36-39 / HMC.jl:37-43)."""

    target_rate: float
    adapt_step: int = 100
    max_step: int = 200
    target_path: float = 1.0
    verbose: bool = False

    def __post_init__(self):
        assert self.adapt_step > 0, "Adaptation step size should be > 0"
        assert self.max_step > 0, "Max step should be > 0"
        assert 0 < self.target_rate < 1, "Target acceptance rate should be in (0, 1)"


@pytree_dataclass
class TuneState:
    """Carried adaptation counters (EmpiricalMALATune / EmpiricalHMCTune)."""

    step_size: jnp.ndarray  # driftStep or leapStep
    n_leaps: jnp.ndarray  # int; unused by MALA-family
    accepted: jnp.ndarray  # int
    proposed: jnp.ndarray  # int


def tuner_init(step_size, n_leaps=1):
    return TuneState(
        step_size=jnp.asarray(step_size, dtype=jnp.result_type(float)),
        n_leaps=jnp.asarray(n_leaps, dtype=jnp.int32),
        accepted=jnp.asarray(0, dtype=jnp.int32),
        proposed=jnp.asarray(0, dtype=jnp.int32),
    )


def tuner_update(tuner: Optional[EmpMCTuner], tune: TuneState, i, accepted, burnin,
                 with_leaps=False):
    """One post-step tuner transition.

    Increments counters, and — when ``i <= burnin`` and ``i % adapt_step == 0``
    — applies the logistic step-size update
    ``step *= 1/(1+exp(-11*(rate-target))) + 0.5`` and (for HMC-family)
    ``n_leaps = min(max_step, ceil(target_path / step))``, then zeroes the
    counters (reference MALA.jl:36-43, HMC.jl:37-47, usage HMC.jl:167-173).
    """
    if tuner is None:
        return tune
    acc = tune.accepted + accepted.astype(jnp.int32)
    prop = tune.proposed + 1
    do_adapt = (i <= burnin) & (jnp.mod(i, tuner.adapt_step) == 0)
    rate = acc / jnp.maximum(prop, 1)
    factor = 1.0 / (1.0 + jnp.exp(-11.0 * (rate - tuner.target_rate))) + 0.5
    new_step = jnp.where(do_adapt, tune.step_size * factor, tune.step_size)
    if with_leaps:
        new_leaps = jnp.where(
            do_adapt,
            jnp.minimum(
                tuner.max_step, jnp.ceil(tuner.target_path / new_step)
            ).astype(jnp.int32),
            tune.n_leaps,
        )
    else:
        new_leaps = tune.n_leaps
    zero = jnp.asarray(0, dtype=jnp.int32)
    return TuneState(
        step_size=new_step,
        n_leaps=new_leaps,
        accepted=jnp.where(do_adapt, zero, acc),
        proposed=jnp.where(do_adapt, zero, prop),
    )
