"""Affine-invariant ensemble sampler (Goodman & Weare 2010) — batched
stretch moves, the parallel red-black scheme of emcee (Foreman-Mackey et
al. 2013).  Beyond the reference's capability set (its only ensemble
runners are SeqMC particles and tempering ladders, SURVEY §2.4); included
because the walker ensemble is the ideal batched shape: W walkers advance as
one (W, d) batch with two half-ensemble updates per step — every walker
identical control flow, one vmapped ``model.eval`` per half, no gradients,
no tuning, and affine invariance makes it immune to the badly-scaled /
correlated targets that force mass-matrix adaptation elsewhere.

Move: for walker x_k in the active half, pick partner x_j from the other
half, draw z ~ g(z) ∝ 1/sqrt(z) on [1/a, a] (inverse-CDF:
z = ((a-1)u + 1)^2 / a), propose y = x_j + z (x_k - x_j), accept with
log-prob (d-1) log z + logp(y) - logp(x_k).

Composition: ``run(model * AIES(steps=..., walkers=...))`` — no sampler
slot (the move IS the sampler); returns a list of per-walker chains (the
same surface as ``prun`` / ``PTMC(walkers=W)``).
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.chain import MCMCChain
from ..core.task import MCMCTask
from ..utils.table import Table


@dataclasses.dataclass(frozen=True)
class AIES:
    """Affine-invariant ensemble runner config.

    ``walkers`` must be even and at least 2*(d+1) for a non-degenerate
    complementary ensemble (checked against the model at run time);
    ``a`` is the stretch-scale (acceptance falls as ``a`` grows).
    """

    steps: int = 1000
    burnin: int = 0
    walkers: int = 64
    a: float = 2.0
    jitter: float = 0.5  # initial walker ball radius (times model.scale)

    # the stretch move is its own sampler: model * AIES is a complete task
    _samplerless_runner = True

    def __post_init__(self):
        assert self.steps > self.burnin >= 0
        assert self.walkers >= 4 and self.walkers % 2 == 0, (
            "walkers must be even and >= 4"
        )
        assert self.a > 1.0, "stretch scale a must be > 1"

    def __rmul__(self, model):
        # model * AIES(...): the stretch move is the sampler, so the product
        # is already a complete task (sampler slot empty)
        return MCMCTask(model, None, self)


@partial(jax.jit, static_argnames=("model_eval", "steps", "a", "d"))
def _aies_scan(model_eval, pars, lp, key, *, steps, a, d):
    """(W, d) ensemble advanced ``steps`` red-black sweeps."""
    W = pars.shape[0]
    H = W // 2
    evalb = jax.vmap(model_eval)

    def half(pars, lp, lo, k):
        """Update walkers [lo:lo+H) using the complementary half."""
        kz, kj, ku = jax.random.split(k, 3)
        act = jax.lax.dynamic_slice_in_dim(pars, lo, H, axis=0)
        lp_act = jax.lax.dynamic_slice_in_dim(lp, lo, H, axis=0)
        oth = jax.lax.dynamic_slice_in_dim(pars, (lo + H) % W, H, axis=0)

        u = jax.random.uniform(kz, (H,), dtype=pars.dtype)
        z = ((a - 1.0) * u + 1.0) ** 2 / a
        j = jax.random.randint(kj, (H,), 0, H)
        anchor = oth[j]
        prop = anchor + z[:, None] * (act - anchor)
        lp_prop = evalb(prop)
        ratio = (d - 1) * jnp.log(z) + lp_prop - lp_act
        ratio = jnp.where(jnp.isnan(ratio), -jnp.inf, ratio)
        logu = jnp.log(jax.random.uniform(ku, (H,), dtype=pars.dtype))
        acc = (ratio > 0) | (ratio > logu)

        new_act = jnp.where(acc[:, None], prop, act)
        new_lp = jnp.where(acc, lp_prop, lp_act)
        pars = jax.lax.dynamic_update_slice_in_dim(pars, new_act, lo, axis=0)
        lp = jax.lax.dynamic_update_slice_in_dim(lp, new_lp, lo, axis=0)
        return pars, lp, acc

    def one_step(carry, k):
        pars, lp = carry
        k1, k2 = jax.random.split(k)
        pars, lp, acc1 = half(pars, lp, 0, k1)
        pars, lp, acc2 = half(pars, lp, H, k2)
        out = {
            "ppars": pars,
            "plogtarget": lp,
            "accept": jnp.concatenate([acc1, acc2]),
        }
        return (pars, lp), out

    keys = jax.random.split(key, steps)
    (pars, lp), ys = jax.lax.scan(one_step, (pars, lp), keys)
    return (pars, lp), ys


def run_aies(model, runner: AIES, seed: int = 0, key=None,
             _carry_state=None, _pos=0):
    """Run the stretch-move ensemble; returns one chain per walker.

    ``_carry_state``: a ``(pars (W, d), lp (W,))`` ensemble to continue from
    (the resume path) instead of a fresh init ball."""
    t0 = time.time()
    if key is None:
        key = jax.random.PRNGKey(seed)
    key, k_init, k_run = jax.random.split(key, 3)

    W, d = runner.walkers, model.size
    assert W >= 2 * (d + 1), (
        f"AIES needs walkers >= 2*(d+1) = {2 * (d + 1)} for a {d}-D model "
        f"(complementary half must span the space); got {W}"
    )
    if _carry_state is not None:
        pars0, lp0 = (jnp.asarray(_carry_state[0]),
                      jnp.asarray(_carry_state[1]))
        assert pars0.shape == (W, d), (
            f"carried ensemble shape {pars0.shape} != (walkers, d) = "
            f"({W}, {d})")
    else:
        scale = jnp.broadcast_to(
            jnp.asarray(model.scale, dtype=model.init.dtype), (d,))
        pars0 = model.init + runner.jitter * scale * jax.random.normal(
            k_init, (W, d), dtype=model.init.dtype
        )
        lp0 = jax.vmap(model.eval)(pars0)

    (pars, lp), ys = _aies_scan(
        model.eval, pars0, lp0, k_run, steps=runner.steps, a=runner.a, d=d
    )

    keep = slice(runner.burnin, None)
    cn = model.column_names()
    samples = np.asarray(ys["ppars"])  # (steps, W, d), one bulk transfer
    accept = np.asarray(ys["accept"])
    logtarget = np.asarray(ys["plogtarget"])
    pars_h, lp_h = np.asarray(pars), np.asarray(lp)

    def one_chain(w):
        task = MCMCTask(model, None, runner,
                        state=(jnp.asarray(pars_h), jnp.asarray(lp_h)),
                        key=key, pos=_pos + runner.steps)
        return MCMCChain(
            range=range(runner.burnin + 1, runner.steps + 1),
            samples=Table(samples[keep, w], cn),
            gradients=Table(np.zeros((0, d)), cn),
            diagnostics={
                "accept": accept[keep, w],
                "logtarget": logtarget[keep, w],
            },
            task=task,
            run_time=time.time() - t0,
        )

    return [one_chain(w) for w in range(W)]


def resume_aies(task: MCMCTask, steps: int = 100):
    """Exact continuation of the whole walker ensemble (the task of every
    per-walker chain carries the full ``(pars, lp)`` ensemble state — the
    ensemble moves together, so resuming any chain resumes all walkers).
    Returns the full list of per-walker chains, like :func:`run_aies`."""
    assert isinstance(task.runner, AIES)
    assert task.state is not None, "AIES task has no stored ensemble state"
    runner = dataclasses.replace(task.runner, steps=steps, burnin=0)
    return run_aies(task.model, runner,
                    key=jax.random.fold_in(task.key, task.pos),
                    _carry_state=task.state, _pos=task.pos)
