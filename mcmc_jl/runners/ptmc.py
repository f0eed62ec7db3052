"""Parallel tempering (replica exchange) runner — fully batched.

The reference's tempering is *serial* (one walker hopping a task ladder,
SerialTempMC.jl); SURVEY §2.4 names the batched form: all rungs advance
simultaneously as one vmapped batch over an inverse-temperature ladder of
power posteriors ``logp_b(theta) = beta * logp(theta)``, with even/odd
neighbor swaps every ``swap_period`` steps done as an on-device permutation
(Metropolis on ``(beta_i - beta_j)(lp_j - lp_i)``).  One model, K replicas,
zero host round-trips — the whole run is a single ``lax.scan``.

Works with any sampler that uses ``model.eval`` / ``model.evalallg`` /
``model.scale`` (RWM, IMH, RAM, MALA, HMC, HMCDA, NUTS); the chain returned
is the cold rung (beta = 1, last ladder entry), with swap-acceptance
diagnostics.

With ``logprior=`` the ladder tempers only the likelihood part
(``logp_b = logprior + b*(logp - logprior)`` — Friel & Pettitt power
posteriors), which makes ``beta=0`` a proper target (the prior) and turns
the per-rung log-likelihood draws (``diagnostics["replica_ll"]``) into the
inputs of the marginal-likelihood estimators in ``stats/evidence.py``
(thermodynamic integration / stepping-stone) — capability absent from the
reference.
"""
from __future__ import annotations

import dataclasses
import time
import types
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.chain import MCMCChain
from ..core.task import MCMCTask
from ..samplers.base import RunCtx
from ..utils.table import Table


@dataclasses.dataclass(frozen=True)
class PTMC:
    """Parallel-tempering runner config.

    ``betas``: ascending inverse temperatures ending at 1.0 (the target).
    """

    steps: int = 1000
    burnin: int = 0
    swap_period: int = 5
    betas: Tuple[float, ...] = (0.1, 0.3, 0.6, 1.0)
    #: independent ladders run as one (walkers, K) batch — the fully
    #: vectorized tempering of SURVEY §2.4 / ROADMAP item 5; returns a list
    #: of cold-rung chains when > 1
    walkers: int = 1
    #: normalized log prior density theta -> logpi(theta).  When given, the
    #: ladder runs power posteriors ``logprior + beta*loglik`` (the prior is
    #: never tempered), beta=0 is allowed (it targets the prior), and
    #: ``diagnostics["replica_ll"]`` holds per-rung log-likelihood draws for
    #: stats.evidence.logz_ti / logz_ss.
    logprior: object = None

    def __post_init__(self):
        assert self.burnin >= 0
        assert self.steps > self.burnin
        assert self.swap_period >= 1
        assert self.walkers >= 1
        b = tuple(self.betas)
        assert len(b) >= 2 and all(x >= 0 for x in b), (
            "betas must be non-negative"
        )
        assert all(b[i] < b[i + 1] for i in range(len(b) - 1)), (
            "betas must be ascending"
        )
        assert abs(b[-1] - 1.0) < 1e-12, "last beta must be 1.0 (the target)"
        if b[0] == 0.0:
            assert self.logprior is not None, (
                "beta=0 targets the bare prior: it is only proper with "
                "prior tempering (pass logprior=)"
            )
        object.__setattr__(self, "betas", b)

    def __rmul__(self, other):
        from ..core.task import product

        return product(other, self)


def _tempered_view(model, beta, logprior=None):
    """A per-replica model view.

    Plain tempering: ``beta * logp``.  Prior tempering (``logprior`` given):
    the power posterior ``logprior + beta * (logp - logprior)`` — only the
    likelihood part is tempered, so beta=0 is the (proper) prior."""
    if logprior is None:
        def eval_(th):
            return beta * model.eval(th)

        def evalallg(th):
            lp, g = model.evalallg(th)
            return beta * lp, beta * g
    else:
        gprior = jax.grad(logprior)

        def eval_(th):
            return logprior(th) + beta * (model.eval(th) - logprior(th))

        def evalallg(th):
            lp, g = model.evalallg(th)
            pl, gp = logprior(th), gprior(th)
            return pl + beta * (lp - pl), gp + beta * (g - gp)

    return types.SimpleNamespace(
        eval=eval_,
        evalallg=None if model.evalallg is None else evalallg,
        scale=model.scale,
        size=model.size,
    )


@partial(jax.jit, static_argnames=("sampler", "ctx", "steps", "swap_period",
                                   "betas", "logprior"))
def _ptmc_scan(model, sampler, ctx, states, key, *, steps, swap_period, betas,
               logprior=None):
    K = len(betas)
    betas_v = jnp.asarray(betas, dtype=model.init.dtype)
    # beta=0 only occurs with prior tempering (PTMC.__post_init__); the
    # divide below is masked for that rung and its ll recomputed fresh
    beta_safe = jnp.where(betas_v > 0, betas_v, 1.0)
    has_b0 = logprior is not None and betas[0] == 0.0
    has_grad = hasattr(states, "grad")
    gprior = None if logprior is None else jax.grad(logprior)

    def step_one(state, k, beta):
        return sampler.step(_tempered_view(model, beta, logprior), ctx,
                            state, k)

    def untempered(states):
        """Per-rung (prior logp, tempered-part draws, tempered-part grads):
        plain tempering -> (0, logp, grad); prior tempering -> the
        log-likelihood and its gradient (Friel-Pettitt power posterior)."""
        lp_t = states.logtarget
        if logprior is None:
            pri = jnp.zeros_like(lp_t)
            gpri = None
        else:
            pri = jax.vmap(logprior)(states.pars)
            gpri = jax.vmap(gprior)(states.pars) if has_grad else None
        ll = (lp_t - pri) / beta_safe
        gll = None
        if has_grad:
            gpri_a = 0.0 if gpri is None else gpri
            gll = (states.grad - gpri_a) / beta_safe[:, None]
        if has_b0:
            # the beta=0 rung's cached logtarget is the prior alone: its
            # likelihood part must be evaluated fresh (one extra eval/step)
            if has_grad:
                lp0, g0 = model.evalallg(states.pars[0])
                gll = gll.at[0].set(g0 - gpri[0])
            else:
                lp0 = model.eval(states.pars[0])
            ll = ll.at[0].set(lp0 - pri[0])
        return pri, gpri, ll, gll

    def swap(states, k, parity, pri, gpri, ll, gll):
        """Even/odd neighbor exchange as a batched permutation."""
        idx = jnp.arange(K)
        is_left = (idx % 2) == parity
        partner = jnp.where(is_left, idx + 1, idx - 1)
        valid = (partner >= 0) & (partner < K)
        partner = jnp.clip(partner, 0, K - 1)

        # accept prob for the PAIR: (b_i - b_j)(ll_j - ll_i); computed
        # symmetrically so both members decide identically
        b_self = betas_v
        b_part = betas_v[partner]
        ratio = (b_self - b_part) * (ll[partner] - ll)
        u = jax.random.uniform(k, (K,), dtype=ll.dtype)
        # one uniform per pair: take the left member's draw
        pair_u = jnp.where(is_left, u, u[partner])
        acc = valid & (jnp.log(pair_u) < ratio)

        src = jnp.where(acc, partner, idx)
        # exchange positions + rebuild cached tempered quantities at own beta
        new_pars = states.pars[src]
        new_ll = ll[src]
        new_lp = pri[src] + betas_v * new_ll
        new_states = states.replace(pars=new_pars, logtarget=new_lp)
        if has_grad:
            gpri_a = 0.0 if gpri is None else gpri[src]
            new_states = new_states.replace(
                grad=gpri_a + betas_v[:, None] * gll[src]
            )
        if hasattr(states, "logcandidate"):
            # IMH caches log q(pars); q is temperature-independent, so the
            # cache swaps with the position (else the next IMH accept ratio
            # uses the partner's stale candidate density)
            new_states = new_states.replace(
                logcandidate=states.logcandidate[src]
            )
        swap_rate = jnp.sum(jnp.where(valid & acc, 1, 0)) / 2.0
        return new_states, new_ll, swap_rate

    def one_step(carry, inp):
        states, = carry
        i, k = inp
        k_step, k_swap = jax.random.split(k)
        ks = jax.random.split(k_step, K)
        states, infos = jax.vmap(step_one)(states, ks, betas_v)

        pri, gpri, ll, gll = untempered(states)
        do_swap = (i % swap_period) == 0
        states2, ll2, nswaps = swap(states, k_swap,
                                    parity=(i // swap_period) % 2,
                                    pri=pri, gpri=gpri, ll=ll, gll=gll)
        states = jax.tree_util.tree_map(
            lambda a, b: jnp.where(do_swap, b, a), states, states2
        )
        ll = jnp.where(do_swap, ll2, ll)
        nswaps = jnp.where(do_swap, nswaps, 0.0)

        out = {
            "ppars": states.pars[-1],  # cold rung after any swap
            "plogtarget": states.logtarget[-1],
            "accept": infos["accept"][-1] if "accept" in infos else True,
            "nswaps": nswaps,
            # per-rung untempered logp (plain) / log-likelihood (prior
            # tempering) — the evidence-estimator inputs (stats/evidence.py)
            "replica_ll": ll,
        }
        return (states,), out

    idx = jnp.arange(1, steps + 1)
    keys = jax.random.split(key, steps)
    (states,), ys = jax.lax.scan(one_step, (states,), (idx, keys))
    return states, ys


def run_ptmc(model, sampler, runner: PTMC, seed: int = 0, key=None, mesh=None,
             _carry_states=None):
    """Run replica-exchange tempering; returns the cold-rung chain (or a
    list of them with ``walkers > 1`` — independent ladders advanced as one
    (walkers, K) vmapped batch, optionally sharded over ``mesh``'s 'chains'
    axis).  ``_carry_states``: a (K,)-ladder state pytree to continue from
    (resume path) instead of fresh initialization."""
    sampler.check(model)
    t0 = time.time()
    if key is None:
        key = jax.random.PRNGKey(seed)
    key, k_init, k_run = jax.random.split(key, 3)

    K = len(runner.betas)
    W = runner.walkers
    betas_arr = jnp.asarray(runner.betas, dtype=model.init.dtype)

    def init_ladder(k):
        return jax.vmap(
            lambda b, kk: sampler.init(
                _tempered_view(model, b, runner.logprior), model.init, kk
            )
        )(betas_arr, jax.random.split(k, K))

    ctx = RunCtx(burnin=runner.burnin)

    if _carry_states is not None:
        assert W == 1, "resume continues one walker's ladder at a time"
        states = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x)[None], _carry_states
        )
    else:
        # one code path for any W: a vmapped (W, K) batch (W == 1 unwraps
        # below)
        states = jax.vmap(init_ladder)(jax.random.split(k_init, W))
    if mesh is not None:
        # shard the walker axis; XLA propagates through the vmapped scan
        from jax.sharding import NamedSharding, PartitionSpec as P

        n_dev = mesh.shape["chains"]
        assert W % n_dev == 0, (
            f"PTMC walkers ({W}) must divide the mesh 'chains' axis "
            f"({n_dev}) to shard — a mesh with walkers=1 would be a silent "
            f"no-op"
        )
        states = jax.tree_util.tree_map(
            lambda x: jax.device_put(
                x,
                NamedSharding(mesh, P(*(("chains",) + (None,) * (x.ndim - 1)))),
            ),
            states,
        )
    final_states, ys = jax.vmap(
        lambda st, k: _ptmc_scan(
            model, sampler, ctx, st, k,
            steps=runner.steps, swap_period=runner.swap_period,
            betas=runner.betas, logprior=runner.logprior,
        )
    )(states, jax.random.split(k_run, W))

    keep = slice(runner.burnin, None)
    cn = model.column_names()
    # single bulk device->host transfer per key, then per-walker views
    host = {k: np.asarray(v) for k, v in ys.items()
            if k in ("ppars", "accept", "nswaps", "plogtarget", "replica_ll")}

    def one_chain(w):
        fstate = jax.tree_util.tree_map(lambda x: x[w], final_states)
        return MCMCChain(
            range=range(runner.burnin + 1, runner.steps + 1),
            samples=Table(host["ppars"][w][keep], cn),
            gradients=Table(np.zeros((0, model.size)), cn),
            diagnostics={
                "accept": host["accept"][w][keep],
                "nswaps": host["nswaps"][w][keep],
                "logtarget": host["plogtarget"][w][keep],
                # (steps, K) per-rung log-likelihood (prior tempering) /
                # untempered logp (plain); burn-in rows kept so evidence
                # estimators can choose their own discard
                "replica_ll": host["replica_ll"][w],
                "betas": np.asarray(runner.betas),
            },
            task=MCMCTask(model, sampler, runner, state=fstate, key=key,
                          pos=runner.steps),
            run_time=time.time() - t0,
        )

    if W == 1:
        return one_chain(0)
    return [one_chain(w) for w in range(W)]


def resume_ptmc(task, steps: int = 100, **kwargs):
    """Exact continuation of a PTMC chain (reference resume semantics,
    runners.jl:48-68, strictly better: the whole ladder's sampler states —
    tuner/dual-averaging adaptation included — carry over)."""
    runner = dataclasses.replace(task.runner, steps=steps, burnin=0,
                                 walkers=1)
    return run_ptmc(task.model, task.sampler, runner,
                    key=jax.random.fold_in(task.key, task.pos),
                    _carry_states=task.state, **kwargs)
