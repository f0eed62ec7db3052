"""Adaptive annealed SMC sampler (no reference equivalent).

The reference's SeqMC (src/runners/SeqMC.jl) walks a *user-supplied* ladder
of targets with importance reweighting.  This runner is the modern
batched descendant: annealed SMC from the prior to the posterior
(Del Moral, Doucet & Jasra 2006) where the inverse-temperature schedule is
chosen **on the fly** by bisecting each increment so the reweighted ESS
hits ``target_ess * particles`` (Jasra et al. 2011; Chopin & Papaspiliopoulos
ch. 17).  The whole run is one ``lax.while_loop`` on device: reweight →
ESS-bisection → systematic resampling → ``moves`` MCMC rejuvenation steps
with any sampler at the current power posterior
``logprior + beta * loglik`` (the same prior-tempered view PTMC uses).

As a by-product the telescoped normalizing-constant increments give an
unbiased-in-Z marginal-likelihood estimate
``log Z = Σ_t log Σ_i W_i^{t-1} exp(δ_t ll_i)`` — a third evidence
estimator cross-validating stats/evidence.py's TI and stepping-stone
(tests/test_asmc.py checks all agree with an analytic conjugate logZ).
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
from ..samplers.base import RunCtx
from ..utils.table import Table
from .ptmc import _tempered_view


@dataclasses.dataclass(frozen=True)
class ASMC:
    """Adaptive annealed-SMC runner config.

    ``logprior``: normalized log prior density (theta -> logpi(theta)).
    ``prior_sample``: key -> one draw from that prior (vmapped internally).
    ``target_ess``: ESS fraction each adaptive temperature step aims for.
    ``moves``: MCMC rejuvenation steps per temperature stage.
    """

    particles: int = 1024
    target_ess: float = 0.5
    moves: int = 2
    max_stages: int = 50
    resampling: str = "systematic"
    logprior: object = None
    prior_sample: object = None

    def __post_init__(self):
        assert self.particles >= 2
        assert 0.0 < self.target_ess < 1.0
        assert self.moves >= 1
        assert self.max_stages >= 1
        assert self.resampling in ("multinomial", "systematic", "stratified")
        assert self.logprior is not None, "ASMC needs logprior="
        assert self.prior_sample is not None, "ASMC needs prior_sample="

    def __rmul__(self, other):
        from ..core.task import product

        return product(other, self)


def _resample_idx(key, logW, npart, method):
    """Ancestor indices for the three standard schemes (on device)."""
    if method == "multinomial":
        return jax.random.categorical(key, logW, shape=(npart,))
    wn = jax.nn.softmax(logW)
    cum = jnp.cumsum(wn)
    if method == "systematic":
        u = jax.random.uniform(key, (), dtype=wn.dtype)
    else:  # stratified
        u = jax.random.uniform(key, (npart,), dtype=wn.dtype)
    pts = (jnp.arange(npart, dtype=wn.dtype) + u) / npart
    return jnp.clip(jnp.searchsorted(cum, pts, side="left"), 0, npart - 1)


@partial(jax.jit, static_argnames=("sampler", "runner"))
def _asmc_loop(model, sampler, runner: ASMC, states, th, key):
    N = runner.particles
    S = runner.max_stages
    logprior = runner.logprior
    ctx = RunCtx(burnin=0)
    dtype = th.dtype
    target = runner.target_ess * N

    def loglik(t):
        return model.eval(t) - logprior(t)

    def ess_of(lw):
        lw = lw - jax.scipy.special.logsumexp(lw)
        return jnp.exp(-jax.scipy.special.logsumexp(2.0 * lw))

    def body(carry):
        i, beta, th, states, logW, logZ, key, betas_b, ess_b, acc_b = carry
        key, k_bis, k_res, k_mv = jax.random.split(key, 4)

        ll = jax.vmap(loglik)(th)
        logWn = logW - jax.scipy.special.logsumexp(logW)

        # --- adaptive increment: bisect delta so ESS(logWn + delta*ll) hits
        # target (ESS is monotone decreasing in delta)
        hi0 = 1.0 - beta

        def bis(_, c):
            lo, hi = c
            mid = 0.5 * (lo + hi)
            small = ess_of(logWn + mid * ll) < target
            return (jnp.where(small, lo, mid), jnp.where(small, mid, hi))

        lo, hi = jax.lax.fori_loop(
            0, 30, bis, (jnp.zeros((), dtype), hi0)
        )
        full = ess_of(logWn + hi0 * ll) >= target  # can we jump straight to 1?
        delta = jnp.where(full, hi0, 0.5 * (lo + hi))

        # --- unbiased logZ increment & reweight
        logZ = logZ + jax.scipy.special.logsumexp(logWn + delta * ll)
        logW = logWn + delta * ll
        beta = beta + delta
        ess_new = ess_of(logW)

        # --- resample (skip only when the clipped final jump kept ESS high)
        do_res = ess_new <= target + 1.0
        idx = _resample_idx(k_res, logW, N, runner.resampling)
        th = jnp.where(do_res, th[idx], th)
        logW = jnp.where(do_res, jnp.full((N,), -jnp.log(float(N)), dtype),
                         logW)

        # --- MCMC rejuvenation at the new power posterior
        view = _tempered_view(model, beta, logprior)
        states = jax.vmap(lambda s, t: sampler.reset(view, s, t))(states, th)

        def mv(m, c):
            states, th, acc = c
            ks = jax.random.split(jax.random.fold_in(k_mv, m), N)
            states, infos = jax.vmap(
                lambda s, k: sampler.step(view, ctx, s, k)
            )(states, ks)
            return states, infos["ppars"], acc + jnp.mean(
                infos["accept"].astype(dtype))

        states, th, acc = jax.lax.fori_loop(
            0, runner.moves, mv, (states, th, jnp.zeros((), dtype))
        )

        betas_b = betas_b.at[i].set(beta)
        ess_b = ess_b.at[i].set(ess_new)
        acc_b = acc_b.at[i].set(acc / runner.moves)
        return (i + 1, beta, th, states, logW, logZ, key,
                betas_b, ess_b, acc_b)

    def cond(carry):
        i, beta = carry[0], carry[1]
        return (beta < 1.0) & (i < S)

    carry0 = (
        jnp.zeros((), jnp.int32), jnp.zeros((), dtype), th, states,
        jnp.full((N,), -jnp.log(float(N)), dtype), jnp.zeros((), dtype), key,
        jnp.full((S,), jnp.nan, dtype), jnp.full((S,), jnp.nan, dtype),
        jnp.full((S,), jnp.nan, dtype),
    )
    (n_stages, beta, th, states, logW, logZ, key,
     betas_b, ess_b, acc_b) = jax.lax.while_loop(cond, body, carry0)

    # final equalization so returned particles are unweighted
    k_fin = jax.random.fold_in(key, 777)
    idx = _resample_idx(k_fin, logW, N, runner.resampling)
    uneven = ess_of(logW) < N - 1e-6
    th = jnp.where(uneven, th[idx], th)
    return dict(n_stages=n_stages, beta=beta, pars=th, logZ=logZ,
                betas=betas_b, ess=ess_b, accept=acc_b)


def run_asmc(model, sampler, runner: ASMC, seed: int = 0, key=None,
             mesh=None):
    """Anneal prior -> posterior; returns an MCMCChain whose samples are the
    final (unweighted) particle ensemble, with diagnostics ``logz``,
    ``betas`` (adaptive schedule), ``ess`` and ``accept`` per stage.

    ``mesh``: shard the particle axis over the mesh's 'chains' axis —
    per-particle likelihood/move work stays local; only the ESS/logZ
    reductions and resampling gathers cross devices (psum / all-to-all
    inserted by XLA)."""
    sampler.check(model)
    t0 = time.time()
    if key is None:
        key = jax.random.PRNGKey(seed)
    k_draw, k_init, k_run = jax.random.split(key, 3)

    N = runner.particles
    th0 = jax.vmap(runner.prior_sample)(jax.random.split(k_draw, N))
    th0 = jnp.asarray(th0, dtype=model.init.dtype).reshape(N, model.size)
    view0 = _tempered_view(model, 0.0, runner.logprior)
    states = jax.vmap(lambda t, k: sampler.init(view0, t, k))(
        th0, jax.random.split(k_init, N)
    )
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        n_dev = mesh.shape["chains"]
        assert N % n_dev == 0, (
            f"ASMC particles ({N}) must divide the mesh 'chains' axis "
            f"({n_dev})"
        )
        shard = lambda x: jax.device_put(
            x, NamedSharding(mesh, P(*(("chains",) + (None,) * (x.ndim - 1))))
        )
        th0 = shard(th0)
        states = jax.tree_util.tree_map(shard, states)

    out = _asmc_loop(model, sampler, runner, states, th0, k_run)
    n_stages = int(out["n_stages"])
    assert float(out["beta"]) >= 1.0 - 1e-9, (
        f"annealing did not reach beta=1 in max_stages={runner.max_stages} "
        f"(reached {float(out['beta']):.4f}); raise max_stages or target_ess"
    )

    cn = model.column_names()
    chain = MCMCChain(
        range=range(1, N + 1),
        samples=Table(np.asarray(out["pars"]), cn),
        gradients=Table(np.zeros((0, model.size)), cn),
        diagnostics={
            "logz": float(out["logZ"]),
            "n_stages": n_stages,
            "betas": np.asarray(out["betas"])[:n_stages],
            "ess": np.asarray(out["ess"])[:n_stages],
            "accept": np.asarray(out["accept"])[:n_stages],
        },
        # the final (equalized) particle ensemble IS the resumable state:
        # beta has reached 1, so continuation = more MCMC rejuvenation moves
        # at the full posterior (resume_asmc)
        task=MCMCTask(model, sampler, runner, state=out["pars"], key=key,
                      pos=n_stages),
        run_time=time.time() - t0,
    )
    return chain


def resume_asmc(task: MCMCTask, steps: int = 10):
    """Continue an annealed-SMC chain: the stored state is the final
    (unweighted) particle ensemble at beta=1, so resuming runs ``steps``
    more vmapped MCMC rejuvenation sweeps at the FULL posterior and returns
    a chain over the refreshed ensemble.  ``logz`` and the adaptive
    schedule diagnostics carry over unchanged (the annealing is complete —
    more moves only decorrelate the particles further)."""
    assert isinstance(task.runner, ASMC)
    assert task.state is not None, "ASMC task has no stored ensemble"
    model, sampler, runner = task.model, task.sampler, task.runner
    t0 = time.time()
    th = jnp.asarray(task.state)
    N = th.shape[0]
    key = jax.random.fold_in(task.key, task.pos)
    k_init, k_run = jax.random.split(key)
    states = jax.vmap(lambda t, k: sampler.init(model, t, k))(
        th, jax.random.split(k_init, N))
    ctx = RunCtx(burnin=0)

    @partial(jax.jit, static_argnames=("sampler", "nsteps"))
    def moves(sampler, states, key, nsteps):
        def body(c, k):
            states, acc = c
            ks = jax.random.split(k, N)
            states, infos = jax.vmap(
                lambda s, kk: sampler.step(model, ctx, s, kk)
            )(states, ks)
            return (states, acc + jnp.mean(
                infos["accept"].astype(th.dtype))), None

        (states, acc), _ = jax.lax.scan(
            body, (states, jnp.zeros((), th.dtype)),
            jax.random.split(key, nsteps))
        return states, acc / nsteps

    states, acc = moves(sampler, states, k_run, steps)
    th_new = states.pars
    cn = model.column_names()
    diags = {"accept": float(acc), "resumed_moves": steps}
    return MCMCChain(
        range=range(1, N + 1),
        samples=Table(np.asarray(th_new), cn),
        gradients=Table(np.zeros((0, model.size)), cn),
        diagnostics=diags,
        task=MCMCTask(model, sampler, runner, state=th_new, key=key,
                      pos=task.pos + steps),
        run_time=time.time() - t0,
    )
