"""Convergence-gated runner: sample until cross-chain diagnostics pass.

The reference runs a fixed step count and leaves convergence assessment to
the user (SerialMC range semantics; stats are post-hoc).  With cheap
vmapped chains and on-device blocks, the natural workflow is *run until
converged*: advance all chains ``check_every`` steps at a time (one
``lax.scan`` per block, states carried exactly), then gate on split/rank
R-hat (Vehtari et al. 2021) and pooled ESS over the retained draws.

``run_until`` is deterministic given a key: the chain law is identical to a
fixed ``SerialMC(steps=steps_run)`` run with the same per-block key
schedule — stopping early never biases the retained draws (the gate reads
diagnostics only; it does not condition on sample values beyond them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import jax
import numpy as np

from ..stats.multichain import ess_pooled, rhat


@dataclasses.dataclass
class ConvergenceResult:
    """Result of :func:`run_until`.

    ``samples``: (kept_steps, n_chains, d) retained draws (post-warmup,
    second-half window at the stopping point).
    ``history``: [(steps_run, max_rhat, min_ess)] one row per check.
    ``states``: final batched sampler states (resume-ready).
    """

    samples: np.ndarray
    converged: bool
    steps_run: int
    rhat: np.ndarray
    ess: np.ndarray
    history: List[Tuple[int, float, float]]
    states: Any
    key: Any

    @property
    def max_rhat(self):
        return float(np.max(self.rhat))

    @property
    def min_ess(self):
        return float(np.min(self.ess))


def run_until(model, sampler, n_chains=8, *, rhat_target=1.01, min_ess=400,
              check_every=500, max_steps=100_000, warmup=None,
              method="rank", seed=0, key=None, inits=None, jitter=0.1,
              mesh=None, verbose=False):
    """Run ``n_chains`` chains until R-hat and pooled-ESS gates pass.

    Blocks of ``check_every`` steps are advanced on device (states carried
    exactly — adaptation behaves as one continuous run with
    ``burnin=warmup``); after each block the gates are evaluated on the
    draws after ``max(warmup, steps_run // 2)``.  Stops when
    ``max R-hat <= rhat_target`` AND ``min pooled ESS >= min_ess``, or at
    ``max_steps``.

    ``method``: "rank" (Vehtari-2021 bulk/tail, default) or "split"
    (classic Gelman-Rubin) — see :func:`mcmc_jl.stats.rhat`.
    """
    from ..parallel.pchains import init_chains, run_chains

    assert n_chains >= 2, "cross-chain gates need >= 2 chains"
    warmup = check_every if warmup is None else warmup
    sampler.check(model)
    if key is None:
        key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    states = init_chains(model, sampler, n_chains, k_init, inits=inits,
                         jitter=jitter, mesh=mesh)

    class _Blk:  # minimal runner shim for run_chains
        len = check_every
        burnin = warmup
        thinning = 1

    blocks: List[np.ndarray] = []
    history: List[Tuple[int, float, float]] = []
    steps_run = 0
    converged = False
    r = e = None
    while steps_run < max_steps:
        infos, states, key = run_chains(
            model, sampler, _Blk, n_chains, key=key, states=states,
            mesh=mesh)
        blocks.append(np.asarray(infos["ppars"]))
        steps_run += check_every
        x = np.concatenate(blocks, axis=0)
        keep = x[max(warmup, steps_run // 2):]
        if keep.shape[0] < 4:
            continue
        r = np.asarray(rhat(keep, method=method))
        e = np.asarray(ess_pooled(keep))
        history.append((steps_run, float(np.max(r)), float(np.min(e))))
        if verbose:
            print(f"run_until: {steps_run} steps, max R-hat "
                  f"{np.max(r):.4f}, min ESS {np.min(e):.0f}")
        if np.max(r) <= rhat_target and np.min(e) >= min_ess:
            converged = True
            break

    x = np.concatenate(blocks, axis=0)
    keep = x[max(warmup, steps_run // 2):]
    if r is None:
        r = np.asarray(rhat(keep, method=method))
        e = np.asarray(ess_pooled(keep))
    return ConvergenceResult(
        samples=keep, converged=converged, steps_run=steps_run,
        rhat=r, ess=e, history=history, states=states, key=key,
    )
