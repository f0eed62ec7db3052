"""Profiling & throughput reporting.

The reference's only instrumentation is wall-clock ``tic()/toq()`` stored in
``MCMCChain.runTime`` (SerialMC.jl:38,84; SURVEY §5).  Here:

- :func:`trace` wraps ``jax.profiler`` for TensorBoard-readable device
  traces of a sampling run;
- :func:`throughput_report` turns a chain (or raw run) into the metrics that
  matter for MCMC hardware efficiency: steps/s, (for HMC-family) leapfrog/s,
  and ESS/s per parameter — the BASELINE.json headline quantities.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np


@contextlib.contextmanager
def trace(logdir="jax-trace"):
    """Device-level profiler trace: ``with trace(): run(...)`` then open the
    logdir in TensorBoard/XProf."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label="block", sink=None):
    t0 = time.perf_counter()
    rec = {"label": label}
    try:
        yield rec
    finally:
        rec["seconds"] = time.perf_counter() - t0
        if sink is not None:
            sink.append(rec)


def throughput_report(chain, n_chains=1, n_leaps=None):
    """steps/s, leapfrog/s and ESS/s for a finished chain."""
    from ..stats.ess import ess

    nsteps = chain.range.stop - 1 if isinstance(chain.range, range) else len(chain.range)
    dt = chain.run_time
    rep = {
        "run_time_s": dt,
        "steps_per_sec": nsteps * n_chains / dt,
    }
    if n_leaps is not None:
        # derive from steps_per_sec so the two rates are exactly consistent
        rep["leapfrog_per_sec"] = rep["steps_per_sec"] * n_leaps
    try:
        e = np.asarray(ess(chain))
        rep["ess_per_param"] = e
        rep["ess_per_sec"] = float(np.min(e)) * n_chains / dt
    except Exception:
        pass
    return rep
