"""Headline benchmark: HMC leapfrog steps per second on one GPU.

The workload is the reference's benchmark posterior (benchmarks/benchunits/
binomial.jl): Bayesian logistic regression, d = 10, N = 1,000, built with
``model(glm=...)`` and sampled by ``HMC(10, 0.05)`` at 65,536 chains through
``run(task, chains=N)``, the entry point a user calls.  The rate counts the
sampling phase of that call (compilation excluded, the first call is a
warm-up); moving the draws to the host and building the chain objects is
reported beside it as ``package_s``.

Usage::

    python bench.py [--chains 65536] [--obs 1000] [--steps 200] [--reps 5]
                    [--sampler hmc|mala] [--compare]

``--sampler mala`` runs ``MALA(eps^2)``, which the kernel route runs as
one-leapfrog HMC; its rate counts one leapfrog per transition.  The default
runs ``fused="auto"`` and prints one JSON line.  ``--compare`` times the
kernel route (``fused=True``) and the generic engine (``fused=False``) in
alternation, kernel, generic, generic, kernel, ..., and prints one line
for each.
Without a GPU the script exits with an error and prints no result.
"""
import argparse
import json
import subprocess
import sys

import numpy as np

METRIC = "hmc_leapfrog_steps_per_sec_logistic"
N_LEAPS, EPS = 10, 0.05  # the step at N = 1,000


def card():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def device_info():
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}


def logistic_data(n=1000, nbeta=10, seed=1):
    """The reference's binomial posterior data: intercept + N(0,1) columns,
    responses drawn from the logistic model at N(0,1) coefficients."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, nbeta - 1))])
    beta0 = rng.standard_normal(nbeta)
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta0))).astype(np.float64)
    return X, Y


def run_once(task, chains, fused, seed):
    """One ``run(task, chains=...)``; returns (chains, sample seconds,
    package seconds, engine)."""
    import mcmc_jl as mc
    from mcmc_jl.parallel import pchains

    out = mc.run(task, chains=chains, seed=seed, fused=fused)
    [rec] = pchains.last_timings
    return out, rec["sample_s"], rec["package_s"], rec["engine"]


def result(task, chains, engine, samples, packs, s0, out):
    import mcmc_jl as mc

    steps = task.runner.len
    n_leaps = getattr(task.sampler, "n_leaps", 1)
    dt = float(np.median(samples))
    acc = float(np.mean([mc.acceptance(c) for c in out[:256]]))
    lp = np.asarray(out[0].diagnostics["logtarget"])
    if not (np.all(np.isfinite(lp)) and acc > 5.0):
        raise RuntimeError(f"bad run: acceptance {acc}%, logtarget {lp[-3:]}")
    return {
        "metric": METRIC,
        "value": chains * steps * n_leaps / dt,
        "unit": "leapfrog/s",
        "engine": engine,
        "chains": chains,
        "obs": int(task.model.glm_spec.X.shape[0]),
        "steps": steps,
        "sampler": type(task.sampler).__name__,
        "sample_s": samples,
        "package_s": packs,
        "compile_s": s0 - dt,
        "acceptance_pct": acc,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chains", type=int, default=65536)
    ap.add_argument("--obs", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sampler", choices=("hmc", "mala"), default="hmc")
    ap.add_argument("--compare", action="store_true")
    args = ap.parse_args(argv)

    import jax

    from mcmc_jl.utils.cache import enable_compile_cache

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {jax.devices()}")
    enable_compile_cache()
    import mcmc_jl as mc

    X, Y = logistic_data(args.obs)
    # the posterior sd shrinks like 1/sqrt(N): so does a stable step
    eps = EPS * float(np.sqrt(1000.0 / args.obs))
    sampler = (mc.HMC(N_LEAPS, eps) if args.sampler == "hmc"
               else mc.MALA(eps * eps))
    task = (mc.model(glm=("logistic", X, Y)) * sampler
            * mc.SerialMC(steps=args.steps))
    extra = {**device_info(), "card": card()}
    routes = (True, False) if args.compare else ("auto",)
    # warm each route up (compiles), then time them in alternation so that
    # drift of the card's clocks falls on all alike: A, B, B, A, ...
    warm = {f: run_once(task, args.chains, f, seed=0) for f in routes}
    times = {f: ([], []) for f in routes}
    last = {}
    for rep in range(args.reps):
        for f in (routes if rep % 2 == 0 else routes[::-1]):
            last[f], s, p, _ = run_once(task, args.chains, f, seed=rep + 1)
            times[f][0].append(s)
            times[f][1].append(p)
    for f in routes:
        _, s0, _, engine = warm[f]
        res = result(task, args.chains, engine, *times[f], s0, last[f])
        print(json.dumps({**res, **extra}))


if __name__ == "__main__":
    main()
