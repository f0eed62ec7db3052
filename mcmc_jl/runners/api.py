"""run / resume / prun dispatch (reference: src/runners/runners.jl).

``run`` dispatches on the runner type of a task (or array of tasks);
``resume`` continues a chain; ``prun`` is the parallel multi-chain engine
(the reference's Julia-``pmap`` backend, runners.jl:35-42, redesigned as a
vmapped + mesh-sharded batch — see :mod:`mcmc_jl.parallel`).
"""
from __future__ import annotations

from typing import Optional

from ..core.chain import MCMCChain
from ..core.task import MCMCTask, _Partial
from .serialmc import SerialMC, run_serialmc, resume_serialmc


def _as_task(x, *rest):
    if rest:  # run(model, sampler, runner) sugar (runners.jl:45)
        sampler, runner = rest
        prod = x * sampler
        if isinstance(prod, _Partial):
            prod = prod * runner
        return prod
    return x


def run(x, *rest, seed: int = 0, chains: Optional[int] = None, **kwargs):
    """Run a task / array of tasks / (model, sampler, runner) triple.

    ``chains=N`` runs N identical chains as one vmapped (optionally
    mesh-sharded) batch and returns a list of N chains — sugar over
    :func:`prun` (the reference would need ``m * [s]*N * r`` + prun).
    """
    t = _as_task(x, *rest)

    if isinstance(t, _Partial):
        raise TypeError("missing runner: use model * sampler * runner")

    if chains is not None:
        assert isinstance(t, MCMCTask), "chains= requires a single task"
        tasks = [MCMCTask(t.model, t.sampler, t.runner) for _ in range(chains)]
        return prun(tasks, seed=seed, **kwargs)

    if isinstance(t, MCMCChain):  # chain continuation alternate (runners.jl:14)
        return run(t.task, seed=seed, **kwargs)

    if isinstance(t, (list, tuple)):
        runners = [ti.runner for ti in t]
        first = runners[-1]
        assert all(isinstance(r, type(first)) for r in runners), (
            "Runners do not have the same runner type"
        )
        if isinstance(first, SerialMC):
            return [run_serialmc(ti, seed=seed + i, **kwargs) for i, ti in enumerate(t)]
        from .serialtempmc import SerialTempMC, run_serialtempmc
        from .seqmc import SeqMC, run_seqmc

        if isinstance(first, SerialTempMC):
            return run_serialtempmc(list(t), seed=seed, **kwargs)
        if isinstance(first, SeqMC):
            return run_seqmc(list(t), seed=seed, **kwargs)
        raise TypeError(f"unknown runner type {type(first).__name__}")

    assert isinstance(t, MCMCTask), f"cannot run {type(t).__name__}"
    if isinstance(t.runner, SerialMC):
        return run_serialmc(t, seed=seed, **kwargs)
    from .ptmc import PTMC, run_ptmc

    if isinstance(t.runner, PTMC):
        return run_ptmc(t.model, t.sampler, t.runner, seed=seed, **kwargs)
    from .aies import AIES, run_aies

    if isinstance(t.runner, AIES):
        return run_aies(t.model, t.runner, seed=seed, **kwargs)
    from .asmc import ASMC, run_asmc

    if isinstance(t.runner, ASMC):
        return run_asmc(t.model, t.sampler, t.runner, seed=seed, **kwargs)
    raise TypeError(f"unknown runner type {type(t.runner).__name__}")


def resume(x, *, steps: int = 100, **kwargs):
    """Continue a chain/task where it stopped (runners.jl:48-68) — exactly,
    since sampler state is an explicit pytree (SURVEY §5 resume note)."""
    if isinstance(x, MCMCChain):
        return resume(x.task, steps=steps, **kwargs)
    if isinstance(x, (list, tuple)):
        last = x[-1]
        first = last.task.runner if isinstance(last, MCMCChain) else last.runner
        if isinstance(first, SerialMC):
            # batched continuation: identical-structure chains re-batch into
            # one vmapped launch (parallel/pchains presume_serialmc), not one
            # scan per chain
            from ..parallel.pchains import presume_serialmc

            return presume_serialmc(list(x), steps=steps, **kwargs)
        from .serialtempmc import SerialTempMC, resume_serialtempmc
        from .seqmc import SeqMC, resume_seqmc

        if isinstance(first, SerialTempMC):
            return resume_serialtempmc(list(x), steps=steps, **kwargs)
        if isinstance(first, SeqMC):
            return resume_seqmc(list(x), steps=steps, **kwargs)
        from .ptmc import PTMC

        if isinstance(first, PTMC):  # walkers > 1: one ladder per chain
            return [resume(t, steps=steps, **kwargs) for t in x]
        from .aies import AIES

        if isinstance(first, AIES):
            # every walker chain carries the SAME full-ensemble state:
            # resume once, return the whole new walker-chain list
            return resume(x[-1], steps=steps, **kwargs)
        raise TypeError(f"unknown runner type {type(first).__name__}")
    assert isinstance(x, MCMCTask)
    if isinstance(x.runner, SerialMC):
        return resume_serialmc(x, steps=steps)
    from .ptmc import PTMC, resume_ptmc

    if isinstance(x.runner, PTMC):
        return resume_ptmc(x, steps=steps, **kwargs)
    from .aies import AIES, resume_aies

    if isinstance(x.runner, AIES):
        return resume_aies(x, steps=steps)
    from .asmc import ASMC, resume_asmc

    if isinstance(x.runner, ASMC):
        return resume_asmc(x, steps=steps)
    raise TypeError(f"unknown runner type {type(x.runner).__name__}")


def prun(tasks, seed: int = 0, mesh=None, **kwargs):
    """Parallel multi-chain run (reference runners.jl:35-42).

    The reference farms independent chains to Julia worker processes via
    ``pmap``; here identical-structure chains are batched on-device with
    ``vmap`` and sharded across a device mesh — see
    :func:`mcmc_jl.parallel.run_chains`.  ``fused``/``interpret`` choose
    the engine (:func:`mcmc_jl.parallel.pchains.kernel_route`).
    Heterogeneous task lists fall back to a sequential loop.
    """
    if isinstance(tasks, MCMCTask):
        tasks = [tasks]
    runners = [t.runner for t in tasks]
    first = runners[-1]
    assert all(isinstance(r, type(first)) for r in runners), (
        "Runners do not have the same runner type"
    )
    from ..parallel.pchains import prun_serialmc

    if isinstance(first, SerialMC):
        return prun_serialmc(list(tasks), seed=seed, mesh=mesh, **kwargs)
    raise TypeError(f"prun supports SerialMC runners, got {type(first).__name__}")
