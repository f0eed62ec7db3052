"""Parallel chain engine: vmap within a device, mesh-sharding across devices.

This replaces the reference's distributed backend — Julia ``pmap`` of whole
chains over worker processes (reference: src/runners/runners.jl:35-42,
examples/parallel_serialmc.jl) — with a batched design (SURVEY §2.4):
identical-structure chains are a *batch axis*, advanced by one vmapped
``lax.scan`` and sharded over a ``jax.sharding.Mesh`` so XLA partitions the
batch across devices, with no host round-trips.  Chains are
independent, so scaling is embarrassingly parallel; only diagnostics or
pooled adaptation ever touch collectives.

``run_chains`` is the engine (returns stacked arrays, stays on device);
``prun_serialmc`` adapts it to the reference's ``prun`` surface (a list of
per-task chains)."""
from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.chain import MCMCChain
from ..core.task import MCMCTask
from ..samplers.base import RunCtx
from ..utils.table import Table

CHAIN_AXIS = "chains"


def default_mesh(axis=CHAIN_AXIS, devices=None):
    """A 1-D mesh over all local devices (chain data-parallel axis)."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def _shard_chains(tree, mesh):
    if mesh is None:
        return tree
    sharding = NamedSharding(mesh, P(CHAIN_AXIS))

    def put(x):
        x = jnp.asarray(x)
        if x.ndim >= 1 and x.shape[0] % mesh.devices.size == 0:
            return jax.device_put(x, sharding)
        return x

    return jax.tree_util.tree_map(put, tree)


@partial(jax.jit, static_argnames=("sampler", "ctx", "nsteps", "thinning",
                                   "pool_adaptation"))
def _scan_chains(model, sampler, ctx, states, key, nsteps, thinning=1,
                 pool_adaptation=False):
    """Advance a batch of chains ``nsteps`` steps; ys are the per-step infos.

    With ``thinning > 1`` the scan emits only every ``thinning``-th info
    (steps grouped in an inner ``fori_loop``), keeping output buffers small
    for long thinned runs.  ``pool_adaptation=True`` all-reduces the adapted
    step sizes across chains after every step (see
    :mod:`mcmc_jl.parallel.collectives`)."""
    from .collectives import pool_tuner_states

    n_chains = jax.tree_util.tree_leaves(states)[0].shape[0]

    # cross-chain adaptation hook: samplers that adapt from pooled batch
    # statistics (e.g. ChEESHMC) expose `pool(ctx, states, info)`; called
    # unconditionally — it IS the sampler's adaptation, not an option
    pool_fn = getattr(sampler, "pool", None)

    def one_step(states, k):
        ks = jax.random.split(k, n_chains)
        states, info = jax.vmap(lambda s, kk: sampler.step(model, ctx, s, kk))(
            states, ks
        )
        if pool_fn is not None:
            states = pool_fn(ctx, states, info)
        if pool_adaptation:
            states = pool_tuner_states(states)
        return states, info

    if thinning == 1:
        keys = jax.random.split(key, nsteps)
        return jax.lax.scan(one_step, states, keys)

    nkept = nsteps // thinning

    def group(states, gks):
        def body(i, st):
            st, _ = one_step(st, gks[i])
            return st

        states = jax.lax.fori_loop(0, thinning - 1, body, states)
        states, info = one_step(states, gks[thinning - 1])
        return states, info

    # same per-step key schedule as the unthinned path: thinning changes
    # which infos are emitted, never the trajectory
    keys = jax.random.split(key, nkept * thinning)
    keys = keys.reshape(nkept, thinning, *keys.shape[1:])
    return jax.lax.scan(group, states, keys)


def init_chains(model, sampler, n_chains, key, inits=None, jitter=0.0,
                mesh=None):
    """Batched sampler state for ``n_chains`` chains.

    ``inits``: (n_chains, size) initial positions; default: model.init
    broadcast (optionally Gaussian-jittered by ``jitter``)."""
    k_init, k_jit = jax.random.split(key)
    if inits is None:
        inits = jnp.broadcast_to(model.init, (n_chains, model.size))
        if jitter > 0:
            inits = inits + jitter * jax.random.normal(
                k_jit, inits.shape, dtype=inits.dtype
            )
    else:
        inits = jnp.asarray(inits)
    inits = _shard_chains(inits, mesh)
    keys = jax.random.split(k_init, n_chains)
    states = jax.vmap(lambda th, k: sampler.init(model, th, k))(inits, keys)
    return _shard_chains(states, mesh)


def run_chains(model, sampler, runner, n_chains, key=None, seed: int = 0,
               inits=None, jitter: float = 0.0, mesh=None, states=None,
               thin_on_device: bool = False, pool_adaptation: bool = False):
    """Run ``n_chains`` identical chains; returns (infos, final_states, key).

    ``infos`` arrays have shape (kept_steps, n_chains, ...) and stay on
    device until the caller materializes them."""
    sampler.check(model)
    if key is None:
        key = jax.random.PRNGKey(seed)
    key, k_init, k_run = jax.random.split(key, 3)
    if states is None:
        states = init_chains(model, sampler, n_chains, k_init, inits=inits,
                             jitter=jitter, mesh=mesh)
    ctx = RunCtx(burnin=runner.burnin)
    thinning = runner.thinning if thin_on_device else 1
    assert runner.len % thinning == 0, (
        f"thin_on_device requires steps ({runner.len}) divisible by "
        f"thinning ({thinning}) — a remainder would silently truncate the "
        f"trajectory"
    )
    final_states, infos = _scan_chains(
        model, sampler, ctx, states, k_run, runner.len, thinning=thinning,
        pool_adaptation=pool_adaptation,
    )
    return infos, final_states, key


#: What "auto" sends to the GLM kernel: only the shapes where it was
#: measured faster than XLA on the H100 (PERF.md), the logistic link at
#: padded width 16, from these batch sizes on.  Below them the kernel's
#: 128-chain programs fill too few SMs.  Other links and widths take the
#: generic engine unless ``fused=True`` asks for the kernel.
KERNEL_MIN_CHAINS = {"hmc": 8192, "mala": 16384}
AUTO_LINKS = ("logistic",)
AUTO_DIM = 16


def _plain_hmc(task):
    from ..samplers.hmc import HMC

    s = task.sampler
    return (
        type(s) is HMC
        and s.tuner is None
        and not s.store_leaps
        and s._kind is None
    )


def _plain_mala(task):
    from ..samplers.mala import MALA

    s = task.sampler
    # plain MALA == one-leapfrog HMC at eps = sqrt(driftStep)
    # (ops/glm_hmc.fused_mala_chains; reference MALA.jl:65-126)
    return type(s) is MALA and s.tuner is None


def _kernel_refusal(task, backend, x64, interpret, mesh):
    """Why the GLM trajectory kernel cannot run ``task``, or None."""
    from ..ops.pallas_glm import KERNEL_LINKS, MAX_DIM

    spec = getattr(task.model, "glm_spec", None)
    if spec is None:
        return "the model is not a model(glm=...)"
    if not (_plain_hmc(task) or _plain_mala(task)):
        return "the sampler is not plain fixed-step HMC or MALA"
    if not isinstance(spec.kind, str) or spec.kind not in KERNEL_LINKS:
        return f"the kernel serves links {KERNEL_LINKS}, not {spec.kind!r}"
    if task.model.size > MAX_DIM:
        return f"the kernel serves d <= {MAX_DIM}, not {task.model.size}"
    if backend != "gpu" and not interpret:
        return f"the kernel runs on a GPU and this process runs on {backend}"
    if x64:
        return "the kernel computes in float32 and jax_enable_x64 is on"
    if mesh is not None and mesh.devices.size > 1:
        return "the kernel runs on one device, and a mesh was given"
    return None


def kernel_route(task, n_chains, *, backend, x64=False, fused="auto",
                 interpret=False, mesh=None):
    """The one decision of which engine runs a group of ``n_chains``
    identical tasks: True for the GPU GLM trajectory kernel
    (:mod:`mcmc_jl.ops.glm_hmc`), False for the generic engine.

    ``fused=False`` always takes the generic engine.  ``fused=True``
    demands the kernel and raises ValueError, naming the reason, when the
    task cannot run on it.  ``"auto"`` takes the kernel when it can run and
    the task is one it was measured faster on: a link in
    :data:`AUTO_LINKS`, padded width :data:`AUTO_DIM`, and at least
    :data:`KERNEL_MIN_CHAINS` chains for its sampler.  ``interpret=True``
    (tests) lifts the GPU condition: the kernel then runs in the Pallas
    interpreter."""
    if fused is False:
        return False
    why = _kernel_refusal(task, backend, x64, interpret, mesh)
    if fused is True:
        if why is not None:
            raise ValueError(f"fused=True, but {why}")
        return True
    if why is not None:
        return False
    from ..ops.pallas_glm import padded_dim

    sampler = "mala" if _plain_mala(task) else "hmc"
    return (task.model.glm_spec.kind in AUTO_LINKS
            and padded_dim(task.model.size) == AUTO_DIM
            and n_chains >= KERNEL_MIN_CHAINS[sampler])


def prun_serialmc(tasks, seed: int = 0, mesh=None, fused="auto",
                  interpret=False):
    """Reference-``prun`` surface: a list of SerialMC tasks -> list of chains.

    Tasks with identical (model fns, sampler, runner) are batched into one
    vmapped+sharded launch; heterogeneous lists split into groups.
    ``fused``/``interpret`` choose the engine of each group, as
    :func:`kernel_route` sets out."""
    t0 = time.time()

    # group tasks by compiled structure
    groups = {}
    for idx, t in enumerate(tasks):
        sig = (t.model.eval, t.model.evalallg, t.sampler, t.runner)
        groups.setdefault(sig, []).append(idx)

    results = [None] * len(tasks)
    key = jax.random.PRNGKey(seed)
    last_timings.clear()
    for gi, (sig, idxs) in enumerate(groups.items()):
        t = tasks[idxs[0]]
        n = len(idxs)
        t_group = time.perf_counter()
        use_kernel = kernel_route(
            t, n, backend=jax.default_backend(),
            x64=jax.config.jax_enable_x64, fused=fused, interpret=interpret,
            mesh=mesh)
        if use_kernel:
            from ..ops.glm_hmc import fused_hmc_chains, fused_mala_chains

            glm_fn = (fused_mala_chains if _plain_mala(t)
                      else fused_hmc_chains)
            infos, final_states = glm_fn(
                t.model, t.sampler, t.runner, n,
                key=jax.random.fold_in(key, gi), interpret=interpret,
            )
        else:
            infos, final_states, _ = run_chains(
                t.model, t.sampler, t.runner, n,
                key=jax.random.fold_in(key, gi), mesh=mesh,
            )
        jax.block_until_ready((infos, final_states))
        t_sampled = time.perf_counter()
        _package_group(t, t.runner, idxs, infos, final_states, key,
                       results, t0)
        last_timings.append({
            "engine": "kernel" if use_kernel else "generic", "chains": n,
            "sample_s": t_sampled - t_group,
            "package_s": time.perf_counter() - t_sampled})
    return results


#: one record per group of the latest prun_serialmc call: the engine, the
#: chain count, the seconds from routing until the draws were on the device
#: (compilation included), and the seconds spent moving them to the host
#: and building the MCMCChain objects
last_timings = []


def _package_group(t, runner, idxs, infos, final_states, key, results, t0,
                   pos_list=None):
    """Slice kept rows on device, transfer once, build one MCMCChain per
    task index (shared by :func:`prun_serialmc` and
    :func:`presume_serialmc`).  ``pos_list`` (aligned with ``idxs``)
    carries per-task step histories — grouped chains may have been resumed
    different numbers of times."""
    # slice to kept rows and drop pre-step duplicates ON DEVICE before
    # materializing: the transfer to the host is the large cost here
    keep_idx = jnp.asarray(np.asarray(list(runner.r)) - 1)
    drop = {"pars", "grads", "logtarget"}
    infos = jax.device_get(
        {k: v[keep_idx] for k, v in infos.items() if k not in drop}
    )
    # one bulk transfer of final states; per-chain slicing stays in numpy
    # (per-chain device indexing would cost one transfer per leaf)
    final_states = jax.device_get(final_states)
    # every chain's continuation key in one call, not one dispatch per chain
    task_keys = np.asarray(jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.asarray(idxs) + 1000))
    cn = t.model.column_names()
    for ci, idx in enumerate(idxs):
        samples = Table(np.asarray(infos["ppars"])[:, ci], cn)
        if "pgrads" in infos:
            gradients = Table(np.asarray(infos["pgrads"])[:, ci], cn)
        else:
            gradients = Table(np.zeros((0, t.model.size)), cn)
        skip = {"ppars", "pgrads", "plogtarget"}
        diags = {"step": np.asarray(list(runner.r))}
        for k, v in infos.items():
            if k not in skip:
                diags[k] = np.asarray(v)[:, ci]
        diags["logtarget"] = np.asarray(infos["plogtarget"])[:, ci]
        state_i = jax.tree_util.tree_map(lambda a: a[ci], final_states)
        pos0 = t.pos if pos_list is None else pos_list[ci]
        new_task = MCMCTask(t.model, t.sampler, runner, state=state_i,
                            key=task_keys[ci],
                            pos=pos0 + runner.len)
        results[idx] = MCMCChain(
            range=runner.r,
            samples=samples,
            gradients=gradients,
            diagnostics=diags,
            task=new_task,
            run_time=time.time() - t0,
        )


def presume_serialmc(chains, steps: int = 100, seed: int = 0, mesh=None):
    """Batched resume of a list of SerialMC chains: the reference's
    long-continuation workflow (runners.jl:48-68) at prun scale.

    Identical-structure chains re-batch into one vmapped launch of the
    generic engine (continuation runners have burnin=0, so adaptation
    never fires again).

    PRNG note: each group's continuation stream derives from the FIRST
    member's stored task key only; the other members' stored keys are
    ignored (safe — per-index restamping in ``_package_group`` keeps the
    downstream streams distinct — but per-chain key state is deliberately
    not folded in)."""
    from ..runners.serialmc import SerialMC, resume_serialmc

    t0 = time.time()
    tasks = [c.task if isinstance(c, MCMCChain) else c for c in chains]
    groups = {}
    for idx, t in enumerate(tasks):
        sig = (t.model.eval, t.model.evalallg, t.sampler,
               type(t.runner), t.runner.thinning)
        groups.setdefault(sig, []).append(idx)

    results = [None] * len(chains)
    key = jax.random.PRNGKey(seed)
    for gi, (sig, idxs) in enumerate(groups.items()):
        t = tasks[idxs[0]]
        n = len(idxs)
        if any(tasks[i].state is None for i in idxs):
            # never-run tasks carry no state to batch: plain per-task resume
            for i in idxs:
                results[i] = resume_serialmc(tasks[i], steps=steps)
            continue
        new_runner = SerialMC(steps=steps, thinning=t.runner.thinning)
        states = jax.tree_util.tree_map(
            lambda *xs: np.stack(xs),
            *[tasks[i].state for i in idxs])
        # derive the continuation stream from the STORED task key: every
        # resume segment re-stamps fresh task keys below, so repeated
        # resume() calls advance the PRNG instead of replaying the same
        # refresh/accept sequence (the old per-task path advanced
        # task.key through run_serialmc; the batched path must too)
        base = t.key if t.key is not None else jax.random.fold_in(key, gi)
        k_run = jax.random.fold_in(base, 7)

        infos, final_states, _ = run_chains(
            t.model, t.sampler, new_runner, n, key=k_run, states=states,
            mesh=mesh)
        _package_group(t, new_runner, idxs, infos, final_states, k_run,
                       results, t0,
                       pos_list=[tasks[i].pos for i in idxs])
    return results
