"""Multi-host operation.

The reference's cluster story is ``@everywhere using MCMC`` + Julia
Distributed ``pmap`` (examples/parallel_serialmc.jl): serialize closures to
workers, gather whole chains.  The JAX story is single-program
multi-data: every host runs the *same* program, ``jax.distributed`` wires
the hosts into one runtime, and the global mesh spans all devices — chains
shard across hosts exactly as they shard across devices, with collectives
over NVLink within a host and the network across hosts.

Because chains are independent, multi-host scaling is communication-free on
the sampling path; only pooled adaptation / cross-chain diagnostics reduce
over the mesh (a handful of scalars per step), which is why >=80% scaling
efficiency at 2 hosts is the expected regime (BASELINE.md).

Typical use::

    from mcmc_jl.parallel import multihost
    multihost.initialize()                      # no-op on a single host
    mesh = multihost.global_mesh()              # all chips on all hosts
    chains = mc.prun(tasks, mesh=mesh)

Single-host processes (including the CPU test mesh) work unchanged: every
helper degrades gracefully when ``jax.process_count() == 1``.
"""
from __future__ import annotations

import numpy as np


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Wire this process into the multi-host runtime (idempotent; no-op for
    a single process).  Arguments mirror ``jax.distributed.initialize`` and
    are auto-detected where a cluster manager provides them."""
    import jax

    if num_processes == 1:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (ValueError, RuntimeError):
        # already initialized, or single-process environment
        pass


def global_mesh(axis="chains"):
    """1-D mesh over every chip of every host."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def process_chain_slice(n_chains):
    """The [start, stop) slice of the global chain axis owned by this host
    (for host-local IO of per-chain results)."""
    import jax

    per = n_chains // jax.process_count()
    start = per * jax.process_index()
    return start, start + per


def scaling_efficiency(rate_1host, rate_nhost, n_hosts):
    """samples/s scaling efficiency vs linear (the BASELINE.md metric)."""
    return rate_nhost / (rate_1host * n_hosts)
