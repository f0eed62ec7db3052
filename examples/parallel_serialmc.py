"""Parallel multi-chain run (reference: examples/parallel_serialmc.jl).

The reference farms 10 HMC chains to Julia worker processes with ``prun``;
here the same 10 chains are one vmapped batch sharded over whatever devices
are present (GPUs of a host, or a virtual CPU mesh)."""
import jax.numpy as jnp

import mcmc_jl as mc
from mcmc_jl.parallel import default_mesh

mymodel = mc.model(lambda v: -jnp.dot(v, v), grad=lambda v: -2 * v, init=jnp.ones(3))
mytasks = mymodel * [mc.HMC(0.75) for _ in range(10)] * mc.SerialMC(
    steps=50000, burnin=5000
)

if __name__ == "__main__":
    mychains = mc.prun(mytasks, mesh=default_mesh())
    print([mc.acceptance(chain) for chain in mychains])
