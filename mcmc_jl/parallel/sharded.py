"""Mesh-sharded chain engine with a data-sharded likelihood.

The reference's only scale axes are chains/particles and the data rows of
the likelihood (SURVEY §2.4): there is no tensor/pipeline/sequence
parallelism to mirror, so the device mesh here is 2-D —

    mesh = ('chains', 'data')

- **chains** is pure data parallelism over independent chains (the
  reference's ``prun`` process pool, runners.jl:35-42);
- **data** shards the likelihood's observation rows: each device computes
  the log-likelihood / gradient contribution of its shard and a
  ``psum('data')`` reduces them — the analog of "model parallelism" for
  MCMC, useful when the dataset behind ``logp`` is large.

Implementation: ``shard_map`` over the whole scan; inside the body a
:class:`LogDensityModel` is rebuilt closing over the *local* data shard with
the ``psum`` baked into its ``eval``/``evalallg``, so every generic sampler
kernel (HMC, MALA, NUTS, ...) runs unchanged on sharded data — collectives
stay on the devices, the host never sees a per-step boundary.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..models.model import LogDensityModel
from ..samplers.base import RunCtx

CHAIN_AXIS = "chains"
DATA_AXIS = "data"


def make_mesh(n_chain_devices=None, n_data_devices=1, devices=None):
    """A ('chains', 'data') mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    if n_chain_devices is None:
        n_chain_devices = len(devices) // n_data_devices
    devs = np.array(devices[: n_chain_devices * n_data_devices]).reshape(
        n_chain_devices, n_data_devices
    )
    return Mesh(devs, (CHAIN_AXIS, DATA_AXIS))


def sharded_glm_model(loglik_shard, prior, size, init, scale=1.0):
    """Build a LogDensityModel whose likelihood is data-sharded.

    ``loglik_shard(theta, *data_shards) -> scalar`` is the log-likelihood
    contribution of the local shard; ``prior(theta) -> scalar`` is counted
    once (it is replicated, so it is added outside the psum).  Returns a
    factory ``make(data_shards) -> LogDensityModel`` for use inside a
    shard_map body.
    """

    def make(*shards):
        # NOTE: inside shard_map, theta is a per-device (replicated) value,
        # so jax.grad of a psum'd sum gives only the LOCAL shard's gradient
        # contribution — the gradient must be psum'd explicitly as well.
        def loglik_local(theta):
            return loglik_shard(theta, *shards)

        vag_local = jax.value_and_grad(loglik_local)
        vag_prior = jax.value_and_grad(prior)

        def logp(theta):
            ll = jax.lax.psum(loglik_local(theta), DATA_AXIS)
            return ll + prior(theta)

        def evalallg(theta):
            ll, gl = vag_local(theta)
            ll = jax.lax.psum(ll, DATA_AXIS)
            gl = jax.lax.psum(gl, DATA_AXIS)
            pl, gp = vag_prior(theta)
            lp = ll + pl
            g = gl + gp
            lp = jnp.where(jnp.isnan(lp), -jnp.inf, lp)
            g = jnp.where(jnp.isfinite(lp), jnp.nan_to_num(g), 0.0)
            return lp, g

        return LogDensityModel(
            eval=logp,
            evalg=lambda th: evalallg(th)[1],
            evalt=None,
            evaldt=None,
            evalallg=evalallg,
            evalallt=None,
            evalalldt=None,
            pmap={"pars": (1, (size,))},
            size=size,
            init=init,
            scale=jnp.broadcast_to(jnp.asarray(scale, init.dtype), (size,)),
        )

    return make


def run_chains_sharded(make_model, data, sampler, runner, mesh, n_chains,
                       key=None, seed=0, inits=None, data_specs=None):
    """Run ``n_chains`` chains of ``sampler`` under a 2-D mesh.

    - ``make_model(*local_shards) -> LogDensityModel`` (e.g. from
      :func:`sharded_glm_model`)
    - ``data``: tuple of global arrays, each sharded along axis 0 over
      ``'data'`` (pass ``data_specs`` to override)
    - chains are sharded over ``'chains'``; PRNG keys follow the chains.

    Returns (final_states, infos) with infos stacked as (steps, chains, ...).
    """
    if key is None:
        key = jax.random.PRNGKey(seed)
    k_init, k_run = jax.random.split(key)

    example_model = make_model(*data)  # full-data model for init (host-side)
    if inits is None:
        inits = jnp.broadcast_to(example_model.init, (n_chains, example_model.size))
    init_keys = jax.random.split(k_init, n_chains)
    step_keys = jax.random.split(k_run, runner.len * n_chains).reshape(
        runner.len, n_chains, -1
    )

    if data_specs is None:
        data_specs = tuple(
            P(DATA_AXIS) if np.ndim(d) == 1 else P(DATA_AXIS, None) for d in data
        )

    ctx = RunCtx(burnin=runner.burnin)

    # check_vma=False: the body mixes data-axis psums (inside the
    # model's sharded likelihood) with chain-sharded state the checker
    # sees as varying over BOTH axes — the inferred vma for the psum'd
    # gradient conflicts with the replicated-out spec even though the
    # value is equal on every data shard by construction.  Correctness
    # is gated by the bitwise sharded-vs-unsharded tests
    # (tests/test_sharded.py) — a regression breaks those, not this.
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(CHAIN_AXIS, None), P(CHAIN_AXIS, None),
                  P(None, CHAIN_AXIS, None)) + tuple(data_specs),
        out_specs=(P(CHAIN_AXIS), P(None, CHAIN_AXIS)),
        check_vma=False,
    )
    def body(inits_blk, init_keys_blk, step_keys_blk, *shards):
        model = make_model(*shards)
        init_one = lambda th, k: sampler.init(model, th, k)  # noqa: E731
        states = jax.vmap(init_one)(inits_blk, init_keys_blk)

        def one_step(states, ks):
            return jax.vmap(lambda s, k: sampler.step(model, ctx, s, k))(states, ks)

        return jax.lax.scan(one_step, states, step_keys_blk)

    return jax.jit(body)(inits, init_keys, step_keys, *data)
