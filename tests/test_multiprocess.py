"""Multi-PROCESS runtime (parallel/multihost.py + jax.distributed).

SURVEY §5's prescribed backend is jax.distributed + mesh; the mesh half has
virtual-device coverage everywhere, but the multi-process half needs real
processes.  This test launches TWO CPU processes wired together with
``multihost.initialize`` (one CPU device each -> a 2-device GLOBAL mesh),
runs the library's data-sharded likelihood engine (psum gradients) over the
cross-process mesh, and checks

* both processes compute IDENTICAL results (bitwise, printed checksums);
* the 2-process run matches a single-process 2-virtual-device run of the
  same program on the same keys (allclose at f64).

The reference ships its distributed path untested (SURVEY §4 "multi-node
without a cluster: nothing") — this is the beyond-reference gate.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_CHILD = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

coord, pid = sys.argv[1], int(sys.argv[2])
from mcmc_jl.parallel import multihost
multihost.initialize(coordinator_address=coord, num_processes=2,
                     process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 2, jax.devices()

import numpy as np
import jax.numpy as jnp
import mcmc_jl as mc
from mcmc_jl.parallel.sharded import (make_mesh, run_chains_sharded,
                                          sharded_glm_model)

# 2-device global mesh: data axis spans the two PROCESSES -> the psum'd
# log-lik/gradient collectives cross the process boundary
mesh = make_mesh(n_chain_devices=1, n_data_devices=2)

rng = np.random.default_rng(1)
nbeta, n_obs = 4, 16
X = np.column_stack([np.ones(n_obs), rng.standard_normal((n_obs, nbeta - 1))])
beta0 = rng.standard_normal(nbeta)
Y = (rng.random(n_obs) < 1.0 / (1.0 + np.exp(-X @ beta0))).astype(np.float64)
X, Y = jnp.asarray(X), jnp.asarray(Y)

def loglik_shard(theta, X_blk, Y_blk):
    logits = X_blk @ theta
    return jnp.dot(Y_blk, logits) - jnp.sum(jnp.logaddexp(0.0, logits))

make_model = sharded_glm_model(loglik_shard, lambda th: -0.5 * th @ th,
                               nbeta, jnp.zeros(nbeta))
final_states, infos = run_chains_sharded(
    make_model, (X, Y), mc.HMC(3, 0.1), mc.SerialMC(steps=20), mesh,
    n_chains=2, seed=0)

# outputs are global arrays; reduce to replicated scalars (addressable on
# every process) so both processes can print the same checksum
summary = float(jax.device_get(jax.jit(lambda x: x.sum())(
    infos["plogtarget"])))
pars = float(jax.device_get(jax.jit(lambda s: s.sum())(final_states.pars)))
print(f"CHECKSUM {summary:.17e} {pars:.17e}")
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _single_process_reference():
    """Same program on a single process with 2 virtual devices."""
    code = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp
import mcmc_jl as mc
from mcmc_jl.parallel.sharded import (make_mesh, run_chains_sharded,
                                          sharded_glm_model)
mesh = make_mesh(n_chain_devices=1, n_data_devices=2,
                 devices=jax.devices()[:2])
rng = np.random.default_rng(1)
nbeta, n_obs = 4, 16
X = np.column_stack([np.ones(n_obs), rng.standard_normal((n_obs, nbeta - 1))])
beta0 = rng.standard_normal(nbeta)
Y = (rng.random(n_obs) < 1.0 / (1.0 + np.exp(-X @ beta0))).astype(np.float64)
X, Y = jnp.asarray(X), jnp.asarray(Y)
def loglik_shard(theta, X_blk, Y_blk):
    logits = X_blk @ theta
    return jnp.dot(Y_blk, logits) - jnp.sum(jnp.logaddexp(0.0, logits))
make_model = sharded_glm_model(loglik_shard, lambda th: -0.5 * th @ th,
                               nbeta, jnp.zeros(nbeta))
final_states, infos = run_chains_sharded(
    make_model, (X, Y), mc.HMC(3, 0.1), mc.SerialMC(steps=20), mesh,
    n_chains=2, seed=0)
print(f"CHECKSUM {float(np.asarray(infos['plogtarget']).sum()):.17e} "
      f"{float(np.asarray(final_states.pars).sum()):.17e}")
"""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("CHECKSUM")][0]
    return tuple(float(t) for t in line.split()[1:])


def test_two_process_jax_distributed_psum():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, coord, str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=cwd) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            # generous timeout: the jax.distributed handshake + 2 child
            # compiles share the 2-vCPU host with the pytest process
            stdout, stderr = p.communicate(timeout=540)
            outs.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, stdout, stderr in outs:
        assert rc == 0, stderr[-2000:]
    sums = []
    for rc, stdout, stderr in outs:
        line = [ln for ln in stdout.splitlines()
                if ln.startswith("CHECKSUM")][0]
        sums.append(tuple(float(t) for t in line.split()[1:]))
    # both processes computed the identical global result (bitwise)
    assert sums[0] == sums[1], sums

    # and it matches the single-process 2-virtual-device run of the same
    # program with the same keys
    ref = _single_process_reference()
    np.testing.assert_allclose(sums[0], ref, rtol=1e-12)
