"""Checkpoint/resume round-trip (SURVEY §5: strictly-better-than-reference
resume — reference chains die with the Julia session)."""
import jax.numpy as jnp
import numpy as np

import mcmc_jl as mc
from mcmc_jl.utils.io import load_chain, load_task_into, save_chain, save_task


def _model():
    return mc.model(lambda v: -jnp.dot(v, v), grad=lambda v: -2 * v,
                    init=jnp.ones(2))


def test_task_roundtrip(tmp_path):
    m = _model()
    c1 = mc.run(m * mc.MALA(0.5, mc.EmpMCTuner(0.6)) * mc.SerialMC(steps=300),
                seed=5)
    p = str(tmp_path / "task.npz")
    save_task(p, c1.task)

    fresh = mc.MCMCTask(m, c1.task.sampler, c1.task.runner)
    restored = load_task_into(p, fresh)
    np.testing.assert_array_equal(np.asarray(restored.state.pars),
                                  np.asarray(c1.task.state.pars))
    # tuner state survives (the reference loses it on resume)
    np.testing.assert_array_equal(np.asarray(restored.state.tune.step_size),
                                  np.asarray(c1.task.state.tune.step_size))
    assert restored.pos == c1.task.pos

    # resumed run from the restored task == resumed run from the live task
    c_live = mc.resume(c1.task, steps=100)
    c_disk = mc.resume(restored, steps=100)
    np.testing.assert_array_equal(c_live.samples.values, c_disk.samples.values)


def test_chain_roundtrip(tmp_path):
    m = _model()
    c1 = mc.run(m * mc.HMC(5, 0.3) * mc.SerialMC(steps=200, burnin=50), seed=2)
    p = str(tmp_path / "chain.npz")
    save_chain(p, c1)

    fresh = mc.MCMCTask(m, c1.task.sampler, c1.task.runner)
    c2 = load_chain(p, fresh)
    np.testing.assert_array_equal(c1.samples.values, c2.samples.values)
    np.testing.assert_array_equal(c1.gradients.values, c2.gradients.values)
    assert c1.samples.columns == c2.samples.columns
    np.testing.assert_array_equal(np.asarray(c1.diagnostics["accept"]),
                                  np.asarray(c2.diagnostics["accept"]))
    assert c2.range == c1.range
    # and it resumes
    c3 = mc.resume(c2, steps=50)
    assert c3.samples.nrow == 50
