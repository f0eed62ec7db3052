"""Statistical z-score gates for the entire sampler zoo.

The reference's KS suite covers only RWM/HMC/MALA/NUTS (test_dists.jl:36-39).
Here every sampler (incl. the manifold family) must reproduce the moments of
a correlated 3-D Gaussian within Monte-Carlo error: |z| <= 5 MC-stderr on
each posterior mean, and marginal variances within 20%.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import mcmc_jl as mc

A = np.array([[1.0, 0.3, 0.0], [0.3, 2.0, 0.2], [0.0, 0.2, 0.5]])
AINV = np.linalg.inv(A)
MU = np.array([0.5, -0.3, 0.2])


def _model():
    Aj = jnp.asarray(A)
    mu = jnp.asarray(MU)
    return mc.model(
        lambda v: -0.5 * (v - mu) @ Aj @ (v - mu),
        gradient=True, tensor=True, dtensor=True,
        init=jnp.asarray(MU + 0.5), check_init=False,
    )


CASES = [
    ("RWM", mc.RWM(0.8), 20000, 4000),
    ("IMH", mc.IMH(mc.MvNormal(jnp.zeros(3), 4.0 * jnp.eye(3))), 20000, 4000),
    ("RAM", mc.RAM(1.0, 0.3), 20000, 4000),
    ("MALA", mc.MALA(0.5), 16000, 3000),
    ("MALA+tuner", mc.MALA(0.1, mc.EmpMCTuner(0.574)), 16000, 3000),
    ("Barker", mc.Barker(0.8), 16000, 3000),
    ("Barker+tuner", mc.Barker(0.1, mc.EmpMCTuner(0.57)), 16000, 3000),
    ("HMC", mc.HMC(10, 0.4), 6000, 1000),
    ("HMC+tuner", mc.HMC(10, 0.1, mc.EmpMCTuner(0.8)), 6000, 1000),
    ("HMCDA", mc.HMCDA(len=2.0), 6000, 1000),
    ("NUTS", mc.NUTS(), 6000, 1000),
    ("NUTS+multinomial", mc.NUTS(multinomial=True), 6000, 1000),
    ("NUTS+multinomial+dense", mc.NUTS(multinomial=True, mass_adapt="dense"),
     6000, 1000),
    ("WALNUTS", mc.WALNUTS(multinomial=True), 6000, 1000),
    ("HMC+2stage", mc.HMC(5, 0.6, integrator="2stage"), 6000, 1000),
    ("HMC+3stage", mc.HMC(4, 0.9, integrator="3stage"), 6000, 1000),
    ("SMMALA", mc.SMMALA(1.2), 10000, 2000),
    ("PMALA", mc.PMALA(1.2), 10000, 2000),
    ("RMHMC", mc.RMHMC(4, 0.6), 3000, 500),
    ("ERMLMC", mc.ERMLMC(4, 0.5), 3000, 500),
    ("RMLMC", mc.RMLMC(4, 0.5), 3000, 500),
]


@pytest.mark.parametrize("name,sampler,steps,burnin", CASES,
                         ids=[c[0] for c in CASES])
def test_sampler_moments(name, sampler, steps, burnin):
    m = _model()
    chain = mc.run(m, sampler, mc.SerialMC(steps=steps, burnin=burnin), seed=1)
    x = chain.samples.values
    assert np.all(np.isfinite(x)), name

    mcse = np.sqrt(mc.var(chain))
    z = np.abs(x.mean(axis=0) - MU) / np.maximum(mcse, 1e-12)
    assert np.all(z < 5), f"{name}: posterior-mean z-scores {z}"

    sd_target = np.sqrt(np.diag(AINV))
    np.testing.assert_allclose(x.std(axis=0, ddof=1), sd_target, rtol=0.2,
                               err_msg=name)

    if "accept" in chain.diagnostics:
        acc = mc.acceptance(chain)
        assert acc > 5, f"{name}: acceptance {acc}%"
