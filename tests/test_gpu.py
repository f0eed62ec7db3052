"""Checks that need the GPU: the Triton GLM kernel compiled for the card,
against the same trajectory in the Pallas interpreter.  They skip
elsewhere; run them on a GPU with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU")
    with jax.enable_x64(False):  # the kernel computes in f32
        yield


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["logistic", "linear", "poisson"])
def test_compiled_kernel_matches_interpreter(gpu, kind):
    from mcmc_jl.ops.pallas_glm import (glm_trajectory, pad_chains,
                                        pad_design, padded_dim)

    rng = np.random.default_rng(0)
    n, d, C = 700, 10, 512
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    Y = (rng.random(n) < 0.5).astype(np.float64)
    XT, Yp, W, O = pad_design(X, Y, weights=rng.uniform(0.5, 2, n))
    D = padded_dim(d)
    th = pad_chains(jnp.asarray(0.05 * rng.standard_normal((C, d)),
                                jnp.float32), D)
    m = pad_chains(jnp.asarray(rng.standard_normal((C, d)), jnp.float32), D)
    kw = dict(n_obs=n, n_leaps=5, eps=0.02, kind=kind, lam=2.0)
    out = glm_trajectory(XT, Yp, W, O, th, m, jnp.zeros_like(th), **kw)
    ref = glm_trajectory(XT, Yp, W, O, th, m, jnp.zeros_like(th),
                         interpret=True, **kw)
    # the card's interior products are TF32, the interpreter's exact f32
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(ref[0]),
                               atol=2e-3)
    lp, lp_ref = np.asarray(out[3]), np.asarray(ref[3])
    np.testing.assert_allclose(lp, lp_ref, rtol=1e-3)
