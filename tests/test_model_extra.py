"""Model-layer extras: debug mode, auto tensor/dtensor, scale handling."""
import jax
import jax.numpy as jnp
import numpy as np

import mcmc_jl as mc


def test_debug_returns_jaxpr():
    def ex(x):
        mc.tilde(x, mc.Normal(0.0, 1.0))

    jaxpr = mc.model(ex, x=np.zeros(2), debug=True)
    assert type(jaxpr).__name__ == "ClosedJaxpr"
    s = str(jaxpr)
    assert "add" in s or "mul" in s


def test_auto_tensor_dtensor_match_analytic():
    """tensor=True derives -Hessian; for the Gaussian -0.5 x'Ax the metric is
    A and dG = 0."""
    A = jnp.asarray(np.array([[2.0, 0.3], [0.3, 1.0]]))

    m = mc.model(lambda v: -0.5 * v @ A @ v, gradient=True, tensor=True,
                 dtensor=True, init=jnp.zeros(2), check_init=False)
    G = np.asarray(m.evalt(jnp.asarray([0.3, -0.2])))
    np.testing.assert_allclose(G, np.asarray(A), rtol=1e-8)
    dG = np.asarray(m.evaldt(jnp.asarray([0.3, -0.2])))
    np.testing.assert_allclose(dG, 0.0, atol=1e-10)

    lp, g, G2, dG2 = m.evalalldt(jnp.asarray([0.3, -0.2]))
    np.testing.assert_allclose(np.asarray(G2), np.asarray(A), rtol=1e-8)


def test_with_scale():
    m = mc.model(lambda v: -jnp.dot(v, v), init=jnp.ones(3))
    m2 = m.with_scale(jnp.asarray([10.0, 1.0, 0.1]))
    np.testing.assert_allclose(np.asarray(m2.scale), [10.0, 1.0, 0.1])
    # original untouched (frozen dataclass semantics)
    np.testing.assert_allclose(np.asarray(m.scale), 1.0)


def test_scalar_init_and_default_pmap():
    m = mc.model(lambda v: -jnp.sum(v * v), init=2.0)
    assert m.size == 1
    assert m.pmap == {"pars": (1, (1,))}
    assert m.column_names() == ["pars.1"]


def test_multihost_helpers_single_process():
    from mcmc_jl.parallel import multihost

    multihost.initialize(num_processes=1)
    mesh = multihost.global_mesh()
    assert mesh.devices.size == len(jax.devices())
    s, e = multihost.process_chain_slice(16)
    assert (s, e) == (0, 16)
    assert multihost.scaling_efficiency(100.0, 180.0, 2) == 0.9
