"""model(glm=...) and the kernel route through the standard run()/prun API.

The GPU GLM trajectory kernel (ops/glm_hmc.py) is reached from the normal
multi-chain surface, ``mc.run(task, chains=N, fused=...)``; one function,
``parallel.pchains.kernel_route``, decides the engine.  Off the GPU these
tests pass ``interpret=True``, which runs the kernel in the Pallas
interpreter, and compare with the generic vmapped engine."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mcmc_jl as mc
from mcmc_jl.core.task import MCMCTask
from mcmc_jl.parallel.pchains import KERNEL_MIN_CHAINS, kernel_route


def _data(n=90, d=4, seed=3):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    beta = rng.standard_normal(d) * 0.7
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    return X, Y


def test_glm_model_matches_manual_logp():
    X, Y = _data()
    rng = np.random.default_rng(0)
    w = rng.uniform(0.5, 2.0, X.shape[0])
    o = 0.2 * rng.standard_normal(X.shape[0])
    m = mc.model(glm=("logistic", X, Y), weights=w, offsets=o, prior_prec=2.0)
    th = jnp.asarray(rng.standard_normal(4) * 0.3)
    z = jnp.asarray(X) @ th + jnp.asarray(o)
    want = (jnp.sum(jnp.asarray(w) * (z * jnp.asarray(Y) - jnp.logaddexp(0.0, z)))
            - 1.0 * th @ th)
    np.testing.assert_allclose(float(m.eval(th)), float(want), rtol=1e-10)
    g_auto = jax.grad(lambda t: m.eval(t))(th)
    np.testing.assert_allclose(np.asarray(m.evalg(th)), np.asarray(g_auto),
                               atol=1e-8)


@pytest.fixture
def f32():
    """The kernel route computes in f32."""
    with jax.enable_x64(False):
        yield


def test_fused_routing_matches_generic(f32):
    X, Y = _data()
    m = mc.model(glm=("logistic", X, Y))
    task = m * mc.HMC(5, 0.1) * mc.SerialMC(steps=800, burnin=200)

    chains_fused = mc.run(task, chains=8, seed=0, fused=True, interpret=True)
    chains_gen = mc.run(task, chains=8, seed=0, fused=False)
    assert len(chains_fused) == 8

    def pooled_mean(chains):
        return np.mean([c.samples.values.mean(0) for c in chains], axis=0)

    mu_f, mu_g = pooled_mean(chains_fused), pooled_mean(chains_gen)
    se = np.sqrt(np.mean([mc.var(c) for c in chains_gen], axis=0) / 8)
    assert np.all(np.abs(mu_f - mu_g) < 6 * se + 0.05), (mu_f, mu_g, se)

    c0 = chains_fused[0]
    # full protocol present
    for k in ("accept", "logtarget"):
        assert k in c0.diagnostics
    assert c0.gradients.shape[0] == c0.samples.shape[0]  # pgrads stored
    acc = mc.acceptance(c0)
    assert acc > 40, acc

    # resume continues from the kernel's final state through the generic path
    c1 = mc.resume(c0, steps=100)
    assert np.all(np.isfinite(c1.samples.values))


def test_fused_routing_requires_plain_hmc():
    X, Y = _data()
    m = mc.model(glm=("logistic", X, Y))
    r = mc.SerialMC(steps=100, burnin=10)
    C = max(KERNEL_MIN_CHAINS.values())

    def route(model, sampler):
        return kernel_route(MCMCTask(model, sampler, r), C, backend="gpu")

    assert route(m, mc.HMC(5, 0.1))
    assert route(m, mc.MALA(0.02))
    assert not route(m, mc.HMC(5, 0.1, mass_adapt=True))
    assert not route(m, mc.HMC(5, 0.1, mc.EmpMCTuner(0.8)))
    assert not route(m, mc.HMC(5, 0.1, True))  # store_leaps
    assert not route(m, mc.NUTS())
    m2 = mc.model(lambda v: -v @ v, gradient=True, init=jnp.zeros(2),
                  check_init=False)
    assert not route(m2, mc.HMC(5, 0.1))


def test_fused_logtarget_diag_is_exact(f32):
    """Padded momentum lanes must not leak into the Hamiltonian: the
    kernel route's logtarget diagnostic equals the model's log-density at
    the stored samples."""
    X, Y = _data(n=60, d=4, seed=5)
    m = mc.model(glm=("logistic", X, Y))
    task = m * mc.HMC(5, 0.1) * mc.SerialMC(steps=200, burnin=50)
    c = mc.run(task, chains=2, seed=0, fused=True, interpret=True)[0]
    lp_true = np.array([float(m.eval(jnp.asarray(row, jnp.float32)))
                        for row in c.samples.values])
    np.testing.assert_allclose(c.diagnostics["logtarget"], lp_true,
                               rtol=1e-4, atol=5e-3)


def test_glmspec_identity_hash():
    X, Y = _data(n=30, d=3, seed=6)
    m = mc.model(glm=("logistic", X, Y))
    hash(m.glm_spec)  # must not raise
    assert m.glm_spec == m.glm_spec
    assert m.glm_spec != mc.model(glm=("logistic", X, Y)).glm_spec


def test_fused_routing_multistage_integrator(f32):
    """HMC(integrator="2stage") on a GLM posterior runs through the kernel
    (which implements the scheme) and matches the generic engine."""
    X, Y = _data()
    m = mc.model(glm=("logistic", X, Y))
    r = mc.SerialMC(steps=800, burnin=200)
    s = mc.HMC(4, 0.2, integrator="2stage")
    assert kernel_route(MCMCTask(m, s, r), 8, backend="gpu", fused=True)

    task = m * s * r
    chains_fused = mc.run(task, chains=8, seed=0, fused=True, interpret=True)
    chains_gen = mc.run(task, chains=8, seed=0, fused=False)
    mu_f = np.mean([c.samples.values.mean(0) for c in chains_fused], axis=0)
    mu_g = np.mean([c.samples.values.mean(0) for c in chains_gen], axis=0)
    se = np.sqrt(np.mean([mc.var(c) for c in chains_gen], axis=0) / 8)
    assert np.all(np.abs(mu_f - mu_g) < 6 * se + 0.05), (mu_f, mu_g)


def test_target_routing_matches_generic():
    """A non-GLM model has no kernel: "auto" takes the generic engine and
    gives exactly the fused=False chains; fused=True raises and says why."""
    d = 3

    def logp(v):
        return -0.5 * jnp.sum((v - 1.0) ** 2 / 4.0)

    m = mc.model(logp, gradient=True, init=jnp.zeros(d), check_init=False)
    task = m * mc.HMC(6, 0.5) * mc.SerialMC(steps=600, burnin=200)
    with pytest.raises(ValueError, match="model"):
        mc.run(task, chains=8, seed=0, fused=True, interpret=True)
    chains_auto = mc.run(task, chains=8, seed=0)
    chains_gen = mc.run(task, chains=8, seed=0, fused=False)
    for a, b in zip(chains_auto, chains_gen):
        np.testing.assert_array_equal(a.samples.values, b.samples.values)

    sf = np.concatenate([c.samples.values for c in chains_auto], axis=0)
    se = sf.std(0) / np.sqrt(np.mean([mc.ess(c) for c in chains_auto]) * 8)
    assert np.all(np.abs(sf.mean(0) - 1.0) < 8 * se + 0.05), (sf.mean(0), se)
    assert np.all(np.abs(sf.std(0) - 2.0) < 0.3), sf.std(0)
    c1 = mc.resume(chains_auto[0], steps=50)
    assert np.all(np.isfinite(c1.samples.values))


def test_fused_mala_routing_matches_generic(f32):
    """Plain MALA runs through the kernel as one-leapfrog HMC (drift step
    s == eps^2; MALA.jl:65-126 vs HMC.jl:93-102)."""
    X, Y = _data()
    m = mc.model(glm=("logistic", X, Y))
    task = m * mc.MALA(0.02) * mc.SerialMC(steps=1200, burnin=300)

    chains_fused = mc.run(task, chains=8, seed=0, fused=True, interpret=True)
    chains_gen = mc.run(task, chains=8, seed=0, fused=False)

    def pooled_mean(chains):
        return np.mean([c.samples.values.mean(0) for c in chains], axis=0)

    mu_f, mu_g = pooled_mean(chains_fused), pooled_mean(chains_gen)
    se = np.sqrt(np.mean([mc.var(c) for c in chains_gen], axis=0) / 8)
    assert np.all(np.abs(mu_f - mu_g) < 6 * se + 0.05), (mu_f, mu_g, se)
    # acceptance statistics must agree too (the MH ratio is identical)
    acc_f = np.mean([mc.acceptance(c) for c in chains_fused])
    acc_g = np.mean([mc.acceptance(c) for c in chains_gen])
    assert abs(acc_f - acc_g) < 12, (acc_f, acc_g)

    # final states are exact-resume MALAStates
    from mcmc_jl.samplers.mala import MALAState

    st = chains_fused[0].task.state
    assert isinstance(st, MALAState)
    c1 = mc.resume(chains_fused[0], steps=100)
    assert np.all(np.isfinite(c1.samples.values))


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize("fused", ["auto", True, False])
def test_kernel_route_by_backend(backend, fused):
    """The route given a backend name: the kernel only on the GPU, unless
    the caller asks for the interpreter."""
    X, Y = _data()
    t = MCMCTask(mc.model(glm=("logistic", X, Y)), mc.HMC(5, 0.1),
                 mc.SerialMC(steps=10))
    C = KERNEL_MIN_CHAINS["hmc"]
    if fused is False:
        assert not kernel_route(t, C, backend=backend, fused=fused)
    elif backend == "gpu":
        assert kernel_route(t, C, backend=backend, fused=fused)
    elif fused is True:
        with pytest.raises(ValueError, match="GPU"):
            kernel_route(t, C, backend=backend, fused=fused)
        assert kernel_route(t, C, backend=backend, fused=fused,
                            interpret=True)
    else:
        assert not kernel_route(t, C, backend=backend, fused=fused)


def _refusal_cases():
    X, Y = _data()
    glm = mc.model(glm=("logistic", X, Y))
    r = mc.SerialMC(steps=10)
    wide = mc.model(glm=("logistic", np.ones((20, 65)), np.ones(20)))
    return {
        "x64": (glm, mc.HMC(5, 0.1), dict(x64=True), "float32"),
        "not_glm": (mc.model(lambda v: -v @ v, gradient=True,
                             init=jnp.zeros(2), check_init=False),
                    mc.HMC(5, 0.1), {}, "model"),
        "tuned_hmc": (glm, mc.HMC(5, 0.1, mc.EmpMCTuner(0.8)), {},
                      "sampler"),
        "hmcda": (glm, mc.HMCDA(), {}, "sampler"),
        "nuts": (glm, mc.NUTS(), {}, "sampler"),
        "probit": (mc.model(glm=("probit", X, Y)), mc.HMC(5, 0.1), {},
                   "links"),
        "custom_link": (mc.model(glm=((lambda z, y: -z * z,
                                       lambda z, y: -2 * z), X, Y)),
                        mc.HMC(5, 0.1), {}, "links"),
        "wide": (wide, mc.HMC(5, 0.1), {}, "d <="),
    }, r


@pytest.mark.parametrize("case", ["x64", "not_glm", "tuned_hmc", "hmcda",
                                  "nuts", "probit", "custom_link", "wide"])
def test_kernel_route_refusals(case):
    """Every condition the kernel needs: "auto" quietly takes the generic
    engine, fused=True raises with the reason."""
    cases, r = _refusal_cases()
    model, sampler, kw, why = cases[case]
    t = MCMCTask(model, sampler, r)
    assert not kernel_route(t, 10 ** 6, backend="gpu", **kw)
    with pytest.raises(ValueError, match=why):
        kernel_route(t, 10 ** 6, backend="gpu", fused=True, **kw)


@pytest.mark.parametrize("sampler", ["hmc", "mala"])
def test_kernel_route_min_chains(sampler):
    """"auto" takes the kernel from the sampler's KERNEL_MIN_CHAINS chains;
    fused=True takes it at any count."""
    X, Y = _data()
    s = mc.HMC(5, 0.1) if sampler == "hmc" else mc.MALA(0.02)
    t = MCMCTask(mc.model(glm=("logistic", X, Y)), s, mc.SerialMC(steps=10))
    n = KERNEL_MIN_CHAINS[sampler]
    assert not kernel_route(t, n - 1, backend="gpu")
    assert kernel_route(t, n, backend="gpu")
    assert kernel_route(t, 2, backend="gpu", fused=True)


@pytest.mark.parametrize("case", ["linear", "poisson", "d20", "d64"])
def test_kernel_route_auto_only_where_measured(case):
    """Links and widths the kernel serves but was not timed on stay on the
    generic engine under "auto"; fused=True still takes the kernel."""
    kind = case if case in ("linear", "poisson") else "logistic"
    d = int(case[1:]) if case.startswith("d") else 4
    X, Y = _data(d=d)
    if kind == "poisson":
        Y = np.round(2 * Y)
    t = MCMCTask(mc.model(glm=(kind, X, Y)), mc.HMC(5, 0.1),
                 mc.SerialMC(steps=10))
    assert not kernel_route(t, 10 ** 6, backend="gpu")
    assert kernel_route(t, 10 ** 6, backend="gpu", fused=True)


def test_fused_true_off_gpu_raises():
    """Without a GPU and without interpret=True, fused=True raises before
    any sampling."""
    X, Y = _data()
    task = (mc.model(glm=("logistic", X, Y)) * mc.HMC(5, 0.1)
            * mc.SerialMC(steps=10))
    with pytest.raises(ValueError, match="GPU"):
        mc.run(task, chains=4, fused=True)
