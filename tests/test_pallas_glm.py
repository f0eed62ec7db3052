"""GPU GLM trajectory kernel (ops/pallas_glm.py) in the Pallas interpreter.

The kernel is checked against a plain float64 reference of the same
integrator over links x weights/offsets x integrators x chain counts that
are and are not multiples of the chain tile; the XLA driver
(ops/glm_hmc.py) against the generic engine; and the wrapper's padding and
refusals.  On the CPU the interpreter computes every product in exact f32,
so the tolerances below are f32 rounding over a few leapfrogs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mcmc_jl as mc
from mcmc_jl.models.glm import link_terms
from mcmc_jl.ops.pallas_glm import (
    BLOCK_CHAINS, BLOCK_OBS, KERNEL_LINKS, glm_trajectory, pad_chains,
    pad_design, padded_dim,
)
from mcmc_jl.samplers.integrators import SCHEDULES


@pytest.fixture(autouse=True)
def _f32():
    """The kernel and its driver compute in f32."""
    with jax.enable_x64(False):
        yield


def _data(n=64, d=6, seed=0, kind="logistic"):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    beta = rng.standard_normal(d) * 0.5
    if kind == "linear":
        Y = X @ beta + rng.standard_normal(n)
    elif kind == "poisson":
        Y = rng.poisson(np.exp(0.3 * X @ beta)).astype(np.float64)
    else:
        Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(float)
    return X.astype(np.float32), Y.astype(np.float32)


def _ref_trajectory(X, Y, theta, m, eps, n_leaps, *, kind="logistic",
                    w=None, o=None, lam=1.0, integrator="leapfrog"):
    """Plain float64 numpy trajectory of the same kick/drift schedule."""
    ll_fn, resid_fn = link_terms(kind)
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)

    def lpg(th):
        z = th @ X.T + (0.0 if o is None else o)
        r = np.asarray(resid_fn(z, Y))
        ll = np.asarray(ll_fn(z, Y))
        if w is not None:
            r, ll = r * w, ll * w
        return (ll.sum(1) - 0.5 * lam * (th * th).sum(1),
                r @ X - lam * th)

    th = np.asarray(theta, np.float64)
    m = np.asarray(m, np.float64)
    lp, g = lpg(th)
    for _ in range(n_leaps):
        for op, c in SCHEDULES[integrator]:
            if op == "B":
                m = m + c * eps * g
            else:
                th = th + c * eps * m
                lp, g = lpg(th)
    return th, m, g, lp


def _kernel(X, Y, theta, m, g, eps, n_leaps, **kw):
    C, d = theta.shape
    XT, Yp, W, O = pad_design(X, Y, kw.pop("w", None), kw.pop("o", None))
    D = padded_dim(d)
    out = glm_trajectory(XT, Yp, W, O, pad_chains(theta, D),
                         pad_chains(m, D), pad_chains(g, D),
                         n_obs=X.shape[0], n_leaps=n_leaps, eps=eps,
                         interpret=True, **kw)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("n_chains", [96, 2 * BLOCK_CHAINS])
@pytest.mark.parametrize("integrator", ["leapfrog", "2stage", "3stage"])
@pytest.mark.parametrize("extras", ["none", "weights", "offsets", "both"])
@pytest.mark.parametrize("kind", list(KERNEL_LINKS))
def test_kernel_matches_f64_reference(kind, extras, integrator, n_chains):
    d, n = 5, 150  # n pads to 2 observation tiles, d to 16
    X, Y = _data(n=n, d=d, seed=1, kind=kind)
    rng = np.random.default_rng(2)
    w = rng.uniform(0.5, 2.0, n) if extras in ("weights", "both") else None
    o = 0.3 * rng.standard_normal(n) if extras in ("offsets", "both") else None
    lam = 1.0 if extras == "none" else 2.5
    theta = 0.1 * rng.standard_normal((n_chains, d))
    m = rng.standard_normal((n_chains, d))
    eps, n_leaps = 0.02, 3
    _, _, g0, _ = _ref_trajectory(X, Y, theta, m, eps, 0, kind=kind, w=w,
                                  o=o, lam=lam)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    th_k, m_k, g_k, lp_k = _kernel(
        X, Y, f32(theta), f32(m), f32(g0), eps, n_leaps, kind=kind, w=w,
        o=o, lam=lam, integrator=integrator)
    th_r, m_r, g_r, lp_r = _ref_trajectory(
        X, Y, theta, m, eps, n_leaps, kind=kind, w=w, o=o, lam=lam,
        integrator=integrator)
    C = n_chains
    np.testing.assert_allclose(th_k[:C, :d], th_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m_k[:C, :d], m_r, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g_k[:C, :d], g_r,
                               rtol=1e-4, atol=1e-4 * np.abs(g_r).max())
    np.testing.assert_allclose(lp_k[:C], lp_r, rtol=1e-5,
                               atol=1e-6 * np.abs(lp_r).max())
    # padded coordinates stay exactly zero
    assert np.all(th_k[:, d:] == 0) and np.all(g_k[:, d:] == 0)


def test_kernel_matches_reference_trajectory():
    X, Y = _data()
    C, d = 8, X.shape[1]
    rng = np.random.default_rng(1)
    theta = rng.standard_normal((C, d)) * 0.1
    m = rng.standard_normal((C, d))
    _, _, g, _ = _ref_trajectory(X, Y, theta, m, 0.1, 0)
    th1, m1, g1, lp1 = _kernel(X, Y, jnp.asarray(theta, jnp.float32),
                               jnp.asarray(m, jnp.float32),
                               jnp.asarray(g, jnp.float32), 0.1, 5)
    th2, m2, g2, lp2 = _ref_trajectory(X, Y, theta, m, 0.1, 5)
    np.testing.assert_allclose(th1[:C, :d], th2, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(m1[:C, :d], m2, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lp1[:C], lp2, rtol=2e-5, atol=2e-4)
    assert np.all(th1[:, d:] == 0) and np.all(g1[:, d:] == 0)


@pytest.mark.parametrize("d, D", [(1, 16), (10, 16), (16, 16), (17, 32),
                                  (64, 64)])
def test_pad_design_shapes(d, D):
    n = 300
    X = np.arange(n * d, dtype=np.float32).reshape(n, d)
    XT, Yp, W, O = pad_design(X, np.ones(n), weights=np.ones(n))
    assert padded_dim(d) == D
    assert XT.shape == (D, 3 * BLOCK_OBS) and Yp.shape == (3 * BLOCK_OBS,)
    assert O is None and W.shape == Yp.shape
    np.testing.assert_array_equal(np.asarray(XT)[:d, :n], X.T)
    assert not np.asarray(XT)[d:].any() and not np.asarray(XT)[:, n:].any()
    assert not np.asarray(W)[n:].any() and not np.asarray(Yp)[n:].any()


@pytest.mark.parametrize("C", [1, BLOCK_CHAINS - 1, BLOCK_CHAINS,
                               BLOCK_CHAINS + 1, 1000])
def test_pad_chains_shapes(C):
    th = jnp.ones((C, 3))
    out = pad_chains(th, 16)
    assert out.shape == (-(-C // BLOCK_CHAINS) * BLOCK_CHAINS, 16)
    assert float(out.sum()) == 3 * C


def test_kernel_raises_off_gpu_without_interpret():
    X, Y = _data(n=40, d=3)
    XT, Yp, _, _ = pad_design(X, Y)
    z = jnp.zeros((BLOCK_CHAINS, 16), jnp.float32)
    with pytest.raises(RuntimeError, match="GPU"):
        glm_trajectory(XT, Yp, None, None, z, z, z, n_obs=40, n_leaps=1,
                       eps=0.1)


@pytest.mark.parametrize("kind", ["probit", "custom"])
def test_kernel_rejects_other_links(kind):
    X, Y = _data(n=40, d=3)
    XT, Yp, _, _ = pad_design(X, Y)
    z = jnp.zeros((BLOCK_CHAINS, 16), jnp.float32)
    link = kind if kind == "probit" else (lambda z, y: z, lambda z, y: y)
    with pytest.raises(ValueError, match="links"):
        glm_trajectory(XT, Yp, None, None, z, z, z, n_obs=40, n_leaps=1,
                       eps=0.1, kind=link, interpret=True)


def _generic_mean(X, Y, sampler, steps, burnin, n_chains=16, seed=1):
    m = mc.model(glm=("logistic", X, Y))
    ch = mc.run(m * sampler * mc.SerialMC(steps=steps, burnin=burnin),
                chains=n_chains, seed=seed, fused=False)
    return np.mean([c.samples.values.mean(0) for c in ch], axis=0)


def test_fused_sampler_posterior_matches_generic():
    from mcmc_jl.ops.glm_hmc import fused_hmc_chains

    X, Y = _data(n=80, d=4, seed=3)
    model = mc.model(glm=("logistic", X, Y))
    s = mc.HMC(5, 0.1)
    infos, states = fused_hmc_chains(model, s, mc.SerialMC(steps=600), 32,
                                     jax.random.PRNGKey(0), interpret=True)
    acc = np.mean(np.asarray(infos["accept"]))
    assert acc > 0.5, acc
    assert np.all(np.isfinite(np.asarray(infos["plogtarget"])))
    fused_mean = np.asarray(infos["ppars"])[200:].mean(axis=(0, 1))
    gen_mean = _generic_mean(X, Y, s, 600, 200)
    np.testing.assert_allclose(fused_mean, gen_mean, atol=0.15)
    # final states are resumable HMCStates at the last draws
    np.testing.assert_allclose(np.asarray(states.pars),
                               np.asarray(infos["ppars"])[-1], rtol=1e-6)


@pytest.mark.parametrize("kind", ["linear", "probit"])
def test_other_links_match_autodiff(kind):
    """linear: kernel lp/grad agree with jax.grad of the model's logp.
    probit: the model's analytic gradient agrees with jax.grad, and the
    kernel does not serve the link (the Triton route lowers no erf)."""
    rng = np.random.default_rng(5)
    n, d = 48, 5
    X, Y = _data(n=n, d=d, seed=5, kind="linear" if kind == "linear"
                 else "logistic")
    model = mc.model(glm=(kind, X, Y))
    theta = jnp.asarray(rng.standard_normal(d) * 0.2, jnp.float32)
    lp, g_auto = jax.value_and_grad(model.eval)(theta)
    np.testing.assert_allclose(np.asarray(model.evalg(theta)),
                               np.asarray(g_auto), rtol=2e-4, atol=2e-4)
    if kind == "probit":
        assert kind not in KERNEL_LINKS
        return
    z = jnp.zeros((1, d), jnp.float32)
    _, _, g1, lp1 = _kernel(X, Y, theta[None], z, z, 0.0, 1, kind=kind)
    np.testing.assert_allclose(lp1[0], float(lp), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(g1[0, :d], np.asarray(g_auto), rtol=2e-4,
                               atol=2e-4)


def test_linear_link_posterior_matches_ridge():
    """Kernel-driven linear-link HMC recovers the analytic ridge posterior."""
    from mcmc_jl.ops.glm_hmc import fused_hmc_chains

    rng = np.random.default_rng(7)
    n, d = 120, 4
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    Y = X @ rng.standard_normal(d) + rng.standard_normal(n)
    model = mc.model(glm=("linear", X, Y))
    infos, _ = fused_hmc_chains(model, mc.HMC(5, 0.05),
                                mc.SerialMC(steps=400), 64,
                                jax.random.PRNGKey(0), interpret=True)
    P = X.T @ X + np.eye(d)
    mean = np.linalg.solve(P, X.T @ Y)
    est = np.asarray(infos["ppars"])[100:].mean(axis=(0, 1))
    np.testing.assert_allclose(est, mean, atol=0.05)


def test_weights_offsets_prior_match_autodiff():
    """Weighted + offset GLM with non-unit prior precision: kernel lp/grad
    agree with jax.grad of the model's weighted logp."""
    rng = np.random.default_rng(11)
    n, d = 40, 4
    X, Y = _data(n=n, d=d, seed=11)
    w = rng.uniform(0.5, 3.0, n).astype(np.float32)
    o = (rng.standard_normal(n) * 0.3).astype(np.float32)
    lam = 2.5
    model = mc.model(glm=("logistic", X, Y), weights=w, offsets=o,
                     prior_prec=lam)
    theta = jnp.asarray(rng.standard_normal(d) * 0.2, jnp.float32)
    lp, g_auto = jax.value_and_grad(model.eval)(theta)
    z = jnp.zeros((1, d), jnp.float32)
    _, _, g1, lp1 = _kernel(X, Y, theta[None], z, z, 0.0, 1, w=w, o=o,
                            lam=lam)
    np.testing.assert_allclose(lp1[0], float(lp), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(g1[0, :d], np.asarray(g_auto), rtol=2e-4,
                               atol=2e-4)


def test_custom_link_exponential_survival():
    """A user (ll, resid) pair: exponential survival with a log-rate link,
    y ~ Exp(exp(z)).  The model's gradient matches autodiff, the generic
    engine recovers beta, and the kernel route refuses the link."""
    rng = np.random.default_rng(13)
    n, d = 60, 3
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    beta = np.array([0.3, -0.5, 0.2])
    Y = rng.exponential(1.0 / np.exp(X @ beta))
    custom = (lambda z, y: z - y * jnp.exp(z),
              lambda z, y: 1.0 - y * jnp.exp(z))
    model = mc.model(glm=(custom, X, Y))
    theta = jnp.asarray(rng.standard_normal(d) * 0.1, jnp.float32)
    np.testing.assert_allclose(np.asarray(model.evalg(theta)),
                               np.asarray(jax.grad(model.eval)(theta)),
                               rtol=2e-4, atol=2e-4)
    task = model * mc.HMC(5, 0.04) * mc.SerialMC(steps=500, burnin=100)
    with pytest.raises(ValueError, match="links"):
        mc.run(task, chains=4, fused=True, interpret=True)
    chains = mc.run(task, chains=16, seed=0)
    assert np.mean([mc.acceptance(c) for c in chains]) > 50
    est = np.mean([c.samples.values.mean(0) for c in chains], axis=0)
    np.testing.assert_allclose(est, beta, atol=0.35)


@pytest.mark.parametrize("integ", ["2stage", "3stage"])
def test_kernel_multistage_matches_generic_integrator(integ):
    """The kernel's 2/3-stage bodies match the generic
    samplers/integrators.py schemes (same f32 math)."""
    import types

    from mcmc_jl.samplers.integrators import get_integrator

    X, Y = _data()
    C, d = 8, X.shape[1]
    rng = np.random.default_rng(3)
    theta = jnp.asarray(rng.standard_normal((C, d)) * 0.1, jnp.float32)
    m = jnp.asarray(rng.standard_normal((C, d)), jnp.float32)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)

    def evalallg(th):  # batched over chains, matching the kernel layout
        logits = th @ Xj.T
        g = (Yj - jax.nn.sigmoid(logits)) @ Xj - th
        lp = (logits @ Yj - jnp.sum(jax.nn.softplus(logits), axis=1)
              - 0.5 * jnp.sum(th * th, axis=1))
        return lp, g

    step_fn, _ = get_integrator(integ)
    mod = types.SimpleNamespace(evalallg=evalallg)
    lp, g0 = evalallg(theta)
    tg, mg, g = theta, m, g0
    for _ in range(5):
        tg, lp, g, mg = step_fn(mod, tg, mg, g, jnp.float32(0.1))
    tk, mk, _, lpk = _kernel(X, Y, theta, m, g0, 0.1, 5, integrator=integ)
    np.testing.assert_allclose(tk[:C, :d], np.asarray(tg), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(mk[:C, :d], np.asarray(mg), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lpk[:C], np.asarray(lp), rtol=2e-5,
                               atol=2e-4)


def test_fused_transition_matches_composed_step():
    """The driver's first transition equals the trajectory kernel composed
    by hand with the XLA Metropolis test on the same draws."""
    from mcmc_jl.ops.glm_hmc import _logp_grad, _run

    X, Y = _data(n=72, d=5, seed=9)
    C, d = BLOCK_CHAINS, X.shape[1]
    XT, Yp, _, _ = pad_design(X, Y)
    D = padded_dim(d)
    rng = np.random.default_rng(2)
    theta = pad_chains(jnp.asarray(rng.standard_normal((C, d)) * 0.2,
                                   jnp.float32), D)
    key = jax.random.PRNGKey(4)
    kw = dict(n_obs=72, kind="logistic", lam=1.0)
    (th_f, lp_f, g_f), infos = _run(
        XT, Yp, None, None, theta, key, n_chains=C, d=d, steps=1,
        n_leaps=4, eps=0.42, integrator="leapfrog", interpret=True, **kw)

    lp, g = _logp_grad(XT, Yp, None, None, theta, interpret=True, **kw)
    k_mom, k_acc = jax.random.split(jax.random.split(key, 1)[0])
    m0 = jnp.pad(jax.random.normal(k_mom, (C, d)), ((0, 0), (0, D - d)))
    p_th, p_m, p_g, p_lp = glm_trajectory(
        XT, Yp, None, None, theta, m0, g, n_obs=72, n_leaps=4, eps=0.42,
        interpret=True)
    ratio = (-lp + 0.5 * jnp.sum(m0 * m0, 1)) - (-p_lp
                                                + 0.5 * jnp.sum(p_m ** 2, 1))
    logu = jnp.log(jax.random.uniform(k_acc, (C,)))
    acc = np.asarray((ratio > 0) | (ratio > logu))
    assert acc.any() and not acc.all(), "want a mix of accepts and rejects"
    np.testing.assert_array_equal(np.asarray(infos["accept"][0]), acc)
    a = acc[:, None]
    np.testing.assert_array_equal(
        np.asarray(th_f), np.where(a, np.asarray(p_th), np.asarray(theta)))
    np.testing.assert_array_equal(
        np.asarray(lp_f), np.where(acc, np.asarray(p_lp), np.asarray(lp)))
    np.testing.assert_array_equal(
        np.asarray(g_f), np.where(a, np.asarray(p_g), np.asarray(g)))


@pytest.mark.parametrize("kind", list(KERNEL_LINKS))
def test_driver_start_point_matches_f64_reference(kind):
    """The driver takes a chain's starting log-density and gradient from
    the kernel's end-point code (a zero-length step); they equal the
    float64 reference."""
    from mcmc_jl.ops.glm_hmc import _logp_grad

    n, d = 150, 5
    X, Y = _data(n=n, d=d, seed=4, kind=kind)
    theta = 0.1 * np.random.default_rng(6).standard_normal((BLOCK_CHAINS, d))
    XT, Yp, _, _ = pad_design(X, Y)
    lp, g = _logp_grad(XT, Yp, None, None,
                       pad_chains(jnp.asarray(theta, jnp.float32),
                                  padded_dim(d)),
                       n_obs=n, kind=kind, lam=1.0, interpret=True)
    _, _, g_r, lp_r = _ref_trajectory(X, Y, theta, np.zeros_like(theta),
                                      0.0, 0, kind=kind)
    np.testing.assert_allclose(np.asarray(lp), lp_r, rtol=1e-5,
                               atol=1e-6 * np.abs(lp_r).max())
    np.testing.assert_allclose(np.asarray(g)[:, :d], g_r, rtol=1e-4,
                               atol=1e-4 * np.abs(g_r).max())
    assert not np.asarray(g)[:, d:].any()


def test_sharded_glm_hmc_matches_per_device_runs():
    """With a device mesh, prun takes the generic engine (the kernel runs
    on one device): "auto" routes there, ``fused=True`` raises, and the
    mesh run equals the unsharded run."""
    from jax.sharding import Mesh

    from mcmc_jl.core.task import MCMCTask
    from mcmc_jl.parallel.pchains import kernel_route

    X, Y = _data(n=48, d=4, seed=5)
    m = mc.model(glm=("logistic", X, Y))
    task = m * mc.HMC(3, 0.1) * mc.SerialMC(steps=30)
    mesh = Mesh(np.array(jax.devices()[:4]), ("chains",))
    t = MCMCTask(m, task.sampler, task.runner)
    assert not kernel_route(t, 10 ** 5, backend="gpu", mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        kernel_route(t, 16, backend="gpu", fused=True, mesh=mesh)
    sharded = mc.run(task, chains=16, seed=7, mesh=mesh)
    single = mc.run(task, chains=16, seed=7)
    for a, b in zip(sharded, single):
        np.testing.assert_allclose(a.samples.values, b.samples.values,
                                   rtol=1e-5, atol=1e-6)


def test_fused_glm_wide_parameter_dim():
    """d > 64 (D = 256): the kernel's lp/grad still match autodiff in the
    interpreter; the route keeps such models on the generic engine."""
    from mcmc_jl.core.task import MCMCTask
    from mcmc_jl.parallel.pchains import kernel_route

    rng = np.random.default_rng(11)
    n, d = 120, 150
    X = (np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
         / np.sqrt(d)).astype(np.float32)
    Y = (rng.random(n) < 0.5).astype(np.float32)
    model = mc.model(glm=("logistic", X, Y))
    theta = jnp.asarray(rng.standard_normal(d) * 0.1, jnp.float32)
    lp, g_auto = jax.value_and_grad(model.eval)(theta)
    assert padded_dim(d) == 256
    z = jnp.zeros((1, d), jnp.float32)
    _, _, g1, lp1 = _kernel(X, Y, theta[None], z, z, 0.0, 1)
    np.testing.assert_allclose(lp1[0], float(lp), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(g1[0, :d], np.asarray(g_auto), rtol=2e-4,
                               atol=2e-4)
    assert np.all(g1[0, d:] == 0)
    t = MCMCTask(model, mc.HMC(5, 0.1), mc.SerialMC(steps=10))
    assert not kernel_route(t, 10 ** 5, backend="gpu")
