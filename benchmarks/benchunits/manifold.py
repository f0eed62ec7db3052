"""Manifold-sampler tier benchmark (VERDICT r4 next #1).

The Riemannian family (SMMALA/PMALA/RMHMC/ERMLMC/RMLMC — reference
src/samplers/SMMALA.jl:39-123, PMALA.jl:42-141, RMHMC.jl:53-184,
ERMLMC.jl:46-180, RMLMC.jl:51-180) had correctness gates but ZERO measured
rates in rounds 1-4.  This unit measures transitions/s and pooled
min-coordinate ESS/s for all five at a few hundred vmapped chains on the
canonical Girolami-Calderhead workload: Bayesian logistic regression with
the analytic Fisher metric

    G(theta) = X' diag(p(1-p)) X + lam I,      p = sigmoid(X theta)
    dG_k     = X' diag(p(1-p)(1-2p) x_k) X

(the observed information of the logistic log-lik equals the Fisher
metric exactly, so tensor == -hessian and the z-gates of
tests/test_samplers_stat.py transfer).  Batched d x d chol/solve/logdet
across hundreds of chains is exactly the shape accelerators do well.

Timing: the reduced log-target scalar is fetched inside the timer
(dispatch is async).
"""
import time

import numpy as np

D, N = 8, 200
LAM = 1.0


def _posterior():
    import jax
    import jax.numpy as jnp

    import mcmc_jl as mc

    rng = np.random.default_rng(11)
    X = np.column_stack([np.ones(N), rng.standard_normal((N, D - 1))])
    beta = rng.standard_normal(D) * 0.6
    Y = (rng.random(N) < 1.0 / (1.0 + np.exp(-X @ beta))).astype(np.float64)
    Xj = jnp.asarray(X)
    Yj = jnp.asarray(Y)
    eye = jnp.eye(D)

    def logp(t):
        z = Xj @ t
        return jnp.sum(Yj * z - jax.nn.softplus(z)) - 0.5 * LAM * jnp.dot(t, t)

    def grad(t):
        z = Xj @ t
        return Xj.T @ (Yj - jax.nn.sigmoid(z)) - LAM * t

    def tensor(t):
        p = jax.nn.sigmoid(Xj @ t)
        w = p * (1.0 - p)
        return (Xj * w[:, None]).T @ Xj + LAM * eye

    def dtensor(t):
        p = jax.nn.sigmoid(Xj @ t)
        wp = p * (1.0 - p) * (1.0 - 2.0 * p)
        return jnp.einsum("n,na,nb,nk->abk", wp, Xj, Xj, Xj)

    return mc.model(logp, grad=grad, tensor=tensor, dtensor=dtensor,
                    init=jnp.zeros(D), check_init=False)


def _bench_one(model, sampler, n_chains, steps, burnin):
    import jax
    import jax.numpy as jnp

    from mcmc_jl.parallel import run_chains
    from mcmc_jl.stats.var import mcvar_iid, mcvar_imse

    runner_cls = __import__("mcmc_jl", fromlist=["SerialMC"]).SerialMC
    runner = runner_cls(steps=steps, burnin=burnin)
    # compile + warm lap (not timed)
    infos, _, _ = run_chains(model, sampler, runner, n_chains, seed=0,
                             jitter=0.3)
    float(jnp.sum(infos["plogtarget"][-1]))

    t0 = time.perf_counter()
    infos, _, _ = run_chains(model, sampler, runner, n_chains, seed=1,
                             jitter=0.3)
    # fetch a reduced scalar INSIDE the timer (async-dispatch guard)
    float(jnp.sum(infos["plogtarget"][-1]))
    dt = time.perf_counter() - t0

    x = np.asarray(infos["ppars"])[burnin:]          # (kept, C, D)
    kept = x.shape[0]
    # per-chain IMSE ESS on a chain subsample (the host-side IMSE loop,
    # not the sampling, dominates wall-time beyond a few hundred chains);
    # pooled total extrapolates the subsample mean
    sub = min(n_chains, 256)
    min_ess = np.empty(sub)
    for c in range(sub):
        min_ess[c] = np.min(kept * mcvar_iid(x[:, c]) / mcvar_imse(x[:, c]))
    acc = 100.0 * float(np.mean(np.asarray(infos["accept"])))
    return steps * n_chains / dt, min_ess.mean() * n_chains / dt, acc


def run():
    import jax

    import mcmc_jl as mc

    on_gpu = jax.default_backend() == "gpu"
    model = _posterior()
    # (name, sampler, chains, steps, burnin) — chains scaled down on a CPU
    # for the O(d^3 N)-per-leap trio
    heavy_c = 256 if on_gpu else 64
    cases = [
        ("SMMALA(1.0)", mc.SMMALA(1.0), 256, 400, 100),
        ("PMALA(1.0)", mc.PMALA(1.0), 256, 400, 100),
        ("RMHMC(4,0.5)", mc.RMHMC(4, 0.5), heavy_c, 120, 30),
        ("ERMLMC(4,0.3)", mc.ERMLMC(4, 0.3), heavy_c, 120, 30),
        ("RMLMC(4,0.3)", mc.RMLMC(4, 0.3), heavy_c, 120, 30),
    ]
    if on_gpu:
        # thousands-of-chains rows: the batched-linalg shape a GPU does well
        cases += [
            ("SMMALA(1.0)", mc.SMMALA(1.0), 2048, 400, 100),
            ("PMALA(1.0)", mc.PMALA(1.0), 2048, 400, 100),
        ]
    rows = []
    for name, sampler, n_chains, steps, burnin in cases:
        tps, ess_s, acc = _bench_one(model, sampler, n_chains, steps, burnin)
        tag = f"manifold logistic {D}d: {name} x{n_chains}"
        rows += [
            (f"{tag}: transitions/s", tps, "trans/s"),
            (f"{tag}: pooled min-coord ESS/s", ess_s, "ESS/s"),
            (f"{tag}: acceptance %", acc, "%"),
        ]
    return rows
