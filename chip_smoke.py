"""Smoke test of the engine on one GPU, through the entry points users call.

Phases (each must pass; any failure exits nonzero and prints no result):

1. the card: ``nvidia-smi`` name and power limit;
2. the Triton GLM trajectory kernel against the plain float64 reference
   (``model(glm=...)``'s own log-density and gradient under
   ``jax.default_matmul_precision("highest")``), from the same
   (theta, momentum), at 65,536 chains x N = 1,000 and 1,024 chains x
   N = 100,000;
3. the benchmark posterior (logistic, d = 10, N = 1,000) with
   ``HMC(10, 0.05)`` at 65,536 chains through ``run(task, chains=N)``, on
   the kernel route and with ``fused=False``: acceptance, and the two
   routes' posterior means and sds within a z-gate; leapfrog/s and
   compile time;
4. ``run_until`` with 64 chains reaching its gate;
5. default ``NUTS()`` at 1,024 chains on the same posterior, its means
   z-gated against the converged ``run_until`` draws;
6. the README's single-chain HMC example (acceptance about 80%);
7. ``resume`` of kernel-route chains.

``--four`` runs only the paths across four cards and what each is compared
with: chain-sharded ``run(task, chains=65536, mesh=...)`` on a 4-card
('chains',) mesh against one card with the same seed, and
``run_chains_sharded`` on a 2x2 ('chains', 'data') mesh with N = 10^6
against one card.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Usage: python chip_smoke.py [--four]
"""
import json
import subprocess
import sys
import time
import traceback

import numpy as np

F32_EPS = 2.0 ** -24   # IEEE f32 unit roundoff
TF32_EPS = 2.0 ** -11  # TF32 keeps 10 mantissa bits
#: (chains, observations) of the kernel checks; chains of the C1 runs, of
#: the NUTS run and of the resumed subset; observations of the --four
#: data-sharded run
KERNEL_SHAPES = ((65536, 1000), (1024, 100_000))
C1_CHAINS, NUTS_CHAINS, RESUME_CHAINS = 65536, 1024, 1024
FOUR_OBS = 1_000_000
#: chains whose statistics enter the z-gates between routes (the full C1
#: batch resolves differences far below the TF32 rounding of the generic
#: engine's log-density, which is not what the gate is for)
GATE_CHAINS = 8192


def log(*a):
    print(*a, flush=True)


def logistic_data(n, d=10, seed=1):
    """The benchmark posterior's data (bench.logistic_data)."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(n), rng.standard_normal((n, d - 1))])
    beta0 = rng.standard_normal(d)
    Y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ beta0))).astype(np.float64)
    return X, Y


def laplace(X, Y, iters=25):
    """Posterior mode and covariance of the N(0, I)-prior logistic model,
    by Newton's method in float64."""
    th = np.zeros(X.shape[1])
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-X @ th))
        H = X.T @ (X * (p * (1 - p))[:, None]) + np.eye(X.shape[1])
        th = th + np.linalg.solve(H, X.T @ (Y - p) - th)
    return th, np.linalg.inv(H)


def z_gate(a, b, limit=5.0):
    """Largest |z| between two sets of per-chain statistics (chains are
    independent, so the standard error of a mean over chains is the
    spread of the chains over sqrt(count))."""
    se = np.sqrt(a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b))
    z = np.abs(a.mean(0) - b.mean(0)) / se
    return float(z.max()), bool(z.max() < limit)


# ---------------------------------------------------------------- phases
def phase_kernel_vs_reference():
    """One trajectory of the kernel against the float64 reference."""
    import jax
    import jax.numpy as jnp

    import mcmc_jl as mc
    from mcmc_jl.ops.pallas_glm import (glm_trajectory, pad_chains,
                                        pad_design, padded_dim)

    ok = True
    for C, N in KERNEL_SHAPES:
        d, n_leaps = 10, 10
        eps = 0.05 * float(np.sqrt(1000.0 / N))
        X, Y = logistic_data(N, d)
        mode, cov = laplace(X, Y)
        rng = np.random.default_rng(3)
        th0 = rng.multivariate_normal(mode, cov, size=C)
        m0 = rng.standard_normal((C, d))
        with jax.enable_x64(True), jax.default_matmul_precision("highest"):
            ref = mc.model(glm=("logistic", X, Y))
            vlg = jax.jit(jax.vmap(ref.evalallg))

            @jax.jit
            def traj(th, m):
                _, g = jax.vmap(ref.evalallg)(th)

                def body(_, c):
                    th, m, g = c
                    m = m + 0.5 * eps * g
                    th = th + eps * m
                    _, g = jax.vmap(ref.evalallg)(th)
                    return th, m + 0.5 * eps * g, g
                return jax.lax.fori_loop(0, n_leaps, body, (th, m, g))

            th_r, _, _ = [np.asarray(a) for a in traj(th0, m0)]
            _, g0 = vlg(th0)
            g0 = np.asarray(g0)
            # scale of the gradient's sum over observations at theta0:
            # sqrt(sum_n (r_n x_nj)^2), the size of random rounding in it
            z = th0 @ X.T
            r = Y - 1.0 / (1.0 + np.exp(-z))
            S = float(np.sqrt((r ** 2) @ (X ** 2)).max())

        XT, Yp, _, _ = pad_design(X, Y)
        D = padded_dim(d)
        f32 = lambda a: pad_chains(jnp.asarray(a, jnp.float32), D)  # noqa
        run = jax.jit(lambda t, m, g: glm_trajectory(
            XT, Yp, None, None, t, m, g, n_obs=N, n_leaps=n_leaps, eps=eps))
        t0 = time.perf_counter()
        out = run(f32(th0), f32(m0), f32(g0))
        jax.block_until_ready(out)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(run(f32(th0), f32(m0), f32(g0)))
        t_run = time.perf_counter() - t0
        th_k, _, g_k, lp_k = [np.asarray(a)[:C] for a in out]
        th_k, g_k = th_k[:, :d].astype(np.float64), g_k[:, :d]
        with jax.enable_x64(True), jax.default_matmul_precision("highest"):
            lp_at, g_at = [np.asarray(a) for a in vlg(th_k)]
            ll_abs = np.abs(th_k @ X.T * Y - np.logaddexp(0, th_k @ X.T))
            ll_abs = ll_abs.sum(1)

        # (a) the log-density at the trajectory's end, which enters the
        # Metropolis ratio: IEEE f32 products, f32 sums of N terms.
        # Tolerance: 4 sigma of random rounding of N f32 additions at the
        # scale of sum_n |ll_n|.
        err_lp = np.abs(lp_k - lp_at)
        tol_lp = 4.0 * np.sqrt(N) * F32_EPS * ll_abs
        # (b) the endpoint gradient: r @ X in TF32.  Tolerance: 8 x the
        # random TF32 rounding of the sum, TF32_EPS * S.
        err_g = float(np.abs(g_k - g_at).max())
        tol_g = 8.0 * TF32_EPS * S
        # (c) the trajectory: TF32 rounds theta and X by up to TF32_EPS
        # relative, so each interior gradient is the gradient at a point
        # displaced by about TF32_EPS |theta|; a trajectory (an oscillation
        # through the posterior) carries that displacement with O(1) gain.
        # Tolerance: 8 x TF32_EPS x max |theta|.
        err_th = float(np.abs(th_k - th_r).max())
        tol_th = 8.0 * TF32_EPS * float(np.abs(th_r).max())
        good = (bool(np.all(err_lp <= tol_lp)) and err_g <= tol_g
                and err_th <= tol_th and bool(np.all(np.isfinite(lp_k))))
        ok &= good
        log(f"kernel C={C} N={N}: endpoint logp (IEEE f32 products) max "
            f"err {err_lp.max():.3g} vs f64, tol {tol_lp.min():.3g} "
            f"(4 sqrt(N) eps_f32 sum|ll|); endpoint grad (TF32 r@X) max err "
            f"{err_g:.3g}, tol {tol_g:.3g} (8 eps_tf32 S); trajectory theta "
            f"max err {err_th:.3g}, tol {tol_th:.3g} "
            f"(8 eps_tf32 max|theta|); first call {t_first:.2f}s, "
            f"trajectory {t_run * 1e3:.3f} ms -> "
            f"{'ok' if good else 'FAIL'}")
        # the generic engine's f32 log-density at its default precision,
        # recorded beside the kernel's
        with jax.enable_x64(False):
            m32 = mc.model(glm=("logistic", X, Y))
            lp32, _ = jax.jit(jax.vmap(m32.evalallg))(
                jnp.asarray(th_k, jnp.float32))
        log(f"generic engine f32 logp at default matmul precision: max err "
            f"{np.abs(np.asarray(lp32) - lp_at).max():.3g} vs f64 at the "
            f"same theta (recorded)")
    return ok


def _c1_task(steps, burnin):
    import mcmc_jl as mc

    X, Y = logistic_data(1000)
    return (mc.model(glm=("logistic", X, Y)) * mc.HMC(10, 0.05)
            * mc.SerialMC(steps=steps, burnin=burnin))


def _timed_run(task, chains, **kw):
    import mcmc_jl as mc
    from mcmc_jl.parallel import pchains

    t0 = time.perf_counter()
    out = mc.run(task, chains=chains, **kw)
    wall = time.perf_counter() - t0
    [rec] = pchains.last_timings
    return out, rec, wall


def _chain_stats(chains):
    means = np.array([c.samples.values.mean(0) for c in chains])
    sds = np.array([c.samples.values.std(0) for c in chains])
    return means, sds


STATE = {}


def phase_c1(card):
    import mcmc_jl as mc

    C, steps, burnin = C1_CHAINS, 300, 100
    task = _c1_task(steps, burnin)
    res = {}
    for label, kw in (("kernel", dict(fused="auto")),
                      ("generic", dict(fused=False))):
        _, first, _ = _timed_run(task, C, seed=0, **kw)
        out, rec, wall = _timed_run(task, C, seed=1, **kw)
        acc = float(np.mean([mc.acceptance(c) for c in out[:GATE_CHAINS]]))
        res[label] = (out, rec, acc)
        lf = C * steps * 10 / rec["sample_s"]
        log(f"C1 {label}: engine {rec['engine']}, {lf:.4g} leapfrog/s "
            f"(sampling {rec['sample_s']:.3f}s), compile "
            f"{first['sample_s'] - rec['sample_s']:.2f}s, packaging "
            f"{rec['package_s']:.2f}s, run() wall {wall:.2f}s, acceptance "
            f"{acc:.2f}% [{card}]")
    ok = res["kernel"][1]["engine"] == "kernel"
    ok &= all(50.0 < r[2] < 99.5 for r in res.values())
    ok &= abs(res["kernel"][2] - res["generic"][2]) < 2.0
    (mk, sk), (mg, sg) = (_chain_stats(res[k][0])
                          for k in ("kernel", "generic"))
    g = GATE_CHAINS
    zm, okm = z_gate(mk[:g], mg[:g])
    zs, oks = z_gate(sk[:g], sg[:g])
    ok &= okm and oks
    log(f"C1 kernel vs generic over {g} chains: posterior mean max |z| "
        f"{zm:.2f}, sd max |z| {zs:.2f} (gate 5); over all {C} chains "
        f"(recorded): mean {z_gate(mk, mg)[0]:.2f}, sd "
        f"{z_gate(sk, sg)[0]:.2f} -> {'ok' if ok else 'FAIL'}")
    STATE["c1_kernel"] = res["kernel"][0]
    return ok


def phase_nuts():
    import mcmc_jl as mc

    X, Y = logistic_data(1000)
    task = (mc.model(glm=("logistic", X, Y)) * mc.NUTS()
            * mc.SerialMC(steps=300, burnin=150))
    out, rec, wall = _timed_run(task, NUTS_CHAINS, seed=2)
    acc = float(np.mean([c.diagnostics["accept"].mean() for c in out]))
    finite = all(np.all(np.isfinite(c.samples.values)) for c in out)
    zm, okm = z_gate(_chain_stats(out)[0], STATE["gated_means"])
    ok = finite and okm and acc > 0.5
    log(f"NUTS() {NUTS_CHAINS} chains: sampling {rec['sample_s']:.2f}s "
        f"(compile included), acceptance stat {acc:.3f}, posterior mean vs "
        f"the converged run_until draws max |z| {zm:.2f} (gate 5) -> "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def phase_readme():
    import jax.numpy as jnp

    import mcmc_jl as mc

    m = mc.model(lambda v: -jnp.dot(v, v), grad=lambda v: -2 * v,
                 init=jnp.ones(3))
    chain = mc.run(m, mc.HMC(0.75), mc.SerialMC(steps=10000, burnin=1000))
    acc = float(mc.acceptance(chain))
    sd = chain.samples.values.std(0)
    ok = 70.0 < acc < 90.0 and bool(np.all(np.abs(sd - np.sqrt(0.5)) < 0.1))
    log(f"README HMC(0.75) single chain: acceptance {acc:.2f}% (~80), sd "
        f"{np.round(sd, 3)} (0.707) -> {'ok' if ok else 'FAIL'}")
    return ok


def phase_run_until():
    import mcmc_jl as mc

    X, Y = logistic_data(1000)
    m = mc.model(glm=("logistic", X, Y))
    t0 = time.perf_counter()
    # trajectory length 0.15, about a quarter of the posterior's period
    # (HMC(10, 0.05) runs near one full period and mixes slowly)
    res = mc.run_until(m, mc.HMC(6, 0.025), n_chains=64, rhat_target=1.01,
                       min_ess=400, check_every=200, max_steps=4000, seed=3)
    ok = res.converged and bool(np.all(np.isfinite(res.samples)))
    STATE["gated_means"] = res.samples.mean(0)
    log(f"run_until 64 chains: converged {res.converged} after "
        f"{res.steps_run} steps, max R-hat {res.max_rhat:.4f}, min ESS "
        f"{res.min_ess:.0f}, {time.perf_counter() - t0:.2f}s -> "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def phase_resume():
    import mcmc_jl as mc

    src = STATE["c1_kernel"][:RESUME_CHAINS]
    out = mc.resume(src, steps=100)
    ok = (len(out) == RESUME_CHAINS
          and all(np.all(np.isfinite(c.samples.values)) for c in out))
    # the continuation starts from the stored final state
    step = [c.samples.values[0] - s.samples.values[-1]
            for c, s in zip(out[:64], src[:64])]
    ok &= float(np.max(np.abs(step))) < 2.0
    acc = float(np.mean([mc.acceptance(c) for c in out]))
    log(f"resume {RESUME_CHAINS} kernel-route chains x 100 steps: acceptance "
        f"{acc:.2f}% -> {'ok' if ok else 'FAIL'}")
    return ok


# ------------------------------------------------------------ four cards
def phase_four_chains(card):
    """Chain-sharded run on a 4-card ('chains',) mesh against one card."""
    import jax

    from mcmc_jl.parallel import default_mesh

    C, steps = C1_CHAINS, 200
    task = _c1_task(steps, 50)
    mesh = default_mesh(devices=jax.devices()[:4])
    res = {}
    for label, kw in (("4 cards", dict(mesh=mesh)),
                      ("1 card", dict(fused=False))):
        _timed_run(task, C, seed=5, **kw)
        out, rec, wall = _timed_run(task, C, seed=5, **kw)
        res[label] = out
        log(f"chain-sharded {label}: engine {rec['engine']}, "
            f"{C * steps * 10 / rec['sample_s']:.4g} leapfrog/s (sampling "
            f"{rec['sample_s']:.3f}s), packaging {rec['package_s']:.2f}s "
            f"[{card}]")
    a, b = res["4 cards"], res["1 card"]
    # same seed, same per-chain keys: the first draw differs only by the
    # matmul algorithm XLA picks for a 16,384- vs a 65,536-chain batch,
    # unless that rounding flips a Metropolis decision (rare)
    d0 = np.array([np.abs(x.samples.values[0] - y.samples.values[0]).max()
                   for x, y in zip(a[:GATE_CHAINS], b[:GATE_CHAINS])])
    frac = float(np.mean(d0 > 1e-3))
    g = GATE_CHAINS
    zm, okm = z_gate(_chain_stats(a[:g])[0], _chain_stats(b[:g])[0])
    ok = okm and frac < 0.01
    log(f"4 cards vs 1 card: first draw differs by > 1e-3 in {frac:.4%} of "
        f"{g} chains (gate 1%; median |diff| {np.median(d0):.3g}), "
        f"posterior mean max |z| {zm:.2f} over {g} chains (gate 5) -> "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def phase_four_data(card):
    """run_chains_sharded on a 2x2 ('chains', 'data') mesh, N = 10^6,
    against a 1x1 mesh on one card."""
    import jax
    import jax.numpy as jnp

    import mcmc_jl as mc
    from mcmc_jl.parallel.sharded import (make_mesh, run_chains_sharded,
                                          sharded_glm_model)

    N, d, C = FOUR_OBS, 10, 256
    X, Y = logistic_data(N, d)
    Xj, Yj = jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32)

    def loglik(theta, X_blk, Y_blk):
        z = X_blk @ theta
        return jnp.dot(Y_blk, z) - jnp.sum(jnp.logaddexp(0.0, z))

    make = sharded_glm_model(loglik, lambda t: -0.5 * jnp.dot(t, t), d,
                             jnp.zeros(d, jnp.float32))
    sampler = mc.HMC(5, 0.05 * float(np.sqrt(1000.0 / N)))
    runner = mc.SerialMC(steps=20)
    out = {}
    for label, mesh in (("2x2", make_mesh(2, 2, jax.devices()[:4])),
                        ("1x1", make_mesh(1, 1, jax.devices()[:1]))):
        with jax.default_matmul_precision("highest"):
            run = lambda: run_chains_sharded(  # noqa: E731
                make, (Xj, Yj), sampler, runner, mesh, C, seed=4)
            jax.block_until_ready(run())
            t0 = time.perf_counter()
            _, infos = run()
            jax.block_until_ready(infos)
            dt = time.perf_counter() - t0
        out[label] = {k: np.asarray(infos[k]) for k in
                      ("logtarget", "grads", "plogtarget")}
        log(f"data-sharded {label}: {C * 20 * 5 / dt:.4g} leapfrog/s "
            f"({dt:.3f}s for 20 steps) [{card}]")
    a, b = out["2x2"], out["1x1"]
    # initial log-density and gradient at theta = 0: the same f32 sums over
    # N observations, reduced in another order (two shards + psum).
    # Tolerance: 4 sqrt(N) eps_f32 times the sum of |terms|: N log 2 for
    # the log-density, 0.5 sum_n |x_nj| for the gradient (r_n = y_n - 1/2).
    err_lp = float(np.abs(a["logtarget"][0] - b["logtarget"][0]).max())
    tol_lp = 4.0 * np.sqrt(N) * F32_EPS * N * np.log(2.0)
    err_g = (np.abs(a["grads"][0] - b["grads"][0]).max(0))
    tol_g = 4.0 * np.sqrt(N) * F32_EPS * 0.5 * np.abs(X).sum(0)
    err_g, tol_g = float(err_g.max()), tol_g[np.argmax(err_g / tol_g)]
    finite = bool(np.all(np.isfinite(a["plogtarget"])))
    ok = err_lp <= tol_lp and err_g <= tol_g and finite
    log(f"2x2 vs 1x1: initial logp max |diff| {err_lp:.3g} (tol "
        f"{tol_lp:.3g} = 4 sqrt(N) eps_f32 |lp|), gradient max |diff| "
        f"{err_g:.3g} (tol {tol_g:.3g}) -> {'ok' if ok else 'FAIL'}")
    return ok


def main(argv):
    four = "--four" in argv
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found {devs}")
    if four and len(devs) < 4:
        sys.exit(f"--four needs four GPUs; JAX found {devs}")
    from mcmc_jl.utils.cache import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(card)
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    card = "; ".join(sorted(set(card.splitlines())))  # one tag per model
    if four:
        phases = [("four_chains", lambda: phase_four_chains(card)),
                  ("four_data", lambda: phase_four_data(card))]
    else:
        phases = [("kernel_vs_reference", phase_kernel_vs_reference),
                  ("c1", lambda: phase_c1(card)),
                  ("run_until", phase_run_until), ("nuts", phase_nuts),
                  ("readme", phase_readme), ("resume", phase_resume)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            ok = fn()
        except Exception:
            traceback.print_exc()
            ok = False
        log(f"phase {name}: {'ok' if ok else 'FAILED'} "
            f"({time.perf_counter() - t0:.1f}s)")
        if not ok:
            failed.append(name)
    if failed:
        sys.exit(f"failed phases: {failed}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main(sys.argv[1:])
