"""Eight schools — the canonical Bayesian hierarchical model
(Rubin 1981; Gelman et al., BDA).  Beyond the reference's example set
(its workloads are all flat regressions) — this exercises the DSL with a
latent hierarchy, the non-centered reparameterization, NUTS with mass
adaptation, and the convergence-gated runner.

    mu ~ N(0, 20^2)          school-effect mean (weak — BDA uses flat)
    tau ~ HalfCauchy(5)      school-effect scale (via log tau, with Jacobian)
    theta_i = mu + tau * z_i, z_i ~ N(0, 1)   (non-centered)
    y_i ~ N(theta_i, se_i^2)

The centered parameterization (theta_i ~ N(mu, tau^2)) is a funnel in
(theta, tau) — fixed-step samplers under-explore small tau; non-centering
removes the pathology (the standard practice this framework's WALNUTS also
addresses head-on for unavoidable funnels).

Run: python examples/eight_schools.py
"""
import jax.numpy as jnp
import numpy as np

import mcmc_jl as mc

# classic data (treatment effects and standard errors)
Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
SE = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])
J = len(Y)


def make_model(gradient=True):
    """Parameter vector: (mu, log_tau, z_1..z_J) — size J + 2."""
    Yj, SEj = jnp.asarray(Y), jnp.asarray(SE)

    def ex(mu, log_tau, z):
        tau = jnp.exp(log_tau)
        mc.tilde(mu, mc.Normal(0.0, 20.0))
        # HalfCauchy(5) prior on tau, sampled on log scale:
        # p(log_tau) = p_HC(tau) * tau  (Jacobian) -> logpdf + log_tau
        mc.tilde(tau, mc.Cauchy(0.0, 5.0))   # symmetric: half-Cauchy ∝ Cauchy on tau>0
        mc.acc(log_tau)                       # Jacobian of tau = exp(log_tau)
        mc.tilde(z, mc.Normal(0.0, 1.0))
        theta = mu + tau * z
        mc.tilde(Yj, mc.Normal(theta, SEj))

    return mc.model(ex, gradient=gradient,
                    mu=0.0, log_tau=0.0, z=np.zeros(J))


def exact_posterior(mu_prior_sd=20.0, hc_scale=5.0):
    """Exact (mu, tau) posterior by quadrature: integrating out theta gives
    y_j | mu, tau ~ N(mu, se_j^2 + tau^2).  Ground truth for the tests."""
    mus = np.linspace(-20, 35, 400)
    taus = np.linspace(0.01, 40, 800)
    M, T = np.meshgrid(mus, taus, indexing="ij")
    V = SE[None, None, :] ** 2 + T[..., None] ** 2
    ll = -0.5 * np.sum((Y - M[..., None]) ** 2 / V + np.log(V), axis=-1)
    lp = ll - 0.5 * (M / mu_prior_sd) ** 2 - np.log1p((T / hc_scale) ** 2)
    w = np.exp(lp - lp.max())
    w /= w.sum()
    mu_mean = (w.sum(1) * mus).sum()
    mu_sd = np.sqrt((w.sum(1) * (mus - mu_mean) ** 2).sum())
    cdf = np.cumsum(w.sum(0))
    tau_median = taus[np.searchsorted(cdf, 0.5)]
    return mu_mean, mu_sd, tau_median


def main():
    m = make_model()

    res = mc.run_until(m, mc.NUTS(mass_adapt=True), n_chains=8,
                       rhat_target=1.01, min_ess=800, check_every=500,
                       max_steps=8000, seed=0, verbose=True)
    print(f"\nconverged={res.converged} after {res.steps_run} steps "
          f"(max R-hat {res.max_rhat:.4f}, min ESS {res.min_ess:.0f})")

    draws = res.samples.reshape(-1, m.size)
    mu = draws[:, 0]
    tau = np.exp(draws[:, 1])
    z = draws[:, 2:]
    theta = mu[:, None] + tau[:, None] * z
    # exact values by 2-D quadrature of the analytic marginal
    # y_j | mu,tau ~ N(mu, se_j^2 + tau^2)  (see exact_posterior below)
    print(f"\nmu:  mean {mu.mean():6.2f}  sd {mu.std():5.2f}  "
          "(exact: 7.43 +/- 4.34)")
    print(f"tau: median {np.median(tau):6.2f}  (exact: 2.76)")
    print("\nschool   raw y    posterior theta (mean +/- sd)  shrinkage")
    for j in range(J):
        shrink = 1.0 - theta[:, j].std() ** 2 / SE[j] ** 2
        print(f"  {j + 1}      {Y[j]:6.1f}   {theta[:, j].mean():6.2f} "
              f"+/- {theta[:, j].std():5.2f}          {shrink:5.2f}")
    return res


if __name__ == "__main__":
    main()
