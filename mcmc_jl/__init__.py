"""mcmc_jl — a batched MCMC engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of the
Julia ``MCMC`` package (dingliumath/MCMC.jl): ``chain = model * sampler *
runner`` with a ``~`` model DSL, 13 MCMC samplers, serial/tempering/SMC
runners, and on-device output analysis — built around pure transition
kernels batched with ``vmap`` and sharded over device meshes with
``shard_map`` instead of coroutines and process pools.

Quick start (reference README Example 1)::

    import jax.numpy as jnp
    import mcmc_jl as mc

    mymodel = mc.model(lambda v: -jnp.dot(v, v), init=jnp.ones(3))
    chain = mc.run(mymodel * mc.RWM(0.1) * mc.SerialMC(steps=1000, burnin=100))
    mc.acceptance(chain); mc.describe(chain)
"""
from .models.model import model, LogDensityModel
from .models.dsl import tilde, observe, acc, factor
from .models import distributions
from .models.distributions import (
    Normal, Uniform, Weibull, Gamma, Cauchy, LogNormal, Binomial, Beta,
    Laplace, Bernoulli, TDist, Exponential, Poisson, MvNormal, Truncated,
)
from .core.task import MCMCTask
from .core.chain import MCMCChain
from .samplers import (
    RWM, IMH, RAM, MALA, Barker, HMC, HMCDA, NUTS, WALNUTS, ChEESHMC, SMMALA, PMALA,
    RMHMC, ERMLMC, RMLMC, EmpMCTuner, slice_sample,
)
from .runners.serialmc import SerialMC
from .runners.seqmc import SeqMC
from .runners.serialtempmc import SerialTempMC
from .runners.ptmc import PTMC
from .runners.aies import AIES
from .runners.asmc import ASMC
from .runners.api import run, resume, prun
from .runners.convergence import ConvergenceResult, run_until
from .stats import (
    mean, mean_rb, mcvar, mcse, var, std, ess, actime, acceptance, describe,
    wsample, linear_zv, quadratic_zv, linearZv, quadraticZv,
    rhat, ess_pooled, summarize_chains, mcmc_quantile, logz_ti, logz_ss,
    pointwise_loglik, waic, psis_loo,
)
from .stats import compare as compare_elpd

# legacy alias matching the reference's MCMCLikModel typealias (likmodel.jl:69)
MCMCLikModel = LogDensityModel

__version__ = "0.1.0"

__all__ = [
    "model", "LogDensityModel", "MCMCLikModel", "tilde", "observe",
    "acc", "factor", "run_until", "ConvergenceResult",
    "distributions",
    "Normal", "Uniform", "Weibull", "Gamma", "Cauchy", "LogNormal",
    "Binomial", "Beta", "Laplace", "Bernoulli", "TDist", "Exponential",
    "Poisson", "MvNormal", "Truncated",
    "MCMCTask", "MCMCChain",
    "RWM", "IMH", "RAM", "MALA", "Barker", "HMC", "HMCDA", "NUTS", "WALNUTS", "ChEESHMC",
    "SMMALA", "PMALA", "RMHMC", "ERMLMC", "RMLMC", "EmpMCTuner", "slice_sample",
    "SerialMC", "SeqMC", "SerialTempMC", "PTMC", "AIES", "ASMC",
    "run", "resume", "prun",
    "mean", "mean_rb", "mcvar", "mcse", "var", "std", "ess", "actime",
    "acceptance", "describe", "wsample", "linear_zv", "quadratic_zv", "linearZv",
    "quadraticZv", "rhat", "ess_pooled", "summarize_chains", "mcmc_quantile",
    "logz_ti", "logz_ss",
    "pointwise_loglik", "waic", "psis_loo", "compare_elpd",
]
