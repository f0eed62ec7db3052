"""Natively-batched distribution catalog.

The reference vectorizes Julia ``Distributions.jl`` objects element-by-element
(reference: src/dsl/definitions/DistributionsExtensions.jl — broadcasting the
13 supported constructors over arrays, and looping ``logpdf``/``logcdf``/
``logccdf`` over ``Array{Distribution}``).  On an accelerator that design is
inverted:
distributions here hold (possibly batched) parameter *arrays* and every
density method is a single fused jnp broadcast expression, so a vector
statement like ``y ~ Normal(mu_vec, sigma)`` lowers to one fused kernel instead
of a scalar loop, and ``jax.grad`` differentiates through both ``x`` and the
parameters (replacing the hand-written rules in
src/dsl/definitions/MCMCDerivRules.jl, which we keep only as test oracles).

Support handling: the reference throws ``OutOfSupportError`` from its LLAcc
accumulator and maps it to ``(-Inf, 0)`` at the model boundary
(src/dsl/definitions/AccumulatorDerivRules.jl:12-17, src/dsl/modelparser.jl:
64-72).  Exceptions don't exist on-device, so every ``logpdf`` here returns
``-inf`` outside the support (or for invalid parameters) using the
"double-where" pattern: the unsafe expression is evaluated at a safe point so
reverse-mode gradients of in-support lanes are never polluted by NaNs.

Parameterizations match Julia Distributions.jl (the reference's convention):
``Gamma(shape, scale)``, ``Exponential(scale)``, ``Weibull(shape, scale)``,
``LogNormal(meanlog, sdlog)``, ``TDist(df)``.

Censoring sugar: ``y ~ +D`` (right-censor -> logccdf) and ``y ~ -D``
(left-censor -> logcdf) from the reference DSL (src/dsl/expr_funcs.jl:18-22)
map to the unary ``+D`` / ``-D`` operators here, which return censored
wrappers whose ``logpdf`` is ``logccdf`` / ``logcdf``.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
from jax.scipy import special as jsp

_REGISTRY = {}

LOG2PI = math.log(2.0 * math.pi)


def _where(cond, a, b):
    return jnp.where(cond, a, b)


def _pyscalar(v):
    """float(v) for a genuine concrete scalar (Python/numpy/jnp); else None.

    Used to fold distribution log-normalizers (``lgamma`` terms) to
    compile-time Python constants: JAX stages EVERY op issued under a trace
    — even on concrete operands — so ``jsp.gammaln(param)`` would add an
    ``lgamma`` op to every traced evaluation.  Parameters are almost always concrete scalars, where the
    normalizer is a compile-time constant; traced/array parameters (DSL
    latents, batched params) keep the jsp path."""
    if isinstance(v, jax.core.Tracer):
        return None
    try:
        if jnp.ndim(v) == 0:
            return float(v)
    except (TypeError, ValueError):
        pass
    return None


def _safe(cond, x, safe_val):
    """Replace out-of-domain x by a harmless value before an unsafe op."""
    return jnp.where(cond, x, safe_val)


def distribution(cls):
    """Register a distribution dataclass as a JAX pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]

    def flatten(d):
        return tuple(getattr(d, f) for f in fields), None

    def unflatten(aux, children):
        return cls(*children)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    _REGISTRY[cls.__name__] = cls
    return cls


class Distribution:
    """Base: elementwise log-density family over broadcastable parameters."""

    # -- density interface -------------------------------------------------
    def logpdf(self, x):  # elementwise; callers sum
        raise NotImplementedError

    def logcdf(self, x):
        raise NotImplementedError

    def logccdf(self, x):
        raise NotImplementedError

    def cdf(self, x):
        return jnp.exp(self.logcdf(x))

    def sample(self, key, shape=()):
        raise NotImplementedError

    def mean(self):
        raise NotImplementedError

    def std(self):
        raise NotImplementedError

    # -- censoring sugar: y ~ +D  /  y ~ -D --------------------------------
    def __pos__(self):
        return RightCensored(self)

    def __neg__(self):
        return LeftCensored(self)


@distribution
class RightCensored(Distribution):
    """``y ~ +D``: contributes ``logccdf(D, y)`` (reference expr_funcs.jl:18)."""

    base: Distribution

    def logpdf(self, x):
        return self.base.logccdf(x)


@distribution
class LeftCensored(Distribution):
    """``y ~ -D``: contributes ``logcdf(D, y)`` (reference expr_funcs.jl:21)."""

    base: Distribution

    def logpdf(self, x):
        return self.base.logcdf(x)


@distribution
class Truncated(Distribution):
    """``Truncated(D, lo, hi)``: D conditioned on ``lo <= x <= hi`` (either
    bound may be None for one-sided truncation).  Beyond-reference (the
    reference only has the censoring sugar above): the log-density is
    renormalized by the log truncation mass, computed stably from
    logcdf/logccdf, and x outside the bounds contributes ``-inf`` (the
    package-wide out-of-support convention)."""

    base: Distribution
    lo: object = None
    hi: object = None

    def _log_mass(self):
        if self.lo is None and self.hi is None:
            return 0.0
        if self.lo is None:
            return self.base.logcdf(self.hi)
        if self.hi is None:
            return self.base.logccdf(self.lo)
        la = self.base.logcdf(self.hi)
        lb = self.base.logcdf(self.lo)
        return la + jnp.log1p(-jnp.exp(lb - la))

    def _in_bounds(self, x):
        ok = jnp.full(jnp.shape(x), True)
        if self.lo is not None:
            ok = ok & (x >= self.lo)
        if self.hi is not None:
            ok = ok & (x <= self.hi)
        return ok

    def logpdf(self, x):
        lp = self.base.logpdf(x) - self._log_mass()
        return jnp.where(self._in_bounds(x), lp, -jnp.inf)

    def logcdf(self, x):
        num = self.base.logcdf(x)
        if self.lo is not None:
            lo_mass = self.base.logcdf(self.lo)
            num = num + jnp.log1p(-jnp.exp(jnp.minimum(lo_mass - num, 0.0)))
        out = jnp.minimum(num - self._log_mass(), 0.0)
        below = jnp.full(jnp.shape(x), False) if self.lo is None else (x < self.lo)
        above = jnp.full(jnp.shape(x), False) if self.hi is None else (x > self.hi)
        return jnp.where(below, -jnp.inf, jnp.where(above, 0.0, out))

    def logccdf(self, x):
        return jnp.log1p(-jnp.exp(jnp.minimum(self.logcdf(x), 0.0)))


# =========================================================================
# Continuous distributions
# =========================================================================


@distribution
class Normal(Distribution):
    mu: jnp.ndarray = 0.0
    sigma: jnp.ndarray = 1.0

    def logpdf(self, x):
        ok = jnp.asarray(self.sigma) > 0
        s = _safe(ok, self.sigma, 1.0)
        z = (x - self.mu) / s
        lp = -0.5 * z * z - jnp.log(s) - 0.5 * LOG2PI
        return _where(ok, lp, -jnp.inf)

    def logcdf(self, x):
        ok = jnp.asarray(self.sigma) > 0
        s = _safe(ok, self.sigma, 1.0)
        z = (x - self.mu) / s
        return _where(ok, jsp.log_ndtr(z), -jnp.inf)

    def logccdf(self, x):
        ok = jnp.asarray(self.sigma) > 0
        s = _safe(ok, self.sigma, 1.0)
        z = (x - self.mu) / s
        return _where(ok, jsp.log_ndtr(-z), -jnp.inf)

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, jnp.shape(self.mu), jnp.shape(self.sigma))
        return self.mu + self.sigma * jax.random.normal(key, shape)

    def mean(self):
        return jnp.asarray(self.mu, dtype=jnp.result_type(self.mu, float))

    def std(self):
        return jnp.asarray(self.sigma, dtype=jnp.result_type(self.sigma, float))


@distribution
class Uniform(Distribution):
    a: jnp.ndarray = 0.0
    b: jnp.ndarray = 1.0

    def logpdf(self, x):
        ok = jnp.asarray(self.b) > jnp.asarray(self.a)
        w = _safe(ok, self.b - self.a, 1.0)
        inside = ok & (x >= self.a) & (x <= self.b)
        return _where(inside, -jnp.log(w), -jnp.inf)

    def cdf(self, x):
        return jnp.clip((x - self.a) / (self.b - self.a), 0.0, 1.0)

    def logcdf(self, x):
        c = self.cdf(x)
        return jnp.log(_safe(c > 0, c, 1.0)) + _where(c > 0, 0.0, -jnp.inf)

    def logccdf(self, x):
        c = 1.0 - self.cdf(x)
        return jnp.log(_safe(c > 0, c, 1.0)) + _where(c > 0, 0.0, -jnp.inf)

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, jnp.shape(self.a), jnp.shape(self.b))
        return self.a + (self.b - self.a) * jax.random.uniform(key, shape)

    def mean(self):
        return 0.5 * (jnp.asarray(self.a, dtype=float) + self.b)

    def std(self):
        return (jnp.asarray(self.b, dtype=float) - self.a) / math.sqrt(12.0)


@distribution
class Exponential(Distribution):
    """Julia convention: Exponential(scale); mean == scale."""

    scale: jnp.ndarray = 1.0

    def logpdf(self, x):
        ok = jnp.asarray(self.scale) > 0
        s = _safe(ok, self.scale, 1.0)
        inside = ok & (x >= 0)
        xs = _safe(inside, x, 0.0)
        return _where(inside, -xs / s - jnp.log(s), -jnp.inf)

    def logcdf(self, x):
        s = _safe(jnp.asarray(self.scale) > 0, self.scale, 1.0)
        xp = jnp.maximum(x, 0.0)
        return _log_of(-jnp.expm1(-xp / s))

    def logccdf(self, x):
        s = _safe(jnp.asarray(self.scale) > 0, self.scale, 1.0)
        return _where(x <= 0, 0.0, -jnp.maximum(x, 0.0) / s)

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, jnp.shape(self.scale))
        return self.scale * jax.random.exponential(key, shape)

    def mean(self):
        return jnp.asarray(self.scale, dtype=float)

    def std(self):
        return jnp.asarray(self.scale, dtype=float)


def _log_of(p):
    """log(p) that returns -inf (not nan) for p <= 0, grad-safe."""
    ok = p > 0
    return _where(ok, jnp.log(_safe(ok, p, 1.0)), -jnp.inf)


@distribution
class Gamma(Distribution):
    """Julia convention: Gamma(shape, scale)."""

    shape: jnp.ndarray = 1.0
    scale: jnp.ndarray = 1.0

    def logpdf(self, x):
        sa, ss = _pyscalar(self.shape), _pyscalar(self.scale)
        if sa is not None and ss is not None:
            # concrete params: the lgamma normalizer folds to a Python
            # constant (keeps the logpdf Pallas-kernel-lowerable)
            okc = (sa > 0) and (ss > 0)
            a, s = (sa, ss) if okc else (1.0, 1.0)
            inside = (x > 0) & okc
            xs = _safe(inside, x, 1.0)
            lp = ((a - 1.0) * jnp.log(xs) - xs / s
                  - (math.lgamma(a) + a * math.log(s)))
            return _where(inside, lp, -jnp.inf)
        ok = (jnp.asarray(self.shape) > 0) & (jnp.asarray(self.scale) > 0)
        a = _safe(ok, self.shape, 1.0)
        s = _safe(ok, self.scale, 1.0)
        inside = ok & (x > 0)
        xs = _safe(inside, x, 1.0)
        lp = (a - 1.0) * jnp.log(xs) - xs / s - jsp.gammaln(a) - a * jnp.log(s)
        return _where(inside, lp, -jnp.inf)

    def cdf(self, x):
        a = _safe(jnp.asarray(self.shape) > 0, self.shape, 1.0)
        s = _safe(jnp.asarray(self.scale) > 0, self.scale, 1.0)
        return jsp.gammainc(a, jnp.maximum(x, 0.0) / s)

    def logcdf(self, x):
        return _log_of(self.cdf(x))

    def logccdf(self, x):
        a = _safe(jnp.asarray(self.shape) > 0, self.shape, 1.0)
        s = _safe(jnp.asarray(self.scale) > 0, self.scale, 1.0)
        return _log_of(jsp.gammaincc(a, jnp.maximum(x, 0.0) / s))

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, jnp.shape(self.shape), jnp.shape(self.scale))
        return self.scale * jax.random.gamma(key, jnp.broadcast_to(self.shape, shape), shape)

    def mean(self):
        return jnp.asarray(self.shape, dtype=float) * self.scale

    def std(self):
        return jnp.sqrt(jnp.asarray(self.shape, dtype=float)) * self.scale


@distribution
class Weibull(Distribution):
    """Julia convention: Weibull(shape, scale)."""

    shape: jnp.ndarray = 1.0
    scale: jnp.ndarray = 1.0

    def logpdf(self, x):
        ok = (jnp.asarray(self.shape) > 0) & (jnp.asarray(self.scale) > 0)
        k = _safe(ok, self.shape, 1.0)
        s = _safe(ok, self.scale, 1.0)
        inside = ok & (x > 0)
        z = _safe(inside, x, 1.0) / s
        lp = jnp.log(k / s) + (k - 1.0) * jnp.log(z) - z**k
        return _where(inside, lp, -jnp.inf)

    def logccdf(self, x):
        k = _safe(jnp.asarray(self.shape) > 0, self.shape, 1.0)
        s = _safe(jnp.asarray(self.scale) > 0, self.scale, 1.0)
        z = jnp.maximum(x, 0.0) / s
        return -(z**k)

    def cdf(self, x):
        return -jnp.expm1(self.logccdf(x))

    def logcdf(self, x):
        return _log_of(self.cdf(x))

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, jnp.shape(self.shape), jnp.shape(self.scale))
        u = jax.random.uniform(key, shape, minval=jnp.finfo(float).tiny)
        return self.scale * (-jnp.log(u)) ** (1.0 / self.shape)

    def mean(self):
        k = jnp.asarray(self.shape, dtype=float)
        return self.scale * jnp.exp(jsp.gammaln(1.0 + 1.0 / k))

    def std(self):
        k = jnp.asarray(self.shape, dtype=float)
        m2 = jnp.exp(jsp.gammaln(1.0 + 2.0 / k))
        m1 = jnp.exp(jsp.gammaln(1.0 + 1.0 / k))
        return self.scale * jnp.sqrt(m2 - m1 * m1)


@distribution
class Cauchy(Distribution):
    loc: jnp.ndarray = 0.0
    scale: jnp.ndarray = 1.0

    def logpdf(self, x):
        ok = jnp.asarray(self.scale) > 0
        s = _safe(ok, self.scale, 1.0)
        z = (x - self.loc) / s
        lp = -jnp.log(jnp.pi * s * (1.0 + z * z))
        return _where(ok, lp, -jnp.inf)

    def cdf(self, x):
        z = (x - self.loc) / self.scale
        return jnp.arctan(z) / jnp.pi + 0.5

    def logcdf(self, x):
        return _log_of(self.cdf(x))

    def logccdf(self, x):
        z = (x - self.loc) / self.scale
        return _log_of(jnp.arctan(-z) / jnp.pi + 0.5)

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, jnp.shape(self.loc), jnp.shape(self.scale))
        return self.loc + self.scale * jax.random.cauchy(key, shape)

    def mean(self):  # undefined; the reference KS test substitutes 1.0
        return jnp.full(jnp.shape(self.loc), jnp.nan)

    def std(self):
        return jnp.full(jnp.shape(self.loc), jnp.nan)


@distribution
class LogNormal(Distribution):
    mu: jnp.ndarray = 0.0
    sigma: jnp.ndarray = 1.0

    def logpdf(self, x):
        ok = jnp.asarray(self.sigma) > 0
        s = _safe(ok, self.sigma, 1.0)
        inside = ok & (x > 0)
        xs = _safe(inside, x, 1.0)
        lx = jnp.log(xs)
        z = (lx - self.mu) / s
        lp = -0.5 * z * z - lx - jnp.log(s) - 0.5 * LOG2PI
        return _where(inside, lp, -jnp.inf)

    def logcdf(self, x):
        inside = x > 0
        lx = jnp.log(_safe(inside, x, 1.0))
        z = (lx - self.mu) / self.sigma
        return _where(inside, jsp.log_ndtr(z), -jnp.inf)

    def logccdf(self, x):
        inside = x > 0
        lx = jnp.log(_safe(inside, x, 1.0))
        z = (lx - self.mu) / self.sigma
        return _where(inside, jsp.log_ndtr(-z), 0.0)

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, jnp.shape(self.mu), jnp.shape(self.sigma))
        return jnp.exp(self.mu + self.sigma * jax.random.normal(key, shape))

    def mean(self):
        s = jnp.asarray(self.sigma, dtype=float)
        return jnp.exp(self.mu + 0.5 * s * s)

    def std(self):
        s = jnp.asarray(self.sigma, dtype=float)
        return jnp.sqrt((jnp.exp(s * s) - 1.0)) * self.mean()


@distribution
class Beta(Distribution):
    a: jnp.ndarray = 1.0
    b: jnp.ndarray = 1.0

    def logpdf(self, x):
        sa, sb = _pyscalar(self.a), _pyscalar(self.b)
        if sa is not None and sb is not None:
            # concrete params: log B(a,b) folds (Pallas-kernel-lowerable)
            okc = (sa > 0) and (sb > 0)
            a, b = (sa, sb) if okc else (1.0, 1.0)
            norm = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
            inside = (x > 0) & (x < 1) & okc
            xs = _safe(inside, x, 0.5)
            lp = ((a - 1.0) * jnp.log(xs)
                  + (b - 1.0) * jnp.log1p(-xs) - norm)
            return _where(inside, lp, -jnp.inf)
        ok = (jnp.asarray(self.a) > 0) & (jnp.asarray(self.b) > 0)
        a = _safe(ok, self.a, 1.0)
        b = _safe(ok, self.b, 1.0)
        inside = ok & (x > 0) & (x < 1)
        xs = _safe(inside, x, 0.5)
        lp = (
            (a - 1.0) * jnp.log(xs)
            + (b - 1.0) * jnp.log1p(-xs)
            - (jsp.gammaln(a) + jsp.gammaln(b) - jsp.gammaln(a + b))
        )
        return _where(inside, lp, -jnp.inf)

    def cdf(self, x):
        return jsp.betainc(self.a, self.b, jnp.clip(x, 0.0, 1.0))

    def logcdf(self, x):
        return _log_of(self.cdf(x))

    def logccdf(self, x):
        return _log_of(1.0 - self.cdf(x))

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, jnp.shape(self.a), jnp.shape(self.b))
        return jax.random.beta(key, self.a, self.b, shape)

    def mean(self):
        a = jnp.asarray(self.a, dtype=float)
        return a / (a + self.b)

    def std(self):
        a = jnp.asarray(self.a, dtype=float)
        b = jnp.asarray(self.b, dtype=float)
        return jnp.sqrt(a * b / ((a + b) ** 2 * (a + b + 1.0)))


@distribution
class Laplace(Distribution):
    loc: jnp.ndarray = 0.0
    scale: jnp.ndarray = 1.0

    def logpdf(self, x):
        ok = jnp.asarray(self.scale) > 0
        s = _safe(ok, self.scale, 1.0)
        lp = -jnp.abs(x - self.loc) / s - jnp.log(2.0 * s)
        return _where(ok, lp, -jnp.inf)

    def cdf(self, x):
        z = (x - self.loc) / self.scale
        return jnp.where(z < 0, 0.5 * jnp.exp(z), 1.0 - 0.5 * jnp.exp(-z))

    def logcdf(self, x):
        z = (x - self.loc) / self.scale
        return jnp.where(z < 0, z - jnp.log(2.0), jnp.log1p(-0.5 * jnp.exp(-jnp.abs(z))))

    def logccdf(self, x):
        z = (x - self.loc) / self.scale
        return jnp.where(z > 0, -z - jnp.log(2.0), jnp.log1p(-0.5 * jnp.exp(-jnp.abs(z))))

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, jnp.shape(self.loc), jnp.shape(self.scale))
        return self.loc + self.scale * jax.random.laplace(key, shape)

    def mean(self):
        return jnp.asarray(self.loc, dtype=float)

    def std(self):
        return math.sqrt(2.0) * jnp.asarray(self.scale, dtype=float)


@distribution
class TDist(Distribution):
    df: jnp.ndarray = 1.0

    def logpdf(self, x):
        sv = _pyscalar(self.df)
        if sv is not None:
            # concrete df: the normalizer folds (Pallas-kernel-lowerable)
            okc = sv > 0
            v = sv if okc else 1.0
            norm = (math.lgamma(0.5 * (v + 1.0)) - math.lgamma(0.5 * v)
                    - 0.5 * math.log(v * math.pi))
            lp = norm - 0.5 * (v + 1.0) * jnp.log1p(x * x / v)
            return _where(okc, lp, -jnp.inf)
        ok = jnp.asarray(self.df) > 0
        v = _safe(ok, self.df, 1.0)
        lp = (
            jsp.gammaln(0.5 * (v + 1.0))
            - jsp.gammaln(0.5 * v)
            - 0.5 * jnp.log(v * jnp.pi)
            - 0.5 * (v + 1.0) * jnp.log1p(x * x / v)
        )
        return _where(ok, lp, -jnp.inf)

    def cdf(self, x):
        v = self.df
        ib = jsp.betainc(0.5 * v, 0.5, v / (v + x * x))
        return jnp.where(x > 0, 1.0 - 0.5 * ib, 0.5 * ib)

    def logcdf(self, x):
        return _log_of(self.cdf(x))

    def logccdf(self, x):
        return _log_of(1.0 - self.cdf(x))

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, jnp.shape(self.df))
        return jax.random.t(key, self.df, shape)

    def mean(self):
        v = jnp.asarray(self.df, dtype=float)
        return jnp.where(v > 1, 0.0, jnp.nan)

    def std(self):
        v = jnp.asarray(self.df, dtype=float)
        return jnp.where(v > 2, jnp.sqrt(v / (v - 2.0)), jnp.nan)


# =========================================================================
# Discrete distributions (derivatives flow through parameters only,
# matching the reference's rules: MCMCDerivRules.jl:105-117)
# =========================================================================


@distribution
class Bernoulli(Distribution):
    p: jnp.ndarray = 0.5

    def logpdf(self, x):
        ok = (jnp.asarray(self.p) >= 0) & (jnp.asarray(self.p) <= 1)
        p = jnp.clip(_safe(ok, self.p, 0.5), 1e-30, 1.0)
        q = jnp.clip(1.0 - _safe(ok, self.p, 0.5), 1e-30, 1.0)
        sup = (x == 0) | (x == 1)
        lp = x * jnp.log(p) + (1.0 - x) * jnp.log(q)
        return _where(ok & sup, lp, -jnp.inf)

    def cdf(self, x):
        return jnp.where(x < 0, 0.0, jnp.where(x < 1, 1.0 - self.p, 1.0))

    def logcdf(self, x):
        return _log_of(self.cdf(x))

    def logccdf(self, x):
        return _log_of(1.0 - self.cdf(x))

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, jnp.shape(self.p))
        return jax.random.bernoulli(key, self.p, shape).astype(jnp.result_type(float))

    def mean(self):
        return jnp.asarray(self.p, dtype=float)

    def std(self):
        p = jnp.asarray(self.p, dtype=float)
        return jnp.sqrt(p * (1.0 - p))


@distribution
class Binomial(Distribution):
    n: jnp.ndarray = 1
    p: jnp.ndarray = 0.5

    def logpdf(self, x):
        n = jnp.asarray(self.n, dtype=jnp.result_type(float))
        ok = (jnp.asarray(self.p) >= 0) & (jnp.asarray(self.p) <= 1) & (n >= 0)
        p = jnp.clip(_safe(ok, self.p, 0.5), 1e-30, 1.0)
        q = jnp.clip(1.0 - _safe(ok, self.p, 0.5), 1e-30, 1.0)
        sup = (x >= 0) & (x <= n) & (x == jnp.floor(x))
        xs = _safe(sup, x, 0.0)
        lp = (
            jsp.gammaln(n + 1.0)
            - jsp.gammaln(xs + 1.0)
            - jsp.gammaln(n - xs + 1.0)
            + xs * jnp.log(p)
            + (n - xs) * jnp.log(q)
        )
        return _where(ok & sup, lp, -jnp.inf)

    def cdf(self, x):
        n = jnp.asarray(self.n, dtype=jnp.result_type(float))
        k = jnp.floor(jnp.clip(x, -1.0, n))
        # P(X <= k) = I_{1-p}(n-k, k+1)
        c = jsp.betainc(jnp.maximum(n - k, 1e-12), k + 1.0, 1.0 - self.p)
        return jnp.where(k < 0, 0.0, jnp.where(k >= n, 1.0, c))

    def logcdf(self, x):
        return _log_of(self.cdf(x))

    def logccdf(self, x):
        return _log_of(1.0 - self.cdf(x))

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, jnp.shape(self.n), jnp.shape(self.p))
        return jax.random.binomial(key, self.n, self.p, shape=shape)

    def mean(self):
        return jnp.asarray(self.n, dtype=float) * self.p

    def std(self):
        n = jnp.asarray(self.n, dtype=float)
        return jnp.sqrt(n * self.p * (1.0 - self.p))


@distribution
class Poisson(Distribution):
    lam: jnp.ndarray = 1.0

    def logpdf(self, x):
        ok = jnp.asarray(self.lam) > 0
        lam = _safe(ok, self.lam, 1.0)
        sup = (x >= 0) & (x == jnp.floor(x))
        xs = _safe(sup, x, 0.0)
        lp = xs * jnp.log(lam) - lam - jsp.gammaln(xs + 1.0)
        return _where(ok & sup, lp, -jnp.inf)

    def cdf(self, x):
        k = jnp.floor(x)
        return jnp.where(k < 0, 0.0, jsp.gammaincc(k + 1.0, self.lam))

    def logcdf(self, x):
        return _log_of(self.cdf(x))

    def logccdf(self, x):
        return _log_of(1.0 - self.cdf(x))

    def sample(self, key, shape=()):
        shape = jnp.broadcast_shapes(shape, jnp.shape(self.lam))
        return jax.random.poisson(key, self.lam, shape).astype(jnp.result_type(float))

    def mean(self):
        return jnp.asarray(self.lam, dtype=float)

    def std(self):
        return jnp.sqrt(jnp.asarray(self.lam, dtype=float))


# =========================================================================
# Multivariate normal (for IMH proposals and the probit example's prior)
# =========================================================================


@distribution
class MvNormal(Distribution):
    """Multivariate normal with mean vector and covariance matrix."""

    mu: jnp.ndarray
    cov: jnp.ndarray

    def _chol(self):
        return jnp.linalg.cholesky(self.cov)

    def logpdf(self, x):
        L = self._chol()
        d = jnp.shape(self.mu)[-1]
        xm = jnp.asarray(x) - self.mu  # (..., d)
        batch_shape = jnp.shape(xm)[:-1]
        # solve_triangular wants the vector axis leading: (d, k) RHS columns
        z = jax.scipy.linalg.solve_triangular(
            L, xm.reshape((-1, d)).T, lower=True
        )
        quad = jnp.sum(z * z, axis=0).reshape(batch_shape)
        return -0.5 * quad - jnp.sum(jnp.log(jnp.diagonal(L))) - 0.5 * d * LOG2PI

    def sample(self, key, shape=()):
        L = self._chol()
        d = jnp.shape(self.mu)[-1]
        eps = jax.random.normal(key, tuple(shape) + (d,))
        return self.mu + eps @ L.T

    def mean(self):
        return jnp.asarray(self.mu, dtype=float)


def logpdf(d: Distribution, x):
    """Free-function spelling ``logpdf(D, x)`` mirroring the reference DSL."""
    return d.logpdf(x)


def logcdf(d: Distribution, x):
    return d.logcdf(x)


def logccdf(d: Distribution, x):
    return d.logccdf(x)


ALL_DISTRIBUTIONS = [
    Normal, Uniform, Weibull, Gamma, Cauchy, LogNormal, Binomial, Beta,
    Laplace, Bernoulli, TDist, Exponential, Poisson,
]

__all__ = [d.__name__ for d in ALL_DISTRIBUTIONS] + [
    "MvNormal", "Distribution", "RightCensored", "LeftCensored", "Truncated",
    "logpdf", "logcdf", "logccdf",
]
