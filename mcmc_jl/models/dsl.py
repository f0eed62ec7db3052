"""The ``~`` model DSL, traced by JAX.

The reference parses a Julia ``quote`` block, rewrites ``x ~ D(args)`` into
``__acc += logpdf(D(args), x)`` against an ``LLAcc`` accumulator, and feeds the
result to a source-to-source AD engine (reference: src/dsl/expr_funcs.jl:8-36,
src/dsl/modelparser.jl:39-104, src/dsl/definitions/AccumulatorDerivRules.jl).

The JAX equivalent needs no source rewriting: a model is an ordinary
Python function of named parameters, traced once by JAX.  Sampling statements
are spelled with :func:`tilde` (alias :func:`observe`) against an implicit
accumulator established by :class:`trace`; ``jax.grad`` replaces the
reference's ReverseDiffSource engine.  Censoring sugar carries over directly:
``tilde(y, +D)`` right-censors (logccdf) and ``tilde(y, -D)`` left-censors
(logcdf), mirroring ``y ~ +D`` / ``y ~ -D`` (expr_funcs.jl:18-22).

Example (reference examples/logistic_regression.jl rewritten)::

    from mcmc_jl import model, tilde
    from mcmc_jl.distributions import Normal, Bernoulli

    def ex(vars):
        tilde(vars, Normal(0, 1.0))
        prob = 1 / (1 + jnp.exp(-X @ vars))
        tilde(Y, Bernoulli(prob))

    m = model(ex, vars=jnp.zeros(nbeta), gradient=True)

Out-of-support values contribute ``-inf`` (never an exception), replacing the
reference's ``OutOfSupportError`` throw/catch that maps to ``(-Inf, 0)``
(modelparser.jl:64-72).
"""
from __future__ import annotations

import threading

import jax.numpy as jnp

from .distributions import Distribution

_STATE = threading.local()


class trace:
    """Context manager that collects the log-likelihood accumulator.

    The analog of the reference's ``__acc = LLAcc(0.)`` prologue
    (modelparser.jl:48-51): each :func:`tilde` statement adds the *sum* of its
    elementwise logpdf (LLAcc sums arrays, AccumulatorDerivRules.jl:20).
    """

    def __enter__(self):
        if not hasattr(_STATE, "stack"):
            _STATE.stack = []
        _STATE.stack.append([])
        return self

    def __exit__(self, *exc):
        self.terms = _STATE.stack.pop()
        return False

    @property
    def value(self):
        acc = jnp.asarray(0.0)
        for t in self.terms:
            acc = acc + t
        return acc


def tilde(x, d: Distribution):
    """``x ~ d``: accumulate ``sum(logpdf(d, x))`` into the active trace."""
    if not getattr(_STATE, "stack", None):
        raise RuntimeError(
            "tilde()/observe() called outside a model trace; statements using "
            "~ semantics must run inside a function passed to model(...)"
        )
    lp = d.logpdf(x)
    _STATE.stack[-1].append(jnp.sum(lp))
    return x


# numpyro-style alias
observe = tilde


def acc(term):
    """``__acc += term``: add a raw log-density increment (summed over
    arrays) to the active trace.

    Direct parity with the reference accumulator's Real/Array ``+``
    overloads (AccumulatorDerivRules.jl:19-20) — the idiom for Jacobian
    corrections of reparameterized variables (e.g. sampling ``log_tau``
    with a prior on ``tau``) and for hand-written likelihood terms
    (Stan's ``target +=``).
    """
    if not getattr(_STATE, "stack", None):
        raise RuntimeError(
            "acc()/factor() called outside a model trace; statements using "
            "~ semantics must run inside a function passed to model(...)"
        )
    _STATE.stack[-1].append(jnp.sum(jnp.asarray(term)))
    return term


# numpyro-style alias
factor = acc


def call_with_trace(fn, kwargs):
    """Run ``fn(**kwargs)`` under a fresh accumulator; return total log-lik.

    The function's return value is ignored: the model's value *is* the
    accumulator (the reference extracts ``__acc.val``, modelparser.jl:48-51).
    This also makes ``lambda x: tilde(x, D)`` safe — tilde returns ``x`` for
    chaining, which must not be double-counted.
    """
    with trace() as tr:
        fn(**kwargs)
    return tr.value
