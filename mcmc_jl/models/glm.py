"""Per-observation terms of the GLM-family log-likelihoods (model(glm=...)).

``link_terms(kind)`` returns ``(ll, resid)``: ``ll(z, y)`` is the
elementwise log-likelihood of the linear predictor z, and ``resid(z, y)`` is
r such that d loglik / d theta = r @ X.  The plain model
(:func:`mcmc_jl.models.model.model`) and the GPU trajectory kernel
(:mod:`mcmc_jl.ops.pallas_glm`) share these definitions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy import special as jsp


def link_terms(kind):
    """``(ll, resid)`` for a built-in link name ("logistic", "linear",
    "poisson", "probit") or a user ``(ll, resid)`` pair of jax-traceable
    elementwise callables."""
    if isinstance(kind, tuple):
        ll_fn, resid_fn = kind
        assert callable(ll_fn) and callable(resid_fn), (
            "custom link must be a (ll(z, y), resid(z, y)) pair of callables"
        )
        return ll_fn, resid_fn
    if kind == "logistic":
        return (
            lambda z, y: z * y - jax.nn.softplus(z),
            lambda z, y: y - jax.nn.sigmoid(z),
        )
    if kind == "linear":  # unit-variance Gaussian residuals
        return (
            lambda z, y: -0.5 * (y - z) * (y - z),
            lambda z, y: y - z,
        )
    if kind == "poisson":  # log link; the lgamma(y+1) constant is dropped
        return (
            lambda z, y: y * z - jnp.exp(z),
            lambda z, y: y - jnp.exp(z),
        )
    if kind == "probit":
        def _ll(z, y):
            return y * jsp.log_ndtr(z) + (1.0 - y) * jsp.log_ndtr(-z)

        def _resid(z, y):
            log_phi = -0.5 * z * z - 0.5 * jnp.log(2.0 * jnp.pi)
            w_pos = jnp.exp(log_phi - jsp.log_ndtr(z))
            w_neg = jnp.exp(log_phi - jsp.log_ndtr(-z))
            return y * w_pos - (1.0 - y) * w_neg

        return _ll, _resid
    raise ValueError(f"unknown GLM link {kind!r}")
