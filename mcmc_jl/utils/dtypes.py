"""Floating-point policy.

The reference engine is Float64 throughout (Julia).  JAX defaults to
float32; enabling
``jax.config.update("jax_enable_x64", True)`` (as the CPU test suite does)
switches the whole framework to float64 with no code changes: every literal
and buffer derives its dtype from :func:`real_dtype`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def real_dtype():
    """The default real dtype: f64 when x64 is enabled, else f32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def as_real(x):
    """Convert to a jnp array of the default real dtype."""
    return jnp.asarray(x, dtype=real_dtype())
