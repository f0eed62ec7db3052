"""Mass-matrix warmup: diagonal / dense metric, Stan-style expanding windows.

The reference has no mass adaptation — its only preconditioning is the static
``model.scale`` hint (e.g. NUTS.jl:73,138).  This module is a
beyond-reference capability shared by :class:`HMC` and :class:`NUTS`:

- ``mass_adapt=True`` (or ``"diag"``): continuous Welford variance estimate
  over the whole burn-in, folded into the integrator as a per-coordinate
  scale (the original mcmc_jl behavior).
- ``mass_adapt="diag-win"``: diagonal metric re-estimated at the end of
  Stan-style expanding, memoryless windows (init buffer 75, doubling windows
  from 25, terminal buffer 50 — the ``adapt window`` scheme of the Stan
  reference manual), frozen after burn-in.
- ``mass_adapt="dense"``: full covariance metric from windowed Welford
  accumulation; the Cholesky factor of the regularized estimate
  ``(n/(n+5)) Sigma + 1e-3 (5/(n+5)) I`` preconditions the dynamics in
  standardized coordinates ``theta = L z`` (kinetic energy
  ``1/2 p' M^{-1} p`` with ``M^{-1} = Sigma``).

Everything is a pure pytree transition so it lives inside the runners'
``lax.scan`` with no host round-trips; window boundaries are data-independent
functions of the step counter, so the whole schedule compiles statically.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import pytree_dataclass

# Stan reference-manual adaptation schedule constants
INIT_BUFFER = 75
TERM_BUFFER = 50
BASE_WINDOW = 25
REG = 1e-3  # regularization scale toward the (scaled) identity


def mass_kind(mass_adapt):
    """Normalize the user-facing ``mass_adapt`` flag to an internal kind."""
    if mass_adapt is False or mass_adapt is None:
        return None
    if mass_adapt is True:
        return "diag"
    s = str(mass_adapt)
    if s == "diag":
        return "diag"
    if s in ("diag-win", "diag_win", "diag-windowed", "diag_windowed"):
        return "diag-win"
    if s == "dense":
        return "dense"
    raise ValueError(
        f"mass_adapt must be False, True, 'diag', 'diag-win' or 'dense'; "
        f"got {mass_adapt!r}"
    )


@pytree_dataclass
class MassAccum:
    """Welford accumulators + current metric scale.

    ``m2``/``scale`` are vectors for the diagonal kinds, matrices (lower-tri
    Cholesky for ``scale``) for the dense kind.
    """

    count: jnp.ndarray  # int32 samples in the current window
    mean: jnp.ndarray  # (d,)
    m2: jnp.ndarray  # (d,) or (d, d)
    scale: jnp.ndarray  # (d,) sqrt-variances, or (d, d) lower-tri L
    next_end: jnp.ndarray  # int32; -1 = not yet armed
    window: jnp.ndarray  # int32 current window length


def mass_init(kind, d, dtype, scale0=None):
    """Fresh accumulator.  ``scale0`` seeds the dense metric's diagonal
    (e.g. ``model.scale`` for NUTS parity) until the first window closes."""
    dense = kind == "dense"
    if dense:
        scale = (jnp.eye(d, dtype=dtype) if scale0 is None
                 else jnp.diag(jnp.asarray(scale0, dtype=dtype) * jnp.ones(d, dtype)))
        m2 = jnp.zeros((d, d), dtype=dtype)
    else:
        scale = jnp.ones((d,), dtype=dtype)
        m2 = jnp.zeros((d,), dtype=dtype)
    return MassAccum(
        count=jnp.asarray(0, jnp.int32),
        mean=jnp.zeros((d,), dtype=dtype),
        m2=m2,
        scale=scale,
        next_end=jnp.asarray(-1, jnp.int32),
        window=jnp.asarray(BASE_WINDOW, jnp.int32),
    )


def mass_vector_scale(kind, acc: MassAccum, dtype, count_threshold=20):
    """Per-coordinate scale for the diagonal kinds: the live Welford estimate
    (continuous mode, identity until ``count_threshold`` samples) or the
    frozen last-window estimate (windowed mode)."""
    if kind == "diag":
        cnt = acc.count.astype(dtype)
        var = acc.m2 / jnp.maximum(cnt - 1.0, 1.0)
        s = jnp.sqrt(jnp.clip(var, 1e-6, 1e6))
        return jnp.where(acc.count >= count_threshold, s, jnp.ones_like(s))
    return acc.scale.astype(dtype)


def mass_update(kind, acc: MassAccum, x, i, burnin):
    """Post-accept transition of the accumulator at step ``i`` (1-based)."""
    if kind is None:
        return acc
    dtype = x.dtype

    if kind == "diag":  # continuous: accumulate across the whole burn-in
        adapting = i <= burnin
        cnt = acc.count + jnp.where(adapting, 1, 0)
        cf = jnp.maximum(cnt.astype(dtype), 1.0)
        delta = x - acc.mean
        mean = jnp.where(adapting, acc.mean + delta / cf, acc.mean)
        m2 = jnp.where(adapting, acc.m2 + delta * (x - mean), acc.m2)
        return acc.replace(count=cnt, mean=mean, m2=m2)

    # windowed kinds ------------------------------------------------------
    # Stan-style buffer shrinking: with a short adaptation span the fixed
    # 75/50 buffers would leave no accumulation window at all (a silent
    # no-op); scale them to 15%/10% of the span instead, like Stan's
    # init_buffer/term_buffer rescaling.
    full = burnin >= INIT_BUFFER + TERM_BUFFER + BASE_WINDOW
    init_buf = jnp.where(full, INIT_BUFFER, (burnin * 15) // 100)
    term_buf = jnp.where(full, TERM_BUFFER, burnin // 10)
    adapt_end = jnp.maximum(burnin - term_buf, 0)
    next_end = jnp.where(
        acc.next_end < 0,
        jnp.minimum(init_buf + acc.window, adapt_end),
        acc.next_end,
    )
    in_win = (i > init_buf) & (i <= adapt_end)
    cnt = acc.count + jnp.where(in_win, 1, 0)
    cf = jnp.maximum(cnt.astype(dtype), 1.0)
    delta = x - acc.mean
    mean = jnp.where(in_win, acc.mean + delta / cf, acc.mean)
    d2 = x - mean
    upd = jnp.outer(delta, d2) if kind == "dense" else delta * d2
    m2 = jnp.where(in_win, acc.m2 + upd, acc.m2)

    # close the window once the counter passes its end (>=: self-healing if
    # the boundary lands before two samples accumulated)
    at_end = in_win & (i >= next_end) & (cnt >= 2)
    n = cnt.astype(dtype)
    w = n / (n + 5.0)
    if kind == "dense":
        cov = m2 / jnp.maximum(n - 1.0, 1.0)
        cov_reg = w * cov + REG * (1.0 - w) * jnp.eye(x.shape[0], dtype=dtype)
        chol = jnp.linalg.cholesky(cov_reg)
        est = jnp.where(jnp.any(jnp.isnan(chol)), acc.scale, chol)
    else:
        var = m2 / jnp.maximum(n - 1.0, 1.0)
        est = jnp.sqrt(w * var + REG * (1.0 - w))
    scale = jnp.where(at_end, est, acc.scale)

    new_window = acc.window * 2
    cand = i + new_window
    # Stan: if the window after next would overrun the adaptation span,
    # extend the next window to the end instead
    cand = jnp.where(cand + 2 * new_window > adapt_end, adapt_end, cand)
    cand = jnp.minimum(jnp.maximum(cand, i + 1), adapt_end)

    return MassAccum(
        count=jnp.where(at_end, 0, cnt),
        mean=jnp.where(at_end, jnp.zeros_like(mean), mean),
        m2=jnp.where(at_end, jnp.zeros_like(m2), m2),
        scale=scale,
        next_end=jnp.where(at_end, cand, next_end),
        window=jnp.where(at_end, new_window, acc.window),
    )


def dense_transforms(L):
    """Coordinate maps for the dense metric: ``theta = L z``.

    Returns ``(fwd, inv, grad_fwd, grad_inv)`` with
    ``grad_z = L' grad_theta`` (chain rule) and its inverse.
    """
    from jax.scipy.linalg import solve_triangular

    return (
        lambda z: L @ z,
        lambda t: solve_triangular(L, t, lower=True),
        lambda g: L.T @ g,
        lambda g: solve_triangular(L.T, g, lower=False),
    )
