"""Cross-chain pooled adaptation.

The reference adapts each chain's step size from its own acceptance counts
(EmpMCTuner, samplers.jl:31-50; dual averaging, HMCDA.jl/NUTS.jl).  With
thousands of vmapped chains the natural upgrade is to *pool* the
adaptation across the chain axis: after every step the adapted scalars
(step sizes, dual-averaging statistics) are replaced by their cross-chain
(geometric) mean — an all-reduce that XLA lowers to ``psum`` collectives
when the chain axis is sharded over a mesh.  Pooling cuts adaptation noise
by ~sqrt(n_chains) and keeps all chains' control flow identical.

Counters (accepted/proposed) stay per-chain — each chain's local rate feeds
its local update, and the pooling of the *resulting* step sizes performs the
averaging; summing counters across chains every step would double-count.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..samplers.base import TuneState

# fields pooled with a geometric mean (positive scales)
_GEO_FIELDS = ("leap_step", "dual_leap_step", "epsilon")
# fields pooled with an arithmetic mean
_ARITH_FIELDS = ("dual_h", "hbar", "lebar")


def pool_tuner_states(states):
    """Average adaptation state across the leading chain axis and broadcast
    the pooled values back to every chain.  No-op for samplers without
    adaptation state."""
    updates = {}
    if hasattr(states, "tune") and isinstance(states.tune, TuneState):
        t = states.tune
        pooled_step = jnp.exp(
            jnp.broadcast_to(jnp.mean(jnp.log(t.step_size), axis=0),
                             t.step_size.shape)
        )
        pooled_leaps = jnp.broadcast_to(
            jnp.max(t.n_leaps, axis=0), t.n_leaps.shape
        )
        updates["tune"] = TuneState(
            step_size=pooled_step,
            n_leaps=pooled_leaps,
            accepted=t.accepted,
            proposed=t.proposed,
        )
    for f in _GEO_FIELDS:
        if hasattr(states, f):
            v = getattr(states, f)
            updates[f] = jnp.exp(
                jnp.broadcast_to(jnp.mean(jnp.log(v), axis=0), v.shape)
            )
    for f in _ARITH_FIELDS:
        if hasattr(states, f):
            v = getattr(states, f)
            updates[f] = jnp.broadcast_to(jnp.mean(v, axis=0), v.shape)
    if not updates:
        return states
    return states.replace(**updates)
