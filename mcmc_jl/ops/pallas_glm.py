"""Whole-trajectory HMC kernel for GLM posteriors on the GPU (Pallas, Triton).

The generic engine evaluates one ``value_and_grad`` per leapfrog as XLA
ops: a (C, d) x (d, N) product, the elementwise link, and a (C, N) x (N, d)
product, with the (C, N) logits written to device memory and read back
between them.  This kernel runs all ``n_leaps`` steps of a trajectory for a
tile of chains in one program.  Each gradient loops over tiles of
observations: the logits of a tile exist only in registers, both products
of a tile run on the tensor cores, and the design matrix (64 KB at d = 10,
N = 1,000) stays in L2.  Momentum refresh and the Metropolis test stay in
XLA (:mod:`mcmc_jl.ops.glm_hmc`).

Layout (:func:`pad_design`, :func:`pad_chains`): the parameter dimension is
zero-padded to D, a power of two >= 16 (``pl.dot`` needs every dimension of
its right operand >= 16); observations to a multiple of the observation
tile; chains to a multiple of the chain tile.  Padded coordinates get a
zero gradient and stay zero; padded observations have a zero design column
and are masked out of the log-density.

Precision of the products:

- inside the trajectory, ``theta @ X^T`` and ``r @ X`` run at
  ``Precision.DEFAULT``, which the Triton route lowers to TF32;
- at the trajectory's last point, ``theta @ X^T`` runs at
  ``Precision.HIGHEST`` (IEEE f32): those logits give the log-density that
  enters the Metropolis ratio and the gradient carried into the next
  transition; its ``r @ X`` stays TF32.

Each gradient is a deterministic function of theta and the two ends of a
trajectory use the same function (the driver evaluates a chain's starting
point with this end-point code too, as a zero-length step), so the
integrator stays reversible and volume-preserving and the chain targets the
IEEE f32 log-density.  In interpret mode every product is exact f32.

Links: "logistic", "linear" and "poisson" (:data:`KERNEL_LINKS`).  The
Triton route lowers no ``erf``, so probit and user links take the generic
engine.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..models.glm import link_terms
from ..samplers.integrators import SCHEDULES

KERNEL_LINKS = ("logistic", "linear", "poisson")
#: largest parameter dimension the kernel serves (compiled and checked on
#: the card at D = 16 and D = 64; timed only at D = 16)
MAX_DIM = 64
#: chains per program, observations per inner tile, warps per program: the
#: tile chosen by a sweep on the H100 (PERF.md)
BLOCK_CHAINS = 128
BLOCK_OBS = 128
NUM_WARPS = 8
MIN_DIM = 16


def _next_pow2(n):
    return 1 << max(int(n) - 1, 0).bit_length()


def padded_dim(d):
    """D: the parameter dimension as the kernel lays it out."""
    return max(MIN_DIM, _next_pow2(d))


def _round_up(x, m):
    return (x + m - 1) // m * m


def pad_design(X, Y, weights=None, offsets=None):
    """(N, d) design, (N,) responses and optional (N,) weights/offsets ->
    ``(XT (D, N_pad), Y (N_pad,), W, O)`` f32 device arrays; W/O stay None
    when not given."""
    X = np.asarray(X, np.float32)
    N, d = X.shape
    n_pad = _round_up(N, BLOCK_OBS)
    XT = np.zeros((padded_dim(d), n_pad), np.float32)
    XT[:d, :N] = X.T

    def vec(v):
        if v is None:
            return None
        out = np.zeros((n_pad,), np.float32)
        out[:N] = np.asarray(v, np.float32).reshape(N)
        return jnp.asarray(out)

    return jnp.asarray(XT), vec(Y), vec(weights), vec(offsets)


def pad_chains(theta, D):
    """(C, d) -> (C_pad, D) zero-padded, C_pad a multiple of the tile."""
    C, d = theta.shape
    c_pad = _round_up(C, BLOCK_CHAINS)
    return jnp.pad(theta, ((0, c_pad - C), (0, D - d)))


def _kernel(xt_ref, y_ref, *refs, n_obs, n_leaps, eps, kind, lam,
            integrator, use_w, use_o):
    it = iter(refs)
    w_ref = next(it) if use_w else None
    o_ref = next(it) if use_o else None
    theta_ref, m_ref, g_ref, theta_out, m_out, g_out, lp_out = it
    ll_fn, resid_fn = link_terms(kind)
    n_tiles = xt_ref.shape[1] // BLOCK_OBS
    f32 = jnp.float32

    def tile(t):
        start = pl.multiple_of(t * BLOCK_OBS, BLOCK_OBS)
        cols = pl.ds(start, BLOCK_OBS)
        xt = xt_ref[:, cols]                           # (D, BN)
        y = y_ref[cols][None, :]
        w = w_ref[cols][None, :] if use_w else None
        o = o_ref[cols][None, :] if use_o else None
        return start, xt, y, w, o

    def logits(theta, xt, o, precision):
        z = jax.lax.dot(theta, xt, precision=precision,
                        preferred_element_type=f32)    # (BC, BN)
        return z if o is None else z + o

    def r_dot_x(r, xt):                                # (BC, BN)x(D, BN)^T
        return jax.lax.dot_general(
            r, xt, (((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.DEFAULT, preferred_element_type=f32)

    def grad_only(theta):
        def body(t, acc):
            _, xt, y, w, o = tile(t)
            r = resid_fn(logits(theta, xt, o, jax.lax.Precision.DEFAULT), y)
            if use_w:
                r = r * w
            return acc + r_dot_x(r, xt)

        acc = jax.lax.fori_loop(0, n_tiles, body, jnp.zeros_like(theta))
        return acc - lam * theta

    def logp_grad(theta):
        def body(t, carry):
            acc, lp = carry
            start, xt, y, w, o = tile(t)
            z = logits(theta, xt, o, jax.lax.Precision.HIGHEST)
            r, ll = resid_fn(z, y), ll_fn(z, y)
            if use_w:
                r, ll = r * w, ll * w
            live = (start + jnp.arange(BLOCK_OBS)) < n_obs
            ll = jnp.where(live[None, :], ll, 0.0)
            return acc + r_dot_x(r, xt), lp + jnp.sum(ll, axis=1)

        acc, lp = jax.lax.fori_loop(
            0, n_tiles, body,
            (jnp.zeros_like(theta), jnp.zeros((theta.shape[0],), f32)))
        lp = lp - 0.5 * lam * jnp.sum(theta * theta, axis=1)
        return lp, acc - lam * theta

    # the kick/drift schedule of samplers/integrators.py; the last macro
    # step is peeled so its last drift evaluates logp_grad
    schedule = SCHEDULES[integrator]
    last_a = max(i for i, (op, _) in enumerate(schedule) if op == "A")

    def macro(theta, m, g, final):
        lp = None
        for j, (op, c) in enumerate(schedule):
            if op == "B":
                m = m + (c * eps) * g
            else:
                theta = theta + (c * eps) * m
                if final and j == last_a:
                    lp, g = logp_grad(theta)
                else:
                    g = grad_only(theta)
        return theta, m, g, lp

    theta, m, g = jax.lax.fori_loop(
        0, n_leaps - 1, lambda _, c: macro(*c, False)[:3],
        (theta_ref[...], m_ref[...], g_ref[...]))
    theta, m, g, lp = macro(theta, m, g, True)
    theta_out[...] = theta
    m_out[...] = m
    g_out[...] = g
    lp_out[...] = lp


@functools.partial(
    jax.jit,
    static_argnames=("n_obs", "n_leaps", "eps", "kind", "lam", "integrator",
                     "interpret"))
def glm_trajectory(XT, Y, W, O, theta, m, grad, *, n_obs, n_leaps, eps,
                   kind="logistic", lam=1.0, integrator="leapfrog",
                   interpret=False):
    """``n_leaps`` macro steps of ``integrator`` for every chain.

    ``XT, Y, W, O`` come from :func:`pad_design` (W/O may be None);
    ``theta, m, grad`` are (C_pad, D) with zero padded columns; ``n_obs``
    is the unpadded N; ``eps`` and the prior precision ``lam`` are static
    floats.  Returns ``(theta, m, grad, logp)``, logp of shape (C_pad,).

    Runs compiled for the GPU, or in the Pallas interpreter when
    ``interpret=True``; anything else raises."""
    if kind not in KERNEL_LINKS:
        raise ValueError(f"the GLM kernel serves links {KERNEL_LINKS}, "
                         f"not {kind!r}")
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the GLM trajectory kernel is compiled for the GPU only; pass "
            "interpret=True to run it in the Pallas interpreter")
    C, D = theta.shape
    assert C % BLOCK_CHAINS == 0 and XT.shape[1] % BLOCK_OBS == 0, (
        "pad with pad_chains/pad_design first")
    use_w, use_o = W is not None, O is not None
    obs = [a for a in (W, O) if a is not None]
    chain_spec = pl.BlockSpec((BLOCK_CHAINS, D), lambda i: (i, 0))
    kernel = functools.partial(
        _kernel, n_obs=n_obs, n_leaps=n_leaps, eps=float(eps), kind=kind,
        lam=float(lam), integrator=integrator, use_w=use_w, use_o=use_o)
    state = jax.ShapeDtypeStruct((C, D), jnp.float32)
    return pl.pallas_call(
        kernel,
        grid=(C // BLOCK_CHAINS,),
        in_specs=[pl.no_block_spec] * (2 + len(obs)) + [chain_spec] * 3,
        out_specs=[chain_spec] * 3
        + [pl.BlockSpec((BLOCK_CHAINS,), lambda i: (i,))],
        out_shape=[state, state, state,
                   jax.ShapeDtypeStruct((C,), jnp.float32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="glm_trajectory",
    )(XT, Y, *obs, theta, m, grad)
