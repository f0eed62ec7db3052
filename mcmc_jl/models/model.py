"""Log-density model layer.

Batched redesign of the reference's ``MCMCLikelihoodModel``
(reference: src/modellers/likmodel.jl:20-58 and src/modellers/mcmcmodels.jl).
The model is a frozen pytree of *pure functions* over a flat parameter
vector:

- ``eval(theta)``              log-target                      (likmodel.jl:21)
- ``evalg / evalallg``         gradient / (logp, grad)         (likmodel.jl:22,25)
- ``evalt / evalallt``         metric tensor G                 (likmodel.jl:23,26)
- ``evaldt / evalalldt``       dG (d x d x d)                  (likmodel.jl:24,27)
- ``pmap``                     name -> (offset, shape), 1-based offsets like
                               the reference (likmodel.jl:28, expr_funcs.jl:86)
- ``init`` / ``scale``         initial values and scaling hints

Where the reference auto-synthesizes missing single/tuple variants from
whichever the user supplied (likmodel.jl:121-136), we do the same — but with
``jax.value_and_grad`` available as the universal fallback, so *any* model can
be upgraded with an exact gradient (the reference could do this only for
DSL-expression models via its external ReverseDiffSource engine).  Higher
derivatives the reference only accepts as user functions (SURVEY §2.2) can be
auto-derived here with ``tensor=True`` (Fisher/observed information via
``jax.hessian``) and ``dtensor=True`` (``jax.jacfwd`` of the tensor).

Out-of-support semantics: the log-target is sanitized to ``-inf`` (NaN ->
-inf) and the gradient to the zero vector whenever the log-target is not
finite, matching the reference's try/catch of OutOfSupportError ->
``(-Inf, zeros)`` (src/dsl/modelparser.jl:64-72) without any host control
flow — everything stays jittable.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import dsl
from ..utils.dtypes import real_dtype


def _sanitize_logp(f):
    def eval_(theta):
        lp = f(theta)
        lp = jnp.asarray(lp, dtype=jnp.result_type(theta))
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    return eval_


def _sanitize_allg(allg):
    def evalallg(theta):
        lp, g = allg(theta)
        lp = jnp.where(jnp.isnan(lp), -jnp.inf, lp)
        ok = jnp.isfinite(lp)
        g = jnp.where(ok, jnp.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0), 0.0)
        return lp, g

    return evalallg


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class LogDensityModel:
    """A likelihood-type model: differentiable log-target over R^size."""

    eval: Callable  # theta -> logp
    evalg: Optional[Callable]  # theta -> grad
    evalt: Optional[Callable]  # theta -> G (d,d)
    evaldt: Optional[Callable]  # theta -> dG (d,d,d)
    evalallg: Optional[Callable]  # theta -> (logp, grad)
    evalallt: Optional[Callable]  # theta -> (logp, grad, G)
    evalalldt: Optional[Callable]  # theta -> (logp, grad, G, dG)
    pmap: dict  # name -> (offset(1-based), shape)
    size: int
    init: jnp.ndarray
    scale: jnp.ndarray
    #: set for models built via model(glm=...): enables the GLM trajectory
    #: kernel route in prun/run(chains=) (parallel/pchains.kernel_route)
    glm_spec: Any = None

    # -- pytree protocol (only init/scale are leaves; fns are static) ------
    def tree_flatten(self):
        children = (self.init, self.scale)
        aux = (self.eval, self.evalg, self.evalt, self.evaldt, self.evalallg,
               self.evalallt, self.evalalldt, tuple(sorted(self.pmap.items())),
               self.size, self.glm_spec)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        init, scale = children
        (ev, g, t, dt, ag, at, adt, pmap_items, size, gspec) = aux
        return cls(ev, g, t, dt, ag, at, adt, dict(pmap_items), size, init,
                   scale, gspec)

    # -- capability predicates (reference mcmcmodels.jl:19-21) -------------
    @property
    def hasgradient(self):
        return self.evalg is not None

    @property
    def hastensor(self):
        return self.evalt is not None

    @property
    def hasdtensor(self):
        return self.evaldt is not None

    # -- parameter <-> named variables (reference expr_funcs.jl:39-91) -----
    def unravel(self, theta):
        """Flat vector -> dict of named parameter arrays (matrices stored
        column-major, like Julia)."""
        out = {}
        for name, (off, shape) in self.pmap.items():
            n = int(np.prod(shape)) if len(shape) else 1
            sl = theta[off - 1 : off - 1 + n]
            if len(shape) == 0:
                out[name] = sl[0]
            elif len(shape) == 1:
                out[name] = sl.reshape(shape)
            else:
                out[name] = sl.reshape(shape, order="F")
        return out

    def ravel(self, values: dict):
        """Dict of named parameter arrays -> flat vector."""
        theta = jnp.zeros((self.size,), dtype=real_dtype())
        for name, (off, shape) in self.pmap.items():
            v = jnp.asarray(values[name], dtype=theta.dtype)
            v = v.reshape(-1, order="F") if v.ndim == 2 else v.reshape(-1)
            theta = theta.at[off - 1 : off - 1 + v.size].set(v)
        return theta

    def column_names(self):
        """Column names 'k', 'k.i', 'k.i.j' (1-based) exactly as the
        reference builds them (SerialMC.jl:70-79)."""
        cn = [None] * self.size
        for name, (off, shape) in self.pmap.items():
            if len(shape) == 0:
                cn[off - 1] = f"{name}"
            elif len(shape) == 1:
                for i in range(shape[0]):
                    cn[off - 1 + i] = f"{name}.{i + 1}"
            else:
                # column-major like Julia's comprehension over (i, j)
                k = 0
                for j in range(shape[1]):
                    for i in range(shape[0]):
                        cn[off - 1 + k] = f"{name}.{i + 1}.{j + 1}"
                        k += 1
        return cn

    def with_scale(self, scale):
        scale = jnp.broadcast_to(jnp.asarray(scale, dtype=real_dtype()), (self.size,))
        return dataclasses.replace(self, scale=scale)

    def __mul__(self, other):
        """``model * sampler`` composition sugar (reference MCMC.jl:87-98)."""
        from ..core.task import product

        return product(self, other)

    def __repr__(self):
        caps = "".join(
            s for s, has in [(" +grad", self.hasgradient), ("/tensor", self.hastensor),
                             ("/dtensor", self.hasdtensor)] if has
        )
        return f"LogDensityModel(size={self.size}, params={list(self.pmap)}{caps})"


def _ispartition(pmap, n):
    """Check pmap tiles [1, n] exactly (reference mcmcmodels.jl:9-15)."""
    c = np.zeros(n)
    for off, shape in pmap.values():
        c[off - 1 : off - 1 + max(1, int(np.prod(shape)))] += 1
    return bool(np.all(c == 1))


def _model_vars(params: dict):
    """kwargs of initial values -> (size, pmap, init vector).

    Mirrors ``modelVars`` (reference expr_funcs.jl:76-91): 1-based offsets in
    declaration order; scalars keep shape (), matrices are stored flattened.
    """
    pmap = {}
    pos = 1
    flat = []
    for name, v in params.items():
        arr = np.asarray(v, dtype=np.float64)
        pmap[name] = (pos, arr.shape)
        pos += max(1, arr.size)
        flat.append(arr.reshape(-1, order="F") if arr.ndim == 2 else arr.reshape(-1))
    init = np.concatenate(flat) if flat else np.zeros((0,))
    return pos - 1, pmap, init


@dataclasses.dataclass(frozen=True, eq=False)
class GLMSpec:
    """Design/response data of a GLM-family posterior (model(glm=...)).

    Carried on the model so the multi-chain runners can route plain-HMC
    sampling to the GPU trajectory kernel (ops/pallas_glm.py).

    ``eq=False``: identity equality/hash.  The spec holds raw numpy arrays
    and lives in the model's static pytree aux, which JAX requires to be
    hashable — dataclass-generated ``__eq__`` would raise on arrays.  Models
    already compare by identity (their fn fields are closures), so this
    loses nothing."""

    kind: Any  # link name or (ll, resid) callable pair
    X: Any  # (N, d) design
    Y: Any  # (N,) responses
    weights: Any = None
    offsets: Any = None
    prior_prec: float = 1.0


def model(
    f: Optional[Callable] = None,
    *,
    glm: Any = None,
    weights: Any = None,
    offsets: Any = None,
    prior_prec: float = 1.0,
    grad: Optional[Callable] = None,
    tensor: Any = None,
    dtensor: Any = None,
    allgrad: Optional[Callable] = None,
    alltensor: Optional[Callable] = None,
    alldtensor: Optional[Callable] = None,
    init: Any = None,
    scale: Any = 1.0,
    pmap: Optional[dict] = None,
    gradient: bool = False,
    mtype: str = "likelihood",
    check_init: bool = True,
    debug: bool = False,
    **params,
) -> LogDensityModel:
    """The model factory — front door of the framework.

    Two modes, mirroring the reference's two ``model()`` entry points
    (src/modellers/mcmcmodels.jl:27-33, likmodel.jl:72-96 / 110-160):

    1. **Callable mode** — ``f`` maps a flat parameter vector to the
       log-target; pass ``init=`` (vector or scalar).  Optional ``grad``,
       ``tensor``, ``dtensor`` (or tuple variants ``allgrad`` etc.).
       ``gradient=True`` derives the gradient with ``jax.grad``.
    2. **DSL mode** — ``f`` is a function of *named* parameters using
       :func:`~mcmc_jl.models.dsl.tilde` statements; pass one kwarg per
       parameter giving its initial value (the reference's
       ``model(expr, v=ones(3), gradient=true)``).

    ``tensor=True`` / ``dtensor=True`` request autodiff-derived higher
    derivatives (negative Hessian of the log-target and its jacobian).

    ``debug=True`` returns the traced jaxpr of the log-target instead of a
    model — the analog of the reference's ``generateModelFunction(...,
    debug=true)`` which returns the generated expression
    (modelparser.jl:103).
    """
    if mtype != "likelihood":
        raise ValueError(f"unsupported model type {mtype!r}")

    dtype = real_dtype()

    glm_spec_obj = None
    if glm is not None:  # ---- GLM mode ---------------------------------
        # Bayesian GLM: logp = sum_i w_i ll(x_i'theta + o_i, y_i)
        #                      - (lam/2)|theta|^2, with analytic gradient.
        # The spec is kept on the model so prun/run(chains=) can route plain
        # HMC to the GPU trajectory kernel.
        assert f is None and not params, "pass either f/DSL params or glm=..."
        from .glm import link_terms

        kind, X, Y = glm
        ll_fn, resid_fn = link_terms(kind)
        Xj = jnp.asarray(np.asarray(X), dtype=dtype)  # (N, d)
        Yj = jnp.asarray(np.asarray(Y), dtype=dtype)
        Wj = None if weights is None else jnp.asarray(np.asarray(weights), dtype=dtype)
        Oj = None if offsets is None else jnp.asarray(np.asarray(offsets), dtype=dtype)
        lam = float(prior_prec)
        d_glm = int(Xj.shape[1])

        def _glm_logp(th):
            z = Xj @ th
            if Oj is not None:
                z = z + Oj
            ll = ll_fn(z, Yj)
            if Wj is not None:
                ll = Wj * ll
            return jnp.sum(ll) - 0.5 * lam * jnp.dot(th, th)

        def _glm_grad(th):
            z = Xj @ th
            if Oj is not None:
                z = z + Oj
            r = resid_fn(z, Yj)
            if Wj is not None:
                r = Wj * r
            return Xj.T @ r - lam * th

        f = _glm_logp
        if grad is None and allgrad is None and not gradient:
            grad = _glm_grad
        if init is None:
            init = jnp.zeros((d_glm,), dtype=dtype)
        glm_spec_obj = GLMSpec(
            kind=kind, X=np.asarray(X), Y=np.asarray(Y),
            weights=None if weights is None else np.asarray(weights),
            offsets=None if offsets is None else np.asarray(offsets),
            prior_prec=lam,
        )
    else:
        assert weights is None and offsets is None, (
            "weights/offsets only apply to glm= models"
        )
    assert f is not None or params, "model() needs a callable, DSL params or glm="

    if params:  # ---- DSL mode ------------------------------------------
        assert init is None, "'init' kwarg not allowed for DSL models (use named params)"
        assert pmap is None, "'pmap' kwarg not allowed for DSL models"
        size, pm, init_vec = _model_vars(params)

        def logp_flat(theta):
            values = _unravel_static(theta, pm)
            return dsl.call_with_trace(f, values)

        raw_eval = logp_flat
        init_vec = jnp.asarray(init_vec, dtype=dtype)
        pmap = pm
    else:  # ---- callable mode ------------------------------------------
        if init is None:
            init = jnp.asarray([1.0], dtype=dtype)
        init_vec = jnp.atleast_1d(jnp.asarray(init, dtype=dtype))
        size = int(init_vec.shape[0])
        if pmap is None:
            pmap = {"pars": (1, (size,))}  # likmodel.jl:139
        raw_eval = f

    assert _ispartition(pmap, size), "param map is not a partition of parameter vector"

    if debug:
        return jax.make_jaxpr(raw_eval)(jnp.zeros((size,), dtype=dtype))

    scale_vec = jnp.broadcast_to(jnp.asarray(scale, dtype=dtype), (size,))

    eval_ = _sanitize_logp(raw_eval)

    # ---- gradient family (likmodel.jl:121-136 synthesis, via jax.grad) ---
    if allgrad is not None:
        evalallg = _sanitize_allg(allgrad)
        evalg = grad if grad is not None else (lambda th: evalallg(th)[1])
    elif grad is not None:
        evalg = grad
        evalallg = _sanitize_allg(lambda th: (raw_eval(th), grad(th)))
    elif gradient:
        evalallg = _sanitize_allg(jax.value_and_grad(raw_eval))
        evalg = lambda th: evalallg(th)[1]  # noqa: E731
    else:
        evalg = evalallg = None

    # ---- tensor family ---------------------------------------------------
    if tensor is True:  # observed information G = -H(logp)
        evalt = lambda th: -jax.hessian(raw_eval)(th)  # noqa: E731
    elif callable(tensor):
        evalt = tensor
    elif alltensor is not None:
        evalt = lambda th: alltensor(th)[-1]  # noqa: E731
    else:
        evalt = None

    if evalt is not None:
        if alltensor is not None:
            evalallt = alltensor
        else:
            assert evalallg is not None, (
                "tensor requires a gradient (pass grad=..., allgrad=... or gradient=True)"
            )
            _ag, _t = evalallg, evalt
            evalallt = lambda th: (*_ag(th), _t(th))  # noqa: E731
    else:
        evalallt = None

    # ---- dtensor family --------------------------------------------------
    if dtensor is True:
        assert evalt is not None, "dtensor=True requires a tensor"
        _t = evalt
        # jacfwd yields dG[i, j, k] = dG_ij/dtheta_k — already the reference
        # layout (PMALA.jl:77-80 indexes dG[:, :, i])
        evaldt = jax.jacfwd(_t)
    elif callable(dtensor):
        evaldt = dtensor
    elif alldtensor is not None:
        evaldt = lambda th: alldtensor(th)[-1]  # noqa: E731
    else:
        evaldt = None

    if evaldt is not None:
        if alldtensor is not None:
            evalalldt = alldtensor
        else:
            assert evalallt is not None, "dtensor requires tensor"
            _at, _dt = evalallt, evaldt
            evalalldt = lambda th: (*_at(th), _dt(th))  # noqa: E731
    else:
        evalalldt = None

    # jit every entry point: models are evaluated millions of times (eagerly
    # from stats/tests, traced from samplers — jit-of-jit inlines cleanly)
    jit_ = lambda f: None if f is None else jax.jit(f)  # noqa: E731

    mdl = LogDensityModel(
        eval=jit_(eval_),
        evalg=jit_(evalg),
        evalt=jit_(evalt),
        evaldt=jit_(evaldt),
        evalallg=jit_(evalallg),
        evalallt=jit_(evalallt),
        evalalldt=jit_(evalalldt),
        pmap=pmap,
        size=size,
        init=init_vec,
        scale=scale_vec,
        glm_spec=glm_spec_obj,
    )

    if check_init:
        lp0 = float(mdl.eval(mdl.init))
        if not np.isfinite(lp0):
            raise ValueError("Initial values out of model support, try other values")

    return mdl


def _unravel_static(theta, pmap):
    out = {}
    for name, (off, shape) in pmap.items():
        n = max(1, int(np.prod(shape)))
        # offsets are Python ints: a STATIC slice, not lax.dynamic_slice
        assert isinstance(off, (int, np.integer)), (
            f"pmap offset for {name!r} must be a Python int (got "
            f"{type(off).__name__})")
        sl = jax.lax.slice_in_dim(theta, off - 1, off - 1 + n)
        if len(shape) == 0:
            out[name] = sl[0]
        elif len(shape) == 1:
            out[name] = sl.reshape(shape)
        else:
            out[name] = sl.reshape(shape, order="F")
    return out
