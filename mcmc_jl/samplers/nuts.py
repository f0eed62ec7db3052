"""No-U-Turn sampler (reference: src/samplers/NUTS.jl; Hoffman & Gelman 2011).

The reference builds trees with host recursion (NUTS.jl:85-118).  Recursion
and dynamic shapes don't exist under XLA, so the doubling is re-derived as an
*iterative* tree expansion (SURVEY §7 hard part (a)): each doubling runs a
bounded ``lax.while_loop`` over the 2^j new leapfrog leaves, selecting the
subtree proposal by reservoir sampling (probabilistically identical to the
recursive pairwise ``rand() <= n2/(n1+n2)`` merge, NUTS.jl:106), and checking
every power-of-two-aligned sub-span for u-turns against a checkpoint stack of
at most ``maxdoublings`` stored states, addressed with bit tricks:

- an even leaf ``k`` is stored at slot ``popcount(k)``;
- at an odd leaf ``k``, the spans ending at ``k`` have start states in slots
  ``popcount(k>>1) - trailing_ones(k) + 1 .. popcount(k>>1)``.

Semantics matched to the reference: log-space slice variable
``u = log(rand()) - H0`` (NUTS.jl:141), leaf validity ``u <= -H``, divergence
gate ``u < deltamax - H`` with deltamax=100 (NUTS.jl:90-95), u-turn test
``dot(th+ - th-, m) < 0`` on either endpoint momentum (NUTS.jl:50), momentum
scaled by ``model.scale`` (NUTS.jl:73,138), and hard-coded dual-averaging
constants delta=0.7, nadapt=1000, gamma=0.05, kappa=0.75, t0=10
(NUTS.jl:121-125).  Diagnostics: ``epsilon``, ``ndoublings`` (NUTS.jl:177).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .base import RunCtx, Sampler, pytree_dataclass
from .hmc import hamiltonian, leapfrog
from .massadapt import (
    MassAccum, dense_transforms, mass_init, mass_kind, mass_update,
    mass_vector_scale,
)

DELTAMAX = 100.0
# dual-averaging constants (NUTS.jl:121-125)
DELTA = 0.7
NADAPT = 1000
GAM = 0.05
KAPPA = 0.75
T0 = 10.0


@pytree_dataclass
class NUTSState:
    pars: jnp.ndarray
    logtarget: jnp.ndarray
    grad: jnp.ndarray
    epsilon: jnp.ndarray
    mu: jnp.ndarray
    hbar: jnp.ndarray
    lebar: jnp.ndarray
    i: jnp.ndarray
    # Mass-warmup accumulators (massadapt.py): continuous diagonal Welford
    # (True/"diag"), Stan-style windowed diagonal ("diag-win"), or windowed
    # dense metric ("dense")
    mass: MassAccum

    @property
    def w_count(self):
        return self.mass.count

    @property
    def w_mean(self):
        return self.mass.mean

    @property
    def w_m2(self):
        return self.mass.m2


def _trailing_ones(k):
    lsb0 = (k + 1) & -(k + 1)  # lowest zero bit position as power of two
    return jax.lax.population_count(lsb0 - 1)


def _popcount(k):
    return jax.lax.population_count(k)


@dataclasses.dataclass(frozen=True, repr=False)
class NUTS(Sampler):
    maxdoublings: int = 5
    #: False | True/"diag" (continuous Welford) | "diag-win" | "dense"
    mass_adapt: object = False
    #: False = reference-parity slice NUTS (Hoffman-Gelman Alg. 6);
    #: True = multinomial state selection (Betancourt 2017, Stan's current
    #: sampler): leaves weighted by exp(-H) instead of the slice indicator,
    #: subtree merges by logsumexp-weighted reservoir, outer merge biased
    #: toward the new subtree.  Better ESS/gradient at identical cost.
    multinomial: bool = False

    needs_gradient = True

    def __post_init__(self):
        assert self.maxdoublings > 0, "max doublings should be > 0"
        assert self.maxdoublings < 20, "max doublings reasonably be < 20"
        mass_kind(self.mass_adapt)  # validate early

    @property
    def _kind(self):
        return mass_kind(self.mass_adapt)

    # ------------------------------------------------------------------
    def init(self, model, theta0, key):
        from .hmcda import find_reasonable_step

        lp, g = model.evalallg(theta0)
        scale = model.scale.astype(theta0.dtype)
        m = jax.random.normal(key, theta0.shape, dtype=theta0.dtype) * scale
        # initial step size heuristic (NUTS.jl:72-82 — the same
        # doubling/halving probe HMCDA uses, HMCDA.jl:51-69), bounded
        eps = find_reasonable_step(model, theta0, lp, g, m, key)

        return NUTSState(
            pars=theta0, logtarget=lp, grad=g,
            epsilon=eps, mu=jnp.log(10.0 * eps),
            hbar=jnp.asarray(0.0, dtype=theta0.dtype),
            lebar=jnp.asarray(0.0, dtype=theta0.dtype),
            i=jnp.asarray(1, dtype=jnp.int32),
            mass=mass_init(self._kind, theta0.shape[0], theta0.dtype,
                           scale0=model.scale),
        )

    def reset(self, model, state, theta):
        lp, g = model.evalallg(theta)
        return state.replace(pars=theta, logtarget=lp, grad=g)

    # ------------------------------------------------------------------
    #: dual-averaging statistic: "accept" (Hoffman-Gelman alpha) or
    #: "halvings" (WALNUTS: fraction of macro steps integrable un-halved)
    _adapt_stat = "accept"

    def _leaf_advance(self, model, pars, lp, m, grad, eps_signed, key):
        """Advance the orbit by one macro-grid state from (pars, lp, grad).
        Returns (pars, lp, grad, m, bad, halved): ``bad`` marks a leaf whose
        construction failed for reasons beyond the energy gate (always False
        for plain NUTS; WALNUTS uses it for irreversible adaptive steps,
        which are handled exactly like divergences); ``halved`` feeds the
        "halvings" adaptation statistic."""
        pars, lp, g, m = leapfrog(model, pars, m, grad, eps_signed)
        return pars, lp, g, m, jnp.asarray(False), jnp.asarray(False)

    def _build_subtree(self, model, z_edge, eps_signed, dirn, n_leaves, u_slice,
                       H0, key):
        """Iteratively build a subtree of ``n_leaves`` leapfrog leaves from
        the edge state; returns (z_end, prop, n_valid, ok, alpha, nalpha,
        diverged, logweight).

        Slice mode: proposal = uniform reservoir over slice-valid leaves.
        Multinomial mode: proposal = exp(H0 - H)-weighted reservoir over all
        non-diverged leaves (progressive sampling is distributionally
        identical to the recursive pairwise multinomial merge)."""
        pars, m, lp, grad = z_edge
        d = pars.shape[0]
        dtype = pars.dtype
        md = self.maxdoublings

        ckpt_pars = jnp.zeros((md, d), dtype=dtype)
        ckpt_m = jnp.zeros((md, d), dtype=dtype)

        def cond(c):
            return (c["k"] < n_leaves) & c["ok"]

        def body(c):
            key, k_sel, k_leaf = jax.random.split(c["key"], 3)
            pars, lp, grad, m, bad, halved = self._leaf_advance(
                model, c["pars"], c["lp"], c["m"], c["grad"], eps_signed,
                k_leaf
            )
            H = hamiltonian(lp, m)
            diverged = (u_slice >= DELTAMAX - H) | jnp.isnan(H) | bad  # NUTS.jl:92
            leaf_ok = ~diverged
            if self._adapt_stat == "halvings":
                # WALNUTS: micro adaptation keeps exp(H0-H) near 1 at any
                # macro step, so the H-G alpha cannot regulate eps; target
                # the fraction of macro steps integrable without halving
                alpha_leaf = jnp.where(bad | halved, 0.0, 1.0)
            else:
                alpha_leaf = jnp.minimum(1.0, jnp.exp(H0 - H))
                alpha_leaf = jnp.where(jnp.isnan(alpha_leaf), 0.0, alpha_leaf)

            if self.multinomial:
                # Boltzmann-weighted reservoir (Betancourt 2017 A.3.1)
                leaf_valid = leaf_ok
                lw_leaf = jnp.where(diverged, -jnp.inf, H0 - H)
                lw_new = jnp.logaddexp(c["lw"], lw_leaf)
                take = leaf_ok & (
                    jnp.log(jax.random.uniform(k_sel, (), dtype=dtype))
                    < lw_leaf - lw_new
                )
            else:
                leaf_valid = u_slice <= -H  # NUTS.jl:91
                lw_new = c["lw"]
                # reservoir: uniform among valid leaves == recursive n2/(n1+n2)
                take = leaf_valid & (
                    jax.random.uniform(k_sel, (), dtype=dtype)
                    * (c["n"] + leaf_valid.astype(jnp.int32)).astype(dtype) < 1.0
                )
            n_new = c["n"] + leaf_valid.astype(jnp.int32)
            prop_pars = jnp.where(take, pars, c["prop_pars"])
            prop_lp = jnp.where(take, lp, c["prop_lp"])
            prop_grad = jnp.where(take, grad, c["prop_grad"])

            k = c["k"]
            is_even = (k % 2) == 0
            slot_store = _popcount(k)
            ckpt_pars = jnp.where(
                is_even & (slot_store < md),
                c["ckpt_pars"].at[jnp.minimum(slot_store, md - 1)].set(pars),
                c["ckpt_pars"],
            )
            ckpt_m = jnp.where(
                is_even & (slot_store < md),
                c["ckpt_m"].at[jnp.minimum(slot_store, md - 1)].set(m),
                c["ckpt_m"],
            )

            # u-turn checks for every span ending at odd leaf k (NUTS.jl:50)
            idx_max = _popcount(k >> 1)
            idx_min = idx_max - _trailing_ones(k) + 1
            slots = jnp.arange(md)
            active = (~is_even) & (slots >= idx_min) & (slots <= idx_max)
            delta = dirn * (pars[None, :] - ckpt_pars)  # (md, d)
            turn = (jnp.sum(delta * ckpt_m, axis=1) < 0) | (
                jnp.sum(delta * m[None, :], axis=1) < 0
            )
            turned = jnp.any(active & turn)

            ok = c["ok"] & leaf_ok & ~turned
            return {
                "k": k + 1, "pars": pars, "lp": lp, "grad": grad, "m": m,
                "prop_pars": prop_pars, "prop_lp": prop_lp, "prop_grad": prop_grad,
                "n": n_new, "lw": lw_new, "ok": ok, "div": c["div"] | diverged,
                "irr": c["irr"] | bad,
                "alpha": c["alpha"] + alpha_leaf, "nalpha": c["nalpha"] + 1,
                "ckpt_pars": ckpt_pars, "ckpt_m": ckpt_m, "key": key,
            }

        init = {
            "k": jnp.asarray(0, jnp.int32), "pars": pars, "lp": lp, "grad": grad,
            "m": m,
            "prop_pars": pars, "prop_lp": lp, "prop_grad": grad,
            "n": jnp.asarray(0, jnp.int32), "lw": jnp.asarray(-jnp.inf, dtype),
            "ok": jnp.asarray(True),
            "div": jnp.asarray(False), "irr": jnp.asarray(False),
            "alpha": jnp.asarray(0.0, dtype), "nalpha": jnp.asarray(0, jnp.int32),
            "ckpt_pars": ckpt_pars, "ckpt_m": ckpt_m, "key": key,
        }
        out = jax.lax.while_loop(cond, body, init)
        z_end = (out["pars"], out["m"], out["lp"], out["grad"])
        prop = (out["prop_pars"], out["prop_lp"], out["prop_grad"])
        return (z_end, prop, out["n"], out["ok"], out["alpha"], out["nalpha"],
                out["div"], out["lw"], out["irr"])

    # ------------------------------------------------------------------
    def step(self, model, ctx: RunCtx, state, key):
        dtype = state.pars.dtype
        d = state.pars.shape[0]
        k_mom, k_slice, k_tree = jax.random.split(key, 3)

        kind = self._kind
        if kind is not None:
            # Preconditioned NUTS in standardized coordinates theta = S z:
            # run a *unit-metric* tree on lp_z(z) = lp(S z) (grad_z = S'
            # grad_theta), which is exactly NUTS with mass M = (S S')^{-1}.
            # (The reference's momentum-scaling shortcut, NUTS.jl:138 +
            # H = 0.5|m|^2, is only a valid Hamiltonian pair for unit scale,
            # so the adapted metric uses this reparam.)  S is a vector for
            # the diagonal kinds, the windowed-covariance Cholesky factor
            # (seeded with diag(model.scale)) for "dense".
            import types

            if kind == "dense":
                L = state.mass.scale.astype(dtype)
                fwd, inv, gfwd, ginv = dense_transforms(L)
            else:
                s_vec = model.scale.astype(dtype) * mass_vector_scale(
                    kind, state.mass, dtype
                )
                fwd = lambda z: z * s_vec
                inv = lambda t: t / s_vec
                gfwd = lambda g: g * s_vec
                ginv = lambda g: g / s_vec

            def evalallg_z(z):
                lp, g = model.evalallg(fwd(z))
                return lp, gfwd(g)

            tree_model = types.SimpleNamespace(evalallg=evalallg_z)
            pars_t = inv(state.pars)
            grad_t = gfwd(state.grad)
            scale = jnp.ones((d,), dtype=dtype)
        else:
            tree_model = model
            pars_t = state.pars
            grad_t = state.grad
            scale = model.scale.astype(dtype)

        m0 = jax.random.normal(k_mom, (d,), dtype=dtype) * scale
        H0 = hamiltonian(state.logtarget, m0)
        if self.multinomial:
            # no slice variable; u_slice = -H0 makes the shared divergence
            # gate read H - H0 >= DELTAMAX (Stan's criterion)
            u_slice = -H0
        else:
            # log-space slice variable (NUTS.jl:141)
            u_slice = jnp.log(jax.random.uniform(k_slice, (), dtype=dtype)) - H0

        eps = state.epsilon
        z0 = (pars_t, m0, state.logtarget, grad_t)

        def cond(c):
            return c["s"] & (c["j"] < self.maxdoublings)

        def body(c):
            key, k_dir, k_acc, k_sub = jax.random.split(c["key"], 4)
            dirn = jnp.where(jax.random.bernoulli(k_dir), 1.0, -1.0).astype(dtype)
            go_fwd = dirn > 0

            edge = jax.tree_util.tree_map(
                lambda p, mn: jnp.where(go_fwd, p, mn), c["z_plus"], c["z_minus"]
            )
            n_leaves = jnp.asarray(1, jnp.int32) << c["j"]
            (z_end, prop1, n1, s1, alpha, nalpha, div, lw1,
             irr) = self._build_subtree(
                tree_model, edge, dirn * eps, dirn, n_leaves, u_slice, H0, k_sub
            )
            z_plus = jax.tree_util.tree_map(
                lambda a, b: jnp.where(go_fwd, b, a), c["z_plus"], z_end
            )
            z_minus = jax.tree_util.tree_map(
                lambda a, b: jnp.where(go_fwd, a, b), c["z_minus"], z_end
            )

            if self.multinomial:
                # biased progressive merge: prob min(1, W_new/W_old)
                # (Betancourt 2017 A.3.2 — favors the fresh subtree)
                u = jax.random.uniform(k_acc, (), dtype=dtype)
                take = s1 & (jnp.log(u) < lw1 - c["lw"])
                lw_tot = jnp.where(s1, jnp.logaddexp(c["lw"], lw1), c["lw"])
            else:
                # accept subtree proposal with prob n1/n (NUTS.jl:160)
                u = jax.random.uniform(k_acc, (), dtype=dtype)
                take = s1 & (u * c["n"].astype(dtype) < n1.astype(dtype))
                lw_tot = c["lw"]
            prop = jax.tree_util.tree_map(
                lambda a, b: jnp.where(take, b, a), c["prop"], prop1
            )

            # overall u-turn between extreme states (NUTS.jl:165)
            dpars = z_plus[0] - z_minus[0]
            turned = (jnp.dot(dpars, z_minus[1]) < 0) | (jnp.dot(dpars, z_plus[1]) < 0)
            s = s1 & ~turned

            return {
                "j": c["j"] + 1, "n": c["n"] + n1, "lw": lw_tot, "s": s,
                "z_minus": z_minus, "z_plus": z_plus, "prop": prop,
                "alpha": alpha, "nalpha": nalpha, "key": key,
                "div": c["div"] | div, "irr": c["irr"] | irr,
            }

        init = {
            "j": jnp.asarray(0, jnp.int32), "n": jnp.asarray(1, jnp.int32),
            "lw": jnp.asarray(0.0, dtype),  # initial point weight exp(H0-H0)
            "s": jnp.asarray(True),
            "z_minus": z0, "z_plus": z0,
            "prop": (pars_t, state.logtarget, grad_t),
            "alpha": jnp.asarray(1.0, dtype), "nalpha": jnp.asarray(1, jnp.int32),
            "key": k_tree, "div": jnp.asarray(False),
            "irr": jnp.asarray(False),
        }
        out = jax.lax.while_loop(cond, body, init)
        new_pars, new_lp, new_grad = out["prop"]
        if kind is not None:  # back to theta-space
            new_pars = fwd(new_pars)
            new_grad = ginv(new_grad)

        # --- dual averaging (NUTS.jl:162-169) ----------------------------
        i = state.i.astype(dtype)
        in_adapt = state.i <= NADAPT
        avg_alpha = out["alpha"] / jnp.maximum(out["nalpha"], 1).astype(dtype)
        hbar = state.hbar * (1.0 - 1.0 / (i + T0)) + (DELTA - avg_alpha) / (i + T0)
        le = state.mu - jnp.sqrt(i) / GAM * hbar
        lebar = i ** (-KAPPA) * le + (1.0 - i ** (-KAPPA)) * state.lebar
        new_eps = jnp.where(in_adapt, jnp.exp(le), jnp.exp(state.lebar))
        new_hbar = jnp.where(in_adapt, hbar, state.hbar)
        new_lebar = jnp.where(in_adapt, lebar, state.lebar)

        mass = mass_update(kind, state.mass, new_pars, state.i, ctx.burnin)

        info = {
            "ppars": new_pars,
            "plogtarget": new_lp,
            "pgrads": new_grad,
            "pars": state.pars,
            "logtarget": state.logtarget,
            "grads": state.grad,
            "accept": jnp.any(new_pars != state.pars),
            "epsilon": new_eps,
            "ndoublings": out["j"],
            "diverging": out["div"],
        }
        if self._adapt_stat == "halvings":
            # WALNUTS only: how often a subtree died to an irreversible
            # adaptive step (vs a true energy divergence)
            info["irreversible"] = out["irr"]
        return (
            NUTSState(
                pars=new_pars, logtarget=new_lp, grad=new_grad,
                epsilon=new_eps, mu=state.mu, hbar=new_hbar, lebar=new_lebar,
                i=state.i + 1, mass=mass,
            ),
            info,
        )
