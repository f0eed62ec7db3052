"""Cross-chain diagnostics.

The reference is single-chain-only (its prun chains never interact and its
stats take one MCMCChain).  With thousands of vmapped chains, cross-chain
diagnostics are both natural and cheap on device:

- :func:`rhat` — split-chain potential scale reduction (Gelman-Rubin);
  ``method="rank"`` gives the rank-normalized bulk/tail R-hat of Vehtari,
  Gelman, Simpson, Carpenter & Bürkner (2021) — robust to heavy tails and
  nonstationary variance where classic split-R-hat is blind
- :func:`ess_pooled` — rank-free pooled ESS: per-chain Geyer ESS summed
- :func:`summarize_chains` — one host-side report for a (steps, chains, d)
  sample block from :func:`mcmc_jl.parallel.run_chains`
"""
from __future__ import annotations

import numpy as np
from scipy.stats import norm as _norm  # host-side only

from .var import mcvar_iid, mcvar_imse


def _as_block(x):
    """Accept (steps, chains, d) arrays or run_chains infos dicts."""
    if isinstance(x, dict):
        x = x["ppars"]
    x = np.asarray(x, dtype=np.float64)
    assert x.ndim == 3, f"expected (steps, chains, d), got {x.shape}"
    return x


def _split_rhat(x):
    n, m, d = x.shape
    if n >= 2:
        half = n // 2
        x = np.concatenate([x[:half], x[half : 2 * half]], axis=1)
        n, m, d = x.shape
    chain_means = x.mean(axis=0)  # (m, d)
    W = x.var(axis=0, ddof=1).mean(axis=0)  # (d,)
    B = n * chain_means.var(axis=0, ddof=1)  # (d,)
    var_plus = (n - 1) / n * W + B / n
    return np.sqrt(var_plus / W)


def _rank_normalize(x):
    """Fractional ranks over ALL draws -> normal scores (Vehtari 2021 eq. 14:
    z = Phi^-1((r - 3/8) / (S + 1/4)))."""
    n, m, d = x.shape
    flat = x.reshape(n * m, d)
    r = np.argsort(np.argsort(flat, axis=0), axis=0) + 1.0
    z = _norm.ppf((r - 0.375) / (n * m + 0.25))
    return z.reshape(n, m, d)


def rhat(x, split: bool = True, method: str = "split"):
    """R-hat per parameter for a (steps, chains, d) block.

    ``method="split"`` — classic split-chain Gelman-Rubin.
    ``method="rank"`` — max(bulk, tail) rank-normalized split-R-hat
    (Vehtari et al. 2021): bulk = split-R-hat of the rank-normal scores;
    tail = the same on the folded draws ``|x - median|`` (catches chains
    agreeing in location but not in the tails)."""
    x = _as_block(x)
    if not split:
        # unsplit classic variant (kept for the original API)
        assert method == "split", "method='rank' implies split chains"
        n, m, d = x.shape
        chain_means = x.mean(axis=0)
        W = x.var(axis=0, ddof=1).mean(axis=0)
        B = n * chain_means.var(axis=0, ddof=1)
        return np.sqrt(((n - 1) / n * W + B / n) / W)
    if method == "split":
        return _split_rhat(x)
    assert method == "rank", f"unknown method {method!r}"
    bulk = _split_rhat(_rank_normalize(x))
    folded = np.abs(x - np.median(x.reshape(-1, x.shape[2]), axis=0))
    tail = _split_rhat(_rank_normalize(folded))
    return np.maximum(bulk, tail)


def ess_pooled(x):
    """Sum of per-chain Geyer-IMSE ESS, per parameter."""
    x = _as_block(x)
    n, m, d = x.shape
    out = np.zeros(d)
    for c in range(m):
        out += n * mcvar_iid(x[:, c]) / mcvar_imse(x[:, c])
    return out


def summarize_chains(x, param_names=None):
    """Host-side cross-chain report: mean, sd, MCSE, pooled ESS, R-hat."""
    x = _as_block(x)
    n, m, d = x.shape
    names = param_names or [f"pars.{i + 1}" for i in range(d)]
    flat = x.reshape(n * m, d)
    ess = ess_pooled(x)
    rep = {}
    for i, name in enumerate(names):
        rep[name] = {
            "mean": float(flat[:, i].mean()),
            "sd": float(flat[:, i].std(ddof=1)),
            "mcse": float(flat[:, i].std(ddof=1) / np.sqrt(max(ess[i], 1.0))),
            "ess": float(ess[i]),
            "rhat": float(rhat(x)[i]),
            "rhat_rank": float(rhat(x, method="rank")[i]),
        }
    return rep
