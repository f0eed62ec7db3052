"""FFT autocovariance (device-side).

The reference computes per-lag autocovariance with ``StatsBase.acf``
(reference: src/stats/var.jl:53, 103) — an O(n*maxlag) host loop.  Here the
full autocovariance sequence is computed with a zero-padded real FFT in
O(n log n) on device, batched over parameter columns (SURVEY §2.5).
Convention matches StatsBase ``acf(x, lags, correlation=false)``: demeaned,
biased (divisor n).
"""
from __future__ import annotations

import jax.numpy as jnp


def autocov(x, maxlag=None):
    """Autocovariance of columns of ``x`` (n, p) for lags 0..maxlag.

    Returns an array (maxlag+1, p).  1-D input is treated as one column and
    returns (maxlag+1,).
    """
    x = jnp.asarray(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    n = x.shape[0]
    if maxlag is None:
        maxlag = n - 1
    xc = x - jnp.mean(x, axis=0, keepdims=True)
    nfft = 1
    while nfft < 2 * n:
        nfft *= 2
    f = jnp.fft.rfft(xc, n=nfft, axis=0)
    acov_full = jnp.fft.irfft(f * jnp.conj(f), n=nfft, axis=0)[: maxlag + 1]
    acov = acov_full / n  # biased, matching StatsBase correlation=false
    return acov[:, 0] if squeeze else acov
