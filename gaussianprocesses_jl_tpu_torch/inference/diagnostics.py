"""Sampler diagnostics: multi-chain effective sample size and
rank-normalized split-R-hat (counterpart of
`gaussianprocesses_jl_tpu/inference/diagnostics.py`; Vehtari, Gelman,
Simpson, Carpenter, Buerkner 2021, the estimators Stan reports).

  * `effective_sample_size` combines within-chain autocorrelation with
    between-chain variance: rho_t = 1 - (W - s_t) / var_plus, s_t the
    chain-averaged lag-t autocovariance, W the mean within-chain variance,
    var_plus the pooled variance. Chains stuck in different modes get
    rho_t ~= 1 at every lag and an ESS of O(1), not O(C n).
  * `split_rhat` is rank-normalized and folded: the larger of the bulk
    R-hat on rank-normal scores and the tail R-hat on folded |x - median|
    scores.

The formulas are the JAX package's, to the letter, including its rho at lag
0, which takes the formula above where Stan pins rho_0 = 1 (a slightly
optimistic ESS, an O(1/n) bias): the port matches the package first. The
FFT autocovariance runs through `torch.fft` on the samples' device, in
sequential chunks of dimensions that bound its workspace. Results are
tensors on the samples' device (the CPU for numpy input).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["effective_sample_size", "split_rhat", "rank_normalize"]


def _as_tensor(samples):
    t = torch.as_tensor(samples)
    return t if t.is_floating_point() else t.to(torch.get_default_dtype())


def _autocov(x):
    """Biased (divide-by-n) autocovariance along dim 1 of (m, n, D) via
    FFT: the estimator the rho_t formula expects."""
    n = x.shape[1]
    x = x - torch.mean(x, dim=1, keepdim=True)
    f = torch.fft.rfft(x, 2 * n, dim=1)
    return torch.fft.irfft(f * torch.conj(f), 2 * n, dim=1)[:, :n] / n


def _split_chains(samples):
    """(C, n, D) -> (2C, n//2, D): every chain split in half. Drops the last
    draw when n is odd."""
    half = samples.shape[1] // 2
    return torch.cat([samples[:, :half], samples[:, half:2 * half]], dim=0)


def rank_normalize(samples):
    """Pooled-rank normal scores (Vehtari et al. 2021, eq. 14) of (C, n, D)
    samples: ordinal ranks over the pooled C n draws of each dimension,
    mapped through the normal quantile with the Blom offset,
    z = ndtri((r - 3/8) / (S + 1/4)). A numpy input takes a host path
    (np.argsort and put_along_axis, scipy's ndtri) and returns a numpy
    array, in the input's dtype as the JAX package does; a tensor ranks by
    a double argsort on its device."""
    C, n, D = samples.shape
    if isinstance(samples, np.ndarray):
        from scipy.special import ndtri

        flat = samples.reshape(C * n, D)
        order = np.argsort(flat, axis=0, kind="stable")
        ranks = np.empty((C * n, D), np.int64)
        np.put_along_axis(ranks, order, np.arange(C * n, dtype=np.int64)[:, None], axis=0)
        z = ndtri((ranks + (1.0 - 0.375)) / (C * n + 0.25))
        return z.reshape(C, n, D).astype(samples.dtype)
    flat = samples.reshape(C * n, D)
    # argsort of the permutation is its inverse: the ranks, no scatter;
    # stable, so ties rank in order as jax.numpy's argsort ranks them
    ranks = torch.argsort(torch.argsort(flat, dim=0, stable=True), dim=0, stable=True)
    z = torch.special.ndtri((ranks.to(flat.dtype) + (1.0 - 0.375)) / (C * n + 0.25))
    return z.reshape(C, n, D)


def _ess_core(s):
    """Vehtari/Stan multi-chain ESS of already-split chains s (m, n, D) ->
    (D,)."""
    m, n, D = s.shape
    chain_var = torch.var(s, dim=1, correction=1)  # (m, D)
    W = torch.mean(chain_var, dim=0)
    chain_mean = torch.mean(s, dim=1)
    B_over_n = torch.var(chain_mean, dim=0, correction=1)
    var_plus = (n - 1) / n * W + B_over_n

    s_t = torch.mean(_autocov(s), dim=0)  # (n, D) chain-averaged autocovariance

    ok = var_plus > 0.0
    vp = torch.where(ok, var_plus, torch.ones_like(var_plus))
    # rho at every lag, lag 0 included, as the JAX package computes it
    rho = 1.0 - (W[None, :] - s_t) / vp[None, :]
    # a degenerate ensemble (every chain constant at one value) carries no
    # information: perfectly correlated
    rho = torch.where(ok[None, :], rho, torch.ones_like(rho))

    # Geyer's initial positive sequence, then its initial monotone sequence
    n_pairs = n // 2
    pair = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]  # (n_pairs, D)
    keep = torch.cumprod((pair > 0.0).to(s.dtype), dim=0)
    pair_mono = torch.cummin(torch.where(keep > 0, pair, torch.full_like(pair, math.inf)),
                             dim=0).values
    pair_mono = torch.where(torch.isfinite(pair_mono), pair_mono, torch.zeros_like(pair_mono))
    tau = -1.0 + 2.0 * torch.sum(pair_mono * keep, dim=0)
    tau = torch.clamp(tau, min=1.0 / n)
    ess = m * n / tau
    # antithetic chains can exceed m n; capped as Stan does
    total = float(m * n)
    return torch.clamp(ess, max=total * math.log10(max(total, 10.0)))


def effective_sample_size(samples, max_workspace_elems: int = 1 << 25,
                          rank_normalized: bool = False):
    """Multi-chain ESS per dimension (Vehtari et al. 2021 / Stan) of
    samples (n_draws, D), one chain, or (C, n_draws, D). Chains are split in
    half; rho_t = 1 - (W - s_t) / var_plus; the sum follows Geyer's initial
    monotone positive rule. Returns (D,).

    rank_normalized=True gives Stan's bulk-ESS: the same estimator on
    pooled-rank normal scores. The FFT's (2C, 2n, D) complex workspace is
    bounded by processing the dimensions in sequential chunks of at most
    `max_workspace_elems` complex entries."""
    if samples.ndim == 2:
        samples = samples[None]
    if rank_normalized:
        samples = rank_normalize(samples)  # the host path for numpy input
    s = _split_chains(_as_tensor(samples))
    m, n, D = s.shape
    chunk = max(1, min(D, int(max_workspace_elems) // max(1, m * 2 * n)))
    if chunk >= D:
        return _ess_core(s)
    return torch.cat([_ess_core(s[..., i:i + chunk]) for i in range(0, D, chunk)])


def _split_rhat_raw(samples):
    """Classic split-R-hat on the given scale: (C, n, D) -> (D,)."""
    s = _split_chains(_as_tensor(samples))
    half = s.shape[1]
    chain_mean = torch.mean(s, dim=1)
    W = torch.mean(torch.var(s, dim=1, correction=1), dim=0)
    B = half * torch.var(chain_mean, dim=0, correction=1)
    var_plus = (half - 1) / half * W + B / half
    return torch.sqrt(var_plus / torch.clamp(W, min=1e-30))


def _median_pooled(x):
    """The median of each dimension over the pooled chains and draws of
    (C, n, D), the mean of the two middle values for an even count (as numpy
    and jax.numpy take it), shaped (1, 1, D)."""
    flat = x.reshape(-1, x.shape[-1])
    srt = torch.sort(flat, dim=0).values
    k = flat.shape[0]
    med = srt[k // 2] if k % 2 else 0.5 * (srt[k // 2 - 1] + srt[k // 2])
    return med[None, None, :]


def split_rhat(samples):
    """Rank-normalized folded split-R-hat (Vehtari et al. 2021): the larger
    of the bulk R-hat (split-R-hat on pooled-rank normal scores) and the
    tail R-hat (the same on rank-normalized |x - median(x)|), the form every
    published metric is gated on (R-hat < 1.01). samples (n, D) or
    (C, n, D) -> (D,). A numpy input ranks on the host path."""
    if samples.ndim == 2:
        samples = samples[None]
    bulk = _split_rhat_raw(rank_normalize(samples))
    if isinstance(samples, np.ndarray):
        folded = np.abs(samples - np.median(samples, axis=(0, 1), keepdims=True))
    else:
        folded = torch.abs(samples - _median_pooled(samples))
    tail = _split_rhat_raw(rank_normalize(folded))
    return torch.maximum(bulk, tail)
