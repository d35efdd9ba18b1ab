"""The benchmark's own copy of the multi-chain effective sample size and
the rank-normalized split-R-hat (Vehtari, Gelman, Simpson, Carpenter,
Buerkner 2021, as Stan reports them), frozen so that the yardstick does
not move with the program.

The ESS combines within-chain autocorrelation with between-chain variance:
rho_t = 1 - (W - s_t) / var_plus, with s_t the chain-averaged lag-t
autocovariance (FFT), W the mean within-chain variance and var_plus the
pooled variance, over chains split in half; the sum follows Geyer's
initial monotone positive sequence. rho at lag 0 takes the formula too
(where Stan pins it to 1), capped at m n log10(m n). The dimensions are
processed in chunks that bound the FFT's workspace.
"""
from __future__ import annotations

import math

import torch

__all__ = ["effective_sample_size", "split_rhat"]


def _split_chains(s):
    half = s.shape[1] // 2
    return torch.cat([s[:, :half], s[:, half:2 * half]], dim=0)


def _autocov(x):
    n = x.shape[1]
    x = x - torch.mean(x, dim=1, keepdim=True)
    f = torch.fft.rfft(x, 2 * n, dim=1)
    return torch.fft.irfft(f * torch.conj(f), 2 * n, dim=1)[:, :n] / n


def _ess_core(s):
    m, n, D = s.shape
    W = torch.mean(torch.var(s, dim=1, correction=1), dim=0)
    B_over_n = torch.var(torch.mean(s, dim=1), dim=0, correction=1)
    var_plus = (n - 1) / n * W + B_over_n
    s_t = torch.mean(_autocov(s), dim=0)
    ok = var_plus > 0.0
    rho = 1.0 - (W[None, :] - s_t) / torch.where(ok, var_plus, torch.ones_like(var_plus))
    rho = torch.where(ok[None, :], rho, torch.ones_like(rho))
    n_pairs = n // 2
    pair = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]
    keep = torch.cumprod((pair > 0.0).to(s.dtype), dim=0)
    mono = torch.cummin(torch.where(keep > 0, pair, torch.full_like(pair, math.inf)),
                        dim=0).values
    mono = torch.where(torch.isfinite(mono), mono, torch.zeros_like(mono))
    tau = torch.clamp(-1.0 + 2.0 * torch.sum(mono * keep, dim=0), min=1.0 / n)
    total = float(m * n)
    return torch.clamp(m * n / tau, max=total * math.log10(max(total, 10.0)))


def effective_sample_size(samples: torch.Tensor, max_workspace_elems: int = 1 << 25):
    """ESS (D,) of samples (C, n_draws, D)."""
    s = _split_chains(samples)
    m, n, D = s.shape
    chunk = max(1, min(D, max_workspace_elems // max(1, m * 2 * n)))
    return torch.cat([_ess_core(s[..., i:i + chunk]) for i in range(0, D, chunk)])


def _rank_normalize(x):
    C, n, D = x.shape
    flat = x.reshape(C * n, D)
    ranks = torch.argsort(torch.argsort(flat, dim=0, stable=True), dim=0, stable=True)
    return torch.special.ndtri((ranks.to(flat.dtype) + 0.625) / (C * n + 0.25)).reshape(C, n, D)


def _rhat_raw(x):
    s = _split_chains(x)
    half = s.shape[1]
    W = torch.mean(torch.var(s, dim=1, correction=1), dim=0)
    B = half * torch.var(torch.mean(s, dim=1), dim=0, correction=1)
    return torch.sqrt(((half - 1) / half * W + B / half) / torch.clamp(W, min=1e-30))


def split_rhat(samples: torch.Tensor):
    """The larger of the bulk and the tail (folded) rank-normalized split
    R-hat, (D,) of samples (C, n_draws, D)."""
    srt = torch.sort(samples.reshape(-1, samples.shape[-1]), dim=0).values
    k = srt.shape[0]
    med = srt[k // 2] if k % 2 else 0.5 * (srt[k // 2 - 1] + srt[k // 2])
    bulk = _rhat_raw(_rank_normalize(samples))
    tail = _rhat_raw(_rank_normalize(torch.abs(samples - med[None, None, :])))
    return torch.maximum(bulk, tail)
