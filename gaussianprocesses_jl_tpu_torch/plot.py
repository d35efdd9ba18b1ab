"""Plotting helpers (counterpart of `gaussianprocesses_jl_tpu/plot.py`;
ref src/plot.jl): the 1-D posterior mean with a credible ribbon and the
observations, and a 2-D heat grid of the mean or variance. matplotlib (and
scipy, for the ribbon's quantile) is imported when a plot is drawn, so the
package needs neither."""
from __future__ import annotations

import numpy as np

__all__ = ["plot_gp", "plot_gp_2d"]


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def plot_gp(gp, xlims=None, n_points: int = 200, beta: float = 0.95, obsv: bool = True,
            ax=None, **kwargs):
    """1-D posterior plot: the mean line, the central `beta` credible ribbon
    and the observations (ref plot.jl, dim == 1)."""
    import matplotlib.pyplot as plt
    from scipy.stats import norm

    if gp.dim != 1:
        raise ValueError("plot_gp draws 1-D GPs; use plot_gp_2d")
    x = _np(gp.x)[:, 0]
    if xlims is None:
        span = x.max() - x.min()
        xlims = (x.min() - 0.05 * span, x.max() + 0.05 * span)
    xs = np.linspace(xlims[0], xlims[1], n_points)
    mu, var = gp.predict_y(xs)
    mu, sd = _np(mu), np.sqrt(_np(var))
    z = norm.ppf((1 + beta) / 2)
    ax = ax if ax is not None else plt.gca()
    ax.plot(xs, mu, **kwargs)
    ax.fill_between(xs, mu - z * sd, mu + z * sd, alpha=0.3)
    if obsv:
        ax.scatter(x, _np(gp.y), s=12, zorder=3)
    return ax


def plot_gp_2d(gp, n_grid: int = 50, var: bool = False, ax=None, **kwargs):
    """2-D heat grid of the posterior mean (or variance) over the data's
    box (ref plot.jl, dim == 2, a 50 x 50 grid)."""
    import matplotlib.pyplot as plt

    if gp.dim != 2:
        raise ValueError("plot_gp_2d draws 2-D GPs")
    X = _np(gp.x)
    g1 = np.linspace(X[:, 0].min(), X[:, 0].max(), n_grid)
    g2 = np.linspace(X[:, 1].min(), X[:, 1].max(), n_grid)
    G1, G2 = np.meshgrid(g1, g2)
    mu, v = gp.predict_y(np.stack([G1.ravel(), G2.ravel()], axis=1))
    Z = _np(v if var else mu).reshape(n_grid, n_grid)
    ax = ax if ax is not None else plt.gca()
    im = ax.pcolormesh(G1, G2, Z, shading="auto", **kwargs)
    return ax, im
