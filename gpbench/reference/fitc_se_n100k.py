"""The plain reference of configuration fitc_se_n100k, and its control: the
same reference in the program's place, in TF32.

FITC's negative log marginal likelihood by its published equations
(Quinonero-Candela and Rasmussen 2005, eq. 24; GaussianProcesses.jl's
`src/sparse/fully_indep_train_conditional.jl`):

    Sigma  = Qff + Lambda,  Qff = Kfu Kuu^-1 Kuf,
    Lambda = sigma^2 I + diag(Kff - Qff),

through the Woodbury identity and the determinant lemma, with
A = Kuu + Kuf Lambda^-1 Kfu:

    y^T Sigma^-1 y = y^T Lambda^-1 y - b^T A^-1 b,  b = Kuf Lambda^-1 y,
    log |Sigma|    = log |A| - log |Kuu| + log |Lambda|,

A and Kuu each by a Cholesky factor. The program takes another route (the
reduced QR of [Lambda^-1/2 Kfu; Luu^T]), so the two share no algebra past
the grams. The gram is this module's own (`gp.se_iso_gram`), the gradient
autograd's, the arithmetic float64.

Departures from the Julia file, shared with the program (the
configuration's `constants`): Kuu takes a jitter of kuu_jitter_rel times
max(1, its largest diagonal entry) before its factor, and Lambda's residual
diag(Kff - Qff) is clamped at 0 before the noise is added, the sum at
lambda_floor. The inducing rows are the configuration's
(`configs/fitc_se_n100k.py::inducing_rows`). Every (m, n) matrix is made
whole: at n = 100 000, m = 512 one is 0.4 GB in float64, and the card holds
the few that autograd keeps.
"""
from __future__ import annotations

import math

import torch

from gpbench.configs.fitc_se_n100k import inducing_rows

from . import lbfgs
from .gp import se_iso_gram, value_and_grad
from .precision import dtype_of, mm

__all__ = ["fitc_nll", "objective", "Control"]

_LOG_2PI = math.log(2.0 * math.pi)


def fitc_nll(theta, X, Xu, y, consts: dict, mode: str):
    """-log N(y; 0, Qff + Lambda) at theta = [log noise std, log l, log
    sigma]; +inf where Kuu + jitter or A does not factor."""
    lognoise, ll, lsigma = theta[0], theta[1], theta[2]
    n, m = X.shape[0], Xu.shape[0]
    eye = torch.eye(m, dtype=X.dtype, device=X.device)
    Kuu = se_iso_gram(Xu, Xu, ll, lsigma, mode)
    Kuu = Kuu + consts["kuu_jitter_rel"] * torch.clamp_min(Kuu.diagonal().max(), 1.0) * eye
    Luu, info_uu = torch.linalg.cholesky_ex(Kuu)
    Kuf = se_iso_gram(Xu, X, ll, lsigma, mode)
    V = torch.linalg.solve_triangular(Luu, Kuf, upper=False)  # Luu^-1 Kuf
    qdiag = torch.sum(V * V, dim=0)
    kdiag = torch.exp(2.0 * lsigma)
    lam = torch.exp(2.0 * lognoise) + torch.clamp_min(kdiag - qdiag, 0.0)
    lam = torch.clamp_min(lam, consts["lambda_floor"])
    Kl = Kuf / lam  # Kuf Lambda^-1
    A = Kuu + mm(Kl, Kuf.T, mode)
    LA, info_a = torch.linalg.cholesky_ex(A)
    b = mm(Kl, y[:, None], mode)
    c = torch.linalg.solve_triangular(LA, b, upper=False)[:, 0]
    quad = torch.sum(y * y / lam) - torch.sum(c * c)
    logdet = (2.0 * torch.sum(torch.log(torch.diagonal(LA)))
              - 2.0 * torch.sum(torch.log(torch.diagonal(Luu))) + torch.sum(torch.log(lam)))
    nll = 0.5 * (quad + logdet + n * _LOG_2PI)
    ok = (info_uu == 0) & (info_a == 0) & torch.isfinite(nll)
    return torch.where(ok, nll, torch.full_like(nll, math.inf))


def objective(cfg: dict, X, y, mode: str):
    """theta -> (FITC's negative log marginal likelihood, its gradient)."""
    dt = dtype_of(mode)
    rows = torch.from_numpy(inducing_rows(cfg, X.shape[0])).to(X.device)
    X, y = X.to(dt), y.to(dt)
    Xu, consts = X[rows], cfg["constants"]
    return lambda theta: value_and_grad(lambda t: fitc_nll(t, X, Xu, y, consts, mode),
                                        theta.to(dt))


class Control:
    """The reference in the program's place, computed in TF32."""

    mode = "tf32"

    def __init__(self, cfg: dict, X, y):
        self.cfg, self.X, self.y = cfg, X, y
        self.vg = objective(cfg, X, y, self.mode)

    def fit(self, x0, maxiter: int, iterates: list | None = None):
        x, n_iter, evaluations = lbfgs.minimize(self.vg, x0.to(torch.float32), maxiter,
                                                trace=iterates)
        return x.double().cpu(), n_iter, evaluations
