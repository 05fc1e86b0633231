"""Batched logistic regression in PyTorch, coefficient-compatible with sklearn.

Counterpart of ``qmmx_monolithic_monte_carlo_tpu/models/logistic.py:31-143``
(``LRModel``, ``fit``, ``fit_batched``, ``predict_proba``, ``fit_sgd``), a
JAX-free copy.  The reference retrains
``sklearn.linear_model.LogisticRegression(max_iter=1000)`` (L2, C=1, lbfgs,
intercept unpenalized); its objective

    min_{w,b}  0.5 ||w||^2 + C sum_i s_i log(1 + exp(-y_i (x_i.w + b)))

is strictly convex, so a full Newton (IRLS) solve driven to gradient ~0 lands
on sklearn's optimum.

``fit_batched`` is an early-exit Newton loop over a leading symbol axis, as
JAX's vmapped ``lax.while_loop`` runs it: each step computes every symbol's
gradient and Hessian and solves them in one batched ``torch.linalg.solve``,
but only the symbols still running take it, so each symbol keeps its own
masked update, its own ``n_iter`` and its own ``grad_norm`` and ends where
its unbatched ``fit`` ends.  The loop stops when every symbol has converged.
Everything runs in the inputs' floating dtype (float64 for the 1e-6 sklearn
parity; float32 input fits in float32).  The fits run where every entry
point of the port runs (``utils/device.resolve``): on the device of a tensor
``x``, else on the card, or on the CPU when asked (``device="cpu"``).  The
matrix products and the solve are library calls, as they are XLA's in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import device as devices


class LRModel(NamedTuple):
    coef: torch.Tensor       # [D] (or [S, D] batched)
    intercept: torch.Tensor  # scalar (or [S])
    n_iter: torch.Tensor     # int32 Newton steps taken
    grad_norm: torch.Tensor  # final max-abs gradient


def _as_float(x, device=None) -> torch.Tensor:
    """``x`` as a floating tensor on the resolved device: that of a tensor
    ``x`` when ``device`` is None, else ``device`` (the card by default)."""
    device = devices.resolve(device, x if torch.is_tensor(x) else None)
    x = torch.as_tensor(x, device=device)
    return x if x.dtype.is_floating_point else x.to(torch.float32)


def _prep(xs, ys, sample_weights, device=None):
    """Features in their floating dtype, labels as +-1 and 0/1 weights (ones
    by default), all of that dtype on the resolved device."""
    x = _as_float(xs, device)
    y = torch.as_tensor(ys, device=x.device)
    y_pm = torch.where(y > 0, 1.0, -1.0).to(x.dtype)
    w = (torch.ones(y.shape, dtype=x.dtype, device=x.device) if sample_weights is None
         else torch.as_tensor(sample_weights, device=x.device).to(x.dtype))
    return x, y_pm, w


def _grad(xa, y_pm, w, beta, c, reg):
    z = y_pm * (xa @ beta[..., None])[..., 0]
    p = torch.sigmoid(z)                               # P(correct side)
    g = c * (xa.transpose(-1, -2) @ (w * (p - 1.0) * y_pm)[..., None])[..., 0]
    return g + reg * beta, p


def fit_batched(xs, ys, sample_weights=None, *, c: float = 1.0, max_iter: int = 100,
                tol: float = 1e-12, device=None) -> LRModel:
    """Per-symbol early-exit Newton/IRLS fits: xs [S, N, D], ys [S, N] in
    {0, 1} (or {-1, +1}), sample_weights [S, N] (0 = padding row, so symbols
    with fewer samples share one shape).  Returns an [S]-batched LRModel.
    ``device`` defaults to that of a tensor ``xs``, else the card (raising
    where there is none)."""
    x, y_pm, w = _prep(xs, ys, sample_weights, device)
    if x.dim() != 3:
        raise ValueError(f"xs must be [S, N, D], got {tuple(x.shape)}")
    n_sym, n, d = x.shape
    dt, dev = x.dtype, x.device
    xa = torch.cat([x, torch.ones((n_sym, n, 1), dtype=dt, device=dev)], dim=-1)
    reg = torch.cat([torch.ones(d, dtype=dt, device=dev), torch.zeros(1, dtype=dt, device=dev)])
    eye = torch.eye(d + 1, dtype=dt, device=dev)
    c = torch.as_tensor(c, dtype=dt, device=dev)
    beta = torch.zeros((n_sym, d + 1), dtype=dt, device=dev)
    n_iter = torch.zeros(n_sym, dtype=torch.int32, device=dev)
    gmax = torch.full((n_sym,), float("inf"), dtype=dt, device=dev)
    while True:
        running = (n_iter < max_iter) & (gmax >= tol)
        if not bool(running.any()):
            break
        g, p = _grad(xa, y_pm, w, beta, c, reg)
        g_now = g.abs().amax(dim=-1)
        s = w * p * (1.0 - p)
        h = c * (xa.transpose(-1, -2) * s[:, None, :]) @ xa + torch.diag(reg)
        # Levenberg damping for safety on degenerate batches
        delta = torch.linalg.solve(h + 1e-12 * eye, g[..., None])[..., 0]
        # a symbol whose gradient already meets tol holds its position
        step = running & ~(g_now < tol)
        beta = torch.where(step[:, None], beta - delta, beta)
        n_iter = n_iter + running.to(torch.int32)
        gmax = torch.where(running, g_now, gmax)
    g, _ = _grad(xa, y_pm, w, beta, c, reg)
    return LRModel(coef=beta[:, :d], intercept=beta[:, d], n_iter=n_iter,
                   grad_norm=g.abs().amax(dim=-1))


def fit(x, y, sample_weight=None, *, c: float = 1.0, max_iter: int = 100,
        tol: float = 1e-12, device=None) -> LRModel:
    """Early-exit Newton/IRLS fit of sklearn's binary logistic objective:
    x [N, D], y [N] in {0, 1} (or {-1, +1}); ``sample_weight`` doubles as a
    validity mask (0 = padding row).  Stops as soon as max|grad| < ``tol``.
    ``device`` as in ``fit_batched``."""
    x = _as_float(x, device)
    y = torch.as_tensor(y, device=x.device)
    w = None if sample_weight is None else torch.as_tensor(sample_weight, device=x.device)[None]
    m = fit_batched(x[None], y[None], w, c=c, max_iter=max_iter, tol=tol)
    return LRModel(*(v[0] for v in m))


def predict_proba(model: LRModel, x) -> torch.Tensor:
    """P(label=1 | x), matching sklearn ``predict_proba[:, 1]``."""
    x = torch.as_tensor(x, device=model.coef.device).to(model.coef.dtype)
    return torch.sigmoid(x @ model.coef + model.intercept)


def fit_sgd(x, y, *, lr: float = 0.05, l2: float = 1e-4, epochs: int = 100,
            device=None) -> LRModel:
    """Plain minibatch-free SGD (one pass = one walk over the rows in
    order), float32, for parity experiments with the OnlinePolicy update rule
    at batch scale.  ``device`` as in ``fit_batched``."""
    x = _as_float(x, device).to(torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    n, d = x.shape
    xa = torch.cat([x, torch.ones((n, 1), dtype=torch.float32, device=x.device)], dim=1)
    beta = torch.zeros(d + 1, dtype=torch.float32, device=x.device)
    for _ in range(epochs):
        for i in range(n):
            pred = torch.sigmoid(xa[i] @ beta)
            beta = beta - lr * ((pred - y[i]) * xa[i] + l2 * beta)
    return LRModel(coef=beta[:d], intercept=beta[d],
                   n_iter=torch.tensor(epochs, dtype=torch.int32, device=x.device),
                   grad_norm=torch.tensor(0.0, dtype=torch.float32, device=x.device))
