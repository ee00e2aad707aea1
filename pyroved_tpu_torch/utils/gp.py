"""Exact GP regression on encoded latents.

Counterpart of ``pyroved_tpu/utils/gp.py``: an RBF-kernel exact GP whose
negative marginal log-likelihood is minimized with Adam at lr 5e-3
(``torch.optim.Adam``: optax's ``adam`` update, betas 0.9 and 0.999, eps
1e-8 added to the bias-corrected root, no weight decay), the loss
recomputed at every step. Solves go through a Cholesky factor. It runs on
the device of the inputs it is given.
"""
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _as_f32(a, device=None) -> Tensor:
    if isinstance(a, Tensor):
        return a.detach().to(device=device or a.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _rbf(x1: Tensor, x2: Tensor, variance: Tensor,
         lengthscale: Tensor) -> Tensor:
    d2 = torch.sum((x1[:, None, :] - x2[None, :, :]) ** 2, dim=-1)
    return variance * torch.exp(-0.5 * d2 / (lengthscale ** 2))


class GPParams(NamedTuple):
    """The GP's parameters, the logs of the RBF kernel's variance and
    lengthscale and of the noise, as f32 scalar tensors."""
    log_variance: Tensor
    log_lengthscale: Tensor
    log_noise: Tensor


def _noisy_gram(X: Tensor, log_variance: Tensor, log_lengthscale: Tensor,
                log_noise: Tensor) -> Tensor:
    n = X.shape[0]
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    return (_rbf(X, X, torch.exp(log_variance), torch.exp(log_lengthscale))
            + (torch.exp(log_noise) + 1e-6) * eye)


def _neg_mll(params, X: Tensor, y: Tensor) -> Tensor:
    n = X.shape[0]
    L = torch.linalg.cholesky(_noisy_gram(X, *params))
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    return (0.5 * torch.dot(y, alpha)
            + torch.sum(torch.log(torch.diagonal(L)))
            + 0.5 * n * math.log(2.0 * math.pi))


class GPRegression:
    """Exact GP regression with an RBF kernel: unit variance, lengthscale
    and noise to start with (``params``, a :class:`GPParams`; any sequence
    of the three logs may be assigned to it)."""

    def __init__(self, X, y):
        self.X = _as_f32(X)
        self.y = _as_f32(y, self.X.device).reshape(-1)
        self.params = GPParams(*(self.X.new_zeros(()) for _ in range(3)))

    def _params(self) -> GPParams:
        return GPParams(*(_as_f32(p, self.X.device) for p in self.params))

    def fit(self, iterations: int = 1, lr: float = 5e-3) -> float:
        """``iterations`` Adam steps (a fresh optimizer state, as the JAX
        package's); returns the loss before the last step."""
        params = [p.clone().requires_grad_(True) for p in self._params()]
        opt = torch.optim.Adam(params, lr=lr)
        loss = float("nan")
        for _ in range(iterations):
            opt.zero_grad()
            value = _neg_mll(params, self.X, self.y)
            value.backward()
            opt.step()
            loss = value.detach()
        self.params = GPParams(*(p.detach() for p in params))
        return float(loss)

    @torch.no_grad()
    def predict(self, Xnew) -> Tuple[Tensor, Tensor]:
        """Posterior predictive mean and variance at new points."""
        Xnew = _as_f32(Xnew, self.X.device)
        params = self._params()
        var = torch.exp(params.log_variance)
        ls = torch.exp(params.log_lengthscale)
        L = torch.linalg.cholesky(_noisy_gram(self.X, *params))
        Ks = _rbf(Xnew, self.X, var, ls)
        alpha = torch.cholesky_solve(self.y[:, None], L)[:, 0]
        mean = Ks @ alpha
        v = torch.linalg.solve_triangular(L, Ks.T, upper=False)
        pred_var = var - torch.sum(v * v, dim=0)
        return mean, torch.clamp(pred_var, min=0.0)


def gp_model(input_dim: int = None, encoded_X=None, y=None,
             gp_iterations: int = 1, lr: float = 5e-3) -> GPRegression:
    """A GP trained on encoded latents for ``gp_iterations`` Adam steps
    (``input_dim`` is inferred from ``encoded_X``)."""
    del input_dim
    gpr = GPRegression(encoded_X, y)
    gpr.fit(gp_iterations, lr)
    return gpr
