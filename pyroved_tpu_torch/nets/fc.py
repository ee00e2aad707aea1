"""Fully-connected encoder and decoder modules.

Counterpart of ``pyroved_tpu/nets/fc.py``. Submodules carry the flax tree's
names (``MLP_0.Dense_i``, ``fc11``, ``fc12``, ``fc13``, ``fc_coord``,
``fc_latent``, ``out``), so JAX weights load by a rename and a transpose
(:mod:`pyroved_tpu_torch.weights`). Initialization is torch's
``nn.Linear`` default, U(+-1/sqrt(fan_in)) for weight and bias, drawn from
an explicit generator.
"""
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.nn import get_activation

Tensor = torch.Tensor


def _default_hidden(hidden_dim) -> Tuple[int, ...]:
    return tuple(hidden_dim) if hidden_dim is not None else (128, 128)


class Dense(nn.Linear):
    """``nn.Linear`` whose default init can draw from a given generator."""

    def reset_from(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            self.weight.copy_(torch.empty(self.weight.shape).uniform_(
                -bound, bound, generator=generator))
            if self.bias is not None:
                self.bias.copy_(torch.empty(self.bias.shape).uniform_(
                    -bound, bound, generator=generator))


class MLP(nn.Module):
    """Stack of Dense + activation layers (``Dense_0``, ``Dense_1``, ...)."""

    def __init__(self, in_dim: int, hidden_dim: Sequence[int],
                 activation: str = "tanh"):
        super().__init__()
        self.act = get_activation(activation)
        self.n_layers = len(hidden_dim)
        for i, h in enumerate(hidden_dim):
            setattr(self, f"Dense_{i}", Dense(in_dim, h))
            in_dim = h

    def layers(self):
        return [getattr(self, f"Dense_{i}") for i in range(self.n_layers)]

    def forward(self, x: Tensor) -> Tensor:
        for layer in self.layers():
            x = self.act(layer(x))
        return x


def init_from(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every Dense of ``module`` from ``generator``, in
    registration order."""
    for m in module.modules():
        if isinstance(m, Dense):
            m.reset_from(generator)
    return module


class fcEncoderNet(nn.Module):
    """MLP encoder producing (mu, sigma) of q(z|x[,y]), softplus sigma."""

    def __init__(self, in_dim: Tuple[int, ...], latent_dim: int = 2,
                 c_dim: int = 0, hidden_dim: Optional[Sequence[int]] = None,
                 activation: str = "tanh", softplus_out: bool = True):
        super().__init__()
        self.in_dim = tuple(in_dim)
        self.flat_dim = int(np.prod(self.in_dim))
        hidden = _default_hidden(hidden_dim)
        self.MLP_0 = MLP(self.flat_dim + int(c_dim), hidden, activation)
        self.fc11 = Dense(hidden[-1], latent_dim)
        self.fc12 = Dense(hidden[-1], latent_dim)
        self.softplus_out = softplus_out

    def forward(self, x: Tensor, y: Optional[Tensor] = None):
        x = _flatten_events(x, self.in_dim, self.flat_dim)
        if y is not None:
            y = y.expand(x.shape[:-1] + (y.shape[-1],))
            x = torch.cat([x, y], dim=-1)
        h = self.MLP_0(x)
        mu = self.fc11(h)
        sigma = self.fc12(h)
        if self.softplus_out:
            sigma = F.softplus(sigma)
        return mu, sigma


def _flatten_events(x: Tensor, in_dim: Tuple[int, ...], flat_dim: int) -> Tensor:
    """``x`` with its trailing event dims flattened to ``flat_dim``."""
    if x.shape[-1] != flat_dim:
        x = x.reshape(x.shape[:-len(in_dim)] + (flat_dim,))
    return x


class jfcEncoderNet(nn.Module):
    """Joint encoder: (mu, sigma) of q(z|x), softplus sigma, and the class
    probabilities alpha of q(k|x), a softmax over ``discrete_dim``."""

    def __init__(self, in_dim: Tuple[int, ...], latent_dim: int = 2,
                 discrete_dim: int = 0,
                 hidden_dim: Optional[Sequence[int]] = None,
                 activation: str = "tanh", softplus_out: bool = True):
        super().__init__()
        self.in_dim = tuple(in_dim)
        self.flat_dim = int(np.prod(self.in_dim))
        hidden = _default_hidden(hidden_dim)
        self.MLP_0 = MLP(self.flat_dim, hidden, activation)
        self.fc11 = Dense(hidden[-1], latent_dim)
        self.fc12 = Dense(hidden[-1], latent_dim)
        self.fc13 = Dense(hidden[-1], discrete_dim)
        self.softplus_out = softplus_out

    def forward(self, x: Tensor):
        h = self.MLP_0(_flatten_events(x, self.in_dim, self.flat_dim))
        mu = self.fc11(h)
        sigma = self.fc12(h)
        if self.softplus_out:
            sigma = F.softplus(sigma)
        return mu, sigma, torch.softmax(self.fc13(h), dim=-1)


class fcClassifierNet(nn.Module):
    """MLP classifier: class probabilities, a softmax over ``num_classes``."""

    def __init__(self, in_dim: Tuple[int, ...], num_classes: int,
                 hidden_dim: Optional[Sequence[int]] = None,
                 activation: str = "tanh"):
        super().__init__()
        self.in_dim = tuple(in_dim)
        self.flat_dim = int(np.prod(self.in_dim))
        hidden = _default_hidden(hidden_dim)
        self.MLP_0 = MLP(self.flat_dim, hidden, activation)
        self.out = Dense(hidden[-1], int(num_classes))

    def forward(self, x: Tensor) -> Tensor:
        h = self.MLP_0(_flatten_events(x, self.in_dim, self.flat_dim))
        return torch.softmax(self.out(h), dim=-1)


class fcRegressorNet(nn.Module):
    """MLP regressor with a linear head of ``c_dim`` outputs."""

    def __init__(self, in_dim: Tuple[int, ...], c_dim: int,
                 hidden_dim: Optional[Sequence[int]] = None,
                 activation: str = "tanh"):
        super().__init__()
        self.in_dim = tuple(in_dim)
        self.flat_dim = int(np.prod(self.in_dim))
        hidden = _default_hidden(hidden_dim)
        self.MLP_0 = MLP(self.flat_dim, hidden, activation)
        self.out = Dense(hidden[-1], int(c_dim))

    def forward(self, x: Tensor) -> Tensor:
        return self.out(self.MLP_0(_flatten_events(x, self.in_dim,
                                                   self.flat_dim)))


class fcDecoderNet(nn.Module):
    """MLP decoder latent -> flattened signal ``[..., prod(out_dim)]``."""

    def __init__(self, in_dim: int, out_dim: Tuple[int, ...],
                 hidden_dim: Optional[Sequence[int]] = None,
                 activation: str = "tanh", sigmoid_out: bool = True):
        super().__init__()
        hidden = _default_hidden(hidden_dim)
        self.MLP_0 = MLP(int(in_dim), hidden, activation)
        self.out = Dense(hidden[-1], int(np.prod(out_dim)))
        self.sigmoid_out = sigmoid_out

    def forward(self, z: Tensor) -> Tensor:
        x = self.out(self.MLP_0(z))
        return torch.sigmoid(x) if self.sigmoid_out else x


class sDecoderNet(nn.Module):
    """Spatial decoder: a per-pixel MLP over a (transformed) grid.

    ``coords`` is ``[..., N, coord_dim]`` and ``z`` is ``[..., latent(+c)]``.
    The output is ``[..., N]`` for one channel, else ``[..., N, C]``. The
    coordinate/latent fusion ``h0 = tanh(coords @ Wc + bc + z @ Wz)`` is
    always tanh; the MLP layers follow ``activation``.
    """

    def __init__(self, coord_dim: int, latent_dim: int,
                 hidden_dim: Optional[Sequence[int]] = None,
                 activation: str = "tanh", sigmoid_out: bool = True,
                 channels: int = 1):
        super().__init__()
        if int(channels) < 1:
            raise ValueError(f"channels must be >= 1, got {channels}")
        hidden = _default_hidden(hidden_dim)
        self.fc_coord = Dense(int(coord_dim), hidden[0])
        self.fc_latent = Dense(int(latent_dim), hidden[0], bias=False)
        self.MLP_0 = MLP(hidden[0], hidden, activation)
        self.out = Dense(hidden[-1], int(channels))
        self.activation = activation
        self.sigmoid_out = sigmoid_out
        self.channels = int(channels)

    def forward(self, coords: Tensor, z: Tensor) -> Tensor:
        h = torch.tanh(self.fc_coord(coords) + self.fc_latent(z)[..., None, :])
        x = self.out(self.MLP_0(h))
        if self.channels == 1:
            x = x[..., 0]
        return torch.sigmoid(x) if self.sigmoid_out else x
