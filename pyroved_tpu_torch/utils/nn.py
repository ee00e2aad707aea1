"""NN helpers: the activation registry, seeding, host conversion and the
dimension-keyed layer factories.

Counterpart of ``pyroved_tpu/utils/nn.py``. Seeding hands out an explicit
``torch.Generator`` instead of a JAX PRNG key; nothing touches torch's
global generator. The factories (``get_bnorm``, ``get_conv``,
``get_maxpool``) and ``concat_features`` / ``Concat`` work in torch's
channels-first layout, ``[B, C, *spatial]``, where the JAX package's work
channels-last.
"""
from typing import Callable, Dict, Iterable, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor

_ACTIVATIONS: Dict[str, Callable[[Tensor], Tensor]] = {
    "relu": torch.relu,
    "lrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "tanh": torch.tanh,
    "softplus": F.softplus,
    # exact (erf) gelu, as the reference registry wires in
    "gelu": lambda x: F.gelu(x, approximate="none"),
}


def get_activation(activation: Optional[str]) -> Optional[Callable[[Tensor], Tensor]]:
    """relu / lrelu (slope 0.01) / tanh / softplus / gelu (exact erf)."""
    if activation is None:
        return None
    return _ACTIVATIONS[activation]


def set_deterministic_mode(seed: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded with ``seed``. Randomness is
    explicit: every stochastic op takes this (or another) generator."""
    g = torch.Generator()
    g.manual_seed(int(seed))
    return g


def resolve_device(device=None) -> torch.device:
    """The device rule of every entry point: ``None`` means ``"cuda"``, and
    a CUDA device without CUDA raises instead of running on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def as_f32(x, device) -> Tensor:
    """A float32 tensor on ``device`` from a tensor or an array-like."""
    if isinstance(x, Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def to_onehot(idx, n: int, device=None) -> Tensor:
    """One-hot float32 rows ``[len(idx), n]`` of integer labels; raises
    when a label lies outside [0, n)."""
    idx = torch.as_tensor(as_numpy(idx)).reshape(-1)
    if idx.numel() and (int(idx.max()) >= n or int(idx.min()) < 0):
        raise AssertionError(
            "Labelling must start from 0 and "
            "maximum label value must be less than total number of classes")
    return F.one_hot(idx.long(), n).to(device=device, dtype=torch.float32)


def average_weights(ensemble: Mapping[int, Mapping[str, Tensor]]
                    ) -> Dict[str, Tensor]:
    """Elementwise mean of state dicts with the same keys (stochastic
    weight averaging over the snapshots in ``ensemble``)."""
    trees = list(ensemble.values())
    if not trees:
        raise ValueError("Empty ensemble")
    return {k: sum(t[k] for t in trees) / float(len(trees)) for k in trees[0]}


def as_numpy(x) -> np.ndarray:
    """Coerce torch tensors and array-likes to a host numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _check_dim(dim: int) -> None:
    if dim not in (1, 2, 3):
        raise KeyError(dim)


def get_bnorm(dim: int):
    """Dimension-keyed BatchNorm factory: the port's
    :class:`~pyroved_tpu_torch.nets.conv.BatchNorm` for every dim (it
    normalizes axis 1, the channels, for any rank), built as
    ``BatchNorm(features)``. A dim outside 1-3 raises ``KeyError``."""
    from ..nets.conv import BatchNorm
    _check_dim(dim)
    return BatchNorm


def get_conv(dim: int):
    """Dimension-keyed convolution factory. Returns a constructor with the
    JAX package's signature, ``(features, kernel_size=3, stride=1,
    padding="SAME", **kw)``, that builds an ``nn.LazyConv{dim}d`` (the
    input channels are inferred at the first call) in channels-first
    layout. ``"SAME"`` is XLA's padding (``total // 2`` before, the rest
    after, any stride), through the port's conv nets' own convolution
    (f32 with TF32 off); ``"VALID"`` is no padding, and an int or a tuple
    is passed to torch. Other keywords go to the convolution."""
    from ..nets import conv as convs
    _check_dim(dim)
    lazy_same = {1: convs.LazyConv1d, 2: convs.LazyConv2d,
                 3: convs.LazyConv3d}[dim]
    lazy = {1: nn.LazyConv1d, 2: nn.LazyConv2d, 3: nn.LazyConv3d}[dim]

    def make(features, kernel_size=3, stride=1, padding="SAME", **kw):
        ks = kernel_size if isinstance(kernel_size, tuple) else (kernel_size,) * dim
        st = stride if isinstance(stride, tuple) else (stride,) * dim
        if isinstance(padding, str) and padding.upper() == "SAME":
            return lazy_same(features, ks, st, **kw)
        if isinstance(padding, str) and padding.upper() == "VALID":
            padding = 0
        return lazy(features, ks, st, padding=padding, **kw)

    return make


def get_maxpool(dim: int):
    """Dimension-keyed max-pool op over ``[B, C, *spatial]``. Returns
    ``pool(x, window=2, stride=2)``."""
    _check_dim(dim)
    fn = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[dim]

    def pool(x, window=2, stride=2):
        return fn(x, window, stride)

    return pool


def concat_features(args: Union[Tensor, Iterable[Tensor]]) -> Tensor:
    """Concatenate feature tensors on the last dim: an input with 4 or more
    dims is flattened to ``[B, -1]`` first, and the leading (batch) dims
    broadcast. A single tensor comes back as it is."""
    if isinstance(args, Tensor):
        return args
    args = [a.reshape(a.shape[0], -1) if a.dim() >= 4 else a for a in args]
    batch_shape = torch.broadcast_shapes(*[a.shape[:-1] for a in args])
    args = [a.expand(tuple(batch_shape) + (a.shape[-1],)) for a in args]
    return torch.cat(args, dim=-1)


class Concat(nn.Module):
    """:func:`concat_features` as a module (usable in ``nn.Sequential``);
    ``allow_broadcast`` is kept for the reference's signature."""

    def __init__(self, allow_broadcast: bool = True):
        super().__init__()
        self.allow_broadcast = allow_broadcast

    def forward(self, input_args) -> Tensor:
        return concat_features(input_args)
