"""NN helpers: the activation registry, seeding and host conversion.

Counterpart of ``pyroved_tpu/utils/nn.py``. Seeding hands out an explicit
``torch.Generator`` instead of a JAX PRNG key; nothing touches torch's
global generator.
"""
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
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


def later_slice(what: str, item: str) -> NotImplementedError:
    """The error for a feature that a later slice of the port brings."""
    return NotImplementedError(
        f"{what} is not ported yet; see ROADMAP.md, '{item}'")


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
