"""Carrying weights across from the JAX package.

The JAX model keeps its parameters as a flax tree,
``{"encoder_z": {"MLP_0": {"Dense_0": {"kernel", "bias"}, ...}, "fc11":
...}, "decoder": {...}}`` (with ``"encoder_y"``, the classifier or
regressor, for the semi-supervised models, and ``fc13``, the class head, in
jiVAE's encoder), with ``[in, out]`` kernels. The port's modules carry the
same names, so the tree maps onto a ``state_dict`` by joining the path with
dots and transposing each kernel to torch's ``[out, in]``.

The conv nets (VED) add two kinds of leaf: a convolution's ``kernel``
``[*k, in, out]`` becomes torch's ``weight`` ``[out, in, *k]`` for any
spatial rank, and a BatchNorm's ``scale`` becomes its ``weight`` (its
``bias`` stays ``bias``). The port's conv nets flatten and reshape
channels-last at their latent heads, as the JAX nets do, so
``features2latent`` and ``latent2features`` map as any Dense. The JAX
model's ``state`` (flax's ``batch_stats``) holds no parameter and is not
carried: both packages normalize with the batch's own statistics.
"""
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX parameter tree whose leaves are
    numpy arrays (or anything ``np.asarray`` takes)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
                continue
            arr = np.asarray(val, np.float32)
            if key == "kernel" and arr.ndim == 2:
                out[prefix + "weight"] = torch.from_numpy(
                    np.array(arr.T, order="C"))
            elif key == "kernel" and arr.ndim > 2:  # [*k, I, O] -> [O, I, *k]
                nd = arr.ndim - 2
                out[prefix + "weight"] = torch.from_numpy(np.array(
                    arr.transpose((nd + 1, nd) + tuple(range(nd))),
                    order="C"))
            elif key == "scale":
                out[prefix + "weight"] = torch.from_numpy(arr.copy())
            elif key == "bias":
                out[prefix + "bias"] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"unexpected parameter leaf {prefix}{key}")

    walk(params, "")
    return out
