"""Process groups, device meshes and the placement of parameters.

Counterpart of ``pyroved_tpu/parallel/mesh.py``. One rank is one device of
the JAX package's mesh; :func:`create_mesh` names the world's ranks with
the JAX package's axes:

- ``'data'``: the trainers split each batch's rows over it and sum the
  grads (``SVItrainer(mesh=...)``);
- ``'model'``: :func:`tensor_parallel_params` splits the output features of
  the linear and convolution layers and the batchnorms' channels over it
  (column parallelism); :func:`whole_tensors` gathers them whole for the
  files a model writes, :func:`local_tensors` cuts them again;
- ``'pixels'``: :func:`~pyroved_tpu_torch.parallel.spatial.shard_pixels`
  splits the decoder's pixel grid over it.
"""
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor

from ..utils.nn import resolve_device
from ..nets.conv import BatchNorm, _SameConv
from .collectives import (Axis, broadcast_tensors, check_mesh, gather_dim,
                          replicated)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device=None) -> int:
    """Join this process to the world's process group and return the world
    size (the JAX package's global device count).

    With ``coordinator_address`` (``host:port``, or a ``tcp://`` or
    ``file://`` URL) the group forms there from ``num_processes`` and
    ``process_id``; without it, from the environment ``torchrun`` sets
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); without
    either, this process alone is the world. ``backend`` defaults to NCCL
    for ``device`` "cuda" (None means "cuda", as every entry point) and to
    gloo for "cpu"; a backend that fails to start raises. On CUDA the
    process takes the card ``LOCAL_RANK % device_count`` (torchrun's
    ``LOCAL_RANK``, else the rank). NCCL takes one rank per card; gloo
    reduces CUDA tensors too and lets ranks share one. An initialized group
    is kept: the call then returns its size."""
    if dist.is_initialized():
        return dist.get_world_size()
    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    env = os.environ
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
        kw = dict(init_method=url, rank=rank, world_size=world)
    elif "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        kw = dict(init_method="env://", rank=rank, world_size=world)
    elif (num_processes or 1) == 1:
        rank, world = 0, 1
        kw = dict(store=dist.HashStore(), rank=0, world_size=1)
    else:
        raise ValueError(
            f"num_processes={num_processes} needs a coordinator_address (or "
            "torchrun's environment) to meet the other processes at")
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, **kw)
    return dist.get_world_size()


def _device_ranks(devices) -> list:
    """The ranks of ``devices`` in order: an int is a rank, a
    ``torch.device`` (or its name) the one rank whose device it is (each
    rank's device: its card under NCCL, else the CPU). A device that no
    rank, or more than one rank, holds raises ``ValueError``."""
    held = None
    out = []
    for d in devices:
        if isinstance(d, (int, np.integer)):
            out.append(int(d))
            continue
        d = torch.device(d)
        if held is None:  # every rank's device, once
            own = (f"cuda:{torch.cuda.current_device()}"
                   if dist.get_backend() == "nccl" else "cpu")
            held = [None] * dist.get_world_size()
            dist.all_gather_object(held, own)
        name = (f"cuda:{torch.cuda.current_device() if d.index is None else d.index}"
                if d.type == "cuda" else d.type)
        owners = [r for r, h in enumerate(held) if h == name]
        if len(owners) != 1:
            raise ValueError(f"device {d} is held by ranks {owners}: pass "
                             f"ranks instead")
        out.append(owners[0])
    return out


def create_mesh(axes: Optional[Dict[str, int]] = None, devices=None,
                ranks=None):
    """A ``DeviceMesh`` named by ``axes`` (``{'axis': size}``, default
    ``{'data': participants}``) over its participants in mesh order:
    ``devices`` as the JAX package's argument, here ranks or
    ``torch.device``s (each the one rank whose device it is), or the same
    as ``ranks``; default the whole world, which must be initialized
    (:func:`initialize_multihost`). Passing both raises ``ValueError``.
    One size may be ``-1`` to take what the others leave; the sizes must
    multiply to the participant count (``ValueError``). Every rank calls
    it, as it builds each axis's process group. The mesh's device type
    follows the backend: "cuda" under NCCL, "cpu" under gloo (whose groups
    reduce CUDA tensors as well)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "parallel.initialize_multihost() first")
    if devices is not None and ranks is not None:
        raise ValueError("create_mesh takes devices or ranks, not both")
    if devices is not None:
        ranks = _device_ranks(devices)
    ranks = (list(range(dist.get_world_size())) if ranks is None
             else [int(r) for r in ranks])
    n = len(ranks)
    if axes is None:
        axes = {"data": n}
    sizes = [int(s) for s in axes.values()]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"Mesh axes {axes} do not cover {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    layout = torch.tensor(ranks, dtype=torch.int64).reshape(sizes)
    return DeviceMesh(device_type, layout, mesh_dim_names=tuple(axes))


def data_parallel_mesh(num_devices: Optional[int] = None):
    """A mesh with one ``'data'`` axis over the world's ranks (or its first
    ``num_devices``)."""
    if not dist.is_initialized():
        raise RuntimeError("data_parallel_mesh needs a process group: call "
                           "parallel.initialize_multihost() first")
    world = dist.get_world_size()
    n = world if num_devices is None else int(num_devices)
    if not 0 < n <= world:
        raise ValueError(f"num_devices={num_devices} for {world} ranks")
    return create_mesh({"data": n}, ranks=range(n))


def replicate_params(model, mesh):
    """Give every rank the parameters of the mesh's first rank: one
    ``broadcast`` of one flat buffer. Takes and returns the model. The
    layers split over ``'model'`` (:func:`tensor_parallel_params`) are
    gathered whole for it, and every rank keeps its rows of the first
    rank's whole layers."""
    check_mesh(mesh)
    params = dict(model.nets.named_parameters())
    whole = whole_tensors(model.nets, params)
    names = sorted(whole)
    broadcast_tensors([whole[n] for n in names],
                      src=int(mesh.mesh.reshape(-1)[0]))
    local = local_tensors(model.nets, whole)
    with torch.no_grad():
        for n in names:
            params[n].copy_(local[n])
    return model


class ColumnParallel(nn.Module):
    """A layer whose output features are split over a mesh axis: this rank
    holds rows ``[r*o/n, (r+1)*o/n)`` of the first dim of each parameter
    (the JAX leaf's last axis: a kernel's output features, a bias, a
    batchnorm's scale) and the output is gathered whole along ``dim``. The
    input enters through :func:`~.collectives.replicated` and the output
    leaves through :func:`~.collectives.gather_dim`, so that every rank
    holds the whole output and its input's whole gradient, as GSPMD's
    re-gather gives. ``features`` is the layer's whole output width."""

    dim = -1

    def _split_from(self, layer: nn.Module, features: int, axis: Axis):
        o = features // axis.size
        self.axis = axis
        self.features = features
        self.rows = slice(axis.rank * o, (axis.rank + 1) * o)
        for name in ("weight", "bias"):
            p = getattr(layer, name, None)
            setattr(self, name, None if p is None else
                    nn.Parameter(p.detach()[self.rows].clone()))

    def forward(self, x):
        (x,) = replicated(self.axis, x)
        return gather_dim(self.axis, self.local(x), self.dim)


class ColumnParallelLinear(ColumnParallel):
    """An ``nn.Linear`` split over its output features (the torch weight's
    first dim)."""

    def __init__(self, layer: nn.Linear, axis: Axis):
        super().__init__()
        self.in_features, self.out_features = (layer.in_features,
                                               layer.out_features)
        self._split_from(layer, layer.out_features, axis)

    def local(self, x):
        return F.linear(x, self.weight, self.bias)


class ColumnParallelConv(ColumnParallel):
    """A ``"SAME"`` convolution of ``nets.conv`` split over its output
    channels, gathered along the channel dim."""

    dim = 1

    def __init__(self, layer, axis: Axis):
        super().__init__()
        self.kernel_size, self.stride = layer.kernel_size, layer.stride
        self._split_from(layer, layer.out_channels, axis)

    def local(self, x):
        return _SameConv.forward(self, x)


class ColumnParallelBatchNorm(ColumnParallel):
    """A ``nets.conv.BatchNorm`` split over its channels: each rank
    normalizes its channels of the whole input (their statistics need no
    other channel) and the output is gathered along the channel dim."""

    dim = 1

    def __init__(self, layer: BatchNorm, axis: Axis):
        super().__init__()
        self._split_from(layer, layer.weight.shape[0], axis)
        self.stats_axis = layer.stats_axis
        stats = layer.running_stats
        self.running_stats = (None if stats is None else
                              tuple(t[self.rows] for t in stats))

    def local(self, x):
        return BatchNorm.forward(self, x[:, self.rows])


def _splittable(child, size: int):
    """The split class of ``child`` when the axis size ``size`` divides its
    output features (the JAX leaf's last axis), else None."""
    if isinstance(child, nn.Linear):
        cls, n = ColumnParallelLinear, child.out_features
    elif isinstance(child, _SameConv) and not isinstance(
            child, nn.modules.lazy.LazyModuleMixin):
        cls, n = ColumnParallelConv, child.out_channels
    elif isinstance(child, BatchNorm):
        cls, n = ColumnParallelBatchNorm, child.weight.shape[0]
    else:
        return None
    return cls if n % size == 0 and n >= size else None


def tensor_parallel_params(model, mesh, axis: str = "model"):
    """Split every parameter leaf whose output features the ``axis`` size
    divides, as the JAX package's ``tensor_parallel_params`` shards every
    leaf whose last axis it divides: the ``nn.Linear`` layers
    (:class:`ColumnParallelLinear`), the convolutions
    (:class:`ColumnParallelConv`) and the batchnorms' scale and bias
    (:class:`ColumnParallelBatchNorm`); the other layers stay whole on
    every rank. Takes and returns the model; build the trainer afterwards
    (its optimizer holds the shards). The decoder's kernels need its
    weights whole, so a split decoder turns them off here; the warning
    comes at the next training call (``sync_fusion_gate``)."""
    ax = Axis(check_mesh(mesh), axis)
    if ax.size == 1 and axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.mesh_dim_names}")
    for parent in list(model.nets.modules()):
        for name, child in list(parent.named_children()):
            cls = _splittable(child, ax.size)
            if cls is not None:
                setattr(parent, name, cls(child, ax))
    gate = getattr(model, "sync_fusion_gate", None)
    if gate is not None:  # a split decoder's kernels would read its shards
        gate(defer_warning=True)
    return model


def tensor_parallel(module: nn.Module) -> bool:
    """True when ``module`` holds a layer split by
    :func:`tensor_parallel_params`."""
    return any(isinstance(m, ColumnParallel) for m in module.modules())


def split_parameters(module: nn.Module) -> Dict[str, ColumnParallel]:
    """``{parameter name: its split layer}`` of every parameter that
    :func:`tensor_parallel_params` split in ``module``."""
    out = {}
    for prefix, m in module.named_modules():
        if isinstance(m, ColumnParallel):
            for name, _ in m.named_parameters(recurse=False):
                out[f"{prefix}.{name}" if prefix else name] = m
    return out


def whole_tensors(module: nn.Module, named: Dict[str, Tensor]
                  ) -> Dict[str, Tensor]:
    """``named`` (tensors keyed by parameter name and shaped like the
    parameter: the parameters, their Adam moments, a gradient window) with
    each split parameter's rows gathered whole over its axis, in name
    order. Every rank of the axis calls it; the others pass through."""
    split = split_parameters(module)
    out = {}
    for name in sorted(named):
        t = named[name]
        layer = split.get(name)
        if layer is not None and t.dim() >= 1 and layer.axis.size > 1:
            t = torch.cat(layer.axis.all_gather(t.detach().contiguous()))
        out[name] = t
    return out


def local_tensors(module: nn.Module, named: Dict[str, Tensor]
                  ) -> Dict[str, Tensor]:
    """Inverse of :func:`whole_tensors`: each split parameter's whole
    tensor cut to this rank's rows; the others pass through."""
    split = split_parameters(module)
    out = {}
    for name, t in named.items():
        layer = split.get(name)
        if layer is not None and t.ndim >= 1 and t.shape[0] == layer.features:
            t = t[layer.rows]
        out[name] = t
    return out
