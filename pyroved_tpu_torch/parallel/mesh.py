"""Process groups, device meshes and the placement of parameters.

Counterpart of ``pyroved_tpu/parallel/mesh.py``. One rank is one device of
the JAX package's mesh; :func:`create_mesh` names the world's ranks with
the JAX package's axes:

- ``'data'``: the trainers split each batch's rows over it and sum the
  grads (``SVItrainer(mesh=...)``);
- ``'model'``: :func:`tensor_parallel_params` splits the output features of
  the linear layers over it (column parallelism);
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

from ..utils.nn import resolve_device
from .collectives import (Axis, broadcast_tensors, check_mesh, gather_last,
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


def create_mesh(axes: Optional[Dict[str, int]] = None, ranks=None):
    """A ``DeviceMesh`` over ``ranks`` (default the whole world, which must
    be initialized: :func:`initialize_multihost`) named by ``axes``
    (``{'axis': size}``, default ``{'data': world size}``), laid out in
    rank order. One size may be ``-1`` to take what the others leave; the
    sizes must multiply to the rank count (``ValueError``). Every rank
    calls it, as it builds each axis's process group. The mesh's device
    type follows the backend: "cuda" under NCCL, "cpu" under gloo (whose
    groups reduce CUDA tensors as well)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "parallel.initialize_multihost() first")
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
    return create_mesh({"data": n}, range(n))


def replicate_params(model, mesh):
    """Give every rank the parameters (and buffers) of the mesh's first
    rank: one ``broadcast`` of one flat buffer. Takes and returns the
    model. Call it before :func:`tensor_parallel_params`."""
    check_mesh(mesh)
    if tensor_parallel(model.nets):
        raise ValueError("replicate_params would broadcast one rank's shards "
                         "of a tensor-parallel model; replicate first")
    tensors = list(model.nets.parameters()) + [
        b for b in model.nets.buffers() if b.is_floating_point()]
    broadcast_tensors(tensors, src=int(mesh.mesh.reshape(-1)[0]))
    return model


class ColumnParallelLinear(nn.Module):
    """A linear layer whose output features are split over a mesh axis:
    this rank holds rows ``[r*o/n, (r+1)*o/n)`` of the weight (the JAX
    kernel's last axis is the torch weight's first) and of the bias, and
    the output is gathered whole. The input enters through
    :func:`~.collectives.replicated` and the output leaves through
    :func:`~.collectives.gather_last`, so that every rank holds the whole
    output and its input's whole gradient, as GSPMD's re-gather gives."""

    def __init__(self, layer: nn.Linear, axis: Axis):
        super().__init__()
        o = layer.out_features // axis.size
        rows = slice(axis.rank * o, (axis.rank + 1) * o)
        self.axis = axis
        self.in_features, self.out_features = (layer.in_features,
                                               layer.out_features)
        self.weight = nn.Parameter(layer.weight.detach()[rows].clone())
        self.bias = (None if layer.bias is None else
                     nn.Parameter(layer.bias.detach()[rows].clone()))

    def forward(self, x):
        (x,) = replicated(self.axis, x)
        return gather_last(self.axis, F.linear(x, self.weight, self.bias))


def tensor_parallel_params(model, mesh, axis: str = "model"):
    """Split every ``nn.Linear`` of the model whose output features the
    ``axis`` size divides into a :class:`ColumnParallelLinear`; the other
    layers stay whole on every rank. Takes and returns the model; build the
    trainer afterwards (its optimizer holds the shards). The decoder's
    kernels need its weights whole, so a split decoder turns them off at
    the next training call (``sync_fusion_gate``)."""
    ax = Axis(check_mesh(mesh), axis)
    if ax.size == 1 and axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.mesh_dim_names}")
    for parent in list(model.nets.modules()):
        for name, child in list(parent.named_children()):
            if (isinstance(child, nn.Linear)
                    and child.out_features % ax.size == 0
                    and child.out_features >= ax.size):
                setattr(parent, name, ColumnParallelLinear(child, ax))
    return model


def tensor_parallel(module: nn.Module) -> bool:
    """True when ``module`` holds a :class:`ColumnParallelLinear`."""
    return any(isinstance(m, ColumnParallelLinear) for m in module.modules())
