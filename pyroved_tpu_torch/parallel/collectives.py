"""The collectives of the parallel layer, and a mesh axis as one rank sees
it.

Only three collectives are used, each over one axis's process group:
``all_reduce`` (sum), ``broadcast`` and the list form of ``all_gather``:
the ones gloo runs on CPU and on CUDA tensors alike, as NCCL does on CUDA
tensors. Three autograd functions place them in a model's graph, each with
the backward that keeps the gradients of a loss that every rank of the
axis holds whole (the models' losses are replicated over 'model' and
'pixels'):

- :func:`replicated` (identity; the backward sums the cotangents over the
  axis): where a replicated value enters work split over the axis, since
  each rank's cotangent then holds only its part's share;
- :func:`sum_over` (sum over the axis; the backward is the identity):
  where the ranks' partial results join. It must not all-reduce in the
  backward, as ``torch.distributed.nn``'s does: every rank already holds
  the whole cotangent, and a second sum would scale it by the axis size;
- :func:`gather_dim` (concatenation of the ranks' slices along one dim;
  the backward keeps the rank's slice, with no communication).

:func:`all_reduce_sum` is the plain sum for values each rank holds only a
part of (a batch's statistics over rows split across 'data'): its backward
sums the cotangents as well, as ``SyncBatchNorm``'s does.

:class:`Axis` is a named mesh axis as this rank sees it; an absent axis (or
no mesh) has size 1, and its collectives are the identity. :class:`DataAxis`
adds what the trainers do over ``'data'``: each rank's rows of a batch and
of its noise, and the one reduction of the step's grads and loss.
"""
from typing import Optional, Sequence

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def check_mesh(mesh):
    """``mesh`` when it is None or a ``DeviceMesh``; else ``TypeError``."""
    from torch.distributed.device_mesh import DeviceMesh
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(
            "mesh must be a torch.distributed.device_mesh.DeviceMesh (see "
            "pyroved_tpu_torch.parallel.create_mesh), got "
            f"{type(mesh).__name__}")
    return mesh


def distributed() -> bool:
    """True when a process group of more than one rank is initialized."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def is_writer() -> bool:
    """True on the rank that writes files and prints: global rank 0, or the
    only process."""
    return not distributed() or dist.get_rank() == 0


def barrier() -> None:
    """Every rank waits here for the others (nothing without a group)."""
    if distributed():
        dist.barrier()


def row_slice(n: int, rank: int, size: int) -> slice:
    """Rows of ``rank`` when ``n`` rows split over ``size`` ranks as
    ``torch.tensor_split`` splits them: contiguous, the first ``n % size``
    ranks one row more."""
    q, r = divmod(int(n), int(size))
    lo = rank * q + min(rank, r)
    return slice(lo, lo + q + (1 if rank < r else 0))


def take_rows(eps, batch_size: int, rows: slice):
    """The noise of a batch's ``rows``: each tensor of ``eps`` (a tensor, a
    tuple with None entries, or None) holds its rows on dim -2, as ``P *
    batch_size`` rows tiled P-fold (particles) or ``batch_size`` rows."""
    if eps is None:
        return None
    if isinstance(eps, (tuple, list)):
        return tuple(take_rows(e, batch_size, rows) for e in eps)
    lead, R, w = eps.shape[:-2], eps.shape[-2], eps.shape[-1]
    P = R // batch_size
    out = eps.reshape(lead + (P, batch_size, w))[..., rows, :]
    return out.reshape(lead + (P * out.shape[-2], w))


def all_reduce_flat(tensors: Sequence[Tensor], group) -> list:
    """``tensors`` summed over ``group`` by one ``all_reduce`` of one flat
    buffer; returns the sums, shaped as the inputs."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [s.view_as(t) for s, t in zip(
        torch.split(flat, [t.numel() for t in tensors]), tensors)]


class Axis:
    """One named axis of a mesh as this rank sees it: ``group`` (None at
    size 1), ``rank`` on the axis and ``size``."""

    def __init__(self, mesh, name: str):
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        self.name = name
        if mesh is None or name not in names:
            self.group, self.rank, self.size = None, 0, 1
            return
        self.size = int(mesh.size(names.index(name)))
        self.rank = int(mesh.get_local_rank(name))
        self.group = mesh.get_group(name) if self.size > 1 else None

    def all_reduce(self, t: Tensor) -> Tensor:
        """``t`` summed over the axis (no autograd)."""
        if self.group is None:
            return t
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: Tensor) -> list:
        """The ranks' ``t`` in axis order (no autograd; equal shapes)."""
        if self.group is None:
            return [t]
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return parts


class DataAxis(Axis):
    """The axis a batch's rows split over (a trainer's ``'data'``): every
    rank gathers the whole batch and draws the whole batch's noise, in
    lockstep, then keeps its rows (:meth:`local`); after its backward, one
    ``all_reduce`` sums every parameter's grad and the loss
    (:meth:`reduce_grads`), and every rank takes the same optimizer
    step."""

    def __init__(self, mesh, name: str = "data"):
        super().__init__(check_mesh(mesh), name)

    def local(self, batch, weights: Tensor, eps):
        """(this rank's rows of ``batch``, of ``weights``, of ``eps``)."""
        if self.group is None:
            return batch, weights, eps
        B = batch[0].shape[0]
        rows = row_slice(B, self.rank, self.size)
        return (tuple(b[rows] for b in batch), weights[rows],
                take_rows(eps, B, rows))

    def reduce_grads(self, optimizer: torch.optim.Optimizer,
                     loss: Tensor) -> Tensor:
        """Sum the grad of every parameter of ``optimizer`` (a zero grad
        where it has none) and ``loss`` over the axis, in place; returns the
        summed loss, detached."""
        loss = loss.detach()
        if self.group is None:
            return loss
        params = [p for g in optimizer.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        *grads, loss = all_reduce_flat([p.grad for p in params] + [loss],
                                       self.group)
        for p, g in zip(params, grads):
            p.grad.copy_(g)
        return loss


# ---------------------------------------------------------------------------
# Collectives in the graph
# ---------------------------------------------------------------------------

class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *all_reduce_flat([g.contiguous() for g in gs],
                                       ctx.group))


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return None, g


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return None, g


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, rank, size, dim, x):
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.dim, ctx.lo, ctx.n = dim, rank * x.shape[dim], x.shape[dim]
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return None, None, None, None, g.narrow(ctx.dim, ctx.lo, ctx.n)


def replicated(axis: Axis, *xs: Tensor):
    """``xs`` unchanged; in the backward their cotangents are summed over
    ``axis`` (one ``all_reduce``). Returns a tuple."""
    if axis.group is None:
        return xs
    return _Replicated.apply(axis.group, *xs)


def sum_over(axis: Axis, x: Tensor) -> Tensor:
    """``x`` summed over ``axis``; the backward passes the cotangent
    through unchanged (it is whole on every rank)."""
    if axis.group is None:
        return x
    return _SumOver.apply(axis.group, x)


def all_reduce_sum(axis: Axis, x: Tensor) -> Tensor:
    """``x`` summed over ``axis``; the backward sums the cotangents over it
    too (each rank's loss holds only its rows' part)."""
    if axis.group is None:
        return x
    return _AllReduceSum.apply(axis.group, x)


def gather_dim(axis: Axis, x: Tensor, dim: int) -> Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in axis order (equal
    shapes); the backward keeps this rank's slice."""
    if axis.group is None:
        return x
    return _Gather.apply(axis.group, axis.rank, axis.size, dim % x.dim(), x)


def broadcast_tensors(tensors: Sequence[Tensor], src: int,
                      group: Optional[object] = None) -> None:
    """Overwrite ``tensors`` in place with global rank ``src``'s, by one
    ``broadcast`` of one flat buffer."""
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.broadcast(flat, src=src, group=group)
    with torch.no_grad():
        for t, s in zip(tensors, torch.split(flat, [t.numel()
                                                    for t in tensors])):
            t.copy_(s.view_as(t))
