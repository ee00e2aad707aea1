"""Parallelism over many devices: data, tensor and pixel parallelism and
an explicit SPMD step.

Counterpart of ``pyroved_tpu/parallel``. The JAX package runs one process
over many devices and lets GSPMD place the collectives. The port runs one
process, a rank, per device, and maps one device of the JAX package's mesh
to one rank: :func:`initialize_multihost` joins the ranks (from
``torchrun``'s environment, an address, or this process alone), and
:func:`create_mesh` names them with a ``torch.distributed`` ``DeviceMesh``
whose axes are the JAX package's (``'data'``, ``'model'``, ``'pixels'``).

The semantics kept are the JAX package's: data-parallel training equals
single-device training. So every rank builds the same loader and model
from the same seeds, gathers the whole batch, draws the whole batch's
noise from the trainer's generator in lockstep with the others, and keeps
its contiguous rows (``tensor_split``: uneven splits are fine, padded rows
keep weight 0); each rank's loss is its rows' weighted sum; after the
backward one ``all_reduce(SUM)`` of one flat buffer of every grad (and the
loss) gives every rank the whole batch's grads, and every rank takes the
same Adam step. Under ``grad_accum`` each micro-step's grads are summed
before they enter the window, as ``optax.MultiSteps`` over GSPMD's
already-reduced grads. :func:`make_spmd_train_step` alone draws each
rank's noise from a generator of its own, as the JAX step folds its key by
the axis index.

``DistributedDataParallel`` is not used: it averages the grads where the
JAX package sums them, its bucket hooks fire inside the
``torch.utils.checkpoint`` tiles of ``pixel_chunks``, and its ``no_sync``
would be a second accumulation beside the trainers' ``GradAccumulator``.
One explicit reduction is one line a reader can audit.

Only ``all_reduce``, ``broadcast`` and the list form of ``all_gather`` are
used, which gloo runs on CPU and CUDA tensors and NCCL on CUDA tensors.
The backend is the caller's, or follows the device: NCCL for "cuda" (one
rank per card), gloo for "cpu". Nothing falls back: a backend that fails
to start raises. Tensor parallelism (:func:`tensor_parallel_params`) and
pixel sharding (:func:`shard_pixels`) put their collectives in the model's
graph (:mod:`.collectives`), so that every rank holds the loss and every
grad whole after the backward.
"""
from .mesh import (create_mesh, data_parallel_mesh, initialize_multihost,
                   replicate_params, tensor_parallel_params)
from .spatial import pixel_sharded_decode, shard_pixels
from .spmd import make_spmd_train_step

__all__ = ["create_mesh", "data_parallel_mesh", "initialize_multihost",
           "replicate_params",
           "tensor_parallel_params", "pixel_sharded_decode", "shard_pixels",
           "make_spmd_train_step"]
