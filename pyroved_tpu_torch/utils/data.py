"""Input pipeline: device-resident datasets with seeded shuffling.

Counterpart of ``pyroved_tpu/utils/data.py``. The whole dataset is copied to
the device once. Each epoch is a permutation of row indices, computed on
the host and keyed by (seed, epoch) exactly as the JAX package keys it (the
splitmix64 Fisher-Yates of ``native/pvt_native.cpp``), so both packages
visit the rows in the same order. Trainers upload the epoch's
``[num_batches, batch_size]`` indices once and gather each batch on the
device with ``index_select``.

The trailing partial batch is padded with index 0 and weight 0, so every
step has the same shape and the padding adds nothing to the loss.
"""
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from .nn import as_numpy, later_slice, resolve_device

Tensor = torch.Tensor

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_STREAMING = "trainer surface: streaming loaders"


def shuffle_indices(n: int, seed: int, epoch: int) -> np.ndarray:
    """Permutation of [0, n) keyed by (seed, epoch): the Fisher-Yates
    shuffle driven by splitmix64 of ``native/pvt_native.cpp``
    (``pvt_shuffle_indices``), as int32. The random draws are computed
    vectorized (splitmix64's state advances by a constant); the swaps run
    in a Python loop, about 0.5 us per row."""
    out = np.arange(n, dtype=np.int32)
    if n < 2:
        return out
    state0 = (int(seed) * _GOLDEN + int(epoch) + 1) & _MASK64
    steps = np.arange(1, n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        zz = np.uint64(state0) + steps * np.uint64(_GOLDEN)
        zz = (zz ^ (zz >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        zz = (zz ^ (zz >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        zz = zz ^ (zz >> np.uint64(31))
    bound = np.arange(n, 1, -1, dtype=np.uint64)  # i + 1 for i = n-1 .. 1
    swaps = (zz % bound).tolist()
    perm = out.tolist()
    for i, r in zip(range(n - 1, 0, -1), swaps):
        perm[i], perm[r] = perm[r], perm[i]
    return np.asarray(perm, np.int32)


class DataLoader:
    """Mini-batch loader over arrays that live on ``device`` (None means
    "cuda"; without CUDA pass ``device="cpu"``).

    Iterating yields tuples of device tensors (the final batch may be
    short). Trainers use the padded path: :attr:`device_arrays`,
    :meth:`epoch_indices` and :meth:`gather`. ``scale=s`` keeps the first
    array in its stored dtype on the device (a uint8 image stack stays
    uint8) and casts each gathered batch to float32 times ``s``; a tuple
    gives one entry per array (None leaves it alone)."""

    def __init__(self, *arrays, batch_size: int = 100, shuffle: bool = True,
                 seed: int = 0, device_resident: bool = True,
                 stream_chunks: int = 0, scale=None, store_dtype=None,
                 device=None):
        if not device_resident:
            raise later_slice("DataLoader(device_resident=False)", _STREAMING)
        if stream_chunks:
            raise later_slice("DataLoader(stream_chunks=...)", _STREAMING)
        if store_dtype is not None:
            raise later_slice("DataLoader(store_dtype=...)", _STREAMING)
        if not arrays:
            raise ValueError("At least one data array is required")
        host = [as_numpy(a) for a in arrays]
        n = host[0].shape[0]
        if any(a.shape[0] != n for a in host):
            raise ValueError("All arrays must share the leading dimension")
        if isinstance(scale, (tuple, list)):
            if len(scale) != len(host):
                raise ValueError(
                    f"scale has {len(scale)} entries for {len(host)} arrays")
            scale = tuple(None if s is None else float(s) for s in scale)
        elif scale is not None:
            scale = (float(scale),) + (None,) * (len(host) - 1)
        self.device = resolve_device(device)
        self.scale = scale
        self.dataset_size = n
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self._epoch = 0
        scales = scale or (None,) * len(host)
        # scaled arrays keep their stored dtype; other floats become f32
        self.device_arrays: Tuple[Tensor, ...] = tuple(
            torch.as_tensor(a if s is not None or a.dtype.kind != "f"
                            else a.astype(np.float32, copy=False),
                            device=self.device)
            for a, s in zip(host, scales))

    @property
    def num_batches(self) -> int:
        return -(-self.dataset_size // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Set the loader's epoch counter, which keys the next epoch's
        permutation: a loader built afresh for a resumed run takes the
        trainer's ``current_epoch`` to visit the rows as the uninterrupted
        run would have."""
        self._epoch = int(epoch)

    def epoch_indices(self, epoch=None) -> Tuple[np.ndarray, np.ndarray]:
        """Permuted, padded row indices ``[num_batches, batch_size]``
        (int32) and weights of the same shape (float32, 0 marks padding)
        for one epoch; without ``epoch`` the loader's own counter is used
        and advanced."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        if self.shuffle:
            perm = shuffle_indices(self.dataset_size, self.seed, epoch)
        else:
            perm = np.arange(self.dataset_size, dtype=np.int32)
        pad = self.num_batches * self.batch_size - self.dataset_size
        weights = np.ones(self.dataset_size, np.float32)
        if pad:
            perm = np.concatenate([perm, np.zeros(pad, perm.dtype)])
            weights = np.concatenate([weights, np.zeros(pad, np.float32)])
        idx = perm.reshape(self.num_batches, self.batch_size).astype(np.int32)
        return idx, weights.reshape(self.num_batches, self.batch_size)

    def gather(self, rows: Tensor) -> Tuple[Tensor, ...]:
        """The batch at device indices ``rows``, with ``scale`` applied
        (an on-device float32 cast and multiply)."""
        batch = tuple(a.index_select(0, rows) for a in self.device_arrays)
        if self.scale is None:
            return batch
        return tuple(b if s is None else b.to(torch.float32) * s
                     for b, s in zip(batch, self.scale))

    def __iter__(self) -> Iterator[Tuple[Tensor, ...]]:
        if self.shuffle:
            order = shuffle_indices(self.dataset_size, self.seed, self._epoch)
            self._epoch += 1
        else:
            order = np.arange(self.dataset_size, dtype=np.int32)
        order = torch.as_tensor(order, device=self.device)
        for start in range(0, self.dataset_size, self.batch_size):
            yield self.gather(order[start:start + self.batch_size])

    def __len__(self) -> int:
        return self.num_batches


def init_dataloader(*args, random_sampler: bool = False, shuffle: bool = True,
                    **kwargs) -> DataLoader:
    """Counterpart of the JAX package's ``init_dataloader``:
    ``random_sampler`` maps to shuffling; every other keyword
    (``batch_size``, ``seed``, ``scale``, ``device``) goes to
    :class:`DataLoader`."""
    return DataLoader(*args, shuffle=shuffle or random_sampler, **kwargs)


def init_ssvae_dataloaders(data_unsup, data_sup: Sequence, data_val: Sequence,
                           **kwargs) -> Tuple[DataLoader, DataLoader,
                                              DataLoader]:
    """Unlabeled, labeled and validation loaders of a semi-supervised model,
    as the JAX package builds them: the labeled loader always shuffles, and
    ``scale=(x_scale, y_scale)`` is refitted to each loader (the unlabeled
    one holds X only). Other keywords (``batch_size``, ``seed``,
    ``device``) go to every loader."""
    scale = kwargs.pop("scale", None)
    if isinstance(scale, (tuple, list)):
        x_scale = scale[0]
        y_scale = scale[1] if len(scale) > 1 else None
    else:
        x_scale, y_scale = scale, None
    pair_scale = (None if x_scale is None and y_scale is None
                  else (x_scale, y_scale))
    loader_unsup = init_dataloader(data_unsup, scale=x_scale, **kwargs)
    loader_sup = init_dataloader(*data_sup, random_sampler=True,
                                 scale=pair_scale, **kwargs)
    loader_val = init_dataloader(*data_val, scale=pair_scale, **kwargs)
    return loader_unsup, loader_sup, loader_val
