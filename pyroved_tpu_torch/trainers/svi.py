"""Stochastic variational inference trainer.

Counterpart of ``pyroved_tpu/trainers/svi.py`` with the same surface:
``train`` / ``evaluate`` / ``step`` / ``run`` / ``print_statistics`` /
``loss_history``, each step minimizing the weighted SUM of per-example
negative ELBOs and each epoch's loss normalized by the dataset size.

The JAX trainer runs an epoch as one compiled ``lax.scan``. Here an epoch
is a Python loop over batches gathered on the device from a
device-resident :class:`~pyroved_tpu_torch.utils.data.DataLoader`: the
epoch's indices are uploaded once, the per-step losses stay on the device,
and the host reads them once, at the end of the epoch. Optimization is
``torch.optim.Adam(lr=1e-3)`` (betas 0.9/0.999, eps 1e-8, as
``optax.adam``). The latent noise comes from a ``torch.Generator`` on the
model's device seeded from ``seed``, in the shapes the model states
(``noise_shapes``); it cannot reproduce JAX's random bits, so
:meth:`SVItrainer.train_step` also takes injected noise. A model with
``prep_beta`` (jiVAE) takes the KL scale as a ``[beta_cont, beta_disc]``
pair.
"""
import time
from typing import Optional

import torch

from ..utils.data import DataLoader
from ..utils.nn import later_slice

Tensor = torch.Tensor

_TRAINER_ITEM = "trainer surface"
# keywords of the JAX trainer that a later slice brings, with the values
# that mean "off"
_LATER_KWARGS = {"mesh": None, "grad_accum": 1, "remat": False,
                 "checkpoint_path": None, "log_file": None}
_LATER_RUN_KWARGS = ("patience", "on_segment", "enum_schedule")


def draw_noise(model, generator: torch.Generator, batch_size: int,
               labeled: bool = False):
    """Standard-normal noise of one batch of ``batch_size`` rows from
    ``generator``, in the shapes ``model.noise_shapes`` states: one tensor,
    or a tuple when the model needs several (None where it needs none)."""
    eps = tuple(None if s is None else
                torch.randn(s, generator=generator, device=generator.device)
                for s in model.noise_shapes(batch_size, labeled))
    return eps[0] if len(eps) == 1 else eps


def fill_zero_grads(optimizer: torch.optim.Optimizer) -> None:
    """A zero grad for every parameter that got none, so that the step
    moves it by its momentum and advances its count, as ``optax.adam``
    updates every leaf at every step (``torch.optim.Adam`` skips a
    parameter whose grad is None)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


class _PendingLoss:
    """A queued epoch loss from ``step(sync=False)``: the 0-d device total
    and the host normalizer. ``float()`` waits for the device and divides
    on the host in float64, exactly as the synchronous path does."""
    __slots__ = ("total", "norm")

    def __init__(self, total: Tensor, norm: int):
        self.total, self.norm = total, norm

    def __float__(self) -> float:
        return float(self.total) / self.norm

    def __repr__(self) -> str:
        return f"_PendingLoss(norm={self.norm})"


class SVItrainer:
    """Epoch-level SVI trainer for one-encoder/one-decoder models.

    Args:
        model: a port model with ``nets``, ``device`` and
            ``weighted_loss_fn(x, y, weights, beta, eps=None)``.
        optimizer: a ``torch.optim.Optimizer`` over ``model.nets``'
            parameters (default ``Adam(lr)``).
        loss: a :class:`~pyroved_tpu_torch.infer.elbo.TraceELBO` whose
            settings are applied to the model.
        enumerate_parallel: accepted for the JAX package's signature.
        seed: seed of the latent noise.
        lr: learning rate of the default optimizer (1e-3).

    ``mesh``, ``grad_accum``, ``remat``, ``checkpoint_path`` and
    ``log_file`` raise ``NotImplementedError`` naming their ROADMAP item.
    """

    def __init__(self, model, optimizer: Optional[torch.optim.Optimizer] = None,
                 loss=None, enumerate_parallel: bool = False, seed: int = 1,
                 **kwargs):
        del enumerate_parallel  # enumeration lives in the models' loss_fn
        lr = float(kwargs.pop("lr", 1e-3))
        for key, off in _LATER_KWARGS.items():
            if key in kwargs and kwargs.pop(key) != off:
                raise later_slice(f"SVItrainer({key}=...)", _TRAINER_ITEM)
        if kwargs:
            raise TypeError(f"SVItrainer got unexpected keywords {sorted(kwargs)}")
        if loss is not None:
            loss.configure(model)
        self.model = model
        self.device = model.device
        self.optimizer = (optimizer if optimizer is not None
                          else torch.optim.Adam(model.nets.parameters(), lr=lr))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.loss_history = {"training_loss": [], "test_loss": []}
        self.epoch_times = []
        self.current_epoch = 0

    # ------------------------------------------------------------------
    def _noise(self, batch_size: int):
        """The latent noise of one batch (``model.noise_shapes``)."""
        return draw_noise(self.model, self.generator, batch_size)

    def _prep_beta(self, scale_factor):
        """The KL scale as the model takes it (a pair for jiVAE)."""
        prep = getattr(self.model, "prep_beta", None)
        return scale_factor if prep is None else prep(scale_factor)

    def train_step(self, batch, weights: Tensor, beta=1.0,
                   eps: Optional[Tensor] = None) -> Tensor:
        """One Adam step on ``sum_b weights_b * (-ELBO_b)`` of ``batch``
        (``(x,)`` or ``(x, y)``, tensors on the model's device). ``eps`` is
        the latent noise; it is drawn from the trainer's generator when not
        given. Returns the loss as a 0-d device tensor, without waiting."""
        x = batch[0]
        y = batch[1] if len(batch) > 1 else None
        if eps is None:
            eps = self._noise(x.shape[0])
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.model.weighted_loss_fn(x, y, weights, beta, eps=eps)
        loss.backward()
        fill_zero_grads(self.optimizer)
        self.optimizer.step()
        return loss.detach()

    @staticmethod
    def _check_loader(loader) -> DataLoader:
        if not isinstance(loader, DataLoader):
            raise later_slice(f"training on a {type(loader).__name__}",
                              "trainer surface: streaming loaders")
        return loader

    def _epoch(self, loader: DataLoader, scale_factor, train: bool) -> Tensor:
        """Sum of the epoch's batch losses as a 0-d device tensor."""
        beta = self._prep_beta(scale_factor)
        idx, w = loader.epoch_indices()
        idx = torch.as_tensor(idx, device=loader.device)
        w = torch.as_tensor(w, device=loader.device)
        losses = []
        for i in range(idx.shape[0]):
            batch = loader.gather(idx[i])
            if train:
                losses.append(self.train_step(batch, w[i], beta))
                continue
            x = batch[0]
            y = batch[1] if len(batch) > 1 else None
            with torch.no_grad():
                losses.append(self.model.weighted_loss_fn(
                    x, y, w[i], beta, eps=self._noise(x.shape[0])))
        return torch.stack(losses).sum()

    def train(self, train_loader: DataLoader, **kwargs):
        """One training epoch; returns loss / dataset_size.

        ``scale_factor`` is the KL scale beta (default 1). ``sync=False``
        returns a pending loss handle without waiting for the device; call
        :meth:`sync_history` or ``float()`` on it."""
        loader = self._check_loader(train_loader)
        total = self._epoch(loader, kwargs.get("scale_factor", 1.0), True)
        if not kwargs.get("sync", True):
            return _PendingLoss(total, loader.dataset_size)
        return float(total) / loader.dataset_size

    def evaluate(self, test_loader: DataLoader, **kwargs):
        """Loss over a held-out set, with no parameter update; keywords as
        :meth:`train`."""
        loader = self._check_loader(test_loader)
        total = self._epoch(loader, kwargs.get("scale_factor", 1.0), False)
        if not kwargs.get("sync", True):
            return _PendingLoss(total, loader.dataset_size)
        return float(total) / loader.dataset_size

    def step(self, train_loader: DataLoader,
             test_loader: Optional[DataLoader] = None, **kwargs) -> None:
        """One epoch of training (and evaluation), appended to
        ``loss_history``. With ``sync=False`` the history holds pending
        handles until :meth:`sync_history`, and ``epoch_times`` measures
        the host's dispatch time."""
        t0 = time.perf_counter()
        self.loss_history["training_loss"].append(
            self.train(train_loader, **kwargs))
        if test_loader is not None:
            self.loss_history["test_loss"].append(
                self.evaluate(test_loader, **kwargs))
        self.epoch_times.append(time.perf_counter() - t0)
        self.current_epoch += 1

    def run(self, train_loader: DataLoader, epochs: int, **kwargs) -> list:
        """Train ``epochs`` epochs; returns the per-epoch losses, also
        appended to ``loss_history``. The same as ``epochs`` calls of
        :meth:`step`, pipelined (``sync=False``) and read once at the end.

        Keyword Args:
            scale_factor: KL scale beta of every epoch.
            scale_schedule: per-epoch betas (length ``epochs``).
            test_loader: held-out loader evaluated after every epoch.
        ``patience``, ``on_segment`` and ``enum_schedule`` raise
        ``NotImplementedError`` naming their ROADMAP item."""
        for key in _LATER_RUN_KWARGS:
            if kwargs.get(key) is not None:
                raise later_slice(f"SVItrainer.run({key}=...)", _TRAINER_ITEM)
        epochs = int(epochs)
        schedule = kwargs.get("scale_schedule")
        if schedule is not None and len(schedule) != epochs:
            raise ValueError(f"scale_schedule has {len(schedule)} entries for "
                             f"{epochs} epochs")
        test_loader = kwargs.get("test_loader")
        start = len(self.loss_history["training_loss"])
        for e in range(epochs):
            sf = (schedule[e] if schedule is not None
                  else kwargs.get("scale_factor", 1.0))
            self.step(train_loader, test_loader, scale_factor=sf, sync=False)
        self.sync_history()
        return self.loss_history["training_loss"][start:]

    def sync_history(self) -> None:
        """Materialize every pending ``step(sync=False)`` loss."""
        for hist in self.loss_history.values():
            for i, v in enumerate(hist):
                if not isinstance(v, float):
                    hist[i] = float(v)

    def print_statistics(self) -> None:
        """Prints the current epoch's losses."""
        self.sync_history()
        e = self.current_epoch
        if len(self.loss_history["test_loss"]) > 0:
            print("Epoch: {} Training loss: {:.4f}, Test loss: {:.4f}".format(
                e, self.loss_history["training_loss"][-1],
                self.loss_history["test_loss"][-1]))
        else:
            print("Epoch: {} Training loss: {:.4f}".format(
                e, self.loss_history["training_loss"][-1]))
