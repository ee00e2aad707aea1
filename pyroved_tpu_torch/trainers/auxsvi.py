"""SVI trainer with an auxiliary supervised objective (semi-supervised
models).

Counterpart of ``pyroved_tpu/trainers/auxsvi.py`` for device-resident
loaders: an epoch walks the unlabeled batches and, after every p-th of
them, takes one labeled batch (``p = (n_sup + n_unsup) // n_sup``, at
``i % p == 1``; every step when p == 1). A labeled step is two updates: the
basic Adam over every network on the labeled ELBO, then a second Adam, of
its own, over ``encoder_y`` alone on the auxiliary loss, evaluated after
the first update. The reported epoch loss is the unlabeled losses' sum over
the unlabeled count. Accuracy (classification) or MSE (regression) on a
validation loader, and stochastic weight averaging of a sub-network.

Adam follows ``optax.adam``: every parameter steps at every update, by its
momentum where the loss does not reach it (a labeled batch's basic loss
does not reach ``encoder_y``), so that the step counts stay equal. The
noise comes from a ``torch.Generator`` on the model's device in the shapes
the model states (``noise_shapes``); :meth:`auxSVItrainer.draw_noise` is
where a test injects the JAX package's.
"""
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.data import DataLoader
from ..utils.nn import average_weights, later_slice
from .svi import _PendingLoss, draw_noise, fill_zero_grads, save_if_due

Tensor = torch.Tensor

_TRAINER_ITEM = "trainer surface"
# keywords of the JAX trainer that a later slice brings, with the values
# that mean "off"
_LATER_KWARGS = {"mesh": None, "grad_accum": 1, "log_file": None}
_LATER_RUN_KWARGS = ("patience", "on_segment", "enum_schedule")


class auxSVItrainer:
    """Trainer of ssiVAE and ss_reg_iVAE (the task comes from the model;
    ``task=`` overrides it).

    Args:
        model: a port model with ``nets`` (``encoder_y`` among them),
            ``weighted_loss_fn``, ``aux_loss_fn`` and ``noise_shapes``.
        optimizer: a ``torch.optim.Optimizer`` over ``model.nets``'
            parameters (default ``Adam(lr)``); the auxiliary optimizer is
            one of its type and defaults over ``encoder_y``'s.
        seed: seed of the noise.
        lr: learning rate of the default optimizers (5e-4).
        checkpoint_path: where to save the training state (both optimizers
            included), after every ``checkpoint_every``-th epoch (default
            10); :meth:`resume` restores it.

    ``mesh``, ``grad_accum`` and ``log_file`` raise ``NotImplementedError``
    naming their ROADMAP item.
    """

    def __init__(self, model, task: Optional[str] = None,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 seed: int = 1, **kwargs):
        task = task or getattr(model, "task", "classification")
        if task not in ("classification", "regression"):
            raise ValueError(
                "Choose between 'classification' and 'regression' tasks")
        lr = float(kwargs.pop("lr", 5e-4))
        for key, off in _LATER_KWARGS.items():
            if key in kwargs and kwargs.pop(key) != off:
                raise later_slice(f"auxSVItrainer({key}=...)", _TRAINER_ITEM)
        self.checkpoint_path = kwargs.pop("checkpoint_path", None)
        self.checkpoint_every = int(kwargs.pop("checkpoint_every", 10))
        if kwargs:
            raise TypeError(
                f"auxSVItrainer got unexpected keywords {sorted(kwargs)}")
        self.task = task
        self.model = model
        self.device = model.device
        aux_params = model.nets["encoder_y"].parameters()
        if optimizer is None:
            self.optimizer = torch.optim.Adam(model.nets.parameters(), lr=lr)
            self.aux_optimizer = torch.optim.Adam(aux_params, lr=lr)
        else:  # the same rule, with a state of its own
            self.optimizer = optimizer
            self.aux_optimizer = type(optimizer)(aux_params,
                                                 **optimizer.defaults)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.history = {"training_loss": [], "test": []}
        self.epoch_times = []
        self.current_epoch = 0
        self.running_weights: Dict[int, Dict[str, Tensor]] = {}

    # ------------------------------------------------------------------
    def draw_noise(self, batch_size: int, labeled: bool):
        """The noise of one unlabeled or labeled batch from the trainer's
        generator (``model.noise_shapes``)."""
        return draw_noise(self.model, self.generator, batch_size, labeled)

    def _update(self, optimizer: torch.optim.Optimizer, loss: Tensor) -> None:
        loss.backward()
        fill_zero_grads(optimizer)
        optimizer.step()

    def unsup_step(self, x: Tensor, weights: Tensor, beta=1.0,
                   eps=None) -> Tensor:
        """One basic Adam step on an unlabeled batch; returns its weighted
        loss (0-d, on the device, without waiting)."""
        if eps is None:
            eps = self.draw_noise(x.shape[0], False)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.model.weighted_loss_fn(x, None, weights, beta, eps=eps)
        self._update(self.optimizer, loss)
        return loss.detach()

    def sup_step(self, x: Tensor, y: Tensor, weights: Tensor, beta=1.0,
                 aux_loss_multiplier=20.0, eps=None) -> Tensor:
        """A labeled step: the basic Adam step on the labeled ELBO, then the
        auxiliary Adam step on ``encoder_y``; returns the sum of the two
        weighted losses."""
        if eps is None:
            eps = self.draw_noise(x.shape[0], True)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.model.weighted_loss_fn(x, y, weights, beta, eps=eps)
        self._update(self.optimizer, loss)
        self.aux_optimizer.zero_grad(set_to_none=True)
        aux = torch.sum(self.model.aux_loss_fn(x, y, aux_loss_multiplier)
                        * weights)
        self._update(self.aux_optimizer, aux)
        return loss.detach() + aux.detach()

    @staticmethod
    def _check_loaders(*loaders) -> None:
        for loader in loaders:
            if not isinstance(loader, DataLoader):
                raise later_slice(f"training on a {type(loader).__name__}",
                                  "trainer surface: streaming loaders")

    @staticmethod
    def _schedule(loader_unsup, loader_sup, nb: int, n_sup_rows: int,
                  sup_period=None):
        """The epoch's interleave: (mask [nb] bool, the labeled batch of
        each step [nb] int32). One labeled step every ``p = (n_sup +
        n_unsup) // n_sup`` unlabeled ones at ``i % p == 1``; with p == 1
        every step is labeled (the reference's cadence would never fire).
        ``sup_period`` sets p."""
        if sup_period is not None:
            p = max(int(sup_period), 1)
        else:
            p = ((len(loader_sup) + len(loader_unsup))
                 // max(len(loader_sup), 1))
        p = max(p, 1)
        sup_mask = np.asarray([p == 1 or i % p == 1 for i in range(nb)], bool)
        sup_j = np.zeros(nb, np.int32)
        sup_j[sup_mask] = np.arange(int(sup_mask.sum())) % n_sup_rows
        return sup_mask, sup_j

    def train(self, loader_unsup: DataLoader, loader_sup: DataLoader,
              **kwargs):
        """One epoch over the unlabeled loader, interleaving labeled batches;
        returns the unlabeled losses' sum over the unlabeled count.

        Keyword Args:
            scale_factor: KL scale beta (default 1).
            aux_loss_multiplier: weight of the auxiliary loss (default 20).
            sup_period: the labeled-step cadence p.
            sync: ``False`` returns a pending loss without waiting.
        """
        self._check_loaders(loader_unsup, loader_sup)
        beta = kwargs.get("scale_factor", 1.0)
        aux_mult = float(kwargs.get("aux_loss_multiplier", 20))
        idx_u, w_u = loader_unsup.epoch_indices()
        idx_s, w_s = loader_sup.epoch_indices()
        mask, sup_j = self._schedule(loader_unsup, loader_sup,
                                     idx_u.shape[0], idx_s.shape[0],
                                     kwargs.get("sup_period"))
        dev = loader_unsup.device
        iu, wu = torch.as_tensor(idx_u, device=dev), torch.as_tensor(w_u,
                                                                     device=dev)
        is_, ws = (torch.as_tensor(idx_s, device=loader_sup.device),
                   torch.as_tensor(w_s, device=loader_sup.device))
        losses = []
        for i in range(idx_u.shape[0]):
            (x,) = loader_unsup.gather(iu[i])
            losses.append(self.unsup_step(x, wu[i], beta))
            if mask[i]:
                j = int(sup_j[i])
                xs, ys = loader_sup.gather(is_[j])
                self.sup_step(xs, ys, ws[j], beta, aux_mult)
        total = torch.stack(losses).sum()
        norm = max(float(w_u.sum()), 1.0)
        if not kwargs.get("sync", True):
            return _PendingLoss(total, norm)
        return float(total) / norm

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, loader_val: DataLoader) -> float:
        """Accuracy (classification) or mean squared error (regression) of
        the ``encoder_y`` head on a labeled loader."""
        if self.task == "classification":
            return self.evaluate_cls(loader_val)
        return self.evaluate_reg(loader_val)

    @torch.no_grad()
    def evaluate_cls(self, loader_val: DataLoader) -> float:
        """Share of the rows whose predicted class is the label's."""
        correct, total = 0, 0
        for data, labels in loader_val:
            predicted = self.model.classifier(data)
            correct = correct + (predicted == labels.argmax(1)).sum()
            total += data.shape[0]
        return int(correct) / total

    @torch.no_grad()
    def evaluate_reg(self, loader_val: DataLoader) -> float:
        """Mean over batches of each batch's mean squared error."""
        total, batches = 0.0, 0
        for data, gt in loader_val:
            predicted = self.model.regressor(data)
            total = total + torch.mean((predicted - gt.reshape(
                predicted.shape)) ** 2)
            batches += 1
        return float(total) / max(batches, 1)

    def step(self, loader_unsup: DataLoader, loader_sup: DataLoader,
             loader_val: Optional[DataLoader] = None, **kwargs) -> None:
        """One training epoch (and an evaluation on ``loader_val``),
        appended to ``history``; keywords as :meth:`train`. With
        ``sync=False`` the training loss stays pending until
        :meth:`sync_history` (the evaluation waits regardless)."""
        t0 = time.perf_counter()
        self.history["training_loss"].append(
            self.train(loader_unsup, loader_sup, **kwargs))
        if loader_val is not None:
            self.history["test"].append(self.evaluate(loader_val))
        self.epoch_times.append(time.perf_counter() - t0)
        self.current_epoch += 1
        save_if_due(self)

    def run(self, loader_unsup: DataLoader, loader_sup: DataLoader,
            epochs: int, **kwargs) -> list:
        """Train ``epochs`` epochs; returns the per-epoch losses, also
        appended to ``history`` (and the metric on ``loader_val`` after
        every epoch to ``history["test"]``). The same as ``epochs`` calls of
        :meth:`step`, pipelined (``sync=False``) and read once at the end.

        Keyword Args:
            scale_factor: KL scale beta of every epoch.
            scale_schedule: per-epoch betas (length ``epochs``).
            aux_loss_multiplier, sup_period: as :meth:`train`.
            loader_val: labeled loader evaluated after every epoch.
        ``patience``, ``on_segment`` and ``enum_schedule`` raise
        ``NotImplementedError`` naming their ROADMAP item."""
        for key in _LATER_RUN_KWARGS:
            if kwargs.get(key) is not None:
                raise later_slice(f"auxSVItrainer.run({key}=...)",
                                  _TRAINER_ITEM)
        epochs = int(epochs)
        schedule = kwargs.get("scale_schedule")
        if schedule is not None and len(schedule) != epochs:
            raise ValueError(f"scale_schedule has {len(schedule)} entries for "
                             f"{epochs} epochs")
        step_kwargs = {k: kwargs[k] for k in ("aux_loss_multiplier",
                                              "sup_period") if k in kwargs}
        start = len(self.history["training_loss"])
        for e in range(epochs):
            sf = (schedule[e] if schedule is not None
                  else kwargs.get("scale_factor", 1.0))
            self.step(loader_unsup, loader_sup, kwargs.get("loader_val"),
                      scale_factor=sf, sync=False, **step_kwargs)
        self.sync_history()
        return self.history["training_loss"][start:]

    def sync_history(self) -> None:
        """Materialize every pending ``step(sync=False)`` loss."""
        for hist in self.history.values():
            for i, v in enumerate(hist):
                if not isinstance(v, float):
                    hist[i] = float(v)

    def resume(self, checkpoint_path: Optional[str] = None) -> int:
        """Restore the model, both optimizers, the noise generator, epoch
        and history from a checkpoint (``checkpoint_path``, else the
        trainer's own); returns the epoch to continue from. Loaders built
        afresh take it through ``set_epoch``."""
        from ..utils.checkpoint import load_checkpoint
        load_checkpoint(checkpoint_path or self.checkpoint_path, self.model,
                        self)
        return self.current_epoch

    # ------------------------------------------------------------------
    def save_running_weights(self, net: str = "encoder_y") -> None:
        """Snapshot a sub-network's weights for stochastic weight averaging,
        keyed by the current epoch."""
        self.running_weights[self.current_epoch] = {
            k: v.detach().clone()
            for k, v in self.model.nets[net].state_dict().items()}

    def average_weights(self, net: str = "encoder_y") -> None:
        """Load the average of the snapshots into the sub-network."""
        self.model.nets[net].load_state_dict(
            average_weights(self.running_weights))

    def print_statistics(self) -> None:
        """Prints the current epoch's loss and metric."""
        self.sync_history()
        e = self.current_epoch
        if len(self.history["test"]) > 0:
            metric = "accuracy" if self.task == "classification" else "MSE"
            print("Epoch: {} Training loss: {:.4f}, Test {}: {:.4f}".format(
                e, self.history["training_loss"][-1], metric,
                self.history["test"][-1]))
        else:
            print("Epoch: {} Training loss: {:.4f}".format(
                e, self.history["training_loss"][-1]))
