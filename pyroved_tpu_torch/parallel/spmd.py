"""Explicit-collective SPMD training step.

Counterpart of ``pyroved_tpu/parallel/spmd.py``. The trainers' ``mesh=``
keeps the single-device trajectory (every rank draws the whole batch's
noise); this step is the JAX package's ``shard_map`` step instead: each
rank draws its own rows' noise, and one hand-placed ``all_reduce`` sums the
grads and the loss, for users who want the collective in plain sight.
"""
import numpy as np
import torch

from .collectives import DataAxis, row_slice


def make_spmd_train_step(model, optimizer: torch.optim.Optimizer, mesh,
                         axis: str = "data", seed: int = 0):
    """Build ``step(batch, weights, beta=1.0, eps=None)``, one training
    step with the batch's rows split over ``mesh``'s ``axis``:

    * each rank keeps its contiguous rows of the whole batch (the row count
      must divide by the axis size) and computes the sum of their weighted
      per-example losses and its grads; its latent noise comes from a
      generator of its own, seeded by ``(seed, rank on the axis)``, or is
      ``eps``, the noise of its rows;
    * one ``all_reduce`` of one flat buffer sums the grads and the loss
      over the axis;
    * ``optimizer`` (over ``model.nets``' parameters) takes the same step
      on every rank.

    The JAX package's step is a function of ``(params, opt_state, rng,
    batch, weights, beta)`` returning ``(params, opt_state, loss)``; here
    the model and the optimizer hold the parameters and their state, the
    rank's generator takes the place of ``fold_in(rng, axis_index)``, and
    the step returns the summed loss (a 0-d tensor). The kernels' gate is
    checked when the step is built (a tensor-parallel decoder turns them
    off), as the JAX package's does."""
    from ..trainers.svi import apply_update, draw_noise, sync_gate
    sync_gate(model)
    ax = DataAxis(mesh, axis)
    state = np.random.SeedSequence([int(seed), ax.rank]).generate_state(1)
    generator = torch.Generator(device=model.device)
    generator.manual_seed(int(state[0]))

    def step(batch, weights, beta=1.0, eps=None):
        B = batch[0].shape[0]
        if B % ax.size:
            raise ValueError(f"the batch's {B} rows do not divide over the "
                             f"{ax.size} ranks of axis {axis!r}")
        rows = row_slice(B, ax.rank, ax.size)
        x, *rest = (model._as_f32(b)[rows] for b in batch)
        w = model._as_f32(weights)[rows]
        if eps is None:
            eps = draw_noise(model, generator, x.shape[0])
        optimizer.zero_grad(set_to_none=True)
        loss = model.weighted_loss_fn(x, rest[0] if rest else None, w, beta,
                                      eps=eps)
        loss.backward()
        loss = ax.reduce_grads(optimizer, loss)
        apply_update(optimizer, None)
        return loss

    return step
