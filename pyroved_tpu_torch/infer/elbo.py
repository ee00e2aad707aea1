"""Reparameterized ELBO building blocks.

Counterpart of ``pyroved_tpu/infer/elbo.py``. Helpers return positive
contributions to the ELBO; ``beta`` scales a latent site's prior and guide
terms together, as ``poutine.scale`` does in Pyro.
"""
from typing import Optional, Tuple

import torch

from . import dists

Tensor = torch.Tensor


class TraceELBO:
    """Estimator settings for the trainer's ``loss=`` argument, as Pyro's
    ``Trace_ELBO``: ``SVItrainer(model, loss=TraceELBO(num_particles=4,
    kl='analytic'))`` sets them on the model."""

    def __init__(self, num_particles: int = 1, kl: str = "mc"):
        if kl not in ("mc", "analytic"):
            raise ValueError("kl must be 'mc' or 'analytic'")
        self.num_particles = int(num_particles)
        self.kl = kl

    def configure(self, model) -> None:
        model.kl_mode = self.kl
        if hasattr(model, "num_particles"):
            model.num_particles = self.num_particles


def normal_latent_site(loc: Tensor, scale: Tensor, beta=1.0, kl: str = "mc",
                       eps: Optional[Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[Tensor, Tensor]:
    """Sample ``z ~ N(loc, scale)`` and return ``(z, contribution)``.

    The contribution is ``beta * (log p(z) - log q(z))`` with p = N(0, I),
    summed over the last dim. ``kl='analytic'`` uses the closed-form KL
    instead of the one-sample estimate. An injected ``eps`` (standard-normal
    noise shaped like ``loc``) is used as is; otherwise it is drawn from
    ``generator``."""
    if eps is None:
        z = dists.normal_sample(loc, scale, generator)
    else:
        z = loc + scale * eps.to(device=loc.device, dtype=loc.dtype)
    if kl == "analytic":
        neg_kl = -torch.sum(dists.normal_kl(loc, scale), dim=-1)
    else:
        neg_kl = torch.sum(
            dists.std_normal_log_prob(z) - dists.normal_log_prob(z, loc, scale),
            dim=-1)
    return z, beta * neg_kl


def obs_site(obs_model: dists.ObsModel, x: Tensor, loc: Tensor) -> Tensor:
    """Observation term: ``log p(x | loc)`` summed over the last dim."""
    return torch.sum(obs_model.log_prob(x, loc), dim=-1)
