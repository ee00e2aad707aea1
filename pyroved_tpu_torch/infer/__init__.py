"""Distributions and ELBO building blocks."""
from . import dists, elbo
from .dists import get_sampler
from .elbo import TraceELBO, normal_latent_site, obs_site

__all__ = ["dists", "elbo", "get_sampler", "TraceELBO", "normal_latent_site",
           "obs_site"]
