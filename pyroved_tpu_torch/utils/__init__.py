"""Coordinate math, NN helpers and the data loader."""
from ..infer.dists import get_sampler
from .coord import (generate_grid, generate_latent_grid, grid2xy, imcoordgrid,
                    rotate_coordinates, scale_coordinates,
                    transform_coordinates)
from .data import DataLoader, init_dataloader, shuffle_indices
from .nn import as_numpy, get_activation, resolve_device, set_deterministic_mode

__all__ = [
    "generate_grid", "generate_latent_grid", "grid2xy", "imcoordgrid",
    "rotate_coordinates", "scale_coordinates", "transform_coordinates",
    "DataLoader", "init_dataloader", "shuffle_indices",
    "as_numpy", "get_activation", "resolve_device", "set_deterministic_mode",
    "get_sampler",
]
