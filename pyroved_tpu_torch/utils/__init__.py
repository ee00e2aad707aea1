"""Coordinate math, NN helpers and the data loader."""
from ..infer.dists import get_sampler
from .checkpoint import (load_checkpoint, save_checkpoint,
                         wait_for_checkpoints)
from .coord import (generate_grid, generate_latent_grid,
                    generate_latent_grid_traversal, grid2xy, imcoordgrid,
                    rotate_coordinates, scale_coordinates,
                    transform_coordinates)
from .data import (DataLoader, init_dataloader, init_ssvae_dataloaders,
                   prefetch, shuffle_indices)
from .nn import (as_numpy, average_weights, get_activation, resolve_device,
                 set_deterministic_mode, to_onehot)

__all__ = [
    "generate_grid", "generate_latent_grid", "generate_latent_grid_traversal",
    "grid2xy", "imcoordgrid",
    "rotate_coordinates", "scale_coordinates", "transform_coordinates",
    "DataLoader", "init_dataloader", "init_ssvae_dataloaders", "prefetch",
    "shuffle_indices", "as_numpy", "average_weights", "get_activation",
    "resolve_device", "set_deterministic_mode", "to_onehot",
    "get_sampler", "save_checkpoint", "load_checkpoint",
    "wait_for_checkpoints",
]
