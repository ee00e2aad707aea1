"""Coordinate math, NN helpers and layer factories, the data loader,
checkpoints, plots, the GP surrogate and profiling."""
from ..infer.dists import get_sampler
from .checkpoint import (load_checkpoint, save_checkpoint,
                         wait_for_checkpoints)
from .coord import (generate_grid, generate_latent_grid,
                    generate_latent_grid_traversal, grid2xy, imcoordgrid,
                    rotate_coordinates, scale_coordinates,
                    transform_coordinates)
from .data import (DataLoader, init_dataloader, init_ssvae_dataloaders,
                   prefetch, shuffle_indices)
from .gp import GPRegression, gp_model
from .nn import (Concat, as_numpy, average_weights, concat_features,
                 get_activation, get_bnorm, get_conv, get_maxpool,
                 resolve_device, set_deterministic_mode, to_onehot)
from .profiling import Timer, trace
from .viz import (make_img_grid, plot_grid_traversal, plot_img_grid,
                  plot_latent_predictions, plot_spect_grid)

__all__ = [
    "generate_grid", "generate_latent_grid", "generate_latent_grid_traversal",
    "grid2xy", "imcoordgrid",
    "rotate_coordinates", "scale_coordinates", "transform_coordinates",
    "DataLoader", "init_dataloader", "init_ssvae_dataloaders", "prefetch",
    "shuffle_indices", "as_numpy", "average_weights", "get_activation",
    "resolve_device", "set_deterministic_mode", "to_onehot",
    "get_bnorm", "get_conv", "get_maxpool", "concat_features", "Concat",
    "Timer", "trace",
    "get_sampler", "save_checkpoint", "load_checkpoint",
    "wait_for_checkpoints", "GPRegression", "gp_model", "make_img_grid",
    "plot_img_grid", "plot_spect_grid", "plot_grid_traversal",
    "plot_latent_predictions",
]
