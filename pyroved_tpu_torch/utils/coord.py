"""Coordinate grids and batched affine transforms.

Counterpart of ``pyroved_tpu/utils/coord.py``, with the same sign
conventions: xx runs -1..1, yy runs 1..-1, 1-D grids run 1..-1, and the
rotation matrix ``[[cos, sin], [-sin, cos]]`` is applied as ``coord @ R``.
"""
import math
from typing import Sequence, Tuple, Union

import torch

Tensor = torch.Tensor


def grid2xy(x1: Tensor, x2: Tensor) -> Tensor:
    """Stacks two meshgrid planes into an ``[H*W, 2]`` coordinate list."""
    return torch.stack([x1, x2], dim=0).reshape(2, -1).T


def imcoordgrid(im_dim: Sequence[int], device=None) -> Tensor:
    """2-D image coordinate grid on [-1, 1] x [1, -1]."""
    xx = torch.linspace(-1.0, 1.0, im_dim[0], device=device)
    yy = torch.linspace(1.0, -1.0, im_dim[1], device=device)
    x0, x1 = torch.meshgrid(xx, yy, indexing="ij")
    return grid2xy(x0, x1).contiguous()


def generate_grid(data_dim: Sequence[int], device=None) -> Tensor:
    """A 1-D or 2-D coordinate grid of shape ``[N, ndim]``."""
    if len(data_dim) not in (1, 2):
        raise NotImplementedError("Currently supports only 1D and 2D data")
    if len(data_dim) == 1:
        return torch.linspace(1.0, -1.0, data_dim[0], device=device)[:, None]
    return imcoordgrid(data_dim, device)


def rotate_coordinates(coord: Tensor, phi: Union[Tensor, float]) -> Tensor:
    """Batched 2-D rotation ``coord @ [[c, s], [-s, c]]``.

    ``coord`` is ``[..., N, 2]``; ``phi`` is ``[...]`` (radians)."""
    phi = torch.as_tensor(phi, dtype=coord.dtype, device=coord.device)
    c = torch.cos(phi)[..., None]
    s = torch.sin(phi)[..., None]
    x, y = coord[..., 0], coord[..., 1]
    return torch.stack([x * c - y * s, x * s + y * c], dim=-1)


def scale_coordinates(coord: Tensor, scale: Union[Tensor, float]) -> Tensor:
    """Batched isotropic scaling; ``scale`` is ``[...]``."""
    scale = torch.as_tensor(scale, dtype=coord.dtype, device=coord.device)
    return coord * scale[..., None, None]


def transform_coordinates(coord: Tensor, phi=0.0, coord_dx=0.0,
                          scale=1.0) -> Tensor:
    """Rotate, scale, then translate a batch of grids ``[..., N, D]``.

    For 1-D grids only the translation applies. ``coord_dx`` broadcasts
    against ``[..., N, D]`` (pass ``[..., 1, D]`` for a per-sample shift)."""
    if coord.shape[-1] == 1:
        return coord + coord_dx
    coord = rotate_coordinates(coord, phi)
    coord = scale_coordinates(coord, scale)
    return coord + coord_dx


def _norm_icdf(q: Tensor) -> Tensor:
    """Standard-normal inverse CDF (probit)."""
    return math.sqrt(2.0) * torch.special.erfinv(2.0 * q - 1.0)


def generate_latent_grid(d: Union[int, Sequence[int]], **kwargs
                         ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """``d x d`` grid over the 2-D latent plane, ``[d0*d1, 2]`` float32.

    Default bounds are the standard-normal quantiles 0.95 -> 0.05 along x
    and 0.05 -> 0.95 along y; ``z_coord=[z1, z2, z3, z4]`` sets them."""
    if isinstance(d, int):
        d = [d, d]
    z_coord = kwargs.get("z_coord")
    if z_coord:
        z1, z2, z3, z4 = z_coord
        grid_x = torch.linspace(z2, z1, d[0])
        grid_y = torch.linspace(z3, z4, d[1])
    else:
        grid_x = _norm_icdf(torch.linspace(0.95, 0.05, d[0]))
        grid_y = _norm_icdf(torch.linspace(0.05, 0.95, d[1]))
    xx, yy = torch.meshgrid(grid_x, grid_y, indexing="ij")
    z = torch.stack([xx.ravel(), yy.ravel()], dim=-1).float()
    return z, (grid_x, grid_y)


def generate_latent_grid_traversal(d: int, cont_dim: int, disc_dim: int,
                                   cont_idx: int, cont_idx_fixed: float,
                                   num_samples: int
                                   ) -> Tuple[Tensor, Tensor]:
    """Latents of a joint traversal: ``[num_samples, cont_dim]`` continuous
    rows, all ``cont_idx_fixed`` but column ``cont_idx``, which sweeps the
    standard-normal quantiles 0.95 -> 0.05 (row i*d + j takes the j-th),
    and ``[d*d, disc_dim]`` one-hot rows, block i (d rows) of class
    ``i % disc_dim``."""
    cont = _norm_icdf(torch.linspace(0.95, 0.05, d))
    samples_cont = torch.full((num_samples, cont_dim), float(cont_idx_fixed))
    samples_cont[:, cont_idx] = cont.repeat(num_samples // d + 1)[:num_samples]
    classes = torch.arange(d) % disc_dim
    samples_disc = torch.zeros(d, d, disc_dim)
    samples_disc[torch.arange(d), :, classes] = 1.0
    return samples_cont, samples_disc.reshape(d * d, disc_dim)
