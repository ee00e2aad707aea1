"""Pixel-axis sharding for very large coordinate grids.

Counterpart of ``pyroved_tpu/parallel/spatial.py``. The spatial decoder's
"sequence" axis is the H*W pixel grid. Pixels are independent given z, so
the grid splits over a mesh axis with no ring communication: each rank
decodes its slice, and the per-example partial terms (or the decoded
slices) are joined by one collective.
"""
import torch

from .collectives import Axis, check_mesh


def shard_pixels(model, mesh, axis: str = "pixels"):
    """Enable pixel-sharded training on ``model``: every training-path
    reconstruction term splits the (padded, masked) grid over ``mesh``'s
    ``axis``, each rank decoding its N/n pixels through the kernels (K1,
    and K2 in the backward) or the module, and the per-example partial
    log-probs are summed over the axis. Exact: the observation
    log-density factorizes over pixels. Every rank holds the loss and every
    grad whole afterwards (``_recon_pixel_sharded``), so it composes with
    the trainers' ``mesh=`` data parallelism over another axis of the same
    mesh, and a trainer without a mesh trains each rank on the same rows.

    The decoder's ``[B, N, H]`` working set shrinks to ``[B, N/n, H]`` per
    rank. Every rank of the axis calls the model's losses together. Pass
    ``mesh=None`` to return to the full-grid paths. On one device,
    ``pixel_chunks=k`` bounds the working set the same way."""
    if mesh is None:
        model._pixel_mesh = None
        model._pixel_axis = None
        return model
    check_mesh(mesh)
    if getattr(model, "coord", 0) == 0:
        raise ValueError(
            "shard_pixels requires a spatial decoder (invariances=...)")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.mesh_dim_names}")
    model._pixel_mesh = mesh
    model._pixel_axis = axis
    return model


@torch.no_grad()
def pixel_sharded_decode(model, z, mesh, axis: str = "data"):
    """Decode content latents ``z [B, L]`` in the canonical pose with the
    grid split over ``mesh``'s ``axis``: each rank decodes its slice (the
    grid padded to a multiple of the axis size) through K1, or the module
    when the kernels are off, and the slices are gathered. Returns ``[B,
    N]`` (``[B, N, C]`` with channels) on the model's device, equal to
    ``model.decode``'s values. Every rank of the axis calls it."""
    check_mesh(mesh)
    if getattr(model, "coord", 0) == 0:
        raise ValueError("pixel_sharded_decode requires a spatial decoder")
    ax = Axis(mesh, axis)
    z = model._as_f32(z)
    N, D = model.grid.shape
    tile = -(-N // ax.size)
    grid = torch.cat([model.grid, model.grid.new_zeros(
        (tile * ax.size - N, D))])[ax.rank * tile:(ax.rank + 1) * tile]
    from ..models.base import posed_decode
    loc = posed_decode(model.decoder_net, grid, z, model._fused,
                       model.activation, model._dec_sig)
    return torch.cat(ax.all_gather(loc.contiguous()), dim=1)[:, :N]
