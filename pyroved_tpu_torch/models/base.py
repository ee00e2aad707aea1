"""Base class for the variational encoder-decoder models.

Counterpart of the parts of ``pyroved_tpu/models/base.py`` that the
ported families use: invariance bookkeeping (1-D data allows only
``['t']``; in 2-D ``'t'`` takes two latent slots), the coordinate grid and
the priors, the latent split in the order rotation -> translation -> scale
-> content, the decoder and the routing of its decodes (and its gate under
tensor parallelism, ``sync_fusion_gate``), the transformed grids, the
pixel-partitioned reconstruction term (``pixel_chunks``, or a mesh axis
under ``parallel.shard_pixels``), P-fold particle tiling, the models' own
requests (``encode``, ``decode`` and the rest, as the JAX models jit them:
bucketed bodies, a captured program a function and bucket on CUDA;
:meth:`baseVAE._request`), the semi-supervised ``fit`` loop, custom
networks (``set_encoder`` / ``set_decoder``), pickle-free
``save_weights`` / ``load_weights`` and the reference pyroVED's weights
(``load_torch_weights``). A model without invariances has no grid: VED
builds on this base with ``data_dim`` its output and its own conv decoder,
and uses only the grid-free parts (``fit``, the requests, the latent
plane, weights).

Parameters live in ``self.nets``, an ``nn.ModuleDict`` with the JAX
package's top-level names (``encoder_z``, ``encoder_y``, ``decoder``) on
``self.device``.
"""
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.nn.modules.batchnorm import _BatchNorm
from torch.utils.checkpoint import checkpoint

from ..infer.elbo import obs_site
from ..nets.conv import BatchNorm
from ..nets.fc import fcDecoderNet, sDecoderNet
from ..ops import spatial_decoder as _sd
from ..ops.spatial_decoder import (apply_fused_sdecoder,
                                   padded_sdecoder_weights,
                                   sdecoder_supports_fusion)
from ..parallel.collectives import Axis, replicated, sum_over
from ..trainers import _graph
from ..trainers._requests import Requests, capped_bucket
from ..utils.coord import generate_grid, transform_coordinates
from ..utils.nn import as_f32, as_numpy, resolve_device

Tensor = torch.Tensor

#: Keywords every model takes (as the JAX package's); a model adds its own.
MODEL_KWARGS = ("channels", "dx_prior", "dy_prior", "sc_prior",
                "decoder_sig", "kl", "num_particles", "approx_tanh", "fused",
                "pixel_chunks")


def check_kwargs(model: str, kwargs, allowed) -> None:
    """Reject keywords ``model`` does not take."""
    unknown = sorted(set(kwargs) - set(allowed))
    if unknown:
        raise TypeError(f"{model} got unsupported keywords {unknown}; "
                        f"supported: {list(allowed)}")


def with_labels(zc: Tensor, y: Optional[Tensor]) -> Tensor:
    """The decoder input: content latents, then the labels if any."""
    return zc if y is None else torch.cat([zc, y], dim=-1)


def tile_rows(a: Optional[Tensor], P: int) -> Optional[Tensor]:
    """``a [B, ...]`` repeated P times along its rows: ``[P*B, ...]``."""
    if a is None:
        return None
    return a.expand((P,) + a.shape).reshape((P * a.shape[0],) + a.shape[1:])


def posed_decode(decoder: nn.Module, grid: Optional[Tensor], z: Tensor,
                 fused: bool, act: str, sigmoid_out: bool, angle=0.0,
                 shift=0.0, scale=1.0, weights=None) -> Tensor:
    """Decode latents ``z [B, L]`` under one fixed pose for the batch.

    Spatial decoders (``grid`` given) go through the fused kernel when
    ``fused`` (on ``weights``, as :func:`padded_sdecoder_weights` gives
    them, where given), else through the module on the transformed grid.
    The pose is Python numbers or arrays, or float32 tensors on ``z``'s
    device, which are read in place with no host-to-device copy (angle and
    scale of one element, shift of one or D), as a captured request passes
    them. Returns ``[B, N(, C)]`` or, for a plain decoder,
    ``[B, prod(out)]``."""
    if grid is None:
        return decoder(z)
    B, D = z.shape[0], grid.shape[-1]
    angle, shift, scale = (torch.as_tensor(v, dtype=torch.float32,
                                           device=z.device)
                           for v in (angle, shift, scale))
    if fused:
        return apply_fused_sdecoder(
            decoder, grid, angle.reshape(()).expand(B),
            shift.expand(B, D).contiguous(), scale.reshape(()).expand(B), z,
            act, sigmoid_out, weights=weights)
    coords = fixed_transform_grid(grid, angle, shift, scale)
    return decoder(coords.expand((B,) + coords.shape), z)


def fixed_transform_grid(grid: Tensor, angle=0.0, shift=0.0, scale=1.0
                         ) -> Tensor:
    """``grid [N, D]`` under one angle/shift/scale (angle and scale of one
    element; shift a scalar or ``[D]``; 1-D grids only shift)."""
    as_t = lambda v: torch.as_tensor(  # noqa: E731
        v, dtype=torch.float32, device=grid.device)
    return transform_coordinates(grid[None], as_t(angle).reshape(1),
                                 as_t(shift), as_t(scale).reshape(1))[0]


def plot_manifold(ndim: int, loc: Tensor, d: int, axes, kwargs) -> None:
    """Show a decoded d x d manifold as the JAX package's models do: an
    image grid spanning the latent bounds ``axes`` (the grid's x and y
    values) for 2-D data, a grid of spectra for 1-D; ``kwargs`` reach the
    plot."""
    from ..utils import viz
    if ndim == 2:
        grid_x, grid_y = axes
        viz.plot_img_grid(loc, d, extent=[float(grid_x.min()),
                                          float(grid_x.max()),
                                          float(grid_y.min()),
                                          float(grid_y.max())], **kwargs)
    elif ndim == 1:
        viz.plot_spect_grid(loc, d, **kwargs)


def request_route(model) -> bool:
    """True when ``model``'s own requests run as captured programs
    (:meth:`baseVAE._request`): a CUDA model while ``_graph.CAPTURE`` is
    set, read at each request. A model whose parameters a mesh splits
    (tensor parallelism, or a pixel grid under ``shard_pixels``) keeps the
    eager bodies, as ``mesh=`` epochs keep the eager loop: gloo's
    collectives cannot be captured."""
    from ..parallel.mesh import tensor_parallel
    return (_graph.CAPTURE and model.device.type == "cuda"
            and model._pixel_mesh is None and not tensor_parallel(model.nets))


def row_coupled(m: nn.Module) -> bool:
    """True when ``m`` is a batchnorm that normalizes a call's rows by their
    own statistics: the port's without running statistics to serve from,
    or torch's in training mode or without running statistics. Zero rows
    padded in would then change every real row's output."""
    if isinstance(m, BatchNorm):
        return m.running_stats is None
    return isinstance(m, _BatchNorm) and (m.training
                                          or not m.track_running_stats)


_SPLIT_DECODER_WARNING = (
    "decoder parameters are sharded across the mesh; disabling the fused "
    "spatial-decoder kernels (they need replicated decoder weights). "
    "Training continues on the sDecoderNet module path.")


class baseVAE:
    """Common machinery for (invariant) variational encoder-decoders."""

    def __init__(self, data_dim: Sequence[int], invariances: Optional[List[str]],
                 device=None, **kwargs):
        self.device = resolve_device(device)
        self.data_dim = tuple(int(d) for d in data_dim)
        self.ndim = len(self.data_dim)
        if invariances is None:
            coord = 0
        else:
            coord = len(invariances)
            if self.ndim == 1:
                if coord > 1 or invariances[0] != "t":
                    raise ValueError(
                        "For 1D data, the only invariance to enforce "
                        "is translation ('t')")
            if "t" in invariances and self.ndim == 2:
                coord = coord + 1
        self.coord = coord
        self.invariances = invariances
        # multi-channel spatial data rides as a trailing axis [B, *data_dim, C]
        self.channels = int(kwargs.get("channels", 1))
        if self.channels < 1:
            raise ValueError(f"channels must be >= 1, got {self.channels}")
        self.out_shape = self.data_dim + (
            (self.channels,) if self.channels > 1 else ())

        self.grid = (generate_grid(self.data_dim, self.device)
                     if self.coord > 0 else None)

        if self.coord > 0 and "t" in invariances:
            dx_pri = float(kwargs.get("dx_prior", 0.1))
            dy_pri = float(kwargs.get("dy_prior", dx_pri))
            self.t_prior = torch.tensor(
                [dx_pri, dy_pri] if self.ndim == 2 else dx_pri,
                dtype=torch.float32, device=self.device)
        else:
            self.t_prior = None
        if self.coord > 0 and "s" in (invariances or []):
            self.sc_prior = float(kwargs.get("sc_prior", 0.1))
        else:
            self.sc_prior = None

        # pixel_chunks=k: the training-path reconstruction term runs over k
        # tiles of the grid, one at a time (see _recon_pixel_chunked)
        self.pixel_chunks = int(kwargs.get("pixel_chunks", 0) or 0)
        if self.pixel_chunks and self.coord == 0:
            raise ValueError(
                "pixel_chunks requires a spatial decoder (invariances=...); "
                "models without a coordinate grid have no pixel axis to "
                "partition")
        # parallel.shard_pixels(model, mesh, axis) sets these: the pixel
        # grid is then split over the mesh axis (see _recon_pixel_sharded)
        self._pixel_mesh = None
        self._pixel_axis = None

        self.nets: Optional[nn.ModuleDict] = None  # set by subclasses
        self.z_dim = None
        self.num_particles = int(kwargs.get("num_particles", 1))
        self.kl_mode = kwargs.get("kl", "mc")

    def _make_decoder(self, zc_dim: int, hidden_dim_d, activation: str,
                      sigmoid_d: bool, kwargs) -> nn.Module:
        """The decoder of ``zc_dim`` latent inputs (an ``sDecoderNet`` over
        the grid with invariances, else an ``fcDecoderNet``) and the routing
        of its decodes: the kernels when the configuration supports them
        and ``fused`` is not False (``_fused``), the Pade tanh on the ELBO
        path under ``approx_tanh`` (``_dec_act``)."""
        if self.coord > 0:
            decoder = sDecoderNet(self.grid.shape[-1], zc_dim, hidden_dim_d,
                                  activation, sigmoid_out=sigmoid_d,
                                  channels=self.channels)
        else:
            decoder = fcDecoderNet(zc_dim, self.out_shape, hidden_dim_d,
                                   activation, sigmoid_out=sigmoid_d)
        self.activation = activation
        self._dec_sig = bool(sigmoid_d)
        self._fused = (bool(kwargs.get("fused", True))
                       and sdecoder_supports_fusion(
                           hidden_dim_d, activation, sigmoid_d, self.coord,
                           self.channels, self.device))
        # opt-in Pade tanh on the ELBO path (max abs error < 2e-4)
        self._dec_act = ("tanh_approx" if kwargs.get("approx_tanh")
                         and activation == "tanh" and self._fused
                         else activation)
        return decoder

    def sync_fusion_gate(self, defer_warning: bool = False) -> bool:
        """Re-check the kernels' gate against the decoder as it now stands:
        a decoder whose layers are split over a mesh axis
        (``parallel.tensor_parallel_params``) cannot feed the kernels,
        which need its weights whole, so they are turned off with a
        ``UserWarning`` and its decodes go to the ``sDecoderNet`` module.
        ``tensor_parallel_params`` calls this as it splits, with
        ``defer_warning``: the warning then waits for the next call, which
        the trainers make at every ``train`` and ``evaluate`` (and
        ``make_spmd_train_step`` when it builds its step). Returns the
        gate."""
        if getattr(self, "_gate_warning", False) and not defer_warning:
            self._gate_warning = False
            warnings.warn(_SPLIT_DECODER_WARNING, UserWarning, stacklevel=2)
        if not getattr(self, "_fused", False):
            return False
        from ..parallel.mesh import tensor_parallel
        if tensor_parallel(self.decoder_net):
            if defer_warning:
                self._gate_warning = True
            else:
                warnings.warn(_SPLIT_DECODER_WARNING, UserWarning,
                              stacklevel=2)
            self._fused = False
        return self._fused

    @property
    def encoder_net(self) -> nn.Module:
        return self.nets["encoder_z"]

    @property
    def decoder_net(self) -> nn.Module:
        return self.nets["decoder"]

    # ------------------------------------------------------------------
    # Latent bookkeeping
    # ------------------------------------------------------------------
    def split_latent(self, z: Tensor):
        """Split ``z[..., z_dim]`` into (phi, dx, sc, content): rotation
        first, then translation, then scale. Missing parts come back as
        identity values (phi=0, dx=0, sc=1); in 1-D phi and sc are None."""
        batch_shape = z.shape[:-1]
        if self.ndim == 1:
            return None, z[..., 0:1], None, z[..., 1:]
        phi = z.new_zeros(batch_shape)
        dx = z.new_zeros(batch_shape + (2,))
        sc = z.new_ones(batch_shape)
        inv = self.invariances or []
        if "r" in inv:
            phi = z[..., 0]
            z = z[..., 1:]
        if "t" in inv:
            dx = z[..., :2]
            z = z[..., 2:]
        if "s" in inv:
            sc = sc + self.sc_prior * z[..., 0]
            z = z[..., 1:]
        return phi, dx, sc, z

    def split_latent_full(self, z: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """:meth:`split_latent` with concrete identity defaults and the
        translation prior applied: the per-sample transform the decoder
        kernel takes. Returns (phi [..], dx [.., D], sc [..], content)."""
        phi, dx, sc, z = self.split_latent(z)
        batch_shape = z.shape[:-1]
        if self.t_prior is not None:
            dx = dx * self.t_prior
        if phi is None:
            phi = z.new_zeros(batch_shape)
        if sc is None:
            sc = z.new_ones(batch_shape)
        return phi, dx, sc, z

    def _embed_latent_plane(self, z: Tensor, latent_dim: int,
                            which_dims=None, z_fixed=None) -> Tensor:
        """Embed 2-D latent-grid points ``z [n, 2]`` into the
        ``latent_dim``-D content space: the plane spans ``which_dims``
        (default the first two), the other dims are ``z_fixed`` (default 0)."""
        if latent_dim == 2 and which_dims is None and z_fixed is None:
            return z
        wd = tuple(int(w) for w in (which_dims if which_dims is not None
                                    else (0, 1)))
        if (len(wd) != 2 or wd[0] == wd[1]
                or not all(0 <= w < latent_dim for w in wd)):
            raise ValueError(
                f"which_dims must be two distinct indices < {latent_dim}, "
                f"got {wd}")
        if z_fixed is None:
            base = z.new_zeros((latent_dim,))
        else:
            base = self._as_f32(z_fixed).reshape(-1).to(z.device)
            if base.shape[0] != latent_dim:
                raise ValueError(
                    f"z_fixed must have length {latent_dim}, got {base.shape[0]}")
        full = base.expand(z.shape[0], latent_dim).clone()
        full[:, wd[0]] = z[:, 0]
        full[:, wd[1]] = z[:, 1]
        return full

    def transformed_grid(self, z: Tensor) -> Tuple[Optional[Tensor], Tensor]:
        """``(coords [..., N, D], content)`` with the latent-derived affine
        transform applied to the grid (coords is None without invariances)."""
        if self.coord == 0:
            return None, z
        phi, dx, sc, z = self.split_latent_full(z)
        grid = self.grid.expand(z.shape[:-1] + self.grid.shape)
        return transform_coordinates(grid, phi, dx[..., None, :], sc), z

    def fixed_transform_grid(self, **kwargs) -> Optional[Tensor]:
        """The grid ``[N, D]`` under one user-fixed pose (``angle``,
        ``shift``, ``scale``; defaults 0, 0 and 1), the generation path's;
        None for a model without a coordinate transform."""
        if self.coord == 0:
            return None
        return fixed_transform_grid(self.grid, kwargs.get("angle", 0.0),
                                    kwargs.get("shift", 0.0),
                                    kwargs.get("scale", 1.0))

    def _module_decode(self, z: Tensor, y: Optional[Tensor] = None):
        """(decoded loc, warped grid or None) of latents ``z`` (and labels
        ``y``) through the decoder module."""
        coords, zc = self.transformed_grid(z)
        zc = with_labels(zc, y)
        if coords is None:
            return self.decoder_net(zc), None
        return self.decoder_net(coords, zc), coords

    def _recon(self, z: Tensor, y: Optional[Tensor], xf: Tensor) -> Tensor:
        """The reconstruction term ``log p(x | decode(z, y))`` summed over
        the pixels, ``[...]``, of latents ``z [..., z_dim]`` whose content
        is joined by labels ``y`` (``[..., *]``, or None), for flat
        observations ``xf`` broadcastable to ``[..., N*C]``: over the whole
        grid (:meth:`_decode_grid`), partitioned under ``pixel_chunks`` or
        ``shard_pixels`` (:meth:`_recon_pixel_parallel`), or through the
        plain decoder without invariances."""
        if self.coord == 0:
            loc = self.decoder_net(with_labels(z, y))
        else:
            phi, dx, sc, zc = self.split_latent_full(z)
            zc = with_labels(zc, y)
            if self._pixel_mode():
                return self._recon_pixel_parallel(phi, dx, sc, zc, xf)
            loc = self._decode_grid(self.grid, phi, dx, sc, zc)
        return obs_site(self.sampler_d, xf, loc.reshape(z.shape[:-1] + (-1,)))

    # ------------------------------------------------------------------
    # Pixel-partitioned reconstruction (training path)
    # ------------------------------------------------------------------
    def _pixel_mode(self) -> Optional[str]:
        """``"shard"`` under ``parallel.shard_pixels``, else ``"chunk"``
        when ``pixel_chunks`` > 1, else None (the full-grid paths). Read at
        every loss, so setting ``model.pixel_chunks`` or calling
        ``shard_pixels`` takes effect at the next step."""
        if self._pixel_mesh is not None:
            return "shard"
        return "chunk" if int(self.pixel_chunks or 0) > 1 else None

    def _padded_pixel_arrays(self, xp: Tensor, multiple: int):
        """(grid, pixel mask, observations) with zero grid rows, mask 0 and
        zero observations padding the pixel count up to a multiple of
        ``multiple``; ``xp`` is ``[batch..., N]`` or ``[batch..., N, C]``."""
        N, D = self.grid.shape
        pad = (-N) % multiple
        grid = self.grid
        mask = grid.new_ones((N,))
        if pad:
            grid = torch.cat([grid, grid.new_zeros((pad, D))])
            mask = torch.cat([mask, mask.new_zeros((pad,))])
            widths = (0, pad) if self.channels == 1 else (0, 0, 0, pad)
            xp = torch.nn.functional.pad(xp, widths)
        return grid, mask, xp

    def _decode_grid(self, grid: Tensor, phi, dx, sc, zc: Tensor,
                     params=None) -> Tensor:
        """The decoded loc ``[batch..., n(, C)]`` over the grid rows
        ``grid [n, D]`` (the whole grid or a tile of it) under the
        per-sample transforms, for decoder inputs ``zc [batch..., L]``:
        through the kernels when routed there, else the decoder module on
        the transformed coordinates. ``params`` (:meth:`_decoder_params`)
        take the place of the decoder's own weights."""
        if self._fused:
            return apply_fused_sdecoder(self.decoder_net, grid, phi, dx, sc,
                                        zc, self._dec_act, self._dec_sig,
                                        weights=params)
        coords = transform_coordinates(
            grid.expand(zc.shape[:-1] + grid.shape), phi, dx[..., None, :],
            sc)
        if params is None:
            return self.decoder_net(coords, zc)
        names = [n for n, _ in self.decoder_net.named_parameters()]
        return torch.func.functional_call(
            self.decoder_net, dict(zip(names, params)), (coords, zc))

    def _decoder_params(self) -> tuple:
        """The decoder's weights as :meth:`_decode_grid` takes them: the
        kernels' padded tensors on the kernels' path, else the module's
        parameters."""
        if self._fused:
            return padded_sdecoder_weights(self.decoder_net)
        return tuple(self.decoder_net.parameters())

    def _tile_recon(self, grid_t, x_t, m_t, phi, dx, sc, zc,
                    params=None) -> Tensor:
        """One tile's masked reconstruction term, ``[batch...]``."""
        lp = self.sampler_d.log_prob(x_t, self._decode_grid(
            grid_t, phi, dx, sc, zc, params))
        if self.channels > 1:
            lp = torch.sum(lp, dim=-1)
        return torch.sum(lp * m_t, dim=-1)

    def _recon_pixel_parallel(self, phi, dx, sc, zc: Tensor,
                              xf: Tensor) -> Tensor:
        """The reconstruction term with the pixel axis partitioned: over
        ``pixel_chunks`` tiles in order, or over this rank's shard of
        ``shard_pixels``' mesh axis. ``xf`` broadcasts to ``[batch...,
        N*C]``; returns ``[batch...]``."""
        C = self.channels
        N = self.grid.shape[0]
        batch = zc.shape[:-1]
        xf = xf.expand(batch + xf.shape[-1:])
        xp = xf.reshape(batch + ((N, C) if C > 1 else (N,)))
        if self._pixel_mode() == "shard":
            return self._recon_pixel_sharded(phi, dx, sc, zc, xp)
        return self._recon_pixel_chunked(phi, dx, sc, zc, xp)

    def _recon_pixel_sharded(self, phi, dx, sc, zc: Tensor,
                             xp: Tensor) -> Tensor:
        """The reconstruction term with the grid split over the mesh axis
        of ``shard_pixels``: this rank decodes its slice of the padded,
        masked grid (N/n pixels) through the routing of every training
        decode (K1, and K2 in the backward, on the kernels' path), and the
        per-example partial terms are summed over the axis. The latents
        and the decoder's weights enter the slice through ``replicated``,
        so the backward sums their partial cotangents over the axis once;
        the sum's backward passes the whole cotangent through. Every rank
        thus holds the loss and every grad whole, as the JAX package's
        ``shard_map`` and ``psum`` give them."""
        axis = Axis(self._pixel_mesh, self._pixel_axis)
        grid, mask, xp = self._padded_pixel_arrays(xp, axis.size)
        tile = grid.shape[0] // axis.size
        rows = slice(axis.rank * tile, (axis.rank + 1) * tile)
        phi, dx, sc, zc, *params = replicated(axis, phi, dx, sc, zc,
                                              *self._decoder_params())
        part = self._tile_recon(
            grid[rows], xp[..., rows] if self.channels == 1
            else xp[..., rows, :], mask[rows], phi, dx, sc, zc, params)
        return sum_over(axis, part)

    def _recon_pixel_chunked(self, phi, dx, sc, zc: Tensor,
                             xp: Tensor) -> Tensor:
        """The reconstruction term over ``pixel_chunks`` grid tiles, in
        order, summed into a zero accumulator (exact: the observation
        log-density factorizes over pixels; a pixel count that k does not
        divide is padded and masked). On the module path with autograd on,
        each tile runs under a checkpoint, so the backward holds one tile's
        ``[batch..., N/k, H]`` activations at a time; the kernels save
        only their inputs, so their tiles run plain: k K1 and k K2 a
        step. The tiles draw no random numbers, so the checkpoint keeps no
        RNG state (reading the CUDA generator's would fail a captured
        epoch). ``xp`` is ``[batch..., N]`` or ``[batch..., N, C]``."""
        k = int(self.pixel_chunks)
        C = self.channels
        batch = zc.shape[:-1]
        grid, mask, xp = self._padded_pixel_arrays(xp, k)
        tile = grid.shape[0] // k
        remat = torch.is_grad_enabled() and not self._fused
        acc = xp.new_zeros(batch)
        for t in range(k):
            rows = slice(t * tile, (t + 1) * tile)
            args = (grid[rows], xp[..., rows] if C == 1 else xp[..., rows, :],
                    mask[rows], phi, dx, sc, zc)
            if remat:
                acc = acc + checkpoint(self._tile_recon, *args,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
            else:
                acc = acc + self._tile_recon(*args)
        return acc

    def _particles(self, single, x: Tensor, y: Optional[Tensor], beta,
                   eps) -> Tensor:
        """``single(x, y, beta, eps)`` averaged over ``num_particles``
        estimates, the batch tiled P-fold into one call as the JAX package
        does (``eps`` then holds P*B rows). Returns ``[B]``."""
        P = self.num_particles
        if P <= 1:
            return single(x, y, beta, eps)
        per = single(tile_rows(x, P), tile_rows(y, P), beta, eps)
        return per.reshape(P, x.shape[0]).mean(0)

    # ------------------------------------------------------------------
    # Requests
    # ------------------------------------------------------------------
    def _row_bytes(self) -> int:
        """Bytes of one row of the model's data: what caps its largest
        bucket (``_requests.capped_bucket``)."""
        return 4 * int(np.prod(self.out_shape))

    def _request_settings(self):
        """``(settings, coupled)``: what every request program's graph
        freezes besides its name and bucket, and which of the nets couple
        their rows (net name -> :func:`row_coupled`), from one walk over
        the nets. The settings are the weights' generation
        (``_weights_replaced``), the addresses of the tensors the bodies
        read in place (parameters, buffers, batchnorms' running statistics)
        and the batchnorms' modes, the decoder's route (``_fused``),
        ``BF16_MATMUL`` (K1's source) and the largest bucket."""
        state, coupled = [], {}
        for name, net in self.nets.items():
            rows = False
            for m in net.modules():
                state += [t.data_ptr() for t in m._parameters.values()
                          if t is not None]
                state += [t.data_ptr() for t in m._buffers.values()
                          if t is not None]
                if isinstance(m, (BatchNorm, _BatchNorm)):
                    own = row_coupled(m)
                    rows = rows or own
                    state.append(own)
                    state += [t.data_ptr()
                              for t in getattr(m, "running_stats", None) or ()]
            coupled[name] = rows
        return ((getattr(self, "_graph_generation", 0), tuple(state),
                 bool(getattr(self, "_fused", False)), _sd.BF16_MATMUL,
                 self._requests.max_bucket), coupled)

    def _request(self, name: tuple, body, batched, extra=(),
                 batch_size: Optional[int] = None, nets=()):
        """``body`` over the rows of the device tensors ``batched`` (and
        the non-batched ``extra``) as one of the model's own requests
        (``trainers/_requests.py``): cut into chunks, each padded to its
        bucket (the JAX package's ``_chunked`` rule under ``batch_size``,
        else ``ServedModel``'s power-of-two buckets), or run at exact rows
        when one of ``nets``, the names of the nets the body reads, couples
        its rows (:func:`row_coupled`). On the captured route
        (:func:`request_route`) each ``name`` (the function, then the
        Python arguments its body reads) at each bucket is a program of
        the model's runner, ``_requests``, under
        :meth:`_request_settings`; elsewhere the same bodies run eagerly.
        The programs are bounded a function: at most 8 from the
        power-of-two rule and 4 others (a ``batch_size``'s, an exact
        body's row counts), the least recently used freed beyond either.
        The largest bucket is 1024 rows, halved while a static buffer of
        its data rows would pass 256 MiB (256 rows at 512x512)."""
        if self.__dict__.get("_requests") is None:
            self._requests = Requests(self.device,
                                      capped_bucket(self._row_bytes()))
        settings, coupled = self._request_settings()
        return self._requests.request(
            name, body, batched, extra, captured=request_route(self),
            settings=settings, batch_size=batch_size,
            exact=any(coupled[n] for n in nets))

    def _pose(self, angle=0.0, shift=0.0, scale=1.0) -> Tensor:
        """The pose ``[angle, shift (D), scale]`` as one float32 vector on
        the model's device: a decode program's input, filled before each
        run, so that a new pose takes no new program."""
        D = self.grid.shape[-1]

        def part(v):
            return np.asarray(as_numpy(v), np.float32).reshape(-1)

        pose = np.concatenate([part(angle).reshape(1),
                               np.broadcast_to(part(shift), (D,)),
                               part(scale).reshape(1)])
        return torch.from_numpy(pose).to(self.device)

    def _posed_body(self, z: Tensor, pose: Optional[Tensor] = None
                    ) -> Tensor:
        """The decode body: decoder inputs ``z`` under ``pose``
        (:meth:`_pose`) through :func:`posed_decode`, one K1 on the
        kernels' path, whose padded weights are made inside a captured
        graph, so that each replay reads the parameters as they then are;
        a plain decoder takes no pose."""
        if pose is None:
            return self.decoder_net(z)
        D = self.grid.shape[-1]
        return posed_decode(self.decoder_net, self.grid, z, self._fused,
                            self.activation, self._dec_sig, pose[:1],
                            pose[1:1 + D], pose[1 + D:])

    @torch.no_grad()
    def _decode_posed(self, z: Tensor, angle=0.0, shift=0.0, scale=1.0,
                      batch_size: Optional[int] = None, **kwargs) -> Tensor:
        """Decode decoder inputs ``z [B, *]`` under one fixed pose as a
        request (:meth:`_request`), chunked at ``batch_size`` rows or
        bucketed; returns ``[B, *data_dim(, C)]``."""
        extra = () if self.grid is None else (self._pose(angle, shift,
                                                         scale),)
        loc = self._request(("decode",), self._posed_body, (z,), extra,
                            batch_size, ("decoder",))
        return loc.reshape((z.shape[0],) + self.out_shape)

    # ------------------------------------------------------------------
    # Custom networks
    # ------------------------------------------------------------------
    def _injected(self, net: nn.Module, *probes) -> nn.Module:
        """``net`` on the model's device with every layer drawn from the
        model's generator: one call on the first of ``probes`` (argument
        tuples, tried in order until one is not a ``TypeError``) builds any
        lazy layer, then layers with ``reset_from`` redraw from the
        generator and other layers with ``reset_parameters`` (torch's own
        Linear, conv, ...) reset under a CPU seed drawn from it, torch's
        global generator left as it was."""
        net = net.cpu()
        with torch.no_grad():
            for i, args in enumerate(probes):
                try:
                    net(*args)
                    break
                except TypeError:
                    if i + 1 == len(probes):
                        raise
        for m in net.modules():
            if hasattr(m, "reset_from"):
                m.reset_from(self.generator)
            elif hasattr(m, "reset_parameters"):
                seed = int(torch.randint(2 ** 62, (1,),
                                         generator=self.generator))
                with torch.random.fork_rng(devices=[]):
                    torch.manual_seed(seed)
                    m.reset_parameters()
        return net.to(self.device)

    def set_encoder(self, encoder_net: nn.Module) -> None:
        """Put a user-defined ``nn.Module`` in place of the inference network
        (``encoder_z``), its layers drawn afresh from the model's generator
        and moved to the model's device. It takes the flattened batch
        ``x [B, prod(data_dim)]`` (a VED's ``[B, *input_dim, C]``), and
        the labels too, ``(x, y)``, when the model is conditional, and
        returns ``(loc, scale)`` (jiVAE's also the class logits). The
        decoder's kernels stay in place. Build trainers after this call:
        they hold the parameters they optimize."""
        if hasattr(self, "input_dim"):  # a VED: channels-last images
            x0 = torch.zeros((2,) + self.input_dim + (self.input_channels,))
        else:
            x0 = torch.zeros(2, int(np.prod(self.out_shape)))
        c = (getattr(self, "c_dim", 0) or getattr(self, "num_classes", 0)
             or getattr(self, "reg_dim", 0))  # the labels' width
        probe = (x0,) if c == 0 else (x0, torch.zeros(2, c))
        self.nets["encoder_z"] = self._injected(encoder_net, probe)
        self._weights_replaced()

    def set_decoder(self, decoder_net: nn.Module) -> None:
        """Put a user-defined ``nn.Module`` in place of the generator network
        (``decoder``), its layers drawn afresh from the model's generator
        and moved to the model's device. A spatial model calls it as
        ``decoder(coords [B, N, D], zc)``, a model without invariances as
        ``decoder(zc)``, where ``zc`` holds the content latents and then the
        labels or classes. The decoder kernels are turned off for good: the
        new decoder runs as a module, on every path. Build trainers after
        this call."""
        zc0 = torch.zeros(
            2, self.z_dim - self.coord + getattr(self, "c_dim", 0)
            + getattr(self, "num_classes", 0) + getattr(self, "reg_dim", 0)
            + getattr(self, "discrete_dim", 0))
        probes = [(zc0,)]
        if self.grid is not None:  # spatial first, then plain
            probes.insert(0, (self.grid.cpu().expand((2,) + self.grid.shape),
                              zc0))
        self.nets["decoder"] = self._injected(decoder_net, *probes)
        self._fused = False
        self._weights_replaced()

    # ------------------------------------------------------------------
    # Weights
    # ------------------------------------------------------------------
    def _weights_replaced(self) -> None:
        """Move the generation that the trainers' captured epochs
        (``trainers._graph``) key their programs by, so that they are
        captured again over the new weights or networks."""
        self._graph_generation = getattr(self, "_graph_generation", 0) + 1

    def state_dict(self):
        return self.nets.state_dict()

    def save_weights(self, filepath: str) -> None:
        """Write the parameters (and the model's generator state) to
        ``filepath + '.pvt'``: a pickle-free ``np.savez`` archive of named
        f32 arrays and a JSON manifest, so loading an untrusted file cannot
        run code. A tensor-parallel model's split layers are written whole:
        every rank calls it and global rank 0 writes."""
        from ..parallel.collectives import is_writer
        from ..parallel.mesh import whole_tensors
        from ..utils.checkpoint import WEIGHTS_FORMAT, write_archive
        whole = whole_tensors(self.nets, self.nets.state_dict())
        if not is_writer():
            return
        arrays = {f"w_{k}": v.detach().cpu().numpy().astype(np.float32)
                  for k, v in whole.items()}
        gen = getattr(self, "generator", None)
        if gen is not None:
            arrays["generator"] = gen.get_state().numpy()
        write_archive(filepath + ".pvt", arrays, {"format": WEIGHTS_FORMAT})

    def load_weights(self, filepath: str) -> None:
        """Load the parameters :meth:`save_weights` wrote (the ``.pvt``
        suffix is added when missing), with strict key and shape checks. A
        ``.pvt`` of the JAX package (flax msgpack bytes) raises; its
        parameter tree crosses over through :meth:`load_jax_params`. A
        tensor-parallel model takes its rank's rows of each split layer."""
        from ..parallel.mesh import local_tensors
        from ..utils.checkpoint import WEIGHTS_FORMAT, check_state, read_archive
        if not filepath.endswith(".pvt"):
            filepath = filepath + ".pvt"
        _, arrays = read_archive(filepath, WEIGHTS_FORMAT)
        state = local_tensors(self.nets, {k[2:]: v for k, v in arrays.items()
                                          if k.startswith("w_")})
        check_state(self.nets.state_dict(), state, filepath)
        self.nets.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in state.items()}, strict=True)
        gen = getattr(self, "generator", None)
        if gen is not None and "generator" in arrays:
            gen.set_state(torch.from_numpy(arrays["generator"]))
        self._weights_replaced()

    def load_jax_params(self, params) -> None:
        """Load the JAX model's parameter tree (``{"encoder_z": ...,
        "decoder": ...}``, plus ``"encoder_y"`` for the semi-supervised
        models; numpy leaves), with strict key and shape checks."""
        from ..weights import from_jax_params
        self.nets.load_state_dict(from_jax_params(params), strict=True)

    def load_torch_weights(self, source, strict: bool = True):
        """Load weights trained with the reference pyroVED (a ``.pt`` file
        of its ``save_weights``, or a torch ``state_dict``), mapping its
        module names onto the port's (see :mod:`pyroved_tpu_torch.interop`).
        Returns the model."""
        from ..interop import load_torch_weights
        return load_torch_weights(self, source, strict=strict)

    def _as_f32(self, x) -> Tensor:
        return as_f32(x, self.device)

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    @staticmethod
    def _check_data_scale(X, data_scale) -> None:
        """Reject raw integer signal data unless ``data_scale`` says how to
        normalize it: the samplers expect normalized floats."""
        if data_scale is not None:
            return
        dt = getattr(X, "dtype", None)
        if dt is None:
            try:
                dt = np.asarray(X).dtype
            except (TypeError, ValueError):
                return
        if isinstance(dt, torch.dtype):
            integer = not (dt.is_floating_point or dt.is_complex)
        else:
            integer = np.issubdtype(np.dtype(dt), np.integer)
        if integer:
            raise ValueError(
                f"fit() got integer data (dtype {dt}) without data_scale=. "
                "The decoder samplers expect normalized floats; pass e.g. "
                "data_scale=1/255. to train on raw uint8 directly (kept "
                "uint8 on the device, normalized per batch), or "
                "pre-convert X yourself.")

    def fit(self, X, y=None, epochs: int = 100, batch_size: int = 100,
            lr: float = 1e-3, scale_factor=1.0, test_data=None,
            verbose: bool = False, trainer=None, patience=None,
            min_delta: float = 0.0, on_segment=None, data_scale=None,
            **kwargs):
        """Train for ``epochs`` epochs and return the trainer (its
        ``loss_history`` holds the per-epoch losses).

        ``X`` is an array or a DataLoader; ``y`` adds conditional features.
        ``test_data`` (an array, a tuple of arrays or a DataLoader) is
        evaluated after every epoch. ``patience=P`` (needs ``test_data``)
        stops once the held-out loss has not improved by more than
        ``min_delta`` for ``P`` epochs; ``on_segment`` receives the epochs'
        records; ``enum_schedule`` (jiVAE) trains the first epochs with
        exact enumeration. ``data_scale=s`` keeps narrow-dtype ``X`` (e.g.
        raw uint8 images) in that dtype on the device and normalizes each
        batch by ``s``; integer ``X`` without it is rejected. Without
        ``verbose`` the trainer's ``run`` drives the epochs; with it, one
        ``step`` and ``print_statistics`` per epoch (``enum_schedule``
        then raises). Other keywords go to the trainer."""
        from ..trainers.svi import SVItrainer
        from ..utils.data import DataLoader, init_dataloader
        enum_schedule = kwargs.pop("enum_schedule", None)
        if isinstance(X, DataLoader):
            loader = X
        else:
            self._check_data_scale(X, data_scale)
            arrays = (X,) if y is None else (X, y)
            loader = init_dataloader(*arrays, batch_size=batch_size,
                                     scale=data_scale, device=self.device)
        test_loader = None
        if test_data is not None:
            if isinstance(test_data, DataLoader):
                test_loader = test_data
            else:
                tarrs = (test_data if isinstance(test_data, tuple)
                         else (test_data,))
                self._check_data_scale(tarrs[0], data_scale)
                test_loader = init_dataloader(*tarrs, batch_size=batch_size,
                                              scale=data_scale,
                                              device=self.device)
        if trainer is not None and kwargs:
            raise ValueError(
                "fit() got both an explicit trainer= and trainer-level "
                f"kwargs {sorted(kwargs)}; configure them on the trainer "
                "you pass, or drop trainer= to have fit() build one.")
        trainer = trainer or SVItrainer(self, lr=lr, **kwargs)
        if patience is not None and test_loader is None:
            raise ValueError("fit(patience=) needs test_data= to monitor")
        if not verbose:
            run_kwargs = {} if test_loader is None else {
                "test_loader": test_loader}
            if patience is not None:
                run_kwargs.update(patience=patience, min_delta=min_delta)
            if on_segment is not None:
                run_kwargs.update(on_segment=on_segment)
            if enum_schedule is not None:
                run_kwargs.update(enum_schedule=enum_schedule)
            trainer.run(loader, int(epochs), scale_factor=scale_factor,
                        **run_kwargs)
            return trainer
        if enum_schedule is not None:
            raise ValueError(
                "enum_schedule= rides the run path; it is not supported "
                "with verbose=True — call trainer.run(..., "
                "enum_schedule=E).")
        return step_loop(
            trainer, lambda: trainer.step(loader, test_loader,
                                          scale_factor=scale_factor),
            epochs, verbose, patience, min_delta, on_segment,
            test_loader is not None)


# keywords of the semi-supervised fits that configure the trainer
_TRAINER_KWARGS = ("mesh", "checkpoint_path", "checkpoint_every", "log_file",
                   "grad_accum", "optimizer", "seed", "task")


def step_loop(trainer, step, epochs, verbose, patience, min_delta,
              on_segment, has_metric):
    """The per-epoch loop of ``fit(verbose=True)``: ``step()`` then, per
    epoch, the statistics, an ``on_segment`` record and the early-stopping
    check on the trainer's held-out metric (a loss, or for a
    classification trainer the accuracy, which should rise)."""
    hist = getattr(trainer, "loss_history", None)
    key = "test_loss" if hist is not None else "test"
    hist = hist if hist is not None else trainer.history
    sign = -1.0 if getattr(trainer, "task", "") == "classification" else 1.0
    trainer.stopped_early = False  # as run() resets it
    best, best_epoch = float("inf"), trainer.current_epoch
    for _ in range(int(epochs)):
        step()
        if verbose:
            trainer.print_statistics()
        if on_segment is not None:
            rec = {"epoch": trainer.current_epoch,
                   "training_loss": hist["training_loss"][-1]}
            if has_metric:
                rec[key] = hist[key][-1]
            on_segment([rec])
        if patience is not None:
            v = sign * hist[key][-1]
            if v < best - min_delta:
                best, best_epoch = v, trainer.current_epoch
            trainer.best_epoch, trainer.best_metric = best_epoch, sign * best
            if trainer.current_epoch - best_epoch >= int(patience):
                trainer.stopped_early = True
                break
    return trainer


def fit_semi_supervised(model, X_unsup, labeled, val, epochs, batch_size, lr,
                        verbose, trainer, data_scale, kwargs):
    """The ``fit`` of ssiVAE and ss_reg_iVAE: loaders for the unlabeled,
    labeled and validation sets on the model's device, an auxSVItrainer,
    then its ``run`` (``patience``, ``min_delta``, ``on_segment`` and
    ``enum_schedule`` go there; the metric of ``patience`` is the
    validation accuracy or MSE); with ``verbose`` or another trainer, one
    ``step`` (and ``print_statistics``) per epoch, where
    ``enum_schedule`` raises."""
    from ..trainers.auxsvi import auxSVItrainer
    from ..utils.data import init_ssvae_dataloaders
    Xl, yl = labeled
    model._check_data_scale(X_unsup, data_scale)
    model._check_data_scale(Xl, data_scale)
    Xv, yv = val if val is not None else (Xl, yl)
    loaders = init_ssvae_dataloaders(
        X_unsup, (Xl, model._labels(yl)), (Xv, model._labels(yv)),
        batch_size=batch_size, scale=data_scale, device=model.device)
    tkw = {k: kwargs.pop(k) for k in _TRAINER_KWARGS if k in kwargs}
    if trainer is not None and tkw:
        raise ValueError(
            "fit() got both an explicit trainer= and trainer-level "
            f"kwargs {sorted(tkw)}; configure them on the trainer you "
            "pass, or drop trainer= to have fit() build one.")
    trainer = trainer or auxSVItrainer(model, lr=lr, **tkw)
    if not verbose and isinstance(trainer, auxSVItrainer):
        trainer.run(loaders[0], loaders[1], int(epochs),
                    loader_val=loaders[2], **kwargs)
        return trainer
    patience = kwargs.pop("patience", None)
    min_delta = float(kwargs.pop("min_delta", 0.0))
    on_segment = kwargs.pop("on_segment", None)
    if kwargs.pop("enum_schedule", None) is not None:
        raise ValueError(
            "enum_schedule= rides the run path; it is not supported with "
            "verbose=True — call trainer.run(..., enum_schedule=E).")
    return step_loop(trainer, lambda: trainer.step(*loaders, **kwargs),
                     epochs, verbose, patience, min_delta, on_segment, True)
