"""Base class for the variational encoder-decoder models.

Counterpart of the parts of ``pyroved_tpu/models/base.py`` that the
ported families use: invariance bookkeeping (1-D data allows only
``['t']``; in 2-D ``'t'`` takes two latent slots), the coordinate grid and
the priors, the latent split in the order rotation -> translation -> scale
-> content, the decoder and the routing of its decodes, the transformed
grids, P-fold particle tiling, chunked encode/decode and the
semi-supervised ``fit`` loop.

Parameters live in ``self.nets``, an ``nn.ModuleDict`` with the JAX
package's top-level names (``encoder_z``, ``encoder_y``, ``decoder``) on
``self.device``.
"""
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..nets.fc import fcDecoderNet, sDecoderNet
from ..ops.spatial_decoder import (apply_fused_sdecoder,
                                   sdecoder_supports_fusion)
from ..utils.coord import generate_grid, transform_coordinates
from ..utils.nn import as_f32, later_slice, resolve_device

Tensor = torch.Tensor

#: Keywords every model takes (as the JAX package's); a model adds its own.
MODEL_KWARGS = ("channels", "dx_prior", "dy_prior", "sc_prior",
                "decoder_sig", "kl", "num_particles", "approx_tanh", "fused")


def check_kwargs(model: str, kwargs, allowed) -> None:
    """Reject keywords ``model`` does not take. ``pixel_chunks`` (the JAX
    package's pixel partitioning) raises ``NotImplementedError`` naming its
    ROADMAP item."""
    if kwargs.get("pixel_chunks"):
        raise later_slice(f"{model}(pixel_chunks=...)", "pixel partitioning")
    unknown = sorted(set(kwargs) - set(allowed) - {"pixel_chunks"})
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
                 shift=0.0, scale=1.0) -> Tensor:
    """Decode latents ``z [B, L]`` under one fixed pose for the batch.

    Spatial decoders (``grid`` given) go through the fused kernel when
    ``fused``, else through the module on the transformed grid. Returns
    ``[B, N(, C)]`` or, for a plain decoder, ``[B, prod(out)]``."""
    if grid is None:
        return decoder(z)
    B = z.shape[0]
    dev = z.device
    if fused:
        full = lambda v: torch.as_tensor(  # noqa: E731
            v, dtype=torch.float32, device=dev).reshape(()).expand(B)
        dx = torch.as_tensor(shift, dtype=torch.float32, device=dev)
        dx = dx.expand(B, grid.shape[-1]).contiguous()
        return apply_fused_sdecoder(decoder, grid, full(angle), dx, full(scale),
                                    z, act, sigmoid_out)
    coords = fixed_transform_grid(grid, angle, shift, scale)
    return decoder(coords.expand((B,) + coords.shape), z)


def fixed_transform_grid(grid: Tensor, angle=0.0, shift=0.0, scale=1.0
                         ) -> Tensor:
    """``grid [N, D]`` under one angle/shift/scale (shift is a scalar or
    ``[D]``; 1-D grids only shift)."""
    as_t = lambda v: torch.as_tensor(  # noqa: E731
        v, dtype=torch.float32, device=grid.device)
    return transform_coordinates(grid[None], as_t(angle)[None], as_t(shift),
                                 as_t(scale)[None])[0]


def chunked(fn, *arrays: Tensor, batch_size: Optional[int] = None):
    """Apply ``fn`` over row chunks of ``batch_size`` (all rows at once when
    None) and concatenate; ``fn`` may return a tensor or a tuple."""
    n = arrays[0].shape[0]
    if not batch_size or n <= batch_size:
        return fn(*arrays)
    outs = [fn(*(a[i:i + batch_size] for a in arrays))
            for i in range(0, n, batch_size)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


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

    def _module_decode(self, z: Tensor, y: Optional[Tensor] = None):
        """(decoded loc, warped grid or None) of latents ``z`` (and labels
        ``y``) through the decoder module."""
        coords, zc = self.transformed_grid(z)
        zc = with_labels(zc, y)
        if coords is None:
            return self.decoder_net(zc), None
        return self.decoder_net(coords, zc), coords

    def _decode_train(self, z: Tensor, y: Optional[Tensor] = None) -> Tensor:
        """The decoded loc ``[..., N(, C)]`` (or ``[..., prod(out)]``) of
        latents ``z [..., z_dim]``, their content joined by labels ``y``
        (``[..., *]``, or None): through the fused kernels when routed
        there, else the decoder module on the transformed grid."""
        if self.coord > 0 and self._fused:
            phi, dx, sc, zc = self.split_latent_full(z)
            return apply_fused_sdecoder(self.decoder_net, self.grid, phi, dx,
                                        sc, with_labels(zc, y), self._dec_act,
                                        self._dec_sig)
        return self._module_decode(z, y)[0]

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

    @torch.no_grad()
    def _decode_posed(self, z: Tensor, angle=0.0, shift=0.0, scale=1.0,
                      batch_size: Optional[int] = None, **kwargs) -> Tensor:
        """Decode decoder inputs ``z [B, *]`` under one fixed pose, chunked
        at ``batch_size`` rows; returns ``[B, *data_dim(, C)]``."""
        def dec(zz):
            return posed_decode(self.decoder_net, self.grid, zz, self._fused,
                                self.activation, self._dec_sig, angle, shift,
                                scale)

        loc = chunked(dec, z, batch_size=batch_size)
        return loc.reshape((z.shape[0],) + self.out_shape)

    # ------------------------------------------------------------------
    # Weights
    # ------------------------------------------------------------------
    def state_dict(self):
        return self.nets.state_dict()

    def load_jax_params(self, params) -> None:
        """Load the JAX model's parameter tree (``{"encoder_z": ...,
        "decoder": ...}``, plus ``"encoder_y"`` for the semi-supervised
        models; numpy leaves), with strict key and shape checks."""
        from ..weights import from_jax_params
        self.nets.load_state_dict(from_jax_params(params), strict=True)

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
            on_segment=None, data_scale=None, **kwargs):
        """Train for ``epochs`` epochs and return the trainer (its
        ``loss_history`` holds the per-epoch losses).

        ``X`` is an array or a DataLoader; ``y`` adds conditional features.
        ``test_data`` (an array, a tuple of arrays or a DataLoader) is
        evaluated after every epoch. ``data_scale=s`` keeps narrow-dtype
        ``X`` (e.g. raw uint8 images) in that dtype on the device and
        normalizes each batch by ``s``; integer ``X`` without it is
        rejected. Without ``verbose`` the trainer's ``run`` drives the
        epochs; with it, one ``step`` and ``print_statistics`` per epoch.
        Other keywords go to the trainer. ``patience``, ``on_segment`` and
        ``enum_schedule`` raise ``NotImplementedError`` naming their
        ROADMAP item."""
        from ..trainers.svi import SVItrainer
        from ..utils.data import DataLoader, init_dataloader
        for key, val in (("patience", patience), ("on_segment", on_segment),
                         ("enum_schedule", kwargs.pop("enum_schedule", None))):
            if val is not None:
                raise later_slice(f"fit({key}=...)", "trainer surface")
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
        if not verbose:
            trainer.run(loader, int(epochs), scale_factor=scale_factor,
                        test_loader=test_loader)
            return trainer
        for _ in range(int(epochs)):
            trainer.step(loader, test_loader, scale_factor=scale_factor)
            trainer.print_statistics()
        return trainer


_TRAINER_KWARGS = ("mesh", "checkpoint_path", "checkpoint_every", "log_file",
                   "optimizer", "seed", "task")


def fit_semi_supervised(model, X_unsup, labeled, val, epochs, batch_size, lr,
                        verbose, trainer, data_scale, kwargs):
    """The ``fit`` of ssiVAE and ss_reg_iVAE: loaders for the unlabeled,
    labeled and validation sets on the model's device, an auxSVItrainer,
    then its ``run``; with ``verbose`` or another trainer, one ``step``
    (and ``print_statistics``) per epoch. ``patience``, ``on_segment`` and
    ``enum_schedule`` raise ``NotImplementedError`` naming their ROADMAP
    item."""
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
    for key in ("patience", "on_segment", "enum_schedule"):
        if kwargs.pop(key, None) is not None:
            raise later_slice(f"fit({key}=...)", "trainer surface")
    kwargs.pop("min_delta", None)  # read by patience only
    for _ in range(int(epochs)):
        trainer.step(*loaders, **kwargs)
        if verbose:
            trainer.print_statistics()
    return trainer
