"""Invariant variational autoencoder (iVAE).

Counterpart of ``pyroved_tpu/models/ivae.py``: a VAE with optional
rotational / translational / scale invariances and optional conditioning
on a vector of ``c_dim`` features. It trains (:meth:`iVAE.weighted_loss_fn`
under ``fit`` and ``SVItrainer``) and serves: encode, posed decode,
reconstruct, latent manifolds and per-example ELBO scoring
(:meth:`iVAE.loss_fn`). Every spatial decode runs through the fused decoder
kernels when the configuration supports them: the forward kernel, its
backward kernel under autograd, or, with ``one_pass_train=True``, the
one-pass Bernoulli train kernel.
"""
from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ..infer.dists import get_sampler
from ..infer.elbo import normal_latent_site, obs_site
from ..nets.fc import fcEncoderNet, init_from
from ..ops.spatial_decoder import (KERNEL_ACTS_WITH_APPROX,
                                   apply_fused_recon_loss)
from ..utils.coord import generate_latent_grid
from ..utils.nn import set_deterministic_mode
from .base import (MODEL_KWARGS, baseVAE, check_kwargs, chunked, later_slice,
                   with_labels)

Tensor = torch.Tensor

_KWARGS = MODEL_KWARGS + ("one_pass_train",)


class iVAE(baseVAE):
    """Variational autoencoder with rotational, translational and scale
    invariances, optionally conditioned on ``c_dim`` features.

    Arguments as in the JAX package: ``data_dim``, ``latent_dim``,
    ``invariances`` (subset of ['r', 't', 's']), ``c_dim``,
    ``hidden_dim_e``/``hidden_dim_d`` (default [128, 128]), ``activation``,
    ``sampler_d``, ``sigmoid_d``, ``seed``; keywords ``dx_prior``,
    ``dy_prior``, ``sc_prior``, ``decoder_sig``, ``kl`` ('mc' or
    'analytic'), ``num_particles``, ``approx_tanh``, ``channels``,
    ``fused`` (False sends every decode to the ``sDecoderNet`` module) and
    ``one_pass_train`` (train through the one-pass loss kernel). Plus
    ``device``: None means "cuda"; without CUDA pass ``device="cpu"``.
    Weights are drawn from ``seed`` with torch's default Linear init.
    """

    def __init__(
        self,
        data_dim: Sequence[int],
        latent_dim: int = 2,
        invariances: Optional[List[str]] = None,
        c_dim: int = 0,
        hidden_dim_e: Optional[Sequence[int]] = None,
        hidden_dim_d: Optional[Sequence[int]] = None,
        activation: str = "tanh",
        sampler_d: str = "bernoulli",
        sigmoid_d: bool = True,
        seed: int = 1,
        device=None,
        **kwargs,
    ) -> None:
        check_kwargs("iVAE", kwargs, _KWARGS)
        super().__init__(data_dim, invariances, device=device, **kwargs)
        self.generator = set_deterministic_mode(seed)
        self.latent_dim = int(latent_dim)
        self.z_dim = self.latent_dim + self.coord
        self.c_dim = int(c_dim)

        encoder = fcEncoderNet(self.out_shape, self.z_dim, self.c_dim,
                               hidden_dim_e, activation, softplus_out=True)
        decoder = self._make_decoder(self.latent_dim + self.c_dim,
                                     hidden_dim_d, activation, sigmoid_d,
                                     kwargs)
        self.nets = nn.ModuleDict({
            "encoder_z": init_from(encoder, self.generator),
            "decoder": init_from(decoder, self.generator),
        }).to(self.device)
        self.sampler_d = get_sampler(sampler_d, **kwargs)
        self.one_pass_train = bool(kwargs.get("one_pass_train", False))

    def noise_shapes(self, batch_size: int, labeled: bool = False):
        """Shape of the standard-normal latent noise one batch needs, like
        the posterior: ``[B, z_dim]``, or ``[P, B, z_dim]`` with
        ``num_particles=P``."""
        P = self.num_particles
        return (((P,) if P > 1 else ()) + (batch_size, self.z_dim),)

    # ------------------------------------------------------------------
    # ELBO
    # ------------------------------------------------------------------
    def _posterior(self, x, y, beta, eps):
        """(flat x, y, loc, scale, z, latent term) of one batch: q(z|x[,y]),
        its sample (``eps`` given or drawn from the model's generator) and
        the beta-scaled latent ELBO term."""
        x = self._as_f32(x)
        B = x.shape[0]
        xf = x.reshape(B, -1)
        y = None if y is None else self._as_f32(y).reshape(B, -1)
        mu, sig = self.encoder_net(xf, y)
        if self.num_particles > 1:  # leading particle axis, one decode
            P = self.num_particles
            mu = mu.expand((P,) + mu.shape)
            sig = sig.expand((P,) + sig.shape)
            if y is not None:
                y = y.expand((P,) + y.shape)
        if eps is not None:
            eps = self._as_f32(eps)
        z, latent_term = normal_latent_site(mu, sig, beta, self.kl_mode,
                                            eps=eps, generator=self.generator)
        return xf, y, mu, sig, z, latent_term

    def loss_fn(self, x, y=None, beta: float = 1.0, eps=None) -> Tensor:
        """Per-example negative ELBO ``[B]`` of a batch ``x`` (and ``y``).

        ``eps`` is the standard-normal noise of the latent sample, shaped
        like the posterior (``[B, z_dim]``, or ``[P, B, z_dim]`` with
        ``num_particles=P``); it is drawn from the model's generator when
        not given. The reconstruction term is unscaled; ``beta`` scales the
        latent term. It records gradients when autograd is on (the decode
        then runs the backward kernel too); score under
        ``torch.no_grad()``."""
        xf, y, _, _, z, latent_term = self._posterior(x, y, beta, eps)
        loc = self._decode_train(z, y)
        recon = obs_site(self.sampler_d, xf, loc.reshape(z.shape[:-1] + (-1,)))
        per_example = -(recon + latent_term)
        return per_example.mean(0) if self.num_particles > 1 else per_example

    def _one_pass(self) -> bool:
        """The gate of the one-pass train kernel: opted in, a fused spatial
        decoder with one channel and a sigmoid head, a Bernoulli sampler
        and one particle."""
        return (self.one_pass_train and self.coord > 0 and self._fused
                and self.num_particles == 1 and self.channels == 1
                and self.sampler_d.name == "bernoulli" and self._dec_sig
                and self._dec_act in KERNEL_ACTS_WITH_APPROX)

    def weighted_loss_fn(self, x, y, weights, beta: float = 1.0,
                         eps=None) -> Tensor:
        """The scalar training loss ``sum_b weights_b * (-ELBO_b)``.

        With ``one_pass_train=True`` (and a configuration the one-pass
        kernel takes) the reconstruction term and all its gradients come
        from that kernel; otherwise this weights :meth:`loss_fn`."""
        weights = self._as_f32(weights)
        if not self._one_pass():
            return torch.sum(self.loss_fn(x, y, beta, eps) * weights)
        xf, y, _, _, z, latent_term = self._posterior(x, y, beta, eps)
        phi, dx, sc, zc = self.split_latent_full(z)
        recon_neg = apply_fused_recon_loss(
            self.decoder_net, self.grid, phi, dx, sc, with_labels(zc, y), xf,
            weights, self._dec_act)
        return recon_neg - torch.sum(weights * latent_term)

    def trace(self, x, y=None, beta: float = 1.0, eps=None) -> dict:
        """Every intermediate value of one guide + model execution, keyed
        by site, through the ``sDecoderNet`` module: ``latent.loc /
        .scale / .value``, ``transform.phi / .dx / .sc``, ``coords`` (the
        warped grid, None without invariances), ``obs.loc``,
        ``recon_logp`` and ``latent_term``."""
        xf, y, mu, sig, z, latent_term = self._posterior(x, y, beta, eps)
        phi = dx = sc = None
        if self.coord > 0:
            phi, dx, sc, _ = self.split_latent_full(z)
        loc, coords = self._module_decode(z, y)
        recon = obs_site(self.sampler_d, xf, loc.reshape(xf.shape[0], -1))
        return {
            "latent": {"loc": mu, "scale": sig, "value": z},
            "transform": {"phi": phi, "dx": dx, "sc": sc},
            "coords": coords,
            "obs": {"loc": loc},
            "recon_logp": recon,
            "latent_term": latent_term,
        }

    # ------------------------------------------------------------------
    # Inference / generation
    # ------------------------------------------------------------------
    @torch.no_grad()
    def encode(self, x_new, y=None, batch_size: Optional[int] = None, **kwargs):
        """``(z_loc, z_scale)`` of q(z|x[,y]); the first ``coord`` latent
        dims are the rotation, shift and scale ones. ``batch_size`` chunks
        the rows."""
        x = self._as_f32(x_new)
        x = x.reshape(x.shape[0], -1)
        if y is None:
            return chunked(self.encoder_net, x, batch_size=batch_size)
        y = self._as_f32(y).reshape(x.shape[0], -1)
        return chunked(self.encoder_net, x, y, batch_size=batch_size)

    @torch.no_grad()
    def decode(self, z, y=None, angle=0.0, shift=0.0, scale=1.0,
               batch_size: Optional[int] = None, **kwargs) -> Tensor:
        """Decode content latents (and ``y``) under a fixed
        angle/shift/scale; returns ``[B, *data_dim(, C)]``."""
        z = self._as_f32(z)
        if y is not None:
            z = torch.cat([z, self._as_f32(y).reshape(z.shape[0], -1)], -1)
        return self._decode_posed(z, angle, shift, scale, batch_size)

    def reconstruct(self, x_new, y=None, **kwargs) -> Tensor:
        """Encode, then decode the posterior mean's content latents (in the
        canonical pose unless ``angle``/``shift``/``scale`` re-pose it)."""
        z_loc, _ = self.encode(x_new, y, **kwargs)
        return self.decode(z_loc[:, self.coord:], y, **kwargs)

    def manifold2d(self, d: int, y=None, plot: bool = False, **kwargs) -> Tensor:
        """Decode a d x d grid over the 2-D latent plane. For
        ``latent_dim > 2`` pass ``which_dims=(i, j)`` (and ``z_fixed``);
        ``z_coord=`` sets the bounds. Plotting waits for a later slice."""
        if plot:
            raise later_slice("manifold2d(plot=True)", "viz")
        which, zfix = kwargs.pop("which_dims", None), kwargs.pop("z_fixed", None)
        z, _ = generate_latent_grid(d, z_coord=kwargs.pop("z_coord", None))
        z = self._embed_latent_plane(z.to(self.device), self.latent_dim,
                                     which, zfix)
        if self.c_dim > 0:
            if y is None:
                raise ValueError("To generate a manifold pass a conditional vector y")
            y = self._as_f32(y)
            y = y[None] if y.ndim < 2 else y
            y = y.expand((z.shape[0],) + y.shape[1:])
        return self.decode(z, y, **kwargs)

    def predict_on_latent(self, *args, **kwargs):
        raise later_slice("iVAE.predict_on_latent", "viz")
