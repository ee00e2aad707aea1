"""Joint discrete-continuous invariant VAE (jiVAE).

Counterpart of ``pyroved_tpu/models/jivae.py``. The K-way discrete latent
is marginalized exactly, with one reparameterized z shared by the K
enumerated branches:

  ELBO = sum_k alpha_k log p(x | z, k)                      (reconstruction)
       + beta_c (log p(z) - log q(z|x))                     (continuous term)
       + beta_d sum_k alpha_k (log(1/K) - log alpha_k)       (discrete term)

The K branches decode in one call with leading dims [K, B]: through the
fused kernels (K1 forward, K2 backward) on K*B rows when the configuration
supports them, else through the decoder module with the coordinate head
computed once for the batch and broadcast over the branches.
``enum_topk=k`` decodes only the k most probable classes per example and
renormalizes their weights; the discrete term stays exact.
"""
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..infer.dists import get_sampler
from ..infer.elbo import normal_latent_site, obs_site
from ..nets.fc import init_from, jfcEncoderNet
from ..ops.spatial_decoder import apply_fused_sdecoder
from ..utils.coord import generate_latent_grid, generate_latent_grid_traversal
from ..utils.nn import later_slice, set_deterministic_mode, to_onehot
from .base import MODEL_KWARGS, baseVAE, check_kwargs, chunked

Tensor = torch.Tensor

_KWARGS = MODEL_KWARGS + ("enum_topk",)


def log_alpha(alpha: Tensor) -> Tensor:
    """log of class probabilities clipped at 1e-12, as the JAX package."""
    return torch.log(torch.clamp(alpha, min=1e-12))


def top_classes(alpha: Tensor, k: int):
    """(renormalized weights [B, k], one-hot codes [k, B, K], the top
    probabilities [B, k]) of the ``k`` most probable classes per row.

    Tie rule: ``jax.lax.top_k`` returns the lower index first among equal
    probabilities; ``torch.topk`` does not promise an order there, so
    inputs with ties can pick other branches than the JAX package."""
    a_top, idx = torch.topk(alpha, k, dim=-1)
    w_top = a_top / a_top.sum(-1, keepdim=True)
    eye = torch.eye(alpha.shape[-1], dtype=alpha.dtype, device=alpha.device)
    return w_top, eye[idx].permute(1, 0, 2), a_top


class jiVAE(baseVAE):
    """VAE with a continuous latent and a ``discrete_dim``-way discrete one,
    plus optional rotational / translational / scale invariances.

    Arguments as in the JAX package: ``data_dim``, ``latent_dim``,
    ``discrete_dim``, ``invariances``, ``hidden_dim_e``/``hidden_dim_d``,
    ``activation``, ``sampler_d``, ``sigmoid_d``, ``seed``; keywords as
    :class:`~pyroved_tpu_torch.models.iVAE`'s (``fused``, ``kl``,
    ``num_particles``, ...) and ``enum_topk``. ``scale_factor`` is a scalar
    or a ``[beta_continuous, beta_discrete]`` pair. ``device``: None means
    "cuda"; without CUDA pass ``device="cpu"``.
    """

    def __init__(
        self,
        data_dim: Sequence[int],
        latent_dim: int,
        discrete_dim: int,
        invariances: Optional[List[str]] = None,
        hidden_dim_e: Optional[Sequence[int]] = None,
        hidden_dim_d: Optional[Sequence[int]] = None,
        activation: str = "tanh",
        sampler_d: str = "bernoulli",
        sigmoid_d: bool = True,
        seed: int = 1,
        device=None,
        **kwargs,
    ) -> None:
        check_kwargs("jiVAE", kwargs, _KWARGS)
        super().__init__(data_dim, invariances, device=device, **kwargs)
        self.generator = set_deterministic_mode(seed)
        self.latent_dim = int(latent_dim)
        self.z_dim = self.latent_dim + self.coord
        self.discrete_dim = int(discrete_dim)
        self.enum_topk = int(kwargs.get("enum_topk", 0) or 0)
        if self.enum_topk and not 1 <= self.enum_topk <= self.discrete_dim:
            raise ValueError(
                f"enum_topk must be in [1, discrete_dim={self.discrete_dim}]"
                f", got {self.enum_topk}")
        encoder = jfcEncoderNet(self.out_shape, self.z_dim, self.discrete_dim,
                                hidden_dim_e, activation, softplus_out=True)
        decoder = self._make_decoder(self.latent_dim + self.discrete_dim,
                                     hidden_dim_d, activation, sigmoid_d,
                                     kwargs)
        self.nets = nn.ModuleDict({
            "encoder_z": init_from(encoder, self.generator),
            "decoder": init_from(decoder, self.generator),
        }).to(self.device)
        self.sampler_d = get_sampler(sampler_d, **kwargs)

    def prep_beta(self, scale_factor):
        """``scale_factor`` as a ``[beta_cont, beta_disc]`` pair: a tensor
        stays one, on the model's device; a number or a pair of numbers
        becomes a pair of floats (rounded to float32, as the JAX package
        holds them), so that no copy to the device makes the host wait for
        the device in every step."""
        if isinstance(scale_factor, Tensor):
            beta = scale_factor.to(device=self.device, dtype=torch.float32)
            return beta.expand(2) if beta.ndim == 0 else beta
        beta = np.asarray(scale_factor, np.float32).reshape(-1)
        return tuple(float(b) for b in np.broadcast_to(beta, (2,)))

    def noise_shapes(self, batch_size: int, labeled: bool = False):
        """Shapes of the standard-normal noise one batch needs: the shared
        z of every branch, ``[P*B, z_dim]`` with ``num_particles=P``."""
        return ((self.num_particles * batch_size, self.z_dim),)

    # ------------------------------------------------------------------
    # ELBO
    # ------------------------------------------------------------------
    def _enum_decode(self, z: Tensor, fused: bool, onehots=None):
        """Decode every enumerated branch of latents ``z [B, z_dim]`` in one
        call: the content latents broadcast over the one-hot codes
        ``onehots [K, B, K]`` (default: every class). Returns ``(coords,
        loc [K, B, N(, C)])``; coords (the warped grid ``[B, N, D]``) is
        None on the fused path and without invariances."""
        B, K = z.shape[0], self.discrete_dim
        if onehots is None:
            eye = torch.eye(K, dtype=z.dtype, device=z.device)
            onehots = eye[:, None, :].expand(K, B, K)
        Ke = onehots.shape[0]
        if fused and self.coord > 0:
            # the branches share phi, dx and sc; autograd sums their grads
            # back over the K copies
            phi, dx, sc, zc = self.split_latent_full(z)
            zc_k = torch.cat([zc.expand((Ke,) + zc.shape), onehots], -1)
            loc = apply_fused_sdecoder(
                self.decoder_net, self.grid, phi.expand(Ke, B),
                dx.expand((Ke,) + dx.shape), sc.expand(Ke, B), zc_k,
                self._dec_act, self._dec_sig)
            return None, loc
        coords, zc = self.transformed_grid(z)
        zc_k = torch.cat([zc.expand((Ke,) + zc.shape), onehots], -1)
        if coords is None:
            return None, self.decoder_net(zc_k)
        # the coordinate head once for [B, N], broadcast against each
        # branch's latent head (the module broadcasts [B, N, H] + [K, B, 1, H])
        return coords, self.decoder_net(coords, zc_k)

    def _loss_single(self, x: Tensor, y, beta: Tensor, eps) -> Tensor:
        B, K = x.shape[0], self.discrete_dim
        xf = x.reshape(B, -1)
        mu, sig, alpha = self.encoder_net(xf)
        z, latent_term = normal_latent_site(mu, sig, beta[0], self.kl_mode,
                                            eps=eps, generator=self.generator)
        disc_term = beta[1] * torch.sum(
            alpha * (-math.log(K) - log_alpha(alpha)), dim=-1)
        w, onehots = alpha, None
        if self.enum_topk:
            w, onehots, _ = top_classes(alpha, self.enum_topk)
        _, loc = self._enum_decode(z, self._fused, onehots)
        recon_k = obs_site(self.sampler_d, xf[None],
                           loc.reshape(loc.shape[0], B, -1))
        recon = torch.sum(w.T * recon_k, dim=0)
        return -(recon + latent_term + disc_term)

    def loss_fn(self, x, y=None, beta=1.0, eps=None) -> Tensor:
        """Per-example negative ELBO ``[B]`` with the exact K-way
        enumeration (or ``enum_topk``), averaged over ``num_particles``
        estimates. ``beta`` is a scalar or a ``[beta_cont, beta_disc]``
        pair; ``eps`` the latent noise (:meth:`noise_shapes`), drawn from
        the model's generator when not given. ``y`` is ignored (the
        trainers' batches may carry it)."""
        x = self._as_f32(x)
        eps = None if eps is None else self._as_f32(eps)
        return self._particles(self._loss_single, x, None,
                               self.prep_beta(beta), eps)

    def weighted_loss_fn(self, x, y, weights, beta=1.0, eps=None) -> Tensor:
        """The scalar training loss ``sum_b weights_b * (-ELBO_b)``."""
        return torch.sum(self.loss_fn(x, y, beta, eps)
                         * self._as_f32(weights))

    def trace(self, x, beta=1.0, eps=None) -> dict:
        """Every site of one guide + model execution through the decoder
        module: ``latent_cont.loc / .scale / .value``, ``latent_disc.probs /
        .enumerated`` ([K, B, K]), ``transform.phi / .dx / .sc``,
        ``coords``, ``obs.loc`` ([K, B, N]), ``recon_logp_k`` ([K, B]),
        ``recon_logp``, ``latent_term`` and ``disc_term``."""
        x = self._as_f32(x)
        B, K = x.shape[0], self.discrete_dim
        xf = x.reshape(B, -1)
        betas = self.prep_beta(beta)
        mu, sig, alpha = self.encoder_net(xf)
        eps = None if eps is None else self._as_f32(eps)
        z, latent_term = normal_latent_site(mu, sig, betas[0], self.kl_mode,
                                            eps=eps, generator=self.generator)
        disc_term = betas[1] * torch.sum(
            alpha * (-math.log(K) - log_alpha(alpha)), dim=-1)
        eye = torch.eye(K, dtype=xf.dtype, device=xf.device)
        phi = dx = sc = None
        if self.coord > 0:
            phi, dx, sc, _ = self.split_latent_full(z)
        coords, loc = self._enum_decode(z, False)
        recon_k = obs_site(self.sampler_d, xf[None], loc.reshape(K, B, -1))
        return {
            "latent_cont": {"loc": mu, "scale": sig, "value": z},
            "latent_disc": {"probs": alpha,
                            "enumerated": eye[:, None, :].expand(K, B, K)},
            "transform": {"phi": phi, "dx": dx, "sc": sc},
            "coords": coords,
            "obs": {"loc": loc},
            "recon_logp_k": recon_k,
            "recon_logp": torch.sum(alpha.T * recon_k, dim=0),
            "latent_term": latent_term,
            "disc_term": disc_term,
        }

    # ------------------------------------------------------------------
    # Inference / generation
    # ------------------------------------------------------------------
    @torch.no_grad()
    def encode(self, x_new, logits: bool = False,
               batch_size: Optional[int] = None, **kwargs):
        """``(z_loc, z_scale, classes)``: classes are argmax indices, or the
        class probabilities with ``logits=True``. ``batch_size`` chunks."""
        x = self._as_f32(x_new)
        x = x.reshape(x.shape[0], -1)
        z_loc, z_scale, alpha = chunked(self.encoder_net, x,
                                        batch_size=batch_size)
        return z_loc, z_scale, alpha if logits else torch.argmax(alpha, 1)

    @torch.no_grad()
    def guide_probs(self, x) -> Tensor:
        """q(k|x), the class probabilities the enumeration weights by."""
        x = self._as_f32(x)
        return self.encoder_net(x.reshape(x.shape[0], -1))[2]

    @torch.no_grad()
    def decode(self, z, y, angle=0.0, shift=0.0, scale=1.0,
               batch_size: Optional[int] = None, **kwargs) -> Tensor:
        """Decode content latents ``z`` with one-hot classes ``y`` under a
        fixed angle/shift/scale; returns ``[B, *data_dim(, C)]``."""
        z = self._as_f32(z)
        z = torch.cat([z, self._as_f32(y).reshape(z.shape[0], -1)], -1)
        return self._decode_posed(z, angle, shift, scale, batch_size)

    def manifold2d(self, d: int, disc_idx: int = 0, plot: bool = False,
                   **kwargs) -> Tensor:
        """Decode a d x d grid over the continuous latent plane for the
        class ``disc_idx``. ``which_dims``/``z_fixed`` pick the plane when
        ``latent_dim > 2``; ``z_coord`` sets the bounds. Plotting waits for
        a later slice."""
        if plot:
            raise later_slice("jiVAE.manifold2d(plot=True)", "viz")
        which, zfix = kwargs.pop("which_dims", None), kwargs.pop("z_fixed", None)
        z, _ = generate_latent_grid(d, z_coord=kwargs.pop("z_coord", None))
        z = self._embed_latent_plane(z.to(self.device), self.latent_dim,
                                     which, zfix)
        z_disc = to_onehot([disc_idx], self.discrete_dim, self.device)
        return self.decode(z, z_disc.expand(z.shape[0], -1), **kwargs)

    def manifold_traversal(self, d: int, cont_idx: int,
                           cont_idx_fixed: int = 0, plot: bool = False,
                           **kwargs) -> Tensor:
        """Decode a joint traversal: continuous latent ``cont_idx`` swept
        over d values for each of d class codes (``d*d`` images)."""
        if plot:
            raise later_slice("jiVAE.manifold_traversal(plot=True)", "viz")
        cont, disc = generate_latent_grid_traversal(
            d, self.latent_dim, self.discrete_dim, cont_idx, cont_idx_fixed,
            d ** 2)
        return self.decode(cont, disc, **kwargs)
