"""Semi-supervised classification VAE (ssiVAE, Kingma's M2).

Counterpart of ``pyroved_tpu/models/ssivae.py``. Three networks: the
q(z|x,y) encoder (``encoder_z``), the q(y|x) classifier (``encoder_y``) and
the p(x|z,y) decoder. A labeled batch observes y. An unlabeled batch
enumerates the K classes exactly: each branch draws its own z ~ q(z|x,y_k),
so the latent noise is ``[K, B, z_dim]``, all K branches decode in one call
(K*B rows through the fused kernels), and the branch ELBOs are averaged
under q(y|x). ``enum_topk=k`` keeps the k most probable branches,
renormalized. The auxiliary objective on labeled batches is
``-aux_loss_multiplier * log q(y|x)``.
"""
import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ..infer.dists import get_sampler
from ..infer.elbo import normal_latent_site, obs_site
from ..nets.fc import fcClassifierNet, fcEncoderNet, init_from
from ..utils.coord import generate_latent_grid, generate_latent_grid_traversal
from ..utils.nn import later_slice, set_deterministic_mode, to_onehot
from .base import (MODEL_KWARGS, baseVAE, check_kwargs, chunked,
                   fit_semi_supervised)
from .jivae import log_alpha, top_classes

Tensor = torch.Tensor

_KWARGS = MODEL_KWARGS + ("enum_topk",)


class ssiVAE(baseVAE):
    """Semi-supervised invariant VAE for classification.

    Arguments as in the JAX package: ``data_dim``, ``latent_dim``,
    ``num_classes``, ``invariances``, ``hidden_dim_e``, ``hidden_dim_d``,
    ``hidden_dim_cls``, ``activation``, ``sampler_d``, ``sigmoid_d``,
    ``seed``; keywords as :class:`~pyroved_tpu_torch.models.iVAE`'s and
    ``enum_topk``. ``device``: None means "cuda"; without CUDA pass
    ``device="cpu"``. Train with :meth:`fit` or
    :class:`~pyroved_tpu_torch.trainers.auxSVItrainer`.
    """

    task = "classification"

    def __init__(
        self,
        data_dim: Sequence[int],
        latent_dim: int,
        num_classes: int,
        invariances: Optional[List[str]] = None,
        hidden_dim_e: Optional[Sequence[int]] = None,
        hidden_dim_d: Optional[Sequence[int]] = None,
        hidden_dim_cls: Optional[Sequence[int]] = None,
        activation: str = "tanh",
        sampler_d: str = "bernoulli",
        sigmoid_d: bool = True,
        seed: int = 1,
        device=None,
        **kwargs,
    ) -> None:
        check_kwargs("ssiVAE", kwargs, _KWARGS)
        super().__init__(data_dim, invariances, device=device, **kwargs)
        self.generator = set_deterministic_mode(seed)
        self.latent_dim = int(latent_dim)
        self.z_dim = self.latent_dim + self.coord
        self.num_classes = int(num_classes)
        self.enum_topk = int(kwargs.get("enum_topk", 0) or 0)
        if self.enum_topk and not 1 <= self.enum_topk <= self.num_classes:
            raise ValueError(
                f"enum_topk must be in [1, num_classes={self.num_classes}]"
                f", got {self.enum_topk}")
        encoder = fcEncoderNet(self.out_shape, self.z_dim, self.num_classes,
                               hidden_dim_e, activation, softplus_out=True)
        classifier = fcClassifierNet(self.out_shape, self.num_classes,
                                     hidden_dim_cls, activation)
        decoder = self._make_decoder(self.latent_dim + self.num_classes,
                                     hidden_dim_d, activation, sigmoid_d,
                                     kwargs)
        self.nets = nn.ModuleDict({
            "encoder_z": init_from(encoder, self.generator),
            "encoder_y": init_from(classifier, self.generator),
            "decoder": init_from(decoder, self.generator),
        }).to(self.device)
        self.sampler_d = get_sampler(sampler_d, **kwargs)

    @property
    def encoder_y_net(self) -> nn.Module:
        return self.nets["encoder_y"]

    def noise_shapes(self, batch_size: int, labeled: bool = False):
        """Shapes of the standard-normal noise one batch needs: ``[P*B,
        z_dim]`` for a labeled batch, ``[K, P*B, z_dim]`` (K the enumerated
        branches: ``num_classes``, or ``enum_topk``) for an unlabeled one."""
        rows = self.num_particles * batch_size
        if labeled:
            return ((rows, self.z_dim),)
        return ((self.enum_topk or self.num_classes, rows, self.z_dim),)

    # ------------------------------------------------------------------
    # ELBO
    # ------------------------------------------------------------------
    def _branch_elbo(self, xf: Tensor, ys: Tensor, beta, eps) -> Tensor:
        """recon + beta (log p(z) - log q(z|x,y)) with z ~ q(z|x,y);
        xf [..., D], ys [..., K], eps [..., z_dim] -> [...]."""
        mu, sig = self.encoder_net(xf, ys)
        z, lat = normal_latent_site(mu, sig, beta, self.kl_mode, eps=eps,
                                    generator=self.generator)
        loc = self._decode_train(z, ys)
        return obs_site(self.sampler_d, xf, loc.reshape(xf.shape)) + lat

    def _enumerated(self, xf: Tensor):
        """(weights [B, Ke], one-hot codes [Ke, B, K], log q(y_k|x) [B, Ke])
        of an unlabeled batch: every class, or the ``enum_topk`` most
        probable ones renormalized (log q stays the untruncated guide's)."""
        alpha = self.encoder_y_net(xf)
        if self.enum_topk:
            w, ys_k, a_top = top_classes(alpha, self.enum_topk)
            return w, ys_k, log_alpha(a_top)
        B, K = xf.shape[0], self.num_classes
        eye = torch.eye(K, dtype=xf.dtype, device=xf.device)
        return alpha, eye[:, None, :].expand(K, B, K), log_alpha(alpha)

    def _loss_single(self, x: Tensor, y: Optional[Tensor], beta,
                     eps) -> Tensor:
        B = x.shape[0]
        xf = x.reshape(B, -1)
        log_prior_y = -math.log(self.num_classes)
        if y is not None:
            return -(self._branch_elbo(xf, y, beta, eps) + log_prior_y)
        w, ys_k, log_q = self._enumerated(xf)
        xf_k = xf.expand((ys_k.shape[0],) + xf.shape)
        elbo_k = self._branch_elbo(xf_k, ys_k, beta, eps)         # [Ke, B]
        branch = elbo_k + log_prior_y - log_q.T   # + log p(y) - log q(y|x)
        return -torch.sum(w.T * branch, dim=0)

    def loss_fn(self, x, y=None, beta=1.0, eps=None) -> Tensor:
        """Per-example negative ELBO ``[B]``: a labeled batch observes the
        one-hot ``y``; an unlabeled one (``y=None``) enumerates the classes.
        Averaged over ``num_particles`` estimates. ``eps`` is the latent
        noise (:meth:`noise_shapes`), drawn from the model's generator when
        not given."""
        x = self._as_f32(x)
        y = None if y is None else self._as_f32(y).reshape(x.shape[0], -1)
        eps = None if eps is None else self._as_f32(eps)
        return self._particles(self._loss_single, x, y, beta, eps)

    def weighted_loss_fn(self, x, y, weights, beta=1.0, eps=None) -> Tensor:
        """The scalar training loss ``sum_b weights_b * (-ELBO_b)``."""
        return torch.sum(self.loss_fn(x, y, beta, eps)
                         * self._as_f32(weights))

    def aux_loss_fn(self, x, y, aux_loss_multiplier=20.0) -> Tensor:
        """The auxiliary objective per example, ``-mult * log q(y|x)``, on a
        labeled batch; zeros without labels."""
        x = self._as_f32(x)
        if y is None:
            return x.new_zeros(x.shape[0])
        alpha = self.encoder_y_net(x.reshape(x.shape[0], -1))
        y = self._as_f32(y).reshape(alpha.shape)
        return -aux_loss_multiplier * torch.sum(y * log_alpha(alpha), -1)

    def trace(self, x, beta=1.0, eps=None) -> dict:
        """The enumerated sites of an unlabeled batch: ``y.probs`` [B, K] and
        ``y.enumerated`` [K, B, K], ``z.loc / .scale / .value`` [K, B,
        z_dim] (one z per branch) and ``branch_elbo`` [K, B]."""
        x = self._as_f32(x)
        B, K = x.shape[0], self.num_classes
        xf = x.reshape(B, -1)
        alpha = self.encoder_y_net(xf)
        eye = torch.eye(K, dtype=xf.dtype, device=xf.device)
        ys_k = eye[:, None, :].expand(K, B, K)
        xf_k = xf.expand(K, B, xf.shape[-1])
        mu, sig = self.encoder_net(xf_k, ys_k)
        if eps is None:
            eps = torch.randn(mu.shape, generator=self.generator).to(mu)
        eps = self._as_f32(eps)
        return {
            "y": {"probs": alpha, "enumerated": ys_k},
            "z": {"loc": mu, "scale": sig, "value": mu + sig * eps},
            "branch_elbo": self._branch_elbo(xf_k, ys_k, beta, eps),
        }

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def _labels(self, y) -> Tensor:
        """Labels as the loaders hold them: one-hot rows of class indices."""
        y = self._as_f32(y)
        return to_onehot(y, self.num_classes, self.device) if y.ndim < 2 else y

    def fit(self, X_unsup, labeled, val=None, epochs: int = 100,
            batch_size: int = 100, lr: float = 5e-4, verbose: bool = False,
            trainer=None, data_scale=None, **kwargs):
        """Semi-supervised training: ``labeled`` is ``(X, y)`` (y one-hot or
        class indices), ``val`` an optional ``(X, y)`` pair (default: the
        labeled set). Returns the :class:`auxSVItrainer`, whose ``history``
        holds the per-epoch losses and validation metrics. Without
        ``verbose`` its ``run`` drives the epochs; other keywords go to
        ``run`` (``scale_factor``, ``aux_loss_multiplier``, ``sup_period``,
        ...) or, for ``optimizer``, ``seed``, ``task`` and the later-slice
        ``mesh``/``checkpoint_path``/``log_file``, to the trainer."""
        return fit_semi_supervised(self, X_unsup, labeled, val, epochs,
                                   batch_size, lr, verbose, trainer,
                                   data_scale, kwargs)

    # ------------------------------------------------------------------
    # Inference / generation
    # ------------------------------------------------------------------
    def set_classifier(self, cls_net: nn.Module) -> None:
        """Put a user-defined classifier in place of ``encoder_y``, its
        Dense layers redrawn from the model's generator. Build trainers
        after this call: they hold the parameters they optimize."""
        self.nets["encoder_y"] = init_from(cls_net, self.generator).to(
            self.device)

    @torch.no_grad()
    def guide_probs(self, x) -> Tensor:
        """q(y|x), the classifier's class probabilities."""
        x = self._as_f32(x)
        return self.encoder_y_net(x.reshape(x.shape[0], -1))

    @torch.no_grad()
    def classifier(self, x_new, batch_size: Optional[int] = None,
                   **kwargs) -> Tensor:
        """Predicted class indices; ``batch_size`` chunks the rows."""
        x = self._as_f32(x_new)
        x = x.reshape(x.shape[0], -1)
        probs = chunked(self.encoder_y_net, x, batch_size=batch_size)
        return torch.argmax(probs, -1)

    @torch.no_grad()
    def encode(self, x_new, y=None, batch_size: Optional[int] = None,
               **kwargs):
        """``(z_loc, z_scale, classes)`` of q(z|x,y); without labels the
        classifier's predictions stand in for them."""
        x = self._as_f32(x_new)
        x = x.reshape(x.shape[0], -1)
        if y is None:
            y_idx = self.classifier(x, batch_size)
            y1h = to_onehot(y_idx, self.num_classes, self.device)
        else:
            y1h = self._labels(y)
            y_idx = torch.argmax(y1h, 1)
        z_loc, z_scale = chunked(self.encoder_net, x, y1h,
                                 batch_size=batch_size)
        return z_loc, z_scale, y_idx

    @torch.no_grad()
    def decode(self, z, y, angle=0.0, shift=0.0, scale=1.0,
               batch_size: Optional[int] = None, **kwargs) -> Tensor:
        """Decode content latents ``z`` with one-hot classes ``y`` under a
        fixed angle/shift/scale; returns ``[B, *data_dim(, C)]``."""
        z = self._as_f32(z)
        z = torch.cat([z, self._as_f32(y).reshape(z.shape[0], -1)], -1)
        return self._decode_posed(z, angle, shift, scale, batch_size)

    def manifold2d(self, d: int, plot: bool = False, **kwargs) -> Tensor:
        """Decode a d x d grid over the latent plane for the class
        ``label=`` (an index or a one-hot row; default 0). ``which_dims``,
        ``z_fixed`` and ``z_coord`` as iVAE's."""
        if plot:
            raise later_slice("ssiVAE.manifold2d(plot=True)", "viz")
        which, zfix = kwargs.pop("which_dims", None), kwargs.pop("z_fixed", None)
        z, _ = generate_latent_grid(d, z_coord=kwargs.pop("z_coord", None))
        z = self._embed_latent_plane(z.to(self.device), self.latent_dim,
                                     which, zfix)
        cls = self._as_f32(kwargs.pop("label", 0))
        if cls.ndim < 2:
            cls = to_onehot(cls.reshape(1), self.num_classes, self.device)
        return self.decode(z, cls.expand(z.shape[0], self.num_classes),
                           **kwargs)

    def manifold_traversal(self, d: int, cont_idx: int,
                           cont_idx_fixed: int = 0, plot: bool = False,
                           **kwargs) -> Tensor:
        """Decode a joint traversal over the classes and one continuous
        latent (``d*d`` images)."""
        if plot:
            raise later_slice("ssiVAE.manifold_traversal(plot=True)", "viz")
        cont, disc = generate_latent_grid_traversal(
            d, self.latent_dim, self.num_classes, cont_idx, cont_idx_fixed,
            d ** 2)
        return self.decode(cont, disc, **kwargs)
