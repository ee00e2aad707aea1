"""Semi-supervised regression VAE (ss_reg_iVAE).

Counterpart of ``pyroved_tpu/models/ss_reg_ivae.py``, the continuous-label
analogue of ssiVAE: the label prior is N(0, regressor_sig) (default 0.5).
A labeled batch observes y; an unlabeled one draws one reparameterized
y ~ N(encoder_y(x), regressor_sig) and scores it against the prior and the
guide. Each batch decodes once (B rows through the fused kernels). The
auxiliary objective on labeled batches is
``-aux_loss_multiplier * log N(y; encoder_y(x), regressor_sig)``.
"""
from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from ..infer.dists import get_sampler, normal_log_prob
from ..infer.elbo import normal_latent_site
from ..nets.fc import fcEncoderNet, fcRegressorNet, init_from
from ..utils.coord import generate_latent_grid
from ..utils.nn import set_deterministic_mode
from .base import (MODEL_KWARGS, baseVAE, check_kwargs, fit_semi_supervised,
                   plot_manifold)

Tensor = torch.Tensor

_KWARGS = MODEL_KWARGS + ("regressor_sig",)


class ss_reg_iVAE(baseVAE):
    """Semi-supervised invariant VAE for regression.

    Arguments as in the JAX package: ``data_dim``, ``latent_dim``,
    ``reg_dim``, ``invariances``, ``hidden_dim_e``, ``hidden_dim_d``,
    ``hidden_dim_reg``, ``activation``, ``sampler_d``, ``sigmoid_d``,
    ``seed``; keywords as :class:`~pyroved_tpu_torch.models.iVAE`'s and
    ``regressor_sig``. ``device``: None means "cuda"; without CUDA pass
    ``device="cpu"``.
    """

    task = "regression"

    def __init__(
        self,
        data_dim: Sequence[int],
        latent_dim: int,
        reg_dim: int,
        invariances: Optional[List[str]] = None,
        hidden_dim_e: Optional[Sequence[int]] = None,
        hidden_dim_d: Optional[Sequence[int]] = None,
        hidden_dim_reg: Optional[Sequence[int]] = None,
        activation: str = "tanh",
        sampler_d: str = "bernoulli",
        sigmoid_d: bool = True,
        seed: int = 1,
        device=None,
        **kwargs,
    ) -> None:
        check_kwargs("ss_reg_iVAE", kwargs, _KWARGS)
        super().__init__(data_dim, invariances, device=device, **kwargs)
        self.generator = set_deterministic_mode(seed)
        self.latent_dim = int(latent_dim)
        self.z_dim = self.latent_dim + self.coord
        self.reg_dim = int(reg_dim)
        self.reg_sig = float(kwargs.get("regressor_sig", 0.5))
        encoder = fcEncoderNet(self.out_shape, self.z_dim, self.reg_dim,
                               hidden_dim_e, activation, softplus_out=True)
        regressor = fcRegressorNet(self.out_shape, self.reg_dim,
                                   hidden_dim_reg, activation)
        decoder = self._make_decoder(self.latent_dim + self.reg_dim,
                                     hidden_dim_d, activation, sigmoid_d,
                                     kwargs)
        self.nets = nn.ModuleDict({
            "encoder_z": init_from(encoder, self.generator),
            "encoder_y": init_from(regressor, self.generator),
            "decoder": init_from(decoder, self.generator),
        }).to(self.device)
        self.sampler_d = get_sampler(sampler_d, **kwargs)

    @property
    def encoder_y_net(self) -> nn.Module:
        return self.nets["encoder_y"]

    def noise_shapes(self, batch_size: int, labeled: bool = False):
        """Shapes of the standard-normal noise one batch needs, ``(label
        noise, latent noise)``: ``[P*B, reg_dim]`` (None for a labeled
        batch, which observes y) and ``[P*B, z_dim]``."""
        rows = self.num_particles * batch_size
        return (None if labeled else (rows, self.reg_dim),
                (rows, self.z_dim))

    # ------------------------------------------------------------------
    # ELBO
    # ------------------------------------------------------------------
    def _loss_single(self, x: Tensor, y: Optional[Tensor], beta,
                     eps) -> Tensor:
        B = x.shape[0]
        xf = x.reshape(B, -1)
        eps_y, eps_z = eps if eps is not None else (None, None)
        if y is None:
            c = self.encoder_y_net(xf)
            if eps_y is None:
                eps_y = torch.randn(c.shape, generator=self.generator).to(c)
            sig_y = torch.full_like(c, self.reg_sig)
            y = c + sig_y * eps_y
            # + log p(y) - log q(y|x), both of width reg_sig
            y_term = torch.sum(normal_log_prob(y, torch.zeros_like(y), sig_y)
                               - normal_log_prob(y, c, sig_y), dim=-1)
        else:
            sig_y = torch.full_like(y, self.reg_sig)
            y_term = torch.sum(normal_log_prob(y, torch.zeros_like(y), sig_y),
                               dim=-1)
        mu, sig = self.encoder_net(xf, y)
        z, lat = normal_latent_site(mu, sig, beta, self.kl_mode, eps=eps_z,
                                    generator=self.generator)
        return -(self._recon(z, y, xf) + lat + y_term)

    def loss_fn(self, x, y=None, beta=1.0, eps=None) -> Tensor:
        """Per-example negative ELBO ``[B]``: a labeled batch observes ``y``
        (``[B]`` or ``[B, reg_dim]``); an unlabeled one (``y=None``) samples
        it from the regressor. Averaged over ``num_particles`` estimates.
        ``eps`` is ``(label noise, latent noise)`` (:meth:`noise_shapes`),
        drawn from the model's generator when not given."""
        x = self._as_f32(x)
        y = None if y is None else self._labels(y)
        if eps is not None:
            eps = tuple(None if e is None else self._as_f32(e) for e in eps)
        return self._particles(self._loss_single, x, y, beta, eps)

    def weighted_loss_fn(self, x, y, weights, beta=1.0, eps=None) -> Tensor:
        """The scalar training loss ``sum_b weights_b * (-ELBO_b)``."""
        return torch.sum(self.loss_fn(x, y, beta, eps)
                         * self._as_f32(weights))

    def aux_loss_fn(self, x, y, aux_loss_multiplier=20.0) -> Tensor:
        """The auxiliary objective per example,
        ``-mult * log N(y; encoder_y(x), regressor_sig)``, on a labeled
        batch; zeros without labels."""
        x = self._as_f32(x)
        if y is None:
            return x.new_zeros(x.shape[0])
        c = self.encoder_y_net(x.reshape(x.shape[0], -1))
        y = self._labels(y)
        lp = torch.sum(normal_log_prob(y, c, torch.full_like(c, self.reg_sig)),
                       dim=-1)
        return -aux_loss_multiplier * lp

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def _labels(self, y) -> Tensor:
        """Continuous labels as rows ``[B, reg_dim]``."""
        y = self._as_f32(y)
        return y.reshape(y.shape[0], -1)

    def fit(self, X_unsup, labeled, val=None, epochs: int = 100,
            batch_size: int = 100, lr: float = 5e-4, verbose: bool = False,
            trainer=None, data_scale=None, **kwargs):
        """Semi-supervised regression training, as :meth:`ssiVAE.fit`; the
        validation metric is the regressor's mean squared error."""
        return fit_semi_supervised(self, X_unsup, labeled, val, epochs,
                                   batch_size, lr, verbose, trainer,
                                   data_scale, kwargs)

    # ------------------------------------------------------------------
    # Inference / generation
    # ------------------------------------------------------------------
    def set_regressor(self, reg_net: nn.Module) -> None:
        """Put a user-defined regressor in place of ``encoder_y``, its Dense
        layers redrawn from the model's generator. Build trainers after
        this call: they hold the parameters they optimize."""
        self.nets["encoder_y"] = init_from(reg_net, self.generator).to(
            self.device)
        self._weights_replaced()

    def _predict_head(self, xf: Tensor) -> Tensor:
        """The regressor's labels of flat rows ``xf``: the body of
        :meth:`regressor`, which ``auxSVItrainer``'s labeled-set metric
        runs inside its own captured program."""
        return self.encoder_y_net(xf)

    @torch.no_grad()
    def regressor(self, x_new, batch_size: Optional[int] = None,
                  **kwargs) -> Tensor:
        """Predicted continuous labels ``[B, reg_dim]``; a request
        (``baseVAE._request``)."""
        x = self._as_f32(x_new)
        return self._request(("regressor",), self._predict_head,
                             (x.reshape(x.shape[0], -1),),
                             batch_size=batch_size,
                             nets=("encoder_y",))

    @torch.no_grad()
    def encode(self, x_new, y=None, batch_size: Optional[int] = None,
               **kwargs):
        """``(z_loc, z_scale, y)`` of q(z|x,y); without labels the
        regressor's predictions stand in for them. One request
        (``baseVAE._request``) either way, the head inside it."""
        x = self._as_f32(x_new)
        x = x.reshape(x.shape[0], -1)
        nets = ("encoder_z", "encoder_y")
        if y is None:
            def body(xx):
                c = self._predict_head(xx)
                return (*self.encoder_net(xx, c), c)

            return self._request(("encode", False), body, (x,),
                                 batch_size=batch_size, nets=nets)
        return self._request(
            ("encode", True), lambda xx, yy: (*self.encoder_net(xx, yy), yy),
            (x, self._labels(y)), batch_size=batch_size, nets=nets)

    @torch.no_grad()
    def decode(self, z, y, angle=0.0, shift=0.0, scale=1.0,
               batch_size: Optional[int] = None, **kwargs) -> Tensor:
        """Decode content latents ``z`` with continuous labels ``y`` under a
        fixed angle/shift/scale; returns ``[B, *data_dim(, C)]``."""
        z = self._as_f32(z)
        z = torch.cat([z, self._as_f32(y).reshape(z.shape[0], -1)], -1)
        return self._decode_posed(z, angle, shift, scale, batch_size)

    def manifold2d(self, d: int, y, plot: bool = True, **kwargs) -> Tensor:
        """Decode a d x d grid over the latent plane conditioned on the
        label vector ``y``. ``which_dims``, ``z_fixed``, ``z_coord`` and
        ``plot`` as iVAE's."""
        which, zfix = kwargs.pop("which_dims", None), kwargs.pop("z_fixed", None)
        z, axes = generate_latent_grid(d, z_coord=kwargs.pop("z_coord", None))
        z = self._embed_latent_plane(z.to(self.device), self.latent_dim,
                                     which, zfix)
        y = self._as_f32(y)
        y = y[None] if y.ndim < 2 else y
        loc = self.decode(z, y.expand((z.shape[0],) + y.shape[1:]), **kwargs)
        if plot:
            plot_manifold(self.ndim, loc, d, axes, kwargs)
        return loc
