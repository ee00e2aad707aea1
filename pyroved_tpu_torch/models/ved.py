"""Variational encoder-decoder (VED): input and output domains differ.

Counterpart of ``pyroved_tpu/models/ved.py`` for im2spec / spec2im
problems: a conv encoder over ``input_dim`` and a conv decoder to
``output_dim`` (:mod:`pyroved_tpu_torch.nets.conv`), with no invariances.
Public arrays keep the JAX package's channels-last layout: inputs and
targets are ``[B, *dim]`` (a singleton channel is appended) or
``[B, *dim, C]``, and single-channel outputs come back without the channel.

It trains on (x, y) pairs (:meth:`VED.weighted_loss_fn` under ``fit`` and
``SVItrainer``; the ELBO scores the target y) and serves through its own
methods: ``encode``, ``decode``, ``predict`` (posterior samples decoded in
one batched call, their mean and std) and ``manifold2d``, each a request
of ``baseVAE._request`` (bucketed bodies, captured programs on CUDA; a
batchnorm that normalizes by the batch's statistics runs exact rows, as
the JAX package pads them). Batchnorm
normalizes with the batch's own statistics, as the JAX package's
stateless batchnorm does; running statistics imported with a reference
model's weights (``state``, set by :mod:`pyroved_tpu_torch.interop`) serve
inference instead once ``use_running_stats`` is set. No VED function runs
a hand-written kernel: the convolutions are cuDNN's on the card.
"""
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..infer.dists import get_sampler
from ..infer.elbo import normal_latent_site, obs_site
from ..nets.conv import BatchNorm, convDecoderNet, convEncoderNet
from ..nets.fc import init_from
from ..utils.coord import generate_latent_grid
from ..utils.nn import as_f32, set_deterministic_mode
from .base import baseVAE, check_kwargs, plot_manifold

Tensor = torch.Tensor

_KWARGS = ("decoder_sig", "kl", "num_particles", "compute_dtype", "pool",
           "conv_first", "pixel_chunks")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class VED(baseVAE):
    """im2spec / spec2im variational encoder-decoder.

    Arguments as in the JAX package: ``input_dim``, ``output_dim``,
    ``input_channels``, ``output_channels``, ``latent_dim``,
    ``hidden_dim_e`` / ``hidden_dim_d`` (conv filters per block, default
    ((32,), (64, 64), (128, 128)) and its mirror), ``activation`` (lrelu),
    ``batchnorm``, ``sampler_d``, ``sigmoid_d``, ``seed``; keywords ``kl``,
    ``num_particles``, ``decoder_sig``, ``compute_dtype`` ("bfloat16" runs
    the conv towers in bf16, the latent and observation heads in f32),
    ``pool`` ("max", or the opt-in "avg" and "stride") and ``conv_first``
    (the commuted upsampler). Plus ``device``: None means "cuda"; without
    CUDA pass ``device="cpu"``. Weights are drawn from ``seed`` with
    torch's default Linear and conv init.
    """

    def __init__(
        self,
        input_dim: Sequence[int],
        output_dim: Sequence[int],
        input_channels: int = 1,
        output_channels: int = 1,
        latent_dim: int = 2,
        hidden_dim_e: Optional[Sequence[Sequence[int]]] = None,
        hidden_dim_d: Optional[Sequence[Sequence[int]]] = None,
        activation: str = "lrelu",
        batchnorm: bool = False,
        sampler_d: str = "bernoulli",
        sigmoid_d: bool = True,
        seed: int = 1,
        device=None,
        **kwargs,
    ) -> None:
        check_kwargs("VED", kwargs, _KWARGS)
        # the base's data_dim is the decoder's output, and no invariance
        # means no coordinate grid
        super().__init__(output_dim, None, device=device,
                         kl=kwargs.get("kl", "mc"),
                         num_particles=kwargs.get("num_particles", 1),
                         pixel_chunks=kwargs.get("pixel_chunks"))
        self.generator = set_deterministic_mode(seed)
        self.input_dim = tuple(int(d) for d in input_dim)
        self.output_dim = tuple(int(d) for d in output_dim)
        self.input_channels = int(input_channels)
        self.output_channels = int(output_channels)
        self.z_dim = self.latent_dim = int(latent_dim)
        self.batchnorm = bool(batchnorm)
        cd = kwargs.get("compute_dtype", "float32")
        if cd not in _DTYPES:
            raise ValueError(
                f"compute_dtype must be float32 or bfloat16, got {cd!r}")
        self.compute_dtype = cd
        pool = kwargs.get("pool", "max")
        if pool not in ("max", "avg", "stride"):
            raise ValueError(f"pool must be max, avg or stride, got {pool!r}")
        self.pool = pool
        dtype = _DTYPES[cd]
        encoder = convEncoderNet(
            self.input_dim, self.input_channels, self.z_dim, hidden_dim_e,
            self.batchnorm, activation, softplus_out=True, dtype=dtype,
            pool=pool)
        decoder = convDecoderNet(
            self.output_dim, self.z_dim, self.output_channels, hidden_dim_d,
            self.batchnorm, activation, sigmoid_out=sigmoid_d, dtype=dtype,
            conv_first=bool(kwargs.get("conv_first", False)))
        self.nets = nn.ModuleDict({
            "encoder_z": init_from(encoder, self.generator),
            "decoder": init_from(decoder, self.generator),
        }).to(self.device)
        self.sampler_d = get_sampler(sampler_d, **kwargs)
        self._stats = {
            name: (torch.zeros(m.weight.shape, device=self.device),
                   torch.ones(m.weight.shape, device=self.device))
            for name, m in self._bnorms()}
        self._use_running_stats = False

    # ------------------------------------------------------------------
    # BatchNorm running statistics (flax's batch_stats)
    # ------------------------------------------------------------------
    def _bnorms(self):
        return [(name, m) for name, m in self.nets.named_modules()
                if isinstance(m, BatchNorm)]

    @property
    def use_running_stats(self) -> bool:
        """False (the default): batchnorm normalizes with the batch's own
        statistics, at train and eval time. True: inference (autograd off)
        normalizes with :attr:`state`, as a torch model in ``eval()``
        does; training still uses the batch's statistics."""
        return self._use_running_stats

    @use_running_stats.setter
    def use_running_stats(self, on: bool) -> None:
        self._use_running_stats = bool(on)
        for name, m in self._bnorms():
            m.running_stats = self._stats[name] if on else None

    @property
    def state(self) -> Dict[str, Tensor]:
        """The running mean and variance of every BatchNorm (flax's init:
        0 and 1), keyed ``<module>.mean`` and ``<module>.var``; empty
        without batchnorm. They live outside the parameters'
        ``state_dict``, as flax keeps ``batch_stats`` apart from
        ``params``. Setting it takes a mapping with the same keys and
        shapes."""
        return {f"{name}.{part}": t for name, pair in self._stats.items()
                for part, t in zip(("mean", "var"), pair)}

    @state.setter
    def state(self, stats) -> None:
        own = self.state
        if set(stats) != set(own):
            raise KeyError(
                f"state keys do not match the model's batchnorms: missing "
                f"{sorted(set(own) - set(stats))}, extra "
                f"{sorted(set(stats) - set(own))}")
        new = {k: as_f32(stats[k], self.device).clone() for k in own}
        for k, v in new.items():
            if v.shape != own[k].shape:
                raise ValueError(f"state[{k!r}]: shape {tuple(v.shape)} "
                                 f"!= {tuple(own[k].shape)}")
        self._stats = {name: (new[name + ".mean"], new[name + ".var"])
                       for name in self._stats}
        self.use_running_stats = self._use_running_stats

    def noise_shapes(self, batch_size: int, labeled: bool = False):
        """Shape of the standard-normal latent noise one batch needs:
        ``[B, z_dim]``, or ``[P, B, z_dim]`` with ``num_particles=P``."""
        P = self.num_particles
        return (((P,) if P > 1 else ()) + (batch_size, self.z_dim),)

    def _with_channels(self, x, spatial: Tuple[int, ...]) -> Tensor:
        """``x`` as f32 on the model's device, with a singleton channel
        appended when it has none."""
        x = self._as_f32(x)
        return x[..., None] if x.dim() == len(spatial) + 1 else x

    # ------------------------------------------------------------------
    # ELBO
    # ------------------------------------------------------------------
    def loss_fn(self, x, y, beta: float = 1.0, eps=None) -> Tensor:
        """Per-example negative ELBO ``[B]`` of the pairs (x, y): q(z|x),
        p(y|z). ``eps`` is the latent noise shaped like the posterior
        (``noise_shapes``), drawn from the model's generator when not
        given; ``beta`` scales the latent term."""
        x = self._with_channels(x, self.input_dim)
        y = self._with_channels(y, self.output_dim)
        B = x.shape[0]
        mu, sig = self.encoder_net(x)
        P = self.num_particles
        if P > 1:
            mu = mu.expand((P,) + mu.shape)
            sig = sig.expand((P,) + sig.shape)
        if eps is not None:
            eps = self._as_f32(eps)
        z, latent_term = normal_latent_site(mu, sig, beta, self.kl_mode,
                                            eps=eps, generator=self.generator)
        loc = self.decoder_net(z.reshape(-1, z.shape[-1]))
        recon = obs_site(self.sampler_d, y.reshape(B, -1),
                         loc.reshape(z.shape[:-1] + (-1,)))
        per_example = -(recon + latent_term)
        return per_example.mean(0) if P > 1 else per_example

    def weighted_loss_fn(self, x, y, weights, beta: float = 1.0,
                         eps=None) -> Tensor:
        """The scalar training loss ``sum_b weights_b * (-ELBO_b)``."""
        return torch.sum(self.loss_fn(x, y, beta, eps)
                         * self._as_f32(weights))

    # ------------------------------------------------------------------
    # Inference / generation
    # ------------------------------------------------------------------
    def _row_bytes(self) -> int:
        return 4 * max(int(np.prod(self.input_dim)) * self.input_channels,
                       int(np.prod(self.output_dim)) * self.output_channels)

    @torch.no_grad()
    def encode(self, x_new, batch_size: Optional[int] = None, **kwargs):
        """``(z_loc, z_scale)`` of q(z|x); ``batch_size`` chunks the rows. A
        request (``baseVAE._request``): with batchnorm (and no running
        statistics served) each chunk is normalized by its own statistics
        at exact rows, the last one zero-padded to ``batch_size`` rows when
        the request has more, as the JAX package pads every chunk, so the
        padding rows enter its statistics there too."""
        x = self._with_channels(x_new, self.input_dim)
        return self._request(("encode",), self.encoder_net, (x,),
                             batch_size=batch_size, nets=("encoder_z",))

    def _squeeze(self, out: Tensor) -> Tensor:
        return out[..., 0] if self.output_channels == 1 else out

    @torch.no_grad()
    def decode(self, z, batch_size: Optional[int] = None, **kwargs) -> Tensor:
        """Decode latents into the target space, ``[B, *output_dim]`` (or
        ``[B, *output_dim, C]``); a request, as :meth:`encode`."""
        z = self._as_f32(z)
        return self._squeeze(self._request(
            ("decode",), self.decoder_net, (z,), batch_size=batch_size,
            nets=("decoder",)))

    @torch.no_grad()
    def predict(self, x_new, num_samples: int = 30, eps=None,
                **kwargs) -> Tuple[Tensor, Tensor]:
        """Encode, draw ``num_samples`` posterior samples, decode all S*B of
        them in one batched call, and return their (mean, std) over samples
        (population std). ``eps`` ``[S, B, z_dim]`` is the standard-normal
        noise, drawn on the host from the model's generator when not given.
        A request (``baseVAE._request``), one program a bucket and
        ``num_samples``: the noise enters it as a batched input, each
        chunk's rows ``[m, S, z_dim]`` zero-padded to the bucket, so the
        program draws nothing; with batchnorm, at exact rows (the decode's
        statistics over all S*B of them, as the JAX package's)."""
        S = int(num_samples)
        x = self._with_channels(x_new, self.input_dim)
        shape = (S, x.shape[0], self.z_dim)
        if eps is None:
            eps = torch.randn(shape, generator=self.generator)
        eps = self._as_f32(eps).reshape(shape).transpose(0, 1)

        def body(xx, ee):
            mu, sig = self.encoder_net(xx)
            zs = mu[None] + sig[None] * ee.transpose(0, 1)
            ys = self.decoder_net(zs.reshape(-1, zs.shape[-1]))
            ys = ys.reshape(zs.shape[:2] + ys.shape[1:])
            return ys.mean(0), ys.std(0, correction=0)

        mean, std = self._request(("predict", S), body, (x, eps),
                                  nets=("encoder_z", "decoder"))
        return self._squeeze(mean), self._squeeze(std)

    def manifold2d(self, d: int, plot: bool = True, **kwargs) -> Tensor:
        """Decode a d x d grid over the 2-D latent plane; ``which_dims`` /
        ``z_fixed`` pick the plane when ``latent_dim > 2``, ``z_coord`` sets
        the bounds. ``plot`` (the default, as in the JAX package) shows the
        decoded grid; other keywords reach the plot."""
        which, zfix = kwargs.pop("which_dims", None), kwargs.pop("z_fixed", None)
        z, axes = generate_latent_grid(d, z_coord=kwargs.pop("z_coord", None))
        z = self._embed_latent_plane(z.to(self.device), self.z_dim, which,
                                     zfix)
        loc = self.decode(z, **kwargs)
        if plot:
            plot_manifold(self.ndim, loc, d, axes, kwargs)
        return loc
