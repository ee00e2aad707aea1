"""Convolutional encoder and decoder modules.

Counterpart of ``pyroved_tpu/nets/conv.py``: blocks of 3x3 convolutions
with a 2x2 pool between blocks (the feature extractor) and their mirror,
conv blocks each followed by a x2 resize and a 1x1 conv (the upsampler),
with the same defaults ([(32,), (64, 64), (128, 128)] filters, lrelu,
optional batchnorm) and keywords. Submodules carry the flax tree's names
(``FeatureExtractor_0.Conv_i``, ``BatchNorm_i``,
``Upsampler_0.UpsampleBlock_i.Conv_0``, ``features2latent``,
``latent2features``), so JAX weights load by a rename and a transpose
(:mod:`pyroved_tpu_torch.weights`).

Inside, the towers run channels-first (``[B, C, *spatial]``), PyTorch's
layout. The nets' public ends keep the JAX package's channels-last layout:
:class:`convEncoderNet` takes ``[B, *spatial, C]`` and flattens its
features channels-last before ``features2latent``, and
:class:`convDecoderNet` reshapes ``latent2features``' output to
``[B, *spatial, C]`` before moving the channels first, and returns
``[B, *spatial, C]``.

Numerics follow the JAX package's:

- ``"SAME"`` padding is XLA's, which pads ``total // 2`` before and the
  rest after. Where that is symmetric (every stride-1 conv) the
  convolution pads; a stride-2 3x3 conv on an even length pads 0 before
  and 1 after, so that case is padded explicitly (``F.pad``) first.
- Batchnorm normalizes with the batch's own statistics, at train and at
  eval time, and updates no running averages: the mean and the variance
  E[x^2] - E[x]^2 (clipped at 0) in f32, epsilon 1e-5, as flax's. Running
  statistics installed by the model (a reference model's, through
  :mod:`pyroved_tpu_torch.interop`) are used instead at inference only
  (autograd off).
- ``dtype=torch.bfloat16`` runs the towers in bf16 (inputs and kernels cast
  to bf16, bf16 out), while the latent heads and the final 1x1 output conv
  stay f32.
- An f32 convolution runs with cuDNN's TF32 off, forward and backward,
  whatever the caller's ``torch.backends.cudnn.allow_tf32`` says, and
  leaves that flag as it found it.
"""
import contextlib
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils.nn import get_activation
from .fc import Dense

Tensor = torch.Tensor

_CONV_FN = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
BN_EPS = 1e-5  # flax's BatchNorm default


@contextlib.contextmanager
def _no_tf32(on_cuda: bool):
    """cuDNN's TF32 off for the convolutions in the block when they run on
    a CUDA device; the caller's setting is restored after it."""
    if not on_cuda:
        yield
        return
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = prev


class _F32Conv(torch.autograd.Function):
    """An f32 convolution (``stride`` and symmetric ``padding`` per axis)
    whose forward and backward both run with TF32 off (autograd runs the
    backward after the forward's scope has closed, so a plain ``F.conv``
    would compute its grads in TF32 when the caller allows it)."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        with _no_tf32(x.is_cuda):
            y = _CONV_FN[x.dim() - 2](x, weight, bias, stride, padding)
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.padding = stride, padding
        ctx.has_bias = bias is not None
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        nd = x.dim() - 2
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                ctx.has_bias and ctx.needs_input_grad[2]]
        with _no_tf32(x.is_cuda):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                gy.contiguous(), x, weight,
                [weight.shape[0]] if ctx.has_bias else None,
                list(ctx.stride), list(ctx.padding), [1] * nd, False,
                [0] * nd, 1, mask)
        return gx, gw, gb, None, None


def same_padding(size: int, kernel_size: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel_size - size, 0)
    return total // 2, total - total // 2


class _SameConv:
    """Forward of a ``"SAME"``-padded convolution (any kernel size and
    stride per axis) in ``compute dtype``: the input and the kernel cast to
    the input's dtype."""

    def forward(self, x: Tensor) -> Tensor:
        pads = [same_padding(n, k, s) for n, k, s in
                zip(x.shape[2:], self.kernel_size, self.stride)]
        pad = tuple(lo for lo, _ in pads)
        if any(lo != hi for lo, hi in pads):
            # F.pad takes the last axis first
            x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
            pad = (0,) * len(pads)
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if x.dtype == torch.float32:
            return _F32Conv.apply(x, w, b, tuple(self.stride), pad)
        return _CONV_FN[x.dim() - 2](x, w, b, self.stride, pad)

    def reset_from(self, generator: torch.Generator) -> None:
        """torch's default conv init (kaiming-uniform with a = sqrt(5),
        which is U(+-1/sqrt(fan_in)), as the JAX package's ``kernel_init``;
        bias U(+-1/sqrt(fan_in))) drawn from ``generator``."""
        fan_in = self.weight[0].numel()
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            self.weight.copy_(torch.empty(self.weight.shape).uniform_(
                -bound, bound, generator=generator))
            self.bias.copy_(torch.empty(self.bias.shape).uniform_(
                -bound, bound, generator=generator))


class Conv1d(_SameConv, nn.Conv1d):
    pass


class Conv2d(_SameConv, nn.Conv2d):
    pass


class Conv3d(_SameConv, nn.Conv3d):
    pass


_CONV = {1: Conv1d, 2: Conv2d, 3: Conv3d}


# utils.nn.get_conv's "SAME" convolutions: the input channels inferred at
# the first call, then the class above
class LazyConv1d(_SameConv, nn.LazyConv1d):
    cls_to_become = Conv1d


class LazyConv2d(_SameConv, nn.LazyConv2d):
    cls_to_become = Conv2d


class LazyConv3d(_SameConv, nn.LazyConv3d):
    cls_to_become = Conv3d


def _conv(ndim: int, in_channels: int, features: int, kernel_size: int = 3,
          strides: int = 1) -> nn.Module:
    return _CONV[ndim](in_channels, features, kernel_size, stride=strides)


class BatchNorm(nn.Module):
    """Batchnorm over every axis but the channels (axis 1), with the batch's
    own statistics and no running averages of its own, as the JAX package
    uses flax's ``BatchNorm``: mean and E[x^2] - E[x]^2 in f32, then
    ``(x - mean) * rsqrt(var + eps) * weight + bias``, cast back to the
    input's dtype. ``weight`` is flax's ``scale``.

    ``running_stats`` is None, or a ``(mean, var)`` pair that the owning
    model installs (imported running statistics, kept outside the
    parameters as flax keeps ``batch_stats`` apart from ``params``): then a
    forward with autograd off (inference) normalizes with them, as a torch
    BatchNorm in ``eval()`` does, and a forward that records gradients
    (training) still uses the batch's.

    ``stats_axis`` is None, or the mesh axis (a ``parallel.collectives
    .Axis``) that a trainer splits the batch's rows over while it runs its
    steps (:func:`batch_stats_over`): then the batch's statistics are the
    whole batch's, as the JAX package's GSPMD step takes them. Each
    channel's sum and sum of squares and the row count are summed over the
    axis in one ``all_reduce`` of one flat buffer, whose backward sums the
    cotangents too (``SyncBatchNorm``'s reduction)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_stats: Optional[Tuple[Tensor, Tensor]] = None
        self.stats_axis = None

    def reset_from(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: Tensor) -> Tensor:
        xf = x.float()
        axes = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.running_stats is not None and not torch.is_grad_enabled():
            mean, var = (s.reshape(shape) for s in self.running_stats)
        elif self.stats_axis is not None and self.stats_axis.group is not None:
            from ..parallel.collectives import all_reduce_sum
            C = xf.shape[1]
            count = xf.new_full((1,), xf.numel() // C)
            flat = all_reduce_sum(self.stats_axis, torch.cat(
                [xf.sum(axes), (xf * xf).sum(axes), count]))
            mean = (flat[:C] / flat[-1]).reshape(shape)
            var = torch.clamp((flat[C:2 * C] / flat[-1]).reshape(shape)
                              - mean * mean, min=0.0)
        else:
            mean = xf.mean(axes, keepdim=True)
            var = torch.clamp((xf * xf).mean(axes, keepdim=True)
                              - mean * mean, min=0.0)
        mul = torch.rsqrt(var + BN_EPS) * self.weight.reshape(shape)
        return ((xf - mean) * mul + self.bias.reshape(shape)).to(x.dtype)


@contextlib.contextmanager
def batch_stats_over(module: nn.Module, axis):
    """Every ``BatchNorm`` of ``module`` takes its statistics over ``axis``
    (a trainer's ``'data'``, whose ranks each hold some of the batch's
    rows) inside the block, forward and backward; nothing changes when the
    axis has one rank."""
    norms = [m for m in module.modules() if hasattr(m, "stats_axis")]
    if axis is None or axis.group is None or not norms:
        yield
        return
    old = [m.stats_axis for m in norms]
    for m in norms:
        m.stats_axis = axis
    try:
        yield
    finally:
        for m, a in zip(norms, old):
            m.stats_axis = a


def _resize_method(ndim: int, mode: str) -> str:
    """Bilinear exists only in 2-D; 1-D and 3-D fall back to nearest."""
    mode = mode if ndim == 2 else "nearest"
    return "linear" if mode == "bilinear" else "nearest"


def _upsample(x: Tensor, factor: int, method: str) -> Tensor:
    """``x [B, C, *spatial]`` with each spatial axis scaled by ``factor``:
    nearest as a repeat per axis, linear as ``F.interpolate`` bilinear with
    half-pixel centres (``align_corners=False``), which is
    ``jax.image.resize``'s linear."""
    if method == "nearest":
        for ax in range(2, x.dim()):
            x = torch.repeat_interleave(x, factor, dim=ax)
        return x
    size = tuple(s * factor for s in x.shape[2:])
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def _max_pool(x: Tensor, ndim: int) -> Tensor:
    # On tied maxima the backward routes the grad to one element of the
    # window, and which one may differ from XLA's select_and_scatter;
    # without ties the two agree.
    return _MAX_POOL[ndim](x, 2, 2)


def _avg_pool(x: Tensor, ndim: int) -> Tensor:
    return _AVG_POOL[ndim](x, 2, 2)


def _default_enc_filters(f):
    return (tuple(tuple(b) for b in f) if f is not None
            else ((32,), (64, 64), (128, 128)))


def _default_dec_filters(f):
    return (tuple(tuple(b) for b in f) if f is not None
            else ((128, 128), (64, 64), (32,)))


class UpsampleBlock(nn.Module):
    """x2 resize (bilinear in 2-D, nearest in 1-D and 3-D) followed by a
    1x1 conv; with ``conv_first=True`` the conv runs before the resize (the
    two commute: the same parameters and, up to f32 reassociation, the same
    output). Channels-first."""

    def __init__(self, ndim: int, in_channels: int, output_channels: int,
                 scale_factor: int = 2, mode: str = "bilinear",
                 dtype: torch.dtype = torch.float32, conv_first: bool = False):
        super().__init__()
        if mode not in ("bilinear", "nearest"):
            raise NotImplementedError(
                "Use 'bilinear' or 'nearest' for upsampling mode")
        self.ndim = ndim
        self.scale_factor = scale_factor
        self.method = _resize_method(ndim, mode)
        self.dtype = dtype
        self.conv_first = conv_first
        self.Conv_0 = _conv(ndim, in_channels, output_channels, kernel_size=1)

    def forward(self, x: Tensor, skip_resize: bool = False) -> Tensor:
        x = x.to(self.dtype)
        if skip_resize:
            # the caller resizes (Upsampler slides its head under it)
            if not self.conv_first:
                raise ValueError("skip_resize requires conv_first")
            return self.Conv_0(x)
        if self.conv_first:
            x = self.Conv_0(x)
        x = _upsample(x, self.scale_factor, self.method)
        return x if self.conv_first else self.Conv_0(x)


class FeatureExtractor(nn.Module):
    """Conv tower: blocks of 3x3 convs (each followed by the activation,
    then batchnorm), a 2x2 pool after every block but the last (and after
    the last with ``pool_last``). ``pool="avg"`` pools by the mean;
    ``pool="stride"`` drops the pool and runs the block's last conv at
    stride 2. Channels-first; returns ``dtype``."""

    def __init__(self, ndim: int, in_channels: int,
                 conv_filters: Optional[Sequence[Sequence[int]]] = None,
                 batchnorm: bool = False, activation: str = "lrelu",
                 pool_last: bool = True, dtype: torch.dtype = torch.float32,
                 pool: str = "max"):
        super().__init__()
        if pool not in ("max", "avg", "stride"):
            raise ValueError(
                f"pool must be 'max', 'avg' or 'stride', got {pool!r}")
        self.ndim, self.dtype, self.pool = ndim, dtype, pool
        self.act = get_activation(activation)
        self.batchnorm = batchnorm
        filters = _default_enc_filters(conv_filters)
        self.plan = []  # per block: (conv indices, downsample)
        i = 0
        for b, block in enumerate(filters):
            downsample = b + 1 < len(filters) or pool_last
            idx = []
            for j, ch in enumerate(block):
                stride = (2 if pool == "stride" and downsample
                          and j == len(block) - 1 else 1)
                setattr(self, f"Conv_{i}", _conv(ndim, in_channels, ch,
                                                 strides=stride))
                if batchnorm:
                    setattr(self, f"BatchNorm_{i}", BatchNorm(ch))
                idx.append(i)
                in_channels = ch
                i += 1
            self.plan.append((idx, downsample))
        self.out_channels = in_channels

    def forward(self, x: Tensor) -> Tensor:
        x = x.to(self.dtype)
        for idx, downsample in self.plan:
            for i in idx:
                x = getattr(self, f"Conv_{i}")(x)
                if self.act is not None:
                    x = self.act(x)
                if self.batchnorm:
                    x = getattr(self, f"BatchNorm_{i}")(x)
            if downsample and self.pool != "stride":
                x = (_max_pool if self.pool == "max" else _avg_pool)(
                    x, self.ndim)
        return x


class Upsampler(nn.Module):
    """Mirror of :class:`FeatureExtractor`: conv blocks each followed by an
    :class:`UpsampleBlock`, then a 1x1 conv to ``output_channels`` in f32.
    With ``conv_first`` the last block's 1x1 conv and the head run before
    the last resize. Channels-first; returns f32."""

    def __init__(self, ndim: int, in_channels: int,
                 conv_filters: Optional[Sequence[Sequence[int]]] = None,
                 output_channels: int = 1, batchnorm: bool = False,
                 activation: str = "lrelu", upsampling_mode: str = "bilinear",
                 dtype: torch.dtype = torch.float32, conv_first: bool = False):
        super().__init__()
        self.ndim, self.dtype, self.conv_first = ndim, dtype, conv_first
        self.upsampling_mode = upsampling_mode
        self.act = get_activation(activation)
        self.batchnorm = batchnorm
        filters = _default_dec_filters(conv_filters)
        self.plan = []  # per block: its conv indices
        i = 0
        for b, block in enumerate(filters):
            idx = []
            for ch in block:
                setattr(self, f"Conv_{i}", _conv(ndim, in_channels, ch))
                if batchnorm:
                    setattr(self, f"BatchNorm_{i}", BatchNorm(ch))
                idx.append(i)
                in_channels = ch
                i += 1
            setattr(self, f"UpsampleBlock_{b}", UpsampleBlock(
                ndim, in_channels, in_channels, mode=upsampling_mode,
                dtype=dtype, conv_first=conv_first))
            self.plan.append(idx)
        self.head = f"Conv_{i}"  # the observation head, f32
        setattr(self, self.head, _conv(ndim, in_channels, output_channels,
                                       kernel_size=1))

    def forward(self, x: Tensor) -> Tensor:
        x = x.to(self.dtype)
        head = getattr(self, self.head)
        for b, idx in enumerate(self.plan):
            for i in idx:
                x = getattr(self, f"Conv_{i}")(x)
                if self.act is not None:
                    x = self.act(x)
                if self.batchnorm:
                    x = getattr(self, f"BatchNorm_{i}")(x)
            up = getattr(self, f"UpsampleBlock_{b}")
            if self.conv_first and b == len(self.plan) - 1:
                x = head(up(x, skip_resize=True).float())
                return _upsample(x, up.scale_factor, _resize_method(
                    self.ndim, self.upsampling_mode))
            x = up(x)
        return head(x.float())


class convEncoderNet(nn.Module):
    """Conv encoder producing (mu, sigma) of q(z|x), softplus sigma.
    Input ``[B, *input_dim, C]`` channels-last; the latent head is f32."""

    def __init__(self, input_dim: Tuple[int, ...], input_channels: int = 1,
                 latent_dim: int = 2,
                 hidden_dim: Optional[Sequence[Sequence[int]]] = None,
                 batchnorm: bool = False, activation: str = "lrelu",
                 softplus_out: bool = True, pool_last: bool = False,
                 dtype: torch.dtype = torch.float32, pool: str = "max"):
        super().__init__()
        ndim = len(input_dim)
        self.FeatureExtractor_0 = FeatureExtractor(
            ndim, input_channels, _default_enc_filters(hidden_dim), batchnorm,
            activation, pool_last, dtype=dtype, pool=pool)
        spatial = tuple(int(d) for d in input_dim)
        for _, downsample in self.FeatureExtractor_0.plan:
            if downsample:  # a 2x2 pool floors; a stride-2 SAME conv ceils
                spatial = tuple(d // 2 if pool != "stride" else -(-d // 2)
                                for d in spatial)
        # (channels, spatial dims) of the tower's output, which the head
        # reads flattened channels-last
        self.feature_shape = (self.FeatureExtractor_0.out_channels, spatial)
        flat = int(np.prod(spatial)) * self.FeatureExtractor_0.out_channels
        self.features2latent = Dense(flat, 2 * latent_dim)
        self.latent_dim = latent_dim
        self.softplus_out = softplus_out

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        h = self.FeatureExtractor_0(x.movedim(-1, 1))
        # flattened channels-last, as the JAX package's head reads it
        h = h.movedim(1, -1).reshape(h.shape[0], -1).float()
        enc = self.features2latent(h)
        mu, sigma = enc[:, :self.latent_dim], enc[:, self.latent_dim:]
        if self.softplus_out:
            sigma = F.softplus(sigma)
        return mu, sigma


class convDecoderNet(nn.Module):
    """Conv decoder: latent -> ``latent2features`` (f32) -> upsampler ->
    sigmoid. Output ``[B, *output_dim, C]`` channels-last, f32."""

    def __init__(self, output_dim: Tuple[int, ...], latent_dim: int = 2,
                 output_channels: int = 1,
                 hidden_dim: Optional[Sequence[Sequence[int]]] = None,
                 batchnorm: bool = False, activation: str = "lrelu",
                 sigmoid_out: bool = True, upsampling_mode: str = "bilinear",
                 dtype: torch.dtype = torch.float32, conv_first: bool = False):
        super().__init__()
        filters = _default_dec_filters(hidden_dim)
        self.in_spatial = tuple(int(d) // 2 ** len(filters)
                                for d in output_dim)
        self.ch0 = filters[0][0]
        self.latent2features = Dense(
            int(latent_dim), int(np.prod(self.in_spatial)) * self.ch0)
        self.Upsampler_0 = Upsampler(
            len(output_dim), self.ch0, filters, output_channels, batchnorm,
            activation, upsampling_mode, dtype=dtype, conv_first=conv_first)
        self.sigmoid_out = sigmoid_out

    def forward(self, z: Tensor) -> Tensor:
        h = self.latent2features(z)
        # reshaped channels-last, as the JAX package writes it
        h = h.reshape((z.shape[0],) + self.in_spatial + (self.ch0,))
        x = self.Upsampler_0(h.movedim(-1, 1)).movedim(1, -1)
        return torch.sigmoid(x) if self.sigmoid_out else x
