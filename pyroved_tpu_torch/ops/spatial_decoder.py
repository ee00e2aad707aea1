"""Fused coordinate-transform + spatial-decoder forward.

Counterpart of the forward half of ``pyroved_tpu/ops/spatial_decoder.py``.
For each sample the rotation, scale and shift fold into three H-vectors

  u = sc*(cos*Wc0 + sin*Wc1),  v = sc*(-sin*Wc0 + cos*Wc1),  w = dx@Wc + bc + z@Wz

so the first layer is ``h0 = tanh(gx*u + gy*v + w)`` and the warped grid
never exists in memory. The hidden layers and the head follow.

* :func:`spatial_decoder_plain` is the plain PyTorch version (the warped
  grid and every activation materialized), the counterpart of
  ``_xla_forward``.
* :func:`fused_spatial_decoder_forward` is the kernel's wrapper: on a CUDA
  tensor it launches ``csrc/spatial_decoder_fwd.cu`` or raises; on a CPU
  tensor it calls the plain version.
* :func:`apply_fused_sdecoder` runs it from an ``sDecoderNet`` module.

The JAX package's tile selection, per-TPU tunings and size thresholds were
measured on a TPU and have no counterpart here: the kernel picks its own
tile, and a supported configuration always runs it.
"""
import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils.nn import get_activation
from . import _build

Tensor = torch.Tensor

#: Hidden-layer activations the kernel implements: the registry's five.
#: ``tanh_approx`` (the Pade tanh behind ``approx_tanh=True``) is the sixth.
KERNEL_ACTS = ("tanh", "relu", "lrelu", "softplus", "gelu")
KERNEL_ACTS_WITH_APPROX = KERNEL_ACTS + ("tanh_approx",)
_ACT_CODE = {name: i for i, name in enumerate(KERNEL_ACTS_WITH_APPROX)}

#: Padded hidden widths the kernel is compiled for.
KERNEL_WIDTHS = (128, 256)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pade_tanh(x: Tensor) -> Tensor:
    """7/6 Pade approximant of tanh with its input clamp."""
    x = torch.clamp(x, -4.97, 4.97)
    x2 = x * x
    num = x * (135135.0 + x2 * (17325.0 + x2 * (378.0 + x2)))
    den = 135135.0 + x2 * (62370.0 + x2 * (3150.0 + 28.0 * x2))
    return num / den


def _act(name: str, x: Tensor) -> Tensor:
    """A hidden-layer activation: the registry's, or the Pade tanh."""
    return _pade_tanh(x) if name == "tanh_approx" else get_activation(name)(x)


def _h0_act(name: str, x: Tensor) -> Tensor:
    """The coordinate-fusion layer is tanh, in the requested flavour."""
    return _pade_tanh(x) if name == "tanh_approx" else torch.tanh(x)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def spatial_decoder_plain(grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout,
                          bout, act: str = "tanh",
                          sigmoid_out: bool = True) -> Tensor:
    """Plain PyTorch forward: grid [N, D], phi/sc [B], dx [B, D], z [B, L],
    Wc [D, H], bc [H], Wz [L, H], hw [nl, H, H], hb [nl, H], wout [H, C],
    bout [C]. Returns [B, N] for C == 1, else [B, N, C]."""
    D = grid.shape[-1]
    if D == 2:
        c = torch.cos(phi)[:, None]
        s = torch.sin(phi)[:, None]
        gx, gy = grid[:, 0], grid[:, 1]
        cx = (gx[None] * c - gy[None] * s) * sc[:, None] + dx[:, 0:1]
        cy = (gx[None] * s + gy[None] * c) * sc[:, None] + dx[:, 1:2]
        coords = torch.stack([cx, cy], -1)  # [B, N, 2]
    else:
        coords = grid[None] + dx[:, None, :]
    h = _h0_act(act, coords @ Wc + bc + (z @ Wz)[:, None, :])
    for i in range(hw.shape[0]):
        h = _act(act, h @ hw[i] + hb[i])
    out = h @ wout + bout
    if wout.shape[1] == 1:
        out = out[..., 0]
    return torch.sigmoid(out) if sigmoid_out else out


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.load("spatial_decoder_fwd").pvt_sdec_fwd
        f.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _check(name: str, t: Tensor, shape: Tuple[int, ...], device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_spatial_decoder_forward(grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb,
                                  wout, bout, act: str = "tanh",
                                  sigmoid_out: bool = True) -> Tensor:
    """Fused transform + decode (shapes as :func:`spatial_decoder_plain`).

    On CPU tensors this is the plain version. On CUDA tensors it launches
    the kernel on the current stream, or raises when the inputs do not fit
    it (H must be 128 or 256, D 1 or 2, C 1..4, float32, contiguous).
    ``fused_spatial_decoder_forward.launches`` counts kernel launches."""
    if grid.device.type == "cpu":
        return spatial_decoder_plain(grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb,
                                     wout, bout, act, sigmoid_out)
    if grid.device.type != "cuda":
        raise ValueError(f"no spatial-decoder kernel for {grid.device}")
    N, D = grid.shape
    B, L = z.shape
    H = Wc.shape[1]
    nl = hw.shape[0]
    C = wout.shape[1]
    if H not in KERNEL_WIDTHS:
        raise ValueError(f"kernel hidden width must be one of {KERNEL_WIDTHS}, "
                         f"got {H}")
    if D not in (1, 2) or not 1 <= C <= 4:
        raise ValueError(f"kernel needs D in (1, 2) and 1 <= C <= 4, got "
                         f"D={D}, C={C}")
    if act not in _ACT_CODE:
        raise ValueError(f"kernel has no activation {act!r}")
    dev = grid.device
    for name, t, shape in (
            ("grid", grid, (N, D)), ("phi", phi, (B,)), ("dx", dx, (B, D)),
            ("sc", sc, (B,)), ("z", z, (B, L)), ("Wc", Wc, (D, H)),
            ("bc", bc, (H,)), ("Wz", Wz, (L, H)), ("hw", hw, (nl, H, H)),
            ("hb", hb, (nl, H)), ("wout", wout, (H, C)), ("bout", bout, (C,))):
        _check(name, t, shape, dev)
    if hw.data_ptr() % 16:  # the kernel stages weights as float4
        raise ValueError("hw must be 16-byte aligned")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (phi, dx, sc, z, Wc, bc, Wz, hw, hb,
                                      wout, bout)):
        raise RuntimeError("the spatial-decoder kernel is forward only: call "
                           "it under torch.no_grad()")
    out = torch.empty((B, N, C) if C > 1 else (B, N), device=dev,
                      dtype=torch.float32)
    if B == 0 or N == 0:  # nothing to launch
        return out
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(grid.data_ptr(), phi.data_ptr(), dx.data_ptr(),
                 sc.data_ptr(), z.data_ptr(), Wc.data_ptr(), bc.data_ptr(),
                 Wz.data_ptr(), hw.data_ptr(), hb.data_ptr(),
                 wout.data_ptr(), bout.data_ptr(), out.data_ptr(),
                 B, N, D, L, H, nl, C, _ACT_CODE[act], int(bool(sigmoid_out)),
                 stream)
    if err != 0:
        raise RuntimeError(f"spatial-decoder kernel launch failed: CUDA error "
                           f"{err}")
    fused_spatial_decoder_forward.launches += 1
    return out


fused_spatial_decoder_forward.launches = 0


# ---------------------------------------------------------------------------
# Model integration
# ---------------------------------------------------------------------------

def sdecoder_supports_fusion(hidden_dim, activation: str, sigmoid_out: bool,
                             coord: int, channels: int = 1,
                             device="cuda") -> bool:
    """True when an sDecoderNet configuration maps onto the kernel and
    ``device`` runs it: an active coordinate transform, a kernel activation,
    1..4 channels, a padded width ``round_up(max(hidden), 128)`` the kernel
    is built for (128 or 256), and a Hopper card. The configuration alone
    decides: no timing enters the gate. On ``device="cpu"`` a supported configuration also counts, since
    there the wrapper runs its plain version: the model takes the same path
    on both."""
    hidden = tuple(hidden_dim) if hidden_dim is not None else (128, 128)
    del sigmoid_out  # both heads supported
    device = torch.device(device)
    hopper = (device.type == "cuda" and torch.cuda.is_available()
              and torch.cuda.get_device_capability(device) == (9, 0))
    return (0 < coord < 5
            and activation in KERNEL_ACTS
            and 1 <= int(channels) <= 4
            and _round_up(max(hidden), 128) in KERNEL_WIDTHS
            and (device.type == "cpu" or hopper))


def padded_sdecoder_weights(decoder) -> Tuple[Tensor, ...]:
    """(Wc [D,H], bc [H], Wz [L,H], hw [nl,H,H], hb [nl,H], wout [H,C],
    bout [C]) from an ``sDecoderNet``, in the kernel's input-major layout,
    every hidden width zero-padded to ``round_up(max width, 128)``.

    The padding is exact: padded lanes get zero weights in and zero bias,
    and every weight out of a padded lane is zero, so they add nothing to
    real lanes or to the head (for softplus they carry log 2, which the
    zero outgoing weights drop)."""
    layers = decoder.MLP_0.layers()
    kernels = [m.weight.T for m in layers]
    biases = [m.bias for m in layers]
    Wc = decoder.fc_coord.weight.T
    bc = decoder.fc_coord.bias
    Wz = decoder.fc_latent.weight.T
    wout = decoder.out.weight.T
    bout = decoder.out.bias.reshape(-1)
    widths = {Wc.shape[1], wout.shape[0],
              *(k.shape[0] for k in kernels), *(k.shape[1] for k in kernels)}
    hmax = _round_up(max(widths), 128)
    if len(widths) > 1 or max(widths) != hmax:
        pad_last = lambda a: F.pad(a, (0, hmax - a.shape[-1]))  # noqa: E731
        Wc, bc, Wz = pad_last(Wc), pad_last(bc), pad_last(Wz)
        kernels = [F.pad(k, (0, hmax - k.shape[1], 0, hmax - k.shape[0]))
                   for k in kernels]
        biases = [pad_last(b) for b in biases]
        wout = F.pad(wout, (0, 0, 0, hmax - wout.shape[0]))
    return (Wc.contiguous(), bc.contiguous(), Wz.contiguous(),
            torch.stack(kernels).contiguous(), torch.stack(biases).contiguous(),
            wout.contiguous(), bout.contiguous())


def _kernel_weights(decoder) -> Tuple[Tensor, ...]:
    """:func:`padded_sdecoder_weights`, kept on the module between calls.

    The entry is keyed by each parameter's storage, device and version
    counter, so ``load_state_dict``, an in-place update or ``.to()`` makes
    the next call rebuild it. It holds the keyed storages alive, so no
    other weight can reuse their addresses while it lives. With autograd
    on, the weights are padded afresh so that gradients reach the module."""
    if torch.is_grad_enabled():
        return padded_sdecoder_weights(decoder)
    params = list(decoder.parameters())
    key = [(p.data_ptr(), p.device, p._version) for p in params]
    cache = decoder.__dict__.get("_kernel_weights")
    if cache is None or cache[0] != key:
        cache = (key, [p.detach() for p in params],
                 padded_sdecoder_weights(decoder))
        decoder.__dict__["_kernel_weights"] = cache
    return cache[2]


def apply_fused_sdecoder(decoder, grid, phi, dx, sc, z, act: str = "tanh",
                         sigmoid_out: bool = True) -> Tensor:
    """Run the fused decode from an ``sDecoderNet``. Leading batch dims of
    phi/dx/sc/z may be multi-dimensional; they are flattened for the kernel
    and restored on the output. The padded weights are built once and reused
    until a weight changes."""
    Wc, bc, Wz, hw, hb, wout, bout = _kernel_weights(decoder)
    batch_shape = z.shape[:-1]
    out = fused_spatial_decoder_forward(
        grid.contiguous(),
        phi.reshape(-1).contiguous(),
        dx.reshape(-1, dx.shape[-1]).contiguous(),
        sc.reshape(-1).contiguous(),
        z.reshape(-1, z.shape[-1]).contiguous(),
        Wc, bc, Wz, hw, hb, wout, bout, act, sigmoid_out)
    chan = (wout.shape[1],) if wout.shape[1] > 1 else ()
    return out.reshape(tuple(batch_shape) + (grid.shape[0],) + chan)
