"""Fused coordinate-transform + spatial decoder: forward, backward and the
one-pass Bernoulli train kernel.

Counterpart of ``pyroved_tpu/ops/spatial_decoder.py``. For each sample the
rotation, scale and shift fold into three H-vectors

  u = sc*(cos*Wc0 + sin*Wc1),  v = sc*(-sin*Wc0 + cos*Wc1),  w = dx@Wc + bc + z@Wz

so the first layer is ``h0 = tanh(gx*u + gy*v + w)`` and the warped grid
never exists in memory. The hidden layers and the head follow. The backward
runs the same fold in reverse (with a0 = u/sc, a1 = v/sc and d0 the
cotangent of h0's pre-activation):

  du = sum_n gx d0,  dv = sum_n gy d0,  dw = sum_n d0
  dsc = <du, a0> + <dv, a1>,  dphi = <du, v> - <dv, u>
  ddx = dw Wc^T,  dz = dw Wz^T,  dbc = sum_b dw,  dWz = z^T dw
  dWc0 = sum_b (sc cos) du - (sc sin) dv + dx0 dw
  dWc1 = sum_b (sc sin) du + (sc cos) dv + dx1 dw   (D = 1: du + dx dw)

Three kernels, each with a plain PyTorch version and a wrapper that, on a
CUDA tensor, launches the kernel or raises, and on a CPU tensor calls the
plain version:

* K1, :func:`fused_spatial_decoder_forward`, plain
  :func:`spatial_decoder_plain`: the decoded values;
* K2, :func:`fused_spatial_decoder_backward`, plain
  :func:`spatial_decoder_bwd_plain`: the grads of every input but the grid
  from the output cotangent;
* K3, :func:`fused_bernoulli_recon_loss_kernel` (K2's source in loss mode),
  plain :func:`recon_loss_plain`: the weighted Bernoulli loss and all of
  K2's grads in one pass.

:data:`BF16_MATMUL` mirrors the JAX package's flag of the same name and
meaning: set (the default, as there), the operands of every hidden-layer
product round to bf16 and the products sum in f32, in the kernels and in
the plain versions as in ``_mxu_dot``, and the kernels run on the tensor
cores (``csrc/spatial_decoder_fwd_tc.cu`` for K1,
``csrc/spatial_decoder_bwd_tc.cu`` for K2/K3). Clear, everything is f32:
K1 runs on the CUDA cores (``csrc/spatial_decoder_fwd.cu``), K2/K3 on the
tensor cores with each f32 operand split into three bf16 limbs
(``csrc/spatial_decoder_bwd_x3.cu``; :func:`limb_matmul` is its product in
plain PyTorch). The flag is read at each call.

:class:`FusedSpatialDecoder` (K1 forward, K2 backward) and
:class:`FusedBernoulliReconLoss` (K3) take the place of the JAX package's
custom VJPs; :func:`apply_fused_sdecoder` and :func:`apply_fused_recon_loss`
run them from an ``sDecoderNet`` module.

The JAX package's tile selection, per-TPU tunings and size thresholds were
measured on a TPU and have no counterpart here: the kernels pick their own
tiles, and a supported configuration always runs them.
"""
import contextlib
import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..utils.nn import get_activation
from . import _build

Tensor = torch.Tensor

#: Hidden-layer activations the kernels implement: the registry's five.
#: ``tanh_approx`` (the Pade tanh behind ``approx_tanh=True``) is the sixth.
KERNEL_ACTS = ("tanh", "relu", "lrelu", "softplus", "gelu")
KERNEL_ACTS_WITH_APPROX = KERNEL_ACTS + ("tanh_approx",)
_ACT_CODE = {name: i for i, name in enumerate(KERNEL_ACTS_WITH_APPROX)}

#: Padded hidden widths the kernels are compiled for.
KERNEL_WIDTHS = (128, 256)

#: Hidden-layer products in bf16 x bf16 -> f32, as the JAX package's
#: ``BF16_MATMUL`` (its default too): the forward's h_l W_l, and in the
#: backward dwout = h_L^T dl, dW_l = h_l^T d_pre and dh = d_pre W_l^T.
#: Heads, biases, activations and the coordinate layer stay in f32.
BF16_MATMUL = True

#: Activation buffers of one pixel tile that the backward kernels keep:
#: h_0 .. h_L, plus one of each hidden layer for gelu, whose derivative
#: needs the pre-activation (the JAX package's limit).
BWD_MAX_BUFFERS = 6


def bwd_max_layers(act: str) -> int:
    """Most hidden layers the backward kernels (K2/K3) take: 5, or 2 with
    gelu, whose derivative needs a buffer of its own for each layer. Both
    kernels take every such configuration (their tile and their weight
    staging follow the decoder's size), so the limit is the same under
    both flags."""
    return (BWD_MAX_BUFFERS - 1) // (2 if act == "gelu" else 1)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _mm(a: Tensor, b: Tensor, bf16=None) -> Tensor:
    """A hidden-layer product, ``_mxu_dot``'s: under :data:`BF16_MATMUL`
    (or ``bf16`` where given) both operands round to bf16; their products
    are exact in f32, which sums them."""
    if BF16_MATMUL if bf16 is None else bf16:
        a = a.to(torch.bfloat16).to(a.dtype)
        b = b.to(torch.bfloat16).to(b.dtype)
    return a @ b


#: The limb products of the f32 K2/K3 kernel's hidden products, (limb of
#: the left operand, limb of the right), 0 hi, 1 mid, 2 lo, in the order
#: the kernel issues them (smallest first); mid lo, lo mid and lo lo, of
#: order 2^-24 relative, are dropped.
LIMB_PAIRS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def bf16_limbs(x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The three bf16 limbs of an f32 tensor, as f32: hi = bf16(x),
    mid = bf16(x - hi), lo = bf16(x - hi - mid), each rounded to nearest.
    hi + mid + lo is x again, to its last bit."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    rest = x - hi
    mid = rest.to(torch.bfloat16).to(x.dtype)
    return hi, mid, (rest - mid).to(torch.bfloat16).to(x.dtype)


def limb_matmul(a: Tensor, b: Tensor, pairs=LIMB_PAIRS) -> Tensor:
    """``a @ b`` as the f32 K2/K3 kernel forms its hidden products: both
    operands split into :func:`bf16_limbs` and the products of the limb
    ``pairs`` summed (each product of bf16 values is exact in f32, which
    sums it). For the tests and ``chip_smoke.py``: the port's plain
    versions keep their f32 ``@``."""
    la, lb = bf16_limbs(a), bf16_limbs(b)
    out = None
    for i, j in pairs:
        p = la[i] @ lb[j]
        out = p if out is None else out + p
    return out


def _pade_tanh(x: Tensor) -> Tensor:
    """7/6 Pade approximant of tanh with its input clamp."""
    x = torch.clamp(x, -4.97, 4.97)
    x2 = x * x
    num = x * (135135.0 + x2 * (17325.0 + x2 * (378.0 + x2)))
    den = 135135.0 + x2 * (62370.0 + x2 * (3150.0 + 28.0 * x2))
    return num / den


#: The tensor-core K1's tanh (``csrc/sm90_common.cuh``, ``tanh_exp2``):
#: tanh(x) = 1 - 2 / (2^a + 1) with a = TWO_LOG2E x in f32, 2^a from the
#: special-function unit. Within 2.5e-7 of f64 tanh: the card's over every
#: f32 input (``chip_smoke.py``'s probe), the mirror below over the CPU
#: tests' sweep.
TWO_LOG2E = float.fromhex("0x1.715476p+1")


def _fma32(a: Tensor, b, c) -> Tensor:
    """fma(a, b, c) of f32 values, rounded once to f32 (through f64, whose
    53 bits hold the product exactly)."""
    return (a.double() * b + c).float()


def tanh_exp2_plain(x: Tensor) -> Tensor:
    """The kernel's tanh of f32 ``x`` (``tanh_exp2`` on a = TWO_LOG2E x)
    in f32 steps, 2^a and the reciprocal correctly rounded where the
    card's are approximate: for the tests; the port's plain versions use
    torch.tanh."""
    e = torch.exp2(x.float() * TWO_LOG2E)
    return _fma32(torch.reciprocal(e + 1.0), -2.0, 1.0)


def _act(name: str, x: Tensor) -> Tensor:
    """A hidden-layer activation: the registry's, or the Pade tanh."""
    return _pade_tanh(x) if name == "tanh_approx" else get_activation(name)(x)


def _h0_act(name: str, x: Tensor) -> Tensor:
    """The coordinate-fusion layer is tanh, in the requested flavour."""
    return _pade_tanh(x) if name == "tanh_approx" else torch.tanh(x)


def _act_grad_from_post(name: str, h: Tensor) -> Tensor:
    """d act / d pre from the post-activation, as the JAX kernel takes it:
    the subgradient at 0 is 1 for lrelu and 0 for relu, and the Pade tanh
    uses tanh's 1 - h^2."""
    if name in ("tanh", "tanh_approx"):
        return 1.0 - h * h
    if name == "lrelu":
        return torch.where(h >= 0.0, 1.0, 0.01)
    if name == "softplus":
        return 1.0 - torch.exp(-h)
    return (h > 0.0).to(h.dtype)


def _gelu_and_grad(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Exact gelu and its derivative Phi(x) + x phi(x)."""
    cdf = 0.5 * (1.0 + torch.erf(x * 0.7071067811865476))
    return x * cdf, cdf + x * 0.3989422804014327 * torch.exp(-0.5 * x * x)


def _softplus(x: Tensor) -> Tensor:
    """softplus in the stable form the kernel uses (no threshold)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def spatial_decoder_plain(grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout,
                          bout, act: str = "tanh", sigmoid_out: bool = True,
                          *, bf16=None) -> Tensor:
    """Plain PyTorch forward: grid [N, D], phi/sc [B], dx [B, D], z [B, L],
    Wc [D, H], bc [H], Wz [L, H], hw [nl, H, H], hb [nl, H], wout [H, C],
    bout [C]. Returns [B, N] for C == 1, else [B, N, C]. The hidden
    products follow :data:`BF16_MATMUL`, or ``bf16`` where given."""
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
        h = _act(act, _mm(h, hw[i], bf16) + hb[i])
    out = h @ wout + bout
    if wout.shape[1] == 1:
        out = out[..., 0]
    return torch.sigmoid(out) if sigmoid_out else out


def spatial_decoder_reference(grid, phi, dx, sc, z, Wc, bc, Wz, hidden,
                              wout, bout) -> Tensor:
    """The JAX package's reference decode: :func:`spatial_decoder_plain`
    with tanh layers, a sigmoid head and f32 products whatever
    :data:`BF16_MATMUL` says, ``hidden`` a sequence of (W [H, H], b [H])
    pairs. Returns [B, N] for one channel."""
    hw = torch.stack([W for W, _ in hidden])
    hb = torch.stack([b for _, b in hidden])
    return spatial_decoder_plain(grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb,
                                 wout, bout, "tanh", True, bf16=False)


def _folded_forward(grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, act):
    """The kernels' recompute over the whole batch, in the folded form:
    (every layer's output [B, N, H], gelu's act'(pre) per layer, and
    (a0, a1, u, v) for D = 2)."""
    gx = grid[:, 0][None, :, None]
    w = dx @ Wc + bc + z @ Wz
    fold = None
    if grid.shape[-1] == 2:
        c, s = torch.cos(phi)[:, None], torch.sin(phi)[:, None]
        a0 = c * Wc[0] + s * Wc[1]
        a1 = -s * Wc[0] + c * Wc[1]
        u, v = sc[:, None] * a0, sc[:, None] * a1
        gy = grid[:, 1][None, :, None]
        pre = gx * u[:, None] + gy * v[:, None] + w[:, None]
        fold = (a0, a1, u, v)
    else:
        pre = gx * Wc[0] + w[:, None]
    hs, gelu_grads = [_h0_act(act, pre)], []
    for i in range(hw.shape[0]):
        pre = _mm(hs[-1], hw[i]) + hb[i]
        if act == "gelu":
            h, g = _gelu_and_grad(pre)
            gelu_grads.append(g)
        else:
            h = _act(act, pre)
        hs.append(h)
    return hs, gelu_grads, fold


def _backprop(grid, phi, dx, sc, z, Wc, Wz, hw, wout, act, hs, gelu_grads,
              fold, dl):
    """The eleven grads from the head's cotangent ``dl [B, N, C]``."""
    B, N, C = dl.shape
    H = Wc.shape[1]
    dbout = dl.sum((0, 1))
    dwout = _mm(hs[-1].reshape(-1, H).T, dl.reshape(-1, C))
    dh = dl @ wout.T
    dhw, dhb = torch.zeros_like(hw), hw.new_zeros(hw.shape[:2])
    for i in reversed(range(hw.shape[0])):
        ag = (gelu_grads[i] if act == "gelu"
              else _act_grad_from_post(act, hs[i + 1]))
        d_pre = dh * ag
        dhw[i] = _mm(hs[i].reshape(-1, H).T, d_pre.reshape(-1, H))
        dhb[i] = d_pre.sum((0, 1))
        dh = _mm(d_pre, hw[i].T)
    d0 = dh * (1.0 - hs[0] * hs[0])  # the coordinate layer is tanh
    dw = d0.sum(1)
    du = (grid[:, 0][None, :, None] * d0).sum(1)
    ddx, dz = dw @ Wc.T, dw @ Wz.T
    dWz, dbc = z.T @ dw, dw.sum(0)
    if fold is not None:
        a0, a1, u, v = fold
        dv = (grid[:, 1][None, :, None] * d0).sum(1)
        dsc = (du * a0).sum(-1) + (dv * a1).sum(-1)
        dphi = (du * v).sum(-1) - (dv * u).sum(-1)
        c, s = sc * torch.cos(phi), sc * torch.sin(phi)
        dWc = torch.stack([c @ du - s @ dv + dx[:, 0] @ dw,
                           s @ du + c @ dv + dx[:, 1] @ dw])
    else:
        dphi, dsc = torch.zeros_like(phi), torch.zeros_like(sc)
        dWc = (du.sum(0) + dx[:, 0] @ dw)[None]
    return dphi, ddx, dsc, dz, dWc, dbc, dWz, dhw, dhb, dwout, dbout


def spatial_decoder_bwd_plain(grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb,
                              wout, bout, g, act: str = "tanh",
                              sigmoid_out: bool = True) -> Tuple[Tensor, ...]:
    """Plain PyTorch version of K2, the counterpart of ``_bwd``.

    Takes the forward's inputs (shapes as :func:`spatial_decoder_plain`)
    and the output cotangent ``g`` ([B, N] or [B, N, C]). Returns the
    grads of (phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout, bout), bout's
    shaped [C]; the grid gets none. Written by hand from the folded-
    transform formulas of the module docstring, with every activation
    materialized: the derivatives come from the post-activation as the
    kernel takes them (for gelu, from the pre-activation), so this is the
    kernel's arithmetic, not autograd's."""
    hs, gelu_grads, fold = _folded_forward(grid, phi, dx, sc, z, Wc, bc, Wz,
                                           hw, hb, act)
    dl = g.reshape(g.shape[0], g.shape[1], wout.shape[1])
    if sigmoid_out:
        s = torch.sigmoid(hs[-1] @ wout + bout)
        dl = dl * s * (1.0 - s)
    return _backprop(grid, phi, dx, sc, z, Wc, Wz, hw, wout, act, hs,
                     gelu_grads, fold, dl)


def recon_loss_plain(grid, phi, dx, sc, z, x, wgt, Wc, bc, Wz, hw, hb, wout,
                     bout, act: str = "tanh") -> Tuple[Tensor, Tuple]:
    """Plain PyTorch version of K3, the counterpart of ``_train_call``.

    ``x [B, N]`` are the observations and ``wgt [B]`` the per-example
    weights; the head is one channel with a sigmoid. Returns the loss
    ``-sum_b wgt_b sum_n [x logit - softplus(logit)]`` (a 0-d tensor) and
    the grads of :func:`spatial_decoder_bwd_plain`, from the head cotangent
    ``wgt_b (sigmoid(logit) - x)``. Written by hand like K2's plain
    version."""
    hs, gelu_grads, fold = _folded_forward(grid, phi, dx, sc, z, Wc, bc, Wz,
                                           hw, hb, act)
    logit = (hs[-1] @ wout + bout)[..., 0]
    wm = wgt[:, None]
    loss = -(wm * (x * logit - _softplus(logit))).sum()
    dl = (wm * (torch.sigmoid(logit) - x))[..., None]
    return loss, _backprop(grid, phi, dx, sc, z, Wc, Wz, hw, wout, act, hs,
                           gelu_grads, fold, dl)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_fwd_fns = {}
_bwd_fns = {}

#: K1's sources: the tensor-core kernel under BF16_MATMUL, else f32.
FWD_SOURCES = {True: "spatial_decoder_fwd_tc", False: "spatial_decoder_fwd"}
#: K2/K3's sources: bf16 products under BF16_MATMUL, else f32 products as
#: three-limb splits; both on the tensor cores.
BWD_SOURCES = {True: "spatial_decoder_bwd_tc", False: "spatial_decoder_bwd_x3"}
#: The C entry points of each source (``<prefix>`` and ``<prefix>_plan``).
BWD_ENTRIES = {True: "pvt_sdec_bwd_tc", False: "pvt_sdec_bwd_x3"}


def _bind_fwd(lib, bf16: bool):
    """K1's launch in a library built from its source for the flag value
    ``bf16``; both sources take the same arguments."""
    f = getattr(lib, "pvt_sdec_fwd_tc" if bf16 else "pvt_sdec_fwd")
    f.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _fwd_kernel(bf16: bool):
    """K1's launch from its source for the flag value ``bf16``
    (:data:`FWD_SOURCES`)."""
    if bf16 not in _fwd_fns:
        _fwd_fns[bf16] = _bind_fwd(_build.load(FWD_SOURCES[bf16]), bf16)
    return _fwd_fns[bf16]


def fwd_tc_max_layers(H: int, C: int, device="cuda") -> int:
    """Most hidden layers the tensor-core K1 takes at width ``H`` with ``C``
    channels on ``device``, as its source works them out from its
    shared-memory layout (at H = 128 every layer's bf16 weights stay
    resident). Kept per width, channels and card."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    return _fwd_tc_max_layers(H, C, index)


@functools.lru_cache(maxsize=16)
def _fwd_tc_max_layers(H, C, index):
    f = _build.load(FWD_SOURCES[True]).pvt_sdec_fwd_tc_max_layers
    f.argtypes = [ctypes.c_int, ctypes.c_int]
    f.restype = ctypes.c_int
    with torch.cuda.device(index):
        n = f(H, C)
    if n < 0:
        raise RuntimeError(f"the tensor-core forward kernel's layer limit at "
                           f"H={H}, C={C} could not be read")
    return n


def _bind_bwd(lib, prefix: str):
    """(plan, launch) of a K2/K3 library whose entry points are ``prefix``
    and ``prefix + "_plan"``; every source takes the same arguments."""
    plan = getattr(lib, prefix + "_plan")
    plan.argtypes = [ctypes.c_int] * 9 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
    plan.restype = ctypes.c_int
    run = getattr(lib, prefix)
    run.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    run.restype = ctypes.c_int
    return plan, run


def fwd_tc_tanh(x: Tensor) -> Tensor:
    """The tensor-core K1's tanh of the contiguous f32 tensor ``x``. On a
    CUDA tensor it launches the source's probe kernel
    (``pvt_sdec_fwd_tc_tanh``) on the current stream, on a CPU tensor it is
    :func:`tanh_exp2_plain`. ``chip_smoke.py`` holds the card's to f64
    tanh."""
    if x.device.type == "cpu":
        return tanh_exp2_plain(x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 tensor")
    f = _build.load(FWD_SOURCES[True]).pvt_sdec_fwd_tc_tanh
    f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.c_void_p]
    f.restype = ctypes.c_int
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = f(x.data_ptr(), y.data_ptr(), x.numel(),
                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"the tanh probe's launch failed: CUDA error {err}")
    return y


def _bwd_kernel(bf16: bool):
    """(plan, launch) of K2/K3's source for the flag value ``bf16``
    (:data:`BWD_SOURCES`)."""
    if bf16 not in _bwd_fns:
        _bwd_fns[bf16] = _bind_bwd(_build.load(BWD_SOURCES[bf16]),
                                   BWD_ENTRIES[bf16])
    return _bwd_fns[bf16]


def _check(name: str, t: Tensor, shape: Tuple[int, ...], device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device``: one combined test lets a valid tensor through (every decode
    pays it), the tests after it name the fault."""
    if (t.device == device and t.dtype == torch.float32 and t.shape == shape
            and t.is_contiguous()):
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel_dims(grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout, bout,
                 act: str) -> Tuple[int, ...]:
    """(B, N, D, L, H, nl, C) of decoder inputs on a CUDA device that the
    kernels take, or raise: H 128 or 256, D 1 or 2, C 1..4, float32,
    contiguous, hw 16-byte aligned."""
    dev = grid.device
    if dev.type != "cuda":
        raise ValueError(f"no spatial-decoder kernel for {dev}")
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
    for name, t, shape in (
            ("grid", grid, (N, D)), ("phi", phi, (B,)), ("dx", dx, (B, D)),
            ("sc", sc, (B,)), ("z", z, (B, L)), ("Wc", Wc, (D, H)),
            ("bc", bc, (H,)), ("Wz", Wz, (L, H)), ("hw", hw, (nl, H, H)),
            ("hb", hb, (nl, H)), ("wout", wout, (H, C)), ("bout", bout, (C,))):
        _check(name, t, shape, dev)
    if hw.data_ptr() % 16:  # the kernels stage weights as float4
        raise ValueError("hw must be 16-byte aligned")
    return B, N, D, L, H, nl, C


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as a pointer, without
    the Python Stream object ``torch.cuda.current_stream`` builds."""
    return torch._C._cuda_getCurrentRawStream(index)


def fused_spatial_decoder_forward(grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb,
                                  wout, bout, act: str = "tanh",
                                  sigmoid_out: bool = True) -> Tensor:
    """Fused transform + decode, K1 (shapes as :func:`spatial_decoder_plain`).

    On CPU tensors this is the plain version. On CUDA tensors it launches
    the kernel on the current stream, or raises when the inputs do not fit
    it (see :func:`_kernel_dims`; the tensor-core kernel takes at most
    :func:`fwd_tc_max_layers` hidden layers): the tensor-core kernel under
    :data:`BF16_MATMUL`, else the f32 one. The output is deterministic: the
    same inputs on the same card give bitwise-equal values. It is forward
    only: for gradients use :class:`FusedSpatialDecoder`.
    ``fused_spatial_decoder_forward.launches`` counts kernel launches by
    source (:data:`FWD_SOURCES`)."""
    if grid.device.type == "cpu":
        return spatial_decoder_plain(grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb,
                                     wout, bout, act, sigmoid_out)
    B, N, D, L, H, nl, C = _kernel_dims(grid, phi, dx, sc, z, Wc, bc, Wz, hw,
                                        hb, wout, bout, act)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (phi, dx, sc, z, Wc, bc, Wz, hw, hb,
                                      wout, bout)):
        raise RuntimeError("the spatial-decoder forward kernel records no "
                           "gradient: use FusedSpatialDecoder, or call it "
                           "under torch.no_grad()")
    bf16 = BF16_MATMUL
    dev = grid.device
    if bf16:
        limit = _fwd_tc_max_layers(H, C, dev.index)
        if nl > limit:
            raise ValueError(f"the tensor-core forward kernel takes at most "
                             f"{limit} hidden layers at width {H} with {C} "
                             f"channels, got {nl}")
    out = torch.empty((B, N, C) if C > 1 else (B, N), device=dev,
                      dtype=torch.float32)
    if B == 0 or N == 0:  # nothing to launch
        return out
    fn = _fwd_kernel(bf16)
    # the launch's device is the current one: switch only when it is not
    with (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
          else contextlib.nullcontext()):
        err = fn(grid.data_ptr(), phi.data_ptr(), dx.data_ptr(),
                 sc.data_ptr(), z.data_ptr(), Wc.data_ptr(), bc.data_ptr(),
                 Wz.data_ptr(), hw.data_ptr(), hb.data_ptr(),
                 wout.data_ptr(), bout.data_ptr(), out.data_ptr(),
                 B, N, D, L, H, nl, C, _ACT_CODE[act], int(bool(sigmoid_out)),
                 int(bf16), _raw_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"spatial-decoder kernel launch failed: CUDA error "
                           f"{err}")
    fused_spatial_decoder_forward.launches[FWD_SOURCES[bf16]] += 1
    return out


fused_spatial_decoder_forward.launches = dict.fromkeys(FWD_SOURCES.values(), 0)


def bwd_workspace(B: int, N: int, D: int, L: int, H: int, nl: int, C: int,
                  act: str = "tanh", loss_mode: bool = False,
                  device="cuda", bf16: bool = None) -> Tuple[int, int]:
    """(workspace bytes, blocks) of one K2/K3 call on ``device`` with the
    kernel of ``bf16`` (default: :data:`BF16_MATMUL`): one slot of
    weight-grad partials per block, the du/dv/dw sums of every pixel tile
    and of every sample, and the weights in bf16 (bf16 kernel) or as three
    bf16 limbs (f32 kernel).
    Kept per shape and card: the plan depends on nothing else."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    return _bwd_plan(BF16_MATMUL if bf16 is None else bool(bf16), B, N, D, L,
                     H, nl, C, act, bool(loss_mode), index)


@functools.lru_cache(maxsize=64)
def _bwd_plan(bf16, B, N, D, L, H, nl, C, act, loss_mode, index):
    plan, _ = _bwd_kernel(bf16)
    floats, blocks = ctypes.c_longlong(), ctypes.c_int()
    with torch.cuda.device(index):
        err = plan(B, N, D, L, H, nl, C, _ACT_CODE[act], int(loss_mode),
                   ctypes.byref(floats), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"spatial-decoder backward plan failed: CUDA error "
                           f"{err}")
    return 4 * floats.value, blocks.value


def _launch_bwd(inputs, g, x, wgt, act: str, sigmoid_out: bool,
                loss_mode: bool, bf16: bool) -> Tuple[Tensor, ...]:
    """Run K2 (``g``) or K3 (``x``, ``wgt``) on checked CUDA inputs, with the
    tensor-core kernel if ``bf16``; returns the eleven grads, then the loss
    for K3."""
    B, N, D, L, H, nl, C = _kernel_dims(*inputs, act)
    if nl > bwd_max_layers(act):
        raise ValueError(f"the backward kernel takes at most "
                         f"{bwd_max_layers(act)} hidden layers with {act}, "
                         f"got {nl}")
    dev = inputs[0].device
    sizes = [B, B * D, B, B * L, D * H, H, L * H, nl * H * H, nl * H, H * C,
             C] + ([1] if loss_mode else [])
    shapes = [(B,), (B, D), (B,), (B, L), (D, H), (H,), (L, H), (nl, H, H),
              (nl, H), (H, C), (C,)] + ([()] if loss_mode else [])
    if B == 0 or N == 0:  # nothing to launch: every sum is empty
        out = torch.zeros(sum(sizes), device=dev, dtype=torch.float32)
    else:
        ws_bytes, blocks = bwd_workspace(B, N, D, L, H, nl, C, act, loss_mode,
                                         dev, bf16)
        ws = torch.empty(ws_bytes // 4, device=dev, dtype=torch.float32)
        out = torch.empty(sum(sizes), device=dev, dtype=torch.float32)
        _, run = _bwd_kernel(bf16)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = run(*(t.data_ptr() for t in inputs), ptr(g), ptr(x),
                      ptr(wgt), out.data_ptr(), ws.data_ptr(), B, N, D, L, H,
                      nl, C, _ACT_CODE[act], int(bool(sigmoid_out)),
                      int(loss_mode), blocks, stream)
        if err != 0:
            raise RuntimeError(f"spatial-decoder backward kernel launch "
                               f"failed: CUDA error {err}")
    return tuple(t.reshape(s) for t, s in zip(torch.split(out, sizes), shapes))


def fused_spatial_decoder_backward(grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb,
                                   wout, bout, g, act: str = "tanh",
                                   sigmoid_out: bool = True
                                   ) -> Tuple[Tensor, ...]:
    """K2: the grads of :func:`spatial_decoder_bwd_plain` from the output
    cotangent ``g`` ([B, N] or [B, N, C], read in place).

    On CPU tensors this is the plain version. On CUDA tensors it launches
    the kernel on the current stream, or raises (inputs as
    :func:`fused_spatial_decoder_forward`, at most
    :func:`bwd_max_layers` hidden layers): the bf16 kernel under
    :data:`BF16_MATMUL`, else the f32 one (three-limb products). The grads
    are deterministic:
    the same inputs on the same card give bitwise-equal grads.
    ``fused_spatial_decoder_backward.launches`` counts kernel launches by
    source (:data:`BWD_SOURCES`)."""
    if grid.device.type == "cpu":
        return spatial_decoder_bwd_plain(grid, phi, dx, sc, z, Wc, bc, Wz,
                                         hw, hb, wout, bout, g, act,
                                         sigmoid_out)
    inputs = (grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout, bout)
    B, N, C = z.shape[0], grid.shape[0], wout.shape[1]
    _check("g", g, (B, N, C) if C > 1 else (B, N), grid.device)
    bf16 = BF16_MATMUL
    grads = _launch_bwd(inputs, g, None, None, act, sigmoid_out, False, bf16)
    fused_spatial_decoder_backward.launches[BWD_SOURCES[bf16]] += 1
    return grads


fused_spatial_decoder_backward.launches = dict.fromkeys(BWD_SOURCES.values(), 0)


def fused_bernoulli_recon_loss_kernel(grid, phi, dx, sc, z, x, wgt, Wc, bc,
                                      Wz, hw, hb, wout, bout,
                                      act: str = "tanh"
                                      ) -> Tuple[Tensor, Tuple]:
    """K3: ``(loss, grads)`` of :func:`recon_loss_plain` in one pass.

    On CPU tensors this is the plain version. On CUDA tensors it launches
    K2's kernel (chosen by :data:`BF16_MATMUL`) in loss mode (one channel,
    sigmoid head; ``x [B, N]``, ``wgt [B]``) or raises. dbout comes back
    shaped like bout, [1]. ``fused_bernoulli_recon_loss_kernel.launches``
    counts kernel launches by source (:data:`BWD_SOURCES`)."""
    if grid.device.type == "cpu":
        return recon_loss_plain(grid, phi, dx, sc, z, x, wgt, Wc, bc, Wz, hw,
                                hb, wout, bout, act)
    inputs = (grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout, bout)
    B, N = z.shape[0], grid.shape[0]
    if wout.shape[1] != 1:
        raise ValueError("the one-pass loss kernel takes one channel")
    _check("x", x, (B, N), grid.device)
    _check("wgt", wgt, (B,), grid.device)
    bf16 = BF16_MATMUL
    *grads, loss = _launch_bwd(inputs, None, x, wgt, act, True, True, bf16)
    fused_bernoulli_recon_loss_kernel.launches[BWD_SOURCES[bf16]] += 1
    return loss, tuple(grads)


fused_bernoulli_recon_loss_kernel.launches = dict.fromkeys(
    BWD_SOURCES.values(), 0)


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

class FusedSpatialDecoder(torch.autograd.Function):
    """K1 forward, K2 backward: the counterpart of the JAX package's
    ``fused_spatial_decoder`` custom VJP. Only the inputs are saved; the
    backward recomputes the activations. The grid gets no gradient."""

    @staticmethod
    def forward(ctx, grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout, bout,
                act, sigmoid_out):
        with torch.no_grad():
            out = fused_spatial_decoder_forward(grid, phi, dx, sc, z, Wc, bc,
                                                Wz, hw, hb, wout, bout, act,
                                                sigmoid_out)
        ctx.save_for_backward(grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout,
                              bout)
        ctx.act, ctx.sigmoid_out = act, sigmoid_out
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        grads = fused_spatial_decoder_backward(*ctx.saved_tensors,
                                               g.contiguous(), ctx.act,
                                               ctx.sigmoid_out)
        return (None, *grads, None, None)


class FusedBernoulliReconLoss(torch.autograd.Function):
    """K3 as an op: the forward returns the weighted Bernoulli loss and
    keeps the grads K3 computed with it; the backward scales them by the
    upstream cotangent. Exact because the loss enters the training loss
    linearly. ``x`` and ``wgt`` get no gradient."""

    @staticmethod
    def forward(ctx, grid, phi, dx, sc, z, x, wgt, Wc, bc, Wz, hw, hb, wout,
                bout, act):
        with torch.no_grad():
            loss, grads = fused_bernoulli_recon_loss_kernel(
                grid, phi, dx, sc, z, x, wgt, Wc, bc, Wz, hw, hb, wout, bout,
                act)
        ctx.save_for_backward(*grads)
        return loss

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        dphi, ddx, dsc, dz, *weights = (ct * g for g in ctx.saved_tensors)
        return (None, dphi, ddx, dsc, dz, None, None, *weights, None)


def fused_spatial_decoder(grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout,
                          bout, act: str = "tanh",
                          sigmoid_out: bool = True) -> Tensor:
    """The fused transform + decode with its gradient, in the JAX package's
    argument order: :class:`FusedSpatialDecoder` (K1 forward, K2 backward
    on CUDA tensors, the plain versions on CPU ones). ``bout`` may be [C]
    or, for one channel, a scalar. Returns [B, N] for one channel, else
    [B, N, C]."""
    return FusedSpatialDecoder.apply(grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb,
                                     wout, bout.reshape(-1), act, sigmoid_out)


# ---------------------------------------------------------------------------
# Model integration
# ---------------------------------------------------------------------------

def sdecoder_supports_fusion(hidden_dim, activation: str, sigmoid_out: bool,
                             coord: int, channels: int = 1,
                             device="cuda") -> bool:
    """True when an sDecoderNet configuration maps onto the kernels and
    ``device`` runs them: an active coordinate transform, a kernel
    activation, 1..4 channels, a padded width ``round_up(max(hidden), 128)``
    the kernels are built for (128 or 256), no more hidden layers than the
    backward takes (:func:`bwd_max_layers`), and a Hopper card. The
    configuration alone decides: no timing enters the gate. On
    ``device="cpu"`` a supported configuration also counts, since there
    the wrappers run their plain versions: the model takes the same path on
    both."""
    hidden = tuple(hidden_dim) if hidden_dim is not None else (128, 128)
    del sigmoid_out  # both heads supported
    device = torch.device(device)
    hopper = (device.type == "cuda" and torch.cuda.is_available()
              and torch.cuda.get_device_capability(device) == (9, 0))
    return (0 < coord < 5
            and activation in KERNEL_ACTS
            and 1 <= int(channels) <= 4
            and _round_up(max(hidden), 128) in KERNEL_WIDTHS
            and len(hidden) <= bwd_max_layers(activation)
            and (device.type == "cpu" or hopper))


def padded_sdecoder_weights(decoder) -> Tuple[Tensor, ...]:
    """(Wc [D,H], bc [H], Wz [L,H], hw [nl,H,H], hb [nl,H], wout [H,C],
    bout [C]) from an ``sDecoderNet``, in the kernel's input-major layout,
    every hidden width zero-padded to ``round_up(max width, 128)``.

    The padding is exact: padded lanes get zero weights in and zero bias,
    and every weight out of a padded lane is zero, so they add nothing to
    real lanes or to the head (for softplus they carry log 2, which the
    zero outgoing weights drop). Built under autograd, the grads that land
    on padded entries are dropped when ``F.pad`` maps them back."""
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
    on, the weights are padded afresh so that gradients reach the module,
    and so they are while a CUDA graph is captured, so that each replay
    pads the parameters as they then are."""
    if torch.is_grad_enabled() or (decoder.out.weight.is_cuda and
                                   torch.cuda.is_current_stream_capturing()):
        return padded_sdecoder_weights(decoder)
    params = list(decoder.parameters())
    key = [(p.data_ptr(), p.device, p._version) for p in params]
    cache = decoder.__dict__.get("_kernel_weights")
    if cache is None or cache[0] != key:
        cache = (key, [p.detach() for p in params],
                 padded_sdecoder_weights(decoder))
        decoder.__dict__["_kernel_weights"] = cache
    return cache[2]


def _flat_latents(grid, phi, dx, sc, z):
    return (grid.contiguous(), phi.reshape(-1).contiguous(),
            dx.reshape(-1, dx.shape[-1]).contiguous(),
            sc.reshape(-1).contiguous(), z.reshape(-1, z.shape[-1]).contiguous())


def apply_fused_sdecoder(decoder, grid, phi, dx, sc, z, act: str = "tanh",
                         sigmoid_out: bool = True, weights=None) -> Tensor:
    """Run the fused decode from an ``sDecoderNet``. Leading batch dims of
    phi/dx/sc/z may be multi-dimensional; they are flattened for the kernel
    and restored on the output. With autograd on it goes through
    :class:`FusedSpatialDecoder`, so the backward is K2 and the grads reach
    the module's parameters; otherwise the padded weights are built once
    and reused until a weight changes. ``weights`` (as
    :func:`padded_sdecoder_weights` gives them) take the place of the
    module's own."""
    if weights is None:
        weights = _kernel_weights(decoder)
    args = _flat_latents(grid, phi, dx, sc, z) + tuple(weights)
    if torch.is_grad_enabled():
        out = FusedSpatialDecoder.apply(*args, act, sigmoid_out)
    else:
        out = fused_spatial_decoder_forward(*args, act, sigmoid_out)
    C = weights[5].shape[1]
    chan = (C,) if C > 1 else ()
    return out.reshape(tuple(z.shape[:-1]) + (grid.shape[0],) + chan)


def apply_fused_recon_loss(decoder, grid, phi, dx, sc, z, x, wgt,
                           act: str = "tanh") -> Tensor:
    """The weighted Bernoulli reconstruction loss
    ``-sum_b wgt_b sum_n log p(x_bn | sigmoid(decode_bn))`` of an
    ``sDecoderNet`` with one channel and a sigmoid head, through K3
    (:class:`FusedBernoulliReconLoss`): z [B, L], x [B, N], wgt [B]."""
    g, phi, dx, sc, z = _flat_latents(grid, phi, dx, sc, z)
    return FusedBernoulliReconLoss.apply(
        g, phi, dx, sc, z, x.reshape(z.shape[0], -1).contiguous(),
        wgt.reshape(-1).contiguous(), *_kernel_weights(decoder), act)
