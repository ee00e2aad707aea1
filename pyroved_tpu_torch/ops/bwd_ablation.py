"""K4: the backward kernel in ablation modes.

Counterpart of ``benchmarks/bwd_ablation.py``'s ``_variant_kernel`` (built
by its ``build_call``): K2's one-channel, 2-D, tanh, sigmoid-head backward,
each mode stripping part of it so that the differences of their times
split K2's time. On the card every mode is a compile-time variant of K2's
own sources, ``csrc/spatial_decoder_bwd_tc.cu`` under :data:`BF16_MATMUL`
and ``csrc/spatial_decoder_bwd_x3.cu`` without, each built with
``-DPVT_ABLATE=<index of the mode in MODES>`` into a library of its own.

The inputs have padded size: ``B`` a multiple of the batch tile ``b_t``,
``N`` of the pixel tile ``n_t``; every row and pixel is real. They take
K2's shapes (grid [N, 2], phi [B], dx [B, 2], sc [B], z [B, L], Wc [2, H],
bc [H], Wz [L, H], hw [nl, H, H], hb [nl, H], wout [H, 1], bout [1], g [B,
N]; the one-channel vectors may carry a unit axis, as JAX's do). The
eleven outputs come in JAX's order and shapes: dphi [B, 1], ddx [B, 2],
dsc [B, 1], dz [B, L], dWc [2, H], dbc [1, H], dWz [L, H], dhw [nl, H, H],
dhb [nl, H], dwout [1, H], dbout [1, 1].

What each mode computes (``I = B / b_t`` batch tiles, ``J = N / n_t``
pixel tiles; ``i(b)`` the batch tile of sample b):

* ``dma_floor``: dz[b, :] is the sum over j of one scalar per tile (i(b),
  j): the tile's grid, z, phi, dx, sc and g blocks and all of every weight
  but bout. Every other output is zero.
* ``fwd_remat``: the forward recompute; dwout the sum of h_L over every
  row, dz[b, :] the sum of h_L over the samples of b's batch tile and all
  pixels; every other output zero. ``fwd_noact``: the same with identity
  activations (h0 too).
* ``full`` and ``full_dg``: the backward; dwout in f32 from the f32 h_L
  (the hidden products follow the flag). The two are one function: JAX's
  ``full_dg`` contracts without a transpose, and ``wgmma`` reads either
  major order, so on Hopper they are one kernel body.
* ``no_breduce``: each tile's dw vector is the whole tile's sum of d0 and
  its du, dv the sums over the tile's first sample; summed over the pixel
  tiles, dw[b] is the sum of the per-sample dw over b's batch tile and
  du[b], dv[b] those of the batch tile's first sample. Every grad
  downstream is computed from these.
* ``mxu_dwout``: ``full`` with dwout zero and, for each tile, the sum of
  its h_L^T dl (both operands rounded to bf16 under the flag) added to
  every entry of its batch tile's dz rows.
* ``mxu_dhb``: ``full`` with each db_l the sum of d_pre_l's rows as a
  matrix product against ones: of its bf16-rounded values under the flag.

Where the hidden products round, they follow the port's ``BF16_MATMUL``,
read at each call (:func:`spatial_decoder._mm`); the coordinate layer and
the head stay f32. :func:`variant` is the entry point: the kernel on a
Hopper card, the plain version on CPU tensors.
"""
import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from . import spatial_decoder as sd

Tensor = torch.Tensor

#: The eight modes, in the order ``benchmarks/bwd_ablation.py``'s ``main``
#: runs them; a mode's index is its ``PVT_ABLATE`` value.
MODES = ("dma_floor", "fwd_noact", "fwd_remat", "no_breduce", "full",
         "full_dg", "mxu_dwout", "mxu_dhb")

#: The C entry points of each flag's ablation builds.
ENTRIES = {True: "pvt_sdec_abl_tc", False: "pvt_sdec_abl_x3"}

OUTPUT_NAMES = ("dphi", "ddx", "dsc", "dz", "dWc", "dbc", "dWz", "dhw", "dhb",
               "dwout", "dbout")


def defines(mode: str) -> Tuple[str]:
    """The macros of ``mode``'s build of either source."""
    return (f"PVT_ABLATE={MODES.index(mode)}",)


def launch_key(mode: str, bf16: bool) -> str:
    """The key of ``variant.launches`` for ``mode`` under the flag value
    ``bf16``: the source, then the mode."""
    return f"{sd.BWD_SOURCES[bool(bf16)]}:{mode}"


def _bf16(t: Tensor) -> Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _check_tiles(B: int, N: int, b_t: int, n_t: int) -> None:
    if b_t < 1 or n_t < 1 or B % b_t or N % n_t:
        raise ValueError(f"the inputs must have padded size: B={B} a "
                         f"multiple of b_t={b_t}, N={N} of n_t={n_t}")


def variant_plain(mode, grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout, bout,
                  g, *, n_layers: int, b_t: int, n_t: int
                  ) -> Tuple[Tensor, ...]:
    """Plain PyTorch version of K4 in ``mode`` (module docstring): the
    eleven outputs in JAX's order and shapes."""
    if mode not in MODES:
        raise ValueError(f"no ablation mode {mode!r}; modes: {MODES}")
    N, B, L, H = grid.shape[0], z.shape[0], z.shape[1], Wc.shape[1]
    _check_tiles(B, N, b_t, n_t)
    if grid.shape[1] != 2 or hw.shape[0] != n_layers:
        raise ValueError("K4 is 2-D with n_layers hidden layers")
    phi, sc, bc, wout, bout = (t.reshape(-1) for t in (phi, sc, bc, wout,
                                                         bout))
    I, J = B // b_t, N // n_t

    def per_batch_tile(v):  # [B] -> each sample gets its batch tile's sum
        return v.reshape(I, b_t).sum(1).repeat_interleave(b_t)

    zeros = dict(dphi=phi.new_zeros(B, 1), ddx=dx.new_zeros(B, 2),
                 dsc=sc.new_zeros(B, 1), dz=z.new_zeros(B, L),
                 dWc=Wc.new_zeros(2, H), dbc=Wc.new_zeros(1, H),
                 dWz=Wz.new_zeros(L, H), dhw=torch.zeros_like(hw),
                 dhb=torch.zeros_like(hb), dwout=Wc.new_zeros(1, H),
                 dbout=Wc.new_zeros(1, 1))
    if mode == "dma_floor":
        weights = (Wc.sum() + Wz.sum() + hw.sum() + bc.sum() + hb.sum()
                   + wout.sum())
        per_sample = z.sum(1) + phi + dx.sum(1) + sc
        # over the J pixel tiles: the grid once, the per-sample blocks and
        # the weights once per tile, every cotangent once
        s = (grid.sum() + J * (per_sample.reshape(I, b_t).sum(1) + weights)
             + g.reshape(I, -1).sum(1))
        zeros["dz"] = s.repeat_interleave(b_t)[:, None].expand(B, L).clone()
        return tuple(zeros[k] for k in OUTPUT_NAMES)

    # the forward recompute, folded
    ident = mode == "fwd_noact"
    act = (lambda x: x) if ident else torch.tanh  # noqa: E731
    c, s = torch.cos(phi)[:, None], torch.sin(phi)[:, None]
    a0 = c * Wc[0] + s * Wc[1]
    a1 = -s * Wc[0] + c * Wc[1]
    u, v = sc[:, None] * a0, sc[:, None] * a1
    w = dx @ Wc + bc + z @ Wz
    gx, gy = grid[:, 0][None, :, None], grid[:, 1][None, :, None]
    hs = [act(gx * u[:, None] + gy * v[:, None] + w[:, None])]
    for i in range(n_layers):
        hs.append(act(sd._mm(hs[-1], hw[i]) + hb[i]))
    hL = hs[-1]
    if mode in ("fwd_remat", "fwd_noact"):
        zeros["dwout"] = hL.sum((0, 1))[None]
        zeros["dz"] = per_batch_tile(hL.sum((1, 2)))[:, None].expand(
            B, L).clone()
        return tuple(zeros[k] for k in OUTPUT_NAMES)

    out = torch.sigmoid(hL @ wout + bout)
    dl = g * out * (1.0 - out)  # [B, N]
    dbout = dl.sum().reshape(1, 1)
    dz_extra = None
    if mode == "mxu_dwout":  # h_L^T dl as a product, one scalar a tile
        hr, dr = (_bf16(hL), _bf16(dl)) if sd.BF16_MATMUL else (hL, dl)
        dz_extra = per_batch_tile((hr * dr[..., None]).sum((1, 2)))
        dwout = zeros["dwout"]
    else:
        dwout = (hL * dl[..., None]).sum((0, 1))[None]
    dh = dl[..., None] * wout
    dhw, dhb = torch.zeros_like(hw), torch.zeros_like(hb)
    for i in reversed(range(n_layers)):
        d_pre = dh * (1.0 - hs[i + 1] * hs[i + 1])
        dhw[i] = sd._mm(hs[i].reshape(-1, H).T, d_pre.reshape(-1, H))
        if mode == "mxu_dhb" and sd.BF16_MATMUL:  # ones^T bf16(d_pre)
            dhb[i] = _bf16(d_pre).sum((0, 1))
        else:
            dhb[i] = d_pre.sum((0, 1))
        dh = sd._mm(d_pre, hw[i].T)
    d0 = dh * (1.0 - hs[0] * hs[0])
    dw = d0.sum(1)
    du, dv = (gx * d0).sum(1), (gy * d0).sum(1)
    if mode == "no_breduce":  # whole-tile dw, the first sample's du, dv
        dw = dw.reshape(I, b_t, H).sum(1).repeat_interleave(b_t, 0)
        du, dv = (t[::b_t].repeat_interleave(b_t, 0) for t in (du, dv))
    dz = dw @ Wz.T
    if dz_extra is not None:
        dz = dz + dz_extra[:, None]
    cs, sn = (sc * torch.cos(phi))[:, None], (sc * torch.sin(phi))[:, None]
    dWc = torch.stack([(cs * du - sn * dv + dx[:, 0:1] * dw).sum(0),
                       (sn * du + cs * dv + dx[:, 1:2] * dw).sum(0)])
    dphi = (du * v).sum(-1, keepdim=True) - (dv * u).sum(-1, keepdim=True)
    dsc = (du * a0).sum(-1, keepdim=True) + (dv * a1).sum(-1, keepdim=True)
    return (dphi, dw @ Wc.T, dsc, dz, dWc, dw.sum(0, keepdim=True), z.T @ dw,
            dhw, dhb, dwout, dbout)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

_fns = {}


def _kernel(mode: str, bf16: bool):
    """(plan, launch) of ``mode``'s build of the flag's source."""
    key = (mode, bool(bf16))
    if key not in _fns:
        lib = _build.load(sd.BWD_SOURCES[bool(bf16)], defines(mode))
        plan = getattr(lib, ENTRIES[bool(bf16)] + "_plan")
        plan.argtypes = [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        plan.restype = ctypes.c_int
        run = getattr(lib, ENTRIES[bool(bf16)])
        run.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 8
                        + [ctypes.c_void_p])
        run.restype = ctypes.c_int
        _fns[key] = (plan, run)
    return _fns[key]


def load_all(flags=(True, False)):
    """Build every mode's library of each flag's source that needs it, one
    ``nvcc`` each, all started together."""
    _build.load_targets([(sd.BWD_SOURCES[f], defines(m))
                         for f in flags for m in MODES])


def plan(mode: str, B: int, N: int, L: int, H: int, nl: int, b_t: int,
         n_t: int, device="cuda", bf16: bool = None) -> Tuple[int, int, int]:
    """(workspace bytes, blocks, pixels a kernel tile) of one call of
    ``mode`` on ``device`` with the flag value ``bf16`` (default:
    :data:`BF16_MATMUL`). Kept per shape and card."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    return _plan(mode, sd.BF16_MATMUL if bf16 is None else bool(bf16), B, N, L,
                 H, nl, b_t, n_t, index)


@functools.lru_cache(maxsize=64)
def _plan(mode, bf16, B, N, L, H, nl, b_t, n_t, index):
    fn, _ = _kernel(mode, bf16)
    floats, blocks, rows = ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        err = fn(B, N, L, H, nl, b_t, n_t, ctypes.byref(floats),
                 ctypes.byref(blocks), ctypes.byref(rows))
    if err != 0:
        raise RuntimeError(f"ablation plan ({mode}) failed: CUDA error {err}")
    return 4 * floats.value, blocks.value, rows.value


def bind(mode, grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout, bout, g, *,
         n_layers: int, b_t: int, n_t: int):
    """``(launch, outputs)`` of K4 in ``mode`` on checked CUDA inputs: the
    flag's source built for the mode, the outputs and the workspace
    allocated once. ``launch()`` runs the kernel into ``outputs`` (the
    eleven, in JAX's order and shapes) on the stream current at binding,
    and raises if the launch fails; every call counts in
    ``variant.launches``. Raises when the inputs do not fit, when the
    kernel tile does not divide ``n_t``, or when a build fails. The timing
    chains of :mod:`pyroved_tpu_torch.tools.bwd_ablation` launch it
    directly."""
    if mode not in MODES:
        raise ValueError(f"no ablation mode {mode!r}; modes: {MODES}")
    dev = grid.device
    N, B, L, H = grid.shape[0], z.shape[0], z.shape[1], Wc.shape[1]
    _check_tiles(B, N, b_t, n_t)
    if H not in sd.KERNEL_WIDTHS:
        raise ValueError(f"kernel hidden width must be one of "
                         f"{sd.KERNEL_WIDTHS}, got {H}")
    if not 1 <= n_layers <= sd.bwd_max_layers("tanh"):
        raise ValueError(f"the backward kernel takes 1 to "
                         f"{sd.bwd_max_layers('tanh')} hidden layers, got "
                         f"{n_layers}")
    inputs = (grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout, bout, g)
    for name, t, shape in zip(
            ("grid", "phi", "dx", "sc", "z", "Wc", "bc", "Wz", "hw", "hb",
             "wout", "bout", "g"), inputs,
            ((N, 2), (B,), (B, 2), (B,), (B, L), (2, H), (H,), (L, H),
             (n_layers, H, H), (n_layers, H), (H,), (1,), (B, N))):
        if t.numel() != torch.Size(shape).numel() or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous of shape {shape}, "
                             f"got {tuple(t.shape)}")
        sd._check(name, t.reshape(shape), shape, dev)
    if hw.data_ptr() % 16:
        raise ValueError("hw must be 16-byte aligned")
    bf16 = sd.BF16_MATMUL
    ws_bytes, blocks, rows = plan(mode, B, N, L, H, n_layers, b_t, n_t, dev,
                                  bf16)
    if n_t % rows:
        raise ValueError(f"the pixel tile n_t={n_t} must be a multiple of "
                         f"the kernel's tile of {rows} pixels")
    sizes = [B, 2 * B, B, B * L, 2 * H, H, L * H, n_layers * H * H,
             n_layers * H, H, 1]
    shapes = [(B, 1), (B, 2), (B, 1), (B, L), (2, H), (1, H), (L, H),
              (n_layers, H, H), (n_layers, H), (1, H), (1, 1)]
    ws = torch.empty(ws_bytes // 4, device=dev, dtype=torch.float32)
    out = torch.empty(sum(sizes), device=dev, dtype=torch.float32)
    outputs = tuple(t.reshape(s) for t, s in zip(torch.split(out, sizes),
                                                 shapes))
    _, run = _kernel(mode, bf16)
    key = launch_key(mode, bf16)
    ptrs = [t.data_ptr() for t in inputs] + [out.data_ptr(), ws.data_ptr()]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = run(*ptrs, B, N, L, H, n_layers, b_t, n_t, blocks, stream)
        if err != 0:
            raise RuntimeError(f"ablation kernel ({mode}) launch failed: "
                               f"CUDA error {err}")
        variant.launches[key] += 1

    launch.keep = (inputs, out, ws)  # alive while the launcher is
    return launch, outputs


def variant_kernel(mode, grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout,
                   bout, g, *, n_layers: int, b_t: int, n_t: int
                   ) -> Tuple[Tensor, ...]:
    """K4 in ``mode`` on checked CUDA inputs, launched once on the current
    stream (:func:`bind`): the eleven outputs in JAX's order and shapes."""
    launch, outputs = bind(mode, grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb,
                           wout, bout, g, n_layers=n_layers, b_t=b_t, n_t=n_t)
    launch()
    return outputs


def on_hopper(device) -> bool:
    """True when ``device`` is a CUDA device of compute capability 9.0."""
    device = torch.device(device)
    return (device.type == "cuda" and torch.cuda.is_available()
            and torch.cuda.get_device_capability(device) == (9, 0))


def variant(mode, grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout, bout, g,
            *, n_layers: int, b_t: int, n_t: int) -> Tuple[Tensor, ...]:
    """K4 in ``mode``: on CPU tensors the plain version
    (:func:`variant_plain`); on a Hopper card the kernel
    (:func:`variant_kernel`), which raises when it cannot build or launch;
    on any other device it raises. ``variant.launches`` counts the kernel's
    launches by source and mode (:func:`launch_key`)."""
    args = (mode, grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout, bout, g)
    kw = dict(n_layers=n_layers, b_t=b_t, n_t=n_t)
    if grid.device.type == "cpu":
        return variant_plain(*args, **kw)
    if not on_hopper(grid.device):
        raise RuntimeError(f"the ablation kernels need a Hopper card (compute "
                           f"capability 9.0); got {grid.device}")
    return variant_kernel(*args, **kw)


variant.launches = {launch_key(m, f): 0 for f in (True, False) for m in MODES}
