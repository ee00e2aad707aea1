"""Model export and serving.

Counterpart of ``pyroved_tpu/serving.py``. :func:`export_model` writes a
pickle-free ``np.savez`` archive: a JSON manifest that describes the
networks, plus every weight as a named float32 array, or with
``quantize="int8"`` every weight matrix as int8 with one float32 scale per
output channel (:func:`quantize_params`; biases stay float32), about a
quarter of the bytes. :class:`ServedModel` rebuilds the networks from the
archive alone, with no model object, and serves ``encode`` and a posed
``decode``; spatial decodes go through the fused decoder kernel. As in the
JAX package, a jiVAE's encode also returns the class probabilities; a
semi-supervised model's encode labels the input with its own head first
(argmax, then one-hot, for ssiVAE; the regressed values for ss_reg_iVAE),
which it also serves as ``classify`` or ``regress``; the decode's latents
are the content latents followed by the classes or labels. An int8 archive
is dequantized once when it is loaded, to the float32 values the JAX
package's per-call dequantize gives, and then serves as a float32 one:
compute stays float32 (or the ``BF16_MATMUL`` hidden products), so its
error comes from the weight rounding alone.

Requests are bucketed as the JAX package's: a symbolic-batch archive
(``batch_size=None``) cuts a request into chunks of at most
``max_bucket`` rows and pads each chunk with zero rows to its power-of-two
bucket, ``min(max_bucket, max(8, 2^ceil(log2 m)))``; a fixed-batch archive
cuts at its ``batch_size`` and pads to it. Each chunk runs its bucket's
body and the rows asked for are copied into the request's result. On
CUDA each function at each bucket is a program of ``trainers/_graph.py``:
its first call runs eagerly (the warm-up), its second is captured as a
CUDA graph and replayed, later ones are replays, as the JAX package runs
one executable compiled per bucket (:class:`ServedModel`).
"""
import json
from typing import Dict, Optional, Union

import numpy as np
import torch

from .models.base import posed_decode
from .models.ved import VED
from .nets.fc import (fcClassifierNet, fcDecoderNet, fcEncoderNet,
                      fcRegressorNet, jfcEncoderNet, sDecoderNet)
from .ops import spatial_decoder as _sd
from .ops.spatial_decoder import (padded_sdecoder_weights,
                                  sdecoder_supports_fusion)
from .parallel.collectives import is_writer
from .parallel.mesh import whole_tensors
from .trainers import _graph
from .trainers._requests import Requests
from .utils.checkpoint import write_archive
from .utils.coord import generate_grid
from .utils.nn import as_f32, as_numpy, resolve_device

Tensor = torch.Tensor

# archive key prefixes: float32 weights, int8 weights and their scales
_W, _Q, _S = "w_", "q_", "s_"


def quantize_params(state) -> Dict[str, object]:
    """Per-output-channel symmetric int8 of every >=2-D float weight of a
    state dict (name -> tensor or array, torch's ``[out, in, ...]`` layout,
    so the output channel is dim 0); 1-D leaves (biases) pass through as
    float32 arrays. A quantized leaf becomes ``{"qint8": int8 [out, ...],
    "qscale": float32 [out, 1, ...]}``: scale = absmax / 127 over every
    dim but the first (1 where the channel is all zeros), values
    ``rint(w / scale)`` clipped to +-127. The arithmetic is the JAX
    package's ``quantize_params``, in numpy on the host, on the transposed
    kernel, so values and scales are bitwise its own, transposed. A
    non-float leaf raises ``ValueError``."""
    out = {}
    for name, leaf in state.items():
        a = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
             else np.asarray(leaf))
        if not np.issubdtype(a.dtype, np.floating):
            raise ValueError(f"quantize='int8' requires float params; found "
                             f"a {a.dtype} leaf {name!r} of shape {a.shape}")
        if a.ndim < 2:
            out[name] = a.astype(np.float32)
            continue
        absmax = np.max(np.abs(a), axis=tuple(range(1, a.ndim)),
                        keepdims=True)
        scale = (absmax / 127.0).astype(np.float32)
        scale = np.where(scale == 0.0, 1.0, scale)
        w = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
        out[name] = {"qint8": w, "qscale": scale.astype(np.float32)}
    return out


def dequantize_params(qstate) -> Dict[str, np.ndarray]:
    """Inverse of :func:`quantize_params`: float32 arrays, ``int8 ->
    float32`` times the scale."""
    return {name: (leaf["qint8"].astype(np.float32) * leaf["qscale"]
                   if isinstance(leaf, dict) else leaf)
            for name, leaf in qstate.items()}


def export_model(model, path: str, batch_size: Union[int, None] = None,
                 quantize: Optional[str] = None) -> None:
    """Write ``model``'s networks to ``path`` (see the module docstring).
    ``batch_size`` fixes the served batch (chunks are padded to it); None
    serves any batch. ``quantize="int8"`` stores the weight matrices as
    per-output-channel int8 (:func:`quantize_params`). A tensor-parallel
    model's split layers are written whole: every rank calls it and global
    rank 0 writes."""
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    if isinstance(model, VED):
        raise NotImplementedError(
            "export_model does not take a VED: the JAX package's export of "
            "one fails (pyroved_tpu/serving.py builds the encode spec from "
            "data_dim, a VED's output_dim), so there is no archive to hold "
            "the port to; serve a VED through its own encode, decode, "
            "predict and manifold2d")
    dec = model.decoder_net
    spatial = isinstance(dec, sDecoderNet)
    head = getattr(model, "encoder_y_net", None)
    manifest = {
        "batch_size": None if batch_size is None else int(batch_size),
        "data_dim": list(model.data_dim),
        "c_dim": int(getattr(model, "c_dim", 0)),
        "discrete_dim": int(getattr(model, "discrete_dim", 0)),
        # the semi-supervised head: "classify" or "regress", its width
        "head": (None if head is None else "classify"
                 if hasattr(model, "num_classes") else "regress"),
        "y_dim": int(getattr(model, "num_classes", 0)
                     or getattr(model, "reg_dim", 0)),
        "hidden_dim_y": (None if head is None else
                         [m.out_features for m in head.MLP_0.layers()]),
        "coord": int(model.coord),
        "grid_dim": int(model.grid.shape[-1]) if spatial else 0,
        "hidden_dim_e": [m.out_features
                         for m in model.encoder_net.MLP_0.layers()],
        "hidden_dim_d": [m.out_features for m in dec.MLP_0.layers()],
        "activation": model.activation,
        "sigmoid": bool(model._dec_sig),
        "channels": int(model.channels),
        "latent_dim": int(model.latent_dim),
        "z_dim": int(model.z_dim),
        "quantize": quantize,
    }
    state = whole_tensors(model.nets, model.state_dict())
    if not is_writer():
        return
    if quantize is None:
        arrays = {_W + k: v.detach().cpu().numpy().astype(np.float32)
                  for k, v in state.items()}
    else:
        arrays = {}
        for k, leaf in quantize_params(state).items():
            if isinstance(leaf, dict):
                arrays[_Q + k], arrays[_S + k] = leaf["qint8"], leaf["qscale"]
            else:
                arrays[_W + k] = leaf
    write_archive(path, arrays, manifest)


def route(device: torch.device) -> bool:
    """True when :class:`ServedModel`'s requests on ``device`` run as
    captured programs: a CUDA device while ``_graph.CAPTURE`` is set (read
    at each request). Elsewhere the same bucketed bodies run eagerly."""
    return _graph.CAPTURE and device.type == "cuda"


class ServedModel(Requests):
    """Serves an :func:`export_model` archive on ``device`` (None means
    "cuda"; without CUDA pass ``device="cpu"``). ``quantize`` is the
    archive's (None or ``"int8"``).

    A request is cut into chunks and each chunk padded to its bucket
    (:meth:`chunks`, :meth:`bucket`; module docstring) by the request
    runner the models' own requests share, which this class is
    (:class:`~pyroved_tpu_torch.trainers._requests.Requests`: static
    inputs, programs, the lock and the stream order). On CUDA, while
    :func:`route` holds, each function (``encode``, ``decode``,
    ``classify`` or ``regress``) at each bucket is a
    :class:`~pyroved_tpu_torch.trainers._graph.Program` over the
    function's static rows and, for a spatial decode, the pose (one ``[1 +
    D + 1]`` vector: angle, shift, scale). Elsewhere (the CPU, or
    ``_graph.CAPTURE`` cleared) the same bodies run eagerly on the
    zero-padded chunks, and give the same bits.

    The programs are bounded by construction: one a function and bucket of
    :meth:`buckets`, which follow from ``max_bucket`` and the archive's
    ``batch_size`` (a symbolic batch: 8, 16, ..., 1024, so at most 8 a
    function; a fixed batch: 1). None is evicted. A program's key is its
    slot in ``programs``, the function and bucket, and :meth:`settings`;
    when the settings change (a new ``max_bucket``, or
    ``ops.spatial_decoder.BF16_MATMUL``, which picks K1's source at the
    call) every program is dropped, its graph and pool with it, and made
    again. ``made`` counts the programs made. The weights are loaded once
    and never replaced, so they are not in the key: the programs read them
    in place, the spatial decoder's padded copy (``padded_sdecoder_weights``)
    made once at load, so a replay runs no padding kernels. A model's
    programs share one memory pool, which holds every program's static
    outputs and about one body's intermediates (the 128x128 grid's
    1024-row decode outputs 64 MiB); each program's ``pool_bytes`` is what
    its capture added."""

    def __init__(self, path: str, device=None):
        super().__init__(resolve_device(device))
        with np.load(path, allow_pickle=False) as archive:
            m = json.loads(archive["manifest"].tobytes().decode("utf-8"))
            qstate = {k[len(_W):]: archive[k]
                      for k in archive.files if k.startswith(_W)}
            qstate.update({k[len(_Q):]: {"qint8": archive[k],
                                         "qscale": archive[_S + k[len(_Q):]]}
                           for k in archive.files if k.startswith(_Q)})
        state = {k: torch.from_numpy(v)
                 for k, v in dequantize_params(qstate).items()}
        self.quantize = m.get("quantize")
        self.batch_size = m["batch_size"]
        self.data_dim = tuple(m["data_dim"])
        self.c_dim = m["c_dim"]
        self.coord = m["coord"]
        self.grid_dim = m["grid_dim"]
        self.channels = m["channels"]
        out_shape = self.data_dim + ((self.channels,) if self.channels > 1
                                     else ())
        self._act = m["activation"]
        self._sig = m["sigmoid"]
        self.head = m.get("head")
        y_dim = m.get("y_dim", 0)
        disc = m.get("discrete_dim", 0)
        if disc:
            self.encoder = jfcEncoderNet(out_shape, m["z_dim"], disc,
                                         m["hidden_dim_e"], self._act)
        else:
            self.encoder = fcEncoderNet(out_shape, m["z_dim"],
                                        self.c_dim + y_dim,
                                        m["hidden_dim_e"], self._act)
        zc_dim = m["latent_dim"] + self.c_dim + y_dim + disc
        if self.grid_dim:
            self.decoder = sDecoderNet(self.grid_dim, zc_dim, m["hidden_dim_d"],
                                       self._act, self._sig, self.channels)
            self.grid = generate_grid(self.data_dim, self.device)
        else:
            self.decoder = fcDecoderNet(zc_dim, out_shape, m["hidden_dim_d"],
                                        self._act, self._sig)
            self.grid = None
        nets = {"encoder_z": self.encoder, "decoder": self.decoder}
        self.head_net = None
        if self.head is not None:
            head_cls = (fcClassifierNet if self.head == "classify"
                        else fcRegressorNet)
            self.head_net = head_cls(out_shape, y_dim, m["hidden_dim_y"],
                                     self._act)
            nets["encoder_y"] = self.head_net
        nets = torch.nn.ModuleDict(nets)
        nets.load_state_dict(state, strict=True)
        nets.to(self.device)
        self._fused = sdecoder_supports_fusion(
            m["hidden_dim_d"], self._act, self._sig, self.coord,
            self.channels, self.device)
        self._weights = None
        if self.grid is not None and self._fused:
            with torch.no_grad():
                self._weights = padded_sdecoder_weights(self.decoder)

    # -- programs -------------------------------------------------------------
    def settings(self) -> tuple:
        """What every program's graph freezes besides its function and
        bucket: ``max_bucket``, the archive's ``batch_size`` and
        ``BF16_MATMUL``."""
        return (self.max_bucket, self.batch_size, _sd.BF16_MATMUL)

    def _run(self, name: str, body, batched, extra=()):
        """``body`` over the rows of ``batched`` (device tensors of n rows)
        and the non-batched device tensors ``extra``, a call a chunk, each
        padded to its bucket, a program each on the captured route (class
        docstring). Returns the n rows' outputs: a tensor or a tuple."""
        return self.request(name, body, batched, extra,
                            captured=route(self.device),
                            settings=self.settings())

    # -- the bodies and the served functions -------------------------------
    def _labeled_encode(self, x: Tensor):
        """q(z|x, y) with y from the head: the one-hot of its argmax
        classes, made on the device, or the regressed values."""
        y = self.head_net(x)
        if self.head == "classify":  # an argmax is in range: no host check
            y = torch.zeros_like(y).scatter_(
                -1, torch.argmax(y, -1, keepdim=True), 1.0)
        return self.encoder(x, y)

    def _decode(self, z: Tensor, pose: Optional[Tensor] = None) -> Tensor:
        """The decode body: a spatial decoder under ``pose`` (``[1 + D +
        1]`` on the device: angle, shift, scale), or a plain one."""
        if pose is None:
            return self.decoder(z)
        D = self.grid.shape[-1]
        return posed_decode(self.decoder, self.grid, z, self._fused,
                            self._act, self._sig, pose[:1], pose[1:1 + D],
                            pose[1 + D:], weights=self._weights)

    @torch.no_grad()
    def encode(self, x, y=None):
        """``(z_loc, z_scale)`` of q(z|x[,y]); a jiVAE export adds the class
        probabilities, a semi-supervised one labels ``x`` itself."""
        x = as_f32(x, self.device)
        x = x.reshape(x.shape[0], -1)
        if self.head is not None:
            return self._run("encode", self._labeled_encode, (x,))
        if self.c_dim > 0:
            if y is None:
                raise ValueError(
                    f"This export was built for a conditional encoder; pass "
                    f"y with {self.c_dim} features")
            y = as_f32(y, self.device).reshape(x.shape[0], self.c_dim)
            return self._run("encode", self.encoder, (x, y))
        return self._run("encode", self.encoder, (x,))

    @torch.no_grad()
    def decode(self, z, angle=0.0, shift=0.0, scale=1.0) -> Tensor:
        """Decode latents (content latents, then any conditional features);
        for spatial exports the pose re-poses the generated signal (angle
        and scale of one element, shift of one or ``grid_dim``)."""
        z = as_f32(z, self.device)
        extra = ()
        if self.grid is not None:
            D = self.grid.shape[-1]
            part = lambda v: np.asarray(  # noqa: E731
                as_numpy(v), np.float32).reshape(-1)
            pose = np.concatenate([part(angle).reshape(1),
                                   np.broadcast_to(part(shift), (D,)),
                                   part(scale).reshape(1)])
            extra = (torch.from_numpy(pose).to(self.device),)
        out = self._run("decode", self._decode, (z,), extra)
        if int(np.prod(out.shape[1:])) == int(np.prod(self.data_dim)):
            out = out.reshape((out.shape[0],) + self.data_dim)
        return out

    @torch.no_grad()
    def _head(self, which: str, x) -> Tensor:
        if self.head != which:
            raise ValueError(f"this export has no {which} head")
        x = as_f32(x, self.device)
        return self._run(which, self.head_net, (x.reshape(x.shape[0], -1),))

    def classify(self, x) -> Tensor:
        """Class probabilities of an ssiVAE export's classifier."""
        return self._head("classify", x)

    def regress(self, x) -> Tensor:
        """Predicted labels of an ss_reg_iVAE export's regressor."""
        return self._head("regress", x)
