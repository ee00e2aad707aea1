"""Model export and serving.

Counterpart of ``pyroved_tpu/serving.py`` for float32 weights.
:func:`export_model` writes a pickle-free ``np.savez`` archive: a JSON
manifest that describes the networks, plus every weight as a named float32
array. :class:`ServedModel` rebuilds the networks from the archive alone,
with no model object, and serves ``encode`` and a posed ``decode``; spatial
decodes go through the fused decoder kernel. As in the JAX package, a
jiVAE's encode also returns the class probabilities; a semi-supervised
model's encode labels the input with its own head first (argmax, then
one-hot, for ssiVAE; the regressed values for ss_reg_iVAE), which it also
serves as ``classify`` or ``regress``; the decode's latents are the content
latents followed by the classes or labels.

The JAX package pads symbolic-batch requests to power-of-two buckets to
bound recompiles. Eager PyTorch compiles nothing per shape, so requests
here are only chunked (at ``max_bucket`` rows, or at the archive's fixed
``batch_size``, where chunks are also padded to that size).
"""
import json
from typing import Optional, Union

import numpy as np
import torch

from .models.base import chunked, later_slice, posed_decode
from .nets.fc import (fcClassifierNet, fcDecoderNet, fcEncoderNet,
                      fcRegressorNet, jfcEncoderNet, sDecoderNet)
from .ops.spatial_decoder import sdecoder_supports_fusion
from .utils.coord import generate_grid
from .utils.nn import as_f32, resolve_device, to_onehot

Tensor = torch.Tensor

_W = "w_"  # archive key prefix of the weights


def export_model(model, path: str, batch_size: Union[int, None] = None,
                 quantize: Optional[str] = None) -> None:
    """Write ``model``'s networks to ``path`` (see the module docstring).
    ``batch_size`` fixes the served batch (chunks are padded to it); None
    serves any batch."""
    if quantize is not None:
        raise later_slice(f"export_model(quantize={quantize!r})",
                          "int8 serving")
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
    }
    arrays = {_W + k: v.detach().cpu().numpy().astype(np.float32)
              for k, v in model.state_dict().items()}
    arrays["manifest"] = np.frombuffer(
        json.dumps(manifest).encode("utf-8"), np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


class ServedModel:
    """Serves an :func:`export_model` archive on ``device`` (None means
    "cuda"; without CUDA pass ``device="cpu"``)."""

    #: Largest number of rows one call handles for an archive without a
    #: fixed batch size; larger requests are chunked at this size.
    max_bucket = 1024

    def __init__(self, path: str, device=None):
        self.device = resolve_device(device)
        with np.load(path, allow_pickle=False) as archive:
            m = json.loads(archive["manifest"].tobytes().decode("utf-8"))
            state = {k[len(_W):]: torch.from_numpy(archive[k])
                     for k in archive.files if k.startswith(_W)}
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
        self._y_dim = y_dim
        nets = torch.nn.ModuleDict(nets)
        nets.load_state_dict(state, strict=True)
        nets.to(self.device)
        self._fused = sdecoder_supports_fusion(
            m["hidden_dim_d"], self._act, self._sig, self.coord,
            self.channels, self.device)

    def _run(self, fn, *batched: Tensor):
        """``fn`` over the rows of ``batched``, chunked (and, for a fixed
        batch size, each chunk zero-padded to it and the result cut back)."""
        if self.batch_size is None:
            return chunked(fn, *batched, batch_size=self.max_bucket)
        bs = self.batch_size

        def padded(*chunk):
            m = chunk[0].shape[0]
            if m < bs:
                chunk = [torch.cat([c, c.new_zeros((bs - m,) + c.shape[1:])])
                         for c in chunk]
            res = fn(*chunk)
            if isinstance(res, tuple):
                return tuple(r[:m] for r in res)
            return res[:m]

        return chunked(padded, *batched, batch_size=bs)

    def _labeled_encode(self, x: Tensor):
        """q(z|x, y) with y from the head: one-hot argmax classes, or the
        regressed values."""
        y = self.head_net(x)
        if self.head == "classify":
            y = to_onehot(torch.argmax(y, -1), self._y_dim, x.device)
        return self.encoder(x, y)

    @torch.no_grad()
    def encode(self, x, y=None):
        """``(z_loc, z_scale)`` of q(z|x[,y]); a jiVAE export adds the class
        probabilities, a semi-supervised one labels ``x`` itself."""
        x = as_f32(x, self.device)
        x = x.reshape(x.shape[0], -1)
        if self.head is not None:
            return self._run(self._labeled_encode, x)
        if self.c_dim > 0:
            if y is None:
                raise ValueError(
                    f"This export was built for a conditional encoder; pass "
                    f"y with {self.c_dim} features")
            y = as_f32(y, self.device).reshape(x.shape[0], self.c_dim)
            return self._run(self.encoder, x, y)
        return self._run(self.encoder, x)

    @torch.no_grad()
    def decode(self, z, angle=0.0, shift=0.0, scale=1.0) -> Tensor:
        """Decode latents (content latents, then any conditional features);
        for spatial exports the pose re-poses the generated signal."""
        z = as_f32(z, self.device)

        def dec(zz):
            return posed_decode(self.decoder, self.grid, zz, self._fused,
                                self._act, self._sig, angle, shift, scale)

        out = self._run(dec, z)
        if int(np.prod(out.shape[1:])) == int(np.prod(self.data_dim)):
            out = out.reshape((out.shape[0],) + self.data_dim)
        return out

    def _head(self, which: str, x) -> Tensor:
        if self.head != which:
            raise ValueError(f"this export has no {which} head")
        x = as_f32(x, self.device)
        with torch.no_grad():
            return self._run(self.head_net, x.reshape(x.shape[0], -1))

    def classify(self, x) -> Tensor:
        """Class probabilities of an ssiVAE export's classifier."""
        return self._head("classify", x)

    def regress(self, x) -> Tensor:
        """Predicted labels of an ss_reg_iVAE export's regressor."""
        return self._head("regress", x)
