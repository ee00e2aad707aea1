"""Weight interop with the reference pyroVED (PyTorch state_dicts).

Counterpart of ``pyroved_tpu/interop.py``: a reference user carries trained
weights across in either direction.

- :func:`load_torch_weights` / :func:`torch_to_params` map a reference
  ``model.state_dict()`` (saved by its ``save_weights`` as
  ``torch.save(self.state_dict(), path + '.pt')``) onto the port's
  ``state_dict``.
- :func:`params_to_torch` is the inverse: a reference-keyed state_dict of
  numpy arrays that a reference model's ``load_state_dict`` accepts once
  the values are wrapped in tensors.

The reference's module names are public API: ``fc_layers.{2i}`` Linear
stacks (a Linear and an activation per layer), ``fc11``/``fc12``/``fc13``
heads, ``coord_latent.fc_coord``/``.fc_latent`` and ``out`` in the fc
nets; ``feature_extractor.layers.{i}`` / ``upsampler.layers.{i}``
Sequentials, ``features2latent.fc_latent`` and ``latent2features.fc`` in
the conv nets. The port's modules carry the JAX package's flax names
(``MLP_0.Dense_i``, ``FeatureExtractor_0.Conv_i``, ...), so the mapping is
generated structurally from the target model, as the JAX package
generates it, and checked leaf by leaf.

The reference and the port are both torch, so a Linear ``[out, in]`` or a
convolution ``[O, I, *K]`` is copied as it is. Two things are converted:

- the two dense bridges of the conv nets flatten feature maps
  channels-first in the reference and channels-last in the port (as in
  the JAX package), so their weight columns or rows (and the decoder
  bridge's bias) are permuted channel-wise, using the feature-map shape of
  the net;
- BatchNorm ``weight``/``bias`` are parameters in both, while
  ``running_mean``/``running_var`` go to the VED's ``state`` (outside the
  parameters' ``state_dict``), and the model then normalizes with them at
  inference (``use_running_stats``), as the reference's ``eval()`` does.
"""
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["torch_to_params", "params_to_torch", "load_torch_weights"]


def _np(v) -> np.ndarray:
    """torch.Tensor / numpy / array-like -> numpy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _reorder_chw_to_hwc(x: np.ndarray, ch: int, spatial: Tuple[int, ...]) -> np.ndarray:
    """Permute the leading axis from (C, *S) flatten order to (*S, C)."""
    rest = x.shape[1:]
    x = x.reshape((ch,) + tuple(spatial) + rest)
    x = np.moveaxis(x, 0, len(spatial))
    return x.reshape((ch * int(np.prod(spatial)),) + rest)


def _reorder_hwc_to_chw(x: np.ndarray, ch: int, spatial: Tuple[int, ...]) -> np.ndarray:
    rest = x.shape[1:]
    x = x.reshape(tuple(spatial) + (ch,) + rest)
    x = np.moveaxis(x, len(spatial), 0)
    return x.reshape((ch * int(np.prod(spatial)),) + rest)


class _Leaf:
    """One reference state_dict leaf <-> one key of the port's
    ``state_dict`` (``collection="params"``) or of a VED's ``state``
    (``"state"``), with its transform."""

    def __init__(self, torch_key: str, key: str, kind: str = "copy",
                 ch: int = 0, spatial: Tuple[int, ...] = (),
                 collection: str = "params"):
        self.torch_key = torch_key
        self.key = key
        self.kind = kind
        self.ch = ch
        self.spatial = tuple(int(s) for s in spatial)
        self.collection = collection

    def fwd(self, w: np.ndarray) -> np.ndarray:
        """reference layout -> the port's."""
        if self.kind == "bridge_in":      # features2latent.weight [2L, C*S]
            return _reorder_chw_to_hwc(w.T, self.ch, self.spatial).T
        if self.kind == "bridge_out":     # latent2features weight [C*S, L], bias
            return _reorder_chw_to_hwc(w, self.ch, self.spatial)
        return w

    def bwd(self, w: np.ndarray) -> np.ndarray:
        """the port's layout -> the reference's."""
        if self.kind == "bridge_in":
            return _reorder_hwc_to_chw(w.T, self.ch, self.spatial).T
        if self.kind == "bridge_out":
            return _reorder_hwc_to_chw(w, self.ch, self.spatial)
        return w


# ---------------------------------------------------------------------------
# Mapping construction (structural, from the target model)
# ---------------------------------------------------------------------------

def _pair(torch_base: str, ours: str, bias: bool = True) -> List[_Leaf]:
    leaves = [_Leaf(f"{torch_base}.weight", f"{ours}.weight")]
    if bias:
        leaves.append(_Leaf(f"{torch_base}.bias", f"{ours}.bias"))
    return leaves


def _fc_leaves(top: str, net) -> List[_Leaf]:
    """The fc nets (encoders, decoders, classifier, regressor): the
    reference's ``make_fc_layers`` interleaves Linear and activation, so
    Linear ``i`` sits at Sequential index ``2*i``."""
    leaves = []
    for i in range(net.MLP_0.n_layers):
        leaves += _pair(f"{top}.fc_layers.{2 * i}", f"{top}.MLP_0.Dense_{i}")
    for head in ("fc11", "fc12", "fc13", "out"):
        if hasattr(net, head):
            leaves += _pair(f"{top}.{head}", f"{top}.{head}")
    if hasattr(net, "fc_coord"):   # sDecoderNet's coord_latent block
        leaves += _pair(f"{top}.coord_latent.fc_coord", f"{top}.fc_coord")
        leaves += _pair(f"{top}.coord_latent.fc_latent", f"{top}.fc_latent",
                        bias=False)  # bias-free in the reference
    return leaves


def _tower_filters(tower, blocks) -> List[List[int]]:
    return [[getattr(tower, f"Conv_{i}").out_channels for i in idx]
            for idx in blocks]


def _conv_stack_leaves(prefix: str, ours: str, filters: Sequence[Sequence[int]],
                       batchnorm: bool, pool_last: Optional[bool],
                       upsampler: bool) -> List[_Leaf]:
    """Walk the reference Sequential layout (a conv, its activation, a
    batchnorm; a maxpool or an upsample block after a block) to recover its
    layer indices, and pair them with the port's per-type numbering
    (``Conv_k`` / ``BatchNorm_k`` / ``UpsampleBlock_k`` in creation
    order)."""
    leaves: List[_Leaf] = []
    idx = conv_i = ub_i = 0
    total = sum(len(b) for b in filters)
    done = 0
    for b_i, block in enumerate(filters):
        for _ in block:
            leaves += _pair(f"{prefix}{idx}", f"{ours}.Conv_{conv_i}")
            idx += 2  # the conv, then the activation module
            if batchnorm:
                base, bn = f"{prefix}{idx}", f"{ours}.BatchNorm_{conv_i}"
                leaves += _pair(base, bn)
                leaves.append(_Leaf(f"{base}.running_mean", f"{bn}.mean",
                                    collection="state"))
                leaves.append(_Leaf(f"{base}.running_var", f"{bn}.var",
                                    collection="state"))
                idx += 1
            conv_i += 1
            done += 1
        if upsampler:
            leaves += _pair(f"{prefix}{idx}.conv",
                            f"{ours}.UpsampleBlock_{ub_i}.Conv_0")
            idx += 1
            ub_i += 1
        else:
            # the reference places a maxpool by counting convs (one when two
            # or more remain), the port (and the JAX package) by counting
            # blocks; they agree for every config the reference can train,
            # and other configs are refused
            ref_pool = done + 1 < total or bool(pool_last)
            block_pool = b_i + 1 < len(filters) or bool(pool_last)
            if ref_pool != block_pool:
                raise ValueError(
                    f"conv filter config {tuple(tuple(b) for b in filters)} "
                    "places maxpools differently in the reference "
                    "(conv-counted) and here (block-counted); the reference "
                    "cannot train this config, so torch interop is "
                    "undefined for it")
            if ref_pool:
                idx += 1
    if upsampler:  # the final 1x1 conv to the output channels
        leaves += _pair(f"{prefix}{idx}", f"{ours}.Conv_{conv_i}")
    return leaves


def _conv_encoder_leaves(top: str, net) -> List[_Leaf]:
    tower = net.FeatureExtractor_0
    blocks = [idx for idx, _ in tower.plan]
    leaves = _conv_stack_leaves(
        f"{top}.feature_extractor.layers.", f"{top}.FeatureExtractor_0",
        _tower_filters(tower, blocks), tower.batchnorm, tower.plan[-1][1],
        upsampler=False)
    ch, spatial = net.feature_shape
    leaves.append(_Leaf(f"{top}.features2latent.fc_latent.weight",
                        f"{top}.features2latent.weight", "bridge_in",
                        ch=ch, spatial=spatial))
    leaves.append(_Leaf(f"{top}.features2latent.fc_latent.bias",
                        f"{top}.features2latent.bias"))
    return leaves


def _conv_decoder_leaves(top: str, net) -> List[_Leaf]:
    tower = net.Upsampler_0
    ch, spatial = net.ch0, net.in_spatial
    leaves = [_Leaf(f"{top}.latent2features.fc.{p}",
                    f"{top}.latent2features.{p}", "bridge_out", ch=ch,
                    spatial=spatial) for p in ("weight", "bias")]
    leaves += _conv_stack_leaves(
        f"{top}.upsampler.layers.", f"{top}.Upsampler_0",
        _tower_filters(tower, tower.plan), tower.batchnorm, None,
        upsampler=True)
    return leaves


def _model_mapping(model) -> List[_Leaf]:
    """Every leaf of ``model``, derived from its nets. The port's top-level
    names are the reference's attribute names (``encoder_z``,
    ``encoder_y``, ``decoder``)."""
    leaves: List[_Leaf] = []
    for top, net in model.nets.items():
        if hasattr(net, "MLP_0"):
            leaves += _fc_leaves(top, net)
        elif hasattr(net, "FeatureExtractor_0"):
            leaves += _conv_encoder_leaves(top, net)
        elif hasattr(net, "Upsampler_0"):
            leaves += _conv_decoder_leaves(top, net)
        else:
            raise ValueError(
                f"cannot derive a reference mapping for nets[{top!r}] "
                f"({type(net).__name__}); custom injected nets are not "
                "supported by the torch interop")
    return leaves


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def torch_to_params(model, state_dict: Mapping[str, Any], strict: bool = True
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Map a reference pyroVED ``state_dict`` onto ``model``'s.

    Args:
        model: a port model (iVAE, jiVAE, ssiVAE, ss_reg_iVAE, VED) whose
            architecture matches the reference model the weights came from.
        state_dict: reference parameter names to torch tensors or numpy
            arrays.
        strict: raise ``KeyError`` on missing keys or unconsumed keys
            (other than BatchNorm ``num_batches_tracked`` counters). With
            ``strict=False`` they are skipped (the model's own values stay);
            a shape mismatch raises ``ValueError`` either way.

    Returns:
        ``(params, stats)``: a new ``state_dict`` for ``model.nets`` (CPU
        float32 tensors; the model is not modified) and the BatchNorm
        running statistics found, keyed as the VED's ``state`` (empty
        unless the reference nets used batchnorm).
    """
    mapping = _model_mapping(model)
    own = model.nets.state_dict()
    own_stats = getattr(model, "state", {})
    params = {k: v.detach().cpu().clone() for k, v in own.items()}
    stats: Dict[str, torch.Tensor] = {}
    missing = []
    consumed = set()
    for leaf in mapping:
        if leaf.torch_key not in state_dict:
            missing.append(leaf.torch_key)
            continue
        consumed.add(leaf.torch_key)
        val = leaf.fwd(_np(state_dict[leaf.torch_key]).astype(np.float32))
        target = own if leaf.collection == "params" else own_stats
        if leaf.key not in target:
            raise ValueError(f"{leaf.torch_key} -> {leaf.key}: the model has "
                             "no such entry — architecture mismatch")
        expected = tuple(target[leaf.key].shape)
        if expected != tuple(val.shape):
            raise ValueError(
                f"{leaf.torch_key} -> {leaf.key}: shape {tuple(val.shape)} "
                f"does not match target {expected} — architecture mismatch")
        out = params if leaf.collection == "params" else stats
        out[leaf.key] = torch.from_numpy(np.ascontiguousarray(val))
    extra = [k for k in state_dict
             if k not in consumed and not k.endswith("num_batches_tracked")]
    if strict and (missing or extra):
        raise KeyError(
            f"state_dict does not line up with the model: "
            f"missing={missing[:5]}{'...' if len(missing) > 5 else ''} "
            f"extra={extra[:5]}{'...' if len(extra) > 5 else ''}")
    return params, stats


def params_to_torch(model, params: Optional[Mapping[str, Any]] = None
                    ) -> Dict[str, np.ndarray]:
    """A reference-keyed state_dict (numpy float32 arrays) of ``model``'s
    parameters (or of ``params``, a ``state_dict`` of the model's keys):
    the inverse of :func:`torch_to_params`. BatchNorm running statistics
    come from the VED's ``state``, and ``num_batches_tracked`` counters are
    emitted as zeros."""
    params = model.nets.state_dict() if params is None else params
    stats = getattr(model, "state", {})
    out: Dict[str, np.ndarray] = {}
    for leaf in _model_mapping(model):
        src = params if leaf.collection == "params" else stats
        val = _np(src[leaf.key]).astype(np.float32)
        if leaf.torch_key.endswith("running_var"):
            base = leaf.torch_key[:-len("running_var")]
            out[base + "num_batches_tracked"] = np.asarray(0, np.int64)
        out[leaf.torch_key] = np.ascontiguousarray(leaf.bwd(val))
    return out


def load_torch_weights(model, source, strict: bool = True):
    """Load reference pyroVED weights into ``model`` in place.

    ``source`` is a path to a ``.pt`` file saved by the reference's
    ``save_weights`` (read with ``torch.load(weights_only=True)``, so a
    file carrying code is refused, not run) or a state_dict-like mapping.
    When it carries BatchNorm running statistics, they are installed in the
    VED's ``state`` and ``use_running_stats`` is set, so that inference
    normalizes as the reference's ``eval()`` does. Returns the model."""
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        source = torch.load(source, map_location="cpu", weights_only=True)
    params, stats = torch_to_params(model, source, strict=strict)
    model.nets.load_state_dict(params, strict=True)
    if stats:
        if not hasattr(model, "use_running_stats"):
            raise ValueError("model does not track batch statistics but the "
                             "state_dict contains BatchNorm running stats")
        model.state = {**model.state, **stats}
        model.use_running_stats = True
    return model
