"""The port's int8 serving (``export_model(quantize="int8")``: weight-only,
symmetric, one scale per output channel; biases float32) against the JAX
package's on the same weights, on the CPU: the int8 values and scales
bitwise the JAX package's ``quantize_params`` (transposed: torch's weights
are ``[out, in]``), the round trip within absmax/254, the served encode,
decode and classify of an int8 archive against the JAX package's int8
``ServedModel``, the archive's size against the float32 one, and the
refusals."""
import os

import numpy as np
import pytest
import torch

import jax

import pyroved_tpu.models as jmodels
import pyroved_tpu.serving as jserving
import pyroved_tpu_torch.models as tmodels
import pyroved_tpu_torch.serving as tserving
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.utils.nn import as_numpy

# Served outputs, f32 on both sides from the same dequantized weights
ATOL = 1e-5
# int8 against float32 (the JAX package's own bound): weight rounding only
QUANT_REL = 0.05
DATA = (8, 8)
POSE = dict(angle=0.3, shift=(0.1, -0.05), scale=1.1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: these small models run faster
    so, and the suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield


def _pair(cls, *args, data=DATA, **kw):
    jm = getattr(jmodels, cls)(data, *args, seed=0, **kw)
    tm = getattr(tmodels, cls)(data, *args, device="cpu", **kw)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def _x(n, seed=0, data=DATA):
    return np.random.default_rng(seed).uniform(0, 1, (n,) + data).astype(
        np.float32)


def _rel(a, b):
    a, b = as_numpy(a).astype(np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _close(ours, ref):
    ours, ref = as_numpy(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def _jax_leaves(tree, prefix=""):
    """The JAX package's quantized tree by the port's parameter names."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict) and set(val) != {"qint8", "qscale"}:
            out.update(_jax_leaves(val, f"{prefix}{key}."))
        else:
            out[prefix + ("weight" if key == "kernel" else key)] = val
    return out


@pytest.mark.parametrize("cls,args", [("iVAE", (2, ["r"])),
                                      ("ssiVAE", (2, 3, ["r"]))],
                         ids=["ivae", "ssivae"])
def test_int8_values_and_scales_bitwise_jax(cls, args):
    jm, tm = _pair(cls, *args)
    ref = _jax_leaves(jserving.quantize_params(
        jax.tree_util.tree_map(np.asarray, jm.params)))
    ours = tserving.quantize_params(tm.state_dict())
    assert sorted(ours) == sorted(ref)
    for name, leaf in ours.items():
        r = ref[name]
        if isinstance(leaf, dict):
            assert leaf["qint8"].dtype == np.int8, name
            assert leaf["qscale"].dtype == np.float32, name
            np.testing.assert_array_equal(leaf["qint8"], r["qint8"].T)
            np.testing.assert_array_equal(leaf["qscale"], r["qscale"].T)
        else:
            np.testing.assert_array_equal(leaf, np.asarray(r))


def test_quantize_roundtrip_error_bound():
    tm = tmodels.iVAE(DATA, 2, ["r"], device="cpu")
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = tserving.dequantize_params(tserving.quantize_params(state))
    assert sorted(back) == sorted(state)
    for name, orig in state.items():
        rec = back[name]
        assert rec.dtype == np.float32
        if orig.ndim < 2:
            np.testing.assert_array_equal(rec, orig)  # biases pass through
        else:
            absmax = np.abs(orig).max(axis=tuple(range(1, orig.ndim)),
                                      keepdims=True)
            assert np.all(np.abs(orig - rec) <= absmax / 254.0 + 1e-9), name


@pytest.mark.parametrize("bs", [None, 8], ids=["any_batch", "batch8"])
@pytest.mark.parametrize("cls,args", [("iVAE", (2, ["r"])),
                                      ("ssiVAE", (2, 3, ["r"]))],
                         ids=["ivae", "ssivae"])
def test_int8_served_matches_jax_int8(cls, args, bs, tmp_path):
    """The port's int8 archive served on the CPU (the decode through K1's
    wrapper) against the JAX package's int8 artifact: encode, posed decode
    and the classifier, at a ragged request; both within the int8 bound of
    the float32 exports."""
    jm, tm = _pair(cls, *args)
    paths = {k: str(tmp_path / k) for k in ("j8", "t8", "t32")}
    jserving.export_model(jm, paths["j8"], batch_size=bs, quantize="int8")
    tserving.export_model(tm, paths["t8"], batch_size=bs, quantize="int8")
    tserving.export_model(tm, paths["t32"], batch_size=bs)
    js = jserving.ServedModel(paths["j8"])
    ts = tserving.ServedModel(paths["t8"], device="cpu")
    t32 = tserving.ServedModel(paths["t32"], device="cpu")
    assert ts.quantize == js.quantize == "int8" and t32.quantize is None
    x = _x(13, seed=1)
    zdim = 2 + (3 if cls == "ssiVAE" else 0)
    z = np.random.default_rng(2).normal(size=(13, zdim)).astype(np.float32)
    if cls == "ssiVAE":
        z[:, 2:] = np.eye(3, dtype=np.float32)[np.arange(13) % 3]
    for ours, ref in zip(ts.encode(x), js.encode(x)):
        _close(ours, ref)
    _close(ts.decode(z, **POSE), js.decode(z, **POSE))
    if cls == "ssiVAE":
        _close(ts.classify(x), js.classify(x))
    assert _rel(ts.encode(x)[0], t32.encode(x)[0]) < QUANT_REL
    assert _rel(ts.decode(z, **POSE), t32.decode(z, **POSE)) < QUANT_REL


@pytest.mark.parametrize("data,bound", [((8, 8), 0.5), ((28, 28), 0.35)],
                         ids=["8x8", "flagship"])
def test_int8_archive_smaller(data, bound, tmp_path):
    """The int8 archive against the float32 one: below one half at 8x8,
    below 0.35 at the flagship's width (28x28, hidden 128x128), where the
    encoder's first layer holds most of the weights."""
    tm = tmodels.iVAE(data, 2, ["r"], device="cpu")
    p32, p8 = str(tmp_path / "f32"), str(tmp_path / "int8")
    tserving.export_model(tm, p32)
    tserving.export_model(tm, p8, quantize="int8")
    assert os.path.getsize(p8) < bound * os.path.getsize(p32)


def test_quantize_refusals(tmp_path):
    tm = tmodels.iVAE(DATA, 2, device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        tserving.export_model(tm, str(tmp_path / "x"), quantize="int4")
    with pytest.raises(ValueError, match="float params"):
        tserving.quantize_params({"w": np.ones((2, 2), np.int32)})
    ved = tmodels.VED((16, 16), (32,), device="cpu")
    with pytest.raises(NotImplementedError, match="VED"):
        tserving.export_model(ved, str(tmp_path / "v"), quantize="int8")
