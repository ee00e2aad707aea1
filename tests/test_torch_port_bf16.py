"""The port under ``BF16_MATMUL = True``, the default of both packages: the
plain versions of K1, K2 and K3 and one flagship-shaped training step
against the JAX package's Pallas kernels in interpret mode with its own
``BF16_MATMUL`` set, the bf16 plain forward against the f32 one within the
reference's own band, and the wrappers' choice of kernel by the flag. The
tensor-core kernels themselves are held against the plain versions on the
card by ``chip_smoke.py``."""
from contextlib import nullcontext

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyroved_tpu.models as jmodels
import pyroved_tpu.ops.spatial_decoder as sd
import pyroved_tpu_torch.models as tmodels
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.trainers import SVItrainer
from pyroved_tpu_torch.utils.nn import as_numpy
from pyroved_tpu_torch.weights import from_jax_params
from test_torch_port_bwd import GRADS, _inputs, _torch, _xw

# Both sides round the same operands to bf16 and sum the exact products in
# f32, but in another order (XLA on the CPU against torch), so an
# intermediate within an f32 rounding of a bf16 boundary rounds to either
# neighbour: one bf16 unit, 2^-8 relative. Such flips are rare and move the
# sums downstream by a part in a few hundred of its own term: over these
# batches a grad differs by up to 1.3e-3 of its tensor's largest entry and
# by 6.2e-4 of its mean magnitude on average (measured, gelu; tanh 2.3e-4).
# Every grad is held to 2.5e-3 of its largest entry plus 1e-4, and its mean
# error to 1.5e-3 of its mean magnitude.
GRAD_REL, GRAD_ATOL, MEAN_REL = 2.5e-3, 1e-4, 1.5e-3
# Decoded values in (0, 1) (sigmoid head) or logits of size ~1: a flipped
# hidden value moves the head by |wout| 2^-8 |h| (measured 1.3e-5 here).
OUT_ATOL = 2e-4
# Deeper or wider decoders than the flagship's two layers of 128 collect
# more flips on the way to the head, and a flip low in the stack moves
# every value above it: over K1_CASES below with seeds 7-9, up to 7.0e-4
# (five layers at H = 256), at most 1% of the values beyond OUT_ATOL, mean
# error at most 4.6e-6 (measured). With the port's flag clear 28-76% of the
# values lie beyond OUT_ATOL and the mean error is at least 1.6e-4. Those
# cases are held to OUT_ATOL on all but DEEP_FRAC of the values, DEEP_ATOL
# on every value and OUT_MEAN on the mean; the flagship-depth cases keep
# OUT_ATOL on every value.
DEEP_ATOL, DEEP_FRAC, OUT_MEAN = 1.5e-3, 0.02, 2e-5
# Losses sum 1,500 (K3) or 784 x 4 (training step) pixel terms; the
# flips cancel in the sum (measured 1.7e-7).
LOSS_RTOL = 1e-6
# Every comparison is also made against the port with its flag clear (f32
# products), which must fail it: the limits above separate bf16 from f32.
# There the grads differ by 3.6e-3 to 1e-1 of their mean magnitude and the
# decoded values by 7.8e-4 to 1.3e-3 (measured).
# The reference's own band for bf16 against f32 (tests/test_ops_fused.py,
# test_bf16_activations_close_to_f32): max and mean absolute difference.
BAND_ATOL, BAND_MEAN = 2e-2, 5e-3


@pytest.fixture
def bf16_both(monkeypatch):
    """JAX's kernels in interpret mode with bf16 products; the port's flag
    set (its default)."""
    monkeypatch.setattr(sd, "INTERPRET", True)
    monkeypatch.setattr(sd, "BF16_MATMUL", True)
    monkeypatch.setattr(sd, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(tsd, "BF16_MATMUL", True)


def _grad_misses(ours, ref, names=GRADS):
    """The grads out of tolerance: the largest error over GRAD_ATOL +
    GRAD_REL of the tensor's largest entry, or the mean error over MEAN_REL
    of its mean magnitude."""
    assert len(ours) == len(ref) == len(names)
    misses = []
    for name, o, r in zip(names, ours, ref):
        o, r = as_numpy(o).astype(np.float64), np.asarray(r, np.float64)
        assert o.shape == r.shape, (name, o.shape, r.shape)
        err = np.abs(o - r)
        if (err.max() > GRAD_ATOL + GRAD_REL * np.abs(r).max()
                or err.mean() > MEAN_REL * np.abs(r).mean()):
            misses.append((name, err.max(), err.mean(), np.abs(r).mean()))
    return misses


def _f32_port(monkeypatch):
    """The control: the port's flag cleared for the rest of the test."""
    monkeypatch.setattr(tsd, "BF16_MATMUL", False)


# (act, D, C, N): tanh and gelu, both coordinate dims, one and three
# channels, N = 300 and a ragged 77
K2_CASES = [("tanh", 2, 1, 300), ("gelu", 1, 3, 300), ("tanh", 1, 3, 77),
            ("gelu", 2, 1, 77)]


@pytest.mark.parametrize("act,D,C,N", K2_CASES)
def test_k2_plain_matches_jax_bwd_bf16(bf16_both, monkeypatch, act, D, C, N):
    a = _inputs(D=D, C=C, N=N, seed=len(act))
    g = np.random.default_rng(1).normal(
        size=(5, N) if C == 1 else (5, N, C)).astype(np.float32)
    res = tuple(jnp.asarray(a[k]) for k in ("grid",) + GRADS)
    ref = sd._bwd(act, True, res, jnp.asarray(g))[1:]

    def ours():
        return tsd.fused_spatial_decoder_backward(
            **_torch(a), g=torch.from_numpy(g), act=act)

    assert _grad_misses(ours(), ref) == []
    _f32_port(monkeypatch)
    assert _grad_misses(ours(), ref)


@pytest.mark.parametrize("act,D,N", [("tanh", 2, 300), ("gelu", 1, 77)])
def test_k3_plain_matches_jax_train_call_bf16(bf16_both, monkeypatch, act, D,
                                              N):
    a = _inputs(D=D, C=1, N=N, seed=10 + len(act))
    x, w = _xw(5, N)
    t = _torch(a)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    ref_loss, ref = sd._train_call(
        j["grid"], j["phi"], j["dx"], j["sc"], j["z"], jnp.asarray(x),
        jnp.asarray(w), *(j[k] for k in GRADS[4:]), act)
    ref = (*ref[:-1], np.asarray(ref[-1]).reshape(1))  # dbout shaped [1]

    def ours():
        return tsd.fused_bernoulli_recon_loss_kernel(
            t["grid"], t["phi"], t["dx"], t["sc"], t["z"], torch.from_numpy(x),
            torch.from_numpy(w), *(t[k] for k in GRADS[4:]), act=act)

    loss, grads = ours()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    assert _grad_misses(grads, ref) == []
    _f32_port(monkeypatch)
    assert _grad_misses(ours()[1], ref)


# (act, D, C, N, hidden): the shapes the tensor-core K1's branches take.
# H = 128 tiles 64 pixels and H = 256 tiles 32, so N = 80, 144, 48 and 112
# end on a 16-pixel tile and N = 16 is one; (96, 160) and (200,) * 5 pad
# to H = 256, where the kernel streams its weights; 3 and 5
# layers; C = 4; the Pade tanh.
K1_CASES = [("tanh", 2, 1, 77, (128, 128)), ("softplus", 1, 3, 77, (128, 128)),
            ("gelu", 2, 3, 77, (128, 128)),
            ("tanh_approx", 2, 4, 80, (128, 128, 128)),
            ("lrelu", 2, 1, 144, (128,) * 5),
            ("relu", 1, 2, 48, (96, 160)),
            ("gelu", 1, 1, 112, (256, 256, 256)),
            ("softplus", 2, 4, 16, (200,) * 5),
            ("tanh", 2, 3, 77, (256,) * 5)]


# gelu: JAX's K1 takes erf from a polynomial (error <= 1.5e-7), far inside
# OUT_ATOL
@pytest.mark.parametrize("act,D,C,N,hidden", K1_CASES)
def test_k1_plain_matches_jax_fwd_bf16(bf16_both, monkeypatch, act, D, C, N,
                                       hidden):
    a = _inputs(D=D, C=C, N=N, hidden=hidden, seed=7)
    ref = np.asarray(sd._fwd(**{k: jnp.asarray(v) for k, v in a.items()},
                             act=act))
    deep = tuple(hidden) != (128, 128)

    def close():
        out = tsd.fused_spatial_decoder_forward(**_torch(a), act=act)
        err = np.abs(out.numpy() - ref)
        if not deep:
            return err.max() <= OUT_ATOL
        return (err.max() <= DEEP_ATOL and err.mean() <= OUT_MEAN
                and (err > OUT_ATOL).mean() <= DEEP_FRAC)

    assert close()
    _f32_port(monkeypatch)
    assert not close()


def test_flagship_training_step_matches_jax_fused_bf16(bf16_both,
                                                       monkeypatch):
    """One weighted-loss step of the flagship (28 x 28, rotation, hidden
    128 x 128, tanh) at batch 4: the port's fused path (K1 forward, K2
    backward, their plain versions here) against the JAX package's fused
    path (its Pallas K1 and K2 in interpret mode), both in bf16."""
    cfg = dict(data_dim=(28, 28), invariances=["r"])
    jm = jmodels.iVAE(seed=3, **cfg)
    jm._fused = True  # the JAX gate wants a TPU; interpret mode runs here
    monkeypatch.setattr(sd, "fused_profitable", lambda *a: True)
    # its Pallas K1 at every size (its CPU tuning sends small decodes to XLA)
    monkeypatch.setattr(sd, "_forward", lambda *a: sd._fwd(*a))
    x = np.random.default_rng(0).uniform(0, 1, (4, 28, 28)).astype(np.float32)
    w = np.array([1, 1, 0.5, 0], np.float32)
    key = jax.random.PRNGKey(5)
    eps = np.array(jax.random.normal(key, (4, jm.z_dim)))
    ref_loss, ref_grads = jax.value_and_grad(jm.weighted_loss_fn)(
        jm.params, key, (jnp.asarray(x),), jnp.asarray(w), jnp.float32(0.7))
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, ref_grads))
    names = sorted(ref)

    def step():
        """(loss, grads by name) of one port step from the JAX weights."""
        tm = tmodels.iVAE(device="cpu", **cfg)
        assert tm._fused
        tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
        loss = SVItrainer(tm).train_step((torch.from_numpy(x),),
                                         torch.from_numpy(w), 0.7,
                                         torch.from_numpy(eps))
        grads = {n: p.grad for n, p in tm.nets.named_parameters()}
        assert sorted(grads) == names
        return loss, [grads[n] for n in names]

    loss, grads = step()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    ref = [ref[n].numpy() for n in names]
    assert _grad_misses(grads, ref, names) == []
    _f32_port(monkeypatch)
    assert _grad_misses(step()[1], ref, names)


def test_bf16_plain_forward_within_reference_band_of_f32(monkeypatch):
    a = _torch(_inputs(D=2, C=1, N=300))
    monkeypatch.setattr(tsd, "BF16_MATMUL", True)
    out = tsd.spatial_decoder_plain(**a)
    monkeypatch.setattr(tsd, "BF16_MATMUL", False)
    ref = tsd.spatial_decoder_plain(**a)
    diff = (out - ref).abs()
    assert 0 < diff.max().item() <= BAND_ATOL
    assert diff.mean().item() < BAND_MEAN


def test_wrappers_pick_the_kernel_by_the_flag(monkeypatch):
    """On CPU tensors the wrappers run the plain version of the flag's
    numerics and count no launch; on the card they bind the flag's source
    (the loader is stubbed here: nothing is built)."""
    t = _torch(_inputs(D=2, C=1, B=3, N=40))
    g = torch.ones(3, 40)
    x, w = torch.full((3, 40), 0.5), torch.ones(3)
    args = (t["grid"], *(t[k] for k in GRADS[:4]), x, w,
            *(t[k] for k in GRADS[4:]))
    k1 = tsd.fused_spatial_decoder_forward
    k2, k3 = tsd.fused_spatial_decoder_backward, tsd.fused_bernoulli_recon_loss_kernel
    before = (dict(k1.launches), dict(k2.launches), dict(k3.launches))
    plain = {}
    for flag in (True, False):
        monkeypatch.setattr(tsd, "BF16_MATMUL", flag)
        plain[flag] = (tsd.spatial_decoder_bwd_plain(**t, g=g),
                       tsd.recon_loss_plain(*args),
                       tsd.spatial_decoder_plain(**t))
        for o, r in zip(k2(**t, g=g), plain[flag][0]):
            assert torch.equal(o, r)
        loss, grads = k3(*args)
        assert torch.equal(loss, plain[flag][1][0])
        for o, r in zip(grads, plain[flag][1][1]):
            assert torch.equal(o, r)
        assert torch.equal(k1(**t), plain[flag][2])
    assert not torch.equal(plain[True][0][7], plain[False][0][7])  # dhw
    assert not torch.equal(plain[True][2], plain[False][2])  # decoded
    assert (k1.launches, k2.launches, k3.launches) == before

    loaded = []

    class Lib:
        def __getattr__(self, name):
            fn = lambda *a: 0  # noqa: E731
            loaded.append(name)
            return fn

    monkeypatch.setattr(tsd._build, "load", lambda name: loaded.append(name)
                        or Lib())
    monkeypatch.setattr(tsd, "_fwd_fns", {})
    monkeypatch.setattr(tsd, "_bwd_fns", {})
    for flag in (True, False):
        tsd._fwd_kernel(flag)
        tsd._bwd_kernel(flag)
    assert loaded == ["spatial_decoder_fwd_tc", "pvt_sdec_fwd_tc",
                      "spatial_decoder_bwd_tc", "pvt_sdec_bwd_tc_plan",
                      "pvt_sdec_bwd_tc", "spatial_decoder_fwd",
                      "pvt_sdec_fwd", "spatial_decoder_bwd_x3",
                      "pvt_sdec_bwd_x3_plan", "pvt_sdec_bwd_x3"]
    assert tsd.FWD_SOURCES == {True: "spatial_decoder_fwd_tc",
                               False: "spatial_decoder_fwd"}
    assert tsd.BWD_SOURCES == {True: "spatial_decoder_bwd_tc",
                               False: "spatial_decoder_bwd_x3"}


@pytest.mark.parametrize("limit", [6, -1])
def test_k1_layer_limit_comes_from_the_tensor_core_source(monkeypatch, limit):
    """The tensor-core K1's layer limit is the one its source works out from
    its shared-memory layout (the loader and the device are stubbed here:
    nothing is built); a limit the source cannot read raises."""
    asked = []

    class MaxLayers:  # a ctypes function: takes argtypes and restype
        def __call__(self, H, C):
            asked.append((H, C))
            return limit

    class Lib:
        pvt_sdec_fwd_tc_max_layers = MaxLayers()

    lib = Lib()
    monkeypatch.setattr(tsd._build, "load", lambda name: asked.append(name)
                        or lib)
    monkeypatch.setattr(tsd.torch.cuda, "device", lambda index: nullcontext())
    tsd._fwd_tc_max_layers.cache_clear()
    try:
        if limit < 0:
            with pytest.raises(RuntimeError, match="could not be read"):
                tsd.fwd_tc_max_layers(128, 3, "cuda:0")
        else:
            assert tsd.fwd_tc_max_layers(128, 3, "cuda:0") == limit
            assert tsd.fwd_tc_max_layers(128, 3, "cuda:0") == limit  # kept
        assert asked == ["spatial_decoder_fwd_tc", (128, 3)]
    finally:
        tsd._fwd_tc_max_layers.cache_clear()
