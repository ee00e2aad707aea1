"""Port parity for the conv nets (``pyroved_tpu_torch/nets/conv.py``):
``UpsampleBlock``, ``FeatureExtractor``, ``Upsampler`` through the decoder,
``convEncoderNet`` and ``convDecoderNet`` against the flax modules of
``pyroved_tpu/nets/conv.py`` on the same weights (``from_jax_params``) and
inputs, in 1-D, 2-D and 3-D, with and without batchnorm, under each
``pool`` and both ``conv_first`` orders: outputs and the grads of a random
projection of them, for the parameters and the input. On the CPU; both
sides f32.

The flax modules are initialized and applied under ``jax.jit`` (one
compile each instead of one per op). With batchnorm they are applied with
``train=True`` and ``batch_stats`` mutable: the JAX package's VED always
normalizes with the batch's own statistics, and so does the port.

Inputs are uniform random floats, so no 2x2 window holds a tie for the
max-pool backward, which may route a tied grad differently.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyroved_tpu.nets.conv as jconv
import pyroved_tpu_torch.nets.conv as tconv
from pyroved_tpu_torch.utils.nn import as_numpy
from pyroved_tpu_torch.weights import from_jax_params

# f32 outputs summed in another order; grads summed over the batch and the
# pixels in another order (the JAX package's gradient tolerance).
ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3

ENC_FILTERS = ((4,), (8, 8))
DEC_FILTERS = ((8, 8), (4,))


def _flax(module, x, bn, *args):
    """(params, outputs, grads of sum(out * ct) for params and x, ct) of a
    flax module, channels-last. The parameters are random numbers in the
    tree ``init`` would make (traced for its shapes, not run), and one
    compiled program gives the outputs and the grads."""
    abstract = jax.eval_shape(lambda key, xx: module.init(key, xx, *args),
                              jax.random.PRNGKey(3), x)
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(-0.5, 0.5, a.shape), jnp.float32),
        abstract["params"])
    stats = abstract.get("batch_stats")
    if stats is not None:
        stats = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape), stats)

    def apply(p, xx):
        v = {"params": p}
        if stats is None:
            out = module.apply(v, xx, *args)
        else:
            v["batch_stats"] = stats
            out = module.apply(v, xx, *(args or (True,)),
                               mutable=["batch_stats"])[0]
        return out if isinstance(out, tuple) else (out,)

    n = sum(int(np.prod(o.shape)) for o in jax.eval_shape(apply, params, x))
    ct = jnp.asarray(np.random.default_rng(9).normal(size=n), jnp.float32)

    def proj(p, xx):
        out = apply(p, xx)
        flat = jnp.concatenate([a.reshape(-1) for a in out])
        return jnp.sum(flat * ct), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        proj, argnums=(0, 1), has_aux=True))(params, x)
    return params, out, gp, gx, ct


def _port(module, params, x, ct, move_channels=True):
    """The port module loaded with ``params``: outputs, and the grads of
    the same projection for its parameters and the input."""
    module.load_state_dict(from_jax_params(jax.tree_util.tree_map(
        np.asarray, params)), strict=True)
    xt = torch.tensor(np.array(x), requires_grad=True)
    out = module(xt.movedim(-1, 1) if move_channels else xt)
    outs = out if isinstance(out, tuple) else (out,)
    if move_channels:  # compare channels-last
        outs = tuple(o.movedim(1, -1) for o in outs)
    flat = torch.cat([o.reshape(-1).float() for o in outs])
    torch.sum(flat * torch.from_numpy(np.array(ct))).backward()
    grads = {n: p.grad for n, p in module.named_parameters()}
    return outs, grads, xt.grad


def _check(ours, params, out, gp, gx, ct, atol=ATOL):
    outs, grads, xgrad = ours
    assert len(outs) == len(out)
    for o, r in zip(outs, out):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(as_numpy(o.float()), np.asarray(r),
                                   atol=atol)
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, gp))
    assert sorted(grads) == sorted(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(as_numpy(grads[name]), r.numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
    np.testing.assert_allclose(as_numpy(xgrad), np.asarray(gx),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)


def _x(shape, seed=0):
    return jnp.asarray(np.random.default_rng(seed).uniform(
        -1, 1, shape).astype(np.float32))


@pytest.mark.parametrize("ndim,mode,conv_first", [
    (2, "bilinear", False), (2, "bilinear", True), (2, "nearest", False),
    (2, "nearest", True), (1, "bilinear", False), (3, "bilinear", True)])
def test_upsample_block_matches_flax(ndim, mode, conv_first):
    """x2 resize and 1x1 conv in both orders; bilinear (2-D only, borders
    included) and nearest (1-D and 3-D fall back to it)."""
    x = _x((2,) + (5, 7, 3)[:ndim] + (3,))
    ref = _flax(jconv.UpsampleBlock(ndim, 4, mode=mode,
                                    conv_first=conv_first), x, False)
    port = tconv.UpsampleBlock(ndim, 3, 4, mode=mode, conv_first=conv_first)
    _check(_port(port, *ref[:1], x, ref[-1]), *ref)


@pytest.mark.parametrize("pool,shape,bn", [
    ("max", (8, 8), False), ("avg", (8, 8), False), ("stride", (8, 8), False),
    ("stride", (9, 7), True), ("max", (9, 7), True), ("avg", (6, 10), True)])
def test_feature_extractor_matches_flax(pool, shape, bn):
    """Each pool; ``pool="stride"`` on even lengths is the case where XLA's
    SAME pads 0 before and 1 after."""
    x = _x((3,) + shape + (2,), seed=1)
    ref = _flax(jconv.FeatureExtractor(2, ENC_FILTERS, bn, pool=pool,
                                       pool_last=True), x, bn, True)
    port = tconv.FeatureExtractor(2, 2, ENC_FILTERS, bn, pool=pool,
                                  pool_last=True)
    _check(_port(port, ref[0], x, ref[-1]), *ref)


def test_stride_same_padding_is_xlas():
    """XLA's SAME at stride 2: (0, 1) on even lengths, (1, 1) on odd ones;
    a symmetric ``padding=1`` would shift every output sample."""
    assert tconv.same_padding(16, 3, 2) == (0, 1)
    assert tconv.same_padding(15, 3, 2) == (1, 1)
    assert tconv.same_padding(16, 3, 1) == (1, 1)
    assert tconv.same_padding(16, 1, 1) == (0, 0)


SPATIAL = {1: (16,), 2: (8, 12), 3: (4, 4, 8)}


@pytest.mark.parametrize("bn", [False, True], ids=["plain", "batchnorm"])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_conv_encoder_matches_flax(ndim, bn):
    """The tower, the channels-last flatten and the latent head."""
    dim = SPATIAL[ndim]
    x = _x((3,) + dim + (2,), seed=2)
    ref = _flax(jconv.convEncoderNet(dim, 3, ENC_FILTERS, bn), x, bn, True)
    port = tconv.convEncoderNet(dim, 2, 3, ENC_FILTERS, bn)
    _check(_port(port, ref[0], x, ref[-1], move_channels=False), *ref)


@pytest.mark.parametrize("conv_first", [False, True], ids=["literal",
                                                          "conv_first"])
@pytest.mark.parametrize("bn", [False, True], ids=["plain", "batchnorm"])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_conv_decoder_matches_flax(ndim, bn, conv_first):
    """The latent head, the channels-last reshape, the upsampler and its
    f32 head; the input grad is the latent's."""
    dim = tuple(4 * d for d in SPATIAL[ndim])
    z = _x((3, 3), seed=3)
    ref = _flax(jconv.convDecoderNet(dim, 3, 2, DEC_FILTERS, bn,
                                     conv_first=conv_first), z, bn, True)
    port = tconv.convDecoderNet(dim, 3, 2, DEC_FILTERS, bn,
                                conv_first=conv_first)
    _check(_port(port, ref[0], z, ref[-1], move_channels=False), *ref)


def test_batchnorm_uses_batch_statistics_at_eval():
    """No running averages and no train/eval switch: ``eval()`` changes
    nothing, and the statistics are the batch's own."""
    bn = tconv.BatchNorm(3)
    assert not list(bn.buffers())
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    y = bn(x)
    bn.eval()
    torch.testing.assert_close(bn(x), y, rtol=0, atol=0)
    np.testing.assert_allclose(as_numpy(y.mean((0, 2, 3))), 0, atol=1e-6)
    np.testing.assert_allclose(as_numpy(y.var((0, 2, 3), correction=0)),
                               1, atol=1e-3)


@pytest.mark.parametrize("flag", [True, False])
def test_tf32_scope_turns_tf32_off_and_restores_the_callers_flag(flag):
    """The scope of the f32 convolutions on a CUDA device: cuDNN's TF32
    off inside, the caller's flag as it was after, also when the block
    raises; off a CUDA device it leaves the flag alone."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32
    try:
        cudnn.allow_tf32 = flag
        with tconv._no_tf32(True):
            assert cudnn.allow_tf32 is False
        assert cudnn.allow_tf32 is flag
        with pytest.raises(RuntimeError):
            with tconv._no_tf32(True):
                raise RuntimeError
        assert cudnn.allow_tf32 is flag
        with tconv._no_tf32(False):
            assert cudnn.allow_tf32 is flag
    finally:
        cudnn.allow_tf32 = prev
