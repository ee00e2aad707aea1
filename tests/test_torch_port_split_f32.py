"""The numerics of the f32 K2/K3 kernel (``csrc/spatial_decoder_bwd_x3.cu``),
which forms every hidden-layer product of f32 operands as six products of
their three bf16 limbs, on the CPU: the plain helper
``ops.spatial_decoder.limb_matmul`` against an f64 product at the
decoder's shapes, and the plain backward with it in place of every hidden
product against the JAX package's ``_bwd`` / ``_train_call`` with f32
products (its Pallas kernel in interpret mode).

What this cannot show is the tensor cores' own accumulation: the f32 sums
inside and across wgmma steps, in the MMA's precision. That is checked on
the card only, by ``chip_smoke.py`` phase 2 (the kernel against the plain
version in f64) and ``python3 -m pyroved_tpu_torch.tools.x3_accuracy``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyroved_tpu.ops.spatial_decoder as sd
from pyroved_tpu_torch.ops import spatial_decoder as tsd

# grads against JAX: the port's f32 bounds (tests/test_torch_port_bwd.py)
ATOL, RTOL = 1e-4, 1e-3
# the limb product's error against f64, over the f32 product's own
F32_FACTOR = 3.0
GRADS = ("phi", "dx", "sc", "z", "Wc", "bc", "Wz", "hw", "hb", "wout", "bout")
TWO_LIMBS = ((0, 1), (1, 0), (0, 0))  # hi mid, mid hi, hi hi


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    """The port's plain versions in f32, as the JAX side here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield


@pytest.fixture
def limb_products(monkeypatch):
    """Every hidden product of the plain versions (the forward's h_l W_l,
    dwout, dW_l and dh) as the kernel's six limb products."""
    monkeypatch.setattr(tsd, "_mm", lambda a, b, bf16=None:
                        tsd.limb_matmul(a, b))


@pytest.fixture
def jax_f32(monkeypatch):
    monkeypatch.setattr(sd, "INTERPRET", True)
    monkeypatch.setattr(sd, "BF16_MATMUL", False)
    monkeypatch.setattr(sd, "ACT_DTYPE", jnp.float32)


def _operands(which, H, R=64, seed=0):
    """The operands of one of the kernel's products at width H and R
    pixels: the forward's h W ([R, H] @ [H, H], h a tanh layer), dW =
    h^T d ([H, R] @ [R, H]) and dh = d W^T ([R, H] @ [H, H])."""
    rng = np.random.default_rng(seed)
    h = np.tanh(rng.normal(size=(R, H)))
    d = rng.normal(size=(R, H)) * 1e-2
    W = rng.normal(size=(H, H)) * 1.5 / H ** 0.5
    a, b = {"forward": (h, W), "dW": (h.T, d), "dh": (d, W.T)}[which]
    return (torch.from_numpy(np.ascontiguousarray(a, np.float32)),
            torch.from_numpy(np.ascontiguousarray(b, np.float32)))


def _err(got, a, b):
    return (got.double() - a.double() @ b.double()).abs().max().item()


def test_limbs_rebuild_f32_exactly():
    scale = 10.0 ** np.arange(-4, 6).repeat(1000)
    x = torch.from_numpy((np.random.default_rng(1).normal(size=10000)
                          * scale).astype(np.float32))
    hi, mid, lo = tsd.bf16_limbs(x)
    for limb in (hi, mid, lo):
        assert torch.equal(limb, limb.to(torch.bfloat16).float())
    assert torch.equal((hi + mid) + lo, x)
    assert (mid.abs() <= hi.abs() * 2.0 ** -8).all()
    assert (lo.abs() <= hi.abs() * 2.0 ** -16).all()


@pytest.mark.parametrize("which", ["forward", "dW", "dh"])
@pytest.mark.parametrize("H", [128, 256])
def test_limb_product_within_f32_of_f64(which, H):
    """The six limb products, summed in f32, are as close to the f64
    product as f32's own product is, within 3x."""
    a, b = _operands(which, H)
    own = _err(a @ b, a, b)
    got = _err(tsd.limb_matmul(a, b), a, b)
    assert got <= F32_FACTOR * own, (got, own)


@pytest.mark.parametrize("which", ["forward", "dW", "dh"])
@pytest.mark.parametrize("H", [128, 256])
def test_two_limbs_fail_the_f64_bound(which, H):
    """Two limbs (hi hi + hi mid + mid hi) leave out terms of 2^-16 or so:
    the same bound fails, so it has teeth."""
    a, b = _operands(which, H)
    own = _err(a @ b, a, b)
    got = _err(tsd.limb_matmul(a, b, TWO_LIMBS), a, b)
    assert got > F32_FACTOR * own, (got, own)


def _inputs(D, C, B=5, N=300, H=128, L=4, nl=2, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)  # noqa: E731
    return dict(grid=rng.uniform(-1, 1, (N, D)).astype(np.float32),
                phi=f(B), dx=f(B, D, k=0.1), sc=1 + f(B, k=0.1), z=f(B, L),
                Wc=f(D, H, k=0.5), bc=f(H, k=0.1), Wz=f(L, H, k=0.5),
                hw=f(nl, H, H, k=1.2 / H ** 0.5), hb=f(nl, H, k=0.1),
                wout=f(H, C, k=1.0 / H ** 0.5), bout=f(C, k=0.1))


def _close(ours, ref, names=GRADS):
    for name, o, r in zip(names, ours, ref):
        np.testing.assert_allclose(np.asarray(o), np.asarray(r), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("act,D,C,H", [("tanh", 2, 1, 128),
                                       ("gelu", 1, 3, 128),
                                       ("softplus", 2, 1, 256)])
def test_limb_backward_matches_jax_bwd(jax_f32, limb_products, act, D, C, H):
    """K2's plain version with the limb products in place of every hidden
    product, against JAX's ``_bwd`` in f32."""
    a = _inputs(D, C, H=H, seed=len(act))
    g = np.random.default_rng(1).normal(
        size=(5, 300) if C == 1 else (5, 300, C)).astype(np.float32)
    ours = tsd.spatial_decoder_bwd_plain(
        **{k: torch.from_numpy(v) for k, v in a.items()},
        g=torch.from_numpy(g), act=act)
    res = tuple(jnp.asarray(a[k]) for k in ("grid",) + GRADS)
    ref = sd._bwd(act, True, res, jnp.asarray(g))
    _close([o.numpy() for o in ours], ref[1:])


@pytest.mark.parametrize("act,D", [("tanh", 2), ("relu", 1)])
def test_limb_loss_matches_jax_train_call(jax_f32, limb_products, act, D):
    """K3's plain version with the limb products, against JAX's
    ``_train_call`` in f32: the loss and the grads."""
    a = _inputs(D, 1, seed=10 + len(act))
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (5, 300)).astype(np.float32)
    w = rng.uniform(0, 1, 5).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    loss, grads = tsd.recon_loss_plain(
        t["grid"], t["phi"], t["dx"], t["sc"], t["z"], torch.from_numpy(x),
        torch.from_numpy(w), *(t[k] for k in GRADS[4:]), act=act)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    ref_loss, ref = sd._train_call(
        j["grid"], j["phi"], j["dx"], j["sc"], j["z"], jnp.asarray(x),
        jnp.asarray(w), *(j[k] for k in GRADS[4:]), act)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    _close([o.numpy() for o in grads[:-1]], ref[:-1], GRADS[:-1])
    np.testing.assert_allclose(grads[-1].numpy(),
                               np.asarray(ref[-1]).reshape(1), atol=ATOL,
                               rtol=RTOL)
