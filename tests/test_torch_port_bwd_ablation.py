"""Port of K4, the backward kernel in ablation modes
(``benchmarks/bwd_ablation.py``'s ``_variant_kernel``, built by its
``build_call``): the port's plain version ``variant_plain`` against JAX's
kernel in interpret mode, every mode under each ``BF16_MATMUL``, on the
same padded inputs (``time_variant``'s recipe, from a numpy seed); ``full``
against K2's plain version; the entry point's routing by device. The CUDA
variants are held against the plain version on the card by
``chip_smoke.py`` (phase 13)."""
import importlib.util
import os

import numpy as np
import pytest
import torch

import pyroved_tpu.ops.spatial_decoder as sd
from pyroved_tpu_torch.ops import bwd_ablation as ab
from pyroved_tpu_torch.ops import spatial_decoder as tsd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# f32 on both sides, sums over up to 4,096 rows in another order: every
# output within 1e-4 + 1e-3 of its tensor's largest entry (the port's
# gradient rule; fwd_remat's dz reaches ~3e2 here, ~1e4 at the flagship).
F32_ATOL, F32_REL = 1e-4, 1e-3
# Under BF16_MATMUL both sides round the same operands, but an intermediate
# within an f32 rounding of a bf16 boundary rounds to either neighbour
# (tests/test_torch_port_bf16.py; PERF.md section 2): 1e-4 + 2.5e-3 of the
# largest entry.
BF16_ATOL, BF16_REL = 1e-4, 2.5e-3
# The shape of the parity cases: a 2x2 grid of (8, 128) tiles
B, N, H, L, NL = 16, 256, 128, 4, 2
# The modes whose outputs depend on the tiles, also run as one (16, 256)
# tile
TILED = ("dma_floor", "fwd_remat", "fwd_noact", "no_breduce", "mxu_dwout")


def _load_jax_ablation():
    spec = importlib.util.spec_from_file_location(
        "bwd_ablation_ref", os.path.join(ROOT, "benchmarks", "bwd_ablation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAB = _load_jax_ablation()


def inputs(seed=0):
    """``time_variant``'s inputs (``benchmarks/bwd_ablation.py:288-297``)
    in JAX's shapes: normal draws x 0.1, ``sc = 1 + ...``."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)  # noqa: E731
    grid = mk(N, 2)
    phi, sc = mk(B, 1), (1.0 + mk(B, 1)).astype(np.float32)
    dx, z = mk(B, 2), mk(B, L)
    Wc, bc, Wz = mk(2, H), mk(1, H), mk(L, H)
    hw, hb = mk(NL, H, H), mk(NL, H)
    wout, bout = mk(1, H), mk(1, 1)
    g = mk(B, N)
    return (grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout, bout, g)


def port_args(a):
    """The same arrays in K2's shapes (phi, sc, bc [B] / [H], wout [H, 1],
    bout [1])."""
    grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout, bout, g = (
        torch.from_numpy(x) for x in a)
    return (grid, phi.reshape(-1), dx, sc.reshape(-1), z, Wc, bc.reshape(-1),
            Wz, hw, hb, wout.reshape(H, 1), bout.reshape(1), g)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PVT_INTERPRET", "1")


def jax_variant(mode, a, b_t, n_t):
    call = JAB.build_call(mode, B, N, H, L, NL, b_t, n_t)
    return [np.asarray(o) for o in call(*a)]


def assert_close(ours, ref, atol, rel, what, names=ab.OUTPUT_NAMES):
    assert len(ours) == len(ref) == len(names)
    for name, o, r in zip(names, ours, ref):
        o = o.detach().numpy()
        assert o.shape == r.shape, f"{what} {name}: {o.shape} != {r.shape}"
        if not np.any(r):  # what the mode leaves at zero stays exactly zero
            assert not np.any(o), f"{what} {name}: not zero"
            continue
        err = np.abs(o - r).max()
        tol = atol + rel * np.abs(r).max()
        assert err <= tol, f"{what} {name}: max err {err:.3e} > {tol:.3e}"


CASES = ([(m, f, (8, 128)) for m in ab.MODES for f in (False, True)]
         + [(m, f, (16, 256)) for m in TILED for f in (False, True)])


@pytest.mark.parametrize("mode,bf16,tiles", CASES,
                         ids=[f"{m}-{'bf16' if f else 'f32'}-{t[0]}x{t[1]}"
                              for m, f, t in CASES])
def test_variant_plain_matches_jax_interpret(interpret, monkeypatch, mode,
                                             bf16, tiles):
    monkeypatch.setattr(sd, "BF16_MATMUL", bf16)
    monkeypatch.setattr(tsd, "BF16_MATMUL", bf16)
    a = inputs()
    b_t, n_t = tiles
    ref = jax_variant(mode, a, b_t, n_t)
    ours = ab.variant_plain(mode, *port_args(a), n_layers=NL, b_t=b_t,
                            n_t=n_t)
    atol, rel = (BF16_ATOL, BF16_REL) if bf16 else (F32_ATOL, F32_REL)
    assert_close(ours, ref, atol, rel, f"{mode} {tiles}")


@pytest.mark.parametrize("bf16", (False, True), ids=("f32", "bf16"))
def test_full_is_k2_plain_with_a_sigmoid_head(monkeypatch, bf16):
    """``full`` is K2's function at C = 1 with a sigmoid head, in f32 to
    f32's rounding. Under the flag K2 rounds h_L and dl to bf16 for dwout
    (``_mxu_dot_at``) where ``full`` keeps f32 (JAX's ablation kernel
    does): dwout is held to that rounding's bound, 2^-8 of the sum of
    |h_L dl| (measured 1.3 % of its largest entry here, a cancelling sum),
    and every other grad, the same arithmetic, to 1e-5 + 1e-6 of its
    largest entry."""
    monkeypatch.setattr(tsd, "BF16_MATMUL", bf16)
    args = port_args(inputs(1))
    ours = ab.variant_plain("full", *args, n_layers=NL, b_t=8, n_t=128)
    ref = [r.reshape(o.shape).numpy() for o, r in zip(
        ours, tsd.spatial_decoder_bwd_plain(*args, act="tanh",
                                            sigmoid_out=True))]
    if bf16:
        hs, _, _ = tsd._folded_forward(*args[:10], act="tanh")
        s = torch.sigmoid(hs[-1] @ args[10] + args[11])[..., 0]
        dl = args[12] * s * (1 - s)
        bound = 2.0 ** -8 * (hs[-1].abs() * dl.abs()[..., None]).sum((0, 1))
        err = (ours[9][0] - torch.from_numpy(ref[9][0])).abs()
        assert bool((err <= bound + 1e-7).all()), "full vs K2 dwout"
        keep = [i for i in range(11) if i != 9]
        ours, ref = [ours[i] for i in keep], [ref[i] for i in keep]
        names = [ab.OUTPUT_NAMES[i] for i in keep]
    else:
        names = ab.OUTPUT_NAMES
    assert_close(ours, ref, 1e-5, 1e-6, "full vs K2", names)
    same = ab.variant_plain("full_dg", *args, n_layers=NL, b_t=8, n_t=128)
    assert all(torch.equal(p, q) for p, q in zip(
        ab.variant_plain("full", *args, n_layers=NL, b_t=8, n_t=128), same))


def test_variant_on_cpu_runs_the_plain_version_without_a_launch():
    args = port_args(inputs(2))
    before = dict(ab.variant.launches)
    for mode in ab.MODES:
        got = ab.variant(mode, *args, n_layers=NL, b_t=8, n_t=128)
        ref = ab.variant_plain(mode, *args, n_layers=NL, b_t=8, n_t=128)
        assert all(torch.equal(p, q) for p, q in zip(got, ref))
    assert ab.variant.launches == before
    assert set(before) == {ab.launch_key(m, f) for m in ab.MODES
                           for f in (True, False)}


class _OnCard:
    """A stand-in for a tensor on the first CUDA device."""
    device = torch.device("cuda", 0)


def test_variant_off_hopper_raises(monkeypatch):
    args = (_OnCard(),) + port_args(inputs(3))[1:]
    with pytest.raises(RuntimeError, match="Hopper"):  # no card at all
        ab.variant("full", *args, n_layers=NL, b_t=8, n_t=128)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    with pytest.raises(RuntimeError, match="Hopper"):  # an A100
        ab.variant("full", *args, n_layers=NL, b_t=8, n_t=128)


def test_unpadded_inputs_and_unknown_modes_raise():
    args = port_args(inputs(4))
    with pytest.raises(ValueError, match="padded"):
        ab.variant_plain("full", *args, n_layers=NL, b_t=6, n_t=128)
    with pytest.raises(ValueError, match="padded"):
        ab.variant_plain("full", *args, n_layers=NL, b_t=8, n_t=96)
    with pytest.raises(ValueError, match="mode"):
        ab.variant_plain("fwd_only", *args, n_layers=NL, b_t=8, n_t=128)
    assert ab.defines("mxu_dhb") == ("PVT_ABLATE=7",)
