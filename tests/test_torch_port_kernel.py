"""Port of the fused spatial-decoder forward: the plain PyTorch version
against the JAX package's Pallas kernel K1 (``_fwd_kernel``) in interpret
mode, the wrapper's CPU routing, and the port's import and build guard
rails. The CUDA kernel itself is held against the plain version on the
card by ``chip_smoke.py``."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyroved_tpu.ops.spatial_decoder as sd
from pyroved_tpu_torch.nets.fc import init_from, sDecoderNet
from pyroved_tpu_torch.ops import _build
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.utils.nn import set_deterministic_mode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# f32 everywhere; the sums run in another order in the two packages
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    """The port's hidden products in f32, as the JAX side here, for the
    whole module (before any module-scoped fixture computes)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield


@pytest.fixture
def k1_interpret(monkeypatch):
    """Run JAX's K1 in interpret mode with f32 matmuls (as its own tests)."""
    monkeypatch.setattr(sd, "INTERPRET", True)
    monkeypatch.setattr(sd, "BF16_MATMUL", False)
    monkeypatch.setattr(sd, "ACT_DTYPE", jnp.float32)


def _inputs(D, C, B=5, N=300, hidden=(128, 128), L=4, seed=0):
    """Decoder inputs from numpy, with hidden widths zero-padded to the
    kernel width as the models pad them."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    H = -(-max(hidden) // 128) * 128
    widths = (hidden[0],) + tuple(hidden)

    def pad(a, shape):
        out = np.zeros(shape, np.float32)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    hw = np.stack([pad(rng.normal(size=(widths[i], widths[i + 1])) * 0.1,
                       (H, H)) for i in range(len(hidden))])
    hb = np.stack([pad(rng.normal(size=(widths[i + 1],)) * 0.1, (H,))
                   for i in range(len(hidden))])
    return dict(
        grid=f32(rng.uniform(-1, 1, (N, D))),
        phi=f32(rng.normal(size=(B,))),
        dx=f32(rng.normal(size=(B, D)) * 0.1),
        sc=f32(1 + 0.1 * rng.normal(size=(B,))),
        z=f32(rng.normal(size=(B, L))),
        Wc=pad(rng.normal(size=(D, hidden[0])) * 0.5, (D, H)),
        bc=pad(rng.normal(size=(hidden[0],)) * 0.1, (H,)),
        Wz=pad(rng.normal(size=(L, hidden[0])) * 0.5, (L, H)),
        hw=f32(hw), hb=f32(hb),
        wout=pad(rng.normal(size=(hidden[-1], C)) * 0.3, (H, C)),
        bout=f32(rng.normal(size=(C,)) * 0.1))


def _port(a, act, sigmoid_out=True):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    out = tsd.fused_spatial_decoder_forward(**t, act=act,
                                            sigmoid_out=sigmoid_out)
    return out.numpy()


def _jax_k1(a, act, sigmoid_out=True):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    return np.asarray(sd._fwd(**j, act=act, sigmoid_out=sigmoid_out))


def _jax_xla(a, act, sigmoid_out=True):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    return np.asarray(sd._xla_forward(**j, act=act, sigmoid_out=sigmoid_out))


@pytest.mark.parametrize("act", ["tanh", "relu", "lrelu", "softplus",
                                 "tanh_approx"])
def test_plain_matches_jax_k1_per_activation(k1_interpret, act):
    a = _inputs(D=2, C=1)
    np.testing.assert_allclose(_port(a, act), _jax_k1(a, act), atol=ATOL)


def test_plain_gelu_matches_jax_exact_forward():
    # K1 evaluates erf with a polynomial (error <= 1.5e-7); the port uses the
    # exact erf, which is what the JAX package's XLA forward computes
    a = _inputs(D=2, C=1)
    np.testing.assert_allclose(_port(a, "gelu"), _jax_xla(a, "gelu"), atol=ATOL)


@pytest.mark.parametrize("D,C", [(1, 1), (1, 3), (2, 3)])
def test_plain_matches_jax_k1_dims_and_channels(k1_interpret, D, C):
    a = _inputs(D=D, C=C)
    out = _port(a, "tanh")
    assert out.shape == ((5, 300) if C == 1 else (5, 300, C))
    np.testing.assert_allclose(out, _jax_k1(a, "tanh"), atol=ATOL)


def test_plain_matches_jax_k1_ragged_padded_width_linear_head(k1_interpret):
    # ragged B and N, hidden (96, 160) padded to H = 256, no sigmoid
    a = _inputs(D=2, C=2, B=3, N=77, hidden=(96, 160), seed=3)
    np.testing.assert_allclose(_port(a, "softplus", False),
                               _jax_k1(a, "softplus", False), atol=ATOL)


def test_padded_weights_match_jax_and_are_exact():
    """padded_sdecoder_weights pads like the JAX package, and the padded
    decode equals the module's own forward."""
    hidden = (96, 160)
    dec = init_from(sDecoderNet(2, 3, hidden, "softplus", channels=2),
                    set_deterministic_mode(0))
    padded = tsd.padded_sdecoder_weights(dec)
    params = {
        "fc_coord": {"kernel": dec.fc_coord.weight.T.detach().numpy(),
                     "bias": dec.fc_coord.bias.detach().numpy()},
        "fc_latent": {"kernel": dec.fc_latent.weight.T.detach().numpy()},
        "MLP_0": {f"Dense_{i}": {"kernel": m.weight.T.detach().numpy(),
                                 "bias": m.bias.detach().numpy()}
                  for i, m in enumerate(dec.MLP_0.layers())},
        "out": {"kernel": dec.out.weight.T.detach().numpy(),
                "bias": dec.out.bias.detach().numpy()},
    }
    ref = sd._padded_sdecoder_weights(params)
    assert padded[3].shape == (2, 256, 256)
    for p, r in zip(padded, ref):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(r))
    rng = np.random.default_rng(1)
    grid = torch.from_numpy(rng.uniform(-1, 1, (50, 2)).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    zeros, ones = torch.zeros(4), torch.ones(4)
    with torch.no_grad():
        fused = tsd.apply_fused_sdecoder(dec, grid, zeros, torch.zeros(4, 2),
                                         ones, z, "softplus")
        module = dec(grid, z)
    np.testing.assert_allclose(fused.numpy(), module.numpy(), atol=ATOL)


def test_wrapper_runs_plain_version_on_cpu_without_launching():
    a = {k: torch.from_numpy(v) for k, v in _inputs(D=2, C=1, N=40).items()}
    launches = tsd.fused_spatial_decoder_forward.launches
    assert set(launches) == set(tsd.FWD_SOURCES.values())
    before = dict(launches)
    out = tsd.fused_spatial_decoder_forward(**a, act="gelu")
    ref = tsd.spatial_decoder_plain(**a, act="gelu")
    assert tsd.fused_spatial_decoder_forward.launches == before
    assert torch.equal(out, ref)


def test_fusion_gate_keeps_jax_config_conditions():
    ok = tsd.sdecoder_supports_fusion
    assert ok((128, 128), "tanh", True, 1, 1, "cpu")
    assert ok((192, 256), "gelu", False, 4, 4, "cpu")   # pads to 256
    assert not ok((128, 128), "tanh", True, 0, 1, "cpu")      # no transform
    assert not ok((128, 128), "tanh", True, 5, 1, "cpu")
    assert not ok((128, 128), "tanh_approx", True, 1, 1, "cpu")
    assert not ok((128, 128), "tanh", True, 1, 5, "cpu")      # channels
    assert not ok((512, 512), "tanh", True, 1, 1, "cpu")      # width 512
    assert not ok((128, 384), "tanh", True, 1, 1, "cpu")      # pads to 384
    # every width that pads to 128 or 256 runs the kernel, however much
    # padding it takes: the configuration alone decides
    assert ok((96, 160), "tanh", True, 1, 1, "cpu")
    assert ok((128, 256), "relu", True, 1, 1, "cpu")
    assert ok((8, 200, 16), "lrelu", True, 2, 1, "cpu")
    assert not ok((128, 128), "tanh", True, 1, 1, "meta")


def _decoder(seed=0, hidden=(96, 160)):
    return init_from(sDecoderNet(2, 3, hidden, "tanh", channels=1),
                     set_deterministic_mode(seed))


def test_kernel_weights_are_reused_until_a_weight_changes():
    dec = _decoder()
    with torch.no_grad():
        first = tsd._kernel_weights(dec)
        assert tsd._kernel_weights(dec) is first
        dec.MLP_0.layers()[1].bias.add_(1.0)       # in-place update
        second = tsd._kernel_weights(dec)
        assert second is not first
        np.testing.assert_array_equal(second[4][1, :160].numpy(),
                                      first[4][1, :160].numpy() + 1.0)
        dec.load_state_dict(_decoder(seed=1).state_dict())
        third = tsd._kernel_weights(dec)
        assert third is not second
        for got, ref in zip(third, tsd.padded_sdecoder_weights(dec)):
            assert torch.equal(got, ref)
        assert tsd._kernel_weights(dec) is third


def test_kernel_weights_follow_autograd_when_it_is_on():
    dec = _decoder()
    with torch.no_grad():
        cached = tsd._kernel_weights(dec)
    fresh = tsd._kernel_weights(dec)
    assert fresh is not cached and fresh[3].requires_grad
    fresh[3].sum().backward()
    assert dec.MLP_0.layers()[0].weight.grad is not None


def test_nvcc_command_targets_hopper():
    cmd = _build.nvcc_command("k.cu", "k.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    joined = " ".join(cmd)
    assert "compute_90a" in joined and "sm_90a" in joined
    assert "-shared" in cmd and "-O3" in cmd and "-std=c++17" in cmd


def test_nvcc_command_defines_macros_into_a_library_of_their_own():
    """A source built with macros defined (the profiled tensor-core K2)
    gets its own library, beside the plain build."""
    cmd = _build.nvcc_command("k.cu", "k.so", ("PVT_PROFILE_PHASES",))
    assert "-DPVT_PROFILE_PHASES" in cmd
    assert cmd[-3:] == ["-o", "k.so", "k.cu"]
    plain = _build._target("spatial_decoder_bwd_tc")
    profiled = _build._target("spatial_decoder_bwd_tc", ("PVT_PROFILE_PHASES",))
    assert plain[0] == profiled[0] and plain[1] != profiled[1]


def test_build_name_follows_the_included_headers(monkeypatch, tmp_path):
    """A library's name hashes its source and every header in ``CSRC`` it
    includes, followed into headers: editing a shared header renames the
    library, so no stale build is loaded; a header it does not include
    does not."""
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\n'
                                   "int k() { return A; }\n")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n'
                                    "constexpr int A = B;\n")
    (tmp_path / "b.cuh").write_text("constexpr int B = 1;\n")
    (tmp_path / "c.cuh").write_text("constexpr int C = 1;\n")
    names = [_build._target("k")[1]]
    (tmp_path / "c.cuh").write_text("constexpr int C = 2;\n")
    names.append(_build._target("k")[1])
    (tmp_path / "b.cuh").write_text("constexpr int B = 2;\n")
    names.append(_build._target("k")[1])
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n'
                                    "constexpr int A = B + 1;\n")
    names.append(_build._target("k")[1])
    assert names[0] == names[1]
    assert len(set(names[1:])) == 3
    assert all(os.path.basename(n).startswith("k-") for n in names)
    # the port's own sources: every tensor-core kernel includes the common
    # header, the two K2/K3 sources through the header they share
    for name, headers in (
            ("spatial_decoder_fwd_tc", ["sm90_common.cuh"]),
            ("spatial_decoder_bwd_tc", ["sm90_bwd.cuh", "sm90_common.cuh"]),
            ("spatial_decoder_bwd_x3", ["sm90_bwd.cuh", "sm90_common.cuh"])):
        monkeypatch.setattr(_build, "CSRC", _build.__dict__["_PKG"] + "/csrc")
        seen = []
        _build._texts(_build._target(name)[0], seen)
        assert [os.path.basename(p) for p in seen] == [name + ".cu"] + headers


def test_port_imports_no_jax():
    """Every port module, serving and chip_smoke import in a fresh process
    without pulling in JAX, flax, optax or the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import pyroved_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'pyroved_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import pyroved_tpu_torch.serving, chip_smoke\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax') or k == 'pyroved_tpu' "
        "or k.startswith('pyroved_tpu.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
