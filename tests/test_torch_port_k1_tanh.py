"""The tensor-core K1's tanh and its wrapper, on the CPU.

The kernel's tanh (``csrc/sm90_common.cuh``, ``tanh_exp2``) runs only on
the card, where ``chip_smoke.py`` holds it to f64 tanh over every f32
input. Here its plain mirror (``ops/spatial_decoder.py``,
``tanh_exp2_plain``) is held to the same bound over a dense sweep and the
special values, its constant to the kernel source's, and the K1 wrapper,
at small sizes of ``chip_smoke.py``'s K1 matrix, to its plain version and
to the JAX package's ``_fwd`` in interpret mode; its input checks name
each fault."""
import math
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyroved_tpu.ops.spatial_decoder as sd
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.tools.measure import random_case
from test_torch_port_bf16 import (DEEP_ATOL, DEEP_FRAC, OUT_ATOL, OUT_MEAN,
                                  bf16_both)  # noqa: F401

# chip_smoke.py's bound for the card's tanh against f64 tanh: f32's
# resolution of the output range (every value it feeds is rounded to bf16
# or summed in f32 into the head)
TANH_BOUND = 2.5e-7
SOURCE = os.path.join(os.path.dirname(tsd.__file__), os.pardir, "csrc",
                      "sm90_common.cuh")


def _probe_inputs():
    """A dense sweep of [-10, 10] (every 2^-17), both signs of every power
    of two from the smallest denormal up, and the special values."""
    pow2 = torch.exp2(torch.arange(-149, 128, dtype=torch.float64)).float()
    big = torch.finfo(torch.float32)
    special = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan,
                            big.max, -big.max, big.tiny, -big.tiny])
    return torch.cat([torch.linspace(-10, 10, (1 << 21) + 1), pow2, -pow2,
                      special])


def test_mirror_within_the_bound_of_f64_tanh():
    """The tanh within TANH_BOUND of f64 tanh; NaN gives NaN and +-inf
    gives +-1 exactly."""
    x = _probe_inputs()
    y = tsd.tanh_exp2_plain(x)
    assert y.dtype == torch.float32
    nan = torch.isnan(x)
    assert bool(torch.isnan(y[nan]).all())
    assert y[x == math.inf].tolist() == [1.0]
    assert y[x == -math.inf].tolist() == [-1.0]
    err = (y.double() - torch.tanh(x.double()))[~nan].abs()
    assert err.max().item() <= TANH_BOUND
    assert err.max().item() > 2.0 ** -24  # f32's own rounding shows


def test_mirror_constants_are_the_kernels():
    """TWO_LOG2E is the literal of the kernel source's kTwoLog2e (a change
    to either side fails here)."""
    text = open(SOURCE).read()
    k = re.search(r"constexpr float kTwoLog2e = ([0-9.]+)f;", text).group(1)
    assert np.float32(float(k)) == np.float32(tsd.TWO_LOG2E)


def test_fwd_tc_tanh_on_cpu_is_the_mirror():
    """The probe's wrapper on a CPU tensor is the plain mirror, and within
    one f32 rounding step of torch's tanh."""
    x = torch.linspace(-6, 6, 4097)
    out = tsd.fwd_tc_tanh(x)
    assert torch.equal(out, tsd.tanh_exp2_plain(x))
    assert (out - torch.tanh(x)).abs().max().item() <= TANH_BOUND


# (D, C, act, H, nl) of chip_smoke.py's K1 matrix at small sizes: every
# activation at both widths at the matrix's depth of two (C = 1 and 3),
# five layers at both widths, four channels at one layer
K1_SMALL = ([(2 if i % 2 else 1, 1 if H == 128 else 3, act, H, 2)
             for i, act in enumerate(tsd.KERNEL_ACTS_WITH_APPROX)
             for H in (128, 256)]
            + [(2, 2, "tanh", 128, 5), (1, 1, "softplus", 256, 5),
               (2, 4, "tanh", 128, 1)])


@pytest.mark.parametrize("D,C,act,H,nl", K1_SMALL,
                         ids=["-".join(map(str, c)) for c in K1_SMALL])
def test_k1_wrapper_on_cpu_matches_plain_and_jax(bf16_both, D, C, act, H,
                                                 nl):
    """On CPU tensors the K1 wrapper is the plain version (bitwise, no
    launch counted) and matches JAX's Pallas K1 in interpret mode with
    bf16 products, at a ragged N (70 at H = 128, 40 at H = 256)."""
    N = 70 if H == 128 else 40
    a = random_case(np.random.default_rng(nl + H), "cpu", D, C, H, 2, N, 3,
                    nl)
    before = dict(tsd.fused_spatial_decoder_forward.launches)
    out = tsd.fused_spatial_decoder_forward(**a, act=act)
    assert tsd.fused_spatial_decoder_forward.launches == before
    assert torch.equal(out, tsd.spatial_decoder_plain(**a, act=act))
    ref = np.asarray(sd._fwd(**{k: jnp.asarray(v.numpy())
                                for k, v in a.items()}, act=act))
    err = np.abs(out.numpy() - ref)
    if (H, nl) == (128, 2):
        assert err.max() <= OUT_ATOL
    else:  # deeper or wider: more bf16 rounding flips reach the head
        assert err.max() <= DEEP_ATOL and err.mean() <= OUT_MEAN
        assert (err > OUT_ATOL).mean() <= DEEP_FRAC


@pytest.mark.parametrize("H", [128, 256])
def test_k1_wrapper_without_hidden_layers_is_plain(H):
    """No hidden layer (the matrix's nl = 0 cases, which JAX's interpret
    mode does not take): on CPU tensors the wrapper is the plain
    version."""
    a = random_case(np.random.default_rng(H), "cpu", 2, 1, H, 2, 70, 2, 0)
    assert torch.equal(tsd.fused_spatial_decoder_forward(**a),
                       tsd.spatial_decoder_plain(**a))


# One fault of each kind _check names, by what it raises and says
CHECK_FAULTS = {
    "device": (lambda t: t.to("meta"), ValueError, "is on meta"),
    "dtype": (lambda t: t.double(), TypeError, "must be float32"),
    "shape": (lambda t: t.reshape(2, 3), ValueError, "has shape (2, 3)"),
    "contiguous": (lambda t: t.t(), ValueError, "must be contiguous"),
}


@pytest.mark.parametrize("fault", sorted(CHECK_FAULTS))
def test_check_names_each_fault(fault):
    """The wrapper's input check lets a valid tensor through and raises,
    naming the input, for each fault (its combined first test skips
    none)."""
    t = torch.zeros(3, 2)
    tsd._check("hw", t, (3, 2), t.device)
    make, exc, says = CHECK_FAULTS[fault]
    bad = make(torch.zeros(3, 2) if fault != "contiguous"
               else torch.zeros(2, 3))
    with pytest.raises(exc, match=r"^hw .*" + re.escape(says)):
        tsd._check("hw", bad, (3, 2), t.device)
