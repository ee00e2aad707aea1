"""The H = 256 plans of the tensor-core K1 and K2/K3 as the tools mirror
them (``tools/profile_fwd_tc.py``, ``tools/profile_bwd_tc.py``), on the
CPU: cluster sizes, tiles, shared memory and passes at an H100's shared
memory, the layer limits the gate relies on, the fields the tools read of
a library's plan, the padded inputs the tools time, and the machine-code
comparison that leaves the H = 256 functions out. ``chip_smoke.py`` phase
2 holds the same mirrors to the libraries' own plans on the card."""
import types

import numpy as np
import pytest
import torch

from pyroved_tpu_torch.nets.fc import sDecoderNet
from pyroved_tpu_torch.ops import spatial_decoder as sd
from pyroved_tpu_torch.tools import cluster_sync, measure
from pyroved_tpu_torch.tools import profile_bwd_tc as bwd
from pyroved_tpu_torch.tools import profile_fwd_tc as fwd

OPTIN = 232_448  # an H100's shared memory a block can opt into


@pytest.mark.parametrize("nl,cs", [(0, 2), (1, 2), (2, 2), (3, 4), (4, 4),
                                   (5, 4), (6, 0)])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_k1_cluster_size_follows_the_weights(nl, cs, C):
    """Two blocks a cluster (64 KB of weights a layer each, 64-pixel
    tiles) up to two layers, four (32 KB a layer, 32-pixel tiles) for
    three to five, none beyond; the chosen plan fits the block."""
    assert fwd.cluster_blocks(nl, C, OPTIN) == cs
    if cs:
        assert fwd.cluster_smem(cs, nl, C) <= OPTIN
        assert fwd.cluster_tile(cs) == (64 if cs == 2 else 32)


def test_k1_cluster_smem_at_the_flagship_and_the_limit():
    """The shared memory a block holds: weights, two levels and the small
    buffers, at two layers (two blocks) and five (four blocks)."""
    assert fwd.cluster_smem(2, 2, 1) == 2 * 65536 + 65536 + 4 * (
        256 + 128 + 4 + 384 + 128 + 512 + 256 + 8)
    assert fwd.cluster_smem(4, 5, 4) == 5 * 32768 + 32768 + 4 * (
        320 + 256 + 4 + 192 + 64 + 1024 + 1024 + 8)
    assert fwd.cluster_smem(4, 6, 1) > OPTIN


@pytest.mark.parametrize("act", sd.KERNEL_ACTS)
@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_k1_layer_limit_covers_the_backward(act, C):
    """K1 takes five layers at H = 256 with any channel count, as many as
    K2/K3 take (so the gate routes what it routed before), and six at
    H = 128 beside one warpgroup."""
    assert fwd.max_layers(256, C, OPTIN) == 5 >= sd.bwd_max_layers(act)
    assert fwd.max_layers(128, C, OPTIN) == 6


@pytest.mark.parametrize("B,N,cs,clusters,tiles", [
    (200, 784, 2, 66, 39), (200, 784, 4, 30, 166), (1, 1, 4, 30, 1),
    (3, 150, 2, 66, 1)])
def test_k1_cluster_tiles_deal_the_tile_list(B, N, cs, clusters, tiles):
    """Cluster 0 takes the first of n = min(clusters, T) contiguous runs of
    the T tiles, floor(T / n) of them; a call of fewer tiles than clusters
    launches one cluster a tile."""
    assert fwd.cluster_tiles(B, N, cs, clusters) == tiles


@pytest.mark.parametrize("nl,C,resident,passes,smem", [
    (1, 1, 1, 1, 65536 + 2 * 16384 + 2 * 8192 + 4 * (1355 + 512 + 1025)),
    (2, 1, 1, 1, 218_416), (2, 4, 1, 1, 230_716),
    (3, 1, 0, 2, 32768 + 4 * 16384 + 4 * 8192 + 4 * (1355 + 1536 + 1025)),
    (4, 2, 0, 2, None), (5, 4, 0, 3, None)])
def test_k2_cluster_plan(nl, C, resident, passes, smem):
    """K2/K3 at H = 256: clusters of four blocks, 32-pixel tiles, the
    weights resident up to two layers (one pass over the tiles: each
    tile's forward and dh run once) and streamed beyond; 16 dW units a
    pass; the clusters that fit split over the passes."""
    plan = bwd.cluster_plan(200, 784, nl, C, 33, OPTIN)
    assert plan["R"] == 32 and plan["cluster"] == 4
    assert plan["n_tiles"] == 25
    assert (plan["resident"], plan["passes"]) == (resident, passes)
    assert plan["per_pass"] == 4 * (33 // passes)
    assert plan["smem"] <= OPTIN
    if smem is not None:
        assert plan["smem"] == smem


def test_k2_cluster_plan_caps_the_clusters_at_the_tiles():
    """A call of fewer tiles than clusters runs one cluster a tile."""
    plan = bwd.cluster_plan(1, 40, 2, 1, 33, OPTIN)
    assert (plan["n_tiles"], plan["per_pass"]) == (2, 8)
    assert bwd.block0_tiles(1, plan) == 1


@pytest.mark.parametrize("info,tiles", [
    (dict(n_tiles=13, per_pass=132, cluster=1), 20),
    (dict(n_tiles=25, per_pass=132, cluster=4), 152)])
def test_block0_tiles_count_clusters(info, tiles):
    """Block 0's tiles: the pass's tiles dealt over its blocks, or over
    its clusters where blocks run in clusters."""
    assert bwd.block0_tiles(200, info) == tiles


def _fake_lib(fields):
    """A library whose plan entry writes ``fields`` into the caller's
    array and whose launch is never called."""
    def plan(*args):
        out = args[-1]
        for i, v in enumerate(fields):
            out[i] = v
        return 0

    return types.SimpleNamespace(pvt_sdec_bwd_tc_plan=plan,
                                 pvt_sdec_bwd_tc=lambda *a: 0)


def test_plan_info_reads_the_cluster_field():
    """A library that reports seven fields gives its cluster size; one
    that reports six (an earlier source) reads as no cluster."""
    seven = bwd.plan_info(_fake_lib((32, 1, 218280, 1, 132, 25, 4)), 200,
                          784, 2, 256)
    assert seven == dict(zip(bwd.PLAN_FIELDS, (32, 1, 218280, 1, 132, 25, 4)))
    six = bwd.plan_info(_fake_lib((32, 0, 200000, 4, 33, 25)), 200, 784, 2,
                        256)
    assert six["cluster"] == 1 and six["passes"] == 4


def test_padded_case_zeroes_the_padded_units():
    """A (128, 256) decoder padded to 256: level 0 and layer 0's outputs
    keep 128 units, layer 1's all 256; every weight into or out of a
    padded unit and its bias is zero, the rest as it was. The zeros are
    those of ``padded_sdecoder_weights`` on an sDecoderNet of those
    widths: padding its padded weights again changes nothing."""
    a = measure.random_case(np.random.default_rng(0), "cpu", 2, 1, 256, 2,
                            30, 3, 2)
    p = measure.padded_case(a, (128, 256))
    assert torch.equal(p["Wc"][:, :128], a["Wc"][:, :128])
    assert not p["Wc"][:, 128:].any() and not p["bc"][128:].any()
    assert not p["Wz"][:, 128:].any()
    assert not p["hw"][0, 128:].any() and not p["hw"][0, :, 128:].any()
    assert not p["hb"][0, 128:].any() and not p["hw"][1, 128:].any()
    assert torch.equal(p["hw"][1, :128], a["hw"][1, :128])
    assert torch.equal(p["wout"], a["wout"]) and a["Wc"][:, 128:].any()
    torch.manual_seed(0)
    net = sDecoderNet(2, 3, hidden_dim=(128, 256))
    names = ("Wc", "bc", "Wz", "hw", "hb", "wout", "bout")
    with torch.no_grad():
        w = dict(zip(names, sd.padded_sdecoder_weights(net)))
    assert w["hw"].shape == (2, 256, 256)
    again = measure.padded_case(dict(a, **w), (128, 256))
    assert all(torch.equal(again[k], w[k]) for k in names)


def test_same_machine_code_skips_the_named_functions(monkeypatch):
    """Functions of a build that match its ``skip`` pattern are left out on
    both sides (new H = 256 kernels, instances gone), the rest compared;
    other builds are compared whole."""
    base = {"k128": ["A ;"], "kILi256E": ["B ;"], "shared": ["C ;"]}
    port = {"k128": ["A ;"], "x_cluster_kernel": ["D ;"], "shared": ["C ;"]}

    def fake_sass_all(items):
        return [dict(base) if "/base/" in p else dict(port)
                for p, _ in items]

    monkeypatch.setattr(measure, "sass_all", fake_sass_all)
    res = measure.same_machine_code(
        "/base", [("edited", ()), ("other", ())],
        {("edited", ()): fwd.H256_FUNCTIONS})
    assert res["edited"]["same"]
    assert res["edited"]["instructions"] == {"k128": [1, 1],
                                             "shared": [1, 1]}
    assert not res["other"]["same"]


def test_same_builds_are_every_production_build():
    """``--same`` compares all 20 production builds, the two bf16 sources
    without their H = 256 functions."""
    builds, skip = fwd.same_builds()
    assert len(builds) == 20 == len(set(builds))
    assert set(skip) == {(sd.FWD_SOURCES[True], ()), (sd.BWD_SOURCES[True], ())}
    assert set(builds) >= set(fwd.other_builds())


def test_cluster_sync_steps_and_refusal_without_a_card(monkeypatch, capsys):
    """The probe's steps are distinct and within the source's limits (16
    stores, 16 KB); without a card the tool says so and exits 1."""
    names = [name for name, _, _ in cluster_sync.STEPS]
    assert len(set(names)) == len(names)
    for _, mode, n in cluster_sync.STEPS:
        assert 0 <= mode <= 3 and 0 <= n <= 16
    assert cluster_sync.BLOCKS % 4 == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cluster_sync.main([]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
