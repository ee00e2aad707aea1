"""The tensor-core K1's A/B tool (``tools/profile_fwd_tc.py``) on the CPU:
its shapes, the tiles of block 0's warpgroups, what it reads of the ptxas
report and the SASS of the K1 kernels, the SFU floor it prints beside
each time, the baseline's wrapper it loads beside an earlier ``csrc``,
and its comparison of the other sources' machine code."""
import shutil

import pytest
import torch

from pyroved_tpu_torch.ops import spatial_decoder as sd
from pyroved_tpu_torch.tools import measure
from pyroved_tpu_torch.tools import profile_fwd_tc as tool

KERNEL = ("_ZN61_GLOBAL__N__7f1e2a33_27_spatial_decoder_fwd_tc_cu_5b0c2d9e18"
          "sdec_fwd_tc_kernelILi128ELi0EEEvNS_5KArgsE")
PROBE = ("_ZN61_GLOBAL__N__7f1e2a33_27_spatial_decoder_fwd_tc_cu_5b0c2d9e17"
         "tanh_probe_kernelEPKfPfx")
PTXAS = f"""ptxas info    : Compiling entry function '{PROBE}' for 'sm_90a'
ptxas info    : Function properties for {PROBE}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 14 registers, used 0 barriers
ptxas info    : Compiling entry function '{KERNEL}' for 'sm_90a'
ptxas info    : Function properties for {KERNEL}
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 16 barriers, 32 bytes cumulative stack size
"""
SASS = f"""
\t\tFunction : {PROBE}
        /*0000*/                   MUFU.EX2 R3, R2 ;
\t\tFunction : {KERNEL}
        /*0000*/                   FFMA R4, R4, 2.8853900432586669922, R5 ;
        /*0010*/                   MUFU.EX2 R6, R4 ;
        /*0020*/                   FADD R6, R6, 1 ;
        /*0030*/                   MUFU.RCP R7, R6 ;
        /*0040*/              @!P0 FFMA R7, R7, -2, 1 ;
        /*0050*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0060*/                   EXIT ;
"""


def test_shapes_are_perf_mds_nine_and_h256():
    """The nine K1 shapes of PERF.md section 6 (two layers, one channel;
    L = 12 for the enumerated rows), then H = 256 at the flagship's
    training shape with two and five layers, and a (128, 256) decoder
    padded to 256; the marks take some of them."""
    assert [s[1:] for s in tool.SHAPES] == [
        (1024, 784, 2, 128, 2, None), (200, 784, 2, 128, 2, None),
        (452, 784, 2, 128, 2, None), (64, 16384, 2, 128, 2, None),
        (2000, 784, 12, 128, 2, None), (50, 784, 2, 128, 2, None),
        (600, 784, 12, 128, 2, None), (200, 16384, 2, 128, 2, None),
        (200, 131072, 2, 128, 2, None), (200, 784, 2, 256, 2, None),
        (200, 784, 2, 256, 5, None), (200, 784, 2, 256, 2, (128, 256))]
    assert set(tool.MARK_SHAPES) <= set(tool.SHAPES)


@pytest.mark.parametrize("B,N,H,first", [(1024, 784, 128, 25),
                                         (50, 784, 128, 1),
                                         (200, 784, 128, 4)])
def test_warpgroup_tiles_split_the_tile_list(B, N, H, first):
    """Block 0's first warpgroup takes floor(T / W) tiles (B = 1024: 100.8
    tiles an SM of four warpgroups); over every warpgroup the contiguous
    runs cover the T tiles once."""
    sms = 132
    tile = 64
    total = B * -(-N // tile)
    assert tool.warpgroup_tiles(B, N, H, 0, sms) == first
    w = min(-(-total // tool.warpgroups(H)), sms) * tool.warpgroups(H)
    runs = [tool.warpgroup_tiles(B, N, H, g, sms) for g in range(w)]
    assert sum(runs) == total and max(runs) - min(runs) <= 1


def test_usage_reads_the_k1_kernel_not_the_probe():
    """The widened regex takes K1's main kernel by its template arguments
    (H, activation) and leaves the tanh probe out."""
    out = measure.usage(PTXAS)
    assert list(out) == ["ILi128ELi0EEEvNS_5KArgsE"]
    assert "Used 128 registers, used 16 barriers, 32 bytes cumulative " \
           "stack size" in out["ILi128ELi0EEEvNS_5KArgsE"]


def test_sass_counts_k1_mufu_and_ffma(monkeypatch):
    """K1's MUFU and FFMA instructions (predicated ones too) are counted;
    the probe kernel is not."""
    monkeypatch.setattr(measure, "cuobjdump", lambda path: SASS)
    out = measure.sass_counts("lib.so")
    assert list(out) == ["ILi128ELi0EEEvNS_5KArgsE"]
    counts = out["ILi128ELi0EEEvNS_5KArgsE"]
    assert (counts["MUFU"], counts["FFMA"], counts["HGMMA"], counts["all"]) \
        == (2, 2, 1, 7)


@pytest.mark.parametrize("B,N,floor", [
    (1024, 784, 0.147), (200, 784, 0.029), (452, 784, 0.065),
    (64, 16384, 0.193), (2000, 784, 0.288), (50, 784, 0.007),
    (600, 784, 0.086), (200, 16384, 0.602), (200, 131072, 4.814)])
def test_sfu_floor_at_the_nine_shapes(B, N, floor):
    """Two MUFU operations for each of 3 H activations a pixel, 16 a clock
    an SM, 132 SMs, 1.98 GHz: the floor of an exact tanh's epilogues."""
    assert round(measure.sfu_floor_ms(B, N, 128, 2), 3) == floor


def test_work_fwd_counts_every_input_once():
    """K1's flops (coordinate layer, hidden products, head) and bytes
    (every input read once, the output written once)."""
    B, N, D, H, L, nl, C = 3, 5, 2, 128, 4, 2, 1
    shapes = dict(grid=(N, D), phi=(B,), dx=(B, D), sc=(B,), z=(B, L),
                  Wc=(D, H), bc=(H,), Wz=(L, H), hw=(nl, H, H), hb=(nl, H),
                  wout=(H, C), bout=(C,))
    a = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    flops, nbytes = measure.work_fwd(a)
    assert flops == B * N * (2 * D * H + 2 * nl * H * H + 2 * C * H)
    assert nbytes == 4 * (sum(torch.Size(s).numel() for s in shapes.values())
                          + B * N * C)


def test_baseline_module_is_the_wrapper_beside_csrc(tmp_path):
    """An earlier tree's wrapper loads as a module of its own (its
    relative imports resolved to the port's), which ``bound`` binds a
    library into and restores; a csrc with no wrapper beside it gives
    None."""
    ops = tmp_path / "pyroved_tpu_torch" / "ops"
    ops.mkdir(parents=True)
    (tmp_path / "pyroved_tpu_torch" / "csrc").mkdir()
    shutil.copy(sd.__file__, ops / "spatial_decoder.py")
    mod = tool.baseline_module(str(tmp_path / "pyroved_tpu_torch" / "csrc"))
    assert mod is not sd and mod.__file__ != sd.__file__
    assert mod.FWD_SOURCES == sd.FWD_SOURCES
    lib = object()
    mod._bind_fwd = lambda lib_, bf16: ("bound", lib_, bf16)
    with tool.bound(mod, lib) as k1:
        assert k1 is mod.fused_spatial_decoder_forward
        assert mod._fwd_fns[True] == ("bound", lib, True)
    assert mod._fwd_fns == {}
    assert tool.baseline_module(str(tmp_path / "csrc")) is None


def test_first_difference_points_at_the_first_differing_line():
    """The line index and both lines where two listings first differ;
    None past the shorter one's end; None where they are equal."""
    old = ["FFMA R1, R2, R3, R4 ;", "MUFU.EX2 R5, R1 ;", "EXIT ;"]
    assert measure.first_difference(old, list(old)) is None
    assert measure.first_difference(old, old[:1] + ["FADD R5, R1, 1 ;"]
                                    + old[2:]) == [1, old[1],
                                                   "FADD R5, R1, 1 ;"]
    assert measure.first_difference(old, old[:2]) == [2, "EXIT ;", None]


def test_same_machine_code_keys_builds_and_marks_the_differing(monkeypatch):
    """Each (name, defines) is compiled from the baseline and the port
    (baseline first), all at once; a build whose sides differ there is
    compiled again alone, side by side, and that decides: a difference
    that goes away is the same machine code, one that stays names its
    first differing line, which :func:`profile_fwd_tc.changed` reports."""
    calls = []
    k, swapped = ["A ;", "B ;"], ["A ;", "C ;"]
    alone = {"/base/src_b.cu": {"k": k}, "/base/src_c.cu": {"k": k}}

    def fake_sass_all(items):
        calls.append(items)
        if len(items) == 1:  # alone: the baseline's, else the port's
            return [alone.get(items[0][0], {"k": k, "p": ["D ;"]}
                              if "src_c" in items[0][0] else {"k": k})]
        return [{"k": k}, {"k": k}, {"k": k}, {"k": swapped},
                {"k": k}, {"k": swapped, "p": ["D ;"]}]

    monkeypatch.setattr(measure, "sass_all", fake_sass_all)
    builds = [("src_a", ()), ("src_b", ("PVT_ABLATE=0",)), ("src_c", ())]
    res = measure.same_machine_code("/base", builds)
    assert [(p.split("/")[-1], d) for p, d in calls[0]] == [
        ("src_a.cu", ()), ("src_a.cu", ()), ("src_b.cu", ("PVT_ABLATE=0",)),
        ("src_b.cu", ("PVT_ABLATE=0",)), ("src_c.cu", ()), ("src_c.cu", ())]
    assert calls[0][0][0] == "/base/src_a.cu" != calls[0][1][0]
    assert calls[1:] == [[calls[0][2]], [calls[0][3]], [calls[0][4]],
                         [calls[0][5]]]
    assert res["src_a"] == {"same": True, "alone": False,
                            "instructions": {"k": [2, 2]}, "differs": {}}
    assert res["src_b PVT_ABLATE=0"] == {
        "same": True, "alone": True, "instructions": {"k": [2, 2]},
        "differs": {}}
    c = res["src_c"]
    assert not c["same"] and c["alone"]
    assert c["instructions"] == {"k": [2, 2], "p": [0, 1]}
    assert c["differs"] == {"p": [0, None, "D ;"]}
    assert tool.changed(res) == ["src_c"]


def test_other_builds_are_every_other_production_build():
    """Both K2/K3 sources and the f32 K1 plain, and each K2/K3 source's
    eight K4 builds: 19, none of them the bf16 K1."""
    builds = tool.other_builds()
    assert len(builds) == 3 + 2 * 8 == len(set(builds))
    assert sd.FWD_SOURCES[True] not in {n for n, _ in builds}
    assert (sd.FWD_SOURCES[False], ()) in builds
