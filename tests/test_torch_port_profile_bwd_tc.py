"""The measurement tools' host-side parts, on the CPU: the ptxas report and
the SASS they read, the phase counters a tile, and K2's bound that
chip_smoke.py and the bf16 K2/K3 profiling tool print beside each time."""
import pytest
import torch

from pyroved_tpu_torch.tools import measure
from pyroved_tpu_torch.tools import profile_bwd_tc as tool

KERNEL = ("_ZN58_GLOBAL__N__5c8a0529_25_spatial_decoder_bwd_tc_cu_e1aa862d18"
          "sdec_bwd_tc_kernelILi128ELi64ELi1EEEvNS_5KArgsE")
PTXAS = f"""ptxas info    : (C7519) warpgroup.arrive is injected in around line 7 by compiler to allow use of registers in GMMA in function '{KERNEL}'
ptxas info    : (C7519) warpgroup.arrive is injected in around line 9 by compiler to allow use of registers in GMMA in function '{KERNEL}'
ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized due to program dependence on compiler-inserted WG.AR in divergent path in function '{KERNEL}'
ptxas info    : Compiling entry function '{KERNEL}' for 'sm_90a'
ptxas info    : Function properties for {KERNEL}
    40 bytes stack frame, 40 bytes spill stores, 88 bytes spill loads
ptxas info    : Used 255 registers, used 16 barriers, 40 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN58_GLOBAL__N__5c8a0529_25_spatial_decoder_bwd_tc_cu_e1aa862d12sdec_tc_prepEPKfPhS2_ii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 16 registers, used 0 barriers
"""


def test_usage_reads_main_kernels_registers_spills_and_wgmma_notes():
    """Only the main kernels are reported, named by their template
    arguments: registers, spills, and each wgmma diagnostic counted."""
    out = measure.usage(PTXAS)
    assert list(out) == ["ILi128ELi64ELi1EEEvNS_5KArgsE"]
    lines = out["ILi128ELi64ELi1EEEvNS_5KArgsE"]
    assert "40 bytes stack frame, 40 bytes spill stores, 88 bytes spill " \
           "loads" in lines
    assert any(ln.startswith("Used 255 registers") for ln in lines)
    assert {"C7519": 2, "C7520": 1} in lines


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN58_GLOBAL__N__5c8a0529_12sdec_tc_prepEv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
\t\tFunction : {KERNEL}
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   STL [R1+0x4], R2 ;
        /*0020*/                   WARPGROUP.ARRIVE ;
        /*0030*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0040*/              @!P0 BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0050*/                   LDL R2, [R1+0x4] ;
        /*0060*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
        /*0070*/                   EXIT ;
""".replace("{KERNEL}", KERNEL)


def test_sass_counts_reads_main_kernels_ops(monkeypatch):
    """Each main kernel's instructions are counted by op, predicated ones
    too; other kernels are left out."""
    monkeypatch.setattr(measure, "cuobjdump", lambda path: SASS)
    out = measure.sass_counts("lib.so")
    assert out == {"ILi128ELi64ELi1EEEvNS_5KArgsE": {
        "CALL": 0, "LDL": 1, "STL": 1, "BAR": 1, "HGMMA": 1,
        "WARPGROUP.ARRIVE": 1, "WARPGROUP.DEPBAR": 1, "MUFU": 0, "FFMA": 0,
        "all": 8}}


def test_per_tile_totals_the_phases_not_the_wait_counters():
    """Cycles a tile by name; the total sums the eight phases only (the
    wait counters are parts of them)."""
    cycles = list(range(1, measure.PHASE_SLOTS + 1))
    out = measure.per_tile(cycles, tool.PHASES, 2)
    assert out["(loop)"] == 0.5 and out["issuing products"] == 5.5
    assert out["total"] == sum(range(1, measure.PHASE_MARKS + 1)) / 2


@pytest.mark.parametrize("shape", tool.SHAPES, ids=[s[0] for s in tool.SHAPES])
def test_bound_is_the_hidden_products_at_the_bf16_peak(shape):
    """K2's and K3's bf16 bound at the tool's shapes (nl tanh layers, one
    channel, 2-D): per pixel 6 nl H^2 product flops and 18 H elementwise
    ones at 989 TFLOP/s, above the bytes at 3.35 TB/s; the f32 bound at
    67 TFLOP/s."""
    _, B, N, L, H, nl, _ = shape
    a = {k: torch.empty(s, device="meta") for k, s in dict(
        grid=(N, 2), phi=(B,), dx=(B, 2), sc=(B,), z=(B, L), Wc=(2, H),
        bc=(H,), Wz=(L, H), hw=(nl, H, H), hb=(nl, H), wout=(H, 1),
        bout=(1,)).items()}
    flops = B * N * (6 * nl * H * H + 18 * H)
    for loss in (False, True):
        got_flops, nbytes = measure.work_bwd(a, loss_mode=loss)
        assert got_flops == flops
        assert nbytes / 3.35e12 < flops / 989e12
        f32, bf16, by32, by16 = measure.bounds(got_flops, nbytes,
                                               measure.PEAKS)
        assert bf16 == pytest.approx(1e3 * flops / 989e12, rel=1e-12)
        assert f32 == pytest.approx(1e3 * flops / 67e12, rel=1e-12)
        assert by32 == by16 == "operations"
