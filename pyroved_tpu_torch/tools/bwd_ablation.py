"""Split K2's time on the card by ablation: K4's eight modes timed.

Counterpart of ``benchmarks/bwd_ablation.py``'s ``time_variant`` and
``main``. Run from the repository root on a machine with one Hopper GPU:

    python3 -m pyroved_tpu_torch.tools.bwd_ablation [--B 200] [--N 784]
        [--H 128] [--layers 2] [--b-t 40] [--n-t 128] [--f32]
        [--baseline DIR]

Builds the eight ablation libraries of the flag's K2 source
(``csrc/spatial_decoder_bwd_tc.cu``, or with ``--f32``
``csrc/spatial_decoder_bwd_x3.cu``; one ``nvcc`` each, together), makes
``time_variant``'s inputs (numpy seed 0, normal draws x 0.1, ``sc = 1 +
...``; L = 4) at the padded size of the logical tiles (``--b-t``/``--n-t``,
default 40/128, JAX's choice at the flagship), and times each mode as a
chain of :data:`CHAIN_LEN` launches in which ``z <- z + 1e-9 dz`` (CUDA
events, after a warm-up chain), beside the device's busy time a call
(``torch.profiler``, 50 launches) and the host's time to enqueue one.
Prints microseconds a call per mode, then
the attribution lines of the JAX harness, each beside what it asks of the
Hopper kernel (:data:`MEANING`). ``--baseline DIR`` first compares the
production K2 libraries' machine code (``cuobjdump -sass``, function by
function) with those of the sources in DIR (an earlier ``csrc``). Raises
without a Hopper card.
"""
import argparse
import json
import os
import re
import sys
import time

import numpy as np
import torch

from ..ops import bwd_ablation as ab
from ..ops import spatial_decoder as sd
from .measure import bf16_matmul, card_info, card_peaks

CHAIN_LEN = 200

#: What each mode asks of the Hopper kernel.
MEANING = {
    "dma_floor": "K2's floor: its blocks walking its tiles, reading each "
                 "tile's inputs, one add, then K2's two reductions",
    "fwd_noact": "the recompute with identity activations",
    "fwd_remat": "the forward recompute's share of K2",
    "no_breduce": "the per-sample du/dv vectors' share (the K2 epilogue "
                  "item)",
    "full": "the production backward at C = 1, sigmoid head: K2",
    "full_dg": "one kernel body with full (wgmma reads either major order: "
               "no transpose to strip); the difference is noise",
    "mxu_dwout": "dwout on wgmma in place of CUDA-core partials and "
                 "shuffles",
    "mxu_dhb": "db_l on wgmma (d_pre^T ones) in place of CUDA-core "
               "partials and shuffles",
}


def inputs(B, N, H, L, n_layers, b_t, n_t, device="cuda", seed=0):
    """``time_variant``'s inputs at the padded size (B and N rounded up to
    the tiles), in K2's shapes, on ``device``."""
    Bp, Np = -(-B // b_t) * b_t, -(-N // n_t) * n_t
    rng = np.random.default_rng(seed)

    def mk(*s):
        return (rng.normal(size=s) * 0.1).astype(np.float32)

    grid = mk(Np, 2)
    phi, sc = mk(Bp), 1.0 + mk(Bp)
    dx, z = mk(Bp, 2), mk(Bp, L)
    Wc, bc, Wz = mk(2, H), mk(H), mk(L, H)
    hw, hb = mk(n_layers, H, H), mk(n_layers, H)
    wout, bout = mk(H, 1), mk(1)
    g = mk(Bp, Np)
    names = ("grid", "phi", "dx", "sc", "z", "Wc", "bc", "Wz", "hw", "hb",
             "wout", "bout", "g")
    arrays = (grid, phi, dx, sc, z, Wc, bc, Wz, hw, hb, wout, bout, g)
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32),
                               device=device) for k, v in zip(names, arrays)}


def _bound_chain(mode, a, n_layers, b_t, n_t):
    """A launcher of ``mode`` on ``a`` with a z of its own, and one step of
    the chain: a launch, then ``z <- z + 1e-9 dz``."""
    z = a["z"].clone()
    launch, out = ab.bind(mode, **dict(a, z=z), n_layers=n_layers, b_t=b_t,
                          n_t=n_t)
    dz = out[3]

    def step():
        launch()
        z.add_(dz, alpha=1e-9)
    return step


def chain_ms(mode, a, n_layers, b_t, n_t, chain=CHAIN_LEN):
    """(ms, host ms) a call of ``mode`` in a chain of ``chain`` launches on
    ``a`` (:func:`inputs`), each feeding ``z + 1e-9 dz`` to the next, timed
    by CUDA events after a warm-up chain of up to 20; the host's time to
    enqueue the chain, a call, says whether the host set the pace."""
    step = _bound_chain(mode, a, n_layers, b_t, n_t)
    for _ in range(min(chain, 20)):
        step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(chain):
        step()
    end.record()
    host = time.perf_counter() - t0
    end.synchronize()
    return start.elapsed_time(end) / chain, 1e3 * host / chain


def busy_ms(mode, a, n_layers, b_t, n_t, n=50):
    """The device's busy time a call of the chain, ms: its kernels' device
    times (``torch.profiler``) over ``n`` chained launches, z's update
    included, over ``n``; below :func:`chain_ms` where the host set the
    pace."""
    step = _bound_chain(mode, a, n_layers, b_t, n_t)
    step()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0.0)
             for ev in prof.key_averages())
    return us / 1e3 / n


def work(mode, a, bf16):
    """(flops, bytes) one call of ``mode`` needs: the hidden products of
    the mode on every padded pixel (the f32 kernel makes each as six bf16
    products), every input read once and every output written once."""
    B, N = a["g"].shape
    nl, H = a["hw"].shape[:2]
    per_pixel = {"dma_floor": 0, "fwd_noact": 2 * nl * H * H,
                 "fwd_remat": 2 * nl * H * H,
                 "mxu_dwout": 6 * nl * H * H + 2 * H,
                 "mxu_dhb": 6 * nl * H * H + 2 * nl * H}.get(
                     mode, 6 * nl * H * H)
    flops = B * N * per_pixel * (1 if bf16 else 6)
    inputs = sum(t.numel() for t in a.values())
    outputs = inputs - a["grid"].numel() - a["g"].numel()
    return flops, 4 * (inputs + outputs)


def bound_ms(mode, a, bf16, peaks):
    """(ms, what bounds it): the least time the card could take for
    :func:`work` at the bf16 tensor-core peak and the HBM rate."""
    flops, nbytes = work(mode, a, bf16)
    ops, mem = flops / peaks[1], nbytes / peaks[2]
    return 1e3 * max(ops, mem), "operations" if ops >= mem else "bytes"


def library_ms(mode, a, bf16, reps=10):
    """cuBLAS's bare products of ``mode`` (bf16, or f32 with TF32 off) on
    matrices of K2's shapes, ms; None for dma_floor, which has none."""
    if mode == "dma_floor":
        return None
    from .measure import cuda_ms
    B, N = a["g"].shape
    nl, H = a["hw"].shape[:2]
    dtype = torch.bfloat16 if bf16 else torch.float32
    gen = torch.Generator(device=a["g"].device).manual_seed(0)
    h = torch.randn(B * N, H, generator=gen, device=a["g"].device).to(dtype)
    d = torch.randn(B * N, H, generator=gen, device=a["g"].device).to(dtype)
    col = torch.ones(B * N, 1, device=a["g"].device, dtype=dtype)
    w = a["hw"].to(dtype)

    def products():
        for i in range(nl):
            torch.matmul(h, w[i])
            if mode in ("fwd_remat", "fwd_noact"):
                continue
            torch.matmul(h.T, d)
            torch.matmul(d, w[i].T)
            if mode == "mxu_dhb":
                torch.matmul(d.T, col)
        if mode == "mxu_dwout":
            torch.matmul(h.T, col)

    ms = cuda_ms(products, reps=reps)
    del h, d, col
    return ms


def kernel_usage(log):
    """{"H=128 R=64": "255 registers, 0 bytes spill stores", ...} of the
    main kernel's instantiations, from a build's ptxas report."""
    out, name, spill = {}, None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spill = m.group(1), ""
        elif "spill stores" in ln:
            spill = ln.split(",")[1].strip()
        elif "Used" in ln and "registers" in ln and name and (
                "sdec_bwd_tc_kernel" in name or "sdec_bwd_x3_kernel" in name):
            hr = re.search(r"ILi(\d+)ELi(\d+)E", name)
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out[f"H={hr.group(1)} R={hr.group(2)}"] = (f"{regs} registers, "
                                                      f"{spill}")
    return out


def attribution(t):
    """The JAX harness's attribution lines from {mode: us}, each with its
    Hopper meaning."""
    rows = [
        ("DMA + grid overhead floor ", t["dma_floor"], "",
         MEANING["dma_floor"]),
        ("fwd recompute (remat)     ", t["fwd_remat"],
         f" (tanh part {t['fwd_remat'] - t['fwd_noact']:+.1f})",
         MEANING["fwd_remat"] + "; the tanh part is exact tanhf's share "
         "(the K1 item)"),
        ("backprop half             ", t["full"] - t["fwd_remat"], "",
         "K2 beyond its recompute: head, dW and dh products, epilogues, "
         "reductions"),
        ("per-batch reduce loop     ", t["full"] - t["no_breduce"], "",
         MEANING["no_breduce"]),
        ("transpose-free dot_general", t["full_dg"],
         f" ({t['full'] - t['full_dg']:+.1f} vs full)", MEANING["full_dg"]),
        ("dwout on MXU              ", t["mxu_dwout"],
         f" ({t['full'] - t['mxu_dwout']:+.1f} vs full; positive = the "
         f"MXU form saves VPU time)", MEANING["mxu_dwout"]),
        ("dhb on MXU (ones^T @ dpre)", t["mxu_dhb"],
         f" ({t['full'] - t['mxu_dhb']:+.1f} vs full)", MEANING["mxu_dhb"]),
    ]
    return [f"  {name}: {us:8.1f} us{extra}  -- Hopper: {meaning}"
            for name, us, extra, meaning in rows]


def same_machine_code(base_dir):
    """{source: True/False} for the two production K2/K3 sources: whether
    the build of ``base_dir``'s copy has the port's machine code, function
    by function."""
    from .profile_f32 import sass
    from ..ops import _build
    out = {}
    for name in sd.BWD_SOURCES.values():
        old = sass(os.path.join(os.path.abspath(base_dir), name + ".cu"))
        new = sass(os.path.join(_build.CSRC, name + ".cu"))
        out[name] = old == new
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=200)
    ap.add_argument("--N", type=int, default=784)
    ap.add_argument("--H", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--b-t", type=int, default=40)
    ap.add_argument("--n-t", type=int, default=128)
    ap.add_argument("--f32", action="store_true",
                    help="the f32 source (BF16_MATMUL = False)")
    ap.add_argument("--baseline", help="a directory of earlier K2 sources "
                    "whose production builds must have the port's machine "
                    "code")
    args = ap.parse_args(argv)
    if not (torch.cuda.is_available() and ab.on_hopper("cuda")):
        raise RuntimeError("bwd_ablation needs a Hopper card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_info()
    print(card, flush=True)
    peaks = card_peaks(card)
    if args.baseline:
        same = same_machine_code(args.baseline)
        print(f"production machine code equal to {args.baseline}'s: "
              f"{json.dumps(same)}", flush=True)
        if not all(same.values()):
            raise AssertionError("a production K2 library's machine code "
                                 "changed")
    bf16 = not args.f32
    t0 = time.perf_counter()
    ab.load_all(flags=(bf16,))
    print(f"built the eight libraries of {sd.BWD_SOURCES[bf16]} in "
          f"{time.perf_counter() - t0:.1f} s; main kernels' ptxas usage:",
          flush=True)
    from ..ops import _build
    for mode in ab.MODES:
        usage = kernel_usage(_build.build_log(sd.BWD_SOURCES[bf16],
                                              ab.defines(mode)))
        print(f"  {mode}: {json.dumps(usage)}", flush=True)
    L = 4
    a = inputs(args.B, args.N, args.H, L, args.layers, args.b_t, args.n_t)
    print(f"backward ablation at B={args.B} N={args.N} H={args.H} "
          f"nl={args.layers} (chain {CHAIN_LEN}), "
          f"{'bf16' if bf16 else 'f32'} products, padded to "
          f"B={a['g'].shape[0]} N={a['g'].shape[1]}:", flush=True)
    t = {}
    with bf16_matmul(bf16):
        for mode in ab.MODES:
            ms, host = chain_ms(mode, a, args.layers, args.b_t, args.n_t)
            busy = busy_ms(mode, a, args.layers, args.b_t, args.n_t)
            t[mode] = 1e3 * ms
            b, by = bound_ms(mode, a, bf16, peaks)
            print(f"  {mode:10s} {t[mode]:8.1f} us/call  (tiles ({args.b_t},"
                  f"{args.n_t})); device busy {1e3 * busy:.1f} us/call, host "
                  f"{1e3 * host:.1f} us/call, bound {1e3 * b:.1f} us ({by})",
                  flush=True)
    print("\nattribution:")
    for line in attribution(t):
        print(line)
    print(json.dumps({"us": t, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
