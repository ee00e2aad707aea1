"""What the port's measurement scripts share (``chip_smoke.py`` and the
tools of :mod:`pyroved_tpu_torch.tools`): the flag and the plain versions
swapped in for a block, the training data, random kernel inputs, CUDA-event
timing, the card's name and its data-sheet peaks, K2's work and bounds,
cuBLAS's bare products; and for the tools, builds of sources outside the
port's ``csrc``, a library bound in the port's place, the phase marks, and
what ptxas and ``cuobjdump`` say of a build."""
import contextlib
import ctypes
import hashlib
import os
import re
import statistics
import subprocess

import numpy as np
import torch

from ..ops import _build
from ..ops import spatial_decoder as sd

# Data-sheet peaks (dense) of the H100 SXM5, the part nvidia-smi names
# "NVIDIA H100 80GB HBM3": f32 on the CUDA cores, bf16 on the tensor cores,
# HBM bandwidth. Other cards have no row: their bounds would be wrong.
H100_SXM = "H100 80GB HBM3"
PEAKS = (67e12, 989e12, 3.35e12)  # (f32 flop/s, bf16 flop/s, bytes/s)
# The same card's special-function units: 16 MUFU operations a clock an SM
# (CUDA's throughput table, compute capability 9.0), 132 SMs, at the
# 1.98 GHz boost clock.
SFU_OPS = 16 * 132 * 1.98e9  # MUFU operations a second


def card_peaks(name):
    """:data:`PEAKS` for a card ``nvidia-smi`` names ``name``, or raise."""
    if H100_SXM not in name:
        raise RuntimeError(f"no data-sheet peaks for card {name!r}")
    return PEAKS


def card_info():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


@contextlib.contextmanager
def plain_versions():
    """The K1, K2 and K3 wrappers replaced by their plain versions inside
    the block, also on CUDA tensors: the kernels' yardstick, never the
    port's path."""
    names = {"fused_spatial_decoder_forward": sd.spatial_decoder_plain,
             "fused_spatial_decoder_backward": sd.spatial_decoder_bwd_plain,
             "fused_bernoulli_recon_loss_kernel": sd.recon_loss_plain}
    old = {n: getattr(sd, n) for n in names}
    for n, f in names.items():
        setattr(sd, n, f)
    try:
        yield
    finally:
        for n, f in old.items():
            setattr(sd, n, f)


@contextlib.contextmanager
def bf16_matmul(on):
    """The port's BF16_MATMUL flag set to ``on`` inside the block."""
    old = sd.BF16_MATMUL
    sd.BF16_MATMUL = on
    try:
        yield
    finally:
        sd.BF16_MATMUL = old


def blobs(n, dim, seed, centers=False):
    """MNIST-like oriented Gaussian bumps (bench.py's data); with
    ``centers``, also each bump's x centre in [-0.4, 0.4] (the labels of
    the semi-supervised runs)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, dim[0]),
                         np.linspace(-1, 1, dim[1]), indexing="ij")
    cx = rng.uniform(-0.4, 0.4, n)[:, None, None]
    cy = rng.uniform(-0.4, 0.4, n)[:, None, None]
    s = rng.uniform(0.05, 0.2, n)[:, None, None]
    X = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / s).astype(np.float32)
    return (X, cx.ravel().astype(np.float32)) if centers else X


def cuda_ms(fn, reps=25, warmup=3):
    """Median of per-call CUDA-event timings after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_queued(fn, n=20, reps=5, warmup=3):
    """Median over ``reps`` of the CUDA-event time of ``n`` back-to-back
    calls, over ``n``: the host queues launches ahead of the device, so a
    kernel longer than its wrapper's host work is timed alone."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def random_case(rng, dev, D, C, H, B, N, L, nl):
    """Random decoder inputs (shapes as ``spatial_decoder_plain``) from the
    numpy generator ``rng``, on ``dev``: D coordinate dims, C channels,
    width H, B samples, N pixels, L latents, nl hidden layers."""
    t = lambda *s, k=1.0: torch.as_tensor(  # noqa: E731
        rng.normal(size=s) * k, dtype=torch.float32, device=dev)
    return dict(grid=torch.as_tensor(rng.uniform(-1, 1, (N, D)),
                                     dtype=torch.float32, device=dev),
                phi=t(B), dx=t(B, D, k=0.1), sc=1 + t(B, k=0.1), z=t(B, L),
                Wc=t(D, H, k=0.5), bc=t(H, k=0.1), Wz=t(L, H, k=0.5),
                hw=t(nl, H, H, k=1.5 / H ** 0.5), hb=t(nl, H, k=0.1),
                wout=t(H, C, k=1.0 / H ** 0.5), bout=t(C, k=0.1))


def padded_case(a, hidden):
    """Kernel inputs ``a`` (width H) made those of a decoder with hidden
    widths ``hidden`` zero-padded to H, as ``padded_sdecoder_weights``
    pads them: level 0 and hidden layer l's output keep ``hidden[0]`` and
    ``hidden[l]`` units, every weight into or out of a padded unit and
    its bias zero. Returns a new dict; ``a`` is left as it is."""
    out = {k: v.clone() for k, v in a.items()}
    widths = (hidden[0],) + tuple(hidden)  # levels 0 .. nl
    out["Wc"][:, widths[0]:] = 0
    out["bc"][widths[0]:] = 0
    out["Wz"][:, widths[0]:] = 0
    for i in range(out["hw"].shape[0]):
        out["hw"][i, widths[i]:, :] = 0
        out["hw"][i, :, widths[i + 1]:] = 0
        out["hb"][i, widths[i + 1]:] = 0
    out["wout"][widths[-1]:, :] = 0
    return out


def row_chunks(a, chunks):
    """Kernel inputs ``a`` cut into ``chunks`` equal row chunks of the
    batch (the per-sample inputs split, the grid and weights shared)."""
    B = a["z"].shape[0]
    step = B // chunks
    return [{k: (v[i:i + step] if k in ("phi", "dx", "sc", "z") else v)
             for k, v in a.items()} for i in range(0, B, step)]


def sfu_floor_ms(B, N, H, nl, mufu=2):
    """The least time of K1's activations on the special-function units,
    ms: h0 and nl hidden layers of width H for B N pixels, ``mufu``
    operations each (tanhf and the tensor-core K1's tanh_exp2: MUFU.EX2 and
    MUFU.RCP), at :data:`SFU_OPS`."""
    return 1e3 * B * N * (nl + 1) * H * mufu / SFU_OPS


def k2_inputs(B, N, L, seed, H=128):
    """K2's and K3's random inputs at one shape (two tanh layers of width
    ``H``): the decoder's inputs, a cotangent, observations and weights."""
    a = random_case(np.random.default_rng(seed), "cuda", 2, 1, H, B, N, L, 2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(B, N, generator=gen, device="cuda")
    x = torch.rand(B, N, generator=gen, device="cuda")
    w = torch.rand(B, generator=gen, device="cuda")
    return a, g, x, w


def work_fwd(a):
    """(flops, bytes) one K1 call needs: per pixel the coordinate layer,
    nl H x H layers and the head; every input read once, the output written
    once."""
    N, D = a["grid"].shape
    B = a["z"].shape[0]
    H = a["Wc"].shape[1]
    nl = a["hw"].shape[0]
    C = a["wout"].shape[1]
    flops = B * N * (2 * D * H + nl * 2 * H * H + 2 * C * H)
    nbytes = 4 * (sum(t.numel() for t in a.values()) + B * N * C)
    return flops, nbytes


def work_bwd(a, loss_mode=False):
    """(flops, bytes) one K2 (or K3) call needs: per pixel the forward
    recompute (h0, nl H x H layers, head) and the backward (head, dW and dh
    of each layer, the du/dv/dw sums); every input read once (with the
    cotangent, or x and the weights), every grad written once."""
    N, D = a["grid"].shape
    B = a["z"].shape[0]
    H = a["Wc"].shape[1]
    nl = a["hw"].shape[0]
    C = a["wout"].shape[1]
    flops = B * N * (6 * nl * H * H + 2 * (D + 1) * H + 6 * C * H + 6 * H)
    inputs = sum(t.numel() for t in a.values())
    grads = inputs - a["grid"].numel()
    extra = B * N + B if loss_mode else B * N * C
    return flops, 4 * (inputs + grads + extra)


def bounds(flops, nbytes, peaks):
    """(f32 bound, bf16 bound, what bounds f32, what bounds bf16), ms."""
    peak_f32, peak_bf16, peak_bw = peaks
    by = lambda peak: ("operations" if flops / peak >= nbytes / peak_bw  # noqa: E731
                       else "bytes")
    return (1e3 * max(flops / peak_f32, nbytes / peak_bw),
            1e3 * max(flops / peak_bf16, nbytes / peak_bw),
            by(peak_f32), by(peak_bf16))


def cublas_ms(B, N, H=128, dtype=torch.float32, chunks=1, nl=2):
    """cuBLAS's time for the bare products of one K2 call's hidden layers
    (``nl`` of width ``H``, operands in ``dtype``; f32 with TF32 as the
    caller set it): h W, h^T d and d W^T a layer, over ``chunks`` row
    chunks."""
    rows = B * N // chunks
    h = torch.randn(rows, H, device="cuda").to(dtype)
    d = torch.randn(rows, H, device="cuda").to(dtype)
    w = torch.randn(nl, H, H, device="cuda").to(dtype)

    def products():
        for i in range(nl):
            torch.matmul(h, w[i])
            torch.matmul(h.T, d)
            torch.matmul(d, w[i].T)

    return chunks * cuda_ms(products, reps=5 if chunks > 1 else 20)


def cublas_fwd_ms(B, N, H=128, nl=2, dtype=torch.bfloat16, chunks=1):
    """cuBLAS's time for the bare products of one K1 call's hidden layers:
    h W_l for each of ``nl`` layers of width ``H`` on B N rows, operands
    and output in ``dtype``, over ``chunks`` row chunks."""
    h = torch.randn(B * N // chunks, H, device="cuda").to(dtype)
    w = torch.randn(nl, H, H, device="cuda").to(dtype)
    return chunks * cuda_ms(lambda: [torch.matmul(h, w[i])
                                     for i in range(nl)],
                            reps=5 if chunks > 1 else 20)


def start_build(path, defines=()):
    """Start building ``path`` (a source outside the port's ``csrc``, with
    its headers beside it) as the port builds a source, into the build
    directory under a name of its own: (the ``nvcc`` process, or None where
    the library is already there, the library's path)."""
    with open(path, "rb") as f:
        text = f.read()
    cmd = " ".join(_build.nvcc_command(path, "OUT", defines)).encode()
    digest = hashlib.sha256(text + b"\0" + cmd).hexdigest()[:16]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    name = os.path.splitext(os.path.basename(path))[0]
    lib = os.path.join(_build.BUILD_DIR, f"ext-{name}-{digest}.so")
    if os.path.exists(lib):
        return None, lib
    return subprocess.Popen(_build.nvcc_command(path, lib, defines),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def finish_build(proc, lib):
    """The loaded library of :func:`start_build` and its build's log."""
    if proc is not None:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({lib}):\n{log}")
        with open(lib + ".log", "w") as f:
            f.write(log)
    with open(lib + ".log") as f:
        return ctypes.CDLL(lib), f.read()


def build(path, defines=()):
    """``path`` built (:func:`start_build`) and loaded: the library and its
    build's log."""
    return finish_build(*start_build(path, defines))


@contextlib.contextmanager
def bound_bwd(lib, entry, bf16):
    """``lib`` (entry points ``entry`` and ``entry + "_plan"``) bound as
    the K2/K3 of the flag value ``bf16`` inside the block."""
    saved = dict(sd._bwd_fns)
    sd._bwd_fns[bf16] = sd._bind_bwd(lib, entry)
    sd._bwd_plan.cache_clear()
    try:
        yield
    finally:
        sd._bwd_fns.clear()
        sd._bwd_fns.update(saved)
        sd._bwd_plan.cache_clear()


@contextlib.contextmanager
def bound_fwd(lib, bf16):
    """``lib`` bound as the K1 of the flag value ``bf16`` inside the
    block."""
    saved = dict(sd._fwd_fns)
    sd._fwd_fns[bf16] = sd._bind_fwd(lib, bf16)
    try:
        yield
    finally:
        sd._fwd_fns.clear()
        sd._fwd_fns.update(saved)


#: The phase counters of a profiled build (``csrc/sm90_common.cuh``):
#: per warpgroup, the phases that marks 0-7 close, then the cycles in
#: barriers, in wgmma waits, issuing products and waiting on the other
#: blocks of a cluster.
PHASE_GROUPS, PHASE_MARKS, PHASE_SLOTS = 4, 8, 12


def phase_cycles(lib, reader, fn):
    """[warpgroup][counter] of one call of ``fn`` (after a warm call) in
    the profiled build ``lib``, whose entry point ``reader`` reads the
    counters (``PVT_PHASE_READER``)."""
    read = getattr(lib, reader)
    read.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    read.restype = ctypes.c_int
    cycles = (ctypes.c_longlong * (PHASE_GROUPS * PHASE_SLOTS))()
    fn()
    torch.cuda.synchronize()
    if read(cycles, 1) != 0:
        raise RuntimeError("resetting the phase cycles failed")
    fn()
    torch.cuda.synchronize()
    if read(cycles, 0) != 0:
        raise RuntimeError("reading the phase cycles failed")
    return [list(cycles[g * PHASE_SLOTS:(g + 1) * PHASE_SLOTS])
            for g in range(PHASE_GROUPS)]


def per_tile(cycles, names, tiles):
    """{name: cycles a tile} of the counters ``cycles`` named by ``names``
    in order, and "total", the sum of the first :data:`PHASE_MARKS`."""
    out = {name: round(cycles[k] / tiles, 1) for k, name in enumerate(names)}
    out["total"] = round(sum(cycles[:min(len(names), PHASE_MARKS)]) / tiles,
                         1)
    return out


#: The main kernels of the K1 and K2/K3 sources, by their mangled names.
MAIN_KERNELS = r"sdec_(?:fwd|bwd)_(?:tc|x3)(?:_cluster)?_kernel"


def usage(log, kernels=MAIN_KERNELS):
    """{main kernel: its registers and spills, and how many times ptxas
    noted each wgmma diagnostic in it (C7519: a warpgroup.arrive injected
    to touch registers of an in-flight wgmma; C7520: wgmma serialised)}
    of a build's ptxas report; a kernel is one whose name matches
    ``kernels``, named by its template arguments."""
    out, notes, kernel = {}, {}, None
    name = lambda s: re.sub(r"^.*" + kernels, "", s)  # noqa: E731
    for ln in log.splitlines():
        m = re.search(r"\((C75\d\d)\).*function '([^']*)'", ln)
        if m:
            if re.search(kernels, m.group(2)):
                key = name(m.group(2))
                notes.setdefault(key, {}).setdefault(m.group(1), 0)
                notes[key][m.group(1)] += 1
        elif "Compiling entry function" in ln:
            fn = ln.split("'")[1]
            kernel = name(fn) if re.search(kernels, fn) else None
        elif kernel and ("registers" in ln or "spill" in ln):
            out.setdefault(kernel, []).append(ln.replace("ptxas info    : ",
                                                         "").strip())
    for key, val in notes.items():
        out.setdefault(key, []).append(val)
    return out


def cuobjdump(path):
    """``cuobjdump -sass`` of the library or cubin at ``path``."""
    return subprocess.run(
        [os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump"),
         "-sass", path], capture_output=True, text=True, check=True).stdout


#: SASS instructions :func:`sass_counts` counts
SASS_OPS = ("CALL", "LDL", "STL", "BAR", "HGMMA", "WARPGROUP.ARRIVE",
            "WARPGROUP.DEPBAR", "MUFU", "FFMA")


def sass_counts(path, kernels=MAIN_KERNELS):
    """{main kernel: {op: count, "all": instructions}} of the library at
    ``path``: calls, local-memory loads and stores (spills), barriers,
    wgmma and its fences and waits, special-function and FMA instructions,
    in each kernel whose name matches ``kernels``."""
    out, cur = {}, None
    for ln in cuobjdump(path).splitlines():
        if "Function :" in ln:
            fn = ln.split(":", 1)[1].strip()
            cur = None
            if re.search(kernels, fn):
                cur = out.setdefault(re.sub(r"^.*" + kernels, "", fn),
                                     dict.fromkeys(SASS_OPS + ("all",), 0))
        elif cur is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln):
            words = ln.split("*/", 1)[1].split()
            op = words[1] if words and words[0].startswith("@") else \
                (words[0] if words else "")
            cur["all"] += 1
            for k in SASS_OPS:
                if op.startswith(k):
                    cur[k] += 1
    return out


def sass_all(items):
    """[{function: instructions}] of each ``(path, defines)`` of ``items``
    compiled to a cubin as the port builds it (one ``nvcc`` each, all
    started together), the anonymous namespace's hash left out of the
    names."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = []
    for path, defines in items:
        cubin = os.path.join(_build.BUILD_DIR, "sass-" + hashlib.sha256(
            "\0".join((path,) + tuple(defines)).encode()).hexdigest()[:16]
            + ".cubin")
        cmd = [c for c in _build.nvcc_command(path, cubin, defines)
               if c not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")]
        procs.append((cubin, subprocess.Popen(
            cmd + ["-cubin"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    outs = []
    for cubin, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({cubin}):\n{log}")
        out, cur = {}, None
        for ln in cuobjdump(cubin).splitlines():
            if "Function :" in ln:
                cur = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "",
                             ln.split(":", 1)[1].strip())
                out[cur] = []
            elif cur is not None and ln.strip():
                out[cur].append(ln.strip())
        outs.append(out)
    return outs


def first_difference(old, new):
    """[line, baseline's, port's] at the first line where two functions'
    SASS listings differ (None past the shorter one's end), or None."""
    for i in range(max(len(old), len(new))):
        a = old[i] if i < len(old) else None
        b = new[i] if i < len(new) else None
        if a != b:
            return [i, a, b]
    return None


def same_machine_code(base_dir, builds, skip=None):
    """{build: {"same": bool, "alone": bool, "instructions": {function:
    [baseline's, port's]}, "differs": {function: first_difference}}} for
    each ``(name, defines)`` of ``builds``: whether ``base_dir``'s copy of
    ``name.cu`` compiles to the port's machine code, function by function,
    each function's instruction counts and, for a function that differs,
    where; a build is keyed by its name and macros. ``skip`` maps a build
    ``(name, defines)`` to a regular expression: its functions whose names
    match it are left out on both sides (a build whose other functions
    must keep their code). All builds compile at once; a build whose two
    sides differ there is compiled again alone, one side after the other
    (``alone``), and that decides: with 32 builds of one source at once on
    an H100 host, ptxas swapped the operands of a few commutative FADDs in
    7 of them, where builds alone all agreed."""
    items = [(os.path.join(d, n + ".cu"), tuple(defs)) for n, defs in builds
             for d in (os.path.abspath(base_dir), _build.CSRC)]
    out = sass_all(items)
    res = {}
    for i, (n, defs) in enumerate(builds):
        pattern = (skip or {}).get((n, tuple(defs)))
        if pattern:
            out[2 * i], out[2 * i + 1] = (
                {f: v for f, v in o.items() if not re.search(pattern, f)}
                for o in out[2 * i:2 * i + 2])
        old, new = out[2 * i], out[2 * i + 1]
        alone = old != new
        if alone:
            old, new = ({f: v for f, v in sass_all([it])[0].items()
                         if not (pattern and re.search(pattern, f))}
                        for it in items[2 * i:2 * i + 2])
        fns = sorted(set(old) | set(new))
        res[" ".join((n,) + tuple(defs))] = {
            "same": old == new, "alone": alone,
            "instructions": {fn: [len(old.get(fn, ())), len(new.get(fn, ()))]
                             for fn in fns},
            "differs": {fn: first_difference(old.get(fn, []),
                                             new.get(fn, []))
                        for fn in fns if old.get(fn) != new.get(fn)}}
    return res
