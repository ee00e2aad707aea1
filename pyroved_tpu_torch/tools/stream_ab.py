"""Hold this tree's eager streamed epochs against an earlier tree's on the
card: the out-of-core flagship of ``examples/out_of_core_training.py``
(uniform 28x28 float32 rows in a memmap, ``iVAE((28, 28), latent_dim=2,
invariances=['r'], seed=1)`` at batch 200, as ``chip_smoke.py``'s phase 9
runs it) streamed one batch at a time (``device_resident=False``) and in
chunks of 64 with the captured programs off (``_graph.CAPTURE = False``).

Run from the repository root on a machine with one CUDA GPU:

    python3 -m pyroved_tpu_torch.tools.stream_ab --baseline DIR [--rows N]

``DIR`` holds an earlier checkout with its ``pyroved_tpu_torch`` (e.g. the
parent commit unpacked under ``_checkout/``, which ``.gitignore`` lists).
The trees run in turns (baseline, this, this, baseline), each run a
process of its own over the same memmap and one kernel build directory.
Each configuration is a fresh model and trainer, a warm-up epoch of 10
batches, then one timed epoch of ``N`` rows (default 200,000): steps/s
(host clock to the device's end), the device's peak memory above what was
allocated before the epoch, the bytes copied to the device, and a SHA-256
of the parameters after it, which must be the same in every run (the same
rows reach the model in the same order). Prints a line a run, then one
JSON line.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIGS = (("per-batch streamed", dict(device_resident=False)),
           ("chunks of 64, eager", dict(device_resident=False,
                                        stream_chunks=64)))
SLAB = 50_000


def write_rows(path: str, rows: int) -> None:
    """``rows`` uniform float32 28x28 images (seed 0, in slabs)."""
    x = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                  shape=(rows, 28, 28))
    rng = np.random.default_rng(0)
    for lo in range(0, rows, SLAB):
        hi = min(lo + SLAB, rows)
        x[lo:hi] = rng.uniform(0, 1, (hi - lo, 28, 28)).astype(np.float32)
    x.flush()


def child(tree: str, path: str, build: str) -> dict:
    """Both configurations through ``tree``'s package."""
    sys.path.insert(0, tree)
    import torch
    from pyroved_tpu_torch.models import iVAE
    from pyroved_tpu_torch.ops import _build
    from pyroved_tpu_torch.trainers import SVItrainer, _graph
    from pyroved_tpu_torch.utils.data import init_dataloader
    _build.BUILD_DIR = build
    _graph.CAPTURE = False
    x = np.load(path, mmap_mode="r")
    out = {}
    for name, kw in CONFIGS:
        model = iVAE((28, 28), latent_dim=2, invariances=["r"], seed=1)
        trainer = SVItrainer(model)
        trainer.train(init_dataloader(x[:2000], batch_size=200, seed=0, **kw))
        loader = init_dataloader(x, batch_size=200, seed=0, **kw)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = trainer.train(loader)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        digest = hashlib.sha256()
        for p in model.nets.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        out[name] = {"steps_per_s": len(loader) / secs, "epoch_s": secs,
                     "peak_mib": (torch.cuda.max_memory_allocated() - base)
                     / 2 ** 20,
                     "h2d_bytes": loader.host_to_device_bytes,
                     "loss": float(loss), "params": digest.hexdigest()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="an earlier checkout's root")
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--child", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(*args.child)))
        return 0
    trees = {"baseline": os.path.abspath(args.baseline), "this": HERE}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "x.npy")
        write_rows(path, args.rows)
        build = os.path.join(tmp, "build")
        for name in ("baseline", "this", "this", "baseline"):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--baseline",
                 args.baseline, "--child", trees[name], path, build],
                capture_output=True, text=True, check=False)
            if proc.returncode:
                sys.stderr.write(proc.stdout + proc.stderr)
                return 1
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            runs.append({"tree": name, **res})
            for config, r in res.items():
                print(f"{name:8s} {config:20s} {r['steps_per_s']:9.2f} "
                      f"steps/s, peak {r['peak_mib']:8.2f} MiB, "
                      f"{r['h2d_bytes']} B to the device, loss "
                      f"{r['loss']:.6f}, params {r['params'][:16]}",
                      flush=True)
    digests = {r[c]["params"] for r in runs for c, _ in CONFIGS}
    same = len(digests) == 1
    print(json.dumps({"rows": args.rows, "runs": runs,
                      "params_equal": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
