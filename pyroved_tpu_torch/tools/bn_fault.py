"""How far ``chip_smoke.py`` phase 12 (i) sees a fault: the batchnorm
im2spec VED over ``{"data": 2}`` on two gloo ranks sharing one card, run
twice and held each time by ``chip_smoke.check_bn_ved``: as it is, and with
a planted fault, the batchnorm statistics' ``all_reduce`` summing nothing
in its backward (``collectives._AllReduceSum.backward`` replaced in the
ranks' processes only; no file changes).

Run from the repository root on a machine with a GPU:

    python3 -m pyroved_tpu_torch.tools.bn_fault

Prints, for each run, whether the check passed (or its message), the
largest error of any grad over its tensor's largest entry against the
one-process noise floor the check reads (the step on the batch's reversed
rows), and the card's name and power limit.
"""
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def rank(rank_id: int, rdv: str, tmp: str, fault: bool) -> None:
    """One rank of one run: (i)'s first step and 2 epochs, saved in tmp."""
    import chip_smoke as c
    from ..parallel import collectives, create_mesh, initialize_multihost
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if fault:
        collectives._AllReduceSum.backward = staticmethod(
            lambda ctx, g: (None, g))
    initialize_multihost(f"file://{rdv}", 2, rank_id, backend="gloo")
    try:
        out = c.rank_bn_ved(create_mesh({"data": 2}), tmp)
        torch.save(out, os.path.join(tmp, f"out{rank_id}_{int(fault)}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("bn_fault: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as c
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    x, y = c.im2spec_pairs(c.BN_ROWS, seed=4)
    first = c.bn_first_step()
    want = {n: g.cpu() for n, g in first["grads"].items()}
    floor = c.rel_to_max([first["reversed_grads"][n].cpu() for n in want],
                         list(want.values()))
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "bn_x.npy"), x)
        np.save(os.path.join(tmp, "bn_y.npy"), y)
        torch.save(first["inputs"], os.path.join(tmp, "bn_first.pt"))
        for fault in (False, True):
            t = time.perf_counter()
            rdv = os.path.join(tmp, f"rdv{int(fault)}")
            procs = [subprocess.Popen(
                [sys.executable, "-m", __spec__.name, "--rank", str(r), rdv,
                 tmp, str(int(fault))]) for r in range(2)]
            if any(p.wait(timeout=600) for p in procs):
                raise RuntimeError("a rank failed")
            outs = [torch.load(os.path.join(tmp, f"out{r}_{int(fault)}.pt"))
                    for r in range(2)]
            got = [outs[0]["first_grads"][n] for n in want]
            rel = c.rel_to_max(got, list(want.values()))
            try:
                c.check_bn_ved(outs, first, x, y)
                verdict = "passed"
            except AssertionError as e:
                verdict = f"failed: {e}"
            print(f"{'planted fault' if fault else 'as it is'}: (i) "
                  f"{verdict}; grads {rel:.3e} of the largest entry, the "
                  f"one-process floor {floor:.3e} "
                  f"({time.perf_counter() - t:.1f} s)", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        rank(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5] == "1")
        sys.exit(0)
    sys.exit(main())
