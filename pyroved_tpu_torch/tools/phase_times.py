"""Seconds a ``chip_smoke.py`` run spends in each phase, from the times its
lines of output arrive, for this tree and earlier ones in one call.

Run from the repository root on a machine with one CUDA GPU:

    python3 -m pyroved_tpu_torch.tools.phase_times DIR [DIR ...] [--logs DIR]

Each ``DIR`` holds a checkout (e.g. the parent commit and this tree,
unpacked under ``_checkout/`` with ``git archive``, which ``.gitignore``
lists). The checkouts run one after another, each ``python3 -u
chip_smoke.py`` from its own root, with no arguments. A phase's header is
a line that starts ``phase N:`` or ``phases N and M:``; its seconds run
from its header to the next one (``start`` is what comes before the first
header: the imports and the kernels' build, which phase 1's header closes).
Each run's output, every line with its seconds since the start, goes to
``--logs``/``<name of DIR>.log`` (default ``chiprun_out/phase_times``).
Prints a JSON line a run: its exit code, its seconds and its phases'
seconds. Exits with the first run's non-zero code, if any.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

HEADER = re.compile(r"^phases? (\d+)(?: and (\d+))?:")


def run(tree: str, logs: str) -> dict:
    """``tree``'s ``chip_smoke.py``, timed by the lines it prints."""
    name = os.path.basename(os.path.normpath(tree))
    phases, current = {}, "start"
    t0 = time.perf_counter()
    last = t0
    with open(os.path.join(logs, f"{name}.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-u", "chip_smoke.py"], cwd=tree,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            now = time.perf_counter()
            log.write(f"{now - t0:9.2f} {line}")
            m = HEADER.match(line)
            if m:
                phases[current] = phases.get(current, 0.0) + now - last
                current = " and ".join(g for g in m.groups() if g)
                last = now
        rc = proc.wait()
    end = time.perf_counter()
    phases[current] = phases.get(current, 0.0) + end - last
    return {"tree": tree, "rc": rc, "seconds": end - t0,
            "phases": {k: round(v, 1) for k, v in phases.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--logs", default=os.path.join("chiprun_out",
                                                   "phase_times"))
    args = ap.parse_args(argv)
    os.makedirs(args.logs, exist_ok=True)
    code = 0
    for tree in args.trees:
        res = run(tree, args.logs)
        print(json.dumps(res), flush=True)
        code = code or res["rc"]
    return code


if __name__ == "__main__":
    sys.exit(main())
