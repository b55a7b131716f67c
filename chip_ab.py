#!/usr/bin/env python3
"""Times intgemm (K2) and the dense tick's branches (K3) of two source
trees in one call on one card, in turns: first, second, second, first.

    python3 chip_ab.py FIRST_ROOT [SECOND_ROOT]

Each root is a checkout of the repository (SECOND_ROOT defaults to this
one), for example the parent commit unpacked with ``git archive`` into
``chip_archive/``. Each turn is a process that imports that root's
``repro_torch`` (its kernels built by nvcc into that root's build
directory) and runs this checkout's `chip_smoke` timing functions on it:
intgemm beside torch.matmul, the software tick of every dense backend and
of the ΔGRU backends at θ = 0.15 on raw audio and FV input, and the qat
and integer FV ticks with the gate shut (`chip_smoke.phase_split`).
Prints the card's name and power limit, one JSON line a turn, then each
key's times, first root against second. Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def turn(src: str) -> None:
    """One turn: build and time the kernels of the tree whose ``src`` is
    given; print its times as one JSON line."""
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: no CUDA device")
    if not build.__file__.startswith(src):
        raise SystemExit(f"chip_ab: imported {build.__file__}, not the tree under {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.SOURCES = {k: build.SOURCES[k] for k in ("intgemm", "tick_fused")}
    for name, report in build.build_all().items():
        print(f"  {name}: {report.strip()}", file=sys.stderr)
    dev = torch.device("cuda")
    times = chip_smoke.intgemm_times(dev)
    # the software ticks at the smoke's operating points (no die to calibrate)
    runs = [r for r in chip_smoke.TICK_RUNS if not r[2] and r[1] != 0.0]
    times.update(chip_smoke.tick_times(dev, None, runs, plain=False))
    times.update(chip_smoke.phase_split(dev, times))
    print(json.dumps({"src": src, "times": times}))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        turn(sys.argv[2])
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    roots = [Path(a).resolve() for a in sys.argv[1:]] + ([ROOT] if len(sys.argv) == 2 else [])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0])
    results = {0: [], 1: []}
    for i in (0, 1, 1, 0):
        proc = subprocess.run([sys.executable, __file__, "--turn", str(roots[i] / "src")],
                              capture_output=True, text=True, timeout=1200)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(proc.stdout[-4000:])
            raise SystemExit(f"chip_ab: turn on {roots[i]} exited {proc.returncode}")
        line = proc.stdout.strip().splitlines()[-1]
        print(line)
        results[i].append(json.loads(line)["times"])
    print(f"first: {roots[0]}, second: {roots[1]} (ms; turns first, second, second, first)")
    for key, value in results[1][0].items():
        if key.endswith("ms") and all(key in r for rs in results.values() for r in rs):
            first = ", ".join(f"{r[key]:.6f}" for r in results[0])
            second = ", ".join(f"{r[key]:.6f}" for r in results[1])
            print(f"{key}: first {first}; second {second}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
