#!/usr/bin/env python3
"""Times the batch filterbank (K1 and its scan entry), intgemm (K2), the
dense tick's branches (K3), the TDC (K5) and WKV6 (K7) of two source trees
in one call on one card, in turns: first, second, second, first.

    python3 chip_ab.py FIRST_ROOT [SECOND_ROOT]

Each root is a checkout of the repository (SECOND_ROOT defaults to this
one), for example the parent commit unpacked with ``git archive`` into
``chip_archive/``. Each turn is a process that imports that root's
``repro_torch`` (its kernels built by nvcc into that root's build
directory) and runs this checkout's `chip_smoke` timing functions on it:
K1 and the scan entry at (64, 32 000) (`chip_smoke.fex_times`: K1 with
frames of 512 and of 500, the event loop; each entry as one block alone),
intgemm beside torch.matmul, the software tick of every dense backend and
of the ΔGRU backends at θ = 0.15 on raw audio and FV input, the qat
and integer FV ticks with the gate shut (`chip_smoke.phase_split`), K5
at (64, 31 744, 16) (`chip_smoke.tdc_times`: also with every chunk
floored by floorf, and as one block alone) and K7 at (8, 4096, 64, 64)
(`chip_smoke.wkv6_times`), and `record_features` of 128 clips on each
frontend, warm (`chip_smoke.record_times`). Prints the card's name and
power limit, one JSON line a turn, then each key's times, first root
against second.

Before the turns it measures the two dependent chains on this checkout's
compiler flags: a probe kernel (one warp) runs K5's carry tick, with
floorf and with the 2^23 add, and K1's step (biquad.cuh's biquad_y and
the |y| sum), and reports cycles a tick or sample (clock64) and the SM
clock (clock64 over %globaltimer, and nvidia-smi's clocks.sm just after);
the probe's and the built tdc and fex_fused libraries' SASS go to
``chain/`` in the kernels' build directory. Needs a CUDA device.
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
    build.SOURCES = {k: build.SOURCES[k]
                     for k in ("fex_fused", "intgemm", "tick_fused", "tdc", "wkv6")}
    for name, report in build.build_all().items():
        print(f"  {name}: {report.strip()}", file=sys.stderr)
    dev = torch.device("cuda")
    times = chip_smoke.fex_times(dev)
    times.update(chip_smoke.intgemm_times(dev))
    # the software ticks at the smoke's operating points (no die to calibrate)
    runs = [r for r in chip_smoke.TICK_RUNS if not r[2] and r[1] != 0.0]
    times.update(chip_smoke.tick_times(dev, None, runs, plain=False))
    times.update(chip_smoke.phase_split(dev, times))
    times.update(chip_smoke.tdc_times(dev))
    times.update(chip_smoke.wkv6_times(dev))
    times.update(chip_smoke.record_times(dev))
    print(json.dumps({"src": src, "times": times}))


# one warp runs n ZOH ticks of csrc/tdc.cu's carry (its tick from
# tdc_tick.cuh), or n samples of csrc/fex_fused.cu's K1 step (biquad_y from
# biquad.cuh and the |y| sum), built with the same flags, timed by clock64
# and %globaltimer
CHAIN_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#include "biquad.cuh"
#include "tdc_tick.cuh"

template <bool MAGIC>
__global__ void chain(const float* d, int n, float* out, long long* cycles,
                      unsigned long long* ns) {
  const float dd = d[threadIdx.x];
  float r = 0.0f, acc = 0.0f;
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) tick<MAGIC>(dd, r, acc);
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[threadIdx.x] = acc + r;
  if (threadIdx.x == 0) {
    cycles[0] = c1 - c0;
    ns[0] = g1 - g0;
  }
}

__global__ void biquad_chain(const float* coeffs, const float* x, int n, float* out,
                             long long* cycles, unsigned long long* ns) {
  const Biquad q = load_biquad(coeffs, threadIdx.x % 16, 16);
  const float xx = x[threadIdx.x];
  float s1 = 0.0f, s2 = 0.0f, part = 0.0f;
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) part = __fadd_rn(part, fabsf(biquad_y(q, xx, s1, s2)));
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[threadIdx.x] = part + s1 + s2;
  if (threadIdx.x == 0) {
    cycles[0] = c1 - c0;
    ns[0] = g1 - g0;
  }
}

extern "C" int biquad_probe(const float* coeffs, const float* x, int n, float* out,
                            long long* cycles, unsigned long long* ns) {
  biquad_chain<<<1, 32>>>(coeffs, x, n, out, cycles, ns);
  return static_cast<int>(cudaDeviceSynchronize());
}

extern "C" int chain_probe(const float* d, int n, int magic, float* out, long long* cycles,
                           unsigned long long* ns) {
  if (magic) {
    chain<true><<<1, 32>>>(d, n, out, cycles, ns);
  } else {
    chain<false><<<1, 32>>>(d, n, out, cycles, ns);
  }
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def chain() -> None:
    """The chains on the card: K5's cycles a tick by floor, K1's cycles a
    sample, the SM clock, SASS."""
    import ctypes

    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: no CUDA device")
    out_dir = build.BUILD_DIR / "chain"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "chain_probe.cu", out_dir / "libchain_probe.so"
    src.write_text(CHAIN_PROBE)
    nvcc = build._nvcc()
    proc = subprocess.run([nvcc, *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(lib_path),
                           str(src)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"chip_ab: the chain probe did not build:\n{proc.stderr}")
    print(" ".join(ln.strip() for ln in (proc.stdout + proc.stderr).splitlines() if "ptxas" in ln))
    lib = ctypes.CDLL(str(lib_path))
    lib.chain_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
    dev = torch.device("cuda")
    d = (torch.rand(32, device=dev) * 30.0).contiguous()  # the paper's d is ~1-30
    res = torch.zeros(32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    ns = torch.zeros(1, dtype=torch.int64, device=dev)
    n = 1 << 22
    result = {}
    for name, magic in (("floorf", 0), ("magic-add", 1), ("floorf again", 0)):
        for _ in range(2):  # the second run is the one kept
            rc = lib.chain_probe(d.data_ptr(), n, magic, res.data_ptr(), cycles.data_ptr(),
                                 ns.data_ptr())
            if rc != 0:
                raise SystemExit(f"chip_ab: the chain probe failed (cudaError {rc})")
        cyc, nsec = int(cycles.item()), int(ns.item())
        result[name] = {"cycles_per_tick": cyc / n, "sm_ghz": cyc / nsec}
    lib.biquad_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [
        ctypes.c_void_p] * 3
    from repro_torch.core.fex import FExConfig

    coeffs = FExConfig().filterbank().stacked(device=dev).contiguous()
    x = (torch.randn(32, device=dev) * 0.2).contiguous()
    for name in ("biquad_y", "biquad_y again"):
        for _ in range(2):
            rc = lib.biquad_probe(coeffs.data_ptr(), x.data_ptr(), n, res.data_ptr(),
                                  cycles.data_ptr(), ns.data_ptr())
            if rc != 0:
                raise SystemExit(f"chip_ab: the biquad probe failed (cudaError {rc})")
        cyc, nsec = int(cycles.item()), int(ns.item())
        result[name] = {"cycles_per_sample": cyc / n, "sm_ghz": cyc / nsec}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(json.dumps({"chain": result, "nvidia-smi clocks.sm, clocks.max.sm, power.limit": smi}))
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    build.SOURCES = {k: build.SOURCES[k] for k in ("fex_fused", "tdc")}
    build.build_all()
    for name, path in (("chain_probe", lib_path), ("tdc", build._lib_path("tdc")),
                       ("fex_fused", build._lib_path("fex_fused"))):
        sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                              text=True, timeout=300).stdout
        (out_dir / f"{name}.sass").write_text(sass)
        print(f"{name}: {len(sass.splitlines())} lines of SASS in {out_dir / (name + '.sass')}")


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        turn(sys.argv[2])
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--chain":
        chain()
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    roots = [Path(a).resolve() for a in sys.argv[1:]] + ([ROOT] if len(sys.argv) == 2 else [])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0])
    probe = subprocess.run([sys.executable, __file__, "--chain"], capture_output=True, text=True,
                           timeout=900)
    sys.stderr.write(probe.stderr[-4000:])
    print(probe.stdout.strip())
    if probe.returncode != 0:
        raise SystemExit(f"chip_ab: the chain probe exited {probe.returncode}")
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
