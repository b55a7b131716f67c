#!/usr/bin/env python3
"""Times the batch filterbank (K1 and its scan entry), intgemm (K2), the
tick's branches (K3, with K4 inside for the ΔGRU), the TDC (K5), the GRU
sequence (K6), WKV6 (K7) and the fit's row chain (fma_rows) of two source
trees in one call on one card, in turns: first, second, second, first.

    python3 chip_ab.py FIRST_ROOT [SECOND_ROOT]

Each root is a checkout of the repository (SECOND_ROOT defaults to this
one), for example the parent commit unpacked with ``git archive`` into
``chip_archive/``. Each turn is a process that imports that root's
``repro_torch`` (its kernels built by nvcc into that root's build
directory) and runs this checkout's `chip_smoke` timing functions on it:
K1 and the scan entry at (64, 32 000) (`chip_smoke.fex_times`: K1 with
frames of 512 and of 500, the event loop; each entry as one block alone),
intgemm beside torch.matmul, the software tick of every dense backend and
of the ΔGRU backends at θ = 0 and 0.15 on raw audio and FV input, the
qat, integer, delta and delta-int FV ticks with the gate shut
(`chip_smoke.phase_split`), fma_rows at (992, 16) beside torch.mv
(`chip_smoke.fma_rows_times`), K5
at (64, 31 744, 16) (`chip_smoke.tdc_times`: also with every chunk
floored by floorf, and as one block alone), K6 over 4096 clips of 62
frames (`chip_smoke.gru_seq_times`: both float layers, layer 1, layer 1
in bf16, cuDNN's GRU beside them), K7 at (8, 4096, 64, 64)
(`chip_smoke.wkv6_times`), and `record_features` of 128 clips on each
frontend, warm (`chip_smoke.record_times`). Prints the card's name and
power limit, one JSON line a turn, then each key's times, first root
against second.

Before the turns it measures the two dependent chains on this checkout's
compiler flags: a probe kernel (one warp) runs K5's carry tick, with
floorf and with the 2^23 add, K1's step (biquad.cuh's biquad_y and
the |y| sum) and the fit's FMA chain, and reports cycles a tick, sample
or FMA (clock64) and the SM clock (clock64 over %globaltimer, and
nvidia-smi's clocks.sm just after); it times an empty launch on
fma_rows' grid, whose sum with 992 FMAs is fma_rows' floor at the fit's
shape; the probe's and the built tdc, fex_fused, fma_rows, gru_seq and
tick_fused libraries' SASS go to ``chain/`` in the kernels' build
directory. Needs a CUDA device.

    python3 chip_ab.py --k6

builds variants of this checkout's K6 source (`k6`: 4 x 2 and 1 x 2
register tiles beside the 2 x 2 one, the gates replaced by sums, the
threads ordered units first) and prints each one's registers, spills and
ms for both float layers and the bf16 layer 1 at (4096, 62).
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
    for name, report in build.build_all().items():
        print(f"  {name}: {report.strip()}", file=sys.stderr)
    dev = torch.device("cuda")
    times = chip_smoke.fex_times(dev)
    times.update(chip_smoke.intgemm_times(dev))
    # the software ticks at the smoke's operating points (no die to calibrate)
    runs = [r for r in chip_smoke.TICK_RUNS if not r[2]]
    times.update(chip_smoke.tick_times(dev, None, runs, plain=False))
    times.update(chip_smoke.phase_split(dev, times))
    times.update(chip_smoke.fma_rows_times(dev))
    times.update(chip_smoke.tdc_times(dev))
    times.update(chip_smoke.gru_seq_times(dev))
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

// the fit's row chain: n dependent __fmaf_rn a lane
__global__ void fma_chain(const float* x, int n, float* out, long long* cycles,
                          unsigned long long* ns) {
  const float a = x[threadIdx.x], b = x[32 + threadIdx.x];
  float acc = 0.0f;
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) acc = __fmaf_rn(a, b, acc);
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) {
    cycles[0] = c1 - c0;
    ns[0] = g1 - g0;
  }
}

__global__ void empty_kernel() {}

extern "C" int fma_probe(const float* x, int n, float* out, long long* cycles,
                         unsigned long long* ns) {
  fma_chain<<<1, 32>>>(x, n, out, cycles, ns);
  return static_cast<int>(cudaDeviceSynchronize());
}

// ms a launch of an empty kernel on one block of `threads` with `smem`
// bytes of dynamic shared memory, over `reps` back-to-back launches
extern "C" int empty_launch_ms(int threads, int smem, int reps, float* ms) {
  cudaError_t e = cudaFuncSetAttribute(empty_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  for (int i = 0; i < 10; ++i) empty_kernel<<<1, threads, smem>>>();
  cudaEventRecord(start);
  for (int i = 0; i < reps; ++i) empty_kernel<<<1, threads, smem>>>();
  cudaEventRecord(stop);
  cudaEventSynchronize(stop);
  cudaEventElapsedTime(ms, start, stop);
  *ms /= reps;
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
  return static_cast<int>(cudaGetLastError());
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
    # the fit's row chain: cycles an FMA, and the empty launch on fma_rows'
    # grid at the fit's (992, 16) (this tree's geometry, and the one-block,
    # 512-thread, 202 752-byte launch of the earlier one-block design); the floor is their sum
    lib.fma_probe.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.empty_launch_ms.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    x = (torch.rand(64, device=dev) * 0.5 + 0.25).contiguous()
    for _ in range(2):
        rc = lib.fma_probe(x.data_ptr(), n, res.data_ptr(), cycles.data_ptr(), ns.data_ptr())
        if rc != 0:
            raise SystemExit(f"chip_ab: the fma probe failed (cudaError {rc})")
    cyc, nsec = int(cycles.item()), int(ns.item())
    result["fma"] = {"cycles_per_fma": cyc / n, "sm_ghz": cyc / nsec}
    from repro_torch.kernels.fma_rows.ops import fma_rows_geometry

    geo = fma_rows_geometry(992, 16)
    for name, threads, smem in (("this tree", geo.threads, geo.smem),
                                ("512 threads", 512, 202752)):
        ms = ctypes.c_float()
        rc = lib.empty_launch_ms(threads, smem, 2000, ctypes.addressof(ms))
        if rc != 0:
            raise SystemExit(f"chip_ab: the empty launch failed (cudaError {rc})")
        result[f"empty launch, {name}"] = {"threads": threads, "smem": smem, "ms": ms.value}
    chain_ms = 992 * (cyc / n) / (cyc / nsec) * 1e-6
    result["fma_rows floor (992, 16)"] = {
        "chain_ms": chain_ms, "floor_ms": chain_ms + result["empty launch, this tree"]["ms"]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(json.dumps({"chain": result, "nvidia-smi clocks.sm, clocks.max.sm, power.limit": smi}))
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    build.SOURCES = {k: build.SOURCES[k]
                     for k in ("fex_fused", "fma_rows", "gru_seq", "tdc", "tick_fused")}
    build.build_all()
    for name, path in (("chain_probe", lib_path), ("tdc", build._lib_path("tdc")),
                       ("fex_fused", build._lib_path("fex_fused")),
                       ("fma_rows", build._lib_path("fma_rows")),
                       ("gru_seq", build._lib_path("gru_seq")),
                       ("tick_fused", build._lib_path("tick_fused"))):
        sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                              text=True, timeout=300).stdout
        (out_dir / f"{name}.sass").write_text(sass)
        print(f"{name}: {len(sass.splitlines())} lines of SASS in {out_dir / (name + '.sass')}")


# K6's probes: variants of csrc/gru_seq.cu, each an edit of this checkout's
# source (rows a thread R; the gates replaced by sums, so their share shows;
# the threads ordered units first, 16 units to a half-warp), built with
# this checkout's flags and timed at chip_smoke's K6 shapes
K6_GATES = (
    """        gr[q][v] = expf(-((si[q][v][0] + b_ir[v]) + (sh[q][v][0] + b_hr[v])));
        gz[q][v] = expf(-((si[q][v][1] + b_iz[v]) + (sh[q][v][1] + b_hz[v])));""",
    """        gr[q][v] = (si[q][v][0] + b_ir[v]) + (sh[q][v][0] + b_hr[v]);
        gz[q][v] = ((si[q][v][1] + b_iz[v]) + (sh[q][v][1] + b_hz[v])) * 1e-3f;""",
    """        gr[q][v] = 1.0f / (1.0f + gr[q][v]);
        gz[q][v] = 1.0f / (1.0f + gz[q][v]);""", "",
    """        hv[q][v] = tanhf((si[q][v][2] + b_in[v]) + gr[q][v] * (sh[q][v][2] + b_hn[v]));""",
    """        hv[q][v] = ((si[q][v][2] + b_in[v]) + gr[q][v] * (sh[q][v][2] + b_hn[v]))"""
    """ * 1e-3f;""",
)
K6_ORDER = (
    """  const int rg = tid % NRG;       // rows rg, rg + NRG, ...
  const int ug = tid / NRG;       // units U ug, U ug + 1
""",
    """  const int nug = (h + U - 1) / U, full = nug / 16 * 16 * NRG, rem = nug % 16;
  const int rg = tid < full ? tid % (16 * NRG) / 16 : (tid - full) / rem;
  const int ug = tid < full ? 16 * (tid / (16 * NRG)) + tid % 16
                            : nug / 16 * 16 + (tid - full) % rem;
""",
)


def _k6_variant(src: str, rows_a_thread: int, edits=()) -> str:
    import re

    out, n = re.subn(r"constexpr int R = \d+;", f"constexpr int R = {rows_a_thread};", src)
    if n != 1:
        raise SystemExit("chip_ab: gru_seq.cu no longer declares R")
    for old, new in zip(edits[::2], edits[1::2]):
        if old not in out:
            raise SystemExit(f"chip_ab: the K6 probe's edit no longer applies:\n{old}")
        out = out.replace(old, new)
    return out


def k6() -> None:
    """K6's probes: each variant's registers and spills (ptxas) and its ms
    for layer 1, layer 2 and layer 1 in bf16 at (4096, 62), beside this
    tree's kernel, and the largest difference to it (0: the same sums)."""
    import ctypes
    import re

    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke
    from repro_torch.kernels import build, gru_sequence
    from repro_torch.kernels.gru import ops

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: no CUDA device")
    src = (build.CSRC / "gru_seq.cu").read_text()
    variants = {
        "this tree (2 x 2 tiles)": (ops.R, _k6_variant(src, ops.R)),
        "no gates": (ops.R, _k6_variant(src, ops.R, K6_GATES)),
        "4 x 2 tiles": (4, _k6_variant(src, 4)),
        "1 x 2 tiles": (1, _k6_variant(src, 1)),
        "units first": (ops.R, _k6_variant(src, ops.R, K6_ORDER)),
    }
    out_dir = build.BUILD_DIR / "k6"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (_, text)) in enumerate(variants.items()):
        path = out_dir / f"gru_seq_{i}.cu"
        path.write_text(text)
        procs[name] = (out_dir / f"libgru_seq_{i}.so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
             str(out_dir / f"libgru_seq_{i}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    dev = torch.device("cuda")
    layers, fv, fv16 = chip_smoke._gru_inputs(dev)
    layers = [[a.float().contiguous() for a in layer] for layer in layers]
    h1 = gru_sequence(fv, *layers[0])
    want = {"layer 1": h1, "layer 2": gru_sequence(h1, *layers[1]),
            "bf16 layer 1": gru_sequence(fv16, *layers[0])}
    h0 = torch.zeros((fv.shape[0], chip_smoke.H), device=dev)
    result = {}
    for name, (lib_path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"chip_ab: K6 probe {name} did not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(lib_path))
        lib.gru_seq_launch.argtypes = build._SIGNATURES["gru_seq"]["gru_seq_launch"][0]
        r = variants[name][0]

        def run(x, layer, lib=lib, r=r):
            geo = ops.gru_seq_geometry(x.shape[0], x.shape[2], chip_smoke.H,
                                       x.dtype == torch.bfloat16)
            threads = ops.ROWS // r * -(-chip_smoke.H // ops.U)
            y = torch.empty(x.shape[:2] + (chip_smoke.H,), dtype=x.dtype, device=dev)
            rc = lib.gru_seq_launch(
                x.data_ptr(), int(x.dtype == torch.bfloat16), *(a.data_ptr() for a in layer),
                h0.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1], x.shape[2], chip_smoke.H,
                geo.inst, geo.copy, threads, geo.smem, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise SystemExit(f"chip_ab: K6 probe {name} failed to launch (cudaError {rc})")
            return y

        entry = {"registers": [int(n) for n in re.findall(r"Used (\d+) registers", log)],
                 "spill_stores": sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", log))}
        for key, x, layer in (("layer 1", fv, layers[0]), ("layer 2", h1, layers[1]),
                              ("bf16 layer 1", fv16, layers[0])):
            y = run(x, layer)
            entry[f"{key} diff"] = float((y.float() - want[key].float()).abs().max())
            entry[f"{key} ms"], _ = chip_smoke._cuda_ms(lambda: run(x, layer), reps=20, hold=True)
        result[name] = entry
        print(json.dumps({"k6 probe": name, **entry}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"k6": result, "nvidia-smi name, power.limit": smi}))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        turn(sys.argv[2])
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--chain":
        chain()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--k6":
        k6()
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
