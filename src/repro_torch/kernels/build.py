"""Builds, loads and routes to the port's CUDA kernels; counts launches.

Counterpart of `repro.kernels.dispatch`. Where the reference picks a
Pallas tier, the port picks by the tensor's device (`route`): a CUDA
tensor launches the hand-written kernel, a CPU tensor takes the plain
PyTorch version, any other device raises. There is no switch that sends
a CUDA tensor to the plain version.

Each source under ``csrc/`` is compiled by its own ``nvcc`` process, all
started together, into a shared library with a plain C interface in
``build/`` beside this module (git-ignored), at first use. The library
name carries a hash of the sources and flags, so an edited source is
never served stale. ``-fmad=false`` keeps nvcc from contracting
``a*b + c`` where the plain version rounds twice (the IIR writes its
fused multiply-adds explicitly). Libraries load with ctypes; every
pointer and the stream are passed as ``c_void_p`` (a bare Python int
would be cut to 32 bits).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

__all__ = [
    "SOURCES",
    "NVCC_FLAGS",
    "build_all",
    "check",
    "launches",
    "library",
    "resolve_device",
    "route",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = {
    "fex_fused": "fex_fused.cu",
    "fma_rows": "fma_rows.cu",
    "gru_seq": "gru_seq.cu",
    "intgemm": "intgemm.cu",
    "tdc": "tdc.cu",
    "tick_fused": "tick_fused.cu",
    "wkv6": "wkv6.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-fmad=false",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fex_fused": {
        # x, x_bf16, coeffs, out, b, t, row stride, c, frame_len,
        # inv_frame, clips a block, bulk, fast, stream
        "fex_fused_launch": ([_P, _I, _P, _P] + [_I] * 5 + [_F] + [_I] * 3 + [_P], _I),
        # x, coeffs, s1, s2, y, b, t, row stride, c, clips a block, bulk,
        # store_bulk, stream
        "biquad_stream_launch": ([_P] * 5 + [_I] * 7 + [_P], _I),
        "fex_fused_error_string": ([_I], ctypes.c_char_p),
    },
    "fma_rows": {
        # d, xs, out, n, c, the head channel, rows, stages, channels a
        # block, flags, smem, stream
        "fma_rows_launch": ([_P, _P, _P] + [_I] * 8 + [_P], _I),
        "fma_rows_error_string": ([_I], ctypes.c_char_p),
    },
    "gru_seq": {
        # x, x_bf16, w, u, b_i, b_h, h0, out, b, t, i, h, instantiation,
        # copy mode, threads, smem bytes, stream
        "gru_seq_launch": ([_P, _I] + [_P] * 6 + [_I] * 8 + [_P], _I),
        # instantiation, x_bf16, threads, smem bytes, &blocks an SM
        "gru_seq_occupancy": ([_I] * 4 + [_P], _I),
        "gru_seq_error_string": ([_I], ctypes.c_char_p),
    },
    "wkv6": {
        # r, k, v, logw, u, y, bf16, b, t, h, p, stream
        "wkv6_launch": ([_P] * 6 + [_I] * 5 + [_P], _I),
        "wkv6_error_string": ([_I], ctypes.c_char_p),
    },
    "tdc": {
        # u, f0, k, out, b, t (counted), samples a clip, c,
        # samples_per_frame, os, scale, clips a block, bulk, fast, stream
        "tdc_launch": ([_P] * 4 + [_I] * 6 + [_F] + [_I] * 3 + [_P], _I),
        "tdc_error_string": ([_I], ctypes.c_char_p),
    },
    "intgemm": {
        # x, w, out, m, k, n, stream
        "intgemm_launch": ([_P, _P, _P, _I, _I, _I, _P], _I),
        "intgemm_error_string": ([_I], ctypes.c_char_p),
    },
    "tick_fused": {
        # inp, mask, n, s1, s2, gru, hw and casc (addresses of the host
        # structs GruState, HwFrontend and Cascade), scores, top, fv_out, w,
        # b, wf, bf, theta, coeffs, mu, sigma, log_rom, sig_rom, tanh_rom,
        # q_max, q_scale, inv_frame, smoothing, one_minus, raw, backend,
        # delta_bulk, stream
        "tick_fused_launch": (
            [_P, _P, _I] + [_P] * 8 + [_P] * 11 + [_F] * 5 + [_I, _I, _I, _P],
            _I,
        ),
        # backend, &smem, &blocks an SM
        "tick_fused_occupancy": ([_I, _P, _P], _I),
        "tick_fused_error_string": ([_I], ctypes.c_char_p),
    },
}

#: Per-kernel launch counts: a wrapper adds one where it launches its
#: kernel and nowhere else, so a run can show which kernels its main
#: path went through. ``launches.clear()`` resets them.
launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_ptxas: Dict[str, str] = {}


def resolve_device(device=None) -> torch.device:
    """An entry point's device: the card unless the caller names another.

    ``None`` means ``"cuda"``; with no CUDA device that raises rather
    than running somewhere the caller did not ask for.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


def route(t: torch.Tensor, name: str) -> bool:
    """True: launch kernel ``name`` (CUDA tensor). False: take its plain
    version (CPU tensor). Any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(
        f"{name}: no kernel or plain version for a tensor on {t.device}"
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every kernel library that is not built yet, one nvcc per
    source, all at once. Returns {name: ptxas report}; raises with the
    compiler's output if any build fails."""
    with _lock:
        todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for name, out in todo.items():
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
                procs[name] = (tmp, out, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ))
            failed = []
            for name, (tmp, out, proc) in procs.items():
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
                    tmp.unlink(missing_ok=True)
                    continue
                os.replace(tmp, out)
                _ptxas[name] = "\n".join(
                    ln for ln in log.splitlines() if "ptxas" in ln or "spill" in ln
                )
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return {n: _ptxas.get(n, "(built earlier)") for n in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all()
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return _libs[name]


def check(name: str, rc: int) -> None:
    """Raise if a launch entry point returned a CUDA error code."""
    if rc != 0:
        msg = getattr(library(name), f"{name}_error_string")(rc)
        raise RuntimeError(
            f"{name} kernel launch failed: {msg.decode()} (cudaError {rc})"
        )
