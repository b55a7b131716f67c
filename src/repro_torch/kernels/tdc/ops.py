"""Public entry point of the SRO ΔΣ TDC kernel.

Counterpart of `repro.kernels.tdc.ops.tdc_counts`. A CUDA tensor
launches the hand-written kernel (``csrc/tdc.cu``, which replaces
``src/repro/kernels/tdc/kernel.py:77 tdc_pallas``); a CPU tensor takes
the plain version `tdc_counts_plain`; any other device raises. There is
no tier or block-size switch. SRO phase jitter (``phase_noise_rms``) is
not modelled here, as in the reference's kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.tdc.ref import tdc_counts_plain

__all__ = ["TdcGeometry", "tdc_counts", "tdc_geometry", "tdc_scale"]

#: Samples of a clip staged per buffer (``csrc/tdc.cu``'s kChunk): divides
#: the paper's 512 samples a frame, so at os = 2 frames end on buffer
#: boundaries.
CHUNK = 128


@dataclasses.dataclass(frozen=True)
class TdcGeometry:
    """How `csrc/tdc.cu` is launched for a (B, T, C) input."""

    clips_per_block: int  # 32 // C clips (at most B): one carry lane each channel
    bulk: bool  # staged by bulk copies (else the helper reads u itself)
    fast: bool  # os = 2 with frames ending on boundaries of CHUNK-sample chunks


def tdc_geometry(b: int, t: int, c: int, spf: int, os: int, aligned: bool = True,
                 clip_samples: int | None = None) -> TdcGeometry:
    """The launch geometry for counting ``t`` samples (whole frames of
    ``spf``) of each of ``b`` clips of ``clip_samples`` (default t) at
    ``c`` channels and ``os`` ZOH ticks a sample; ``aligned``: the input's
    address is 16-byte aligned. Raises where nothing can be launched."""
    clip_samples = t if clip_samples is None else clip_samples
    if min(b, t, c, spf, os) <= 0 or t % spf or clip_samples < t:
        raise ValueError(f"tdc geometry: b={b} t={t} c={c} spf={spf} os={os} "
                         f"clip_samples={clip_samples}")
    # a bulk copy's addresses and size are multiples of 16 bytes: every
    # clip's run starts aligned and every chunk, the last too, is whole words
    bulk = aligned and c <= 32 and (clip_samples * c) % 4 == 0 and (t * c) % 4 == 0
    return TdcGeometry(clips_per_block=max(1, min(32 // min(c, 32), b)), bulk=bulk,
                       fast=os == 2 and spf % CHUNK == 0)


def tdc_scale(cfg) -> float:
    """``n_phases * (1 / f_tdc)`` as the reference's kernel folds it: in
    double precision, then one rounding to float32."""
    return float(np.float32(cfg.n_phases * (1.0 / cfg.f_tdc)))


def tdc_counts(u: torch.Tensor, cfg, chip=None) -> torch.Tensor:
    """(B, T, C) rectified input at the internal rate -> (B, F, C) float32
    counts, for the `TDFExConfig` ``cfg`` and an optional die ``chip``
    (its gain mismatch scales f_free and k_sro per channel). T is
    trimmed to whole frames of ``decimation // tdc_oversample`` samples.
    """
    c = u.shape[-1]
    gain = torch.ones((c,), dtype=torch.float32, device=u.device)
    if chip is not None:
        gain = 1.0 + chip.gain_mismatch.to(device=u.device, dtype=torch.float32)
    f0_eff = cfg.f_free_hz * gain
    k_eff = cfg.k_sro_hz * gain
    spf = cfg.decimation // cfg.tdc_oversample
    t = (u.shape[1] // spf) * spf
    scale = tdc_scale(cfg)
    if not build.route(u, "tdc"):
        return tdc_counts_plain(u[:, :t], f0_eff, k_eff, spf, cfg.tdc_oversample, scale)
    if u.dtype != torch.float32 or u.dim() != 3:
        raise TypeError(f"tdc_counts takes (B, T, C) float32; got {u.dtype} {tuple(u.shape)}")
    b = u.shape[0]
    out = torch.empty((b, t // spf, c), dtype=torch.float32, device=u.device)
    if out.numel() == 0:
        return out
    # the kernel reads the first t samples of each clip in place: no copy of
    # a contiguous input's trimmed tail
    u, f0_eff, k_eff = u.contiguous(), f0_eff.contiguous(), k_eff.contiguous()
    geo = tdc_geometry(b, t, c, spf, cfg.tdc_oversample, aligned=u.data_ptr() % 16 == 0,
                       clip_samples=u.shape[1])
    lib = build.library("tdc")
    with torch.cuda.device(u.device):
        rc = lib.tdc_launch(
            u.data_ptr(), f0_eff.data_ptr(), k_eff.data_ptr(), out.data_ptr(),
            b, t, u.shape[1], c, spf, cfg.tdc_oversample, scale, geo.clips_per_block,
            int(geo.bulk), int(geo.fast), torch.cuda.current_stream(u.device).cuda_stream,
        )
    build.check("tdc", rc)
    build.launches["tdc"] += 1
    return out
