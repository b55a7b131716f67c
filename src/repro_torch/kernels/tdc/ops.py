"""Public entry point of the SRO ΔΣ TDC kernel.

Counterpart of `repro.kernels.tdc.ops.tdc_counts`. A CUDA tensor
launches the hand-written kernel (``csrc/tdc.cu``, which replaces
``src/repro/kernels/tdc/kernel.py:77 tdc_pallas``); a CPU tensor takes
the plain version `tdc_counts_plain`; any other device raises. There is
no tier or block-size switch. SRO phase jitter (``phase_noise_rms``) is
not modelled here, as in the reference's kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.tdc.ref import tdc_counts_plain

__all__ = ["tdc_counts", "tdc_scale"]


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
    u = u[:, : (u.shape[1] // spf) * spf]
    scale = tdc_scale(cfg)
    if not build.route(u, "tdc"):
        return tdc_counts_plain(u, f0_eff, k_eff, spf, cfg.tdc_oversample, scale)
    if u.dtype != torch.float32 or u.dim() != 3:
        raise TypeError(f"tdc_counts takes (B, T, C) float32; got {u.dtype} {tuple(u.shape)}")
    b, t, _ = u.shape
    out = torch.empty((b, t // spf, c), dtype=torch.float32, device=u.device)
    if out.numel() == 0:
        return out
    u, f0_eff, k_eff = u.contiguous(), f0_eff.contiguous(), k_eff.contiguous()
    lib = build.library("tdc")
    with torch.cuda.device(u.device):
        rc = lib.tdc_launch(
            u.data_ptr(), f0_eff.data_ptr(), k_eff.data_ptr(), out.data_ptr(),
            b, t, c, spf, cfg.tdc_oversample, scale,
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    build.check("tdc", rc)
    build.launches["tdc"] += 1
    return out
