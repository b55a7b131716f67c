"""Quickstart: one synthetic keyword through the full KWS pipeline, on the card by default.

    python -m repro_torch.quickstart [--device cpu]

Counterpart of `examples/quickstart.py`: synthesize a "yes", compare the
software model's frames (the filterbank scan, |y| and the frame mean as
separate steps) with the fused filterbank kernel (K1 on the card), then
quantize / log / normalize, run the GRU-FC classifier over every frame,
print each registered frontend's FV_Raw difference against the software
codes, check that the "integer" backend (K2 on the card) gives the QAT
scores bit for bit, and print the IC model's latency and power.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.energy import paper_accelerator, paper_power_model
from repro_torch.core.fex import (
    FExConfig,
    biquad_filterbank,
    fit_norm_stats,
    frame_average,
    full_wave_rectify,
    oversample2x,
)
from repro_torch.core.frontend import available_frontends
from repro_torch.core.gru import GRUConfig
from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig
from repro_torch.data.gscd import CLASSES, GSCDSynthConfig, _TEMPLATES, synth_keyword
from repro_torch.kernels.build import resolve_device
from repro_torch.kernels.fex_fused import fex_fused

__all__ = ["main", "run"]


def run(device=None, params=None) -> Dict[str, Any]:
    """The walk-through on ``device`` (the card by default); ``params``
    replace the random float params from ``torch.Generator().manual_seed(0)``.
    Returns the printed figures: ``peak``, ``frames`` (K1's, on the host),
    ``frames_err``, ``top`` (a class name), ``fv_raw_diff`` (frontend ->
    LSB), ``integer_exact``, ``latency_ms``, ``power_uw`` and ``seconds``."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    audio = synth_keyword(rng, _TEMPLATES["yes"], GSCDSynthConfig())
    peak = float(np.abs(audio).max())
    print(f"synthesized 'yes': {audio.shape[0]} samples @16 kHz, peak {peak:.3f}")

    fcfg = FExConfig()
    x = torch.as_tensor(audio[None], device=dev)
    xo = oversample2x(x)
    # the software model step by step (on the card, the scan entry and
    # torch's frame mean) against the fused kernel K1, whose frame sums
    # run in the reference's compiled order
    frames_sw = frame_average(full_wave_rectify(biquad_filterbank(xo, fcfg.filterbank())),
                              fcfg.frame_len)
    frames = fex_fused(xo, fcfg.filterbank(), fcfg.frame_len)
    frames_err = float((frames_sw - frames).abs().max())
    print(f"FEx frames: {tuple(frames.shape)} (62 frames x 16 ch); "
          f"fused-kernel max err vs the step-by-step model: {frames_err:.2e}")

    # fit mu / sigma on this clip (demo only; training fits on the corpus),
    # FV_Log by the closed form as the reference's eager set-up has it
    fv_raw = quant.quantize_unsigned(frames, fcfg.quant_bits, fcfg.quant_full_scale)
    fv_log = quant.log_compress_eager(fv_raw, fcfg.quant_bits, fcfg.log_bits)
    stats = fit_norm_stats(fv_log)
    pipe = KWSPipeline(KWSPipelineConfig(), norm_stats=stats)
    if params is None:
        params = pipe.init_params(torch.Generator().manual_seed(0), device=dev)
    fv_norm = pipe.features_from_raw(fv_raw)  # `pipe.features(x)` without K1 again
    scores = pipe.logits_all_frames(params, fv_norm)
    top = CLASSES[int(torch.argmax(scores[0, -1]))]
    print(f"classifier (untrained) final-frame top class: {top}")

    # the same call site runs every registered frontend; the two hardware
    # frontends model one die, calibrated once
    diffs, states = {}, {}
    for name in available_frontends():
        p = KWSPipeline(KWSPipelineConfig(frontend=name), norm_stats=stats)
        die = "software" if name == "software" else "hardware"
        if die not in states:
            states[die] = p.init_frontend_state(mismatch=False, device=dev)
        _, raw_f = p.features(x, states[die])
        diffs[name] = float((raw_f - fv_raw).abs().max())
        print(f"frontend {name:15s}: FV_Raw max |diff| vs software reference = "
              f"{diffs[name]:.1f} LSB")

    # the "integer" backend: int8 weight codes, Q6.8 activations and
    # 24-bit accumulators, bit-identical to QAT
    pipe_int = KWSPipeline(KWSPipelineConfig(classifier="integer"), norm_stats=stats)
    scores_int = pipe_int.logits_all_frames(params, fv_norm)
    exact = bool(torch.equal(scores, scores_int))
    print(f"classifier 'integer' (int8/Q6.8 codes): bit-identical to QAT scores = {exact}")

    acc, pm, g = paper_accelerator(), paper_power_model(), GRUConfig()
    latency_ms = acc.latency_s(g) * 1e3
    power_uw = pm.total_power_w(g) * 1e6
    print(f"IC model: latency {latency_ms:.1f} ms (paper 12.4), core power "
          f"{power_uw:.1f} uW (paper 23)")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    print(f"quickstart on {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'CPU'} "
          f"in {seconds:.2f} s")
    print("next: python -m repro_torch.training.kws trains this pipeline end-to-end")
    return {"peak": peak, "frames": frames.cpu().numpy(), "frames_err": frames_err,
            "top": top, "fv_raw_diff": diffs, "integer_exact": exact,
            "latency_ms": latency_ms, "power_uw": power_uw, "seconds": seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    out = run(ap.parse_args(argv).device)
    return 0 if out["integer_exact"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
