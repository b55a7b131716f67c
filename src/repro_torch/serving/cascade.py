"""Cascaded always-on wake serving: a stage-1 detector gating the GRU.

Counterpart of `repro.serving.cascade`. At serving scale most always-on
streams are silence, so a tiny first-stage detector runs on every 16 ms
feature frame and wakes the GRU classifier only on candidate speech:

  * `CascadeConfig` — detector kind, wake / release thresholds
    (hysteresis), hangover frames, gated-tick score decay. Bound to a
    pipeline through `KWSPipelineConfig.cascade`.
  * `detector_scores` — per-frame nonnegative wake scores from the
    16-channel FV_Norm frame: an energy gate (``"energy"``) or a linear
    scorer (``"linear"``, fit by `fit_linear_detector`).
  * `init_state` / `gate_step` / `wake_rate` — the per-stream detector
    state machine (awake latch, hangover countdown, woken / ticks
    counters) that rides `ServerState` like every other leaf.

Both detectors score >= 0, so ``wake_threshold=0``
(`CascadeConfig.always_on()`) opens the gate on every submitted tick and
the cascaded server equals the ungated one for every backend. As in the
reference, the gate is modelled sparsity: the gated classifier work still
runs and is discarded.

The scores are rounded as the reference's compiled serving tick rounds
them (jax 0.9.0 on the CPU, ROADMAP queue 3, P8): the energy score sums
relu(fv) left to right and multiplies by 1/C; the linear score is a
chain of fused multiply-adds over the channels from 0, then ``+ b``, and
its sigmoid is XLA's CPU expansion ``1 / (1 + exp(-z))`` with XLA's
Cephes exp polynomial (fused multiply-adds as the compiled code has
them, results below the smallest normal flushed to zero). The CUDA tick
(``kernels/csrc/tick_fused.cu``) computes the same operations.

This module imports torch, `repro_torch.core.fex` and
`repro_torch.kernels.build` only (no serving or pipeline module), so
`repro_torch.core.pipeline` can host the config without a cycle.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fex import fma_f32
from repro_torch.kernels.build import resolve_device

__all__ = [
    "CascadeConfig",
    "DETECTORS",
    "detector_scores",
    "init_state",
    "gate_step",
    "wake_rate",
    "fit_linear_detector",
    "xla_sigmoid",
]

DETECTORS = ("energy", "linear")


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Stage-1 wake-gate configuration (hashable).

    detector          "energy": mean over channels of relu(FV_Norm);
                      "linear": sigmoid(fv @ linear_w + linear_b), in
                      [0, 1] (fit with `fit_linear_detector`).
    wake_threshold    score >= wake_threshold turns the awake latch on;
                      0.0 means the gate is always open (`always_open`).
    release_threshold score < release_threshold turns the latch off
                      (0 <= release <= wake); None -> wake_threshold.
    hangover_frames   extra ticks the classifier keeps running after the
                      latch drops.
    score_decay       per-gated-tick multiplier on the smoothed posterior
                      of a stream the gate held asleep (in [0, 1]; 1.0 is
                      a frozen hold).
    linear_w, linear_b  the "linear" detector's weight per channel (a
                      tuple of floats, so the config stays hashable) and
                      bias.
    """

    detector: str = "energy"
    wake_threshold: float = 0.0
    release_threshold: Optional[float] = None
    hangover_frames: int = 0
    score_decay: float = 1.0
    linear_w: Optional[Tuple[float, ...]] = None
    linear_b: float = 0.0

    def __post_init__(self):
        if self.detector not in DETECTORS:
            raise ValueError(
                f"unknown cascade detector {self.detector!r}; "
                f"registered: {DETECTORS}"
            )
        if self.wake_threshold < 0.0:
            raise ValueError(
                "wake_threshold must be >= 0 (detector scores are "
                f"nonnegative); got {self.wake_threshold}"
            )
        if self.release_threshold is not None and not (
            0.0 <= self.release_threshold <= self.wake_threshold
        ):
            raise ValueError(
                "release_threshold must satisfy 0 <= release <= wake "
                f"({self.wake_threshold}); got {self.release_threshold}"
            )
        if self.hangover_frames < 0:
            raise ValueError(
                f"hangover_frames must be >= 0; got {self.hangover_frames}"
            )
        if not 0.0 <= self.score_decay <= 1.0:
            raise ValueError(
                f"score_decay must be in [0, 1]; got {self.score_decay}"
            )
        if self.detector == "linear":
            if self.linear_w is None:
                raise ValueError(
                    "detector='linear' needs linear_w (and linear_b); "
                    "fit them with cascade.fit_linear_detector"
                )
            object.__setattr__(
                self, "linear_w", tuple(float(w) for w in self.linear_w)
            )

    @classmethod
    def always_on(cls, **kwargs) -> "CascadeConfig":
        """A gate that is always open (wake_threshold=0): the cascaded
        server equals the ungated one."""
        return cls(wake_threshold=0.0, **kwargs)

    @property
    def always_open(self) -> bool:
        """True when every submitted tick wakes the classifier."""
        return self.wake_threshold <= 0.0

    @property
    def release(self) -> float:
        return (
            self.wake_threshold
            if self.release_threshold is None
            else self.release_threshold
        )


def _f32(v: float) -> float:
    """A Python float rounded to float32, as the reference's weakly typed
    scalars are."""
    return float(np.float32(v))


def _hex_f32(h: str) -> float:
    """A float32 constant of XLA's CPU exp, given as the double's hex."""
    return _f32(struct.unpack(">d", bytes.fromhex(h))[0])


# XLA's CPU exp (Cephes): input clamp, log2(e), ln 2 split in two, and
# the polynomial coefficients.
_EXP_LO = _hex_f32("C055F33340000000")
_EXP_HI = _hex_f32("4056333340000000")
_LOG2E = _hex_f32("3FF7154760000000")
_LN2_HI = _hex_f32("3FE6300000000000")
_LN2_LO = _hex_f32("BF2BD01060000000")
_EXP_P = tuple(_hex_f32(h) for h in (
    "3F2A0D2CE0000000", "3F56E879C0000000", "3F81112100000000",
    "3FA5553820000000", "3FC5555540000000",
))
_F32_MIN_NORMAL = 1.1754943508222875e-38


def xla_sigmoid(z: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the reference's compiled CPU code computes it:
    ``1 / (1 + exp(-z))`` with XLA's exp polynomial, its multiply-adds
    fused where the compiled code fuses them, and a result below the
    smallest normal float32 flushed to zero. float32 in and out."""
    k = lambda v: torch.full_like(z, v)  # noqa: E731
    x = -z
    x = torch.where(x >= _EXP_LO, x, k(_EXP_LO))
    x = torch.where(x <= _EXP_HI, x, k(_EXP_HI))
    fx = torch.clamp(torch.floor(fma_f32(x, k(_LOG2E), k(0.5))), -127.0, 127.0)
    r = fma_f32(k(-_LN2_HI), fx, x)
    r = fma_f32(k(-_LN2_LO), fx, r)
    y = fma_f32(r, k(_EXP_P[0]), k(_EXP_P[1]))
    for p in _EXP_P[2:] + (0.5,):
        y = fma_f32(y, r, k(p))
    y = fma_f32(y, r * r, r) + 1.0
    pow2n = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    s = 1.0 / fma_f32(y, pow2n, k(1.0))
    return torch.where(s.abs() < _F32_MIN_NORMAL, torch.zeros_like(s), s)


def detector_scores(fv: torch.Tensor, config: CascadeConfig) -> torch.Tensor:
    """Stage-1 wake scores for FV_Norm frames, shape (..., C) -> (...).

    Nonnegative for every input (the `always_open` contract):
      * "energy": mean(relu(fv)) over channels, summed left to right;
      * "linear": sigmoid(fv @ w + b) in [0, 1], the dot a chain of fused
        multiply-adds from 0 over the channels.
    """
    fv = fv.to(torch.float32)
    c = fv.shape[-1]
    if config.detector == "energy":
        rect = torch.clamp_min(fv, 0.0)
        acc = torch.zeros(fv.shape[:-1], dtype=torch.float32, device=fv.device)
        for i in range(c):
            acc = acc + rect[..., i]
        return acc * _f32(1.0 / c)
    acc = torch.zeros(fv.shape[:-1], dtype=torch.float32, device=fv.device)
    for i, w in enumerate(config.linear_w):
        acc = fma_f32(fv[..., i], torch.full_like(acc, _f32(w)), acc)
    return xla_sigmoid(acc + _f32(config.linear_b))


def init_state(batch: int, device=None) -> Dict[str, torch.Tensor]:
    """Fresh per-stream detector state, all (batch,) leaves; all-zeros is
    the valid fresh state (asleep, no hangover, zero counters).

    awake  — the hysteresis latch (bool).
    hang   — remaining hangover ticks after the latch dropped (int32).
    woken  — ticks the gate let the classifier advance (int32).
    ticks  — submitted ticks seen (int32, wraps like the ΔGRU counters).

    ``device=None`` means the card, as for every entry point of the port.
    """
    dev = resolve_device(device)
    z = lambda dtype: torch.zeros((batch,), dtype=dtype, device=dev)  # noqa: E731
    return {
        "awake": z(torch.bool),
        "hang": z(torch.int32),
        "woken": z(torch.int32),
        "ticks": z(torch.int32),
    }


def gate_step(state: Dict[str, torch.Tensor], score: torch.Tensor,
              config: CascadeConfig):
    """Advance the detector state machine one tick; return (state, gate).

    gate (bool, per stream) is True where the classifier runs this tick:
    the awake latch is on, or the hangover countdown is still draining.
    The caller applies its submitted mask on top (an idle stream's
    detector state must not advance). Thresholds compare as float32.
    """
    above = score >= _f32(config.wake_threshold)
    below = score < _f32(config.release)
    awake = above | (state["awake"] & ~below)
    gate = awake | (state["hang"] > 0)
    hang = torch.where(
        awake,
        torch.full_like(state["hang"], config.hangover_frames),
        torch.clamp_min(state["hang"] - 1, 0),
    )
    new_state = {
        "awake": awake,
        "hang": hang,
        "woken": state["woken"] + gate.to(torch.int32),
        "ticks": state["ticks"] + 1,
    }
    return new_state, gate


def wake_rate(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Fraction of submitted ticks the gate woke the classifier, per
    stream (float32); 1.0 for slots that have seen no traffic."""
    ticks = state["ticks"].to(torch.float32)
    woken = state["woken"].to(torch.float32)
    return torch.where(
        state["ticks"] > 0, woken / torch.clamp_min(ticks, 1.0),
        torch.ones_like(ticks),
    )


def fit_linear_detector(speech_fv, silence_fv, steps: int = 200,
                        lr: float = 0.5) -> Tuple[Tuple[float, ...], float]:
    """Fit the "linear" detector: logistic regression speech-vs-silence on
    FV_Norm frames, full-batch gradient descent on the softplus BCE with
    gradients from `torch.autograd.grad`.

    speech_fv / silence_fv: (..., C) frame stacks (numpy arrays or
    tensors; the fit runs where a tensor lies). Returns (linear_w tuple,
    linear_b) ready for `CascadeConfig`.
    """
    speech = torch.as_tensor(speech_fv, dtype=torch.float32)
    silence = torch.as_tensor(silence_fv, dtype=torch.float32,
                              device=speech.device)
    n_ch = speech.shape[-1]
    if silence.shape[-1] != n_ch:
        raise ValueError(
            f"channel mismatch: speech C={n_ch}, silence C={silence.shape[-1]}"
        )
    xs = torch.cat([speech.reshape(-1, n_ch), silence.reshape(-1, n_ch)])
    ys = torch.cat([
        torch.ones(speech.reshape(-1, n_ch).shape[0], device=speech.device),
        torch.zeros(silence.reshape(-1, n_ch).shape[0], device=speech.device),
    ])
    w = torch.zeros(n_ch, device=speech.device)
    b = torch.zeros((), device=speech.device)
    for _ in range(steps):
        w.requires_grad_(True)
        b.requires_grad_(True)
        z = xs @ w + b
        loss = torch.mean(torch.nn.functional.softplus(z) - ys * z)
        gw, gb = torch.autograd.grad(loss, (w, b))
        with torch.no_grad():
            w = w - lr * gw
            b = b - lr * gb
    return tuple(float(v) for v in w.cpu().numpy()), float(b)
