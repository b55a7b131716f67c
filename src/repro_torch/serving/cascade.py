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
`fit_linear_detector` takes the gradient the reference's compiled
``jit(grad(loss))`` takes, operation for operation (XLA's exp, log and
log1p, its dot and reduction orders), so the two fits are array-equal;
on the card the weight gradient's row chain is the kernel
``kernels/csrc/fma_rows.cu``.

This module imports torch, `repro_torch.core.fex`,
`repro_torch.kernels.build` and `repro_torch.kernels.fma_rows` only (no
serving or pipeline module), so `repro_torch.core.pipeline` can host the
config without a cycle.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fex import fma_f32, xla_sum
from repro_torch.kernels.build import resolve_device
from repro_torch.kernels.fma_rows import fma_rows

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


# XLA's CPU log (the log_f32 of its elemental IR): the mantissa in
# [0.5, 1) against sqrt(1/2), and a Horner polynomial split in three.
_SQRT_HALF = _hex_f32("3FE6A09E60000000")
_LOG_P = tuple(tuple(_hex_f32(h) for h in hs) for hs in (
    ("3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000"),
    ("BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000"),
    ("3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000"),
))
# XLA's log1p: a rational approximation below sqrt(2) - 1, else log(1 + x).
_LOG1P_SMALL = _hex_f32("3FDA8279A0000000")
_LOG1P_DEN = tuple(_hex_f32(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000",
))
_LOG1P_NUM = tuple(_hex_f32(h) for h in (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000",
))


def _exp_parts(x: torch.Tensor):
    """XLA's CPU exp as two factors (y, 2^n): exp(x) = y * 2^n, the caller
    rounding the product (alone or fused with what follows)."""
    k = lambda v: torch.full_like(x, v)  # noqa: E731
    x = torch.where(x >= _EXP_LO, x, k(_EXP_LO))
    x = torch.where(x <= _EXP_HI, x, k(_EXP_HI))
    fx = torch.clamp(torch.floor(fma_f32(x, k(_LOG2E), k(0.5))), -127.0, 127.0)
    r = fma_f32(k(-_LN2_HI), fx, x)
    r = fma_f32(k(-_LN2_LO), fx, r)
    y = fma_f32(r, k(_EXP_P[0]), k(_EXP_P[1]))
    for p in _EXP_P[2:] + (0.5,):
        y = fma_f32(y, r, k(p))
    y = fma_f32(y, r * r, r) + 1.0
    return y, ((fx.to(torch.int32) + 127) << 23).view(torch.float32)


def xla_sigmoid(z: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the reference's compiled CPU code computes it:
    ``1 / (1 + exp(-z))`` with XLA's exp polynomial, its multiply-adds
    fused where the compiled code fuses them, and a result below the
    smallest normal float32 flushed to zero. float32 in and out."""
    y, pow2n = _exp_parts(-z)
    s = 1.0 / fma_f32(y, pow2n, torch.ones_like(z))
    return torch.where(s.abs() < _F32_MIN_NORMAL, torch.zeros_like(s), s)


def _xla_log(v: torch.Tensor) -> torch.Tensor:
    """log(v) for finite v > 0 as XLA's CPU code computes it, the
    multiply-adds fused where the compiled code fuses them."""
    k = lambda c: torch.full_like(v, c)  # noqa: E731
    bits = torch.where(v > _F32_MIN_NORMAL, v, k(_F32_MIN_NORMAL)).view(torch.int32)
    expo = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    low = m < _SQRT_HALF
    x = (m + -1.0) + torch.where(low, m, torch.zeros_like(m))
    expo = torch.where(low, expo - 1.0, expo)
    x2 = x * x
    x3 = x2 * x
    a, b, c = (fma_f32(fma_f32(x, k(p0), k(p1)), x, k(p2)) for p0, p1, p2 in _LOG_P)
    poly = fma_f32(fma_f32(fma_f32(a, x3, b), x3, c), x3, expo * _LN2_LO)
    return fma_f32(expo, k(_LN2_HI), fma_f32(k(-0.5), x2, x) + poly)


def _xla_log1p(e: torch.Tensor) -> torch.Tensor:
    """log1p(e) for 0 <= e <= 1 as XLA's CPU code computes it."""
    k = lambda c: torch.full_like(e, c)  # noqa: E731
    e2 = e * e
    ez = e * 0.0
    den = ez + 1.0
    for c in _LOG1P_DEN:
        den = fma_f32(den, e, k(c))
    num = ez + _LOG1P_NUM[0]
    for c in _LOG1P_NUM[1:]:
        num = fma_f32(num, e, k(c))
    small = e + fma_f32(k(-0.5), e2, (e * e2) * (num / den))
    return torch.where(e.abs() < _LOG1P_SMALL, small, _xla_log(e + 1.0))


def _xla_logits(xs: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """z = xs @ w + b in `_fit_grad`'s order."""
    n, c = xs.shape
    if c == 1 or n == 1:  # a chain of fused multiply-adds from b
        acc = b.expand(n)
        for j in range(c):
            acc = fma_f32(xs[:, j], w[j].expand(n), acc)
        return acc
    tiled = c - c % 8
    parts = []
    if tiled:
        lanes = torch.zeros((n, 8), dtype=xs.dtype, device=xs.device)
        for c0 in range(0, tiled, 8):
            lanes = fma_f32(xs[:, c0:c0 + 8], w[c0:c0 + 8].expand(n, 8), lanes)
        whole = n - n % 8  # rows in whole 8-row tiles: an adjacent pairwise tree
        pairs, halves = lanes[:whole], lanes[whole:]  # the last rows: lane i + lane i + 4, ...
        while pairs.shape[1] > 1:
            pairs = pairs[:, 0::2] + pairs[:, 1::2]
            half = halves.shape[1] // 2
            halves = halves[:, :half] + halves[:, half:]
        parts.append(torch.cat([pairs[:, 0], halves[:, 0]]))
    if tiled < c:
        tail = torch.zeros(n, dtype=xs.dtype, device=xs.device)
        for j in range(tiled, c):
            tail = fma_f32(xs[:, j], w[j].expand(n), tail)
        parts.append(tail)
    return (parts[0] + (parts[1] if len(parts) == 2 else 0.0)) + b


def _fit_grad(xs: torch.Tensor, ys: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """(dL/dw, dL/db) of mean(softplus(xs @ w + b) - ys * (xs @ w + b)) as
    the reference's compiled ``jit(grad(loss))`` computes it (jax 0.9.0,
    the CPU). At C >= 2 and N >= 2, z = xs @ w is XLA's row-major GEMV
    with 8-row, 8-column tiles: the first C - C % 8 columns summed in 8
    lanes (column j in lane j mod 8, fused multiply-adds from 0), the lanes
    added as an adjacent pairwise tree in a whole 8-row tile and as a
    halving tree (lane i + lane i + 4, then i + i + 2, then 0 + 1) in the
    last N % 8 rows; the last C % 8 columns a chain of fused multiply-adds
    from 0, and the two parts added (+ 0.0 where one is absent); then + b.
    At C = 1 or N = 1 the product is a chain of fused multiply-adds from
    b over the channels. dz = fma(exp(z - softplus(z)), 1/N, -y/N),
    softplus as max(z, 0) + log1p(exp(-|z|)); dL/dw XLA's column-major
    GEMV, a chain of fused multiply-adds over the rows from 0
    (`kernels.fma_rows`), but on one channel, `fma_rows.ref.head_channel`
    (C = 1 past 32 rows; channel 0 at C = 2 and the one channel past the
    8-channel tiles at C = 8k + 1, from 3 rows), its first 8 rows
    multiplied and added apart; dL/db `xla_sum` of dz. Read from the
    compiled code (``--xla_dump_to``: IR and object code) at N = 600
    (C = 1, 5, 12, 20), N = 16 (C = 1, 5, 9, 16), N = 6 (C = 2, 5, 16),
    N = 14 and 8 (C = 16) and N = 1 (C = 2, 16); held equal at every
    width 1-24 and row count of `tests/test_torch_cascade.py`'s map."""
    n = xs.shape[0]
    z = _xla_logits(xs, w, b)
    y, pow2n = _exp_parts(-z.abs())
    softplus = torch.clamp_min(z, 0.0) + _xla_log1p(y * pow2n)
    y, pow2n = _exp_parts(z - softplus)
    inv_n = _f32(1.0 / n)
    dz = fma_f32(y * pow2n, torch.full_like(z, inv_n), ys * -inv_n)
    return fma_rows(dz, xs), xla_sum(dz)


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
    the gradient the reference's compiled step takes (`_fit_grad`).

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
        gw, gb = _fit_grad(xs, ys, w, b)
        w = w - lr * gw
        b = b - lr * gb
    return tuple(float(v) for v in w.cpu().numpy()), float(b)
