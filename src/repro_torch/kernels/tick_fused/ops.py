"""Public entry point of the fused serving-tick kernel.

Counterpart of `repro.kernels.tick_fused.ops.tick_fused`. A CUDA tensor
launches the hand-written kernel (``csrc/tick_fused.cu``, which replaces
``src/repro/kernels/tick_fused/kernel.py:256 tick_fused_pallas``): the
whole tick in ONE launch. A CPU tensor takes the plain version
`tick_reference`. Any other device raises.

The kernel is built for the paper's model: 16 channels, 256-sample hops
(512 internal samples), two GRU(48) layers, 12 classes, the log +
normalizer post-processing, and the qat or integer classifier. Any other
geometry on a CUDA tensor raises rather than running something else.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import quant
from repro_torch.core.frontend import _nominal_coeffs
from repro_torch.core.gru_int import QuantizedClassifier
from repro_torch.kernels import build
from repro_torch.kernels.tick_fused.ref import smoothing_weights, tick_reference
from repro_torch.serving.quantize import quantize_classifier

# The geometry csrc/tick_fused.cu is compiled for.
_GEOMETRY = dict(
    num_channels=16, chunk_samples=256, frame_len=512, input_dim=16,
    hidden_dim=48, num_layers=2, num_classes=12, quant_bits=12, log_bits=10,
)


@dataclasses.dataclass(frozen=True)
class TickOperands:
    """Everything the kernel reads besides the per-tick slab and state,
    resident on the card: int8 weight codes and int32 bias codes packed
    layer by layer (both backends run on codes; for qat they are exactly
    the fake-quantized weights), the filterbank, the norm stats, and the
    log / sigmoid / tanh ROMs."""

    integer: bool
    w: torch.Tensor
    b: torch.Tensor
    coeffs: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor
    log_rom: torch.Tensor
    sig_rom: torch.Tensor
    tanh_rom: torch.Tensor
    q_max: float
    q_scale: float


def _check_geometry(pipeline) -> None:
    cfg = pipeline.config
    got = dict(
        num_channels=cfg.fex.num_channels, chunk_samples=pipeline.chunk_samples,
        frame_len=cfg.fex.frame_len, input_dim=cfg.gru.input_dim,
        hidden_dim=cfg.gru.hidden_dim, num_layers=cfg.gru.num_layers,
        num_classes=cfg.gru.num_classes, quant_bits=cfg.fex.quant_bits,
        log_bits=cfg.fex.log_bits,
    )
    if got != _GEOMETRY or cfg.fex.oversample != 2:
        raise ValueError(
            f"the CUDA tick is built for {_GEOMETRY} with 2x oversampling; "
            f"got {got}, oversample={cfg.fex.oversample}"
        )
    if not (cfg.use_log and cfg.use_norm):
        raise ValueError(
            "the CUDA tick implements the paper's post-processing "
            "(use_log=True, use_norm=True)"
        )
    if cfg.classifier_key not in ("qat", "integer"):
        raise ValueError(
            f"the CUDA tick serves the qat and integer classifiers; got "
            f"{cfg.classifier_key!r}"
        )


def pack_operands(pipeline, params, frontend_state, device) -> TickOperands:
    """Upload what the kernel reads once; a server does this at
    construction. ``params`` are float (qat) or `QuantizedClassifier`
    (integer) parameters."""
    _check_geometry(pipeline)
    cfg = pipeline.config
    if frontend_state is None or frontend_state.norm_stats is None:
        raise ValueError("use_norm requires fitted norm_stats")
    q = params
    if not isinstance(q, QuantizedClassifier):
        q = quantize_classifier(params, cfg.gru)
    w = torch.cat(
        [t.reshape(-1) for layer in q.gru for t in (layer["w_i"], layer["w_h"])]
        + [q.fc_w.reshape(-1)]
    )
    b = torch.cat(
        [t for layer in q.gru for t in (layer["b_i"], layer["b_h"])] + [q.fc_b]
    )
    ns = frontend_state.norm_stats
    f32 = lambda t: t.to(device=device, dtype=torch.float32).contiguous()  # noqa: E731
    fexc = cfg.fex
    return TickOperands(
        integer=cfg.classifier_key == "integer",
        w=w.to(device=device, dtype=torch.int8).contiguous(),
        b=b.to(device=device, dtype=torch.int32).contiguous(),
        coeffs=f32(_nominal_coeffs(cfg, frontend_state, device)),
        mu=f32(ns.mu),
        sigma=f32(ns.sigma),
        log_rom=quant.log_rom(device, fexc.quant_bits, fexc.log_bits),
        sig_rom=quant.sigmoid_rom(device),
        tanh_rom=quant.tanh_rom(device),
        q_max=fexc.quant_full_scale,
        q_scale=quant.quantizer_scale(fexc.quant_bits, fexc.quant_full_scale),
    )


def _require(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"tick_fused: {name} must be {dtype} {tuple(shape)} on {device}; "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"tick_fused: {name} must be contiguous")


def tick_fused(
    pipeline,
    raw_audio: bool,
    params,
    state,
    inp: torch.Tensor,
    mask: torch.Tensor,
    frontend_state,
    smoothing: float,
    *,
    operands: TickOperands = None,
    fv_out: torch.Tensor = None,
):
    """One fused serving tick; ``state`` is the ``(gru, carry, scores)``
    tuple of `tick_reference`. Returns ``(new_state, scores, top)``.

    On the card the kernel writes the new state INTO the given state
    tensors (the counterpart of the reference's buffer donation): treat
    ``state`` as consumed and use the returned one. ``operands`` come
    from `pack_operands` (built here when None). ``fv_out``, an (N, C)
    float32 CUDA tensor, receives the kernel's FV_Norm frame of every
    submitting stream (a diagnostic output of the kernel).
    """
    if not build.route(inp, "tick_fused"):
        if fv_out is not None:
            raise ValueError("fv_out is an output of the CUDA kernel only")
        return tick_reference(
            pipeline, raw_audio, params, state, inp, mask, frontend_state,
            smoothing,
        )
    dev = inp.device
    if operands is None:
        operands = pack_operands(pipeline, params, frontend_state, dev)
    else:
        _check_geometry(pipeline)
    if operands.w.device != dev:
        raise ValueError(f"operands on {operands.w.device}, inputs on {dev}")
    gru, carry, scores = state
    n = inp.shape[0]
    cfg = pipeline.config
    c, h, k = cfg.fex.num_channels, cfg.gru.hidden_dim, cfg.gru.num_classes
    in_dim = pipeline.chunk_samples if raw_audio else c
    h_dtype = torch.int32 if operands.integer else torch.float32
    _require(inp, "inp", (n, in_dim), torch.float32, dev)
    _require(mask, "mask", (n,), torch.bool, dev)
    for i, t in enumerate(gru):
        _require(t, f"gru[{i}]", (n, h), h_dtype, dev)
    for key in ("s1", "s2"):
        _require(carry[key], f"carry[{key!r}]", (n, c), torch.float32, dev)
    _require(scores, "scores", (n, k), torch.float32, dev)
    if fv_out is not None:
        _require(fv_out, "fv_out", (n, c), torch.float32, dev)
    top = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return (gru, carry, scores), scores, top
    s, one_minus = smoothing_weights(smoothing)
    op = operands
    lib = build.library("tick_fused")
    with torch.cuda.device(dev):
        rc = lib.tick_fused_launch(
            inp.data_ptr(), mask.data_ptr(), n,
            carry["s1"].data_ptr(), carry["s2"].data_ptr(),
            gru[0].data_ptr(), gru[1].data_ptr(), scores.data_ptr(),
            top.data_ptr(), None if fv_out is None else fv_out.data_ptr(),
            op.w.data_ptr(), op.b.data_ptr(), op.coeffs.data_ptr(),
            op.mu.data_ptr(), op.sigma.data_ptr(), op.log_rom.data_ptr(),
            op.sig_rom.data_ptr(), op.tanh_rom.data_ptr(),
            op.q_max, op.q_scale, 1.0 / cfg.fex.frame_len, s, one_minus,
            int(raw_audio), int(op.integer),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check("tick_fused", rc)
    build.launches["tick_fused"] += 1
    return (gru, carry, scores), scores, top
