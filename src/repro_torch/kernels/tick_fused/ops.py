"""Public entry point of the fused serving-tick kernel.

Counterpart of `repro.kernels.tick_fused.ops.tick_fused`. A CUDA tensor
launches the hand-written kernel (``csrc/tick_fused.cu``, which replaces
``src/repro/kernels/tick_fused/kernel.py:256 tick_fused_pallas`` and, for
the ΔGRU backends, the gather-compacted column update K4 inside it): the
whole tick in ONE launch. A CPU tensor takes the plain version
`tick_reference`. Any other device raises.

The kernel is built for the paper's model: 16 channels, 256-sample hops
(512 internal samples), two GRU(48) layers, 12 classes, the log +
normalizer post-processing, any of the three frontends (software, and
the hardware frontends' common streaming step with its 4-leaf carry
{s1, s2, r, j}) and any of the five classifier backends (float, qat,
integer, delta, delta-int), with or without the stage-1 cascade gate
(its detector, hysteresis / hangover state machine and score decay run
inside the same launch). Any other geometry on a CUDA tensor raises
rather than running something else.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core import quant
from repro_torch.core.frontend import _HardwareBase, _nominal_coeffs, streaming_tdc_scale
from repro_torch.core.tdfex import fv_scale
from repro_torch.core.gru_int import QuantizedClassifier
from repro_torch.kernels import build
from repro_torch.kernels.tick_fused.ref import smoothing_weights, tick_reference
from repro_torch.serving.cascade import CascadeConfig
from repro_torch.serving.quantize import quantize_classifier

# The geometry csrc/tick_fused.cu is compiled for.
_GEOMETRY = dict(
    num_channels=16, chunk_samples=256, frame_len=512, input_dim=16,
    hidden_dim=48, num_layers=2, num_classes=12, quant_bits=12, log_bits=10,
)
# The kernel's backend numbers (enum Backend in csrc/tick_fused.cu).
_BACKENDS = {"qat": 0, "integer": 1, "float": 2, "delta": 3, "delta-int": 4}
# The per-layer leaves of a ΔGRU state, in the order of struct GruState.
_DELTA_KEYS = ("h", "x_ref", "h_ref", "acc_x", "acc_h", "skipped", "total")
_FRONTENDS = ("software", "hardware", "hardware-pallas")
# The detector state leaves in the order of struct Cascade, with dtypes.
_DET = (("awake", torch.bool), ("hang", torch.int32), ("woken", torch.int32),
        ("ticks", torch.int32))
_DETECTORS = {"energy": 0, "linear": 1}


class GruStatePointers(ctypes.Structure):
    """ctypes mirror of ``struct GruState`` in csrc/tick_fused.cu: per
    layer, the device pointers of the classifier state (the dense
    backends fill ``h`` only). Passed to the launch by address."""

    _fields_ = [(key, ctypes.c_void_p * 2) for key in _DELTA_KEYS]


class HwFrontendArgs(ctypes.Structure):
    """ctypes mirror of ``struct HwFrontend`` in csrc/tick_fused.cu: the
    hardware frontends' operands and carry pointers (``on`` = 0 for the
    software frontend). Passed to the launch by address."""

    _fields_ = (
        [(key, ctypes.c_void_p) for key in ("r", "j", "gain", "beta", "alpha")]
        + [(key, ctypes.c_float) for key in
           ("f_free", "k_sro", "tdc_scale", "fv_scale", "hd2", "hd3")]
        + [("shared_hd", ctypes.c_int), ("on", ctypes.c_int)]
    )


class CascadeArgs(ctypes.Structure):
    """ctypes mirror of ``struct Cascade`` in csrc/tick_fused.cu: the
    detector state pointers, the detector's weights and the gate's
    constants (``on`` = 0 without a cascade). Passed to the launch by
    address."""

    _fields_ = (
        [(key, ctypes.c_void_p) for key, _ in _DET]
        + [("w", ctypes.c_float * 16)]
        + [(key, ctypes.c_float) for key in ("b", "wake", "release", "decay")]
        + [(key, ctypes.c_int) for key in ("hangover", "detector", "decay_on", "on")]
    )


def _cascade_args(casc: CascadeConfig, det, n: int, dev) -> CascadeArgs:
    """Check the detector state against what the kernel writes and fill
    the struct; thresholds, weights and decay rounded to float32 as the
    reference's weakly typed scalars are."""
    args = CascadeArgs()
    if not isinstance(det, dict) or set(det) != {key for key, _ in _DET}:
        raise ValueError(
            f"tick_fused: det must be a dict of {tuple(k for k, _ in _DET)}"
        )
    for key, dtype in _DET:
        _require(det[key], f"det[{key!r}]", (n,), dtype, dev)
        setattr(args, key, det[key].data_ptr())
    if casc.detector == "linear":
        if len(casc.linear_w) != 16:
            raise ValueError("the CUDA tick's linear detector takes 16 weights")
        args.w[:] = list(casc.linear_w)
    args.b = casc.linear_b
    args.wake, args.release = casc.wake_threshold, casc.release
    args.decay = casc.score_decay
    args.hangover = casc.hangover_frames
    args.detector = _DETECTORS[casc.detector]
    args.decay_on = int(casc.score_decay != 1.0)
    args.on = 1
    return args


@dataclasses.dataclass(frozen=True)
class TickOperands:
    """Everything the kernel reads besides the per-tick slab and state,
    resident on the card: the weights packed layer by layer (int8 weight
    codes and int32 bias codes for qat, integer, delta and delta-int,
    which all run on codes; float32 ``wf`` / ``bf`` for float), the
    per-layer ΔGRU thresholds (θ_x, θ_h) as Q6.8 codes (zero for the
    dense backends), the filterbank, the norm stats, and the log /
    sigmoid / tanh ROMs; for the hardware frontends also the die's gain
    (1 + mismatch), beta and alpha (empty for the software frontend) and
    the VTC / SRO / TDC constants."""

    backend: str
    hardware: bool
    gain: torch.Tensor
    beta: torch.Tensor
    alpha: torch.Tensor
    hw_consts: tuple  # f_free, k_sro, tdc_scale, fv_scale, hd2, hd3
    w: torch.Tensor
    b: torch.Tensor
    wf: torch.Tensor
    bf: torch.Tensor
    theta: torch.Tensor
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
    if cfg.frontend not in _FRONTENDS:
        raise ValueError(
            f"the CUDA tick serves the frontends {_FRONTENDS}; got {cfg.frontend!r}"
        )
    if not (cfg.use_log and cfg.use_norm):
        raise ValueError(
            "the CUDA tick implements the paper's post-processing "
            "(use_log=True, use_norm=True)"
        )
    if cfg.classifier_key not in _BACKENDS:
        raise ValueError(
            f"the CUDA tick serves the classifiers {sorted(_BACKENDS)}; got "
            f"{cfg.classifier_key!r}"
        )


def _packed(gru_layers, fc_w, fc_b):
    """Weights and biases in the kernel's layer-by-layer layout."""
    w = torch.cat(
        [t.reshape(-1) for layer in gru_layers for t in (layer["w_i"], layer["w_h"])]
        + [fc_w.reshape(-1)]
    )
    b = torch.cat(
        [t for layer in gru_layers for t in (layer["b_i"], layer["b_h"])] + [fc_b]
    )
    return w, b


def pack_operands(pipeline, params, frontend_state, device) -> TickOperands:
    """Upload what the kernel reads once; a server does this at
    construction. ``params`` are float parameters (float, qat, delta) or
    `QuantizedClassifier` codes (integer, delta-int)."""
    _check_geometry(pipeline)
    cfg = pipeline.config
    key = cfg.classifier_key
    if frontend_state is None or frontend_state.norm_stats is None:
        raise ValueError("use_norm requires fitted norm_stats")
    f32 = lambda t: t.to(device=device, dtype=torch.float32).contiguous()  # noqa: E731
    unused = lambda dtype: torch.empty((0,), dtype=dtype, device=device)  # noqa: E731
    if key == "float":
        wf, bf = _packed(params["gru"], params["fc"]["w"], params["fc"]["b"])
        wf, bf = f32(wf), f32(bf)
        w, b = unused(torch.int8), unused(torch.int32)
    else:
        q = params
        if not isinstance(q, QuantizedClassifier):
            q = quantize_classifier(params, cfg.gru)
        w, b = _packed(q.gru, q.fc_w, q.fc_b)
        w = w.to(device=device, dtype=torch.int8).contiguous()
        b = b.to(device=device, dtype=torch.int32).contiguous()
        wf, bf = unused(torch.float32), unused(torch.float32)
    thetas = [0, 0] * cfg.gru.num_layers
    if pipeline.classifier.is_delta:
        thetas = [t for pair in pipeline.classifier.delta.code_thresholds(
            cfg.gru.num_layers) for t in pair]
    ns = frontend_state.norm_stats
    fexc = cfg.fex
    hardware = isinstance(pipeline.frontend, _HardwareBase)
    gain = beta = alpha = unused(torch.float32)
    hw_consts = (0.0,) * 6
    if hardware:
        tdcfg = cfg.tdfex_config
        chip = frontend_state.chip
        c = fexc.num_channels
        gain = f32(torch.ones((c,)) if chip is None else 1.0 + chip.gain_mismatch)
        b_cal, a_cal = _HardwareBase._calibration(tdcfg, frontend_state)
        beta = f32(torch.as_tensor(b_cal, dtype=torch.float32).expand(c))
        alpha = f32(torch.as_tensor(a_cal, dtype=torch.float32).expand(c))
        hw_consts = (
            quant._f32(tdcfg.f_free_hz), quant._f32(tdcfg.k_sro_hz),
            streaming_tdc_scale(tdcfg), fv_scale(tdcfg),
            quant._f32(10.0 ** (tdcfg.vtc_hd2_db / 20.0)),
            quant._f32(10.0 ** (tdcfg.vtc_hd3_db / 20.0)),
        )
    return TickOperands(
        backend=key, hardware=hardware, gain=gain, beta=beta, alpha=alpha,
        hw_consts=hw_consts, w=w, b=b, wf=wf, bf=bf,
        theta=torch.tensor(thetas, dtype=torch.int32, device=device),
        coeffs=f32(_nominal_coeffs(cfg, frontend_state, device)),
        mu=f32(ns.mu),
        sigma=f32(ns.sigma),
        log_rom=quant.log_rom(device, fexc.quant_bits, fexc.log_bits),
        sig_rom=quant.sigmoid_rom(device),
        tanh_rom=quant.tanh_rom(device),
        q_max=fexc.quant_full_scale,
        q_scale=quant.quantizer_scale(fexc.quant_bits, fexc.quant_full_scale),
    )


#: Bytes a row of each array the ΔGRU branch stages, in its order (struct
#: GruState's x_ref, h_ref, acc_x, acc_h, layer 1 then layer 2): whole
#: 16-byte words, so the rows of a block are one run of them.
DELTA_ROW_BYTES = (16 * 4, 48 * 4, 144 * 4, 144 * 4, 48 * 4, 48 * 4, 144 * 4, 144 * 4)


def delta_staging(addresses) -> int:
    """How the ΔGRU branch stages its state: bit k set where staged array
    k (`DELTA_ROW_BYTES`' order) goes by one bulk copy a block, clear
    where it goes by cp.async words. A bulk copy needs its source on a
    16-byte boundary: every block's rows start on one where the array's
    base does, since every row is whole 16-byte words. Raises for
    anything but eight addresses of 4-byte words."""
    addresses = tuple(int(a) for a in addresses)
    if len(addresses) != len(DELTA_ROW_BYTES):
        raise ValueError(f"delta_staging takes {len(DELTA_ROW_BYTES)} addresses; "
                         f"got {len(addresses)}")
    if any(a <= 0 or a % 4 for a in addresses):
        raise ValueError(f"delta_staging: every address must be a nonzero multiple of 4; "
                         f"got {addresses}")
    return sum(1 << k for k, a in enumerate(addresses) if a % 16 == 0)


def _require(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"tick_fused: {name} must be {dtype} {tuple(shape)} on {device}; "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"tick_fused: {name} must be contiguous")


def _gru_pointers(classifier, gru, n, c, h, dev) -> GruStatePointers:
    """Check the classifier state against what the kernel writes and
    collect its device pointers."""
    ptrs = GruStatePointers()
    layers = tuple(gru)
    backend = classifier.name
    if len(layers) != 2:
        raise ValueError(f"tick_fused: gru must hold 2 layers; got {len(layers)}")
    if classifier.is_delta:
        dtype = torch.float32 if backend == "delta" else torch.int32
        for layer, st in enumerate(layers):
            in_dim = c if layer == 0 else h
            shapes = dict(h=(n, h), x_ref=(n, in_dim), h_ref=(n, h),
                          acc_x=(n, 3 * h), acc_h=(n, 3 * h),
                          skipped=(n,), total=(n,))
            if not isinstance(st, dict) or set(st) != set(_DELTA_KEYS):
                raise ValueError(
                    f"tick_fused: gru[{layer}] must be a dict of {_DELTA_KEYS}"
                )
            for key in _DELTA_KEYS:
                t = st[key]
                want = torch.int32 if key in ("skipped", "total") else dtype
                _require(t, f"gru[{layer}][{key!r}]", shapes[key], want, dev)
                getattr(ptrs, key)[layer] = t.data_ptr()
        return ptrs
    dtype = torch.int32 if backend == "integer" else torch.float32
    for layer, t in enumerate(layers):
        _require(t, f"gru[{layer}]", (n, h), dtype, dev)
        ptrs.h[layer] = t.data_ptr()
    return ptrs


def occupancy(backend: str):
    """(dynamic shared bytes, blocks an SM) of a tick launch for
    ``backend`` on the current card (the CUDA occupancy API)."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    lib = build.library("tick_fused")
    build.check("tick_fused", lib.tick_fused_occupancy(
        _BACKENDS[backend], ctypes.addressof(smem), ctypes.addressof(blocks)))
    return smem.value, blocks.value


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
    """One fused serving tick; ``state`` is the ``(gru, carry, scores,
    det)`` tuple of `tick_reference`. Returns ``(new_state, scores, top)``.

    ``gru`` is a tuple of per-layer tensors, or of per-layer dicts of the
    seven ΔGRU leaves for delta / delta-int; ``det`` is the cascade's
    detector state (bool ``awake``, int32 ``hang`` / ``woken`` / ``ticks``,
    each (N,)) for a cascaded pipeline, else None. On the card the kernel
    writes the new state INTO the given state tensors (the counterpart of
    the reference's buffer donation): treat ``state`` as consumed and use
    the returned one. ``operands`` come from `pack_operands` (built here
    when None). ``fv_out``, an (N, C)
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
    if operands.theta.device != dev:
        raise ValueError(f"operands on {operands.theta.device}, inputs on {dev}")
    if operands.hardware != isinstance(pipeline.frontend, _HardwareBase):
        raise ValueError(
            f"operands packed for another frontend than {pipeline.config.frontend!r}"
        )
    if operands.backend != pipeline.config.classifier_key:
        raise ValueError(
            f"operands packed for {operands.backend!r}, pipeline serves "
            f"{pipeline.config.classifier_key!r}"
        )
    gru, carry, scores, det = state
    n = inp.shape[0]
    cfg = pipeline.config
    c, h, k = cfg.fex.num_channels, cfg.gru.hidden_dim, cfg.gru.num_classes
    in_dim = pipeline.chunk_samples if raw_audio else c
    _require(inp, "inp", (n, in_dim), torch.float32, dev)
    _require(mask, "mask", (n,), torch.bool, dev)
    ptrs = _gru_pointers(pipeline.classifier, gru, n, c, h, dev)
    carry_keys = ("s1", "s2", "r", "j") if operands.hardware else ("s1", "s2")
    if set(carry) != set(carry_keys):
        raise ValueError(f"tick_fused: carry must hold {carry_keys}; got {tuple(carry)}")
    for key in carry_keys:
        _require(carry[key], f"carry[{key!r}]", (n, c), torch.float32, dev)
    hw = HwFrontendArgs()
    if operands.hardware:
        hw.r, hw.j = carry["r"].data_ptr(), carry["j"].data_ptr()
        hw.gain = operands.gain.data_ptr()
        hw.beta, hw.alpha = operands.beta.data_ptr(), operands.alpha.data_ptr()
        (hw.f_free, hw.k_sro, hw.tdc_scale, hw.fv_scale,
         hw.hd2, hw.hd3) = operands.hw_consts
        hw.shared_hd = int(operands.hw_consts[4] == operands.hw_consts[5])
        hw.on = 1
    casc = CascadeArgs()
    if (cfg.cascade is None) != (det is None):
        raise ValueError(
            "tick_fused: det must be given exactly when the pipeline has a cascade"
        )
    if cfg.cascade is not None:
        casc = _cascade_args(cfg.cascade, det, n, dev)
    _require(scores, "scores", (n, k), torch.float32, dev)
    if fv_out is not None:
        _require(fv_out, "fv_out", (n, c), torch.float32, dev)
    top = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return (gru, carry, scores, det), scores, top
    s, one_minus = smoothing_weights(smoothing)
    delta_bulk = 0
    if pipeline.classifier.is_delta:
        delta_bulk = delta_staging(getattr(ptrs, key)[layer] for layer in range(2)
                                   for key in ("x_ref", "h_ref", "acc_x", "acc_h"))
    op = operands
    lib = build.library("tick_fused")
    with torch.cuda.device(dev):
        rc = lib.tick_fused_launch(
            inp.data_ptr(), mask.data_ptr(), n,
            carry["s1"].data_ptr(), carry["s2"].data_ptr(),
            ctypes.addressof(ptrs), ctypes.addressof(hw), ctypes.addressof(casc),
            scores.data_ptr(),
            top.data_ptr(), None if fv_out is None else fv_out.data_ptr(),
            op.w.data_ptr(), op.b.data_ptr(), op.wf.data_ptr(), op.bf.data_ptr(),
            op.theta.data_ptr(), op.coeffs.data_ptr(),
            op.mu.data_ptr(), op.sigma.data_ptr(), op.log_rom.data_ptr(),
            op.sig_rom.data_ptr(), op.tanh_rom.data_ptr(),
            op.q_max, op.q_scale, 1.0 / cfg.fex.frame_len, s, one_minus,
            int(raw_audio), _BACKENDS[op.backend], delta_bulk,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check("tick_fused", rc)
    build.launches["tick_fused"] += 1
    return (gru, carry, scores, det), scores, top
