"""Temporal-sparsity ΔGRU inference engine (DeltaKWS-style ΔGRU).

PyTorch counterpart of `repro.core.gru_delta`: the paper's 16 -> GRU(48)
-> GRU(48) -> FC(12) classifier evaluated incrementally. Each layer
remembers the last-transmitted input / state vectors and the running
matmul partial sums; per step only the components whose change exceeds
a threshold θ fire a (Δ · weight column) update. Two arithmetic domains:

  * the QAT fake-quant float domain (`delta_*`, backend ``"delta"``),
    the delta sibling of `repro_torch.core.gru`;
  * the bit-exact integer code domain (`int_delta_*`, backend
    ``"delta-int"``, int8 weights through `intgemm`, Q6.8 ROM gates),
    the delta sibling of `repro_torch.core.gru_int`.

Per layer the state is a dict of

  h        the true GRU hidden state (identical to the dense backends),
  x_ref    last-transmitted input memory,
  h_ref    last-transmitted state memory,
  acc_x    running partial sum Σ Δx · W_i (bias not folded in, so a
  acc_h    running partial sum Σ Δh · W_h  zeroed slot is a fresh stream),
  skipped  per-stream int32 count of delta-eligible weight columns
           skipped so far (a layer's column is 3H MACs),
  total    per-stream int32 count of delta-eligible columns offered.

float32 (counters int32) in the float domain, int32 in the code domain.
At θ = 0 only exactly-unchanged components are skipped, the partial sums
telescope on their fixed-point grids, and each domain equals its dense
base backend ("qat", "integer") bit for bit. The gate math after the
partial sums is the dense cell's, through the same Q6.8 ROMs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import quant
from repro_torch.core.gru import GRUConfig, _gate, _layer_weights, _matmul, fc_logits
from repro_torch.core.gru_int import (
    _ACC_SHIFT,
    _ACT_SHIFT,
    _ONE_Q68,
    QuantizedClassifier,
    _accum,
)
from repro_torch.kernels.intgemm import intgemm

__all__ = [
    "DeltaConfig",
    "delta_init_states",
    "delta_gru_cell",
    "delta_classifier_step",
    "delta_classifier_forward",
    "int_delta_init_states",
    "int_delta_gru_cell",
    "int_delta_classifier_step",
    "int_delta_classifier_forward",
    "delta_eligible_macs_per_frame",
    "dense_fc_macs_per_frame",
    "effective_mac_fraction",
    "is_delta_states",
]

DeltaState = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DeltaConfig:
    """ΔGRU thresholds, in the FV_Norm/state value domain (Q6.8 units).

    ``theta_x`` / ``theta_h`` apply to every layer's input / hidden
    deltas; ``per_layer`` overrides both per layer as a tuple of
    (theta_x, theta_h) pairs (length must equal ``gru.num_layers``).
    Thresholds are snapped to the Q6.8 grid (`code_thresholds`), so the
    float and code domains fire identically: a delta fires when
    ``|Δ| > θ`` with both sides on the grid.
    """

    theta_x: float = 0.0
    theta_h: float = 0.0
    per_layer: Optional[Tuple[Tuple[float, float], ...]] = None

    def __post_init__(self):
        thetas = [self.theta_x, self.theta_h]
        if self.per_layer is not None:
            # nested tuples keep the config hashable
            object.__setattr__(
                self,
                "per_layer",
                tuple((float(tx), float(th)) for tx, th in self.per_layer),
            )
            thetas += [t for pair in self.per_layer for t in pair]
        if any(t < 0 for t in thetas):
            raise ValueError(f"delta thresholds must be >= 0; got {self}")

    def code_thresholds(self, num_layers: int) -> Tuple[Tuple[int, int], ...]:
        """Per-layer (θ_x, θ_h) in integer Q6.8 code units."""
        if self.per_layer is not None:
            if len(self.per_layer) != num_layers:
                raise ValueError(
                    f"DeltaConfig.per_layer has {len(self.per_layer)} "
                    f"entries for {num_layers} GRU layers"
                )
            pairs = self.per_layer
        else:
            pairs = ((self.theta_x, self.theta_h),) * num_layers
        scale = 2.0 ** quant.ACT_Q6_8.frac_bits
        return tuple(
            (int(round(tx * scale)), int(round(th * scale))) for tx, th in pairs
        )


def _layer_dims(config: GRUConfig) -> List[Tuple[int, int]]:
    h = config.hidden_dim
    return [
        (config.input_dim if layer == 0 else h, h)
        for layer in range(config.num_layers)
    ]


def delta_eligible_macs_per_frame(config: GRUConfig) -> int:
    """MACs per frame a ΔGRU can skip: the GRU matmul lanes (each input /
    state component drives a 3H-wide weight column)."""
    return sum(3 * h * (i + h) for i, h in _layer_dims(config))


def dense_fc_macs_per_frame(config: GRUConfig) -> int:
    """The always-dense FC head's MACs per frame (never delta-skipped)."""
    return config.num_classes * config.hidden_dim


def _zeros_state(config, batch, dtype, device) -> List[DeltaState]:
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    return [
        {
            "h": z(batch, h),
            "x_ref": z(batch, in_dim),
            "h_ref": z(batch, h),
            "acc_x": z(batch, 3 * h),
            "acc_h": z(batch, 3 * h),
            "skipped": z(batch, dt=torch.int32),
            "total": z(batch, dt=torch.int32),
        }
        for in_dim, h in _layer_dims(config)
    ]


def delta_init_states(config: GRUConfig, batch: int, device) -> List[DeltaState]:
    """Float-domain per-layer delta state; all zeros is the fresh state
    (empty memories, empty partial sums, zero counters)."""
    return _zeros_state(config, batch, torch.float32, device)


def int_delta_init_states(config: GRUConfig, batch: int, device) -> List[DeltaState]:
    """Code-domain per-layer delta state (int32 Q6.8 / frac-15 codes)."""
    return _zeros_state(config, batch, torch.int32, device)


def is_delta_states(states: Any) -> bool:
    """True when ``states`` is a delta-backend state list / tuple."""
    return (
        isinstance(states, (list, tuple))
        and len(states) > 0
        and isinstance(states[0], dict)
        and "skipped" in states[0]
    )


def _count_macs(st: DeltaState, fire_x: torch.Tensor, fire_h: torch.Tensor):
    """Advance the per-stream skipped / total counters by one step, in
    column units (a layer offers I + H columns per frame)."""
    in_dim, h = fire_x.shape[-1], fire_h.shape[-1]
    fired = fire_x.sum(-1, dtype=torch.int32) + fire_h.sum(-1, dtype=torch.int32)
    skipped = st["skipped"] + (in_dim + h - fired)
    total = st["total"] + (in_dim + h)
    return skipped, total


def _thresholded(new: torch.Tensor, ref: torch.Tensor, theta):
    """(Δ with the non-firing components zeroed, fire mask)."""
    d = new - ref
    fire = torch.abs(d) > theta
    return torch.where(fire, d, torch.zeros((), dtype=d.dtype, device=d.device)), fire


# --------------------------------------------------------------------------
# float (QAT fake-quant) domain
# --------------------------------------------------------------------------

def delta_gru_cell(
    layer: Dict[str, torch.Tensor],
    st: DeltaState,
    x: torch.Tensor,
    config: GRUConfig,
    thetas: Tuple[int, int],
    matmul=None,
) -> Tuple[DeltaState, torch.Tensor]:
    """One ΔGRU step, QAT float domain: x (B, I) -> (new state, h' (B, H)).

    ``matmul`` overrides how a Δ·W contribution is evaluated (default the
    dense ``dx @ w``); the tick's plain version passes the gather-
    compacted product of `repro_torch.kernels.tick_fused.gather`.
    """
    aq = lambda v: quant.fake_quant(v, quant.ACT_Q6_8)  # noqa: E731
    w_i, w_h, b_i, b_h = _layer_weights(layer)
    tx, th = thetas
    scale = quant.ACT_Q6_8.scale
    mm = _matmul if matmul is None else matmul

    dx, fire_x = _thresholded(x, st["x_ref"], tx * scale)
    x_ref = st["x_ref"] + dx
    acc_x = st["acc_x"] + mm(dx, w_i)

    dh, fire_h = _thresholded(st["h"], st["h_ref"], th * scale)
    h_ref = st["h_ref"] + dh
    acc_h = st["acc_h"] + mm(dh, w_h)

    gi = aq(acc_x + b_i)
    gh = aq(acc_h + b_h)
    i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
    r = _gate("sigmoid", i_r + h_r)
    z = _gate("sigmoid", i_z + h_z)
    n = _gate("tanh", i_n + aq(r * h_n))
    h_new = aq((1.0 - z) * n + z * st["h"])

    skipped, total = _count_macs(st, fire_x, fire_h)
    new_st = {
        "h": h_new, "x_ref": x_ref, "h_ref": h_ref,
        "acc_x": acc_x, "acc_h": acc_h,
        "skipped": skipped, "total": total,
    }
    return new_st, h_new


def _quantized(config: GRUConfig) -> GRUConfig:
    # the delta engine is always quantized, whatever config.quantized says
    return config if config.quantized else dataclasses.replace(config, quantized=True)


def delta_classifier_step(
    params: Dict[str, Any],
    states: List[DeltaState],
    fv_t: torch.Tensor,
    config: GRUConfig,
    thetas: Tuple[Tuple[int, int], ...],
    matmul=None,
) -> Tuple[List[DeltaState], torch.Tensor]:
    """Streaming ΔGRU step: one frame (B, C) -> (new states, (B, K)).

    The input is snapped to the Q6.8 grid first (a no-op for frames the
    frontend made): the memories must stay on the grid for the partial
    sums to telescope exactly.
    """
    new_states = []
    x = quant.fake_quant(fv_t, quant.ACT_Q6_8)
    for layer, st, t in zip(params["gru"], states, thetas):
        st, x = delta_gru_cell(layer, st, x, config, t, matmul=matmul)
        new_states.append(st)
    return new_states, fc_logits(params, x, _quantized(config))


def delta_classifier_forward(
    params: Dict[str, Any],
    fv: torch.Tensor,
    config: GRUConfig,
    thetas: Tuple[Tuple[int, int], ...],
    return_states: bool = False,
):
    """fv (B, T, C) -> per-frame logits (B, T, K); ``return_states`` also
    returns the final per-layer delta states."""
    states = delta_init_states(config, fv.shape[0], fv.device)
    logits = []
    for t in range(fv.shape[1]):
        states, lg = delta_classifier_step(params, states, fv[:, t], config, thetas)
        logits.append(lg)
    logits = torch.stack(logits, dim=1)
    return (logits, states) if return_states else logits


# --------------------------------------------------------------------------
# integer code domain
# --------------------------------------------------------------------------

def int_delta_gru_cell(
    layer: Dict[str, torch.Tensor],
    st: DeltaState,
    x: torch.Tensor,
    config: GRUConfig,
    thetas: Tuple[int, int],
    matmul=None,
) -> Tuple[DeltaState, torch.Tensor]:
    """One ΔGRU step on codes: x (B, I) int32 Q6.8 -> (state, h' codes).

    ``matmul`` overrides how a Δ·W contribution is evaluated (default the
    int24-saturating `intgemm`, which clips the per-step contribution;
    the accumulators themselves are not clipped).
    """
    del config  # geometry is carried by the code tensors
    tx, th = thetas
    mm = intgemm if matmul is None else matmul

    dx, fire_x = _thresholded(x, st["x_ref"], tx)
    x_ref = st["x_ref"] + dx
    acc_x = st["acc_x"] + mm(dx.contiguous(), layer["w_i"])

    dh, fire_h = _thresholded(st["h"], st["h_ref"], th)
    h_ref = st["h_ref"] + dh
    acc_h = st["acc_h"] + mm(dh.contiguous(), layer["w_h"])

    gi = quant.clip_act_codes(quant.round_shift_even(acc_x + layer["b_i"], _ACC_SHIFT))
    gh = quant.clip_act_codes(quant.round_shift_even(acc_h + layer["b_h"], _ACC_SHIFT))
    i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
    r = quant.lut_sigmoid_q68(i_r + h_r)
    z = quant.lut_sigmoid_q68(i_z + h_z)
    rn = quant.clip_act_codes(quant.round_shift_even(r * h_n, _ACT_SHIFT))
    n = quant.lut_tanh_q68(i_n + rn)
    h_new = quant.clip_act_codes(
        quant.round_shift_even((_ONE_Q68 - z) * n + z * st["h"], _ACT_SHIFT)
    )

    skipped, total = _count_macs(st, fire_x, fire_h)
    new_st = {
        "h": h_new, "x_ref": x_ref, "h_ref": h_ref,
        "acc_x": acc_x, "acc_h": acc_h,
        "skipped": skipped, "total": total,
    }
    return new_st, h_new


def int_delta_classifier_step(
    qparams: QuantizedClassifier,
    states: List[DeltaState],
    fv_t: torch.Tensor,
    config: GRUConfig,
    thetas: Tuple[Tuple[int, int], ...],
    matmul=None,
) -> Tuple[List[DeltaState], torch.Tensor]:
    """Streaming ΔGRU step on codes: one frame (B, C) -> (states, (B, K))."""
    new_states = []
    x = fv_t
    for layer, st, t in zip(qparams.gru, states, thetas):
        st, x = int_delta_gru_cell(layer, st, x, config, t, matmul=matmul)
        new_states.append(st)
    return new_states, _accum(x, qparams.fc_w, qparams.fc_b)


def int_delta_classifier_forward(
    qparams: QuantizedClassifier,
    fv_codes: torch.Tensor,
    config: GRUConfig,
    thetas: Tuple[Tuple[int, int], ...],
    return_states: bool = False,
):
    """fv codes (B, T, C) -> per-frame logit codes (B, T, K)."""
    states = int_delta_init_states(config, fv_codes.shape[0], fv_codes.device)
    logits = []
    for t in range(fv_codes.shape[1]):
        states, lg = int_delta_classifier_step(
            qparams, states, fv_codes[:, t].contiguous(), config, thetas
        )
        logits.append(lg)
    logits = torch.stack(logits, dim=1)
    return (logits, states) if return_states else logits


# --------------------------------------------------------------------------
# sparsity telemetry
# --------------------------------------------------------------------------

def effective_mac_fraction(states: List[DeltaState], config: GRUConfig) -> torch.Tensor:
    """Per-stream effective-MAC fraction in [0, 1] from the counters.

    executed / offered over the whole classifier: the delta-eligible GRU
    counters (columns converted to MACs per layer) plus the always-dense
    FC head, folded back in from the frame count the totals imply.
    Streams with no traffic yet report 1.0. float32, reduced in the
    reference's order.
    """
    dims = _layer_dims(config)
    f32 = torch.float32
    skipped = 0
    total = 0
    for st, (_, h) in zip(states, dims):
        skipped = skipped + st["skipped"].to(f32) * (3 * h)
        total = total + st["total"].to(f32) * (3 * h)
    per_frame = float(delta_eligible_macs_per_frame(config))
    fc = float(dense_fc_macs_per_frame(config))
    n_frames = total / per_frame
    executed = total - skipped + n_frames * fc
    offered = total + n_frames * fc
    one = torch.ones((), dtype=f32, device=total.device)
    return torch.where(total > 0, executed / torch.maximum(offered, one), one)
