"""Weights carried across from the reference, through numpy.

The reference's float parameter pytree, its AdamW state,
`QuantizedClassifier` codes,
norm stats, ΔGRU states, cascade detector states, whole serving states,
hardware-frontend states (a die drawn with ``jax.random`` and its
calibration) and the LM backbones' parameter and cache trees arrive as
numpy arrays (for example through
``jax.tree_util.tree_map(np.asarray, tree)``) and leave as the port's
tensors on ``device``, in the same layouts: ``w_i`` (I, 3H), ``w_h``
(H, 3H), ``fc.w`` (H, K). This module takes numpy only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fex import FExNormStats
from repro_torch.core.frontend import FrontendState
from repro_torch.core.gru_int import QuantizedClassifier
from repro_torch.core.tdfex import TDFExState
from repro_torch.serving.serve_loop import ServerState

__all__ = [
    "params_from_numpy",
    "opt_state_from_numpy",
    "gru_layer_from_numpy",
    "quantized_from_numpy",
    "norm_stats_from_numpy",
    "delta_states_from_numpy",
    "cascade_state_from_numpy",
    "frontend_state_from_numpy",
    "server_state_from_numpy",
    "lm_params_from_numpy",
]


_GRU_KEYS = ("w_i", "w_h", "b_i", "b_h")


def _t(a, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def params_from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """``{"gru": [{w_i, w_h, b_i, b_h}, ...], "fc": {w, b}}`` of numpy
    float arrays -> the same dict of float32 tensors."""
    f = lambda a: _t(a, device, torch.float32)  # noqa: E731
    return {
        "gru": [dict(zip(_GRU_KEYS, gru_layer_from_numpy(layer, device)))
                for layer in tree["gru"]],
        "fc": {"w": f(tree["fc"]["w"]), "b": f(tree["fc"]["b"])},
    }


def opt_state_from_numpy(state: Dict[str, Any], device) -> Dict[str, Any]:
    """An AdamW state ``{"step": int32 scalar, "m": ..., "v": ...}`` of
    numpy arrays, the moments shaped like the params (float32 leaves, or
    ``{"q": int8, "s": float32}`` rows for int8 moments) -> the same tree
    of tensors, dtypes checked (`repro_torch.training.optimizer`)."""

    def moments(tree):
        if isinstance(tree, (list, tuple)):
            return [moments(v) for v in tree]
        if isinstance(tree, dict) and set(tree) != {"q", "s"}:
            return {k: moments(v) for k, v in tree.items()}
        if isinstance(tree, dict):
            q, s = np.asarray(tree["q"]), np.asarray(tree["s"])
            if q.dtype != np.int8 or s.dtype != np.float32:
                raise ValueError(f"an int8 moment holds int8 q and float32 s; got {q.dtype}, {s.dtype}")
            return {"q": torch.tensor(q, device=device), "s": torch.tensor(s, device=device)}
        a = np.asarray(tree)
        if a.dtype != np.float32:
            raise ValueError(f"a float moment is float32; got {a.dtype}")
        return torch.tensor(a, device=device)

    step = np.asarray(state["step"])
    if step.dtype != np.int32 or step.shape != ():
        raise ValueError(f"step is an int32 scalar; got {step.dtype} {step.shape}")
    return {"step": torch.tensor(step, device=device),
            "m": moments(state["m"]), "v": moments(state["v"])}


def gru_layer_from_numpy(layer: Dict[str, Any], device) -> Tuple[torch.Tensor, ...]:
    """One GRU layer of the reference, ``{w_i, w_h, b_i, b_h}`` as numpy
    float arrays -> the four operands of `kernels.gru_sequence`, float32:
    (w (I, 3H), u (H, 3H), b_i (3H,), b_h (3H,))."""
    return tuple(_t(layer[k], device, torch.float32) for k in _GRU_KEYS)


def quantized_from_numpy(q: Any, device) -> QuantizedClassifier:
    """An object with ``gru`` (per-layer dicts of int8 weight / int32
    bias codes), ``fc_w`` and ``fc_b`` numpy arrays -> the port's
    `QuantizedClassifier`."""
    wt = lambda a: _t(a, device, torch.int8)  # noqa: E731
    bt = lambda a: _t(a, device, torch.int32)  # noqa: E731
    return QuantizedClassifier(
        gru=tuple(
            {"w_i": wt(l["w_i"]), "w_h": wt(l["w_h"]),
             "b_i": bt(l["b_i"]), "b_h": bt(l["b_h"])}
            for l in q.gru
        ),
        fc_w=wt(q.fc_w),
        fc_b=bt(q.fc_b),
    )


def norm_stats_from_numpy(mu, sigma, device) -> FExNormStats:
    """Per-channel FV_Log mean and std -> `FExNormStats` (float32)."""
    return FExNormStats(
        mu=_t(mu, device, torch.float32), sigma=_t(sigma, device, torch.float32)
    )


def delta_states_from_numpy(states, device) -> List[Dict[str, torch.Tensor]]:
    """A ΔGRU state (a list of per-layer dicts of numpy arrays: float32
    for "delta", int32 for "delta-int", int32 counters) -> the same list
    of dicts of tensors, dtypes kept, so a server can start mid-stream
    from the reference's state."""
    return [
        {k: torch.tensor(np.array(v), device=device) for k, v in layer.items()}
        for layer in states
    ]


def cascade_state_from_numpy(det, device) -> Dict[str, torch.Tensor]:
    """A cascade detector state (a dict of (N,) numpy arrays: bool
    ``awake``, int32 ``hang`` / ``woken`` / ``ticks``) -> the same dict of
    tensors, dtypes checked, so a server can start mid-stream from the
    reference's state."""
    want = {"awake": np.bool_, "hang": np.int32, "woken": np.int32,
            "ticks": np.int32}
    if set(det) != set(want):
        raise ValueError(f"a detector state holds {sorted(want)}; got {sorted(det)}")
    out = {}
    for key, dtype in want.items():
        a = np.array(det[key])
        if a.dtype != dtype:
            raise ValueError(f"det[{key!r}] must be {np.dtype(dtype)}; got {a.dtype}")
        out[key] = torch.tensor(a, device=device)
    return out


def frontend_state_from_numpy(
    device,
    gain_mismatch=None,
    cf_mismatch=None,
    beta=None,
    alpha=None,
    coeffs=None,
    mu=None,
    sigma=None,
) -> FrontendState:
    """A reference `FrontendState`'s leaves as numpy arrays -> the port's
    `FrontendState` on ``device``: the die's ``gain_mismatch`` /
    ``cf_mismatch`` (both or neither), its calibration ``beta`` /
    ``alpha``, the designed (5, C) ``coeffs`` (taken as they are, not
    redesigned) and the norm stats ``mu`` / ``sigma``. Leaves left None
    stay None, so a die drawn with ``jax.random`` computes the same thing
    in the port."""
    f = lambda a: None if a is None else _t(a, device, torch.float32)  # noqa: E731
    chip: Optional[TDFExState] = None
    if (gain_mismatch is None) != (cf_mismatch is None):
        raise ValueError("a chip needs both gain_mismatch and cf_mismatch")
    if gain_mismatch is not None:
        chip = TDFExState(gain_mismatch=f(gain_mismatch), cf_mismatch=f(cf_mismatch))
    stats = None if mu is None else norm_stats_from_numpy(mu, sigma, device)
    return FrontendState(norm_stats=stats, chip=chip, beta=f(beta), alpha=f(alpha),
                         coeffs=f(coeffs))


def server_state_from_numpy(gru, carry, scores, det, device):
    """A reference `ServerState`'s leaves as numpy arrays (on a sharded
    reference server, gathered from its mesh in global slot order) -> the
    port's `repro_torch.serving.serve_loop.ServerState` on ``device``,
    every dtype kept: ``gru`` per-layer arrays (float32 or int32 codes) or
    ΔGRU dicts, ``carry`` a dict of float32 arrays, ``scores`` float32,
    ``det`` a detector state or None. Lets a test hold a port server's
    state against the reference's leaf by leaf (`ServerState.leaves`)."""
    layers = tuple(gru)
    if layers and isinstance(layers[0], dict):
        layers = tuple(delta_states_from_numpy(layers, device))
    else:
        layers = tuple(torch.tensor(np.array(h), device=device) for h in layers)
    return ServerState(
        gru=layers,
        carry={k: _t(v, device, torch.float32) for k, v in carry.items()},
        scores=_t(scores, device, torch.float32),
        det=None if det is None else cascade_state_from_numpy(det, device),
    )


def _lm_leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16: torch.from_numpy has no bf16, so the bits
        # cross as int16 and are viewed back
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def lm_params_from_numpy(tree: Any, device) -> Any:
    """An LM backbone's parameter or cache tree (`repro.models`: nested
    dicts, lists and tuples of numpy arrays, float32 or ``ml_dtypes``
    bfloat16 leaves) -> the same tree of tensors on ``device``, every
    dtype and bit kept."""
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(lm_params_from_numpy(v, device) for v in tree)
    return _lm_leaf(tree, device)
