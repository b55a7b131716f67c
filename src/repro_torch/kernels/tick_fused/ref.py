"""Plain version of the fused serving tick.

Counterpart of `repro.kernels.tick_fused.ref.tick_reference` for every
classifier backend: the frontend feature frame (or an FV_Norm
passthrough), the stage-1 cascade wake gate, every GRU layer through the
pipeline's classifier backend, the FC head, softmax, exponential score
smoothing and the masked state advance. The CPU tier of the serving
tick, and what the CUDA kernel is held against on the card.

The state crossing this boundary is the 4-tuple ``(gru, carry, scores,
det)``; ``gru`` is a tuple of per-layer tensors, or of per-layer dicts
for the ΔGRU backends; ``det`` is the cascade's detector state
(`repro_torch.serving.cascade.init_state`), None for an ungated pipeline.

``step_fn`` overrides the classifier step (default:
``pipeline.streaming_logits_apply``); `gather.make_sparse_step` gives the
gather-compacted ΔGRU step, the plain version of the kernel's sparse
update. It receives the tick's wake mask as a fourth argument, so a
sparse step can drop the Δ·W work of streams whose new state is
discarded.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.frontend import masked_select
from repro_torch.serving import cascade as cascade_lib

# (gru states tuple, frontend carry dict, smoothed scores, detector state)
TickState = Tuple[Any, Any, torch.Tensor, Any]


def softmax(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with the max subtracted, as
    ``jax.nn.softmax``; the denominator is summed left to right, the
    order the CUDA tick uses."""
    e = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
    total = e[..., :1]
    for k in range(1, e.shape[-1]):
        total = total + e[..., k : k + 1]
    return e / total


def smoothing_weights(smoothing: float) -> Tuple[float, float]:
    """``(smoothing, 1 - smoothing)`` rounded as float32 arithmetic does."""
    s = np.float32(smoothing)
    return float(s), float(np.float32(1.0) - s)


def tick_reference(
    pipeline,
    raw_audio: bool,
    params,
    state: TickState,
    inp: torch.Tensor,
    mask: torch.Tensor,
    frontend_state,
    smoothing: float,
    step_fn: Optional[Callable] = None,
):
    """One serving tick on explicit state tensors.

    inp is a raw-audio slab (N, chunk_samples) when ``raw_audio`` else an
    FV_Norm slab (N, C); mask (N,) bool marks slots that submitted this
    tick. Frontend carry, GRU states and smoothed scores advance ONLY
    under the mask: an idle slot's slice of every tensor is returned
    unchanged.

    With a cascade (``pipeline.config.cascade``) the detector scores the
    feature frame and its gate narrows the mask the classifier and the
    scores advance under (``wake = mask & gate``): a submitted but gated
    stream's GRU state holds (its posterior multiplied by ``score_decay``
    when that is not 1), while the frontend carry and the detector state
    advance under the submitted mask. An always-open gate makes
    ``wake == mask``, the ungated tick. Returns ``((gru, carry, scores,
    det), scores, top)``.
    """
    gru_in, carry_in, scores_in, det_in = state
    if raw_audio:
        new_carry, fv = pipeline.streaming_features_apply(
            carry_in, inp, frontend_state
        )
        carry = masked_select(mask, new_carry, carry_in)
    else:
        carry, fv = carry_in, inp
    casc = pipeline.config.cascade
    if casc is not None:
        score = cascade_lib.detector_scores(fv, casc)
        new_det, gate = cascade_lib.gate_step(det_in, score, casc)
        det = masked_select(mask, new_det, det_in)
        wake = mask & gate
    else:
        det, wake = det_in, mask
    if step_fn is None:
        new_gru, logits = pipeline.streaming_logits_apply(params, list(gru_in), fv)
    else:
        new_gru, logits = step_fn(params, list(gru_in), fv, wake)
    gru = masked_select(wake, tuple(new_gru), tuple(gru_in))
    s, one_minus = smoothing_weights(smoothing)
    smoothed = s * scores_in + one_minus * softmax(logits)
    scores = masked_select(wake, smoothed, scores_in)
    if casc is not None and casc.score_decay != 1.0:
        gated = mask & ~wake
        # the reference's weakly typed decay multiplies as a float32
        decayed = float(np.float32(casc.score_decay)) * scores_in
        scores = masked_select(gated, decayed, scores)
    top = torch.argmax(scores, dim=-1)
    return (gru, carry, scores, det), scores, top
