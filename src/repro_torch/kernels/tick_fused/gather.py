"""Plain version of the ΔGRU gather-compacted column update (K4).

Counterpart of ``src/repro/kernels/tick_fused/kernel.py:76-182``
(`_gather_contrib`, `_mask_rows`, `gather_delta_matmul`,
`gather_delta_intgemm`, `make_sparse_step`), the sparse ``Δ @ W`` that the
reference's megakernel runs inside the tick. The CUDA tick's ΔGRU branch
(``csrc/tick_fused.cu``) is its kernel; these functions are what it is
held against, in the tests and in ``chip_smoke.py``. The CPU tick keeps
the dense ``Δ @ W`` / `intgemm` of the reference's XLA tier, equal to
these on the fixed-point grids.

The block-union fire mask of a thresholded Δ (zeros where not fired) is
compacted by a prefix sum into a list of firing columns, and one rank-1
``Δ[:, i] · W[i]`` is added per listed column, in ascending column order.
Rows whose new state the tick's mask discards are zeroed first, so an
idle stream costs no columns. In the code domain the whole per-tick
contribution is clipped to int24 once, where `intgemm` clips.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels.intgemm.ref import INT24_MAX, INT24_MIN

__all__ = ["gather_delta_matmul", "gather_delta_intgemm", "make_sparse_step"]


def _gather_contrib(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ over firing columns i of outer(d[:, i], w[i]); d (B, I) is a
    thresholded delta block, w (I, N)."""
    bsz, in_dim = d.shape
    col = (d != 0).any(dim=0)  # (I,) block-union fire mask
    n_fired = int(col.sum())
    # compact[j] = index of the j-th firing column (prefix-sum scatter;
    # non-firing columns land in the dropped slot I)
    pos = torch.cumsum(col.to(torch.int64), 0) - 1
    slot = torch.where(col, pos, torch.full_like(pos, in_dim))
    compact = torch.zeros(in_dim + 1, dtype=torch.int64, device=d.device)
    compact[slot[col]] = torch.arange(in_dim, device=d.device)[col]
    acc = torch.zeros((bsz, w.shape[1]), dtype=torch.result_type(d, w), device=d.device)
    for j in range(n_fired):
        i = int(compact[j])
        acc = acc + d[:, i : i + 1] * w[i : i + 1]
    return acc


def _mask_rows(d: torch.Tensor, row_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero the delta rows of streams whose new state the tick discards."""
    if row_mask is None:
        return d
    return torch.where(row_mask[:, None], d, torch.zeros((), dtype=d.dtype, device=d.device))


def gather_delta_matmul(
    d: torch.Tensor, w: torch.Tensor, row_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Float-domain gather Δ·W: drop-in for ``d @ w`` in
    `gru_delta.delta_gru_cell`."""
    return _gather_contrib(_mask_rows(d, row_mask), w)


def gather_delta_intgemm(
    d: torch.Tensor, w: torch.Tensor, row_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Code-domain gather Δ·W: drop-in for ``intgemm(d, w)`` in
    `gru_delta.int_delta_gru_cell`; the int24 clip applies to the whole
    contribution (int32 partial sums are exact: products < 2^21, at most
    96 terms)."""
    contrib = _gather_contrib(
        _mask_rows(d, row_mask).to(torch.int32), w.to(torch.int32)
    )
    return torch.clamp(contrib, INT24_MIN, INT24_MAX)


def make_sparse_step(pipeline):
    """A `tick_reference` ``step_fn`` with gather-compacted Δ·W updates
    for the delta backends, or None (the dense step) for the others.

    It reuses the `gru_delta` classifier step the dense tick runs and
    overrides only its ``matmul=`` hook.
    """
    backend = pipeline.classifier
    if not backend.is_delta:
        return None
    # lazy: core imports the kernels package
    from repro_torch.core import gru_delta, gru_int

    cfg = pipeline.config.gru
    thetas = backend.delta.code_thresholds(cfg.num_layers)

    if backend.name == "delta":
        def step(params, states, fv, wake):
            return gru_delta.delta_classifier_step(
                params, states, fv, cfg, thetas,
                matmul=functools.partial(gather_delta_matmul, row_mask=wake),
            )
        return step

    def step(params, states, fv, wake):
        states, codes = gru_delta.int_delta_classifier_step(
            params, states, gru_int.quantize_acts(fv), cfg, thetas,
            matmul=functools.partial(gather_delta_intgemm, row_mask=wake),
        )
        return states, gru_int.dequantize_acts(codes)
    return step
