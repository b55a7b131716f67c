"""Plain version of the GRU sequence kernel: the core float GRU.

Counterpart of `repro.kernels.gru.ref.gru_sequence_ref`; it delegates to
`repro_torch.core.gru.gru_layer` with ``quantized=False``, so the kernel
and the software model share one definition.
"""

from __future__ import annotations

import torch

from repro_torch.core.gru import GRUConfig, gru_layer

__all__ = ["gru_sequence_plain"]


def gru_sequence_plain(xs, w, u, b_i, b_h, h0) -> torch.Tensor:
    """(T, B, I) time-major in -> (T, B, H) time-major out.

    Computes in float32, whatever the operands' dtype, and returns xs's
    dtype: the kernel keeps its state and sums in float32 too.
    """
    f = lambda a: a.to(torch.float32)  # noqa: E731
    cfg = GRUConfig(input_dim=xs.shape[-1], hidden_dim=u.shape[0], quantized=False)
    layer = {"w_i": f(w), "w_h": f(u), "b_i": f(b_i), "b_h": f(b_h)}
    hs, _ = gru_layer(layer, f(xs).transpose(0, 1), cfg, h0=f(h0))
    return hs.transpose(0, 1).to(xs.dtype)
