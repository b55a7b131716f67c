"""Public entry point of the state-resident WKV6 kernel.

Counterpart of `repro.kernels.wkv6.ops.wkv6`. A CUDA tensor launches the
hand-written kernel (``csrc/wkv6.cu``, which replaces
``src/repro/kernels/wkv6/kernel.py:62 wkv6_pallas``); a CPU tensor takes
the plain version `wkv6_plain`; any other device raises. There is no
block-size or tier argument.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.wkv6.ref import wkv6_plain

__all__ = ["wkv6", "MAX_HEAD_DIM"]

#: The largest head size P the kernel takes (it is built at P = 64: a
#: block's 128 threads keep the 64 x 64 state as 4 x 8 register tiles).
MAX_HEAD_DIM = 64


def wkv6(r, k, v, logw, u) -> torch.Tensor:
    """r, k, v, logw (B, T, H, P) (logw <= 0) and u (H, P) -> y
    (B, T, H, P) in r's dtype, from a zero state; the state is kept in
    float32 and not returned."""
    if not build.route(r, "wkv6"):  # float32 state here too, as on the card
        return wkv6_plain(*(a.to(torch.float32) for a in (r, k, v, logw, u))).to(r.dtype)
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wkv6 takes float32 or bfloat16 r; got {r.dtype}")
    if r.dim() != 4:
        raise ValueError(f"wkv6 takes (B, T, H, P) r; got {tuple(r.shape)}")
    b, t, h, p = r.shape
    for name, a in (("k", k), ("v", v), ("logw", logw)):
        if a.shape != r.shape:
            raise ValueError(f"wkv6: {name} {tuple(a.shape)} is not r's {tuple(r.shape)}")
        if a.dtype != r.dtype:
            raise TypeError(f"wkv6: {name} is {a.dtype}, r is {r.dtype}")
    if u.shape != (h, p):
        raise ValueError(f"wkv6: u {tuple(u.shape)} is not (H, P) = {(h, p)}")
    for name, a in (("k", k), ("v", v), ("logw", logw), ("u", u)):
        if a.device != r.device:
            raise ValueError(f"r on {r.device} but {name} on {a.device}")
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wkv6 takes float32 or bfloat16 u; got {u.dtype}")
    if p > MAX_HEAD_DIM:
        raise ValueError(f"wkv6: head size P={p} is above the kernel's {MAX_HEAD_DIM}")
    y = torch.empty_like(r, memory_format=torch.contiguous_format)
    if y.numel() == 0:
        return y
    r, k, v, logw = (a.contiguous() for a in (r, k, v, logw))
    u = u.to(torch.float32).contiguous()
    lib = build.library("wkv6")
    with torch.cuda.device(r.device):
        rc = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            y.data_ptr(), int(r.dtype == torch.bfloat16), b, t, h, p,
            torch.cuda.current_stream(r.device).cuda_stream,
        )
    build.check("wkv6", rc)
    build.launches["wkv6"] += 1
    return y
