"""Mixture-of-Experts FFN, the one-card route.

PyTorch counterpart of `repro.models.moe`'s ``moe_apply`` without a
model axis (`moe.py:228-241` and the shared experts): route every token
to its top-k experts, gather the tokens of each expert into a buffer of
fixed capacity C = max(int(T * top_k / E * capacity_factor), 4), run the
expert FFNs as one batched product, and add the results back weighted by
the gates. Overflow tokens are dropped; experts padded past
``num_experts`` get -inf router logits and never receive a token. All
bookkeeping stays in (T * k,) index space, integer and equal to the
reference's.

The model-axis ``shard_map`` route (expert parallelism over several
cards, one psum over "model") is not ported: a ``mesh_ctx`` with a model
axis raises, naming ROADMAP.md item 6. The port defines no MeshContext;
``mesh_ctx`` is otherwise accepted and ignored.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, mlp_apply, mlp_init, wide
from repro_torch.models.moe_quant import dequant_weight

__all__ = ["moe_init", "moe_apply", "padded_num_experts"]


def padded_num_experts(num_experts: int, mesh_ctx=None) -> int:
    """``num_experts`` rounded up to a multiple of the mesh's model-axis
    size (1 without a mesh)."""
    m = mesh_ctx.model_size if mesh_ctx is not None else 1
    return ((num_experts + m - 1) // m) * m


def moe_init(gen: torch.Generator, cfg, mesh_ctx=None) -> dict:
    """One MoE FFN layer's float32 parameters: the router (d, E_pad), the
    padded expert banks (E_pad, d, f) / (E_pad, f, d) and, with shared
    experts, a ``shared`` MLP f * num_shared_experts wide."""
    m = cfg.moe
    e_pad = padded_num_experts(m.num_experts, mesh_ctx)
    d, f = cfg.d_model, m.d_expert
    p = {
        "router": dense_init(gen, (d, e_pad)),
        # fan_in = shape[0] (E_pad) for the up and gate banks, as the reference draws them
        "w_up": dense_init(gen, (e_pad, d, f)),
        "w_gate": dense_init(gen, (e_pad, d, f)),
        "w_down": dense_init(gen, (e_pad, f, d), fan_in=f),
    }
    if m.num_shared_experts:
        p["shared"] = mlp_init(gen, d, f * m.num_shared_experts, cfg.mlp_act)
    return p


def _expert_ffn(p, xb: torch.Tensor, act: str) -> torch.Tensor:
    """xb (E, C, d) -> (E, C, d), batched over the experts; the banks may
    be int8 ``{"q", "s"}``. SiLU-gated whatever ``act`` is, as the
    reference's."""
    dt = xb.dtype
    up = torch.einsum("ecd,edf->ecf", xb, dequant_weight(p["w_up"], dt))
    gate = torch.einsum("ecd,edf->ecf", xb, dequant_weight(p["w_gate"], dt))
    h = F.silu(gate) * up
    return torch.einsum("ecf,efd->ecd", h, dequant_weight(p["w_down"], dt))


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest of each row, ties to the lower
    index. A stable descending sort keeps equal values in index order,
    so a tie is settled as the reference settles it (``torch.topk``
    promises no order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x: torch.Tensor, router: torch.Tensor, num_experts: int, top_k: int):
    """(probs (T, E_pad), gates (T, k), idx (T, k)): float32 router
    logits, padded experts masked with -inf, softmax, top-k, the gates
    renormalized."""
    f32 = wide(x.dtype)
    logits = x.to(f32) @ router.to(f32)
    pad_mask = torch.arange(router.shape[1], device=x.device) < num_experts
    logits = torch.where(pad_mask[None, :], logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def _load(idx: torch.Tensor, e_pad: int) -> torch.Tensor:
    """The share of the T * k choices each expert received, float32."""
    counts = torch.zeros((e_pad,), dtype=torch.float32, device=idx.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), dtype=torch.float32, device=idx.device))
    return counts / idx.numel()


def _dispatch(idx: torch.Tensor, e_pad: int, capacity: int):
    """The integer bookkeeping of the dispatch: (keep (T*k,), slot
    (T*k,), tok_for_slot (n_slots,), valid_slot (n_slots,)). A kept
    (token, choice) takes slot ``expert * capacity + rank``, its rank the
    count of earlier choices of that expert; a choice past its expert's
    capacity goes to the trash slot n_slots, which is cut off."""
    t, top_k = idx.shape
    dev = idx.device
    flat_e = idx.reshape(-1)
    flat_tok = torch.repeat_interleave(torch.arange(t, dtype=torch.int32, device=dev), top_k)
    # jax.nn.one_hot, transposed to (E_pad, T*k) so the exclusive rank is a
    # scan along the inner dim
    onehot = (torch.arange(e_pad, device=dev)[:, None] == flat_e[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot  # exclusive rank an expert
    pos_in_e = torch.sum(pos * onehot, dim=0)
    keep = pos_in_e < capacity
    n_slots = e_pad * capacity
    slot = torch.where(keep, flat_e * capacity + pos_in_e, n_slots)

    def invert(values, dtype):  # .at[slot].max(values) into zeros
        return torch.zeros((n_slots + 1,), dtype=dtype, device=dev).scatter_reduce(
            0, slot, values, "amax")[:-1]

    tok_for_slot = invert(flat_tok, torch.int32)
    valid_slot = invert(keep.to(torch.int32), torch.int32)
    return keep, slot, tok_for_slot, valid_slot


def _route_and_compute(x: torch.Tensor, p, *, num_experts: int, top_k: int, capacity: int,
                       act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (y (T, d): the experts' contributions, the aux loss)."""
    t, d = x.shape
    wu = p["w_up"]["q"] if isinstance(p["w_up"], dict) else p["w_up"]
    e_pad = wu.shape[0]
    probs, gates, idx = _route(x, p["router"], num_experts, top_k)

    # Switch-style load-balance loss: E * sum(importance * load)
    importance = probs.mean(dim=0)  # (E_pad,)
    aux = num_experts * torch.sum(importance * _load(idx, e_pad).to(probs.dtype))

    keep, slot, tok_for_slot, valid_slot = _dispatch(idx, e_pad, capacity)
    n_slots = e_pad * capacity
    flat_g = gates.reshape(-1).to(x.dtype)
    gate_for_slot = torch.zeros((n_slots + 1,), dtype=x.dtype, device=x.device).scatter_reduce(
        0, slot, torch.where(keep, flat_g, 0), "amax")[:-1]
    # index_select: its backward adds rows by index_add, where advanced
    # indexing's sorts the (n_slots,) indices first
    buf = torch.index_select(x, 0, tok_for_slot.to(torch.int64)) * valid_slot[:, None].to(x.dtype)
    h = _expert_ffn(p, buf.reshape(e_pad, capacity, d), act)
    contrib = h.reshape(n_slots, d) * (gate_for_slot * valid_slot.to(x.dtype))[:, None]
    return _combine(contrib, slot.reshape(t, top_k)), aux


def _combine(contrib: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``zeros.at[tok_for_slot].add(contrib)``: each token's kept
    contributions added in slot order (by expert, as the reference's
    scatter adds them), one gathered (T, d) add a choice in the
    activation dtype. A fixed order, where an ``index_add`` on the card
    adds in whatever order its atomics land; dropped choices (the trash
    slot) add zero. slot (T, k), contrib (n_slots, d)."""
    padded = torch.cat([contrib, contrib.new_zeros((1, contrib.shape[1]))])
    slot = torch.sort(slot, dim=-1).values
    y = torch.zeros((slot.shape[0], contrib.shape[1]), dtype=contrib.dtype,
                    device=contrib.device)
    for j in range(slot.shape[1]):
        y = y + torch.index_select(padded, 0, slot[:, j])
    return y


def moe_apply(p, x: torch.Tensor, cfg, mesh_ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN layer on x (B, S, d). Returns (y, aux_loss)."""
    if mesh_ctx is not None and getattr(mesh_ctx, "model_axis", None) is not None:
        raise NotImplementedError(
            "the model-axis MoE route (experts sharded over several cards) is not ported: "
            "ROADMAP.md queue 1, item 6")
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    capacity = max(int(t * m.top_k / m.num_experts * m.capacity_factor), 4)
    y, aux = _route_and_compute(x.reshape(t, d), p, num_experts=m.num_experts, top_k=m.top_k,
                                capacity=capacity, act=cfg.mlp_act)
    y = y.reshape(b, s, d)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, cfg.mlp_act)
    return y, aux
