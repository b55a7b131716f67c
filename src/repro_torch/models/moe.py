"""Mixture-of-Experts FFN with expert parallelism.

PyTorch counterpart of `repro.models.moe`. Route every token to its top-k
experts, gather the tokens of each expert into a buffer of fixed capacity
C = max(int(T * top_k / E * capacity_factor), 4), run the expert FFNs as
one batched product, and add the results back weighted by the gates.
Overflow tokens are dropped; experts padded past ``num_experts`` (to a
multiple of the model axis: granite 40 -> 48 at 16) get -inf router
logits and never receive a token. All bookkeeping stays in (T * k,)
index space, integer and equal to the reference's; each token's kept
contributions are added in slot order (`_combine`), a fixed order where
an ``index_add`` on the card would add in whatever order its atomics land.

Without a model axis (``mesh_ctx`` None) the route runs once over every
token. With one, it is the reference's ``shard_map`` route over a device
grid (`distributed.sharding.Mesh`, whose entries may all be one card):
one body a (data, model) grid coordinate, on that coordinate's device.
Data shard i's B / dp rows are routed through the full (replicated)
router, the same on every model shard, so once a data shard; body (i, j)
keeps the choices of its expert slice [j * E_loc, (j + 1) * E_loc) at a
capacity from its own T_loc, and the sum over j in shard order (the
psum over "model") is data shard i's output; aux is the mean over the
data shards. With FSDP axes and T_loc * top_k at most
``cfg.moe.stationary_threshold`` the weights-stationary path runs
instead: all T tokens are routed (capacity from T), each FSDP shard
multiplies its d-slice of a body's buffer by its slice of the banks,
up / gate are summed over the FSDP shards and the output slices
gathered, and each data shard takes back its own rows.

The port keeps each bank whole on one device, so a body's expert slice
(and the FSDP "gather" of its pieces, their concatenation) is a view of
the bank on that device and one copy onto any other; int8 ``{"q",
"s"}`` scales are split only along an axis they have. Gradients flow
through autograd; the dispatch gather's own backward (`_TokenGather`)
adds each token's slots in a fixed order, so a training step on the card
is deterministic.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, mlp_apply, mlp_init, wide
from repro_torch.models.moe_quant import dequant_weight

__all__ = ["MeshContext", "moe_init", "moe_apply", "padded_num_experts"]


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """Mesh + axis-name conventions threaded through model apply fns
    (`distributed.sharding.make_mesh_context` builds one from rules)."""

    mesh: object  # distributed.sharding.Mesh
    dp_axes: Tuple[str, ...] = ("data",)  # batch axes ("pod", "data") multi-pod
    model_axis: Optional[str] = "model"
    # FSDP axes the expert banks are sharded over (empty = no FSDP)
    fsdp_axes: Tuple[str, ...] = ()

    @property
    def model_size(self) -> int:
        if self.model_axis is None:
            return 1
        return self.mesh.shape[self.model_axis]

    def constrain_heads(self, t):
        """The reference pins (B, S, H, D) attention activations to
        batch-over-dp + heads-over-model; that only places data, and the
        port keeps activations whole on one device: the identity."""
        return t

    def constrain_hidden(self, x):
        """The reference pins the residual stream to batch-over-dp; the
        identity here, as `constrain_heads`."""
        return x


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


def _dispatch(idx: torch.Tensor, e_loc: int, capacity: int, e_start: int = 0):
    """The integer bookkeeping of the dispatch to experts [e_start,
    e_start + e_loc): (keep (T*k,), slot (T*k,), tok_for_slot (n_slots,),
    valid_slot (n_slots,)). A kept (token, choice) of a local expert takes
    slot ``(expert - e_start) * capacity + rank``, its rank the count of
    earlier choices of that expert; a choice past its expert's capacity,
    or of an expert of another shard, goes to the trash slot n_slots,
    which is cut off."""
    t, top_k = idx.shape
    dev = idx.device
    flat_e = idx.reshape(-1)
    flat_tok = torch.repeat_interleave(torch.arange(t, dtype=torch.int32, device=dev), top_k)
    local = (flat_e >= e_start) & (flat_e < e_start + e_loc)
    e_rel = torch.where(local, flat_e - e_start, e_loc)  # e_loc: no expert of this shard
    # jax.nn.one_hot, transposed to (E_loc, T*k) so the exclusive rank is a
    # scan along the inner dim
    onehot = (torch.arange(e_loc, device=dev)[:, None] == e_rel[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot  # exclusive rank an expert
    pos_in_e = torch.sum(pos * onehot, dim=0)
    keep = local & (pos_in_e < capacity)
    n_slots = e_loc * capacity
    slot = torch.where(keep, e_rel * capacity + pos_in_e, n_slots)

    def invert(values, dtype):  # .at[slot].max(values) into zeros
        return torch.zeros((n_slots + 1,), dtype=dtype, device=dev).scatter_reduce(
            0, slot, values, "amax")[:-1]

    tok_for_slot = invert(flat_tok, torch.int32)
    valid_slot = invert(keep.to(torch.int32), torch.int32)
    return keep, slot, tok_for_slot, valid_slot


def _routing(x: torch.Tensor, router: torch.Tensor, num_experts: int, e_pad: int,
             top_k: int):
    """(gates (T, k), idx (T, k), aux): the routing of x (T, d) through
    the full (d, E_pad) router and the Switch-style load-balance loss
    E * sum(importance * load)."""
    probs, gates, idx = _route(x, router, num_experts, top_k)
    importance = probs.mean(dim=0)  # (E_pad,)
    aux = num_experts * torch.sum(importance * _load(idx, e_pad).to(probs.dtype))
    return gates, idx, aux


def _compute(x: torch.Tensor, p_loc, gates: torch.Tensor, idx: torch.Tensor, e_start: int,
             capacity: int, act: str, ffn_fn=None) -> torch.Tensor:
    """y (T, d): the contributions of the experts [e_start, e_start +
    E_loc) of ``p_loc``'s banks to the tokens x (T, d) routed as (gates,
    idx). ``ffn_fn``, when given, replaces the expert FFN on the (E_loc,
    C, d) buffer (the weights-stationary path)."""
    t, d = x.shape
    wu = p_loc["w_up"]["q"] if isinstance(p_loc["w_up"], dict) else p_loc["w_up"]
    e_loc = wu.shape[0]
    keep, slot, tok_for_slot, valid_slot = _dispatch(idx, e_loc, capacity, e_start)
    n_slots = e_loc * capacity
    flat_g = gates.reshape(-1).to(x.dtype)
    gate_for_slot = torch.zeros((n_slots + 1,), dtype=x.dtype, device=x.device).scatter_reduce(
        0, slot, torch.where(keep, flat_g, 0), "amax")[:-1]
    valid = valid_slot.to(x.dtype)
    buf = _TokenGather.apply(x, tok_for_slot, slot.reshape(t, idx.shape[1]), e_loc) * valid[:, None]
    buf = buf.reshape(e_loc, capacity, d)
    h = _expert_ffn(p_loc, buf, act) if ffn_fn is None else ffn_fn(buf)
    contrib = h.reshape(n_slots, d) * (gate_for_slot * valid)[:, None]
    return _combine(contrib, slot.reshape(t, idx.shape[1]), e_loc)


def _route_and_compute(x: torch.Tensor, p_loc, e_start: int = 0, *, num_experts: int,
                       e_pad: int, top_k: int, capacity: int, act: str,
                       ffn_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (y (T, d): the contributions of the experts
    [e_start, e_start + E_loc) of ``p_loc``'s banks, the aux loss);
    ``p_loc["router"]`` is the full (d, E_pad) router."""
    gates, idx, aux = _routing(x, p_loc["router"], num_experts, e_pad, top_k)
    return _compute(x, p_loc, gates, idx, e_start, capacity, act, ffn_fn), aux


class _TokenGather(torch.autograd.Function):
    """``x[tok_for_slot]``, the dispatch buffer's rows, whose gradient adds
    each token's kept slots in slot order (`_combine`) in float32 and
    rounds once. index_select's own backward is an index_add: on the CPU
    it adds in index order in float32, as here, but on the card it adds a
    token's slots (and every unfilled slot's zero, all on token 0) in
    whatever order its atomics land, each add rounded to the activation
    dtype, so two runs of a training step would differ. The unfilled
    slots' rows are multiplied by zero after the gather: their gradient
    is zero."""

    @staticmethod
    def forward(ctx, x, tok_for_slot, slot, e_loc):
        ctx.save_for_backward(slot)
        ctx.e_loc = e_loc
        return torch.index_select(x, 0, tok_for_slot.to(torch.int64))

    @staticmethod
    def backward(ctx, grad):
        (slot,) = ctx.saved_tensors
        return _combine(grad.to(wide(grad.dtype)), slot, ctx.e_loc).to(grad.dtype), None, None, None


def _combine(contrib: torch.Tensor, slot: torch.Tensor, e_loc: int) -> torch.Tensor:
    """``zeros.at[tok_for_slot].add(contrib)``: each token's kept
    contributions added in slot order (by expert, as the reference's
    scatter adds them), one gathered (T, d) add a choice in the
    activation dtype. Dropped choices and those of other shards' experts
    (the trash slot, sorted last) add zero; a token keeps at most one
    choice of each of the E_loc experts, so the adds stop after
    min(k, E_loc). slot (T, k), contrib (n_slots, d)."""
    padded = torch.cat([contrib, contrib.new_zeros((1, contrib.shape[1]))])
    slot = torch.sort(slot, dim=-1).values
    y = torch.zeros((slot.shape[0], contrib.shape[1]), dtype=contrib.dtype,
                    device=contrib.device)
    for j in range(min(slot.shape[1], e_loc)):
        y = y + torch.index_select(padded, 0, slot[:, j])
    return y


def _capacity(t: int, m) -> int:
    return max(int(t * m.top_k / m.num_experts * m.capacity_factor), 4)


def moe_apply(p, x: torch.Tensor, cfg, mesh_ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN layer on x (B, S, d). Returns (y, aux_loss)."""
    m = cfg.moe
    b, s, d = x.shape
    wu = p["w_up"]["q"] if isinstance(p["w_up"], dict) else p["w_up"]
    e_pad = wu.shape[0]
    if mesh_ctx is None or mesh_ctx.model_axis is None:
        t = b * s
        y, aux = _route_and_compute(x.reshape(t, d), p, 0, num_experts=m.num_experts,
                                    e_pad=e_pad, top_k=m.top_k, capacity=_capacity(t, m),
                                    act=cfg.mlp_act)
        y = y.reshape(b, s, d)
    else:
        y, aux = _grid_apply(p, x, cfg, mesh_ctx, e_pad)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, cfg.mlp_act)
    return y, aux


# --------------------------------------------------------------------------
# the model-axis route over a device grid
# --------------------------------------------------------------------------

def _size(mesh, axes) -> int:
    return math.prod(mesh.shape[ax] for ax in axes)


def _coord(mesh, fixed: dict) -> tuple:
    """The grid coordinate with the given axes' indices (an int for one
    axis, or a row-major index over a tuple of axes); every other axis at 0."""
    idx = dict.fromkeys(mesh.axis_names, 0)
    for axes, flat in fixed.items():
        axes = (axes,) if isinstance(axes, str) else axes
        for ax in reversed(axes):
            idx[ax] = flat % mesh.shape[ax]
            flat //= mesh.shape[ax]
    return tuple(idx[ax] for ax in mesh.axis_names)


def _on(w, dev):
    """A tensor, or an int8 ``{"q", "s"}`` bank, on ``dev`` (itself when
    already there: a view stays a view)."""
    if isinstance(w, dict):
        return {k: v.to(dev) for k, v in w.items()}
    return w.to(dev)


def _split(w, size: int, dim: int) -> list:
    """A bank split into views of ``size`` along ``dim``; an int8 scale
    (last dim 1) is split along ``dim`` only where it has that axis."""
    if not isinstance(w, dict):
        return list(torch.split(w, size, dim=dim))
    qs = torch.split(w["q"], size, dim=dim)
    last = dim in (-1, w["q"].ndim - 1)
    ss = [w["s"]] * len(qs) if last else torch.split(w["s"], size, dim=dim)
    return [{"q": q, "s": sc} for q, sc in zip(qs, ss)]


def _psum(parts: list, dev) -> torch.Tensor:
    """A sum over shards in shard order, on ``dev``."""
    total = parts[0].to(dev)
    for part in parts[1:]:
        total = total + part.to(dev)
    return total


def _grid_apply(p, x: torch.Tensor, cfg, mc: MeshContext, e_pad: int):
    """The reference's ``shard_map`` route (`moe.py:242-397`) over
    ``mc.mesh``: one body a (data shard i, model shard j), on the grid's
    device at that coordinate (x's device on an abstract mesh)."""
    m = cfg.moe
    mesh = mc.mesh
    b, s, d = x.shape
    n_model = mc.model_size
    if e_pad % n_model:
        raise ValueError(f"moe_apply: {e_pad} experts do not split over a {n_model}-way model "
                         "axis (moe_init pads them under the same mesh context)")
    e_loc = e_pad // n_model
    dp = tuple(mc.dp_axes)
    dp_total = _size(mesh, dp)
    if b % dp_total:
        raise ValueError(f"moe_apply: a batch of {b} rows does not split over {dp_total} data "
                         "shards")
    bb = b // dp_total
    t_loc = bb * s
    fsdp = tuple(mc.fsdp_axes)
    stationary = bool(fsdp) and t_loc * m.top_k <= m.stationary_threshold

    def device(coord):
        dev = mesh.device(coord)
        return x.device if dev is None else dev

    banks = {name: _split(p[name], e_loc, 0) for name in ("w_up", "w_gate", "w_down")}

    def routing(x_, dev):
        # the router is replicated: every model shard of a data shard routes
        # the same tokens alike, so they are routed once and the gates and
        # choices handed to each body
        return _routing(x_.to(dev), p["router"].to(dev), m.num_experts, e_pad, m.top_k)

    if not stationary:
        capacity = _capacity(t_loc, m)
        ys, auxes = [], []
        for i in range(dp_total):
            x_i = x[i * bb:(i + 1) * bb].reshape(t_loc, d)
            gates, idx, aux = routing(x_i, device(_coord(mesh, {dp: i})))
            auxes.append(aux.to(x.device))
            y_parts = []
            for j in range(n_model):
                dev = device(_coord(mesh, {dp: i, mc.model_axis: j}))
                # this layer's FSDP gather of the slice: the slice itself
                p_loc = {name: _on(bank[j], dev) for name, bank in banks.items()}
                y_parts.append(_compute(x_i.to(dev), p_loc, gates.to(dev), idx.to(dev),
                                        j * e_loc, capacity, cfg.mlp_act))
            ys.append(_psum(y_parts, x.device))
        # aux is the same on every model shard; the mean over data
        # (different tokens a shard)
        return torch.cat(ys).reshape(b, s, d), _psum(auxes, x.device) / dp_total

    # ---- stationary path: the tokens move, the banks stay ----
    x_all = x.reshape(b * s, d)  # every data shard's rows, gathered in shard order
    cap_all = _capacity(b * s, m)
    n_fsdp = _size(mesh, fsdp)
    if d % n_fsdp:
        raise ValueError(f"moe_apply: d_model {d} does not split over {n_fsdp} FSDP shards")
    d_shard = d // n_fsdp
    # computed from the gathered token set: the same on every body
    gates, idx, aux = routing(x_all, device(_coord(mesh, {})))
    y_parts = []
    for j in range(n_model):
        dev_j = device(_coord(mesh, {mc.model_axis: j}))
        devs = [device(_coord(mesh, {fsdp: k, mc.model_axis: j})) for k in range(n_fsdp)]
        up_k = [_on(w, dv) for w, dv in zip(_split(banks["w_up"][j], d_shard, 1), devs)]
        gate_k = [_on(w, dv) for w, dv in zip(_split(banks["w_gate"][j], d_shard, 1), devs)]
        down_k = [_on(w, dv) for w, dv in zip(_split(banks["w_down"][j], d_shard, 2), devs)]

        def ffn_stationary(buf, up_k=up_k, gate_k=gate_k, down_k=down_k, devs=devs,
                           dev_j=dev_j):
            """(E_loc, C, d) full-d dispatch buffer -> (E_loc, C, d)."""
            dt = buf.dtype
            sl = [buf[..., k * d_shard:(k + 1) * d_shard].to(dv) for k, dv in enumerate(devs)]
            up = _psum([torch.einsum("ecd,edf->ecf", b_k, dequant_weight(w, dt))
                        for b_k, w in zip(sl, up_k)], dev_j)
            gate = _psum([torch.einsum("ecd,edf->ecf", b_k, dequant_weight(w, dt))
                          for b_k, w in zip(sl, gate_k)], dev_j)
            h = F.silu(gate) * up
            y_sl = [torch.einsum("ecf,efd->ecd", h.to(dv), dequant_weight(w, dt)).to(dev_j)
                    for w, dv in zip(down_k, devs)]
            return torch.cat(y_sl, dim=2)

        p_loc = {name: bank[j] for name, bank in banks.items()}
        y_parts.append(_compute(x_all.to(dev_j), p_loc, gates.to(dev_j), idx.to(dev_j),
                                j * e_loc, cap_all, cfg.mlp_act, ffn_stationary))
    # the psum over model; each data shard's rows of it, in shard order, are y_all
    return _psum(y_parts, x.device).reshape(b, s, d), aux.to(x.device)
