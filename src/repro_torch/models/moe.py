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
`moe_grid`, one body a grid coordinate, on that coordinate's pieces of
the banks and rows, with the collectives of `distributed.collectives`.
The transformer's sharded step calls it on its shares; `moe_apply` with
a mesh context cuts whole tensors into shares (`param_specs`, the batch
over the data-parallel axes) and puts y back together. Body (i, j) keeps
the choices of its expert slice [j * E_loc, (j + 1) * E_loc) of data
shard i's rows, routed through the full (replicated) router, at a
capacity from its own T_loc, and the psum over "model" is data shard i's
output; aux is the mean over the data shards. With FSDP axes and T_loc *
top_k at most ``cfg.moe.stationary_threshold`` the weights-stationary
path runs instead: all T tokens are gathered and routed (capacity from
T), each FSDP shard multiplies its d-slice of a body's buffer by its
slice of the banks, up / gate are summed over the FSDP shards and the
output slices gathered, and each data shard takes back its own rows. A
coordinate can also run alone (the dry run's per-device trace), its
collectives in their lone form.

On a grid whose entries are one device, the pieces are views of the
banks, and the FSDP all-gather of adjacent views of one tensor is a view
(`distributed.collectives.all_gather`): no bank is copied. int8 ``{"q",
"s"}`` scales are split only along an axis they have. Gradients flow
through autograd; the dispatch gather's own backward (`_TokenGather`)
adds each token's slots in a fixed order, so a training step on the card
is deterministic.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import all_gather, axes_size, axis_index, psum
from repro_torch.models.layers import (
    dense_init,
    gather_param,
    mlp_apply,
    mlp_grid,
    mlp_init,
    wide,
)
from repro_torch.models.moe_quant import dequant_weight

__all__ = ["MeshContext", "moe_init", "moe_apply", "moe_grid", "padded_num_experts"]


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """Mesh + axis-name conventions threaded through model apply fns
    (`distributed.sharding.make_mesh_context` builds one from rules).

    ``coord`` None: the step builds every grid coordinate, one process
    (each on its `Mesh.device`). ``coord`` set: the step builds that
    coordinate's share alone, its collectives in their lone form
    (`distributed.collectives`), on parameters that are already the
    coordinate's pieces; ``specs`` then holds the parameters' `P` tree
    (`distributed.sharding.param_specs` of the whole tree)."""

    mesh: object  # distributed.sharding.Mesh
    dp_axes: Tuple[str, ...] = ("data",)  # batch axes ("pod", "data") multi-pod
    model_axis: Optional[str] = "model"
    # FSDP axes the expert banks are sharded over (empty = no FSDP)
    fsdp_axes: Tuple[str, ...] = ()
    coord: Optional[Tuple[int, ...]] = None
    specs: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def model_size(self) -> int:
        if self.model_axis is None:
            return 1
        return self.mesh.shape[self.model_axis]

    @functools.cached_property
    def coords(self) -> tuple:
        """The grid coordinates the step builds, row-major."""
        if self.coord is not None:
            return (tuple(self.coord),)
        return tuple(itertools.product(*(range(n) for n in self.mesh.shape.values())))

    @functools.cached_property
    def groups(self) -> dict:
        """`distributed.collectives`' groups of ``coords``, one entry a
        tuple of axes, filled as the collectives ask."""
        return {}

    def device(self, coord, default):
        """The device of grid coordinate ``coord`` (``default`` on an
        abstract mesh)."""
        dev = self.mesh.device(coord)
        return default if dev is None else dev

    def constrain_heads(self, t):
        """The reference pins (B, S, H, D) attention activations to
        batch-over-dp + heads-over-model; on whole tensors that only
        places data: the identity (the sharded step lays heads out
        itself, `models.attention`)."""
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
    wu = p_loc["w_up"]["q"] if isinstance(p_loc["w_up"], dict) else p_loc["w_up"]
    buf, back = _buffer(x, gates, idx, wu.shape[0], e_start, capacity)
    h = _expert_ffn(p_loc, buf, act) if ffn_fn is None else ffn_fn(buf)
    return _unbuffer(h, back)


def _buffer(x: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor, e_loc: int, e_start: int,
            capacity: int):
    """The (E_loc, C, d) dispatch buffer of the experts [e_start, e_start +
    e_loc) and what `_unbuffer` needs to add their outputs back."""
    t, d = x.shape
    keep, slot, tok_for_slot, valid_slot = _dispatch(idx, e_loc, capacity, e_start)
    n_slots = e_loc * capacity
    flat_g = gates.reshape(-1).to(x.dtype)
    gate_for_slot = torch.zeros((n_slots + 1,), dtype=x.dtype, device=x.device).scatter_reduce(
        0, slot, torch.where(keep, flat_g, 0), "amax")[:-1]
    valid = valid_slot.to(x.dtype)
    slot = slot.reshape(t, idx.shape[1])
    buf = _TokenGather.apply(x, tok_for_slot, slot, e_loc) * valid[:, None]
    return buf.reshape(e_loc, capacity, d), (gate_for_slot * valid, slot, e_loc)


def _unbuffer(h: torch.Tensor, back) -> torch.Tensor:
    """The experts' outputs h (E_loc, C, d) weighted by their gates and
    added back to their tokens: (T, d)."""
    weight, slot, e_loc = back
    contrib = h.reshape(-1, h.shape[-1]) * weight[:, None]
    return _combine(contrib, slot, e_loc)


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
    """MoE FFN layer on x (B, S, d). Returns (y, aux_loss). With a model
    axis in ``mesh_ctx``: `moe_grid` on every grid coordinate's pieces of
    p and x (views, on the coordinates' devices), y put back together."""
    if mesh_ctx is not None and mesh_ctx.model_axis is not None:
        return _on_grid(p, x, cfg, mesh_ctx)
    m = cfg.moe
    b, s, d = x.shape
    wu = p["w_up"]["q"] if isinstance(p["w_up"], dict) else p["w_up"]
    t = b * s
    y, aux = _route_and_compute(x.reshape(t, d), p, 0, num_experts=m.num_experts,
                                e_pad=wu.shape[0], top_k=m.top_k, capacity=_capacity(t, m),
                                act=cfg.mlp_act)
    y = y.reshape(b, s, d)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, cfg.mlp_act)
    return y, aux


def _on_grid(p, x: torch.Tensor, cfg, mc: MeshContext):
    """`moe_apply` over ``mc``'s full grid: the layer's `param_specs`
    pieces and x's rows over the data-parallel axes, one share a
    coordinate, through `moe_grid`."""
    from repro_torch.distributed.sharding import (P, context_rules, from_shares, param_specs,
                                                  to_shares)

    if mc.coord is not None:
        raise ValueError("moe_apply takes whole tensors; a coordinate's share runs moe_grid")
    wu = p["w_up"]["q"] if isinstance(p["w_up"], dict) else p["w_up"]
    if wu.shape[0] % mc.model_size:
        raise ValueError(f"moe_apply: {wu.shape[0]} experts do not split over a "
                         f"{mc.model_size}-way model axis (moe_init pads them under the same "
                         "mesh context)")
    dp_total = axes_size(mc.mesh, mc.dp_axes)
    if x.shape[0] % dp_total:
        raise ValueError(f"moe_apply: a batch of {x.shape[0]} rows does not split over "
                         f"{dp_total} data shards")
    specs = param_specs({"moe": p}, context_rules(mc))["moe"]
    x_spec = P(mc.dp_axes if len(mc.dp_axes) > 1 else mc.dp_axes[0])
    ys, auxes = moe_grid(to_shares(p, specs, mc), specs, to_shares(x, x_spec, mc), cfg, mc)
    return from_shares(ys, x_spec, mc).to(x.device), auxes[0].to(x.device)


# --------------------------------------------------------------------------
# the route on a grid: one entry a grid coordinate
# --------------------------------------------------------------------------

def _back_to(back, dev):
    """`_buffer`'s add-back state on ``dev``."""
    weight, slot, e_loc = back
    return weight.to(dev), slot.to(dev), e_loc


def moe_grid(ps: list, specs, xs: list, cfg, mc: MeshContext) -> Tuple[list, list]:
    """`moe_apply` on a share: ``ps`` one tree a coordinate of
    ``mc.coords``, its pieces of the layer's parameters (banks (E_loc, d /
    F, f) and (E_loc, f, d / F), the router whole), ``xs`` its rows
    (B_loc, S, d). The reference's ``shard_map`` bodies, one a
    coordinate: the dropping path gathers the banks over the FSDP axes,
    routes the coordinate's rows and psums the experts' contributions
    over "model"; the weights-stationary path all-gathers the tokens over
    the data-parallel axes, multiplies its d-slice of each buffer by its
    bank pieces (up and gate psum'd over the FSDP axes, the output slices
    all-gathered), psums over "model" and keeps its own rows. aux is
    pmean'd over the data-parallel axes. The router is replicated, so the
    coordinates that hold the same rows route them alike: they are routed
    once (once a data shard; on the stationary path once, and one buffer
    a model shard). Returns (y, aux) shares."""
    m = cfg.moe
    bb, s, d = xs[0].shape
    wu = ps[0]["w_up"]["q"] if isinstance(ps[0]["w_up"], dict) else ps[0]["w_up"]
    e_loc = wu.shape[0]
    e_pad = e_loc * mc.model_size
    dp, fsdp = tuple(mc.dp_axes), tuple(mc.fsdp_axes)
    dp_total = axes_size(mc.mesh, dp)
    t_loc = bb * s
    stationary = bool(fsdp) and t_loc * m.top_k <= m.stationary_threshold
    starts = [axis_index(mc.mesh, c, mc.model_axis) * e_loc for c in mc.coords]
    names = ("w_up", "w_gate", "w_down")
    if not stationary:
        banks = {k: gather_param([p[k] for p in ps], specs[k], mc) for k in names}
        routed, ys, auxes = {}, [], []
        for i, (c, p, x) in enumerate(zip(mc.coords, ps, xs)):
            x = x.reshape(t_loc, d)
            shard_i = axis_index(mc.mesh, c, dp)
            if shard_i not in routed:
                routed[shard_i] = _routing(x, p["router"], m.num_experts, e_pad, m.top_k)
            gates, idx, aux = (t.to(x.device) for t in routed[shard_i])
            y = _compute(x, {k: banks[k][i] for k in names}, gates, idx, starts[i],
                         _capacity(t_loc, m), cfg.mlp_act)
            ys.append(y.reshape(bb, s, d))
            auxes.append(aux)
        ys = psum(ys, mc.model_axis, mc)
    else:
        x_all = all_gather([x.reshape(t_loc, d) for x in xs], dp, mc, 0)
        cap_all = _capacity(x_all[0].shape[0], m)
        gates, idx, aux = _routing(x_all[0], ps[0]["router"], m.num_experts, e_pad, m.top_k)
        auxes = [aux.to(x.device) for x in xs]
        bufs = {}
        for xa, e0 in zip(x_all, starts):
            if e0 not in bufs:
                bufs[e0] = _buffer(xa, gates.to(xa.device), idx.to(xa.device), e_loc, e0, cap_all)
        d_shard = wu.shape[1]
        sl = [bufs[e0][0].to(xa.device).narrow(2, axis_index(mc.mesh, c, fsdp) * d_shard, d_shard)
              for xa, e0, c in zip(x_all, starts, mc.coords)]
        dt = xs[0].dtype
        up = psum([torch.einsum("ecd,edf->ecf", b_, dequant_weight(p["w_up"], dt))
                   for b_, p in zip(sl, ps)], fsdp, mc)
        gate = psum([torch.einsum("ecd,edf->ecf", b_, dequant_weight(p["w_gate"], dt))
                     for b_, p in zip(sl, ps)], fsdp, mc)
        y_sl = [torch.einsum("ecf,efd->ecd", F.silu(g_) * u_, dequant_weight(p["w_down"], dt))
                for g_, u_, p in zip(gate, up, ps)]
        h = all_gather(y_sl, fsdp, mc, 2)
        # the coordinates of a model shard hold the same buffer and, gathered
        # over the FSDP axes, the same outputs: added back once a model shard
        back = {}
        for h_, e0 in zip(h, starts):
            if e0 not in back:
                back[e0] = _unbuffer(h_, _back_to(bufs[e0][1], h_.device))
        y_all = psum([back[e0].to(x.device) for x, e0 in zip(xs, starts)], mc.model_axis, mc)
        ys = [ya.narrow(0, axis_index(mc.mesh, c, dp) * t_loc, t_loc).reshape(bb, s, d)
              for ya, c in zip(y_all, mc.coords)]
    auxes = [a / dp_total for a in psum(auxes, dp, mc)]
    if "shared" in ps[0]:
        shared = mlp_grid([p["shared"] for p in ps], specs["shared"], xs, cfg.mlp_act, mc)
        ys = [y + y_s for y, y_s in zip(ys, shared)]
    return ys, auxes
