"""Decoder-only transformer backbone of the dense and MoE architectures
(musicgen, qwen3, gemma2, codeqwen, phi4, llava, kimi-k2, granite-moe).

PyTorch counterpart of `repro.models.transformer`, with the same
parameter tree, arguments and results. ``cfg.layer_pattern`` is the
block sequence of one step (("global",) for uniform stacks, ("local",
"global") for Gemma-2, ("moe",) for MoE stacks); each slot's parameters
carry a leading (n_steps,) axis, and MoE stacks may put
``first_k_dense`` dense layers in front (``dense_prefix``, Kimi-K2).
The reference's ``lax.scan`` over the steps is a loop over them, and its
``jax.checkpoint`` of a whole step one ``torch.utils.checkpoint`` a step
(`layers.remat`).

With a ``mesh_ctx`` (`moe.MeshContext` over a `distributed.sharding.Mesh`)
the step is the reference's sharded one, laid out by `param_specs`,
`batch_specs` and `cache_specs` and run one share a grid coordinate
(`layers.mlp_grid`, `attention.attn_grid` / `decode_attn_grid`,
`moe.moe_grid`, the collectives of `distributed.collectives`): the
residual stream's batch over the data-parallel axes, the heads, the MLP
hidden dim, the experts and the vocabulary over "model", every weight
all-gathered over its FSDP axes where it is used. On a full grid
(``mesh_ctx.coord`` None) every coordinate runs in the one process and
the functions take and return whole tensors, which they shard
(`sharding.shard`: views) and put back together; with ``coord`` they
take and return that coordinate's pieces and run its share alone, the
collectives in their lone form (the dry run's per-device trace).
Without a ``mesh_ctx`` the one-device step runs, unchanged.

API (shared by every backbone through `models.registry`):
    init_params(gen, cfg, mesh_ctx, device)      -> params
    forward(params, batch, cfg, mesh_ctx)        -> (logits, aux_loss)
    loss_fn(params, batch, cfg, mesh_ctx)        -> scalar loss
    init_cache(cfg, batch, max_len, ..., device) -> cache
    prefill(params, batch, cfg, mesh_ctx)        -> (logits, cache)
    decode_step(params, cache, cache_len, batch, cfg, mesh_ctx)
                                                 -> (logits, cache)
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models.attention import (
    attn_apply,
    attn_grid,
    attn_init,
    decode_attn_apply,
    decode_attn_grid,
)
from repro_torch.models.layers import (
    cross_entropy_loss,
    dense_init,
    embed_grid,
    grid_specs,
    head_grid,
    logits_grid,
    loss_grid,
    mlp_apply,
    mlp_grid,
    mlp_init,
    remat,
    rms_norm,
    softcap,
    unstack_specs,
)
from repro_torch.distributed.collectives import axes_of
from repro_torch.models.moe import moe_apply, moe_grid, moe_init
from repro_torch.training.optimizer import tree_map

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "prefill", "decode_step"]

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _block_init(gen: torch.Generator, cfg, kind: str, mesh_ctx=None) -> Params:
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=torch.float32, device=gen.device)  # noqa: E731
    p: Params = {
        "ln1": zeros(),
        "attn": attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                          cfg.qk_norm),
        "ln2": zeros(),
    }
    if cfg.post_norms:
        p["ln1_post"] = zeros()
        p["ln2_post"] = zeros()
    if kind == "moe":
        p["moe"] = moe_init(gen, cfg, mesh_ctx)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.mlp_act)
    return p


def _pattern_slots(cfg):
    return [(f"slot{i}_{k}", k) for i, k in enumerate(cfg.layer_pattern)]


def _first_dense(cfg) -> int:
    return cfg.moe.first_k_dense if cfg.moe else 0


def _n_steps(cfg) -> int:
    n = cfg.n_layers - _first_dense(cfg)
    if n % len(cfg.layer_pattern):
        raise ValueError(f"{cfg.name}: {n} layers not divisible by pattern {cfg.layer_pattern}")
    return n // len(cfg.layer_pattern)


def init_params(gen: torch.Generator, cfg, mesh_ctx=None, device=None) -> Params:
    """Random parameters drawn from ``gen`` (on its device), cast to the
    activation dtype as the reference casts them, on ``device`` (default:
    the card through `kernels.build.resolve_device`). Each slot of
    ``layers`` stacks its blocks along a leading (n_steps,) axis, filled
    block by block (no second copy of a stack is made)."""
    from repro_torch.kernels.build import resolve_device  # lazy: kernels import models

    device = resolve_device(device)
    dt = cfg.activation_dtype
    cast = lambda t: t.to(device=device, dtype=dt)  # noqa: E731
    d, v = cfg.d_model, cfg.vocab_padded
    params: Params = {
        "embed": cast(dense_init(gen, (v, d), fan_in=d)),
        "final_norm": torch.zeros((d,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = cast(dense_init(gen, (d, v)))
    if _first_dense(cfg):
        params["dense_prefix"] = [tree_map(cast, _block_init(gen, cfg, "global", mesh_ctx))
                                  for _ in range(_first_dense(cfg))]
    n_steps = _n_steps(cfg)
    layers: Params = {}
    for slot_name, kind in _pattern_slots(cfg):
        first = _block_init(gen, cfg, kind, mesh_ctx)
        stack = tree_map(lambda t: torch.empty((n_steps,) + tuple(t.shape), dtype=dt,
                                               device=device), first)
        for i in range(n_steps):
            block = first if i == 0 else _block_init(gen, cfg, kind, mesh_ctx)
            tree_map(lambda s, t: s[i].copy_(t), stack, block)
        layers[slot_name] = stack
    params["layers"] = layers
    return params


# --------------------------------------------------------------------------
# forward / loss
# --------------------------------------------------------------------------

def _step(layers: Params, i: int) -> Params:
    return tree_map(lambda t: t[i], layers)


def _block_apply(p, x, cfg, kind, mesh_ctx):
    window = cfg.sliding_window if kind == "local" else None
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_out, kv = attn_apply(p["attn"], h, cfg, window=window, mesh_ctx=mesh_ctx)
    if cfg.post_norms:
        attn_out = rms_norm(attn_out, p["ln1_post"], cfg.norm_eps)
    x = x + attn_out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind == "moe":
        ffn_out, aux = moe_apply(p["moe"], h, cfg, mesh_ctx)
    else:
        ffn_out = mlp_apply(p["mlp"], h, cfg.mlp_act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.post_norms:
        ffn_out = rms_norm(ffn_out, p["ln2_post"], cfg.norm_eps)
    return x + ffn_out, aux, kv


def _embed_in(params, batch, cfg) -> torch.Tensor:
    dt = cfg.activation_dtype
    dev = params["embed"].device
    if cfg.frontend == "embedding":
        x = batch["embeddings"].to(device=dev, dtype=dt)
    else:
        x = params["embed"].to(dt)[batch["tokens"].to(device=dev, dtype=torch.int64)]
    if cfg.scale_embeddings:
        # sqrt(d) rounded to the activation dtype first, as the reference's
        # jnp.asarray(jnp.sqrt(d * 1.0), dtype): gemma2's 67.88 is 68.0 in bfloat16
        x = x * float(torch.sqrt(torch.tensor(cfg.d_model * 1.0, dtype=torch.float32)).to(dt))
    return x


def _head_out(params, x, cfg) -> torch.Tensor:
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return h @ w.to(h.dtype)


def forward(params, batch, cfg, mesh_ctx=None):
    """Logits (B, S, V_padded) of ``batch["tokens"]`` (B, S) (or of
    ``batch["embeddings"]`` (B, S, d) for an embedding frontend) and the
    summed auxiliary loss (float32; zero for dense blocks). The final
    soft-cap is the loss's, not applied here."""
    if mesh_ctx is not None:
        return _grid_forward(params, batch, cfg, mesh_ctx)
    x = _embed_in(params, batch, cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in params.get("dense_prefix", []):
        x, aux, _ = _block_apply(p, x, cfg, "global", mesh_ctx)
        aux_total = aux_total + aux
    slots = _pattern_slots(cfg)

    def body(step_params, x, aux_acc):
        for slot_name, kind in slots:
            x, aux, _ = _block_apply(step_params[slot_name], x, cfg, kind, mesh_ctx)
            aux_acc = aux_acc + aux
        return x, aux_acc

    body = remat(body, cfg)
    for i in range(_n_steps(cfg)):
        x, aux_total = body(_step(params["layers"], i), x, aux_total)
    return _head_out(params, x, cfg), aux_total


def loss_fn(params, batch, cfg, mesh_ctx=None, aux_weight: float = 0.01):
    if mesh_ctx is not None:
        return _grid_loss(params, batch, cfg, mesh_ctx, aux_weight)
    logits, aux = forward(params, batch, cfg, mesh_ctx)
    ce = cross_entropy_loss(logits, batch["labels"].to(logits.device), cfg.final_softcap)
    return ce + aux_weight * aux


# --------------------------------------------------------------------------
# serving: cache init / prefill / decode
# --------------------------------------------------------------------------

def _slot_cache_len(cfg, kind: str, max_len: int) -> int:
    if kind == "local" and cfg.sliding_window:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_cache(cfg, batch: int, max_len: int, mesh_ctx=None, device=None) -> Params:
    """Zero K / V caches in the activation dtype: a (n_steps, B, S_slot,
    KV, D) pair a slot (a local slot holds min(window, max_len) positions
    as a ring, a global one max_len) and a (B, max_len, KV, D) pair a
    dense-prefix layer, on ``device`` (default: the card)."""
    from repro_torch.kernels.build import resolve_device  # lazy: kernels import models

    device = resolve_device(device)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    z = lambda *shape: torch.zeros(shape, dtype=cfg.activation_dtype, device=device)  # noqa: E731
    n_steps = _n_steps(cfg)
    cache: Params = {"layers": {}}
    for slot_name, kind in _pattern_slots(cfg):
        s = _slot_cache_len(cfg, kind, max_len)
        cache["layers"][slot_name] = {"k": z(n_steps, batch, s, kv, hd),
                                      "v": z(n_steps, batch, s, kv, hd)}
    if _first_dense(cfg):
        cache["dense_prefix"] = [{"k": z(batch, max_len, kv, hd), "v": z(batch, max_len, kv, hd)}
                                 for _ in range(_first_dense(cfg))]
    return cache


def _compress_kv(k, v, cfg, kind, max_len):
    """Full-sequence (k, v) -> the slot's cache layout: zero-padded to the
    slot length, or (a ring, S > S_slot) the last S_slot positions rolled
    so that position p sits at p % S_slot."""
    s_slot = _slot_cache_len(cfg, kind, max_len)
    s = k.shape[1]
    if s_slot >= s:
        pad = s_slot - s
        if pad:
            z = k.new_zeros((k.shape[0], pad) + tuple(k.shape[2:]))
            k, v = torch.cat([k, z], dim=1), torch.cat([v, z], dim=1)
        return k, v
    k = torch.roll(k[:, s - s_slot:], s % s_slot, dims=1)
    v = torch.roll(v[:, s - s_slot:], s % s_slot, dims=1)
    return k, v


def _stack_kv(kvs):
    return {"k": torch.stack([c["k"] for c in kvs]), "v": torch.stack([c["v"] for c in kvs])}


def prefill(params, batch, cfg, mesh_ctx=None, max_len: Optional[int] = None):
    """Run the prompt: (soft-capped logits at its last position (B, V),
    the cache a `decode_step` continues from, laid out for ``max_len``
    (default: the prompt's length))."""
    if mesh_ctx is not None:
        return _grid_prefill(params, batch, cfg, mesh_ctx, max_len)
    x = _embed_in(params, batch, cfg)
    max_len = max_len or x.shape[1]
    cache: Params = {"layers": {}}
    dense = []
    for p in params.get("dense_prefix", []):
        x, _, kv = _block_apply(p, x, cfg, "global", mesh_ctx)
        k, v = _compress_kv(kv[0], kv[1], cfg, "global", max_len)
        dense.append({"k": k, "v": v})
    if dense:
        cache["dense_prefix"] = dense
    slots = _pattern_slots(cfg)
    per_slot = {name: [] for name, _ in slots}
    for i in range(_n_steps(cfg)):
        step_params = _step(params["layers"], i)
        for slot_name, kind in slots:
            x, _, kv = _block_apply(step_params[slot_name], x, cfg, kind, mesh_ctx)
            k, v = _compress_kv(kv[0], kv[1], cfg, kind, max_len)
            per_slot[slot_name].append({"k": k, "v": v})
    cache["layers"] = {name: _stack_kv(kvs) for name, kvs in per_slot.items()}
    logits = _head_out(params, x[:, -1:, :], cfg)
    return softcap(logits[:, 0, :], cfg.final_softcap), cache


def decode_step(params, cache, cache_len, batch, cfg, mesh_ctx=None):
    """One token for the whole batch: ``batch`` {"tokens": (B, 1)} or
    {"embeddings": (B, 1, d)}, ``cache_len`` the tokens already cached (an
    int, or a 0-d integer tensor, moved to the card once a step). Returns
    (soft-capped logits (B, V), the new cache)."""
    if mesh_ctx is not None:
        return _grid_decode(params, cache, cache_len, batch, cfg, mesh_ctx)
    x = _embed_in(params, batch, cfg)
    if torch.is_tensor(cache_len):
        cache_len = cache_len.to(x.device)

    def apply_one(p, c, x, kind):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        attn_out, k_c, v_c = decode_attn_apply(
            p["attn"], h, cfg, c["k"], c["v"], cache_len,
            ring=(kind == "local" and cfg.sliding_window is not None))
        if cfg.post_norms:
            attn_out = rms_norm(attn_out, p["ln1_post"], cfg.norm_eps)
        x = x + attn_out
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if kind == "moe":
            ffn_out, _ = moe_apply(p["moe"], h, cfg, mesh_ctx)
        else:
            ffn_out = mlp_apply(p["mlp"], h, cfg.mlp_act)
        if cfg.post_norms:
            ffn_out = rms_norm(ffn_out, p["ln2_post"], cfg.norm_eps)
        return x + ffn_out, {"k": k_c, "v": v_c}

    new_cache: Params = {"layers": {}}
    if "dense_prefix" in cache:
        new_dense = []
        for p, c in zip(params["dense_prefix"], cache["dense_prefix"]):
            x, c_new = apply_one(p, c, x, "global")
            new_dense.append(c_new)
        new_cache["dense_prefix"] = new_dense
    slots = _pattern_slots(cfg)
    per_slot = {name: [] for name, _ in slots}
    for i in range(_n_steps(cfg)):
        step_params = _step(params["layers"], i)
        for slot_name, kind in slots:
            x, c_new = apply_one(step_params[slot_name], _step(cache["layers"][slot_name], i),
                                 x, kind)
            per_slot[slot_name].append(c_new)
    new_cache["layers"] = {name: _stack_kv(kvs) for name, kvs in per_slot.items()}
    logits = _head_out(params, x, cfg)
    return softcap(logits[:, 0, :], cfg.final_softcap), new_cache


# --------------------------------------------------------------------------
# the sharded step: one share a grid coordinate (see the module docstring)
# --------------------------------------------------------------------------

def _specs(mc, params, batch, cache=None, batch_size=None, max_len=None, cfg=None) -> dict:
    """`layers.grid_specs`; a prefill's cache specs from the cache it will
    write."""
    if cache is None and max_len is not None and mc.coord is None:
        cache = init_cache(cfg, batch_size, max_len, device="meta")
    return grid_specs(mc, params, batch, cache, batch_size)


def _embed_grid(shares, specs, bs, cfg, mc) -> list:
    dt = cfg.activation_dtype
    if cfg.frontend == "embedding":
        xs = [b["embeddings"].to(dt) for b in bs]
    else:
        xs = embed_grid([p["embed"] for p in shares], specs["embed"],
                        [b["tokens"] for b in bs], dt, mc)
    if cfg.scale_embeddings:
        f = float(torch.sqrt(torch.tensor(cfg.d_model * 1.0, dtype=torch.float32)).to(dt))
        xs = [x * f for x in xs]
    return xs


def _block_grid(ps, specs, xs, cfg, kind, mc, full_kv=False):
    window = cfg.sliding_window if kind == "local" else None
    hs = [rms_norm(x, p["ln1"], cfg.norm_eps) for p, x in zip(ps, xs)]
    attn, kvs = attn_grid([p["attn"] for p in ps], specs["attn"], hs, cfg, window, mc, full_kv)
    if cfg.post_norms:
        attn = [rms_norm(a, p["ln1_post"], cfg.norm_eps) for p, a in zip(ps, attn)]
    xs = [x + a for x, a in zip(xs, attn)]
    hs = [rms_norm(x, p["ln2"], cfg.norm_eps) for p, x in zip(ps, xs)]
    if kind == "moe":
        ffn, aux = moe_grid([p["moe"] for p in ps], specs["moe"], hs, cfg, mc)
    else:
        ffn = mlp_grid([p["mlp"] for p in ps], specs["mlp"], hs, cfg.mlp_act, mc)
        aux = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
    if cfg.post_norms:
        ffn = [rms_norm(f, p["ln2_post"], cfg.norm_eps) for p, f in zip(ps, ffn)]
    return [x + f for x, f in zip(xs, ffn)], aux, kvs


def _grid_trunk(params, batch, cfg, mc, on_layer=None):
    """Embedding and every block on the grid: (shares of the final hidden
    state, of the aux loss, the parameter shares, the batch shares, the
    specs). ``on_layer(kind, kvs, where)`` sees each block's (k, v) share
    (the prefill's cache; ``where`` a dense-prefix index or a slot's
    name)."""
    from repro_torch.distributed.sharding import to_shares

    specs = _specs(mc, params, batch)
    shares = to_shares(params, specs["params"], mc)
    bs = to_shares(batch, specs["batch"], mc)
    ps_specs = specs["params"]
    xs = _embed_grid(shares, ps_specs, bs, cfg, mc)
    aux = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
    for i in range(len(params.get("dense_prefix", []))):
        xs, a, kvs = _block_grid([p["dense_prefix"][i] for p in shares],
                                 ps_specs["dense_prefix"][i], xs, cfg, "global", mc,
                                 on_layer is not None)
        aux = [t + u for t, u in zip(aux, a)]
        if on_layer:
            on_layer("global", kvs, i)
    layers = [p["layers"] for p in shares]
    step_specs = unstack_specs(layers[0], ps_specs["layers"])
    slots = _pattern_slots(cfg)

    def body(step_ps, xs, aux):
        for slot_name, kind in slots:
            xs, a, kvs = _block_grid([sp[slot_name] for sp in step_ps], step_specs[slot_name],
                                     xs, cfg, kind, mc, on_layer is not None)
            aux = [t + u for t, u in zip(aux, a)]
            if on_layer:
                on_layer(kind, kvs, slot_name)
        return xs, aux

    if on_layer is None:
        body = remat(body, cfg)
    for i in range(_n_steps(cfg)):
        xs, aux = body([_step(layer, i) for layer in layers], xs, aux)
    return xs, aux, shares, bs, specs


def _grid_forward(params, batch, cfg, mc):
    xs, aux, shares, _, specs = _grid_trunk(params, batch, cfg, mc)
    return logits_grid(shares, specs, xs, cfg, mc), aux[0]


def _grid_loss(params, batch, cfg, mc, aux_weight):
    xs, aux, shares, bs, specs = _grid_trunk(params, batch, cfg, mc)
    logits, vsplit = head_grid(shares, specs["params"], xs, cfg, mc)
    return loss_grid(logits, vsplit, bs, specs["batch"], cfg, mc) + aux_weight * aux[0]


def seq_entry(spec):
    """The cache leaf's sequence-axis entry (dims (..., B, S, KV, D))."""
    return spec[len(spec) - 3] if len(spec) >= 3 else None


def kv_cache_share(kvs, cfg, kind, max_len, spec, mc) -> list:
    """A block's (k, v) share in its cache layout: the slot's ring or
    padded layout on the whole sequence, then the coordinate's slice of
    the sequence axes; k / v whose kv heads are split over "model" swap
    the split for the sequence's (an all-to-all), or gather their heads
    where the sequence does not take "model"."""
    from repro_torch.distributed.collectives import all_gather, all_to_all, axes_size, axis_index

    seq = axes_of(seq_entry(spec))
    local_heads = kvs[0][0].shape[2] != cfg.n_kv_heads
    out = {"k": [], "v": []}
    for name, pos in (("k", 0), ("v", 1)):
        ts = [_compress_kv(kv[0], kv[1], cfg, kind, max_len)[pos] for kv in kvs]
        rest = tuple(ax for ax in seq if ax != mc.model_axis)
        if rest:  # the sequence's non-model axes: the rows are replicated there
            n = axes_size(mc.mesh, rest)
            ts = [t.narrow(1, axis_index(mc.mesh, c, rest) * (t.shape[1] // n), t.shape[1] // n)
                  for t, c in zip(ts, mc.coords)]
        on_model = mc.model_axis in seq
        if local_heads and on_model:
            ts = all_to_all(ts, mc.model_axis, mc, 1, 2)
        else:
            if local_heads:
                ts = all_gather(ts, mc.model_axis, mc, 2)
            if on_model:
                n = mc.model_size
                ts = [t.narrow(1, axis_index(mc.mesh, c, mc.model_axis) * (t.shape[1] // n),
                               t.shape[1] // n) for t, c in zip(ts, mc.coords)]
        out[name] = ts
    return [{"k": k, "v": v} for k, v in zip(out["k"], out["v"])]


def _grid_prefill(params, batch, cfg, mc, max_len):
    from repro_torch.distributed.sharding import P, from_shares

    x0 = next(iter(batch.values()))
    n_rows = x0.shape[0]
    s = x0.shape[1]
    max_len = max_len or s
    cspecs = _specs(mc, params, batch, batch_size=n_rows, max_len=max_len, cfg=cfg)["cache"]
    dense, per_slot = [], {name: [] for name, _ in _pattern_slots(cfg)}

    def on_layer(kind, kvs, where):
        if isinstance(where, int):  # a dense-prefix layer
            dense.append(kv_cache_share(kvs, cfg, kind, max_len, cspecs["dense_prefix"][where]["k"],
                                   mc))
        else:
            spec = cspecs["layers"][where]["k"]
            per_slot[where].append(kv_cache_share(kvs, cfg, kind, max_len, P(*spec[1:]), mc))

    xs, _, shares, bs, specs = _grid_trunk(params, batch, cfg, mc, on_layer)
    logits = logits_grid(shares, specs, xs, cfg, mc, last=True)
    caches = []
    for i in range(len(xs)):
        c = {"layers": {name: _stack_kv([kv[i] for kv in kvs]) for name, kvs in per_slot.items()}}
        if dense:
            c["dense_prefix"] = [d[i] for d in dense]
        caches.append(c)
    return logits, from_shares(caches, cspecs, mc)


def _grid_decode(params, cache, cache_len, batch, cfg, mc):
    from repro_torch.distributed.sharding import from_shares, to_shares

    n_rows = next(iter(batch.values())).shape[0]
    specs = _specs(mc, params, batch, cache, batch_size=n_rows)
    cspecs = specs["cache"]
    shares = to_shares(params, specs["params"], mc)
    bs = to_shares(batch, specs["batch"], mc)
    cs = to_shares(cache, cspecs, mc)
    ps_specs = specs["params"]
    xs = _embed_grid(shares, ps_specs, bs, cfg, mc)

    def apply_one(ps, pspec, cc, cspec, xs, kind):
        hs = [rms_norm(x, p["ln1"], cfg.norm_eps) for p, x in zip(ps, xs)]
        attn, new = decode_attn_grid(
            [p["attn"] for p in ps], pspec["attn"], hs, cfg, [(c["k"], c["v"]) for c in cc],
            axes_of(seq_entry(cspec["k"])), cache_len,
            ring=(kind == "local" and cfg.sliding_window is not None), mc=mc)
        if cfg.post_norms:
            attn = [rms_norm(a, p["ln1_post"], cfg.norm_eps) for p, a in zip(ps, attn)]
        xs = [x + a for x, a in zip(xs, attn)]
        hs = [rms_norm(x, p["ln2"], cfg.norm_eps) for p, x in zip(ps, xs)]
        if kind == "moe":
            ffn, _ = moe_grid([p["moe"] for p in ps], pspec["moe"], hs, cfg, mc)
        else:
            ffn = mlp_grid([p["mlp"] for p in ps], pspec["mlp"], hs, cfg.mlp_act, mc)
        if cfg.post_norms:
            ffn = [rms_norm(f, p["ln2_post"], cfg.norm_eps) for p, f in zip(ps, ffn)]
        return [x + f for x, f in zip(xs, ffn)], [{"k": k, "v": v} for k, v in new]

    n = len(xs)
    new_dense = []
    for i in range(len(params.get("dense_prefix", []))):
        xs, c_new = apply_one([p["dense_prefix"][i] for p in shares], ps_specs["dense_prefix"][i],
                              [c["dense_prefix"][i] for c in cs], cspecs["dense_prefix"][i],
                              xs, "global")
        new_dense.append(c_new)
    layers = [p["layers"] for p in shares]
    step_specs = unstack_specs(layers[0], ps_specs["layers"])
    step_cspecs = unstack_specs(cs[0]["layers"], cspecs["layers"])
    slots = _pattern_slots(cfg)
    per_slot = {name: [] for name, _ in slots}
    for i in range(_n_steps(cfg)):
        for slot_name, kind in slots:
            xs, c_new = apply_one([_step(layer, i)[slot_name] for layer in layers],
                                  step_specs[slot_name],
                                  [_step(c["layers"][slot_name], i) for c in cs],
                                  step_cspecs[slot_name], xs, kind)
            per_slot[slot_name].append(c_new)
    logits = logits_grid(shares, specs, xs, cfg, mc, last=True)
    caches = []
    for k in range(n):
        c = {"layers": {name: _stack_kv([kv[k] for kv in kvs]) for name, kvs in per_slot.items()}}
        if new_dense:
            c["dense_prefix"] = [d[k] for d in new_dense]
        caches.append(c)
    return logits, from_shares(caches, cspecs, mc)
