"""Zamba2 hybrid backbone (arXiv:2411.15242): a deep Mamba2 stack with a
few *shared* transformer blocks applied periodically.

PyTorch counterpart of `repro.models.zamba2`, with the same parameter
tree, cache tree, arguments and results:
  * cfg.n_layers Mamba2 layers (81 for zamba2-7b), their leaves stacked
    along a leading (n_layers,) axis (``"mamba"``);
  * before mamba layer i where i % shared_attn_every == 0, one of
    n_shared_blocks (``"shared"``, a list) shared attention + MLP blocks
    runs, alternating;
  * a shared block reads concat(hidden, token embedding) (2d) through
    ``in_proj``, adds attention back at width d, then a d -> d_ff MLP.
Each *application* of a shared block has its own KV cache (its own
positions), though the parameters are shared.

The reference's per-group ``lax.scan`` over the stacked layers is a loop
over them; its ``jax.checkpoint`` wraps the Mamba body only
(`layers.remat` a layer), the shared applications are not recomputed.

With a ``mesh_ctx`` the step is the reference's sharded one, one share a
grid coordinate as `models.transformer`'s: the mamba layers on
`mamba2.mamba2_block_grid` (w_z, w_x, w_dt and conv_w column-parallel over
"model", the SSD on each coordinate's heads, the gated RMSNorm over the
whole d_inner by a psum of the squares, out_proj row-parallel); a shared
block's in_proj column-parallel and its output all-gathered, then
`attention.attn_grid` / `decode_attn_grid` and `layers.mlp_grid` on the
concat's projection. The conv carries keep d_inner over "model", the SSD
states their heads, the shared applications' k / v caches their
sequence (`sharding.cache_specs`). Without a ``mesh_ctx`` the one-device
step runs, unchanged.

API (shared by every backbone through `models.registry`):
    init_params(gen, cfg, mesh_ctx, device)      -> params
    forward(params, batch, cfg, mesh_ctx)        -> (logits, aux_loss)
    loss_fn(params, batch, cfg, mesh_ctx)        -> scalar loss
    init_cache(cfg, batch, max_len, ..., device) -> cache
    prefill(params, batch, cfg, mesh_ctx, max_len) -> (logits, cache)
    decode_step(params, cache, cache_len, batch, cfg, mesh_ctx)
                                                 -> (logits, cache)
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.distributed.collectives import all_gather
from repro_torch.models import mamba2 as M2
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
    gather_param,
    grid_specs,
    head_grid,
    logits_grid,
    loss_grid,
    mlp_apply,
    mlp_grid,
    mlp_init,
    remat,
    rms_norm,
    splits_on,
    unstack_specs,
)
from repro_torch.models.transformer import kv_cache_share, seq_entry
from repro_torch.training.optimizer import tree_map

__all__ = ["n_shared_applications", "init_params", "forward", "loss_fn", "init_cache",
           "prefill", "decode_step"]

Params = Dict[str, Any]


def _groups(cfg) -> List[Tuple[int, int]]:
    """[(start, length)] mamba-layer groups between shared applications."""
    k = cfg.shared_attn_every
    return [(i, min(k, cfg.n_layers - i)) for i in range(0, cfg.n_layers, k)]


def n_shared_applications(cfg) -> int:
    return len(_groups(cfg))


def _shared_block_init(gen: torch.Generator, cfg) -> Params:
    """One shared block's float32 parameters, drawn from ``gen`` on its
    device; attention reads the 2d concat through a fused input projection."""
    d = cfg.d_model
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=gen.device)  # noqa: E731
    return {
        "ln1": zeros(2 * d),
        "in_proj": dense_init(gen, (2 * d, d)),
        "attn": attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                          cfg.qk_norm),
        "ln2": zeros(d),
        "mlp": mlp_init(gen, d, cfg.d_ff, cfg.mlp_act),
    }


def init_params(gen: torch.Generator, cfg, mesh_ctx=None, device=None) -> Params:
    """Random parameters drawn from ``gen`` (on its device), every leaf
    cast to the activation dtype as the reference casts them, on
    ``device`` (default: the card through `kernels.build.resolve_device`).
    ``"mamba"`` stacks each leaf along a leading (n_layers,) axis, filled
    layer by layer (no second copy of the stack is made)."""
    from repro_torch.kernels.build import resolve_device  # lazy: kernels import models

    device = resolve_device(device)
    dt = cfg.activation_dtype
    cast = lambda t: t.to(device=device, dtype=dt)  # noqa: E731
    d, v = cfg.d_model, cfg.vocab_padded
    params: Params = {
        "embed": cast(dense_init(gen, (v, d), fan_in=d)),
        "head": cast(dense_init(gen, (d, v))),
        "final_norm": torch.zeros((d,), dtype=dt, device=device),
    }
    first = M2.mamba2_block_init(gen, cfg)
    stack = {k: torch.empty((cfg.n_layers,) + tuple(t.shape), dtype=dt, device=device)
             for k, t in first.items()}
    for i in range(cfg.n_layers):
        layer = first if i == 0 else M2.mamba2_block_init(gen, cfg)
        for k, t in layer.items():
            stack[k][i].copy_(t)
    params["mamba"] = stack
    params["shared"] = [tree_map(cast, _shared_block_init(gen, cfg))
                        for _ in range(cfg.n_shared_blocks)]
    return params


def _shared_apply(p, x, emb, cfg, cache=None, cache_len=None):
    """One shared-block application. ``cache`` None: the whole sequence
    (returns its (k, v)); else a decode step against ``cache`` {"k", "v"}
    holding ``cache_len`` tokens (returns the new cache)."""
    xin = torch.cat([x, emb], dim=-1)
    h = rms_norm(xin, p["ln1"], cfg.norm_eps) @ p["in_proj"].to(x.dtype)
    if cache is None:
        attn_out, kv = attn_apply(p["attn"], h, cfg)
    else:
        attn_out, k_c, v_c = decode_attn_apply(p["attn"], h, cfg, cache["k"], cache["v"],
                                               cache_len)
        kv = {"k": k_c, "v": v_c}
    x = x + attn_out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2, cfg.mlp_act), kv


def _layer(params: Params, i: int) -> Params:
    return {k: t[i] for k, t in params["mamba"].items()}


def _shared(params: Params, cfg, gi: int) -> Params:
    return params["shared"][gi % cfg.n_shared_blocks]


def _embed(params, batch, cfg) -> torch.Tensor:
    tokens = batch["tokens"].to(device=params["embed"].device, dtype=torch.int64)
    return params["embed"].to(cfg.activation_dtype)[tokens]


def _head(params, x, cfg) -> torch.Tensor:
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return h @ params["head"].to(h.dtype)


def forward(params, batch, cfg, mesh_ctx=None):
    """Logits (B, S, V_padded) of ``batch["tokens"]`` (B, S), and the
    reference's zero auxiliary loss."""
    if mesh_ctx is not None:
        return _grid_forward(params, batch, cfg, mesh_ctx)
    x = _embed(params, batch, cfg)
    emb = x
    body = remat(lambda p, x: M2.mamba2_block_apply(p, x, cfg)[0], cfg)
    for gi, (start, length) in enumerate(_groups(cfg)):
        x, _ = _shared_apply(_shared(params, cfg, gi), x, emb, cfg)
        for i in range(start, start + length):
            x = body(_layer(params, i), x)
    return _head(params, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, batch, cfg, mesh_ctx=None):
    if mesh_ctx is not None:
        return _grid_loss(params, batch, cfg, mesh_ctx)
    logits, _ = forward(params, batch, cfg, mesh_ctx)
    return cross_entropy_loss(logits, batch["labels"].to(logits.device), cfg.final_softcap)


def init_cache(cfg, batch: int, max_len: int, mesh_ctx=None, device=None) -> Params:
    """Zero caches in the activation dtype, on ``device`` (default: the
    card): a K / V pair a shared application (n_apps, B, max_len, KV, D),
    and each mamba layer's conv carry (n_layers, B, K-1, d_in) and SSD
    state (n_layers, B, H, N, P)."""
    from repro_torch.kernels.build import resolve_device  # lazy: kernels import models

    device = resolve_device(device)
    z = lambda *shape: torch.zeros(shape, dtype=cfg.activation_dtype, device=device)  # noqa: E731
    n_apps = n_shared_applications(cfg)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    ssm = cfg.ssm
    d_in = ssm.expand * cfg.d_model
    return {
        "shared_kv": {"k": z(n_apps, batch, max_len, kv, hd),
                      "v": z(n_apps, batch, max_len, kv, hd)},
        "conv": z(cfg.n_layers, batch, ssm.d_conv - 1, d_in),
        "ssd": z(cfg.n_layers, batch, d_in // ssm.head_dim, ssm.d_state, ssm.head_dim),
    }


def prefill(params, batch, cfg, mesh_ctx=None, max_len=None):
    """Run the prompt: (logits at its last position (B, V), the cache a
    `decode_step` continues from, each application's K / V zero-padded to
    ``max_len`` (default: the prompt's length))."""
    if mesh_ctx is not None:
        return _grid_prefill(params, batch, cfg, mesh_ctx, max_len)
    x = _embed(params, batch, cfg)
    emb = x
    max_len = max_len or x.shape[1]
    ks, vs, convs, ssds = [], [], [], []
    for gi, (start, length) in enumerate(_groups(cfg)):
        x, (k, v) = _shared_apply(_shared(params, cfg, gi), x, emb, cfg)
        pad = max_len - k.shape[1]
        if pad > 0:
            zk = k.new_zeros((k.shape[0], pad) + tuple(k.shape[2:]))
            k, v = torch.cat([k, zk], dim=1), torch.cat([v, zk], dim=1)
        ks.append(k)
        vs.append(v)
        for i in range(start, start + length):
            x, (conv_s, ssd_s) = M2.mamba2_block_apply(_layer(params, i), x, cfg)
            convs.append(conv_s)
            ssds.append(ssd_s)
    cache = {"shared_kv": {"k": torch.stack(ks), "v": torch.stack(vs)},
             "conv": torch.stack(convs), "ssd": torch.stack(ssds)}
    return _head(params, x[:, -1:, :], cfg)[:, 0, :], cache


def decode_step(params, cache, cache_len, batch, cfg, mesh_ctx=None):
    """One token a sequence (``batch["tokens"]`` (B, 1)) from ``cache``
    holding ``cache_len`` tokens (an int, or a 0-d integer tensor): the
    current token's embedding is re-injected at every shared block.
    Returns (logits (B, V), the new cache)."""
    if mesh_ctx is not None:
        return _grid_decode(params, cache, cache_len, batch, cfg, mesh_ctx)
    x = _embed(params, batch, cfg)
    emb = x
    if torch.is_tensor(cache_len):
        cache_len = cache_len.to(x.device)
    ks, vs, convs, ssds = [], [], [], []
    for gi, (start, length) in enumerate(_groups(cfg)):
        c = {"k": cache["shared_kv"]["k"][gi], "v": cache["shared_kv"]["v"][gi]}
        x, c_new = _shared_apply(_shared(params, cfg, gi), x, emb, cfg, c, cache_len)
        ks.append(c_new["k"])
        vs.append(c_new["v"])
        for i in range(start, start + length):
            x, (conv_s, ssd_s) = M2.mamba2_block_decode(_layer(params, i), x, cfg,
                                                        cache["conv"][i], cache["ssd"][i])
            convs.append(conv_s)
            ssds.append(ssd_s)
    new_cache = {"shared_kv": {"k": torch.stack(ks), "v": torch.stack(vs)},
                 "conv": torch.stack(convs), "ssd": torch.stack(ssds)}
    return _head(params, x, cfg)[:, 0, :], new_cache


# --------------------------------------------------------------------------
# the sharded step: one share a grid coordinate (see the module docstring)
# --------------------------------------------------------------------------

def _shared_grid(ps, specs, xs, embs, cfg, mc, full_kv=False, caches=None, seq_axes=(),
                 cache_len=None):
    """One shared-block application on a share: ``in_proj`` column-parallel
    over "model" and its output all-gathered (the attention's input is
    whole, as the residual stream), then `attention.attn_grid` (the whole
    sequence: returns each coordinate's (k, v), every kv head with
    ``full_kv``) or `attention.decode_attn_grid` against ``caches`` (one
    (k, v) a coordinate, the sequence split over ``seq_axes``: returns the
    new caches), and `layers.mlp_grid`."""
    w = gather_param([p["in_proj"] for p in ps], specs["in_proj"], mc)
    hs = [rms_norm(torch.cat([x, e], dim=-1), p["ln1"], cfg.norm_eps) @ wi.to(x.dtype)
          for p, x, e, wi in zip(ps, xs, embs, w)]
    if splits_on(specs["in_proj"], 1, mc.model_axis):
        hs = all_gather(hs, mc.model_axis, mc, 2)
    aps = [p["attn"] for p in ps]
    if caches is None:
        attn, kvs = attn_grid(aps, specs["attn"], hs, cfg, None, mc, full_kv)
    else:
        attn, kvs = decode_attn_grid(aps, specs["attn"], hs, cfg, caches, seq_axes, cache_len,
                                     mc=mc)
    xs = [x + a for x, a in zip(xs, attn)]
    h2 = [rms_norm(x, p["ln2"], cfg.norm_eps) for p, x in zip(ps, xs)]
    return [x + f for x, f in zip(xs, mlp_grid([p["mlp"] for p in ps], specs["mlp"], h2,
                                                cfg.mlp_act, mc))], kvs


def _grid_in(params, batch, cfg, mc, cache=None):
    """(parameter shares, batch shares, specs, embedded tokens a
    coordinate) of the grid; ``cache`` a whole cache (or its ``meta``
    stand-in) gives the specs its "cache"."""
    from repro_torch.distributed.sharding import to_shares

    specs = grid_specs(mc, params, batch, cache, batch["tokens"].shape[0])
    shares = to_shares(params, specs["params"], mc)
    bs = to_shares(batch, specs["batch"], mc)
    xs = embed_grid([p["embed"] for p in shares], specs["params"]["embed"],
                    [b["tokens"] for b in bs], cfg.activation_dtype, mc)
    return shares, bs, specs, xs


def _grid_trunk(params, batch, cfg, mc, max_len=None):
    """Every shared application and mamba layer on the grid: (shares of the
    final hidden state, the parameter shares, the batch shares, the
    specs, (each application's k / v and each layer's states a
    coordinate, empty unless ``max_len`` is given: a prefill))."""
    from repro_torch.distributed.sharding import P

    keep = max_len is not None
    cache = init_cache(cfg, batch["tokens"].shape[0], max_len, device="meta") if keep else None
    shares, bs, specs, xs = _grid_in(params, batch, cfg, mc, cache)
    embs = xs
    pspecs = specs["params"]
    mspecs = unstack_specs(shares[0]["mamba"], pspecs["mamba"])
    body = remat(lambda ps, xs: M2.mamba2_block_grid(ps, mspecs, xs, cfg, mc)[0], cfg)
    kvs, states = [], []
    for gi, (start, length) in enumerate(_groups(cfg)):
        j = gi % cfg.n_shared_blocks
        xs, kv = _shared_grid([p["shared"][j] for p in shares], pspecs["shared"][j], xs, embs,
                              cfg, mc, full_kv=keep)
        if keep:
            kspec = P(*specs["cache"]["shared_kv"]["k"][1:])
            kvs.append(kv_cache_share(kv, cfg, "global", max_len, kspec, mc))
        for i in range(start, start + length):
            ps = [_layer(p, i) for p in shares]
            if keep:
                xs, st = M2.mamba2_block_grid(ps, mspecs, xs, cfg, mc)
                states.append(st)
            else:
                xs = body(ps, xs)
    return xs, shares, bs, specs, (kvs, states)


def _stack_cache(kvs, states) -> Params:
    """A coordinate's cache: each application's {"k", "v"} and each mamba
    layer's (conv, ssd), stacked."""
    return {"shared_kv": {"k": torch.stack([kv["k"] for kv in kvs]),
                          "v": torch.stack([kv["v"] for kv in kvs])},
            "conv": torch.stack([st[0] for st in states]),
            "ssd": torch.stack([st[1] for st in states])}


def _grid_forward(params, batch, cfg, mc):
    xs, shares, _, specs, _ = _grid_trunk(params, batch, cfg, mc)
    return logits_grid(shares, specs, xs, cfg, mc), torch.zeros((), dtype=torch.float32,
                                                                device=xs[0].device)


def _grid_loss(params, batch, cfg, mc):
    xs, shares, bs, specs, _ = _grid_trunk(params, batch, cfg, mc)
    logits, vsplit = head_grid(shares, specs["params"], xs, cfg, mc)
    return loss_grid(logits, vsplit, bs, specs["batch"], cfg, mc)


def _grid_out(shares, specs, xs, kvs, states, cfg, mc):
    """(the logits of the last position, the caches) put back together
    from the grid's shares (a coordinate's own pieces with ``coord``): each
    application's k / v and each layer's states a coordinate, stacked once
    the logits are out."""
    from repro_torch.distributed.sharding import from_shares

    logits = logits_grid(shares, specs, xs, cfg, mc, last=True)
    caches = [_stack_cache([kv[k] for kv in kvs], [st[k] for st in states])
              for k in range(len(xs))]
    return logits, from_shares(caches, specs["cache"], mc)


def _grid_prefill(params, batch, cfg, mc, max_len):
    max_len = max_len or batch["tokens"].shape[1]
    xs, shares, _, specs, (kvs, states) = _grid_trunk(params, batch, cfg, mc, max_len)
    return _grid_out(shares, specs, xs, kvs, states, cfg, mc)


def _grid_decode(params, cache, cache_len, batch, cfg, mc):
    from repro_torch.distributed.collectives import axes_of
    from repro_torch.distributed.sharding import P, to_shares

    shares, _, specs, xs = _grid_in(params, batch, cfg, mc, cache)
    embs = xs
    cs = to_shares(cache, specs["cache"], mc)
    pspecs = specs["params"]
    mspecs = unstack_specs(shares[0]["mamba"], pspecs["mamba"])
    seq_axes = axes_of(seq_entry(P(*specs["cache"]["shared_kv"]["k"][1:])))
    kvs, states = [], []
    for gi, (start, length) in enumerate(_groups(cfg)):
        j = gi % cfg.n_shared_blocks
        xs, new = _shared_grid([p["shared"][j] for p in shares], pspecs["shared"][j], xs, embs,
                               cfg, mc, caches=[(c["shared_kv"]["k"][gi], c["shared_kv"]["v"][gi])
                                                for c in cs],
                               seq_axes=seq_axes, cache_len=cache_len)
        kvs.append([{"k": k, "v": v} for k, v in new])
        for i in range(start, start + length):
            xs, st = M2.mamba2_block_grid([_layer(p, i) for p in shares], mspecs, xs, cfg, mc,
                                          [(c["conv"][i], c["ssd"][i]) for c in cs])
            states.append(st)
    return _grid_out(shares, specs, xs, kvs, states, cfg, mc)
