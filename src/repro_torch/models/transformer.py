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
(`layers.remat`). ``mesh_ctx`` (`moe.MeshContext`) reaches the MoE
layers, which take the model-axis route over its device grid; the rest
of the model runs on the parameters' device, where the reference's
sharding constraints only place data.

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

from repro_torch.models.attention import attn_apply, attn_init, decode_attn_apply
from repro_torch.models.layers import (
    cross_entropy_loss,
    dense_init,
    mlp_apply,
    mlp_init,
    remat,
    rms_norm,
    softcap,
)
from repro_torch.models.moe import moe_apply, moe_init
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
