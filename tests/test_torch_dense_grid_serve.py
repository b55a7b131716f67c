"""The sharded transformer's prefill and flash-decoding decode
(`repro_torch.models.transformer.prefill` / `decode_step` under a
`MeshContext` over a device grid of the CPU) against the reference's
`prefill` / `decode_step` jitted on Auto meshes of the same shapes, their
caches laid out by `cache_specs` (out_shardings of the prefill,
in_shardings of the decode), float32.

A 16-token prompt into a 24-position cache, then two decode steps: the
cache's sequence split over "model" (6 or 12 positions a coordinate),
gemma2's local layers a 24-slot window, kimi's experts on the
weights-stationary path."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from repro.distributed import sharding as js
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.distributed import sharding as ts
from repro_torch.models import transformer as tt
from test_torch_dense_grid import B, S, case_id, cfgs, contexts, draw_params, rel

MAX_LEN = S + 8
CASES = [(a, g) for a in ("qwen3-4b", "gemma2-27b", "musicgen-medium", "kimi-k2-1t-a32b")
         for g in ((2, 4), (2, 2))]
# max |difference| / max |reference|, float32, measured <= 8.8e-7 (logits,
# the flash-decoding softmax's max and sum psum'd over the sequence
# slices) and <= 8.1e-7 (caches) over these cases
LOGITS_TOL = 2e-6
CACHE_TOL = 2e-6


def _tokens(tcfg, n, seed):
    g = torch.Generator().manual_seed(seed)
    if tcfg.frontend == "embedding":
        return {"embeddings": torch.randn((B, n, tcfg.d_model), generator=g)}
    return {"tokens": torch.randint(0, tcfg.vocab, (B, n), generator=g, dtype=torch.int32)}


@functools.lru_cache(maxsize=None)
def reference(arch, grid):
    """The reference's prefill logits and cache, then two decode steps'
    logits and the last cache, jitted on the grid's Auto mesh."""
    jcfg, tcfg = cfgs(arch)
    jrules, _ = contexts(grid)
    jmc = js.make_mesh_context(jrules)
    p = draw_params(jcfg, jrules)
    prompt = _tokens(tcfg, S, 1)
    steps = [_tokens(tcfg, 1, 2 + i) for i in range(2)]
    mesh = jrules.mesh
    cache_shape = jax.eval_shape(lambda: jt.init_cache(jcfg, B, MAX_LEN, jmc))
    cshard = js.named(js.cache_specs(cache_shape, jrules, B), mesh)
    rep = NamedSharding(mesh, PartitionSpec())

    def jb(b):
        return {k: jnp.asarray(v.numpy()) for k, v in b.items()}

    with mesh:
        jp = jax.device_put(jax.tree.map(jnp.asarray, p), rep)
        logits, cache = jax.jit(lambda q, b: jt.prefill(q, b, jcfg, jmc, max_len=MAX_LEN),
                                out_shardings=(rep, cshard))(jp, jb(prompt))
        decode = jax.jit(lambda q, c, n, b: jt.decode_step(q, c, n, b, jcfg, jmc),
                         in_shardings=(rep, cshard, None, rep), out_shardings=(rep, cshard))
        out = [np.asarray(logits)]
        prefill_cache = jax.tree.map(np.asarray, cache)
        for i, b in enumerate(steps):
            lg, cache = decode(jp, cache, jnp.int32(S + i), jb(b))
            out.append(np.asarray(lg))
        return {"params": p, "prompt": prompt, "steps": steps, "logits": out,
                "prefill_cache": prefill_cache, "cache": jax.tree.map(np.asarray, cache)}


def _caches_close(got, want):
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda t: t.numpy(), got)), jax.tree.leaves(want)):
        assert g.shape == w.shape, path
        assert rel(g, w) <= CACHE_TOL, path


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_prefill_follows_the_references(case):
    arch, grid = case
    ref = reference(arch, grid)
    _, tcfg = cfgs(arch)
    _, trules = contexts(grid)
    tp = convert.lm_params_from_numpy(ref["params"], "cpu")
    logits, cache = tt.prefill(tp, ref["prompt"], tcfg, ts.make_mesh_context(trules),
                               max_len=MAX_LEN)
    assert rel(logits.numpy(), ref["logits"][0]) <= LOGITS_TOL
    _caches_close(cache, ref["prefill_cache"])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_flash_decoding_follows_the_references(case):
    """Two decode steps from the grid's own prefill: each coordinate writes
    the token where its slice holds the slot, the softmax's max and sum
    reduced over the sequence axes."""
    arch, grid = case
    ref = reference(arch, grid)
    _, tcfg = cfgs(arch)
    _, trules = contexts(grid)
    mc = ts.make_mesh_context(trules)
    tp = convert.lm_params_from_numpy(ref["params"], "cpu")
    _, cache = tt.prefill(tp, ref["prompt"], tcfg, mc, max_len=MAX_LEN)
    for i, b in enumerate(ref["steps"]):
        logits, cache = tt.decode_step(tp, cache, torch.tensor(S + i), b, tcfg, mc)
        assert rel(logits.numpy(), ref["logits"][1 + i]) <= LOGITS_TOL
    _caches_close(cache, ref["cache"])


def _bf16_study():
    """A narrow counterpart of `python3 chip_smoke.py --mesh-faults` (whose
    full-width readings set `chip_smoke.py`'s MESH_GRID_* bounds), the port
    alone in bfloat16 on the CPU: a narrow qwen3-4b (d_model 256, d_ff 512, vocab
    1024, 8 heads of 32, 4 kv heads, 4 layers) on a (2, 2) grid against the
    one-card route on the same weights, and the one-card route against
    float32, over four seeds: the first step's loss and grad_norm (batch 2
    x 256 tokens), then a 256-token prefill into a 272-position cache and
    16 decode steps (the worst step's max |difference| / max |logit|)."""
    import dataclasses

    from repro_torch import configs as tconfigs
    from repro_torch.training import train_loop as ttl
    from repro_torch.training.optimizer import global_norm, tree_map

    base = tconfigs.get_config("qwen3-4b")
    cfg = dataclasses.replace(base, d_model=256, d_ff=512, vocab=1024, n_heads=8, n_kv_heads=4,
                              head_dim=32, n_layers=4)
    f32 = dataclasses.replace(cfg, dtype="float32")
    mc = ts.make_mesh_context(ts.ShardingRules(mesh=ts.Mesh((2, 2), ("data", "model"), "cpu")))
    prompt, steps = 256, 16

    def logits_run(p, c, m, toks):
        out = []
        lg, cache = tt.prefill(p, {"tokens": toks[:, :prompt]}, c, m, max_len=prompt + steps)
        out.append(lg.float())
        for i in range(steps):
            lg, cache = tt.decode_step(p, cache, torch.tensor(prompt + i),
                                       {"tokens": toks[:, prompt + i:prompt + i + 1]}, c, m)
            out.append(lg.float())
        return out

    def worst(a, b):
        return max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b))

    print("qwen3 narrow (2, 2) bf16: |relative difference| of the first step's loss, grad_norm; "
          "max over prefill + 16 decodes of max |logit difference| / max |logit|: grid vs "
          "one-card, one-card vs float32")
    for seed in range(4):
        p = tt.init_params(torch.Generator().manual_seed(seed), cfg, mc, device="cpu")
        p32 = tree_map(lambda t: t.float(), p)
        batch = next(ttl.lm_batches(cfg.vocab, 1, batch=2, seq=256, seed=seed))
        runs = [(p, cfg, None), (p, cfg, mc), (p32, f32, None)]
        (l0, g0), (l1, g1), (lt, gt) = [
            (float(v), float(global_norm(g))) for v, g in
            (ttl.value_and_grad(lambda q, b, c=c, m=m: tt.loss_fn(q, b, c, m), q, batch)
             for q, c, m in runs)]
        toks = torch.randint(0, cfg.vocab, (2, prompt + steps),
                             generator=torch.Generator().manual_seed(100 + seed),
                             dtype=torch.int32)
        one, grid, truth = (logits_run(q, c, m, toks) for q, c, m in runs)
        print(f"  seed {seed}: step grid {abs(l1 / l0 - 1):.3g}, {abs(g1 / g0 - 1):.3g}; "
              f"one-card {abs(l0 / lt - 1):.3g}, {abs(g0 / gt - 1):.3g} | logits grid "
              f"{worst(grid, one):.3g}, one-card {worst(one, truth):.3g}")


if __name__ == "__main__":
    _bf16_study()
