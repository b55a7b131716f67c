"""The port's one-card MoE route (`repro_torch.models.moe`,
`moe_quant`) against the reference's on the CPU.

The routing bookkeeping array-equal to what the reference computes in
the same call (its top-k indices, `keep`, `slot`, the dispatch buffer
``x[tok_for_slot] * valid_slot`` its experts receive, `load`); y, aux and
the gradients within stated tolerances; capacity drops; padded experts
never routed; the shared expert; int8 expert banks array-equal to the
reference's `quantize_expert_params` / `dequant_weight`; and the
reference's own oracles of `tests/test_moe.py` held on the port.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jm
from repro.models import moe_quant as jq
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import moe as tm
from repro_torch.models import moe_quant as tq

# float32, port against reference, max |difference| / max |reference|:
# y measured <= 3e-7, gradients <= 6e-7 (products in another order), aux
# <= 1e-7 relative
F32_TOL = 5e-6


class _ModelAxis:
    """A stand-in for the reference's MeshContext on an 8-way model axis."""
    model_size = 8
    model_axis = "model"


def _cfgs(arch="granite-moe-3b-a800m", capacity_factor=16.0, num_experts=8):
    def one(cfg):
        return dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
            cfg.moe, num_experts=num_experts, capacity_factor=capacity_factor))

    return one(jconfigs.get_config(arch).reduced()), one(tconfigs.get_config(arch).reduced())


def _params(jcfg, mesh_ctx=None, seed=0):
    """Parameters of the reference's `moe_init` tree (shapes by
    ``jax.eval_shape``), drawn with numpy at its scales, float32."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jm.moe_init(k, jcfg, mesh_ctx), jax.random.PRNGKey(0))

    def draw(path, s):
        name = path[-1].key
        fan_in = s.shape[1] if name == "w_down" else s.shape[0]
        return (rng.standard_normal(s.shape) / math.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _x(jcfg, b=2, s=16, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, jcfg.d_model)).astype(np.float32)


def _ref_call(p, x, jcfg, monkeypatch):
    """The reference's moe_apply, eagerly, with what its routing computed:
    (y, aux, {"idx", "gates", "keep", "slot", "buf"})."""
    seen = {}
    top_k, where, ffn = jax.lax.top_k, jnp.where, jm._expert_ffn

    def rec_top_k(probs, k):
        seen["gates"], seen["idx"] = top_k(probs, k)
        return seen["gates"], seen["idx"]

    def rec_where(cond, a, b):
        out = where(cond, a, b)
        if isinstance(b, int) and b == seen.get("n_slots"):  # slot = where(keep, ..., n_slots)
            seen["keep"], seen["slot"] = np.asarray(cond), np.asarray(out)
        return out

    def rec_ffn(p_loc, xb, act):
        seen["buf"] = np.asarray(xb).reshape(-1, xb.shape[-1])
        return ffn(p_loc, xb, act)

    m = jcfg.moe
    t = x.shape[0] * x.shape[1]
    e_pad = (p["w_up"]["q"] if isinstance(p["w_up"], dict) else p["w_up"]).shape[0]
    seen["n_slots"] = e_pad * max(int(t * m.top_k / m.num_experts * m.capacity_factor), 4)
    with monkeypatch.context() as mp:
        mp.setattr(jax.lax, "top_k", rec_top_k)
        mp.setattr(jnp, "where", rec_where)
        mp.setattr(jm, "_expert_ffn", rec_ffn)
        y, aux = jm.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    return np.asarray(y), float(aux), seen


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", ["no-drops", "drops", "padded", "shared"])
def test_routing_equals_the_references(case, monkeypatch):
    """Top-k indices, keep, slot, tok_for_slot, the dispatch buffer and
    load array-equal; the gates, y and aux within F32_TOL. "drops": capacity
    factor 0.25 (capacity 4 of 32 choices an expert: keep has False);
    "padded": 5 experts padded to 8 by an 8-way model axis (never
    routed); "shared": kimi-k2's reduced config with its shared expert."""
    arch = "kimi-k2-1t-a32b" if case == "shared" else "granite-moe-3b-a800m"
    jcfg, tcfg = _cfgs(arch, capacity_factor=0.25 if case == "drops" else 16.0,
                       num_experts=5 if case == "padded" else 8)
    mesh_ctx = _ModelAxis() if case == "padded" else None
    p, x = _params(jcfg, mesh_ctx), _x(jcfg, s=64 if case == "drops" else 16)
    assert ("shared" in p) == (case == "shared")
    y_ref, aux_ref, seen = _ref_call(p, x, jcfg, monkeypatch)

    tp, tx = convert.lm_params_from_numpy(p, "cpu"), torch.from_numpy(x)
    t, d = x.shape[0] * x.shape[1], x.shape[2]
    m = tcfg.moe
    e_pad = tp["w_up"].shape[0]
    assert e_pad == (8 if case == "padded" else m.num_experts) == tm.padded_num_experts(
        m.num_experts, mesh_ctx)
    capacity = max(int(t * m.top_k / m.num_experts * m.capacity_factor), 4)
    probs, gates, idx = tm._route(tx.reshape(t, d), tp["router"], m.num_experts, m.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(seen["idx"]))
    top = np.asarray(seen["gates"])  # the reference's top-k probabilities, renormalized
    assert _rel(gates.numpy(), top / np.maximum(top.sum(-1, keepdims=True), 1e-9)) <= F32_TOL
    assert int(idx.max()) < m.num_experts and float(probs[:, m.num_experts:].sum()) == 0.0
    keep, slot, tok_for_slot, valid_slot = tm._dispatch(idx, e_pad, capacity)
    np.testing.assert_array_equal(keep.numpy(), seen["keep"])
    np.testing.assert_array_equal(slot.numpy(), seen["slot"])
    assert bool(keep.all()) == (case != "drops")
    buf = tx.reshape(t, d)[tok_for_slot.long()] * valid_slot[:, None].float()
    np.testing.assert_array_equal(buf.numpy(), seen["buf"])
    # .at[slot].max(flat_tok) by its definition: each kept choice's token in its slot
    want_tok = np.zeros(e_pad * capacity + 1, np.int32)
    np.maximum.at(want_tok, seen["slot"], np.repeat(np.arange(t, dtype=np.int32), m.top_k))
    np.testing.assert_array_equal(tok_for_slot.numpy(), want_tok[:-1])
    load = np.bincount(np.asarray(seen["idx"]).ravel(), minlength=e_pad).astype(np.float32)
    np.testing.assert_array_equal(tm._load(idx, e_pad).numpy(), load / (t * m.top_k))

    y, aux = tm.moe_apply(tp, tx, tcfg)
    assert _rel(y.numpy(), y_ref) <= F32_TOL
    assert abs(float(aux) / aux_ref - 1) <= F32_TOL


def test_ties_go_to_the_lower_index():
    """A row of equal probabilities routes to the first top_k experts,
    as ``jax.lax.top_k`` settles a tie."""
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3]])
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    got_v, got_i = tm._top_k(probs, 2)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i.tolist() == [[0, 1], [1, 2]]


def _dense_reference(p, x, cfg):
    """Every token to its top-k experts with no capacity limit (the
    reference test's oracle, in torch)."""
    m = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    e_pad = p["w_up"].shape[0]
    logits = xf @ p["router"]
    logits = torch.where(torch.arange(e_pad) < m.num_experts, logits, -torch.inf)
    gates, idx = torch.topk(torch.softmax(logits, -1), m.top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(xf)
    for e in range(e_pad):
        y_e = (torch.nn.functional.silu(xf @ p["w_gate"][e]) * (xf @ p["w_up"][e])) @ p["w_down"][e]
        out = out + ((idx == e) * gates).sum(-1)[:, None] * y_e
    return out.reshape(x.shape)


def test_moe_matches_dense_reference_and_drops_reduce_the_norm():
    """The reference's oracles on the port: without drops the dense
    routing within 1e-5 and aux > 0; capacity factor 0.25 drops tokens
    and lowers the output's norm."""
    jcfg, tcfg = _cfgs()
    p = convert.lm_params_from_numpy(_params(jcfg), "cpu")
    x = torch.from_numpy(_x(jcfg, s=32))
    y, aux = tm.moe_apply(p, x, tcfg)
    np.testing.assert_allclose(y.numpy(), _dense_reference(p, x, tcfg).numpy(), atol=1e-5)
    assert float(aux) > 0
    _, lo = _cfgs(capacity_factor=0.25)
    assert float(tm.moe_apply(p, x, lo)[0].norm()) < float(y.norm())


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "kimi-k2-1t-a32b"])
def test_moe_gradients_equal_the_references(arch):
    """d/dparams and d/dx of sum(y^2) + 0.01 aux, through the gates, the
    scatter-max inversion and the combine, against ``jax.grad``; every
    leaf reached (router, banks, shared)."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=1.0)
    p, x = _params(jcfg), _x(jcfg, s=24)

    def loss(p, x):
        y, aux = jm.moe_apply(p, x, jcfg)
        return jnp.sum(y ** 2) + 0.01 * aux

    want_p, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, p),
                                                           jnp.asarray(x))
    tp = jax.tree.map(lambda t: t.requires_grad_(True), convert.lm_params_from_numpy(p, "cpu"))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tm.moe_apply(tp, tx, tcfg)
    (torch.sum(y ** 2) + 0.01 * aux).backward()
    assert _rel(tx.grad.numpy(), want_x) <= F32_TOL
    got = jax.tree.map(lambda t: t.grad.numpy(), tp)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want_p)):
        assert np.abs(g).max() > 0, path
        assert _rel(g, w) <= F32_TOL, path


def test_int8_experts_equal_the_references():
    """Codes and scales array-equal to the reference's
    `quantize_expert_params` (the shared expert and the router left
    alone), `dequant_weight` array-equal, the quantized layer within
    F32_TOL of the reference's quantized layer and ~1 % of the float
    one; `quantize_expert_shapes` gives the codes' and scales' shapes."""
    jcfg, tcfg = _cfgs("kimi-k2-1t-a32b")
    p = _params(jcfg)
    want = jq.quantize_expert_params({"moe": jax.tree.map(jnp.asarray, p)})["moe"]
    got = tq.quantize_expert_params({"moe": convert.lm_params_from_numpy(p, "cpu")})["moe"]
    for name in ("w_up", "w_gate", "w_down"):
        assert got[name]["q"].dtype == torch.int8 and got[name]["s"].dtype == torch.float32
        np.testing.assert_array_equal(got[name]["q"].numpy(), np.asarray(want[name]["q"]))
        np.testing.assert_array_equal(got[name]["s"].numpy(), np.asarray(want[name]["s"]))
        np.testing.assert_array_equal(tq.dequant_weight(got[name], torch.float32).numpy(),
                                      np.asarray(jq.dequant_weight(want[name], jnp.float32)))
    assert torch.is_tensor(got["router"]) and torch.is_tensor(got["shared"]["w_up"])
    x = _x(jcfg) * 0.5
    yq, _ = tm.moe_apply(got, torch.from_numpy(x), tcfg)
    y_ref, _ = jm.moe_apply(want, jnp.asarray(x), jcfg)
    assert _rel(yq.numpy(), y_ref) <= F32_TOL
    y, _ = tm.moe_apply(convert.lm_params_from_numpy(p, "cpu"), torch.from_numpy(x), tcfg)
    assert _rel(yq.numpy(), y.numpy()) < 0.05
    shapes = tq.quantize_expert_shapes({"moe": {"w_up": torch.empty((8, 64, 32), device="meta"),
                                                "shared": {"w_up": torch.empty((64, 32))}}})
    assert shapes["moe"]["w_up"]["q"].shape == (8, 64, 32)
    assert shapes["moe"]["w_up"]["q"].dtype == torch.int8
    assert shapes["moe"]["w_up"]["s"].shape == (8, 64, 1)
    assert torch.is_tensor(shapes["moe"]["shared"]["w_up"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_token_gather_gradient_is_index_selects_in_a_fixed_order(dtype):
    """The dispatch gather's gradient (`_TokenGather`: each token's kept
    slots added in slot order in float32, rounded once) is bit-equal on
    the CPU to index_select's own backward (an index_add in index order,
    float32 accumulation), which on the card adds in its atomics' order:
    top-8 of 40 experts with drops, so tokens gather up to 8 slots."""
    t, d, e, k, capacity = 96, 16, 40, 8, 12
    gen = torch.Generator().manual_seed(5)
    idx = tm._top_k(torch.rand((t, e), generator=gen), k)[1]
    keep, slot, tok_for_slot, valid_slot = tm._dispatch(idx, e, capacity)
    assert not bool(keep.all())
    x = torch.randn((t, d), generator=gen).to(dtype)
    g = torch.randn((e * capacity, d), generator=gen).to(dtype)
    valid = valid_slot.to(dtype)[:, None]
    grads = []
    for gather in (lambda x: tm._TokenGather.apply(x, tok_for_slot, slot.reshape(t, k), e),
                   lambda x: torch.index_select(x, 0, tok_for_slot.to(torch.int64))):
        leaf = x.clone().requires_grad_(True)
        (gather(leaf) * valid * g).sum().backward()
        grads.append(leaf.grad)
    assert torch.equal(grads[0], grads[1])
