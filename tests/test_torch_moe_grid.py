"""The port's model-axis MoE route (`repro_torch.models.moe.moe_apply`
with a `MeshContext` over a device grid of the CPU) against the
reference's ``shard_map`` route under ``jax.jit`` on Auto meshes of the
8 CPU devices `tests/conftest.py` provides.

Every body's routing bookkeeping (top-k indices, the kept set, the slots)
array-equal to what the reference's body at the same (data, model)
coordinate computes, recorded by ``jax.debug.callback``; y and aux within
GRID_TOL; gradients within the one-card route's F32_TOL; the dropping
and the weights-stationary paths forced through ``stationary_threshold``,
with and without FSDP, float32 and int8 banks, reduced granite and
reduced kimi (its shared expert); a reduced granite train step with
rules against the reference's on its mesh.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding, PartitionSpec

from repro import configs as jconfigs
from repro.distributed import sharding as js
from repro.models import moe as jm
from repro.models import moe_quant as jq
from repro.models import transformer as jt
from repro.training import optimizer as jo
from repro.training import train_loop as jtl
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.distributed import sharding as ts
from repro_torch.models import moe as tm
from repro_torch.models import moe_quant as tq
from repro_torch.training import optimizer as to
from repro_torch.training import train_loop as ttl

# float32, the port's grid route against the reference's shard_map route,
# max |difference| / max |reference|: y measured <= 1.9e-7 and aux <= 1.2e-7
# relative (products and psums in another order)
GRID_TOL = 1e-6
# the one-card route's gradient tolerance (tests/test_torch_moe.py)
F32_TOL = 5e-6
AXES = ("data", "model")
ARCH = {"granite": "granite-moe-3b-a800m", "kimi": "kimi-k2-1t-a32b"}

# (arch, grid, fsdp, path, banks, num_experts): 6 experts pad to 8 on the
# 4-way model axis (their router columns -inf, never routed)
CASES = [
    ("granite", (2, 4), False, "dropping", "float32", 8),
    ("granite", (2, 4), True, "dropping", "float32", 8),
    ("granite", (2, 4), True, "stationary", "float32", 8),
    ("granite", (2, 4), False, "dropping", "float32", 6),
    ("granite", (2, 4), True, "stationary", "float32", 6),
    ("granite", (1, 4), False, "dropping", "float32", 8),
    ("granite", (1, 4), True, "stationary", "float32", 8),
    ("granite", (2, 2), True, "dropping", "int8", 8),
    ("granite", (2, 2), True, "stationary", "int8", 8),
    ("kimi", (2, 4), False, "dropping", "float32", 8),
    ("kimi", (2, 4), True, "stationary", "float32", 8),
    ("kimi", (2, 4), True, "dropping", "int8", 8),
    ("kimi", (2, 4), True, "stationary", "int8", 8),
    ("kimi", (1, 4), True, "dropping", "float32", 8),
    ("kimi", (2, 2), False, "dropping", "int8", 8),
    ("kimi", (2, 2), True, "stationary", "float32", 8),
]
GRAD_CASES = [
    ("granite", (2, 4), True, "dropping"),
    ("granite", (2, 4), True, "stationary"),
    ("kimi", (2, 2), False, "dropping"),
    ("kimi", (2, 2), True, "stationary"),
]


def _id(case) -> str:
    return "-".join(str(c) if not isinstance(c, tuple) else "x".join(map(str, c)) for c in case)


def _cfgs(arch, path="dropping", num_experts=8, capacity_factor=1.0):
    """Reduced float32 configs, the path forced: a threshold of 0 never
    takes the stationary path, 4096 always does here (FSDP on)."""
    def one(cfg):
        return dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
            cfg.moe, num_experts=num_experts, capacity_factor=capacity_factor,
            stationary_threshold=4096 if path == "stationary" else 0))

    return one(jconfigs.get_config(ARCH[arch]).reduced()), one(tconfigs.get_config(ARCH[arch]).reduced())


def _contexts(grid, fsdp):
    devs = np.array(jax.devices()[:math.prod(grid)]).reshape(grid)
    jmesh = jax.sharding.Mesh(devs, AXES, axis_types=(AxisType.Auto,) * 2)
    jrules = js.ShardingRules(mesh=jmesh, fsdp=fsdp)
    trules = ts.ShardingRules(mesh=ts.Mesh(grid, AXES, "cpu"), fsdp=fsdp)
    return jrules, trules


def _params(jcfg, jmc, seed=0):
    """The reference's `moe_init` tree under ``jmc`` (padded banks), drawn
    with numpy at its scales, float32."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jm.moe_init(k, jcfg, jmc), jax.random.PRNGKey(0))

    def draw(path, s):
        fan_in = s.shape[1] if path[-1].key == "w_down" else s.shape[0]
        return (rng.standard_normal(s.shape) / math.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _x(jcfg, b=4, s=16, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, jcfg.d_model)).astype(np.float32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


def _ref_grid_call(p, x, jcfg, jmc, n_slots, monkeypatch):
    """The reference's moe_apply under jax.jit on ``jmc``'s mesh, with what
    each shard_map body routed: (y, aux, {(data, model): {"idx", "keep",
    "slot"}})."""
    seen = {}
    top_k, where = jax.lax.top_k, jnp.where

    def record(name):
        def cb(coord, value):
            seen.setdefault(tuple(int(c) for c in coord), {})[name] = np.asarray(value)
        return cb

    def coord():
        return jnp.stack([jax.lax.axis_index(ax) for ax in AXES])

    def rec_top_k(probs, k):
        gates, idx = top_k(probs, k)
        jax.debug.callback(record("idx"), coord(), idx)
        return gates, idx

    def rec_where(cond, a, b):
        out = where(cond, a, b)
        if isinstance(b, int) and b == n_slots:  # slot = where(keep, ..., n_slots)
            jax.debug.callback(record("keep"), coord(), cond)
            jax.debug.callback(record("slot"), coord(), out)
        return out

    with monkeypatch.context() as mp:
        mp.setattr(jax.lax, "top_k", rec_top_k)
        mp.setattr(jnp, "where", rec_where)
        y, aux = jax.jit(lambda p, x: jm.moe_apply(p, x, jcfg, jmc))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        y = np.asarray(y)
        jax.effects_barrier()
    return y, float(aux), seen


def _port_grid_call(tp, tx, tcfg, tmc, monkeypatch):
    """The port's moe_apply on ``tmc``'s grid, with each body's (idx,
    keep, slot) in the order the bodies ran."""
    bodies = []
    dispatch = tm._dispatch

    def rec_dispatch(idx, *args):
        out = dispatch(idx, *args)
        bodies.append({"idx": idx.numpy(), "keep": out[0].numpy(), "slot": out[1].numpy()})
        return out

    with monkeypatch.context() as mp:
        mp.setattr(tm, "_dispatch", rec_dispatch)
        y, aux = tm.moe_apply(tp, tx, tcfg, tmc)
    return y, aux, bodies


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_grid_route_equals_the_references(case, monkeypatch):
    """Each body's top-k indices, kept set and slots array-equal to the
    reference's body at the same (data, model) coordinate (the dropping
    path: one routing a body over its data shard's rows; the stationary
    path: one a model shard over every row, the same at every data
    coordinate); y and aux within GRID_TOL."""
    arch, grid, fsdp, path, banks, n_exp = case
    jcfg, tcfg = _cfgs(arch, path, n_exp)
    jrules, trules = _contexts(grid, fsdp)
    jmc, tmc = js.make_mesh_context(jrules), ts.make_mesh_context(trules)
    p, x = _params(jcfg, jmc), _x(jcfg)
    if banks == "int8":
        p = jax.tree.map(np.asarray, jq.quantize_expert_params({"moe": p})["moe"])
    e_pad = 8
    assert (p["w_up"]["q"] if banks == "int8" else p["w_up"]).shape[0] == e_pad
    dp, n_model = grid
    m = jcfg.moe
    t = x.shape[0] * x.shape[1] // (dp if path == "dropping" else 1)
    n_slots = e_pad // n_model * max(int(t * m.top_k / m.num_experts * m.capacity_factor), 4)
    y_ref, aux_ref, seen = _ref_grid_call(p, x, jcfg, jmc, n_slots, monkeypatch)

    tp = convert.lm_params_from_numpy(p, "cpu")
    y, aux, bodies = _port_grid_call(tp, torch.from_numpy(x), tcfg, tmc, monkeypatch)
    assert sorted(seen) == [(i, j) for i in range(dp) for j in range(n_model)]
    assert len(bodies) == (dp * n_model if path == "dropping" else n_model)
    for (i, j), want in seen.items():
        got = bodies[i * n_model + j] if path == "dropping" else bodies[j]
        for name in ("idx", "keep", "slot"):
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{name} at {(i, j)}")
        assert int(got["idx"].max()) < m.num_experts
    if path == "dropping":  # capacity 8 for 64 choices a data shard: some are dropped
        e_loc = e_pad // n_model
        assert any(((b["idx"].reshape(-1) // e_loc == k % n_model) & ~b["keep"]).any()
                   for k, b in enumerate(bodies))
    assert _rel(y.numpy(), y_ref) <= GRID_TOL
    assert abs(float(aux) / aux_ref - 1) <= GRID_TOL


@pytest.mark.parametrize("case", GRAD_CASES, ids=_id)
def test_grid_route_gradients_equal_jax_grad(case):
    """d/dparams and d/dx of sum(y^2) + 0.01 aux through the grid route
    against ``jax.grad`` of the reference's shard_map route: every leaf
    reached (router, banks, shared), within F32_TOL."""
    arch, grid, fsdp, path = case
    jcfg, tcfg = _cfgs(arch, path)
    jrules, trules = _contexts(grid, fsdp)
    jmc, tmc = js.make_mesh_context(jrules), ts.make_mesh_context(trules)
    p, x = _params(jcfg, jmc), _x(jcfg, s=8)

    def loss(p, x):
        y, aux = jm.moe_apply(p, x, jcfg, jmc)
        return jnp.sum(y ** 2) + 0.01 * aux

    want_p, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, p),
                                                           jnp.asarray(x))
    tp = jax.tree.map(lambda t: t.requires_grad_(True), convert.lm_params_from_numpy(p, "cpu"))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tm.moe_apply(tp, tx, tcfg, tmc)
    (torch.sum(y ** 2) + 0.01 * aux).backward()
    assert _rel(tx.grad.numpy(), want_x) <= F32_TOL
    got = jax.tree.map(lambda t: t.grad.numpy(), tp)
    for (path_, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want_p)):
        assert np.abs(g).max() > 0, path_
        assert _rel(g, w) <= F32_TOL, path_


@pytest.mark.parametrize("grid", [(1, 4), (2, 2)], ids=_id)
def test_bank_slices_are_views_on_one_device(grid, monkeypatch):
    """On a grid whose entries are all one device, every body's expert
    slice (and, on the stationary path, each FSDP piece) shares the
    bank's storage: no bank is copied."""
    for path in ("dropping", "stationary"):
        _, tcfg = _cfgs("granite", path)
        tmc = ts.make_mesh_context(ts.ShardingRules(mesh=ts.Mesh(grid, AXES, "cpu")))
        p = tm.moe_init(torch.Generator().manual_seed(0), tcfg, tmc)
        ptrs = {name: p[name].untyped_storage().data_ptr() for name in ("w_up", "w_gate", "w_down")}
        einsum, seen = torch.einsum, []

        def rec_einsum(eq, a, w):
            seen.append(w.untyped_storage().data_ptr())
            return einsum(eq, a, w)

        with monkeypatch.context() as mp:
            mp.setattr(torch, "einsum", rec_einsum)
            tm.moe_apply(p, torch.randn(4, 16, tcfg.d_model), tcfg, tmc)
        # a body a (data, model) coordinate, or a piece an (FSDP, model) one
        assert len(seen) == 3 * grid[0] * grid[1]
        assert set(seen) == set(ptrs.values())


@pytest.mark.parametrize("path", ["dropping", "stationary"])
def test_moe_apply_on_a_grid_is_moe_grid_routing_once_a_data_shard(path, monkeypatch):
    """`moe_apply` with a mesh context runs the sharded step's route,
    `moe_grid`, once on the grid's shares; the replicated router routes
    each data shard's rows once (the stationary path's gathered rows
    once), not once a coordinate."""
    _, tcfg = _cfgs("granite", path)
    grid = (2, 2)
    tmc = ts.make_mesh_context(ts.ShardingRules(mesh=ts.Mesh(grid, AXES, "cpu")))
    p = tm.moe_init(torch.Generator().manual_seed(0), tcfg, tmc)
    x = torch.randn(4, 16, tcfg.d_model, generator=torch.Generator().manual_seed(1))
    calls = {"moe_grid": 0, "_routing": 0}

    def counting(name):
        fn = getattr(tm, name)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    with monkeypatch.context() as mp:
        for name in calls:
            mp.setattr(tm, name, counting(name))
        y, aux = tm.moe_apply(p, x, tcfg, tmc)
    assert calls == {"moe_grid": 1, "_routing": grid[0] if path == "dropping" else 1}
    assert y.shape == x.shape and torch.isfinite(y).all() and torch.isfinite(aux)


def test_a_batch_that_does_not_split_raises():
    _, tcfg = _cfgs("granite")
    tmc = ts.make_mesh_context(ts.ShardingRules(mesh=ts.Mesh((2, 2), AXES, "cpu")))
    p = tm.moe_init(torch.Generator().manual_seed(0), tcfg, tmc)
    with pytest.raises(ValueError, match="does not split over 2 data shards"):
        tm.moe_apply(p, torch.randn(3, 4, tcfg.d_model), tcfg, tmc)


def test_padded_banks_carry_over():
    """granite at full expert count on a 16-way model axis: the reference's
    `moe_init` under the mesh context pads 40 -> 48, the port's too, and
    `convert.lm_params_from_numpy` carries the padded tree leaf for leaf."""
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, num_experts=40))
                  for c in (jconfigs.get_config(ARCH["granite"]).reduced(),
                            tconfigs.get_config(ARCH["granite"]).reduced()))
    jmesh = jax.sharding.AbstractMesh((1, 16), AXES, axis_types=(AxisType.Auto,) * 2)
    jmc = js.make_mesh_context(js.ShardingRules(mesh=jmesh))
    tmc = ts.make_mesh_context(ts.ShardingRules(mesh=ts.Mesh((1, 16), AXES)))
    p = _params(jcfg, jmc)
    tp = convert.lm_params_from_numpy(p, "cpu")
    assert tp["w_up"].shape[0] == tp["router"].shape[1] == 48 == tm.padded_num_experts(40, tmc)
    drawn = tm.moe_init(torch.Generator().manual_seed(0), tcfg, tmc)
    for name, leaf in p.items():
        assert tuple(drawn[name].shape) == leaf.shape
        np.testing.assert_array_equal(tp[name].numpy(), leaf)


def test_lowering_with_rules_traces_the_grid():
    """`lower_train_step`, `lower_prefill` and `lower_decode_step` with
    rules on a (2, 2) grid of the CPU: the parameters drawn under the mesh
    context (7 experts padded to 8), every body's expert products counted
    (more FLOPs than the one-device step over 7 experts), the decode step
    on the stationary path with int8 expert banks (`serve_quant`)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import train_batch_shape
    from repro_torch.serving.serve_loop import lower_decode_step, lower_prefill

    cfg = dataclasses.replace(tconfigs.get_config(ARCH["kimi"]).reduced(), serve_quant=True,
                              moe=dataclasses.replace(
                                  tconfigs.get_config(ARCH["kimi"]).reduced().moe,
                                  num_experts=7))
    rules = ts.ShardingRules(mesh=ts.Mesh((2, 2), AXES, "cpu"))
    shape = train_batch_shape(cfg, ShapeSpec("t", "train", 32, 4))
    grid, params, _ = ttl.lower_train_step(cfg, shape, device="cpu", rules=rules)
    one, one_params, _ = ttl.lower_train_step(cfg, shape, device="cpu")
    assert params["layers"]["slot0_moe"]["moe"]["w_up"].shape[1] == 8
    assert one_params["layers"]["slot0_moe"]["moe"]["w_up"].shape[1] == 7
    assert grid.flops > one.flops and grid.peak_bytes > 0
    prefill, _ = lower_prefill(cfg, ShapeSpec("p", "prefill", 16, 4), "cpu", rules)
    decode, dparams, _ = lower_decode_step(cfg, ShapeSpec("d", "decode", 16, 4), "cpu", rules)
    assert prefill.flops > 0 and decode.flops > 0
    assert dparams["layers"]["slot0_moe"]["moe"]["w_up"]["q"].shape[1] == 8


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp-stationary", "dropping"])
def test_train_step_on_a_grid_follows_the_references(fsdp):
    """Reduced granite (8 experts, top-2), two AdamW steps with rules on a
    (2, 4) grid of the CPU against the reference's `build_train_step(cfg,
    rules)` jitted on the (2, 4) Auto mesh: FSDP on takes the stationary
    path (32 tokens a data shard), off the dropping path (a capacity from
    each shard's tokens). Loss and grad_norm within 1e-5 relative."""
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH["granite"]).reduced(), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH["granite"]).reduced(), dtype="float32")
    jrules, trules = _contexts((2, 4), fsdp)
    shapes = jax.eval_shape(lambda k: jt.init_params(k, jcfg, js.make_mesh_context(jrules)),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    p = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.05).astype(np.float32), shapes)
    lr = 3e-3
    jstep = jax.jit(jtl.build_train_step(jcfg, jrules, jtl.TrainConfig(jo.AdamWConfig(lr=lr))))
    tstep = ttl.build_train_step(tcfg, ttl.TrainConfig(to.AdamWConfig(lr=lr)), "cpu", trules)
    mesh = jrules.mesh
    jp = jax.tree.map(jnp.asarray, p)
    jp, jopt = jax.device_put((jp, jo.init_opt_state(jp, jo.AdamWConfig(lr=lr))),
                              NamedSharding(mesh, PartitionSpec()))
    tp = convert.lm_params_from_numpy(p, "cpu")
    topt = to.init_opt_state(tp, to.AdamWConfig(lr=lr))
    with mesh:
        for b in ttl.lm_batches(tcfg.vocab, 2, batch=4, seq=16):
            jp, jopt, jmet = jstep(jp, jopt, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
            tp, topt, tmet = tstep(tp, topt, b)
            assert abs(float(tmet["loss"]) / float(jmet["loss"]) - 1) <= 1e-5
            assert abs(float(tmet["grad_norm"]) / float(jmet["grad_norm"]) - 1) <= 1e-5


def _bf16_study():
    """The study behind `chip_smoke.py`'s GRID_* and KIMI_Y_TOL bounds, the
    port alone in bfloat16 at narrow widths: (1) a 4-layer granite (d_model
    256, 40 experts of 64 padded to 48, top-8) on a (1, 16) grid, the first
    step's loss and grad_norm against the one-card route on the same
    weights and the one-card route's own against float32; (2) kimi's MoE
    layer (384 experts, top-8, the shared expert) on a (2, 8) grid with
    FSDP, 128 tokens on the stationary path, y against the one-card route
    (bf16 and int8 banks) and the one-card route's against float32."""
    from repro_torch.models import transformer as tt
    from repro_torch.training.optimizer import global_norm, tree_map

    base = tconfigs.get_config(ARCH["granite"]).reduced()
    cfg = dataclasses.replace(base, d_model=256, d_ff=512, n_layers=4, vocab=1024,
                              moe=dataclasses.replace(base.moe, num_experts=40, top_k=8,
                                                      d_expert=64))
    mc = ts.make_mesh_context(ts.ShardingRules(mesh=ts.Mesh((1, 16), AXES, "cpu")))
    f32 = dataclasses.replace(cfg, dtype="float32")
    print("granite (1, 16), first step |relative difference|: grid vs one-card, "
          "one-card vs float32 (loss, grad_norm)")
    for seed in range(4):
        p = tt.init_params(torch.Generator().manual_seed(seed), cfg, mc, device="cpu")
        batch = next(ttl.lm_batches(cfg.vocab, 1, batch=1, seq=512, seed=seed))
        runs = [(p, cfg, None), (p, cfg, mc), (tree_map(lambda t: t.float(), p), f32, None)]
        (l0, g0), (l1, g1), (lt, gt) = [
            (float(v), float(global_norm(g))) for v, g in
            (ttl.value_and_grad(lambda q, b, c=c, x=x: tt.loss_fn(q, b, c, x), q, batch)
             for q, c, x in runs)]
        print(f"  seed {seed}: grid {abs(l1 / l0 - 1):.3g}, {abs(g1 / g0 - 1):.3g}; "
              f"one-card {abs(l0 / lt - 1):.3g}, {abs(g0 / gt - 1):.3g}")
    kimi = tconfigs.get_config(ARCH["kimi"])
    mc = ts.make_mesh_context(ts.ShardingRules(mesh=ts.Mesh((2, 8), AXES, "cpu")))
    print("kimi layer (2, 8) stationary, max |difference| / max |y|: grid vs one-card "
          "(bf16, int8), one-card bf16 vs float32")
    for d, f in ((512, 128), (1024, 256)):
        cfg = dataclasses.replace(kimi, d_model=d, moe=dataclasses.replace(kimi.moe, d_expert=f))
        for seed in range(3):
            p = tree_map(lambda t: t.to(torch.bfloat16),
                         tm.moe_init(torch.Generator().manual_seed(seed), cfg, mc))
            x = torch.randn((128, 1, d), generator=torch.Generator().manual_seed(100 + seed))
            x = x.to(torch.bfloat16)
            errs = []
            for q in (p, tq.quantize_expert_params({"moe": p})["moe"]):
                y0 = tm.moe_apply(q, x, cfg)[0].float()
                errs.append(_rel(tm.moe_apply(q, x, cfg, mc)[0].float().numpy(), y0.numpy()))
            y32 = tm.moe_apply(tree_map(lambda t: t.float(), p), x.float(), cfg)[0]
            own = _rel(tm.moe_apply(p, x, cfg)[0].float().numpy(), y32.numpy())
            print(f"  d_model {d} seed {seed}: grid {errs[0]:.3g} / {errs[1]:.3g}, "
                  f"one-card {own:.3g}")


if __name__ == "__main__":
    _bf16_study()
