"""The port's sharded transformer step (`repro_torch.models.transformer`
under a `MeshContext` over a device grid of the CPU) against the
reference's `build_train_step(cfg, rules)` and `forward`, jitted on Auto
meshes of the same shapes over the 8 CPU devices `tests/conftest.py`
provides, in float32.

Reduced qwen3-4b and kimi-k2 (dense prefix, MoE on the
weights-stationary path, shared expert) on (2, 4), (1, 4) and (2, 2)
grids: every coordinate's parameter pieces shaped as
``NamedSharding.shard_shape``, the forward, the gradients and two AdamW
steps (the `check_*` functions, which
tests/test_torch_dense_grid_variants.py runs for gemma2-27b and
musicgen-medium); the grid's collectives in both forms. The prefill and
the flash-decoding decode are in tests/test_torch_dense_grid_serve.py.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding, PartitionSpec
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.distributed import sharding as js
from repro.models import transformer as jt
from repro.training import optimizer as jo
from repro.training import train_loop as jtl
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.distributed import collectives as tcol
from repro_torch.distributed import sharding as ts
from repro_torch.models import transformer as tt
from repro_torch.training import optimizer as to
from repro_torch.training import train_loop as ttl

AXES = ("data", "model")
GRIDS = [(2, 4), (1, 4), (2, 2)]
CASES = [(a, g) for a in ("qwen3-4b", "kimi-k2-1t-a32b") for g in GRIDS]
B, S = 4, 16
LR = 3e-3
# max |logits - reference| / max |reference|, float32, measured <= 9.9e-7
# over the twelve cases of this file and the variants': the heads' and the
# hidden dim's partial sums psum'd in grid order where the reference's
# partitioned program adds them in its own
FWD_TOL = 1e-6
# loss and grad_norm of two AdamW steps, relative; measured <= 5.6e-6
STEP_TOL = 1e-5
# max |gradient - reference| / max |reference| a leaf; measured <= 2.2e-6
GRAD_TOL = 5e-6


def case_id(case) -> str:
    arch, grid = case
    return f"{arch}-{'x'.join(map(str, grid))}"


def cfgs(arch):
    return tuple(dataclasses.replace(c.get_config(arch).reduced(), dtype="float32")
                 for c in (jconfigs, tconfigs))


def contexts(grid):
    devs = np.array(jax.devices()[:math.prod(grid)]).reshape(grid)
    jmesh = jax.sharding.Mesh(devs, AXES, axis_types=(AxisType.Auto,) * 2)
    return js.ShardingRules(mesh=jmesh), ts.ShardingRules(mesh=ts.Mesh(grid, AXES, "cpu"))


def draw_params(jcfg, jrules, seed=3):
    """The reference's parameter tree under the grid's mesh context (padded
    experts), drawn with numpy, float32."""
    shapes = jax.eval_shape(lambda k: jt.init_params(k, jcfg, js.make_mesh_context(jrules)),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
                        shapes)


def batches(tcfg, n=2, seed=0):
    emb = tcfg.d_model if tcfg.frontend == "embedding" else None
    return list(ttl.lm_batches(tcfg.vocab, n, batch=B, seq=S, seed=seed, embed_dim=emb))


def jbatch(b):
    return {k: jnp.asarray(v.numpy()) for k, v in b.items()}


def rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def reference(arch, grid):
    """The reference's logits and gradients on the first batch, and loss /
    grad_norm over two AdamW steps, in one program jitted on the grid's
    Auto mesh (inputs replicated)."""
    jcfg, _ = cfgs(arch)
    jrules, _ = contexts(grid)
    jmc = js.make_mesh_context(jrules)
    p = draw_params(jcfg, jrules)
    bs = [jbatch(b) for b in batches(cfgs(arch)[1])]
    mesh = jrules.mesh
    rep = NamedSharding(mesh, PartitionSpec())
    step = jtl.build_train_step(jcfg, jrules, jtl.TrainConfig(jo.AdamWConfig(lr=LR)))

    def run(p, bs):
        logits, _ = jt.forward(p, bs[0], jcfg, jmc)
        grads = jax.grad(lambda q: jt.loss_fn(q, bs[0], jcfg, jmc))(p)
        opt = jo.init_opt_state(p, jo.AdamWConfig(lr=LR))
        metrics = []
        for b in bs:
            p, opt, met = step(p, opt, b)
            metrics.append((met["loss"], met["grad_norm"]))
        return logits, grads, metrics

    with mesh:
        jp = jax.device_put(jax.tree.map(jnp.asarray, p), rep)
        logits, grads, metrics = jax.jit(run)(jp, bs)
    return {"params": p, "logits": np.asarray(logits), "grads": jax.tree.map(np.asarray, grads),
            "metrics": [(float(a), float(b)) for a, b in metrics]}


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_pieces_are_shard_shapes(case):
    check_pieces(case)


def check_pieces(case):
    """Each coordinate's piece of every parameter (`sharding.shard`) has
    ``NamedSharding(mesh, spec).shard_shape`` of the reference's spec, and
    `local_shapes` says the same."""
    arch, grid = case
    jcfg, tcfg = cfgs(arch)
    jrules, trules = contexts(grid)
    shapes = jax.eval_shape(lambda k: jt.init_params(k, jcfg, js.make_mesh_context(jrules)),
                            jax.random.PRNGKey(0))
    jspecs = js.param_specs(shapes, jrules)
    tp = tt.init_params(torch.Generator().manual_seed(0), tcfg,
                        ts.make_mesh_context(trules), device="cpu")
    tspecs = ts.param_specs(tp, trules)
    want = [NamedSharding(jrules.mesh, sp).shard_shape(s.shape) for s, sp in
            zip(jax.tree.leaves(shapes), jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(
                x, PartitionSpec)))]
    local = [tuple(t.shape) for t in to._leaves(ts.local_shapes(tp, tspecs, trules.mesh))]
    assert local == [tuple(w) for w in want]
    for c in ts.make_mesh_context(trules).coords:
        pieces = ts.shard(tp, tspecs, trules.mesh, c)
        assert [tuple(t.shape) for t in to._leaves(pieces)] == local
        # views of the whole tree: nothing copied
        for piece, whole in zip(to._leaves(pieces), to._leaves(tp)):
            assert piece.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr()


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_forward_follows_the_references(case):
    check_forward(case)


def check_forward(case):
    arch, grid = case
    ref = reference(arch, grid)
    _, tcfg = cfgs(arch)
    _, trules = contexts(grid)
    tp = convert.lm_params_from_numpy(ref["params"], "cpu")
    logits, _ = tt.forward(tp, batches(tcfg)[0], tcfg, ts.make_mesh_context(trules))
    assert logits.shape == ref["logits"].shape
    assert rel(logits.numpy(), ref["logits"]) <= FWD_TOL


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_gradients_follow_the_references(case):
    check_gradients(case)


def check_gradients(case):
    """Every leaf's gradient through the grid's collectives (psum and its
    dual, all-gather and reduce-scatter) within GRAD_TOL of ``jax.grad``
    of the reference's sharded loss."""
    arch, grid = case
    ref = reference(arch, grid)
    _, tcfg = cfgs(arch)
    _, trules = contexts(grid)
    tp = convert.lm_params_from_numpy(ref["params"], "cpu")
    mc = ts.make_mesh_context(trules)
    _, grads = ttl.value_and_grad(lambda q, b: tt.loss_fn(q, b, tcfg, mc), tp, batches(tcfg)[0])
    got = jax.tree.map(lambda t: t.numpy(), grads)
    reached = 0
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(ref["grads"])):
        if np.abs(w).max() == 0:  # the embedding frontend leaves "embed" unread
            assert np.abs(g).max() == 0, path
            continue
        reached += 1
        assert rel(g, w) <= GRAD_TOL, path
    assert reached > 0


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_two_adamw_steps_follow_the_references(case):
    check_steps(case)


def check_steps(case):
    arch, grid = case
    ref = reference(arch, grid)
    _, tcfg = cfgs(arch)
    _, trules = contexts(grid)
    tp = convert.lm_params_from_numpy(ref["params"], "cpu")
    topt = to.init_opt_state(tp, to.AdamWConfig(lr=LR))
    step = ttl.build_train_step(tcfg, ttl.TrainConfig(to.AdamWConfig(lr=LR)), "cpu", trules)
    for b, (loss, gnorm) in zip(batches(tcfg), ref["metrics"]):
        tp, topt, met = step(tp, topt, b)
        assert abs(float(met["loss"]) / loss - 1) <= STEP_TOL
        assert abs(float(met["grad_norm"]) / gnorm - 1) <= STEP_TOL


def test_the_one_device_step_runs_no_grid_code(monkeypatch):
    """Without rules the step is the one-device step: no share is built
    and no collective runs (its numbers are held to the reference by
    tests/test_torch_transformer.py)."""
    def boom(*a, **k):
        raise AssertionError("grid code on the one-device path")

    monkeypatch.setattr(tt, "_grid_trunk", boom)
    monkeypatch.setattr(tcol, "_collective", boom)
    monkeypatch.setattr(tcol, "_report", boom)
    _, tcfg = cfgs("kimi-k2-1t-a32b")
    tp = tt.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    step = ttl.build_train_step(tcfg, ttl.TrainConfig(), "cpu")
    _, _, met = step(tp, to.init_opt_state(tp, to.AdamWConfig()), batches(tcfg)[0])
    assert np.isfinite(float(met["loss"]))


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

class _Counter(TorchDispatchMode):
    """A dispatch mode that records the collectives run while it is on."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def note_collective(self, kind, wire, mesh, axes, group):
        self.seen.append((kind, wire, axes, len(group)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _grid_ctx(grid=(2, 4), coord=None):
    rules = ts.ShardingRules(mesh=ts.Mesh(grid, AXES, "cpu"))
    return ts.make_mesh_context(rules, coord, {} if coord is not None else None)


def _share(mc, shape=(3, 8), seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g) for _ in mc.coords]


@pytest.mark.parametrize("axes", ["model", "data", ("data", "model")])
def test_full_grid_collectives_sum_and_gather_in_order(axes):
    """On a full (2, 4) grid: psum and pmax give each group's sum / max in
    shard order, all_gather concatenates, reduce_scatter hands out chunks
    of the sum, all_to_all swaps a split dim for a concatenated one."""
    mc = _grid_ctx()
    xs = _share(mc)
    names = (axes,) if isinstance(axes, str) else axes
    n = tcol.axes_size(mc.mesh, names)

    def group(k):
        c = mc.coords[k]
        return [i for i, d in enumerate(mc.coords)
                if all(d[a] == c[a] for a, ax in enumerate(AXES) if ax not in names)]

    for k, (s_, m_, g_, r_, a_) in enumerate(zip(
            tcol.psum(xs, axes, mc), tcol.pmax(xs, axes, mc), tcol.all_gather(xs, axes, mc, 1),
            tcol.reduce_scatter(xs, axes, mc, 1), tcol.all_to_all(xs, axes, mc, 1, 0))):
        members = sorted(group(k), key=lambda i: tcol.axis_index(mc.mesh, mc.coords[i], names))
        assert len(members) == n
        total = xs[members[0]]
        for i in members[1:]:
            total = total + xs[i]
        assert torch.equal(s_, total)
        assert torch.equal(m_, torch.stack([xs[i] for i in members]).amax(0))
        assert torch.equal(g_, torch.cat([xs[i] for i in members], 1))
        me = members.index(k)
        assert torch.equal(r_, total.chunk(n, 1)[me])
        assert torch.equal(a_, torch.cat([xs[i].chunk(n, 1)[me] for i in members], 0))


@pytest.mark.parametrize("kind", ["psum", "all_gather", "reduce_scatter", "all_to_all"])
def test_full_grid_collective_backward_is_its_dual(kind):
    """d/dx of sum(w * f(x)) through a collective on the full grid equals
    the same through its plain-tensor spelling."""
    mc = _grid_ctx()
    xs = [x.requires_grad_(True) for x in _share(mc)]
    fn = {"psum": lambda v: tcol.psum(v, "model", mc),
          "all_gather": lambda v: tcol.all_gather(v, "model", mc, 1),
          "reduce_scatter": lambda v: tcol.reduce_scatter(v, "model", mc, 1),
          "all_to_all": lambda v: tcol.all_to_all(v, "model", mc, 1, 0)}[kind]
    outs = fn(xs)
    ws = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i))
          for i, o in enumerate(outs)]
    sum(torch.sum(w * o) for w, o in zip(ws, outs)).backward()
    got = [x.grad.clone() for x in xs]
    ys = [x.detach().clone().requires_grad_(True) for x in xs]
    outs2 = []
    for k, c in enumerate(mc.coords):
        members = [i for i, d in enumerate(mc.coords) if d[0] == c[0]]
        me = members.index(k)
        n = len(members)
        if kind == "psum":
            outs2.append(sum(ys[i] for i in members))
        elif kind == "all_gather":
            outs2.append(torch.cat([ys[i] for i in members], 1))
        elif kind == "reduce_scatter":
            outs2.append(sum(ys[i] for i in members).chunk(n, 1)[me])
        else:
            outs2.append(torch.cat([ys[i].chunk(n, 1)[me] for i in members], 0))
    sum(torch.sum(w * o) for w, o in zip(ws, outs2)).backward()
    for g, y in zip(got, ys):
        torch.testing.assert_close(g, y.grad, rtol=0, atol=1e-6)


@pytest.mark.parametrize("adjacent", [True, False], ids=["views", "copies"])
def test_a_one_device_gather_of_adjacent_pieces_is_a_view(adjacent):
    """On a full grid of one device, gathering a tensor's adjacent pieces
    (`sharding.shard`'s views) gives a view of it, one a member, with the
    gathered values and gradients; pieces that are copies are concatenated."""
    mc = _grid_ctx()
    w = torch.randn((6, 8), generator=torch.Generator().manual_seed(0), requires_grad=True)
    spec = ts.P("data", "model")
    pieces = [ts.shard(w, spec, mc.mesh, c) for c in mc.coords]
    if not adjacent:
        pieces = [p.clone() for p in pieces]
    outs = tcol.all_gather(pieces, "data", mc, 0)
    ws = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i))
          for i, o in enumerate(outs)]
    sum(torch.sum(g * o) for g, o in zip(ws, outs)).backward()
    want_grad = torch.zeros_like(w)
    for k, c in enumerate(mc.coords):
        j = tcol.axis_index(mc.mesh, c, "model")
        cols = w.shape[1] // mc.mesh.shape["model"]
        assert torch.equal(outs[k], w.detach()[:, j * cols:(j + 1) * cols])
        shares = outs[k].untyped_storage().data_ptr() == w.untyped_storage().data_ptr()
        assert shares == adjacent
        want_grad[:, j * cols:(j + 1) * cols] += ws[k]
    torch.testing.assert_close(w.grad, want_grad, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind,shape,wire", [
    ("psum", (3, 8), 2 * 96 * 3 / 4),
    ("all_gather", (3, 8, 4), 96 * 4 * 3 / 4 * 4),
    ("reduce_scatter", (3, 8), 96 * 3 / 4),
    ("all_to_all", (3, 8), 96 * 3 / 4),
    ("pmax", (3, 8), 2 * 96 * 3 / 4),
])
def test_lone_forms_have_the_real_shapes_and_wire_bytes(kind, shape, wire):
    """A coordinate's share alone: each collective returns the real one's
    shape from the local piece, and reports the reference's wire bytes a
    device over the 4-way model axis, forward and (its dual) backward."""
    mc = _grid_ctx(coord=(1, 2))
    x = torch.randn(shape, requires_grad=kind != "pmax")
    want_shape = {"psum": shape, "pmax": shape, "all_gather": (3, 32, 4),
                  "reduce_scatter": (3, 2), "all_to_all": (12, 2)}[kind]
    counter = _Counter()
    with counter:
        fn = {"psum": lambda v: tcol.psum(v, "model", mc),
              "pmax": lambda v: tcol.pmax(v, "model", mc),
              "all_gather": lambda v: tcol.all_gather(v, "model", mc, 1),
              "reduce_scatter": lambda v: tcol.reduce_scatter(v, "model", mc, 1),
              "all_to_all": lambda v: tcol.all_to_all(v, "model", mc, 1, 0)}[kind]
        (out,) = fn([x])
        assert tuple(out.shape) == want_shape
        if kind != "pmax":
            out.sum().backward()
            assert x.grad.shape == x.shape
    kinds = {"psum": "all-reduce", "pmax": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}
    assert counter.seen[0] == (kinds[kind], pytest.approx(wire), ("model",), 4)
    assert len(counter.seen) == (1 if kind == "pmax" else 2)
    if kind == "all_gather":  # its backward is a reduce-scatter of the gathered gradient
        assert counter.seen[1][:2] == ("reduce-scatter", pytest.approx(96 * 4 * 4 * 3 / 4))
    if kind == "psum":
        assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()


def test_a_collective_over_a_size_one_axis_is_the_identity():
    mc = _grid_ctx((1, 4), coord=(0, 1))
    counter = _Counter()
    x = torch.randn(2, 3)
    with counter:
        assert tcol.psum([x], "data", mc)[0] is x
    assert counter.seen == []


def test_sync_grads_all_reduces_the_replicated_axes():
    """A coordinate's gradient pieces: a norm scale (replicated) is
    all-reduced over every axis, a model-split FSDP weight over none."""
    mc = _grid_ctx(coord=(0, 0))
    specs = {"ln": ts.P(None), "w": ts.P("data", "model")}
    counter = _Counter()
    with counter:
        ts.sync_grads({"ln": torch.ones(8), "w": torch.ones(4, 2)}, specs, mc)
    assert [(k, ax) for k, _, ax, _ in counter.seen] == [("all-reduce", ("data", "model"))]


def test_unshard_inverts_shard():
    _, tcfg = cfgs("gemma2-27b")
    _, trules = contexts((2, 4))
    mc = ts.make_mesh_context(trules)
    tp = tt.init_params(torch.Generator().manual_seed(0), tcfg, mc, device="cpu")
    specs = ts.param_specs(tp, trules)
    pieces = [ts.shard(tp, specs, trules.mesh, c) for c in mc.coords]
    back = ts.unshard(pieces, specs, trules.mesh, mc.coords)
    for a, b in zip(to._leaves(back), to._leaves(tp)):
        assert torch.equal(a, b)
