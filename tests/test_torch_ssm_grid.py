"""The port's sharded rwkv6 and zamba2 steps (`repro_torch.models.rwkv6` /
`zamba2` under a `MeshContext` over a device grid of the CPU) against the
reference's `build_train_step(cfg, rules)`, `forward`, `prefill` and
`decode_step`, jitted on Auto meshes of the same shapes over the 8 CPU
devices `tests/conftest.py` provides, in float32.

Reduced rwkv6-7b (4 heads of 16: one a model coordinate at model 4) on
(2, 4), (1, 4) and (2, 2) grids (the `check_*` functions, which
tests/test_torch_ssm_grid_zamba2.py runs for reduced zamba2-7b): every
coordinate's parameter and cache pieces shaped as
``NamedSharding.shard_shape``, the forward, the gradients and two AdamW
steps; `check_serve`, a prefill into caches laid out by `cache_specs`
followed by two decode steps, runs for both in
tests/test_torch_ssm_grid_serve.py.

The reduced models amplify rounding (R7; tests/test_torch_zamba2.py), so
no float32 run of either is held to 1e-6 of another: at this draw the
reference's own float32 logits lie 4.5e-6 (rwkv6) and 1.2e-4 (zamba2) of
max |logit| from a float64 run of the port, a gradient leaf up to 1.3e-5
and 9.7e-4, and its grid's logits 2.5e-6 from its own one-device
program's (rwkv6, (1, 4)). So each result is held twice: in float32 to
the reference within the measured bounds of `REF_TOL`, and in float64 to
the port's one-device route within `F64_TOL`, where rounding cannot hide a
fault of the layout. The second AdamW step's grad_norm is held only in
float64: AdamW's first update is lr * sign(g), and the signs of the
gradients near zero scatter the float32 runs of zamba2 by ~25 % around
the float64 truth (the reference 76.16, the port 59.49, the truth 57.69
at (2, 4)).

Then rwkv6's traps of the layout, one test each: the replicated
per-channel leaves cut to a coordinate's heads, and the channel mix (its
product reduce-scattered onto the gate's columns and the gated product
all-gathered); zamba2's are in tests/test_torch_ssm_grid_zamba2.py.
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

from repro import configs as jconfigs
from repro.distributed import sharding as js
from repro.models import rwkv6 as jr
from repro.models import zamba2 as jz
from repro.training import optimizer as jo
from repro.training import train_loop as jtl
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.distributed import collectives as tcol
from repro_torch.distributed import sharding as ts
from repro_torch.models import mamba2 as tm2
from repro_torch.models import rwkv6 as tr
from repro_torch.models import zamba2 as tz
from repro_torch.training import optimizer as to
from repro_torch.training import train_loop as ttl
from test_torch_dense_grid import _Counter, rel

AXES = ("data", "model")
GRIDS = [(2, 4), (1, 4), (2, 2)]
ARCHS = {"rwkv6-7b": (jr, tr), "zamba2-7b": (jz, tz)}
CASES = [("rwkv6-7b", g) for g in GRIDS]
B, S = 4, 16
MAX_LEN = S + 8
LR = 3e-3
# float32, max |difference| / max |reference| (the loss and grad_norm of
# the first step and the second step's loss: |relative difference|):
# measured over the three grids, rwkv6 / zamba2: logits 4.9e-6 / 1.6e-4,
# a gradient leaf 2.3e-5 / 1.4e-3, the steps 5.5e-6 / 3.8e-4, the
# prefill's and decodes' logits and caches 3.0e-6 / 1.7e-5
REF_TOL = {"rwkv6-7b": {"fwd": 1e-5, "grad": 5e-5, "step": 2e-5, "serve": 1e-5},
           "zamba2-7b": {"fwd": 5e-4, "grad": 5e-3, "step": 1e-3, "serve": 5e-5}}
# float64, the grid against the one-device route: rounding alone
F64_TOL = 1e-12


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


def draw_params(arch, jcfg, seed=3):
    """The reference's parameter tree drawn with numpy, float32: every leaf
    N(0, 0.1), so that each per-channel and per-head leaf differs from
    channel to channel and from head to head."""
    jb = ARCHS[arch][0]
    shapes = jax.eval_shape(lambda k: jb.init_params(k, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
                        shapes)


def batches(tcfg, n=2, seed=0):
    return list(ttl.lm_batches(tcfg.vocab, n, batch=B, seq=S, seed=seed))


def _tokens(tcfg, n, seed):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, tcfg.vocab, (B, n), generator=g, dtype=torch.int32)}


def rel64(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def as64(tcfg, tp):
    return dataclasses.replace(tcfg, dtype="float64"), to.tree_map(lambda t: t.double(), tp)


def jb_(b):
    return {k: jnp.asarray(v.numpy()) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def reference(arch, grid):
    """The reference's logits and gradients on the first batch and loss /
    grad_norm over two AdamW steps, in one program jitted on the grid's
    Auto mesh (inputs replicated)."""
    jb = ARCHS[arch][0]
    jcfg, tcfg = cfgs(arch)
    jrules, _ = contexts(grid)
    jmc = js.make_mesh_context(jrules)
    p = draw_params(arch, jcfg)
    bs = [jb_(b) for b in batches(tcfg)]
    mesh = jrules.mesh
    step = jtl.build_train_step(jcfg, jrules, jtl.TrainConfig(jo.AdamWConfig(lr=LR)))

    def run(p, bs):
        logits, _ = jb.forward(p, bs[0], jcfg, jmc)
        grads = jax.grad(lambda q: jb.loss_fn(q, bs[0], jcfg, jmc))(p)
        opt = jo.init_opt_state(p, jo.AdamWConfig(lr=LR))
        metrics = []
        for b in bs:
            p, opt, met = step(p, opt, b)
            metrics.append((met["loss"], met["grad_norm"]))
        return logits, grads, metrics

    with mesh:
        jp = jax.device_put(jax.tree.map(jnp.asarray, p), NamedSharding(mesh, PartitionSpec()))
        logits, grads, metrics = jax.jit(run)(jp, bs)
    return {"params": p, "logits": np.asarray(logits), "grads": jax.tree.map(np.asarray, grads),
            "metrics": [(float(a), float(b)) for a, b in metrics]}


@functools.lru_cache(maxsize=None)
def reference_serve(arch, grid):
    """The reference's prefill (its cache laid out by `cache_specs`) and two
    decode steps, jitted on the grid's Auto mesh."""
    jb = ARCHS[arch][0]
    jcfg, tcfg = cfgs(arch)
    jrules, _ = contexts(grid)
    jmc = js.make_mesh_context(jrules)
    p = draw_params(arch, jcfg)
    mesh = jrules.mesh
    rep = NamedSharding(mesh, PartitionSpec())
    prompt = _tokens(tcfg, S, 1)
    steps = [_tokens(tcfg, 1, 2 + i) for i in range(2)]
    cache_shape = jax.eval_shape(lambda: jb.init_cache(jcfg, B, MAX_LEN, jmc))
    cshard = js.named(js.cache_specs(cache_shape, jrules, B), mesh)
    with mesh:
        jp = jax.device_put(jax.tree.map(jnp.asarray, p), rep)
        lg, cache = jax.jit(lambda q, b: jb.prefill(q, b, jcfg, jmc, max_len=MAX_LEN),
                            out_shardings=(rep, cshard))(jp, jb_(prompt))
        serve = [np.asarray(lg)]
        prefill_cache = jax.tree.map(np.asarray, cache)
        decode = jax.jit(lambda q, c, n, b: jb.decode_step(q, c, n, b, jcfg, jmc),
                         in_shardings=(rep, cshard, None, rep), out_shardings=(rep, cshard))
        for i, b in enumerate(steps):
            lg, cache = decode(jp, cache, jnp.int32(S + i), jb_(b))
            serve.append(np.asarray(lg))
    return {"params": p, "prompt": prompt, "steps": steps, "serve": serve,
            "prefill_cache": prefill_cache, "cache": jax.tree.map(np.asarray, cache)}


def check_pieces(case):
    """Each coordinate's piece of every parameter and cache leaf
    (`sharding.shard`, views) has ``NamedSharding(mesh, spec).shard_shape``
    of the reference's spec."""
    arch, grid = case
    jb, tb = ARCHS[arch]
    jcfg, tcfg = cfgs(arch)
    jrules, trules = contexts(grid)
    mesh = trules.mesh
    for kind in ("params", "cache"):
        if kind == "params":
            shapes = jax.eval_shape(lambda k: jb.init_params(k, jcfg), jax.random.PRNGKey(0))
            jspecs = js.param_specs(shapes, jrules)
            tree = tb.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
            tspecs = ts.param_specs(tree, trules)
        else:
            shapes = jax.eval_shape(lambda: jb.init_cache(jcfg, B, MAX_LEN))
            jspecs = js.cache_specs(shapes, jrules, B)
            tree = tb.init_cache(tcfg, B, MAX_LEN, device="cpu")
            tspecs = ts.cache_specs(tree, trules, B)
        want = [tuple(NamedSharding(jrules.mesh, sp).shard_shape(s.shape)) for s, sp in
                zip(jax.tree.leaves(shapes), jax.tree.leaves(
                    jspecs, is_leaf=lambda x: isinstance(x, PartitionSpec)))]
        local = [tuple(t.shape) for t in to._leaves(ts.local_shapes(tree, tspecs, mesh))]
        assert local == want, kind
        for c in ts.make_mesh_context(trules).coords:
            pieces = ts.shard(tree, tspecs, mesh, c)
            assert [tuple(t.shape) for t in to._leaves(pieces)] == local
            for piece, whole in zip(to._leaves(pieces), to._leaves(tree)):
                assert piece.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr()


def _port(arch, grid, ref=reference):
    ref = ref(arch, grid)
    _, tcfg = cfgs(arch)
    _, trules = contexts(grid)
    return ref, ARCHS[arch][1], tcfg, trules, convert.lm_params_from_numpy(ref["params"], "cpu")


def check_forward(case):
    ref, tb, tcfg, trules, tp = _port(*case)
    mc = ts.make_mesh_context(trules)
    logits, _ = tb.forward(tp, batches(tcfg)[0], tcfg, mc)
    assert logits.shape == ref["logits"].shape
    assert rel(logits.numpy(), ref["logits"]) <= REF_TOL[case[0]]["fwd"]
    c64, p64 = as64(tcfg, tp)
    one, _ = tb.forward(p64, batches(tcfg)[0], c64)
    grid, _ = tb.forward(p64, batches(tcfg)[0], c64, mc)
    assert rel64(grid, one) <= F64_TOL


def check_gradients(case):
    """Every leaf's gradient through the grid's collectives: in float32
    against ``jax.grad`` of the reference's sharded loss, in float64
    against the port's one-device gradient."""
    ref, tb, tcfg, trules, tp = _port(*case)
    mc = ts.make_mesh_context(trules)
    b = batches(tcfg)[0]
    _, grads = ttl.value_and_grad(lambda q, b_: tb.loss_fn(q, b_, tcfg, mc), tp, b)
    got = jax.tree.map(lambda t: t.numpy(), grads)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(ref["grads"])):
        assert g.shape == w.shape, path
        assert rel(g, w) <= REF_TOL[case[0]]["grad"], path
    c64, p64 = as64(tcfg, tp)
    _, one = ttl.value_and_grad(lambda q, b_: tb.loss_fn(q, b_, c64), p64, b)
    _, grid = ttl.value_and_grad(lambda q, b_: tb.loss_fn(q, b_, c64, mc), p64, b)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(grid), jax.tree.leaves(one)):
        assert rel64(g, w) <= F64_TOL, path


def check_steps(case):
    """The float32 grid's first step's loss and grad_norm and its second
    step's loss against the reference's; in float64 both steps' against
    the one-device step's."""
    ref, _, tcfg, trules, tp = _port(*case)
    tol = REF_TOL[case[0]]["step"]

    def run(params, cfg, rules):
        opt = to.init_opt_state(params, to.AdamWConfig(lr=LR))
        step = ttl.build_train_step(cfg, ttl.TrainConfig(to.AdamWConfig(lr=LR)), "cpu", rules)
        out = []
        for b in batches(tcfg):
            params, opt, met = step(params, opt, b)
            out.append((float(met["loss"]), float(met["grad_norm"])))
        return out

    (l1, g1), (l2, _) = run(tp, tcfg, trules)
    (w1, h1), (w2, _) = ref["metrics"]
    assert abs(l1 / w1 - 1) <= tol and abs(g1 / h1 - 1) <= tol and abs(l2 / w2 - 1) <= tol
    c64, p64 = as64(tcfg, tp)
    for got, want in zip(run(p64, c64, trules), run(p64, c64, None)):
        assert rel64(got, want) <= F64_TOL


def _caches_close(got, want, tol, close=rel):
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda t: t.numpy(), got)), jax.tree.leaves(want)):
        assert g.shape == w.shape, path
        assert close(g, w) <= tol, path


def _serve(tb, tp, cfg, ref, mc):
    """The prefill's logits and cache, then each decode step's."""
    logits, cache = tb.prefill(tp, ref["prompt"], cfg, mc, max_len=MAX_LEN)
    out = [(logits, cache)]
    for i, b in enumerate(ref["steps"]):
        logits, cache = tb.decode_step(tp, cache, torch.tensor(S + i), b, cfg, mc)
        out.append((logits, cache))
    return out


def check_serve(case):
    """The prefill's logits and caches (recurrent states with their heads or
    d_inner over "model", the shared blocks' k / v with their sequence
    over it), then two decode steps from the grid's own prefill."""
    ref, tb, tcfg, trules, tp = _port(*case, reference_serve)
    mc = ts.make_mesh_context(trules)
    tol = REF_TOL[case[0]]["serve"]
    runs = _serve(tb, tp, tcfg, ref, mc)
    for (logits, _), want in zip(runs, ref["serve"]):
        assert rel(logits.numpy(), want) <= tol
    _caches_close(runs[0][1], ref["prefill_cache"], tol)
    _caches_close(runs[-1][1], ref["cache"], tol)
    c64, p64 = as64(tcfg, tp)
    for (lg, c), (lw, cw) in zip(_serve(tb, p64, c64, ref, mc), _serve(tb, p64, c64, ref, None)):
        assert rel64(lg, lw) <= F64_TOL
        _caches_close(c, jax.tree.map(lambda t: t.numpy(), cw), F64_TOL, rel64)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_pieces_are_shard_shapes(case):
    check_pieces(case)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_forward_follows_the_references(case):
    check_forward(case)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_gradients_follow_the_references(case):
    check_gradients(case)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_two_adamw_steps_follow_the_references(case):
    check_steps(case)


# ---------------------------------------------------------------------------
# the traps of the layout
# ---------------------------------------------------------------------------

def _whole_and_pieces(arch, grid=(1, 4)):
    """A reduced model's first layer whole, and each coordinate's pieces of
    it with its model index and specs."""
    jcfg, tcfg = cfgs(arch)
    _, trules = contexts(grid)
    tp = convert.lm_params_from_numpy(draw_params(arch, jcfg), "cpu")
    mc = ts.make_mesh_context(trules)
    stack = tp["layers"] if arch == "rwkv6-7b" else tp["mamba"]
    specs = ts.param_specs(stack, trules)
    whole = {k: t[0] for k, t in stack.items()}
    lspecs = {k: ts.P(*sp[1:]) for k, sp in specs.items()}
    pieces = [ts.shard(whole, lspecs, trules.mesh, c) for c in mc.coords]
    return tcfg, mc, whole, lspecs, pieces


def test_rwkv6_per_channel_leaves_are_cut_to_the_local_heads():
    """On each coordinate the time mix's r, k, v, gate, log-decay and bonus
    are the whole layer's at the coordinate's heads: the replicated
    decay_base, decay_w2's columns, bonus_u and ln_x are cut to them."""
    tcfg, mc, whole, lspecs, pieces = _whole_and_pieces("rwkv6-7b")
    x = torch.randn((B, S, tcfg.d_model), generator=torch.Generator().manual_seed(5))
    full = tr._time_mix_pre(whole, x, tcfg)
    y = torch.randn(full[0].shape, generator=torch.Generator().manual_seed(6))
    post = tr._time_mix_post(whole, y, full[3], tcfg)
    hd = tcfg.resolved_head_dim
    for c, p in zip(mc.coords, pieces):
        lo, n = tr._channels(tcfg, lspecs, mc, c)
        assert n == tcfg.d_model // mc.model_size
        local = tr._time_mix_pre(p, x, tcfg, channels=(lo, n))
        heads = slice(lo // hd, (lo + n) // hd)
        for got, want in zip(local[:6], full[:6]):
            if want.dim() == 3:  # the gate (B, S, d)
                want = want[..., lo:lo + n]
            elif want.dim() == 2:  # the bonus (H, P)
                want = want[heads]
            else:
                want = want[:, :, heads]
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        # ln_x cut to the heads; w_o's rows make a partial sum of the output
        part = tr._time_mix_post(p, y[:, :, heads], full[3][..., lo:lo + n], tcfg, (lo, n))
        assert part.shape == post.shape
    whole_ = tr._time_mix_post(whole, y, full[3], tcfg)
    parts = [tr._time_mix_post(p, y[:, :, lo // hd:(lo + n) // hd], full[3][..., lo:lo + n],
                               tcfg, (lo, n))
             for c, p in zip(mc.coords, pieces) if c[0] == 0
             for lo, n in [tr._channels(tcfg, lspecs, mc, c)]]
    torch.testing.assert_close(sum(parts), whole_, rtol=1e-5, atol=1e-6)


def test_rwkv6_channel_mix_reduce_scatters_its_product():
    """The grid layer equals the whole layer, and its collectives over
    "model" are w_o's all-reduce, then the channel mix's reduce-scatter of
    its product onto cm_w_r's columns and the all-gather of the gated
    product: each a half of an all-reduce's wire bytes, where gathering
    the gate instead would add an all-gather to a whole all-reduce."""
    tcfg, mc, whole, lspecs, pieces = _whole_and_pieces("rwkv6-7b")
    x = torch.randn((B, S, tcfg.d_model), generator=torch.Generator().manual_seed(7))
    want, _ = tr.rwkv6_block_apply(whole, x, tcfg)
    counter = _Counter()
    with counter:
        got, _ = tr._grid_layer(pieces, lspecs, [x] * len(mc.coords), tcfg, mc)
    for g in got:
        torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-6)
    on_model = [(k, w) for k, w, axes, _ in counter.seen if axes == ("model",)]
    kinds = [k for k, _ in on_model]
    groups = len(mc.coords) // mc.model_size
    assert kinds == ["all-reduce"] * mc.model_size * groups + \
        ["reduce-scatter"] * mc.model_size * groups + ["all-gather"] * mc.model_size * groups
    act = B * S * tcfg.d_model * 4  # one (B, S, d) float32 activation
    m = mc.model_size
    wire = {k: w for k, w in on_model}
    assert wire["all-reduce"] == pytest.approx(2 * act * (m - 1) / m)
    assert wire["reduce-scatter"] == pytest.approx(act * (m - 1) / m)
    assert wire["all-gather"] == pytest.approx(act * (m - 1) / m)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_the_one_device_steps_run_no_grid_code(arch, monkeypatch):
    """Without rules the train step, the prefill and the decode are the
    one-device ones: no share is built and no collective runs (their
    numbers are held to the reference by tests/test_torch_lm.py and
    tests/test_torch_zamba2.py)."""
    def boom(*a, **k):
        raise AssertionError("grid code on the one-device path")

    for name in ("_grid_forward", "_grid_loss", "_grid_prefill", "_grid_decode"):
        monkeypatch.setattr(tr, name, boom)
        monkeypatch.setattr(tz, name, boom)
    monkeypatch.setattr(tm2, "mamba2_block_grid", boom)
    monkeypatch.setattr(tcol, "_collective", boom)
    monkeypatch.setattr(tcol, "_report", boom)
    _, tcfg = cfgs(arch)
    tb = ARCHS[arch][1]
    tp = tb.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    step = ttl.build_train_step(tcfg, ttl.TrainConfig(), "cpu")
    _, _, met = step(tp, to.init_opt_state(tp, to.AdamWConfig()), batches(tcfg)[0])
    assert np.isfinite(float(met["loss"]))
    logits, cache = tb.prefill(tp, _tokens(tcfg, S, 1), tcfg, max_len=MAX_LEN)
    logits, _ = tb.decode_step(tp, cache, torch.tensor(S), _tokens(tcfg, 1, 2), tcfg)
    assert np.isfinite(logits.numpy()).all()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_command_line_trains_on_a_grid(arch, capsys, monkeypatch):
    """``train_loop --mesh 2x2 --arch rwkv6-7b|zamba2-7b`` runs the sharded
    step (its collectives run), not the one-device step on the first
    device."""
    seen = []
    collective = tcol._collective
    monkeypatch.setattr(tcol, "_collective",
                        lambda kind, *a, **k: seen.append(kind) or collective(kind, *a, **k))
    argv = ["--arch", arch, "--steps", "2", "--mesh", "2x2", "--device", "cpu"]
    assert ttl.main(argv) == 0
    assert "smoke train OK" in capsys.readouterr().out
    assert {"all-reduce", "all-gather"} <= set(seen)
