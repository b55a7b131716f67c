"""The port's LM sharding rules (`repro_torch.distributed.sharding`) and
production meshes (`repro_torch.launch.mesh`) against the reference's.

`param_specs`, `batch_specs` and `cache_specs` equal leaf for leaf,
leading None of a scanned stack included: for every config at production
size on the (16, 16) and (2, 16, 16) meshes (the reference's `make_rules`
on a ``jax.sharding.AbstractMesh`` and ``jax.eval_shape``'d trees, the
port's on its abstract `Mesh` and its own trees traced on fake tensors),
and on a (2, 4) mesh for the reduced configs, int8 serving weights
included.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, PartitionSpec
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.distributed import sharding as js
from repro.launch import mesh as jmesh_lib
from repro.models import moe_quant as jq
from repro.models.registry import get_backbone as jbackbone
from repro_torch import configs as tconfigs
from repro_torch.configs import SHAPES
from repro_torch.distributed import sharding as ts
from repro_torch.launch import mesh as tmesh_lib
from repro_torch.models import moe_quant as tq
from repro_torch.models.registry import get_backbone as tbackbone

ARCHS = jconfigs.list_archs()
CACHE_SHAPE = SHAPES["decode_32k"]  # (128, 32768): batch divides every dp


def _flat(tree, leaf_type, prefix=""):
    """{path: tuple(spec)} of a specs tree (dicts by key, lists by index)."""
    if isinstance(tree, leaf_type):
        return {prefix: tuple(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"{prefix}: {type(tree)}")
    out = {}
    for k, v in items:
        out.update(_flat(v, leaf_type, f"{prefix}/{k}"))
    return out


def _assert_specs_equal(got, want):
    got, want = _flat(got, ts.P), _flat(want, PartitionSpec)
    assert sorted(got) == sorted(want)
    for path, spec in want.items():
        assert got[path] == spec, path


def _ref_trees(jcfg, jrules, quant=False):
    """The reference's (params, cache) shapes under its mesh context."""
    bb = jbackbone(jcfg)
    mc = js.make_mesh_context(jrules)
    params = jax.eval_shape(lambda k: bb.init_params(k, jcfg, mc), jax.random.PRNGKey(0))
    if quant:
        params = jq.quantize_expert_shapes(params)
    b, s = CACHE_SHAPE.global_batch, CACHE_SHAPE.seq_len
    cache = jax.eval_shape(lambda: bb.init_cache(jcfg, b, s, mc))
    return params, cache


def _port_trees(tcfg, trules, quant=False):
    """The port's (params, cache) trees on fake tensors (nothing allocated)."""
    bb = tbackbone(tcfg)
    mc = ts.make_mesh_context(trules)
    with FakeTensorMode():
        params = bb.init_params(torch.Generator().manual_seed(0), tcfg, mc, device="cpu")
        if quant:
            params = tq.quantize_expert_params(params)
        cache = bb.init_cache(tcfg, CACHE_SHAPE.global_batch, CACHE_SHAPE.seq_len, mc,
                              device="cpu")
    return params, cache


def _batches(cfg):
    """Train, prefill and decode batch shapes (leading dims 256, 32, 128,
    and a batch of 1 that replicates), as ``meta`` tensors and structs."""
    shapes = {"train": (256, 4096), "prefill": (32, 32), "decode": (128, 1), "long": (1, 1)}
    tree = {}
    for name, (b, s) in shapes.items():
        if cfg.frontend == "embedding":
            tree[name] = {"embeddings": (b, s, cfg.d_model), "labels": (b, s)}
        else:
            tree[name] = {"tokens": (b, s), "labels": (b, s)}
    tree["scalar"] = {"step": ()}
    meta = {k: {n: torch.empty(s, device="meta") for n, s in v.items()} for k, v in tree.items()}
    structs = {k: {n: jax.ShapeDtypeStruct(s, np.float32) for n, s in v.items()}
               for k, v in tree.items()}
    return meta, structs


def _check(jcfg, tcfg, jrules, trules, quant=False):
    jp, jc = _ref_trees(jcfg, jrules, quant)
    tp, tc = _port_trees(tcfg, trules, quant)
    _assert_specs_equal(ts.param_specs(tp, trules), js.param_specs(jp, jrules))
    b = CACHE_SHAPE.global_batch
    _assert_specs_equal(ts.cache_specs(tc, trules, b), js.cache_specs(jc, jrules, b))
    tb, jb = _batches(tcfg)
    _assert_specs_equal(ts.batch_specs(tb, trules), js.batch_specs(jb, jrules))
    return ts.param_specs(tp, trules)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_production_specs_equal_the_references(arch, multi_pod):
    """Every config at production size: the reference's `make_rules` on an
    Auto AbstractMesh of the pod shape, the port's on
    `make_production_mesh` (FSDP over "pod" too for the 1T MoE, as the
    dry run's cells shard it)."""
    over_pod = multi_pod and arch.startswith("kimi")
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    jm = AbstractMesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    jrules = jmesh_lib.make_rules(jm, fsdp_over_pod=over_pod)
    tm = tmesh_lib.make_production_mesh(multi_pod=multi_pod)
    assert tm.devices is None and dict(tm.shape) == dict(jm.shape)
    assert tm.size == tmesh_lib.mesh_device_count(multi_pod=multi_pod)
    trules = tmesh_lib.make_rules(tm, fsdp_over_pod=over_pod)
    assert (trules.dp_axes, trules.fsdp_axes) == (jrules.dp_axes, jrules.fsdp_axes)
    specs = _check(jconfigs.get_config(arch), tconfigs.get_config(arch), jrules, trules)
    if arch.startswith("kimi") and not multi_pod:
        # GQA's 8 kv heads do not divide 16-way TP: they replicate; the
        # shared expert under "moe" takes the expert rule on its layer stack
        assert specs["layers"]["slot0_moe"]["attn"]["wk"] == (None, "data", None, None)
        assert specs["dense_prefix"][0]["attn"]["wk"] == ("data", None, None)
        assert specs["layers"]["slot0_moe"]["moe"]["shared"]["w_up"] == (None, "data", None)
        assert specs["layers"]["slot0_moe"]["moe"]["w_up"] == (None, "model", "data", None)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_specs_on_a_2x4_mesh_equal_the_references(arch):
    """Reduced configs on a (2, 4) mesh (the reference's of the 8 CPU
    devices, the port's a grid of the CPU), FSDP on; the MoE configs with
    int8 serving weights: q takes the bank's rule, s drops its last
    entry."""
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    jrules = js.ShardingRules(mesh=jax.sharding.Mesh(devs, ("data", "model"),
                                                     axis_types=(AxisType.Auto,) * 2))
    trules = ts.ShardingRules(mesh=ts.Mesh((2, 4), ("data", "model"), "cpu"))
    jcfg, tcfg = jconfigs.get_config(arch).reduced(), tconfigs.get_config(arch).reduced()
    _check(jcfg, tcfg, jrules, trules)
    if tcfg.moe is not None:
        specs = _check(jcfg, tcfg, jrules, trules, quant=True)
        bank = specs["layers"]["slot0_moe"]["moe"]["w_up"]
        assert bank["q"] == (None, "model", "data", None)
        assert bank["s"] == (None, "model", "data", None)
        assert specs["layers"]["slot0_moe"]["moe"]["w_down"]["s"] == (None, "model", None, None)


def test_mesh_grids_and_fit():
    """A grid's devices row-major, one device filling it; `_fit` drops an
    entry that does not divide its dimension."""
    mesh = ts.Mesh((2, 3), ("data", "model"), ["cpu"] * 6)
    assert mesh.devices.shape == (2, 3) and mesh.device((1, 2)) == torch.device("cpu")
    assert list(mesh.devices.flat) == list(ts.Mesh((2, 3), ("data", "model"), "cpu").devices.flat)
    assert ts.Mesh((2, 3), ("data", "model")).device((0, 0)) is None
    with pytest.raises(ValueError, match="5 devices given, 6 wanted"):
        ts.Mesh((2, 3), ("data", "model"), ["cpu"] * 5)
    assert ts._fit(ts.P("data", "model"), (4, 4), mesh) == ("data", None)
    assert ts._fit(ts.P(("data", "model")), (12, 5), mesh) == (("data", "model"), None)
