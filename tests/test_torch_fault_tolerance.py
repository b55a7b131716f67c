"""The port's fault tolerance and checkpoint format against the reference.

Mirrors tests/test_fault_tolerance.py (straggler detection and warm-up,
the power-of-two elastic shrink, the periodic checkpoint manager, the
autoscaler policy against a fake server) and tests/test_checkpoint.py
(round trip, pruning, async save, invisible tmp dirs, corruption) on
`repro_torch.distributed.fault_tolerance` and
`repro_torch.training.checkpoint`; then checkpoints cross the two
packages both ways, float32, int32, bool and bfloat16 leaves byte-equal,
under the reference's leaf names.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.serve_loop import ServerState as JServerState
from repro.training import checkpoint as jckpt
from repro_torch.distributed.fault_tolerance import (
    CheckpointManager,
    CheckpointPolicy,
    ElasticMeshManager,
    StragglerMonitor,
)
from repro_torch.serving.autoscale import AutoscalePolicy, Autoscaler
from repro_torch.serving.serve_loop import ServerState
from repro_torch.training.checkpoint import latest_step, restore_checkpoint, save_checkpoint


def test_straggler_detection_and_budget():
    mon = StragglerMonitor(threshold=2.0, budget=3)
    for step in range(10):
        assert not mon.record(step, 1.0)
    assert not mon.record(10, 5.0)
    assert not mon.record(11, 5.0)
    assert mon.record(12, 5.0)
    assert len(mon.events) == 3


def test_straggler_ema_not_poisoned():
    mon = StragglerMonitor(threshold=2.0, budget=100)
    for step in range(5):
        mon.record(step, 1.0)
    ema_before = mon.ema
    mon.record(5, 50.0)
    assert mon.ema == ema_before


def test_straggler_warmup_discards_compile_step():
    mon = StragglerMonitor(threshold=2.0, budget=1)
    assert not mon.record(0, 100.0)
    assert not mon.record(1, 1.0)
    assert mon.ema == 1.0
    assert mon.record(2, 3.0)
    assert len(mon.events) == 1 and mon.events[0].duration == 3.0


def test_straggler_warmup_knob_and_timed():
    mon = StragglerMonitor(threshold=2.0, budget=1, warmup=0)
    mon.record(0, 4.0)
    assert mon.ema == 4.0
    mon = StragglerMonitor(warmup=3)
    for step in range(3):
        mon.record(step, 99.0)
    assert mon.ema is None
    mon.record(3, 1.0)
    assert mon.ema == 1.0
    with pytest.raises(ValueError, match="warmup"):
        StragglerMonitor(warmup=-1)
    mon = StragglerMonitor(warmup=0)
    with mon.timed(0) as t:
        assert t.step == 0
    assert mon.ema is not None and mon.ema >= 0.0


def test_elastic_shrink_power_of_two():
    made = []
    mgr = ElasticMeshManager(lambda n: made.append(n) or n, 16)
    mgr.shrink(1)
    assert mgr.data_size == 8
    mgr.shrink(3)
    assert mgr.data_size == 4
    mgr.shrink(3)
    assert mgr.data_size == 1
    with pytest.raises(RuntimeError):
        mgr.shrink(1)
    assert made == [8, 4, 1]


def test_checkpoint_manager_periodic_skips_step_zero_and_rotates(tmp_path):
    mgr = CheckpointManager(CheckpointPolicy(str(tmp_path), every_steps=10, keep=2,
                                             async_save=False))
    mgr.maybe_save(0, {"w": torch.zeros(2)})
    assert latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        mgr.restore_latest({"w": torch.zeros(2)})
    for step in range(1, 31):
        mgr.maybe_save(step, {"w": torch.full((2,), float(step))})
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000000020", "step_000000030"]
    restored, step = mgr.restore_latest({"w": torch.zeros(2)})
    assert step == 30 and float(restored["w"][0]) == 30.0


def test_checkpoint_manager_async(tmp_path):
    mgr = CheckpointManager(CheckpointPolicy(str(tmp_path), every_steps=5))
    for step in range(1, 11):
        mgr.maybe_save(step, {"w": torch.arange(3) + step})
    restored, step = mgr.restore_latest({"w": torch.zeros(3, dtype=torch.int64)})
    assert step == 10 and restored["w"].tolist() == [10, 11, 12]


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 16), generator=g),
                   "b": torch.randn(16, generator=g).to(torch.bfloat16)},
        "opt": {"m": [torch.ones(3), torch.arange(4.0)]},
        "mask": torch.rand(5, generator=g) < 0.5,
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _assert_trees_equal(a, b):
    for (na, x), (nb, y) in zip(_names(a), _names(b), strict=True):
        assert na == nb and x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _names(tree):
    from repro_torch.training.checkpoint import _flatten_with_names

    return _flatten_with_names(tree)


def test_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 100, tree)
    restored, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 100
    _assert_trees_equal(restored, tree)
    assert list(restored) == list(tree)  # the template's key order


def test_latest_pruning_async_and_tmp_dirs(tmp_path):
    for s in [10, 20, 30, 40]:
        save_checkpoint(str(tmp_path), s, _tree(), keep=2)
    assert latest_step(str(tmp_path)) == 40
    assert sorted(os.listdir(tmp_path)) == ["step_000000030", "step_000000040"]
    os.makedirs(tmp_path / "step_000000099.tmp")
    assert latest_step(str(tmp_path)) == 40
    t = save_checkpoint(str(tmp_path), 50, _tree(1), async_save=True, keep=5)
    t.join()
    restored, step = restore_checkpoint(str(tmp_path), _tree())
    assert step == 50
    _assert_trees_equal(restored, _tree(1))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope"), _tree())


def test_corruption_and_shape_mismatch_detected(tmp_path):
    save_checkpoint(str(tmp_path), 3, _tree())
    target = tmp_path / "step_000000003" / "leaf_00000.npy"
    arr = np.load(target).copy()
    arr.flat[0] += 1
    np.save(target, arr)
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(str(tmp_path), _tree())
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), {"w": torch.zeros(1)}, verify=False)


def _server_states():
    """The same serving state in both packages: a ΔGRU layer dict, a
    dense layer, the carry, scores and a detector state, in float32,
    int32 and bool; plus a bfloat16 leaf."""
    rng = np.random.default_rng(3)
    n = 6
    gru = ({"h": rng.standard_normal((n, 4)).astype(np.float32),
            "acc_x": rng.integers(-2**20, 2**20, (n, 12)).astype(np.int32),
            "total": rng.integers(0, 99, (n,)).astype(np.int32)},
           rng.integers(-2**15, 2**15, (n, 4)).astype(np.int32))
    carry = {"s1": rng.standard_normal((n, 3)).astype(np.float32),
             "s2": rng.standard_normal((n, 3)).astype(np.float32)}
    scores = rng.random((n, 12)).astype(np.float32)
    det = {"awake": rng.random(n) < 0.5, "hang": rng.integers(0, 3, n).astype(np.int32)}
    bf16 = rng.standard_normal(7).astype(np.float32)
    port = {"server": ServerState(
        gru=({k: torch.from_numpy(v) for k, v in gru[0].items()}, torch.from_numpy(gru[1])),
        carry={k: torch.from_numpy(v) for k, v in carry.items()},
        scores=torch.from_numpy(scores),
        det={k: torch.from_numpy(v) for k, v in det.items()}),
        "emb": torch.from_numpy(bf16).to(torch.bfloat16)}
    ref = {"server": JServerState(
        gru=({k: jnp.asarray(v) for k, v in gru[0].items()}, jnp.asarray(gru[1])),
        carry={k: jnp.asarray(v) for k, v in carry.items()},
        scores=jnp.asarray(scores),
        det={k: jnp.asarray(v) for k, v in det.items()}),
        "emb": jnp.asarray(bf16).astype(jnp.bfloat16)}
    return port, ref


def _byte_pairs(port_tree, ref_tree):
    ref = jax.tree_util.tree_leaves(ref_tree)
    port = [leaf for _, leaf in _names(port_tree)]
    assert len(ref) == len(port)
    for p, r in zip(port, ref):
        r = np.asarray(r)
        pb = p.view(torch.int16).numpy().tobytes() if p.dtype == torch.bfloat16 else p.numpy().tobytes()
        yield p, r, pb, r.tobytes()


def test_checkpoints_cross_the_two_packages(tmp_path):
    port, ref = _server_states()
    names = [n for n, _ in _names(port)]
    assert names == [n for n, _ in jckpt._flatten_with_names(ref)]
    assert "server/.gru/0/acc_x" in names and "server/.det/awake" in names
    # the reference writes, the port restores
    jckpt.save_checkpoint(str(tmp_path / "ref"), 7, ref)
    got, step = restore_checkpoint(str(tmp_path / "ref"), port)
    assert step == 7 and isinstance(got["server"], ServerState)
    for p, r, pb, rb in _byte_pairs(got, ref):
        assert str(p.dtype).removeprefix("torch.") == str(r.dtype) and pb == rb
    # the port writes, the reference restores
    save_checkpoint(str(tmp_path / "port"), 9, port)
    back, step = jckpt.restore_checkpoint(str(tmp_path / "port"), ref)
    assert step == 9
    for p, r, pb, rb in _byte_pairs(port, back):
        assert str(p.dtype).removeprefix("torch.") == str(r.dtype) and pb == rb
    manifest = json.loads((tmp_path / "port" / "step_000000009" / "manifest.json").read_text())
    assert {e["dtype"] for e in manifest["leaves"]} == {"float32", "int32", "bool", "bfloat16"}
    assert [e["name"] for e in manifest["leaves"]] == names


class _FakeServer:
    """The surface `Autoscaler` drives: occupancy inputs and a recording
    `resize`."""

    def __init__(self, max_streams=16, n_devices=4, n_open=0):
        self.max_streams = max_streams
        self.n_devices = n_devices
        self.active = {sid: sid for sid in range(n_open)}
        self.resizes = []

    def resize(self, n):
        self.resizes.append(n)
        self.max_streams = n


def _policy(**kw):
    base = dict(min_streams=4, max_streams=64, grow_at=0.85, shrink_at=0.30,
                hysteresis_ticks=3, cooldown_ticks=0, factor=2)
    base.update(kw)
    return AutoscalePolicy(**base)


def test_autoscaler_grows_on_sustained_occupancy_and_rejection():
    srv = _FakeServer(max_streams=16, n_open=15)
    auto = Autoscaler(srv, _policy())
    assert auto.observe() is None
    assert auto.observe() is None
    assert auto.observe() == "grow"
    assert srv.resizes == [32]
    srv = _FakeServer(max_streams=16, n_open=8)
    auto = Autoscaler(srv, _policy())
    auto.note_rejection()
    assert auto.observe() == "grow"
    assert srv.resizes == [32]
    srv = _FakeServer(max_streams=16, n_open=8)
    auto = Autoscaler(srv, _policy())
    assert all(auto.observe() is None for _ in range(20))
    assert srv.resizes == []


def test_autoscaler_shrinks_only_when_slo_healthy():
    srv = _FakeServer(max_streams=32, n_open=4)
    auto = Autoscaler(srv, _policy(), monitor=StragglerMonitor(budget=100, warmup=0))
    for _ in range(2):
        assert auto.observe(1.0) is None
    assert auto.observe(1.0) == "shrink"
    assert srv.resizes == [16]
    srv2 = _FakeServer(max_streams=32, n_open=4)
    auto2 = Autoscaler(srv2, _policy(), monitor=StragglerMonitor(budget=100, warmup=0))
    auto2.observe(1.0)
    for _ in range(5):
        assert auto2.observe(10.0) is None
    assert srv2.resizes == []
    acts = [auto2.observe(1.0) for _ in range(3)]
    assert "shrink" in acts and srv2.resizes == [16]


def test_autoscaler_shrink_clamps_cooldown_and_caps():
    srv = _FakeServer(max_streams=16, n_devices=4, n_open=9)
    auto = Autoscaler(srv, _policy(shrink_at=0.60, grow_at=0.85))
    for _ in range(3):
        auto.observe()
    assert srv.resizes == [12]
    srv = _FakeServer(max_streams=16, n_open=16)
    auto = Autoscaler(srv, _policy(cooldown_ticks=5, max_streams=32))
    acts = [auto.observe() for _ in range(12)]
    assert acts.count("grow") == 1
    srv.active = {sid: sid for sid in range(32)}
    assert all(auto.observe() is None for _ in range(10))
    assert srv.resizes == [32]
    assert auto.events and auto.events[0]["action"] == "grow"
