"""The per-device account of the dry run on a mesh: a grid coordinate's
share of the port's step (`lower_train_step` / `lower_prefill` /
`lower_decode_step` with ``rules`` and ``coord``, traced on fake tensors,
the collectives in their lone form) against the reference's program for
the same (2, 4) Auto mesh of the 8 CPU devices, compiled and read by
`analyze_hlo` and ``memory_analysis``, at the reduced configs, batch 8 x
64 tokens.

Argument bytes are equal exactly (each leaf's
``NamedSharding.shard_shape``: parameters, AdamW moments, batch, cache).
FLOPs and wire bytes differ where the two programs partition differently;
the tolerances below are measured and their causes named:

- FLOPs, train: the port is above by 1.9-2.7 % for qwen3, gemma2 and
  kimi (XLA folds part of the attention backward and takes the sharded
  embedding lookup as a one-hot product), and by 8.7 % / 9.1 % for
  granite and musicgen, whose 4 heads padded to 32 put every real head
  on model coordinate 0: the port projects them there after gathering
  the activations, GSPMD runs some of that work on the padded layout.
- FLOPs, prefill: GSPMD runs the reference's prefill sequence-parallel
  (each device 16 of the 64 positions, every weight gathered whole), the
  port tensor-parallel, as its train step (heads and hidden over "model",
  a device's weights 1/4 of a layer's). The two do the same products but
  one: the port projects every kv head at every position on every model
  coordinate for the cache (which takes the sequence split), where the
  reference projects them once a position: +27.2 % (qwen3), +47.1 % (kimi),
  +10.2 % (zamba2's shared blocks); rwkv6, which keeps no kv cache, is
  0.7 % under. The port keeps tensor parallelism so that a device holds
  1/4 of a layer's weights, not the whole layer the sequence-parallel
  program gathers.
- FLOPs, decode (F13, repaired): each coordinate projects only its share
  of the new token's k / v, as the reference: its piece where the kv
  heads split over "model", else its slice of the kv heads' KV * D columns
  (half a head each at 2 kv heads on 4 coordinates), all-gathered before
  the qk-norm and the rotation: qwen3's decode equals the reference's
  FLOPs (it was +23.1 %), kimi's is +10.0 % (was +30.0 %), in its MoE layer
  (the weights-stationary experts' products and the router, whose
  contraction shapes the reference's compiled text does not show).
- FLOPs, rwkv6 / zamba2 train: the port is 0.4 % under the reference for
  rwkv6 (GSPMD computes the decay's and the channel mix's gate products
  on a layout of its own) and 2.7 % over for zamba2 (the shared blocks'
  attention as the transformer's, +1.9-2.7 %).
- Argument bytes: rwkv6's decode does not read the cache length, and
  XLA drops the unread argument from the reference's program; the port
  holds its 4 bytes (`UNREAD`).
- Wire bytes: XLA's CPU backend computes bf16 in float32, so the
  reference's activation collectives carry 4 bytes an element where the
  port's (and a TPU's) carry 2; and GSPMD all-reduces each product's
  partial input gradient apart (q, k, v; up, gate) where the port
  all-reduces once at each psum's backward. GSPMD's reshards
  (all-to-all, collective-permute) are not modelled; the port is held to
  a band of the reference's all-reduce + all-gather + reduce-scatter.

``python tests/test_torch_mesh_dryrun.py`` prints the table of both, and
beside it each cell's peak a device (F14, recorded, not held): the port's
traced peak of live bytes against the reference's ``memory_analysis``
(argument + temp + output bytes).
"""

import dataclasses
import os

if __name__ == "__main__":  # the table wants the suite's 8 host devices (tests/conftest.py)
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as js  # noqa: E402
from repro.launch.dryrun import train_batch_shape as jtrain_shape  # noqa: E402
from repro.launch.roofline import analyze_hlo  # noqa: E402
from repro.serving import serve_loop as jsl  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import sharding as ts  # noqa: E402
from repro_torch.launch.dryrun import train_batch_shape  # noqa: E402
from repro_torch.serving import serve_loop as tsl  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402

AXES = ("data", "model")
GRID = (2, 4)
S, B = 64, 8
CELLS = [(a, "train") for a in ("qwen3-4b", "gemma2-27b", "granite-moe-3b-a800m",
                                "kimi-k2-1t-a32b", "musicgen-medium")] + \
    [(a, k) for a in ("qwen3-4b", "kimi-k2-1t-a32b") for k in ("prefill", "decode")] + \
    [(a, k) for a in ("rwkv6-7b", "zamba2-7b") for k in ("train", "prefill", "decode")]
# the port's FLOPs over the reference's, less 1: measured +1.96 %, +1.89 %,
# +8.65 %, +2.73 %, +9.09 % (train), +27.2 % / +47.1 % (prefill of qwen3 /
# kimi), +0.00 % / +10.0 % (decode); rwkv6 -0.36 % / -0.74 % / +0.00 %,
# zamba2 +2.69 % / +10.18 % / +0.00 % (train / prefill / decode)
FLOPS_OVER = {
    ("qwen3-4b", "train"): 0.025, ("gemma2-27b", "train"): 0.025,
    ("granite-moe-3b-a800m", "train"): 0.10, ("kimi-k2-1t-a32b", "train"): 0.035,
    ("musicgen-medium", "train"): 0.10,
    ("qwen3-4b", "prefill"): 0.29, ("kimi-k2-1t-a32b", "prefill"): 0.49,
    ("qwen3-4b", "decode"): 0.005, ("kimi-k2-1t-a32b", "decode"): 0.11,
    ("rwkv6-7b", "train"): 0.005, ("rwkv6-7b", "prefill"): 0.005,
    ("rwkv6-7b", "decode"): 0.005, ("zamba2-7b", "train"): 0.035,
    ("zamba2-7b", "prefill"): 0.12, ("zamba2-7b", "decode"): 0.005,
}
# the port's FLOPs under the reference's, where they are
FLOPS_UNDER = {("rwkv6-7b", "train"): 0.005, ("rwkv6-7b", "prefill"): 0.01}
# argument bytes the port holds and the reference's program does not read
UNREAD = {("rwkv6-7b", "decode"): 4}
# the port's wire bytes over the reference's all-reduce + all-gather +
# reduce-scatter bytes, by kind for the transformer: measured 0.37-0.49
# (train), 0.43-0.44 (prefill), 0.69-0.73 (decode); for rwkv6 / zamba2
# 0.229 / 0.292 (train), 0.326 / 0.433 (prefill), 0.509 / 0.671 (decode):
# rwkv6's channel mix reduce-scatters and all-gathers where GSPMD
# all-reduces both products' partial sums
WIRE_BAND = {"train": (0.33, 0.55), "prefill": (0.38, 0.50), "decode": (0.60, 0.78),
             ("rwkv6-7b", "train"): (0.20, 0.26), ("rwkv6-7b", "prefill"): (0.29, 0.36),
             ("rwkv6-7b", "decode"): (0.46, 0.56), ("zamba2-7b", "train"): (0.26, 0.33)}
CORE = ("all-reduce", "all-gather", "reduce-scatter")


def _rules():
    devs = np.array(jax.devices()[:8]).reshape(GRID)
    jmesh = jax.sharding.Mesh(devs, AXES, axis_types=(AxisType.Auto,) * 2)
    return js.ShardingRules(mesh=jmesh), ts.ShardingRules(mesh=ts.Mesh(GRID, AXES))


def reference_account(jcfg, kind, peak=False):
    """(argument bytes, FLOPs, wire bytes by kind) a device of the
    reference's compiled program; with ``peak`` also its
    ``memory_analysis`` argument + temp + output bytes."""
    jrules, _ = _rules()
    spec = jconfigs.ShapeSpec("x", kind, S, B)
    if kind == "train":
        lowered = jtl.lower_train_step(jcfg, jrules, jtrain_shape(jcfg, spec))[0]
    elif kind == "prefill":
        lowered = jsl.lower_prefill(jcfg, jrules, spec)[0]
    else:
        lowered = jsl.lower_decode_step(jcfg, jrules, spec)[0]
    compiled = lowered.compile()
    a = analyze_hlo(compiled.as_text())
    mem = compiled.memory_analysis()
    out = (mem.argument_size_in_bytes, a.flops, dict(a.collective_breakdown))
    if peak:
        out += (mem.argument_size_in_bytes + mem.temp_size_in_bytes + mem.output_size_in_bytes,)
    return out


def port_account(tcfg, kind):
    """The `GraphAnalysis` of coordinate (0, 0)'s share of the port's step."""
    _, trules = _rules()
    spec = tconfigs.ShapeSpec("x", kind, S, B)
    if kind == "train":
        return ttl.lower_train_step(tcfg, train_batch_shape(tcfg, spec), device="cpu",
                                    rules=trules, coord=(0, 0))[0]
    if kind == "prefill":
        return tsl.lower_prefill(tcfg, spec, "cpu", trules, (0, 0))[0]
    return tsl.lower_decode_step(tcfg, spec, "cpu", trules, (0, 0))[0]


def _cfgs(arch, **moe):
    out = []
    for c in (jconfigs, tconfigs):
        cfg = c.get_config(arch).reduced()
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        out.append(cfg)
    return out


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_per_device_account_follows_the_references(cell):
    arch, kind = cell
    jcfg, tcfg = _cfgs(arch)
    args, flops, wire = reference_account(jcfg, kind)
    got = port_account(tcfg, kind)
    assert got.held_bytes == args + UNREAD.get(cell, 0)
    assert flops * (1 - FLOPS_UNDER.get(cell, 0.0)) <= got.flops \
        <= flops * (1 + FLOPS_OVER[cell]), (got.flops, flops)
    core = sum(wire.get(k, 0.0) for k in CORE)
    lo, hi = WIRE_BAND.get(cell, WIRE_BAND[kind])
    assert lo * core <= got.wire_bytes <= hi * core, (got.wire_bytes, core)
    assert set(got.collective_breakdown) <= set(CORE)
    assert sum(got.collective_breakdown.values()) == pytest.approx(got.wire_bytes)
    # (2, 4) fits one node of 8 cards: every collective on NVLink
    assert set(got.link_bytes) == {"nvlink"}


def test_stationary_decode_moves_fewer_bytes_than_the_gather_path():
    """kimi's decode: the weights-stationary path (8 rows a data shard x
    top-2 under the default threshold) moves fewer wire bytes a device
    than the FSDP gather of the banks (``stationary_threshold=0``), in
    the port as in the reference (73 616 < 92 560 bytes there)."""
    wires = {}
    for name, moe in (("stationary", {}), ("gather", {"stationary_threshold": 0})):
        jcfg, tcfg = _cfgs("kimi-k2-1t-a32b", **moe)
        _, _, wire = reference_account(jcfg, "decode")
        wires[name] = (sum(wire.values()), port_account(tcfg, "decode").wire_bytes)
    assert wires["stationary"][0] < wires["gather"][0]
    assert wires["stationary"][1] < wires["gather"][1]


def _table():
    """The per-device account of each cell, the reference's against the
    port's, in the configs' bf16 and in float32 (where the reference's
    CPU program carries the same element size as the port's); and each
    cell's peak a device (F14): the port's traced peak of live bytes and
    the reference's ``memory_analysis`` argument + temp + output bytes."""
    print(f"{'cell':34} {'dtype':8} {'args ref/port':>17} {'flops ref':>11} {'port/ref':>8} "
          f"{'wire ref core':>13} {'port/ref':>8} {'peak ref':>10} {'port':>10}  "
          "reference's other collectives")
    for arch, kind in CELLS:
        for dtype in ("bfloat16", "float32"):
            jcfg, tcfg = (dataclasses.replace(c, dtype=dtype) for c in _cfgs(arch))
            args, flops, wire, peak = reference_account(jcfg, kind, peak=True)
            got = port_account(tcfg, kind)
            core = sum(wire.get(k, 0.0) for k in CORE)
            other = {k: v for k, v in wire.items() if k not in CORE}
            print(f"{arch + ' ' + kind:34} {dtype:8} {args:>8}/{got.held_bytes:<8} "
                  f"{flops:11.5g} {got.flops / flops:8.4f} {core:13.6g} "
                  f"{got.wire_bytes / core:8.4f} {peak:10d} {got.peak_bytes:10d}  {other}",
                  flush=True)


if __name__ == "__main__":
    _table()
