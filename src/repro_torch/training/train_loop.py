"""The LM train step: forward, backward and AdamW.

Counterpart of `repro.training.train_loop`'s `TrainConfig` and
`build_train_step` (and of `examples/lm_smoke.py`): gradient
accumulation over microbatches (float32 sums from zeros, then ``/ mb``;
the loss the mean of the microbatches' losses), a schedule-driven
learning rate, `adamw_update` with its global-norm clip, and the
metrics ``loss`` and ``grad_norm``. The step runs on one device; with
sharding ``rules`` (`distributed.sharding.ShardingRules` over a device
grid) the backbone gets `make_mesh_context(rules)`: each backbone (the
transformer, rwkv6, zamba2) runs the reference's sharded step, one share
a grid coordinate on the grid's devices, on the whole parameters (whose gradients are the one-device
step's). With ``coord`` as well the step is that coordinate's share
alone: parameters, AdamW moments and batch are its pieces
(`sharding.local_shapes` of `param_specs`, `opt_state_specs`,
`batch_specs`), the collectives run in their lone form and the gradients
of replicated pieces are all-reduced (`sharding.sync_grads`).
`lower_train_step`, the dry run's entry (`repro_torch.launch.dryrun`),
traces the step on fake tensors under `launch.roofline.GraphAnalysis`:
its FLOPs, HBM bytes, peak memory and the collectives' wire bytes,
nothing allocated; with rules, the whole grid's work on the one device;
with a coordinate, that device's.

    python -m repro_torch.training.train_loop [--arch rwkv6-7b] [--steps 30]
        [--device cpu] [--mesh 2x4 --devices cuda:0 ...]

trains the arch's reduced config (every config: rwkv6, the eight
transformer configs and zamba2) on random weights from a seed, with the
reference's batch recipe: tokens (steps, 8, 33) drawn from
``numpy.random.default_rng(0)``, inputs ``[:, :-1]``, labels ``[:, 1:]``;
an embedding frontend (musicgen, llava) takes random frame embeddings in
place of the inputs. ``--mesh DxM`` runs the sharded step of the
reference's smoke on a (D, M) ("data", "model") grid with its default
rules (FSDP over "data"): ``--devices`` lists the grid's D * M devices
row-major, or one device for all of them; the parameters and the batch
live on the first.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (
    Mesh,
    ShardingRules,
    batch_specs,
    local_shapes,
    make_mesh_context,
    opt_state_specs,
    param_specs,
    sync_grads,
)
from repro_torch.kernels.build import resolve_device
from repro_torch.models.registry import get_backbone
from repro_torch.training.optimizer import AdamWConfig, adamw_update, init_opt_state, tree_map

__all__ = ["TrainConfig", "build_train_step", "value_and_grad", "lm_batches",
           "lower_train_step", "coordinate_share", "main"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    microbatch: int = 1  # gradient-accumulation steps per update
    lr_schedule: Optional[Callable] = None  # step -> lr


def value_and_grad(loss: Callable, params, *args):
    """(loss, gradients shaped like ``params``, in their dtypes) of
    ``loss(params, *args)`` by autograd; a leaf the loss does not read
    (the token embedding of an embedding frontend) gets zeros, as under
    ``jax.grad``."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    value = loss(leaves, *args)
    value.backward()
    return value.detach(), tree_map(
        lambda p: torch.zeros_like(p) if p.grad is None else p.grad, leaves)


def build_train_step(arch_cfg, train_cfg: TrainConfig = TrainConfig(), device=None,
                     rules=None, coord=None, specs=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on ``device`` (default: the card through `resolve_device`),
    where the batch's tensors are moved. TF32 stays off on the card.
    ``rules`` (`distributed.sharding.ShardingRules`): the backbone runs
    under `make_mesh_context(rules)`, as the reference's step does;
    ``coord`` with ``specs`` (`coordinate_share`'s) builds that
    coordinate's share alone, on its pieces."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    backbone = get_backbone(arch_cfg)
    mesh_ctx = None if rules is None else make_mesh_context(rules, coord, specs)

    def loss(params, batch):
        return backbone.loss_fn(params, batch, arch_cfg, mesh_ctx)

    def train_step(params, opt_state, batch):
        batch = {k: v.to(device) for k, v in batch.items()}
        mb = train_cfg.microbatch
        if mb > 1:
            g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            losses = []
            for i in range(mb):
                part = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                        for k, v in batch.items()}
                l, g = value_and_grad(loss, params, part)
                g_sum = tree_map(torch.add, g_sum, g)
                losses.append(l)
            grads = tree_map(lambda g: g / mb, g_sum)
            l = torch.stack(losses).mean()
        else:
            l, grads = value_and_grad(loss, params, batch)
        if coord is not None:
            grads = sync_grads(grads, specs["params"], mesh_ctx)
        lr = None
        if train_cfg.lr_schedule is not None:
            lr = train_cfg.lr_schedule(opt_state["step"])
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  train_cfg.optimizer, lr)
        metrics["loss"] = l
        return params, opt_state, metrics

    return train_step


def _mesh_context(rules):
    return None if rules is None else make_mesh_context(rules)


def fake_like(shapes, device) -> dict:
    """Zero tensors of ``shapes``' shapes and dtypes (a dict of tensors,
    e.g. on ``meta``, standing in for the reference's ShapeDtypeStructs)
    on ``device``; called under a `FakeTensorMode`, they allocate nothing."""
    return {k: torch.zeros(tuple(v.shape), dtype=v.dtype, device=device)
            for k, v in shapes.items()}


def coordinate_share(params, opt, batch, rules: ShardingRules, device):
    """A grid coordinate's share of whole (fake or ``meta``) trees: (its
    parameters, moments and batch as zero tensors of their pieces'
    shapes on ``device``, the specs ``{"params", "batch"}`` that
    `build_train_step(coord=...)` wants). Called under a `FakeTensorMode`
    it allocates nothing."""
    pspecs = param_specs(params, rules)
    bspecs = batch_specs(batch, rules)

    def zeros(tree, specs):
        return tree_map(lambda t: torch.zeros(tuple(t.shape), dtype=t.dtype, device=device),
                        local_shapes(tree, specs, rules.mesh))

    return (zeros(params, pspecs), zeros(opt, opt_state_specs(opt, pspecs)),
            zeros(batch, bspecs), {"params": pspecs, "batch": bspecs})


def lower_train_step(arch_cfg, batch_shape, train_cfg: TrainConfig = TrainConfig(),
                     device=None, rules=None, coord=None):
    """The dry run's entry: one update step of ``arch_cfg`` traced on fake
    tensors, nothing allocated. Returns ``(analysis, params_shape,
    opt_shape)``: the step's `launch.roofline.GraphAnalysis` (FLOPs by
    dtype, HBM bytes, the peak of live bytes with the parameters, the
    optimizer state and the batch held throughout, as a training loop holds
    them, and the collectives' wire bytes) and the fake parameter and
    optimizer-state trees.

    Beside the reference's arguments it takes the ``device`` the fake
    tensors live on (default: the card through `resolve_device`), and
    ``rules`` is optional: without them the step is the one-device step;
    with them the parameters are drawn under `make_mesh_context(rules)`
    (padded expert banks) and the trace counts every grid coordinate's
    share on the one device; with ``coord`` too, the share of that
    coordinate alone (`coordinate_share`): one device of the grid, its
    collectives in their lone form, the trees returned its pieces.
    ``batch_shape`` is a dict of tensors (``meta`` ones will do) whose
    shapes and dtypes stand in for ShapeDtypeStructs. The parameters are
    drawn from a CPU `torch.Generator` as `init_params` draws them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.roofline import GraphAnalysis

    device = resolve_device(device)
    backbone = get_backbone(arch_cfg)
    with FakeTensorMode():
        params = backbone.init_params(torch.Generator().manual_seed(0), arch_cfg,
                                      _mesh_context(rules), device=device)
        opt = init_opt_state(params, train_cfg.optimizer)
        batch = fake_like(batch_shape, device)
        specs = None
        if coord is not None:
            params, opt, batch, specs = coordinate_share(params, opt, batch, rules, device)
        step = build_train_step(arch_cfg, train_cfg, device, rules, coord, specs)
        analysis = GraphAnalysis()
        analysis.hold((params, opt, batch))
        with analysis:
            step(params, opt, batch)
    return analysis, params, opt


def lm_batches(vocab: int, steps: int, batch: int = 8, seq: int = 32, seed: int = 0,
               embed_dim: Optional[int] = None):
    """The reference smoke's batches: tokens (steps, batch, seq + 1) from
    ``default_rng(seed)`` below ``vocab``; step ``i`` -> {"tokens":
    [:, :-1], "labels": [:, 1:]} as int32 tensors on the host. With
    ``embed_dim`` (an embedding frontend: musicgen's audio frames, llava's
    patches) "tokens" gives way to "embeddings", standard normal float32
    (batch, seq, embed_dim) drawn from a generator seeded ``seed + i``,
    as the reference smoke draws them from ``PRNGKey(i)``."""
    data = np.random.default_rng(seed).integers(0, vocab, (steps, batch, seq + 1))
    for it in range(steps):
        labels = torch.from_numpy(data[it, :, 1:].astype(np.int32))
        if embed_dim is None:
            yield {"tokens": torch.from_numpy(data[it, :, :-1].astype(np.int32)), "labels": labels}
        else:
            gen = torch.Generator().manual_seed(seed + it)
            yield {"embeddings": torch.randn((batch, seq, embed_dim), generator=gen),
                   "labels": labels}


def _grid_rules(mesh: str, devices, device):
    """ShardingRules of a ``DxM`` ("data", "model") grid over ``devices``
    (one entry fills the grid; default: ``device`` resolved), FSDP over
    "data"."""
    try:
        shape = tuple(int(n) for n in mesh.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        raise SystemExit(f"train_loop: --mesh wants DxM (e.g. 2x4), got {mesh!r}")
    devs = devices or [resolve_device(device)]
    return ShardingRules(mesh=Mesh(shape, ("data", "model"), devs[0] if len(devs) == 1 else devs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train a reduced LM on random weights.")
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs there)")
    ap.add_argument("--mesh", default=None,
                    help="DxM: the sharded step on a (D, M) ('data', 'model') device grid")
    ap.add_argument("--devices", nargs="+", default=None,
                    help="with --mesh: the grid's D*M devices row-major, or one for all "
                         "(default: --device)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch).reduced()
    backbone = get_backbone(cfg)
    rules = None
    if args.mesh:
        rules = _grid_rules(args.mesh, args.devices, args.device)
        device = rules.mesh.devices.flat[0]
        where = f"a {tuple(rules.mesh.shape.values())} grid of {rules.mesh}"
    else:
        device = resolve_device(args.device)
        where = str(device)
    print(f"== {args.arch} (reduced: {cfg.n_layers}L d={cfg.d_model}) on {where} ==")
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    params = backbone.init_params(gen, cfg, _mesh_context(rules), device=device)
    opt = init_opt_state(params, AdamWConfig())
    step = build_train_step(cfg, TrainConfig(optimizer=AdamWConfig(lr=3e-3)), device, rules)
    losses = []
    embed_dim = cfg.d_model if cfg.frontend == "embedding" else None
    for it, batch in enumerate(lm_batches(cfg.vocab, args.steps, embed_dim=embed_dim)):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        if it % 5 == 0:
            print(f"  step {it:3d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f}")
    if not np.isfinite(losses).all():
        print("train_loop: a loss is not finite", file=sys.stderr)
        return 1
    print(f"smoke train OK: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
