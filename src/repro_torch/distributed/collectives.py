"""Data-parallel gradient collectives over a list of shards.

Counterpart of `repro.distributed.collectives`. Where the reference runs
inside ``shard_map`` / ``vmap`` over a named mesh axis, the port's shard
axis is a Python list: one gradient tree (and one residual tree) a
shard, each on its shard's device. Entries may name the same device, as
`distributed.sharding.stream_devices` allows for the fleet, so one card
can hold several shards.

`compressed_psum_with_error_feedback`: the int8-quantized gradient
all-reduce with error feedback. Per leaf, every shard quantizes
``g + residual`` with one scale shared by all shards (the absmax over
shards), the int8 codes are summed as int32, and each shard keeps what
its codes failed to send as its next residual: unbiased in the long run,
one byte an element on the wire instead of four.

The port evaluates each leaf in the source's order, operation by
operation, as the reference's ``jax.vmap`` does: array-equal to it at
every shard count. Under ``jax.jit`` XLA rewrites two of the leaf's
expressions (P9): ``/ n`` becomes a product with the float32 reciprocal
of n (an ulp apart at n = 3), and the residual ``g32 - q * scale``
contracts to a fused multiply-add on some elements and not on others,
by the leaf's shape and data, so no fixed order reproduces the compiled
step; the port's DP step is held to it within a tolerance. Divisions by
a scalar divide by a device tensor: PyTorch's CUDA division by a host
scalar multiplies by its reciprocal.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from repro_torch.training.optimizer import _leaves, tree_map

__all__ = ["compressed_psum_with_error_feedback", "init_residual", "pmean", "elements_apart"]

Tree = Any


def _divide(x: torch.Tensor, by: float) -> torch.Tensor:
    """``x / by`` rounded as a true float32 division on every device."""
    return torch.div(x, torch.tensor(by, dtype=x.dtype, device=x.device))


def _over_shards(fn, n_out: int, *groups: Sequence[Tree]) -> List[List[Tree]]:
    """At every leaf, ``fn(*one list of shard leaves a group)`` returns
    ``n_out`` lists of per-shard leaves -> for each output, one tree a
    shard."""
    n = len(groups[0])
    out = tree_map(lambda *leaves: fn(*(leaves[i:i + n] for i in range(0, len(leaves), n))),
                   *(t for g in groups for t in g))
    like = groups[0][0]
    return [[tree_map(lambda _, o: o[k][s], like, out) for s in range(n)] for k in range(n_out)]


def pmean(trees: Sequence[Tree]) -> List[Tree]:
    """The uncompressed all-reduce mean: every shard gets the mean of the
    shards' leaves (summed in shard order on the first shard's device,
    then divided by n), on its own device."""
    n = len(trees)

    def leaf(gs):
        home = gs[0].device
        total = gs[0].to(torch.float32)
        for g in gs[1:]:
            total = total + g.to(device=home, dtype=torch.float32)
        mean = _divide(total, n).to(gs[0].dtype)
        return ([mean.to(g.device) for g in gs],)

    return _over_shards(leaf, 1, trees)[0]


def compressed_psum_with_error_feedback(
    grads: Sequence[Tree], residual: Sequence[Tree]
) -> Tuple[List[Tree], List[Tree]]:
    """All-reduce-mean one gradient tree a shard with int8 compression.

    Per leaf, as the reference's protocol: (1) one absmax over the
    shards, ``scale = max|g + r| / 127 + 1e-12``, so every shard
    quantizes with the same scale and decodes exactly what was sent;
    (2) ``q = clip(round(g32 / scale), -127, 127)`` in int8 (round half
    to even); (3) the shard's new residual ``g32 - q * scale``; (4) the
    int32 sum of the codes over the shards, decoded as ``total * scale /
    n``. Returns (the synced gradients, one tree a shard, equal on every
    shard and on its device; the new residuals, one tree a shard, in
    float32)."""
    n = len(grads)
    if len(residual) != n or n == 0:
        raise ValueError(f"{n} gradient trees but {len(residual)} residual trees")

    def leaf(gs, rs):
        home = gs[0].device
        g32 = [g.to(torch.float32) + r for g, r in zip(gs, rs)]
        amax = torch.stack([torch.amax(torch.abs(x)).to(home) for x in g32]).amax()
        scale = _divide(amax, 127.0) + 1e-12
        scales = [scale.to(x.device) for x in g32]
        q = [torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
             for x, s in zip(g32, scales)]
        new_r = [x - c.to(torch.float32) * s for x, c, s in zip(g32, q, scales)]
        total = q[0].to(torch.int32)
        for c in q[1:]:
            total = total + c.to(device=home, dtype=torch.int32)
        mean = _divide(total.to(torch.float32) * scale, n).to(gs[0].dtype)
        return [mean.to(g.device) for g in gs], new_r

    synced, new_residual = _over_shards(leaf, 2, grads, residual)
    return synced, new_residual


def init_residual(params: Tree) -> Tree:
    """Zero float32 residuals shaped like ``params``, on their devices."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def elements_apart(got: Tree, want: Tree, scale: Tree, tol: float) -> Tuple[int, int]:
    """(elements of ``got`` further from ``want``'s than ``tol`` times
    the max |x| of ``scale``'s leaf, elements) over trees shaped alike,
    compared on the host. Two evaluations of a compressed sync (on two
    devices, say) may differ by a whole code where ``g + residual`` lies
    within rounding of a tie; this counts the elements where they do."""
    off = total = 0
    for a, b, g in zip(_leaves(got), _leaves(want), _leaves(scale), strict=True):
        b = b.cpu()
        off += int(((a.cpu() - b).abs() > tol * float(g.abs().max())).sum())
        total += b.numel()
    return off, total
