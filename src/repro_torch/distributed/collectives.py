"""Collectives of the port: the data-parallel gradient all-reduce over a
list of shards, and the named-axis collectives of the LM's device grid.

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

**The grid's collectives** (`psum`, `pmax`, `all_gather`,
`reduce_scatter`, `all_to_all`) are the counterparts of ``jax.lax``'s
over named mesh axes, for the sharded LM step (`models.transformer`,
`models.rwkv6` or `models.zamba2` with a `models.moe.MeshContext`). A
*share* is a list with one tensor a grid coordinate of ``mc.coords``,
each on its coordinate's device. On a full
grid (``mc.coord`` None: every coordinate in one process) each
collective works group by group, a group the coordinates that differ
only along the named axes, taken in row-major order over those axes:
sums in that order (`shard_sum`), concatenations in it. Under autograd
each one's backward is its dual (an all-reduce's an all-reduce of the
cotangents, an all-gather's a reduce-scatter, and back), so the
gradients of a grid step are those of the one-device step.

With ``mc.coord`` set the share holds that coordinate alone and each
collective takes its **lone form**: it returns the shape and dtype the
real collective would, filled from the local piece only (a sum is the
piece itself, a gather the piece repeated). A lone collective is true in
memory and in shape, not in value; the dry run traces a coordinate's
share with it (`training.train_loop.lower_train_step(coord=...)`), and
the card runs one to check the traced peak. It is never used on a grid
of several coordinates.

Every collective, forward and backward, reports its kind and wire bytes
a device to each active dispatch mode that takes them
(``note_collective``: `launch.roofline.GraphAnalysis`), with the
reference's formulas (`roofline.py:428-440`): all-reduce 2 b (n - 1) /
n, all-gather out (n - 1) / n, reduce-scatter and all-to-all in (n - 1)
/ n, for b / in the bytes a device puts in and out those it gets.
"""

from __future__ import annotations

import math
from typing import Any, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.training.optimizer import _leaves, tree_map

__all__ = ["compressed_psum_with_error_feedback", "init_residual", "pmean", "elements_apart",
           "shard_sum", "psum", "pmax", "all_gather", "reduce_scatter", "all_to_all",
           "axis_index", "axes_size", "axes_of"]

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


# --------------------------------------------------------------------------
# named-axis collectives of the LM's device grid
# --------------------------------------------------------------------------

def _to(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device``: itself where it already is."""
    return x if x.device == device else x.to(device)


def shard_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """A sum over shards in shard order, on ``device``."""
    total = _to(parts[0], device)
    for part in parts[1:]:
        total = total + _to(part, device)
    return total


def axes_of(entry) -> tuple:
    """The axis names of a spec entry or an ``axes`` argument: None, a
    name, or a tuple of names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_size(mesh, axes) -> int:
    """The number of coordinates along ``axes`` (a name, a tuple, None)."""
    return math.prod(mesh.shape[ax] for ax in axes_of(axes))


def axis_index(mesh, coord, axes) -> int:
    """``coord``'s row-major index over ``axes`` (``jax.lax.axis_index``
    of a tuple of axes)."""
    idx = 0
    for ax in axes_of(axes):
        idx = idx * mesh.shape[ax] + coord[mesh.axis_names.index(ax)]
    return idx


def _members(mesh, coord, axes) -> list:
    """Every coordinate of ``coord``'s group over ``axes``, in order."""
    pos = [mesh.axis_names.index(ax) for ax in axes]
    out = []
    for flat in range(axes_size(mesh, axes)):
        c = list(coord)
        for p, ax in zip(reversed(pos), reversed(axes)):
            c[p] = flat % mesh.shape[ax]
            flat //= mesh.shape[ax]
        out.append(tuple(c))
    return out


def _wire(kind: str, nbytes: int, n: int) -> float:
    """Wire bytes a device of an n-member collective on ``nbytes`` bytes in."""
    if kind == "all-reduce":
        return 2.0 * nbytes * (n - 1) / n
    if kind == "all-gather":
        return float(nbytes) * (n - 1)  # the gathered output's (n - 1) / n
    return nbytes * (n - 1) / n


def _report(kind: str, xs, n: int, mc, axes, group) -> None:
    """Hand ``note_collective(kind, wire_bytes, mesh, axes, group)`` each
    member's wire bytes to the active dispatch modes that take it."""
    listeners = [m for m in _get_current_dispatch_mode_stack() if hasattr(m, "note_collective")]
    if not listeners:
        return
    for x in xs:
        wire = _wire(kind, x.numel() * x.element_size(), n)
        for mode in listeners:
            mode.note_collective(kind, wire, mc.mesh, axes, group)


def _chunk(x, dim, i, n):
    c = x.shape[dim] // n
    return x.narrow(dim, i * c, c)


def _adjacent(xs, devs, dim):
    """Where the members are one device's adjacent pieces along ``dim`` of
    one tensor (a full grid on one card gathering what `sharding.shard`
    cut), their concatenation as a view of it, one a member; else None."""
    from torch._subclasses.fake_tensor import FakeTensor

    x0 = xs[0]
    if any(torch.device(d) != x0.device for d in devs) or x0.device.type == "meta" \
            or any(isinstance(x, FakeTensor) for x in xs):
        return None
    ptr = x0.untyped_storage().data_ptr()
    step = x0.shape[dim] * x0.stride(dim)
    for k, x in enumerate(xs):
        if x.device != x0.device or x.dtype != x0.dtype or x.shape != x0.shape \
                or x.stride() != x0.stride() or x.untyped_storage().data_ptr() != ptr \
                or x.storage_offset() != x0.storage_offset() + k * step:
            return None
    shape = list(x0.shape)
    shape[dim] *= len(xs)
    return [x0.as_strided(shape, x0.stride(), x0.storage_offset()) for _ in xs]


def _run(kind: str, xs, n: int, idx, devs, dims, mc, axes, group):
    """One group's collective: ``xs`` the members' tensors (one: the lone
    form, ``idx`` its place in the group), their ``devs``."""
    _report(kind, xs, n, mc, axes, group)
    dim, dim2 = dims
    if len(xs) == 1:  # the lone form: the shape of the real one, the local values
        x, i = xs[0], idx[0]
        if kind == "all-reduce":
            return [x.clone()]
        if kind == "all-gather":
            return [torch.cat([x] * n, dim)]
        if kind == "reduce-scatter":
            return [_chunk(x, dim, i, n).clone()]
        return [torch.cat([_chunk(x, dim, i, n)] * n, dim2)]  # all-to-all
    home = devs[0]
    # members on one device share the result (its backward needs only the
    # sum of their cotangents); others get a copy on their own
    if kind == "all-reduce":
        total = shard_sum(xs, home)
        return [_to(total, d) for d in devs]
    if kind == "all-gather":
        views = _adjacent(xs, devs, dim)
        if views is not None:
            return views
        whole = torch.cat([_to(x, home) for x in xs], dim)
        return [_to(whole, d) for d in devs]
    if kind == "reduce-scatter":
        total = shard_sum(xs, home)
        return [_chunk(total, dim, k, n).to(d, copy=True) for k, d in enumerate(devs)]
    return [torch.cat([_chunk(x, dim, k, n).to(d) for x in xs], dim2)  # all-to-all
            for k, d in enumerate(devs)]


_DUAL = {"all-reduce": "all-reduce", "all-gather": "reduce-scatter",
         "reduce-scatter": "all-gather", "all-to-all": "all-to-all"}


class _Collective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, *xs):
        ctx.op = op
        return tuple(_run(op["kind"], xs, *op["args"]))

    @staticmethod
    def backward(ctx, *gs):
        op = ctx.op
        n, idx, devs, (dim, dim2), *rest = op["args"]
        dims = (dim2, dim) if op["kind"] == "all-to-all" else (dim, dim2)
        return (None,) + tuple(_run(_DUAL[op["kind"]], gs, n, idx, devs, dims, *rest))


def _groups(axes, mc) -> list:
    """The share's groups over ``axes``: for each, the positions in
    ``mc.coords`` of its members in order (one: a lone coordinate), their
    indices over ``axes`` and the coordinates of the whole group; kept in
    ``mc.groups``."""
    if axes in mc.groups:
        return mc.groups[axes]
    coords = mc.coords
    groups = {}
    for k, c in enumerate(coords):
        key = tuple(0 if ax in axes else i for ax, i in zip(mc.mesh.axis_names, c))
        groups.setdefault(key, []).append(k)
    n = axes_size(mc.mesh, axes)
    out = []
    for ks in groups.values():
        ks.sort(key=lambda k: axis_index(mc.mesh, coords[k], axes))
        if len(ks) not in (1, n):
            raise ValueError(f"a collective over {axes}: {len(ks)} of the group's {n} "
                             "coordinates are in the share")
        out.append((ks, [axis_index(mc.mesh, coords[k], axes) for k in ks],
                    _members(mc.mesh, coords[ks[0]], axes)))
    mc.groups[axes] = out
    return out


def _live(axes, mc) -> tuple:
    return tuple(ax for ax in axes_of(axes) if mc.mesh.shape[ax] > 1)


def _collective(kind: str, xs: list, axes, mc, dim: int = 0, dim2: int = 0) -> list:
    """``kind`` over ``axes`` on the share ``xs`` (aligned with
    ``mc.coords``), group by group."""
    axes = _live(axes, mc)
    n = axes_size(mc.mesh, axes)
    if n == 1:
        return list(xs)
    out = [None] * len(xs)
    for ks, idx, group in _groups(axes, mc):
        devs = [mc.device(mc.coords[k], xs[k].device) for k in ks]
        args = (n, idx, devs, (dim, dim2), mc, axes, group)
        ins = [xs[k] for k in ks]
        if torch.is_grad_enabled() and any(x.requires_grad for x in ins):
            res = _Collective.apply({"kind": kind, "args": args}, *ins)
        else:
            res = _run(kind, ins, *args)
        for k, r in zip(ks, res):
            out[k] = r
    return out


def psum(xs: list, axes, mc) -> list:
    """``jax.lax.psum`` over ``axes``: each member gets the group's sum."""
    return _collective("all-reduce", xs, axes, mc)


def pmax(xs: list, axes, mc) -> list:
    """``jax.lax.pmax`` over ``axes``, outside autograd (a softmax's max,
    whose gradient cancels): each member gets the group's elementwise
    max (the lone form: its own)."""
    xs = [x.detach() for x in xs]
    axes = _live(axes, mc)
    n = axes_size(mc.mesh, axes)
    if n == 1:
        return xs
    out = [None] * len(xs)
    for ks, _, group in _groups(axes, mc):
        ins = [xs[k] for k in ks]
        _report("all-reduce", ins, n, mc, axes, group)
        m = ins[0]
        for x in ins[1:]:
            m = torch.maximum(m, x.to(m.device))
        for k in ks:
            out[k] = m.to(mc.device(mc.coords[k], xs[k].device), copy=True)
    return out


def all_gather(xs: list, axes, mc, dim: int) -> list:
    """``jax.lax.all_gather(..., tiled=True)`` over ``axes`` along ``dim``:
    each member gets the members' pieces concatenated in order."""
    return _collective("all-gather", xs, axes, mc, dim)


def reduce_scatter(xs: list, axes, mc, dim: int) -> list:
    """``jax.lax.psum_scatter(..., tiled=True)`` over ``axes``: member k
    gets the k-th of n chunks along ``dim`` of the group's sum."""
    return _collective("reduce-scatter", xs, axes, mc, dim)


def all_to_all(xs: list, axes, mc, split_dim: int, concat_dim: int) -> list:
    """``jax.lax.all_to_all(..., tiled=True)`` over ``axes``: member k gets
    the k-th chunk along ``split_dim`` of every member's piece,
    concatenated along ``concat_dim`` in member order."""
    return _collective("all-to-all", xs, axes, mc, split_dim, concat_dim)
