"""Parameter / activation sharding rules of the LM, and device placement
of the stream-parallel serving fleet.

Counterpart of `repro.distributed.sharding`.

**The LM's rules.** Conventions on the production mesh (("pod",)
"data", "model"): tensor parallelism over "model" (attention heads, FFN
hidden, vocab, MoE experts); FSDP over `fsdp_axes` (usually ("data",),
plus "pod" for the 1T MoE) on the remaining large dimension of each
weight; the batch over ``dp_axes`` (("pod", "data") multi-pod). Rules
are name-based over the parameter tree; a scanned stack's leading
(n_steps,) axis gets a None prepended. `param_specs`, `batch_specs` and
`cache_specs` give the reference's PartitionSpecs leaf for leaf.

A port `Mesh` is a named grid: ``axis_names`` and ``shape`` (an ordered
name -> size mapping, as jax's), with an n-D array of ``torch.device``
entries that may repeat (one card can hold every shard), or without
devices (an abstract mesh, like ``jax.sharding.AbstractMesh``, for the
specs of meshes larger than the machine). `P` is the PartitionSpec
counterpart: a tuple of None, an axis name, or a tuple of axis names.
The specs say how the reference lays a tensor out. `shard` gives a grid
coordinate's piece of each leaf (a view), `local_shapes` the pieces'
shapes, `unshard` puts pieces back together; each backbone's sharded
step (`models.transformer`, `models.rwkv6`, `models.zamba2` under
`make_mesh_context(rules)`) runs one share a coordinate on these pieces, and with ``coord=`` the share of
that coordinate alone (the dry run's per-device trace).

**The fleet.** The KWS server's unit of parallelism is the stream slot:
every per-slot state tensor, input slab and submitted mask leads with
the (max_streams,) slot axis, and slots are independent (no cross-slot
reduction anywhere in the tick). Where the reference splits that axis
block-wise over a 1-D ``("stream",)`` mesh, the port splits it over a
list of shard devices (`StreamingKWSServer(devices=...)`): shard ``k``
holds slots ``[k * max_streams / n, (k + 1) * max_streams / n)`` in
tensors of its own on ``devices[k]`` and gets one tick kernel launch a
tick. Entries may repeat, so one card can run several shards.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.distributed.collectives import axes_of, axis_index, psum
from repro_torch.kernels.build import resolve_device
from repro_torch.models.moe import MeshContext
from repro_torch.training.optimizer import tree_map

__all__ = [
    "Mesh",
    "P",
    "ShardingRules",
    "make_mesh_context",
    "param_specs",
    "batch_specs",
    "cache_specs",
    "opt_state_specs",
    "local_shapes",
    "shard",
    "unshard",
    "context_rules",
    "to_shares",
    "from_shares",
    "sync_grads",
    "stream_devices",
    "surviving_devices",
]


class P(tuple):
    """A PartitionSpec: one entry a dimension, each None (replicated), an
    axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


class Mesh:
    """A named grid of shards.

    ``Mesh((2, 4), ("data", "model"), devices)``: ``devices`` None (an
    abstract mesh: no devices, for specs only), one device (every shard
    on it), or a sequence of ``prod(axis_sizes)`` devices in row-major
    order; entries may repeat. ``shape`` maps each axis name to its size,
    in order, and ``devices`` is the n-D object array of ``torch.device``
    (None for an abstract mesh)."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str], devices=None):
        if len(axis_sizes) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"Mesh: sizes {tuple(axis_sizes)} and names {tuple(axis_names)} "
                             "must pair up, the names distinct")
        self.axis_names = tuple(axis_names)
        self.shape = collections.OrderedDict(zip(self.axis_names, (int(n) for n in axis_sizes)))
        self.size = math.prod(self.shape.values())
        self.devices = None
        if devices is not None:
            if isinstance(devices, (str, torch.device)):
                devices = [devices] * self.size
            devs = [_canonical(d) for d in devices]
            if len(devs) != self.size:
                raise ValueError(f"Mesh {tuple(self.shape.values())}: {len(devs)} devices "
                                 f"given, {self.size} wanted")
            arr = np.empty(self.size, dtype=object)
            arr[:] = devs
            self.devices = arr.reshape(tuple(self.shape.values()))

    def __repr__(self) -> str:
        where = "abstract" if self.devices is None else \
            f"devices {sorted({str(d) for d in self.devices.flat})}"
        return f"Mesh({dict(self.shape)}, {where})"

    def device(self, coord: Sequence[int]):
        """The device at grid coordinate ``coord`` (one index an axis);
        None on an abstract mesh."""
        return None if self.devices is None else self.devices[tuple(coord)]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Mesh
    dp_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp_axes: Tuple[str, ...] = ("data",)
    fsdp: bool = True

    @property
    def fsdp_spec(self):
        if not self.fsdp:
            return None
        return self.fsdp_axes if len(self.fsdp_axes) > 1 else self.fsdp_axes[0]

    @property
    def dp_spec(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]


def make_mesh_context(rules: ShardingRules, coord=None, specs=None) -> MeshContext:
    """The model's `MeshContext` of ``rules``; ``coord`` (one index an
    axis) builds that coordinate's share alone, on pieces whose whole
    tree has the `param_specs` ``specs``."""
    if coord is not None:
        coord = tuple(int(i) for i in coord)
        if len(coord) != len(rules.mesh.axis_names) or any(
                not 0 <= i < n for i, n in zip(coord, rules.mesh.shape.values())):
            raise ValueError(f"coordinate {coord} is not on the grid {dict(rules.mesh.shape)}")
        if specs is None:
            raise ValueError("a coordinate's share needs the parameters' specs")
    return MeshContext(
        mesh=rules.mesh,
        dp_axes=rules.dp_axes,
        model_axis=rules.model_axis,
        fsdp_axes=rules.fsdp_axes if rules.fsdp else (),
        coord=coord,
        specs=specs,
    )


# expected trailing ndims for each named weight class
_RULES = {
    # name: (base_ndim, spec builder)
    "embed": (2, lambda r: P(r.model_axis, r.fsdp_spec)),
    "head": (2, lambda r: P(r.fsdp_spec, r.model_axis)),
    "wq": (3, lambda r: P(r.fsdp_spec, r.model_axis, None)),
    "wk": (3, lambda r: P(r.fsdp_spec, r.model_axis, None)),
    "wv": (3, lambda r: P(r.fsdp_spec, r.model_axis, None)),
    "wo": (3, lambda r: P(r.model_axis, None, r.fsdp_spec)),
    "w_up": (2, lambda r: P(r.fsdp_spec, r.model_axis)),
    "w_gate": (2, lambda r: P(r.fsdp_spec, r.model_axis)),
    "w_down": (2, lambda r: P(r.model_axis, r.fsdp_spec)),
    "router": (2, lambda r: P(None, None)),
    # mamba2 projections (column-parallel inner dim / heads over model)
    "in_proj": (2, lambda r: P(r.fsdp_spec, r.model_axis)),
    "out_proj": (2, lambda r: P(r.model_axis, r.fsdp_spec)),
    "w_z": (2, lambda r: P(r.fsdp_spec, r.model_axis)),
    "w_x": (2, lambda r: P(r.fsdp_spec, r.model_axis)),
    "w_dt": (2, lambda r: P(r.fsdp_spec, r.model_axis)),
    "conv_w": (2, lambda r: P(None, r.model_axis)),  # (K, d_inner)
    # rwkv6 time-mix (channels == heads x head_dim over model)
    "w_r": (2, lambda r: P(r.fsdp_spec, r.model_axis)),
    "w_k": (2, lambda r: P(r.fsdp_spec, r.model_axis)),
    "w_v": (2, lambda r: P(r.fsdp_spec, r.model_axis)),
    "w_g": (2, lambda r: P(r.fsdp_spec, r.model_axis)),
    "w_o": (2, lambda r: P(r.model_axis, r.fsdp_spec)),
    # rwkv6 channel-mix
    "cm_w_k": (2, lambda r: P(r.fsdp_spec, r.model_axis)),
    "cm_w_v": (2, lambda r: P(r.model_axis, r.fsdp_spec)),
    "cm_w_r": (2, lambda r: P(r.fsdp_spec, r.model_axis)),
}

# MoE expert banks: one extra leading expert axis sharded over model. The
# shared expert's MLP sits under "moe" too, so its (stacked) leaves take
# these rules with the layer stack read as the expert axis, as the
# reference's do.
_EXPERT_RULES = {
    "w_up": lambda r: P(r.model_axis, r.fsdp_spec, None),
    "w_gate": lambda r: P(r.model_axis, r.fsdp_spec, None),
    "w_down": lambda r: P(r.model_axis, None, r.fsdp_spec),
}


def _axes_size(entry, mesh: Mesh) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return mesh.shape[entry]
    n = 1
    for ax in entry:
        n *= mesh.shape[ax]
    return n


def _fit(spec: P, shape, mesh: Mesh) -> P:
    """Drop spec entries that don't divide the dim size (explicit
    shardings require exact divisibility). The systematic case is GQA kv
    heads (8) on the 16-way model axis: KV projections replicate under
    wide TP (Megatron convention: attention then runs fully local per
    rank); the KV *cache* stays distributed by sharding its sequence axis
    instead (see cache_specs)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    for i, entry in enumerate(dims):
        if entry is None:
            continue
        if shape[i] % _axes_size(entry, mesh) != 0:
            dims[i] = None
    return P(*dims)


def _leaf_spec(names: Sequence[str], leaf, rules: ShardingRules) -> P:
    """``names``: the dict keys on the leaf's path (list indices left
    out, as the reference's DictKey filter leaves them)."""
    name = names[-1] if names else ""
    # int8 serving weights: {"q","s"} dicts under the weight's name —
    # q inherits the weight rule; s drops the (now size-1) last-dim entry
    is_s = False
    if name in ("q", "s") and len(names) >= 2:
        is_s = name == "s"
        name = names[-2]
    in_moe = "moe" in names or "experts" in names
    ndim = leaf.ndim

    if in_moe and name in _EXPERT_RULES:
        base = 3
        spec = _EXPERT_RULES[name](rules)
    elif name in _RULES:
        base, builder = _RULES[name]
        spec = builder(rules)
    else:
        # norms, biases, small vectors: replicated
        base = ndim
        spec = P(*([None] * ndim))
    extra = ndim - base
    if extra < 0:
        return P(*([None] * ndim))
    dims = [None] * extra + list(spec)
    if is_s:
        dims = dims[:-1] + [None]
    return _fit(P(*dims), tuple(leaf.shape), rules.mesh)


def _map_with_names(fn, tree, names=()):
    """``fn(names, leaf)`` over a tree of dicts, lists and tuples, the
    same tree back; ``names`` are the dict keys on the leaf's path."""
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_names(fn, v, names) for v in tree)
    return fn(names, tree)


def param_specs(params_shape: Any, rules: ShardingRules):
    """Tree of `P` matching a params tree (any leaves with ``ndim`` and
    ``shape``: tensors, fake or ``meta`` ones)."""
    return _map_with_names(lambda names, leaf: _leaf_spec(names, leaf, rules), params_shape)


def _dp_total(rules: ShardingRules) -> int:
    dp_total = 1
    for ax in rules.dp_axes:
        dp_total *= rules.mesh.shape[ax]
    return dp_total


def batch_specs(batch_shape: Any, rules: ShardingRules):
    """Input batch: leading dim is the global batch -> dp axes; if the
    batch doesn't divide the dp axes (long-context batch=1), replicate."""
    dp_total = _dp_total(rules)

    def spec(names, leaf):
        if leaf.ndim == 0:
            return P()
        if leaf.shape[0] % dp_total == 0:
            return P(*([rules.dp_spec] + [None] * (leaf.ndim - 1)))
        return P(*([None] * leaf.ndim))

    return _map_with_names(spec, batch_shape)


def cache_specs(cache_shape: Any, rules: ShardingRules, batch: int):
    """Serving-state sharding, keyed by leaf name.

    KV caches ("k"/"v", shape (..., B, S, KV, hd)): batch over dp when it
    divides; the SEQUENCE axis shards over "model" (plus "data" when the
    batch cannot shard — long-context batch=1). Recurrent states shard
    their head/channel axis over "model" to match the column-parallel
    projections that produce them."""
    dp_total = _dp_total(rules)
    batch_ok = batch % dp_total == 0
    seq_axes = (
        rules.model_axis if batch_ok else ("data", rules.model_axis)
    )

    def spec(names, leaf):
        name = names[-1] if names else ""
        dims = [None] * leaf.ndim
        bidx = None
        for i, d in enumerate(tuple(leaf.shape)[:2]):
            if d == batch:
                bidx = i
                break
        if bidx is None:
            return P(*dims)
        if batch_ok:
            dims[bidx] = rules.dp_spec
        if name in ("k", "v") and leaf.ndim >= bidx + 4:
            dims[bidx + 1] = seq_axes  # sequence axis
        elif name in ("wkv", "ssd") and leaf.ndim >= bidx + 3:
            dims[bidx + 1] = rules.model_axis  # heads
        elif name == "conv":
            dims[-1] = rules.model_axis  # d_inner (column-parallel)
        return _fit(P(*dims), tuple(leaf.shape), rules.mesh)

    return _map_with_names(spec, cache_shape)


def opt_state_specs(opt_state, pspecs):
    """AdamW's state sharded like the parameters, as the reference's
    ``_opt_state_specs``: the step replicated, each moment its
    parameter's spec; an int8 moment's codes take it and its row scale
    drops the last entry."""
    def mirror(spec, moment):
        if isinstance(moment, dict) and "q" in moment:
            return {"q": spec, "s": P(*(list(spec)[:-1] + [None]))}
        return spec

    return {"step": P(),
            "m": _spec_map(mirror, pspecs, opt_state["m"]),
            "v": _spec_map(mirror, pspecs, opt_state["v"])}


def _spec_map(fn, specs, *trees):
    """``fn(spec, *subtrees)`` at each `P` of ``specs`` (a tree whose
    leaves are specs), with the subtrees of ``trees`` at the same place."""
    if isinstance(specs, P):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: _spec_map(fn, v, *(t[k] for t in trees)) for k, v in specs.items()}
    return type(specs)(_spec_map(fn, v, *(t[i] for t in trees)) for i, v in enumerate(specs))


def _spec_dims(spec, ndim) -> list:
    return list(spec) + [None] * (ndim - len(spec))


def local_shape(shape, spec: P, mesh: Mesh) -> tuple:
    """``shape`` with each dim divided by its spec entry's axis sizes
    (``NamedSharding(mesh, spec).shard_shape``)."""
    dims = _spec_dims(spec, len(shape))
    out = []
    for n, entry in zip(shape, dims):
        k = _axes_size(entry, mesh)
        if n % k:
            raise ValueError(f"dim {n} of {tuple(shape)} does not split {k} ways ({spec})")
        out.append(n // k)
    return tuple(out)


def local_shapes(tree, specs, mesh: Mesh):
    """``meta`` tensors of each leaf's dtype and its piece's shape on the
    grid (`local_shape`): what a coordinate holds."""
    return tree_map(lambda t, spec: torch.empty(local_shape(tuple(t.shape), spec, mesh),
                                                dtype=t.dtype, device="meta"), tree, specs)


def _slices(shape, spec: P, mesh: Mesh, coord) -> list:
    """(dim, start, length) of the piece at ``coord`` along each sharded dim."""
    out = []
    for d, (n, entry) in enumerate(zip(shape, _spec_dims(spec, len(shape)))):
        k = _axes_size(entry, mesh)
        if k > 1:
            size = n // k
            out.append((d, axis_index(mesh, coord, entry) * size, size))
    return out


@dataclasses.dataclass
class _Cuts:
    """A leaf and its sharded dims: [(dim, spec entry, piece length)]."""
    t: torch.Tensor
    cuts: list


def _plan(tree, specs, mesh: Mesh):
    return tree_map(lambda t, spec: _Cuts(t, [
        (d, entry, n // _axes_size(entry, mesh))
        for d, (n, entry) in enumerate(zip(t.shape, _spec_dims(spec, t.dim())))
        if _axes_size(entry, mesh) > 1]), tree, specs)


def _pieces(plan, mesh: Mesh, coord, dev=None):
    """The pieces of a `_plan` at ``coord`` (on ``dev`` where given)."""
    def piece(leaf):
        t = leaf.t
        for d, entry, size in leaf.cuts:
            t = t.narrow(d, axis_index(mesh, coord, entry) * size, size)
        return t if dev is None or t.device == dev else t.to(dev)

    return tree_map(piece, plan)


def shard(tree, specs, mesh: Mesh, coord):
    """Each leaf's piece at grid coordinate ``coord`` as a view (the leaf
    itself where its spec is replicated)."""
    return _pieces(_plan(tree, specs, mesh), mesh, coord)


def unshard(shares: Sequence[Any], specs, mesh: Mesh, coords: Sequence[tuple]):
    """The whole tree from one tree of pieces a coordinate of ``coords``
    (every coordinate of the grid), on the first piece's device: each
    leaf's pieces put at their places (a replicated axis's first
    coordinate taken)."""
    def whole(spec, *pieces):
        ref = pieces[0]
        shape = [n * _axes_size(e, mesh) for n, e in zip(ref.shape, _spec_dims(spec, ref.dim()))]
        named = {ax for e in spec for ax in axes_of(e)}
        free = [k for k, ax in enumerate(mesh.axis_names) if ax not in named]
        out = ref.new_empty(shape)
        for c, p in zip(coords, pieces):
            if any(c[k] for k in free):  # a replicated axis's first coordinate only
                continue
            view = out
            for d, start, size in _slices(tuple(shape), spec, mesh, c):
                view = view.narrow(d, start, size)
            view.copy_(p.to(out.device))
        return out

    return tree_map(lambda first, spec, *rest: whole(spec, first, *rest), shares[0], specs,
                    *shares[1:])


def context_rules(mc: MeshContext) -> ShardingRules:
    """The `ShardingRules` a mesh context was made from."""
    fsdp = tuple(mc.fsdp_axes)
    return ShardingRules(mesh=mc.mesh, dp_axes=tuple(mc.dp_axes), model_axis=mc.model_axis,
                         fsdp_axes=fsdp or ("data",), fsdp=bool(fsdp))


def to_shares(tree, specs, mc: MeshContext) -> list:
    """One tree a coordinate of ``mc.coords``: the coordinate's pieces
    (views), on its device. A coordinate's share (``mc.coord`` set) is
    the tree it was given."""
    if mc.coord is not None:
        return [tree]
    plan = _plan(tree, specs, mc.mesh)
    return [_pieces(plan, mc.mesh, c, mc.mesh.device(c)) for c in mc.coords]


def from_shares(shares: Sequence[Any], specs, mc: MeshContext):
    """The whole tree from a full grid's shares (`unshard`); a
    coordinate's share: its own pieces."""
    if mc.coord is not None:
        return shares[0]
    return unshard(shares, specs, mc.mesh, mc.coords)


def sync_grads(grads, specs, mc: MeshContext):
    """A coordinate's gradient pieces summed over the grid axes its
    parameter is replicated on (the FSDP axes were summed by the
    reduce-scatter in the all-gather's backward): the lone all-reduces of
    the reference's data-parallel gradient sync. Only a coordinate's
    share needs it: on a full grid the pieces are views of one tree, and
    autograd adds them."""
    def one(g, spec):
        named = {ax for e in spec for ax in axes_of(e)}
        axes = tuple(ax for ax in mc.mesh.axis_names if ax not in named)
        return psum([g], axes, mc)[0]

    return tree_map(one, grads, specs)


# --------------------------------------------------------------------------
# Stream-parallel serving fleet (KWS)
# --------------------------------------------------------------------------

def _canonical(device) -> torch.device:
    """``device`` resolved (a CUDA device needs a card) and, for CUDA,
    with its index, so equal placements compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def stream_devices(devices: Union[int, Sequence[Any], None] = None) -> List[torch.device]:
    """The shard devices of a stream-parallel server.

    devices: an int (the first N visible CUDA devices), a sequence of
    devices (``torch.device`` or strings; entries may repeat, one shard
    each), or None for every visible CUDA device. An int larger than the
    visible device count raises, as does a mix of device types: serving
    capacity planning must not silently degrade.
    """
    if devices is None or isinstance(devices, int):
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = visible if devices is None else devices
        if want < 1 or want > visible:
            raise ValueError(
                f"stream_devices(devices={devices}) but only {visible} "
                "device(s) visible"
            )
        return [torch.device("cuda", i) for i in range(want)]
    devs = [_canonical(d) for d in devices]
    if not devs:
        raise ValueError("stream_devices: the device list is empty")
    if len({d.type for d in devs}) > 1:
        raise ValueError(
            f"stream_devices: every shard must be on one device type; got "
            f"{[str(d) for d in devs]}"
        )
    return devs


def surviving_devices(devices: Sequence[torch.device], lost_index: int) -> list:
    """The shard devices minus the lost shard's entry, in shard order: the
    pool a shard-loss recovery rebuilds its (smaller) fleet from
    (`StreamingKWSServer.recover_shard_loss` hands it to
    `ElasticMeshManager`, whose power-of-two shrink takes a prefix)."""
    devs = list(devices)
    if not 0 <= lost_index < len(devs):
        raise ValueError(
            f"lost_index {lost_index} outside mesh of {len(devs)} device(s)"
        )
    return [d for i, d in enumerate(devs) if i != lost_index]
