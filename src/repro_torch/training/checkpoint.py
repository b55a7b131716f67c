"""Versioned, atomic, async-capable checkpointing.

Counterpart of `repro.training.checkpoint`, in its on-disk format, so a
checkpoint written by either package restores in the other:
``<dir>/step_<N>/`` holds one ``.npy`` of raw bytes (uint8) per leaf and
a ``manifest.json`` (step, and per leaf its name, file, shape, dtype
string and crc32). Writes go to ``step_<N>.tmp`` and are renamed only
after the manifest is fsynced, so a partly written checkpoint is never
visible.

A state tree here is nested dicts, tuples, lists and dataclasses of
torch tensors, numpy arrays or Python scalars (None is an empty
subtree). It flattens in the reference's order and to its leaf names:
dict keys sorted, sequences by index, dataclass fields in declaration
order as ``.field``, joined by ``/`` (``.gru/0``, ``.carry/s1``). The
dtype strings are numpy's (``float32``, ``int32``, ``bool``), and
bfloat16, which numpy lacks, is stored as ``bfloat16`` by its raw bytes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint"]

Tree = Any

# torch dtypes numpy has no name for, stored by their raw bytes through
# an integer view of the same width
_RAW = {"bfloat16": (torch.bfloat16, torch.int16)}


def _children(tree: Tree) -> Optional[List[Tuple[str, Any]]]:
    """(name, subtree) pairs of an inner node in the reference's order;
    None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def _flatten_with_names(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    children = _children(tree)
    if children is None:
        return [(prefix, tree)]
    out = []
    for name, sub in children:
        out += _flatten_with_names(sub, f"{prefix}/{name}" if prefix else name)
    return out


def _unflatten(template: Tree, leaves) -> Tree:
    """``template``'s structure with its leaves taken from the iterator
    ``leaves``, in `_flatten_with_names` order."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves) for v in template)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    return next(leaves)


def _host_bytes(leaf) -> Tuple[np.ndarray, str, List[int]]:
    """(raw uint8 bytes, dtype string, shape) of one leaf, on the host."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu").contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name in _RAW:
            t = t.view(_RAW[name][1])
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(leaf))
        name = str(arr.dtype)
    return np.frombuffer(arr.tobytes(), np.uint8), name, list(arr.shape)


def save_checkpoint(
    directory: str,
    step: int,
    tree: Tree,
    keep: int = 3,
    async_save: bool = False,
) -> Optional[threading.Thread]:
    """Atomically write ``tree`` at ``step``; prune to the newest ``keep``.
    The leaves are copied to the host before any thread starts, so the
    caller may change them as soon as this returns."""
    leaves = [(name, *_host_bytes(leaf)) for name, leaf in _flatten_with_names(tree)]

    def _write():
        final = os.path.join(directory, f"step_{step:09d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest: Dict[str, Any] = {"step": step, "leaves": []}
        for i, (name, raw, dtype, shape) in enumerate(leaves):
            fn = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fn), raw)
            manifest["leaves"].append({
                "name": name, "file": fn, "shape": shape, "dtype": dtype,
                "crc": zlib.crc32(raw.tobytes()) & 0xFFFFFFFF,
            })
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _prune(directory, keep)

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _prune(directory: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def _leaf(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype in _RAW:
        return torch.from_numpy(raw.copy()).view(_RAW[dtype][0]).reshape(shape)
    return torch.from_numpy(raw.view(np.dtype(dtype)).reshape(shape).copy())


def restore_checkpoint(
    directory: str,
    template: Tree,
    step: Optional[int] = None,
    device=None,
    verify: bool = True,
) -> Tuple[Tree, int]:
    """Load a checkpoint into ``template``'s structure; returns (tree,
    step). Leaves are torch tensors: on ``device`` when given, else on
    the device of the template's tensor in that place, else on the host.
    ``step`` defaults to the newest; ``verify`` checks each leaf's crc32."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    places = [
        leaf.device if torch.is_tensor(leaf) else torch.device("cpu")
        for _, leaf in _flatten_with_names(template)
    ]
    if len(places) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint at step {step} has {len(manifest['leaves'])} leaves; "
            f"the template has {len(places)}"
        )
    leaves = []
    for entry, place in zip(manifest["leaves"], places):
        raw = np.load(os.path.join(path, entry["file"]))
        if verify:
            crc = zlib.crc32(raw.tobytes()) & 0xFFFFFFFF
            if crc != entry["crc"]:
                raise IOError(
                    f"checksum mismatch in {entry['name']} at step {step}"
                )
        t = _leaf(raw, entry["dtype"], entry["shape"])
        leaves.append(t.to(place if device is None else device))
    return _unflatten(template, iter(leaves)), step
