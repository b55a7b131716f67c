"""AdamW with optional int8 moments, and the paper's schedules.

Counterpart of `repro.training.optimizer`. The paper trains its GRU with
AdamW (lr 1e-3, wd 0.01) and ReduceLROnPlateau (factor 0.8, patience 3,
min lr 5e-4), Section III-F; `cosine_schedule` is the LM steps' schedule.

Parameters, gradients and moments are trees of nested dicts, lists and
tuples of tensors. The optimizer state has the reference's tree,
``{"step": int32 scalar, "m": ..., "v": ...}``, with the moments shaped
like the parameters, so a checkpoint of ``(params, opt)`` written by
either package restores in the other (`repro_torch.training.checkpoint`).

int8 moments (``state_dtype="int8"``) are quantized per last-dim row for
leaves of two or more dimensions and at least ``_INT8_MIN_SIZE``
elements: ``{"q": int8 codes shaped like the parameter, "s": float32
scale a row}``. The first moment is signed absmax; the second is stored
in sqrt space (unsigned codes offset by 127), which bounds the error of
the update's denominator where linear codes would zero small entries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

__all__ = [
    "AdamWConfig",
    "init_opt_state",
    "global_norm",
    "adamw_update",
    "tree_map",
    "cosine_schedule",
    "ReduceLROnPlateau",
]

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # float32 | int8


_INT8_MIN_SIZE = 4096


def _leaves(tree: Tree) -> list:
    """The leaves in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` (nested dicts, lists, tuples),
    with the subtrees of ``rest`` in the same places: a tree shaped like
    ``tree``. A subtree of ``rest`` reaches ``fn`` whole where ``tree``
    has a leaf (so an int8 moment ``{"q", "s"}`` does)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as the reference's: the
    vectorized CPU ``torch.sqrt`` is off by an ulp on ~0.6 % of inputs.
    The float64 root of a float32 rounds to float32 correctly."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _use_int8(p: torch.Tensor) -> bool:
    return p.dim() >= 2 and p.numel() >= _INT8_MIN_SIZE


def _quant_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed absmax int8 a last-dim row (the first moment)."""
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequant_rowwise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _quant_sqrt_rowwise(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unsigned sqrt-space codes, offset into int8 (the second moment)."""
    r = _sqrt(torch.clamp(v, min=0.0))
    scale = torch.amax(r, dim=-1, keepdim=True) / 254.0 + 1e-20
    q = torch.clamp(torch.round(r / scale) - 127, -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequant_sqrt_rowwise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    r = (q.to(torch.float32) + 127.0) * scale
    return r * r


def init_opt_state(params: Tree, cfg: AdamWConfig) -> Tree:
    """Zero moments shaped like ``params`` on their devices, and step 0
    (an int32 scalar on the first leaf's device)."""

    def zeros_like_moment(p):
        if cfg.state_dtype == "int8" and _use_int8(p):
            return {
                "q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                "s": torch.zeros(p.shape[:-1] + (1,), dtype=torch.float32, device=p.device),
            }
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = _leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(zeros_like_moment, params),
        "v": tree_map(zeros_like_moment, params),
    }


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, the leaves
    added in the reference's order."""
    total = 0
    for leaf in _leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return _sqrt(total)


@torch.no_grad()
def adamw_update(
    params: Tree,
    grads: Tree,
    state: Tree,
    cfg: AdamWConfig,
    lr=None,
) -> Tuple[Tree, Tree, dict]:
    """One AdamW step. Params may be bf16 (updated in float32, cast back);
    moments float32 or int8 rows. The gradient is scaled by
    ``min(1, grad_clip / (global_norm + 1e-9))`` first. Returns (params,
    state, {"grad_norm": ...}); nothing given is changed in place."""
    lr = cfg.lr if lr is None else lr
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** stepf
    bc2 = 1.0 - cfg.b2 ** stepf

    def update_leaf(p, g, m, v):
        g32 = g.to(torch.float32) * clip
        quantized = isinstance(m, dict)
        if quantized:
            m32 = _dequant_rowwise(m["q"], m["s"])
            v32 = _dequant_sqrt_rowwise(v["q"], v["s"])
        else:
            m32, v32 = m, v
        m32 = cfg.b1 * m32 + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v32 + (1 - cfg.b2) * g32 * g32
        mhat = m32 / bc1
        vhat = v32 / bc2
        p32 = p.to(torch.float32)
        upd = mhat / (_sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        p_new = (p32 - lr * upd).to(p.dtype)
        if quantized:
            mq, ms = _quant_rowwise(m32)
            vq, vs = _quant_sqrt_rowwise(v32)
            return p_new, {"q": mq, "s": ms}, {"q": vq, "s": vs}
        return p_new, m32, v32

    out = tree_map(update_leaf, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
    new_state = {"step": step, "m": pick(1), "v": pick(2)}
    return pick(0), new_state, {"grad_norm": gnorm}


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """step -> lr: linear warm-up over ``warmup`` steps, then a half
    cosine from ``base_lr`` to 0 at ``total``, in float32."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return lr


class ReduceLROnPlateau:
    """Host-side scheduler of the paper's recipe (factor 0.8, patience 3
    epochs, floor 5e-4)."""

    def __init__(self, lr: float = 1e-3, factor: float = 0.8,
                 patience: int = 3, min_lr: float = 5e-4):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best - 1e-6:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr
