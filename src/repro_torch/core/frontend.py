"""Pluggable feature-extraction frontends for the KWS pipeline.

PyTorch counterpart of `repro.core.frontend`. Every way of turning raw
audio into FV_Raw quantizer codes is a `FeatureFrontend` registered
under a string key. This slice ports ``"software"``, the Section II
model; the hardware frontends arrive with their own slice (ROADMAP
queue 1, "Hardware frontends"), and until then the registry names only
what it holds.

Streaming: a frontend exposes a chunked step that consumes one 16 ms
raw-audio hop per call and carries the filter state across calls. The
only deviation from the batch path is at chunk edges: the 2x
linear-interpolation oversampler needs one sample of lookahead, which
streaming replaces with edge replication.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import quant
from repro_torch.core.fex import (
    FExNormStats,
    biquad_filterbank_frame_mean,
    biquad_filterbank_streaming,
    fex_frames,
    frame_average,
    oversample2x,
)

__all__ = [
    "FrontendState",
    "FeatureFrontend",
    "register_frontend",
    "get_frontend",
    "available_frontends",
    "masked_select",
    "tree_leaves",
    "tree_clone",
    "SoftwareFrontend",
]


def masked_select(mask: torch.Tensor, new_tree: Any, old_tree: Any) -> Any:
    """Per-stream select over matching trees of tensors (dict, tuple, list
    or a bare tensor): leaves lead with the stream axis, and stream ``i``
    takes ``new`` where ``mask[i]`` else keeps ``old``.

    This is how a batched streaming carry (or GRU state / score buffer)
    advances only for streams that submitted a frame this tick: an idle
    stream's state is bit-identical before and after the tick.
    """
    if isinstance(new_tree, dict):
        return {k: masked_select(mask, new_tree[k], old_tree[k]) for k in new_tree}
    if isinstance(new_tree, (tuple, list)):
        return type(new_tree)(
            masked_select(mask, n, o) for n, o in zip(new_tree, old_tree)
        )
    m = mask.reshape(mask.shape + (1,) * (new_tree.dim() - mask.dim()))
    return torch.where(m, new_tree, old_tree)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree (dict, tuple, list or a bare tensor) in the
    order `masked_select` walks it: a dense classifier state's per-layer
    tensors or a ΔGRU state's per-layer dicts alike."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_clone(tree: Any) -> Any:
    """A copy of a tree of tensors with every leaf cloned."""
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_clone(v) for v in tree)
    return tree.clone()


@dataclasses.dataclass(frozen=True)
class FrontendState:
    """Everything a frontend needs beyond the static config.

    norm_stats — mu/sigma of FV_Log over the training set (Section III-F);
                 required whenever the pipeline's ``use_norm`` is on.
    coeffs     — stacked (5, C) biquad coefficients; None -> the nominal
                 filterbank of ``cfg.fex``.
    """

    norm_stats: Optional[FExNormStats] = None
    coeffs: Optional[torch.Tensor] = None

    def with_norm_stats(self, norm_stats: Optional[FExNormStats]):
        return dataclasses.replace(self, norm_stats=norm_stats)


class FeatureFrontend:
    """One feature path: raw audio -> FV_Raw quantizer codes.

    Implementations are stateless singletons. Subclasses implement:

      raw_codes(audio, cfg, state)          -> (B, F, C) FV_Raw codes
      streaming_init(cfg, batch, device)    -> carry dict of tensors
      streaming_step(chunk, cfg, state, carry)
                                            -> (carry, (B, C) FV_Raw frame)

    ``cfg`` is the `KWSPipelineConfig`.
    """

    name: str = "?"

    def raw_codes(self, audio, cfg, state) -> torch.Tensor:
        raise NotImplementedError

    def streaming_init(self, cfg, batch: int, device) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def streaming_step(
        self, chunk, cfg, state, carry
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        raise NotImplementedError


_REGISTRY: Dict[str, FeatureFrontend] = {}


def register_frontend(name: str):
    """Class decorator: instantiate + register under ``name``."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls

    return deco


def get_frontend(name: str) -> FeatureFrontend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown frontend {name!r}; registered frontends: "
            f"{sorted(_REGISTRY)}"
        ) from None


def available_frontends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _chunk_to_internal(chunk: torch.Tensor, fexc) -> torch.Tensor:
    """One raw-audio hop (B, S @ fs_audio) -> internal rate (B, frame_len),
    with edge-replicated 2x oversampling."""
    if fexc.oversample == 2:
        chunk = oversample2x(chunk)
    return chunk


def _nominal_coeffs(cfg, state: Optional[FrontendState], device) -> torch.Tensor:
    if state is not None and state.coeffs is not None:
        return state.coeffs
    return cfg.fex.filterbank().stacked(device=device)


@register_frontend("software")
class SoftwareFrontend(FeatureFrontend):
    """Voltage-domain model: BPF -> |.| -> frame mean -> 12-bit quantizer."""

    def raw_codes(self, audio, cfg, state):
        fexc = cfg.fex
        if state is not None and state.coeffs is not None:
            x = oversample2x(audio) if fexc.oversample == 2 else audio
            y, _ = biquad_filterbank_streaming(x, state.coeffs)
            frames = frame_average(torch.abs(y), fexc.frame_len)
        else:
            frames = fex_frames(audio, fexc)
        return quant.quantize_unsigned(
            frames, fexc.quant_bits, fexc.quant_full_scale
        )

    def streaming_init(self, cfg, batch, device):
        c = cfg.fex.num_channels
        z = lambda: torch.zeros((batch, c), dtype=torch.float32, device=device)  # noqa: E731
        return {"s1": z(), "s2": z()}

    def streaming_step(self, chunk, cfg, state, carry):
        fexc = cfg.fex
        x = _chunk_to_internal(chunk, fexc)
        frame, (s1, s2) = biquad_filterbank_frame_mean(
            x, _nominal_coeffs(cfg, state, chunk.device), (carry["s1"], carry["s2"])
        )
        codes = quant.quantize_unsigned(
            frame, fexc.quant_bits, fexc.quant_full_scale
        )
        return {"s1": s1, "s2": s2}, codes
