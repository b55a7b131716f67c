"""Pluggable classifier backends for the KWS pipeline.

Counterpart of `repro.core.classifier`: every way of evaluating the
GRU-FC network is a `ClassifierBackend` registered under a string key,
selected via `KWSPipelineConfig.classifier`. This slice ports

  "qat"     — the quantization-aware fake-quant forward of
              `repro_torch.core.gru` (the default inference path);
  "integer" — the bit-exact integer engine of `repro_torch.core.gru_int`
              over int8/int32 codes, matmuls through the `intgemm`
              kernel; bit-identical to "qat" on the same parameters.

"float", "delta" and "delta-int" are ported by later slices and raise
`NotImplementedError` naming the slice.

The backend boundary speaks float FV_Norm frames in and float logits out
for every backend; the integer backend converts at the boundary (exact
in both directions for on-grid inputs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import gru_int
from repro_torch.core.gru import (
    GRUConfig,
    gru_classifier_forward,
    gru_classifier_step,
    init_states,
)
from repro_torch.serving.quantize import quantize_classifier

__all__ = [
    "ClassifierBackend",
    "register_classifier",
    "get_classifier",
    "available_classifiers",
    "resolve_classifier_key",
    "QATClassifier",
    "IntegerClassifier",
]


class ClassifierBackend:
    """One execution path of the GRU-FC classifier.

    Implementations are stateless singletons. Subclasses implement:

      prepare(params, cfg)        float params -> the form this backend
                                  consumes (idempotent)
      init_states(cfg, batch, device)
                                  per-layer hidden state tensors
      forward(params, fv, cfg)    (B, T, C) FV_Norm -> (B, T, K) logits
      step(params, states, fv_t, cfg)
                                  one frame (B, C) -> (states, (B, K))
    """

    name: str = "?"

    def prepare(self, params: Any, cfg: GRUConfig) -> Any:
        return params

    def init_states(self, cfg: GRUConfig, batch: int, device) -> List[torch.Tensor]:
        raise NotImplementedError

    def forward(self, params, fv: torch.Tensor, cfg: GRUConfig):
        raise NotImplementedError

    def step(self, params, states, fv_t: torch.Tensor, cfg: GRUConfig):
        raise NotImplementedError


_REGISTRY: Dict[str, ClassifierBackend] = {}

# Backends of the reference that later slices port (ROADMAP queue 1).
_LATER = {
    "float": "\"Float classifier backend\"",
    "delta": "\"ΔGRU backends\"",
    "delta-int": "\"ΔGRU backends\"",
}


def register_classifier(name: str):
    """Class decorator: instantiate + register under ``name``."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls

    return deco


def get_classifier(name: str) -> ClassifierBackend:
    if name in _LATER:
        raise NotImplementedError(
            f"classifier {name!r} is ported in a later slice: ROADMAP "
            f"queue 1, {_LATER[name]}"
        )
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown classifier {name!r}; registered classifiers: "
            f"{sorted(_REGISTRY)}"
        ) from None


def available_classifiers() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_classifier_key(classifier: Optional[str], gru: GRUConfig) -> str:
    """None -> "qat" when ``gru.quantized`` else "float". Explicit keys win."""
    if classifier is not None:
        return classifier
    return "qat" if gru.quantized else "float"


@register_classifier("qat")
class QATClassifier(ClassifierBackend):
    """QAT fake-quant forward (8-bit weights, Q6.8 activations)."""

    @staticmethod
    def _cfg(cfg: GRUConfig) -> GRUConfig:
        return cfg if cfg.quantized else dataclasses.replace(cfg, quantized=True)

    def init_states(self, cfg, batch, device):
        return init_states(cfg, batch, device)

    def forward(self, params, fv, cfg):
        return gru_classifier_forward(params, fv, self._cfg(cfg))

    def step(self, params, states, fv_t, cfg):
        return gru_classifier_step(params, states, fv_t, self._cfg(cfg))


@register_classifier("integer")
class IntegerClassifier(ClassifierBackend):
    """Bit-exact integer engine over `QuantizedClassifier` codes.

    `prepare` quantizes float params once (idempotent); `forward`/`step`
    quantize the FV_Norm input to Q6.8 codes at entry and dequantize
    logit codes at exit. Hidden states are int32 Q6.8 code tensors.
    """

    def prepare(self, params, cfg):
        if isinstance(params, gru_int.QuantizedClassifier):
            return params
        return quantize_classifier(params, cfg)

    def init_states(self, cfg, batch, device):
        return gru_int.int_init_states(cfg, batch, device)

    def forward(self, params, fv, cfg):
        self._check_prepared(params)
        codes = gru_int.int_gru_classifier_forward(
            params, gru_int.quantize_acts(fv), cfg
        )
        return gru_int.dequantize_acts(codes)

    def step(self, params, states, fv_t, cfg):
        self._check_prepared(params)
        states, codes = gru_int.int_gru_classifier_step(
            params, states, gru_int.quantize_acts(fv_t), cfg
        )
        return states, gru_int.dequantize_acts(codes)

    @staticmethod
    def _check_prepared(params):
        if not isinstance(params, gru_int.QuantizedClassifier):
            raise TypeError(
                "integer classifier needs QuantizedClassifier params; "
                "call pipeline.prepare_params(params) (or "
                "repro_torch.serving.quantize.quantize_classifier) first"
            )
