"""Pluggable classifier backends for the KWS pipeline.

Counterpart of `repro.core.classifier`: every way of evaluating the
GRU-FC network is a `ClassifierBackend` registered under a string key,
selected via `KWSPipelineConfig.classifier`:

  "float"     — plain float32 forward of `repro_torch.core.gru`, no
                fake-quant anywhere (agrees with the reference within a
                tolerance only);
  "qat"       — the quantization-aware fake-quant forward of
                `repro_torch.core.gru` (the default inference path);
  "integer"   — the bit-exact integer engine of `repro_torch.core.gru_int`
                over int8/int32 codes, matmuls through the `intgemm`
                kernel; bit-identical to "qat" on the same parameters;
  "delta"     — the ΔGRU of `repro_torch.core.gru_delta` in the QAT
                float domain (θ = 0 is "qat" bit for bit);
  "delta-int" — the ΔGRU on the integer backend's codes (θ = 0 is
                "integer" bit for bit).

The backend boundary speaks float FV_Norm frames in and float logits out
for every backend; the integer backend converts at the boundary (exact
in both directions for on-grid inputs).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import gru_delta, gru_int
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
    "FloatClassifier",
    "QATClassifier",
    "IntegerClassifier",
    "DeltaClassifier",
    "DeltaIntClassifier",
]


class ClassifierBackend:
    """One execution path of the GRU-FC classifier.

    Implementations are stateless singletons (`with_config` may return a
    copy bound to pipeline-level config). Subclasses implement:

      prepare(params, cfg)        float params -> the form this backend
                                  consumes (idempotent)
      init_states(cfg, batch, device)
                                  per-layer hidden state tensors
      forward(params, fv, cfg)    (B, T, C) FV_Norm -> (B, T, K) logits
      step(params, states, fv_t, cfg)
                                  one frame (B, C) -> (states, (B, K))
    """

    name: str = "?"
    # True for the ΔGRU backends: per-layer state dicts with skip counters,
    # and the tick's sparse column update (K4)
    is_delta: bool = False

    def prepare(self, params: Any, cfg: GRUConfig) -> Any:
        return params

    def with_config(self, pipeline_config: Any) -> "ClassifierBackend":
        """The backend bound to pipeline-level config beyond the
        `GRUConfig` (the ΔGRU thresholds of `KWSPipelineConfig.delta`);
        dense backends return ``self``."""
        return self

    def init_states(self, cfg: GRUConfig, batch: int, device) -> List[torch.Tensor]:
        raise NotImplementedError

    def forward(self, params, fv: torch.Tensor, cfg: GRUConfig):
        raise NotImplementedError

    def step(self, params, states, fv_t: torch.Tensor, cfg: GRUConfig):
        raise NotImplementedError


_REGISTRY: Dict[str, ClassifierBackend] = {}


def register_classifier(name: str):
    """Class decorator: instantiate + register under ``name``."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls

    return deco


def get_classifier(name: str) -> ClassifierBackend:
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


class _FloatBase(ClassifierBackend):
    """Shared float-forward plumbing; `_cfg` pins the fake-quant mode."""

    _quantized: bool = True

    def _cfg(self, cfg: GRUConfig) -> GRUConfig:
        if cfg.quantized == self._quantized:
            return cfg
        return dataclasses.replace(cfg, quantized=self._quantized)

    def init_states(self, cfg, batch, device):
        return init_states(cfg, batch, device)

    def forward(self, params, fv, cfg):
        return gru_classifier_forward(params, fv, self._cfg(cfg))

    def step(self, params, states, fv_t, cfg):
        return gru_classifier_step(params, states, fv_t, self._cfg(cfg))


@register_classifier("float")
class FloatClassifier(_FloatBase):
    """Plain float32 forward: no fake-quant anywhere."""

    _quantized = False


@register_classifier("qat")
class QATClassifier(_FloatBase):
    """QAT fake-quant forward (8-bit weights, Q6.8 activations)."""

    _quantized = True


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


class _DeltaBase(ClassifierBackend):
    """Shared ΔGRU plumbing; subclasses pick the arithmetic domain.

    Instances carry their `gru_delta.DeltaConfig` (the registry singleton
    holds the θ = 0 default); `with_config` returns a copy bound to
    `KWSPipelineConfig.delta`. The per-layer state dicts thread through
    `init_states`, the server's state, `masked_select` and the slot reset
    like the dense backends' hidden states.
    """

    is_delta = True

    def __init__(self, delta: Optional[gru_delta.DeltaConfig] = None):
        self.delta = gru_delta.DeltaConfig() if delta is None else delta

    def with_config(self, pipeline_config):
        delta = getattr(pipeline_config, "delta", None)
        if delta is None or delta == self.delta:
            return self
        return type(self)(delta)

    def _thetas(self, cfg: GRUConfig):
        return self.delta.code_thresholds(cfg.num_layers)


@register_classifier("delta")
class DeltaClassifier(_DeltaBase):
    """ΔGRU in the QAT fake-quant float domain. Params stay float (like
    "qat"); state leaves are float32 grid values plus int32 counters."""

    def init_states(self, cfg, batch, device):
        return gru_delta.delta_init_states(cfg, batch, device)

    def forward(self, params, fv, cfg):
        return gru_delta.delta_classifier_forward(params, fv, cfg, self._thetas(cfg))

    def step(self, params, states, fv_t, cfg):
        return gru_delta.delta_classifier_step(
            params, states, fv_t, cfg, self._thetas(cfg)
        )


@register_classifier("delta-int")
class DeltaIntClassifier(_DeltaBase):
    """ΔGRU on the "integer" backend's codes: int8 weight codes through
    `intgemm`, int32 Q6.8 state and frac-15 accumulator codes, float
    FV_Norm / logits at the boundary like `IntegerClassifier`."""

    def prepare(self, params, cfg):
        return IntegerClassifier.prepare(self, params, cfg)

    def init_states(self, cfg, batch, device):
        return gru_delta.int_delta_init_states(cfg, batch, device)

    def forward(self, params, fv, cfg):
        IntegerClassifier._check_prepared(params)
        codes = gru_delta.int_delta_classifier_forward(
            params, gru_int.quantize_acts(fv), cfg, self._thetas(cfg)
        )
        return gru_int.dequantize_acts(codes)

    def step(self, params, states, fv_t, cfg):
        IntegerClassifier._check_prepared(params)
        states, codes = gru_delta.int_delta_classifier_step(
            params, states, gru_int.quantize_acts(fv_t), cfg, self._thetas(cfg)
        )
        return states, gru_int.dequantize_acts(codes)
