"""End-to-end KWS pipeline assembly (Fig. 3): FEx -> classifier.

Counterpart of `repro.core.pipeline`. Both stages are string-keyed
backends: `KWSPipelineConfig.frontend` names a registered
`repro_torch.core.frontend.FeatureFrontend` ("software", "hardware",
"hardware-pallas") and `KWSPipelineConfig.classifier` a registered
`repro_torch.core.classifier.ClassifierBackend` ("float", "qat",
"integer", "delta", "delta-int"; the ΔGRU thresholds come from
`KWSPipelineConfig.delta`). `KWSPipelineConfig.cascade` binds the
stage-1 wake gate (`repro_torch.serving.cascade.CascadeConfig`), which
only the serving tick reads.

Every feature entry point routes through the frontend:

  features(audio, state)                batch audio -> (FV_Norm, FV_Raw)
  record_features(audio, state)         FV_Raw recorded in batches (the
                                        Section III-F flow: features are
                                        recorded from the chip once, then
                                        the classifier trains on them)
  streaming_features_step(carry, chunk) one 16 ms raw-audio hop -> one
                                        FV_Norm frame per stream
  streaming_step(params, states, fv_t)  one GRU step per 16 ms frame

and the classifier side: `logits` (final frame), `logits_all_frames`
and `predict` (audio -> class, `features` then `logits`).

On a CUDA tensor the batch features run the port's kernels: K1 for
"software", the K1 scan entry and K5 for "hardware-pallas", the scan
entry and the cumulative-phase TDC (PyTorch, as in the reference) for
"hardware". Frontend parameters (norm stats, chip mismatch, beta/alpha,
filterbank coefficients) live in one `FrontendState`, built by
`init_frontend_state` or `repro_torch.core.calibration`. The reference's
deprecated shims ``features_software`` and ``record_features_hardware``
are not ported.

The FV_Raw -> FV_Norm post-processing (log ROM, (x-mu)/sigma, Q6.8) is
the chip's digital back-end and is shared by every frontend.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.classifier import (
    ClassifierBackend,
    get_classifier,
    resolve_classifier_key,
)
from repro_torch.core.fex import FExConfig, FExNormStats
from repro_torch.core.frontend import FeatureFrontend, FrontendState, get_frontend
from repro_torch.core.gru import GRUConfig, init_gru_classifier
from repro_torch.core.gru_delta import DeltaConfig
from repro_torch.core.tdfex import TDFExConfig
from repro_torch.kernels.build import resolve_device
from repro_torch.serving.cascade import CascadeConfig

__all__ = ["KWSPipelineConfig", "KWSPipeline"]


@dataclasses.dataclass(frozen=True)
class KWSPipelineConfig:
    frontend: str = "software"  # registered FeatureFrontend key
    fex: FExConfig = dataclasses.field(default_factory=FExConfig)
    gru: GRUConfig = dataclasses.field(default_factory=GRUConfig)
    # Hardware-sim parameters of the "hardware*" frontends; None ->
    # TDFExConfig built around `fex` (the paper's nominal chip).
    tdfex: Optional[TDFExConfig] = None
    use_log: bool = True
    use_norm: bool = True
    # Registered ClassifierBackend key ("float" / "qat" / "integer" /
    # "delta" / "delta-int"); None resolves from gru.quantized.
    classifier: Optional[str] = None
    # ΔGRU thresholds for the "delta" / "delta-int" backends (None: θ = 0).
    delta: Optional[DeltaConfig] = None
    # Stage-1 wake cascade for the serving tick
    # (`repro_torch.serving.cascade.CascadeConfig`): a detector on the
    # feature frame gates the classifier per stream. None -> no gate;
    # `CascadeConfig.always_on()` equals None for every backend. Read
    # only by the serving layer; batch `features` / `logits` ignore it.
    cascade: Optional[CascadeConfig] = None

    def __post_init__(self):
        # the pipeline post-processes (and shapes hops) with `fex` while
        # the hardware frontends generate features with `tdfex.fex`
        if self.tdfex is not None and self.tdfex.fex != self.fex:
            raise ValueError(
                "KWSPipelineConfig.fex and KWSPipelineConfig.tdfex.fex "
                "disagree; pass tdfex=TDFExConfig(fex=your_fex, ...)"
            )

    @property
    def tdfex_config(self) -> TDFExConfig:
        return self.tdfex if self.tdfex is not None else TDFExConfig(fex=self.fex)

    @property
    def classifier_key(self) -> str:
        return resolve_classifier_key(self.classifier, self.gru)


class KWSPipeline:
    """Stateless-functional pipeline with convenience wrappers.

    A `FrontendState` may be bound at construction (the default for
    every call) or passed per call; methods never mutate it. Tensors
    stay on the device they come in on; the creating entry points
    (`init_params`, `streaming_init`, `streaming_features_init`) take a
    ``device`` that defaults to the card.
    """

    def __init__(
        self,
        config: KWSPipelineConfig,
        state: Optional[FrontendState] = None,
        norm_stats: Optional[FExNormStats] = None,
    ):
        self.config = config
        self.frontend: FeatureFrontend = get_frontend(config.frontend)
        # with_config binds the ΔGRU thresholds of config.delta; dense
        # backends return the registry singleton unchanged
        self.classifier: ClassifierBackend = get_classifier(
            config.classifier_key
        ).with_config(config)
        if state is None:
            state = FrontendState()
        if norm_stats is not None:
            state = state.with_norm_stats(norm_stats)
        self.state = state
        # memo for prepare_params: (params object, prepared form); the
        # strong reference keeps the key's id() from being recycled
        self._prepared = None

    @property
    def norm_stats(self) -> Optional[FExNormStats]:
        """The bound frontend state's FV_Log normalizer statistics."""
        return self.state.norm_stats

    def _resolve(self, state: Optional[FrontendState]) -> FrontendState:
        return self.state if state is None else state

    # ---------- frontend state ----------

    def init_frontend_state(
        self, generator: Optional[torch.Generator] = None, device=None, **kwargs
    ) -> FrontendState:
        """This frontend's state on ``device`` (the card by default): for
        the hardware paths a chip drawn from ``generator`` (``mismatch``)
        and its beta / alpha calibration (``calibrate``); a shell for
        "software". Bound norm stats carry over unless given."""
        kwargs.setdefault("norm_stats", self.state.norm_stats)
        return self.frontend.init_state(
            self.config, generator=generator, device=device, **kwargs
        )

    def with_state(self, state: FrontendState) -> "KWSPipeline":
        """A copy of this pipeline with ``state`` bound as the default."""
        return KWSPipeline(self.config, state=state)

    # ---------- features ----------

    def features(
        self,
        audio: torch.Tensor,
        state: Optional[FrontendState] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """audio (B, T) -> (fv_norm (B, F, C), fv_raw codes), through the
        configured frontend, on the audio's device. ``generator`` draws
        the hardware frontends' noise (None: noiseless)."""
        state = self._resolve(state)
        fv_raw = self.frontend.raw_codes(audio, self.config, state, generator=generator)
        return self._postprocess(fv_raw, state), fv_raw

    def record_features(
        self,
        audio: np.ndarray,
        state: Optional[FrontendState] = None,
        generator: Optional[torch.Generator] = None,
        batch_size: int = 64,
        device=None,
    ) -> np.ndarray:
        """FV_Raw codes of host audio (B, T), recorded on ``device`` (the
        card by default) in batches of ``batch_size`` and returned as one
        host array (Section III-F). Works for every frontend; the
        hardware paths draw their per-record noise from ``generator``."""
        device = resolve_device(device)
        state = self._resolve(state)
        outs = []
        for i in range(0, audio.shape[0], batch_size):
            chunk = torch.as_tensor(np.asarray(audio[i : i + batch_size], np.float32),
                                    device=device)
            raw = self.frontend.raw_codes(chunk, self.config, state, generator=generator)
            outs.append(raw.cpu().numpy())
        return np.concatenate(outs, axis=0)

    def _postprocess(self, fv_raw: torch.Tensor, state: FrontendState) -> torch.Tensor:
        """FV_Raw codes -> FV_Norm: the chip's digital back-end (log ROM,
        normalizer, Q6.8 saturation), shared by every frontend."""
        x = fv_raw
        fexc = self.config.fex
        if self.config.use_log:
            x = quant.log_compress_lut(x, fexc.quant_bits, fexc.log_bits)
        if self.config.use_norm:
            if state.norm_stats is None:
                raise ValueError("use_norm requires fitted norm_stats")
            x = (x - state.norm_stats.mu) / state.norm_stats.sigma
        else:
            in_bits = fexc.log_bits if self.config.use_log else fexc.quant_bits
            x = x * 2.0 ** -(in_bits - 5)
        return quant.fake_quant(x, quant.ACT_Q6_8)

    def features_from_raw(
        self, fv_raw: torch.Tensor, state: Optional[FrontendState] = None
    ) -> torch.Tensor:
        """Post-processing only: recorded FV_Raw codes -> FV_Norm."""
        return self._postprocess(fv_raw, self._resolve(state))

    # ---------- classifier ----------

    def init_params(
        self, generator: Optional[torch.Generator] = None, device=None
    ) -> Dict[str, Any]:
        """Float training params from ``generator``, on ``device`` (the
        card by default); `prepare_params` converts for the backend."""
        return init_gru_classifier(
            self.config.gru, generator, resolve_device(device)
        )

    def prepare_params(self, params):
        """Float params -> whatever the configured backend consumes
        (`QuantizedClassifier` codes for ``classifier="integer"``).
        Idempotent, and memoized by parameter identity so per-frame
        callers do not re-quantize every 16 ms tick."""
        if self._prepared is not None and self._prepared[0] is params:
            return self._prepared[1]
        prepared = self.classifier.prepare(params, self.config.gru)
        self._prepared = (params, prepared)
        return prepared

    def logits(self, params, fv_norm: torch.Tensor) -> torch.Tensor:
        """(B, F, C) -> final-frame logits (B, K)."""
        return self.logits_all_frames(params, fv_norm)[:, -1, :]

    def logits_all_frames(self, params, fv_norm: torch.Tensor) -> torch.Tensor:
        """(B, F, C) -> logits of every frame (B, F, K), through the
        configured backend (K2 on the card for integer and delta-int)."""
        return self.classifier.forward(
            self.prepare_params(params), fv_norm, self.config.gru
        )

    def predict(
        self,
        params,
        audio: torch.Tensor,
        state: Optional[FrontendState] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """audio (B, T) -> the class of each clip's final frame (B,) int64:
        `features`, then the argmax of `logits`, on the audio's device."""
        fv_norm, _ = self.features(audio, state, generator)
        return torch.argmax(self.logits(params, fv_norm), dim=-1)

    # ---------- streaming serving ----------

    @property
    def chunk_samples(self) -> int:
        """Raw-audio samples per 16 ms streaming hop (at fs_audio)."""
        fexc = self.config.fex
        return int(round(fexc.fs_audio * fexc.frame_shift_ms / 1000.0))

    def streaming_init(self, batch: int, device=None):
        """Classifier state for a batch of streams: per-layer float32 for
        float / qat, int32 Q6.8 codes for integer, per-layer dicts for
        delta / delta-int."""
        return self.classifier.init_states(
            self.config.gru, batch, resolve_device(device)
        )

    def streaming_step(self, params, states, fv_t: torch.Tensor):
        """One 16 ms frame for a batch of streams -> (states, logits)."""
        return self.classifier.step(
            self.prepare_params(params), states, fv_t, self.config.gru
        )

    def streaming_features_init(self, batch: int, device=None):
        """Frontend carry (filter state) for ``batch`` streams."""
        return self.frontend.streaming_init(
            self.config, batch, resolve_device(device)
        )

    def streaming_features_apply(
        self, carry, chunk: torch.Tensor, state: FrontendState,
        generator: Optional[torch.Generator] = None,
    ):
        """One raw hop (B, chunk_samples) -> (carry, fv_norm (B, C)); the
        serving tick's plain frontend phase."""
        carry, fv_raw = self.frontend.streaming_step(
            chunk, self.config, state, carry, generator=generator
        )
        return carry, self._postprocess(fv_raw, state)

    def streaming_features_step(
        self,
        carry,
        chunk: torch.Tensor,
        state: Optional[FrontendState] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """One raw-audio hop (B, chunk_samples) -> (carry, fv_norm (B, C)).

        Feed consecutive 16 ms hops; the carry holds the per-stream
        filter (and SRO phase) state, so the concatenated stream matches
        the batch `features` path up to the chunk-edge oversampler."""
        return self.streaming_features_apply(
            carry, chunk, self._resolve(state), generator
        )

    def streaming_logits_apply(self, params, states, fv_t: torch.Tensor):
        """`streaming_step` on already backend-shaped ``params``."""
        return self.classifier.step(params, states, fv_t, self.config.gru)
