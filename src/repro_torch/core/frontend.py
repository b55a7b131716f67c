"""Pluggable feature-extraction frontends for the KWS pipeline.

PyTorch counterpart of `repro.core.frontend`. Every way of turning raw
audio into FV_Raw quantizer codes is a `FeatureFrontend` registered
under a string key, as in the reference:

  "software"        — the Section II voltage-domain model
                      (`repro_torch.core.fex`; on a CUDA tensor the
                      batch frames are the K1 kernel).
  "hardware"        — the Section III time-domain simulation
                      (`repro_torch.core.tdfex`): VTC, mismatched
                      Rec-BPF, SRO DeltaSigma TDC (cumulative-phase
                      form), beta/alpha calibration.
  "hardware-pallas" — the same chain with the TDC stage served by the
                      K5 kernel (`repro_torch.kernels.tdc`), named after
                      the reference's Pallas frontend.

All per-frontend parameters (norm stats, chip mismatch, beta/alpha,
filterbank coefficients) travel in one `FrontendState`.

Streaming: a frontend exposes a chunked step that consumes one 16 ms
raw-audio hop per call and carries the filter (and, for the hardware
frontends, the SRO phase) state across calls. The only deviation from
the batch path is at chunk edges: the 2x linear-interpolation
oversampler needs one sample of lookahead, which streaming replaces
with edge replication. The streaming steps are the serving tick's plain
versions; on the card the tick is the `tick_fused` kernel.
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
    biquad_scan,
    fex_frames,
    fma_f32,
    frame_sum,
    oversample2x,
)
from repro_torch.core.tdfex import (
    TDFExConfig,
    TDFExState,
    counts_to_fv_raw,
    design_mismatched_filterbank,
    draw_chip,
    sro_frequency,
    sro_tdc,
    vtc,
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
    "hardware_state",
    "streaming_tdc_scale",
    "SoftwareFrontend",
    "HardwareFrontend",
    "HardwarePallasFrontend",
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
    """The tensors of a tree (dict, tuple, list or a bare tensor; None,
    an absent subtree such as an ungated server's detector state, has
    none) in the order `masked_select` walks it: a dense classifier
    state's per-layer tensors or a ΔGRU state's per-layer dicts alike."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_clone(tree: Any) -> Any:
    """A copy of a tree of tensors with every leaf cloned (None stays)."""
    if tree is None:
        return None
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
    chip       — per-die mismatch realization (hardware frontends only).
    beta       — per-channel offset calibration: free-running SRO
                 counts per frame (Fig. 13's programmable subtractor).
    alpha      — per-channel gain calibration (Fig. 17a -> 17b).
    coeffs     — stacked (5, C) biquad coefficients, designed once (with
                 any cf mismatch) when the state is built; None -> the
                 nominal filterbank of ``cfg.fex``.

    Tensors lie on the device the frontend runs on.
    """

    norm_stats: Optional[FExNormStats] = None
    chip: Optional[TDFExState] = None
    beta: Optional[torch.Tensor] = None
    alpha: Optional[torch.Tensor] = None
    coeffs: Optional[torch.Tensor] = None

    def with_norm_stats(self, norm_stats: Optional[FExNormStats]):
        return dataclasses.replace(self, norm_stats=norm_stats)


class FeatureFrontend:
    """One feature path: raw audio -> FV_Raw quantizer codes.

    Implementations are stateless singletons. Subclasses implement:

      init_state(cfg, generator, norm_stats, device, ...)
                                            -> FrontendState
      raw_codes(audio, cfg, state, generator)
                                            -> (B, F, C) FV_Raw codes
      streaming_init(cfg, batch, device)    -> carry dict of tensors
      streaming_step(chunk, cfg, state, carry, generator)
                                            -> (carry, (B, C) FV_Raw frame)

    ``cfg`` is the `KWSPipelineConfig`; the hardware frontends read
    ``cfg.tdfex_config``. ``generator`` (a `torch.Generator`) draws the
    hardware frontends' noise; None is the noiseless chip.
    """

    name: str = "?"

    def init_state(self, cfg, generator=None, norm_stats=None, device=None, **kwargs):
        raise NotImplementedError

    def raw_codes(self, audio, cfg, state, generator=None) -> torch.Tensor:
        raise NotImplementedError

    def streaming_init(self, cfg, batch: int, device) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def streaming_step(
        self, chunk, cfg, state, carry, generator=None
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
    if state is not None and state.chip is not None:
        # the chip's cf mismatch lives in the designed coefficients;
        # refusing beats simulating a mismatch-free filterbank
        raise ValueError(
            "FrontendState has a chip (cf mismatch) but no designed "
            "coeffs; build the state via init_frontend_state / "
            "calibrate_state / hardware_state instead of by hand"
        )
    return cfg.fex.filterbank().stacked(device=device)


def hardware_state(
    tdcfg: TDFExConfig,
    chip: Optional[TDFExState] = None,
    beta: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
    norm_stats: Optional[FExNormStats] = None,
    device=None,
) -> FrontendState:
    """A hardware-frontend state on ``device`` (default: the chip's, or
    the card without a chip: `kernels.build.resolve_device`, which raises
    where there is none), designing the die's (possibly mismatched)
    Rec-BPF coefficients once. beta / alpha default to the nominal offset
    and unity gain (an uncalibrated die)."""
    from repro_torch.kernels.build import resolve_device

    c = tdcfg.fex.num_channels
    if device is None:
        device = chip.gain_mismatch.device if chip is not None else resolve_device()
    f32 = lambda t: t.to(device=device, dtype=torch.float32)  # noqa: E731
    if beta is None:
        beta = torch.full((c,), tdcfg.beta_nominal)
    if alpha is None:
        alpha = torch.ones((c,))
    if chip is not None:
        chip = TDFExState(gain_mismatch=f32(chip.gain_mismatch), cf_mismatch=f32(chip.cf_mismatch))
    return FrontendState(
        norm_stats=norm_stats,
        chip=chip,
        beta=f32(beta),
        alpha=f32(alpha),
        coeffs=design_mismatched_filterbank(tdcfg, chip).stacked(device=device),
    )


@register_frontend("software")
class SoftwareFrontend(FeatureFrontend):
    """Voltage-domain model: BPF -> |.| -> frame mean -> 12-bit quantizer."""

    def init_state(self, cfg, generator=None, norm_stats=None, device=None, **kwargs):
        del generator, device, kwargs  # nothing to calibrate in the ideal model
        return FrontendState(norm_stats=norm_stats)

    def raw_codes(self, audio, cfg, state, generator=None):
        del generator  # the software model is noiseless
        fexc = cfg.fex
        coeffs = state.coeffs if state is not None else None
        frames = fex_frames(audio, fexc, coeffs)
        return quant.quantize_unsigned(
            frames, fexc.quant_bits, fexc.quant_full_scale
        )

    def streaming_init(self, cfg, batch, device):
        c = cfg.fex.num_channels
        z = lambda: torch.zeros((batch, c), dtype=torch.float32, device=device)  # noqa: E731
        return {"s1": z(), "s2": z()}

    def streaming_step(self, chunk, cfg, state, carry, generator=None):
        del generator
        fexc = cfg.fex
        x = _chunk_to_internal(chunk, fexc)
        frame, (s1, s2) = biquad_filterbank_frame_mean(
            x, _nominal_coeffs(cfg, state, chunk.device), (carry["s1"], carry["s2"])
        )
        codes = quant.quantize_unsigned(
            frame, fexc.quant_bits, fexc.quant_full_scale
        )
        return {"s1": s1, "s2": s2}, codes


def streaming_tdc_scale(tdcfg: TDFExConfig) -> float:
    """``n_phases * tdc_oversample / f_tdc``, the counts per Hz of one
    frame's summed SRO frequency, rounded once to float32 (the ZOH over
    the ``os`` TDC ticks of a sample contributes the factor os)."""
    return quant._f32(tdcfg.n_phases * tdcfg.tdc_oversample / tdcfg.f_tdc)


def _hardware_frame(duty, coeffs, s1, s2, gain, tdcfg):
    """The Rec-BPF and SRO over one hop: (B, frame_len) duty -> (summed
    SRO frequency (B, C), (s1, s2)). The frame sum runs in the
    reference's compiled order (`frame_sum`), the order the CUDA tick
    uses too."""
    y, (s1, s2) = biquad_scan(duty, coeffs, (s1, s2))
    f = sro_frequency(torch.abs(y), tdcfg, gain)
    return frame_sum(f, duty.shape[-1])[:, 0], (s1, s2)


class _HardwareBase(FeatureFrontend):
    """Shared VTC -> Rec-BPF -> (TDC) -> beta/alpha signal chain; the TDC
    stage itself is `_counts`."""

    def init_state(
        self,
        cfg,
        generator=None,
        norm_stats=None,
        device=None,
        mismatch: bool = True,
        calibrate: bool = True,
        **kwargs,
    ):
        """A calibrated per-die state (the Section III-F flow) on
        ``device`` (the card by default).

        ``generator`` with ``mismatch=True`` draws a fresh chip (gain and
        cf mismatch); ``calibrate=True`` measures beta (zero input) and
        alpha (reference tones) as `repro_torch.core.calibration` does,
        with the generator's noise.
        """
        del kwargs
        from repro_torch.core.calibration import calibrate_chip
        from repro_torch.kernels.build import resolve_device

        device = resolve_device(device)
        tdcfg = cfg.tdfex_config
        chip = None
        if generator is not None and mismatch:
            chip = draw_chip(generator, tdcfg, device)
        beta = alpha = None  # hardware_state defaults: an uncalibrated die
        if calibrate:
            beta, alpha = calibrate_chip(tdcfg, chip, generator, device=device)
        return hardware_state(
            tdcfg, chip, beta=beta, alpha=alpha, norm_stats=norm_stats, device=device
        )

    def _counts(self, rect, tdcfg, chip, generator):
        return sro_tdc(rect, tdcfg, chip, generator)

    @staticmethod
    def _calibration(tdcfg, state: Optional[FrontendState]):
        beta = quant._f32(tdcfg.beta_nominal)
        if state is not None and state.beta is not None:
            beta = state.beta
        alpha = 1.0
        if state is not None and state.alpha is not None:
            alpha = state.alpha
        return beta, alpha

    def raw_codes(self, audio, cfg, state, generator=None):
        tdcfg = cfg.tdfex_config
        duty = vtc(audio, tdcfg, generator)
        y, _ = biquad_filterbank_streaming(duty, _nominal_coeffs(cfg, state, audio.device))
        chip = state.chip if state is not None else None
        counts = self._counts(torch.abs(y), tdcfg, chip, generator)
        beta, alpha = self._calibration(tdcfg, state)
        return counts_to_fv_raw(counts, tdcfg, beta, alpha)

    def streaming_init(self, cfg, batch, device):
        c = cfg.fex.num_channels
        z = lambda: torch.zeros((batch, c), dtype=torch.float32, device=device)  # noqa: E731
        # r: fractional phase carry of the 15-phase counter (counts);
        # j: the previous frame-edge phase jitter (counts)
        return {"s1": z(), "s2": z(), "r": z(), "j": z()}

    def streaming_step(self, chunk, cfg, state, carry, generator=None):
        """One hop through VTC, Rec-BPF and TDC.

        The per-tick floor increments telescope within a frame, so a hop
        needs only the summed phase and the fractional carry r:
        ``counts = floor(r + scale * sum f)``, ``r' = frac(...)``, with
        ``r + scale * sum`` one fused multiply-add as compiled. With a
        ``generator`` and ``phase_noise_rms``, one jitter draw per frame
        edge reproduces the batch path's per-frame phase noise.
        """
        tdcfg = cfg.tdfex_config
        duty = vtc(chunk, tdcfg, generator)
        chip = state.chip if state is not None else None
        gain = None
        if chip is not None:
            gain = 1.0 + chip.gain_mismatch
        total, (s1, s2) = _hardware_frame(
            duty, _nominal_coeffs(cfg, state, chunk.device), carry["s1"], carry["s2"],
            gain, tdcfg,
        )
        j = carry["j"]
        if generator is not None and tdcfg.phase_noise_rms > 0:
            noise = torch.randn(j.shape, generator=generator, device=generator.device)
            j = tdcfg.n_phases * tdcfg.phase_noise_rms * noise.to(j.device)
        tot = fma_f32(total, total.new_tensor(streaming_tdc_scale(tdcfg)), carry["r"])
        tot = tot + (j - carry["j"])
        counts = torch.floor(tot)
        beta, alpha = self._calibration(tdcfg, state)
        codes = counts_to_fv_raw(counts, tdcfg, beta, alpha)
        return {"s1": s1, "s2": s2, "r": tot - counts, "j": j}, codes


@register_frontend("hardware")
class HardwareFrontend(_HardwareBase):
    """Behavioral chip simulation with the cumulative-phase TDC
    (`repro_torch.core.tdfex.sro_tdc`)."""


@register_frontend("hardware-pallas")
class HardwarePallasFrontend(_HardwareBase):
    """The same signal chain with the TDC stage served by the K5 kernel
    (`repro_torch.kernels.tdc`): the CUDA kernel for a CUDA tensor, its
    plain fractional-carry loop for a CPU tensor. SRO phase jitter
    (``phase_noise_rms``) is not modelled in the kernel, as in the
    reference."""

    def _counts(self, rect, tdcfg, chip, generator):
        del generator  # the kernel path is deterministic
        from repro_torch.kernels.tdc import tdc_counts

        return tdc_counts(rect, tdcfg, chip)
