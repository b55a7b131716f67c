"""Cycle/energy model of the KWS IC — reproduces Table II and Fig. 21.

Counterpart of `repro.core.energy`, copied (pure dataclasses over the
MAC and weight counts of `repro_torch.core.gru`).

Grounded in the paper's disclosed numbers:
  * accelerator: 8 HPEs, 250 kHz, 0.75 V; 24 KB WMEM; 9.96 uW while
    streaming 16 ms frames; 75 % dynamic / 25 % leakage; leakage 78 % SRAM;
    dynamic split ~44 % logic / 56 % SRAM.
  * analog FEx: 9.3 uW at 0.5 V (16 channels, VTC + Rec-BPF + PFM).
  * total KWS core: 23 uW; latency 12.4 ms (Fig. 4 / Table II).

The latency model is *predictive*: ceil(MACs / n_hpe) + per-layer FSM
overhead cycles at f_clk. With the paper's network (24,204 MACs) this
gives 12.4 ms, matching Table II.

Energy constants are calibrated once from the published power split and
then reused to predict power for *other* network sizes (e.g. the 499 KB
Cortex-M7 network of [36] discussed in Section IV) — and, via
`AcceleratorModel.effective_mac_fraction`, for *other MAC loads*: the
ΔGRU serving backend's measured temporal sparsity (`srv.sparsity`,
`repro_torch.core.gru_delta`) plugs in to predict DeltaKWS-style µW/latency
at a given skip rate, and via
`AcceleratorModel.duty_cycle`, for gated workloads: the cascaded wake
gate's measured `srv.wake_rate` (`repro_torch.serving.cascade`) composes
multiplicatively with the ΔGRU fraction to predict the µW of a
classifier that sleeps through non-speech frames entirely.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.gru import GRUConfig, classifier_macs, classifier_param_bytes

__all__ = [
    "AcceleratorModel",
    "ICPowerModel",
    "paper_accelerator",
    "paper_power_model",
]


@dataclasses.dataclass(frozen=True)
class AcceleratorModel:
    """The GRU-FC accelerator of Section III-E."""

    n_hpe: int = 8
    f_clk_hz: float = 250e3
    # FSM overhead per matrix/vector op (pipeline fill, state transitions).
    # Calibrated so the paper network lands on its measured 12.4 ms:
    # 12.4 ms * 250 kHz = 3100 cycles; MAC cycles = ceil(24204/8) = 3026;
    # 74 remaining cycles over ~10 sequenced ops ~= 7 cycles each.
    overhead_cycles_per_op: int = 7
    n_sequenced_ops: int = 10
    # Fraction of the per-frame MACs actually executed (1.0 = dense).
    # The ΔGRU serving backend (`repro_torch.core.gru_delta`) measures this
    # per stream as `srv.sparsity`; plugging the measured fraction in
    # here predicts DeltaKWS-style gains: MAC cycles (and the dynamic
    # MAC energy in `ICPowerModel`) scale linearly with the executed
    # work, while the FSM overhead and the SRAM/logic leakage do not —
    # exactly the split the DeltaKWS IC reports.
    effective_mac_fraction: float = 1.0
    # Fraction of frames the classifier runs at all (1.0 = always-on).
    # The cascaded wake gate (`repro_torch.serving.cascade`) measures this
    # per stream as `srv.wake_rate`; a gated frame costs the
    # accelerator nothing dynamic, so the time-averaged dynamic MAC
    # power in `ICPowerModel` scales by the duty cycle while leakage
    # (weights stay SRAM-resident) and the per-WOKEN-frame
    # latency/cycles do not — the gate skips frames, it does not speed
    # them up. Composes multiplicatively with effective_mac_fraction
    # (duty cycle x within-wake ΔGRU sparsity).
    duty_cycle: float = 1.0

    def __post_init__(self):
        if not 0.0 <= self.effective_mac_fraction <= 1.0:
            raise ValueError(
                "effective_mac_fraction must be in [0, 1]; got "
                f"{self.effective_mac_fraction}"
            )
        if not 0.0 <= self.duty_cycle <= 1.0:
            raise ValueError(
                f"duty_cycle must be in [0, 1]; got {self.duty_cycle}"
            )

    def effective_macs(self, config: GRUConfig) -> int:
        """Executed MACs per frame under the configured sparsity."""
        return int(round(classifier_macs(config) * self.effective_mac_fraction))

    def cycles_per_frame(self, config: GRUConfig) -> int:
        mac_cycles = -(-self.effective_macs(config) // self.n_hpe)  # ceil
        return mac_cycles + self.overhead_cycles_per_op * self.n_sequenced_ops

    def latency_s(self, config: GRUConfig) -> float:
        """Classifier latency after the last FV arrives (Fig. 4)."""
        return self.cycles_per_frame(config) / self.f_clk_hz

    def utilization(self, config: GRUConfig, frame_shift_s: float = 16e-3):
        """Fraction of the frame period the accelerator is busy."""
        return self.latency_s(config) / frame_shift_s


@dataclasses.dataclass(frozen=True)
class ICPowerModel:
    """Power model calibrated against Fig. 21 / Table I / Table II."""

    accel: AcceleratorModel = dataclasses.field(default_factory=AcceleratorModel)
    # Analog FEx power: per-channel BPF+PFM plus the shared VTC. Table I
    # gives 9.3 uW for 16 channels; the VTC is a single shared block that we
    # attribute ~1.5 uW (two VCOs + FLL at 0.5 V), the rest split per channel.
    fex_vtc_w: float = 1.5e-6
    fex_per_channel_w: float = (9.3e-6 - 1.5e-6) / 16.0
    # Digital front-end (TDC counters, CIC, post-processing @61 Hz): the
    # 23 uW total minus 9.3 (FEx) minus 9.96 (accel) = 3.74 uW.
    digital_frontend_w: float = 23e-6 - 9.3e-6 - 9.96e-6
    # Accelerator energy constants, calibrated from the 9.96 uW / 75-25
    # dynamic-leakage split at 1.513 MMAC/s (24204 MACs / 16 ms):
    #   dynamic 7.47 uW -> 4.94 pJ/MAC (incl. SRAM read, 0.75 V, 65 nm LP)
    #   leakage 2.49 uW at 24+1.3 KB SRAM + logic -> per-KB and fixed parts.
    e_mac_j: float = 7.47e-6 / (24204.0 / 16e-3)
    leak_sram_w_per_kb: float = (2.49e-6 * 0.78) / 25.3
    leak_logic_w: float = 2.49e-6 * 0.22

    def accelerator_power_w(
        self, config: GRUConfig, frame_shift_s: float = 16e-3
    ) -> float:
        # dynamic energy scales with the MACs actually executed (the
        # accelerator's effective_mac_fraction; 1.0 = dense) and with
        # the fraction of frames the cascade gate wakes the classifier
        # at all (duty_cycle; 1.0 = always-on); leakage is
        # state-independent — the weights stay SRAM-resident whether or
        # not a ΔGRU skips their columns (or the gate skips the frame)
        dyn = (
            self.e_mac_j
            * self.accel.effective_macs(config)
            * self.accel.duty_cycle
            / frame_shift_s
        )
        sram_kb = (classifier_param_bytes(config) + 1.3 * 1024) / 1024.0
        leak = self.leak_sram_w_per_kb * sram_kb + self.leak_logic_w
        return dyn + leak

    def fex_power_w(self, num_channels: int = 16) -> float:
        return self.fex_vtc_w + self.fex_per_channel_w * num_channels

    def total_power_w(
        self,
        config: GRUConfig,
        num_channels: int = 16,
        frame_shift_s: float = 16e-3,
    ) -> float:
        return (
            self.fex_power_w(num_channels)
            + self.digital_frontend_w
            + self.accelerator_power_w(config, frame_shift_s)
        )


def paper_accelerator() -> AcceleratorModel:
    return AcceleratorModel()


def paper_power_model() -> ICPowerModel:
    return ICPowerModel()
