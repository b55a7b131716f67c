"""Synthetic GSCD-v2-like dataset (formant synthesis).

Counterpart of `repro.data.gscd`, copied: host-side numpy / scipy, so
`make_dataset` and `batch_iterator` give the reference's arrays for the
same seed. The real Google Speech Commands Dataset is not available
offline, so the corpus is synthesized, a 12-class task of the same
structure:

  classes = ["silence", "unknown"] + 10 target keywords

Each keyword is a formant-trajectory template (sequence of voiced /
unvoiced segments with F1-F3 resonances); samples draw per-utterance
pitch, tempo, formant jitter, amplitude, and background noise, so classes
overlap realistically ("go"/"no" share vowels, "unknown" reuses held-out
templates the classifier never sees labeled).

Accuracy numbers on it are therefore *relative* reproductions of the
paper's claims (ablation gaps, SNR robustness, hw/sw gap).

Synthesis is host-side numpy/scipy (it plays the role of the laptop +
sound card in Fig. 16); the device-side model consumes raw waveforms.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import signal as sps

__all__ = [
    "CLASSES",
    "KEYWORDS",
    "GSCDSynthConfig",
    "synth_keyword",
    "make_dataset",
    "batch_iterator",
]

KEYWORDS = ["yes", "no", "up", "down", "left", "right", "on", "off", "stop", "go"]
CLASSES = ["silence", "unknown"] + KEYWORDS

# Formant templates: list of segments
#   (duration_weight, voiced, (F1_start, F1_end), (F2_start, F2_end),
#    (F3_start, F3_end), amplitude)
# Loosely modeled on American English phone formants; exact phonetics is
# irrelevant — distinct, overlapping spectro-temporal classes are the goal.
_Seg = Tuple[float, bool, Tuple[float, float], Tuple[float, float], Tuple[float, float], float]

_TEMPLATES: Dict[str, List[_Seg]] = {
    "yes": [
        (0.35, True, (280, 500), (2100, 1800), (2900, 2600), 0.9),  # /jE/
        (0.30, True, (550, 550), (1800, 1800), (2500, 2500), 1.0),  # /E/
        (0.35, False, (4500, 5000), (6000, 6500), (7500, 7500), 0.55),  # /s/
    ],
    "no": [
        (0.40, True, (400, 450), (1300, 900), (2500, 2300), 0.9),  # /n/->/o/
        (0.60, True, (450, 380), (900, 700), (2300, 2200), 1.0),  # /oU/
    ],
    "up": [
        (0.55, True, (640, 640), (1190, 1190), (2400, 2400), 1.0),  # /V/
        (0.20, False, (100, 100), (400, 400), (900, 900), 0.0),  # closure
        (0.25, False, (800, 1200), (1800, 2200), (3000, 3400), 0.45),  # /p/ burst
    ],
    "down": [
        (0.30, False, (300, 400), (2800, 2400), (3600, 3400), 0.5),  # /d/
        (0.40, True, (750, 400), (1300, 800), (2500, 2300), 1.0),  # /aU/
        (0.30, True, (400, 350), (1100, 1200), (2400, 2400), 0.7),  # /n/
    ],
    "left": [
        (0.30, True, (380, 530), (2200, 1850), (2800, 2500), 0.85),  # /lE/
        (0.25, True, (530, 530), (1850, 1850), (2500, 2500), 1.0),
        (0.20, False, (4000, 4500), (5500, 6000), (7000, 7000), 0.4),  # /f/
        (0.25, False, (500, 900), (1800, 2000), (3000, 3200), 0.45),  # /t/
    ],
    "right": [
        (0.35, True, (420, 750), (1300, 1100), (1600, 2300), 0.9),  # /raI/
        (0.35, True, (750, 450), (1100, 1900), (2300, 2600), 1.0),  # /aI/
        (0.30, False, (600, 1000), (1900, 2100), (3100, 3300), 0.45),  # /t/
    ],
    "on": [
        (0.55, True, (700, 600), (1100, 1000), (2500, 2400), 1.0),  # /A/
        (0.45, True, (400, 350), (1300, 1250), (2400, 2400), 0.75),  # /n/
    ],
    "off": [
        (0.50, True, (650, 600), (950, 900), (2500, 2400), 1.0),  # /O/
        (0.50, False, (4200, 4600), (5800, 6200), (7200, 7200), 0.5),  # /f/
    ],
    "stop": [
        (0.25, False, (4500, 4800), (6200, 6400), (7500, 7500), 0.5),  # /s/
        (0.15, False, (600, 900), (1800, 2000), (3000, 3100), 0.4),  # /t/
        (0.40, True, (650, 650), (1000, 1000), (2450, 2450), 1.0),  # /A/
        (0.20, False, (700, 1100), (1700, 2100), (2900, 3300), 0.4),  # /p/
    ],
    "go": [
        (0.30, False, (250, 400), (1800, 1400), (2600, 2400), 0.5),  # /g/
        (0.70, True, (480, 380), (1000, 720), (2350, 2250), 1.0),  # /oU/
    ],
}

# Held-out "unknown" words (Section III-F: 25 non-target words), drawn
# once from a fixed seed.
@functools.lru_cache(maxsize=None)
def _make_unknown_templates(n: int = 25, seed: int = 1234) -> List[List[_Seg]]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        n_seg = int(rng.integers(2, 5))
        segs: List[_Seg] = []
        for _ in range(n_seg):
            voiced = bool(rng.random() < 0.65)
            if voiced:
                f1 = float(rng.uniform(280, 800))
                f2 = float(rng.uniform(700, 2300))
                f3 = float(rng.uniform(2200, 3000))
                amp = float(rng.uniform(0.7, 1.0))
            else:
                f1 = float(rng.uniform(800, 4800))
                f2 = float(rng.uniform(1800, 6400))
                f3 = float(rng.uniform(3000, 7600))
                amp = float(rng.uniform(0.35, 0.6))
            drift = rng.uniform(0.8, 1.25)
            segs.append(
                (
                    float(rng.uniform(0.5, 1.5)),
                    voiced,
                    (f1, f1 * drift),
                    (f2, f2 * drift),
                    (f3, f3 * drift),
                    amp,
                )
            )
        out.append(segs)
    return out


@dataclasses.dataclass(frozen=True)
class GSCDSynthConfig:
    fs: int = 16000
    duration_s: float = 1.0
    # Nominal waveform amplitude: the paper drives ~250 mVpp into the VTC;
    # we use normalized units where 1.0 = VTC full scale, so speech peaks
    # sit near 0.25 (=0.125 amplitude) like the measurement setup.
    amplitude: float = 0.125
    background_noise: float = 0.004  # always-present noise floor
    silence_noise: float = 0.010  # "silence" class = background tracks
    pitch_lo: float = 95.0
    pitch_hi: float = 220.0
    tempo_jitter: float = 0.18
    formant_jitter: float = 0.06
    amp_jitter_db: float = 6.0
    n_unknown_templates: int = 25

    @property
    def n_samples(self) -> int:
        return int(self.fs * self.duration_s)


def _resonator_sos(f0: float, fs: float, bw: float = 120.0) -> np.ndarray:
    """2nd-order resonator (formant) as an sos section."""
    f0 = float(np.clip(f0, 60.0, fs / 2 * 0.95))
    r = np.exp(-np.pi * bw / fs)
    theta = 2 * np.pi * f0 / fs
    # poles at r e^{+-j theta}; unity gain at resonance (approx)
    b = np.array([1.0 - r, 0.0, 0.0])
    a = np.array([1.0, -2 * r * np.cos(theta), r * r])
    return np.concatenate([b, a])[None, :]


def _synth_segment(
    rng: np.random.Generator,
    cfg: GSCDSynthConfig,
    n: int,
    voiced: bool,
    f1: Tuple[float, float],
    f2: Tuple[float, float],
    f3: Tuple[float, float],
    amp: float,
    pitch: float,
) -> np.ndarray:
    if n <= 0:
        return np.zeros(0, np.float32)
    fs = cfg.fs
    if voiced:
        # glottal impulse train with slight jitter
        period = max(int(fs / pitch), 8)
        exc = np.zeros(n)
        idx = np.arange(0, n, period)
        idx = idx + rng.integers(-2, 3, size=idx.shape)
        idx = np.clip(idx, 0, n - 1)
        exc[idx] = 1.0
        exc = sps.lfilter([1.0], [1.0, -0.96], exc)  # glottal rolloff
    else:
        exc = rng.standard_normal(n) * 0.35
    # Two halves with interpolated formants (cheap trajectory model).
    halves = []
    for frac in (0.25, 0.75):
        h = n // 2 if frac < 0.5 else n - n // 2
        if h <= 0:
            continue
        seg_exc = exc[: h] if frac < 0.5 else exc[n - h :]
        y = seg_exc
        for (lo, hi), bw in ((f1, 110.0), (f2, 160.0), (f3, 220.0)):
            fc = lo + (hi - lo) * frac
            fc *= 1.0 + rng.normal(0, cfg.formant_jitter)
            y = sps.sosfilt(_resonator_sos(fc, fs, bw), y)
        halves.append(y)
    y = np.concatenate(halves)
    # amplitude envelope (attack/decay)
    env = np.ones(n)
    a = max(int(0.012 * fs), 1)
    env[:a] = np.linspace(0, 1, a)
    env[-a:] = np.linspace(1, 0, a)
    return (amp * env * y).astype(np.float32)


def synth_keyword(
    rng: np.random.Generator,
    template: Sequence[_Seg],
    cfg: GSCDSynthConfig,
) -> np.ndarray:
    """One utterance from a template, with speaker/tempo variability."""
    n_total = cfg.n_samples
    speech_frac = rng.uniform(0.55, 0.8)
    n_speech = int(n_total * speech_frac)
    pitch = rng.uniform(cfg.pitch_lo, cfg.pitch_hi)
    weights = np.array([s[0] for s in template], np.float64)
    weights = weights * rng.uniform(
        1 - cfg.tempo_jitter, 1 + cfg.tempo_jitter, size=weights.shape
    )
    weights /= weights.sum()
    lens = np.floor(weights * n_speech).astype(int)
    lens[-1] = n_speech - lens[:-1].sum()
    parts = [
        _synth_segment(rng, cfg, n, v, f1, f2, f3, a, pitch)
        for (_, v, f1, f2, f3, a), n in zip(template, lens)
    ]
    speech = np.concatenate(parts) if parts else np.zeros(0, np.float32)
    # random placement within the 1 s window
    start = int(rng.uniform(0.0, max(n_total - n_speech, 1)))
    out = np.zeros(n_total, np.float32)
    out[start : start + len(speech)] = speech
    # normalize to nominal amplitude with per-utterance gain jitter
    peak = np.abs(out).max() + 1e-9
    gain_db = rng.uniform(-cfg.amp_jitter_db, cfg.amp_jitter_db)
    out = out / peak * cfg.amplitude * (10.0 ** (gain_db / 20.0))
    out += rng.standard_normal(n_total).astype(np.float32) * cfg.background_noise
    return out.astype(np.float32)


def _synth_silence(rng: np.random.Generator, cfg: GSCDSynthConfig) -> np.ndarray:
    n = cfg.n_samples
    kind = rng.integers(0, 3)
    noise = rng.standard_normal(n)
    if kind == 1:  # pink-ish
        noise = sps.lfilter([0.05], [1.0, -0.95], noise)
    elif kind == 2:  # hum + noise
        t = np.arange(n) / cfg.fs
        noise = 0.6 * noise + 2.0 * np.sin(2 * np.pi * 120 * t + rng.uniform(0, 6.3))
    noise = noise / (np.abs(noise).max() + 1e-9)
    level = cfg.silence_noise * 10.0 ** (rng.uniform(-6, 6) / 20.0)
    return (level * noise).astype(np.float32)


def make_dataset(
    n_per_class: int,
    cfg: Optional[GSCDSynthConfig] = None,
    seed: int = 0,
    unknown_split: str = "train",
) -> Dict[str, np.ndarray]:
    """Generate a balanced synthetic dataset.

    unknown_split: "train" uses the first half of the unknown templates,
    "test" the second half — so the Unknown class at test time contains
    words never seen in training, like the real GSCD protocol (and like the
    paper, Unknown stays the hardest class).
    """
    cfg = cfg or GSCDSynthConfig()
    templates = _make_unknown_templates(cfg.n_unknown_templates)
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    half = len(templates) // 2
    unk_pool = templates[:half] if unknown_split == "train" else templates[half:]
    for ci, cls in enumerate(CLASSES):
        for _ in range(n_per_class):
            if cls == "silence":
                x = _synth_silence(rng, cfg)
            elif cls == "unknown":
                tpl = unk_pool[rng.integers(0, len(unk_pool))]
                x = synth_keyword(rng, tpl, cfg)
            else:
                x = synth_keyword(rng, _TEMPLATES[cls], cfg)
            xs.append(x)
            ys.append(ci)
    order = rng.permutation(len(xs))
    return {
        "audio": np.stack(xs)[order],
        "label": np.asarray(ys, np.int32)[order],
    }


def batch_iterator(
    data: Dict[str, np.ndarray],
    batch_size: int,
    seed: int = 0,
    drop_remainder: bool = True,
):
    """Shuffled epoch iterator over host arrays."""
    n = len(data["label"])
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    end = n - n % batch_size if drop_remainder else n
    for i in range(0, end, batch_size):
        sl = idx[i : i + batch_size]
        yield {k: v[sl] for k, v in data.items()}
