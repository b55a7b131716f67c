#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

Run from the root of the repository: ``python3 chip_smoke.py``. It
drives the port's main path, the raw-audio serving tick of
`repro_torch.serving.serve_loop.StreamingKWSServer`, at 4096 streams of
the paper's model (random weights from a seed), and holds each CUDA
kernel against its plain PyTorch version on the card:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds both kernels from ``src/repro_torch/kernels/csrc`` with nvcc
     and prints ptxas' registers / shared memory / spills;
  3. intgemm against its plain version at the classifier's shapes, a
     saturating case and 1x1x1: bit-equal;
  4. tick_fused against the plain tick for qat and integer, raw audio and
     FV_Norm, over ticks with partial masks and an all-idle tick: state,
     FV codes and top bit-equal, scores within 1e-6;
  5. the server at 4096 streams, qat and integer: 64 step_batch ticks and
     a 32-tick run_batch, every tick held against the plain tick loop;
     tick_fused launches once per tick and intgemm never;
  6. the integer pipeline's streaming_step: 5 intgemm launches per step,
     equal to the plain version;
  7. times on CUDA events after warm-up: ms per step_batch tick and each
     kernel's time beside its plain version's, its bound and a library
     yardstick where one exists; one JSON line per kernel, then all
     kernels in one JSON line;
  8. the result line ``{"ok": true, "device": {...}}``.

Every failure raises, so the exit code is not 0. Without a CUDA device,
or run outside a checkout of the repository, it exits 1 and prints no
result.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_STREAMS = 4096
SEED = 0
SMOOTHING = 0.7
SCORE_TOL = 1e-6
LIVE_TICKS = 64
REPLAY_TICKS = 32
PIPELINE_STEPS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM CUDA cores, float32 (int32 counted alike)
C, H, G, K, HOP = 16, 48, 144, 12, 256


def _cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _clone_state(state):
    gru, carry, scores = state
    return (tuple(t.clone() for t in gru), {k: v.clone() for k, v in carry.items()},
            scores.clone())


@functools.lru_cache(maxsize=None)
def _norm_stats():
    """FV_Log mean / std fitted by the port's own software frontend on
    seeded noise clips (plain version, on the CPU: set-up)."""
    import torch

    from repro_torch.core import fex, quant

    g = torch.Generator().manual_seed(SEED)
    audio = torch.randn((4, 4096), generator=g) * torch.tensor([[0.02], [0.05], [0.1], [0.3]])
    frames = fex.fex_frames(audio, fex.FExConfig())
    return fex.fit_norm_stats(
        quant.log_compress_lut(quant.quantize_unsigned(frames, 12, 0.7))
    )


def _setup(dev, classifier: str):
    """A pipeline with fitted norm stats and random float params from the
    seed, on ``dev``."""
    import torch

    from repro_torch.core import fex
    from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig

    stats = _norm_stats()
    stats = fex.FExNormStats(mu=stats.mu.to(dev), sigma=stats.sigma.to(dev))
    pipe = KWSPipeline(KWSPipelineConfig(classifier=classifier), norm_stats=stats)
    params = pipe.init_params(torch.Generator().manual_seed(SEED + 1), device=dev)
    return pipe, params


def _audio(gen, shape, dev):
    """Noise hops with per-stream gains from -40 dB to -6 dB full scale,
    so FV_Raw codes span the quantizer's range."""
    import torch

    gains = torch.logspace(-2, -0.3, shape[-2], device=dev)[:, None]
    return torch.randn(shape, generator=gen, device=dev) * gains


def phase_intgemm(dev):
    import torch

    from repro_torch.kernels.intgemm import intgemm, intgemm_ref

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    worst = 0
    cases = [(N_STREAMS, 16, 144), (N_STREAMS, 48, 144), (N_STREAMS, 48, 12), (1, 1, 1)]
    for m, k, n in cases + [("sat", 48, 144)]:
        if m == "sat":
            m = 129
            x = torch.where(torch.arange(m, device=dev)[:, None] % 3 == 0, 8191, -8192)
            x = x.expand(m, k).contiguous().to(torch.int32)
            w = torch.full((k, n), 127, dtype=torch.int8, device=dev)
        else:
            x = torch.randint(-8192, 8192, (m, k), generator=g, device=dev, dtype=torch.int32)
            w = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        got, want = intgemm(x, w), intgemm_ref(x, w)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err != 0:
            raise AssertionError(f"intgemm ({m},{k})x({k},{n}) differs by {err}")
        if m == 129 and (int(got.max()), int(got.min())) != (2**23 - 1, -(2**23)):
            raise AssertionError("saturating case did not saturate")
        worst = max(worst, err)
        print(f"intgemm ({m}, {k}) x ({k}, {n}): bit-equal to the plain version")
    return worst


def phase_tick(dev):
    """tick_fused against tick_reference on the card; returns the worst
    score difference."""
    import torch

    from repro_torch.kernels.tick_fused import pack_operands, tick_fused, tick_reference

    worst = 0.0
    n = N_STREAMS
    for classifier in ("qat", "integer"):
        pipe, params = _setup(dev, classifier)
        params = pipe.prepare_params(params)
        ops = pack_operands(pipe, params, pipe.state, dev)
        for raw in (True, False):
            state = (tuple(pipe.streaming_init(n, dev)), pipe.streaming_features_init(n, dev),
                     torch.zeros((n, K), device=dev))
            g = torch.Generator(device=dev).manual_seed(SEED + 3)
            for t, frac in enumerate([1.0, 0.6, 0.0, 0.9, 0.3]):
                if raw:
                    inp = _audio(g, (n, HOP), dev)
                else:
                    inp = torch.round(torch.randn((n, C), generator=g, device=dev) * 512) / 256
                mask = torch.rand(n, generator=g, device=dev) < frac
                (pg, pc, ps), _, ptop = tick_reference(
                    pipe, raw, params, _clone_state(state), inp, mask, pipe.state, SMOOTHING)
                fv = torch.zeros((n, C), device=dev)
                (kg, kc, ks), _, ktop = tick_fused(
                    pipe, raw, params, _clone_state(state), inp, mask, pipe.state, SMOOTHING,
                    operands=ops, fv_out=fv)
                torch.cuda.synchronize()
                where = f"tick_fused {classifier} {'raw' if raw else 'fv'} tick {t}"
                for a, b in zip(kg, pg):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{where}: GRU state differs")
                for key in ("s1", "s2"):
                    if not torch.equal(kc[key], pc[key]):
                        raise AssertionError(f"{where}: carry {key} differs")
                if raw:
                    _, pfv = pipe.streaming_features_apply(_clone_state(state)[1], inp, pipe.state)
                    if not torch.equal(fv[mask], pfv[mask]):
                        raise AssertionError(f"{where}: FV codes differ")
                if not torch.equal(ktop, ptop):
                    raise AssertionError(f"{where}: top differs")
                err = float((ks - ps).abs().max())
                if err > SCORE_TOL:
                    raise AssertionError(f"{where}: scores differ by {err}")
                worst = max(worst, err)
                state = (kg, kc, ks)
            print(f"tick_fused {classifier} {'raw' if raw else 'fv'}: 5 ticks equal to the plain tick")
    return worst


def drive_server(dev, classifier: str):
    """The main path: a user's StreamingKWSServer on the card. Returns the
    server's outputs, the inputs and the launch counts of the run."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.serving.serve_loop import StreamingKWSServer

    pipe, params = _setup(dev, classifier)
    srv = StreamingKWSServer(pipe, params, max_streams=N_STREAMS, smoothing=SMOOTHING)
    for sid in range(N_STREAMS):
        srv.open_stream(sid)
    rng = np.random.default_rng(SEED + 4)
    gains = np.logspace(-2, -0.3, N_STREAMS).astype(np.float32)[:, None]
    live = [((rng.standard_normal((N_STREAMS, HOP)).astype(np.float32) * gains),
             rng.random(N_STREAMS) < (0.0 if t == 7 else 0.85)) for t in range(LIVE_TICKS)]
    replay = (rng.standard_normal((REPLAY_TICKS, N_STREAMS, HOP)).astype(np.float32) * gains,
              rng.random((REPLAY_TICKS, N_STREAMS)) < 0.85)
    build.launches.clear()
    t0 = time.perf_counter()
    outs = [srv.step_batch(slab, mask) for slab, mask in live]
    live_s = time.perf_counter() - t0
    replay_out = srv.run_batch(*replay)
    counts = dict(build.launches)
    return pipe, srv, live, replay, outs, replay_out, counts, live_s


def check_server(dev, pipe, srv, live, replay, outs, replay_out):
    """Replay the same inputs through the plain tick loop on the card."""
    import torch

    from repro_torch.kernels.tick_fused import tick_reference

    n = N_STREAMS
    params = pipe.prepare_params(srv.params)
    state = (tuple(pipe.streaming_init(n, dev)), pipe.streaming_features_init(n, dev),
             torch.zeros((n, K), device=dev))
    ticks = list(live) + [(replay[0][t], replay[1][t]) for t in range(REPLAY_TICKS)]
    want = list(outs) + [(replay_out[0][t], replay_out[1][t]) for t in range(REPLAY_TICKS)]
    worst = 0.0
    for t, ((slab, mask), (scores, top)) in enumerate(zip(ticks, want)):
        state, ps, ptop = tick_reference(
            pipe, True, params, state, torch.as_tensor(slab, device=dev),
            torch.as_tensor(mask, device=dev), pipe.state, SMOOTHING)
        if not (ptop.cpu().numpy() == top).all():
            raise AssertionError(f"server tick {t}: top differs from the plain tick")
        err = float((ps.cpu() - torch.as_tensor(scores)).abs().max())
        if err > SCORE_TOL:
            raise AssertionError(f"server tick {t}: scores differ by {err}")
        worst = max(worst, err)
    for a, b in zip(srv.state.gru, state[0]):
        if not torch.equal(a, b):
            raise AssertionError("server GRU state differs from the plain loop")
    for key in ("s1", "s2"):
        if not torch.equal(srv.state.carry[key], state[1][key]):
            raise AssertionError(f"server carry {key} differs from the plain loop")
    return worst


def phase_pipeline(dev):
    """KWSPipeline(classifier="integer").streaming_step at 4096 streams."""
    import torch

    from repro_torch.kernels import build

    pipe, params = _setup(dev, "integer")
    q = pipe.prepare_params(params)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    frames = [torch.round(torch.randn((N_STREAMS, C), generator=g, device=dev) * 512) / 256
              for _ in range(PIPELINE_STEPS)]
    states = pipe.streaming_init(N_STREAMS, dev)
    build.launches.clear()
    logits = []
    for fv in frames:
        states, lg = pipe.streaming_step(q, states, fv)
        logits.append(lg)
    torch.cuda.synchronize()
    counts = dict(build.launches)
    if counts.get("intgemm", 0) != 5 * PIPELINE_STEPS or counts.get("tick_fused", 0):
        raise AssertionError(f"integer streaming_step launches: {counts}")
    cpu_q, cpu_states = q.to("cpu"), pipe.streaming_init(N_STREAMS, "cpu")
    for fv, lg in zip(frames, logits):
        cpu_states, cpu_lg = pipe.streaming_step(cpu_q, cpu_states, fv.cpu())
        if not torch.equal(lg.cpu(), cpu_lg):
            raise AssertionError("integer streaming_step differs from the plain version")
    for a, b in zip(states, cpu_states):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("integer streaming_step state differs from the plain version")
    print(f"integer streaming_step: {counts['intgemm']} intgemm launches in "
          f"{PIPELINE_STEPS} steps, equal to the plain version")
    return counts["intgemm"]


def tick_bound(n_active: int):
    """Least time for one tick of ``n_active`` raw-audio streams (all
    submitting): each input byte read once, each output written once, and
    the operations the tick needs at the card's CUDA-core rate."""
    state = 2 * C * 4 + 2 * H * 4 + K * 4  # s1, s2, h1, h2, scores
    per_stream = HOP * 4 + 1 + 2 * state + 8  # hop, mask, state in + out, top
    tables = 24204 + 2352 + 4096 * 4 + 2 * 32767 * 4 + 5 * C * 4 + 2 * C * 4
    byts = n_active * per_stream + tables
    iir = 2 * HOP * C * 11  # per internal sample: 3 fma (2 each), 2 mul, 2 add, abs, acc
    post = C * 10 + 2 * HOP
    macs = G * (C + H) + G * (H + H) + H * K
    gates = 2 * H * 14
    tail = K * 6
    ops = n_active * (iir + post + 2 * macs + gates + tail)
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def intgemm_bound(m: int, k: int, n: int):
    byts = m * k * 4 + k * n + m * n * 4
    ops = 2 * m * k * n
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_times(dev, srv_qat, live):
    """Kernel, plain and library times on CUDA events at the main path's
    shapes, and host-clock ms per step_batch tick."""
    import torch

    from repro_torch.kernels.intgemm import intgemm, intgemm_ref
    from repro_torch.kernels.tick_fused import pack_operands, tick_fused, tick_reference

    n = N_STREAMS
    out = {}
    # step_batch: the user's tick, host slab in, host scores out
    slab, _ = live[0]
    mask = torch.ones(n, dtype=torch.bool).numpy()
    for _ in range(3):
        srv_qat.step_batch(slab, mask)
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        srv_qat.step_batch(slab, mask)
    out["step_batch_ms"] = (time.perf_counter() - t0) / reps * 1e3
    # tick kernel, qat and integer, all streams submitting raw audio
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    inp = _audio(g, (n, HOP), dev)
    full = torch.ones(n, dtype=torch.bool, device=dev)
    for classifier in ("qat", "integer"):
        pipe, params = _setup(dev, classifier)
        params = pipe.prepare_params(params)
        ops = pack_operands(pipe, params, pipe.state, dev)
        state = (tuple(pipe.streaming_init(n, dev)), pipe.streaming_features_init(n, dev),
                 torch.zeros((n, K), device=dev))
        out[f"tick_{classifier}_ms"] = _cuda_ms(
            lambda: tick_fused(pipe, True, params, state, inp, full, pipe.state, SMOOTHING,
                               operands=ops), reps=50)
        out[f"tick_{classifier}_plain_ms"] = _cuda_ms(
            lambda: tick_reference(pipe, True, params, _clone_state(state), inp, full,
                                   pipe.state, SMOOTHING), reps=2, warmup=1)
    out["tick_bound_ms"], out["tick_bound_by"] = tick_bound(n)
    # intgemm at the largest gate shape of the integer tick
    x = torch.randint(-8192, 8192, (n, H), generator=g, device=dev, dtype=torch.int32)
    w = torch.randint(-128, 128, (H, G), generator=g, device=dev, dtype=torch.int8)
    x64, w64 = x.to(torch.float64), w.to(torch.float64)
    out["intgemm_ms"] = _cuda_ms(lambda: intgemm(x, w), reps=200)
    out["intgemm_plain_ms"] = _cuda_ms(lambda: intgemm_ref(x, w), reps=20)
    out["intgemm_library_ms"] = _cuda_ms(lambda: torch.matmul(x64, w64), reps=200)
    out["intgemm_bound_ms"], out["intgemm_bound_by"] = intgemm_bound(n, H, G)
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"built {sorted(reports)} with nvcc in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            print(f"  {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    intgemm_err = phase_intgemm(dev)
    tick_err = phase_tick(dev)

    tick_launches = 0
    servers = {}
    for classifier in ("qat", "integer"):
        pipe, srv, live, replay, outs, replay_out, counts, live_s = drive_server(dev, classifier)
        want = LIVE_TICKS + REPLAY_TICKS
        if counts.get("tick_fused", 0) != want or counts.get("intgemm", 0):
            raise AssertionError(f"server {classifier}: launches {counts}, want "
                                 f"tick_fused={want} and no intgemm")
        tick_launches += counts["tick_fused"]
        err = check_server(dev, pipe, srv, live, replay, outs, replay_out)
        tick_err = max(tick_err, err)
        print(f"server {classifier}: {LIVE_TICKS} step_batch + {REPLAY_TICKS} run_batch "
              f"ticks at {N_STREAMS} streams, launches {counts}, equal to the plain "
              f"tick loop (scores within {err:.3g}); live ticks took {live_s:.3f} s")
        servers[classifier] = (srv, live)
    intgemm_launches = phase_pipeline(dev)

    times = phase_times(dev, *servers["qat"])
    print(f"step_batch at {N_STREAMS} streams (qat, raw audio, host slab in, host "
          f"scores out): {times['step_batch_ms']:.4f} ms per tick")
    print(f"tick_fused integer: {times['tick_integer_ms']:.5f} ms, plain "
          f"{times['tick_integer_plain_ms']:.2f} ms")
    kernels = [
        {
            "name": "tick_fused", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/tick_fused.cu",
            "replaces": "src/repro/kernels/tick_fused/kernel.py:256",
            "launches": tick_launches, "max_abs_err": tick_err,
            "ms": times["tick_qat_ms"], "plain_ms": times["tick_qat_plain_ms"],
            "bound_ms": times["tick_bound_ms"], "bound_by": times["tick_bound_by"],
            "library_ms": None,
        },
        {
            "name": "intgemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/intgemm.cu",
            "replaces": "src/repro/kernels/intgemm/kernel.py:46",
            "launches": intgemm_launches, "max_abs_err": intgemm_err,
            "ms": times["intgemm_ms"], "plain_ms": times["intgemm_plain_ms"],
            "bound_ms": times["intgemm_bound_ms"], "bound_by": times["intgemm_bound_by"],
            "library_ms": times["intgemm_library_ms"],
        },
    ]
    for k in kernels:
        print(json.dumps(k))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
