#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

Run from the root of the repository: ``python3 chip_smoke.py``. It
drives the port's main path, the raw-audio serving tick of
`repro_torch.serving.serve_loop.StreamingKWSServer`, at 4096 streams of
the paper's model (random weights from a seed) for every classifier
backend (qat, integer, float, delta and delta-int at θ = 0.15), and holds
each CUDA kernel against its plain PyTorch version on the card:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds both kernels from ``src/repro_torch/kernels/csrc`` with nvcc
     and prints ptxas' registers / shared memory / spills;
  3. intgemm against its plain version at the classifier's shapes, a
     saturating case and 1x1x1: bit-equal;
  4. tick_fused against the plain tick for the five backends (delta and
     delta-int at θ = 0 and 0.15, held against the plain tick with K4's
     plain gather step), raw audio and FV_Norm, over ticks with partial
     masks and an all-idle tick: state (ΔGRU memories, accumulators and
     counters included), FV codes and top bit-equal, scores within 1e-6;
     float within FLOAT_TOL;
  5. the server at 4096 streams, each backend: step_batch ticks and a
     run_batch, every tick held against the plain tick loop; tick_fused
     launches once per tick (running K4 inside for delta / delta-int) and
     intgemm never; the mean of srv.sparsity for the ΔGRU runs;
  6. the integer and delta-int pipelines' streaming_step: 5 intgemm
     launches per step, equal to the plain version;
  7. times on CUDA events after warm-up: ms per step_batch tick and each
     kernel's time beside its plain version's, its bound and a library
     yardstick where one exists, the ΔGRU tick at θ = 0 and 0.15 on raw
     audio and on the reference's sparsity traffic (8 cycled slabs of
     N(0, 0.05) FV_Norm frames); one JSON line per kernel, then all
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
# float backend, kernel against plain tick, on states and scores: the
# kernel sums in its own order and evaluates sigmoid / tanh with
# expf / tanhf
FLOAT_TOL = 1e-5
LIVE_TICKS = 24
REPLAY_TICKS = 8
PIPELINE_STEPS = 3
THETA = 0.15  # the reference's ΔGRU operating point
# (classifier, θ) of the server runs, the main path
SERVER_RUNS = (("qat", None), ("integer", None), ("float", None),
               ("delta", THETA), ("delta-int", THETA))
# stream hold before a timed burst: 1 ms of enqueue time per call at the
# H100's ~2 GHz clock, far above any wrapper's Python
HOLD_CYCLES_PER_CALL = 2_000_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM CUDA cores, float32 (int32 counted alike)
C, H, G, K, HOP = 16, 48, 144, 12, 256
DENSE_STATE_BYTES = 2 * H * 4  # h1, h2
# per layer h, x_ref, h_ref, acc_x, acc_h, skipped, total
DELTA_STATE_BYTES = 4 * sum(H + i + H + 2 * G + 2 for i in (C, H))
ELIGIBLE_MACS = G * (C + H) + G * (H + H)  # what a ΔGRU can skip


def _cuda_ms(fn, reps: int, warmup: int = 3, hold: bool = False):
    """(device ms per call of ``fn`` on CUDA events, host µs per call to
    enqueue it). With ``hold`` the stream first sleeps long enough for
    the host to enqueue every call, so the events time the kernels back
    to back and not the host's enqueue rate (a kernel shorter than its
    wrapper's Python would otherwise be timed at the wrapper's speed)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(int(HOLD_CYCLES_PER_CALL * reps))
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    stop.record()
    stop.synchronize()
    enqueue_us = enqueue_s / reps * 1e6
    if hold and enqueue_us > 500.0:  # the hold lasts ~1 ms a call
        raise AssertionError(f"enqueue took {enqueue_us:.0f} µs a call; the hold is too short")
    return start.elapsed_time(stop) / reps, enqueue_us


def _gru_diff(got, want) -> float:
    """Largest difference over the classifier state's leaves."""
    from repro_torch.core.frontend import tree_leaves

    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def _check_top(where: str, top, ptop, pscores, flt: bool) -> None:
    """``top`` against the plain tick's ``ptop``: everywhere, or for float
    wherever the plain tick's two best scores are more than 2 * FLOAT_TOL
    apart (host arrays or tensors)."""
    import numpy as np

    top, ptop, pscores = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                          for x in (top, ptop, pscores))
    clear = np.ones(top.shape, bool)
    if flt:
        best2 = np.sort(pscores, axis=-1)[:, -2:]
        clear = best2[:, 1] - best2[:, 0] > 2 * FLOAT_TOL
    if not (top[clear] == ptop[clear]).all():
        raise AssertionError(f"{where}: top differs from the plain tick")


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


def _setup(dev, classifier: str, theta=None):
    """A pipeline with fitted norm stats (ΔGRU thresholds θ for the delta
    backends) and random float params from the seed, on ``dev``."""
    import torch

    from repro_torch.core import fex
    from repro_torch.core.gru_delta import DeltaConfig
    from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig

    stats = _norm_stats()
    stats = fex.FExNormStats(mu=stats.mu.to(dev), sigma=stats.sigma.to(dev))
    delta = None if theta is None else DeltaConfig(theta, theta)
    pipe = KWSPipeline(KWSPipelineConfig(classifier=classifier, delta=delta), norm_stats=stats)
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


def _label(classifier, theta):
    return classifier if theta is None else f"{classifier} θ={theta}"


def phase_tick(dev):
    """tick_fused against tick_reference on the card, for every backend;
    returns {classifier: worst difference} (scores, and the state too for
    float)."""
    import torch

    from repro_torch.core.frontend import tree_clone, tree_leaves
    from repro_torch.kernels.tick_fused import pack_operands, tick_fused, tick_reference
    from repro_torch.kernels.tick_fused.gather import make_sparse_step

    worst = {}
    n = N_STREAMS
    for classifier, theta in (("qat", None), ("integer", None), ("float", None),
                              ("delta", 0.0), ("delta", THETA),
                              ("delta-int", 0.0), ("delta-int", THETA)):
        pipe, params = _setup(dev, classifier, theta)
        params = pipe.prepare_params(params)
        ops = pack_operands(pipe, params, pipe.state, dev)
        step_fn = make_sparse_step(pipe)  # K4's plain version for the ΔGRU
        flt = classifier == "float"
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
                    pipe, raw, params, tree_clone(state), inp, mask, pipe.state, SMOOTHING,
                    step_fn=step_fn)
                fv = torch.zeros((n, C), device=dev)
                (kg, kc, ks), _, ktop = tick_fused(
                    pipe, raw, params, tree_clone(state), inp, mask, pipe.state, SMOOTHING,
                    operands=ops, fv_out=fv)
                torch.cuda.synchronize()
                where = f"tick_fused {_label(classifier, theta)} {'raw' if raw else 'fv'} tick {t}"
                err = float((ks - ps).abs().max())
                if flt:
                    err = max(err, _gru_diff(kg, pg))
                    if err > FLOAT_TOL:
                        raise AssertionError(f"{where}: differs by {err}")
                else:
                    for a, b in zip(tree_leaves(kg), tree_leaves(pg)):
                        if not torch.equal(a, b):
                            raise AssertionError(f"{where}: GRU state differs")
                    if err > SCORE_TOL:
                        raise AssertionError(f"{where}: scores differ by {err}")
                _check_top(where, ktop, ptop, ps, flt)
                for key in ("s1", "s2"):
                    if not torch.equal(kc[key], pc[key]):
                        raise AssertionError(f"{where}: carry {key} differs")
                if raw:
                    _, pfv = pipe.streaming_features_apply(tree_clone(state)[1], inp, pipe.state)
                    if not torch.equal(fv[mask], pfv[mask]):
                        raise AssertionError(f"{where}: FV codes differ")
                worst[classifier] = max(worst.get(classifier, 0.0), err)
                state = (kg, kc, ks)
            print(f"tick_fused {_label(classifier, theta)} {'raw' if raw else 'fv'}: 5 ticks "
                  f"equal to the plain tick" + (f" within {worst[classifier]:.3g}" if flt else ""))
    return worst


def drive_server(dev, classifier: str, theta=None):
    """The main path: a user's StreamingKWSServer on the card. Returns the
    server's outputs, the inputs and the launch counts of the run."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.serving.serve_loop import StreamingKWSServer

    pipe, params = _setup(dev, classifier, theta)
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
    """Replay the same inputs through the plain tick loop on the card (with
    K4's plain gather step for the ΔGRU backends)."""
    import numpy as np
    import torch

    from repro_torch.core.frontend import tree_leaves
    from repro_torch.kernels.tick_fused import tick_reference
    from repro_torch.kernels.tick_fused.gather import make_sparse_step

    n = N_STREAMS
    params = pipe.prepare_params(srv.params)
    step_fn = make_sparse_step(pipe)
    flt = pipe.config.classifier_key == "float"
    state = (tuple(pipe.streaming_init(n, dev)), pipe.streaming_features_init(n, dev),
             torch.zeros((n, K), device=dev))
    ticks = list(live) + [(replay[0][t], replay[1][t]) for t in range(REPLAY_TICKS)]
    want = list(outs) + [(replay_out[0][t], replay_out[1][t]) for t in range(REPLAY_TICKS)]
    worst = 0.0
    for t, ((slab, mask), (scores, top)) in enumerate(zip(ticks, want)):
        state, ps, ptop = tick_reference(
            pipe, True, params, state, torch.as_tensor(slab, device=dev),
            torch.as_tensor(mask, device=dev), pipe.state, SMOOTHING, step_fn=step_fn)
        ps = ps.cpu().numpy()
        err = float(np.abs(ps - scores).max())
        _check_top(f"server tick {t}", top, ptop, ps, flt)
        if err > (FLOAT_TOL if flt else SCORE_TOL):
            raise AssertionError(f"server tick {t}: scores differ by {err}")
        worst = max(worst, err)
    if flt:
        worst = max(worst, _gru_diff(srv.state.gru, state[0]))
        if worst > FLOAT_TOL:
            raise AssertionError(f"server GRU state differs from the plain loop by {worst}")
    else:
        for a, b in zip(tree_leaves(srv.state.gru), tree_leaves(state[0])):
            if not torch.equal(a, b):
                raise AssertionError("server GRU state differs from the plain loop")
    for key in ("s1", "s2"):
        if not torch.equal(srv.state.carry[key], state[1][key]):
            raise AssertionError(f"server carry {key} differs from the plain loop")
    return worst


def phase_pipeline(dev, classifier: str):
    """KWSPipeline(classifier=...).streaming_step at 4096 streams, for the
    integer and delta-int backends (θ = 0.15)."""
    import torch

    from repro_torch.core.frontend import tree_leaves
    from repro_torch.kernels import build

    pipe, params = _setup(dev, classifier, THETA if classifier == "delta-int" else None)
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
        raise AssertionError(f"{classifier} streaming_step launches: {counts}")
    cpu_q, cpu_states = q.to("cpu"), pipe.streaming_init(N_STREAMS, "cpu")
    for fv, lg in zip(frames, logits):
        cpu_states, cpu_lg = pipe.streaming_step(cpu_q, cpu_states, fv.cpu())
        if not torch.equal(lg.cpu(), cpu_lg):
            raise AssertionError(f"{classifier} streaming_step differs from the plain version")
    for a, b in zip(tree_leaves(states), tree_leaves(cpu_states)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"{classifier} streaming_step state differs from the plain version")
    print(f"{classifier} streaming_step: {counts['intgemm']} intgemm launches in "
          f"{PIPELINE_STEPS} steps, equal to the plain version")
    return counts["intgemm"]


def tick_bound(n_active: int, raw: bool = True, fires=None, mac_fraction: float = 1.0,
               weight_bytes: int = 24204):
    """Least time for one tick of ``n_active`` streams (all submitting):
    each input byte read once, each output written once, and the
    operations the tick needs at the card's CUDA-core rate.

    A ΔGRU tick (``fires`` given, from `_delta_fires`) reads its whole
    state but writes only what this run's data changes: h and the
    counters always, the x_ref / h_ref columns that fired, and an
    accumulator only where one of its columns fired. It does the
    delta-eligible MACs scaled by the measured effective-MAC fraction
    (plus ~4 operations a column for the thresholds, memories and
    counters)."""
    carry = 2 * C * 4 if raw else 0
    if fires is None:
        state_in = state_out = DENSE_STATE_BYTES
    else:
        column_frac, acc_frac = fires
        mems, accs = 4 * (C + 3 * H), 4 * 4 * G  # x_ref + h_ref, acc_x + acc_h of both layers
        state_in = DELTA_STATE_BYTES
        state_out = DELTA_STATE_BYTES - mems - accs + column_frac * mems + acc_frac * accs
    # input, mask, carry and scores in + out, classifier state in, out, top
    per_stream = ((HOP * 4 if raw else C * 4) + 1 + 2 * (carry + K * 4)
                  + state_in + state_out + 8)
    tables = weight_bytes + 2352 + 4096 * 4 + 2 * 32767 * 4 + 5 * C * 4 + 2 * C * 4
    byts = n_active * per_stream + tables
    iir = 2 * HOP * C * 11 if raw else 0  # per internal sample: 3 fma (2 each), 2 mul, 2 add, abs, acc
    post = C * 10 + 2 * HOP if raw else 0
    delta = 4 * (C + 3 * H) if fires is not None else 0
    macs = mac_fraction * ELIGIBLE_MACS + H * K
    gates = 2 * H * 14
    tail = K * 6
    ops = n_active * (iir + post + delta + 2 * macs + gates + tail)
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _delta_fires(tick, state, ticks: int = 8):
    """(fraction of memory columns that fired, fraction of accumulators
    with a fired column) over ``ticks`` more calls of ``tick()``, which
    advances ``state`` in place with every stream submitting. A column
    fired exactly where its x_ref / h_ref changed, since firing needs
    |value - ref| > θ >= 0."""
    import torch

    fired = columns = touched = accs = 0
    for _ in range(ticks):
        before = [{k: st[k].clone() for k in ("x_ref", "h_ref")} for st in state[0]]
        tick()
        for st, old in zip(state[0], before):
            for key in ("x_ref", "h_ref"):
                changed = st[key] != old[key]
                fired += int(changed.sum())
                columns += changed.numel()
                touched += int(changed.any(dim=1).sum())
                accs += changed.shape[0]
    torch.cuda.synchronize()
    return fired / columns, touched / accs


def intgemm_bound(m: int, k: int, n: int):
    byts = m * k * 4 + k * n + m * n * 4
    ops = 2 * m * k * n
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _fv_traffic(n: int):
    """The reference's sparsity-benchmark traffic (benchmarks/serve_load.py,
    `_traffic`): 8 slabs of N(0, 0.05) FV_Norm frames, every stream
    submitting, cycled tick after tick."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    return [torch.as_tensor(rng.standard_normal((n, C)).astype(np.float32) * 0.05)
            for _ in range(8)]


def phase_times(dev, srv_qat, live):
    """Kernel, plain and library times on CUDA events at the main path's
    shapes, and host-clock ms per step_batch tick."""
    import torch

    from repro_torch.core.frontend import tree_clone
    from repro_torch.core.gru_delta import effective_mac_fraction
    from repro_torch.kernels.intgemm import intgemm, intgemm_ref
    from repro_torch.kernels.tick_fused import pack_operands, tick_fused, tick_reference
    from repro_torch.kernels.tick_fused.gather import make_sparse_step

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
    # the tick kernel, every backend, all streams submitting: raw audio,
    # and for the ΔGRU also the cycled FV traffic
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    audio = [_audio(g, (n, HOP), dev) for _ in range(8)]
    fv_slabs = [x.to(dev) for x in _fv_traffic(n)]
    full = torch.ones(n, dtype=torch.bool, device=dev)
    for classifier, theta in (("qat", None), ("integer", None), ("float", None),
                              ("delta", 0.0), ("delta", THETA),
                              ("delta-int", 0.0), ("delta-int", THETA)):
        pipe, params = _setup(dev, classifier, theta)
        params = pipe.prepare_params(params)
        ops = pack_operands(pipe, params, pipe.state, dev)
        step_fn = make_sparse_step(pipe)
        delta = pipe.classifier.is_delta
        kinds = (("raw", audio), ("fv", fv_slabs)) if delta else (("raw", audio),)
        for kind, slabs in kinds:
            raw = kind == "raw"
            state = (tuple(pipe.streaming_init(n, dev)), pipe.streaming_features_init(n, dev),
                     torch.zeros((n, K), device=dev))
            tick = [0]

            def run():
                inp = slabs[tick[0] % len(slabs)]
                tick[0] += 1
                tick_fused(pipe, raw, params, state, inp, full, pipe.state, SMOOTHING,
                           operands=ops)

            key = f"{_label(classifier, theta)} {kind}"
            out[f"{key} ms"], out[f"{key} enqueue_us"] = _cuda_ms(run, reps=200, hold=True)
            frac, fires, extra = 1.0, None, ""
            if delta:
                frac = float(effective_mac_fraction(list(state[0]), pipe.config.gru).mean())
                fires = _delta_fires(run, state)
                out[f"{key} fired_columns"], out[f"{key} fired_accumulators"] = fires
                extra = (f", effective-MAC fraction {frac:.4f}, per tick {fires[0]:.4f} of "
                         f"the columns and {fires[1]:.4f} of the accumulators fired")
            out[f"{key} mac_fraction"] = frac
            out[f"{key} plain_ms"], _ = _cuda_ms(
                lambda: tick_reference(pipe, raw, params, tree_clone(state), slabs[0], full,
                                       pipe.state, SMOOTHING, step_fn=step_fn),
                reps=2, warmup=1)
            out[f"{key} bound_ms"], out[f"{key} bound_by"] = tick_bound(
                n, raw, fires, frac, 4 * 24204 if classifier == "float" else 24204)
            print(f"tick_fused {key}: {out[f'{key} ms']:.5f} ms on the card "
                  f"({out[f'{key} enqueue_us']:.1f} µs host enqueue a call), plain "
                  f"{out[f'{key} plain_ms']:.2f} ms, bound {out[f'{key} bound_ms']:.5f} ms "
                  f"({out[f'{key} bound_by']}){extra}")
    # intgemm at the largest gate shape of the integer tick
    x = torch.randint(-8192, 8192, (n, H), generator=g, device=dev, dtype=torch.int32)
    w = torch.randint(-128, 128, (H, G), generator=g, device=dev, dtype=torch.int8)
    x64, w64 = x.to(torch.float64), w.to(torch.float64)
    out["intgemm_ms"], out["intgemm_enqueue_us"] = _cuda_ms(lambda: intgemm(x, w), reps=200,
                                                            hold=True)
    out["intgemm_plain_ms"], _ = _cuda_ms(lambda: intgemm_ref(x, w), reps=20, hold=True)
    out["intgemm_library_ms"], _ = _cuda_ms(lambda: torch.matmul(x64, w64), reps=200, hold=True)
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

    launches = {}
    servers = {}
    for classifier, theta in SERVER_RUNS:
        pipe, srv, live, replay, outs, replay_out, counts, live_s = drive_server(
            dev, classifier, theta)
        want = LIVE_TICKS + REPLAY_TICKS
        delta = pipe.classifier.is_delta
        if counts.get("tick_fused", 0) != want or counts.get("intgemm", 0):
            raise AssertionError(f"server {classifier}: launches {counts}, want "
                                 f"tick_fused={want} and no intgemm")
        launches[classifier] = counts
        err = check_server(dev, pipe, srv, live, replay, outs, replay_out)
        tick_err[classifier] = max(tick_err[classifier], err)
        extra = f"; mean srv.sparsity {float(srv.sparsity.mean()):.4f}" if delta else ""
        print(f"server {_label(classifier, theta)}: {LIVE_TICKS} step_batch + {REPLAY_TICKS} "
              f"run_batch ticks at {N_STREAMS} streams, launches {counts}, equal to the plain "
              f"tick loop (scores within {err:.3g}); live ticks took {live_s:.3f} s{extra}")
        servers[classifier] = (srv, live)
    intgemm_launches = sum(phase_pipeline(dev, c) for c in ("integer", "delta-int"))

    times = phase_times(dev, *servers["qat"])
    print(f"step_batch at {N_STREAMS} streams (qat, raw audio, host slab in, host "
          f"scores out): {times['step_batch_ms']:.4f} ms per tick")

    def tick_entry(name, key, n_launches, err, replaces="src/repro/kernels/tick_fused/kernel.py:256"):
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/tick_fused.cu", "replaces": replaces,
            "launches": n_launches, "max_abs_err": err,
            "ms": times[f"{key} ms"], "plain_ms": times[f"{key} plain_ms"],
            "bound_ms": times[f"{key} bound_ms"], "bound_by": times[f"{key} bound_by"],
            "library_ms": None,
        }

    d_key = f"{_label('delta', THETA)} raw"
    kernels = [
        tick_entry("tick_fused", "qat raw",
                   launches["qat"]["tick_fused"] + launches["integer"]["tick_fused"],
                   max(tick_err["qat"], tick_err["integer"])),
        tick_entry("tick_fused[float]", "float raw", launches["float"]["tick_fused"],
                   tick_err["float"]),
        tick_entry("tick_fused[delta]", d_key, launches["delta"]["tick_fused"],
                   tick_err["delta"]),
        tick_entry("tick_fused[delta-int]", f"{_label('delta-int', THETA)} raw",
                   launches["delta-int"]["tick_fused"], tick_err["delta-int"]),
        # K4 runs inside the ΔGRU tick: one per delta / delta-int tick_fused launch
        tick_entry("delta_gather", d_key,
                   launches["delta"]["tick_fused"] + launches["delta-int"]["tick_fused"],
                   max(tick_err["delta"], tick_err["delta-int"]),
                   replaces="src/repro/kernels/tick_fused/kernel.py:76"),
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
    print(json.dumps({"times": times}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
