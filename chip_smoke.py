#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

Run from the root of the repository: ``python3 chip_smoke.py``. It
drives the port's main paths at the paper's full width (random weights
and a die drawn from a seed) and holds each CUDA kernel against its
plain PyTorch version on the card:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds every kernel from ``src/repro_torch/kernels/csrc`` with nvcc
     (one process per source, all at once) and prints ptxas' registers /
     shared memory / spills;
  3. intgemm against its plain version at the classifier's shapes, a
     saturating case and 1x1x1: bit-equal;
  4. calibration: a die drawn from a torch.Generator on the card and
     calibrated there (`init_frontend_state`); the noiseless bench on
     the card equals the same bench on the CPU;
  5. the batch features path: `record_features` of 128 seeded 1 s clips
     (batches of 64) for the software, hardware and hardware-pallas
     frontends, each with its launch counts (K1; the K1 scan entry; the
     scan entry and K5) and its warm time (`record_times`); codes equal
     to the CPU's on a small input;
     K1, the scan entry and K5 against their plain versions at the
     path's shapes (bit-equal), K1 and the scan entry also at the edges of
     their geometry (`fex_edges`: frames of 512 / 100 / 20, float32 and
     bfloat16, C 1..33, B 1..33, T 1..1001, unaligned audio, the carry
     across two calls), K5 within 1 count of the float64 oracle
     (also at b = frames = c = 1), hardware-pallas within the
     reference's 2 LSB of hardware; norm stats fitted from the recorded
     hardware-pallas codes;
  6. tick_fused against the plain tick for the five backends (delta and
     delta-int at θ = 0 and 0.15, held against the plain tick with K4's
     plain gather step), raw audio and FV_Norm, with the software
     frontend and, on raw audio, the hardware frontend on the calibrated
     die, over ticks with partial masks and an all-idle tick: state
     (ΔGRU memories, accumulators and counters, the hardware carry
     {s1, s2, r, j}), FV codes and top bit-equal, scores within 1e-6;
     float within FLOAT_TOL;
  7. the server at 4096 streams: each backend with the software frontend,
     and qat and delta (θ = 0.15) with the hardware frontend; step_batch
     ticks and a run_batch, every tick held against the plain tick loop;
     tick_fused launches once per tick (running K4 inside for delta /
     delta-int) and no other kernel; the mean of srv.sparsity for the
     ΔGRU runs;
  8. the integer and delta-int pipelines' streaming_step: 5 intgemm
     launches per step, equal to the plain version;
  9. the cascaded server at 4096 streams on traffic where the gate gates
     (half the streams -60 dB noise, half tone plus noise): qat and
     delta-int with the energy gate at 0.15, delta (θ = 0.15) at 0.1 with
     hangover 3 and decay 0.9, qat on the calibrated die with a "linear"
     detector fitted on the card from the die's FV_Norm frames (0.5,
     hangover 3; one fma_rows launch a step, the fit equal to the same
     fit on the CPU, the kernel bit-equal to its plain version), and an
     always-on qat server equal to the ungated one;
     every tick held against the plain tick loop (detector state, GRU
     state, top, srv.sparsity equal, scores within 1e-6), one tick_fused
     launch per tick, the mean srv.wake_rate per server;
 10. the async ingress on the qat server at 4096 streams: 64 ticks through
     step_batch, PipelinedIngress(depth=2, window=1) and (window=4), 8
     through TickCoalescer, each equal to the step_batch sequence, with
     its launches and ms per tick (host clock); metrics on against off;
 11. the fleet at 4096 slots with 3072 streams open (qat and delta-int,
     raw audio): a server resized 4096 -> 8192 -> 4096 between ticks, a
     server of four shards on the one card (one tick_fused launch a shard
     a tick) that then loses shard 1 (`recover_shard_loss`: the survivors
     unchanged, the lost streams reopened zeroed), and an Autoscaler over
     a seeded ramp / peak / drain trace that grows and shrinks, each equal
     per stream id to an unsharded fixed-capacity twin (state and scores);
     the host ms of each resize and recovery and of the first and second
     step_batch after it, the qat tick on 1 and on 4 shards (device ms, launches a tick);
     `logits_all_frames` and `predict` (integer: K2, and K1 for predict's
     features) equal to the CPU plain path;
12. the serving command line (`python -m repro_torch.serving.serve_streaming`,
     `phase_driver`) in process at 32 streams x 62 ticks: qat live, integer
     --offline, delta-int --cascade --pipelined --window 4 (a partial last
     window), the hardware frontend with --metrics --autoscale, float on two
     shards of the card with a live --grow; one tick_fused launch a tick a
     shard; each run equal per stream to the same driver with --device cpu
     (run meanwhile in a process of its own on the card run's params, norm
     stats and frontend state); ms a tick on the host clock; then the
     quickstart (`repro_torch.quickstart.run`) on the card: K1's frames equal
     to the plain version, the integer scores bit-identical to qat, the
     FV_Raw diffs of the CPU run;
13. QAT training through `training.kws.train` (the entry point of
     ``python -m repro_torch.training.kws``): the synthetic corpus (24
     clips a class, test set seed 1) recorded on the card (K1), 25 steps
     at batch 64 with AdamW and ReduceLROnPlateau and a checkpoint, whose
     leaves are held equal to the state it saved, then a run resumed from
     it to step 50; the loss falls, test accuracy beats 1/12, the integer
     replay (K2) gives the QAT model's logits and confusion matrix; one
     step's gradients on the card within 1e-5 of max |g| of the same step
     on the CPU; a warm step's time, and its device activities and busy
     share under torch.profiler;
14. K6 through `kernels.gru_sequence`: the paper's classifier at full
     width in float (layer 1 16 -> 48 feeding layer 2 48 -> 48) over 4096
     clips of 62 frames, float32 and one bf16 pass of layer 1, one launch
     a layer, each held against the plain version on the card, each
     launch's geometry and blocks an SM (occupancy API); cuDNN's
     `torch.nn.GRU` on the same weights as the library yardstick;
15. K7 through `kernels.wkv6` at rwkv6-7b's head layout and train_4k
     length (8, 4096, 64, 64) in float32, one launch, against the plain
     sequential form (relative to max |y|), strong decay and bf16 at small
     sizes, and the chunked training form at B = 1 timed as information;
16. times on CUDA events after warm-up: ms per step_batch tick and each
     kernel's time beside its plain version's, its bound and a library
     yardstick where one exists (the qat, integer and ΔGRU ticks on raw
     audio and on the reference's sparsity traffic as FV input, the ΔGRU
     at θ = 0 and 0.15, the hardware tick, the gated tick beside the
     ungated one, intgemm beside torch.matmul and as one 16-row block, K1
     and the scan entry at the batch path's shapes (also as one block
     alone, and K1 with frames of 500: `fex_times`), K5 (also with
     every chunk floored by floorf and as one block alone), K6 beside cuDNN,
     K7, the fit's fma_rows beside torch.mv); the tick's phase split
     (qat, integer, and delta / delta-int at θ = 0.15 and 0: the raw
     tick, the FV tick and the FV tick behind a gate that opens for
     nobody give the frontend's and the classifier's shares; for the
     ΔGRU, K4's phase, also its plain sparse step and its own bound); the
     tick kernels' dynamic shared memory and blocks an SM (occupancy
     API); one JSON line per kernel (K4's `delta_gather` with its phase's
     time, plain time and bound), then all kernels in one JSON line;
17. data-parallel QAT training through `training.kws.train(dp=4,
     compress_grads=True, devices=["cuda:0"] * 4)`: the reference
     example's recipe on four shards of the one card, 5 steps (the
     corpus by K1, the integer replay by K2); the first step's loss,
     synced gradients and per-shard residuals against the same step on
     the CPU, a plain DP step against the single-device step; s a step;
18. the LM train step on rwkv6-7b at full width cut to 2 layers: 10 steps
     at 1 x 4096 tokens (s a step, tokens a second, peak memory, the
     loss), a prefill of 4096 tokens and 16 decode steps whose logits
     equal the full forward's within a bfloat16 tolerance;
19. the transformer backbone (attention, the dense MLPs, the one-card MoE
     route) through the same train step: qwen3-4b and granite-moe-3b at
     full width cut in depth to what fits the card, gemma2-27b at full
     width with one local / global step; 4 steps each at 1 x 4096 tokens
     (s a step, tokens a second, peak memory, busy share and top kernels
     of a profiled step), a prefill and 16 decode steps whose logits equal
     a full forward's within a bfloat16 tolerance (gemma2's 4100-token
     prompt wraps its local rings);
20. the model-axis MoE route (`phase_moe_grid`) on device grids whose
     entries are all the card: granite-moe-3b at full width on a (1, 16)
     grid through the transformer's sharded step, 40 experts padded to
     48, GRID_LAYERS deep (the peak `lower_train_step(..., rules=)`
     predicts held to the measured one), its first step against the
     one-card route's within a bfloat16 bound, 3 steps; kimi-k2's
     full-width MoE layer on a (2, 8) grid with FSDP through `moe_apply`,
     128 decode tokens on the weights-stationary path, bf16 and int8
     banks, y against the one-card route's, ms a layer and its busy share;
21. the production meshes (`phase_mesh`): coordinate (0, 0)'s share of
     qwen3-4b x train_4k on the (16, 16) mesh run for real at full depth
     (its peak held to the trace), qwen3-4b trained on a (2, 2) grid of
     the card against the one-card step and its prefill / decode against
     the one-card route, then qwen3-4b's and kimi-k2's cells traced per
     device on both meshes;
22. rwkv6 and zamba2 on the production mesh (`phase_ssm_mesh`):
     coordinate (0, 0)'s share of rwkv6-7b x train_4k on the (16, 16)
     mesh run for real at its 32 layers (its peak held to the trace),
     zamba2-7b trained on a (2, 2) grid of the card at 12 layers against
     the one-card step and its prefill / decode against the one-card
     route, then their train_4k and decode_32k cells traced per device;
23. the result line ``{"ok": true, "device": {...}}``.

Every failure raises, so the exit code is not 0. Without a CUDA device,
or run outside a checkout of the repository, it exits 1 and prints no
result. Two studies print the readings behind tolerances instead of
running the phases: ``--zamba2-drift`` (ZAMBA_F32_TOL) and
``--mesh-faults [ARCH]`` (MESH_GRID_*_TOL, ZAMBA_GRID_*_TOL);
``--ssm-mesh`` runs `phase_ssm_mesh` alone.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
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
HW_LIVE_TICKS = 12  # hardware-frontend server runs
HW_REPLAY_TICKS = 4
FEATURE_CLIPS = 128  # batch features: 1 s clips at 16 kHz
CLIP_SAMPLES = 16000
FEATURE_BATCH = 64
THETA = 0.15  # the reference's ΔGRU operating point
# (classifier, θ) of the server runs, the main path
SERVER_RUNS = (("qat", None), ("integer", None), ("float", None),
               ("delta", THETA), ("delta-int", THETA))
# ... and of the hardware-frontend server runs
HW_SERVER_RUNS = (("qat", None), ("delta", THETA))
# stream hold before a timed burst: cycles a millisecond at the H100's
# ~2 GHz clock
HOLD_CYCLES_PER_MS = 2_000_000
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
    the host to enqueue every call (at least 1 ms a call, and four times
    the slowest warm-up call's enqueue after the first), so the events
    time the kernels back to back and not the host's enqueue rate (a
    kernel shorter than its wrapper's Python would otherwise be timed at
    the wrapper's speed)."""
    import torch

    warm_s = []
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        warm_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    hold_ms = max(1.0, 4e3 * max(warm_s[1:] or warm_s or [0.0]))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(int(HOLD_CYCLES_PER_MS * hold_ms * reps))
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    stop.record()
    stop.synchronize()
    enqueue_us = enqueue_s / reps * 1e6
    if hold and enqueue_us > 500.0 * hold_ms:
        raise AssertionError(f"enqueue took {enqueue_us:.0f} µs a call; the hold of "
                             f"{hold_ms:.2f} ms a call is too short")
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


def _setup(dev, classifier: str, theta=None, hw_state=None, cascade=None):
    """A pipeline with fitted norm stats (ΔGRU thresholds θ for the delta
    backends, the stage-1 gate ``cascade`` when given) and random float
    params from the seed, on ``dev``. With ``hw_state`` (a calibrated die
    with its norm stats) the pipeline serves the "hardware" frontend on
    that die."""
    import torch

    from repro_torch.core import fex
    from repro_torch.core.gru_delta import DeltaConfig
    from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig

    delta = None if theta is None else DeltaConfig(theta, theta)
    if hw_state is not None:
        pipe = KWSPipeline(KWSPipelineConfig(frontend="hardware", classifier=classifier,
                                             delta=delta, cascade=cascade), state=hw_state)
        params = pipe.init_params(torch.Generator().manual_seed(SEED + 1), device=dev)
        return pipe, params
    stats = _norm_stats()
    stats = fex.FExNormStats(mu=stats.mu.to(dev), sigma=stats.sigma.to(dev))
    pipe = KWSPipeline(KWSPipelineConfig(classifier=classifier, delta=delta, cascade=cascade),
                       norm_stats=stats)
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


def _label(classifier, theta, hardware=False):
    label = classifier if theta is None else f"{classifier} θ={theta}"
    return f"{label} hardware" if hardware else label


def phase_tick(dev, hw_state=None):
    """tick_fused against tick_reference on the card, for every backend
    (with ``hw_state``: the hardware frontend on that die, raw audio
    only); returns {classifier: worst difference} (scores, and the state
    too for float)."""
    import torch

    from repro_torch.core.frontend import tree_clone, tree_leaves
    from repro_torch.kernels.tick_fused import pack_operands, tick_fused, tick_reference
    from repro_torch.kernels.tick_fused.gather import make_sparse_step

    worst = {}
    n = N_STREAMS
    for classifier, theta in (("qat", None), ("integer", None), ("float", None),
                              ("delta", 0.0), ("delta", THETA),
                              ("delta-int", 0.0), ("delta-int", THETA)):
        pipe, params = _setup(dev, classifier, theta, hw_state)
        params = pipe.prepare_params(params)
        ops = pack_operands(pipe, params, pipe.state, dev)
        step_fn = make_sparse_step(pipe)  # K4's plain version for the ΔGRU
        flt = classifier == "float"
        hw = hw_state is not None
        for raw in ((True,) if hw else (True, False)):
            state = (tuple(pipe.streaming_init(n, dev)), pipe.streaming_features_init(n, dev),
                     torch.zeros((n, K), device=dev), None)
            g = torch.Generator(device=dev).manual_seed(SEED + 3)
            for t, frac in enumerate([1.0, 0.6, 0.0, 0.9, 0.3]):
                if raw:
                    inp = _audio(g, (n, HOP), dev)
                else:
                    inp = torch.round(torch.randn((n, C), generator=g, device=dev) * 512) / 256
                mask = torch.rand(n, generator=g, device=dev) < frac
                (pg, pc, ps, _), _, ptop = tick_reference(
                    pipe, raw, params, tree_clone(state), inp, mask, pipe.state, SMOOTHING,
                    step_fn=step_fn)
                fv = torch.zeros((n, C), device=dev)
                (kg, kc, ks, _), _, ktop = tick_fused(
                    pipe, raw, params, tree_clone(state), inp, mask, pipe.state, SMOOTHING,
                    operands=ops, fv_out=fv)
                torch.cuda.synchronize()
                where = (f"tick_fused {_label(classifier, theta, hw)} "
                         f"{'raw' if raw else 'fv'} tick {t}")
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
                for key in pc:
                    if not torch.equal(kc[key], pc[key]):
                        raise AssertionError(f"{where}: carry {key} differs")
                if raw:
                    _, pfv = pipe.streaming_features_apply(tree_clone(state)[1], inp, pipe.state)
                    if not torch.equal(fv[mask], pfv[mask]):
                        raise AssertionError(f"{where}: FV codes differ")
                worst[classifier] = max(worst.get(classifier, 0.0), err)
                state = (kg, kc, ks, None)
            print(f"tick_fused {_label(classifier, theta, hw)} {'raw' if raw else 'fv'}: 5 ticks "
                  f"equal to the plain tick" + (f" within {worst[classifier]:.3g}" if flt else ""))
    return worst


def _noise_traffic(live_ticks: int, replay_ticks: int):
    """Noise hops with per-stream gains from -40 dB to -6 dB full scale;
    85 % of the streams submit per tick, tick 7 is all-idle."""
    import numpy as np

    rng = np.random.default_rng(SEED + 4)
    gains = np.logspace(-2, -0.3, N_STREAMS).astype(np.float32)[:, None]
    live = [((rng.standard_normal((N_STREAMS, HOP)).astype(np.float32) * gains),
             rng.random(N_STREAMS) < (0.0 if t == 7 else 0.85)) for t in range(live_ticks)]
    replay = (rng.standard_normal((replay_ticks, N_STREAMS, HOP)).astype(np.float32) * gains,
              rng.random((replay_ticks, N_STREAMS)) < 0.85)
    return live, replay


def _cascade_hops(n_ticks: int, seed: int):
    """(n_ticks, N_STREAMS, HOP) hops where the gate really gates: the
    first half of the streams is noise at -60 dB full scale (silence), the
    second half a tone (200 Hz - 6 kHz) plus noise, continuous across
    hops, at -40 dB to -6 dB full scale."""
    import numpy as np

    rng = np.random.default_rng(seed)
    half = N_STREAMS // 2
    hops = rng.standard_normal((n_ticks, N_STREAMS, HOP)).astype(np.float32) * 1e-3
    t = np.arange(n_ticks * HOP).reshape(n_ticks, 1, HOP) / 16000.0
    freq = rng.uniform(200, 6000, (1, N_STREAMS - half, 1))
    gains = np.logspace(-2, -0.3, N_STREAMS - half)[None, :, None]
    tone = 0.7 * np.sin(2 * np.pi * freq * t) + 0.3 * rng.standard_normal(
        (n_ticks, N_STREAMS - half, HOP))
    hops[:, half:] = (tone * gains).astype(np.float32)
    return hops


def _cascade_traffic(live_ticks: int, replay_ticks: int):
    """`_cascade_hops` as live ticks (85 % submitting, tick 7 all-idle)
    and a replay."""
    import numpy as np

    rng = np.random.default_rng(SEED + 8)
    hops = _cascade_hops(live_ticks + replay_ticks, SEED + 9)
    live = [(hops[t], rng.random(N_STREAMS) < (0.0 if t == 7 else 0.85))
            for t in range(live_ticks)]
    replay = (hops[live_ticks:], rng.random((replay_ticks, N_STREAMS)) < 0.85)
    return live, replay


def drive_server(dev, classifier: str, theta=None, hw_state=None, live_ticks=LIVE_TICKS,
                 replay_ticks=REPLAY_TICKS, cascade=None, traffic=_noise_traffic):
    """The main path: a user's StreamingKWSServer on the card (the
    hardware frontend on ``hw_state``'s die when given, the stage-1 gate
    ``cascade`` when given), fed by ``traffic(live_ticks, replay_ticks)``.
    Returns the server's outputs, the inputs and the launch counts of the
    run."""
    from repro_torch.kernels import build
    from repro_torch.serving.serve_loop import StreamingKWSServer

    pipe, params = _setup(dev, classifier, theta, hw_state, cascade)
    srv = StreamingKWSServer(pipe, params, max_streams=N_STREAMS, smoothing=SMOOTHING)
    for sid in range(N_STREAMS):
        srv.open_stream(sid)
    live, replay = traffic(live_ticks, replay_ticks)
    build.launches.clear()
    t0 = time.perf_counter()
    outs = [srv.step_batch(slab, mask) for slab, mask in live]
    live_s = time.perf_counter() - t0
    replay_out = srv.run_batch(*replay)
    counts = dict(build.launches)
    return pipe, srv, live, replay, outs, replay_out, counts, live_s


def check_server(dev, pipe, srv, live, replay, outs, replay_out):
    """Replay the same inputs through the plain tick loop on the card (with
    K4's plain gather step for the ΔGRU backends): scores within the
    tolerance, top, the GRU state, the carry, the cascade's detector state
    and srv.sparsity equal."""
    import numpy as np
    import torch

    from repro_torch.core.frontend import tree_leaves
    from repro_torch.core.gru_delta import effective_mac_fraction
    from repro_torch.kernels.tick_fused import tick_reference
    from repro_torch.kernels.tick_fused.gather import make_sparse_step
    from repro_torch.serving.cascade import init_state

    n = N_STREAMS
    params = pipe.prepare_params(srv.params)
    step_fn = make_sparse_step(pipe)
    flt = pipe.config.classifier_key == "float"
    det = None if pipe.config.cascade is None else init_state(n, dev)
    state = (tuple(pipe.streaming_init(n, dev)), pipe.streaming_features_init(n, dev),
             torch.zeros((n, K), device=dev), det)
    n_replay = len(replay[0])
    ticks = list(live) + [(replay[0][t], replay[1][t]) for t in range(n_replay)]
    want = list(outs) + [(replay_out[0][t], replay_out[1][t]) for t in range(n_replay)]
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
    for key in state[1]:
        if not torch.equal(srv.state.carry[key], state[1][key]):
            raise AssertionError(f"server carry {key} differs from the plain loop")
    for key in (state[3] or {}):
        if not torch.equal(srv.state.det[key], state[3][key]):
            raise AssertionError(f"server detector state {key} differs from the plain loop")
    if pipe.classifier.is_delta:
        plain = effective_mac_fraction(
            [{k: st[k].cpu() for k in ("skipped", "total")} for st in state[0]],
            pipe.config.gru).numpy()
        if not np.array_equal(srv.sparsity, plain):
            raise AssertionError("server sparsity differs from the plain loop")
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
               weight_bytes: int = 24204, hardware: bool = False, n_woken=None):
    """Least time for one tick of ``n_active`` streams (all submitting):
    each input byte read once, each output written once, and the
    operations the tick needs at the card's CUDA-core rate.

    ``n_woken`` (a cascaded tick): the stage-1 gate adds, per submitting
    stream, its 16 feature reads, ~40 operations (the linear detector's
    multiply-adds and sigmoid; the energy score needs fewer) and its four
    state leaves (13 bytes) read and written; the classifier's state,
    operations and scores count only for the ``n_woken`` streams the gate
    let through (the gated ones need nothing of it).

    A ΔGRU tick (``fires`` given, from `_delta_fires`) reads its whole
    state but writes only what this run's data changes: h and the
    counters always, the x_ref / h_ref columns that fired, and an
    accumulator only where one of its columns fired. It does the
    delta-eligible MACs scaled by the measured effective-MAC fraction
    (plus ~4 operations a column for the thresholds, memories and
    counters). ``hardware``: the hardware frontend's VTC and SRO
    operations, its extra carry and its per-channel calibration."""
    woken = n_active if n_woken is None else n_woken
    carry = 2 * C * 4 if raw else 0
    # the hardware carry adds r (read and written) and j (read only)
    carry_extra = 3 * C * 4 if raw and hardware else 0
    # input, mask, carry and top; scores in + out and the classifier
    # state in and out for the streams the classifier runs for
    per_stream = (HOP * 4 if raw else C * 4) + 1 + 2 * carry + carry_extra + 8
    per_woken, woken_ops = classifier_work(fires, mac_fraction)
    det_bytes = 2 * 13 if n_woken is not None else 0
    tables = weight_bytes + 2352 + 4096 * 4 + 2 * 32767 * 4 + 5 * C * 4 + 2 * C * 4
    tables += 3 * C * 4 if hardware else 0  # gain, beta, alpha
    byts = n_active * (per_stream + det_bytes) + woken * per_woken + tables
    iir = 2 * HOP * C * 11 if raw else 0  # per internal sample: 3 fma (2 each), 2 mul, 2 add, abs, acc
    if raw and hardware:  # + VTC (2 mul, add, fma), SRO (fma, mul, max)
        iir = 2 * HOP * C * (11 + 5 + 4)
    post = C * 10 + 2 * HOP if raw else 0
    gate_ops = 40 if n_woken is not None else 0
    ops = n_active * (iir + post + gate_ops) + woken * woken_ops
    return _bound(byts, ops)


def classifier_work(fires=None, mac_fraction: float = 1.0):
    """(bytes, operations) of the classifier for one stream it runs for:
    the scores read and written and the classifier state (a ΔGRU's as
    `tick_bound` counts it: read whole, written where this run's data
    changed it); the thresholds (~4 operations a column), the MACs (the
    delta-eligible ones times ``mac_fraction``, and the FC head), the
    gates and the tail."""
    if fires is None:
        state_in = state_out = DENSE_STATE_BYTES
    else:
        column_frac, acc_frac = fires
        mems, accs = 4 * (C + 3 * H), 4 * 4 * G  # x_ref + h_ref, acc_x + acc_h of both layers
        state_in = DELTA_STATE_BYTES
        state_out = DELTA_STATE_BYTES - mems - accs + column_frac * mems + acc_frac * accs
    delta = 4 * (C + 3 * H) if fires is not None else 0
    macs = mac_fraction * ELIGIBLE_MACS + H * K
    gates = 2 * H * 14
    tail = K * 6
    return 2 * K * 4 + state_in + state_out, delta + 2 * macs + gates + tail


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


# the tick runs timed on CUDA events: (classifier, θ, hardware, inputs);
# qat and integer run on FV input too (beside raw: the frontend's share)
TICK_RUNS = (("qat", None, False, ("raw", "fv")), ("integer", None, False, ("raw", "fv")),
             ("float", None, False, ("raw",)), ("delta", 0.0, False, ("raw", "fv")),
             ("delta", THETA, False, ("raw", "fv")), ("delta-int", 0.0, False, ("raw", "fv")),
             ("delta-int", THETA, False, ("raw", "fv")), ("qat", None, True, ("raw",)),
             ("delta", THETA, True, ("raw",)))
# a cascade whose gate opens for nobody: the FV tick without its classifier
SHUT_GATE_THRESHOLD = 1e9


def tick_times(dev, hw_state, runs=TICK_RUNS, plain: bool = True):
    """The tick kernel's ms on CUDA events at N_STREAMS, all streams
    submitting, for each of ``runs`` (the hardware runs on ``hw_state``'s
    die): raw audio hops, and the reference's sparsity traffic as FV
    input; with ``plain`` also the plain tick's ms and the bound."""
    import torch

    from repro_torch.core.frontend import tree_clone
    from repro_torch.core.gru_delta import effective_mac_fraction
    from repro_torch.kernels.tick_fused import pack_operands, tick_fused, tick_reference
    from repro_torch.kernels.tick_fused.gather import make_sparse_step

    n = N_STREAMS
    out = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    slabs_of = {"raw": [_audio(g, (n, HOP), dev) for _ in range(8)],
                "fv": [x.to(dev) for x in _fv_traffic(n)]}
    full = torch.ones(n, dtype=torch.bool, device=dev)
    for classifier, theta, hw, kinds in runs:
        pipe, params = _setup(dev, classifier, theta, hw_state if hw else None)
        params = pipe.prepare_params(params)
        ops = pack_operands(pipe, params, pipe.state, dev)
        step_fn = make_sparse_step(pipe)
        delta = pipe.classifier.is_delta
        for kind in kinds:
            raw, slabs = kind == "raw", slabs_of[kind]
            state = (tuple(pipe.streaming_init(n, dev)), pipe.streaming_features_init(n, dev),
                     torch.zeros((n, K), device=dev), None)
            tick = [0]

            def run():
                inp = slabs[tick[0] % len(slabs)]
                tick[0] += 1
                tick_fused(pipe, raw, params, state, inp, full, pipe.state, SMOOTHING,
                           operands=ops)

            key = f"{_label(classifier, theta, hw)} {kind}"
            out[f"{key} ms"], out[f"{key} enqueue_us"] = _cuda_ms(run, reps=200, hold=True)
            if not plain:
                print(f"tick_fused {key}: {out[f'{key} ms']:.5f} ms on the card")
                continue
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
                n, raw, fires, frac, 4 * 24204 if classifier == "float" else 24204, hw)
            print(f"tick_fused {key}: {out[f'{key} ms']:.5f} ms on the card "
                  f"({out[f'{key} enqueue_us']:.1f} µs host enqueue a call), plain "
                  f"{out[f'{key} plain_ms']:.2f} ms, bound {out[f'{key} bound_ms']:.5f} ms "
                  f"({out[f'{key} bound_by']}){extra}")
    return out


# the phase split's FV ticks behind a shut gate: (classifier, θ)
SPLIT_RUNS = (("qat", None), ("integer", None), ("delta", THETA), ("delta", 0.0),
              ("delta-int", THETA), ("delta-int", 0.0))


def phase_split(dev, times, runs=SPLIT_RUNS):
    """The tick's time split by modes the kernel already has: the FV ticks
    (``times``, from `tick_times`) beside their raw ticks give the
    frontend's share; the FV tick behind a cascade whose gate opens for
    nobody (the detector and the tail run, the classifier of every block
    idles; a ΔGRU block still stages its state) beside the ungated FV tick
    gives the classifier's share. For the ΔGRU runs (K4's phase) also the
    phase's own bound (`classifier_work` at the FV tick's fires, where
    ``times`` has them) and its plain version: the sparse classifier step
    (`make_sparse_step`, K4's plain gather) on the same FV input. Prints
    one line a run; returns the times."""
    import torch

    from repro_torch.kernels.tick_fused import pack_operands, tick_fused
    from repro_torch.kernels.tick_fused.gather import make_sparse_step
    from repro_torch.serving.cascade import CascadeConfig, init_state

    n = N_STREAMS
    slabs = [x.to(dev) for x in _fv_traffic(n)]
    full = torch.ones(n, dtype=torch.bool, device=dev)
    out = {}
    for classifier, theta in runs:
        pipe, params = _setup(dev, classifier, theta, cascade=CascadeConfig(
            wake_threshold=SHUT_GATE_THRESHOLD))
        params = pipe.prepare_params(params)
        ops = pack_operands(pipe, params, pipe.state, dev)
        state = (tuple(pipe.streaming_init(n, dev)), pipe.streaming_features_init(n, dev),
                 torch.zeros((n, K), device=dev), init_state(n, dev))
        tick = [0]

        def run():
            tick_fused(pipe, False, params, state, slabs[tick[0] % len(slabs)], full,
                       pipe.state, SMOOTHING, operands=ops)
            tick[0] += 1

        label = _label(classifier, theta)
        key = f"{label} fv shut"
        out[f"{key} ms"], _ = _cuda_ms(run, reps=200, hold=True)
        torch.cuda.synchronize()
        if int(state[3]["woken"].sum()) != 0:
            raise AssertionError(f"{key}: the shut gate woke a stream")
        raw_ms, fv_ms = times[f"{label} raw ms"], times[f"{label} fv ms"]
        out[f"{label} split frontend_ms"] = raw_ms - fv_ms
        out[f"{label} split classifier_ms"] = fv_ms - out[f"{key} ms"]
        out[f"{label} split rest_ms"] = out[f"{key} ms"]
        extra = ""
        if pipe.classifier.is_delta:
            step_fn = make_sparse_step(pipe)
            states = tuple(pipe.streaming_init(n, dev))
            out[f"{label} split classifier plain_ms"], _ = _cuda_ms(
                lambda: step_fn(params, list(states), slabs[0], full), reps=2, warmup=1)
            extra = f"; plain sparse step {out[f'{label} split classifier plain_ms']:.3f} ms"
            fires = times.get(f"{label} fv fired_columns")
            if fires is not None:
                byts, n_ops = classifier_work(
                    (fires, times[f"{label} fv fired_accumulators"]),
                    times[f"{label} fv mac_fraction"])
                bound = _bound(n * byts, n * n_ops)
                out[f"{label} split classifier bound_ms"], out[
                    f"{label} split classifier bound_by"] = bound
                extra += f", the phase's bound {bound[0]:.5f} ms ({bound[1]})"
        print(f"phase split {label}: raw tick {raw_ms:.5f} ms, FV tick {fv_ms:.5f} ms, "
              f"FV tick with the gate shut {out[f'{key} ms']:.5f} ms: frontend "
              f"{raw_ms - fv_ms:.5f} ms, classifier {fv_ms - out[f'{key} ms']:.5f} ms, "
              f"the rest (launch, staging, detector, tail) {out[f'{key} ms']:.5f} ms{extra}")
    return out


def intgemm_times(dev):
    """intgemm at the largest gate shape of the integer tick, beside its
    plain version and torch.matmul on float64 copies (the library
    yardstick: CUDA has no integer matmul)."""
    import torch

    from repro_torch.kernels.intgemm import intgemm, intgemm_ref

    n = N_STREAMS
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    x = torch.randint(-8192, 8192, (n, H), generator=g, device=dev, dtype=torch.int32)
    w = torch.randint(-128, 128, (H, G), generator=g, device=dev, dtype=torch.int8)
    x64, w64 = x.to(torch.float64), w.to(torch.float64)
    out = {}
    out["intgemm_ms"], out["intgemm_enqueue_us"] = _cuda_ms(lambda: intgemm(x, w), reps=200,
                                                            hold=True)
    out["intgemm_plain_ms"], _ = _cuda_ms(lambda: intgemm_ref(x, w), reps=20, hold=True)
    out["intgemm_library_ms"], _ = _cuda_ms(lambda: torch.matmul(x64, w64), reps=200, hold=True)
    out["intgemm_bound_ms"], out["intgemm_bound_by"] = intgemm_bound(n, H, G)
    # one 16-row block: the launch and one block's staging and tile, the
    # floor under the full call
    x16 = x[:16].contiguous()
    out["intgemm one_block_ms"], _ = _cuda_ms(lambda: intgemm(x16, w), reps=200, hold=True)
    print(f"intgemm ({n}, {H}) x ({H}, {G}): {out['intgemm_ms']:.6f} ms on the card, "
          f"torch.matmul (float64) {out['intgemm_library_ms']:.6f} ms, plain "
          f"{out['intgemm_plain_ms']:.4f} ms, bound {out['intgemm_bound_ms']:.6f} ms "
          f"({out['intgemm_bound_by']}); one 16-row block {out['intgemm one_block_ms']:.6f} ms")
    return out


def phase_times(dev, srv_qat, live, hw_state):
    """Kernel, plain and library times on CUDA events at the main path's
    shapes (the hardware tick on ``hw_state``'s die), the dense tick's
    phase split, and host-clock ms per step_batch tick."""
    import torch

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
    out.update(tick_times(dev, hw_state))
    out.update(phase_split(dev, out))
    out.update(intgemm_times(dev))
    from repro_torch.kernels.tick_fused.ops import occupancy

    for backend in ("qat", "float", "delta"):
        smem, blocks = occupancy(backend)
        out[f"tick {backend} smem_bytes"], out[f"tick {backend} blocks_per_sm"] = smem, blocks
        print(f"tick_fused {backend}: {smem} B dynamic shared memory, {blocks} blocks an SM "
              f"(occupancy API)")
    return out


def _clips(n: int, samples: int = CLIP_SAMPLES):
    """Seeded 16 kHz clips: a tone (200 Hz - 6 kHz) plus noise, with
    per-clip gains from -40 dB to -6 dB full scale."""
    import numpy as np

    rng = np.random.default_rng(SEED + 7)
    t = np.arange(samples) / 16000.0
    tones = np.sin(2 * np.pi * rng.uniform(200, 6000, (n, 1)) * t)
    gains = np.logspace(-2, -0.3, n)[:, None]
    return ((0.7 * tones + 0.3 * rng.standard_normal((n, samples))) * gains).astype(np.float32)


def _state_to(state, device):
    """A FrontendState with every tensor moved to ``device``."""
    import dataclasses

    from repro_torch.core.fex import FExNormStats
    from repro_torch.core.tdfex import TDFExState

    mv = lambda t: None if t is None else t.to(device)  # noqa: E731
    chip, ns = state.chip, state.norm_stats
    return dataclasses.replace(
        state, beta=mv(state.beta), alpha=mv(state.alpha), coeffs=mv(state.coeffs),
        chip=None if chip is None else TDFExState(mv(chip.gain_mismatch), mv(chip.cf_mismatch)),
        norm_stats=None if ns is None else FExNormStats(mv(ns.mu), mv(ns.sigma)),
    )


def _once_ms(fn):
    """(device ms of one call of ``fn`` on CUDA events, its result)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop), result


def _bound(byts: float, ops: float):
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fex_fused_bound(b: int, t: int, c: int, frame_len: int):
    """K1: audio read once, coefficients, frames written; 10 flops a
    (clip, channel, sample) (3 fma, 2 mul, an add, the |y| sum)."""
    return _bound(b * t * 4 + 5 * c * 4 + b * (t // frame_len) * c * 4, b * t * c * 10)


def scan_bound(b: int, t: int, c: int):
    """The scan entry: audio in, y out, the carry in and out; 9 flops."""
    return _bound(b * t * 4 + 5 * c * 4 + 4 * b * c * 4 + b * t * c * 4, b * t * c * 9)


def tdc_bound(b: int, t: int, c: int, spf: int, os: int):
    """K5: u read once, f0 / k, counts written; per sample an fma, a max
    and a product, per ZOH tick an add, a floor, a subtract and the
    count."""
    return _bound(b * t * c * 4 + 2 * c * 4 + b * (t // spf) * c * 4, b * t * c * (4 + 4 * os))


FEX_SHAPE = (FEATURE_BATCH, 2 * CLIP_SAMPLES)  # K1 and the scan on a batch of 1 s clips
GENERIC_FRAME = 500  # a frame length off the 32-sample blocks: K1's event loop


def fex_times(dev, x=None, coeffs=None, duty=None, scan_coeffs=None):
    """K1's and the scan entry's ms on ``x`` / ``duty`` (default: N(0,
    0.2²) at FEX_SHAPE, the nominal filterbank): K1 with frames of 512 (the
    untrimmed rows read in place, the branch-free body), K1 with frames of
    GENERIC_FRAME (the event loop), the scan entry, and each entry on the
    first two clips alone (one block: the filter warp's chain with nothing
    beside it)."""
    import torch

    from repro_torch.core.fex import FExConfig
    from repro_torch.kernels.fex_fused import biquad_stream, fex_fused

    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    if x is None:
        x = torch.randn(FEX_SHAPE, generator=g, device=dev) * 0.2
    if duty is None:
        duty = torch.randn(FEX_SHAPE, generator=g, device=dev) * 0.2
    nominal = FExConfig().filterbank().stacked(device=dev)
    coeffs = nominal if coeffs is None else coeffs
    scan_coeffs = nominal if scan_coeffs is None else scan_coeffs
    out = {}
    out["fex_fused ms"], _ = _cuda_ms(lambda: fex_fused(x, coeffs, 512), reps=20, hold=True)
    out["fex_fused one block ms"], _ = _cuda_ms(lambda: fex_fused(x[:2], coeffs, 512), reps=10,
                                                hold=True)
    out["fex_fused generic ms"], _ = _cuda_ms(lambda: fex_fused(x, coeffs, GENERIC_FRAME),
                                              reps=10, hold=True)
    out["scan ms"], _ = _cuda_ms(lambda: biquad_stream(duty, scan_coeffs), reps=20, hold=True)
    out["scan one block ms"], _ = _cuda_ms(lambda: biquad_stream(duty[:2], scan_coeffs), reps=10,
                                           hold=True)
    return out


def record_times(dev, state=None, reps: int = 3):
    """Warm ms of `record_features` of FEATURE_CLIPS clips in batches of
    FEATURE_BATCH on each frontend, on the host's clock (the call returns
    host arrays): the median of ``reps`` calls after one untimed call.
    ``state``: the hardware die (default: one drawn from torch.Generator
    seed SEED and calibrated on the card)."""
    import statistics

    import torch

    from repro_torch.core.frontend import FrontendState
    from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig

    if state is None:
        state = KWSPipeline(KWSPipelineConfig(frontend="hardware")).init_frontend_state(
            torch.Generator(device=dev).manual_seed(SEED), device=dev)
    audio = _clips(FEATURE_CLIPS)
    out = {}
    for frontend, st in (("software", FrontendState()), ("hardware", state),
                         ("hardware-pallas", state)):
        pipe = KWSPipeline(KWSPipelineConfig(frontend=frontend), state=st)
        pipe.record_features(audio, batch_size=FEATURE_BATCH)
        secs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            pipe.record_features(audio, batch_size=FEATURE_BATCH)
            secs.append(time.perf_counter() - t0)
        out[f"record_features {frontend} warm ms"] = statistics.median(secs) * 1e3
    return out


# K1's and the scan's edges, each held bit-equal to its plain version on the
# card (tests/test_torch_kernels_gpu.py sweeps more): (b, c) with one clip,
# partial blocks, idle lanes and two channel groups; K1 frames of 512 (the
# branch-free body), 100 and 20 (the event loop; 200 samples is shorter
# than a chunk), float32 and bfloat16, rows with a tail past the last frame;
# the scan at T = 1, 3 and 1001 (not multiples of 4), 200 and 768
FEX_EDGE_BC = ((1, 16), (33, 16), (33, 1), (5, 7), (2, 33))
FEX_EDGE_FRAMES = ((512, 3), (100, 7), (20, 10))
SCAN_EDGE_T = (1, 3, 200, 768, 1001)


def fex_edges(dev) -> int:
    """K1 and the scan entry against their plain versions at the edges of
    their geometry, on unaligned audio and across two calls of the scan.
    Returns the number of comparisons; raises on the first difference."""
    import torch

    from repro_torch.core.filters import design_filterbank
    from repro_torch.kernels.fex_fused import (
        biquad_stream,
        biquad_stream_ref,
        fex_fused,
        fex_fused_ref,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    n = 0

    def scan_equal(x, coeffs, carry, where):
        y, (s1, s2) = biquad_stream(x, coeffs, carry)
        py, (p1, p2) = biquad_stream_ref(x, coeffs, carry)
        if not (torch.equal(y, py) and torch.equal(s1, p1) and torch.equal(s2, p2)):
            raise AssertionError(f"biquad_stream differs from the plain scan at {where}")
        return y, (s1, s2)

    for b, c in FEX_EDGE_BC:
        coeffs = design_filterbank(c, 32000.0)
        for frame, frames in FEX_EDGE_FRAMES:
            t = frame * frames
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randn((b, t + frame // 2 + 1), generator=g, device=dev) * 0.2).to(dtype)
                want = fex_fused_ref(x[:, :t], coeffs, frame)
                if not torch.equal(fex_fused(x, coeffs, frame), want):
                    raise AssertionError(f"fex_fused differs from its plain version at b={b} "
                                         f"c={c} frame={frame} {dtype}")
                n += 1
        for t in SCAN_EDGE_T:
            x = torch.randn((b, t), generator=g, device=dev) * 0.3
            carry = tuple(torch.randn((b, c), generator=g, device=dev) * 0.01 for _ in range(2))
            scan_equal(x, coeffs, carry, f"b={b} t={t} c={c}")
            n += 1
    coeffs = design_filterbank(16, 32000.0)
    for dtype in (torch.float32, torch.bfloat16):  # 4 (bfloat16: 2) bytes off 16
        x = torch.empty(3 * 1024 + 1, device=dev, dtype=dtype)[1:].view(3, 1024)
        x.copy_(torch.randn((3, 1024), generator=g, device=dev) * 0.2)
        if not torch.equal(fex_fused(x, coeffs, 512), fex_fused_ref(x, coeffs, 512)):
            raise AssertionError(f"fex_fused differs from its plain version on unaligned {dtype}")
        n += 1
    x = torch.empty(3 * 1000 + 1, device=dev)[1:].view(3, 1000)
    x.copy_(torch.randn((3, 1000), generator=g, device=dev) * 0.3)
    y, state = scan_equal(x, coeffs, None, "unaligned audio")
    y_a, mid = biquad_stream(x[:, :333], coeffs)
    y_b, end = biquad_stream(x[:, 333:], coeffs, mid)
    if not (torch.equal(torch.cat([y_a, y_b], 1), y) and all(map(torch.equal, end, state))):
        raise AssertionError("biquad_stream across two calls differs from one call")
    return n + 2


TDC_SHAPE = (FEATURE_BATCH, 31744, C)  # K5 on a batch of 1 s clips, whole frames


def tdc_times(dev, u=None, cfg=None, chip=None):
    """K5's ms on ``u`` (default: |N(0, 0.2²)| at TDC_SHAPE, the paper's
    TDFExConfig); on the same input with one sample in every 128 raised to
    2.2e5, so that every chunk's d reaches 2^22 and the carry floors by
    floorf (the time does not depend on the values otherwise); and for the
    first two clips alone (one block: its carry warp's chain with nothing
    beside it)."""
    import torch

    from repro_torch.core.tdfex import TDFExConfig
    from repro_torch.kernels.tdc import ops

    if u is None:
        g = torch.Generator(device=dev).manual_seed(SEED + 18)
        u = torch.randn(TDC_SHAPE, generator=g, device=dev).abs() * 0.2
    cfg = cfg or TDFExConfig()
    out = {}
    out["tdc ms"], _ = _cuda_ms(lambda: ops.tdc_counts(u, cfg, chip), reps=20, hold=True)
    big = u.clone()
    big[:, ::128] = 2.2e5
    out["tdc floorf ms"], _ = _cuda_ms(lambda: ops.tdc_counts(big, cfg, chip), reps=20, hold=True)
    del big
    two = u[:2].contiguous()
    out["tdc one block ms"], _ = _cuda_ms(lambda: ops.tdc_counts(two, cfg, chip), reps=10,
                                          hold=True)
    return out


def _wkv_inputs(dev, shape, seed, strong=False):
    """r, k, v ~ N(0, 1), logw = -exp(N(0, 1) - 1) (or -50: strong decay),
    u ~ N(0, 0.3²), as the reference's kernel test draws them."""
    import torch

    b, t, h, p = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    r, k, v = rn(b, t, h, p), rn(b, t, h, p), rn(b, t, h, p)
    lw = torch.full(shape, -50.0, device=dev) if strong else -torch.exp(rn(b, t, h, p) - 1.0)
    return r, k, v, lw, rn(h, p) * 0.3


def wkv6_times(dev):
    """K7's ms at WKV_SHAPE in float32 (the inputs of `phase_wkv6`)."""
    from repro_torch.kernels import wkv6

    args = _wkv_inputs(dev, WKV_SHAPE, SEED + 17)
    ms, _ = _cuda_ms(lambda: wkv6(*args), reps=10, hold=True)
    return {"wkv6 ms": ms}


GRU_STREAMS = 4096  # K6: the paper's classifier over 1 s clips
GRU_FRAMES = 62
WKV_SHAPE = (8, 4096, 64, 64)  # K7: rwkv6-7b's heads at its train_4k length
WKV_CHUNK = 128  # rwkv6-7b's SSMConfig chunk
BF16_TOL = 3e-2  # bf16 output against float32 (the reference's own bound)
# K7 against its plain version, max |Δ| / max |y|: the kernel sums the keys
# in its own order with fused multiply-adds and expf; measured 1.6e-7 at
# (8, 4096, 64, 64) on an H100
WKV_REL_TOL = 2e-6
# the chunked form against the sequential one (both plain), relative: the
# chunk's cumsums and exps of clipped differences round otherwise
WKV_CHUNKED_REL_TOL = 1e-4
# cuDNN's GRU against the plain version: another implementation's sums and
# activations, held only to show the yardstick computes the same function
LIBRARY_TOL = 1e-4


def gru_seq_bound(b: int, t: int, layers):
    """K6 over the given (I, H) layers: x read and h written once a step,
    the weights and h0 once; 2 (I + H) 3H flops a row and step."""
    byts = sum(b * t * (i + h) * 4 + ((i + h) * 3 * h + 6 * h) * 4 + b * h * 4 for i, h in layers)
    return _bound(byts, sum(2 * b * t * (i + h) * 3 * h for i, h in layers))


def wkv6_bound(b: int, t: int, h: int, p: int):
    """K7: r, k, v, logw read and y written once, u once; per (b, h, t)
    5 P² flops (r · S 2 P²; the decay, k v^T and their sum P² each) and
    6 P (exp of logw; the bonus r · (u ⊙ k v^T) = (Σ_p r_p u_p k_p) v)."""
    return _bound(5 * b * t * h * p * 4 + h * p * 4, (5 * p * p + 6 * p) * b * t * h)


def _gru_inputs(dev):
    """The float GRU classifier's two layers from `init_gru_classifier`
    (torch.Generator seed SEED) as (w, u, b_i, b_h), and GRU_STREAMS clips
    of GRU_FRAMES N(0, 1) FV-like frames in float32 and bf16."""
    import torch

    from repro_torch.core.gru import GRUConfig, init_gru_classifier

    params = init_gru_classifier(GRUConfig(quantized=False), torch.Generator().manual_seed(SEED),
                                 device=dev)
    layers = [tuple(layer[k] for k in ("w_i", "w_h", "b_i", "b_h")) for layer in params["gru"]]
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    fv = torch.randn((GRU_STREAMS, GRU_FRAMES, C), generator=g, device=dev)
    return layers, fv, fv.to(torch.bfloat16)


def _cudnn_grus(dev, layers):
    """cuDNN's `torch.nn.GRU` loaded with each layer's weights (the
    library yardstick; the port never calls it)."""
    import torch

    grus = []
    for (w, u, bi, bh), i in zip(layers, (C, H)):
        m = torch.nn.GRU(i, H, batch_first=True).to(dev)
        with torch.no_grad():
            m.weight_ih_l0.copy_(w.T)
            m.weight_hh_l0.copy_(u.T)
            m.bias_ih_l0.copy_(bi)
            m.bias_hh_l0.copy_(bh)
        m.flatten_parameters()
        grus.append(m)
    return grus


def gru_seq_times(dev):
    """K6's ms on the inputs of `phase_gru_seq`: both layers chained, layer
    1 alone and in bf16, cuDNN's GRU over both layers beside them, and
    the bound of both layers."""
    import torch

    from repro_torch.kernels import gru_sequence

    layers, fv, fv16 = _gru_inputs(dev)
    grus = _cudnn_grus(dev, layers)

    def library():
        with torch.no_grad():
            return grus[1](grus[0](fv)[0])[0]

    out = {}
    out["gru_sequence ms"], _ = _cuda_ms(
        lambda: gru_sequence(gru_sequence(fv, *layers[0]), *layers[1]), reps=20, hold=True)
    out["gru_sequence layer 1 ms"], _ = _cuda_ms(lambda: gru_sequence(fv, *layers[0]),
                                                 reps=20, hold=True)
    out["gru_sequence bf16 layer 1 ms"], _ = _cuda_ms(lambda: gru_sequence(fv16, *layers[0]),
                                                      reps=20, hold=True)
    out["gru_sequence library_ms"], _ = _cuda_ms(library, reps=20, hold=True)
    out["gru_sequence bound_ms"], out["gru_sequence bound_by"] = gru_seq_bound(
        GRU_STREAMS, GRU_FRAMES, ((C, H), (H, H)))
    return out


def phase_gru_seq(dev):
    """K6 on the paper's classifier at full width (`_gru_inputs`): layer 1
    (16 -> 48) feeding layer 2 (48 -> 48) through `gru_sequence`, then one
    bf16 pass of layer 1; each output against the plain version on the
    card, cuDNN's GRU on the same weights as the library yardstick; each
    launch's geometry and blocks an SM (occupancy API); the times by
    `gru_seq_times`."""
    import torch

    from repro_torch.kernels import build, gru_sequence, gru_sequence_plain
    from repro_torch.kernels.gru.ops import gru_seq_geometry, occupancy

    layers, fv, fv16 = _gru_inputs(dev)
    build.launches.clear()
    h1 = gru_sequence(fv, *layers[0])
    h2 = gru_sequence(h1, *layers[1])
    h1_16 = gru_sequence(fv16, *layers[0])
    torch.cuda.synchronize()
    launches = dict(build.launches)
    if launches != {"gru_seq": 3}:
        raise AssertionError(f"gru_sequence path: launches {launches}, want gru_seq=3")
    for name, out, dtype in (("layer 1", h1, torch.float32), ("layer 2", h2, torch.float32),
                             ("layer 1 bf16", h1_16, torch.bfloat16)):
        if out.shape != (GRU_STREAMS, GRU_FRAMES, H) or out.dtype != dtype:
            raise AssertionError(f"gru_sequence {name}: {tuple(out.shape)} {out.dtype}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"gru_sequence {name}: not finite")
    for name, x, i in (("layer 1", fv, C), ("layer 2", h1, H), ("layer 1 bf16", fv16, C)):
        bf16 = x.dtype == torch.bfloat16
        geo = gru_seq_geometry(GRU_STREAMS, i, H, bf16, x.data_ptr() % 16)
        print(f"gru_sequence {name}: {geo.blocks} blocks of {geo.rows} rows, {geo.threads} "
              f"threads, {geo.smem} B dynamic shared, instantiation {geo.inst}, copy mode "
              f"{geo.copy}; {occupancy(geo, bf16)} blocks an SM (occupancy API)")
    zeros = torch.zeros((GRU_STREAMS, H), device=dev)

    def plain(x, layer):
        return gru_sequence_plain(x.transpose(0, 1), *layer, zeros).transpose(0, 1)

    out = {}
    out["gru_sequence plain_ms"], p1 = _once_ms(lambda: plain(fv, layers[0]))
    plain2_ms, p2 = _once_ms(lambda: plain(h1, layers[1]))  # layer 2 on the kernel's layer 1
    out["gru_sequence plain_ms"] += plain2_ms
    p1_16 = plain(fv16, layers[0])
    err = max(float((h1 - p1).abs().max()), float((h2 - p2).abs().max()))
    err16 = float((h1_16.float() - p1_16.float()).abs().max())
    if err > FLOAT_TOL or err16 > BF16_TOL:
        raise AssertionError(f"gru_sequence differs from its plain version by {err:.3g} (float32, "
                             f"limit {FLOAT_TOL}) / {err16:.3g} (bf16, limit {BF16_TOL})")
    chain = float((h2 - plain(p1, layers[1])).abs().max())
    grus = _cudnn_grus(dev, layers)
    with torch.no_grad():
        lib_err = max(float((grus[0](fv)[0] - p1).abs().max()),
                      float((grus[1](h1)[0] - p2).abs().max()))
    if lib_err > LIBRARY_TOL:
        raise AssertionError(f"cuDNN's GRU differs from the plain version by {lib_err:.3g}")
    out.update(gru_seq_times(dev))
    out["gru_sequence bf16 err"] = err16
    print(f"gru_sequence ({GRU_STREAMS}, {GRU_FRAMES}, {C}) -> 48 -> 48: launches {launches}; "
          f"within {err:.3g} of the plain version per layer (float32, limit {FLOAT_TOL}), "
          f"{err16:.3g} in bf16 (limit {BF16_TOL}); the two kernels chained differ from the "
          f"plain chain by {chain:.3g}; cuDNN's GRU on the same weights within {lib_err:.3g}")
    print(f"gru_sequence: {out['gru_sequence ms']:.5f} ms for both layers on the card (layer 1 "
          f"{out['gru_sequence layer 1 ms']:.5f} ms, in bf16 {out['gru_sequence bf16 layer 1 ms']:.5f} "
          f"ms), plain {out['gru_sequence plain_ms']:.1f} "
          f"ms, cuDNN {out['gru_sequence library_ms']:.5f} ms, bound "
          f"{out['gru_sequence bound_ms']:.5f} ms ({out['gru_sequence bound_by']})")
    return err, launches["gru_seq"], out


def phase_wkv6(dev):
    """K7 at rwkv6-7b's head layout and train_4k length (WKV_SHAPE,
    float32), drawn as the reference's test draws it, against the plain
    sequential form on the card; strong decay (logw = -50) and bf16 at
    small sizes; the chunked training form at B = 1 timed as
    information."""
    import torch

    from repro_torch.kernels import build, wkv6, wkv6_plain
    from repro_torch.models.rwkv6 import wkv6_chunked

    b, t, h, p = WKV_SHAPE
    r, k, v, lw, u = _wkv_inputs(dev, WKV_SHAPE, SEED + 17)
    build.launches.clear()
    y = wkv6(r, k, v, lw, u)
    torch.cuda.synchronize()
    launches = dict(build.launches)
    if launches != {"wkv6": 1}:
        raise AssertionError(f"wkv6 path: launches {launches}, want wkv6=1")
    if y.shape != (b, t, h, p) or y.dtype != torch.float32 or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"wkv6: {tuple(y.shape)} {y.dtype} or not finite")
    out = {}
    out["wkv6 plain_ms"], want = _once_ms(lambda: wkv6_plain(r, k, v, lw, u))
    err = float((y - want).abs().max())
    rel = err / float(want.abs().max())
    if rel > WKV_REL_TOL:
        raise AssertionError(f"wkv6 differs from its plain version by {rel:.3g} of max |y| "
                             f"(limit {WKV_REL_TOL})")
    small = _wkv_inputs(dev, (2, 64, 4, p), SEED + 18, strong=True)
    swant = wkv6_plain(*small)
    strong = float((wkv6(*small) - swant).abs().max() / swant.abs().max())
    if strong > WKV_REL_TOL:
        raise AssertionError(f"wkv6 under strong decay differs by {strong:.3g} (limit {WKV_REL_TOL})")
    bf = [a[:2, :512].to(torch.bfloat16) for a in (r, k, v, lw)]
    bwant = wkv6_plain(*(a.float() for a in bf), u)
    y16 = wkv6(*bf, u)
    err16 = float((y16.float() - bwant).abs().max() / bwant.abs().max())
    if y16.dtype != torch.bfloat16 or err16 > BF16_TOL:
        raise AssertionError(f"wkv6 in bf16 differs by {err16:.3g} of max |y| (limit {BF16_TOL})")
    out["wkv6 chunked B=1 ms"], (yc, _) = _once_ms(
        lambda: wkv6_chunked(r[:1], k[:1], v[:1], lw[:1], u, WKV_CHUNK))
    chunked = float((yc - want[:1]).abs().max() / want[:1].abs().max())
    if chunked > WKV_CHUNKED_REL_TOL:
        raise AssertionError(f"wkv6_chunked differs from the sequential form by {chunked:.3g}")
    del yc, want, r, k, v, lw, y
    out.update(wkv6_times(dev))
    out["wkv6 bound_ms"], out["wkv6 bound_by"] = wkv6_bound(b, t, h, p)
    out["wkv6 rel err"] = rel
    print(f"wkv6 {WKV_SHAPE}: launches {launches}; within {rel:.3g} of max |y| of the plain "
          f"version (limit {WKV_REL_TOL}; {err:.3g} absolute), {strong:.3g} under strong decay at "
          f"(2, 64, 4, {p}); bf16 at (2, 512, {h}, {p}) within {err16:.3g} (limit {BF16_TOL}); "
          f"the chunked form (chunk {WKV_CHUNK}) at B = 1 within {chunked:.3g} of the "
          f"sequential one")
    print(f"wkv6: {out['wkv6 ms']:.5f} ms on the card, plain {out['wkv6 plain_ms']:.1f} ms, "
          f"chunked at B = 1 {out['wkv6 chunked B=1 ms']:.1f} ms, bound "
          f"{out['wkv6 bound_ms']:.5f} ms ({out['wkv6 bound_by']}); no single PyTorch call "
          f"computes WKV6")
    return err, launches["wkv6"], out


def phase_calibration(dev):
    """A die drawn from torch.Generator seed SEED on the card and
    calibrated there, as a user builds it (`init_frontend_state`); the
    noiseless bench on the card against the same bench on the CPU."""
    import torch

    from repro_torch.core.calibration import calibrate_chip
    from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig

    pipe = KWSPipeline(KWSPipelineConfig(frontend="hardware"))
    t0 = time.perf_counter()
    state = pipe.init_frontend_state(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for name in ("beta", "alpha", "coeffs"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"calibration: {name} is not finite")
    if abs(float(state.alpha.mean()) - 1.0) > 1e-5 or state.coeffs.shape != (5, C):
        raise AssertionError("calibration: alpha is not normalized or coeffs misshapen")
    tdcfg = pipe.config.tdfex_config
    beta, alpha = calibrate_chip(tdcfg, state.chip, device=dev)
    cbeta, calpha = calibrate_chip(tdcfg, _state_to(state, "cpu").chip, device="cpu")
    if not (torch.equal(beta.cpu(), cbeta) and torch.equal(alpha.cpu(), calpha)):
        raise AssertionError("calibration on the card differs from the same bench on the CPU")
    print(f"calibration: die from torch.Generator seed {SEED} calibrated on the card in "
          f"{secs:.2f} s; beta {float(state.beta.min()):.2f}..{float(state.beta.max()):.2f}, "
          f"alpha {float(state.alpha.min()):.4f}..{float(state.alpha.max()):.4f}; the noiseless "
          f"bench equals the CPU's")
    return state


def phase_features(dev, state):
    """The batch features path: `record_features` of FEATURE_CLIPS clips
    for the three frontends (launch counts read around each), then each
    kernel of the path against its plain version at the path's shapes.
    Returns the recorded codes, the launch counts, the kernels' errors
    and times, and the norm stats fitted from the hardware-pallas codes."""
    import numpy as np
    import torch

    from repro_torch.core import fex, tdfex
    from repro_torch.core.calibration import fit_norm_stats_from_counts
    from repro_torch.core.frontend import FrontendState
    from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.fex_fused import (
        biquad_stream,
        biquad_stream_ref,
        fex_fused,
        fex_fused_ref,
    )
    from repro_torch.kernels.fex_fused import ops as fex_ops
    from repro_torch.kernels.tdc import ops as tdc_ops
    from repro_torch.kernels.tdc import tdc_counts, tdc_counts_plain, tdc_counts_ref
    from repro_torch.kernels.tdc.ops import tdc_scale

    audio = _clips(FEATURE_CLIPS)
    states = {"software": FrontendState(), "hardware": state, "hardware-pallas": state}
    codes, launches = {}, {}
    n_batches = -(-FEATURE_CLIPS // FEATURE_BATCH)
    want_launches = {"software": {"fex_fused": n_batches}, "hardware": {"biquad_stream": n_batches},
                     "hardware-pallas": {"biquad_stream": n_batches, "tdc": n_batches}}
    for frontend, st in states.items():
        pipe = KWSPipeline(KWSPipelineConfig(frontend=frontend), state=st)
        build.launches.clear()
        t0 = time.perf_counter()
        raw = pipe.record_features(audio, batch_size=FEATURE_BATCH)
        secs = time.perf_counter() - t0
        launches[frontend] = dict(build.launches)
        if launches[frontend] != want_launches[frontend]:
            raise AssertionError(f"record_features {frontend}: launches {launches[frontend]}, "
                                 f"want {want_launches[frontend]}")
        n_frames = 2 * CLIP_SAMPLES // 512
        if raw.shape != (FEATURE_CLIPS, n_frames, C) or not np.isfinite(raw).all():
            raise AssertionError(f"record_features {frontend}: shape {raw.shape} or not finite")
        if raw.min() < 0 or raw.max() > 4095 or raw.max() < 1000:
            raise AssertionError(f"record_features {frontend}: codes {raw.min()}..{raw.max()}")
        # a small input on the card against the same call on the CPU
        small = audio[:4, :1600]
        on_card = pipe.record_features(small, batch_size=2)
        on_cpu = KWSPipeline(pipe.config, state=_state_to(st, "cpu")).record_features(
            small, batch_size=2, device="cpu")
        if not np.array_equal(on_card, on_cpu):
            raise AssertionError(f"record_features {frontend}: card differs from the CPU")
        codes[frontend] = raw
        print(f"record_features {frontend}: {FEATURE_CLIPS} x {CLIP_SAMPLES / 16000:g} s clips in batches of "
              f"{FEATURE_BATCH} in {secs:.3f} s, launches {launches[frontend]}, codes "
              f"{int(raw.min())}..{int(raw.max())}; 4 x 0.1 s clips equal to the CPU's")
    hw_diff = float(np.abs(codes["hardware"] - codes["hardware-pallas"]).max())
    if hw_diff > 2:
        raise AssertionError(f"hardware-pallas differs from hardware by {hw_diff} LSB (limit 2)")
    print(f"hardware-pallas against hardware: at most {hw_diff:.0f} LSB apart (limit 2)")
    warm = record_times(dev, state)
    print("record_features warm (median of 3 after one untimed call): " + ", ".join(
        f"{k.split()[1]} {v:.2f} ms" for k, v in warm.items()))

    # the kernels at the path's shapes: one batch of 64 clips, 32 000
    # internal samples each
    tdcfg = KWSPipelineConfig().tdfex_config
    batch = torch.as_tensor(audio[:FEATURE_BATCH], device=dev)
    errs, times = {}, dict(warm)
    x = fex.oversample2x(batch)
    nominal = fex.FExConfig().filterbank().stacked(device=dev)
    got = fex_fused(x, nominal, 512)
    times["fex_fused plain_ms"], want = _once_ms(lambda: fex_fused_ref(x, nominal, 512))
    if not torch.equal(got, want):
        raise AssertionError("fex_fused differs from its plain version")
    errs["fex_fused"] = 0.0
    duty = tdfex.vtc(batch, tdcfg)
    y, (s1, s2) = biquad_stream(duty, state.coeffs)
    times["scan plain_ms"], (py, (ps1, ps2)) = _once_ms(lambda: biquad_stream_ref(duty, state.coeffs))
    if not (torch.equal(y, py) and torch.equal(s1, ps1) and torch.equal(s2, ps2)):
        raise AssertionError("biquad_stream differs from the plain scan")
    errs["scan"] = 0.0
    rect = torch.abs(y)
    spf, os_ = tdcfg.decimation // tdcfg.tdc_oversample, tdcfg.tdc_oversample
    gain = 1.0 + state.chip.gain_mismatch
    f0, k = tdcfg.f_free_hz * gain, tdcfg.k_sro_hz * gain
    b_t, t_use = rect.shape[0], (rect.shape[1] // spf) * spf
    counts = tdc_counts(rect, tdcfg, state.chip)
    times["tdc plain_ms"], plain = _once_ms(
        lambda: tdc_counts_plain(rect[:, :t_use], f0, k, spf, os_, tdc_scale(tdcfg)))
    if not torch.equal(counts, plain):
        raise AssertionError("tdc differs from its plain loop")
    oracle = tdc_counts_ref(rect.cpu().numpy(), f0.cpu().numpy(), k.cpu().numpy(), spf, os_,
                            tdcfg.f_tdc)
    off = float(np.abs(counts.cpu().numpy() - oracle).max())
    one = rect[:1, :spf, :1].contiguous()  # b = frames = c = 1 (R4)
    chip1 = tdfex.TDFExState(state.chip.gain_mismatch[:1], state.chip.cf_mismatch[:1])
    c1 = tdc_counts(one, tdcfg, chip1)
    p1 = tdc_counts_plain(one, f0[:1], k[:1], spf, os_, tdc_scale(tdcfg))
    o1 = tdc_counts_ref(one.cpu().numpy(), f0[:1].cpu().numpy(), k[:1].cpu().numpy(), spf, os_,
                        tdcfg.f_tdc)
    off = max(off, float(np.abs(c1.cpu().numpy() - o1).max()))
    if not torch.equal(c1, p1) or off > 1.0:
        raise AssertionError(f"tdc: (1, 1, 1) differs from plain, or {off} counts off the oracle")
    errs["tdc"] = 0.0
    print(f"fex_fused {tuple(x.shape)}, biquad_stream {tuple(duty.shape)} and tdc "
          f"{tuple(rect.shape)}: bit-equal to their plain versions; "
          f"tdc at most {off:.0f} count off the float64 oracle (also at b = frames = c = 1); "
          f"tdc geometry {tdc_ops.tdc_geometry(b_t, t_use, C, spf, os_, clip_samples=rect.shape[1])}")
    # kernel times at the same shapes
    n_edges = fex_edges(dev)
    geo = fex_ops.fex_geometry(x.shape[0], x.shape[1] // 512 * 512, C, 512, x.stride(0),
                               x.data_ptr() % 16 == 0, False)
    print(f"fex_fused and biquad_stream: {n_edges} edge cases bit-equal to their plain versions "
          f"(frames 512 / 100 / 20, float32 / bfloat16, C 1..33, B 1..33, T 1..1001, "
          f"unaligned audio, the carry across two calls); K1 geometry {geo}")
    times.update(fex_times(dev, x, nominal, duty, state.coeffs))
    times.update(tdc_times(dev, rect, tdcfg, state.chip))
    b, t = x.shape
    # K1 reads the whole frames only (62 of 512 samples a clip)
    times["fex_fused bound_ms"], times["fex_fused bound_by"] = fex_fused_bound(
        b, t // 512 * 512, C, 512)
    times["scan bound_ms"], times["scan bound_by"] = scan_bound(b, t, C)
    times["tdc bound_ms"], times["tdc bound_by"] = tdc_bound(b, t_use, C, spf, os_)
    for name in ("fex_fused", "scan", "tdc"):
        print(f"{name}: {times[f'{name} ms']:.5f} ms on the card, plain "
              f"{times[f'{name} plain_ms']:.1f} ms, bound {times[f'{name} bound_ms']:.5f} ms "
              f"({times[f'{name} bound_by']})")
    print(f"fex_fused one block (2 clips) alone {times['fex_fused one block ms']:.5f} ms, frames "
          f"of {GENERIC_FRAME} (event loop) {times['fex_fused generic ms']:.5f} ms; scan one "
          f"block alone {times['scan one block ms']:.5f} ms")
    print(f"tdc with every chunk floored by floorf {times['tdc floorf ms']:.5f} ms; one block "
          f"(2 clips) alone {times['tdc one block ms']:.5f} ms")
    stats = fit_norm_stats_from_counts(torch.as_tensor(codes["hardware-pallas"], device=dev), tdcfg)
    cpu_stats = fit_norm_stats_from_counts(torch.as_tensor(codes["hardware-pallas"]), tdcfg)
    # the FV_Log values are the same table on both; only the order of the
    # mean's and the std's float32 sums differs
    fit_diff = max(float((stats.mu.cpu() / cpu_stats.mu - 1).abs().max()),
                   float((stats.sigma.cpu() / cpu_stats.sigma - 1).abs().max()))
    if fit_diff > 1e-5:
        raise AssertionError(f"norm stats fitted on the card differ from the CPU's by {fit_diff:.3g}")
    print(f"norm stats fitted from the hardware-pallas codes on the card, within {fit_diff:.3g} "
          f"(relative) of the CPU's fit (limit 1e-5)")
    return codes, launches, errs, times, stats


CASCADE_LIVE_TICKS = 24
CASCADE_REPLAY_TICKS = 8
INGRESS_TICKS = 64
COALESCER_TICKS = 8
DETECTOR_CLIPS = 16  # 0.5 s clips of tone and of silence for the linear detector
DETECTOR_SAMPLES = 8000
DETECTOR_STEPS = 200  # fit_linear_detector's default


def fma_rows_bound(n: int, c: int):
    """The fit's row chain: d and xs read once, (C,) written; an FMA (two
    flops) a (row, channel)."""
    return _bound(4 * (n + n * c + c), 2 * n * c)


def _fit_die_detector(dev, hw_state):
    """The "linear" detector for the hardware die: `fit_linear_detector`
    run on the card on the die's FV_Norm frames of tone clips (speech
    stand-ins) against -60 dB noise clips (silence), launches counted
    around it, held array-equal to the same fit on the CPU; then its row
    chain's kernel (`kernels.fma_rows`) against its plain version at the
    fit's shapes (and on a case where float64 lands on a float32
    midpoint), timed beside its plain version and torch.mv. Returns
    ((linear_w, linear_b), fma_rows launches, the kernel's error, times)."""
    import numpy as np
    import torch

    from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig
    from repro_torch.kernels import build
    from repro_torch.serving.cascade import fit_linear_detector

    pipe = KWSPipeline(KWSPipelineConfig(frontend="hardware"), state=hw_state)
    tones = torch.as_tensor(_clips(DETECTOR_CLIPS, DETECTOR_SAMPLES), device=dev)
    silence = torch.as_tensor(np.random.default_rng(SEED + 10).standard_normal(
        (DETECTOR_CLIPS, DETECTOR_SAMPLES)).astype(np.float32) * 1e-3, device=dev)
    tone_fv, _ = pipe.features(tones)
    silence_fv, _ = pipe.features(silence)
    build.launches.clear()
    t0 = time.perf_counter()
    w, b = fit_linear_detector(tone_fv, silence_fv, steps=DETECTOR_STEPS)
    secs = time.perf_counter() - t0
    counts = dict(build.launches)
    if counts != {"fma_rows": DETECTOR_STEPS}:
        raise AssertionError(f"fit_linear_detector: launches {counts}, want only "
                             f"fma_rows={DETECTOR_STEPS}")
    t0 = time.perf_counter()
    cw, cb = fit_linear_detector(tone_fv.cpu(), silence_fv.cpu(), steps=DETECTOR_STEPS)
    cpu_secs = time.perf_counter() - t0
    if w != cw or b != cb:
        raise AssertionError("the linear detector fitted on the card differs from the CPU's fit")
    print(f"linear detector fitted on the card on {tuple(tone_fv.shape)} tone and "
          f"{tuple(silence_fv.shape)} silence FV_Norm frames of the die in {secs:.3f} s "
          f"({DETECTOR_STEPS} steps, launches {counts}); equal to the same fit on the CPU "
          f"({cpu_secs:.3f} s); b = {b:.4f}")

    c = tone_fv.shape[-1]
    xs = torch.cat([tone_fv.reshape(-1, c), silence_fv.reshape(-1, c)])
    times = fma_rows_times(dev, xs)
    times["fit s"], times["fit cpu s"] = secs, cpu_secs
    return (w, b), counts["fma_rows"], 0.0, times


def fma_rows_times(dev, xs=None):
    """The fit's row chain (`kernels.fma_rows`) at the fit's shapes: ``xs``
    (default: (992, 16) seeded normal rows, the die's fit's shape) and a
    seeded d, held bit-equal to its plain version (also on xs's first
    channel alone, over all its rows and over 16, and on a case where
    float64 lands on a float32 midpoint), timed beside its plain version
    and torch.mv (its own order)."""
    import torch

    from repro_torch.kernels.fma_rows import fma_rows, fma_rows_ref

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    if xs is None:
        xs = torch.randn((2 * DETECTOR_CLIPS * 31, C), generator=g, device=dev)
    n, c = xs.shape
    d = torch.randn(n, generator=g, device=dev) * 1e-3
    got = fma_rows(d, xs)
    times = {}
    times["fma_rows plain_ms"], want = _once_ms(lambda: fma_rows_ref(d, xs))
    if not torch.equal(got, want):
        raise AssertionError("fma_rows differs from its plain version")
    # one channel: past 32 rows the first 8 multiplied and added apart
    # (XLA's peeled column-major GEMV tile), then the fused chain; up to 32
    # rows the fused chain alone
    for m in (n, 16):
        if not torch.equal(fma_rows(d[:m], xs[:m, :1]), fma_rows_ref(d[:m], xs[:m, :1])):
            raise AssertionError(f"fma_rows differs from its plain version at ({m}, 1)")
    # acc = 1 + 2^-23, then p = 2^-24 - 2^-70: float64 lands on a midpoint
    md = torch.tensor([1.0, 2.0**-24 * (1 + 2.0**-23)], device=dev)
    mx = torch.tensor([[1 + 2.0**-23], [1 - 2.0**-23]], device=dev)
    if fma_rows(md, mx).item() != 1 + 2.0**-23 or not torch.equal(fma_rows(md, mx),
                                                                  fma_rows_ref(md, mx)):
        raise AssertionError("fma_rows: the midpoint case is not rounded once")
    times["fma_rows ms"], _ = _cuda_ms(lambda: fma_rows(d, xs), reps=200, hold=True)
    xt = xs.t()
    times["fma_rows library_ms"], _ = _cuda_ms(lambda: torch.mv(xt, d), reps=200, hold=True)
    times["fma_rows bound_ms"], times["fma_rows bound_by"] = fma_rows_bound(n, c)
    print(f"fma_rows ({n},) x ({n}, {c}): bit-equal to its plain version (and on a float64 "
          f"midpoint); {times['fma_rows ms']:.6f} ms on the card, plain "
          f"{times['fma_rows plain_ms']:.1f} ms, torch.mv {times['fma_rows library_ms']:.6f} ms, "
          f"bound {times['fma_rows bound_ms']:.6f} ms ({times['fma_rows bound_by']})")
    return times


def cascade_runs(hw_state, linear):
    """(label, classifier, θ, die or None, CascadeConfig) of the cascade
    phase's servers."""
    from repro_torch.serving.cascade import CascadeConfig

    w, b = linear
    return [
        ("qat energy 0.15", "qat", None, None, CascadeConfig(wake_threshold=0.15)),
        ("delta-int θ=0.15 energy 0.15", "delta-int", THETA, None,
         CascadeConfig(wake_threshold=0.15)),
        ("delta θ=0.15 energy 0.1 hangover 3 decay 0.9", "delta", THETA, None,
         CascadeConfig(wake_threshold=0.1, hangover_frames=3, score_decay=0.9)),
        ("qat hardware linear 0.5 hangover 3", "qat", None, hw_state,
         CascadeConfig(detector="linear", wake_threshold=0.5, hangover_frames=3,
                       linear_w=w, linear_b=b)),
        ("qat always_on", "qat", None, None, CascadeConfig.always_on()),
    ]


def phase_cascade(dev, hw_state):
    """The cascaded serving path at N_STREAMS on traffic where the gate
    gates (half the streams silent): each server's live step_batch ticks
    and run_batch against the plain tick loop, launches counted around
    each run; the always-on server against the ungated one, bit for bit.
    Returns (worst score difference, tick_fused launches, per-server mean
    wake rates, the linear detector, and `_fit_die_detector`'s fma_rows
    launches, error and times)."""
    import numpy as np

    linear, fit_launches, fit_err, fit_times = _fit_die_detector(dev, hw_state)
    worst, launches, rates = 0.0, 0, {}
    for label, classifier, theta, die, casc in cascade_runs(hw_state, linear):
        pipe, srv, live, replay, outs, replay_out, counts, live_s = drive_server(
            dev, classifier, theta, die, CASCADE_LIVE_TICKS, CASCADE_REPLAY_TICKS,
            cascade=casc, traffic=_cascade_traffic)
        want = CASCADE_LIVE_TICKS + CASCADE_REPLAY_TICKS
        if counts != {"tick_fused": want}:
            raise AssertionError(f"cascade server {label}: launches {counts}, want only "
                                 f"tick_fused={want}")
        launches += counts["tick_fused"]
        err = check_server(dev, pipe, srv, live, replay, outs, replay_out)
        worst = max(worst, err)
        rates[label] = float(srv.wake_rate.mean())
        if not casc.always_open and not 0.0 < rates[label] < 1.0:
            raise AssertionError(f"cascade server {label}: the gate did not gate "
                                 f"(mean wake rate {rates[label]})")
        extra = (f", mean srv.sparsity {float(srv.sparsity.mean()):.4f}"
                 if pipe.classifier.is_delta else "")
        print(f"cascade server {label}: {CASCADE_LIVE_TICKS} step_batch + "
              f"{CASCADE_REPLAY_TICKS} run_batch ticks at {N_STREAMS} streams, launches "
              f"{counts}, equal to the plain tick loop (scores within {err:.3g}); mean "
              f"srv.wake_rate {rates[label]:.4f}{extra}; live ticks took {live_s:.3f} s")
        if casc.always_open:
            _, plain, _, _, plain_outs, plain_replay, _, _ = drive_server(
                dev, classifier, theta, die, CASCADE_LIVE_TICKS, CASCADE_REPLAY_TICKS,
                traffic=_cascade_traffic)
            for (a, ta), (b_, tb) in zip(outs + [replay_out], plain_outs + [plain_replay]):
                if not (np.array_equal(a, b_) and np.array_equal(ta, tb)):
                    raise AssertionError("always_on server differs from the ungated server")
            for x, y in zip(srv.state.leaves(), plain.state.leaves()):
                if not bool((x == y).all()):
                    raise AssertionError("always_on server state differs from the ungated one")
            print("cascade server qat always_on: equal to the ungated qat server, bit for bit")
    return worst, launches, rates, linear, (fit_launches, fit_err, fit_times)


def cascade_times(dev, hw_state, linear):
    """The gated tick's kernel ms beside the ungated tick's on the cascade
    traffic (all streams submitting), its plain version and its bound."""
    import torch

    from repro_torch.core.frontend import tree_clone
    from repro_torch.kernels.tick_fused import pack_operands, tick_fused, tick_reference
    from repro_torch.kernels.tick_fused.gather import make_sparse_step
    from repro_torch.serving.cascade import init_state

    n = N_STREAMS
    hops = [torch.as_tensor(h, device=dev) for h in _cascade_hops(8, SEED + 11)]
    full = torch.ones(n, dtype=torch.bool, device=dev)
    out = {}
    runs = cascade_runs(hw_state, linear)
    for label, classifier, theta, die, casc in [runs[0], runs[3]]:
        for key, cc in ((f"cascade {label}", casc), (f"ungated {label}", None)):
            pipe, params = _setup(dev, classifier, theta, die, cc)
            params = pipe.prepare_params(params)
            ops = pack_operands(pipe, params, pipe.state, dev)
            state = (tuple(pipe.streaming_init(n, dev)), pipe.streaming_features_init(n, dev),
                     torch.zeros((n, K), device=dev), None if cc is None else init_state(n, dev))
            tick = [0]

            def run():
                inp = hops[tick[0] % len(hops)]
                tick[0] += 1
                tick_fused(pipe, True, params, state, inp, full, pipe.state, SMOOTHING,
                           operands=ops)

            out[f"{key} ms"], _ = _cuda_ms(run, reps=200, hold=True)
            if cc is None:
                continue
            woken0 = state[3]["woken"].clone()
            for _ in range(8):
                run()
            n_woken = float((state[3]["woken"] - woken0).sum()) / 8
            out[f"{key} wake_fraction"] = n_woken / n
            out[f"{key} plain_ms"], _ = _cuda_ms(
                lambda: tick_reference(pipe, True, params, tree_clone(state), hops[0], full,
                                       pipe.state, SMOOTHING, step_fn=make_sparse_step(pipe)),
                reps=2, warmup=1)
            out[f"{key} bound_ms"], out[f"{key} bound_by"] = tick_bound(
                n, True, hardware=die is not None, n_woken=n_woken)
        print(f"tick_fused {label}: gated {out[f'cascade {label} ms']:.5f} ms against ungated "
              f"{out[f'ungated {label} ms']:.5f} ms on the card (woken fraction "
              f"{out[f'cascade {label} wake_fraction']:.4f}); plain "
              f"{out[f'cascade {label} plain_ms']:.2f} ms, bound "
              f"{out[f'cascade {label} bound_ms']:.5f} ms ({out[f'cascade {label} bound_by']})")
    return out


def phase_ingress(dev):
    """The async ingress on the qat server at N_STREAMS: INGRESS_TICKS
    ticks through step_batch, PipelinedIngress(depth=2, window=1) and
    (depth=2, window=4), COALESCER_TICKS through TickCoalescer, each on a
    fresh server and equal to the step_batch sequence bit for bit, with
    its launches counted; ms per tick on the host clock; metrics on
    against off. Returns the times and the launch counts."""
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.serving.ingress import PipelinedIngress, TickCoalescer
    from repro_torch.serving.serve_loop import StreamingKWSServer

    pipe, params = _setup(dev, "qat")
    rng = np.random.default_rng(SEED + 12)
    gains = np.logspace(-2, -0.3, N_STREAMS).astype(np.float32)[:, None]
    ticks = [((rng.standard_normal((N_STREAMS, HOP)) * gains).astype(np.float32),
              rng.random(N_STREAMS) < 0.85) for _ in range(INGRESS_TICKS)]

    def server(metrics=None):
        srv = StreamingKWSServer(pipe, params, max_streams=N_STREAMS, smoothing=SMOOTHING,
                                 metrics=metrics)
        for sid in range(N_STREAMS):
            srv.open_stream(sid)
        srv.step_batch(np.zeros((N_STREAMS, HOP), np.float32), np.zeros(N_STREAMS, bool))
        torch.cuda.synchronize()
        return srv

    def timed(fn):
        build.launches.clear()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, (time.perf_counter() - t0) * 1e3, dict(build.launches)

    out, launches = {}, {}
    ref_srv = server()
    ref, ms, launches["step_batch"] = timed(lambda: [ref_srv.step_batch(*t) for t in ticks])
    out["step_batch ms_per_tick"] = ms / INGRESS_TICKS
    # the same ticks from pinned host memory (a caller that produces its
    # audio there): the slab's copy to the card becomes asynchronous
    pinned_ticks = [(torch.from_numpy(slab).pin_memory(), torch.from_numpy(mask).pin_memory())
                    for slab, mask in ticks]
    pin_srv = server()
    got, ms, launches["step_batch pinned"] = timed(
        lambda: [pin_srv.step_batch(*t) for t in pinned_ticks])
    out["step_batch pinned ms_per_tick"] = ms / INGRESS_TICKS
    for (gs, gt), (rs, rt) in zip(got, ref, strict=True):
        if not (np.array_equal(gs, rs) and np.array_equal(gt, rt)):
            raise AssertionError("step_batch from pinned memory differs from step_batch")

    def pipelined(window, metrics=None):
        srv = server(metrics)
        ing = PipelinedIngress(srv, HOP, depth=2, window=window)

        def run():
            for slab, mask in ticks:
                s, m = ing.stage()
                s[:] = slab
                m[:] = mask
                ing.commit()
            return ing.drain()

        handles, ms, launches[f"window={window}"] = timed(run)
        rows = [r for h in handles for r in (zip(*h.result()) if window > 1 else [h.result()])]
        return rows, ms, srv

    for window in (1, 4):
        rows, ms, _ = pipelined(window)
        out[f"pipelined window={window} ms_per_tick"] = ms / INGRESS_TICKS
        for (gs, gt), (rs, rt) in zip(rows, ref, strict=True):
            if not (np.array_equal(gs, rs) and np.array_equal(gt, rt)):
                raise AssertionError(f"PipelinedIngress window={window} differs from step_batch")
    srv = server()
    co = TickCoalescer(srv)

    def coalesce():
        done = []  # add() hands back the ticks it retired
        for slab, mask in ticks[:COALESCER_TICKS]:
            for slot in np.flatnonzero(mask):
                done += co.add(int(slot), slab[slot])
            co.flush()
        return done + co.drain()

    handles, ms, launches["coalescer"] = timed(coalesce)
    out["coalescer ms_per_tick"] = ms / COALESCER_TICKS
    for h, (rs, rt) in zip(handles, ref[:COALESCER_TICKS], strict=True):
        if not (np.array_equal(h.scores, rs) and np.array_equal(h.top, rt)):
            raise AssertionError("TickCoalescer differs from step_batch")
    # the caller's host copy of a slab into a pinned staging buffer and
    # into pageable memory (what the pipelined path adds per tick)
    pinned = torch.empty((N_STREAMS, HOP), pin_memory=True).numpy()
    pageable = np.empty((N_STREAMS, HOP), np.float32)
    for name, dst in (("pinned", pinned), ("pageable", pageable)):
        t0 = time.perf_counter()
        for slab, _ in ticks:
            dst[:] = slab
        out[f"slab_copy_{name} ms"] = (time.perf_counter() - t0) * 1e3 / INGRESS_TICKS
    want = {"step_batch": INGRESS_TICKS, "step_batch pinned": INGRESS_TICKS,
            "window=1": INGRESS_TICKS, "window=4": INGRESS_TICKS, "coalescer": COALESCER_TICKS}
    for path, n in want.items():
        if launches[path] != {"tick_fused": n}:
            raise AssertionError(f"ingress {path}: launches {launches[path]}, want tick_fused={n}")
    # metrics on against off, in turns: off, on, on, off, twice
    runs = {}
    for metrics in (None, True, True, None) * 2:
        srv = server(metrics)
        got, ms, _ = timed(lambda: [srv.step_batch(*t) for t in ticks])
        for (gs, gt), (rs, rt) in zip(got, ref):
            if not (np.array_equal(gs, rs) and np.array_equal(gt, rt)):
                raise AssertionError(f"metrics={metrics} server differs from step_batch")
        runs.setdefault(metrics, []).append(ms / INGRESS_TICKS)
        if metrics:
            snap = srv.metrics_snapshot()
    hists = {h["name"]: h["percentiles"] for h in snap["histograms"]}
    # where a pipelined tick's host time goes: the ingress's trace spans
    # (stage -> commit is the caller's copy into the pinned slab) and the
    # server's dispatch / fetch histograms, on an instrumented twin run
    _, _, traced = pipelined(1, metrics=True)
    tsnap = traced.metrics_snapshot()
    for span, roll in tsnap["spans"].items():
        out[f"pipelined span {span} p50"] = roll["p50_ms"]
    for h in tsnap["histograms"]:
        if h["name"] in ("kws_serve_tick_dispatch_ms", "kws_serve_tick_fetch_ms"):
            out[f"pipelined {h['name']} p50"] = h["percentiles"]["p50"]
    out["metrics_off runs"], out["metrics_on runs"] = runs[None], runs[True]
    out["metrics_off ms_per_tick"] = float(np.median(runs[None]))
    out["metrics_on ms_per_tick"] = float(np.median(runs[True]))
    out["metrics overhead_pct"] = (out["metrics_on ms_per_tick"] / out["metrics_off ms_per_tick"]
                                   - 1.0) * 100.0
    for name in ("kws_serve_tick_dispatch_ms", "kws_serve_tick_fetch_ms"):
        out[f"{name} p50"], out[f"{name} p99"] = hists[name]["p50"], hists[name]["p99"]
    print(f"ingress at {N_STREAMS} streams (qat, raw audio, host clock, ms per tick): "
          f"step_batch {out['step_batch ms_per_tick']:.4f} (slabs in pinned memory "
          f"{out['step_batch pinned ms_per_tick']:.4f}), PipelinedIngress depth 2 window 1 "
          f"{out['pipelined window=1 ms_per_tick']:.4f}, window 4 "
          f"{out['pipelined window=4 ms_per_tick']:.4f}, TickCoalescer "
          f"{out['coalescer ms_per_tick']:.4f}; every path equal to the step_batch sequence, "
          f"launches {launches}; the host copy of a {N_STREAMS * HOP * 4 / 2**20:g} MiB slab "
          f"into pinned memory "
          f"{out['slab_copy_pinned ms']:.4f} ms, into pageable memory "
          f"{out['slab_copy_pageable ms']:.4f} ms")
    print(f"metrics on {out['metrics_on ms_per_tick']:.4f} against off "
          f"{out['metrics_off ms_per_tick']:.4f} ms per tick, medians of 4 runs each in turns "
          f"({out['metrics overhead_pct']:+.2f} %; on {out['metrics_on runs']}, off "
          f"{out['metrics_off runs']}), outputs identical; dispatch p50 {out['kws_serve_tick_dispatch_ms p50']:.4f} / p99 "
          f"{out['kws_serve_tick_dispatch_ms p99']:.4f} ms, fetch p50 "
          f"{out['kws_serve_tick_fetch_ms p50']:.4f} / p99 "
          f"{out['kws_serve_tick_fetch_ms p99']:.4f} ms")
    print("PipelinedIngress window 1, instrumented, p50 ms: " + ", ".join(
        f"{k[len('pipelined '):-len(' p50')]} {v:.4f}" for k, v in out.items()
        if k.startswith("pipelined ") and k.endswith(" p50")))
    return out, launches


FLEET_OPEN = 3072  # open streams of the fleet's 4096-slot servers
FLEET_SHARDS = 4  # shards of the sharded server, all on the one card
FLEET_RUNS = (("qat", None), ("delta-int", THETA))
AUTOSCALE_STEPS = 24  # the autoscaler's ramp / peak / drain trace
ENTRY_CLIPS = 8  # logits_all_frames / predict: 0.5 s clips on the card


def _fleet_hops(t: int, n_sids: int):
    """Tick ``t``'s raw hop for stream ids 0 .. n_sids - 1 (gains from -40
    dB to -6 dB full scale) and which of them submit (85 %)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 20 + t)
    gains = np.logspace(-2, -0.3, n_sids).astype(np.float32)[:, None]
    return (rng.standard_normal((n_sids, HOP)).astype(np.float32) * gains,
            rng.random(n_sids) < 0.85)


def _fleet_tick(srv, hops, submit, timed=None):
    """One step_batch of the server's open streams, each fed its own
    stream id's hop; returns {sid: (scores row, top)}. With ``timed`` (a
    dict and a key), the host ms of the step_batch alone go there."""
    import numpy as np

    sids = np.fromiter(srv.active.keys(), dtype=np.int64, count=len(srv.active))
    slots = np.fromiter(srv.active.values(), dtype=np.int64, count=len(srv.active))
    sub = submit[sids]
    slab = np.zeros((srv.max_streams, HOP), np.float32)
    mask = np.zeros(srv.max_streams, bool)
    slab[slots[sub]] = hops[sids[sub]]
    mask[slots[sub]] = True
    if timed is None:
        scores, top = srv.step_batch(slab, mask)
    else:
        ms, (scores, top) = _host_ms(lambda: srv.step_batch(slab, mask))
        timed[0][timed[1]] = ms
    return {int(s): (scores[k], int(top[k])) for s, k in zip(sids, slots)}


def _sid_rows(srv, sids):
    """Every state leaf's rows of ``sids``, in that order."""
    import torch

    idx = torch.tensor([srv.active[s] for s in sids], device=srv.device)
    return [t.index_select(0, idx.to(t.device)) for t in srv.state.leaves()]


def _assert_fleet_equal(where, srv, twin, sids, outs=None):
    """``srv``'s state rows (and the tick outputs ``outs`` = (srv's,
    twin's)) equal the twin's per stream id."""
    import numpy as np
    import torch

    for a, b in zip(_sid_rows(srv, sids), _sid_rows(twin, sids), strict=True):
        if not torch.equal(a.to(b.device), b):
            raise AssertionError(f"{where}: state differs from the twin")
    if outs is not None:
        got, want = outs
        for s in sids:
            if got[s][1] != want[s][1] or not np.array_equal(got[s][0], want[s][0]):
                raise AssertionError(f"{where}: stream {s}'s scores differ from the twin")


def _host_ms(fn):
    """(host ms of ``fn``, its result), the card idle before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, result


def phase_fleet(dev):
    """The elastic fleet at N_STREAMS slots with FLEET_OPEN streams open,
    raw audio, for qat and delta-int (θ = 0.15): a server resized
    N_STREAMS -> 2 * N_STREAMS -> N_STREAMS between ticks, a server of
    FLEET_SHARDS shards on the one card (one tick_fused launch a shard a
    tick) that then loses shard 1, and an Autoscaler over a seeded ramp /
    peak / drain trace; each equal per stream id to an unsharded,
    fixed-capacity twin fed the same traffic (state and scores), the
    recovered shard's streams reopened zeroed. Then logits_all_frames
    (integer) and predict on the card against the CPU plain path. Times:
    host ms of each resize and the recovery and of the step_batch of the
    first and second tick after each; the qat tick at 1 and at FLEET_SHARDS shards (device ms of the
    launches on staged inputs, host ms of a step_batch). Returns (times,
    {kernel key: launches on these paths}, {classifier: 0 max
    difference})."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.serving.autoscale import shard_of_slot
    from repro_torch.serving.serve_loop import StreamingKWSServer

    times, launches = {}, {}
    sids = list(range(FLEET_OPEN))
    for classifier, theta in FLEET_RUNS:
        label = _label(classifier, theta)
        pipe, params = _setup(dev, classifier, theta)

        def server(**kw):
            kw.setdefault("devices", [dev])
            srv = StreamingKWSServer(pipe, params, max_streams=N_STREAMS, smoothing=SMOOTHING,
                                     **kw)
            for sid in sids:
                srv.open_stream(sid)
            return srv

        twin, elastic = server(), server()
        sharded = server(devices=[dev] * FLEET_SHARDS)
        build.launches.clear()
        t = 0

        def tick(*servers, timed=None, after=None):
            """One tick of the servers; with ``timed``, that server's
            step_batch alone is timed as the ``after`` tick."""
            nonlocal t
            hops, submit = _fleet_hops(t, N_STREAMS)
            t += 1
            return [_fleet_tick(srv, hops, submit, None if srv is not timed else
                                (times, f"fleet {label} {after} step_batch host_ms"))
                    for srv in servers]

        for _ in range(2):
            want, got, got_sh = tick(twin, elastic, sharded)
            _assert_fleet_equal(f"fleet {label} sharded", sharded, twin, sids, (got_sh, want))
        moves = ("resize grow", "resize shrink", "recover_shard_loss")
        for what, cap in zip(moves, (2 * N_STREAMS, N_STREAMS)):
            ms, _ = _host_ms(lambda: elastic.resize(cap))
            times[f"fleet {label} {what} host_ms"] = ms
            for nth in ("first", "second"):
                want, got, got_sh = tick(twin, elastic, sharded, timed=elastic,
                                         after=f"{nth} after {what}")
                _assert_fleet_equal(f"fleet {label} after {what}", elastic, twin, sids,
                                    (got, want))
            _assert_fleet_equal(f"fleet {label} sharded", sharded, twin, sids, (got_sh, want))
        if elastic.compile_count != 1:
            raise AssertionError(f"fleet {label}: a resize rebuilt the operands")
        # shard loss: shard 1's streams reopen zeroed, the others keep state
        lost = [s for s in sids
                if shard_of_slot(sharded.active[s], N_STREAMS, FLEET_SHARDS) == 1]
        kept = [s for s in sids if s not in set(lost)]
        before = _sid_rows(sharded, kept)
        ms, info = _host_ms(lambda: sharded.recover_shard_loss(1))
        times[f"fleet {label} recover_shard_loss host_ms"] = ms
        if (info["n_devices"], sorted(info["reopened"]), info["survivors"]) != (
                FLEET_SHARDS // 2, lost, kept):
            raise AssertionError(f"fleet {label}: recovery summary {info}")
        for a, b in zip(_sid_rows(sharded, kept), before, strict=True):
            if not torch.equal(a, b):
                raise AssertionError(f"fleet {label}: a survivor's state changed in the recovery")
        if any(bool(x.any()) for x in _sid_rows(sharded, lost)):
            raise AssertionError(f"fleet {label}: a reopened stream is not zeroed")
        for nth in ("first", "second"):
            want, got, got_sh = tick(twin, elastic, sharded, timed=sharded,
                                     after=f"{nth} after recover_shard_loss")
            _assert_fleet_equal(f"fleet {label} recovered", sharded, twin, kept, (got_sh, want))
        counts = dict(build.launches)
        n_ticks = t
        # twin and elastic one launch a tick; the sharded server one a shard,
        # then one a surviving shard for the two ticks after the recovery
        want_launches = 2 * n_ticks + FLEET_SHARDS * (n_ticks - 2) + 2 * (FLEET_SHARDS // 2)
        if counts != {"tick_fused": want_launches}:
            raise AssertionError(f"fleet {label}: launches {counts}, want only "
                                 f"tick_fused={want_launches}")
        launches[label] = counts["tick_fused"]
        after = ", ".join(
            f"{times[f'fleet {label} first after {w} step_batch host_ms']:.3f} / "
            f"{times[f'fleet {label} second after {w} step_batch host_ms']:.3f}" for w in moves)
        print(f"fleet {label}: {n_ticks} ticks of {FLEET_OPEN} open streams; resize "
              f"{N_STREAMS} -> {2 * N_STREAMS} -> {N_STREAMS} and {FLEET_SHARDS} shards on one "
              f"card equal to the unsharded twin; recover_shard_loss(1) kept {len(kept)}, "
              f"reopened {len(lost)} zeroed; launches {counts}; resize "
              f"{times[f'fleet {label} resize grow host_ms']:.2f} / "
              f"{times[f'fleet {label} resize shrink host_ms']:.2f} ms, recovery "
              f"{times[f'fleet {label} recover_shard_loss host_ms']:.2f} ms; the first / second "
              f"step_batch after each {after} ms (host)")
        if classifier == "qat":
            times.update(_fleet_tick_times(pipe, params, twin, sharded))
    launches.update(_autoscale_run(dev))
    entry_launches, entry_err = _entry_points(dev)
    launches.update(entry_launches)
    return times, launches, entry_err


def _fleet_tick_times(pipe, params, one, sharded):
    """The qat raw tick at N_STREAMS slots on 1 and on FLEET_SHARDS shards
    of one card: device ms of the server's launches on staged inputs
    (CUDA events, back to back after a stream hold) and launches a tick;
    host ms of a step_batch (20 calls)."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.serving.serve_loop import StreamingKWSServer

    out = {}
    hops, _ = _fleet_hops(99, N_STREAMS)
    mask = np.ones(N_STREAMS, bool)
    for n, srv in ((1, one), (FLEET_SHARDS, None)):
        if srv is None:  # the recovered server has 2 shards: a fresh 4-shard one
            srv = StreamingKWSServer(pipe, params, max_streams=N_STREAMS, smoothing=SMOOTHING,
                                     devices=[one.device] * n)
            for sid in range(N_STREAMS):
                srv.open_stream(sid)
        inputs = srv._inputs(hops, mask, ())
        build.launches.clear()
        srv._tick(inputs, True)
        per_tick = build.launches["tick_fused"]
        if per_tick != n:
            raise AssertionError(f"a tick of {n} shards launched {per_tick} kernels")
        ms, _ = _cuda_ms(lambda: srv._tick(inputs, True), reps=50, hold=True)
        for _ in range(3):
            srv.step_batch(hops, mask)
        host_ms, _ = _host_ms(lambda: [srv.step_batch(hops, mask) for _ in range(20)])
        out[f"fleet qat tick {n} shard ms"] = ms
        out[f"fleet qat tick {n} shard launches"] = per_tick
        out[f"fleet qat step_batch {n} shard host_ms"] = host_ms / 20
        print(f"fleet qat tick at {N_STREAMS} streams on {n} shard(s) of one card: {ms:.5f} ms "
              f"(device, {per_tick} launch(es) a tick), step_batch {host_ms / 20:.4f} ms (host)")
    return out


def _autoscale_run(dev):
    """An Autoscaler over a seeded trace: ramp (opens, some refused at
    capacity), peak, drain (closes); every tick's scores and the final
    state equal per stream id to a fixed-capacity twin. Returns the
    launches of the run."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.serving.autoscale import AutoscalePolicy, Autoscaler
    from repro_torch.serving.serve_loop import StreamingKWSServer

    pipe, params = _setup(dev, "qat")
    srv = StreamingKWSServer(pipe, params, max_streams=N_STREAMS // 8, smoothing=SMOOTHING,
                             device=dev)
    twin = StreamingKWSServer(pipe, params, max_streams=N_STREAMS, smoothing=SMOOTHING,
                              device=dev)
    auto = Autoscaler(srv, AutoscalePolicy(min_streams=N_STREAMS // 8, max_streams=N_STREAMS,
                                           grow_at=0.8, shrink_at=0.3, hysteresis_ticks=2,
                                           cooldown_ticks=2))
    rng = np.random.default_rng(SEED + 30)
    nxt = 0
    build.launches.clear()
    for step in range(AUTOSCALE_STEPS):
        if step < 10:  # ramp
            for _ in range(N_STREAMS * 5 // 64):
                try:
                    srv.open_stream(nxt)
                except RuntimeError:
                    auto.note_rejection()
                    continue
                twin.open_stream(nxt)
                nxt += 1
        elif step >= 14:  # drain
            for sid in sorted(srv.active)[: min(len(srv.active) - N_STREAMS // 64,
                                                N_STREAMS * 3 // 32)]:
                srv.close_stream(sid)
                twin.close_stream(sid)
        hops, submit = _fleet_hops(100 + step, nxt)
        t0 = time.perf_counter()
        got = _fleet_tick(srv, hops, submit)
        tick_s = time.perf_counter() - t0
        want = _fleet_tick(twin, hops, submit)
        _assert_fleet_equal(f"autoscaler step {step}", srv, twin, sorted(srv.active), (got, want))
        auto.observe(tick_s)
    counts = dict(build.launches)
    actions = [e["action"] for e in auto.events]
    if "grow" not in actions or "shrink" not in actions:
        raise AssertionError(f"the autoscaler did not grow and shrink: {auto.events}")
    if counts != {"tick_fused": 2 * AUTOSCALE_STEPS}:
        raise AssertionError(f"autoscaler run: launches {counts}")
    print(f"autoscaler: {AUTOSCALE_STEPS} steps, {nxt} streams opened, decisions "
          f"{[(e['action'], e['from'], e['to'], e['reason']) for e in auto.events]}, every "
          f"tick equal per stream id to a {N_STREAMS}-slot twin; launches {counts}")
    return {"autoscale": counts["tick_fused"]}


def _entry_points(dev):
    """logits_all_frames (integer: K2) and predict (integer: K1 and K2) on
    seeded clips on the card, each equal to the same call on the CPU.
    Returns ({kernel key: launches}, max difference)."""
    import torch

    from repro_torch.kernels import build

    pipe, params = _setup(dev, "integer")
    cpu_pipe = pipe.with_state(_state_to(pipe.state, "cpu"))
    cpu_params = {"gru": [{k: v.cpu() for k, v in layer.items()} for layer in params["gru"]],
                  "fc": {k: v.cpu() for k, v in params["fc"].items()}}
    audio = torch.as_tensor(_clips(ENTRY_CLIPS, CLIP_SAMPLES // 2), device=dev)
    fv, _ = pipe.features(audio)
    build.launches.clear()
    logits = pipe.logits_all_frames(params, fv)
    top = pipe.predict(params, audio)
    torch.cuda.synchronize()
    counts = dict(build.launches)
    # the integer classifier's forward: 4 intgemm launches a frame (each
    # layer's input and hidden products), then one for the FC over every
    # frame; once in each call
    frames = fv.shape[1]
    want = {"intgemm": 2 * (4 * frames + 1), "fex_fused": 1}
    if counts != want:
        raise AssertionError(f"logits_all_frames / predict launches {counts}, want {want}")
    cpu_logits = cpu_pipe.logits_all_frames(cpu_params, fv.cpu())
    cpu_top = cpu_pipe.predict(cpu_params, audio.cpu())
    if not torch.equal(logits.cpu(), cpu_logits):
        raise AssertionError("logits_all_frames (integer) differs from the CPU plain path")
    if not torch.equal(top.cpu(), cpu_top):
        raise AssertionError("predict (integer) differs from the CPU plain path")
    print(f"logits_all_frames / predict (integer) on {ENTRY_CLIPS} clips x {frames} frames: "
          f"equal to the CPU plain path; launches {counts}")
    return {"entry intgemm": counts["intgemm"], "entry fex_fused": counts["fex_fused"]}, 0


DRIVER_STREAMS = 32
DRIVER_SECONDS = 1.0  # 62 ticks of 16 ms
# the serving command line's runs: (label, its flags); each also runs
# with --device cpu (the plain tick) on the card run's params, norm stats
# and frontend state, in a process of its own while the card goes on
DRIVER_RUNS = (
    ("qat", ["--classifier", "qat"]),
    ("integer offline", ["--classifier", "integer", "--offline"]),
    ("delta-int cascade pipelined", ["--classifier", "delta-int", "--theta", "0.15",
                                     "--cascade", "--pipelined", "--window", "4"]),
    ("hardware metrics autoscale", ["--frontend", "hardware", "--metrics", "--autoscale"]),
    ("float grow 2 shards", ["--classifier", "float", "--grow", "64", "--devices", "cuda:0",
                             "cuda:0"]),
)
DRIVER_TIMEOUT = 300  # s, the CPU twins' processes

_DRIVER_WORKER = """
import sys
import torch
torch.set_num_threads(1)
import chip_smoke
job = torch.load(sys.argv[1], weights_only=False)
if job["kind"] == "quickstart":
    from repro_torch import quickstart
    out = quickstart.run("cpu")
else:
    from repro_torch.serving import serve_streaming
    out = chip_smoke._driver_snapshot(serve_streaming.serve(
        serve_streaming.parse_args(job["argv"]), job["params"], job["stats"], job["state"]))
torch.save(out, sys.argv[2])
"""


def _driver_argv(flags, device=None):
    argv = ["--streams", str(DRIVER_STREAMS), "--seconds", str(DRIVER_SECONDS)] + flags
    if device == "cpu":
        argv = [("cpu" if a.startswith("cuda") else a) for a in argv] + ["--device", "cpu"]
    return argv


def _driver_snapshot(res):
    """What a driver run produced, on the host: the server's state in
    global slot order, its slot map, sparsity, wake rate, the metrics'
    deterministic parts, the per-stream top and the autoscaler's
    decisions."""
    import dataclasses

    srv = res["server"]
    state = {f.name: getattr(srv.state, f.name) for f in dataclasses.fields(srv.state)}
    snap = srv.metrics_snapshot() if srv.metrics is not None else None
    metrics = None
    if snap is not None:
        def key(e):
            return e["name"], tuple(sorted(e["labels"].items()))
        metrics = {"counters": sorted((key(e), e["value"]) for e in snap["counters"]),
                   "gauges": sorted((key(e), e["value"]) for e in snap["gauges"]),
                   "histograms": sorted((key(e), e["count"]) for e in snap["histograms"]),
                   "journal": [e["kind"] for e in snap["journal"]]}
    return {"state": _tree_to(state, "cpu"), "active": dict(srv.active),
            "sparsity": srv.sparsity, "wake_rate": srv.wake_rate, "top": res["top"],
            "top_counts": res["top_counts"], "metrics": metrics, "n_frames": res["n_frames"],
            "decisions": [(d["action"], d["from"], d["to"], d["reason"])
                          for d in res["decisions"]],
            "ms_per_tick": res["ms_per_tick"], "n_devices": srv.n_devices,
            "max_streams": srv.max_streams}


def _tree_to(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _driver_tmp():
    """A scratch directory for the twins' jobs and results, removed at exit."""
    import atexit
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_driver_")
    atexit.register(shutil.rmtree, tmp, True)
    return tmp


def _driver_job(tmp, name, job):
    """Start a CPU twin's process on ``job``: (Popen, its output path). A
    twin still running when the script exits is killed."""
    import atexit

    import torch

    src, out = Path(tmp) / f"{name}.job", Path(tmp) / f"{name}.out"
    torch.save(job, src)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.Popen([sys.executable, "-c", _DRIVER_WORKER, str(src), str(out)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                            env=env)
    atexit.register(proc.kill)
    return proc, out


def quickstart_twin():
    """The quickstart's --device cpu run (the plain versions, ~1 min of one
    core), started in a process of its own. Nothing of it depends on the
    card, so `main` starts it before the phases and `phase_driver` joins it."""
    return _driver_job(_driver_tmp(), "quickstart", {"kind": "quickstart"})


def _driver_join(name, proc, out):
    import torch

    _, err = proc.communicate(timeout=DRIVER_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"driver twin {name}: exit {proc.returncode}\n{err[-4000:]}")
    return torch.load(out, weights_only=False)


def _assert_driver_equal(label, card, cpu, flt):
    """A card run against its --device cpu twin, per stream id: GRU state,
    carry, detector state, top, sparsity, wake rate and the decisions
    equal; scores within SCORE_TOL (FLOAT_TOL and the GRU state too for
    float). Returns the largest score (and float state) difference."""
    import numpy as np
    import torch

    from repro_torch.core.frontend import tree_leaves

    for key in ("top", "top_counts", "decisions", "metrics", "n_frames", "max_streams"):
        if card[key] != cpu[key]:
            raise AssertionError(f"driver {label}: {key} {card[key]} on the card, "
                                 f"{cpu[key]} on the CPU")
    sids = sorted(card["active"])
    if sids != sorted(cpu["active"]):
        raise AssertionError(f"driver {label}: open streams differ")
    rows = [card["active"][s] for s in sids], [cpu["active"][s] for s in sids]
    worst = 0.0
    for field in ("gru", "carry", "det", "scores"):
        got, want = tree_leaves(card["state"][field]), tree_leaves(cpu["state"][field])
        if len(got) != len(want):
            raise AssertionError(f"driver {label}: {field} has {len(got)} leaves, {len(want)}")
        for a, b in zip(got, want):
            a, b = a[rows[0]], b[rows[1]]
            if field == "scores" or (flt and field == "gru"):
                err = float((a.double() - b.double()).abs().max())
                worst = max(worst, err)
                if err > (FLOAT_TOL if flt else SCORE_TOL):
                    raise AssertionError(f"driver {label}: {field} differs by {err}")
            elif a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"driver {label}: {field} differs from the CPU run")
    for key in ("sparsity", "wake_rate"):
        if not np.array_equal(card[key][rows[0]], cpu[key][rows[1]]):
            raise AssertionError(f"driver {label}: {key} differs from the CPU run")
    return worst


def phase_driver(dev, quick=None):
    """The serving command line (`python -m repro_torch.serving.serve_streaming`)
    in process at DRIVER_STREAMS streams x 62 ticks for each DRIVER_RUNS run,
    and the quickstart (`repro_torch.quickstart.run`), on the card. Each run's
    launches are counted from its set-up on: tick_fused once a tick a shard
    (K4 inside it for the ΔGRU); the set-up's K1 (norm stats), and for the
    hardware run its calibration's kernels. Each is held against the same
    driver with --device cpu (the plain tick) on the card run's params, norm
    stats and frontend state, run in a process of its own meanwhile; the
    quickstart's K1 frames against the CPU run's plain version, its integer
    scores bit-identical to qat, its FV_Raw diffs the CPU run's (``quick``:
    that run's process from `quickstart_twin`, else started here). Returns
    ({kernel: launches}, {run: max score error}, times)."""
    import collections

    from repro_torch import quickstart
    from repro_torch.kernels import build
    from repro_torch.serving import serve_streaming

    t_phase = time.perf_counter()
    launches, errs, times = collections.Counter(), {}, {}
    twins = {"quickstart": quick or quickstart_twin()}
    tmp = _driver_tmp()
    cards = {}
    for label, flags in DRIVER_RUNS:
        build.launches.clear()
        res = serve_streaming.serve(serve_streaming.parse_args(_driver_argv(flags)))
        counts = dict(build.launches)
        srv = res["server"]
        # one tick_fused launch a tick a shard, a pipelined window of 4
        # ticks included (`run_batch_async` launches each tick's kernel)
        want = res["n_frames"] * srv.n_devices
        if res["n_frames"] != int(DRIVER_SECONDS / 16e-3) or counts.get("tick_fused") != want:
            raise AssertionError(f"driver {label}: launches {counts}, want tick_fused={want}")
        launches.update({f"{label} {k}": n for k, n in counts.items()})
        cards[label] = _driver_snapshot(res)
        times[f"driver {label} ms_per_tick"] = res["ms_per_tick"]
        pipe = res["pipeline"]
        twins[label] = _driver_job(tmp, label.replace(" ", "_"), {
            "kind": "driver", "argv": _driver_argv(flags, "cpu"),
            "params": _tree_to(res["params"], "cpu"),
            "stats": _state_to(pipe.state, "cpu").norm_stats,
            "state": _state_to(pipe.state, "cpu")})
        print(f"driver {label}: {want} tick_fused launches over {res['n_frames']} ticks on "
              f"{srv.n_devices} shard(s), {res['ms_per_tick']:.4f} ms a tick (host clock, "
              f"build excluded), set-up and run launches {counts}")
    build.launches.clear()
    q = quickstart.run(dev)
    q_counts = dict(build.launches)
    launches.update({f"quickstart {k}": n for k, n in q_counts.items()})
    times["quickstart s"] = q["seconds"]
    for label, _ in DRIVER_RUNS:
        cpu = _driver_join(label, *twins[label])
        errs[label] = _assert_driver_equal(label, cards[label], cpu, "float" in label)
        print(f"driver {label}: equal to --device cpu per stream (scores within "
              f"{errs[label]:.3g}); the CPU run {cpu['ms_per_tick']:.2f} ms a tick")
    cq = _driver_join("quickstart", *twins["quickstart"])
    if not q["integer_exact"]:
        raise AssertionError("quickstart: the integer scores are not qat's on the card")
    if q["fv_raw_diff"] != cq["fv_raw_diff"]:
        raise AssertionError(f"quickstart FV_Raw diffs {q['fv_raw_diff']} on the card, "
                             f"{cq['fv_raw_diff']} on the CPU")
    errs["quickstart frames"] = float(abs(q["frames"] - cq["frames"]).max())
    if errs["quickstart frames"] != 0.0:
        raise AssertionError(f"quickstart: K1's frames differ from the plain version by "
                             f"{errs['quickstart frames']}")
    secs = time.perf_counter() - t_phase
    times["driver phase s"] = secs
    print(f"quickstart on the card in {q['seconds']:.3f} s, launches {q_counts}: K1's frames "
          f"equal to the plain version, integer bit-identical to qat, FV_Raw diffs "
          f"{q['fv_raw_diff']} as on the CPU; top {q['top']} (CPU {cq['top']})")
    print(f"phase_driver: {secs:.1f} s")
    return dict(launches), errs, times


TRAIN_PER_CLASS = 24  # the reference example's corpus: 24 clips a class, test set seed 1
# two runs of 25: the second resumes from the first's checkpoint (200, then
# 100, until the script's time grew past three quarters of its limit)
TRAIN_STEPS = 50
TRAIN_BATCH = 64
# a step's gradients on the card against the same step on the CPU, per
# leaf, max |difference| / max |gradient|: the forward is equal on the
# grid, the backward's sums run in other orders (cuBLAS against the CPU)
TRAIN_GRAD_TOL = 1e-5


def _grad_rel_err(got, want) -> float:
    """Largest max |difference| / max |want| over the leaves of two
    gradient trees."""
    from repro_torch.training.checkpoint import _flatten_with_names

    return max(float((a.cpu() - b.cpu()).abs().max() / b.abs().max())
               for (_, a), (_, b) in zip(_flatten_with_names(got), _flatten_with_names(want),
                                         strict=True))


def _profile_step(step, top: int = 0):
    """(device activities, device busy share, host ms) of one call of
    ``step`` under torch.profiler: the union of the device's intervals over
    the span of everything the profiler saw. None for both where it saw
    no device activity. With ``top``, prints the ``top`` kernel names by
    their summed device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    events = list(prof.events())
    device = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    if not device:
        return None, None, host_ms
    if top:
        by_name = {}
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                              - e.time_range.start) / 1e3
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
            print(f"  device {ms:9.3f} ms  {name[:110]}")
    busy, end = 0.0, float("-inf")
    for a, b in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events))
    return len(device), busy / span, host_ms


def phase_train(dev):
    """QAT training through `repro_torch.training.kws.train`, the entry
    point of ``python -m repro_torch.training.kws``: the synthetic corpus
    (seed 0, TRAIN_PER_CLASS a class; test set seed 1) recorded on the
    card (K1), TRAIN_STEPS / 2 steps at TRAIN_BATCH with AdamW and
    ReduceLROnPlateau and a checkpoint, then a second run that resumes
    from it for the rest; the test accuracy of the QAT model and of its
    integer replay (K2). Checks: the checkpoint's leaves equal the first
    run's state, the loss falls, accuracy beats 1/12, the integer replay's
    confusion matrix and logits equal the QAT model's, one step's
    gradients on the card within TRAIN_GRAD_TOL of the same step on the
    CPU; one warm step under torch.profiler. Returns ({kernel: launches},
    times)."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig
    from repro_torch.distributed.fault_tolerance import CheckpointManager, CheckpointPolicy
    from repro_torch.kernels import build
    from repro_torch.training import kws
    from repro_torch.training.checkpoint import _flatten_with_names
    from repro_torch.training.optimizer import ReduceLROnPlateau, tree_map

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the QAT matmuls and their backward need full float32")
    ckpt_dir = ROOT / "chiprun_out" / "kws_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    half = TRAIN_STEPS // 2
    run = dict(batch=TRAIN_BATCH, n_per_class=TRAIN_PER_CLASS, ckpt_dir=str(ckpt_dir),
               device=dev, ckpt_every=half)
    build.launches.clear()
    first = kws.train(steps=half, **run)
    # the checkpoint the second run resumes from holds the first run's state
    got_p, got_opt, _ = kws.resume(CheckpointManager(CheckpointPolicy(str(ckpt_dir), half)),
                                   first["params"], first["opt"], ReduceLROnPlateau(*kws.SCHEDULE))
    for (name, a), (_, b) in zip(_flatten_with_names((got_p, got_opt)),
                                 _flatten_with_names((first["params"], first["opt"])), strict=True):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"checkpoint leaf {name} differs from the state it saved")
    second = kws.train(steps=TRAIN_STEPS, resume_run=True, **run)
    if second["start_step"] != half:
        raise AssertionError(f"the second run resumed at {second['start_step']}, not {half}")
    ftr, fte = second["features"]
    pipes = {c: KWSPipeline(KWSPipelineConfig(classifier=c)) for c in ("qat", "integer")}
    logits = {c: pipe.logits(second["params"], fte) for c, pipe in pipes.items()}
    torch.cuda.synchronize()
    counts = dict(build.launches)
    # K1: record_features in batches of 64 (train and test set) a run; K2:
    # the integer evaluation (4 launches a frame and the FC, one batch of
    # up to 128 clips), twice, then the replay's logits once
    n_train, n_test = 12 * TRAIN_PER_CLASS, 12 * max(TRAIN_PER_CLASS // 3, 4)
    frames = ftr.shape[1]
    ceil = lambda a, b: -(-a // b)  # noqa: E731
    want = {"fex_fused": 2 * (ceil(n_train, 64) + ceil(n_test, 64)),
            "intgemm": 3 * ceil(n_test, 128) * (4 * frames + 1)}
    if counts != want:
        raise AssertionError(f"train: launches {counts}, want {want}")
    if not torch.equal(logits["integer"], logits["qat"]):
        raise AssertionError("the integer replay's logits differ from the QAT model's")
    if not np.array_equal(second["confusion"], second["int_confusion"]):
        raise AssertionError("the integer replay's confusion matrix differs from the QAT model's")
    losses = first["losses"] + second["losses"]
    w = kws.WINDOW
    if not np.mean(losses[-w:]) < np.mean(losses[:w]):
        raise AssertionError(f"the loss did not fall: {np.mean(losses[:w]):.4f} -> "
                             f"{np.mean(losses[-w:]):.4f}")
    if not second["accuracy"] > 1 / 12:
        raise AssertionError(f"test accuracy {second['accuracy']:.4f} does not beat 1/12")

    # one step's gradients on the card and on the CPU, on a batch of the
    # recorded features at the trained params
    idx = torch.arange(TRAIN_BATCH, device=dev)
    ytr = torch.as_tensor(second["labels"][0], device=dev)
    loss, grads = kws.value_and_grad(second["params"], ftr[idx], ytr[idx])
    cpu_loss, cpu_grads = kws.value_and_grad(tree_map(lambda t: t.cpu(), second["params"]),
                                             ftr[idx].cpu(), ytr[idx].cpu())
    grad_err = _grad_rel_err(grads, cpu_grads)
    loss_err = abs(float(loss) - float(cpu_loss))
    if grad_err > TRAIN_GRAD_TOL or loss_err > 1e-6:
        raise AssertionError(f"a step's gradients on the card differ from the CPU's by "
                             f"{grad_err:.3g} of max |g| (limit {TRAIN_GRAD_TOL}), the loss by "
                             f"{loss_err:.3g}")

    # one warm step under the profiler
    params, opt = second["params"], second["opt"]
    for _ in range(2):
        params, opt, _ = kws.train_step(params, opt, ftr[idx], ytr[idx], 1e-3)
    n_dev, busy, prof_ms = _profile_step(
        lambda: kws.train_step(params, opt, ftr[idx], ytr[idx], 1e-3))
    steps_s = first["step_s"][1:] + second["step_s"][1:]
    out = {
        "train step s": float(np.median(steps_s)),
        "train first step s": first["step_s"][0],
        "train run s": first["seconds"] + second["seconds"],
        "train device activities a step": n_dev,
        "train busy share": busy,
        "train profiled step ms": prof_ms,
        "train grad err": grad_err,
        "train accuracy": second["accuracy"],
    }
    print(f"train: {len(losses)} steps at batch {TRAIN_BATCH} over {frames} frames on "
          f"{n_train} clips ({TRAIN_STEPS // 2} + {TRAIN_STEPS // 2} resumed from the checkpoint, "
          f"whose leaves equal the saved state); loss {np.mean(losses[:w]):.4f} -> "
          f"{np.mean(losses[-w:]):.4f}; test accuracy {second['accuracy']:.4f} over {n_test} "
          f"clips (QAT), the integer replay's confusion matrix and logits equal; launches {counts}")
    print(f"train: a warm step {out['train step s']:.5f} s (median of {len(steps_s)}), the first "
          f"{out['train first step s']:.4f} s, both runs' steps {out['train run s']:.3f} s; "
          f"the card's gradients within {grad_err:.3g} of max |g| of the CPU's (limit "
          f"{TRAIN_GRAD_TOL}), the loss within {loss_err:.3g}; TF32 off")
    if n_dev is None:
        print("train: torch.profiler saw no device activity: kernels a step and busy share "
              "not measured")
    else:
        print(f"train: one warm step under torch.profiler: {n_dev} device activities "
              f"(kernels and copies), the device busy {busy:.4f} of the span, {prof_ms:.3f} ms "
              f"on the host clock")
    return counts, out


DP_SHARDS = 4  # data-parallel shards, all on the one card
DP_STEPS = 5  # 20, then 10, until the script's time grew past 0.9 of its limit


def phase_train_dp(dev):
    """Data-parallel QAT training through `training.kws.train` (the entry
    point of ``python -m repro_torch.training.kws --dp 4 --compress-grads
    --devices cuda:0 ...``): the reference example's recipe on DP_SHARDS
    shards of the one card, batch TRAIN_BATCH (a shard's TRAIN_BATCH /
    DP_SHARDS rows), the int8 all-reduce with error feedback, DP_STEPS
    steps; the corpus recorded by K1, the integer replay by K2. Checks:
    the first step's loss, synced gradients and per-shard residuals on the
    card against the same step on the CPU's shards within TRAIN_GRAD_TOL
    (a whole code may differ where a value lies within it of a rounding
    tie: at most 0.1 % of the elements), one plain DP step against the
    single-device `value_and_grad` on the same batch, the integer replay's
    confusion matrix equal to QAT's. Returns ({kernel: launches}, times)."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.core.gru import GRUConfig, init_gru_classifier
    from repro_torch.distributed.collectives import elements_apart, init_residual
    from repro_torch.kernels import build
    from repro_torch.training import kws
    from repro_torch.training.optimizer import tree_map

    ckpt_dir = ROOT / "chiprun_out" / "kws_dp_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    devices = [str(dev)] * DP_SHARDS
    build.launches.clear()
    out = kws.train(steps=DP_STEPS, batch=TRAIN_BATCH, n_per_class=TRAIN_PER_CLASS,
                    ckpt_dir=str(ckpt_dir), device=dev, ckpt_every=DP_STEPS, dp=DP_SHARDS,
                    compress_grads=True, devices=devices)
    torch.cuda.synchronize()
    counts = dict(build.launches)
    n_train, n_test = 12 * TRAIN_PER_CLASS, 12 * max(TRAIN_PER_CLASS // 3, 4)
    ftr, fte = out["features"]
    frames = ftr.shape[1]
    ceil = lambda a, b: -(-a // b)  # noqa: E731
    want = {"fex_fused": ceil(n_train, 64) + ceil(n_test, 64),
            "intgemm": ceil(n_test, 128) * (4 * frames + 1)}
    if counts != want:
        raise AssertionError(f"train dp: launches {counts}, want {want}")
    if len(out["residual"]) != DP_SHARDS or not np.isfinite(out["losses"]).all():
        raise AssertionError("train dp: a residual a shard and finite losses expected")
    if not np.array_equal(out["confusion"], out["int_confusion"]):
        raise AssertionError("train dp: the integer replay's confusion matrix differs from QAT's")

    # the run's first step on the card and on the CPU: the initial params,
    # the step-0 batch, zero residuals
    ytr = torch.as_tensor(out["labels"][0], device=dev)
    rows = torch.as_tensor(kws._batch(0, 0, n_train, TRAIN_BATCH), device=dev)
    params = init_gru_classifier(GRUConfig(), torch.Generator().manual_seed(0), dev)
    fv, y = ftr[rows], ytr[rows]

    def first_step(device, shard_devices):
        reps = [tree_map(lambda t, d=d: t.to(d), params) for d in shard_devices]
        return kws.dp_value_and_grad(reps, fv.to(device), y.to(device),
                                     residual=[init_residual(r) for r in reps])

    loss, synced, resid = first_step(dev, [dev] * DP_SHARDS)
    cpu_loss, cpu_synced, cpu_resid = first_step("cpu", ["cpu"] * DP_SHARDS)
    flips = [elements_apart(a, b, cpu_synced[0], TRAIN_GRAD_TOL)
             for a, b in [(synced[0], cpu_synced[0])] + list(zip(resid, cpu_resid))]
    off, total = sum(f[0] for f in flips), sum(f[1] for f in flips)
    loss_err = abs(float(loss) - float(cpu_loss))
    if loss_err > 1e-6 or off > 1e-3 * total:
        raise AssertionError(f"train dp: the first step on the card differs from the CPU's: loss "
                             f"by {loss_err:.3g}, {off} of {total} synced / residual elements "
                             f"beyond {TRAIN_GRAD_TOL} of max |g|")
    # one plain DP step against the single-device step on the same batch
    plain_loss, plain, _ = kws.dp_value_and_grad(
        [tree_map(lambda t: t.clone(), params) for _ in range(DP_SHARDS)], fv, y)
    one_loss, one = kws.value_and_grad(params, fv, y)
    plain_err = _grad_rel_err(plain[0], one)
    if plain_err > TRAIN_GRAD_TOL or abs(float(plain_loss) - float(one_loss)) > 1e-6:
        raise AssertionError(f"train dp: a plain DP step differs from the single-device step by "
                             f"{plain_err:.3g} of max |g| (limit {TRAIN_GRAD_TOL})")
    steps_s = out["step_s"][1:]
    w = kws.WINDOW
    times = {"train dp step s": float(np.median(steps_s)),
             "train dp first step s": out["step_s"][0],
             "train dp run s": out["seconds"],
             "train dp loss": float(np.mean(out["losses"][-w:]))}
    print(f"train dp: {DP_STEPS} steps, {DP_SHARDS} shards on {dev} (compressed, batch "
          f"{TRAIN_BATCH}, {TRAIN_BATCH // DP_SHARDS} rows a shard): a warm step "
          f"{times['train dp step s']:.5f} s (median of {len(steps_s)}), the first "
          f"{times['train dp first step s']:.4f} s, the run {times['train dp run s']:.3f} s; loss "
          f"{np.mean(out['losses'][:w]):.4f} -> {times['train dp loss']:.4f}; test accuracy "
          f"{out['accuracy']:.4f}, the integer replay's confusion matrix equal; launches {counts}")
    print(f"train dp: the first step's loss within {loss_err:.3g} of the CPU's, {off} of {total} "
          f"synced / residual elements a code apart (beyond {TRAIN_GRAD_TOL} of max |g|); a plain "
          f"DP step within {plain_err:.3g} of max |g| of the single-device step")
    return counts, times


LM_ARCH = "rwkv6-7b"
LM_LAYERS = 2  # 32 layers (~7.5 B parameters) with grads and moments exceed 80 GB
LM_SEQ = 4096  # the train_4k length, batch 1
LM_STEPS = 10
LM_DECODE = 16
LM_ZERO_LEAVES = ("bonus_u", "mix_x", "mix_base", "cm_mix_k", "cm_mix_r", "ln1", "ln2", "ln_x")
# bfloat16 logits of the last decode step against the full forward at the
# same position, max |difference| / max |logit|: the decode carries its
# WKV state in bfloat16 step by step, the chunked form within chunks in
# float32; measured 0.0062 on an H100 at rwkv6-7b's full width, 2 layers,
# with LM_ZERO_LEAVES drawn away from zero
LM_DECODE_TOL = 0.02
# A train step's peak as `training.train_loop.lower_train_step` predicts it
# (the step traced on fake tensors on the card, the parameters, AdamW's
# state and the batch held) against max_memory_allocated over the run's
# steps: |predicted - measured| within this share of the measured peak.
LM_PEAK_TOL = 0.10


def _predict_step(dev, cfg, label, seq, rules=None):
    """`lower_train_step`'s prediction for one AdamW (3e-3) step of ``cfg``
    at 1 x ``seq`` tokens on ``dev`` (with sharding ``rules``, every body
    of the MoE route's device grid): (analysis, modelled step s, seconds
    the trace took). Prints its line under ``label``."""
    import torch

    from repro_torch.configs import SHAPES
    from repro_torch.launch.roofline import make_report
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig, lower_train_step

    shape = torch.empty((1, seq), dtype=torch.int32, device="meta")
    t0 = time.perf_counter()
    analysis, _, _ = lower_train_step(cfg, {"tokens": shape, "labels": shape},
                                      TrainConfig(optimizer=AdamWConfig(lr=3e-3)), dev, rules)
    trace_s = time.perf_counter() - t0
    report = make_report(cfg, SHAPES["train_4k"], analysis, "train")
    print(f"{label}: lower_train_step predicts (traced on fake tensors in {trace_s:.1f} s) a "
          f"peak of {analysis.peak_bytes / 1e9:.3f} GB ({analysis.held_bytes / 1e9:.3f} GB "
          f"held), graph flops {analysis.flops:.4e} "
          f"({', '.join(f'{k} {v:.3e}' for k, v in sorted(analysis.flops_by_dtype.items()))}), "
          f"bytes {analysis.hbm_bytes:.4e}, a modelled step of {report.step_time_s:.4f} s "
          f"({report.dominant}-bound: compute {report.compute_s:.4f} s, memory "
          f"{report.memory_s:.4f} s)")
    return analysis, report.step_time_s, trace_s


def _hold_prediction(key, label, analysis, modelled_s, trace_s, train_peak, warm):
    """The predicted peak against the measured one within LM_PEAK_TOL
    (raises otherwise); the measured warm step against the modelled one
    (printed, not held). Returns the times under ``key``."""
    err = (analysis.peak_bytes - train_peak) / train_peak
    print(f"{label}: predicted peak {analysis.peak_bytes / 1e9:.3f} GB, measured "
          f"{train_peak / 1e9:.3f} GB ({err:+.2%}, limit {LM_PEAK_TOL:.0%}); graph flops "
          f"{analysis.flops:.4e}; modelled step {modelled_s:.4f} s, measured warm step "
          f"{warm:.4f} s (measured / modelled {warm / modelled_s:.3f})")
    if abs(err) > LM_PEAK_TOL:
        raise AssertionError(f"{label}: predicted peak {analysis.peak_bytes / 1e9:.3f} GB is "
                             f"{err:+.2%} off the measured {train_peak / 1e9:.3f} GB (limit "
                             f"{LM_PEAK_TOL:.0%})")
    return {f"{key} predicted peak GB": analysis.peak_bytes / 1e9,
            f"{key} predicted peak err": err, f"{key} graph flops": analysis.flops,
            f"{key} graph bytes": analysis.hbm_bytes, f"{key} modelled step s": modelled_s,
            f"{key} step / modelled": warm / modelled_s, f"{key} lowering s": trace_s}


def phase_lm(dev):
    """The LM train step (`training.train_loop.build_train_step`) on
    rwkv6-7b at full width (d_model 4096, d_ff 14336, vocab 65536, 64
    heads of 64, bfloat16, remat "full") cut to LM_LAYERS layers, random
    weights from a generator on the card: LM_STEPS steps at batch 1 x
    LM_SEQ tokens of the reference smoke's recipe (tokens from
    default_rng(0), inputs [:, :-1], labels [:, 1:]), then a prefill of
    LM_SEQ tokens and LM_DECODE decode steps, with LM_ZERO_LEAVES (zero
    as drawn) drawn away from zero, the last decode's logits against the
    full forward's at the same position within LM_DECODE_TOL. No kernel
    of the port runs (the backbone trains through the chunked WKV6 form,
    as the reference does). Before training, `lower_train_step` predicts
    the step's peak from the port's graph on fake tensors; the measured
    peak must be within LM_PEAK_TOL of it (`_hold_prediction`). Returns
    ({kernel: launches}, times)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import rwkv6
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import TrainConfig, build_train_step, lm_batches

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    predicted = _predict_step(dev, cfg, "lm", LM_SEQ)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # what the earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    build.launches.clear()
    params = rwkv6.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
    n_params = sum(t.numel() for t in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "head", "final_norm"))
    opt = init_opt_state(params, AdamWConfig(lr=3e-3))
    step = build_train_step(cfg, TrainConfig(optimizer=AdamWConfig(lr=3e-3)), dev)
    losses, step_s = [], []
    for batch in lm_batches(cfg.vocab, LM_STEPS, batch=1, seq=LM_SEQ):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    train_peak = torch.cuda.max_memory_allocated() - base
    if not np.isfinite(losses).all():
        raise AssertionError(f"lm: a loss is not finite: {losses}")
    print("lm: one more step under torch.profiler, its kernels by device ms:")
    n_dev, busy, prof_ms = _profile_step(lambda: step(params, opt, batch), top=8)
    del opt
    # the leaves that init_params draws as zero (the bonus u, the token-shift
    # and channel-mix mixes, the norms' scales), drawn away from it so that
    # the decode check exercises them
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for name in LM_ZERO_LEAVES:
        leaf = params["layers"][name]
        noise = torch.randn(leaf.shape, generator=gen, device=dev) * 0.1
        params["layers"][name] = (leaf.float() + noise).to(leaf.dtype)

    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, LM_SEQ + LM_DECODE)).astype(np.int32)).to(dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = rwkv6.prefill(params, {"tokens": toks[:, :LM_SEQ]}, cfg)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(LM_DECODE):
            logits, cache = rwkv6.decode_step(params, cache, LM_SEQ + i,
                                              {"tokens": toks[:, LM_SEQ + i:LM_SEQ + i + 1]}, cfg)
        torch.cuda.synchronize()
        decode_s = (time.perf_counter() - t0) / LM_DECODE
        full, _ = rwkv6.forward(params, {"tokens": toks}, cfg)
    torch.cuda.synchronize()
    counts = dict(build.launches)
    if counts:
        raise AssertionError(f"lm: launches {counts}, want none (PyTorch operations only)")
    ref = full[:, -1].float()
    decode_err = float((logits.float() - ref).abs().max() / ref.abs().max())
    # prefill runs the forward's block code on the first LM_SEQ tokens: its
    # last logits check prefill's slicing and cache, not the recurrence
    ref_p = full[:, LM_SEQ - 1].float()
    prefill_err = float((last.float() - ref_p).abs().max() / ref_p.abs().max())
    if not (decode_err <= LM_DECODE_TOL and prefill_err <= LM_DECODE_TOL):
        raise AssertionError(f"lm: prefill's last / the last decode logits differ from the "
                             f"forward's by {prefill_err:.3g} / {decode_err:.3g} of max |logit| "
                             f"(limit {LM_DECODE_TOL})")
    warm = float(np.median(step_s[1:]))
    times = {"lm step s": warm, "lm first step s": step_s[0],
             "lm tokens per s": LM_SEQ / warm, "lm train peak GB": train_peak / 1e9,
             "lm peak GB": (torch.cuda.max_memory_allocated() - base) / 1e9,
             "lm prefill s": prefill_s, "lm decode ms": decode_s * 1e3,
             "lm loss first": losses[0], "lm loss last": losses[-1],
             "lm params": n_params, "lm decode err": decode_err,
             "lm device activities a step": n_dev, "lm busy share": busy,
             "lm profiled step ms": prof_ms}
    times.update(_hold_prediction("lm", "lm", *predicted, train_peak, warm))
    print(f"lm: {LM_ARCH} at full width ({cfg.d_model} / {cfg.d_ff} / vocab {cfg.vocab}, "
          f"{cfg.d_model // cfg.resolved_head_dim} heads of {cfg.resolved_head_dim}, "
          f"{cfg.dtype}, remat {cfg.remat}) cut to {LM_LAYERS} layers ({n_params} params): "
          f"{LM_STEPS} train steps at 1 x {LM_SEQ} tokens, a warm step {warm:.4f} s (median of "
          f"{LM_STEPS - 1}), the first {step_s[0]:.3f} s, {LM_SEQ / warm:.1f} tokens a second, "
          f"peak {train_peak / 1e9:.3f} GB (max_memory_allocated above the "
          f"{base / 1e9:.3f} GB the earlier phases hold); loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"lm: prefill of {LM_SEQ} tokens {prefill_s:.4f} s, {LM_DECODE} decode steps "
          f"{decode_s * 1e3:.3f} ms each, with {', '.join(LM_ZERO_LEAVES)} drawn away from zero: "
          f"the last decode logits within {decode_err:.3g} of max |logit| of the forward's "
          f"(limit {LM_DECODE_TOL}), prefill's last (the same block code) within "
          f"{prefill_err:.3g}; peak "
          f"{times['lm peak GB']:.3f} GB; launches {counts or 'none'}")
    if n_dev is None:
        print("lm: torch.profiler saw no device activity: busy share not measured")
    else:
        print(f"lm: one step under torch.profiler: {n_dev} device activities, the device busy "
              f"{busy:.4f} of the span, {prof_ms:.3f} ms on the host clock")
    return counts, times


TF_SEQ = 4096  # the train_4k length, batch 1
TF_STEPS = 4  # 6 until rwkv6's and zamba2's mesh phase joined the script
TF_DECODE = 16
# (arch, layers, prompt): each at its published widths. qwen3-4b's 36 layers
# (4.02 B parameters) need 22 bytes a parameter while AdamW writes the new
# state beside the old (bf16 params and grads, float32 moments, twice):
# 88.5 GB with nothing else; granite's 32 layers (3.30 B) 72.6 GB plus
# AdamW's float32 / float64 temporaries, ~28 bytes an element of its
# (32, 40, 1536, 512) expert leaf. Both are cut to the deepest stack that
# trains within the card's 80 GB without the allocator emptying its cache
# mid-step: on an H100 qwen3-4b peaked at 76.9 GB at 23 layers (at 24,
# 79.9 GB and one allocator retry), granite at 77.6 GB at 24. gemma2-27b
# runs one local / global step (75.0 GB: AdamW's float64 root of the
# (256000, 4608) embedding alone is 9.4 GB); its 4100-token prompt passes
# the 4096 window, so prefill rolls its local rings and the forward's
# window mask cuts in.
TF_RUNS = (("qwen3-4b", 23, TF_SEQ), ("gemma2-27b", 2, TF_SEQ + 4),
           ("granite-moe-3b-a800m", 24, TF_SEQ))
TF_NORMS = ("ln1", "ln2", "ln1_post", "ln2_post", "q_norm", "k_norm", "final_norm")
# bfloat16 logits of prefill's last position and of the last decode step
# against a full forward over the same tokens, max |difference| / max
# |logit|: decode attends through the grouped form over the cache, the
# forward through the repeated heads, and both round to bfloat16 in other
# places
TF_DECODE_TOL = 0.02


def _draw_norms(tree, gen, names=TF_NORMS):
    """The leaves ``names`` (the norm scales, zero as `init_params` draws
    them) drawn away from their initial values, so that the decode check
    exercises them."""
    import torch

    for key, leaf in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(leaf, (dict, list)):
            _draw_norms(leaf, gen, names)
        elif key in names:
            noise = torch.randn(leaf.shape, generator=gen, device=leaf.device) * 0.1
            tree[key] = (leaf.float() + noise).to(leaf.dtype)


def _decode_errs(backbone, params, cfg, check, prompt):
    """A prefill of ``prompt`` seeded tokens and TF_DECODE decode steps (a
    cache of prompt + TF_DECODE positions) at ``check``, then a forward
    over the same tokens, all without grad. Returns (prefill s, decode s a
    step, [prefill's last logits, the last decode's], each max |difference
    from the forward's| / max |logit|)."""
    import numpy as np
    import torch

    from repro_torch.models.layers import softcap

    dev = params["embed"].device
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, prompt + TF_DECODE)).astype(np.int32)).to(dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = backbone.prefill(params, {"tokens": toks[:, :prompt]}, check,
                                       max_len=prompt + TF_DECODE)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(TF_DECODE):
            logits, cache = backbone.decode_step(
                params, cache, prompt + i, {"tokens": toks[:, prompt + i:prompt + i + 1]}, check)
        torch.cuda.synchronize()
        decode_s = (time.perf_counter() - t0) / TF_DECODE
        del cache
        full, _ = backbone.forward(params, {"tokens": toks}, check)
        full = softcap(full[0, [prompt - 1, -1]].float(), cfg.final_softcap)
    errs = [float((got.float() - ref).abs().max() / ref.abs().max())
            for got, ref in ((last[0], full[0]), (logits[0], full[1]))]
    return prefill_s, decode_s, errs


def _lm_run(dev, backbone, cfg, prompt, key, label, check=None, norms=TF_NORMS):
    """One LM backbone module (`models.transformer`, `models.zamba2`) at
    ``cfg`` through `training.train_loop.build_train_step`: random weights
    from a generator on the card, TF_STEPS steps at 1 x TF_SEQ tokens of
    the reference smoke's recipe with AdamW at 3e-3, one more under
    torch.profiler; then, with the leaves ``norms`` drawn away from their
    initial values, `_decode_errs` at ``check`` (default ``cfg``) over
    ``prompt`` tokens. Before training, `lower_train_step` predicts the
    step's peak and its modelled time (`_predict_step`); the measured peak
    is held to it within LM_PEAK_TOL (`_hold_prediction`). Returns its
    times under ``key`` (the decode errors among them, for the caller to
    hold to its limit); prints under ``label``."""
    import gc

    import numpy as np
    import torch

    from repro_torch.training.checkpoint import _flatten_with_names
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import TrainConfig, build_train_step, lm_batches

    check = check or cfg
    predicted = _predict_step(dev, cfg, label, TF_SEQ)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # what the earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    params = backbone.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
    n_params = sum(t.numel() for _, t in _flatten_with_names(params))
    opt = init_opt_state(params, AdamWConfig(lr=3e-3))
    step = build_train_step(cfg, TrainConfig(optimizer=AdamWConfig(lr=3e-3)), dev)
    losses, step_s = [], []
    for batch in lm_batches(cfg.vocab, TF_STEPS, batch=1, seq=TF_SEQ):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    train_peak = torch.cuda.max_memory_allocated() - base
    # allocations that found no free block and first released the cache
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    print(f"{label}: one more step under torch.profiler, its kernels by device ms:")
    n_dev, busy, prof_ms = _profile_step(lambda: step(params, opt, batch), top=8)
    del opt, step, metrics
    gc.collect()
    _draw_norms(params, torch.Generator(device=dev).manual_seed(SEED + 1), norms)
    prefill_s, decode_s, errs = _decode_errs(backbone, params, cfg, check, prompt)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del params
    warm = float(np.median(step_s[1:]))
    times = {
        f"{key} layers": cfg.n_layers, f"{key} params": n_params, f"{key} step s": warm,
        f"{key} first step s": step_s[0], f"{key} tokens per s": TF_SEQ / warm,
        f"{key} train peak GB": train_peak / 1e9, f"{key} peak GB": peak / 1e9,
        f"{key} alloc retries": retries,
        f"{key} prefill s": prefill_s, f"{key} decode ms": decode_s * 1e3,
        f"{key} prefill err": errs[0], f"{key} decode err": errs[1],
        f"{key} loss first": losses[0], f"{key} loss last": losses[-1],
        f"{key} device activities a step": n_dev, f"{key} busy share": busy,
        f"{key} profiled step ms": prof_ms}
    times.update(_hold_prediction(key, label, *predicted, train_peak, warm))
    heads = (f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.resolved_head_dim}"
             if cfg.n_heads else "")
    print(f"{label}: published widths (d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {heads}, {cfg.dtype}, remat {cfg.remat}) at {cfg.n_layers} layers "
          f"({n_params} params): {TF_STEPS} train steps at 1 x {TF_SEQ} tokens, a warm step "
          f"{warm:.4f} s (median of {TF_STEPS - 1}), the first {step_s[0]:.3f} s, "
          f"{TF_SEQ / warm:.1f} tokens a second, peak {train_peak / 1e9:.3f} GB "
          f"(max_memory_allocated above the {base / 1e9:.3f} GB held before), {retries} "
          f"allocator retries; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    moe = (f" (capacity factor {check.moe.capacity_factor})" if cfg.moe else "")
    print(f"{label}: prefill of {prompt} tokens {prefill_s:.4f} s, {TF_DECODE} decode steps "
          f"{decode_s * 1e3:.3f} ms each, {', '.join(norms)} drawn away from their initial "
          f"values{moe}: prefill's last logits within {errs[0]:.3g}, the last decode's within "
          f"{errs[1]:.3g} of max |logit| of the forward's; peak {peak / 1e9:.3f} GB")
    if n_dev is None:
        print(f"{label}: torch.profiler saw no device activity: busy share not measured")
    else:
        print(f"{label}: one step under torch.profiler: {n_dev} device activities, the device "
              f"busy {busy:.4f} of the span, {prof_ms:.3f} ms on the host clock")
    return times


def phase_transformer(dev):
    """The transformer backbone (`models.transformer`: attention, the dense
    MLPs and the one-card MoE route) through `_lm_run`, TF_RUNS at their
    published widths, bfloat16, remat "full": TF_STEPS train steps at
    1 x TF_SEQ tokens, a profiled step, prefill of the config's prompt and
    TF_DECODE decode steps against a no-grad forward within
    TF_DECODE_TOL. granite's check runs at capacity factor num_experts /
    top_k (capacity = every token), so the forward drops no token that
    decode keeps; its training keeps the published 1.25. No kernel of the
    port runs. Returns ({kernel: launches}, times)."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer

    times = {}
    build.launches.clear()
    phase_t0 = time.perf_counter()
    for arch, layers, prompt in TF_RUNS:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        check = cfg
        if cfg.moe is not None:
            check = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        key = f"tf {arch}"
        times.update(_lm_run(dev, transformer, cfg, prompt, key, f"transformer {arch}", check))
        if max(times[f"{key} prefill err"], times[f"{key} decode err"]) > TF_DECODE_TOL:
            raise AssertionError(f"transformer {arch}: prefill's last / the last decode "
                                 f"logits differ from the forward's by "
                                 f"{times[f'{key} prefill err']:.3g} / "
                                 f"{times[f'{key} decode err']:.3g} of max |logit| "
                                 f"(limit {TF_DECODE_TOL})")
    counts = dict(build.launches)
    if counts:
        raise AssertionError(f"transformer: launches {counts}, want none (PyTorch operations "
                             f"only)")
    gc.collect()
    torch.cuda.empty_cache()
    times["tf phase s"] = time.perf_counter() - phase_t0
    print(f"transformer: the phase took {times['tf phase s']:.1f} s")
    return counts, times


GRID_ARCH = "granite-moe-3b-a800m"
GRID_SHAPE = (1, 16)  # ("data", "model"): 40 experts padded to 48, 3 a model shard
# `lower_train_step(cfg, ..., rules=)` at 1 x TF_SEQ tokens on the (1, 16)
# grid (fake tensors, the port's own graph) predicts 76.949 GB at 20
# layers, the deepest stack that fits GRID_MEMORY (21: 80.713 GB). With
# the dense layers sharded too (16 shares a layer) its trace takes 130.1 s
# and a step 6.31 s on an H100's host (10 layers: 73.8 s, 3.05 s), so the
# phase runs 5 layers (10 until rwkv6's and zamba2's mesh phase joined the
# script), for the script's time: it traces them on the card and holds
# the measured peak to the prediction, which is no longer checked near
# the card's 80 GB on this path.
GRID_LAYERS = 5
GRID_MEMORY = 80e9
GRID_STEPS = 3
# bfloat16: the grid's first step against the one-card route's on the same
# weights, |relative difference| of the loss and of grad_norm. At one data
# shard the capacity is the one-card route's and the padded experts are
# never routed, so only the psum's order over the 16 model shards differs;
# bf16 rounding then moves later layers' routing near its ties. The bounds
# are ~3x the one-card route's own bf16 error against float32 (0.0027 loss,
# 0.016 grad_norm) and ~10x the grid's distance from it (0.00089, 0.0094),
# both measured on a narrow granite (d_model 256, 4 layers, 40 experts of
# 64, top-8, (1, 16) grid): `python tests/test_torch_moe_grid.py`.
GRID_LOSS_TOL = 1e-2
GRID_GNORM_TOL = 5e-2
KIMI_ARCH = "kimi-k2-1t-a32b"
KIMI_GRID = (2, 8)  # FSDP over "data": t_loc * top_k = 64 * 8 <= 4096, stationary
KIMI_TOKENS = 128  # decode_32k's global batch, one token each
KIMI_CHUNK = 32  # experts a chunk when drawing and quantizing the banks
KIMI_REPS = 5
# bfloat16 y of the grid's stationary path against the one-card route, max
# |difference| / max |y|: up and gate are summed over the two FSDP pieces
# of d_model in bf16. ~3x the one-card route's own bf16 error against
# float32 at narrow widths (<= 0.0094 at d_model 1024; the grid's distance
# <= 0.0097): `python tests/test_torch_moe_grid.py`.
KIMI_Y_TOL = 0.03


def _draw_bank(gen, shape, fan_in, dtype):
    """A (E, a, b) expert bank of N(0, 1 / fan_in) in ``dtype``, drawn on
    ``gen``'s device KIMI_CHUNK experts at a time (the float32 draw of a
    whole kimi bank is 22.5 GB)."""
    import torch

    from repro_torch.models.layers import dense_init

    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for e0 in range(0, shape[0], KIMI_CHUNK):
        n = min(KIMI_CHUNK, shape[0] - e0)
        out[e0:e0 + n] = dense_init(gen, (n,) + tuple(shape[1:]), fan_in=fan_in).to(dtype)
    return out


def _quantize_bank(w):
    """`models.moe_quant.quantize_expert_params` of one bank, KIMI_CHUNK
    experts at a time (row scales: the chunks are exact)."""
    import torch

    from repro_torch.models.moe_quant import quantize_expert_params

    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(tuple(w.shape[:-1]) + (1,), dtype=torch.float32, device=w.device)
    for e0 in range(0, w.shape[0], KIMI_CHUNK):
        part = quantize_expert_params({"moe": {"w_up": w[e0:e0 + KIMI_CHUNK]}})["moe"]["w_up"]
        q[e0:e0 + KIMI_CHUNK] = part["q"]
        s[e0:e0 + KIMI_CHUNK] = part["s"]
    return {"q": q, "s": s}


def _grid_granite(dev, times):
    """granite-moe-3b at full width on a GRID_SHAPE grid of the card,
    GRID_LAYERS deep: the predicted peak held, the first step against the
    one-card route on the same weights, GRID_STEPS steps timed."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Mesh, ShardingRules, make_mesh_context
    from repro_torch.models import transformer
    from repro_torch.training.optimizer import AdamWConfig, global_norm, init_opt_state
    from repro_torch.training.train_loop import (TrainConfig, build_train_step, lm_batches,
                                                 value_and_grad)

    cfg = dataclasses.replace(get_config(GRID_ARCH), n_layers=GRID_LAYERS)
    rules = ShardingRules(mesh=Mesh(GRID_SHAPE, ("data", "model"), dev))
    label = f"moe grid {GRID_ARCH} {GRID_SHAPE}"
    predicted = _predict_step(dev, cfg, label, TF_SEQ, rules)
    if predicted[0].peak_bytes > GRID_MEMORY:
        raise AssertionError(f"{label}: {GRID_LAYERS} layers predicted at "
                             f"{predicted[0].peak_bytes / 1e9:.3f} GB, past {GRID_MEMORY / 1e9} GB")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # what the earlier phases still hold
    params = transformer.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                                     make_mesh_context(rules), device=dev)
    e_pad = params["layers"]["slot0_moe"]["moe"]["w_up"].shape[1]
    if e_pad != 48:
        raise AssertionError(f"{label}: {e_pad} experts, want 40 padded to 48")
    batches = list(lm_batches(cfg.vocab, GRID_STEPS, batch=1, seq=TF_SEQ))
    # the one-card route (no mesh context) on the same weights and batch
    one_loss, grads = value_and_grad(
        lambda p, b: transformer.loss_fn(p, {k: v.to(dev) for k, v in b.items()}, cfg),
        params, batches[0])
    one_loss, one_gnorm = float(one_loss), float(global_norm(grads))
    del grads
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    opt = init_opt_state(params, AdamWConfig(lr=3e-3))
    step = build_train_step(cfg, TrainConfig(optimizer=AdamWConfig(lr=3e-3)), dev, rules)
    losses, gnorms, step_s = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    train_peak = torch.cuda.max_memory_allocated() - base
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    del params, opt, step, metrics
    gc.collect()
    torch.cuda.empty_cache()
    loss_err = abs(losses[0] / one_loss - 1)
    gnorm_err = abs(gnorms[0] / one_gnorm - 1)
    warm = float(np.median(step_s[1:]))
    key = "grid granite"
    times.update({
        f"{key} layers": GRID_LAYERS, f"{key} step s": warm, f"{key} first step s": step_s[0],
        f"{key} tokens per s": TF_SEQ / warm, f"{key} train peak GB": train_peak / 1e9,
        f"{key} alloc retries": retries, f"{key} loss first": losses[0],
        f"{key} loss last": losses[-1], f"{key} one-card loss": one_loss,
        f"{key} one-card grad_norm": one_gnorm, f"{key} grad_norm first": gnorms[0],
        f"{key} loss rel err": loss_err, f"{key} grad_norm rel err": gnorm_err})
    times.update(_hold_prediction(key, label, *predicted, train_peak, warm))
    print(f"{label}: published widths (d_model {cfg.d_model}, 40 experts of "
          f"{cfg.moe.d_expert} padded to {e_pad}, {e_pad // GRID_SHAPE[1]} a model shard, "
          f"top-{cfg.moe.top_k}, capacity factor {cfg.moe.capacity_factor}, {cfg.dtype}) at "
          f"{GRID_LAYERS} layers: {GRID_STEPS} train steps at 1 x {TF_SEQ} tokens, a warm step "
          f"{warm:.4f} s, the first {step_s[0]:.3f} s, {TF_SEQ / warm:.1f} tokens a second, peak "
          f"{train_peak / 1e9:.3f} GB, {retries} allocator retries; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    print(f"{label}: first step loss {losses[0]:.6f} / grad_norm {gnorms[0]:.6f} against the "
          f"one-card route's {one_loss:.6f} / {one_gnorm:.6f} on the same weights: relative "
          f"{loss_err:.3g} (limit {GRID_LOSS_TOL}) / {gnorm_err:.3g} (limit {GRID_GNORM_TOL})")
    if loss_err > GRID_LOSS_TOL or gnorm_err > GRID_GNORM_TOL:
        raise AssertionError(f"{label}: the first step's loss / grad_norm differ from the "
                             f"one-card route's by {loss_err:.3g} / {gnorm_err:.3g} (limits "
                             f"{GRID_LOSS_TOL} / {GRID_GNORM_TOL})")


def _grid_kimi(dev, times):
    """kimi-k2's MoE layer at full width (384 experts of 7168 -> 2048,
    top-8, the shared expert) on a KIMI_GRID grid of the card with FSDP
    over "data": KIMI_TOKENS decode tokens take the stationary path. bf16
    banks, then int8 ones quantized bank by bank (the bf16 bank freed as
    its codes land), each held to the one-card route within KIMI_Y_TOL."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Mesh, ShardingRules, make_mesh_context
    from repro_torch.models import moe
    from repro_torch.models.layers import dense_init, mlp_init

    cfg = get_config(KIMI_ARCH)
    m, d, f = cfg.moe, cfg.d_model, cfg.moe.d_expert
    mc = make_mesh_context(ShardingRules(mesh=Mesh(KIMI_GRID, ("data", "model"), dev)))
    t_loc = KIMI_TOKENS // KIMI_GRID[0]
    if not (mc.fsdp_axes and t_loc * m.top_k <= m.stationary_threshold):
        raise AssertionError(f"kimi grid: {t_loc} tokens a data shard do not take the "
                             "stationary path")
    e_pad = moe.padded_num_experts(m.num_experts, mc)
    dt = cfg.activation_dtype
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    p = {"router": dense_init(gen, (d, e_pad)).to(dt),
         # fan_in = E_pad for the up and gate banks, as moe_init draws them
         "w_up": _draw_bank(gen, (e_pad, d, f), e_pad, dt),
         "w_gate": _draw_bank(gen, (e_pad, d, f), e_pad, dt),
         "w_down": _draw_bank(gen, (e_pad, f, d), f, dt),
         "shared": {k: v.to(dt) for k, v in mlp_init(gen, d, f * m.num_shared_experts,
                                                    cfg.mlp_act).items()}}
    x = torch.randn((KIMI_TOKENS, 1, d), generator=gen, device=dev).to(dt)
    label = f"moe grid {KIMI_ARCH} layer {KIMI_GRID}"
    for banks in ("bf16", "int8"):
        if banks == "int8":
            for name in ("w_up", "w_gate", "w_down"):
                p[name] = _quantize_bank(p[name])
                gc.collect()
            torch.cuda.empty_cache()
        bank_gb = sum(t.numel() * t.element_size() for name in ("w_up", "w_gate", "w_down")
                      for t in (p[name].values() if isinstance(p[name], dict) else [p[name]])) / 1e9
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            y1, a1 = moe.moe_apply(p, x, cfg)
            yg, ag = moe.moe_apply(p, x, cfg, mc)
            err = float((yg.float() - y1.float()).abs().max() / y1.float().abs().max())
            aux_err = abs(float(ag) / float(a1) - 1)
            del y1, yg
            grid_ms, grid_us = _cuda_ms(lambda: moe.moe_apply(p, x, cfg, mc), KIMI_REPS, 1)
            one_ms, _ = _cuda_ms(lambda: moe.moe_apply(p, x, cfg), KIMI_REPS, 1)
            # the host cost of the grid's 16 bodies: one layer under the profiler
            n_dev, busy, _ = _profile_step(lambda: moe.moe_apply(p, x, cfg, mc))
        peak = torch.cuda.max_memory_allocated()
        key = f"grid kimi {banks}"
        times.update({f"{key} y rel err": err, f"{key} aux rel err": aux_err,
                      f"{key} layer ms": grid_ms, f"{key} layer host us": grid_us,
                      f"{key} one-card layer ms": one_ms, f"{key} bank GB": bank_gb,
                      f"{key} peak GB": peak / 1e9, f"{key} device activities": n_dev,
                      f"{key} busy share": busy})
        print(f"{label} {banks} banks ({bank_gb:.3f} GB): {KIMI_TOKENS} tokens, stationary path "
              f"(capacity {moe._capacity(KIMI_TOKENS, m)} a shard's expert, {e_pad // KIMI_GRID[1]} "
              f"experts a model shard, d_model in {KIMI_GRID[0]} FSDP pieces): y within "
              f"{err:.3g} of max |y| of the one-card route's (limit {KIMI_Y_TOL}), aux within "
              f"{aux_err:.3g}; {grid_ms:.3f} ms a layer ({grid_us:.0f} us on the host to enqueue "
              f"it; under torch.profiler {n_dev} device activities, the device busy "
              f"{busy if busy is None else round(busy, 4)} of the span), the one-card route "
              f"{one_ms:.3f} ms; peak {peak / 1e9:.3f} GB")
        if err > KIMI_Y_TOL or aux_err > 1e-6:
            raise AssertionError(f"{label} {banks}: y / aux differ from the one-card route's by "
                                 f"{err:.3g} / {aux_err:.3g} (limits {KIMI_Y_TOL} / 1e-6)")
    del p, x
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe_grid(dev):
    """The model-axis MoE route over a `distributed.sharding.Mesh` whose
    entries are all the card: granite-moe-3b trained at full width on a
    GRID_SHAPE grid through `training.train_loop.build_train_step(...,
    rules=)`, the transformer's sharded step with `models.moe.moe_grid` in
    its MoE layers (`_grid_granite`), and kimi-k2's full-width MoE layer
    through `models.moe.moe_apply` with a mesh context (`moe_grid` on the
    layer's shares, the route the model runs) on the stationary path in
    bf16 and int8 (`_grid_kimi`). The reference's MoE
    reaches no Pallas kernel: no kernel of the port launches. Returns
    ({kernel: launches}, times)."""
    import torch

    from repro_torch.kernels import build

    times = {}
    build.launches.clear()
    phase_t0 = time.perf_counter()
    _grid_granite(dev, times)
    _grid_kimi(dev, times)
    counts = dict(build.launches)
    if counts:
        raise AssertionError(f"moe grid: launches {counts}, want none (PyTorch operations only)")
    torch.cuda.synchronize()
    times["grid phase s"] = time.perf_counter() - phase_t0
    print(f"moe grid: the phase took {times['grid phase s']:.1f} s")
    return counts, times


MESH_ARCHS = ("qwen3-4b", "kimi-k2-1t-a32b")
MESH_NAMES = ("16x16", "2x16x16")
MESH_SHARE_ARCH = "qwen3-4b"
MESH_SHARE_STEPS = 3
MESH_GRID_SHAPE = (2, 2)
# qwen3-4b at full width on a (2, 2) grid of the card, in one process:
# params, gradients and AdamW's moments of 12 layers (1.6 B parameters)
# with every coordinate's activations of a 2 x 4096-token batch
MESH_GRID_LAYERS = 12
MESH_GRID_BATCH = 2
MESH_GRID_SEQ = 4096
MESH_GRID_STEPS = 3
MESH_GRID_PROMPT = 1024
MESH_GRID_DECODE = 16
# bfloat16: the (2, 2) grid's first step and its prefill / decode logits
# against the one-card route's on the same weights, |relative difference|
# of the loss and of grad_norm, max |difference| / max |logit| of the
# worst of a prefill and 16 decodes. Read at this width, depth, batch and
# dtype on an H100 (`python3 chip_smoke.py --mesh-faults`, three weight
# draws): the sound grid <= 1.23e-5 / 1.54e-4 / 0.0215; with the MLP's
# psum over "model" dropped >= 2.27e-4 / 0.216 / 1.12; with flash-
# decoding's sequence shard 1 lost, the decodes >= 0.919. Each bound lies
# between the two (loss 4x over the sound readings and 4.5x under the
# fault's; grad_norm 65x / 22x; logits 3.3x / 13x).
MESH_GRID_LOSS_TOL = 5e-5
MESH_GRID_GNORM_TOL = 1e-2
MESH_GRID_LOGITS_TOL = 0.07

_MESH_WORKER = """
import json, sys, time
import torch
from repro_torch.launch import dryrun
for arch, shape, mesh in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    report, _ = dryrun.run_cell(arch, shape, device=sys.argv[2], mesh=mesh)
    out = report.to_json()
    out["trace_s"] = time.perf_counter() - t0
    print("MESH_CELL " + json.dumps(out), flush=True)
"""


def _mesh_traces_start(dev, cells=None):
    """Start one process a cell (default: every cell of MESH_ARCHS on
    MESH_NAMES), each tracing it (`launch.dryrun.run_cell`, fake tensors
    on the card): [(Popen, cells)]."""
    from repro_torch.configs import SHAPES, get_config

    if cells is None:
        cells = [(a, s, m) for a in MESH_ARCHS for s in SHAPES
                 if s not in get_config(a).skip_shapes for m in MESH_NAMES]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return [(subprocess.Popen([sys.executable, "-c", _MESH_WORKER, json.dumps([cell]), str(dev)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env),
             [cell]) for cell in cells]


def _mesh_traces_join(procs, times):
    """Each cell's report from the workers: a device's peak against the
    card's memory and its compute, memory and (modelled) collective
    terms, printed; raises if a worker failed."""
    reports = []
    for proc, cells in procs:
        out, err = proc.communicate(timeout=900)
        got = [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
               if line.startswith("MESH_CELL ")]
        if proc.returncode != 0 or len(got) != len(cells):
            raise AssertionError(f"mesh traces {cells}: exit {proc.returncode}, "
                                 f"{len(got)} reports\n{err[-4000:]}")
        reports += got
    for r in sorted(reports, key=lambda r: (r["arch"], r["shape"], r["chips"])):
        key = f"mesh {r['arch']} {r['shape']} {r['mesh']}"
        fit = r["peak_bytes_per_device"] <= GRID_MEMORY
        times.update({f"{key} peak GB": r["peak_bytes_per_device"] / 1e9,
                      f"{key} compute s": r["compute_s"], f"{key} memory s": r["memory_s"],
                      f"{key} collective s": r["collective_s"], f"{key} trace s": r["trace_s"]})
        print(f"{key}: a device's share of {r['chips']} (traced on fake tensors in "
              f"{r['trace_s']:.1f} s): peak {r['peak_bytes_per_device'] / 1e9:.3f} GB "
              f"({'fits' if fit else 'does NOT fit'} {GRID_MEMORY / 1e9:.0f} GB), args "
              f"{r['arg_bytes_per_device'] / 1e9:.3f} GB; compute {r['compute_s']:.4f} s, memory "
              f"{r['memory_s']:.4f} s, collective {r['collective_s']:.4f} s (modelled over "
              f"datasheet links; wire {r['wire_bytes']:.4e} B) -> {r['dominant']}-bound")
    return reports


def _mesh_share(dev, times, arch=MESH_SHARE_ARCH, key="mesh share", traced=None):
    """Coordinate (0, 0)'s share of ``arch`` x train_4k on the (16, 16) mesh
    run for real on the card, at full width and depth (a batch of 16 x
    4096 a device; qwen3-4b: 2 of 32 q heads, all 8 kv heads, a vocabulary
    slice of 9 496; rwkv6-7b: 4 of 64 heads, d_ff 896 of 14 336, a slice of
    4 096), random weights, tokens of that slice: the collectives in their
    lone form (true in memory, not in value), the measured peak held to the
    trace's prediction within LM_PEAK_TOL, the warm step printed beside the
    modelled compute and memory terms. Its times go under ``key``. The
    trace runs here first; with ``traced``, a callable that returns the
    cell's report from a tracing process (`_mesh_traces_join`), it is
    waited for after the steps instead."""
    import gc
    import types

    import numpy as np
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import arch_train_config, train_batch_shape
    from repro_torch.launch.mesh import make_production_mesh, make_rules
    from repro_torch.launch.roofline import make_report
    from repro_torch.models.registry import get_backbone
    from repro_torch.training.optimizer import init_opt_state, tree_map
    from repro_torch.training.train_loop import (build_train_step, coordinate_share, fake_like,
                                                 lower_train_step)

    cfg = get_config(arch)
    spec = SHAPES["train_4k"]
    rules = make_rules(make_production_mesh(), fsdp_over_pod=cfg.param_count() > 100e9)
    coord = (0, 0)
    train_cfg = arch_train_config(cfg)
    batch_shape = train_batch_shape(cfg, spec)
    label = f"{key} {arch} train_4k 16x16 {coord}"
    if traced is None:
        t0 = time.perf_counter()
        analysis, _, _ = lower_train_step(cfg, batch_shape, train_cfg, dev, rules, coord)
        trace_s = time.perf_counter() - t0
        report = make_report(cfg, spec, analysis, "train", mesh="16x16", chips=256)
    with FakeTensorMode():
        params = get_backbone(cfg).init_params(torch.Generator().manual_seed(0), cfg, device=dev)
        lparams, lopt, lbatch, specs = coordinate_share(
            params, init_opt_state(params, train_cfg.optimizer), fake_like(batch_shape, dev),
            rules, dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = tree_map(lambda t: (torch.randn(tuple(t.shape), generator=gen, device=dev) * 0.02)
                      .to(t.dtype), lparams)
    opt = tree_map(lambda t: torch.zeros(tuple(t.shape), dtype=t.dtype, device=dev), lopt)
    # tokens of the coordinate's vocabulary slice: its lone lookups are whole
    # rows (a token of another slice would embed as zeros, whose norms'
    # gradients overflow bf16 over the layers)
    b_loc, s_loc = tuple(lbatch["tokens"].shape)
    batch = {k: torch.randint(0, lparams["embed"].shape[0], (b_loc, s_loc), generator=gen,
                              device=dev, dtype=torch.int32) for k in ("tokens", "labels")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = build_train_step(cfg, train_cfg, dev, rules, coord, specs)
    losses, step_s = [], []
    for _ in range(MESH_SHARE_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
    train_peak = torch.cuda.max_memory_allocated() - base
    del params, opt, step, metrics, batch
    gc.collect()
    torch.cuda.empty_cache()
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    warm = float(np.median(step_s[1:]))
    if traced is not None:
        r = traced()
        analysis = types.SimpleNamespace(peak_bytes=r["peak_bytes_per_device"],
                                         flops=r["hlo_flops"], hbm_bytes=r["hlo_bytes"])
        report = types.SimpleNamespace(compute_s=r["compute_s"], memory_s=r["memory_s"],
                                       collective_s=r["collective_s"])
        trace_s = r["trace_s"]
    times.update({f"{key} layers": cfg.n_layers, f"{key} rows": b_loc, f"{key} step s": warm,
                  f"{key} first step s": step_s[0], f"{key} train peak GB": train_peak / 1e9,
                  f"{key} compute s": report.compute_s, f"{key} memory s": report.memory_s,
                  f"{key} collective s": report.collective_s})
    print(f"{label}: {cfg.n_layers} layers, {b_loc} x {s_loc} tokens a device, lone "
          f"collectives: {MESH_SHARE_STEPS} steps, warm step {warm:.4f} s (first "
          f"{step_s[0]:.3f} s) beside the modelled compute {report.compute_s:.4f} s and memory "
          f"{report.memory_s:.4f} s (collective {report.collective_s:.4f} s, not run); peak "
          f"{train_peak / 1e9:.3f} GB")
    times.update(_hold_prediction(key, label, analysis, max(report.compute_s, report.memory_s),
                                  trace_s, train_peak, warm))


def _mesh_tokens(dev, cfg):
    """A MESH_GRID_PROMPT-token prompt and the MESH_GRID_DECODE tokens fed
    after it, (MESH_GRID_BATCH, prompt + decode)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    return torch.randint(0, cfg.vocab, (MESH_GRID_BATCH, MESH_GRID_PROMPT + MESH_GRID_DECODE),
                         generator=gen, device=dev, dtype=torch.int32)


def _mesh_logits(dev, backbone, cfg, params, mc, toks) -> list:
    """The float32 logits of a prefill of ``toks``' prompt and of each
    decode step after it (``backbone`` under ``mc``; one card with None)."""
    import torch

    max_len = MESH_GRID_PROMPT + MESH_GRID_DECODE
    with torch.no_grad():
        lg, cache = backbone.prefill(params, {"tokens": toks[:, :MESH_GRID_PROMPT]}, cfg, mc,
                                     max_len=max_len)
        out = [lg.float()]
        for i in range(MESH_GRID_DECODE):
            n = MESH_GRID_PROMPT + i
            lg, cache = backbone.decode_step(params, cache, torch.tensor(n, device=dev),
                                             {"tokens": toks[:, n:n + 1]}, cfg, mc)
            out.append(lg.float())
    return out


def _logits_err(got: list, want: list) -> float:
    """The worst step's max |difference| / max |logit|."""
    return max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))


def _mesh_grid(dev, times, arch=MESH_SHARE_ARCH):
    """``arch`` (`MESH_GRIDS`: its depth and dtype, the leaves drawn away
    from their initial values, its bounds and its key) at full width,
    trained on a MESH_GRID_SHAPE grid of the card (every coordinate in this
    process, the real collectives): MESH_GRID_STEPS steps at MESH_GRID_BATCH x
    MESH_GRID_SEQ tokens, the first step's loss and grad_norm against the
    one-card step on the same weights; then a prefill and decode steps on
    the grid against the one-card route."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Mesh, ShardingRules, make_mesh_context
    from repro_torch.models.registry import get_backbone
    from repro_torch.training.optimizer import AdamWConfig, global_norm, init_opt_state
    from repro_torch.training.train_loop import (TrainConfig, build_train_step, lm_batches,
                                                 value_and_grad)

    layers, dtype, norms, (loss_tol, gnorm_tol, logits_tol), key = MESH_GRIDS[arch]
    cfg = dataclasses.replace(get_config(arch), n_layers=layers, dtype=dtype)
    backbone = get_backbone(cfg)
    rules = ShardingRules(mesh=Mesh(MESH_GRID_SHAPE, ("data", "model"), dev))
    mc = make_mesh_context(rules)
    label = f"{key} {arch} {MESH_GRID_SHAPE}"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = backbone.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, mc,
                                  device=dev)
    _draw_norms(params, torch.Generator(device=dev).manual_seed(SEED + 1), norms)
    batches = list(lm_batches(cfg.vocab, MESH_GRID_STEPS, batch=MESH_GRID_BATCH,
                              seq=MESH_GRID_SEQ))
    one_loss, grads = value_and_grad(
        lambda p, b: backbone.loss_fn(p, {k: v.to(dev) for k, v in b.items()}, cfg),
        params, batches[0])
    one_loss, one_gnorm = float(one_loss), float(global_norm(grads))
    del grads
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    opt = init_opt_state(params, AdamWConfig(lr=3e-3))
    step = build_train_step(cfg, TrainConfig(optimizer=AdamWConfig(lr=3e-3)), dev, rules)
    first = params
    losses, gnorms, step_s = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    train_peak = torch.cuda.max_memory_allocated() - base
    del params, opt, step, metrics
    gc.collect()
    torch.cuda.empty_cache()
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    loss_err = abs(losses[0] / one_loss - 1)
    gnorm_err = abs(gnorms[0] / one_gnorm - 1)
    # prefill and decode on the first step's weights, the grid against one card
    toks = _mesh_tokens(dev, cfg)
    runs = {name: _mesh_logits(dev, backbone, cfg, first, m, toks)
            for name, m in (("one", None), ("grid", mc))}
    logits_err = _logits_err(runs["grid"], runs["one"])
    del first, runs
    gc.collect()
    torch.cuda.empty_cache()
    warm = float(np.median(step_s[1:]))
    times.update({f"{key} layers": layers, f"{key} step s": warm,
                  f"{key} first step s": step_s[0], f"{key} train peak GB": train_peak / 1e9,
                  f"{key} loss rel err": loss_err, f"{key} grad_norm rel err": gnorm_err,
                  f"{key} logits rel err": logits_err})
    print(f"{label}: published widths at {layers} layers, {dtype}, {MESH_GRID_STEPS} steps at "
          f"{MESH_GRID_BATCH} x {MESH_GRID_SEQ} tokens: warm step {warm:.4f} s (first "
          f"{step_s[0]:.3f} s), peak {train_peak / 1e9:.3f} GB; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; first step loss / grad_norm against the one-card step's "
          f"{one_loss:.6f} / {one_gnorm:.6f}: relative {loss_err:.3g} (limit "
          f"{loss_tol}) / {gnorm_err:.3g} (limit {gnorm_tol}); a "
          f"{MESH_GRID_PROMPT}-token prefill and {MESH_GRID_DECODE} decode steps within "
          f"{logits_err:.3g} of max |logit| of the one-card route (limit {logits_tol})")
    if loss_err > loss_tol or gnorm_err > gnorm_tol or logits_err > logits_tol:
        raise AssertionError(f"{label}: loss / grad_norm / logits differ from the one-card "
                             f"route's by {loss_err:.3g} / {gnorm_err:.3g} / {logits_err:.3g}")


MESH_FAULT_SEEDS = 3
# the planted faults of each grid's study (`_planted`)
MESH_FAULTS = {"qwen3-4b": ("none", "mlp psum", "decode shard"),
               "zamba2-7b": ("none", "gated norm")}


@contextlib.contextmanager
def _planted(fault: str):
    """Plant ``fault`` into the sharded step for the study below: "mlp
    psum" drops `layers.mlp_grid`'s psum over "model" (each model shard
    keeps its half of the down projection's sum); "decode shard" loses
    flash-decoding's sequence shard 1 (its max set to +inf, so its
    exponentials are zero); "gated norm" makes zamba2's gated RMSNorm
    local (each model shard normalises its own slice of d_inner, no psum
    of the squares); "none" plants nothing."""
    from repro_torch.distributed.collectives import axis_index
    from repro_torch.models import attention, layers, mamba2, transformer

    if fault == "mlp psum":
        mlp_grid = transformer.mlp_grid

        def without_psum(ps, specs, xs, act, mc):
            psum = layers.psum
            layers.psum = lambda ys, axes, mc_: list(ys)
            try:
                return mlp_grid(ps, specs, xs, act, mc)
            finally:
                layers.psum = psum

        transformer.mlp_grid = without_psum
        try:
            yield
        finally:
            transformer.mlp_grid = mlp_grid
    elif fault == "decode shard":
        import torch

        pmax = attention.pmax

        def losing_shard(xs, axes, mc):
            return [torch.full_like(m, float("inf")) if axis_index(mc.mesh, c, axes) == 1 else m
                    for m, c in zip(pmax(xs, axes, mc), mc.coords)]

        attention.pmax = losing_shard
        try:
            yield
        finally:
            attention.pmax = pmax
    elif fault == "gated norm":
        norm = mamba2._gated_norm_grid
        mamba2._gated_norm_grid = lambda ys, gn, cfg, mc: [
            mamba2.rms_norm(y, g, cfg.norm_eps) for y, g in zip(ys, gn)]
        try:
            yield
        finally:
            mamba2._gated_norm_grid = norm
    else:
        yield


def mesh_grid_faults(dev, archs=tuple(MESH_FAULTS)):
    """`python3 chip_smoke.py --mesh-faults [ARCH]`: the readings behind
    each grid's bounds (`MESH_GRIDS`) at `_mesh_grid`'s own width, depth,
    batch and dtype, for MESH_FAULT_SEEDS weight draws (seed 0 is
    `_mesh_grid`'s): the first step's loss and grad_norm and the prefill /
    decode logits of the (2, 2) grid against the one-card route, sound and
    with each planted fault of MESH_FAULTS[arch] (`_planted`). One line a
    seed and fault."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Mesh, ShardingRules, make_mesh_context
    from repro_torch.models.registry import get_backbone
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.train_loop import lm_batches, value_and_grad

    mc = make_mesh_context(ShardingRules(mesh=Mesh(MESH_GRID_SHAPE, ("data", "model"), dev)))
    for arch in archs:
        layers, dtype, norms, _, _ = MESH_GRIDS[arch]
        cfg = dataclasses.replace(get_config(arch), n_layers=layers, dtype=dtype)
        backbone = get_backbone(cfg)
        batch = {k: v.to(dev) for k, v in next(lm_batches(cfg.vocab, 1, batch=MESH_GRID_BATCH,
                                                          seq=MESH_GRID_SEQ)).items()}
        toks = _mesh_tokens(dev, cfg)
        for seed in range(MESH_FAULT_SEEDS):
            params = backbone.init_params(
                torch.Generator(device=dev).manual_seed(SEED + 10 * seed), cfg, mc, device=dev)
            _draw_norms(params, torch.Generator(device=dev).manual_seed(SEED + 1 + 10 * seed),
                        norms)

            def first_step(m):
                loss, grads = value_and_grad(lambda p, b: backbone.loss_fn(p, b, cfg, m), params,
                                             batch)
                out = float(loss), float(global_norm(grads))
                del grads
                gc.collect()
                return out

            one_loss, one_gnorm = first_step(None)
            one_logits = _mesh_logits(dev, backbone, cfg, params, None, toks)
            for fault in MESH_FAULTS[arch]:
                with _planted(fault):
                    loss, gnorm = first_step(mc)
                    logits = _mesh_logits(dev, backbone, cfg, params, mc, toks)
                print(f"mesh faults {arch} seed {seed} {fault}: loss "
                      f"{abs(loss / one_loss - 1):.4g} grad_norm {abs(gnorm / one_gnorm - 1):.4g} "
                      f"logits {_logits_err(logits, one_logits):.4g} (prefill "
                      f"{_logits_err(logits[:1], one_logits[:1]):.4g}) of the one-card route's",
                      flush=True)
                del logits
            del params, one_logits
            gc.collect()
            torch.cuda.empty_cache()


def phase_mesh(dev):
    """The transformer's sharded step on the production meshes: (b)
    coordinate (0, 0)'s share of qwen3-4b x train_4k on the (16, 16) mesh
    run for real (`_mesh_share`) and (c) qwen3-4b on a (2, 2) grid of the
    card (`_mesh_grid`), then (a) every cell of MESH_ARCHS traced per
    device on MESH_NAMES, one process a cell (`launch.dryrun.run_cell(...,
    mesh=)`, coordinate 0's share, fake tensors on the card). The reference's LM layers reach no Pallas kernel: no
    kernel of the port launches. Returns ({kernel: launches}, times)."""
    import torch

    from repro_torch.kernels import build

    times = {}
    build.launches.clear()
    phase_t0 = time.perf_counter()
    # the share's and the grid's steps are host-bound: they run before the
    # tracing processes start, so that no other process shares the host
    _mesh_share(dev, times)
    _mesh_grid(dev, times)
    procs = _mesh_traces_start(dev)
    try:
        _mesh_traces_join(procs, times)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    counts = dict(build.launches)
    if counts:
        raise AssertionError(f"mesh: launches {counts}, want none (PyTorch operations only)")
    torch.cuda.synchronize()
    times["mesh phase s"] = time.perf_counter() - phase_t0
    print(f"mesh: the phase took {times['mesh phase s']:.1f} s")
    return counts, times


ZAMBA_ARCH = "zamba2-7b"
# zamba2-7b's 81 mamba layers (78.0 M parameters each) and 2 shared blocks
# (231 M each) with embed and head are 7.0 B parameters, 154 GB at 22 bytes
# a parameter. Cut to the deepest stack that trains within the card's 80 GB
# without the allocator emptying its cache mid-step: on an H100 18 layers
# peaked at 55.4 GB, 22 at 65.4, 23 at 67.8 (groups of 6, 6, 6, 5: shared
# blocks 0, 1, 0, 1), 24 at 70.3 GB with one allocator retry and a step
# 28 % slower than at 23.
ZAMBA_LAYERS = 23
# the vector leaves zero (or one) as drawn: the norm scales, and the SSM's
# A_log, dt_bias, D and conv bias
ZAMBA_LEAVES = ("ln", "ln1", "ln2", "gn", "final_norm", "A_log", "dt_bias", "D", "conv_b")
# The decode check's gate runs in float32 at the published widths: 7
# layers (groups of 6, 1: shared blocks 0, 1), 1.24 B parameters, 5.0 GB,
# no optimizer state. Random weights make the model chaotic: on an H100
# (`--zamba2-drift`, three seeds each) float32's own rounding reaches the
# last decode at 1.1e-4-1.2e-4 of max |logit| at 7 layers, 1.7e-4-2.3e-4
# at 13, 3.2e-4-2.4e-3 at 19, and bfloat16's at 0.26-0.48 at 12 layers and
# 0.51-1.26 at 18-24 (0.0061-0.0207 after `_lm_run`'s training steps), so
# the bfloat16 drift is reported, not gated. The limit sits 8x above the
# float32 readings at 7 layers and 6x below the smallest bfloat16 one.
ZAMBA_F32_LAYERS = 7
ZAMBA_F32_TOL = 1e-3


def phase_zamba2(dev):
    """The Zamba2 hybrid (`models.zamba2` over `models.mamba2`: the chunked
    SSD, the causal conv, the shared attention + MLP blocks re-reading the
    token embedding) at its published widths (d_model 3584, d_ff 14336,
    vocab 32000, 32 heads of 112, SSM state 64, heads of 64, expand 2,
    chunk 128, a shared block every 6). Through `_lm_run`, in bfloat16,
    remat "full" (the mamba body only, as the reference), cut to
    ZAMBA_LAYERS layers: TF_STEPS train steps at 1 x TF_SEQ tokens, a
    profiled step, then with ZAMBA_LEAVES drawn away from their initial
    values a TF_SEQ-token prefill and TF_DECODE decode steps against a
    no-grad forward, the drift reported. Then the same prefill and decode
    in float32 at ZAMBA_F32_LAYERS layers (`_decode_errs`), held to the
    forward within ZAMBA_F32_TOL. No kernel of the port runs. Returns
    ({kernel: launches}, times)."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import zamba2

    build.launches.clear()
    phase_t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(ZAMBA_ARCH), n_layers=ZAMBA_LAYERS)
    key = f"zamba2 {ZAMBA_ARCH}"
    times = _lm_run(dev, zamba2, cfg, TF_SEQ, key, key, norms=ZAMBA_LEAVES)
    if not np.isfinite([times[f"{key} prefill err"], times[f"{key} decode err"]]).all():
        raise AssertionError("zamba2: the bfloat16 decode drift is not finite")
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=ZAMBA_F32_LAYERS, dtype="float32")
    params = zamba2.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg32, device=dev)
    _draw_norms(params, torch.Generator(device=dev).manual_seed(SEED + 1), ZAMBA_LEAVES)
    prefill_s, decode_s, errs = _decode_errs(zamba2, params, cfg32, cfg32, TF_SEQ)
    del params
    times.update({"zamba2 f32 layers": ZAMBA_F32_LAYERS, "zamba2 f32 prefill s": prefill_s,
                  "zamba2 f32 decode ms": decode_s * 1e3, "zamba2 f32 prefill err": errs[0],
                  "zamba2 f32 decode err": errs[1]})
    print(f"zamba2: float32 at {ZAMBA_F32_LAYERS} layers: prefill of {TF_SEQ} tokens "
          f"{prefill_s:.4f} s, {TF_DECODE} decode steps {decode_s * 1e3:.3f} ms each; prefill's "
          f"last logits within {errs[0]:.3g}, the last decode's within {errs[1]:.3g} of max "
          f"|logit| of the forward's (limit {ZAMBA_F32_TOL})")
    if max(errs) > ZAMBA_F32_TOL:
        raise AssertionError(f"zamba2: float32 prefill's last / the last decode logits differ "
                             f"from the forward's by {errs[0]:.3g} / {errs[1]:.3g} of max "
                             f"|logit| (limit {ZAMBA_F32_TOL})")
    counts = dict(build.launches)
    if counts:
        raise AssertionError(f"zamba2: launches {counts}, want none (PyTorch operations only)")
    gc.collect()
    torch.cuda.empty_cache()
    times["zamba2 phase s"] = time.perf_counter() - phase_t0
    print(f"zamba2: the phase took {times['zamba2 phase s']:.1f} s")
    return counts, times


# (dtype, layers) of the drift study, each at three seeds
ZAMBA_DRIFT_RUNS = [("bfloat16", n) for n in (12, 18, 21, 22, 23, 24)]
ZAMBA_DRIFT_RUNS += [("float32", n) for n in (7, 13, 19)]


def zamba2_decode_drift(dev):
    """`python3 chip_smoke.py --zamba2-drift`: the drift of zamba2-7b's
    prefill and decode from its forward (`_decode_errs` over TF_SEQ
    tokens, ZAMBA_LEAVES drawn away from their initial values, no
    training) at its published widths, for each of ZAMBA_DRIFT_RUNS at
    seeds 0, 1 and 2: the readings behind ZAMBA_F32_TOL. One line a run."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import zamba2

    for dtype, layers in ZAMBA_DRIFT_RUNS:
        cfg = dataclasses.replace(get_config(ZAMBA_ARCH), n_layers=layers, dtype=dtype)
        for seed in range(3):
            params = zamba2.init_params(torch.Generator(device=dev).manual_seed(SEED + seed),
                                        cfg, device=dev)
            _draw_norms(params, torch.Generator(device=dev).manual_seed(SEED + 100 + seed),
                        ZAMBA_LEAVES)
            _, _, errs = _decode_errs(zamba2, params, cfg, cfg, TF_SEQ)
            del params
            gc.collect()
            torch.cuda.empty_cache()
            print(f"zamba2 drift {dtype} {layers} layers seed {seed}: prefill {errs[0]:.4g} "
                  f"decode {errs[1]:.4g} of max |logit|", flush=True)


SSM_SHARE_ARCH = "rwkv6-7b"
# zamba2-7b at full width on a (2, 2) grid of the card: groups of 6, 6
# and 1 mamba layers, so both shared blocks run (1.7 B parameters). Not
# 12 layers: two shared applications would give the (n_apps, B, S, KV, D)
# k / v caches a leading axis of the batch's size, 2, and `cache_specs`
# (the reference's rule) finds the batch axis by its size.
ZAMBA_GRID_LAYERS = 13
# zamba2's (2, 2) grid against the one-card route on the same weights,
# as MESH_GRID_*_TOL hold qwen3's: |relative difference| of the first
# step's loss and grad_norm, max |difference| / max |logit| of the worst
# of a prefill and 16 decodes. Read at this width and depth on an H100
# (`python3 chip_smoke.py --mesh-faults zamba2-7b`, two weight draws).
# In bfloat16 the sound grid (loss 2.6e-4-5.6e-4, grad_norm 0.030-0.059,
# logits 0.84-0.93) and the gated norm made local (6.7e-4-1.3e-3,
# 0.018-0.093, 1.16-1.27) overlap: random weights make the model
# chaotic (`ZAMBA_F32_TOL`). So the grid runs in float32, where the sound
# grid reads <= 4.4e-7 / 6.0e-4 / 4.6e-4 and the fault >= 3.1e-5 / 9.5e-3
# / 1.19 (its prefill alone >= 0.95): each bound lies between (loss 9x
# over the sound readings and 7.7x under the fault's, grad_norm 3.3x /
# 4.7x, logits 22x / 119x).
ZAMBA_GRID_DTYPE = "float32"
ZAMBA_GRID_LOSS_TOL = 4e-6
ZAMBA_GRID_GNORM_TOL = 2e-3
ZAMBA_GRID_LOGITS_TOL = 0.01
# each grid of `_mesh_grid`: (layers, dtype, leaves drawn away from their
# initial values, (loss, grad_norm, logits) bounds, its times' key)
MESH_GRIDS = {
    MESH_SHARE_ARCH: (MESH_GRID_LAYERS, "bfloat16", TF_NORMS,
                      (MESH_GRID_LOSS_TOL, MESH_GRID_GNORM_TOL, MESH_GRID_LOGITS_TOL),
                      "mesh grid"),
    ZAMBA_ARCH: (ZAMBA_GRID_LAYERS, ZAMBA_GRID_DTYPE, ZAMBA_LEAVES,
                 (ZAMBA_GRID_LOSS_TOL, ZAMBA_GRID_GNORM_TOL, ZAMBA_GRID_LOGITS_TOL),
                 "ssm mesh grid"),
}
# (a') cells of rwkv6 and zamba2 traced per device, one process a cell;
# the first is the (b') share's prediction
SSM_MESH_CELLS = [(a, s, "16x16") for a in (SSM_SHARE_ARCH, ZAMBA_ARCH)
                  for s in ("train_4k", "decode_32k")]


def phase_ssm_mesh(dev):
    """rwkv6's and zamba2's sharded steps on the production mesh: (b')
    coordinate (0, 0)'s share of rwkv6-7b x train_4k on the (16, 16) mesh
    run for real at its 32 layers (`_mesh_share`), (c') zamba2-7b on a (2,
    2) grid of the card at ZAMBA_GRID_LAYERS layers against the one-card
    route (`_mesh_grid`, in float32: ZAMBA_GRID_*_TOL), and (a')
    SSM_MESH_CELLS traced per device, one process a cell, started first:
    rwkv6's train_4k trace is the share's prediction, which the share
    waits for after its steps.
    No kernel of the port launches (the reference's LM
    layers reach no Pallas kernel; rwkv6 trains through the chunked form).
    Returns ({kernel: launches}, times)."""
    import torch

    from repro_torch.kernels import build

    times = {}
    build.launches.clear()
    phase_t0 = time.perf_counter()
    # the traces start first: they run beside the share's device-bound
    # steps (12 s each) and zamba2's grid, which keeps the phase near 100 s
    procs = _mesh_traces_start(dev, SSM_MESH_CELLS)
    try:
        _mesh_share(dev, times, SSM_SHARE_ARCH, "ssm mesh share",
                    traced=lambda: _mesh_traces_join(procs[:1], times)[0])
        _mesh_grid(dev, times, ZAMBA_ARCH)
        _mesh_traces_join(procs[1:], times)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    counts = dict(build.launches)
    if counts:
        raise AssertionError(f"ssm mesh: launches {counts}, want none (PyTorch operations only)")
    torch.cuda.synchronize()
    times["ssm mesh phase s"] = time.perf_counter() - phase_t0
    print(f"ssm mesh: the phase took {times['ssm mesh phase s']:.1f} s")
    return counts, times


def main() -> int:
    # the allocator grows segments in place instead of caching fixed blocks:
    # the transformer phase's AdamW at full width needs one 9.4 GB float64
    # temporary after the backward has left its blocks behind
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--zamba2-drift"]:
        zamba2_decode_drift(dev)
        return 0
    if sys.argv[1:2] == ["--mesh-faults"]:
        mesh_grid_faults(dev, tuple(sys.argv[2:]) or tuple(MESH_FAULTS))
        return 0
    if sys.argv[1:] == ["--ssm-mesh"]:
        phase_ssm_mesh(dev)
        return 0
    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"built {sorted(reports)} with nvcc in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            print(f"  {name}: {line.strip()}")
    quick = quickstart_twin()  # runs on the host beside the phases until phase_driver

    intgemm_err = phase_intgemm(dev)
    die = phase_calibration(dev)
    _, feat_launches, feat_errs, feat_times, hw_stats = phase_features(dev, die)
    hw_state = die.with_norm_stats(hw_stats)
    tick_err = phase_tick(dev)
    hw_tick_err = phase_tick(dev, hw_state)

    launches = {}
    servers = {}
    runs = [(c, t, None, LIVE_TICKS, REPLAY_TICKS) for c, t in SERVER_RUNS]
    runs += [(c, t, hw_state, HW_LIVE_TICKS, HW_REPLAY_TICKS) for c, t in HW_SERVER_RUNS]
    for classifier, theta, state, n_live, n_replay in runs:
        hw = state is not None
        label = _label(classifier, theta, hw)
        pipe, srv, live, replay, outs, replay_out, counts, live_s = drive_server(
            dev, classifier, theta, state, n_live, n_replay)
        want = n_live + n_replay
        delta = pipe.classifier.is_delta
        if counts != {"tick_fused": want}:
            raise AssertionError(f"server {label}: launches {counts}, want only "
                                 f"tick_fused={want}")
        key = label if hw else classifier
        launches[key] = counts
        err = check_server(dev, pipe, srv, live, replay, outs, replay_out)
        errs = hw_tick_err if hw else tick_err
        errs[classifier] = max(errs[classifier], err)
        extra = f"; mean srv.sparsity {float(srv.sparsity.mean()):.4f}" if delta else ""
        print(f"server {label}: {n_live} step_batch + {n_replay} run_batch ticks at "
              f"{N_STREAMS} streams, launches {counts}, equal to the plain tick loop (scores "
              f"within {err:.3g}); live ticks took {live_s:.3f} s{extra}")
        servers[key] = (srv, live)
    intgemm_launches = sum(phase_pipeline(dev, c) for c in ("integer", "delta-int"))
    casc_err, casc_launches, _, linear, (fit_launches, fit_err, fit_times) = phase_cascade(
        dev, hw_state)
    ingress_times, _ = phase_ingress(dev)
    fleet_times, fleet_launches, entry_err = phase_fleet(dev)
    driver_launches, driver_errs, driver_times = phase_driver(dev, quick)

    def driver(kernel, *runs):
        """The phase's launches of ``kernel``, in ``runs`` (default: all)."""
        return sum(n for key, n in driver_launches.items()
                   if key.endswith(f" {kernel}") and (not runs or key[:-len(kernel) - 1] in runs))
    train_launches, train_times = phase_train(dev)
    dp_launches, dp_times = phase_train_dp(dev)
    _, lm_times = phase_lm(dev)
    _, tf_times = phase_transformer(dev)
    _, grid_times = phase_moe_grid(dev)
    _, mesh_times = phase_mesh(dev)
    _, ssm_mesh_times = phase_ssm_mesh(dev)
    _, zamba_times = phase_zamba2(dev)
    gru_err, gru_launches, gru_times = phase_gru_seq(dev)
    wkv_err, wkv_launches, wkv_times = phase_wkv6(dev)

    times = phase_times(dev, *servers["qat"], hw_state)
    times.update(feat_times)
    times.update(cascade_times(dev, hw_state, linear))
    times.update(fit_times)
    times.update(ingress_times)
    times.update(fleet_times)
    times.update(driver_times)
    times.update(train_times)
    times.update(dp_times)
    times.update(lm_times)
    times.update(tf_times)
    times.update(grid_times)
    times.update(mesh_times)
    times.update(ssm_mesh_times)
    times.update(zamba_times)
    times.update(gru_times)
    times.update(wkv_times)
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

    def feature_entry(name, key, n_launches, err,
                      source="src/repro_torch/kernels/csrc/fex_fused.cu",
                      replaces="src/repro/kernels/fex_fused/kernel.py:82"):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launches, "max_abs_err": err,
            "ms": times[f"{key} ms"], "plain_ms": times[f"{key} plain_ms"],
            "bound_ms": times[f"{key} bound_ms"], "bound_by": times[f"{key} bound_by"],
            "library_ms": None,  # no PyTorch call computes a biquad filterbank or the TDC
        }

    d_key = f"{_label('delta', THETA)} raw"
    k4 = _label("delta", THETA)
    kernels = [
        # the server runs, then the fleet's (resized, sharded, recovered and
        # autoscaled servers with their twins), then the serving command line's
        tick_entry("tick_fused", "qat raw",
                   launches["qat"]["tick_fused"] + launches["integer"]["tick_fused"]
                   + fleet_launches["qat"] + fleet_launches["autoscale"]
                   + driver("tick_fused", "qat", "integer offline"),
                   max(tick_err["qat"], tick_err["integer"], driver_errs["qat"],
                       driver_errs["integer offline"])),
        tick_entry("tick_fused[float]", "float raw",
                   launches["float"]["tick_fused"] + driver("tick_fused", "float grow 2 shards"),
                   max(tick_err["float"], driver_errs["float grow 2 shards"])),
        tick_entry("tick_fused[delta]", d_key, launches["delta"]["tick_fused"],
                   tick_err["delta"]),
        tick_entry("tick_fused[delta-int]", f"{_label('delta-int', THETA)} raw",
                   launches["delta-int"]["tick_fused"]
                   + fleet_launches[_label("delta-int", THETA)], tick_err["delta-int"]),
        # K4 runs inside the ΔGRU tick: one per delta / delta-int tick_fused
        # launch; its time is the phase's (the FV tick less the gate-shut FV
        # tick, both measured in this run), its plain time the sparse step's
        {
            "name": "delta_gather", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/tick_fused.cu",
            "replaces": "src/repro/kernels/tick_fused/kernel.py:76",
            "launches": launches["delta"]["tick_fused"] + launches["delta-int"]["tick_fused"]
            + fleet_launches[_label("delta-int", THETA)]
            + driver("tick_fused", "delta-int cascade pipelined"),
            "max_abs_err": max(tick_err["delta"], tick_err["delta-int"]),
            "ms": times[f"{k4} split classifier_ms"],
            "plain_ms": times[f"{k4} split classifier plain_ms"],
            "bound_ms": times[f"{k4} split classifier bound_ms"],
            "bound_by": times[f"{k4} split classifier bound_by"],
            "library_ms": None,  # no PyTorch call computes the thresholded sparse update
        },
        tick_entry("tick_fused[hardware]", "qat hardware raw",
                   sum(n["tick_fused"] for label, n in launches.items() if "hardware" in label)
                   + driver("tick_fused", "hardware metrics autoscale"),
                   max(*hw_tick_err.values(), driver_errs["hardware metrics autoscale"])),
        # the gated branch (detector, gate, decay) inside the same launch
        tick_entry("tick_fused[cascade]", "cascade qat energy 0.15",
                   casc_launches + driver("tick_fused", "delta-int cascade pipelined"),
                   max(casc_err, driver_errs["delta-int cascade pipelined"])),
        # record_features (software), then predict, then the training corpora,
        # then the serving command line's norm stats and the quickstart
        feature_entry("fex_fused", "fex_fused",
                      feat_launches["software"]["fex_fused"] + fleet_launches["entry fex_fused"]
                      + train_launches["fex_fused"] + dp_launches["fex_fused"]
                      + driver("fex_fused"),
                      max(feat_errs["fex_fused"], driver_errs["quickstart frames"])),
        # the K1 kernel's per-sample entry: the hardware frontends' Rec-BPF scan
        feature_entry("fex_fused[scan]", "scan",
                      sum(n.get("biquad_stream", 0) for n in feat_launches.values())
                      + driver("biquad_stream"), feat_errs["scan"]),
        feature_entry("tdc", "tdc", feat_launches["hardware-pallas"]["tdc"] + driver("tdc"),
                      feat_errs["tdc"], source="src/repro_torch/kernels/csrc/tdc.cu",
                      replaces="src/repro/kernels/tdc/kernel.py:77"),
        {
            "name": "intgemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/intgemm.cu",
            "replaces": "src/repro/kernels/intgemm/kernel.py:46",
            # streaming_step, logits_all_frames and predict, the trained models' replays
            "launches": intgemm_launches + fleet_launches["entry intgemm"]
            + train_launches["intgemm"] + dp_launches["intgemm"] + driver("intgemm"),
            "max_abs_err": max(intgemm_err, entry_err),
            "ms": times["intgemm_ms"], "plain_ms": times["intgemm_plain_ms"],
            "bound_ms": times["intgemm_bound_ms"], "bound_by": times["intgemm_bound_by"],
            "library_ms": times["intgemm_library_ms"],
        },
        {
            "name": "gru_sequence", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gru_seq.cu",
            "replaces": "src/repro/kernels/gru/kernel.py:73",
            "launches": gru_launches, "max_abs_err": gru_err,
            "ms": times["gru_sequence ms"], "plain_ms": times["gru_sequence plain_ms"],
            "bound_ms": times["gru_sequence bound_ms"], "bound_by": times["gru_sequence bound_by"],
            "library_ms": times["gru_sequence library_ms"],  # cuDNN torch.nn.GRU, both layers
        },
        {
            "name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6/kernel.py:62",
            "launches": wkv_launches, "max_abs_err": wkv_err,
            "ms": times["wkv6 ms"], "plain_ms": times["wkv6 plain_ms"],
            "bound_ms": times["wkv6 bound_ms"], "bound_by": times["wkv6 bound_by"],
            "library_ms": None,  # no single PyTorch call computes the WKV6 recurrence
        },
        {
            # no Pallas kernel: the reference's compiled jax.grad takes this chain
            "name": "fma_rows", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fma_rows.cu",
            "replaces": "src/repro/serving/cascade.py:280",
            "launches": fit_launches, "max_abs_err": fit_err,
            "ms": times["fma_rows ms"], "plain_ms": times["fma_rows plain_ms"],
            "bound_ms": times["fma_rows bound_ms"], "bound_by": times["fma_rows bound_by"],
            "library_ms": times["fma_rows library_ms"],  # torch.mv, in its own order
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
