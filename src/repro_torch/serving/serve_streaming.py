"""Streaming KWS serving from the command line, on the card by default.

Counterpart of `examples/serve_streaming.py`: N concurrent audio streams
of the synthetic corpus, each submitting one raw 16 ms hop a tick to a
`StreamingKWSServer`. On the card a tick is one `tick_fused` launch a
shard (the frontend with its per-stream filter and SRO-phase carry, the
classifier, softmax and smoothing); with ``--device cpu`` it is the
plain PyTorch tick. ``--offline`` replays each stream's buffered audio
through `srv.run` instead of live `srv.step` calls; ``--pipelined``
serves through the async ingress (`serving.ingress.PipelinedIngress`,
``--window`` ticks a dispatch); ``--grow`` resizes the server live
halfway through; ``--metrics`` serves through a `MetricsRegistry` and
prints `srv.metrics_snapshot()`; ``--autoscale`` drives an `Autoscaler`
every live tick and prints each decision with its reason.

    python -m repro_torch.serving.serve_streaming [--streams 32]
        [--seconds 1.0] [--frontend software|hardware|hardware-pallas]
        [--classifier float|qat|integer|delta|delta-int] [--theta 0.15]
        [--cascade [--wake-threshold 0.1]] [--offline]
        [--pipelined [--window 4]] [--grow 64] [--metrics] [--autoscale]
        [--devices N | --devices cuda:0 cuda:0 ...] [--device cpu]

The kernels are built (`kernels.build`, at first use) before the clock
starts; the clock is read through this module's ``time`` name.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.fex import FExConfig, FExNormStats, eager_mean_std, fex_frames
from repro_torch.core.gru_delta import DeltaConfig
from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig
from repro_torch.data.gscd import CLASSES, make_dataset
from repro_torch.distributed.sharding import stream_devices
from repro_torch.kernels import build
from repro_torch.kernels.build import resolve_device
from repro_torch.serving.autoscale import AutoscalePolicy, Autoscaler
from repro_torch.serving.cascade import CascadeConfig
from repro_torch.serving.ingress import PipelinedIngress
from repro_torch.serving.serve_loop import StreamingKWSServer

__all__ = ["N_CLIPS", "corpus", "main", "norm_stats", "parse_args", "serve",
           "server_devices", "setup"]

#: Clips of the corpus: `make_dataset(6)`, 6 one-second clips of each class.
N_CLIPS = 6 * len(CLASSES)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--frontend", default="software",
                    choices=["software", "hardware", "hardware-pallas"])
    ap.add_argument("--classifier", default="qat",
                    choices=["float", "qat", "integer", "delta", "delta-int"],
                    help="classifier backend; 'integer' serves the int8 / Q6.8 code "
                         "engine, 'delta' / 'delta-int' the ΔGRU at --theta (θ=0 equals "
                         "qat / integer) with per-stream effective-MAC fractions")
    ap.add_argument("--theta", type=float, default=0.0,
                    help="ΔGRU delta threshold (Q6.8 value units, input and hidden "
                         "deltas of every layer) for --classifier delta / delta-int")
    ap.add_argument("--cascade", action="store_true",
                    help="run the stage-1 energy wake gate inside the tick and print "
                         "the per-stream duty cycle (srv.wake_rate)")
    ap.add_argument("--wake-threshold", type=float, default=0.1,
                    help="energy-detector wake threshold for --cascade (0 = always open)")
    ap.add_argument("--offline", action="store_true",
                    help="replay buffered audio through srv.run instead of live ticks")
    ap.add_argument("--pipelined", action="store_true",
                    help="serve live ticks through PipelinedIngress (double-buffered "
                         "staging, non-blocking dispatch, deferred score fetch)")
    ap.add_argument("--window", type=int, default=4,
                    help="ticks coalesced into one dispatch by --pipelined")
    ap.add_argument("--grow", type=int, default=None,
                    help="live-resize the server to this many slots halfway through "
                         "the run (a multiple of the shard count; live blocking mode)")
    ap.add_argument("--metrics", action="store_true",
                    help="serve through a MetricsRegistry and print "
                         "srv.metrics_snapshot() as JSON at the end")
    ap.add_argument("--autoscale", action="store_true",
                    help="drive an Autoscaler every live tick and print each capacity "
                         "decision with its reason (live blocking mode)")
    ap.add_argument("--devices", nargs="+", default=None,
                    help="shard the stream slots: N (the first N cards, or N CPU shards "
                         "with --device cpu) or a list of devices whose entries may "
                         "repeat (cuda:0 cuda:0 is two shards on one card); default: the "
                         "largest visible card count that divides --streams")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain tick)")
    return ap.parse_args(argv)


def server_devices(args) -> List[torch.device]:
    """The server's shard devices from ``--devices`` and ``--device``."""
    device = resolve_device(args.device)
    devices = args.devices
    if devices is not None and len(devices) == 1 and devices[0].isdigit():
        devices = int(devices[0])
    if devices is None:
        if device.type != "cuda":
            return stream_devices([device])
        devices = torch.cuda.device_count()
        while args.streams % devices:
            devices -= 1  # the largest visible count the slot axis divides
    if isinstance(devices, int) and device.type != "cuda":
        devices = [device] * devices
    return stream_devices(devices)


def _check_streams(streams: int) -> None:
    if not 1 <= streams <= N_CLIPS:
        raise ValueError(f"--streams {streams}: the corpus has {N_CLIPS} clips, so 1 to "
                         f"{N_CLIPS} streams")


def corpus(streams: int) -> np.ndarray:
    """The first ``streams`` clips of `make_dataset(6, seed=0)`, (streams, 16000)."""
    _check_streams(streams)
    return np.asarray(make_dataset(6, seed=0)["audio"][:streams], np.float32)


def norm_stats(audio: np.ndarray, device) -> FExNormStats:
    """FV_Log mean and population std (+ 1e-3) of the clips' software
    frames, per channel (K1 on the card). FV_Log is the closed-form log
    (`quant.log_compress_eager`), and mu / sigma follow the eager
    ``mean(0)`` / ``std(0)`` (`fex.eager_mean_std`), as the reference's
    set-up evaluates them (`examples/serve_streaming.py:135-136`)."""
    fcfg = FExConfig()
    frames = fex_frames(torch.as_tensor(audio, device=device), fcfg)
    fv_raw = quant.quantize_unsigned(frames, fcfg.quant_bits, fcfg.quant_full_scale)
    fv_log = quant.log_compress_eager(fv_raw, fcfg.quant_bits, fcfg.log_bits)
    mu, std = eager_mean_std(fv_log.reshape(-1, fcfg.num_channels))
    return FExNormStats(mu=mu, sigma=std + 1e-3)


def setup(args, params=None, stats=None, frontend_state=None):
    """(pipeline, float params, server with every stream open, audio).

    ``params`` (float, or codes for the integer backends), ``stats`` and
    ``frontend_state`` replace what the driver would make: random params
    from ``torch.Generator().manual_seed(0)``, the corpus' norm stats and
    the frontend's state (no drawn mismatch; the hardware frontends'
    beta / alpha calibrated on the first shard's device)."""
    audio = corpus(args.streams)
    devices = server_devices(args)
    dev = devices[0]
    if stats is None:
        stats = norm_stats(audio, dev)
    delta = None
    if args.classifier in ("delta", "delta-int"):
        delta = DeltaConfig(theta_x=args.theta, theta_h=args.theta)
    cascade = CascadeConfig(wake_threshold=args.wake_threshold) if args.cascade else None
    pipe = KWSPipeline(
        KWSPipelineConfig(frontend=args.frontend, classifier=args.classifier,
                          delta=delta, cascade=cascade),
        norm_stats=stats,
    )
    if frontend_state is None:
        frontend_state = pipe.init_frontend_state(mismatch=False, device=dev)
    pipe = pipe.with_state(frontend_state.with_norm_stats(stats))
    if params is None:
        params = pipe.init_params(torch.Generator().manual_seed(0), device=dev)
    srv = StreamingKWSServer(pipe, params, max_streams=args.streams, devices=devices,
                             metrics=args.metrics)
    for sid in range(args.streams):
        srv.open_stream(sid)
    return pipe, params, srv, audio


def _build_kernels(args) -> Optional[float]:
    """Build and load every kernel library where the server runs on the
    card; the seconds it took (None on the CPU)."""
    if server_devices(args)[0].type != "cuda":
        return None
    t0 = time.perf_counter()
    for name in sorted(build.build_all()):
        build.library(name)
    secs = time.perf_counter() - t0
    print(f"kernels {sorted(build.SOURCES)} built and loaded in {secs:.2f} s")
    return secs


def _per_stream_line(values: Dict[int, float]) -> str:
    shown = {s: round(v, 3) for s, v in list(values.items())[:8]}
    vals = list(values.values())
    return (f"mean {np.mean(vals):.3f} (min {np.min(vals):.3f} / max {np.max(vals):.3f}); "
            f"first streams: {shown}")


def serve(args, params=None, stats=None, frontend_state=None) -> Dict[str, Any]:
    """Run the driver; returns what it produced: ``top`` (stream id -> its
    final top class), ``top_counts``, ``server``, the autoscaler's
    ``decisions`` in order, ``wall`` seconds, ``ms_per_tick``,
    ``n_frames``, ``pipeline``, ``params`` and ``build_s``."""
    _check_streams(args.streams)
    build_s = _build_kernels(args)
    pipe, params, srv, audio = setup(args, params, stats, frontend_state)
    auto = None
    if args.autoscale:
        auto = Autoscaler(srv, AutoscalePolicy(
            min_streams=srv.n_devices, max_streams=4 * args.streams,
            hysteresis_ticks=2, cooldown_ticks=4))
    hop = pipe.chunk_samples  # 256 samples = 16 ms at 16 kHz
    n_frames = min(audio.shape[1] // hop, int(args.seconds / 16e-3))
    if args.offline:
        mode = "offline srv.run replay"
    elif args.pipelined:
        mode = f"live async ingress (depth 2, window {args.window})"
    else:
        mode = "live fused ticks"
    print(f"serving {args.streams} streams x {n_frames} raw-audio hops ({hop} samples / "
          f"16 ms each) via frontend {args.frontend!r}, classifier {args.classifier!r} "
          f"on {srv.n_devices} device(s) [{mode}]...")
    decisions: List[dict] = []
    detections: Dict[int, int] = {}
    t0 = time.time()
    if args.offline:
        out = srv.run({sid: audio[sid, : n_frames * hop] for sid in range(args.streams)})
        for sid, r in out.items():
            detections[sid] = r["top"]
    elif args.pipelined:
        ing = PipelinedIngress(srv, dim=hop, window=args.window)
        slots = {sid: srv.active[sid] for sid in range(args.streams)}
        for t in range(n_frames):
            slab, mask = ing.stage()
            for sid, slot in slots.items():
                slab[slot] = audio[sid, t * hop:(t + 1) * hop]
                mask[slot] = True
            ing.commit(meta=t)
        # the final tick's top row is the last handle's last window row
        tops = ing.drain()[-1].top
        tops = tops[-1] if tops.ndim == 2 else tops
        for sid, slot in slots.items():
            detections[sid] = int(tops[slot])
    else:
        for t in range(n_frames):
            if args.grow is not None and t == n_frames // 2:
                srv.resize(args.grow)
                print(f"  [tick {t}] resized live to {srv.max_streams} slots "
                      f"({len(srv.active)} open streams moved bitwise)")
            chunk = {sid: audio[sid, t * hop:(t + 1) * hop] for sid in range(args.streams)}
            t_tick = time.perf_counter()
            out = srv.step(chunk)
            for sid, r in out.items():
                detections[sid] = r["top"]
            if auto is not None:
                before = auto.last_decision
                auto.observe(time.perf_counter() - t_tick)
                d = auto.last_decision
                if d is not None and d is not before:
                    decisions.append(d)
                    print(f"  [tick {t}] autoscaler {d['action']}: {d['from']} -> "
                          f"{d['to']} slots (reason: {d['reason']})")
    for dev in dict.fromkeys(srv.shard_devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    wall = time.time() - t0
    per_frame = wall / n_frames * 1e3
    rt_streams = args.streams * (16.0 / per_frame)
    where = (torch.cuda.get_device_name(srv.device) if srv.device.type == "cuda"
             else "CPU")
    print(f"wall {wall:.2f}s -> {per_frame:.2f} ms per batched audio-in tick (FEx + GRU); "
          f"real-time capacity at this batch ~{rt_streams:.0f} streams/device ({where})")
    top_counts: Dict[str, int] = {}
    for sid, cls in detections.items():
        top_counts[CLASSES[cls]] = top_counts.get(CLASSES[cls], 0) + 1
    print("final per-stream top classes (untrained weights -> arbitrary):", top_counts)
    if args.classifier in ("delta", "delta-int"):
        frac = srv.sparsity
        line = _per_stream_line({s: float(frac[srv.active[s]]) for s in sorted(detections)})
        print(f"ΔGRU θ={args.theta:g}: effective-MAC fraction {line}")
    if args.cascade:
        wr = srv.wake_rate
        line = _per_stream_line({s: float(wr[srv.active[s]]) for s in sorted(detections)})
        print(f"cascade thr={args.wake_threshold:g}: classifier duty cycle (wake rate) {line}")
    if args.metrics:
        print("metrics snapshot:")
        print(json.dumps(srv.metrics_snapshot(), indent=2))
    print("the IC serves 1 stream at 23 uW; the card serves thousands of streams with one "
          "weights-resident tick_fused launch a 16 ms tick")
    return {"top": detections, "top_counts": top_counts, "server": srv,
            "decisions": decisions, "wall": wall, "ms_per_tick": per_frame,
            "n_frames": n_frames, "pipeline": pipe, "params": params, "build_s": build_s}


def main(argv=None) -> int:
    serve(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
