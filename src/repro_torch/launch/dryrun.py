"""The LM dry run: every (architecture x input shape) cell's step traced
on fake tensors, with its roofline on one H100, or per device on the
production meshes.

Counterpart of `repro.launch.dryrun`. The reference lowers and compiles
each cell for a 256- or 512-chip TPU mesh and reads XLA's memory and cost
analyses; the port traces the same step (`training.train_loop.
lower_train_step`, `serving.serve_loop.lower_prefill` /
`lower_decode_step`) under `torch._subclasses.fake_tensor.FakeTensorMode`
and `launch.roofline.GraphAnalysis`, which count the FLOPs, the HBM bytes
and the peak of live bytes of the port's own graph on one device without
allocating any of it. Nothing is set in the environment on import.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_out --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 16x16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --device cpu

On a mesh (``--mesh 16x16``, the single pod, or ``--multi-pod``, the
(2, 16, 16) one) a cell is traced as the reference compiles it, per
device: `launch.mesh.make_production_mesh` and `make_rules` (FSDP over
"pod" too past 100 B parameters), and the step of grid coordinate 0's
share alone (`lower_train_step(..., rules, coord)` and the serving
lowerings: each backbone's sharded step, its collectives in their lone
form), so the FLOPs, HBM bytes, peak and argument bytes are one
device's, and the collectives' wire bytes give a modelled collective
term over the datasheet links of `launch.roofline.HARDWARE`.

Per cell it prints one line: the predicted peak against the card's memory
(fits or not: the caching allocator's cache, fragmentation and retries are
not modelled), the graph's FLOPs and HBM bytes, the compute and memory
terms, the dominant term, ``useful_ratio`` and ``roofline_fraction``; with
``--out`` it writes the cell's `CellReport` JSON. The fake tensors live on
the card by default and on the CPU with ``--device cpu`` (the counts are
the same; the card rounds each allocation up to 512 bytes).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.kernels.build import resolve_device
from repro_torch.launch.mesh import make_production_mesh, make_rules, mesh_device_count
from repro_torch.launch.roofline import device_memory_bytes, fits, make_report
from repro_torch.serving.serve_loop import lower_decode_step, lower_prefill
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainConfig, lower_train_step

__all__ = ["train_batch_shape", "arch_train_config", "run_cell", "main"]

#: The meshes a cell is traced on: one card, the pod, two pods.
MESHES = ("1xH100", "16x16", "2x16x16")

#: Prefill at or past this many tokens chunks attention's keys and values
#: (`attn_chunk` = `LONG_PREFILL_CHUNK`), as the reference's dry run does.
LONG_PREFILL = 16384
LONG_PREFILL_CHUNK = 2048


def train_batch_shape(arch_cfg, shape_spec):
    """A train step's batch as ``meta`` tensors: tokens (or frame
    embeddings) and labels, (global batch, seq_len)."""
    b, s = shape_spec.global_batch, shape_spec.seq_len
    labels = torch.empty((b, s), dtype=torch.int32, device="meta")
    if arch_cfg.frontend == "embedding":
        return {"embeddings": torch.empty((b, s, arch_cfg.d_model),
                                          dtype=arch_cfg.activation_dtype, device="meta"),
                "labels": labels}
    return {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta"), "labels": labels}


def arch_train_config(arch_cfg) -> TrainConfig:
    """int8 optimizer moments past 100 B parameters, float32 below."""
    state_dtype = "int8" if arch_cfg.param_count() > 100e9 else "float32"
    return TrainConfig(optimizer=AdamWConfig(state_dtype=state_dtype))


def run_cell(arch: str, shape: str, note: str = "", overrides: dict | None = None,
             device=None, mesh=None):
    """Trace one cell; returns (CellReport, GraphAnalysis) and prints its
    line. Prefill at `LONG_PREFILL` tokens or more chunks attention
    (`LONG_PREFILL_CHUNK`); ``overrides`` replaces `ArchConfig` fields;
    ``device`` (default: the card) is where the fake tensors live. On one
    card by default; ``mesh`` "16x16" or "2x16x16" traces coordinate 0's
    share of that production mesh's step. Raises SystemExit for a
    shape the config skips."""
    device = resolve_device(device)
    name = mesh or "1xH100"
    if name not in MESHES:
        raise SystemExit(f"dryrun: mesh {mesh!r}: one of {', '.join(MESHES[1:])}")
    arch_cfg = get_config(arch)
    shape_spec = SHAPES[shape]
    if shape_spec.kind == "prefill" and shape_spec.seq_len >= LONG_PREFILL:
        arch_cfg = dataclasses.replace(arch_cfg, attn_chunk=LONG_PREFILL_CHUNK)
    if overrides:
        arch_cfg = dataclasses.replace(arch_cfg, **overrides)
    if shape in arch_cfg.skip_shapes:
        raise SystemExit(f"{arch} skips {shape}")
    rules = coord = None
    chips = 1
    if name != "1xH100":
        prod = make_production_mesh(multi_pod=name == "2x16x16")
        rules = make_rules(prod, fsdp_over_pod=arch_cfg.param_count() > 100e9)
        coord = (0,) * len(prod.axis_names)
        chips = mesh_device_count(multi_pod=name == "2x16x16")
    share = () if coord is None else (rules, coord)
    t0 = time.perf_counter()
    if shape_spec.kind == "train":
        analysis, _, _ = lower_train_step(arch_cfg, train_batch_shape(arch_cfg, shape_spec),
                                          arch_train_config(arch_cfg), device, *share)
    elif shape_spec.kind == "prefill":
        analysis, _ = lower_prefill(arch_cfg, shape_spec, device, *share)
    else:
        analysis, _, _ = lower_decode_step(arch_cfg, shape_spec, device, *share)
    t_trace = time.perf_counter() - t0
    report = make_report(arch_cfg, shape_spec, analysis, shape_spec.kind, note=note,
                         mesh=name, chips=chips)
    mem = device_memory_bytes(device)
    where = "1xH100" if coord is None else f"{name}, coordinate {coord}'s share of {chips}"
    wire = "" if coord is None else (
        f", collective {report.collective_s * 1e3:.2f} ms (modelled, datasheet links; wire "
        f"{report.wire_bytes:.4e} B: "
        + ", ".join(f"{k} {v:.3e}" for k, v in sorted(report.collective_breakdown.items()))
        + ")")
    print(f"[{arch} x {shape} @ {where}, fake tensors on {device}] traced {t_trace:.1f} s | "
          f"peak {report.peak_bytes_per_device / 1e9:.3f} GB "
          f"{'fits' if fits(report, device) else 'does NOT fit'} {mem / 1e9:.1f} GB "
          f"(allocator cache and retries not modelled), args "
          f"{report.arg_bytes_per_device / 1e9:.3f} GB | graph flops {report.hlo_flops:.4e} "
          f"({', '.join(f'{k} {v:.3e}' for k, v in sorted(analysis.flops_by_dtype.items()))}), "
          f"bytes {report.hlo_bytes:.4e} | roofline: compute {report.compute_s * 1e3:.2f} ms, "
          f"memory {report.memory_s * 1e3:.2f} ms{wire} -> {report.dominant}-bound, step "
          f"{report.step_time_s * 1e3:.2f} ms; useful-ratio {report.useful_ratio:.2f}, "
          f"roofline fraction {report.roofline_fraction:.2%}")
    return report, analysis


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Trace LM cells on fake tensors: FLOPs, bytes, "
                                             "peak memory and the roofline on one H100, or "
                                             "per device on a production mesh.")
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default=None, choices=("16x16",),
                    help="trace a device's share of the one-pod mesh (default: one card)")
    ap.add_argument("--multi-pod", action="store_const", const="2x16x16", dest="mesh",
                    help="trace a device's share of the (2, 16, 16) two-pod mesh")
    ap.add_argument("--out", default=None, help="directory for JSON reports")
    ap.add_argument("--note", default="")
    ap.add_argument("--device", default=None,
                    help="where the fake tensors live (default: the card; 'cpu' here)")
    args = ap.parse_args(argv)
    name = args.mesh or "1xH100"

    if args.all:
        cells = [(arch, shape) for arch in list_archs() for shape in SHAPES
                 if shape not in get_config(arch).skip_shapes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures = []
    for arch, shape in cells:
        try:
            report, _ = run_cell(arch, shape, args.note, device=args.device, mesh=name)
        except SystemExit:
            raise
        except Exception as e:  # noqa: BLE001 - record and go on to the next cell
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
            continue
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"{arch}__{shape}__{name}.json"), "w") as f:
                json.dump(report.to_json(), f, indent=2)
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print(f"dry-run OK: {len(cells)} cells on {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
