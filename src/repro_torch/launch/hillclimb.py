"""The dry run's iterations on three cells, each a hypothesis -> change ->
trace. Counterpart of `repro.launch.hillclimb`: the same cells and
overrides, traced on fake tensors by `launch.dryrun.run_cell` (the
roofline from the port's own graph), one JSON per iteration. Cells A and
C and the kimi fit run on one card; cell B (kimi-k2 x decode_32k,
weights-stationary expert parallelism) needs a model axis, so it traces
a device's share of the (16, 16) mesh, its collective term modelled over
the datasheet links (`launch.roofline`).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell A|B|C|kimi_fit|all]
        [--out results/hillclimb] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import run_cell

__all__ = ["cell_a", "cell_b", "cell_c", "kimi_fit", "main"]


def _run(arch, shape, steps, out, device, mesh=None):
    for name, overrides, note in steps:
        report, _ = run_cell(arch, shape, note=note, overrides=overrides, device=device,
                             mesh=mesh)
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"{name}.json"), "w") as f:
            json.dump(report.to_json(), f, indent=2)


def cell_a(out, device=None):
    """musicgen-medium x train_4k: 24 heads, the (S, S) scores of a
    4096-token sequence materialised in every layer."""
    print("#### CELL A: musicgen-medium x train_4k")
    _run("musicgen-medium", "train_4k", [
        ("A0_baseline", {}, "baseline (24 heads, vanilla attention, remat=full)"),
        ("A1_headpad", {"attn_head_pad": 32},
         "hypothesis: zero-padding heads 24->32 adds a third to the attention work on one "
         "card (no tensor-parallel axis to balance) -> compute and memory terms up"),
        ("A2_flash", {"attn_head_pad": 32, "attn_chunk": 1024},
         "hypothesis: chunked attention keeps one (S, 1024) block of scores at a time -> "
         "peak down by the scores' share"),
        ("A3_dots", {"attn_head_pad": 32, "attn_chunk": 1024, "remat": "dots"},
         "hypothesis: saving the products' outputs removes the forward's recompute of them "
         "-> compute term down ~25 %, peak up by the saved activations"),
    ], out, device)


def cell_b(out, device=None):
    """kimi-k2 x decode_32k on the (16, 16) mesh: the FSDP all-gather of
    every layer's expert banks against weights-stationary expert
    parallelism, which moves the tokens instead."""
    print("#### CELL B: kimi-k2-1t-a32b x decode_32k @ 16x16")
    cfg = get_config("kimi-k2-1t-a32b")
    _run("kimi-k2-1t-a32b", "decode_32k", [
        ("B0_gather", {"moe": dataclasses.replace(cfg.moe, stationary_threshold=0)},
         "baseline: each layer's expert banks all-gathered over the FSDP axis a token step"),
        ("B1_stationary", {},
         "hypothesis: weights-stationary EP (the tokens all-gathered, the banks never move) "
         "-> collective term down by the banks' wire bytes"),
    ], out, device, mesh="16x16")


def cell_c(out, device=None):
    """rwkv6-7b x train_4k: the chunked WKV6's (q, q, h) ratio tensors."""
    print("#### CELL C: rwkv6-7b x train_4k")
    cfg = get_config("rwkv6-7b")
    _run("rwkv6-7b", "train_4k", [
        ("C0_baseline", {}, "baseline (remat=full, wkv chunk 128)"),
        ("C1_dots", {"remat": "dots"},
         "hypothesis: remat=dots keeps the products' outputs -> compute term -25 %, peak up"),
        ("C2_chunk256", {"remat": "dots", "ssm": dataclasses.replace(cfg.ssm, chunk=256)},
         "hypothesis: wkv chunk 128->256 halves the inter-chunk steps, doubles the intra-"
         "chunk (q, q) work -> memory term up with the ratio tensors"),
        ("C3_chunk64", {"remat": "dots", "ssm": dataclasses.replace(cfg.ssm, chunk=64)},
         "counter-hypothesis: chunk 64 halves the (q, q, h) ratio tensors -> memory term "
         "down if they dominate"),
    ], out, device)


def kimi_fit(out, device=None):
    """kimi-k2 x train_4k against one card's memory."""
    print("#### kimi-k2 train_4k memory fit")
    _run("kimi-k2-1t-a32b", "train_4k", [
        ("K0_baseline", {}, "baseline: int8 moments, vanilla attention"),
        ("K1_flash", {"attn_chunk": 1024},
         "hypothesis: chunked attention removes the (4096, 4096) float32 score transients -> "
         "peak down by them (the 1 T parameters stay far past one card)"),
    ], out, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=["A", "B", "C", "kimi_fit", "all"], default="all")
    ap.add_argument("--out", default="results/hillclimb", help="directory for the JSON reports")
    ap.add_argument("--device", default=None,
                    help="where the fake tensors live (default: the card; 'cpu' here)")
    args = ap.parse_args(argv)
    for name, fn in (("A", cell_a), ("B", cell_b), ("C", cell_c), ("kimi_fit", kimi_fit)):
        if args.cell in (name, "all"):
            fn(args.out, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
