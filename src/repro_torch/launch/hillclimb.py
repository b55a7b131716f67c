"""The dry run's iterations on three cells, each a hypothesis -> change ->
trace. Counterpart of `repro.launch.hillclimb`: the same cells and
overrides, traced on fake tensors by `launch.dryrun.run_cell` (the
roofline from the port's own graph), one JSON per iteration. As the
reference's `run_cell` always builds the production mesh, every cell
traces a device's share of the (16, 16) mesh (coordinate 0 of 256): its
peak against one card's 80 GB, its collective term modelled over the
datasheet links (`launch.roofline`).

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


def _run(arch, shape, steps, out, device):
    for name, overrides, note in steps:
        report, _ = run_cell(arch, shape, note=note, overrides=overrides, device=device,
                             mesh="16x16")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"{name}.json"), "w") as f:
            json.dump(report.to_json(), f, indent=2)


def cell_a(out, device=None):
    """musicgen-medium x train_4k on the (16, 16) mesh: 24 heads on a
    16-way model axis, the (S, S) scores of a 4096-token sequence
    materialised in every layer."""
    print("#### CELL A: musicgen-medium x train_4k @ 16x16")
    _run("musicgen-medium", "train_4k", [
        ("A0_baseline", {"attn_head_pad": None},
         "baseline: the published 24 heads, which do not split 16 ways: every model "
         "coordinate runs all 24 (vanilla attention, remat=full)"),
        ("A1_headpad", {"attn_head_pad": 32},
         "hypothesis: zero-padding heads 24->32 splits them 2 a model coordinate -> a "
         "device's attention work and scores down ~12x, compute and memory terms down"),
        ("A2_flash", {"attn_head_pad": 32, "attn_chunk": 1024},
         "hypothesis: chunked attention keeps one (S, 1024) block of a device's scores at a "
         "time -> its peak down by the scores' share"),
        ("A3_dots", {"attn_head_pad": 32, "attn_chunk": 1024, "remat": "dots"},
         "hypothesis: saving the products' outputs removes the forward's recompute of them "
         "-> compute term down ~25 %, a device's peak up by the saved activations"),
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
    ], out, device)


def cell_c(out, device=None):
    """rwkv6-7b x train_4k on the (16, 16) mesh: 4 of the 64 heads a
    device, the chunked WKV6's (q, q, h) ratio tensors."""
    print("#### CELL C: rwkv6-7b x train_4k @ 16x16")
    cfg = get_config("rwkv6-7b")
    _run("rwkv6-7b", "train_4k", [
        ("C0_baseline", {}, "baseline (remat=full, wkv chunk 128, 4 heads a device)"),
        ("C1_dots", {"remat": "dots"},
         "hypothesis: remat=dots keeps the products' outputs -> compute term -25 %, a "
         "device's peak up"),
        ("C2_chunk256", {"remat": "dots", "ssm": dataclasses.replace(cfg.ssm, chunk=256)},
         "hypothesis: wkv chunk 128->256 halves the inter-chunk steps, doubles the intra-"
         "chunk (q, q) work -> memory term up with the ratio tensors"),
        ("C3_chunk64", {"remat": "dots", "ssm": dataclasses.replace(cfg.ssm, chunk=64)},
         "counter-hypothesis: chunk 64 halves the (q, q, h) ratio tensors -> memory term "
         "down if they dominate"),
    ], out, device)


def kimi_fit(out, device=None):
    """kimi-k2 x train_4k: a device's peak on the (16, 16) mesh against one
    card's 80 GB."""
    print("#### kimi-k2 train_4k memory fit @ 16x16")
    _run("kimi-k2-1t-a32b", "train_4k", [
        ("K0_baseline", {}, "baseline: int8 moments, vanilla attention, a device's share of "
         "256 against one card's 80 GB"),
        ("K1_flash", {"attn_chunk": 1024},
         "hypothesis: chunked attention removes a device's (4096, 4096) float32 score "
         "transients -> its peak down by them (the saved layer inputs and the gathered expert "
         "banks stay)"),
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
