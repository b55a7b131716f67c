"""The dry run's parts beside its FLOPs (tests/test_torch_dryrun*.py):

- `model_flops_for` equal to the reference's for every arch x shape, and
  `CellReport.to_json()` with the reference's keys;
- `train_batch_shape` / `prefill_batch_shape` / `serve_batch_shape` giving
  the reference's shapes and dtypes for every arch x shape;
- `GraphAnalysis`: its peak of live bytes against a hand-computed peak on
  a small graph, and the reduced train steps' peak, FLOPs and bytes on
  fake tensors equal to those of the same steps run for real under the
  same mode on the CPU; the HBM bytes of views, in-place and expanded
  operands; the hardware model's peaks by dtype;
- one full-width cell (kimi-k2 x decode_32k on the CPU) traced without
  allocating, the command line's line and JSON (one card, and a device's
  share of the two-pod mesh), the hill-climb's cell B on the (16, 16)
  mesh, and an import of the dry run that sets no environment variable.
"""

import dataclasses
import json
import os
import pathlib
import resource
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import roofline as jroofline
from repro.serving import serve_loop as jsl
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun, hillclimb, roofline
from repro_torch.launch.roofline import HARDWARE, CellReport, GraphAnalysis
from repro_torch.models.registry import get_backbone
from repro_torch.serving.serve_loop import prefill_batch_shape, serve_batch_shape
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_loop import TrainConfig, build_train_step, lower_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in tconfigs.list_archs() for s in tconfigs.SHAPES]


def _reference_train_batch_shape():
    """The reference dry run's `train_batch_shape`; importing its module
    sets XLA_FLAGS, restored here at once."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import train_batch_shape
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return train_batch_shape


def _same_shapes(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype), k
        assert got[k].device.type == "meta"


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_and_batch_shapes_are_the_references(arch, shape):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jspec, tspec = jconfigs.SHAPES[shape], tconfigs.SHAPES[shape]
    assert roofline.model_flops_for(tcfg, tspec) == jroofline.model_flops_for(jcfg, jspec)
    _same_shapes(dryrun.train_batch_shape(tcfg, tspec),
                 _reference_train_batch_shape()(jcfg, jspec))
    _same_shapes(prefill_batch_shape(tcfg, tspec), jsl.prefill_batch_shape(jcfg, jspec))
    _same_shapes(serve_batch_shape(tcfg, tspec), jsl.serve_batch_shape(jcfg, jspec))


def test_cell_report_has_the_references_keys():
    fields = dict(arch="a", shape="s", mesh="m", chips=1, kind="train", compute_s=1.0,
                  memory_s=2.0, collective_s=0.0, dominant="memory", hlo_flops=1e9,
                  hlo_bytes=1e9, wire_bytes=0.0, model_flops=5e8, useful_ratio=0.5,
                  peak_bytes_per_device=1.0, arg_bytes_per_device=1.0)
    want = jroofline.CellReport(**fields).to_json()
    got = CellReport(**fields).to_json()
    assert sorted(got) == sorted(want)
    assert got["step_time_s"] == want["step_time_s"] == 2.0
    # the useful compute at the peak for the config's dtype
    assert got["roofline_fraction"] == pytest.approx(5e8 / HARDWARE.bf16_flops / 2.0)
    f32 = CellReport(**fields, dtype="float32")
    assert f32.roofline_fraction == pytest.approx(5e8 / HARDWARE.f32_flops / 2.0)


def test_the_hardware_model_is_one_h100():
    assert HARDWARE.peak_flops(torch.bfloat16) == HARDWARE.bf16_flops == 989.4e12
    assert HARDWARE.peak_flops("float32") == HARDWARE.f32_flops == 66.9e12
    assert HARDWARE.hbm_bw == 3.35e12 and HARDWARE.memory_bytes == 80e9
    assert roofline.device_memory_bytes("cpu") == 80e9


def test_make_report_on_one_card():
    cfg = tconfigs.get_config("qwen3-4b").reduced()
    spec = tconfigs.ShapeSpec("t", "train", 64, 2)
    analysis, _, _ = lower_train_step(cfg, dryrun.train_batch_shape(cfg, spec), device="cpu")
    r = roofline.make_report(cfg, spec, analysis, "train")
    assert (r.mesh, r.chips, r.collective_s, r.wire_bytes) == ("1xH100", 1, 0.0, 0.0)
    assert r.compute_s == pytest.approx(analysis.flops_by_dtype["bfloat16"] / 989.4e12)
    assert r.memory_s == pytest.approx(analysis.hbm_bytes / 3.35e12)
    assert r.dominant == "memory" and r.step_time_s == r.memory_s
    assert r.useful_ratio == pytest.approx(roofline.model_flops_for(cfg, spec) / analysis.flops)
    assert r.peak_bytes_per_device == analysis.peak_bytes
    assert r.arg_bytes_per_device == analysis.held_bytes
    assert roofline.fits(r, "cpu")


def test_peak_of_a_small_graph_by_hand():
    a = torch.ones(1000)  # 4000 bytes, held
    g = GraphAnalysis()
    assert g.hold([a, a]) == 4000  # one storage counts once
    with g:
        b = a * 2  # 8000 live
        c = b + 1  # 12000 live: the peak so far
        del b  # 8000
        s = c.sum()  # 8004
        v = c.view(10, 100)  # a view: no allocation, no bytes
        c.add_(1)  # in place: no allocation, reads and writes c
        e = a[None].expand(3, 1000) * 1.0  # reads a's 4000 bytes once, 12000 out: 20004 live
        del e  # 8004
        f = torch.zeros(2500)  # 10000: 18004 live
    assert g.peak_bytes == 20004 and g.held_bytes == 4000
    assert g.live_bytes == 18004 and f.shape == (2500,)
    del c, v
    assert g.live_bytes == 14004
    want_bytes = (4000 + 4000) + (4000 + 4000) + (4000 + 4) + (4000 + 4000) + (4000 + 12000) + 10000
    assert g.hbm_bytes == want_bytes
    assert g.flops == 0 and s.item() == 3000.0


def test_flops_by_dtype():
    g = GraphAnalysis()
    with g:
        torch.ones(4, 8, dtype=torch.bfloat16) @ torch.ones(8, 16, dtype=torch.bfloat16)
        torch.bmm(torch.ones(3, 4, 8), torch.ones(3, 8, 2))
        torch.einsum("ij,jk->ik", torch.ones(5, 6), torch.ones(6, 7))
    assert g.flops_by_dtype == {"bfloat16": 2.0 * 4 * 8 * 16,
                                "float32": 2.0 * 3 * 4 * 8 * 2 + 2.0 * 5 * 6 * 7}
    assert g.compute_s() == pytest.approx(1024 / 989.4e12 + (384 + 420) / 66.9e12)


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-3b-a800m", "rwkv6-7b", "zamba2-7b"])
def test_the_peak_on_fake_tensors_is_the_peak_of_the_step_run_for_real(arch):
    """The reduced step traced on fake tensors and run for real under the
    same mode on the CPU: the same peak of live bytes, FLOPs and bytes."""
    cfg = tconfigs.get_config(arch).reduced()
    shape = dryrun.train_batch_shape(cfg, tconfigs.ShapeSpec("t", "train", 64, 2))
    fake, _, _ = lower_train_step(cfg, shape, device="cpu")
    params = get_backbone(cfg).init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = init_opt_state(params, TrainConfig().optimizer)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in shape.items()}
    real = GraphAnalysis()
    real.hold((params, opt, batch))
    with real:
        _, _, metrics = build_train_step(cfg, TrainConfig(), "cpu")(params, opt, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert (fake.peak_bytes, fake.held_bytes, fake.flops, fake.hbm_bytes) == (
        real.peak_bytes, real.held_bytes, real.flops, real.hbm_bytes)


def test_a_full_width_cell_allocates_nothing():
    """kimi-k2 x decode_32k (1.03 T parameters, a 32 768-token cache of 128
    streams) traced on the CPU: hundreds of GB predicted, the process's
    resident set grows by far less than one GB."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    report, analysis = dryrun.run_cell("kimi-k2-1t-a32b", "decode_32k", device="cpu")
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 - before
    assert report.peak_bytes_per_device > 1e12 and not roofline.fits(report, "cpu")
    assert grown < 1e9
    assert report.kind == "decode" and report.hlo_flops > 0


def test_the_command_line_writes_one_json_a_cell(tmp_path, capsys):
    assert dryrun.main(["--arch", "rwkv6-7b", "--shape", "long_500k", "--device", "cpu",
                        "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "rwkv6-7b x long_500k" in out and "fits" in out and "dry-run OK: 1 cells" in out
    report = json.loads((tmp_path / "rwkv6-7b__long_500k__1xH100.json").read_text())
    assert report["mesh"] == "1xH100" and report["kind"] == "decode"
    with pytest.raises(SystemExit, match="skips"):
        skipped = next((a, s) for a, s in CELLS if s in tconfigs.get_config(a).skip_shapes)
        dryrun.run_cell(*skipped, device="cpu")


def test_long_prefill_chunks_attention(monkeypatch):
    seen = []
    monkeypatch.setattr(dryrun, "lower_prefill",
                        lambda cfg, spec, device: seen.append(cfg.attn_chunk) or (_Stub(), None))
    monkeypatch.setattr(dryrun, "make_report", lambda *a, **k: _report())
    dryrun.run_cell("qwen3-4b", "prefill_32k", device="cpu")
    assert seen == [dryrun.LONG_PREFILL_CHUNK]


class _Stub:
    flops_by_dtype = {}


def _report():
    return CellReport("a", "s", "1xH100", 1, "prefill", 1.0, 1.0, 0.0, "memory", 1.0, 1.0, 0.0,
                      1.0, 1.0, 1.0, 1.0)


def _reduced_configs(monkeypatch, d_model=64, d_expert=32):
    """`get_config` of the dry run and the hill climb giving reduced configs
    (of the given width and expert width)."""
    def reduced(name):
        cfg = tconfigs.get_config(name).reduced()
        moe = cfg.moe and dataclasses.replace(cfg.moe, d_expert=d_expert)
        return dataclasses.replace(cfg, d_model=d_model, moe=moe)

    monkeypatch.setattr(dryrun, "get_config", reduced)
    monkeypatch.setattr(hillclimb, "get_config", reduced)


def test_hillclimb_cell_b_moves_the_tokens_not_the_banks(tmp_path, capsys, monkeypatch):
    """Cell B (kimi-k2 x decode_32k on the (16, 16) mesh, two layers, d_model
    1024, experts 512 wide) writes B0_gather.json and B1_stationary.json,
    each a device's share of 256; the weights-stationary step's collective
    term is below the gather's, whose every layer moves the banks."""
    _reduced_configs(monkeypatch, d_model=1024, d_expert=512)
    assert hillclimb.main(["--cell", "B", "--out", str(tmp_path), "--device", "cpu"]) == 0
    assert "CELL B" in capsys.readouterr().out
    b0, b1 = (json.loads((tmp_path / f"{n}.json").read_text())
              for n in ("B0_gather", "B1_stationary"))
    assert (b0["mesh"], b0["chips"], b1["mesh"], b1["chips"]) == ("16x16", 256, "16x16", 256)
    assert 0 < b1["collective_s"] < b0["collective_s"]
    assert b1["wire_bytes"] < b0["wire_bytes"]


@pytest.mark.parametrize("cell,names,d_model", [
    ("A", ("A0_baseline", "A1_headpad", "A2_flash", "A3_dots"), 1024),
    ("C", ("C0_baseline", "C1_dots", "C2_chunk256", "C3_chunk64"), 256),
    ("kimi_fit", ("K0_baseline", "K1_flash"), 1024),
])
def test_hillclimb_cells_trace_a_device_of_the_pod(cell, names, d_model, tmp_path, monkeypatch):
    """Cells A, C and the kimi fit trace a device's share of the (16, 16)
    mesh as cell B does (reduced, d_model 1024; rwkv6's 256: one head of
    16 a model coordinate): every JSON's mesh is 16x16 and its chips 256.
    Cell A's padding of musicgen's heads splits them over the model axis,
    so its device runs fewer attention FLOPs."""
    _reduced_configs(monkeypatch, d_model=d_model, d_expert=512)
    assert hillclimb.main(["--cell", cell, "--out", str(tmp_path), "--device", "cpu"]) == 0
    reports = {n: json.loads((tmp_path / f"{n}.json").read_text()) for n in names}
    for r in reports.values():
        assert (r["mesh"], r["chips"]) == ("16x16", 256)
        assert r["collective_s"] > 0 and r["peak_bytes_per_device"] > 0
    if cell == "A":
        assert reports["A1_headpad"]["hlo_flops"] < reports["A0_baseline"]["hlo_flops"]


def test_the_command_line_traces_a_device_of_two_pods(tmp_path, capsys, monkeypatch):
    """``--multi-pod``: coordinate (0, 0, 0)'s share of the (2, 16, 16)
    mesh, 512 chips, a nonzero collective term over the network (a
    16-way "model" group spans two nodes of 8); the file carries the
    mesh's name; the rwkv6 and zamba2 backbones trace a device's share
    too (at d_model 1024: 64 heads of 16, 128 SSD heads of 16, whole
    heads on each of 16 model coordinates)."""
    _reduced_configs(monkeypatch)
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k", "--multi-pod",
                        "--device", "cpu", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "2x16x16, coordinate (0, 0, 0)'s share of 512" in out and "collective" in out
    report = json.loads((tmp_path / "qwen3-4b__decode_32k__2x16x16.json").read_text())
    assert report["chips"] == 512 and report["mesh"] == "2x16x16"
    assert report["collective_s"] > 0 and report["wire_bytes"] > 0
    assert report["useful_ratio"] == pytest.approx(
        report["model_flops"] / (report["hlo_flops"] * 512))
    _reduced_configs(monkeypatch, d_model=1024)
    for arch in ("rwkv6-7b", "zamba2-7b"):
        report, _ = dryrun.run_cell(arch, "decode_32k", device="cpu", mesh="2x16x16")
        assert report.chips == 512 and report.collective_s > 0


def test_importing_the_dry_run_sets_no_environment_variable():
    code = ("import os, sys\n"
            f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
            "before = dict(os.environ)\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.hillclimb\n"
            "assert dict(os.environ) == before\n"
            "print('same')\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0 and "same" in out.stdout, out.stderr


def test_arch_train_config_takes_int8_moments_past_100b():
    assert dryrun.arch_train_config(tconfigs.get_config("kimi-k2-1t-a32b")).optimizer.state_dtype \
        == "int8"
    assert dryrun.arch_train_config(tconfigs.get_config("qwen3-4b")).optimizer.state_dtype \
        == "float32"


def test_workspaces_count_while_their_operation_runs():
    """logsumexp's exp(x - max) and max are live while it runs: the peak
    is the input, the output and those two; the CPU's softmax backward
    allocates nothing of its own (the card's forms grad * output)."""
    x = torch.ones(1000, 10)
    g = GraphAnalysis()
    g.hold(x)
    with g:
        out = torch.logsumexp(x, dim=-1)
    assert g.live_bytes == 40000 + 4000
    assert g.peak_bytes == 40000 + 4000 + (40000 + 4000)
    y = torch.softmax(torch.ones(100, 10, requires_grad=True), -1)
    grad = torch.ones_like(y)
    g = GraphAnalysis()
    with g:
        y.backward(grad)  # reads grad and y, writes the input's gradient
    assert g.peak_bytes == g.live_bytes == 4000 and g.hbm_bytes == 3 * 4000
    assert out.shape == (1000,)


def test_a_quantized_decode_holds_int8_expert_banks():
    """``serve_quant``: the expert banks held as int8 codes and float32
    row scales (`models.moe_quant`), the products unchanged."""
    from repro_torch.serving.serve_loop import lower_decode_step

    cfg = tconfigs.get_config("kimi-k2-1t-a32b").reduced()
    spec = tconfigs.ShapeSpec("d", "decode", 64, 2)
    plain, _, _ = lower_decode_step(cfg, spec, "cpu")
    quant, qparams, _ = lower_decode_step(dataclasses.replace(cfg, serve_quant=True), spec, "cpu")
    bank = qparams["layers"]["slot0_moe"]["moe"]["w_up"]
    assert bank["q"].dtype == torch.int8 and bank["s"].dtype == torch.float32
    assert quant.flops == plain.flops and quant.held_bytes < plain.held_bytes
