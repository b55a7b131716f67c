"""Roofline analysis of the port's own graph on one H100.

Counterpart of `repro.launch.roofline`. The reference parses the HLO text
of a compiled XLA program; the port has no HLO, so `GraphAnalysis` counts
what its eager step dispatches: a `TorchDispatchMode`, used together with
`torch._subclasses.fake_tensor.FakeTensorMode` so that the step runs on
tensors that carry a shape, a dtype and a device but allocate nothing
(it counts real tensors alike). Per aten operation it records

  FLOPs      - `torch.utils.flop_counter`'s formulas: 2 M N K for every
               matrix product (mm, addmm, bmm, baddbmm, and what einsum and
               matmul lower to), no elementwise work, the reference's MXU
               convention; binned by the product's dtype.
  HBM bytes  - eager PyTorch fuses nothing, so every operation reads its
               inputs and writes its outputs once: their bytes (a view's
               the bytes it spans, at most its storage's). An operation
               whose outputs alias its inputs and writes nothing (a view,
               detach) counts 0.
  peak bytes - every storage an operation creates is live from then until
               it is freed (a weak-reference finaliser on the storage);
               tensors that exist before (parameters, optimizer state, the
               batch) are added with `GraphAnalysis.hold`. On the card each
               allocation is rounded up to the caching allocator's 512
               bytes. Two operations allocate a temporary the mode cannot
               see, and it counts while they run (`_WORKSPACES`): the
               card's softmax backward forms grad * output first, and
               logsumexp exp(x - max) and its max. Other kernels' own
               workspaces (a reduction's or a scan's staging buffer, a few
               hundred KB at the reduced sizes) are not modelled, nor is
               what the allocator reserves beyond its blocks (its cache,
               fragmentation, a retry): the peak is the one
               `torch.cuda.max_memory_allocated` reports.

  wire bytes - every collective of the sharded step
               (`distributed.collectives`, forward and backward) reports
               its kind and its wire bytes a device by the reference's
               formulas (`roofline.py:428-440`), and which link its group
               spans (`group_link`): `wire_bytes`, `collective_breakdown`
               by kind, `link_bytes` by link.

`HARDWARE` holds one H100 SXM5 80GB HBM3 at 700 W: bf16 tensor cores
989.4 TFLOP/s dense, float32 CUDA cores 66.9 TFLOP/s (TF32 stays off in
the port), HBM 3.35 TB/s, 80 GB, and the links of a modelled cluster of
such cards, from datasheets: NVLink 4 at 450 GB/s a direction a card
within a node of 8 (NVIDIA H100 SXM5 datasheet: 900 GB/s
bidirectional), one 400 Gb/s NDR InfiniBand port a card across nodes,
50 GB/s (ConnectX-7). The placement is stated, not measured: a mesh's
coordinates are numbered row-major ("model" innermost) and cards 8k to
8k + 7 share node k. `make_report` turns an analysis into the
reference's `CellReport`: compute s = sum over dtypes of FLOPs / that
dtype's peak, memory s = bytes / HBM rate, collective s = each link's
wire bytes over its rate, summed. These are modelled figures.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

__all__ = [
    "HARDWARE", "Hardware", "GraphAnalysis", "CellReport", "model_flops_for", "make_report",
    "device_memory_bytes", "fits", "group_link",
]


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit: NVIDIA's dense
    peaks (no sparsity) for the port's product dtypes, HBM rate and size;
    and the datasheet links of a cluster of them (module docstring)."""

    name: str = "H100 SXM5 80GB HBM3, 700 W"
    bf16_flops: float = 989.4e12  # tensor cores, dense (fp16 the same)
    f32_flops: float = 66.9e12  # CUDA cores: TF32 is off in the port
    hbm_bw: float = 3.35e12  # B/s
    memory_bytes: float = 80e9
    nvlink_bw: float = 450e9  # B/s a direction a card (NVLink 4, H100 SXM5 datasheet)
    network_bw: float = 50e9  # B/s a card across nodes: one 400 Gb/s NDR port
    cards_per_node: int = 8

    def link_bw(self, link: str) -> float:
        """The rate of ``link`` ("nvlink" within a node, "network" across)."""
        return self.nvlink_bw if link == "nvlink" else self.network_bw

    def peak_flops(self, dtype) -> float:
        """The dense peak for products in ``dtype`` (a torch.dtype or its
        name, as `GraphAnalysis.flops_by_dtype` keys them): the tensor
        cores' for bf16 and fp16, the CUDA cores' float32 rate otherwise."""
        name = str(dtype).replace("torch.", "")
        return self.bf16_flops if name in ("bfloat16", "float16") else self.f32_flops


HARDWARE = Hardware()


def group_link(mesh, group, hw: Hardware = HARDWARE) -> str:
    """The slowest link a collective's group of grid coordinates spans:
    "nvlink" when every member's card (its row-major number on the mesh,
    "model" innermost) is in one node of ``hw.cards_per_node``, else
    "network"."""
    sizes = list(mesh.shape.values())
    nodes = set()
    for c in group:
        flat = 0
        for i, n in zip(c, sizes):
            flat = flat * n + i
        nodes.add(flat // hw.cards_per_node)
    return "nvlink" if len(nodes) == 1 else "network"


#: The CUDA caching allocator's granule: every block is a multiple of it.
ALLOC_GRANULE = 512


def device_memory_bytes(device) -> float:
    """The memory a step may hold on ``device``: the card's own total where
    there is one, `HARDWARE.memory_bytes` otherwise (a dry run on the CPU
    stands in for the card)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(device).total_memory)
    return HARDWARE.memory_bytes


def _softmax_backward_workspace(ins, outs) -> int:
    """The card's `_softmax_backward_data` (ATen's SoftMax.cu) computes
    ``grad * output`` into a temporary before its epilogue; the CPU's
    kernel fuses it."""
    return _span_bytes(ins[0]) if ins[0].device.type == "cuda" else 0


def _logsumexp_workspace(ins, outs) -> int:
    """ATen's logsumexp takes the max (kept dims) and ``exp(x - max)``
    before it sums, on every device."""
    return _span_bytes(ins[0]) + sum(_span_bytes(t) for t in outs)


#: Operations whose implementation allocates below the dispatch mode: the
#: bytes of their temporaries, live while the operation runs.
_WORKSPACES = {
    torch.ops.aten._softmax_backward_data: _softmax_backward_workspace,
    torch.ops.aten.logsumexp: _logsumexp_workspace,
}


def _alloc_bytes(nbytes: int, device: torch.device) -> int:
    """An allocation's bytes: on the card, a whole number of the caching
    allocator's blocks."""
    if device.type == "cuda":
        return -(-nbytes // ALLOC_GRANULE) * ALLOC_GRANULE
    return nbytes


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _span_bytes(t: torch.Tensor) -> int:
    """The bytes an operation reads or writes of ``t``: its elements, at
    most its storage (an expanded view reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class GraphAnalysis(TorchDispatchMode):
    """FLOPs by dtype, HBM bytes and the peak of live bytes of everything
    dispatched while the mode is on (see the module docstring). Enter it
    inside a `FakeTensorMode` to count a step without running it."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = {}
        self.hbm_bytes = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.held_bytes = 0
        self.wire_bytes = 0.0
        self.collective_breakdown: Dict[str, float] = {}
        self.link_bytes: Dict[str, float] = {}
        self._storages = WeakIdKeyDictionary()

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    def compute_s(self, hw: Hardware = HARDWARE) -> float:
        """Each dtype's FLOPs at that dtype's peak, summed."""
        return sum(f / hw.peak_flops(dt) for dt, f in self.flops_by_dtype.items())

    def memory_s(self, hw: Hardware = HARDWARE) -> float:
        return self.hbm_bytes / hw.hbm_bw

    def collective_s(self, hw: Hardware = HARDWARE) -> float:
        """Each link's wire bytes at its rate, summed (modelled)."""
        return sum(b / hw.link_bw(link) for link, b in self.link_bytes.items())

    def note_collective(self, kind: str, wire: float, mesh, axes, group) -> None:
        """One collective's wire bytes a device, reported by
        `distributed.collectives` while the mode is on."""
        self.wire_bytes += wire
        self.collective_breakdown[kind] = self.collective_breakdown.get(kind, 0.0) + wire
        link = group_link(mesh, group)
        self.link_bytes[link] = self.link_bytes.get(link, 0.0) + wire


    def hold(self, tree) -> int:
        """Count the tensors of ``tree`` (made before the analysis: the
        step's arguments) as live from now until they are freed; returns
        their bytes, which also go to `held_bytes`."""
        before = self.live_bytes
        for t in _tensors(tree):
            self._track(t)
        self.held_bytes += self.live_bytes - before
        return self.live_bytes - before

    def _free(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        nbytes = _alloc_bytes(st.nbytes(), t.device)
        self._storages[st] = nbytes
        weakref.finalize(st, self._free, nbytes).atexit = False
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        packet = func.overloadpacket
        if packet in flop_registry and ins:
            key = str(ins[0].dtype).replace("torch.", "")
            self.flops_by_dtype[key] = (self.flops_by_dtype.get(key, 0.0)
                                        + float(flop_registry[packet](*args, **kwargs,
                                                                      out_val=out)))
        in_storages = {id(t.untyped_storage()) for t in ins}
        fresh = [t for t in outs if id(t.untyped_storage()) not in in_storages]
        if fresh or func._schema.is_mutable:
            self.hbm_bytes += sum(_span_bytes(t) for t in ins) + sum(_span_bytes(t) for t in outs)
        for t in fresh:
            self._track(t)
        workspace = _WORKSPACES.get(packet)
        if workspace is not None and ins:
            temp = _alloc_bytes(workspace(ins, outs), ins[0].device)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes + temp)
        return out


@dataclasses.dataclass
class CellReport:
    """One (arch, shape) cell, a device's share, with the reference's
    fields: ``hlo_flops`` / ``hlo_bytes`` are the port's graph FLOPs and
    HBM bytes (the names kept for the reports' readers); ``mesh`` "1xH100"
    (one card, no collective) or a production mesh's name, "16x16" or
    "2x16x16", and its chips."""

    arch: str
    shape: str
    mesh: str
    chips: int
    kind: str  # train | prefill | decode
    # per-device roofline terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    # raw
    hlo_flops: float  # per device
    hlo_bytes: float
    wire_bytes: float
    model_flops: float  # analytic useful flops, global
    useful_ratio: float  # model_flops / (hlo_flops * chips)
    peak_bytes_per_device: float
    arg_bytes_per_device: float
    note: str = ""
    collective_breakdown: Dict[str, float] = dataclasses.field(default_factory=dict)
    dtype: str = dataclasses.field(default="bfloat16", repr=False)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time at the peak for the config's dtype / the
        modelled step time."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        useful_t = self.model_flops / self.chips / HARDWARE.peak_flops(self.dtype)
        return min(useful_t / t, 1.0)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        del d["dtype"]
        d["step_time_s"] = self.step_time_s
        d["roofline_fraction"] = self.roofline_fraction
        return d


def model_flops_for(arch_cfg, shape_spec) -> float:
    """Analytic 'useful' FLOPs per step, global across chips.

    train: 6*N*D (fwd+bwd), MoE counts active params only;
    prefill: 2*N*D; decode: 2*N*B per token (one step).
    Attention score/value flops are excluded (same convention as 6ND).
    """
    n = arch_cfg.active_param_count()
    if shape_spec.kind == "train":
        tokens = shape_spec.global_batch * shape_spec.seq_len
        return 6.0 * n * tokens
    if shape_spec.kind == "prefill":
        tokens = shape_spec.global_batch * shape_spec.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape_spec.global_batch  # decode: one token/stream


def make_report(arch_cfg, shape_spec, analysis: GraphAnalysis, kind: str, note: str = "",
                hw: Hardware = HARDWARE, mesh: str = "1xH100", chips: int = 1) -> CellReport:
    """The cell's `CellReport` from its step's analysis: on one card, or
    (``mesh``, ``chips``) from one device's share of the mesh's step."""
    mf = model_flops_for(arch_cfg, shape_spec)
    terms = {"compute": analysis.compute_s(hw), "memory": analysis.memory_s(hw),
             "collective": analysis.collective_s(hw)}
    return CellReport(
        arch=arch_cfg.name, shape=shape_spec.name, mesh=mesh, chips=chips, kind=kind,
        compute_s=terms["compute"], memory_s=terms["memory"], collective_s=terms["collective"],
        dominant=max(terms, key=terms.get),
        hlo_flops=analysis.flops, hlo_bytes=analysis.hbm_bytes, wire_bytes=analysis.wire_bytes,
        model_flops=mf,
        useful_ratio=mf / (analysis.flops * chips) if analysis.flops else 0.0,
        peak_bytes_per_device=float(analysis.peak_bytes),
        arg_bytes_per_device=float(analysis.held_bytes), note=note,
        collective_breakdown=dict(analysis.collective_breakdown),
        dtype=str(arch_cfg.activation_dtype).replace("torch.", ""))


def fits(report: CellReport, device="cuda") -> bool:
    """The predicted peak is at most the card's memory (`device_memory_bytes`)."""
    return report.peak_bytes_per_device <= device_memory_bytes(device)

