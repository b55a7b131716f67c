"""The dry run's serving cells held to the reference's: the graph FLOPs of
the port's prefill and decode step (`serving.serve_loop.lower_prefill` /
`lower_decode_step`, traced on fake tensors) against the reference's
`analyze_hlo` of its compiled ones on a (1, 1) mesh with Auto axes (R2),
at the reduced configs, B = 2, S = 64. Exact, but for rwkv6's prefill:
the reference contracts the chunked WKV6's intra-chunk scores
einsum(r, k, exp(el_t - il_j)) and the bonus einsum(r, u, k) as dots,
which the port takes as elementwise products and sums
(`models.rwkv6._intra_scores`); the shortfall is exactly their
2 b nc q q h p + 2 b nc q h p FLOPs a layer (measured 1.47 %)."""

import pytest
import torch

from repro import configs as jconfigs
from repro.launch.roofline import analyze_hlo
from repro.serving import serve_loop as jsl
from repro_torch import configs as tconfigs
from repro_torch.serving.serve_loop import lower_decode_step, lower_prefill
from test_torch_dryrun import ARCHS, B, S, reference_rules


def _wkv_intra_flops(cfg) -> float:
    """The intra-chunk scores' and the bonus' products of the chunked
    WKV6 over the (B, S) prompt, every layer."""
    h = cfg.d_model // cfg.resolved_head_dim
    p, q = cfg.resolved_head_dim, min(cfg.ssm.chunk, S)
    nc = -(-S // q)
    return cfg.n_layers * (2 * B * nc * q * q * h * p + 2 * B * nc * q * h * p)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_flops_equal_the_references(arch):
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    lowered, _ = jsl.lower_prefill(jcfg, reference_rules(), jconfigs.ShapeSpec("p", "prefill", S, B))
    want = analyze_hlo(lowered.compile().as_text()).flops
    analysis, _ = lower_prefill(tcfg, tconfigs.ShapeSpec("p", "prefill", S, B), "cpu")
    missing = _wkv_intra_flops(tcfg) if tcfg.backbone == "rwkv6" else 0.0
    assert analysis.flops == want - missing, (arch, analysis.flops, want)
    assert analysis.peak_bytes > analysis.held_bytes > 0


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-7b"])
def test_decode_step_flops_equal_the_references(arch):
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    spec = jconfigs.ShapeSpec("d", "decode", S, B)
    lowered, _, _ = jsl.lower_decode_step(jcfg, reference_rules(), spec)
    want = analyze_hlo(lowered.compile().as_text()).flops
    analysis, _, cache = lower_decode_step(tcfg, tconfigs.ShapeSpec("d", "decode", S, B), "cpu")
    assert analysis.flops == want
    # the cache init_cache makes is held; the step returns a new one
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in torch.utils._pytree.tree_leaves(cache))
    assert analysis.held_bytes > cache_bytes
    assert analysis.peak_bytes >= analysis.held_bytes + cache_bytes
