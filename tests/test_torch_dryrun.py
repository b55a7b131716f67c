"""The dry run's train cells held to the reference's: the graph FLOPs of
the port's train step (`training.train_loop.lower_train_step`, traced on
fake tensors under `launch.roofline.GraphAnalysis`) against the
reference's `analyze_hlo` of its compiled step
(`repro.training.train_loop.lower_train_step` on a (1, 1) mesh with Auto
axes, R2), at the reduced configs, B = 2, S = 64. Exact for the
transformer configs; rwkv6 and zamba2 within the tolerances below, their
differing operations named there. The serving cells are in
tests/test_torch_dryrun_serve.py."""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.distributed.sharding import ShardingRules
from repro.launch.roofline import analyze_hlo
from repro.training import train_loop as jtl
from repro_torch import configs as tconfigs
from repro_torch.launch.dryrun import train_batch_shape
from repro_torch.training.train_loop import lower_train_step

B, S = 2, 64
# Relative shortfall of the port's train-step FLOPs under the reference's,
# measured 0.70 % (rwkv6) and 0.17 % (zamba2); 0 for every transformer.
#  - rwkv6: the reference contracts the chunked WKV6's intra-chunk scores
#    einsum(r, k, exp(el_t - il_j)) and the bonus einsum(r, u, k) as dots
#    (forward and remat); the port takes them as elementwise products and
#    sums (`models.rwkv6._intra_scores`, `(r * u * k).sum`), which count
#    no FLOPs.
#  - zamba2: in the SSD's backward XLA contracts two broadcast products'
#    gradients as dots, d(decay_to_end) = sum_p d(decay x) x (of s_local)
#    and d(cb) = sum_h d(scores) ratio; the port's autograd takes them as
#    elementwise products and sums (`models.mamba2._ssd_chunked`).
TRAIN_FLOPS_RTOL = {"rwkv6-7b": 0.0075, "zamba2-7b": 0.002}
ARCHS = ["qwen3-4b", "granite-moe-3b-a800m", "gemma2-27b", "rwkv6-7b", "zamba2-7b"]


def reference_rules():
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    return ShardingRules(mesh=mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_flops_equal_the_references(arch):
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    lowered, _, _ = jtl.lower_train_step(jcfg, reference_rules(), batch)
    want = analyze_hlo(lowered.compile().as_text()).flops
    analysis, params, opt = lower_train_step(
        tcfg, train_batch_shape(tcfg, tconfigs.ShapeSpec("t", "train", S, B)), device="cpu")
    got = analysis.flops
    rtol = TRAIN_FLOPS_RTOL.get(arch, 0.0)
    assert want * (1 - rtol) <= got <= want, (arch, got, want)
    # the products are bf16, the routers' and AdamW's float32
    assert set(analysis.flops_by_dtype) <= {"bfloat16", "float32"}
    assert analysis.flops_by_dtype["bfloat16"] > 0.9 * got
    # parameters and optimizer state are fake, held through the step
    leaf = params["embed"]
    assert isinstance(leaf, torch._subclasses.fake_tensor.FakeTensor)
    assert analysis.held_bytes > 0 and analysis.peak_bytes > analysis.held_bytes
    assert analysis.hbm_bytes > analysis.peak_bytes
    assert opt is not None
