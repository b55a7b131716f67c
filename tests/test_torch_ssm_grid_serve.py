"""The sharded rwkv6 and zamba2 prefill and decode (`repro_torch.models.
rwkv6` / `zamba2` under a `MeshContext` over a device grid of the CPU)
against the reference's `prefill` / `decode_step` jitted on Auto meshes of
the same shapes, their caches laid out by `cache_specs`, as
tests/test_torch_ssm_grid.py holds the train steps (the same draw and
bounds): a 16-token prompt into a 24-position cache, then two decode
steps from the grid's own prefill; the WKV and SSD states with their
heads over "model", the conv carries with d_inner over it, zamba2's
shared k / v caches with their sequence over it. In float32 against the
reference, in float64 against the port's one-device route."""

import pytest

from test_torch_ssm_grid import ARCHS, GRIDS, case_id, check_serve

CASES = [(a, g) for a in ARCHS for g in GRIDS]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_prefill_and_decodes_follow_the_references(case):
    check_serve(case)
