"""The sharded transformer step against the reference's, as
tests/test_torch_dense_grid.py holds it, for reduced gemma2-27b (local /
global layers, attention and final soft-caps, post norms, tied
embeddings) and musicgen-medium (the embedding frontend, 4 heads padded
to 32 on the model axis) on (2, 4), (1, 4) and (2, 2) grids."""

import pytest

from test_torch_dense_grid import (
    GRIDS,
    case_id,
    check_forward,
    check_gradients,
    check_pieces,
    check_steps,
)

CASES = [(a, g) for a in ("gemma2-27b", "musicgen-medium") for g in GRIDS]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_pieces_are_shard_shapes(case):
    check_pieces(case)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_forward_follows_the_references(case):
    check_forward(case)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_gradients_follow_the_references(case):
    check_gradients(case)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_two_adamw_steps_follow_the_references(case):
    check_steps(case)
