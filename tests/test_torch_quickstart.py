"""The port's quickstart against the reference's own `examples/quickstart.py`.

The reference runs from its file with ``jax.core.trace_state_clean``
restored (R5; its fused kernel runs in Pallas interpret mode) and its
printed figures are read back. The port's `repro_torch.quickstart.run`
runs on the CPU with the reference's params (``PRNGKey(0)``, carried
across through numpy). Held equal: the top class, the integer backend's
bit-identity to QAT, the FV_Raw difference of every frontend (13.0 /
13.0 / 0.0 LSB; the hardware dies are calibrated, not drawn, so nothing
is carried across), the IC model's latency and power. The port's frames
(K1's plain version) are array-equal to the reference's `fex_frames`, and
their difference to the step-by-step software model stays within
FRAMES_ERR_BOUND (the reference prints its interpret kernel's 2.98e-08).
"""

import contextlib
import io
import pathlib
import re
import runpy
import sys

import jax
import jax._src.core as jax_core_internal
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.energy import paper_accelerator, paper_power_model
from repro.core.fex import FExConfig, fex_frames
from repro.core.gru import GRUConfig
from repro.core.pipeline import KWSPipeline, KWSPipelineConfig
from repro.data.gscd import GSCDSynthConfig, _TEMPLATES, synth_keyword
from repro_torch import convert, quickstart

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "examples" / "quickstart.py"
# K1's frame sums (in the reference's compiled order) against torch's
# frame mean of the scan's |y|: measured 3.73e-09 on the CPU
FRAMES_ERR_BOUND = 1e-7


@pytest.fixture(scope="module")
def runs():
    """(the reference's stdout, the port's figures and stdout)."""
    restore = not hasattr(jax.core, "trace_state_clean")
    if restore:
        jax.core.trace_state_clean = jax_core_internal.trace_state_clean
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            old, sys.argv = sys.argv, [str(REFERENCE)]
            try:
                runpy.run_path(str(REFERENCE), run_name="__main__")
            finally:
                sys.argv = old
    finally:
        if restore:
            del jax.core.trace_state_clean
    params = KWSPipeline(KWSPipelineConfig()).init_params(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    tout = io.StringIO()
    with contextlib.redirect_stdout(tout):
        got = quickstart.run("cpu", params=tparams)
    return out.getvalue(), got, tout.getvalue()


def _field(text, pattern):
    m = re.search(pattern, text)
    assert m, pattern
    return m.group(1)


def test_top_class_and_integer_bit_identity(runs):
    ref, got, out = runs
    assert got["top"] == _field(ref, r"final-frame top class: (\w+)")
    assert _field(ref, r"bit-identical to QAT scores = (\w+)") == "True"
    assert got["integer_exact"] is True
    assert "bit-identical to QAT scores = True" in out


def test_fv_raw_diff_of_every_frontend(runs):
    ref, got, out = runs
    want = {name: float(d) for name, d in
            re.findall(r"frontend (\S+)\s*: FV_Raw max \|diff\| vs software reference = "
                       r"([\d.]+) LSB", ref)}
    assert want == {"hardware": 13.0, "hardware-pallas": 13.0, "software": 0.0}
    assert got["fv_raw_diff"] == want
    assert re.findall(r"frontend (\S+)\s*: FV_Raw", out) == list(want)


def test_frames_equal_the_references(runs):
    ref, got, _ = runs
    audio = synth_keyword(np.random.default_rng(0), _TEMPLATES["yes"], GSCDSynthConfig())
    assert got["peak"] == float(np.abs(audio).max())
    want = np.asarray(fex_frames(jnp.asarray(audio[None]), FExConfig()))
    np.testing.assert_array_equal(got["frames"], want)
    assert 0 < got["frames_err"] <= FRAMES_ERR_BOUND
    assert float(_field(ref, r"max err vs reference: ([\d.e+-]+)")) <= FRAMES_ERR_BOUND


def test_latency_and_power_equal_the_references(runs):
    ref, got, out = runs
    g = GRUConfig()
    assert got["latency_ms"] == paper_accelerator().latency_s(g) * 1e3
    assert got["power_uw"] == paper_power_model().total_power_w(g) * 1e6
    line = re.compile(r"IC model: latency [\d.]+ ms \(paper 12.4\), core power [\d.]+ uW")
    assert line.search(out).group(0) == line.search(ref).group(0)
