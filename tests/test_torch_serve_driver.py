"""The port's serving command line against the reference's own example.

`examples/serve_streaming.py` is loaded from its file and its `main()` run
with ``sys.argv`` patched and ``--devices 1``: on the 8-device emulated
CPU platform of tests/conftest.py its default would shard the streams,
and its `open_stream` then stops on the `Explicit` mesh (R9). Its server
is captured by wrapping the module's `StreamingKWSServer` name, which
also hands over its float params and its pipeline (norm stats, frontend
state). The port's `repro_torch.serving.serve_streaming` runs with
``--device cpu`` on those params, stats and state; both modules' ``time``
names are replaced by a clock that advances a fixed step a read, so the
autoscaler's decisions do not depend on the host.

Held equal per stream id: every GRU / ΔGRU state leaf, the frontend
carry and the detector state, ``top``, ``sparsity``, ``wake_rate``, the
printed top-class counts, ΔGRU and cascade lines, the resize line and
the autoscaler's decisions (action, from, to, reason). Scores within
1e-6, the float backend within F1's 2e-6. The metrics snapshot has the
reference's keys, counters, gauges, histogram counts and journal event
kinds. One port run on two CPU shards (``--devices cpu cpu``) is held
against the reference's one-device run.
"""

import contextlib
import importlib.util
import io
import pathlib
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.serving import serve_streaming

ROOT = pathlib.Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "examples" / "serve_streaming.py"
SCORE_ATOL = 1e-6
FLOAT_ATOL = 2e-6
# F15: the driver's own sigma against the reference's (8 of 16 channels
# one ulp apart at 8 streams)
SIGMA_ULPS = 1
CLOCK_STEP = 1e-3  # seconds a clock read advances

# 12 ticks (0.2 s) a run; 8 streams, 16 for the autoscaler (which then
# grows 16 -> 32 at tick 1 on the occupancy watermark)
CASES = {
    "qat-live": ["--streams", "8", "--classifier", "qat"],
    "integer-offline": ["--streams", "8", "--classifier", "integer", "--offline"],
    "delta-int-cascade-pipelined": ["--streams", "8", "--classifier", "delta-int",
                                    "--theta", "0.15", "--cascade", "--pipelined",
                                    "--window", "5"],
    "float-grow": ["--streams", "8", "--classifier", "float", "--grow", "16"],
    "hardware-metrics-autoscale": ["--streams", "16", "--frontend", "hardware", "--metrics",
                                   "--autoscale"],
}
SECONDS = ["--seconds", "0.2"]
# the printed lines that must match the reference's word for word
SAME_LINES = ("final per-stream top classes", "ΔGRU θ=", "cascade thr=", "  [tick ")


class FakeClock:
    """A stand-in for the ``time`` module: every read advances STEP s."""

    def __init__(self, step: float = CLOCK_STEP):
        self.t = 0.0
        self.step = step

    def _read(self) -> float:
        self.t += self.step
        return self.t

    def time(self) -> float:
        return self._read()

    def perf_counter(self) -> float:
        return self._read()


@contextlib.contextmanager
def _patched(obj, **attrs):
    old = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(obj, k, v)


@pytest.fixture(scope="module")
def reference_module():
    spec = importlib.util.spec_from_file_location("reference_serve_streaming", REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_REFERENCE_RUNS = {}


def _reference(mod, case):
    """(server, its float params, its pipeline, stdout) of the reference
    example's run of ``case`` on one device, once per case."""
    if case not in _REFERENCE_RUNS:
        made = []
        server_cls = mod.StreamingKWSServer

        def capture(pipe, params, *args, **kwargs):
            srv = server_cls(pipe, params, *args, **kwargs)
            made.append((srv, params, pipe))
            return srv

        argv = ["serve_streaming.py", *CASES[case], *SECONDS, "--devices", "1"]
        out = io.StringIO()
        with _patched(mod, StreamingKWSServer=capture, time=FakeClock()), \
                _patched(sys, argv=argv), contextlib.redirect_stdout(out):
            mod.main()
        (srv, params, pipe), = made
        _REFERENCE_RUNS[case] = (srv, params, pipe, out.getvalue())
    return _REFERENCE_RUNS[case]


def _np(x):
    return None if x is None else np.asarray(x)


def _port_inputs(params, pipe):
    """The reference's float params, norm stats and frontend state as the
    port's, on the CPU."""
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    st = pipe.state
    stats = convert.norm_stats_from_numpy(np.asarray(st.norm_stats.mu),
                                          np.asarray(st.norm_stats.sigma), "cpu")
    chip = st.chip
    state = convert.frontend_state_from_numpy(
        "cpu", gain_mismatch=None if chip is None else _np(chip.gain_mismatch),
        cf_mismatch=None if chip is None else _np(chip.cf_mismatch), beta=_np(st.beta),
        alpha=_np(st.alpha), coeffs=_np(st.coeffs))
    return tparams, stats, state


def _port(argv, params, stats, state):
    out = io.StringIO()
    with _patched(serve_streaming, time=FakeClock()), contextlib.redirect_stdout(out):
        res = serve_streaming.serve(serve_streaming.parse_args(argv), params, stats, state)
    return res, out.getvalue()


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [(f"{k}.{p}", a) for k in sorted(tree) for p, a in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [(f"{i}.{p}", a) for i, t in enumerate(tree) for p, a in _leaves(t)]
    return [("", tree)]


def _rows(srv, sids, field, reference: bool):
    """Stream ids' rows of every leaf of a state field, in id order."""
    if reference:
        st = jax.tree_util.tree_map(np.asarray, srv.state)
        st = convert.server_state_from_numpy(st.gru, st.carry, st.scores, st.det, "cpu")
    else:
        st = srv.state
    rows = [srv.active[s] for s in sids]
    return [(p, a.cpu().numpy()[rows]) for p, a in _leaves(getattr(st, field))]


def _lines(out):
    return [ln for ln in out.splitlines() if ln.startswith(SAME_LINES)]


def _decisions(out):
    return re.findall(r"autoscaler (\w+): (\d+) -> (\d+) slots \(reason: (\w+)\)", out)


def _metrics(snap):
    """The snapshot's deterministic parts: counters, gauges, histogram
    counts, journal event kinds."""
    def key(e):
        return e["name"], tuple(sorted(e["labels"].items()))

    return {
        "keys": sorted(snap),
        "server": sorted(snap["server"]),
        "counters": sorted((key(e), e["value"]) for e in snap["counters"]),
        "gauges": sorted((key(e), e["value"]) for e in snap["gauges"]),
        "histograms": sorted((key(e), e["count"]) for e in snap["histograms"]),
        "journal": [e["kind"] for e in snap["journal"]],
    }


def _assert_like_reference(case, res, out, jsrv, jout):
    tsrv = res["server"]
    flt = "float" in CASES[case]
    sids = sorted(tsrv.active)
    assert sids == sorted(jsrv.active) == list(range(len(sids)))
    for field in ("gru", "carry", "det"):
        got, want = _rows(tsrv, sids, field, False), _rows(jsrv, sids, field, True)
        assert [p for p, _ in got] == [p for p, _ in want], field
        for (path, a), (_, b) in zip(got, want):
            assert a.dtype == b.dtype, (field, path)
            if flt and a.dtype == np.float32:
                np.testing.assert_allclose(a, b, rtol=0, atol=FLOAT_ATOL, err_msg=path)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{field}.{path}")
    np.testing.assert_allclose(tsrv.scores[[tsrv.active[s] for s in sids]],
                               jsrv.scores[[jsrv.active[s] for s in sids]], rtol=0,
                               atol=FLOAT_ATOL if flt else SCORE_ATOL)
    jscores = jsrv.scores
    assert res["top"] == {s: int(np.argmax(jscores[jsrv.active[s]])) for s in sids}
    for name in ("sparsity", "wake_rate"):
        np.testing.assert_array_equal(getattr(tsrv, name)[[tsrv.active[s] for s in sids]],
                                      getattr(jsrv, name)[[jsrv.active[s] for s in sids]])
    assert _lines(out) == _lines(jout)
    assert [(d["action"], str(d["from"]), str(d["to"]), d["reason"])
            for d in res["decisions"]] == _decisions(jout)
    assert res["n_frames"] == 12


@pytest.mark.parametrize("case", sorted(CASES))
def test_driver_equals_the_reference_example(reference_module, case):
    jsrv, params, jpipe, jout = _reference(reference_module, case)
    res, out = _port([*CASES[case], *SECONDS, "--device", "cpu"], *_port_inputs(params, jpipe))
    _assert_like_reference(case, res, out, jsrv, jout)
    tsrv = res["server"]
    assert tsrv.tick_dispatch == "cpu" and tsrv.n_devices == 1
    if "--metrics" in CASES[case]:
        assert _metrics(tsrv.metrics_snapshot()) == _metrics(jsrv.metrics_snapshot())
        assert "metrics snapshot:" in out
    if "--autoscale" in CASES[case]:
        assert res["decisions"] and res["decisions"][0]["reason"] == "occupancy_watermark"
    if "--grow" in CASES[case]:
        assert tsrv.max_streams == jsrv.max_streams == 16


def test_two_shards_equal_the_references_one_device_run(reference_module):
    case = "delta-int-cascade-pipelined"
    jsrv, params, jpipe, jout = _reference(reference_module, case)
    res, out = _port([*CASES[case], *SECONDS, "--device", "cpu", "--devices", "cpu", "cpu"],
                     *_port_inputs(params, jpipe))
    assert res["server"].n_devices == 2
    _assert_like_reference(case, res, out, jsrv, jout)


def test_own_setup_equals_the_references(reference_module):
    """The port's corpus, norm stats and seeded params, made by the driver
    itself: mu array-equal to the reference's, sigma within F15's ulp."""
    jsrv, _, jpipe, _ = _reference(reference_module, "qat-live")
    audio = serve_streaming.corpus(8)
    stats = serve_streaming.norm_stats(audio, "cpu")
    np.testing.assert_array_equal(stats.mu.numpy(), np.asarray(jpipe.state.norm_stats.mu))
    # F15: jnp.std's compiled sum of squares is not followed; 1 ulp
    np.testing.assert_array_max_ulp(stats.sigma.numpy(), np.asarray(jpipe.state.norm_stats.sigma),
                                    maxulp=SIGMA_ULPS)
    args = serve_streaming.parse_args(["--streams", "8", "--device", "cpu"])
    pipe, params, srv, got = serve_streaming.setup(args, stats=stats)
    np.testing.assert_array_equal(got, audio)
    assert sorted(srv.active) == list(range(8)) and srv.max_streams == 8
    want = pipe.init_params(torch.Generator().manual_seed(0), device="cpu")
    for (_, a), (_, b) in zip(_leaves(params), _leaves(want)):
        assert torch.equal(a, b)


def test_streams_past_the_corpus_raise():
    with pytest.raises(ValueError, match="72 clips"):
        serve_streaming.main(["--streams", "73", "--device", "cpu"])


def test_no_card_and_no_cpu_flag_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_streaming.main(["--streams", "8", "--seconds", "0.05"])


@pytest.mark.parametrize("devices,want", [
    (None, ["cpu"]), (["2"], ["cpu", "cpu"]), (["cpu", "cpu", "cpu"], ["cpu"] * 3),
])
def test_devices_flag_on_the_cpu(devices, want):
    argv = ["--device", "cpu"] + ([] if devices is None else ["--devices", *devices])
    got = serve_streaming.server_devices(serve_streaming.parse_args(argv))
    assert [str(d) for d in got] == want
