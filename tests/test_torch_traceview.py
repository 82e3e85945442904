"""PyTorch port vs JAX reference: ``analysis/traceview.py``.

The port's traceview reads the port's own artifacts: the serving CLI's
``--metrics-out`` snapshot and ``--trace-out`` Chrome trace from a CPU
smoke engine must validate with no problems, and its ``require_nonzero``
names the recorded metrics.  Malformed traces are rejected as the
reference's ``tests/test_telemetry.py`` rejects them, with the same
messages; ``attribution`` of one metrics dict equals the reference's.
"""

import copy
import json

import pytest

from repro.analysis import traceview as jtv

from repro_torch.analysis import traceview as ttv

ARCH = "granite_3_8b"
NONZERO = ["decode_steps", "tokens_decoded", "prefill_tokens", "ttft_s",
           "itl_s", "queue_wait_s", "e2e_latency_s"]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Metrics snapshot and trace of the port's CPU smoke engine (W4,
    kv8, paged), through the serving CLI as a user writes them."""
    from repro_torch.launch import serve as tserve
    d = tmp_path_factory.mktemp("traceview")
    m, t = str(d / "metrics.json"), str(d / "trace.json")
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--engine",
                 "--w-bits", "4", "--kv-bits", "8", "--requests", "4",
                 "--rate", "200", "--max-slots", "4", "--new-tokens", "4",
                 "--prompt-len", "12", "--max-len", "64", "--page-size", "8",
                 "--metrics-out", m, "--trace-out", t])
    with open(m) as fm, open(t) as ft:
        return m, t, json.load(fm), json.load(ft)


def test_engine_artifacts_validate(artifacts):
    _, _, metrics, trace = artifacts
    assert ttv.validate_chrome_trace(trace) == []
    assert ttv.require_nonzero(metrics, NONZERO) == []
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"step", "decode", "queued"} <= names
    s = ttv.trace_summary(trace)
    assert s["spans"] > 0 and s["lanes"] >= 2 and s["dropped"] == 0
    # the reference's validator reads the port's trace alike
    assert jtv.validate_chrome_trace(trace) == []
    assert jtv.trace_summary(trace) == s
    assert ttv.require_nonzero(metrics, ["no_such_metric"]) == \
        ["metric no_such_metric not in snapshot"]


def test_cli_validates_the_engine_artifacts(artifacts, capsys):
    m, t, _, _ = artifacts
    assert ttv.main(["--metrics", m, "--trace", t, "--require-nonzero",
                     ",".join(NONZERO)]) == 0
    out = capsys.readouterr().out
    assert "traceview: OK" in out and "cost attribution" in out
    assert ttv.main(["--metrics", m, "--require-nonzero",
                     "preemptions", "--format", "json"]) == 1


MALFORMED = [
    {"traceEvents": [{"name": "x", "ph": "E", "ts": 1, "pid": 1, "tid": 0}]},
    {"traceEvents": [{"name": "x", "ph": "B", "ts": 1, "pid": 1, "tid": 0}]},
    {"traceEvents": [
        {"name": "a", "ph": "B", "ts": 5, "pid": 1, "tid": 0},
        {"name": "", "ph": "E", "ts": 9, "pid": 1, "tid": 0},
        {"name": "b", "ph": "B", "ts": 2, "pid": 1, "tid": 0},
        {"name": "", "ph": "E", "ts": 3, "pid": 1, "tid": 0}]},
    {},
    {"traceEvents": [{"name": "x", "ph": "Q", "ts": 1, "pid": 1, "tid": 0},
                     {"name": "y", "ph": "B", "ts": -1, "pid": 1, "tid": 0},
                     {"name": "z", "ph": "B", "ts": 1, "pid": "1", "tid": 0},
                     7]},
]


@pytest.mark.parametrize("trace", MALFORMED)
def test_malformed_traces_are_rejected_as_the_reference_rejects_them(trace):
    got = ttv.validate_chrome_trace(trace)
    assert got and got == jtv.validate_chrome_trace(trace)


def test_a_broken_engine_trace_is_rejected(artifacts):
    _, _, _, trace = artifacts
    bad = copy.deepcopy(trace)
    first_e = next(i for i, e in enumerate(bad["traceEvents"])
                   if e.get("ph") == "E")
    del bad["traceEvents"][first_e]
    assert ttv.validate_chrome_trace(bad)


def test_attribution_equals_the_reference(artifacts):
    """The same snapshot through both: the theory (BOPs a token, weight
    and KV bytes) and every phase's achieved rates are equal; the dequant
    table describes each framework's own kernels, so only its
    ops-per-element (and the achieved rate it scales) may differ."""
    _, _, metrics, _ = artifacts
    got, want = ttv.attribution(metrics), jtv.attribution(metrics)
    assert got["theory"] == want["theory"]
    assert got["phases"] == want["phases"]
    assert got["meta"] == want["meta"]
    assert {p["phase"] for p in got["phases"]} == {"prefill", "decode"}
    for g, w in zip(got["dequant"], want["dequant"]):
        assert (g["family"], g["active"]) == (w["family"], w["active"])
        if "achieved_gops_s" in w:
            assert g["achieved_gops_s"] == pytest.approx(
                w["achieved_gops_s"] * g["ops_per_elem"]
                / w["ops_per_elem"], rel=1e-2, abs=0.02)
    assert got["theory"]["bops_per_token_g"] < \
        got["theory"]["bops_per_token_g_w16"]
    text = ttv.format_attribution(got)
    assert "decode" in text and "prefill" in text
    with pytest.raises(ValueError):
        ttv.attribution({"meta": {}})
