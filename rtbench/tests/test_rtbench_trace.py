"""``rtbench/trace.py``: the idle gaps of a traced window, each labelled by
the innermost span the host was in, the port's ``rt.*`` spans before the
harness's."""

import json

import pytest

from rtbench.trace import Trace


def _span(name, t0, t1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": t0, "dur": t1 - t0}


def _trace(tmp_path, program=True):
    """Two frames; the device busy but for six gaps, one in each kind of
    place (times in us); ``program``: with the port's spans."""
    events = [
        _span("rtbench.pose", 0, 10), _span("rtbench.call", 10, 100),
        _span("rtbench.sync", 100, 200),
        _span("rtbench.pose", 210, 220), _span("rtbench.call", 220, 290),
        _span("rtbench.sync", 290, 300),
    ]
    if program:
        events += [
            _span("rt.frame.0", 12, 95), _span("rt.bind", 15, 40), _span("rt.replay", 45, 60),
            _span("rt.clone", 62, 70),
            # a nested span that starts with its parent
            _span("rt.frame.1", 220, 285), _span("rt.replay", 220, 250),
            # the device's copy of an annotation, and a span past the window
            _span("rt.bind", 0, 300, cat="gpu_user_annotation"), _span("rt.bind", 400, 500),
        ]
    for t0, t1 in ((0, 20), (30, 41), (44, 96), (99, 150), (180, 200), (210, 221), (229, 300)):
        events.append(_span("kernel", t0, t1, cat="kernel"))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace(str(path), 2)


def test_idle_gaps_take_the_innermost_span(tmp_path):
    tr = _trace(tmp_path)
    gaps = {label: s for label, s in tr.breakdown()["idle_gaps"]}
    assert gaps == pytest.approx({"rtbench.sync": 30e-6, "rt.bind": 10e-6,
                                  "between_spans": 10e-6, "rt.replay": 8e-6, "rt.frame": 3e-6,
                                  "rtbench.call": 3e-6})
    assert tr.busy_us == 300 - 64
    assert tr.breakdown()["device_ops"] == [["kernel", pytest.approx(236e-6)]]


def test_without_program_spans_the_harness_spans_label(tmp_path):
    tr = _trace(tmp_path, program=False)
    labels = sorted(label for label, _ in tr.breakdown()["idle_gaps"])
    assert labels == sorted(["rtbench.call", "rtbench.call", "rtbench.call", "rtbench.sync",
                             "between_spans", "rtbench.call"])
