"""The port's trace export and report (``repro_torch.obs.export``,
``repro_torch.obs.report``) against the JAX package's (``repro.obs``) on
the CPU, and the traced cluster smoke.

The same spans give the same Chrome trace document, file, load errors,
summary and report output (exit codes included) in both packages; the
reference's ``summarize`` reads the port's trace and gives the port's
summary. ``python -m repro_torch.obs.smoke --device cpu`` writes a trace
with a coordinator lane and two worker lanes (each with ``launch.*``
spans on the workers' device) that ``python -m repro_torch.obs.report
--min-hosts 2 --min-stages 4`` accepts. Every case is fixed.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.obs import export as r_export
from repro.obs import metrics as r_metrics
from repro.obs import report as r_report
from repro_torch.obs import export as t_export
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import report as t_report
from repro_torch.obs import trace as t_trace

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _tracer():
    """Restore the port's process tracer."""
    prev = t_trace.current()
    yield
    t_trace.set_tracer(prev)


SPANS = {
    "two_hosts": [
        {"name": "engine.knn_batch", "cat": "engine", "ts": 0.0,
         "dur": 100.0, "pid": 1, "tid": 1, "host": "coordinator",
         "trace": "t1", "args": {"B": 8}},
        {"name": "amih.probe", "cat": "amih", "ts": 10.0, "dur": 20.0,
         "pid": 2, "tid": 3, "host": "host0", "trace": "t1"},
        {"name": "launch.verify_grouped.dispatch", "cat": "kernel",
         "ts": 35.0, "dur": 5.5, "pid": 2, "tid": 3, "host": "host0",
         "args": {"device": "cuda:0", "B": 2, "C": 64}},
    ],
    "no_host_no_args": [
        {"name": "a", "ts": 5, "dur": 1},
        {"name": "b", "cat": "x", "ts": 1.5, "dur": 0.25, "tid": 7},
        {"ts": 2.0},
    ],
    "three_lanes": [
        {"name": f"s{i % 5}", "ts": float(i), "dur": float(i % 3),
         "host": f"host{i % 3}", "trace": "abc"}
        for i in range(30)
    ],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_chrome_trace_doc_equals_reference(name):
    spans = SPANS[name]
    for trace_id in (None, "tid-7"):
        assert t_export.chrome_trace_doc(spans, trace_id) == \
            r_export.chrome_trace_doc(spans, trace_id)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_write_load_and_summarize_equal_reference(name, tmp_path):
    """The written files are the same JSON, each package loads the
    other's, and the reference's ``summarize`` of the port's trace is the
    port's summary."""
    spans = SPANS[name]
    t_path, r_path = tmp_path / "t.json", tmp_path / "r.json"
    assert t_export.write_chrome_trace(spans, str(t_path)) == len(spans)
    r_export.write_chrome_trace(spans, str(r_path))
    assert t_path.read_text() == r_path.read_text()
    t_doc = t_export.load_chrome_trace(str(r_path))
    r_doc = r_export.load_chrome_trace(str(t_path))
    assert t_doc == r_doc
    assert t_report.summarize(t_doc) == r_report.summarize(t_doc)


def test_write_chrome_trace_from_a_live_tracer(tmp_path):
    tr = t_trace.Tracer(enabled=True, host="coordinator", trace_id="x9")
    with tr.span("outer", cat="engine", B=4):
        with tr.span("inner", cat="kernel", device="cpu"):
            pass
    tr.ingest([{"name": "amih.probe", "ts": 3.0, "dur": 1.0}],
              host="host1", shift_us=2.0)
    path = tmp_path / "live.json"
    assert t_export.write_chrome_trace(tr, str(path)) == 3
    doc = json.loads(path.read_text())
    assert doc == r_export.chrome_trace_doc(tr.snapshot(), trace_id="x9")
    assert doc["metadata"] == {"trace_id": "x9"}
    lanes = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M"}
    assert lanes == {"coordinator", "host1"}


@pytest.mark.parametrize("text", [
    '{"notTraceEvents": 1}',
    '{"traceEvents": [{"ph": "X", "name": "x"}]}',
    '{"traceEvents": [{"name": "no ph"}]}',
    '{"traceEvents": [7]}',
    "[1, 2]",
])
def test_load_chrome_trace_rejects_what_the_reference_rejects(text,
                                                              tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(text)
    with pytest.raises(ValueError) as t_err:
        t_export.load_chrome_trace(str(bad))
    with pytest.raises(ValueError) as r_err:
        r_export.load_chrome_trace(str(bad))
    assert str(t_err.value) == str(r_err.value)


@pytest.mark.parametrize("argv,rc", [
    (["--min-hosts", "2", "--min-stages", "3"], 0),
    (["--min-hosts", "3"], 1),
    (["--min-stages", "4"], 1),
    ([], 0),
], ids=["floors-met", "hosts-unmet", "stages-unmet", "no-floors"])
def test_report_cli_equals_reference(argv, rc, tmp_path, capsys):
    path = str(tmp_path / "trace.json")
    t_export.write_chrome_trace(SPANS["two_hosts"], path)
    assert t_report.main([path] + argv) == rc
    out_t = capsys.readouterr()
    assert r_report.main([path] + argv) == rc
    out_r = capsys.readouterr()
    assert (out_t.out, out_t.err) == (out_r.out, out_r.err)
    assert "% wall" in out_t.out


def test_report_cli_unreadable_files_exit_2(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text("not json")
    for path in (str(bad), str(tmp_path / "missing.json")):
        assert t_report.main([path]) == r_report.main([path]) == 2
    assert "error:" in capsys.readouterr().err


def test_write_metrics_jsonl_equals_reference(tmp_path):
    regs = (t_metrics.MetricsRegistry(), r_metrics.MetricsRegistry())
    for reg in regs:
        reg.counter("launches.verify_grouped").add(3)
        reg.counter("cache.hits").add(1)
        reg.histogram("serve.latency_ms").record(2.5, count=4)
    t_export.write_metrics_jsonl(str(tmp_path / "t.jsonl"), regs[0])
    r_export.write_metrics_jsonl(str(tmp_path / "r.jsonl"), regs[1])
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "r.jsonl").read_text()


@pytest.mark.parametrize("probe", ["host", "device"])
def test_obs_smoke_and_report_cli(probe, tmp_path):
    """The traced 2-worker cluster smoke on the CPU, then the report CLI
    with the floors the smoke's trace must meet; both packages summarize
    the trace alike, and each worker lane holds a ``launch.*`` span on
    the workers' device. Without ``--out`` the trace goes to a new
    temporary directory, never the working one."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               TMPDIR=str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    (tmp_path / "cwd").mkdir()
    out = tmp_path / "trace.json"
    smoke = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.smoke", "--device", "cpu",
         "--probe-backend", probe]
        + (["--out", str(out)] if probe == "device" else []),
        env=env, cwd=tmp_path / "cwd", capture_output=True, text=True,
        timeout=300,
    )
    assert smoke.returncode == 0, smoke.stderr
    assert "3 hosts" in smoke.stdout and "['cpu']" in smoke.stdout
    assert not any((tmp_path / "cwd").iterdir())
    if probe == "host":
        (out,) = (tmp_path / "tmp").glob("obs_smoke_*/obs_smoke_trace.json")
        assert f"wrote {out}:" in smoke.stdout
    report = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(out),
         "--min-hosts", "2", "--min-stages", "4"],
        env=env, capture_output=True, text=True, timeout=60,
    )
    assert report.returncode == 0, report.stderr
    assert "host0" in report.stdout and "cluster.rpc" in report.stdout
    assert not report.stderr
    doc = t_export.load_chrome_trace(str(out))
    assert t_report.summarize(doc) == r_report.summarize(doc)
    lanes = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M"}
    launch_lanes = {lanes[e["pid"]] for e in doc["traceEvents"]
                    if e["ph"] == "X" and e["name"].startswith("launch.")
                    and e["args"].get("device") == "cpu"}
    assert launch_lanes == {"host0", "host1"}
    assert doc["metadata"]["trace_id"]
