"""Parity of the port's ``tracing`` (``koordinator_tpu_torch/tracing.py``)
with the JAX package's: the same scripted operations on a tracer of each
package leave the same span documents (names, services, parent structure,
attributes, events, status) with the trace and span ids renamed by first
appearance and the times masked; ``activate`` with a remote parent,
``inject``/``extract`` and the annotation round trip decode alike, and a
JSONL export writes the same records.  Mirrors tests/test_tracing.py's
core cases.
"""

import json

import pytest

from tests.torch_parity import reset_observability, set_torch_threads

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh_tracing():
    reset_observability()
    yield
    reset_observability()


def both():
    from koordinator_tpu import tracing as jt

    from koordinator_tpu_torch import tracing as tt

    return tt, jt


def canon(docs):
    """Span docs with ids renamed by first appearance and times masked."""
    ids: dict = {}

    def cid(x):
        return None if x is None else ids.setdefault(x, len(ids))

    out = []
    for d in docs:
        d = dict(d)
        d["trace_id"], d["span_id"] = cid(d["trace_id"]), cid(d["span_id"])
        d["parent_id"] = cid(d["parent_id"])
        d["start_time"] = "<t>"
        d["duration_s"] = None if d["duration_s"] is None else "<t>"
        d["events"] = [dict(e, time="<t>") for e in d["events"]]
        out.append(d)
    return out


def script(mod):
    """One scripted run on a fresh tracer of ``mod``; returns the exported
    docs and the values the script read."""
    tracer = mod.Tracer(service="svc", ring_capacity=8)
    col = mod.InMemoryExporter()
    tracer.add_exporter(col)
    seen = []
    assert tracer.current_context() is None
    with tracer.span("root", attributes={"k": 1}) as root:
        seen.append(tracer.current_span() is root)
        with tracer.span("child", service="other") as child:
            child.set_attribute("x", "y")
            child.add_event("tick", {"n": 2})
            child.add_event("tock")
            seen.append(tracer.current_context() == child.context())
        manual = tracer.start_span("manual", attributes={"pod": "p0"})
        manual.set_attributes({"node": "n0", "round": 3})
        manual.end()
        manual.end()                     # idempotent
    remote = mod.TraceContext(trace_id="r" * 32, span_id="s" * 16)
    with tracer.activate(remote):
        seen.append(tracer.current_context() == remote)
        seen.append(tracer.current_span() is None)
        with tracer.span("served"):
            pass
    with tracer.activate(None):
        seen.append(tracer.current_context() is None)
    with pytest.raises(RuntimeError):
        with tracer.span("fails"):
            raise RuntimeError("boom")
    orphan = tracer.start_span("orphan", parent=remote)
    orphan.end()
    seen.append(len(tracer.ring))
    seen.append([s.name for s in tracer.spans_for_trace(root.trace_id)])
    seen.append([s.name for s in col.find(service="other")])
    seen.append(len(col.by_trace(remote.trace_id)))
    docs = [s.to_doc() for s in col.spans]
    # remote ids are the script's own: keep them visible in the docs
    return docs, seen


def test_span_nesting_remote_parents_and_errors():
    tt, jt = both()
    tdocs, tseen = script(tt)
    jdocs, jseen = script(jt)
    assert canon(tdocs) == canon(jdocs)
    assert tseen == jseen
    assert [d["name"] for d in tdocs] == [
        "child", "manual", "root", "served", "fails", "orphan"]
    assert tdocs[3]["parent_id"] == "s" * 16
    assert tdocs[4]["status"] == "error"
    assert tdocs[4]["attributes"]["error"] == "RuntimeError('boom')"


def test_inject_extract_and_annotation_round_trip():
    tt, jt = both()
    out = []
    for mod in (tt, jt):
        got = []
        assert mod.inject({"a": 1}) == {"a": 1}      # no active trace
        with mod.TRACER.span("op") as sp:
            doc = mod.inject({"a": 1})
            got.append(doc[mod.TRACE_DOC_KEY] == sp.context().to_doc())
            got.append(mod.inject({mod.TRACE_DOC_KEY: "kept"}))
            got.append(mod.current_trace_id() == sp.trace_id)
        ctx = mod.extract(doc)
        got.append(ctx == sp.context())
        got.append(mod.TRACE_DOC_KEY in doc)         # popped
        ann = sp.context().to_annotation()
        got.append(mod.TraceContext.from_annotation(ann) == sp.context())
        got.append(json.loads(ann) == sp.context().to_doc())
        for bad in (None, "", "{", "[]", '{"trace_id": 1}',
                    '{"trace_id": "a", "span_id": ""}'):
            got.append(mod.TraceContext.from_annotation(bad))
        for bad in (None, 3, {}, {"trace_id": "a"},
                    {"trace_id": "a", "span_id": 2}):
            got.append(mod.TraceContext.from_doc(bad))
            got.append(mod.extract({mod.TRACE_DOC_KEY: bad}))
        out.append(got)
    assert out[0] == out[1]
    assert tt.TRACE_ANNOTATION == jt.TRACE_ANNOTATION
    assert tt.TRACE_DOC_KEY == jt.TRACE_DOC_KEY


def test_jsonl_export_and_exporter_faults(tmp_path):
    tt, jt = both()
    out = []
    for mod in (tt, jt):
        path = tmp_path / f"{mod.__name__}.jsonl"
        tracer = mod.Tracer(service="svc")
        exporter = mod.JsonlExporter(str(path))
        tracer.add_exporter(exporter)

        class Broken:
            def export(self, span):
                raise ValueError("exporter bug")

        tracer.add_exporter(Broken())
        with tracer.span("a", attributes={"n": 1}):
            with tracer.span("b"):
                pass
        exporter.close()
        docs = [json.loads(line) for line in path.read_text().splitlines()]
        out.append((canon(docs), tracer.export_errors, exporter.errors))
        tracer.remove_exporter(exporter)
    assert out[0] == out[1]
    assert out[0][1] == 2


def test_module_conveniences_use_the_process_tracer():
    tt, jt = both()
    out = []
    for mod in (tt, jt):
        col = mod.InMemoryExporter()
        mod.TRACER.add_exporter(col)
        prev = mod.TRACER.service
        assert mod.configure(service="unit") is mod.TRACER
        with mod.span("outer"):
            with mod.activate(None):
                out_ctx = mod.current_context()
        mod.TRACER.configure(service=prev)
        out.append((canon([s.to_doc() for s in col.spans]),
                    out_ctx is not None, mod.current_span()))
    assert out[0] == out[1]
