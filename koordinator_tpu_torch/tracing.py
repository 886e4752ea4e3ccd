"""Dependency-free distributed tracing for the control plane (port of
``koordinator_tpu/tracing.py``).

The reference koordinator debugs a placement by reading five binaries'
logs; this module gives the rebuild one artifact instead: a trace.  A
``TraceContext`` (trace_id + span_id) rides RPC frame documents and
deltasync event entries exactly the way ``deadline_ms`` does — as a
plain JSON field (``TRACE_DOC_KEY``) — so a pod enqueued in one process
and reconciled in another leaves spans that share one trace_id.

Pieces:

- :class:`Span`: trace_id / span_id / parent_id, service, attributes,
  timestamped events, status.  Wall-clock start plus a perf-counter
  duration (cross-process ordering uses the wall clock; intra-span
  precision uses the monotonic one).
- :class:`Tracer`: thread-local context stack.  ``span(...)`` opens a
  child of the current span (or of an explicitly ``parent=``-ed remote
  context); ``activate(ctx)`` installs a REMOTE parent for a block —
  the server-side half of wire propagation.  Finished spans fan out to
  pluggable exporters and into a bounded ring the debug endpoints read
  (``/debug/trace/<pod>``).
- Exporters: :class:`InMemoryExporter` (tests), :class:`JsonlExporter`
  (soaks/ops; one JSON object per line, crash-safe appends).  Setting
  ``KOORD_TRACE_JSONL=<path>`` in the environment wires a JSONL
  exporter at import time, so any binary can be told to record without
  code changes (``tools/soak.sh`` SOAK_TRACE=1 uses this; pretty-print
  with ``tools/trace_dump.py``).

Everything is O(1) locks + dict ops; no sampling machinery, no
background threads.  Hot paths create spans only when a trace is
actually in flight (propagated context or an opt-in), so an untraced
50k-pod round pays one round span, not 50k.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Iterator, Mapping, Optional

#: field name a TraceContext rides under in RPC frame docs and deltasync
#: event entries (the ``deadline_ms`` pattern: plain JSON, schema-extra)
TRACE_DOC_KEY = "trace"

#: pod annotation key carrying a trace context between binaries that
#: talk through pod objects (scheduler bind -> kubelet -> koordlet
#: reconcile), the role patched annotations play in the reference
TRACE_ANNOTATION = "koordinator.sh/trace-context"


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The propagated identity: which trace, and which span to parent."""

    trace_id: str
    span_id: str

    def to_doc(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @staticmethod
    def from_doc(doc) -> Optional["TraceContext"]:
        """Lenient decode: wire peers may send garbage; a malformed
        context drops silently (tracing must never fail a request)."""
        if not isinstance(doc, dict):
            return None
        tid, sid = doc.get("trace_id"), doc.get("span_id")
        if not (isinstance(tid, str) and tid
                and isinstance(sid, str) and sid):
            return None
        return TraceContext(trace_id=tid, span_id=sid)

    def to_annotation(self) -> str:
        return json.dumps(self.to_doc(), separators=(",", ":"))

    @staticmethod
    def from_annotation(value) -> Optional["TraceContext"]:
        if not isinstance(value, str) or not value:
            return None
        try:
            return TraceContext.from_doc(json.loads(value))
        except (ValueError, TypeError):
            return None


class Span:
    """One timed operation.  Mutate only between start and end()."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "service",
                 "start_time", "_start_perf", "duration_s", "attributes",
                 "events", "status", "_tracer")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], service: str,
                 start_time: float, start_perf: float,
                 attributes: Optional[dict] = None, tracer=None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.service = service
        self.start_time = start_time
        self._start_perf = start_perf
        self.duration_s: Optional[float] = None
        self.attributes: dict = dict(attributes or {})
        self.events: list[dict] = []
        self.status = "ok"
        self._tracer = tracer

    def context(self) -> TraceContext:
        return TraceContext(trace_id=self.trace_id, span_id=self.span_id)

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value

    def set_attributes(self, attrs: Mapping) -> None:
        self.attributes.update(attrs)

    def add_event(self, name: str,
                  attributes: Optional[Mapping] = None) -> None:
        self.events.append({
            "name": name,
            "time": time.time(),
            **({"attributes": dict(attributes)} if attributes else {}),
        })

    def set_error(self, message: str) -> None:
        self.status = "error"
        self.attributes.setdefault("error", message)

    def end(self) -> None:
        """Idempotent; finishes the span and exports it."""
        if self.duration_s is not None:
            return
        self.duration_s = max(0.0, time.perf_counter() - self._start_perf)
        if self._tracer is not None:
            self._tracer._export(self)

    def to_doc(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "service": self.service,
            "start_time": self.start_time,
            "duration_s": self.duration_s,
            "status": self.status,
            "attributes": self.attributes,
            "events": self.events,
        }


class InMemoryExporter:
    """Collects finished spans (tests, interactive debugging)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.spans: list[Span] = []

    def export(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def by_trace(self, trace_id: str) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.trace_id == trace_id]

    def find(self, name: Optional[str] = None,
             service: Optional[str] = None) -> list[Span]:
        with self._lock:
            return [s for s in self.spans
                    if (name is None or s.name == name)
                    and (service is None or s.service == service)]

    def clear(self) -> None:
        with self._lock:
            self.spans = []


class JsonlExporter:
    """One JSON object per line, appended per span.  Holds ONE
    append-mode handle (exports can run under the scheduler's round
    lock — a per-span open/close syscall trio would tax exactly the
    latency tracing measures); each line is a single write() call, so
    concurrent processes sharing a file interleave by line, never
    mid-record."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._file = None
        self.errors = 0

    def export(self, span: Span) -> None:
        line = json.dumps(span.to_doc(), separators=(",", ":"),
                          default=str) + "\n"
        with self._lock:
            try:
                if self._file is None:
                    # line-buffered: every span line lands on disk at
                    # the write, so a crash loses at most the in-flight
                    # span (the crash-safety the per-span open gave)
                    self._file = open(self.path, "a", buffering=1)
                self._file.write(line)
            except (OSError, ValueError):
                # a full/readonly disk (or a handle someone closed) must
                # not fail the traced operation; retry fresh next span
                self.errors += 1
                self._close_locked()

    # koordlint: guarded-by(self._lock)
    def _close_locked(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()


class Tracer:
    """Thread-local span stack + exporter fan-out + debug ring."""

    def __init__(self, service: str = "", ring_capacity: int = 4096):
        self.service = service
        self._tls = threading.local()
        self._exporters: list = []
        self._lock = threading.Lock()
        #: bounded ring of recently finished spans — the backing store
        #: for /debug/trace/<pod> without any exporter configured
        self.ring: deque[Span] = deque(maxlen=ring_capacity)
        self.export_errors = 0

    # -- configuration -------------------------------------------------------

    def configure(self, service: Optional[str] = None) -> None:
        if service is not None:
            self.service = service

    def add_exporter(self, exporter) -> None:
        with self._lock:
            self._exporters.append(exporter)

    def remove_exporter(self, exporter) -> None:
        with self._lock:
            if exporter in self._exporters:
                self._exporters.remove(exporter)

    # -- context -------------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_span(self) -> Optional[Span]:
        for entry in reversed(self._stack()):
            if isinstance(entry, Span):
                return entry
        return None

    def current_context(self) -> Optional[TraceContext]:
        stack = self._stack()
        if not stack:
            return None
        top = stack[-1]
        return top.context() if isinstance(top, Span) else top

    @contextlib.contextmanager
    def activate(self, ctx: Optional[TraceContext]) -> Iterator[None]:
        """Install a REMOTE parent context for the block.  ``None`` is a
        no-op passthrough (the ambient context, if any, stays active) so
        call sites need no branching."""
        if ctx is None:
            yield
            return
        stack = self._stack()
        stack.append(ctx)
        try:
            yield
        finally:
            stack.pop()

    # -- spans ---------------------------------------------------------------

    def start_span(self, name: str, service: Optional[str] = None,
                   parent: Optional[TraceContext] = None,
                   attributes: Optional[dict] = None) -> Span:
        """Manual-lifecycle span (caller must end()); does NOT enter the
        thread-local stack.  ``parent=None`` uses the current context;
        no current context starts a new trace."""
        pctx = parent if parent is not None else self.current_context()
        trace_id = pctx.trace_id if pctx is not None else _new_trace_id()
        return Span(
            name=name, trace_id=trace_id, span_id=_new_span_id(),
            parent_id=pctx.span_id if pctx is not None else None,
            service=self.service if service is None else service,
            start_time=time.time(), start_perf=time.perf_counter(),
            attributes=attributes, tracer=self,
        )

    @contextlib.contextmanager
    def span(self, name: str, service: Optional[str] = None,
             parent: Optional[TraceContext] = None,
             attributes: Optional[dict] = None) -> Iterator[Span]:
        """Open a span as the current context for the block; ends and
        exports on exit.  An exception marks the span errored and
        re-raises — tracing never swallows failures."""
        sp = self.start_span(name, service=service, parent=parent,
                             attributes=attributes)
        stack = self._stack()
        stack.append(sp)
        try:
            yield sp
        except BaseException as e:
            sp.set_error(repr(e))
            raise
        finally:
            stack.pop()
            sp.end()

    def _export(self, span: Span) -> None:
        self.ring.append(span)
        with self._lock:
            exporters = list(self._exporters)
        for exporter in exporters:
            try:
                exporter.export(span)
            except Exception:  # noqa: BLE001 — an exporter bug must not
                self.export_errors += 1  # fail the traced operation

    # -- debug queries -------------------------------------------------------

    def spans_for_trace(self, trace_id: str) -> list[Span]:
        """Recently finished spans of one trace (ring-bounded), oldest
        first."""
        spans = [s for s in list(self.ring) if s.trace_id == trace_id]
        spans.sort(key=lambda s: s.start_time)
        return spans


#: the process-wide tracer.  Components default their spans' service to
#: ``TRACER.service`` (set by each binary's main via ``configure``) but
#: may override per span — which is what keeps service attribution
#: correct when tests assemble several binaries into one process.
TRACER = Tracer(service=os.environ.get("KOORD_TRACE_SERVICE", ""))

if os.environ.get("KOORD_TRACE_JSONL"):
    TRACER.add_exporter(JsonlExporter(os.environ["KOORD_TRACE_JSONL"]))


# -- module-level conveniences (the common call surface) ---------------------

def configure(service: Optional[str] = None,
              jsonl_path: Optional[str] = None) -> Tracer:
    TRACER.configure(service=service)
    if jsonl_path:
        TRACER.add_exporter(JsonlExporter(jsonl_path))
    return TRACER


def span(name: str, **kwargs):
    return TRACER.span(name, **kwargs)


def activate(ctx: Optional[TraceContext]):
    return TRACER.activate(ctx)


def current_context() -> Optional[TraceContext]:
    return TRACER.current_context()


def current_span() -> Optional[Span]:
    return TRACER.current_span()


def current_trace_id() -> Optional[str]:
    ctx = TRACER.current_context()
    return ctx.trace_id if ctx is not None else None


def inject(doc: dict) -> dict:
    """Copy-on-write inject of the current context into a frame/event
    doc under TRACE_DOC_KEY; returns ``doc`` unchanged when no trace is
    active or the doc already carries one."""
    ctx = TRACER.current_context()
    if ctx is None or TRACE_DOC_KEY in doc:
        return doc
    out = dict(doc)
    out[TRACE_DOC_KEY] = ctx.to_doc()
    return out


def extract(doc: dict) -> Optional[TraceContext]:
    """Pop + decode TRACE_DOC_KEY from a frame/event doc (mutates doc,
    mirroring how the channel pops ``deadline_ms``)."""
    return TraceContext.from_doc(doc.pop(TRACE_DOC_KEY, None))
