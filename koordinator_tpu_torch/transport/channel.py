"""Socket RPC: a threaded server with per-type handlers and a blocking
client with request correlation and reconnect-with-resync (port of
``koordinator_tpu/transport/channel.py``).

Shape mirrors the reference's hook server plumbing
(``runtimeproxy/dispatcher`` + ``nri/server.go``): the server is a
registry of handlers keyed by call type; every handler gets the decoded
(doc, arrays) and returns (doc, arrays) — errors travel as ERROR frames
and surface client-side as :class:`RpcError` (fail-open decisions belong
to the caller, matching the proxy's fail-open dispatch).

Every connection writes through a bounded outbound queue drained by a
dedicated sender thread, so a stalled peer can never block a handler or a
broadcaster — it just starts dropping (and is reaped when its socket
dies), the same backpressure posture as an apiserver watch that a slow
client falls off of.
"""

from __future__ import annotations

import os
import queue
import socket
import socketserver
import threading
from typing import Callable, Optional

import numpy as np

from koordinator_tpu_torch import tracing
from koordinator_tpu_torch.transport.wire import (
    Frame,
    FrameType,
    WireSchemaError,
    decode_payload,
    encode_payload,
    read_frame,
    validate_doc,
)

Handler = Callable[[dict, dict[str, np.ndarray]],
                   tuple[dict, dict[str, np.ndarray] | None]]

#: the connection whose frame is currently being dispatched on THIS
#: thread — handlers are (doc, arrays) -> (doc, arrays) with no
#: connection parameter, but protocol negotiation (HELLO) must stamp
#: the NEGOTIATED message protocol onto the connection so later
#: broadcasts pick the right event encoding per peer.  Dispatch workers
#: are per-connection threads, so a threadlocal is race-free.
_DISPATCH = threading.local()


def set_conn_proto(proto: int) -> None:
    """Stamp the negotiated message protocol on the connection whose
    request is currently being dispatched (no-op outside dispatch —
    e.g. a handler invoked directly in tests)."""
    conn = getattr(_DISPATCH, "conn", None)
    if conn is not None:
        conn.proto = int(proto)

#: Outbound frames buffered per connection before the peer is declared
#: stalled (poison + forced resync).  Sized to the DeltaLog retention
#: window (deltasync.DeltaLog, 4096): a burst the delta log could replay
#: WITHOUT a full-snapshot resync must not poison the wire first — with a
#: tight producer loop the sender thread drains in ~5ms GIL slices, and
#: a 1,024-event NodeMetric burst overflowed a 256-deep queue at
#: event 256, killing the watch.
#: Poison now triggers exactly when falling behind means a resync is
#: unavoidable anyway.
SEND_QUEUE_DEPTH = 4096

#: Inbound frames buffered per connection between the read loop and the
#: dispatch worker.  The reader stays eager so every frame is stamped
#: with its TRUE arrival time — a request queued behind a slow handler
#: (a 6s solve on the same connection) must burn its deadline budget
#: while it waits, not get a fresh one when the handler finally returns.
#: Bounded so a fast pusher cannot balloon memory: a full inbox blocks
#: the reader and backpressure falls back to the socket, exactly the
#: pre-split behavior (frames past the window get stamped late, which
#: only makes deadlines LENIENT, never shed-happy).
RECV_QUEUE_DEPTH = 64


class RpcError(RuntimeError):
    pass


class RpcRemoteError(RpcError):
    """The peer answered with an ERROR frame: the request was rejected
    (schema error, unknown node, ...) but the CONNECTION is healthy.
    Callers that manage connection lifecycle must not tear down a
    shared client on it — closing would kill other threads' in-flight
    calls on the same socket.

    ``doc`` is the ERROR frame's decoded document; ``resync`` is True
    when the server asks the client to re-HELLO (e.g. a state push for
    a node a restarted service no longer knows — the client's watch
    view is stale, not just this one request)."""

    def __init__(self, message: str, doc: dict | None = None):
        super().__init__(message)
        self.doc = doc or {}
        self.resync = bool(self.doc.get("resync", False))


class RpcDeadlineError(RpcRemoteError):
    """The server shed the request because its ``deadline_ms`` expired
    before the handler could run (ERROR frame with ``expired: true``)."""


class DeadlineExpired(RuntimeError):
    """Raised by a handler that found its request's deadline already
    passed (``doc['__expires_at__']``) — the channel layer answers with
    an ERROR frame carrying ``expired: true`` instead of a generic
    handler failure."""


def _recv_exact(sock: socket.socket, faults=None):
    def recv(n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            if faults is not None:
                faults.on_read()   # slow-drip read injection
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed")
            buf.extend(chunk)
        return bytes(buf)
    return recv


class _Conn:
    """One server-side connection: bounded outbound queue + sender thread."""

    def __init__(self, sock: socket.socket, faults=None):
        self.sock = sock
        self.faults = faults
        self.queue: "queue.Queue[Optional[Frame]]" = queue.Queue(
            SEND_QUEUE_DEPTH)
        self.alive = True
        self.dropped = 0
        #: negotiated message protocol for this peer (stamped by the
        #: HELLO handler via set_conn_proto); 0 = never negotiated —
        #: broadcasts treat it as a legacy peer (JSON event lists)
        self.proto = 0
        #: reorder-fault hold slot: a push pulled out of order, emitted
        #: after the next outbound frame (or on poison)
        self._held: Optional[bytes] = None
        self._sender = threading.Thread(target=self._drain, daemon=True)
        self._sender.start()

    def send(self, frame: Frame) -> None:
        """Enqueue; never blocks the caller. A full queue (stalled peer)
        drops the frame and poisons the connection so the peer resyncs on
        reconnect instead of silently missing one event."""
        if not self.alive:
            return
        try:
            self.queue.put_nowait(frame)
        except queue.Full:
            self.dropped += 1
            self.alive = False
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def close(self) -> None:
        self.alive = False
        try:
            self.queue.put_nowait(None)
        except queue.Full:
            # cannot signal the sender through a full queue — sever
            # directly; queued frames are lost, but a full queue means
            # the peer stalled (poison semantics anyway)
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            # the sender may have drained the whole backlog between our
            # Full and the shutdown, in which case it is blocked on
            # queue.get() with no poison coming — a permanently leaked
            # thread.  Retry once: either the poison lands now (queue
            # has room) and the sender exits on it, or the queue is
            # still full, meaning frames remain and the sender will hit
            # the shut-down socket's OSError on its next send and exit.
            try:
                self.queue.put_nowait(None)
            except queue.Full:
                pass

    def _drain(self) -> None:
        while True:
            frame = self.queue.get()
            if frame is None:
                # poison AFTER the backlog: already-queued frames (e.g.
                # a response to an in-flight call whose side effect
                # already applied) still reach the peer, THEN the wire
                # is severed so the peer sees EOF and its reconnect
                # logic fires — without the shutdown a stopped server's
                # connections stay half-open and `connected` never
                # flips
                try:
                    if self._held is not None:
                        self.sock.sendall(self._held)
                        self._held = None
                    self.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                return
            try:
                if not self._send_one(frame):
                    self.alive = False
                    try:
                        self.sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    return
            except OSError:
                self.alive = False
                return

    def _send_one(self, frame: Frame) -> bool:
        """Write one frame, applying any scheduled fault.  Returns False
        when the fault severed the connection (caller shuts down)."""
        data = frame.encode()
        inj = self.faults
        if inj is not None:
            action = inj.outbound_action(is_push=frame.request_id == 0)
            if action == "sever":
                return False
            if action == "truncate":
                self.sock.sendall(data[: inj.truncate_at(len(data))])
                return False
            if action == "drop":
                return True
            if action == "delay":
                inj.delay()
            elif action == "duplicate":
                self.sock.sendall(data)
            elif action == "reorder":
                if self._held is None:
                    self._held = data      # emit after the NEXT frame
                    return True
        self.sock.sendall(data)
        if self._held is not None:
            held, self._held = self._held, None
            self.sock.sendall(held)
        return True


class _ConnHandler(socketserver.BaseRequestHandler):
    """Per-connection: an EAGER read loop (this thread) feeding a
    bounded inbox consumed by one dispatch worker.  The split exists for
    deadline honesty: handlers are sequential per connection, so a
    request read lazily after a 6s solve would be stamped 6s late and
    granted a fresh budget its caller already burned.  The eager reader
    stamps true arrival; the worker keeps the sequential handler
    semantics."""

    def handle(self):
        import time as _time

        server: RpcServer = self.server.rpc  # type: ignore[attr-defined]
        if server.kind == "tcp":
            # a reply and a push often leave back to back: with Nagle on,
            # the second waits for the peer's delayed ACK (~40 ms a call)
            self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        recv = _recv_exact(self.request, faults=server.faults)
        conn = _Conn(self.request, faults=server.faults)
        server._on_connect(conn)
        inbox: "queue.Queue[Optional[tuple[Frame, float]]]" = queue.Queue(
            RECV_QUEUE_DEPTH)
        worker = threading.Thread(
            target=_dispatch_loop, args=(server, conn, inbox), daemon=True)
        worker.start()
        try:
            while True:
                try:
                    frame = read_frame(recv)
                except (ConnectionError, OSError):
                    return
                if frame.type is FrameType.PING:
                    # liveness probes answer at read time — a heartbeat
                    # must not queue behind a long solve
                    conn.send(Frame(FrameType.ACK, frame.request_id,
                                    encode_payload({})))
                    continue
                inbox.put((frame, _time.monotonic()))
        finally:
            # poison AFTER the backlog (blocking put: the worker is
            # draining); already-read frames still run their handlers —
            # their side effects (state pushes) are the peer's committed
            # intent — but responses to a gone peer drop in conn.send
            inbox.put(None)
            # bounded join: the worker may sit in a long handler; the
            # connection teardown must not wait it out (the worker exits
            # on the poison right after, sends going to a dead conn)
            worker.join(timeout=5.0)
            server._on_disconnect(conn)
            conn.close()


def _dispatch_loop(server: "RpcServer", conn: _Conn, inbox) -> None:
    while True:
        item = inbox.get()
        if item is None:
            return
        frame, recv_time = item
        _dispatch_one(server, conn, frame, recv_time)


def _dispatch_one(server: "RpcServer", conn: _Conn, frame: Frame,
                  recv_time: float) -> None:
    import time as _time

    from koordinator_tpu_torch import metrics

    handler = server.handlers.get(frame.type)
    if handler is None:
        conn.send(Frame(FrameType.ERROR, frame.request_id,
                        encode_payload(
                            {"message": f"no handler for {frame.type}"})))
        return
    try:
        doc, arrays = decode_payload(frame.payload)
        # typed request schemas: version/shape skew between
        # peers fails loud here, not deep inside a handler
        validate_doc(frame.type, doc)
        # deadline propagation: the caller's remaining budget rides the
        # doc; the budget clock starts at frame ARRIVAL (the eager read
        # loop's stamp — no cross-host clock sync needed).  Expired
        # already -> shed without dispatching; otherwise the absolute
        # expiry is handed to the handler so long waits INSIDE it (the
        # scheduler round lock) can shed late too (DeadlineExpired).
        deadline_ms = doc.pop("deadline_ms", None)
        if deadline_ms is not None:
            expires = recv_time + float(deadline_ms) / 1000.0
            if _time.monotonic() >= expires:
                metrics.rpc_deadline_shed_total.inc(
                    labels={"type": frame.type.name})
                conn.send(Frame(
                    FrameType.ERROR, frame.request_id,
                    encode_payload(
                        {"message": "deadline expired before "
                         "dispatch", "expired": True})))
                return
            doc["__expires_at__"] = expires
        # trace propagation: a caller's TraceContext rides the doc like
        # deadline_ms; a traced request gets a server-side dispatch span
        # (joined to the caller's trace), untraced requests pay one dict
        # lookup and no span
        tctx = tracing.extract(doc)
        _DISPATCH.conn = conn
        try:
            if tctx is not None:
                with tracing.TRACER.span(
                        f"rpc.{frame.type.name}",
                        service=server.service or None, parent=tctx):
                    out_doc, out_arrays = handler(doc, arrays)
            else:
                out_doc, out_arrays = handler(doc, arrays)
        finally:
            _DISPATCH.conn = None
        rtype = FrameType(out_doc.pop(
            "__type__", int(_RESPONSE_TYPE.get(
                frame.type, FrameType.ACK))))
        conn.send(Frame(rtype, frame.request_id,
                        encode_payload(out_doc, out_arrays)))
    except DeadlineExpired as e:
        conn.send(Frame(FrameType.ERROR, frame.request_id,
                        encode_payload(
                            {"message": str(e), "expired": True})))
    except WireSchemaError as e:
        err_doc = {"message": str(e), "schema": True}
        if getattr(e, "resync", False):
            # the client's whole watch view is stale (e.g. a push for a
            # node this service incarnation never learned) — tell it to
            # re-HELLO, not just fail the one call
            err_doc["resync"] = True
        conn.send(Frame(FrameType.ERROR, frame.request_id,
                        encode_payload(err_doc)))
    except Exception as e:  # handler bug: fail the call, not conn
        conn.send(Frame(FrameType.ERROR, frame.request_id,
                        encode_payload({"message": repr(e)})))


_RESPONSE_TYPE = {
    FrameType.HELLO: FrameType.SNAPSHOT,
    FrameType.SOLVE_REQUEST: FrameType.SOLVE_RESPONSE,
    FrameType.HOOK_REQUEST: FrameType.HOOK_RESPONSE,
}


class _UnixServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True


class _TcpServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


def _parse_addr(addr: str):
    """"tcp://host:port" -> ("tcp", (host, port)); anything else is a
    unix-socket path.  IPv4 / hostnames only — an IPv6 literal would need
    AF_INET6 plumbing the transport doesn't have, so reject it loudly
    instead of failing later with an opaque gaierror."""
    if addr.startswith("tcp://"):
        host, _, port = addr[len("tcp://"):].rpartition(":")
        if "[" in host or "]" in host:
            raise ValueError(
                f"IPv6 literals are not supported by the framed "
                f"transport: {addr!r}")
        return "tcp", (host or "127.0.0.1", int(port))
    return "unix", addr


class RpcServer:
    """Framed RPC server; per connection, one eager receive thread, one
    sequential dispatch worker, and one send thread.  ``path`` is a
    unix-socket path (same-host peers) or ``tcp://host:port``
    (cross-host control plane — the reference's gRPC boundary listens
    on TCP the same way)."""

    def __init__(self, path: str, faults=None, service: str = ""):
        self.path = path
        #: optional faults.FaultInjector — chaos harness only; None in
        #: production (one attribute check per frame)
        self.faults = faults
        #: service name stamped on traced-request dispatch spans so a
        #: multi-binary test process still attributes spans to the right
        #: component; empty falls back to the process tracer's service
        self.service = service
        self.kind, target = _parse_addr(path)
        self.handlers: dict[FrameType, Handler] = {}
        self._conns: list[_Conn] = []
        self._conn_lock = threading.Lock()
        self._stopped = False
        if self.kind == "unix":
            if os.path.exists(target):
                os.unlink(target)
            self._server = _UnixServer(target, _ConnHandler)
        else:
            self._server = _TcpServer(target, _ConnHandler)
        self._server.rpc = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        """Resolved listen address (useful with tcp://host:0)."""
        if self.kind == "unix":
            return self.path
        host, port = self._server.server_address[:2]
        return f"tcp://{host}:{port}"

    def register(self, ftype: FrameType, handler: Handler) -> None:
        self.handlers[ftype] = handler

    def start(self) -> None:
        # tight poll interval: shutdown() blocks until serve_forever's
        # select loop notices, and the 0.5s stdlib default turns every
        # stop() — a restart, a failover, a test teardown — into a
        # half-second stall
        self._thread = threading.Thread(
            target=lambda: self._server.serve_forever(poll_interval=0.05),
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        # flag first: a connection whose handler thread registers AFTER
        # the conns snapshot below would otherwise never be closed and
        # its peer would hang on a half-dead socket (race exposed by the
        # tight poll interval — stop() used to be slow enough to lose it)
        with self._conn_lock:
            self._stopped = True
        self._server.shutdown()
        self._server.server_close()
        with self._conn_lock:
            conns = list(self._conns)
        for conn in conns:
            conn.close()
        if self.kind == "unix" and os.path.exists(self.path):
            os.unlink(self.path)

    # -- server push (watch-stream analog) ----------------------------------

    def _on_connect(self, conn: _Conn) -> None:
        with self._conn_lock:
            if self._stopped:
                # lost the race with stop(): sever immediately so the
                # peer sees EOF instead of a silently dead server
                conn.close()
                return
            self._conns.append(conn)

    def _on_disconnect(self, conn: _Conn) -> None:
        with self._conn_lock:
            if conn in self._conns:
                self._conns.remove(conn)

    def broadcast(self, ftype: FrameType, doc: dict,
                  arrays: dict[str, np.ndarray] | None = None,
                  min_proto: int = 0, legacy=None) -> int:
        """Push a frame (request_id 0 = unsolicited) to all live
        connections — the informer watch-event fan-out. Never blocks:
        frames go through each connection's bounded queue.

        Mixed-version fan-out: when ``min_proto`` > 0, only peers that
        negotiated at least that message protocol get the primary
        payload; older peers (including never-HELLO'd ones at proto 0)
        get the ``legacy`` payload instead — a zero-arg callable
        returning ``(doc, arrays)``, encoded LAZILY so an all-v2 fleet
        never pays the v1 encode.  ``legacy=None`` with ``min_proto``
        set skips old peers entirely (their resync machinery recovers)."""
        frame: Optional[Frame] = None
        legacy_frame: Optional[Frame] = None
        with self._conn_lock:
            conns = list(self._conns)
        sent = 0
        for conn in conns:
            if not conn.alive:
                continue
            if min_proto and conn.proto < min_proto:
                if legacy is None:
                    continue
                if legacy_frame is None:
                    ldoc, larrays = legacy()
                    legacy_frame = Frame(
                        ftype, 0, encode_payload(ldoc, larrays))
                conn.send(legacy_frame)
            else:
                if frame is None:
                    frame = Frame(ftype, 0, encode_payload(doc, arrays))
                conn.send(frame)
            sent += 1
        return sent


class RpcClient:
    """Blocking request/response client. Unsolicited (request_id 0) frames
    are delivered to ``on_push`` — the watch stream."""

    def __init__(self, path: str, on_push=None, timeout: float = 10.0,
                 faults=None, fault_domain: str = ""):
        self.path = path
        self.on_push = on_push
        self.timeout = timeout
        self.faults = faults
        #: correlated-fault domain tag (e.g. "rack:r1") — a storm over
        #: the domain refuses this client's connects, severs or blocks
        #: its calls (faults.FaultInjector storm modes); empty = the
        #: connection sits outside the modeled topology
        self.fault_domain = fault_domain
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._pending: dict[int, "_Waiter"] = {}
        self._pending_lock = threading.Lock()
        self._next_id = 1
        self._reader: Optional[threading.Thread] = None
        self.connected = False
        self.push_errors = 0

    def connect(self) -> None:
        if self.faults is not None:
            if self.fault_domain:
                self.faults.on_connect(self.fault_domain)
            else:
                self.faults.on_connect()
        kind, target = _parse_addr(self.path)
        if kind == "unix":
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(self.timeout)
            sock.connect(target)
            sock.settimeout(None)
        else:
            # bound by the client timeout: a black-holed TCP target must
            # fail in self.timeout, not the OS connect default (~2 min)
            sock = socket.create_connection(target, timeout=self.timeout)
            sock.settimeout(None)   # reader thread blocks indefinitely
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self.connected = True
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()
        if self.faults is not None and self.fault_domain:
            register = getattr(self.faults, "register_conn", None)
            if register is not None:
                register(self.fault_domain, self._sever_for_fault)

    def _sever_for_fault(self) -> None:
        """Storm sever: shut the socket down so the reader sees EOF and
        in-flight calls fail fast; the fd itself is released by the
        owner's close() (reconnect machinery)."""
        self.connected = False
        sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def close(self) -> None:
        if self.faults is not None and self.fault_domain:
            unregister = getattr(self.faults, "unregister_conn", None)
            if unregister is not None:
                unregister(self.fault_domain, self._sever_for_fault)
        self.connected = False
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()
            self._sock = None
        # join the reader (bounded) so long soaks with repeated
        # reconnects don't accumulate daemon threads; skip when close()
        # runs ON the reader (a push handler tearing the stream down)
        reader = self._reader
        if reader is not None and reader is not threading.current_thread():
            reader.join(timeout=2.0)
            if not reader.is_alive():
                self._reader = None

    def _read_loop(self) -> None:
        sock = self._sock
        assert sock is not None
        recv = _recv_exact(sock, faults=self.faults)
        try:
            while True:
                frame = read_frame(recv)
                if frame.request_id == 0:
                    if self.on_push is not None:
                        try:
                            self.on_push(frame)
                        except Exception:
                            # a bad push must not kill the stream: later
                            # frames still correlate calls and pushes
                            self.push_errors += 1
                    continue
                with self._pending_lock:
                    waiter = self._pending.pop(frame.request_id, None)
                if waiter is not None:
                    waiter.frame = frame
                    waiter.event.set()
        except (ConnectionError, OSError):
            pass
        finally:
            self.connected = False
            with self._pending_lock:
                waiters = list(self._pending.values())
                self._pending.clear()
            for w in waiters:
                w.event.set()  # fail fast with frame=None

    def call(self, ftype: FrameType, doc: dict,
             arrays: dict[str, np.ndarray] | None = None,
             deadline_ms: float | None = None,
             ) -> tuple[FrameType, dict, dict[str, np.ndarray]]:
        sock = self._sock
        if sock is None:
            raise RpcError("not connected")
        if not self.connected:
            # the reader thread died (peer EOF / transport error): fail
            # fast instead of sending into a half-closed socket and
            # burning the full timeout waiting for a response that can
            # never correlate
            raise RpcError("not connected (stream closed)")
        if self.faults is not None and self.fault_domain:
            action = self.faults.outbound_domain(self.fault_domain)
            if action == "block":
                # asym_send storm: the call fails but the stream stays —
                # inbound pushes keep arriving (asymmetric partition)
                raise RpcError(
                    f"fault injection: domain {self.fault_domain!r} "
                    f"outbound blocked")
            if action == "sever":
                self._sever_for_fault()
                raise RpcError(
                    f"connection lost: domain {self.fault_domain!r} "
                    f"partitioned")
        if deadline_ms is not None:
            # per-call deadline rides the frame doc so the server can
            # shed the request once nobody is waiting for it
            doc = dict(doc, deadline_ms=float(deadline_ms))
        # active trace context rides the doc the same way (copy-on-write
        # no-op when nothing is traced)
        doc = tracing.inject(doc)
        waiter = _Waiter()
        with self._pending_lock:
            req_id = self._next_id
            self._next_id += 1
            self._pending[req_id] = waiter
        frame = Frame(ftype, req_id, encode_payload(doc, arrays))
        try:
            with self._send_lock:
                data = frame.encode()
                cut = (self.faults.outbound_cut(len(data))
                       if self.faults is not None else None)
                if cut is not None:
                    # injected mid-write truncation: the peer's framing
                    # is desynced — sever so both sides fail loud
                    sock.sendall(data[:cut])
                    raise OSError("fault injection: truncated write")
                sock.sendall(data)
        except OSError as e:
            self.connected = False
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            with self._pending_lock:
                self._pending.pop(req_id, None)
            raise RpcError(f"connection lost: {e}") from e
        wait = self.timeout
        if deadline_ms is not None:
            wait = min(wait, float(deadline_ms) / 1000.0)
        if not waiter.event.wait(wait):
            with self._pending_lock:
                self._pending.pop(req_id, None)
            if deadline_ms is not None and wait < self.timeout:
                # the CALLER'S budget ran out, not the transport: the
                # connection is healthy and the server may still answer
                # (the stale response is dropped by the waiter map).
                # RpcDeadlineError subclasses RpcRemoteError so shared-
                # connection owners (ReconnectingSidecarClient) pass it
                # through instead of tearing the client down and killing
                # other threads' in-flight calls.
                raise RpcDeadlineError(
                    f"deadline ({deadline_ms:g}ms) expired awaiting "
                    f"response")
            raise RpcError("rpc timeout")
        if waiter.frame is None:
            raise RpcError("connection lost")
        rdoc, rarrays = decode_payload(waiter.frame.payload)
        if waiter.frame.type is FrameType.ERROR:
            cls = (RpcDeadlineError if rdoc.get("expired")
                   else RpcRemoteError)
            raise cls(rdoc.get("message", "remote error"), doc=rdoc)
        return waiter.frame.type, rdoc, rarrays


class _Waiter:
    def __init__(self):
        self.event = threading.Event()
        self.frame: Optional[Frame] = None
