"""Parity of the port's wire (``koordinator_tpu_torch/transport/wire.py``
and the event codecs of ``deltasync.py``) with the JAX package's, byte for
byte.

For seeded documents and arrays (small ones, and ones past the zero-copy
threshold) the two ``encode_payload`` give the same bytes, and so do the
two ``Frame.encode``; each package's ``decode_payload`` reads the other's
bytes to equal documents and arrays.  For every event kind the same
mutations on each package's ``StateSyncService`` give delta logs and
snapshots whose v1 and v2 (columnar) packings encode to the same bytes,
and each package's ``_decode_events`` reads the other's to the same
entries.  The cases of ``tests/test_wire_v2.py`` that concern the port's
modules (the request schemas, a pre-negotiation HELLO, state-push
validation and the no-partial-commit property) run as the cases of one
test on both packages; its lease cases need the JAX package's ``ha``
module, which the port has not copied.  The garbage streams of
``tests/test_wire_fuzz.py`` run against a port ``RpcServer`` as the cases
of another.
"""

import socket
import struct

import numpy as np
import pytest

from koordinator_tpu.transport import deltasync as jds
from koordinator_tpu.transport import wire as jwire

from koordinator_tpu_torch.transport import deltasync as tds
from koordinator_tpu_torch.transport import wire as twire

from tests.torch_parity import R, reset_observability, set_torch_threads

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh_observability():
    reset_observability()
    yield
    reset_observability()


DTYPES = (np.int32, np.int64, np.uint8, np.float32, np.float64, np.bool_,
          np.int16)


def seeded_payload(seed: int):
    """A JSON document (nested, unicode, numbers) and named arrays: a few
    small ones, and with odd seeds one past ZERO_COPY_MIN_BYTES."""
    rng = np.random.default_rng(seed)
    doc = {"kind": f"k{seed}", "rv": int(rng.integers(0, 2**40)),
           "names": [f"pod-{i}-é" for i in range(int(rng.integers(0, 5)))],
           "nested": {"a": [1, 2.5, None, True], "b": {"c": "x"}},
           "ratio": float(rng.random())}
    arrays = {}
    for i in range(int(rng.integers(0, 5))):
        dtype = DTYPES[int(rng.integers(0, len(DTYPES)))]
        shape = tuple(int(s) for s in rng.integers(0, 6, int(
            rng.integers(0, 3))))
        arrays[f"a{i}"] = (rng.integers(-100, 100, shape) if shape
                           else rng.integers(-100, 100)).astype(dtype)
    if seed % 2:
        arrays["big"] = rng.integers(0, 2**31, (20_000, R)).astype(np.int32)
    return doc, arrays


def assert_same_arrays(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert a[key].shape == b[key].shape, key
        assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("seed", range(8))
def test_payload_and_frame_bytes_equal(seed):
    doc, arrays = seeded_payload(seed)
    want = jwire.encode_payload(doc, arrays)
    got = twire.encode_payload(doc, arrays)
    assert got == want
    for ftype in twire.FrameType:
        jframe = jwire.Frame(jwire.FrameType(int(ftype)), seed + 7, want)
        tframe = twire.Frame(ftype, seed + 7, got)
        assert tframe.encode() == jframe.encode()
    # each package reads the other's bytes as it reads its own (a 0-d
    # array comes back with shape (1,) from both)
    ref_doc, ref_arrays = jwire.decode_payload(want)
    for decode, payload in ((twire.decode_payload, want),
                            (jwire.decode_payload, got)):
        out_doc, out_arrays = decode(payload)
        assert out_doc == ref_doc == doc
        assert_same_arrays(out_arrays, ref_arrays)
        for key, arr in arrays.items():
            assert np.array_equal(out_arrays[key].reshape(arr.shape), arr)
    # the frame header read back through both readers
    for read, frame in ((twire.read_frame, jwire.Frame(
            jwire.FrameType.DELTA, 3, want)), (jwire.read_frame, twire.Frame(
            twire.FrameType.DELTA, 3, got))):
        raw = frame.encode()
        pos = [0]

        def recv(n, raw=raw):
            out = raw[pos[0]:pos[0] + n]
            pos[0] += n
            return out

        back = read(recv)
        assert int(back.type) == int(twire.FrameType.DELTA)
        assert back.request_id == 3 and back.payload == want


def test_constants_equal():
    for name in ("MAGIC", "VERSION", "PROTOCOL_VERSION",
                 "MIN_PROTOCOL_VERSION", "MAX_PAYLOAD",
                 "ZERO_COPY_MIN_BYTES", "ZERO_COPY_MIN_SHARE",
                 "STATE_PUSH_ARRAY_KEYS"):
        assert getattr(twire, name) == getattr(jwire, name), name
    assert twire.PROTOCOL_VERSION == 4 and twire.MIN_PROTOCOL_VERSION == 3
    assert ({f.name: int(f) for f in twire.FrameType}
            == {f.name: int(f) for f in jwire.FrameType})
    assert ({f.name: s for f, s in twire.REQUEST_SCHEMAS.items()}
            == {f.name: s for f, s in jwire.REQUEST_SCHEMAS.items()})
    assert tds._KIND_CODES == jds._KIND_CODES
    assert tds._V2_DEFAULTS == jds._V2_DEFAULTS


@pytest.mark.parametrize("seed", range(4))
def test_string_columns_equal(seed):
    rng = np.random.default_rng(seed)
    values = ["".join(chr(int(c)) for c in rng.integers(32, 0x2FF, int(n)))
              for n in rng.integers(0, 12, int(rng.integers(0, 30)))]
    jl, jb = jwire.pack_str_column(values)
    tl, tb = twire.pack_str_column(values)
    assert_same_arrays({"l": tl, "b": tb}, {"l": jl, "b": jb})
    assert twire.unpack_str_column(jl, jb) == values
    assert jwire.unpack_str_column(tl, tb) == values


def vec(rng, hi=64_000):
    return rng.integers(0, hi, R).astype(np.int32)


def drive(service, kind: str, rng) -> None:
    """The same mutations on either package's StateSyncService; ``kind``
    names the event kind the case ends on (``mixed``: every kind)."""
    nrt = {"node.koordinator.sh/cpu-topology":
           '{"detail": [{"core": 0, "node": 0, "socket": 0, "id": 0}]}'}
    devices = {"gpu": [{"core": 100, "memory": 1 << 14, "group": 0}] * 2}
    service.upsert_node("n0", vec(rng), usage=vec(rng, 1_000),
                        labels={"zone": "a"}, taints={"dedicated": "x"},
                        annotations=nrt, devices=devices)
    service.upsert_node("n1", vec(rng))
    service.add_pod("p0", vec(rng, 4_000), priority=7, quota="q",
                    gang="g", node_selector={"zone": "a"},
                    labels={"app": "w"}, owner="rs/x", qos=3,
                    arrival_ts=12.5)
    service.add_pod("p1", vec(rng, 4_000))
    service.upsert_reservation(
        "r0", vec(rng, 8_000).astype(np.int64),
        owners=[{"labels": {"app": "w"}}, {"controller": "rs/x"}],
        allocate_once=True, ttl_sec=30.0, node="n0",
        node_selector={"zone": "a"}, tolerations={"dedicated": "x"},
        restricted=True)
    if kind in ("node_usage", "mixed"):
        service.update_node_usage("n0", vec(rng, 1_000),
                                  agg_usage=vec(rng, 1_000),
                                  prod_usage=vec(rng, 1_000),
                                  sys_usage=vec(rng, 100),
                                  hp_usage=vec(rng, 100))
        service.update_node_usage("n1", vec(rng, 1_000))
    if kind in ("node_alloc", "mixed"):
        service.update_node_allocatable("n1", vec(rng))
    if kind in ("node_devices", "mixed"):
        service.update_node_devices(
            "n1", {"xpu": [{"core": 50, "memory": 1 << 9, "group": 1}]})
    if kind in ("pod_remove", "mixed"):
        service.remove_pod("p1")
    if kind in ("rsv_remove", "mixed"):
        service.remove_reservation("r0")
    if kind in ("node_remove", "mixed"):
        service.remove_node("n1")


KINDS = ("node_upsert", "node_usage", "node_alloc", "node_devices",
         "node_remove", "pod_add", "pod_remove", "rsv_upsert", "rsv_remove",
         "mixed")


@pytest.mark.parametrize("kind", KINDS)
def test_event_packing_bytes_equal(kind):
    services = (jds.StateSyncService(), tds.StateSyncService())
    for service in services:
        drive(service, kind, np.random.default_rng(len(kind)))
    jsvc, tsvc = services
    assert jsvc.rv == tsvc.rv
    cases = [("log", jsvc.log.since(0), tsvc.log.since(0))]
    jsnap_events = [(jsvc.rv, e["doc"], e["arrays"]) for e in (
        list(jsvc.nodes.values()) + list(jsvc.reservations.values())
        + list(jsvc.pods.values()))]
    tsnap_events = [(tsvc.rv, e["doc"], e["arrays"]) for e in (
        list(tsvc.nodes.values()) + list(tsvc.reservations.values())
        + list(tsvc.pods.values()))]
    cases.append(("snapshot", jsnap_events, tsnap_events))
    for label, jev, tev in cases:
        for jpack, tpack in ((jds._pack_events, tds._pack_events),
                             (jds._pack_events_v2, tds._pack_events_v2)):
            jdoc, jarr = jpack(jev)
            tdoc, tarr = tpack(tev)
            want = jwire.encode_payload(jdoc, jarr)
            got = twire.encode_payload(tdoc, tarr)
            assert got == want, (label, jpack.__name__)
            # cross decode: each package's reader on the other's bytes
            jentries = jds._decode_events(*jwire.decode_payload(got))
            tentries = tds._decode_events(*twire.decode_payload(want))
            assert jentries == tentries
            d, a = twire.decode_payload(want)
            for entry in tds._decode_events(d, a):
                tds._unpack_event_arrays(entry, a)
    # the snapshot documents as the HELLO handler builds them
    jdoc, jarr = jsvc._snapshot(jds._pack_events_v2)
    tdoc, tarr = tsvc._snapshot(tds._pack_events_v2)
    assert (twire.encode_payload(tdoc, tarr)
            == jwire.encode_payload(jdoc, jarr))


# -- tests/test_wire_v2.py's cases --------------------------------------------


def _schema_outcome(wire_mod, ftype_name: str, doc: dict):
    try:
        wire_mod.validate_doc(wire_mod.FrameType[ftype_name], doc)
    except wire_mod.WireSchemaError as e:
        return "error", str(e)
    return "ok", None


SCHEMA_CASES = {
    "missing_required_field": ("HELLO", {"proto": 4}, "last_rv"),
    "wrong_type": ("LEASE_GET", {"name": 7}, "name"),
    "bool_not_int": ("HELLO", {"last_rv": True, "proto": 4}, "bool"),
    "extra_fields": ("HELLO", {"last_rv": 3, "proto": 4, "future": "f"},
                     None),
    "unschemad_type": ("DELTA", {"anything": object()}, None),
}


def _push_server(mod, tmp_path, name):
    from importlib import import_module

    channel = import_module(mod.__name__.rsplit(".", 1)[0] + ".channel")
    server = channel.RpcServer(str(tmp_path / name))
    service = mod.StateSyncService()
    service.attach(server)
    server.start()
    return channel, server, service


def _old_protocol_hello(tmp_path):
    for mod, name in ((tds, "t.sock"), (jds, "j.sock")):
        channel, server, _ = _push_server(mod, tmp_path, name)
        client = channel.RpcClient(server.path)
        client.connect()
        try:
            with pytest.raises(channel.RpcError, match="proto"):
                client.call(twire.FrameType.HELLO, {"last_rv": -1})
            with pytest.raises(channel.RpcError, match="incompatible"):
                client.call(twire.FrameType.HELLO,
                            {"last_rv": -1, "proto": 99})
        finally:
            client.close()
            server.stop()


def _push_validation(tmp_path):
    outcomes = []
    for mod, name in ((tds, "pt.sock"), (jds, "pj.sock")):
        channel, server, service = _push_server(mod, tmp_path, name)
        client = channel.RpcClient(server.path)
        client.connect()
        got = []
        try:
            for bad in (np.zeros(3, np.int32), np.zeros((2, R), np.int32),
                        np.zeros(R, np.float32)):
                with pytest.raises(channel.RpcError) as e:
                    client.call(twire.FrameType.STATE_PUSH,
                                {"kind": "node_upsert", "name": "bad"},
                                {"allocatable": bad})
                got.append(str(e.value))
            assert service.rv == 0 and not service.nodes
            with pytest.raises(channel.RpcError, match="labels") as e:
                client.call(twire.FrameType.STATE_PUSH,
                            {"kind": "rsv_upsert", "name": "r1",
                             "owners": [{"labels": "xyz"}]},
                            {"requests": np.zeros(R, np.int32)})
            got.append(str(e.value))
            with pytest.raises(channel.RpcError, match="core") as e:
                client.call(twire.FrameType.STATE_PUSH,
                            {"kind": "node_upsert", "name": "n1",
                             "devices": {"gpu": [{"core": "many"}]}},
                            {"allocatable": np.zeros(R, np.int32)})
            got.append(str(e.value))
            assert service.rv == 0 and not service.nodes
            _, doc, _ = client.call(
                twire.FrameType.STATE_PUSH,
                {"kind": "node_upsert", "name": "good"},
                {"allocatable": np.zeros(R, np.int32)})
            assert doc["rv"] == 1 and "good" in service.nodes
        finally:
            client.close()
            server.stop()
        outcomes.append(got)
    assert outcomes[0] == outcomes[1]


def _no_partial_commit(tmp_path):
    """The property of ``TestStatePushNoPartialCommit`` on the port, with
    the JAX service given each document beside it: both reject it, or
    both commit it with the same rv and the same snapshot bytes; every
    committed event replays into a port SchedulerBinding."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    from koordinator_tpu_torch.scheduler.scheduler import Scheduler
    from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot

    replay = tds.SchedulerBinding(Scheduler(
        ClusterSnapshot(capacity=16, device="cpu"), device="cpu"))
    json_scalars = st.one_of(
        st.none(), st.booleans(), st.integers(-2**40, 2**40),
        st.text(max_size=8))
    labels = json_scalars | st.dictionaries(
        st.text(max_size=4), st.text(max_size=4), max_size=2)
    docs = st.fixed_dictionaries(
        {"kind": st.sampled_from(
            ["node_upsert", "node_usage", "pod_add", "pod_remove",
             "rsv_upsert", "rsv_remove", "bogus"]),
         "name": st.text(min_size=1, max_size=8)},
        optional={
            "labels": labels,
            "owners": json_scalars | st.lists(
                json_scalars | st.fixed_dictionaries(
                    {}, optional={"labels": labels,
                                  "controller": json_scalars}),
                max_size=2),
            "devices": json_scalars | st.dictionaries(
                st.text(max_size=4),
                st.lists(json_scalars | st.fixed_dictionaries(
                    {}, optional={"core": json_scalars,
                                  "memory": json_scalars}),
                         max_size=2),
                max_size=2),
            "priority": json_scalars,
            "ttl_sec": json_scalars,
        })
    arrays = st.dictionaries(
        st.sampled_from(["allocatable", "usage", "requests"]),
        st.sampled_from([np.zeros(R, np.int32), np.zeros(R - 1, np.int32),
                         np.zeros((2, R), np.int32),
                         np.zeros(R, np.float32),
                         np.full(R, 2**40, np.int64)]),
        max_size=2)

    @settings(max_examples=150, deadline=None)
    @given(doc=docs, arrs=arrays)
    def check(doc, arrs):
        outs = []
        for mod, wmod in ((tds, twire), (jds, jwire)):
            service = mod.StateSyncService()
            before = (service.rv, dict(service.nodes), dict(service.pods),
                      dict(service.reservations))
            try:
                out, _ = service._handle_state_push(dict(doc), dict(arrs))
            except wmod.WireSchemaError as e:
                assert (service.rv, dict(service.nodes), dict(service.pods),
                        dict(service.reservations)) == before
                outs.append(("rejected", str(e)))
                continue
            assert out["rv"] == before[0] + 1
            snap, snap_arrays = service._snapshot()
            outs.append(("committed", wmod.encode_payload(snap,
                                                          snap_arrays)))
            if mod is tds:
                for entry in snap["events"]:
                    tds._dispatch_event(
                        replay, entry,
                        tds._unpack_event_arrays(entry, snap_arrays))
        assert outs[0] == outs[1], doc

    check()


WIRE_V2_CASES = {
    **{f"schema_{name}": name for name in SCHEMA_CASES},
    "old_protocol_hello_rejected": _old_protocol_hello,
    "state_push_wrong_shape_and_dtype_rejected": _push_validation,
    "state_push_no_partial_commit": _no_partial_commit,
}


@pytest.mark.parametrize("case", list(WIRE_V2_CASES))
def test_wire_v2_case(case, tmp_path):
    target = WIRE_V2_CASES[case]
    if isinstance(target, str):
        ftype, doc, needle = SCHEMA_CASES[target]
        got = _schema_outcome(twire, ftype, doc)
        assert got == _schema_outcome(jwire, ftype, doc)
        if needle is None:
            assert got == ("ok", None)
        else:
            assert got[0] == "error" and needle in got[1]
        return
    target(tmp_path)


# -- tests/test_wire_fuzz.py's cases ------------------------------------------


def _header(magic=twire.MAGIC, version=twire.VERSION, ftype=10, req_id=1,
            length=0):
    return struct.pack("<HBBII", magic, version, ftype, req_id, length)


GARBAGE = [
    b"",
    b"\x00" * 64,
    b"GET / HTTP/1.1\r\n\r\n",
    _header(magic=0xDEAD),
    _header(version=99),
    _header(ftype=250, length=4) + b"\x00" * 4,
    _header(length=2 ** 31 - 1),
    _header(ftype=10, length=8) + b"\xff" * 8,
    _header(ftype=10, length=6) + struct.pack("<I", 400) + b"xx",
    (lambda body: _header(ftype=1, length=len(body)) + body)(
        struct.pack("<I", 76)
        + b'{"last_rv":-1,"proto":3,"__arrays__":[{"key":"a","dtype":"<i4",'
          b'"shape":[64],"offset":9999,"nbytes":256}]}'),
    _header(ftype=10, length=100) + b"short",
]


def _raw_conn(server) -> socket.socket:
    host, port = server.address[len("tcp://"):].rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=5)
    # a partial frame leaves the server waiting for more bytes: the drain
    # gives up after a second (only the server's survival is checked)
    s.settimeout(1)
    return s


def _drain(sock) -> None:
    try:
        while sock.recv(4096):
            pass
    except OSError:
        pass


def _send_garbage(server, blob: bytes) -> None:
    s = _raw_conn(server)
    try:
        if blob:
            s.sendall(blob)
        _drain(s)
    finally:
        s.close()


def _ping(client) -> None:
    ftype, _, _ = client.call(twire.FrameType.PING, {})
    assert ftype is twire.FrameType.ACK


@pytest.mark.parametrize("case", [f"blob_{i}" for i in range(len(GARBAGE))]
                         + ["others_untouched"])
def test_wire_fuzz_case(case):
    """A garbage peer costs only its own connection: the port's server
    survives every blob, and a fresh client (for ``others_untouched``, a
    client connected through all the abuse) still completes a call."""
    from koordinator_tpu_torch.transport.channel import RpcClient, RpcServer

    server = RpcServer("tcp://127.0.0.1:0")
    server.start()
    client = None
    try:
        if case == "others_untouched":
            client = RpcClient(server.address, timeout=10.0)
            client.connect()
            for blob in GARBAGE:
                _send_garbage(server, blob)
                _ping(client)
            return
        _send_garbage(server, GARBAGE[int(case.split("_")[1])])
        client = RpcClient(server.address, timeout=10.0)
        client.connect()
        _ping(client)
    finally:
        if client is not None:
            client.close()
        server.stop()


@pytest.mark.parametrize("server_pkg", ["torch", "jax"])
def test_rpc_across_packages(server_pkg):
    """A port client calls a JAX server and a JAX client a port server:
    the echo handler's document and arrays come back equal, and a handler
    error surfaces as the caller's package's RpcError."""
    from koordinator_tpu.transport import channel as jch

    from koordinator_tpu_torch.transport import channel as tch

    srv_mod, cli_mod = (tch, jch) if server_pkg == "torch" else (jch, tch)

    def echo(doc, arrays):
        if doc.get("boom"):
            raise ValueError("kaput")
        return {"echo": doc["msg"]}, {"arr": arrays["arr"] * 2}

    server = srv_mod.RpcServer("tcp://127.0.0.1:0")
    server.register(srv_mod.FrameType.SOLVE_REQUEST, echo)
    server.start()
    client = cli_mod.RpcClient(server.address, timeout=10.0)
    try:
        client.connect()
        arr = np.arange(2 * R, dtype=np.int32).reshape(2, R)
        ftype, doc, arrays = client.call(
            cli_mod.FrameType.SOLVE_REQUEST, {"msg": "hi"}, {"arr": arr})
        assert int(ftype) == int(twire.FrameType.SOLVE_RESPONSE)
        assert doc == {"echo": "hi"}
        assert np.array_equal(arrays["arr"], arr * 2)
        with pytest.raises(cli_mod.RpcError, match="kaput"):
            client.call(cli_mod.FrameType.SOLVE_REQUEST,
                        {"msg": "x", "boom": True})
    finally:
        client.close()
        server.stop()
