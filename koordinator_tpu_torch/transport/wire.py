"""Frame + payload encoding (port of
``koordinator_tpu/transport/wire.py``).

One frame on the wire:

    magic   u16  0x4B54 ("KT")
    version u8   wire version (1)
    type    u8   FrameType
    req_id  u32  request/response correlation id
    length  u32  payload byte length
    payload

The payload is a control document plus an array blob:

    json_len u32 | json utf-8 | raw array section

The json document carries small structured fields; numpy arrays ride in
the raw section, referenced from ``doc["__arrays__"]`` manifest entries
``{key, dtype, shape, offset, nbytes}`` — so the hot path (node/pod
resource tensors) moves as raw little-endian bytes, not text. This is the
same split gRPC+proto gives the reference: tiny schema-ed control data,
binary tensors.

Two version numbers govern the wire:

- ``VERSION`` (header byte) is the FRAMING version — header layout +
  payload packing.  A mismatch is unrecoverable and fails at read_frame.
- ``PROTOCOL_VERSION`` is the MESSAGE protocol — the set of frame types
  and their document schemas (the role ``apis/runtime/v1alpha1/api.proto``
  plays for the reference).  It is negotiated in HELLO: a client
  advertises its protocol and the server replies with
  ``min(peer, local)`` when the peer is inside
  ``[MIN_PROTOCOL_VERSION, PROTOCOL_VERSION]``, rejecting anything
  outside the window with an ERROR instead of silently mis-decoding
  (history: v1 ad-hoc docs; v2 adds typed REQUEST_SCHEMAS, the
  ``proto`` field in HELLO, and lease frames; v3 adds STATE_PUSH —
  client-originated state events, the direction a non-Python scheduler
  plugin feeds its informer view into the sidecar; v4 adds the columnar
  event codec for the hot frame types — deltasync DELTA/SNAPSHOT event
  lists ride as columnar numpy blocks instead of per-event JSON docs,
  see docs/wire_protocol.md).

``REQUEST_SCHEMAS`` types each schema'd frame's json document;
``validate_doc`` is enforced server-side on every request frame, so a
peer built against a different protocol fails loud at the boundary.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import struct
import time

import numpy as np

MAGIC = 0x4B54
VERSION = 1
PROTOCOL_VERSION = 4
#: oldest message protocol this build still speaks.  HELLO negotiates
#: the session protocol to ``min(peer, PROTOCOL_VERSION)`` as long as
#: the peer advertises at least this; below it (or above
#: PROTOCOL_VERSION) the server rejects with "incompatible".  v3 peers
#: keep the per-event JSON event lists; v4 peers get the columnar
#: event codec on DELTA/SNAPSHOT.
MIN_PROTOCOL_VERSION = 3
_HEADER = struct.Struct("<HBBII")
MAX_PAYLOAD = 256 << 20  # 256 MiB guard against corrupt length words

#: zero-copy decode policy: a decoded array may
#: alias the frame payload (np.frombuffer view) ONLY when it is both
#: big enough that the copy would cost real time AND a large share of
#: the payload — otherwise the view pins the whole payload buffer for
#: the lifetime of a tiny array (a 4-byte rv field keeping a multi-MB
#: snapshot alive).  Small or minority arrays are copied; the payload
#: buffer is then released as soon as decode returns.
ZERO_COPY_MIN_BYTES = 64 << 10
ZERO_COPY_MIN_SHARE = 0.5


class FrameType(enum.IntEnum):
    HELLO = 1           # client: {last_rv, proto}; reply SNAPSHOT or ACK
    SNAPSHOT = 2        # full state dump @ rv
    DELTA = 3           # incremental changes (rv-ordered)
    ACK = 4             # generic ok, {rv} for sync acks
    ERROR = 5           # {message, resync: bool}
    SOLVE_REQUEST = 6   # run a scheduling round
    SOLVE_RESPONSE = 7  # assignments/failures
    HOOK_REQUEST = 8    # runtime hook dispatch (api.proto:148 shapes)
    HOOK_RESPONSE = 9
    PING = 10
    LEASE_GET = 11      # {name} -> lease record fields
    LEASE_UPDATE = 12   # CAS write: {name, expect_holder, <record>} -> {ok}
    STATE_PUSH = 13     # client-originated state event -> {rv}; the
                        # Go-plugin/informer -> sidecar feed direction


class WireSchemaError(ValueError):
    """A request document does not match its frame's schema — the loud
    failure mode for protocol skew between peers."""


#: REQUEST document schemas: field -> (allowed type(s), required).
#: Unknown extra fields are allowed (minor additions stay compatible);
#: a missing required field or a type mismatch is a WireSchemaError.
REQUEST_SCHEMAS: dict[FrameType, dict[str, tuple]] = {
    FrameType.HELLO: {
        "last_rv": (int, True),
        "proto": (int, True),
        # service boot-epoch the client last synced from; absent on
        # first contact and from older peers (rv-only resync semantics)
        "instance": (str, False),
    },
    FrameType.SOLVE_REQUEST: {},
    FrameType.HOOK_REQUEST: {
        "hook": (str, True),
        "pod_meta": (dict, False),
        "container_meta": (dict, False),
        "labels": (dict, False),
        "annotations": (dict, False),
        "cgroup_parent": (str, False),
        "resources": (dict, False),
        "envs": (dict, False),
    },
    FrameType.LEASE_GET: {
        "name": (str, True),
    },
    FrameType.LEASE_UPDATE: {
        "name": (str, True),
        "expect_holder": (str, True),
        "holder": (str, True),
        "duration_seconds": ((int, float), True),
        "acquire_time": ((int, float), True),
        "renew_time": ((int, float), True),
        "transitions": (int, True),
    },
    FrameType.STATE_PUSH: {
        "kind": (str, True),
        "name": (str, True),
        # event-kind-specific fields (labels, priority, quota, ...) ride
        # as extras; resource vectors ride the raw array section
    },
}


#: every array key any STATE_PUSH kind accepts (deltasync
#: _handle_state_push's require_vector calls) — ONE set shared with the
#: HTTP gateway's JSON-to-array lift, so a new kind's array field cannot
#: be accepted by the framed path while the HTTP path silently drops it
#: (as the sys_usage/hp_usage fields once drifted)
STATE_PUSH_ARRAY_KEYS = ("allocatable", "usage", "agg_usage",
                         "prod_usage", "sys_usage", "hp_usage",
                         "hp_request", "hp_max_used_req",
                         "requests")


def check_field_type(val, types) -> bool:
    """isinstance with the wire rule that bool (an int subclass) never
    satisfies a numeric field unless bool is listed explicitly — one
    copy of the rule for frame validation and state-push field checks."""
    if isinstance(val, bool) and bool not in (
            types if isinstance(types, tuple) else (types,)):
        return False
    return isinstance(val, types)


def validate_doc(ftype: FrameType, doc: dict) -> None:
    """Check a request document against REQUEST_SCHEMAS (no-op for
    unschema'd frame types)."""
    schema = REQUEST_SCHEMAS.get(ftype)
    if schema is None:
        return
    for field, (types, required) in schema.items():
        if field not in doc:
            if required:
                raise WireSchemaError(
                    f"{ftype.name}: missing required field {field!r} "
                    f"(peer protocol skew? local proto="
                    f"{PROTOCOL_VERSION})")
            continue
        val = doc[field]
        if not check_field_type(val, types):
            raise WireSchemaError(
                f"{ftype.name}: field {field!r} has type "
                f"{type(val).__name__}, expected {types}")


@dataclasses.dataclass(frozen=True)
class Frame:
    type: FrameType
    request_id: int
    payload: bytes

    def encode(self) -> bytes:
        return _HEADER.pack(MAGIC, VERSION, int(self.type),
                            self.request_id, len(self.payload)) + self.payload


def encode_payload(doc: dict, arrays: dict[str, np.ndarray] | None = None) -> bytes:
    """Pack a json-able doc + named numpy arrays into one payload.

    Instrumented: codec wall + payload bytes feed the
    ``wire_codec_duration_seconds`` / ``wire_payload_bytes``
    histograms and, when the timeline recorder is armed, a
    ``json_codec`` segment — the codec's slice of the host-wait
    attribution."""
    t0 = time.perf_counter()
    blobs = []
    manifest = []
    offset = 0
    for key, arr in (arrays or {}).items():
        a = np.ascontiguousarray(arr)
        raw = a.tobytes()
        manifest.append({
            "key": key, "dtype": a.dtype.str, "shape": list(a.shape),
            "offset": offset, "nbytes": len(raw),
        })
        blobs.append(raw)
        offset += len(raw)
    out = dict(doc)
    if manifest:
        out["__arrays__"] = manifest
    j = json.dumps(out, separators=(",", ":")).encode()
    payload = struct.pack("<I", len(j)) + j + b"".join(blobs)
    _observe_codec("encode", t0, len(payload))
    return payload


def decode_payload(payload: bytes) -> tuple[dict, dict[str, np.ndarray]]:
    t0 = time.perf_counter()
    (json_len,) = struct.unpack_from("<I", payload, 0)
    doc = json.loads(payload[4:4 + json_len].decode())
    arrays: dict[str, np.ndarray] = {}
    base = 4 + json_len
    manifest = doc.pop("__arrays__", [])
    if not isinstance(manifest, list):
        raise WireSchemaError(
            f"__arrays__ manifest must be a list, got "
            f"{type(manifest).__name__}")
    for entry in manifest:
        try:
            start = base + int(entry["offset"])
            nbytes = int(entry["nbytes"])
            dtype = np.dtype(entry["dtype"])
            shape = entry["shape"]
            count = (int(np.prod(shape, dtype=np.int64)) if shape else 1)
            if (start < 4 + json_len or start + nbytes > len(payload)
                    or count * dtype.itemsize != nbytes):
                raise WireSchemaError(
                    f"array manifest entry {entry.get('key')!r} points "
                    f"outside the payload (offset={entry['offset']}, "
                    f"nbytes={nbytes}, payload={len(payload)})")
            arr = np.frombuffer(payload, dtype=dtype, count=count,
                                offset=start).reshape(shape)
        except WireSchemaError:
            raise
        except (KeyError, TypeError, ValueError, OverflowError) as e:
            raise WireSchemaError(
                f"corrupt array manifest entry {entry!r}: {e}") from e
        if (nbytes < ZERO_COPY_MIN_BYTES
                or nbytes < ZERO_COPY_MIN_SHARE * len(payload)):
            # copy-above-threshold: don't let a small view pin the
            # whole payload buffer (see ZERO_COPY_MIN_BYTES)
            arr = arr.copy()
        arrays[entry["key"]] = arr
    _observe_codec("decode", t0, len(payload))
    return doc, arrays


def _observe_codec(op: str, t0: float, nbytes: int) -> None:
    from koordinator_tpu_torch import metrics, timeline

    t1 = time.perf_counter()
    metrics.wire_codec_seconds.observe(t1 - t0, labels={"op": op})
    metrics.wire_payload_bytes.observe(float(nbytes), labels={"op": op})
    if timeline.RECORDER.enabled:
        timeline.RECORDER.add(t0, t1, "json_codec", f"wire.{op}")


def pack_str_column(values: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """Columnar string packing for the v2 event codec: a list of
    strings becomes ``(lengths int32, utf-8 blob uint8)`` — two numpy
    arrays that ride the raw array section instead of N JSON string
    fields.  The inverse is :func:`unpack_str_column`."""
    encoded = [v.encode() for v in values]
    lens = np.asarray([len(b) for b in encoded], dtype=np.int32)
    blob = (np.frombuffer(b"".join(encoded), dtype=np.uint8)
            if encoded else np.zeros(0, dtype=np.uint8))
    return lens, blob


def unpack_str_column(lens: np.ndarray, blob: np.ndarray) -> list[str]:
    """Inverse of :func:`pack_str_column`."""
    raw = blob.tobytes()
    ends = np.cumsum(lens.astype(np.int64)) if len(lens) else lens
    if len(lens) and int(ends[-1]) != len(raw):
        raise WireSchemaError(
            f"string column blob is {len(raw)} bytes but lengths sum "
            f"to {int(ends[-1])}")
    out: list[str] = []
    pos = 0
    for end in ends.tolist():
        out.append(raw[pos:end].decode())
        pos = end
    return out


def read_frame(recv_exact) -> Frame:
    """Read one frame via a recv_exact(n)->bytes callable. Raises
    ConnectionError on short reads / bad magic."""
    header = recv_exact(_HEADER.size)
    magic, version, ftype, req_id, length = _HEADER.unpack(header)
    if magic != MAGIC:
        raise ConnectionError(f"bad frame magic {magic:#x}")
    if version != VERSION:
        raise ConnectionError(f"unsupported wire version {version}")
    if length > MAX_PAYLOAD:
        raise ConnectionError(f"oversized frame ({length} bytes)")
    payload = recv_exact(length) if length else b""
    return Frame(FrameType(ftype), req_id, payload)
