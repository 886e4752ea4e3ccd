"""Leader election / HA for the control-plane components (port of
``koordinator_tpu/ha.py``, copied whole).

The reference leader-elects koord-manager, koord-scheduler and
koord-descheduler with client-go Lease locks (``cmd/koord-manager/main.go``
``--enable-leader-election`` / ``--leader-elect-resource-lock=leases``;
equivalent flags in the scheduler and descheduler commands). The control
plane is stateless — on failover the new leader rebuilds everything from
informers, gated by the startup sync barrier
(``cmd/koord-scheduler/app/sync_barrier.go``, scheduler/barrier.py here).

This module is the client-go ``leaderelection`` semantic rebuilt over a
pluggable lease store: acquire when the lease is free or expired, renew
while holding, release on stop, fire OnStartedLeading / OnStoppedLeading /
OnNewLeader transitions. The in-process :class:`InMemoryLeaseStore` stands
in for the apiserver Lease object (compare-and-swap under a lock, the same
atomicity a Lease update gives).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional, Protocol


@dataclasses.dataclass
class LeaseRecord:
    """coordination.k8s.io/v1 Lease essentials."""

    holder: str = ""
    duration_seconds: float = 15.0
    acquire_time: float = 0.0
    renew_time: float = 0.0
    transitions: int = 0

    def expired(self, now: float) -> bool:
        return (not self.holder
                or now >= self.renew_time + self.duration_seconds)


class LeaseStore(Protocol):
    """The lock-object seam (a k8s Lease in the real deployment)."""

    def get(self, name: str) -> LeaseRecord: ...

    def update(self, name: str, expect_holder: str,
               record: LeaseRecord) -> bool: ...


class InMemoryLeaseStore:
    """Compare-and-swap lease store; ``expect_holder`` mismatches fail the
    update the way a stale resourceVersion fails a Lease PUT."""

    #: in-process contenders share the process's monotonic clock
    preferred_clock = staticmethod(time.monotonic)

    def __init__(self) -> None:
        self._leases: dict[str, LeaseRecord] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> LeaseRecord:
        with self._lock:
            return dataclasses.replace(
                self._leases.get(name) or LeaseRecord())

    def update(self, name: str, expect_holder: str,
               record: LeaseRecord) -> bool:
        with self._lock:
            current = self._leases.get(name) or LeaseRecord()
            if current.holder != expect_holder:
                return False
            self._leases[name] = dataclasses.replace(record)
            return True


class LeaderElector:
    """client-go leaderelection.LeaderElector semantics, tick-driven.

    Call :meth:`tick` on the component's cadence (or :meth:`run` in a
    thread): it acquires the lease when free/expired, renews while leading,
    and demotes itself if a renew fails or another holder appears.

    Clock domains: lease timestamps are compared across ALL contenders, so
    every process contending one lease must share a clock domain.  The
    default clock is taken from the store's ``preferred_clock``
    (``time.monotonic`` for the in-process store; ``time.time`` wall clock
    for :class:`RemoteLeaseStore`, whose contenders live in different
    processes where each process's monotonic epoch is meaningless).  An
    explicit ``clock=`` argument always wins — but passing a per-process
    monotonic clock with a cross-process store invites split-brain.
    """

    def __init__(
        self,
        store: LeaseStore,
        lease_name: str,
        identity: str,
        lease_duration: float = 15.0,
        retry_period: float = 2.0,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
        on_new_leader: Optional[Callable[[str], None]] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        if clock is None:
            clock = getattr(store, "preferred_clock", time.monotonic)
        self.store = store
        self.lease_name = lease_name
        self.identity = identity
        self.lease_duration = lease_duration
        self.retry_period = retry_period
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.on_new_leader = on_new_leader
        self.clock = clock
        self._leading = False
        self._observed_leader = ""
        self._stopped = False

    def is_leader(self) -> bool:
        return self._leading

    def _set_leading(self, leading: bool) -> None:
        if leading and not self._leading:
            self._leading = True
            if self.on_started_leading:
                self.on_started_leading()
        elif not leading and self._leading:
            self._leading = False
            if self.on_stopped_leading:
                self.on_stopped_leading()

    def _observe(self, holder: str) -> None:
        if holder and holder != self._observed_leader:
            self._observed_leader = holder
            if self.on_new_leader:
                self.on_new_leader(holder)

    def tick(self) -> bool:
        """One tryAcquireOrRenew; returns is_leader afterwards."""
        if self._stopped:
            return False
        now = self.clock()
        lease = self.store.get(self.lease_name)
        if lease.holder == self.identity:
            # renew
            renewed = self.store.update(
                self.lease_name, self.identity, dataclasses.replace(
                    lease, renew_time=now))
            self._set_leading(renewed)
            self._observe(self.identity if renewed else lease.holder)
            return self._leading
        if lease.expired(now):
            acquired = self.store.update(
                self.lease_name, lease.holder, LeaseRecord(
                    holder=self.identity,
                    duration_seconds=self.lease_duration,
                    acquire_time=now, renew_time=now,
                    transitions=lease.transitions + 1))
            self._set_leading(acquired)
            if acquired:
                self._observe(self.identity)
            return self._leading
        # someone else holds a live lease
        self._set_leading(False)
        self._observe(lease.holder)
        return False

    def release(self) -> None:
        """Voluntary hand-off on clean shutdown (client-go ReleaseOnCancel):
        clear the holder so a follower acquires without waiting out the
        lease."""
        self._stopped = True
        if self._leading:
            lease = self.store.get(self.lease_name)
            if lease.holder == self.identity:
                self.store.update(
                    self.lease_name, self.identity, LeaseRecord(
                        duration_seconds=lease.duration_seconds,
                        transitions=lease.transitions))
        self._set_leading(False)

    def run(self, stop: threading.Event,
            sleep: Callable[[float], None] = time.sleep) -> None:
        """Loop tick() every retry_period until stop is set."""
        while not stop.is_set():
            self.tick()
            sleep(self.retry_period)
        self.release()


def leader_gated(elector: Optional[LeaderElector],
                 fn: Callable, *args, **kwargs):
    """Run a control-loop step only while leading (controller-runtime
    managers simply don't start controllers on non-leaders); None elector
    means leader election is disabled (--enable-leader-election=false)."""
    if elector is not None and not elector.tick():
        return None
    return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# Cross-process leases over the wire transport
# ---------------------------------------------------------------------------
#
# The reference's Leases are apiserver objects precisely so that two
# scheduler PROCESSES on different hosts can contend one lock.  Here the
# state server plays the apiserver role: it owns the authoritative
# InMemoryLeaseStore and serves LEASE_GET / LEASE_UPDATE frames; each
# contender runs a LeaderElector over a RemoteLeaseStore.  CAS atomicity
# lives server-side (one store, one lock), exactly like a Lease PUT with a
# resourceVersion precondition.


def _record_doc(name: str, expect_holder: str, rec: LeaseRecord) -> dict:
    return {
        "name": name, "expect_holder": expect_holder,
        "holder": rec.holder,
        "duration_seconds": float(rec.duration_seconds),
        "acquire_time": float(rec.acquire_time),
        "renew_time": float(rec.renew_time),
        "transitions": int(rec.transitions),
    }


class LeaseService:
    """Server side: expose a LeaseStore on the framed transport
    (cmd/koord-manager/main.go --leader-elect-resource-lock=leases)."""

    def __init__(self, store: Optional[LeaseStore] = None):
        self.store: LeaseStore = store or InMemoryLeaseStore()

    def attach(self, server) -> None:
        from koordinator_tpu_torch.transport.wire import FrameType

        server.register(FrameType.LEASE_GET, self._get)
        server.register(FrameType.LEASE_UPDATE, self._update)

    def _get(self, doc: dict, arrays):
        rec = self.store.get(doc["name"])
        out = _record_doc(doc["name"], "", rec)
        out.pop("expect_holder")
        return out, None

    def _update(self, doc: dict, arrays):
        rec = LeaseRecord(
            holder=doc["holder"],
            duration_seconds=float(doc["duration_seconds"]),
            acquire_time=float(doc["acquire_time"]),
            renew_time=float(doc["renew_time"]),
            transitions=int(doc["transitions"]),
        )
        ok = self.store.update(doc["name"], doc["expect_holder"], rec)
        return {"ok": bool(ok)}, None


class RemoteLeaseStore:
    """Client-side LeaseStore over an RpcClient.

    Failure posture is fail-closed for leadership: a transport error on
    ``update`` returns False (a leader that cannot renew demotes itself —
    client-go's renew-deadline behavior), and on ``get`` returns an empty
    record, which is safe because acquiring still requires a successful
    CAS against the server-side store.
    """

    #: contenders are separate PROCESSES: they must evaluate lease expiry
    #: on a shared clock, and a per-process monotonic epoch is not one —
    #: a host up 30 days would see every other host's renews as ancient
    #: and steal a live lease (split-brain).  Wall clock is the same
    #: domain the reference's apiserver Lease timestamps live in.
    preferred_clock = staticmethod(time.time)

    def __init__(self, client):
        self.client = client

    def get(self, name: str) -> LeaseRecord:
        from koordinator_tpu_torch.transport.channel import RpcError
        from koordinator_tpu_torch.transport.wire import FrameType

        try:
            _, doc, _ = self.client.call(
                FrameType.LEASE_GET, {"name": name})
        except RpcError:
            return LeaseRecord()
        return LeaseRecord(
            holder=doc.get("holder", ""),
            duration_seconds=float(doc.get("duration_seconds", 15.0)),
            acquire_time=float(doc.get("acquire_time", 0.0)),
            renew_time=float(doc.get("renew_time", 0.0)),
            transitions=int(doc.get("transitions", 0)),
        )

    def update(self, name: str, expect_holder: str,
               record: LeaseRecord) -> bool:
        from koordinator_tpu_torch.transport.channel import RpcError
        from koordinator_tpu_torch.transport.wire import FrameType

        try:
            _, doc, _ = self.client.call(
                FrameType.LEASE_UPDATE,
                _record_doc(name, expect_holder, record))
        except RpcError:
            return False
        return bool(doc.get("ok"))
