"""Deterministic, seeded fault injection at the frame/socket seams (port of
``koordinator_tpu/transport/faults.py``).

The transport's failure modes in production — sidecars crashing mid-
write, sockets black-holing, watch feeds stalling — are all reproduced
here as *scheduled* faults: a :class:`FaultInjector` owns one seeded
``random.Random`` and every fault decision is a draw from it, so a
failing chaos run replays exactly from its seed (tools/soak.sh prints
the seed on failure).

Injection points (all off by default — a ``None`` injector costs one
attribute check):

- ``RpcClient.connect``      -> :meth:`FaultInjector.on_connect`
  (connect refusal)
- ``RpcClient.call`` send    -> :meth:`FaultInjector.outbound_cut`
  (mid-write truncation; the socket is severed after the partial write)
- reader ``recv`` loops      -> :meth:`FaultInjector.on_read`
  (slow-drip reads)
- server ``_Conn`` sends     -> :meth:`FaultInjector.outbound_action`
  (connection sever, mid-write truncation on any frame; drop / delay /
  duplication / reordering on PUSH frames only — responses stay
  correlated)

``heal()`` flips the injector off atomically — the chaos soak's
"faults heal, system reconverges" phase.  ``injected`` counts every
fault actually fired, by kind, so tests can assert the schedule was
exercised at all.

Beyond the independent per-connection probabilities, the injector also
models **correlated** faults (the drill engine's storms): connections
carry a *fault domain* tag (a rack/zone group derived from the network
topology — see :func:`domains_from_labels`), and one storm event severs
or refuses every connection in the domain together.  Storms come in
three modes:

- ``partition`` — live connections in the domain are severed at storm
  start and new connects are refused (full network cut);
- ``refuse``    — only new connects fail; established connections drain
  (the half-dead switch that still forwards existing flows);
- ``asym_send`` — outbound *calls* from the domain fail but inbound
  pushes still arrive (the asymmetric partition: the peer can talk to
  you, you cannot talk to the peer).

Storms are driven either manually (:meth:`FaultInjector.start_storm` /
:meth:`FaultInjector.end_storm`) or by a time-phased
:class:`FaultSchedule` of :class:`StormWindow` entries evaluated against
an explicit virtual clock (:meth:`FaultInjector.advance_to`) — no
wall-clock reads, so a drill replays its exact storm membership and
timing from one seed under a fake clock.

``heal()`` ends every storm, detaches the schedule, and resets any
registered circuit breakers (:meth:`FaultInjector.register_breaker`) so
healed peers are probed immediately instead of waiting out a full open
window.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import threading
import time

#: storm modes, in increasing severity (the merge when a domain sits in
#: overlapping windows keeps the severest)
REFUSE = "refuse"
ASYM_SEND = "asym_send"
PARTITION = "partition"

_MODE_SEVERITY = {REFUSE: 1, ASYM_SEND: 2, PARTITION: 3}


def domains_from_labels(labels_by_node: dict[str, dict[str, str]],
                        key: str = "rack") -> dict[str, list[str]]:
    """Group nodes into fault domains by a topology label.

    ``{"n0": {"rack": "r1"}, "n1": {"rack": "r1"}}`` with ``key="rack"``
    yields ``{"rack:r1": ["n0", "n1"]}`` — the domain names are what
    connection owners tag their clients with (``RpcClient(...,
    fault_domain="rack:r1")``) and what storm windows name.  Nodes
    missing the label are skipped (they sit outside the topology and no
    correlated event can take them out together)."""
    out: dict[str, list[str]] = {}
    for name, labels in labels_by_node.items():
        value = (labels or {}).get(key)
        if value is None:
            continue
        out.setdefault(f"{key}:{value}", []).append(name)
    for members in out.values():
        members.sort()
    return out


@dataclasses.dataclass(frozen=True)
class StormWindow:
    """One scheduled correlated-fault event: every connection tagged
    with one of ``domains`` is blocked with ``mode`` for virtual time
    ``[start, end)``."""

    start: float
    end: float
    domains: frozenset[str]
    mode: str = PARTITION

    def __post_init__(self):
        if self.mode not in _MODE_SEVERITY:
            raise ValueError(f"unknown storm mode {self.mode!r}")
        if not self.end > self.start:
            raise ValueError(
                f"empty storm window [{self.start}, {self.end})")
        object.__setattr__(self, "domains", frozenset(self.domains))

    def active_at(self, t: float) -> bool:
        return self.start <= t < self.end


class FaultSchedule:
    """A time-phased list of storm windows, evaluated on a virtual
    clock.  Windows may overlap (a zone partition spanning a rack flap);
    per domain the severest active mode wins."""

    def __init__(self, windows=()):
        self.windows: tuple[StormWindow, ...] = tuple(
            sorted(windows, key=lambda w: (w.start, w.end)))

    def active(self, t: float) -> list[StormWindow]:
        return [w for w in self.windows if w.active_at(t)]

    def blocked(self, t: float) -> dict[str, str]:
        """domain -> mode for every domain inside a window at ``t``."""
        out: dict[str, str] = {}
        for w in self.active(t):
            for d in w.domains:
                cur = out.get(d)
                if cur is None or (_MODE_SEVERITY[w.mode]
                                   > _MODE_SEVERITY[cur]):
                    out[d] = w.mode
        return out

    def horizon(self) -> float:
        return max((w.end for w in self.windows), default=0.0)

    def boundaries(self) -> list[float]:
        """Sorted distinct start/end times — fake-clock tests step the
        injector exactly through these."""
        ts = {w.start for w in self.windows} | {w.end for w in self.windows}
        return sorted(ts)

    @staticmethod
    def flap_train(domains, start: float, up_s: float, down_s: float,
                   flaps: int, mode: str = PARTITION
                   ) -> tuple[StormWindow, ...]:
        """``flaps`` repeated storms of ``up_s`` seconds separated by
        ``down_s`` healthy gaps — the flapping-ToR pattern that breaker
        pacing and rv-gap resync must both survive."""
        out = []
        t = start
        for _ in range(max(0, flaps)):
            out.append(StormWindow(t, t + up_s, frozenset(domains), mode))
            t += up_s + down_s
        return tuple(out)

    @classmethod
    def generate(cls, seed: int, domains, horizon_s: float,
                 storms: int = 3, mean_gap_s: float = 2.0,
                 mean_hold_s: float = 1.0, max_width: int = 1,
                 modes=(PARTITION,)) -> "FaultSchedule":
        """Seeded storm schedule: every draw (timing, membership, mode)
        comes from one ``random.Random(seed)``, so the exact storm
        membership and timing replay from the seed alone."""
        domains = sorted(domains)
        rng = random.Random(seed)
        out: list[StormWindow] = []
        t = 0.0
        for _ in range(max(0, storms)):
            t += rng.expovariate(1.0 / mean_gap_s)
            hold = rng.expovariate(1.0 / mean_hold_s)
            if t >= horizon_s:
                break
            end = min(t + hold, horizon_s)
            if not end > t:
                break
            width = rng.randint(1, max(1, min(max_width, len(domains))))
            members = rng.sample(domains, width)
            mode = rng.choice(list(modes))
            out.append(StormWindow(t, end, frozenset(members), mode))
            t = end
        return cls(out)


@dataclasses.dataclass
class FaultConfig:
    """Per-decision probabilities.  All default 0.0 (= never)."""

    #: client connect() raises ConnectionRefusedError
    connect_refuse_p: float = 0.0
    #: outbound frame (any): sever the connection before writing
    send_sever_p: float = 0.0
    #: outbound frame (any): write a partial prefix, then sever —
    #: the peer's framing desyncs and its read loop dies
    send_truncate_p: float = 0.0
    #: push frame: silently drop (the black-holed watch event — the
    #: client's rv-gap detection is what recovers from this)
    push_drop_p: float = 0.0
    #: push frame: delay before writing
    push_delay_p: float = 0.0
    push_delay_ms: float = 10.0
    #: push frame: write twice (the client's rv guard must dedup)
    push_duplicate_p: float = 0.0
    #: push frame: hold, and emit after the NEXT outbound frame
    #: (rv-order inversion on the wire)
    push_reorder_p: float = 0.0
    #: each recv() chunk: sleep first (slow-drip read)
    read_drip_p: float = 0.0
    read_drip_ms: float = 2.0
    #: scheduler Solve phase: sleep before dispatching the solve (the
    #: synthetic latency regression the SLO burn-rate engine must
    #: detect — a real one would be a recompile storm or device
    #: contention; the injected delay is indistinguishable to the
    #: scheduling_duration_seconds observer)
    solve_delay_p: float = 0.0
    solve_delay_ms: float = 0.0


class FaultInjector:
    """Seeded fault scheduler shared by any number of connections.

    Thread-safe: the rng is guarded so concurrent sender/reader threads
    draw a single deterministic sequence (the *schedule* is reproducible
    per seed; which thread consumes which draw still depends on timing,
    which is exactly the nondeterminism chaos testing wants to shake)."""

    def __init__(self, seed: int = 0, config: FaultConfig | None = None,
                 sleep=time.sleep, schedule: "FaultSchedule | None" = None):
        self.seed = seed
        self.config = config or FaultConfig()
        self.enabled = True
        self.injected: collections.Counter = collections.Counter()
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._sleep = sleep
        #: correlated-fault state (all guarded by _lock): manual storms,
        #: schedule-driven storms, and the registries the storms act on
        self.schedule = schedule
        self.virtual_time = 0.0
        self._manual_blocked: dict[str, str] = {}     # domain -> mode
        self._sched_blocked: dict[str, str] = {}      # domain -> mode
        self._active_windows: set[int] = set()        # indices into schedule
        self._conns: dict[str, list] = {}             # domain -> [sever_fn]
        self._breakers: list = []
        self._heal_listeners: list = []

    # -- correlated fault domains -------------------------------------------

    def register_conn(self, domain: str, sever_fn) -> None:
        """A live connection in ``domain`` registers how to sever it; a
        partition storm over the domain invokes every registered fn.  A
        connection created INTO an already-stormed partition is severed
        immediately (it raced past on_connect before the storm began, or
        the owner dialed a still-listening peer across the cut)."""
        if not domain:
            return
        sever_now = False
        with self._lock:
            self._conns.setdefault(domain, []).append(sever_fn)
            sever_now = self._domain_mode_locked(domain) == PARTITION
        if sever_now:
            try:
                sever_fn()
            except Exception:
                pass

    def unregister_conn(self, domain: str, sever_fn) -> None:
        with self._lock:
            fns = self._conns.get(domain)
            if fns and sever_fn in fns:
                fns.remove(sever_fn)
            if not fns and domain in self._conns:
                del self._conns[domain]

    def register_breaker(self, breaker) -> None:
        """heal() resets registered breakers so a healed peer is probed
        immediately instead of waiting out the remaining open window."""
        with self._lock:
            if breaker not in self._breakers:
                self._breakers.append(breaker)

    def add_heal_listener(self, fn) -> None:
        with self._lock:
            self._heal_listeners.append(fn)

    # koordlint: guarded-by(self._lock)
    def _domain_mode_locked(self, domain: str) -> str | None:
        a = self._manual_blocked.get(domain)
        b = self._sched_blocked.get(domain)
        if a is None:
            return b
        if b is None:
            return a
        return a if _MODE_SEVERITY[a] >= _MODE_SEVERITY[b] else b

    def domain_mode(self, domain: str) -> str | None:
        """Active storm mode blocking ``domain``, or None (healthy)."""
        with self._lock:
            return self._domain_mode_locked(domain)

    def start_storm(self, domains, mode: str = PARTITION) -> None:
        """Begin a manual correlated storm over ``domains``.  Partition
        mode severs every registered connection in the domains NOW —
        deterministically, not probabilistically."""
        if mode not in _MODE_SEVERITY:
            raise ValueError(f"unknown storm mode {mode!r}")
        to_sever = []
        with self._lock:
            for d in domains:
                cur = self._manual_blocked.get(d)
                if cur is None or _MODE_SEVERITY[mode] > _MODE_SEVERITY[cur]:
                    self._manual_blocked[d] = mode
                if mode == PARTITION:
                    to_sever.extend(self._conns.get(d, ()))
        self._count(f"storm_{mode}")
        for fn in to_sever:
            try:
                fn()
            except Exception:
                pass

    def end_storm(self, domains=None) -> None:
        """End manual storms for ``domains`` (None = all)."""
        with self._lock:
            if domains is None:
                self._manual_blocked.clear()
            else:
                for d in domains:
                    self._manual_blocked.pop(d, None)

    def advance_to(self, t: float) -> None:
        """Advance the schedule's virtual clock to ``t`` and apply any
        window transitions: domains entering a partition window get
        their live connections severed; domains whose windows all closed
        are unblocked.  Drives nothing when no schedule is attached."""
        to_sever = []
        started_kinds = []
        with self._lock:
            self.virtual_time = t
            if self.schedule is None:
                return
            now = self.schedule.blocked(t)
            active = {i for i, w in enumerate(self.schedule.windows)
                      if w.active_at(t)}
            for i in active - self._active_windows:
                w = self.schedule.windows[i]
                self.injected[f"storm_{w.mode}"] += 1
                started_kinds.append(f"storm_{w.mode}")
                if w.mode == PARTITION:
                    for d in w.domains:
                        to_sever.extend(self._conns.get(d, ()))
            self._active_windows = active
            self._sched_blocked = now
        if started_kinds:
            # metric outside the lock (the registry takes its own)
            from koordinator_tpu_torch import metrics
            for kind in started_kinds:
                metrics.faults_injected_total.inc(labels={"kind": kind})
        for fn in to_sever:
            try:
                fn()
            except Exception:
                pass

    def heal(self) -> None:
        """Stop injecting (the soak's recovery phase).  Already-held
        reordered frames still flush through their connections.  Ends
        every storm (manual and scheduled), detaches the schedule, and
        resets registered breakers so healed peers are probed NOW."""
        self.enabled = False
        with self._lock:
            self._manual_blocked.clear()
            self._sched_blocked.clear()
            self._active_windows.clear()
            self.schedule = None
            breakers = list(self._breakers)
            listeners = list(self._heal_listeners)
        for b in breakers:
            reset = getattr(b, "reset", None)
            if reset is not None:
                reset()
        for fn in listeners:
            try:
                fn()
            except Exception:
                pass

    def _hit(self, p: float) -> bool:
        if not self.enabled or p <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < p

    def _count(self, kind: str) -> None:
        from koordinator_tpu_torch import metrics

        self.injected[kind] += 1
        metrics.faults_injected_total.inc(labels={"kind": kind})

    # -- client seams --------------------------------------------------------

    def on_connect(self, domain: str = "") -> None:
        if domain:
            mode = self.domain_mode(domain)
            if mode in (PARTITION, REFUSE):
                self._count("domain_refuse")
                raise ConnectionRefusedError(
                    f"fault injection: domain {domain!r} stormed ({mode})")
        if self._hit(self.config.connect_refuse_p):
            self._count("connect_refuse")
            raise ConnectionRefusedError("fault injection: connect refused")

    def outbound_domain(self, domain: str) -> str | None:
        """Correlated-fault action for a client's outbound call from
        ``domain``: "sever" (partition — tear the connection down),
        "block" (asym_send — fail the call, keep the stream so inbound
        pushes still arrive), or None."""
        if not domain:
            return None
        mode = self.domain_mode(domain)
        if mode == PARTITION:
            self._count("domain_sever")
            return "sever"
        if mode == ASYM_SEND:
            self._count("domain_block")
            return "block"
        return None

    def outbound_cut(self, nbytes: int) -> int | None:
        """Byte count to truncate a client write at, or None (no fault)."""
        if self._hit(self.config.send_truncate_p):
            self._count("client_truncate")
            with self._lock:
                return self._rng.randrange(1, max(nbytes, 2))
        return None

    def on_read(self) -> None:
        if self._hit(self.config.read_drip_p):
            self._count("read_drip")
            self._sleep(self.config.read_drip_ms / 1000.0)

    # -- scheduler seam ------------------------------------------------------

    def on_solve(self) -> None:
        """Called at the top of the scheduler's Solve phase when an
        injector is attached (``Scheduler(faults=...)``): a hit sleeps
        ``solve_delay_ms``, landing squarely in the round's
        ``scheduling_duration_seconds{phase="Solve"}`` observation."""
        if self._hit(self.config.solve_delay_p):
            self._count("solve_delay")
            self._sleep(self.config.solve_delay_ms / 1000.0)

    # -- server _Conn seam ---------------------------------------------------

    def outbound_action(self, is_push: bool) -> str | None:
        """One of None / "sever" / "truncate" / "drop" / "delay" /
        "duplicate" / "reorder" for a server-side outbound frame.
        Evaluated in severity order; at most one fault per frame."""
        if self._hit(self.config.send_sever_p):
            self._count("sever")
            return "sever"
        if self._hit(self.config.send_truncate_p):
            self._count("truncate")
            return "truncate"
        if is_push:
            if self._hit(self.config.push_drop_p):
                self._count("push_drop")
                return "drop"
            if self._hit(self.config.push_delay_p):
                self._count("push_delay")
                return "delay"
            if self._hit(self.config.push_duplicate_p):
                self._count("push_duplicate")
                return "duplicate"
            if self._hit(self.config.push_reorder_p):
                self._count("push_reorder")
                return "reorder"
        return None

    def truncate_at(self, nbytes: int) -> int:
        with self._lock:
            return self._rng.randrange(1, max(nbytes, 2))

    def delay(self) -> None:
        self._sleep(self.config.push_delay_ms / 1000.0)
