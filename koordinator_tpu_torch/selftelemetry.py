"""Process self-telemetry: the gauges the trend engine watches (port of
``koordinator_tpu/selftelemetry.py``, copied whole).

Every binary registers the same small set of process-health gauges —
RSS, open fds, live threads, interpreter allocation blocks, gc-tracked
objects, gc collections — labeled by ``binary`` so one aggregated
``/metrics`` scrape (or one shared soak-harness process) keeps the
series distinguishable.  The long-horizon trend engine
(:mod:`koordinator_tpu_torch.trend`) fits slopes over exactly these series to
answer "is this thing leaking under hours of churn"; the SLO
monitor's sampler picks them up like any other registry instrument.

Collection is deliberately O(1)-ish per sample: ``/proc/self/statm``
for RSS, one ``listdir`` for fds, ``sys.getallocatedblocks()`` (a
counter the allocator already maintains), ``len(gc.get_objects(0))``
(generation 0 only — a full ``gc.get_objects()`` walk is O(heap) and
would be the soak's own leak of CPU).  Platforms without procfs skip
the procfs-backed gauges rather than publishing zeros a trend fit
would read as a cliff.
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import time

from koordinator_tpu_torch import metrics

_PAGE_SIZE = float(os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf")
                   else 4096)


def rss_bytes() -> float | None:
    """Current resident set from ``/proc/self/statm`` (field 2, pages);
    None where procfs is absent — CURRENT, not the peak ru_maxrss,
    because a trend fit over a high-water mark can never see recovery."""
    try:
        with open("/proc/self/statm") as f:
            return float(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, IndexError, ValueError):
        return None


def open_fds() -> float | None:
    try:
        return float(len(os.listdir("/proc/self/fd")))
    except OSError:
        return None


class SelfTelemetry:
    """Samples the process gauges under one ``binary`` label.

    Drive it with :meth:`sample` (the SLO monitor's ``pre_sample`` hook
    and tests) or :meth:`start` (a background thread for binaries that
    run no SLO monitor — koordlet, manager).
    """

    def __init__(self, binary: str, clock=time.time):
        self.binary = binary
        self.clock = clock
        self.labels = {"binary": binary}
        self.samples = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def sample(self) -> None:
        rss = rss_bytes()
        if rss is not None:
            metrics.process_rss_bytes.set(rss, labels=self.labels)
        fds = open_fds()
        if fds is not None:
            metrics.process_open_fds.set(fds, labels=self.labels)
        metrics.process_threads.set(float(threading.active_count()),
                                    labels=self.labels)
        metrics.process_alloc_blocks.set(float(sys.getallocatedblocks()),
                                         labels=self.labels)
        # generation-0 tracked objects: cheap, and a container leak
        # churns through gen0 before it tenures
        metrics.process_gc_objects.set(float(len(gc.get_objects(0))),
                                       labels=self.labels)
        try:
            collections = sum(s.get("collections", 0)
                              for s in gc.get_stats())
        except Exception:  # noqa: BLE001 — stats shape is impl detail
            collections = 0
        metrics.process_gc_collections.set(float(collections),
                                           labels=self.labels)
        self.samples += 1

    # -- background sampler --------------------------------------------------

    def start(self, interval_s: float = 5.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.sample()
                except Exception:  # noqa: BLE001 — observer thread
                    pass

        self.sample()   # one sample up front: the trend window starts now
        self._thread = threading.Thread(
            target=loop, name=f"self-telemetry-{self.binary}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=5.0)
