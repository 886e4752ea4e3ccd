"""Scheduler startup sync barrier (the port's copy of
``koordinator_tpu/scheduler/barrier.py``, whole; reference:
``cmd/koord-scheduler/app/sync_barrier.go:70-229`` — after a restart, write
a barrier marker through the apiserver and refuse to schedule until the
informer stream has replayed past it, so decisions never run on a stale
cache).

Abstracted over the event source: ``mark()`` stamps a monotonically
increasing barrier version into the source (the reference patches a pod);
``observed_version()`` reports the latest version the informer has seen.
``wait_until_synced`` polls with a deadline. Pass the barrier to
``Scheduler(barrier=...)`` — rounds no-op until it opens.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class SyncBarrier:
    def __init__(
        self,
        mark: Callable[[], int],
        observed_version: Callable[[], int],
        timeout_seconds: float = 30.0,
        clock=time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self._mark = mark
        self._observed = observed_version
        self.timeout_seconds = timeout_seconds
        self.clock = clock
        self.sleep = sleep
        self._barrier_version: Optional[int] = None
        self.synced = False

    def start(self) -> int:
        """Stamp the barrier; scheduling stays gated until it is observed."""
        self._barrier_version = self._mark()
        self.synced = False
        return self._barrier_version

    def check(self) -> bool:
        """Non-blocking: has the informer replayed past the barrier?"""
        if self.synced:
            return True
        if self._barrier_version is None:
            return True  # never started: no gate (fresh process, empty cache)
        if self._observed() >= self._barrier_version:
            self.synced = True
        return self.synced

    def wait_until_synced(self, poll_interval: float = 0.05) -> bool:
        """Blocking wait with the configured timeout. On timeout the barrier
        OPENS anyway (the reference logs and proceeds — scheduling forever
        beats never scheduling) but returns False so callers can record it."""
        deadline = self.clock() + self.timeout_seconds
        while not self.check():
            if self.clock() >= deadline:
                self.synced = True
                return False
            self.sleep(poll_interval)
        return True
