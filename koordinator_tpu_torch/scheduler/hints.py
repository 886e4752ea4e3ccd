"""Scheduling hints, cross-scheduler nomination, in-place pod resize (port
of ``koordinator_tpu/scheduler/hints.py``; reference:
``frameworkext/hinter`` + ``plugins/schedulinghint``,
``frameworkext/cross_scheduler_nominator.go``, the ResizePod feature gate and
``RunResizePod``, ``framework_extender.go:837``).

- :class:`SchedulingHints`: per-pod preferred/excluded node sets recorded by
  earlier attempts or external hinters; consumed as a feasibility-mask edit
  plus a score bonus at batch-build time.
- :class:`CrossSchedulerNominator`: nominated (pod -> node, resources) from
  other scheduler instances; their claims are charged into the snapshot so a
  concurrently-deciding scheduler doesn't double-book the capacity.
- :func:`resize_pod`: validate + apply an in-place resource resize of a bound
  pod against its node's free capacity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot


@dataclasses.dataclass
class PodHint:
    preferred_nodes: set[str] = dataclasses.field(default_factory=set)
    excluded_nodes: set[str] = dataclasses.field(default_factory=set)
    #: bonus added to preferred nodes' scores (schedulinghint plugin weight)
    preference_bonus: int = 20


class SchedulingHints:
    def __init__(self, snapshot: ClusterSnapshot):
        self.snapshot = snapshot
        self._hints: dict[str, PodHint] = {}

    def set_hint(self, pod_name: str, hint: PodHint) -> None:
        self._hints[pod_name] = hint

    def record_failure(self, pod_name: str, node: str) -> None:
        """A failed placement excludes that node from the next attempt
        (the hinter's negative-cache behavior)."""
        self._hints.setdefault(pod_name, PodHint()).excluded_nodes.add(node)

    def clear(self, pod_name: str) -> None:
        self._hints.pop(pod_name, None)

    def has_hint(self, pod_name: str) -> bool:
        return pod_name in self._hints

    def apply_to_mask(self, pod_name: str, feasible: np.ndarray) -> np.ndarray:
        """Edit one pod's (N,) feasibility row: drop excluded nodes; if any
        preferred node is feasible, restrict to the preferred set (the
        skip/prefer semantics of the schedulinghint plugin)."""
        hint = self._hints.get(pod_name)
        if hint is None:
            return feasible
        out = feasible.copy()
        for node in hint.excluded_nodes:
            row = self.snapshot.node_index.get(node)
            if row is not None:
                out[row] = False
        if hint.preferred_nodes:
            preferred = np.zeros_like(out)
            any_pref = False
            for node in hint.preferred_nodes:
                row = self.snapshot.node_index.get(node)
                if row is not None and out[row]:
                    preferred[row] = True
                    any_pref = True
            if any_pref:
                out = preferred
        return out


class CrossSchedulerNominator:
    """Nominations made by OTHER schedulers: charge their claimed resources
    into the snapshot so this scheduler's solve sees them as used; release
    when the owning scheduler binds or abandons."""

    def __init__(self, snapshot: ClusterSnapshot):
        self.snapshot = snapshot
        #: (node, requests, node_generation) — the release must target
        #: the node INSTANCE the charge was made against
        self._nominations: dict[str, tuple[str, np.ndarray, int]] = {}

    def nominate(self, pod_uid: str, node: str, requests: np.ndarray) -> bool:
        if pod_uid in self._nominations:
            return False
        if node not in self.snapshot.node_index:
            return False
        self.snapshot.reserve(node, requests)
        self._nominations[pod_uid] = (
            node, np.asarray(requests),
            self.snapshot.node_generation.get(node, 0))
        return True

    def release(self, pod_uid: str) -> None:
        entry = self._nominations.pop(pod_uid, None)
        if entry is None:
            return
        node, requests, generation = entry
        self.snapshot.unreserve_instance(node, requests, generation)

    def nominated_node(self, pod_uid: str) -> Optional[str]:
        entry = self._nominations.get(pod_uid)
        return entry[0] if entry else None


def resize_pod(
    snapshot: ClusterSnapshot,
    node: str,
    old_requests: np.ndarray,
    new_requests: np.ndarray,
) -> tuple[bool, str]:
    """In-place resize of a bound pod (ResizePod/RunResizePod): the delta must
    fit the node's remaining free capacity; growth is charged, shrink is
    released. Returns (ok, reason)."""
    row = snapshot.node_index.get(node)
    if row is None:
        return False, f"node {node} not found"
    old = np.asarray(old_requests, np.int64)
    new = np.asarray(new_requests, np.int64)
    delta = new - old
    if np.any(delta > 0):
        snapshot.flush()
        free = snapshot.state.free[row].cpu().numpy()
        if np.any(delta > free):
            lacking = int(np.argmax(delta - free))
            return False, f"insufficient free capacity on dim {lacking}"
    grow = np.maximum(delta, 0).astype(np.int32)
    shrink = np.maximum(-delta, 0).astype(np.int32)
    if grow.any():
        snapshot.reserve(node, grow)
    if shrink.any():
        snapshot.unreserve(node, shrink)
    return True, ""
