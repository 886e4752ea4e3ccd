"""QoS classes (a copy of ``koordinator_tpu/api/qos.py``).

Reference: ``apis/extension/qos.go:19-28`` defines five QoS classes
(LSE/LSR/LS/BE/SYSTEM) carried on pods via the ``koordinator.sh/qosClass`` label
(``apis/extension/constants.go:33``).

Here each class is an integer code so a batch of pods carries a ``(P,)`` int8
tensor of QoS classes, and QoS-conditional math (e.g. the load-aware estimator's
QoS-dependent scaling factors) is a gather over a small per-class constant table
instead of branching.
"""

from __future__ import annotations

import enum


class QoSClass(enum.IntEnum):
    """Pod QoS class, ordered roughly by "sensitivity" (higher = more sensitive).

    Integer codes are stable protocol values used inside tensors; do not reorder.
    """

    NONE = 0
    BE = 1      # best-effort batch: may be suppressed/evicted
    LS = 2      # latency-sensitive, shares cores
    LSR = 3     # latency-sensitive reserved: exclusive cpuset
    LSE = 4     # latency-sensitive exclusive: exclusive cpuset, no BE sharing
    SYSTEM = 5  # node system agents

    @classmethod
    def parse(cls, s: str) -> "QoSClass":
        """Parse the label value form ("LS", "BE", ...); empty/unknown -> NONE."""
        try:
            return cls[s.upper()] if s else cls.NONE
        except KeyError:
            return cls.NONE

    @property
    def is_latency_sensitive(self) -> bool:
        return self in (QoSClass.LS, QoSClass.LSR, QoSClass.LSE)

    @property
    def is_best_effort(self) -> bool:
        return self is QoSClass.BE


NUM_QOS_CLASSES = len(QoSClass)
