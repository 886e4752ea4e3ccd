"""The CRD objects the port's scheduler emits (from
``koordinator_tpu/api/crds.py``, which the port does not import: that
package's ``api`` pulls in JAX).  Only ``ScheduleExplanation``
(``scheduling.koordinator.sh_scheduleexplanations.yaml``) so far."""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple


@dataclasses.dataclass(frozen=True)
class ScheduleExplanation:
    """A persisted diagnosis of an unschedulable pod."""

    pod_uid: str
    pod_namespace: str = ""
    pod_name: str = ""
    reasons: Tuple[str, ...] = ()              # per-node or per-plugin failures
    node_offers: Mapping[str, str] = dataclasses.field(default_factory=dict)
    update_time: float = 0.0
