"""Host snapshot and the reduced scheduling round of the port.

- ``snapshot``    -- host->device cluster-state sync (name->row maps,
                     delta row updates, capacity bucketing)
- ``scheduler``   -- the scheduling round: queue, gangs, reservations,
                     batched solve, bind, Diagnose, preemption
- ``diagnosis``   -- structured "why unschedulable" diagnoses
                     (schedule_diagnosis.go)
- ``explanation`` -- placement explanations, ScheduleExplanation
                     persistence and the workload auditor
"""

from koordinator_tpu_torch.scheduler.snapshot import (
    ClusterSnapshot,
    NodeSpec,
    PodSpec,
)
from koordinator_tpu_torch.scheduler.scheduler import (
    Scheduler,
    SchedulingResult,
)
from koordinator_tpu_torch.scheduler.diagnosis import (
    PodDiagnosis,
    diagnosis_from_counts,
    explain_pod,
)
from koordinator_tpu_torch.scheduler.explanation import (
    AuditEvent,
    ExplanationRing,
    ExplanationStore,
    PlacementExplanation,
    WorkloadAuditor,
)

__all__ = [
    "AuditEvent",
    "ClusterSnapshot",
    "ExplanationRing",
    "ExplanationStore",
    "NodeSpec",
    "PlacementExplanation",
    "PodDiagnosis",
    "PodSpec",
    "Scheduler",
    "SchedulingResult",
    "WorkloadAuditor",
    "diagnosis_from_counts",
    "explain_pod",
]
