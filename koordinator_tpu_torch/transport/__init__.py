"""The wire-protocol layer: framed RPC + incremental cluster-state sync
(port of ``koordinator_tpu/transport/__init__.py``).

The reference's deployment seams are all remote-procedure boundaries:
CRI/NRI hook gRPC (``apis/runtime/v1alpha1/api.proto:148``, ``pkg/koordlet/
runtimehooks/nri/server.go``), the kubelet HTTPS stub, and apiserver watch
streams feeding informers (SURVEY.md §5 "distributed communication
backend"). The rebuild's equivalent (SURVEY.md §7 step 4) is the
sidecar bridge between the protocol shell and the device-resident solver:
a snapshot + resource-version'd delta stream so the solver's device
buffers are updated by scatter, never rebuilt, plus solve/hook RPCs over
the same framed transport.
"""

from koordinator_tpu_torch.transport.wire import (  # noqa: F401
    Frame,
    FrameType,
    decode_payload,
    encode_payload,
)
from koordinator_tpu_torch.transport.channel import (  # noqa: F401
    DeadlineExpired,
    RpcClient,
    RpcDeadlineError,
    RpcError,
    RpcRemoteError,
    RpcServer,
)
from koordinator_tpu_torch.transport.deltasync import (  # noqa: F401
    DeltaLog,
    ResyncRequired,
    StateSyncClient,
    StateSyncService,
    UnknownNodeError,
)
from koordinator_tpu_torch.transport.faults import (  # noqa: F401
    ASYM_SEND,
    PARTITION,
    REFUSE,
    FaultConfig,
    FaultInjector,
    FaultSchedule,
    StormWindow,
    domains_from_labels,
)
from koordinator_tpu_torch.transport.retry import (  # noqa: F401
    CircuitBreaker,
    RetryPolicy,
    RetrySchedule,
)
