"""koord-runtime-proxy: CRI-interposing proxy (port of
``koordinator_tpu/runtimeproxy.py``; reference:
``pkg/runtimeproxy/`` — gRPC service ``apis/runtime/v1alpha1/api.proto:148``
PreRunPodSandboxHook/PreCreateContainerHook/..., dispatcher
``dispatcher/dispatcher.go``, failover store ``store/``).

The legacy path for runtimes without NRI: kubelet's CRI calls pass through
this proxy, which consults registered hook servers before/after forwarding to
the real runtime. Transport here is in-process callables (the gRPC framing is
a deployment detail); semantics preserved:

- **fail-open dispatch**: a hook server error never blocks the CRI call —
  the request passes through unmodified (dispatcher.go behavior).
- **hook response merging**: hook servers return partial updates (labels,
  annotations, cgroup parent, resources, envs) merged into the CRI request.

Only the hook types and the dispatcher are copied so far, for
``transport.services.HookService``; the failover store and the CRI
interposer come with the runtime hooks.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Optional, Protocol


class HookType(enum.Enum):
    PRE_RUN_POD_SANDBOX = "PreRunPodSandbox"
    PRE_CREATE_CONTAINER = "PreCreateContainer"
    PRE_START_CONTAINER = "PreStartContainer"
    POST_START_CONTAINER = "PostStartContainer"
    PRE_UPDATE_CONTAINER_RESOURCES = "PreUpdateContainerResources"
    POST_STOP_POD_SANDBOX = "PostStopPodSandbox"


@dataclasses.dataclass
class HookRequest:
    """The CRI-call context handed to hook servers (api.proto shapes)."""

    pod_meta: dict = dataclasses.field(default_factory=dict)
    container_meta: dict = dataclasses.field(default_factory=dict)
    labels: dict = dataclasses.field(default_factory=dict)
    annotations: dict = dataclasses.field(default_factory=dict)
    cgroup_parent: str = ""
    resources: dict = dataclasses.field(default_factory=dict)
    envs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class HookResponse:
    """Partial updates to merge back into the CRI request."""

    labels: dict = dataclasses.field(default_factory=dict)
    annotations: dict = dataclasses.field(default_factory=dict)
    cgroup_parent: str = ""
    resources: dict = dataclasses.field(default_factory=dict)
    envs: dict = dataclasses.field(default_factory=dict)


class HookServer(Protocol):
    def handle(self, hook: HookType, request: HookRequest) -> Optional[HookResponse]: ...


class Dispatcher:
    """Routes hooks to registered servers, fail-open (dispatcher.go)."""

    def __init__(self):
        self._servers: dict[HookType, list[HookServer]] = {t: [] for t in HookType}
        self._lock = threading.Lock()

    def register(self, server: HookServer, hooks: list[HookType]) -> None:
        with self._lock:
            for hook in hooks:
                self._servers[hook].append(server)

    def dispatch(self, hook: HookType, request: HookRequest) -> HookRequest:
        with self._lock:
            servers = list(self._servers[hook])
        for server in servers:
            try:
                response = server.handle(hook, request)
            except Exception:  # noqa: BLE001 — fail-open by contract
                continue
            if response is None:
                continue
            request.labels.update(response.labels)
            request.annotations.update(response.annotations)
            if response.cgroup_parent:
                request.cgroup_parent = response.cgroup_parent
            request.resources.update(response.resources)
            request.envs.update(response.envs)
        return request

