"""RPC services over the framed transport (port of
``koordinator_tpu/transport/services.py``).

- :class:`SolveService` is the ``framework.Plugin`` extension seam
  (SURVEY.md §2.11 / §7 step 4): the protocol shell asks the solver
  sidecar for a scheduling round and gets assignments + failure reasons
  back. In the reference this boundary is the upstream scheduler calling
  plugin Filter/Score/Reserve in-process; here the whole batched round is
  one RPC, so the wire crossing is per-round, not per-pod-per-node.
- :class:`HookService` carries the runtime-hook dispatch
  (``apis/runtime/v1alpha1/api.proto:148`` PreRunPodSandboxHook et al)
  over the same frames, fail-open like the runtime proxy.
"""

from __future__ import annotations

from typing import Optional

from koordinator_tpu_torch.transport.wire import FrameType


class SolveService:
    """Server side: schedule_round over the wire.

    Honors per-call deadlines: solve rounds serialize on the scheduler
    lock, so a request can spend its whole budget just WAITING — once it
    has, the caller's RpcClient has already timed out and running the
    solve computes assignments nobody will read (worse: it burns the
    round lock the NEXT caller is queued behind).  The expiry check runs
    after the lock is acquired, which is exactly where the time went."""

    def __init__(self, scheduler):
        self.scheduler = scheduler
        self.sheds = 0

    def attach(self, server) -> None:
        server.register(FrameType.SOLVE_REQUEST, self._handle)

    def _handle(self, doc: dict, arrays):
        import time

        from koordinator_tpu_torch import metrics
        from koordinator_tpu_torch.transport.channel import DeadlineExpired

        expires = doc.get("__expires_at__")
        with self.scheduler.lock:
            if expires is not None and time.monotonic() >= expires:
                self.sheds += 1
                metrics.solve_deadline_shed_total.inc()
                raise DeadlineExpired(
                    "solve deadline expired while waiting for the round "
                    "lock; request shed without solving")
            result = self.scheduler.schedule_round()
        return {
            "assignments": dict(result.assignments),
            "failures": {name: diag.message()
                         for name, diag in result.failures.items()},
            "nominations": {p: [n, v] for p, (n, v)
                            in result.nominations.items()},
            "round_pods": result.round_pods,
        }, None


def solve_remote(client, deadline_ms: float | None = None) -> dict:
    """Client side: one scheduling round on the remote solver.
    ``deadline_ms`` bounds the wait AND lets the server shed the round
    if it cannot start before the budget is gone."""
    _, doc, _ = client.call(FrameType.SOLVE_REQUEST, {},
                            deadline_ms=deadline_ms)
    return doc


class HookService:
    """Server side: runtime-hook dispatch (NRI/proxy seam)."""

    def __init__(self, dispatcher):
        self.dispatcher = dispatcher

    def attach(self, server) -> None:
        server.register(FrameType.HOOK_REQUEST, self._handle)

    def _handle(self, doc: dict, arrays):
        from koordinator_tpu_torch.runtimeproxy import HookRequest, HookType

        hook = HookType(doc["hook"])
        request = HookRequest(
            pod_meta=doc.get("pod_meta", {}),
            container_meta=doc.get("container_meta", {}),
            labels=doc.get("labels", {}),
            annotations=doc.get("annotations", {}),
            cgroup_parent=doc.get("cgroup_parent", ""),
            resources=doc.get("resources", {}),
            envs=doc.get("envs", {}),
        )
        merged = self.dispatcher.dispatch(hook, request)
        return {
            "labels": merged.labels,
            "annotations": merged.annotations,
            "cgroup_parent": merged.cgroup_parent,
            "resources": merged.resources,
            "envs": merged.envs,
        }, None


def hook_remote(client, hook, request, fail_open: bool = True) -> Optional[dict]:
    """Client side: dispatch one hook remotely. Fail-open returns None on
    transport errors (the proxy must never wedge the CRI path —
    dispatcher.go fail-open semantics)."""
    from koordinator_tpu_torch.transport.channel import RpcError

    doc = {
        "hook": hook.value,
        "pod_meta": request.pod_meta,
        "container_meta": request.container_meta,
        "labels": request.labels,
        "annotations": request.annotations,
        "cgroup_parent": request.cgroup_parent,
        "resources": request.resources,
        "envs": request.envs,
    }
    try:
        _, out, _ = client.call(FrameType.HOOK_REQUEST, doc)
        return out
    except RpcError:
        if fail_open:
            return None
        raise
