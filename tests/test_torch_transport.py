"""The port's transport bindings (``koordinator_tpu_torch/transport``) against
the JAX package's, over real sockets.

Each case of ``tests/test_transport.py`` that concerns the scheduler runs
the same script on both packages: a ``StateSyncService`` on an
``RpcServer``, a ``Scheduler`` fed through ``StateSyncClient`` and
``SchedulerBinding`` and solved through ``SolveService``/``solve_remote``.
Every check of the JAX case holds on the port, and the two packages'
outcomes (the rounds' assignments and failure messages, the sync
counters and ``sync_fingerprint``: registries, snapshot rows, pending and
bound pods) are equal.  The cases that drive the JAX package's scheduler
binaries (``main_koord_scheduler``) feed the scheduler through an
in-process binding on the service instead, as those binaries do.  The
interop cases cross the packages: a JAX ``StateSyncService`` feeds one JAX
and one port scheduler (and a port service one of each), and their
fingerprints and first round agree.

Every client is closed and every server stopped in a ``finally``; every
wait has a timeout.
"""

import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

from tests.torch_parity import (
    PKGS,
    R,
    reset_observability,
    rv,
    set_torch_threads,
    side,
    sync_fingerprint,
    wait_until,
)

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh_observability():
    reset_observability()
    yield
    reset_observability()


class Rig:
    """A server and the clients of one case; ``close`` is idempotent."""

    def __init__(self, s, path: str):
        self.s = s
        self.server = s.RpcServer(path)
        self.clients: list = []

    def connect(self, **kw):
        # a JAX round may compile first: a call waits up to a minute
        kw.setdefault("timeout", 60.0)
        client = self.s.RpcClient(self.server.address, **kw)
        self.clients.append(client)
        client.connect()
        return client

    def close(self) -> None:
        for c in self.clients:
            c.close()
        self.server.stop()


def both(script) -> list:
    """Run ``script(s, tmpdir)`` on each package (each in its own short
    socket directory, its rig closed in a finally); the outcomes must be
    equal.  Returns them."""
    outs = []
    for pkg in PKGS:
        d = tempfile.mkdtemp(prefix="kt")
        try:
            outs.append(script(side(pkg), d))
        finally:
            for name in os.listdir(d):
                os.unlink(os.path.join(d, name))
            os.rmdir(d)
    assert outs[0] == outs[1]
    return outs


def rounds_doc(result: dict) -> dict:
    return {k: result[k] for k in ("assignments", "failures", "nominations",
                                   "round_pods")}


def sync_stack(s, rig, sched, **client_kw):
    """A StateSyncClient over ``sched`` on a fresh client of ``rig``."""
    sync = s.StateSyncClient(s.SchedulerBinding(sched))
    client = rig.connect(on_push=sync.on_push, **client_kw)
    return sync, client


# -- the cases of tests/test_transport.py -------------------------------------


def test_sync_snapshot_deltas_and_solve_end_to_end():
    def script(s, d):
        rig = Rig(s, os.path.join(d, "s.sock"))
        try:
            service = s.StateSyncService()
            service.attach(rig.server)
            service.upsert_node("n1", rv(16_000, 65_536))
            service.add_pod("p1", rv(1_000, 1_024))
            sched = s.scheduler()
            s.SolveService(sched).attach(rig.server)
            rig.server.start()
            sync, client = sync_stack(s, rig, sched)
            applied = sync.bootstrap(client)
            assert applied == 2 and sync.rv == service.rv
            out = [rounds_doc(s.solve_remote(client))]
            assert out[0]["assignments"] == {"p1": "n1"}
            service.upsert_node("n2", rv(16_000, 65_536))
            service.add_pod("p2", rv(1_000, 1_024), node_selector={})
            wait_until(lambda: sync.rv == service.rv)
            out.append(rounds_doc(s.solve_remote(client)))
            assert "p2" in out[-1]["assignments"]
            service.add_pod("p3", rv(99_000, 1))
            wait_until(lambda: sync.rv == service.rv)
            out.append(rounds_doc(s.solve_remote(client)))
            assert "p3" in out[-1]["failures"]
            service.remove_pod("p3")
            wait_until(lambda: sync.rv == service.rv)
            assert "p3" not in sched.pending
            return out, sync_fingerprint(sched)
        finally:
            rig.close()

    both(script)


def test_delta_burst_within_retention_survives_the_wire():
    def script(s, d):
        rig = Rig(s, os.path.join(d, "s.sock"))
        try:
            service = s.StateSyncService()
            service.attach(rig.server)
            rig.server.start()
            service.upsert_node("n1", rv(16_000, 65_536))
            sched = s.scheduler()
            sync, client = sync_stack(s, rig, sched)
            sync.bootstrap(client)
            n_burst = 1_024
            for i in range(n_burst):
                service.update_node_usage("n1", rv(100 + i, 1_024))
            wait_until(lambda: sync.rv == service.rv, timeout=30.0)
            assert client.connected, "burst poisoned the connection"
            assert sync.applied >= n_burst
            spec = sched.snapshot.node_specs["n1"]
            assert spec.usage[0] == 100 + n_burst - 1
            return sync_fingerprint(sched)
        finally:
            rig.close()

    both(script)


def test_sync_reconnect_resumes_from_rv():
    def script(s, d):
        rig = Rig(s, os.path.join(d, "s.sock"))
        try:
            service = s.StateSyncService()
            service.attach(rig.server)
            rig.server.start()
            service.upsert_node("n1", rv(16_000, 65_536))
            sched = s.scheduler()
            sync, client = sync_stack(s, rig, sched)
            sync.bootstrap(client)
            rv_before = sync.rv
            client.close()
            service.add_pod("p1", rv(1_000, 1_024))
            service.upsert_node("n2", rv(16_000, 65_536))
            client2 = rig.connect(on_push=sync.on_push)
            applied = sync.bootstrap(client2)
            assert applied == 2
            assert sync.rv == service.rv > rv_before
            assert "p1" in sched.pending
            assert "n2" in sched.snapshot.node_index
            return sync_fingerprint(sched)
        finally:
            rig.close()

    both(script)


def test_hello_detects_service_restart_despite_rv_collision():
    def script(s, d):
        sock = os.path.join(d, "epoch.sock")
        sched = s.scheduler()
        sync = s.StateSyncClient(s.SchedulerBinding(sched))
        rigs = []
        try:
            def boot(node_name):
                rig = Rig(s, sock)
                rigs.append(rig)
                service = s.StateSyncService()
                service.attach(rig.server)
                rig.server.start()
                service.upsert_node(node_name, rv(8_000, 8_192))
                return rig, service

            rig1, service1 = boot("n-old")
            client = rig1.connect(on_push=sync.on_push)
            sync.bootstrap(client)
            assert sync.rv == service1.rv == 1
            assert sync.instance == service1.instance
            rig1.close()
            rig2, service2 = boot("n-new")
            assert service2.rv == 1 and service2.instance != service1.instance
            client2 = rig2.connect(on_push=sync.on_push)
            applied = sync.bootstrap(client2)
            assert applied == 1, "rv collision returned ACK, not snapshot"
            assert sync.instance == service2.instance
            assert sorted(sched.snapshot.node_index) == ["n-new"]
            assert sync.bootstrap(client2) == 0
            return sync_fingerprint(sched)
        finally:
            for rig in rigs:
                rig.close()

    both(script)


def test_sync_falls_back_to_snapshot_beyond_retention():
    def script(s, d):
        rig = Rig(s, os.path.join(d, "s.sock"))
        try:
            service = s.StateSyncService(retention=2)
            service.attach(rig.server)
            rig.server.start()
            service.upsert_node("n1", rv(16_000, 65_536))
            sched = s.scheduler()
            sync, client = sync_stack(s, rig, sched)
            sync.bootstrap(client)
            client.close()
            for i in range(5):
                service.upsert_node(f"m{i}", rv(8_000, 8_192))
            service.remove_node("n1")
            client2 = rig.connect(on_push=sync.on_push)
            sync.bootstrap(client2)
            assert sync.rv == service.rv
            assert "n1" not in sched.snapshot.node_index
            assert all(f"m{i}" in sched.snapshot.node_index
                       for i in range(5))
            return sync_fingerprint(sched)
        finally:
            rig.close()

    both(script)


def test_sync_replay_overlap_is_idempotent():
    def script(s, d):
        rig = Rig(s, os.path.join(d, "s.sock"))
        try:
            service = s.StateSyncService()
            service.attach(rig.server)
            rig.server.start()
            service.add_pod("p1", rv(1_000, 1_024))
            sched = s.scheduler()
            sync, client = sync_stack(s, rig, sched)
            sync.bootstrap(client)
            rev = sched._pending_rev
            ftype, doc, arrays = client.call(
                s.FrameType.HELLO,
                {"last_rv": 0, "proto": s.wire.PROTOCOL_VERSION})
            assert ftype is s.FrameType.DELTA
            sync._apply(doc, arrays)
            assert sync.skipped >= 1
            assert sched._pending_rev == rev
            return sync.skipped, sync_fingerprint(sched)
        finally:
            rig.close()

    both(script)


def test_hook_rpc_roundtrip_and_fail_open():
    def script(s, d):
        rp = s.runtimeproxy
        rig = Rig(s, os.path.join(d, "s.sock"))
        try:
            dispatcher = rp.Dispatcher()

            class BvtServer:
                def handle(self, hook, request):
                    return rp.HookResponse(
                        annotations={"koordinator.sh/bvt": "2"},
                        envs={"SEEN": request.pod_meta.get("uid", "")})

            dispatcher.register(BvtServer(), [rp.HookType.PRE_RUN_POD_SANDBOX])
            s.services.HookService(dispatcher).attach(rig.server)
            rig.server.start()
            client = rig.connect()
            out = s.services.hook_remote(
                client, rp.HookType.PRE_RUN_POD_SANDBOX,
                rp.HookRequest(pod_meta={"uid": "u1"}))
            assert out["annotations"]["koordinator.sh/bvt"] == "2"
            assert out["envs"]["SEEN"] == "u1"
            client.close()
            assert s.services.hook_remote(
                client, rp.HookType.PRE_RUN_POD_SANDBOX,
                rp.HookRequest()) is None
            with pytest.raises(s.RpcError):
                s.services.hook_remote(client,
                                       rp.HookType.PRE_RUN_POD_SANDBOX,
                                       rp.HookRequest(), fail_open=False)
            return out
        finally:
            rig.close()

    both(script)


def test_service_restart_with_lower_rv_forces_snapshot():
    def script(s, d):
        rig = Rig(s, os.path.join(d, "s.sock"))
        try:
            service = s.StateSyncService()
            service.attach(rig.server)
            rig.server.start()
            service.upsert_node("n1", rv(16_000, 65_536))
            sched = s.scheduler()
            sync, client = sync_stack(s, rig, sched)
            sync.bootstrap(client)
            sync.rv = 100
            applied = sync.bootstrap(client)
            assert applied == 1
            assert sync.rv == service.rv == 1
            service.add_pod("p1", rv(1_000, 1_024))
            wait_until(lambda: "p1" in sched.pending)
            return sync_fingerprint(sched)
        finally:
            rig.close()

    both(script)


def test_concurrent_mutations_solves_and_pushes():
    """One thread mutates the informer state while the main thread runs
    solve RPCs (a shortened switch interval forces interleaving): the
    scheduler lock and the rv order place every pod exactly once, and the
    node accounting equals the placed pods'."""
    n_pods = 30

    def script(s, d):
        rig = Rig(s, os.path.join(d, "s.sock"))
        interval = sys.getswitchinterval()
        th = None
        try:
            service = s.StateSyncService()
            service.attach(rig.server)
            sched = s.scheduler()
            s.SolveService(sched).attach(rig.server)
            rig.server.start()
            sync, client = sync_stack(s, rig, sched, timeout=60)
            service.upsert_node("n1", rv(100_000, 65_536))
            sync.bootstrap(client)
            sys.setswitchinterval(1e-5)

            def mutate():
                for i in range(n_pods):
                    service.add_pod(f"p{i}", rv(100, 16))

            th = threading.Thread(target=mutate)
            th.start()
            assigned = {}
            for _ in range(50):
                assigned.update(s.solve_remote(client)["assignments"])
                if len(assigned) == n_pods and not th.is_alive():
                    break
                time.sleep(0.01)
            th.join(30)
            assert not th.is_alive()
            sys.setswitchinterval(interval)
            wait_until(lambda: sync.rv == service.rv)
            assigned.update(s.solve_remote(client)["assignments"])
            assert len(assigned) == n_pods
            assert not sched.pending
            fp = sync_fingerprint(sched)
            row = sched.snapshot.node_index["n1"]
            assert fp["state"]["node_requested"][row][0] == 100 * n_pods
            return sorted(assigned.items()), fp["state"]
        finally:
            sys.setswitchinterval(interval)
            if th is not None:
                th.join(30)
            rig.close()

    both(script)


def test_bound_pod_delete_releases_reservation_and_quota():
    def script(s, d):
        rig = Rig(s, os.path.join(d, "s.sock"))
        try:
            service = s.StateSyncService()
            service.attach(rig.server)
            rig.server.start()
            tree = s.QuotaTree(rv(16_000, 65_536).astype(np.int64))
            tree.add("team", min=rv(1_000).astype(np.int64),
                     max=np.full(R, s.UNBOUNDED, np.int64))
            sched = s.scheduler(quota_tree=tree)
            s.SolveService(sched).attach(rig.server)
            sync, client = sync_stack(s, rig, sched)
            sync.bootstrap(client)
            service.upsert_node("n1", rv(16_000, 65_536))
            service.add_pod("p1", rv(16_000, 1_024), quota="team")
            wait_until(lambda: sync.rv == service.rv)
            out = [rounds_doc(s.solve_remote(client))]
            assert out[0]["assignments"] == {"p1": "n1"}
            assert tree.nodes["team"].used[0] == 16_000
            service.remove_pod("p1")
            wait_until(lambda: tree.nodes["team"].used[0] == 0)
            assert "p1" not in sched.bound
            service.add_pod("p2", rv(16_000, 1_024), quota="team")
            wait_until(lambda: sync.rv == service.rv)
            out.append(rounds_doc(s.solve_remote(client)))
            assert out[1]["assignments"] == {"p2": "n1"}
            return out, tree.nodes["team"].used.tolist()
        finally:
            rig.close()

    both(script)


def test_snapshot_resync_releases_bound_state():
    def script(s, d):
        rig = Rig(s, os.path.join(d, "s.sock"))
        try:
            service = s.StateSyncService(retention=1)
            service.attach(rig.server)
            rig.server.start()
            binds = []
            sched = s.scheduler(bind_fn=lambda p, n: binds.append((p, n)))
            s.SolveService(sched).attach(rig.server)
            sync, client = sync_stack(s, rig, sched)
            service.upsert_node("n1", rv(16_000, 65_536))
            service.add_pod("p1", rv(16_000, 1_024))
            sync.bootstrap(client)
            s.solve_remote(client)
            assert "p1" in sched.bound
            client.close()
            for i in range(4):
                service.upsert_node(f"m{i}", rv(8_000, 8_192))
            client2 = rig.connect(on_push=sync.on_push)
            sync.bootstrap(client2)
            assert not sched.bound
            result = rounds_doc(s.solve_remote(client2))
            assert result["assignments"] == {"p1": "n1"}
            return binds, result, sync_fingerprint(sched)
        finally:
            rig.close()

    both(script)


def test_reservation_sync_over_the_wire():
    def script(s, d):
        rig = Rig(s, os.path.join(d, "s.sock"))
        try:
            service = s.StateSyncService()
            service.attach(rig.server)
            rig.server.start()
            sched = s.scheduler()
            s.SolveService(sched).attach(rig.server)
            sync, client = sync_stack(s, rig, sched)
            sync.bootstrap(client)
            service.upsert_node("n1", rv(10_000, 65_536))
            service.upsert_reservation(
                "rsv-a", rv(8_000, 8_192).astype(np.int64),
                owners=[{"labels": {"app": "web"}}])
            wait_until(lambda: sync.rv == service.rv)
            out = [rounds_doc(s.solve_remote(client))]
            assert sched.reservations.get("rsv-a").node == "n1"
            service.add_pod("other", rv(4_000, 1_024))
            wait_until(lambda: sync.rv == service.rv)
            out.append(rounds_doc(s.solve_remote(client)))
            assert "other" in out[-1]["failures"]
            service.add_pod("web-1", rv(6_000, 1_024),
                            labels={"app": "web"})
            wait_until(lambda: sync.rv == service.rv)
            out.append(rounds_doc(s.solve_remote(client)))
            assert out[-1]["assignments"].get("web-1") == "n1"
            assert sched.reservations.get("rsv-a").allocated[0] == 6_000
            service.remove_pod("web-1")
            wait_until(lambda: "web-1" not in sched.bound)
            service.remove_reservation("rsv-a")
            wait_until(lambda: sync.rv == service.rv)
            out.append(rounds_doc(s.solve_remote(client)))
            assert out[-1]["assignments"].get("other") == "n1"
            return out, sync_fingerprint(sched)
        finally:
            rig.close()

    both(script)


def test_reservation_in_snapshot_resync():
    def script(s, d):
        rig = Rig(s, os.path.join(d, "s.sock"))
        try:
            service = s.StateSyncService()
            service.attach(rig.server)
            service.upsert_node("n1", rv(10_000, 65_536))
            service.upsert_reservation(
                "rsv-a", rv(6_000, 4_096).astype(np.int64),
                owners=[{"labels": {"app": "web"}}])
            rig.server.start()
            sched = s.scheduler()
            s.SolveService(sched).attach(rig.server)
            sync, client = sync_stack(s, rig, sched)
            sync.bootstrap(client)
            out = rounds_doc(s.solve_remote(client))
            assert sched.reservations.get("rsv-a").node == "n1"
            return out, sync_fingerprint(sched)
        finally:
            rig.close()

    both(script)


def nrt(cpus: int, per_core: int = 2, per_numa: int = 4) -> dict:
    """The koordlet's cpu-topology annotation (NodeTopology's shape)."""
    detail = [{"cpu": c, "core": c // per_core, "socket": 0,
               "node": c // per_numa} for c in range(cpus)]
    return {"node.koordinator.sh/cpu-topology":
            json.dumps({"detail": detail}, sort_keys=True)}


def gpu_vec(gpu: int, gpu_mem: int, cpu: int = 16_000,
            memory: int = 65_536) -> np.ndarray:
    return rv(cpu, memory, **{"kubernetes.io/gpu": gpu,
                              "kubernetes.io/gpu-memory": gpu_mem})


def test_fine_grained_registries_ride_node_sync():
    def script(s, d):
        rig = Rig(s, os.path.join(d, "s.sock"))
        try:
            service = s.StateSyncService()
            service.attach(rig.server)
            rig.server.start()
            sched = s.scheduler(managers=True)
            s.SolveService(sched).attach(rig.server)
            sync, client = sync_stack(s, rig, sched)
            sync.bootstrap(client)
            service.upsert_node(
                "n1", gpu_vec(400, 81_920 * 4), annotations=nrt(8),
                devices={"gpu": [{"core": 100, "memory": 81_920,
                                  "group": 0} for _ in range(4)]})
            wait_until(lambda: sync.rv == service.rv)
            service.add_pod("lsr-1", rv(2_000, 512), priority=9_000, qos=3)
            wait_until(lambda: sync.rv == service.rv)
            out = [rounds_doc(s.solve_remote(client))]
            assert out[0]["assignments"]["lsr-1"] == "n1"
            assert len(sched.resource_status["lsr-1"]["resource-status"]
                       ["cpuset"].split(",")) == 2
            service.add_pod("gpu-1", gpu_vec(100, 8_192, 1_000, 512))
            wait_until(lambda: sync.rv == service.rv)
            out.append(rounds_doc(s.solve_remote(client)))
            assert out[-1]["assignments"]["gpu-1"] == "n1"
            assert sched.resource_status["gpu-1"]["device-allocated"]["gpu"]
            return out, sched.resource_status, sync_fingerprint(sched)
        finally:
            rig.close()

    both(script)


class TestLocalBindings:
    """StateSyncService.attach_binding: the in-process feed."""

    def test_synchronous_apply_in_rv_order(self):
        def script(s, d):
            applied = []

            class Recorder:
                def node_upsert(self, entry, arrs):
                    applied.append(("node", entry["name"]))

                def pod_add(self, entry, arrs):
                    applied.append(("pod", entry["name"]))

                def pod_remove(self, name):
                    applied.append(("rm", name))

            service = s.StateSyncService()
            service.attach_binding(Recorder())
            service.upsert_node("n1", rv(8_000, 8_192))
            service.add_pod("p1", rv(500, 512))
            service.remove_pod("p1")
            assert applied == [("node", "n1"), ("pod", "p1"), ("rm", "p1")]
            return applied

        both(script)

    def test_service_stays_live_while_a_binding_apply_blocks(self):
        def script(s, d):
            gate = threading.Event()
            entered = threading.Event()

            class Stuck:
                def node_upsert(self, entry, arrs):
                    entered.set()
                    assert gate.wait(10), "test gate never opened"

            service = s.StateSyncService()
            service.attach_binding(Stuck())
            pusher = threading.Thread(
                target=lambda: service.upsert_node("slow", rv(1_000, 1_024)),
                daemon=True)
            pusher.start()
            try:
                assert entered.wait(5), "binding apply never started"
                doc, _ = service._handle_hello({"last_rv": -1, "proto": 3},
                                               {})
                assert doc["rv"] == 1 and len(doc["events"]) == 1
            finally:
                gate.set()
                pusher.join(5)
            assert not pusher.is_alive()
            return doc["rv"]

        both(script)


def local_stack(s, d, managers: bool = True):
    """The scheduler binaries' wiring: the scheduler fed through an
    in-process binding on a service served at ``d``."""
    sched = s.scheduler(capacity=8, managers=managers)
    rig = Rig(s, os.path.join(d, "dev.sock"))
    service = s.StateSyncService()
    service.attach(rig.server)
    service.attach_binding(s.SchedulerBinding(sched))
    rig.server.start()
    return sched, rig, service


def valid_count(state) -> int:
    from tests.torch_parity import host

    return 0 if state is None else int(host(state.valid).sum())


def test_node_devices_push_registers_inventory():
    def script(s, d):
        sched, rig, service = local_stack(s, d)
        try:
            service.upsert_node("n-dev", rv(8_000, 8_192))
            client = rig.connect()
            inventory = {"gpu": [{"core": 100, "memory": 1 << 14,
                                  "group": 0}] * 2}
            _, doc, _ = client.call(
                s.FrameType.STATE_PUSH,
                {"kind": "node_devices", "name": "n-dev",
                 "devices": inventory})
            assert doc["rv"] == 2
            assert valid_count(sched.device_manager.state("gpu")) == 2
            assert service.nodes["n-dev"]["doc"]["devices"] == inventory
            with pytest.raises(s.RpcError, match="unknown node"):
                client.call(s.FrameType.STATE_PUSH,
                            {"kind": "node_devices", "name": "ghost",
                             "devices": inventory})
            assert service.rv == 2
            return sync_fingerprint(sched)
        finally:
            rig.close()

    both(script)


def test_node_devices_refresh_clears_disappeared_types():
    def script(s, d):
        sched, rig, service = local_stack(s, d)
        try:
            service.upsert_node("n-dev", rv(8_000, 8_192))
            client = rig.connect()
            client.call(s.FrameType.STATE_PUSH,
                        {"kind": "node_devices", "name": "n-dev",
                         "devices": {"gpu": [{"core": 100,
                                              "memory": 1 << 14}]}})
            manager = sched.device_manager
            assert valid_count(manager.state("gpu")) == 1
            client.call(s.FrameType.STATE_PUSH,
                        {"kind": "node_devices", "name": "n-dev",
                         "devices": {"xpu": [{"core": 100,
                                              "memory": 1 << 14}]}})
            assert valid_count(manager.state("xpu")) == 1
            assert valid_count(manager.state("gpu")) == 0
            return sync_fingerprint(sched)
        finally:
            rig.close()

    both(script)


def test_node_upsert_clears_omitted_device_types():
    def script(s, d):
        sched, rig, service = local_stack(s, d)
        try:
            inventory = {"gpu": [{"core": 100, "memory": 1 << 14,
                                  "group": 0}]}
            service.upsert_node("n-up", rv(8_000, 8_192), devices=inventory)
            manager = sched.device_manager
            assert valid_count(manager.state("gpu")) == 1
            service.upsert_node("n-up", rv(8_000, 8_192),
                                labels={"zone": "b"})
            assert service.nodes["n-up"]["doc"]["devices"] == {}
            assert valid_count(manager.state("gpu")) == 0
            return sync_fingerprint(sched)
        finally:
            rig.close()

    both(script)


def test_reset_clears_fine_grained_registries():
    def script(s, d):
        sched = s.scheduler(capacity=8, managers=True)
        sched.snapshot.upsert_node(s.NodeSpec(
            name="n0", allocatable=rv(8_000, 8_192),
            usage=np.zeros(R, np.int32)))
        sched.device_manager.register_node_devices(
            "gpu", "n0", [{"core": 100, "memory": 1 << 14}])
        sched.cpu_manager.register_node("n0", s.topology(4))
        s.SchedulerBinding(sched).reset()
        assert sched.device_manager.state("gpu") is None
        assert sched.device_manager.registered_types_for("n0") == set()
        assert sched.cpu_manager.node("n0") is None
        return sync_fingerprint(sched)

    both(script)


def test_direct_api_rejects_malformed_device_inventory():
    def script(s, d):
        service = s.StateSyncService()
        errors = []
        with pytest.raises(s.wire.WireSchemaError,
                           match="must be a list") as e:
            service.upsert_node("n0", rv(1_000, 1_024),
                                devices={"gpu": "bogus"})
        errors.append(str(e.value))
        service.upsert_node("n0", rv(1_000, 1_024))
        with pytest.raises(s.wire.WireSchemaError,
                           match="must be a list") as e:
            service.update_node_devices("n0", {"gpu": "bogus"})
        errors.append(str(e.value))
        with pytest.raises(s.wire.WireSchemaError,
                           match="must be an integer") as e:
            service.update_node_devices("n0", {"gpu": [{"core": "a"}]})
        errors.append(str(e.value))
        assert service.rv == 1
        return errors

    both(script)


def test_node_upsert_clears_stale_cpu_topology():
    def script(s, d):
        sched, rig, service = local_stack(s, d)
        try:
            detail = [{"core": c // 2, "node": 0, "socket": 0, "id": c}
                      for c in range(4)]
            service.upsert_node(
                "n-nrt", rv(4_000, 4_096),
                annotations={"node.koordinator.sh/cpu-topology":
                             json.dumps({"detail": detail})})
            assert sched.cpu_manager.node("n-nrt") is not None
            service.upsert_node("n-nrt", rv(4_000, 4_096),
                                labels={"zone": "b"})
            assert sched.cpu_manager.node("n-nrt") is None
            return sync_fingerprint(sched)
        finally:
            rig.close()

    both(script)


def test_unchanged_device_heartbeat_does_not_churn_the_log():
    def script(s, d):
        service = s.StateSyncService()
        service.upsert_node("n0", rv(1_000, 1_024))
        inventory = {"gpu": [{"core": 100, "memory": 1 << 14, "group": 0}]}
        out = [service.update_node_devices("n0", inventory)]
        out.append(service.update_node_devices("n0", dict(inventory)))
        out.append(service.rv)
        out.append(service.update_node_devices("n0", {}))
        assert out == [2, 2, 2, 3]
        return out

    both(script)


def test_node_remove_clears_fine_grained_registries():
    def script(s, d):
        sched, rig, service = local_stack(s, d)
        try:
            detail = [{"core": c, "node": 0, "socket": 0, "id": c}
                      for c in range(2)]
            service.upsert_node(
                "n-rm", rv(2_000, 2_048),
                annotations={"node.koordinator.sh/cpu-topology":
                             json.dumps({"detail": detail})},
                devices={"gpu": [{"core": 100, "memory": 1 << 14,
                                  "group": 0}]})
            dm, cm = sched.device_manager, sched.cpu_manager
            assert valid_count(dm.state("gpu")) == 1
            assert cm.node("n-rm") is not None
            service.remove_node("n-rm")
            assert valid_count(dm.state("gpu")) == 0
            assert dm.registered_types_for("n-rm") in (set(), {"gpu"})
            assert cm.node("n-rm") is None
            return sync_fingerprint(sched)
        finally:
            rig.close()

    both(script)


def test_node_allocatable_push_merges_without_clobbering():
    from koordinator_tpu_torch.api.resources import ResourceDim

    def script(s, d):
        rig = Rig(s, os.path.join(d, "s.sock"))
        try:
            service = s.StateSyncService()
            service.attach(rig.server)
            rig.server.start()
            service.upsert_node(
                "n1", rv(16_000, 65_536), usage=rv(4_000, 8_192),
                labels={"zone": "a"},
                devices={"gpu": [{"core": 100, "memory": 1 << 14,
                                  "group": 0}]})
            sched = s.scheduler()
            sync, client = sync_stack(s, rig, sched)
            sync.bootstrap(client)
            new_alloc = rv(16_000, 65_536, **{
                "kubernetes.io/batch-cpu": 9_000,
                "kubernetes.io/batch-memory": 30_000})
            _, doc, _ = client.call(
                s.FrameType.STATE_PUSH,
                {"kind": "node_allocatable", "name": "n1"},
                {"allocatable": new_alloc})
            assert doc["rv"] == service.rv
            wait_until(lambda: sync.rv == service.rv)
            spec = sched.snapshot.node_specs["n1"]
            assert spec.allocatable[ResourceDim.BATCH_CPU] == 9_000
            assert spec.usage[ResourceDim.CPU] == 4_000
            assert spec.labels == {"zone": "a"}
            stored = service.nodes["n1"]
            assert stored["doc"]["devices"]["gpu"]
            sched2 = s.scheduler()
            sync2, client2 = sync_stack(s, rig, sched2)
            sync2.bootstrap(client2)
            assert sched2.snapshot.node_specs["n1"].allocatable[
                ResourceDim.BATCH_CPU] == 9_000
            with pytest.raises(s.RpcRemoteError, match="unknown node"):
                client.call(s.FrameType.STATE_PUSH,
                            {"kind": "node_allocatable", "name": "ghost"},
                            {"allocatable": new_alloc})
            return sync_fingerprint(sched), sync_fingerprint(sched2)
        finally:
            rig.close()

    both(script)


def test_conn_close_with_full_queue_does_not_leak_sender_thread():
    """The port's ``_Conn.close`` against a momentarily full queue: the
    sender drains the backlog between close's failed poison put and its
    socket shutdown, and must still get its poison."""
    import queue as _queue

    from koordinator_tpu_torch.transport.channel import _Conn
    from koordinator_tpu_torch.transport.wire import (
        Frame,
        FrameType,
        encode_payload,
    )

    drained = threading.Event()
    in_send = threading.Event()

    class FakeSock:
        def __init__(self):
            self.release = threading.Event()

        def sendall(self, data):
            in_send.set()
            self.release.wait(5)

        def shutdown(self, how):
            self.release.set()
            assert drained.wait(5), "sender never drained the backlog"

    conn = _Conn.__new__(_Conn)
    conn.sock = FakeSock()
    conn.faults = None
    conn._held = None
    conn.queue = _queue.Queue(4)
    conn.alive = True
    conn.dropped = 0
    orig_get = conn.queue.get

    def tracking_get(*a, **kw):
        if conn.queue.empty():
            drained.set()
        return orig_get(*a, **kw)

    conn.queue.get = tracking_get
    frame = Frame(FrameType.DELTA, 0, encode_payload({"x": 1}))
    conn.queue.put_nowait(frame)
    sender = threading.Thread(target=conn._drain, daemon=True)
    conn._sender = sender
    sender.start()
    assert in_send.wait(5)
    for _ in range(4):
        conn.queue.put_nowait(frame)
    conn.close()
    sender.join(5)
    assert not sender.is_alive(), "sender thread leaked"


# -- across the packages ------------------------------------------------------


def fill(service, rng, n_nodes: int = 6, n_pods: int = 12) -> None:
    """Seeded nodes (some with NRT annotations and GPU inventory), pending
    pods, a reservation, then usage refreshes and removals."""
    for i in range(n_nodes):
        kw = {}
        if i % 2 == 0:
            kw["annotations"] = nrt(8)
        if i % 3 == 0:
            kw["devices"] = {"gpu": [{"core": 100, "memory": 1 << 14,
                                      "group": g // 2} for g in range(4)]}
        service.upsert_node(
            f"n{i}", gpu_vec(400 if i % 3 == 0 else 0,
                             (1 << 14) * 4 if i % 3 == 0 else 0,
                             int(rng.integers(8_000, 32_000)),
                             int(rng.integers(16_384, 65_536))),
            usage=rv(int(rng.integers(0, 4_000)),
                     int(rng.integers(0, 8_192))),
            labels={"zone": "a" if i % 2 else "b"}, **kw)
    service.upsert_reservation("rsv-0", rv(2_000, 1_024).astype(np.int64),
                               owners=[{"labels": {"app": "svc"}}])
    for j in range(n_pods):
        kw = {}
        if j % 4 == 0:
            kw["labels"] = {"app": "svc"}
        if j % 5 == 0:
            kw["node_selector"] = {"zone": "a"}
        req = (gpu_vec(100, 1 << 13, int(rng.integers(100, 2_000)), 512)
               if j % 6 == 1 else
               rv(int(rng.integers(100, 3_000)), int(rng.integers(64, 4_096))))
        service.add_pod(f"p{j}", req, priority=int(rng.integers(0, 9_000)),
                        qos=3 if j % 7 == 2 else 0, **kw)
    service.update_node_usage("n1", rv(1_000, 2_048))
    service.remove_pod("p3")
    service.remove_node(f"n{n_nodes - 1}")


@pytest.mark.parametrize("service_pkg", PKGS)
def test_one_service_feeds_both_packages(service_pkg):
    """A service of one package on a real socket bootstraps a JAX and a
    port scheduler (each through its own package's StateSyncClient), then
    pushes live deltas to both: their fingerprints are equal after the
    bootstrap and after the deltas, and so are their first rounds."""
    src = side(service_pkg)
    scheds = {pkg: side(pkg).scheduler(managers=True) for pkg in PKGS}
    d = tempfile.mkdtemp(prefix="kt")
    server = src.RpcServer(os.path.join(d, "x.sock"))
    clients = []
    try:
        service = src.StateSyncService()
        service.attach(server)
        server.start()
        rng = np.random.default_rng(7)
        fill(service, rng)
        syncs = {}
        for pkg in PKGS:
            s = side(pkg)
            syncs[pkg] = s.StateSyncClient(s.SchedulerBinding(scheds[pkg]))
            client = s.RpcClient(server.address, on_push=syncs[pkg].on_push,
                                 timeout=60.0)
            clients.append(client)
            client.connect()
            assert syncs[pkg].bootstrap(client) > 0
            assert syncs[pkg].proto == 4
        assert (sync_fingerprint(scheds["jax"])
                == sync_fingerprint(scheds["torch"]))
        service.add_pod("late", rv(1_500, 1_024), priority=5_000)
        service.update_node_usage("n2", rv(2_000, 1_000))
        service.upsert_node("n9", rv(12_000, 32_768), annotations=nrt(4))
        for pkg in PKGS:
            wait_until(lambda pkg=pkg: syncs[pkg].rv == service.rv)
        assert (sync_fingerprint(scheds["jax"])
                == sync_fingerprint(scheds["torch"]))
        results = [scheds[pkg].schedule_round() for pkg in PKGS]
        docs = [(r.assignments, {n: f.message() for n, f in
                                 r.failures.items()}, r.nominations,
                 r.round_pods) for r in results]
        assert docs[0] == docs[1]
        assert docs[0][0], "the round placed pods"
        assert (scheds["jax"].resource_status
                == scheds["torch"].resource_status)
        assert (sync_fingerprint(scheds["jax"])
                == sync_fingerprint(scheds["torch"]))
    finally:
        for c in clients:
            c.close()
        server.stop()
        for name in os.listdir(d):
            os.unlink(os.path.join(d, name))
        os.rmdir(d)
