"""Parity of the port's ``ha`` (``koordinator_tpu_torch/ha.py``) with the JAX
package's: the same scripted election on each package's lease store and
electors gives the same tick results, transition callbacks and lease
records; ``leader_gated`` and the elector's ``run`` loop behave alike; the
lease frames serve a ``RemoteLeaseStore`` over each package's own transport
with the same CAS outcomes; and a standby port scheduler gates its rounds on
the lease as the JAX one does.  Mirrors tests/test_ha.py's cases (the
descheduler's is left for the descheduler's port).
"""

import dataclasses
import shutil
import tempfile
import threading
import time

import pytest

from tests.torch_parity import (
    PKGS,
    reset_observability,
    rv,
    set_torch_threads,
    side,
)

set_torch_threads()


@pytest.fixture(autouse=True)
def _fresh():
    reset_observability()
    yield
    reset_observability()


def ha(pkg: str):
    if pkg == "jax":
        from koordinator_tpu import ha as mod
    else:
        from koordinator_tpu_torch import ha as mod
    return mod


def election_script(mod) -> list:
    """Acquire, renew, fail over after expiry, a stale leader's demotion, a
    release's hand-off and a CAS against a stale holder, on a fake clock."""
    t = [0.0]
    out: list = []
    store = mod.InMemoryLeaseStore()

    def elector(name, **kw):
        return mod.LeaderElector(
            store, "L", name, lease_duration=15, clock=lambda: t[0],
            on_started_leading=lambda: out.append(f"{name}-start"),
            on_stopped_leading=lambda: out.append(f"{name}-stop"),
            on_new_leader=lambda who: out.append(f"{name}-new:{who}"), **kw)

    a, b = elector("a"), elector("b")
    for now in (0.0, 10.0, 20.0):
        t[0] = now
        out.append((now, b.tick() if now else (a.tick(), b.tick())))
    out.append(("a back", a.tick(), a.is_leader(), b.is_leader()))
    out.append(dataclasses.asdict(store.get("L")))
    b.release()
    out.append(("released", a.tick(), b.tick()))
    out.append(dataclasses.asdict(store.get("L")))
    out.append(store.update("L", "nobody", mod.LeaseRecord(holder="x")))
    out.append(store.update("L", "a", mod.LeaseRecord(holder="x",
                                                      renew_time=3.0)))
    out.append(dataclasses.asdict(store.get("L")))
    out.append(store.get("L").expired(17.9))
    out.append(store.get("L").expired(18.0))
    runs: list = []
    out.append(mod.leader_gated(a, lambda: runs.append("a") or 1))
    out.append(mod.leader_gated(None, lambda: 2))
    out.append(runs)
    return out


def test_election_script_matches():
    assert election_script(ha("torch")) == election_script(ha("jax"))


@pytest.mark.parametrize("pkg", PKGS)
def test_run_loop_releases_on_stop(pkg):
    mod = ha(pkg)
    store = mod.InMemoryLeaseStore()
    a = mod.LeaderElector(store, "L", "a", retry_period=0.001)
    stop = threading.Event()
    th = threading.Thread(target=a.run, args=(stop,), daemon=True)
    th.start()
    try:
        deadline = time.monotonic() + 5.0
        while not a.is_leader() and time.monotonic() < deadline:
            time.sleep(0.001)
        assert a.is_leader()
    finally:
        stop.set()
        th.join(timeout=5)
    assert not th.is_alive()
    assert store.get("L").holder == ""


def remote_script(pkg: str) -> list:
    """Two electors on RemoteLeaseStores over one LeaseService, each on its
    own client: the first acquires, the second waits, the stale CAS fails,
    a release hands off; then the server stops and the store fails
    closed."""
    s = side(pkg)
    mod = ha(pkg)
    d = tempfile.mkdtemp(prefix="kh")
    server = s.RpcServer(f"{d}/lease.sock")
    clients = []
    out: list = []
    try:
        mod.LeaseService().attach(server)
        server.start()
        for _ in range(2):
            c = s.RpcClient(server.path, timeout=5.0)
            c.connect()
            clients.append(c)
        t = [100.0]
        e1, e2 = (mod.LeaderElector(mod.RemoteLeaseStore(c), "sched",
                                    f"r{i}", lease_duration=10,
                                    clock=lambda: t[0])
                  for i, c in enumerate(clients))
        out.append((e1.tick(), e2.tick()))
        st = mod.RemoteLeaseStore(clients[1])
        out.append(dataclasses.asdict(st.get("sched")))
        out.append(st.update("sched", "r1", mod.LeaseRecord(holder="r1")))
        e1.release()
        out.append((e2.tick(), e1.tick()))
        out.append(dataclasses.asdict(st.get("sched")))
        server.stop()
        t[0] = 200.0
        out.append(dataclasses.asdict(st.get("sched")))
        out.append(st.update("sched", "r1", mod.LeaseRecord(holder="r0")))
    finally:
        for c in clients:
            c.close()
        server.stop()
        shutil.rmtree(d, ignore_errors=True)
    return out


def test_remote_lease_store_matches():
    assert remote_script("torch") == remote_script("jax")


def gated_rounds(pkg: str) -> list:
    """A leader and a standby scheduler over one store: the standby decides
    nothing and keeps its queue until the leader's lease expires."""
    s = side(pkg)
    mod = ha(pkg)
    t = [0.0]
    store = mod.InMemoryLeaseStore()
    lead = mod.LeaderElector(store, "sched", "a", lease_duration=10.0,
                             clock=lambda: t[0])
    standby = mod.LeaderElector(store, "sched", "b", lease_duration=10.0,
                                clock=lambda: t[0])
    out = [(lead.tick(), standby.tick())]
    scheds = []
    for el in (lead, standby):
        sched = s.scheduler(capacity=8, elector=el)
        sched.snapshot.upsert_node(s.NodeSpec(
            name="n1", allocatable=rv(16_000, 65_536)))
        sched.enqueue(_pod_spec(pkg)(name="p1", requests=rv(1_000, 512)))
        scheds.append(sched)
    out.append([sched.schedule_round().assignments for sched in scheds])
    out.append(("p1" in scheds[1].pending,
                scheds[1].last_result.assignments))
    t[0] = 30.0
    out.append(standby.tick())
    out.append(scheds[1].schedule_round().assignments)
    return out


def _pod_spec(pkg: str):
    if pkg == "jax":
        from koordinator_tpu.scheduler.snapshot import PodSpec
    else:
        from koordinator_tpu_torch.scheduler.snapshot import PodSpec
    return PodSpec


def test_scheduler_rounds_gate_on_leadership():
    assert gated_rounds("torch") == gated_rounds("jax")
