"""Live against replayed state, and a loadgen trace replayed over the wire,
on the port and the JAX package from the same seeds.

The two properties of ``tests/test_replay_parity.py`` run on both
packages: a random event sequence applied live (an in-process binding on
the service) and a fresh scheduler bootstrapped over a real socket must
hold the same registries, node set, reservations and node rows; and so
must a client that fell behind the delta log's retention and resynced from
a snapshot.  The port's live and replayed fingerprints equal each other
and the JAX ones.

Then the replay criterion of the port: ``tools/loadgen.py``'s
``generate_trace`` drives a JAX and a port scheduler, each fed by its own
package's ``StateSyncService`` over a unix socket (a feeder client pushes
``STATE_PUSH`` frames, the scheduler follows through a watching
``StateSyncClient``), with the trace mapped as the loadgen harness maps it
(``SteadyStateHarness._apply``): gangs registered in-process, quota
updates under ``scheduler.lock``, a ``solve_remote`` every tick of
virtual time, each after the watch caught up.  Every round's assignments,
failure messages, nominations and ``round_pods`` are equal.  The
schedulers run on a virtual clock with ``incremental_solve=False``: on the
CPU the JAX scheduler's incremental finish writes pass 2's binds into a
read-only view of pass 1's result and raises on a round whose pass 2
places a pod.  Four smoke seeds run the greedy path; one trace at 256
nodes, 60 arrivals a second and a 20 s tick sends rounds of over 1,024
pods through the batch solver.
"""

import json
import os
import tempfile

import numpy as np
import pytest

from tests.conftest import prop_seeds
from tests.torch_parity import (
    PKGS,
    host,
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


def fingerprint(sched):
    """The registry state a live applier and a replayed one must share:
    raw device inventory, CPU topologies, node names, reservations and
    node rows by name (rows are assigned in apply order, so names)."""
    dm, cm = sched.device_manager, sched.cpu_manager
    dev = {t: dict(sorted(raw.items())) for t, raw in sorted(dm._raw.items())}
    topo = {n: host(st.topology.core_of).tolist()
            for n, st in sorted(cm._nodes.items())}
    rsv = sorted((s.name, host(s.requests).tolist(), s.allocate_once)
                 for s in sched.reservations.specs())
    rows = sorted((n, host(spec.allocatable).tolist(),
                   host(spec.usage).tolist())
                  for n, spec in sched.snapshot.node_specs.items())
    return dev, topo, sorted(sched.snapshot.node_index), rsv, rows


def _nrt(cores: int) -> dict:
    detail = [{"core": c // 2, "node": 0, "socket": 0, "id": c}
              for c in range(cores)]
    return {"node.koordinator.sh/cpu-topology":
            json.dumps({"detail": detail})}


def random_walk(service, seed: int) -> None:
    """``tests/test_replay_parity.py``'s random event sequence."""
    rng = np.random.default_rng(seed)
    known: set[str] = set()
    rsv_known: set[str] = set()
    pod_seq = 0
    for _ in range(120):
        op = int(rng.integers(0, 14))
        name = f"n{int(rng.integers(0, 6))}"
        if op <= 4:
            kw = {}
            if rng.random() < 0.5:
                count = int(rng.integers(1, 4))
                kw["devices"] = {"gpu": [
                    {"core": 100, "memory": 1 << 10, "group": 0}] * count}
            if rng.random() < 0.5:
                kw["annotations"] = _nrt(int(rng.integers(2, 6)) * 2)
            service.upsert_node(name, rv(8_000, 8_192), **kw)
            known.add(name)
        elif op <= 6 and known:
            target = sorted(known)[int(rng.integers(0, len(known)))]
            devices = ({} if rng.random() < 0.3 else
                       {"xpu": [{"core": 50, "memory": 1 << 9, "group": 0}]
                        * int(rng.integers(1, 3))})
            service.update_node_devices(target, devices)
        elif op <= 8 and known:
            target = sorted(known)[int(rng.integers(0, len(known)))]
            service.remove_node(target)
            known.discard(target)
        elif op == 9:
            service.add_pod(f"p{pod_seq}", rv(100, 64))
            pod_seq += 1
        elif op == 10:
            rname = f"r{int(rng.integers(0, 4))}"
            service.upsert_reservation(
                rname, rv(500, 256), allocate_once=bool(rng.random() < 0.5),
                owners=[{"labels": {"app": rname}}])
            rsv_known.add(rname)
        elif op == 11 and rsv_known:
            target = sorted(rsv_known)[int(rng.integers(0, len(rsv_known)))]
            service.remove_reservation(target)
            rsv_known.discard(target)
        elif op == 12 and known:
            target = sorted(known)[int(rng.integers(0, len(known)))]
            service.update_node_allocatable(target, rv(8_000, 8_192, **{
                "kubernetes.io/batch-cpu": int(rng.integers(0, 6_000)),
                "kubernetes.io/batch-memory": int(rng.integers(0, 4_096))}))
        elif op == 13 and known:
            target = sorted(known)[int(rng.integers(0, len(known)))]
            service.update_node_usage(
                target, rv(int(rng.integers(0, 8_000)),
                           int(rng.integers(0, 8_192))),
                sys_usage=rv(100, 128),
                hp_usage=rv(int(rng.integers(0, 2_000)), 256))


def bootstrap_over_socket(s, service, replay) -> None:
    server = s.RpcServer("tcp://127.0.0.1:0")
    service.attach(server)
    server.start()
    client = None
    try:
        sync = s.StateSyncClient(s.SchedulerBinding(replay))
        client = s.RpcClient(server.address, on_push=sync.on_push)
        client.connect()
        sync.bootstrap(client)
        assert sync.rv == service.rv
    finally:
        if client is not None:
            client.close()
        server.stop()


@pytest.mark.parametrize("seed", prop_seeds(8))
def test_random_event_sequences_replay_identically(seed):
    prints = {}
    for pkg in PKGS:
        s = side(pkg)
        live = s.scheduler(managers=True, zero_thresholds=False)
        service = s.StateSyncService()
        service.attach_binding(s.SchedulerBinding(live))
        random_walk(service, seed)
        replay = s.scheduler(managers=True, zero_thresholds=False)
        bootstrap_over_socket(s, service, replay)
        assert fingerprint(replay) == fingerprint(live), (
            f"{pkg} seed {seed}: live and replayed registries diverged")
        prints[pkg] = (fingerprint(live), sync_fingerprint(live),
                       sync_fingerprint(replay))
    assert prints["torch"] == prints["jax"]


def fallen_behind(s, seed: int):
    """``test_fallen_behind_client_resyncs_to_parity``'s walk on one
    package: (live, replayed) schedulers after the resync."""
    rng = np.random.default_rng(1000 + seed)
    live = s.scheduler(managers=True, zero_thresholds=False)
    service = s.StateSyncService(retention=16)
    service.attach_binding(s.SchedulerBinding(live))
    server = s.RpcServer("tcp://127.0.0.1:0")
    service.attach(server)
    server.start()
    clients = []
    try:
        replay = s.scheduler(managers=True, zero_thresholds=False)
        sync = s.StateSyncClient(s.SchedulerBinding(replay))
        service.upsert_node("n0", rv(8_000, 8_192),
                            devices={"gpu": [{"core": 100, "memory": 1 << 10,
                                              "group": 0}]},
                            annotations=_nrt(4))
        client = s.RpcClient(server.address, on_push=sync.on_push)
        clients.append(client)
        client.connect()
        sync.bootstrap(client)
        client.close()
        known = {"n0"}
        for _ in range(60):
            op = int(rng.integers(0, 10))
            name = f"n{int(rng.integers(0, 4))}"
            if op <= 5:
                kw = {}
                if rng.random() < 0.5:
                    kw["devices"] = {"gpu": [
                        {"core": 100, "memory": 1 << 10, "group": 0}]}
                if rng.random() < 0.5:
                    kw["annotations"] = _nrt(4)
                service.upsert_node(name, rv(8_000, 8_192), **kw)
                known.add(name)
            elif op <= 7 and known:
                target = sorted(known)[int(rng.integers(0, len(known)))]
                service.remove_node(target)
                known.discard(target)
            elif name in known:
                service.update_node_devices(
                    name, {"xpu": [{"core": 50, "memory": 1 << 9,
                                    "group": 0}]})
        if "n0" in known:
            service.remove_node("n0")
        client2 = s.RpcClient(server.address, on_push=sync.on_push)
        clients.append(client2)
        client2.connect()
        sync.bootstrap(client2)
        assert sync.rv == service.rv
        return live, replay
    finally:
        for c in clients:
            c.close()
        server.stop()


@pytest.mark.parametrize("seed", prop_seeds(4))
def test_fallen_behind_client_resyncs_to_parity(seed):
    prints = {}
    for pkg in PKGS:
        live, replay = fallen_behind(side(pkg), seed)
        assert fingerprint(replay) == fingerprint(live), (
            f"{pkg} seed {seed}: resync replay diverged from live")
        prints[pkg] = (fingerprint(live), sync_fingerprint(live),
                       sync_fingerprint(replay))
    assert prints["torch"] == prints["jax"]


# -- a loadgen trace over the wire --------------------------------------------


def replay_trace(pkg: str, cfg, events, tick: float) -> list[dict]:
    """Feed ``events`` to one package's scheduler over a unix socket as
    the loadgen harness maps them, solving through ``solve_remote`` every
    ``tick`` virtual seconds (after the watch caught up).  Returns every
    round's result document."""
    from tools import loadgen as lg

    s = side(pkg)
    total = rv(cfg.node_cpu_milli * cfg.nodes,
               cfg.node_memory_mib * cfg.nodes).astype(np.int64)
    tree = s.QuotaTree(total)
    base = {}
    for name in cfg.quota_names():
        base[name] = total * 2
        tree.add(name, min=np.zeros_like(total), max=base[name].copy())
    now = [0.0]
    sched = s.scheduler(capacity=max(16, 1 << (cfg.nodes - 1).bit_length()),
                        zero_thresholds=False, quota_tree=tree,
                        incremental_solve=False, clock=lambda: now[0])
    d = tempfile.mkdtemp(prefix="kt")
    server = s.RpcServer(os.path.join(d, "lg.sock"))
    clients = []
    try:
        service = s.StateSyncService(retention=8192)
        service.attach(server)
        s.SolveService(sched).attach(server)
        server.start()
        alloc = rv(cfg.node_cpu_milli, cfg.node_memory_mib)
        for i in range(cfg.nodes):
            service.upsert_node(f"lg-n{i}", alloc)
        sync = s.StateSyncClient(s.SchedulerBinding(sched))
        watch, feeder, solver = (s.RpcClient(server.address, timeout=120.0,
                                              **kw)
                                 for kw in ({"on_push": sync.on_push}, {}, {}))
        for c in (watch, feeder, solver):
            clients.append(c)
            c.connect()
        sync.bootstrap(watch)
        push = s.FrameType.STATE_PUSH
        rounds = []
        i = 0
        t = 0.0
        end = max(cfg.duration_s, events[-1].t if events else 0.0)
        while True:
            while i < len(events) and events[i].t <= t:
                e, p = events[i], events[i].payload
                if e.kind == lg.POD_ADD:
                    req = (rv(**{"kubernetes.io/batch-cpu": p["cpu"],
                                 "kubernetes.io/batch-memory": p["memory"]})
                           if p.get("be") else rv(p["cpu"], p["memory"]))
                    doc = {"kind": "pod_add", "name": e.name,
                           "qos": int(p.get("qos", 0)),
                           "priority": int(p.get("priority", 0)),
                           "arrival_ts": e.t}
                    if p.get("gang"):
                        doc["gang"] = p["gang"]
                    if p.get("quota"):
                        doc["quota"] = p["quota"]
                    feeder.call(push, doc, {"requests": req})
                elif e.kind == lg.POD_DEL:
                    feeder.call(push, {"kind": "pod_remove", "name": e.name})
                elif e.kind == lg.NODE_DOWN:
                    feeder.call(push, {"kind": "node_remove", "name": e.name})
                elif e.kind == lg.NODE_UP:
                    feeder.call(push, {"kind": "node_upsert", "name": e.name},
                                {"allocatable": alloc})
                elif e.kind == lg.GANG_BURST:
                    sched.register_gang(s.GangRecord(
                        name=e.name, min_member=int(p["size"])))
                elif e.kind == lg.QUOTA_UPDATE:
                    with sched.lock:
                        node = tree.nodes.get(e.name)
                        if node is not None:
                            node.max = (base[e.name].astype(np.float64)
                                        * float(p.get("scale", 1.0))
                                        ).astype(np.int64)
                i += 1
            wait_until(lambda: sync.rv == service.rv, timeout=60.0)
            now[0] = t
            doc = s.solve_remote(solver, deadline_ms=240_000)
            rounds.append(dict(t=t, **{k: doc[k] for k in (
                "assignments", "failures", "nominations", "round_pods")}))
            if t >= end and i >= len(events):
                return rounds
            t += tick
    finally:
        for c in clients:
            c.close()
        server.stop()
        for name in os.listdir(d):
            os.unlink(os.path.join(d, name))
        os.rmdir(d)


def assert_rounds_equal(cfg, tick: float) -> list[dict]:
    from tools import loadgen as lg

    events = lg.generate_trace(cfg)
    jax_rounds = replay_trace("jax", cfg, events, tick)
    torch_rounds = replay_trace("torch", cfg, events, tick)
    assert len(jax_rounds) == len(torch_rounds)
    for a, b in zip(jax_rounds, torch_rounds):
        assert b == a, f"t={a['t']}: the port's round differs"
    assert sum(len(r["assignments"]) for r in jax_rounds) > 0
    return jax_rounds


@pytest.mark.parametrize("seed", range(4))
def test_loadgen_trace_binds_alike(seed):
    from tools import loadgen as lg

    rounds = assert_rounds_equal(lg.smoke_config(seed), tick=5.0)
    assert len(rounds) > 20


def test_loadgen_trace_through_the_batch_solver():
    """Rounds of over 1,024 pods (the batch solver's threshold): 256
    nodes, 60 arrivals a second, a 20 s tick."""
    import dataclasses

    from tools import loadgen as lg

    cfg = dataclasses.replace(lg.smoke_config(11), nodes=256,
                              arrival_rate=60.0, duration_s=40.0,
                              pod_lifetime_s=240.0)
    rounds = assert_rounds_equal(cfg, tick=20.0)
    assert max(r["round_pods"] for r in rounds) >= 1_024
