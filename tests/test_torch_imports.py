"""The port stands alone: it imports neither JAX nor anything of the JAX
package, not at import time and not after scheduling rounds down every path
(a cold batch round, an incremental round over the candidate cache, a
greedy round, and reservation rounds: reserve-pods and a pinned
reservation opening, then owner pods through the reservation pre-pass;
then a cold and an incremental round in the wide key regime, at a capacity
of 40,960 with 70 node classes; then a gang round and two rounds under
``cand_method="approx"``; then a preemption round, its nominations' binds
and a quota overuse revoke; then a round whose Diagnose phase counts the
reject reasons, keeps an explanation, writes a ScheduleExplanation and
audit records, and a bound pod's score decomposition; then a round with a
network-topology gang, cpusets and GPUs (the device-plugin gate on), a
delete and a restore through ``add_bound_pod``'s ``resource_status``; then
the round's gates: a standby round, a closed barrier, a hinted round on a
dense mask and a degraded round; then a round with every observability hook
on: traced pods, an exporter on the tracer, the timeline recorder and the
journey ledger, a flight record and the metrics' exposition)."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ROUND = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(2)
import koordinator_tpu_torch
from koordinator_tpu_torch import convert
from koordinator_tpu_torch.kernels import build, explain_counts, greedy_scan, prefix_accept, refresh_candidates, round_fit_choose, select_candidates
from koordinator_tpu_torch.ops import batch_assign, explain, gang
from koordinator_tpu_torch.quota.tree import QuotaTree
from koordinator_tpu_torch.scheduler.scheduler import Scheduler
from koordinator_tpu_torch.scheduler.snapshot import ClusterSnapshot, NodeSpec, PodSpec

rng = np.random.default_rng(0)
snap = ClusterSnapshot(capacity=32, device="cpu")
for i in range(24):
    a = np.zeros(10, np.int32)
    a[0], a[1] = rng.integers(8000, 64000), rng.integers(16384, 262144)
    snap.upsert_node(NodeSpec(name=f"n{i}", allocatable=a))
tree = QuotaTree(np.full(10, 10**7, np.int64))
tree.add("q", np.zeros(10, np.int64), np.full(10, 10**6, np.int64))
binds = []
sched = Scheduler(snap, quota_tree=tree, bind_fn=lambda p, n: binds.append(p),
                  batch_solver_threshold=64, device="cpu")
for j in range(96):
    q = np.zeros(10, np.int32)
    q[0], q[1] = rng.integers(100, 4000), rng.integers(128, 8192)
    sched.enqueue(PodSpec(name=f"p{j}", requests=q, priority=int(j % 7),
                          quota="q" if j % 2 else None))
res = sched.schedule_round()
assert sched.last_solver == "batch" and len(binds) == len(res.assignments) > 0
assert sched.last_solve_path == "full_cold"
sched.incremental_dirty_threshold = 1.0
for j in range(96, 200):
    q = np.zeros(10, np.int32)
    q[0], q[1] = rng.integers(100, 4000), rng.integers(128, 8192)
    sched.enqueue(PodSpec(name=f"p{j}", requests=q, priority=int(j % 7)))
sched.schedule_round()
assert sched.last_solve_path == "incremental"
sched.batch_solver_threshold = 10**6
for j in range(200, 230):
    q = np.zeros(10, np.int32)
    q[0], q[1] = rng.integers(100, 4000), rng.integers(128, 8192)
    sched.enqueue(PodSpec(name=f"p{j}", requests=q, priority=int(j % 7)))
sched.schedule_round()
assert sched.last_solve_path == "greedy"
from koordinator_tpu_torch.ops import reservation
from koordinator_tpu_torch.scheduler.reservations import OwnerMatcher, ReservationSpec
for v in range(4):
    r = np.zeros(10, np.int32)
    r[0], r[1] = 4000, 4096
    sched.add_reservation(ReservationSpec(
        name=f"r{v}", requests=r, owners=[OwnerMatcher(labels={"app": "web"})],
        node=f"n{v}" if v % 2 else None, allocate_once=(v == 2)))
sched.schedule_round()
assert len(sched.reservations.available()) == 4
for j in range(230, 250):
    q = np.zeros(10, np.int32)
    q[0], q[1] = rng.integers(100, 2000), rng.integers(128, 2048)
    sched.enqueue(PodSpec(name=f"p{j}", requests=q, priority=int(j % 7),
                          labels={"app": "web"}))
res = sched.schedule_round()
assert any(sched.bound[n].reservation for n in res.assignments)
sched.delete_pod(sorted(res.assignments)[0])
sched.remove_reservation("r0")
# the wide key regime (capacity past 2**15) with 70 label classes (two
# selector words a pod): a cold and an incremental round
wide = ClusterSnapshot(capacity=40_960, device="cpu")
for i in range(70):
    a = np.zeros(10, np.int32)
    a[0], a[1] = rng.integers(8000, 64000), rng.integers(16384, 262144)
    wide.upsert_node(NodeSpec(name=f"w{i}", allocatable=a,
                              labels={"rack": f"r{i}"}))
ws = Scheduler(wide, batch_solver_threshold=16, device="cpu")
ws.incremental_dirty_threshold = 1.0
for rnd in range(2):
    for j in range(40):
        q = np.zeros(10, np.int32)
        q[0], q[1] = rng.integers(100, 4000), rng.integers(128, 8192)
        ws.enqueue(PodSpec(name=f"w{rnd}-{j}", requests=q,
                           node_selector={"rack": f"r{j}"} if j % 2 else {}))
    res = ws.schedule_round()
    assert res.assignments and wide.class_capacity == 128
assert ws.last_solve_path == "incremental"
# a gang round (gang_assign's full path) and approx rounds (K1a's reduction
# in the cache's cold selection, then in an incremental round)
from koordinator_tpu_torch.scheduler.scheduler import GangRecord
sched.batch_solver_threshold = 16
sched.register_gang(GangRecord(name="gang", min_member=3))
for j in range(20):
    q = np.zeros(10, np.int32)
    q[0], q[1] = rng.integers(100, 2000), rng.integers(128, 2048)
    sched.enqueue(PodSpec(name=f"g{j}", requests=q,
                          gang="gang" if j < 4 else None))
res = sched.schedule_round()
assert sched.last_solve_path == "full_gang" and "g0" in res.assignments
ws.cand_method = "approx"
for rnd in range(2):
    for j in range(40):
        q = np.zeros(10, np.int32)
        q[0], q[1] = rng.integers(100, 4000), rng.integers(128, 8192)
        ws.enqueue(PodSpec(name=f"a{rnd}-{j}", requests=q))
    res = ws.schedule_round()
    assert res.assignments
assert ws.last_solve_path == "incremental"
# preemption (PostFilter: a chain of single pods and a gang job; the
# Nominated round binds them) and the quota overuse revoke
from koordinator_tpu_torch.scheduler.scheduler import BoundPod, PdbRecord
now = [0.0]
ps = ClusterSnapshot(capacity=8, device="cpu")
for i in range(4):
    a = np.zeros(10, np.int32)
    a[0], a[1] = 8000, 65536
    ps.upsert_node(NodeSpec(name=f"m{i}", allocatable=a))
total = np.zeros(10, np.int64)
total[0], total[1] = 32000, 262144
ptree = QuotaTree(total)
for qn, floor in (("a", 0), ("b", 24000)):
    mx = np.full(10, -1, np.int64)
    mx[0] = 32000
    mn = np.zeros(10, np.int64)
    mn[0] = floor
    ptree.add(qn, mn, mx)
evicted, revoked = [], []
pre = Scheduler(ps, quota_tree=ptree, device="cpu", clock=lambda: now[0],
                preempt_fn=lambda v, by: evicted.append(v))
pre.enable_overuse_revoke(lambda p, q: revoked.append(p), delay_evict_sec=5.0)
pre.register_pdb(PdbRecord(name="pdb", selector={"app": "x"}, allowed=10))
for j in range(8):
    q = np.zeros(10, np.int32)
    q[0] = 4000
    pre.add_bound_pod(BoundPod(PodSpec(name=f"b{j}", requests=q, priority=j,
                                       quota="a", labels={"app": "x"}),
                               f"m{j % 4}"))
# the quota's used as its ElasticQuota status reports it
ptree.nodes["a"].used[0] += 32000
pre.register_gang(GangRecord(name="pg", min_member=2))
for j in range(4):
    q = np.zeros(10, np.int32)
    q[0] = 4000
    pre.enqueue(PodSpec(name=f"h{j}", requests=q, priority=9000 + j,
                        gang="pg" if j >= 2 else None))
res = pre.schedule_round()
assert res.nominations and evicted
res = pre.schedule_round()
assert res.assignments
q = np.zeros(10, np.int32)
q[0] = 20000
pre.enqueue(PodSpec(name="bq", requests=q, priority=9999, quota="b"))
pre.schedule_round()
now[0] = 10.0
pre.schedule_round()
assert revoked
# Diagnose with the reject-reason counts, into an explanation, a
# ScheduleExplanation store and an auditor; a bound pod's score terms
from koordinator_tpu_torch.scheduler.explanation import ExplanationStore, WorkloadAuditor
pre.explanations, pre.auditor = ExplanationStore(blocking=True), WorkloadAuditor()
assert pre.explain
big = np.zeros(10, np.int32)
big[0], big[1] = 900000, 1024
pre.enqueue(PodSpec(name="too-big", requests=big))
res = pre.schedule_round()
assert res.failures["too-big"].reason_counts["fit_cpu"] == 4
assert res.failures["too-big"].reason_counts["node_invalid"] == 4
assert pre.pod_explanation("too-big").top_reason() == "fit_cpu"
assert pre.explanations.get("too-big") is not None
assert pre.auditor.attempts("too-big") == 1
assert pre.explain_candidates(sorted(pre.bound)[0])[0]["winner"]
assert pre.explain_candidates("too-big") == []
# network-topology gangs, NUMA cpusets and GPU device share: a gang round
# planned on a spine/block/node tree (K8's plain version), LSR pods taking
# cpusets and GPU pods taking minors at bind, the device-plugin gate on,
# a delete, then a restore through add_bound_pod's resource_status
from koordinator_tpu_torch import features
from koordinator_tpu_torch.kernels import offer_slots
from koordinator_tpu_torch.ops import deviceshare, network_topology, numa, select
from koordinator_tpu_torch.ops.network_topology import TopologyRequirements, TopologyTree
from koordinator_tpu_torch.ops.numa import CPUTopology
from koordinator_tpu_torch.scheduler import device_plugin_adapter
from koordinator_tpu_torch.scheduler.cpu_manager import CPUManager
from koordinator_tpu_torch.scheduler.device_manager import DeviceManager
ts = ClusterSnapshot(capacity=16, device="cpu")
tree = TopologyTree(["spine", "block", "node"])
cm, dm = CPUManager(device="cpu"), DeviceManager(device="cpu")
for i in range(12):
    a = np.zeros(10, np.int32)
    a[0], a[1], a[3], a[4] = 16000, 65536, 800, 655360
    ts.upsert_node(NodeSpec(name=f"t{i}", allocatable=a, labels={
        "node.koordinator.sh/gpu-vendor": "metax"}))
    tree.add_node([f"s{i // 6}", f"b{i // 3}", f"t{i}"])
    cm.register_node(f"t{i}", CPUTopology.uniform(
        sockets=1, numa_per_socket=2, cores_per_numa=4, device="cpu"))
dm.register("gpu", [f"t{i}" for i in range(12)],
            [[{"core": 100, "memory": 81920, "group": j // 4}
              for j in range(8)] for _ in range(12)])
tsched = Scheduler(ts, device="cpu", batch_solver_threshold=8,
                   topology_tree=tree.build(capacity=16, device="cpu"),
                   cpu_manager=cm, device_manager=dm)
tsched.register_gang(GangRecord(name="tg", min_member=3, topology=TopologyRequirements(
    desired_slots=3, must_gather_layer=2)))
features.SCHEDULER_GATES.set("DevicePluginAdaption", True)
for j in range(12):
    q = np.zeros(10, np.int32)
    q[0], q[1] = 2000, 2048
    if j % 4 == 1:
        q[3] = 200
    if j % 4 == 2:
        q[3], q[4] = 50, 4096
    tsched.enqueue(PodSpec(name=f"t{j}", requests=q, qos=3 if j % 4 == 3 else 0,
                           gang="tg" if j < 3 else None))
res = tsched.schedule_round()
assert tsched.last_topology_parts_s["gangs"] == 1 and "t0" in res.assignments
assert any("resource-status" in v for v in tsched.resource_status.values())
assert any("device-plugin" in v for v in tsched.resource_status.values())
status = dict(tsched.resource_status)
gone = sorted(status)[0]
tsched.delete_pod(gone)
again = Scheduler(ts, device="cpu", cpu_manager=CPUManager(device="cpu"),
                  device_manager=DeviceManager(device="cpu"))
for name, bp in tsched.bound.items():
    again.add_bound_pod(bp, resource_status=status.get(name))
# the round's gates: a standby round, a closed barrier, a hinted round on a
# dense mask (the batch threshold crossed) into bind_batch_fn, then a
# degraded round suspending BE and batch-dimension pods, timed by a monitor
from koordinator_tpu_torch.scheduler.barrier import SyncBarrier
from koordinator_tpu_torch.scheduler.hints import PodHint, SchedulingHints
from koordinator_tpu_torch.scheduler.monitor import SchedulerMonitor
gsnap = ClusterSnapshot(capacity=32, device="cpu")
for i in range(20):
    a = np.zeros(10, np.int32)
    a[0], a[1], a[6], a[7] = 32000, 65536, 8000, 8192
    gsnap.upsert_node(NodeSpec(name=f"h{i}", allocatable=a))
clock, seen, leads = [0.0], [0], [False]
barrier = SyncBarrier(lambda: 1, lambda: seen[0])
barrier.start()
hints = SchedulingHints(gsnap)
class Elector:
    def tick(self):
        return leads[0]
batches = []
gs = Scheduler(gsnap, device="cpu", hints=hints, barrier=barrier,
               elector=Elector(), monitor=SchedulerMonitor(),
               bind_batch_fn=batches.append, staleness_threshold_sec=5.0,
               clock=lambda: clock[0], batch_solver_threshold=16)
gs.note_sync_event()
for j in range(40):
    q = np.zeros(10, np.int32)
    q[0], q[1] = rng.integers(100, 4000), rng.integers(128, 8192)
    gs.enqueue(PodSpec(name=f"hp{j}", requests=q, priority=int(j % 5)))
hints.set_hint("hp1", PodHint(excluded_nodes={"h0", "h1"}))
hints.set_hint("hp2", PodHint(preferred_nodes={"h3"}))
assert not gs.schedule_round().assignments and gs.round_seq == 1
leads[0] = True
assert not gs.schedule_round().assignments
seen[0] = 1
res = gs.schedule_round()
assert gs.last_solve_path == "full_dense" and res.assignments["hp2"] == "h3"
assert len(batches) == 1 and "Solve" in gs.monitor.round_timings
hints.clear("hp1")
hints.clear("hp2")
clock[0] = 9.0
for j in range(40, 80):
    q = np.zeros(10, np.int32)
    q[0], q[1] = rng.integers(100, 4000), rng.integers(128, 8192)
    if j % 4 == 0:
        q[6] = 500
    gs.enqueue(PodSpec(name=f"hp{j}", requests=q, qos=1 if j % 4 == 1 else 0))
res = gs.schedule_round()
assert gs.degraded and gs.last_solve_path == "degraded"
assert gs.last_suspended == 20 and len(gs._last_suspended_names) == 20
# every observability hook on: traced pods with arrival stamps, an exporter
# on the tracer, the timeline recorder and the journey ledger
from koordinator_tpu_torch import journey, metrics, timeline, tracing
from koordinator_tpu_torch.scheduler import flight_recorder
timeline.RECORDER.set_enabled(True)
journey.LEDGER.set_enabled(True)
col = tracing.InMemoryExporter()
tracing.TRACER.add_exporter(col)
osnap = ClusterSnapshot(capacity=16, device="cpu")
for i in range(12):
    a = np.zeros(10, np.int32)
    a[0], a[1] = rng.integers(8000, 64000), rng.integers(16384, 262144)
    osnap.upsert_node(NodeSpec(name=f"o{i}", allocatable=a))
ots = Scheduler(osnap, device="cpu", trace_pods=True, flight_ring_size=4,
                batch_solver_threshold=8)
for j in range(20):
    q = np.zeros(10, np.int32)
    q[0], q[1] = rng.integers(100, 4000), rng.integers(128, 8192)
    ots.enqueue(PodSpec(name=f"o{j}", requests=q, arrival_ts=1e9 + j))
res = ots.schedule_round()
assert col.find(name="scheduler.round") and len(col.find(
    name="scheduler.bind")) == len(res.assignments) > 0
assert ots.flight_recorder.last().placed == len(res.assignments)
assert timeline.RECORDER.cycles()[0]["cycle"] == ots.round_seq
assert any(r["stage"] == "ingest" for r in journey.LEDGER.report()["series"])
assert "koord_scheduler_pending_pods" in metrics.expose_all(openmetrics=True)
assert ots.pod_trace_id("o0") is not None
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "koordinator_tpu"))
print("LOADED", bad)
"""


def test_the_gates_modules_are_checked():
    """The round gates' modules are among the sources the import-line
    check reads."""
    names = {os.path.relpath(p, REPO) for p in _sources()}
    for mod in ("barrier", "hints", "monitor"):
        assert f"koordinator_tpu_torch/scheduler/{mod}.py" in names


def test_the_observability_modules_are_checked():
    """The observability copies are among the sources the import-line check
    reads."""
    names = {os.path.relpath(p, REPO) for p in _sources()}
    for mod in ("metrics", "tracing", "timeline", "journey",
                "scheduler/flight_recorder"):
        assert f"koordinator_tpu_torch/{mod}.py" in names


def test_port_runs_a_round_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _ROUND], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|koordinator_tpu)"
                     r"(\.|\s|$)")


def _sources():
    root = os.path.join(REPO, "koordinator_tpu_torch")
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    for script in ("chip_smoke.py", "profile_torch_round.py"):
        path = os.path.join(REPO, script)
        if os.path.exists(path):
            yield path
    probes = os.path.join(REPO, "probes")
    if os.path.isdir(probes):
        for name in sorted(os.listdir(probes)):
            if name.endswith(".py"):
                yield os.path.join(probes, name)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_lines(path):
    with open(path) as f:
        hits = [line for line in f if _IMPORT.match(line)]
    assert hits == []
