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
audit records, and a bound pod's score decomposition)."""

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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "koordinator_tpu"))
print("LOADED", bad)
"""


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
