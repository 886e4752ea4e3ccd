"""The cases of tests/test_hints.py run on both packages: the port's copy
of ``scheduler/hints.py`` (``koordinator_tpu_torch/scheduler/hints.py``)
and the JAX package's, each through its own snapshot and scheduler, with
the same answers.  Then seeded masks through ``apply_to_mask`` on both,
bit for bit."""

import numpy as np
import pytest

from tests.torch_parity import CPU, R, set_torch_threads

set_torch_threads()

PKGS = ["jax", "port"]


def mods(pkg):
    """(hints module, Scheduler, ClusterSnapshot, NodeSpec, PodSpec)."""
    if pkg == "jax":
        from koordinator_tpu.scheduler import hints
        from koordinator_tpu.scheduler.scheduler import Scheduler
        from koordinator_tpu.scheduler.snapshot import (
            ClusterSnapshot,
            NodeSpec,
            PodSpec,
        )

        return hints, Scheduler, ClusterSnapshot, NodeSpec, PodSpec, {}
    from koordinator_tpu_torch.scheduler import hints
    from koordinator_tpu_torch.scheduler.scheduler import Scheduler
    from koordinator_tpu_torch.scheduler.snapshot import (
        ClusterSnapshot,
        NodeSpec,
        PodSpec,
    )

    return (hints, Scheduler, ClusterSnapshot, NodeSpec, PodSpec,
            {"device": "cpu"})


def cpu_vec(cpu, mem=0):
    v = np.zeros(R, np.int32)
    v[CPU], v[1] = cpu, mem
    return v


def make_cluster(pkg, n_nodes=4, cpu=16_000, mem=32_768):
    _, _, snap_cls, node_cls, _, dev = mods(pkg)
    snapshot = snap_cls(capacity=16, **dev)
    for i in range(n_nodes):
        snapshot.upsert_node(node_cls(name=f"n{i}",
                                      allocatable=cpu_vec(cpu, mem)))
    return snapshot


def scheduler(pkg, snapshot, **kw):
    _, sched_cls, _, _, _, dev = mods(pkg)
    if pkg == "jax":
        kw["mesh"] = "off"
    return sched_cls(snapshot, **dev, **kw)


def free_cpu(snapshot, name):
    snapshot.flush()
    free = snapshot.state.free
    free = free.cpu().numpy() if hasattr(free, "cpu") else np.asarray(free)
    return int(free[snapshot.node_index[name]][CPU])


# -- tests/test_hints.py TestSchedulingHints ---------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_excluded_node_skipped(pkg):
    hints_mod, *_, pod_cls, _ = mods(pkg)
    snapshot = make_cluster(pkg, 3)
    hints = hints_mod.SchedulingHints(snapshot)
    sched = scheduler(pkg, snapshot, hints=hints)
    hints.set_hint("p1", hints_mod.PodHint(excluded_nodes={"n0", "n1"}))
    sched.enqueue(pod_cls(name="p1", requests=cpu_vec(1000), priority=9500))
    assert sched.schedule_round().assignments["p1"] == "n2"


@pytest.mark.parametrize("pkg", PKGS)
def test_preferred_restricts(pkg):
    hints_mod, *_, pod_cls, _ = mods(pkg)
    snapshot = make_cluster(pkg, 3)
    hints = hints_mod.SchedulingHints(snapshot)
    sched = scheduler(pkg, snapshot, hints=hints)
    hints.set_hint("p1", hints_mod.PodHint(preferred_nodes={"n1"}))
    sched.enqueue(pod_cls(name="p1", requests=cpu_vec(1000), priority=9500))
    assert sched.schedule_round().assignments["p1"] == "n1"


@pytest.mark.parametrize("pkg", PKGS)
def test_infeasible_preference_ignored(pkg):
    hints_mod = mods(pkg)[0]
    hints = hints_mod.SchedulingHints(make_cluster(pkg, 2))
    hints.set_hint("p1", hints_mod.PodHint(preferred_nodes={"ghost"}))
    assert hints.apply_to_mask("p1", np.array([True, True])).all()


@pytest.mark.parametrize("pkg", PKGS)
def test_record_failure_excludes(pkg):
    hints = mods(pkg)[0].SchedulingHints(make_cluster(pkg, 2))
    hints.record_failure("p1", "n0")
    mask = hints.apply_to_mask("p1", np.array([True, True]))
    assert not mask[0] and mask[1]


# -- TestCrossSchedulerNominator ---------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_nomination_charges_capacity(pkg):
    hints_mod, *_, pod_cls, _ = mods(pkg)
    snapshot = make_cluster(pkg, 1, cpu=4000)
    nominator = hints_mod.CrossSchedulerNominator(snapshot)
    assert nominator.nominate("other-pod", "n0", cpu_vec(3000))
    sched = scheduler(pkg, snapshot)
    sched.enqueue(pod_cls(name="mine", requests=cpu_vec(2000), priority=9500))
    assert "mine" in sched.schedule_round().failures
    nominator.release("other-pod")
    sched.enqueue(pod_cls(name="mine", requests=cpu_vec(2000), priority=9500))
    assert sched.schedule_round().assignments.get("mine") == "n0"


@pytest.mark.parametrize("pkg", PKGS)
def test_double_nomination_rejected(pkg):
    nominator = mods(pkg)[0].CrossSchedulerNominator(make_cluster(pkg, 1))
    assert nominator.nominate("p", "n0", cpu_vec(100))
    assert not nominator.nominate("p", "n0", cpu_vec(100))
    assert nominator.nominated_node("p") == "n0"


@pytest.mark.parametrize("pkg", PKGS)
def test_nomination_release_skips_a_readded_node(pkg):
    """A release targets the node INSTANCE the claim was charged to: after
    the node left and came back, releasing charges the fresh one
    nothing."""
    _, _, _, node_cls, _, _ = mods(pkg)
    snapshot = make_cluster(pkg, 1, cpu=4000)
    nominator = mods(pkg)[0].CrossSchedulerNominator(snapshot)
    assert not nominator.nominate("p", "ghost", cpu_vec(100))
    assert nominator.nominate("p", "n0", cpu_vec(1000))
    snapshot.remove_node("n0")
    snapshot.upsert_node(node_cls(name="n0", allocatable=cpu_vec(4000,
                                                                 32_768)))
    nominator.release("p")
    nominator.release("p")
    assert free_cpu(snapshot, "n0") == 4000


# -- TestResizePod ------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_grow_within_free(pkg):
    snapshot = make_cluster(pkg, 1, cpu=4000)
    snapshot.reserve("n0", cpu_vec(1000))
    ok, reason = mods(pkg)[0].resize_pod(snapshot, "n0", cpu_vec(1000),
                                         cpu_vec(2000))
    assert ok, reason
    assert free_cpu(snapshot, "n0") == 4000 - 2000


@pytest.mark.parametrize("pkg", PKGS)
def test_grow_beyond_free_rejected(pkg):
    snapshot = make_cluster(pkg, 1, cpu=4000)
    snapshot.reserve("n0", cpu_vec(3500))
    ok, reason = mods(pkg)[0].resize_pod(snapshot, "n0", cpu_vec(3500),
                                         cpu_vec(4500))
    assert not ok and "insufficient" in reason


@pytest.mark.parametrize("pkg", PKGS)
def test_shrink_releases(pkg):
    snapshot = make_cluster(pkg, 1, cpu=4000)
    snapshot.reserve("n0", cpu_vec(3000))
    ok, _ = mods(pkg)[0].resize_pod(snapshot, "n0", cpu_vec(3000),
                                    cpu_vec(1000))
    assert ok
    assert free_cpu(snapshot, "n0") == 3000


def test_resize_answers_equal():
    """The same resizes on both packages: the verdicts, the reasons and
    the free capacity after each, a missing node among them."""
    outs = []
    for pkg in PKGS:
        resize = mods(pkg)[0].resize_pod
        snapshot = make_cluster(pkg, 2, cpu=4000)
        snapshot.reserve("n1", cpu_vec(2500, 4096))
        got = []
        for node, old, new in (("n1", (2500, 4096), (3900, 1024)),
                               ("n1", (3900, 1024), (4100, 1024)),
                               ("n0", (0, 0), (0, 40_000)),
                               ("gone", (0, 0), (1, 1)),
                               ("n1", (3900, 1024), (100, 8192))):
            ok, reason = resize(snapshot, node, cpu_vec(*old),
                                cpu_vec(*new))
            got.append((ok, reason, free_cpu(snapshot, "n1")))
        outs.append(got)
    assert outs[0] == outs[1]


# -- apply_to_mask on seeded masks -------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_apply_to_mask_equals_the_reference(seed):
    """Random feasible rows, excluded and preferred sets (some of them
    unknown names, some preferred nodes infeasible or excluded): the port's
    row equals the reference's bit for bit, and the input is untouched."""
    rng = np.random.default_rng(seed)
    n = 12
    names = [f"n{i}" for i in range(n)] + ["ghost"]
    rows = rng.random((8, 16)) < 0.6
    outs = []
    for pkg in PKGS:
        hints_mod = mods(pkg)[0]
        hints = hints_mod.SchedulingHints(make_cluster(pkg, n))
        r = np.random.default_rng(seed + 100)
        got = []
        for k, row in enumerate(rows):
            excl = {names[i] for i in np.flatnonzero(r.random(13) < 0.2)}
            pref = {names[i] for i in np.flatnonzero(r.random(13) < 0.15)}
            hints.set_hint(f"p{k}", hints_mod.PodHint(preferred_nodes=pref,
                                                      excluded_nodes=excl))
            before = row.copy()
            got.append(hints.apply_to_mask(f"p{k}", row))
            assert np.array_equal(row, before)
            assert hints.has_hint(f"p{k}")
        hints.clear("p0")
        got.append(hints.apply_to_mask("p0", rows[0]))
        outs.append(np.stack(got))
    assert np.array_equal(outs[0], outs[1])
