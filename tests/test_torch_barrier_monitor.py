"""The port's copies of ``scheduler/barrier.py`` (whole) and
``scheduler/monitor.py`` (without its metrics, timeline and tracing hooks)
against the JAX package's: the same calls on a fake clock give the same
answers and the same state."""

import logging

import pytest

PKGS = ["jax", "port"]


def barrier_cls(pkg):
    if pkg == "jax":
        from koordinator_tpu.scheduler.barrier import SyncBarrier
    else:
        from koordinator_tpu_torch.scheduler.barrier import SyncBarrier
    return SyncBarrier


def monitor_cls(pkg):
    if pkg == "jax":
        from koordinator_tpu.scheduler.monitor import SchedulerMonitor
    else:
        from koordinator_tpu_torch.scheduler.monitor import SchedulerMonitor
    return SchedulerMonitor


def barrier_trace(pkg, seen_after, timeout):
    """A barrier on a fake clock whose informer sees the barrier's version
    after ``seen_after`` polls: every answer along the way."""
    t, polls, version = [0.0], [0], [4]

    def observed():
        polls[0] += 1
        return version[0] if polls[0] > seen_after else version[0] - 1

    def sleep(s):
        t[0] += s

    b = barrier_cls(pkg)(lambda: version[0], observed,
                         timeout_seconds=timeout, clock=lambda: t[0],
                         sleep=sleep)
    out = [b.check(), b.synced]
    out.append(b.start())
    out.append(b.synced)
    out.append(b.wait_until_synced(poll_interval=0.1))
    out += [b.synced, b.check(), round(t[0], 6), polls[0]]
    version[0] = 5
    out.append(b.start())
    out += [b.check(), b.synced]
    return out


@pytest.mark.parametrize("seen_after,timeout", [(0, 1.0), (3, 1.0),
                                                (50, 1.0), (50, 0.0)])
def test_barrier_equals_the_reference(seen_after, timeout):
    assert barrier_trace("port", seen_after, timeout) == barrier_trace(
        "jax", seen_after, timeout)


def test_barrier_opens_on_timeout_and_says_so():
    out = barrier_trace("port", 10**6, 0.5)
    assert out[4] is False and out[5] is True


def monitor_trace(pkg, caplog):
    t = [0.0]
    m = monitor_cls(pkg)(timeout_sec=1.0, history=3, clock=lambda: t[0])
    out = []
    for rnd, steps in enumerate(([("A", 0.5), ("B", 0.25), ("A", 0.25)],
                                 [("A", 2.0), ("C", 0.125)],
                                 [("B", 0.5)], [("A", 0.5)])):
        m.start_round()
        for name, dt in steps:
            with m.phase(name, carry_s=0.5 if name == "C" else 0.0):
                t[0] += dt
        out.append(dict(m.round_timings))
    with pytest.raises(KeyError):
        with m.phase("D"):
            t[0] += 3.0
            raise KeyError("x")
    out.append(dict(m.round_timings))
    out.append({k: list(v) for k, v in m.phase_history.items()})
    out.append(m.slow_rounds)
    out.append(m.stats())
    out.append(sorted(r.getMessage() for r in caplog.records
                      if "scheduling phase" in r.getMessage()))
    caplog.clear()
    return out


def test_monitor_equals_the_reference(caplog):
    caplog.set_level(logging.WARNING)
    want = monitor_trace("jax", caplog)
    got = monitor_trace("port", caplog)
    assert got == want
    assert got[6] == 2                     # A at 2.0 s and D at 3.0 s
    assert len(got[5]["A"]) == 3           # the history keeps 3


def test_monitor_defaults():
    for pkg in PKGS:
        m = monitor_cls(pkg)()
        assert (m.timeout_sec, m.slow_rounds, m.round_timings, m.tenant,
                m.stats()) == (1.0, 0, {}, "", {})
