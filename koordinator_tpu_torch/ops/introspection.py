"""Solver introspection: first calls a shape bucket, device bytes, profiler
capture (port of ``koordinator_tpu/ops/introspection.py``).

Three answers a self-observing scheduler needs when the latency SLO
burns (slo_monitor.py): is it first-call costs, device memory pressure, or
something else:

- :func:`instrument` wraps a solver entry point and counts its first call
  at each shape bucket (the label ``shape_of`` gives) into
  ``solver_recompiles_total{fn, shape}``, with the number of buckets seen
  in the ``solver_jit_cache_size{fn}`` gauge: the JAX package's series,
  under the same names and labels.  The port compiles nothing per shape
  (no jit cache: the kernels are built once, ahead of any call), so its
  "compile" is the first call of an entry at a new bucket.  That call is
  where the port pays its first-call costs: the kernel library's load or
  build (``kernels/build.py``) on the process's first launch, and the CUDA
  caching allocator's growth to the bucket's working set.  A bucket counts
  once for the lifetime of the wrapper, whatever the static arguments
  (JAX's jit recompiles per static-argument set, so its counts may exceed
  one where the port's stay at one).
- :func:`device_bytes` sums ``nbytes`` of the tensors of a tree
  (``ClusterState``, ``CandidateCache``): metadata only, no copy, no sync.
- :class:`ProfilerCapture` exposes ``torch.profiler`` as an on-demand,
  **gated-off-by-default** capture for the ``/debug/profile?seconds=N``
  endpoint (a production scheduler must not let any caller start a device
  trace unless the operator enabled the gate at assembly).  The trace
  covers the whole process: CUDA kernels are recorded whichever thread
  launched them (a round on the solve server's thread while the capture
  sleeps on the gateway's).

The JAX module's collective counters read XLA's compiled HLO over a mesh;
the port has no mesh, so they are not here.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import threading
import time

import torch

from koordinator_tpu_torch import metrics

#: the file a capture writes into its directory
TRACE_FILE = "trace.json"


def _leaves(tree):
    """The tensors of a tree of dataclasses, tuples, lists and dicts."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _leaves(item)
    elif isinstance(tree, dict):
        for item in tree.values():
            yield from _leaves(item)


def default_shape_of(args, kwargs) -> str:
    """Fallback shape-bucket label: the distinct tensor shapes of the
    positional args, largest first, capped for label sanity."""
    shapes = {tuple(int(d) for d in leaf.shape) for leaf in _leaves(args)}
    top = sorted(shapes,
                 key=lambda s: (-int(math.prod(s or (1,))), s))[:3]
    return "/".join("x".join(map(str, s)) if s else "scalar" for s in top)


class InstrumentedJit:
    """Callable wrapper over a solver entry that counts its first call at
    each shape bucket (the JAX class's name, kept so both packages'
    dashboards and tests name one thing).

    The wrapper is pass-through: arguments and outputs are exactly the
    wrapped function's.  A call that raises counts nothing; a labeling
    failure labels the bucket ``unknown`` rather than fail the solve.
    """

    def __init__(self, fn, name: str, shape_of=None):
        self.fn = fn
        self.name = name
        self.shape_of = shape_of or default_shape_of
        self._seen: set[str] = set()
        self._lock = threading.Lock()
        self.misses = 0

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        try:
            shape = self.shape_of(args, kwargs)
        except Exception:  # noqa: BLE001 — labeling must not fail a solve
            shape = "unknown"
        if shape not in self._seen:
            with self._lock:
                if shape not in self._seen:
                    self._seen.add(shape)
                    self.misses += 1
                    metrics.solver_recompiles.inc(
                        labels={"fn": self.name, "shape": shape})
                    metrics.solver_jit_cache_size.set(
                        float(len(self._seen)), labels={"fn": self.name})
        return out


def instrument(fn, name: str, shape_of=None) -> InstrumentedJit:
    """Wrap a solver entry point for first-call accounting.

    ``shape_of(args, kwargs) -> str`` names the shape bucket; callers
    with a known signature should pass one (e.g. ``P{batch}xN{nodes}``)
    — the default derives a generic label from the tensor shapes."""
    return InstrumentedJit(fn, name, shape_of=shape_of)


def device_bytes(tree) -> int:
    """Total ``nbytes`` of the tensors of a tree (0 for None).  Metadata
    only: never blocks on or copies device memory."""
    return sum(int(leaf.nbytes) for leaf in _leaves(tree))


def device_bytes_by_shard(tree) -> dict[int, int]:
    """Per-device footprint of a tree's tensors: {device index: bytes}.
    The port solves on one device, so every tensor lands on its device's
    index (0 for the CPU)."""
    out: dict[int, int] = {}
    for leaf in _leaves(tree):
        did = leaf.device.index or 0
        out[did] = out.get(did, 0) + int(leaf.nbytes)
    return out


class ProfileDisabled(Exception):
    """The profiling endpoint gate is off (the default)."""


class ProfileBusy(Exception):
    """A capture is already in flight (one trace at a time)."""


class TorchProfiler:
    """``start_trace(dir)``/``stop_trace()`` over ``torch.profiler``: host
    ops, and with a GPU present the CUDA kernels of every thread; the stop
    writes a Chrome trace (:data:`TRACE_FILE`) into the directory."""

    def __init__(self):
        self._prof = None
        self._dir = None

    def start_trace(self, out_dir: str) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._dir = out_dir
        self._prof.start()

    def stop_trace(self) -> None:
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(self._dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self._dir, TRACE_FILE))


class ProfilerCapture:
    """On-demand ``torch.profiler`` trace capture behind an explicit gate.

    ``enabled=False`` (the default) refuses every capture with
    :class:`ProfileDisabled` — the endpoint ships dark and an operator
    turns it on at assembly (``--enable-profile-endpoint``).  Captures
    serialize on a lock and are clamped to ``max_seconds``.
    ``profiler``/``sleep`` are injectable for tests.
    """

    def __init__(self, enabled: bool = False, out_dir: str | None = None,
                 max_seconds: float = 30.0, profiler=None, sleep=time.sleep):
        self.enabled = enabled
        self.out_dir = out_dir
        self.max_seconds = max_seconds
        self._profiler = profiler
        self._sleep = sleep
        self._lock = threading.Lock()
        self.captures = 0
        #: True while a trace is recording (between the profiler's start
        #: and its stop)
        self.recording = False

    def _torch_profiler(self):
        if self._profiler is not None:
            return self._profiler
        return TorchProfiler()

    def capture(self, seconds: float) -> dict:
        """Run one trace for ``seconds`` (clamped to (0, max_seconds]);
        returns ``{"dir", "seconds"}`` where ``dir`` holds the Chrome
        trace (``chrome://tracing``, Perfetto)."""
        if not self.enabled:
            raise ProfileDisabled(
                "profiling endpoint disabled (enable at assembly with "
                "--enable-profile-endpoint)")
        seconds = float(seconds)
        if not math.isfinite(seconds):
            # nan survives min/max clamping and would start a trace
            # only to die inside sleep()
            raise ValueError("seconds must be finite")
        seconds = min(max(seconds, 0.001), self.max_seconds)
        if not self._lock.acquire(blocking=False):
            raise ProfileBusy("a profiler capture is already running")
        try:
            out_dir = self.out_dir or tempfile.mkdtemp(
                prefix="koord-torch-profile-")
            profiler = self._torch_profiler()
            profiler.start_trace(out_dir)
            self.recording = True
            try:
                self._sleep(seconds)
            finally:
                self.recording = False
                profiler.stop_trace()
            self.captures += 1
            return {"dir": out_dir, "seconds": seconds}
        finally:
            self._lock.release()
