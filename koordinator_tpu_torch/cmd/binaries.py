"""The scheduler binary's parser and assembly (port of
``koordinator_tpu/cmd/binaries.py``; reference ``cmd/koord-scheduler``).

``main_koord_scheduler(argv)`` parses flags, applies feature gates, and
returns the assembled component graph as an :class:`Assembled` — callers
(tests, a deployment shim) wire transports and drive rounds themselves.
The flags are the JAX binary's, with the same defaults and help; the port
assembles on the GPU unless the caller passes ``device="cpu"``.

A flag whose module the port does not have yet exits with ``SystemExit``
naming that module, never silently ignored: ``--tenants`` above 1
(``scheduler/tenancy.py``), ``--quality-mode`` other than ``off``
(``quality/lp_pack.py``), ``--forecast-mode`` other than ``off``
(``forecast/plane.py``) and ``--checkpoint-path``
(``drills/checkpoint.py``).  The other five binaries (koordlet,
koord-manager, koord-descheduler, koord-runtime-proxy,
koord-device-daemon) are not in the port yet: :data:`MAINS` names the
scheduler only.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Optional

from koordinator_tpu_torch.cmd import (
    add_common_flags,
    add_leader_election_flags,
    apply_feature_gates,
    build_elector,
    build_self_telemetry,
)


@dataclasses.dataclass
class Assembled:
    """What a binary main() hands back: the component graph + metadata."""

    name: str
    args: argparse.Namespace
    component: Any
    elector: Optional[Any] = None
    server: Optional[Any] = None   # transport RpcServer when one was opened
    gateway: Optional[Any] = None  # HTTP/JSON gateway when one was opened
    state_sync: Optional[Any] = None  # StateSyncService (sidecar assembly)
    #: parsed component config (SchedulerComponentConfig) so the
    #: embedding shell wires data-dependent plugins with file args
    component_config: Optional[Any] = None
    #: process self-telemetry sampler (selftelemetry.SelfTelemetry) —
    #: every binary registers the same leak-watch gauges under its own
    #: binary label
    telemetry: Optional[Any] = None

    def stop(self) -> None:
        """Tear down whatever this binary opened (the telemetry thread, the
        gateway, the server, the component's own lifecycle: the
        scheduler's SLO sampler); a leading elector releases its lease so a
        follower acquires without waiting out the duration."""
        # journey-ledger fleet snapshot: every binary flushes its sketch
        # table on teardown when KOORD_JOURNEY_JSONL names a path —
        # tools/latency_report.py merges the per-process files into one
        # fleet-wide journey table (merge = bucket-wise add)
        journey_path = os.environ.get("KOORD_JOURNEY_JSONL")
        if journey_path:
            try:
                from koordinator_tpu_torch import journey

                if journey.LEDGER.enabled:
                    journey.LEDGER.write_jsonl(journey_path)
            except Exception:
                pass
        if self.telemetry is not None:
            self.telemetry.stop()
        if self.elector is not None:
            self.elector.release()
        if self.gateway is not None:
            self.gateway.stop()
        if self.server is not None:
            self.server.stop()
        stop = getattr(self.component, "stop", None)
        if callable(stop):
            stop()


# ---- koord-scheduler -------------------------------------------------------

def build_scheduler_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="koord-scheduler")
    add_common_flags(parser)
    add_leader_election_flags(parser, default_lease="koord-scheduler")
    parser.add_argument("--node-capacity", type=int, default=1024,
                        help="initial padded node-state capacity")
    parser.add_argument("--gang-passes", type=int, default=2)
    parser.add_argument("--batch-solver-threshold", type=int, default=1024,
                        help="queue size at which rounds switch from the "
                             "exact greedy scan to the data-parallel "
                             "propose/accept engine")
    parser.add_argument("--enable-preemption", action="store_true")
    parser.add_argument("--sync-barrier-timeout", type=float, default=30.0,
                        help="app/sync_barrier.go wait budget")
    parser.add_argument(
        "--staleness-threshold-seconds", type=float, default=0.0,
        help="sync-feed silence (seconds) after which rounds flip into "
             "stale-state degraded mode: BE/batch-dim admission suspends "
             "and solves go full-pass until a resync re-warms the feed; "
             "0 disables the watchdog")
    parser.add_argument("--listen-socket", default="",
                        help="unix socket for the solve/state-sync RPC "
                             "services (empty = in-process only)")
    parser.add_argument(
        "--http-port", type=int, default=None,
        help="serve the HTTP/JSON gateway (solve, state push, leases, "
             "diagnosis) — the zero-client-code sidecar surface; omit "
             "to disable")
    parser.add_argument(
        "--config", default="",
        help="KubeSchedulerConfiguration YAML with per-plugin args "
             "(LoadAwareScheduling, NodeResourcesFitPlus, "
             "ScarceResourceAvoidance, Coscheduling) — the reference's "
             "versioned component config; defaults apply where unset")
    parser.add_argument(
        "--no-explain", action="store_true",
        help="disable placement explainability: the device-side "
             "reject-reason accounting (ops/explain.py), the "
             "/debug/explain/<pod> explanations, and the "
             "unschedulable_pods/filter_reject_fraction/capacity_slack "
             "rollups all go dark; Diagnose falls back to the per-pod "
             "host recompute")
    parser.add_argument(
        "--no-timeline", action="store_true",
        help="disable the critical-path observatory (timeline.py): no "
             "per-cycle segment recording, host-wait attribution, "
             "critical-path solving, or /debug/timeline bodies — the "
             "kill switch for suspected self-overhead (decisions are "
             "bit-identical either way; KOORD_TIMELINE=0 is the env "
             "equivalent)")
    parser.add_argument(
        "--no-journey", action="store_true",
        help="disable the pod-journey ledger (journey.py): no per-pod "
             "arrival/enqueue/bind latency sketches, /debug/latency "
             "answers 501, and the pod_journey_latency_seconds gauges "
             "go dark — the kill switch for suspected self-overhead "
             "(scheduling decisions and quota charges are bit-identical "
             "either way; KOORD_JOURNEY=0 is the env equivalent)")
    parser.add_argument(
        "--trace-pods", action="store_true",
        help="open a root trace span for EVERY enqueued pod (pods whose "
             "submitter propagated a trace context are always traced); "
             "spans land in the in-process ring (/debug/trace/<pod>) "
             "and any KOORD_TRACE_JSONL exporter")
    parser.add_argument(
        "--slo-sample-interval-seconds", type=float, default=0.0,
        help="background SLO burn-rate sampling cadence: every interval "
             "the registry metrics are sampled into the in-process "
             "time-series and the SLO specs' fast/slow burn windows are "
             "evaluated (breach -> alert counter + flight-recorder "
             "dump).  0 (default) = on-demand only: each GET /debug/slo "
             "request samples + evaluates; production sidecars should "
             "set e.g. 5")
    parser.add_argument(
        "--slo-latency-threshold-seconds", type=float, default=0.2,
        help="the scheduling-latency SLO's per-observation bound (the "
             "paper's p99 target: 0.2)")
    parser.add_argument(
        "--flight-ring-size", type=int, default=256,
        help="round flight-recorder ring capacity: a long soak's report "
             "joins trend verdicts to rounds, so size this to cover the "
             "report window (round_flight_overwritten_total counts the "
             "records a too-small ring silently evicts)")
    parser.add_argument(
        "--trend-window-seconds", type=float, default=1800.0,
        help="the /debug/steady trend engine's default evaluation "
             "window: slopes over the self-telemetry/queue-depth series "
             "are fitted over this much history and classified "
             "steady/drifting/leaking (?window=N overrides per request)")
    parser.add_argument(
        "--tenants", type=int, default=1,
        help="multiplex N clusters onto this scheduler's mesh "
             "(scheduler/tenancy.py): each tenant gets its own "
             "snapshot/quota/degraded state and sync binding (extra "
             "tenants listen at <listen-socket>.<tenant>), all sharing "
             "ONE compiled solver; rounds run as pipelined (or "
             "tenant-axis batched) cycles with weighted-fair admission")
    parser.add_argument(
        "--tenant-weights", default="",
        help="comma-separated weighted-fair admission weights, one per "
             "tenant (short lists pad with 1.0)")
    parser.add_argument(
        "--tenant-cycle-pod-budget", type=int, default=4096,
        help="pods admitted per multi-tenant cycle across all tenants "
             "(the weighted deficit-round-robin quantum)")
    parser.add_argument(
        "--quality-mode", choices=("off", "lp", "auto"), default="off",
        help="solve-quality mode (quality/lp_pack): off = the greedy "
             "top-k path exactly; lp = every eligible round solves "
             "with the LP-relaxation packing engine (dual-price "
             "ascent + iterative masked rounding, feasibility-checked "
             "by the greedy path's own capacity/quota kernels); auto "
             "= escalate only rounds whose result leaves min-over-dims "
             "capacity_slack_fraction above --quality-slack-threshold. "
             "Gangs with topology requirements additionally plan "
             "through the rank-aware minimal-diameter planner "
             "(quality/topo_gang) whenever the mode is not off")
    parser.add_argument(
        "--quality-slack-threshold", type=float, default=0.3,
        help="auto-mode escalation bar: when the MINIMUM "
             "capacity_slack_fraction over provisioned dims left by a "
             "round exceeds this, the next round solves on the "
             "quality path (every dimension must have headroom worth "
             "winning back)")
    parser.add_argument(
        "--forecast-mode", choices=("off", "admit", "full"), default="off",
        help="forecast plane (forecast/): off = today's solve exactly "
             "(bit-identical acceptance decisions and quota charges); "
             "admit = the forecast-headroom reserve — the predicted LS "
             "peak growth not yet visible in observed usage — charges "
             "into every round's filter/score accounting; full = "
             "admission plus the predictive-colocation and "
             "proactive-rebalance drivers where the deployment shell "
             "wires them.  Any mode other than off attaches a "
             "ForecastPlane fed from the round prelude and serves "
             "/debug/forecast")
    parser.add_argument(
        "--forecast-horizon-seconds", type=float, default=120.0,
        help="the forecast plane's base prediction horizon; stretches "
             "with the diurnal trend slope (plane.horizon_for) up to "
             "4x")
    parser.add_argument(
        "--enable-profile-endpoint", action="store_true",
        help="arm /debug/profile?seconds=N (on-demand jax.profiler "
             "capture); OFF by default — the endpoint answers 403 "
             "until an operator enables it here")
    parser.add_argument(
        "--profile-dir", default="",
        help="directory for /debug/profile trace captures (default: a "
             "fresh temp dir per capture)")
    parser.add_argument(
        "--checkpoint-path", default="",
        help="warm-restart checkpoint file (docs/robustness.md): "
             "restored on boot when present, rewritten every "
             "--checkpoint-interval-seconds and once on stop; empty "
             "disables checkpointing (behavior is bit-identical either "
             "way — the checkpoint is host state + the replay cursor, "
             "never solver state)")
    parser.add_argument(
        "--checkpoint-interval-seconds", type=float, default=30.0,
        help="cadence of the background checkpoint writer")
    return parser


def refuse_unported_flags(args: argparse.Namespace) -> None:
    """Exit naming the module a flag needs when the port lacks it."""
    missing = []
    if args.tenants > 1:
        missing.append(("--tenants above 1", "scheduler/tenancy.py"))
    if args.quality_mode != "off":
        missing.append((f"--quality-mode {args.quality_mode}",
                        "quality/lp_pack.py"))
    if args.forecast_mode != "off":
        missing.append((f"--forecast-mode {args.forecast_mode}",
                        "forecast/plane.py"))
    if args.checkpoint_path:
        missing.append(("--checkpoint-path", "drills/checkpoint.py"))
    if missing:
        raise SystemExit("; ".join(
            f"{flag} needs {module}, which the PyTorch port does not have "
            "yet" for flag, module in missing))


def main_koord_scheduler(argv: list[str], lease_store=None, preempt_fn=None,
                         device=None) -> Assembled:
    """``preempt_fn(victim, preemptor)`` is the deployment shell's
    eviction transport; required when preemption is enabled (the flag or
    the config file), because nominating victims without evicting them
    frees accounting for pods that keep running.  ``device``: where the
    scheduler's tensors live (None means the GPU)."""
    from koordinator_tpu_torch.device import resolve_device
    from koordinator_tpu_torch.features import SCHEDULER_GATES
    from koordinator_tpu_torch.ops.assignment import ScoringConfig
    from koordinator_tpu_torch.scheduler import ClusterSnapshot, Scheduler
    from koordinator_tpu_torch.scheduler.cpu_manager import CPUManager
    from koordinator_tpu_torch.scheduler.device_manager import DeviceManager
    from koordinator_tpu_torch.scheduler.explanation import (
        ExplanationStore,
        WorkloadAuditor,
    )

    args = build_scheduler_parser().parse_args(argv)
    refuse_unported_flags(args)
    device = resolve_device(device)
    apply_feature_gates(args.feature_gates, SCHEDULER_GATES)
    if args.no_timeline:
        from koordinator_tpu_torch import timeline

        timeline.RECORDER.set_enabled(False)
    if args.no_journey:
        from koordinator_tpu_torch import journey

        journey.LEDGER.set_enabled(False)
    from koordinator_tpu_torch.cmd.component_config import (
        SchedulerComponentConfig,
        load_scheduler_config,
    )

    # always go through the component config so every default (gang
    # timeout, scoring) has exactly one home — the dataclass
    component_config = (
        load_scheduler_config(args.config, device=device) if args.config
        else SchedulerComponentConfig(scoring=ScoringConfig.default(device)))
    snapshot = ClusterSnapshot(capacity=args.node_capacity, device=device)
    elector = build_elector(args, lease_store)
    # precedence: an explicit CLI flag wins over the config file, which
    # wins over built-in defaults (matching the reference's flag
    # layering).  Tri-state is preserved: an explicit `enablePreemption:
    # false` in the config must reach the Scheduler as False, not
    # collapse to None (which would auto-enable when preempt_fn is
    # wired).
    enable_preemption = (True if args.enable_preemption
                         else component_config.enable_preemption)
    if enable_preemption and preempt_fn is None:
        raise SystemExit(
            "preemption enabled (flag or config) but no eviction "
            "transport wired: pass preempt_fn to main_koord_scheduler — "
            "nominating victims without evicting them double-books nodes")
    scheduler = Scheduler(
        snapshot,
        config=component_config.scoring,
        gang_passes=args.gang_passes,
        gang_default_timeout_sec=component_config.gang_default_timeout_sec,
        batch_solver_threshold=args.batch_solver_threshold,
        enable_preemption=enable_preemption,
        preempt_fn=preempt_fn,
        elector=elector,
        staleness_threshold_sec=(args.staleness_threshold_seconds
                                 if args.staleness_threshold_seconds > 0
                                 else None),
        trace_pods=args.trace_pods,
        explain=not args.no_explain,
        flight_ring_size=args.flight_ring_size,
        explanations=ExplanationStore(),
        auditor=WorkloadAuditor(),
        cpu_manager=CPUManager(device=device),
        device_manager=DeviceManager(device=device),
    )
    # -- self-observability: SLO burn-rate engine + solver introspection
    from koordinator_tpu_torch import journey as _journey
    from koordinator_tpu_torch.ops.introspection import ProfilerCapture
    from koordinator_tpu_torch.slo_monitor import SloMonitor, default_specs
    from koordinator_tpu_torch.trend import TrendEngine

    # self-telemetry rides the SLO sampler (every sweep — background OR
    # on-demand /debug/slo//debug/steady — refreshes RSS/fds/threads
    # first), so the scheduler needs no second sampling thread
    telemetry = build_self_telemetry(args, "koord-scheduler")
    slo_monitor = SloMonitor(
        specs=default_specs(
            latency_threshold_s=args.slo_latency_threshold_seconds,
            staleness_threshold_s=(args.staleness_threshold_seconds
                                   if args.staleness_threshold_seconds > 0
                                   else 30.0)),
        sample_interval_s=(args.slo_sample_interval_seconds
                           if args.slo_sample_interval_seconds > 0 else 5.0),
        # a fast-burn breach dumps the latest round's flight record with
        # the offending SLO named — the "why" artifact next to the alert
        on_breach=lambda spec, doc: scheduler.flight_recorder.dump_now(
            f"slo:{spec.name}"),
        # the journey ledger's quantile gauges refresh in the SAME sweep
        # that evaluates the SLO windows, so burn rates compute from true
        # per-pod e2e quantiles instead of round-bucket interpolation
        pre_sample=[telemetry.sample, _journey.LEDGER.publish_gauges],
    )
    scheduler.slo_monitor = slo_monitor
    # the trend engine shares the SLO monitor's sample cache: one
    # sampling pass feeds burn rates AND the long-horizon leak watch
    scheduler.trend_engine = TrendEngine(
        slo_monitor.cache, window_s=args.trend_window_seconds)
    if args.slo_sample_interval_seconds > 0:
        slo_monitor.start()   # stopped via Assembled.stop -> Scheduler.stop
    if args.enable_profile_endpoint:
        scheduler.profile_capture = ProfilerCapture(
            enabled=True, out_dir=args.profile_dir or None)
    server = None
    sync_service = None
    if args.listen_socket or args.http_port is not None:
        # the SIDECAR assembly: state enters over STATE_PUSH frames or
        # POST /v1/state, lands in the sync service, and applies to the
        # scheduler synchronously through an in-process binding — the
        # same commit->binding path remote sync clients ride, minus the
        # socket loop.  Remote replicas can still HELLO the same service
        # for snapshots/deltas.
        from koordinator_tpu_torch.transport.deltasync import (
            SchedulerBinding,
            StateSyncService,
        )

        sync_service = StateSyncService()
        sync_service.attach_binding(SchedulerBinding(scheduler))
    # the lease surface (frames + HTTP) must share the elector's store:
    # a private store would let a remote contender "acquire" a lease the
    # local elector also holds in the real one — split-brain
    shared_lease_store = (elector.store if elector is not None
                          else lease_store)
    if shared_lease_store is None:
        from koordinator_tpu_torch.ha import InMemoryLeaseStore

        shared_lease_store = InMemoryLeaseStore()
    if args.listen_socket:
        from koordinator_tpu_torch.ha import LeaseService
        from koordinator_tpu_torch.transport import RpcServer
        from koordinator_tpu_torch.transport.services import SolveService

        server = RpcServer(args.listen_socket, service="scheduler")
        SolveService(scheduler).attach(server)
        sync_service.attach(server)
        LeaseService(store=shared_lease_store).attach(server)
        server.start()
    gateway = None
    if args.http_port is not None:
        from koordinator_tpu_torch.transport.http_gateway import HttpGateway

        gateway = HttpGateway(port=args.http_port, scheduler=scheduler,
                              state_sync=sync_service,
                              lease_store=shared_lease_store)
        gateway.start()
    return Assembled(name="koord-scheduler", args=args, component=scheduler,
                     elector=elector, server=server,
                     gateway=gateway, state_sync=sync_service,
                     component_config=component_config,
                     telemetry=telemetry)


MAINS = {
    "koord-scheduler": main_koord_scheduler,
}
