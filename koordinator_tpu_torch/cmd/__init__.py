"""Per-binary CLI entry points (port of ``koordinator_tpu/cmd/__init__.py``,
copied whole).

The reference ships six binaries, each a cobra/pflag command
(SURVEY.md §2.1: koord-scheduler, koord-manager, koordlet,
koord-descheduler, koord-runtime-proxy, koord-device-daemon) sharing a
flag vocabulary: ``--feature-gates A=true,B=false`` (k8s component-base),
leader-election flags (``cmd/koord-manager/main.go``), address/interval
knobs, and component-specific options. This package is that layer:
``koordinator_tpu_torch.cmd.binaries`` holds each binary's parser and
``main_<binary>(argv)``, which assembles the component graph from flags and
returns it (callers/tests drive it).  The port has the scheduler binary
only so far (``binaries.MAINS``).
"""

from __future__ import annotations

import argparse

from koordinator_tpu_torch.features import FeatureGates
from koordinator_tpu_torch.ha import InMemoryLeaseStore, LeaderElector


def add_common_flags(parser: argparse.ArgumentParser) -> None:
    """Flags every binary shares (component-base + controller-runtime)."""
    parser.add_argument(
        "--feature-gates", default="", metavar="A=true,B=false",
        help="comma-separated feature gate overrides")
    parser.add_argument(
        "--metrics-addr", default=":8080",
        help="prometheus metrics bind address")
    parser.add_argument(
        "--enable-pprof", action="store_true",
        help="enable the profiling endpoint")
    parser.add_argument(
        "--v", type=int, default=2, help="log verbosity (klog -v)")
    parser.add_argument(
        "--self-telemetry-interval-seconds", type=float, default=0.0,
        help="background cadence for the process self-telemetry gauges "
             "(RSS, fds, threads, alloc blocks, gc — the trend engine's "
             "leak-watch inputs, labeled binary=<name>); 0 disables the "
             "thread (the scheduler still refreshes them on every SLO "
             "sample sweep)")


def build_self_telemetry(args: argparse.Namespace, binary: str):
    """A started SelfTelemetry when the cadence flag asks for one, else
    an unstarted instance (callers may still hook .sample) — ONE wiring
    shared by every binary main."""
    from koordinator_tpu_torch.selftelemetry import SelfTelemetry

    telemetry = SelfTelemetry(binary)
    interval = getattr(args, "self_telemetry_interval_seconds", 0.0)
    if interval and interval > 0:
        telemetry.start(interval)
    return telemetry


def add_leader_election_flags(parser: argparse.ArgumentParser,
                              default_lease: str) -> None:
    """cmd/koord-manager/main.go:66-73 equivalents."""
    parser.add_argument(
        "--enable-leader-election", dest="enable_leader_election",
        action="store_true", default=True)
    parser.add_argument(
        "--disable-leader-election", dest="enable_leader_election",
        action="store_false")
    parser.add_argument("--leader-election-namespace",
                        default="koordinator-system")
    parser.add_argument("--leader-elect-lease-name", default=default_lease)
    parser.add_argument("--leader-elect-lease-duration", type=float,
                        default=15.0)
    parser.add_argument("--leader-elect-retry-period", type=float,
                        default=2.0)
    parser.add_argument("--identity", default="",
                        help="holder identity (defaults to hostname+pid)")


def apply_feature_gates(spec: str, gates: FeatureGates) -> None:
    if spec:
        gates.set_from_spec(spec)


def build_elector(args: argparse.Namespace,
                  store: InMemoryLeaseStore | None = None
                  ) -> LeaderElector | None:
    """None when disabled (leader_gated treats None as always-leader)."""
    if not getattr(args, "enable_leader_election", False):
        return None
    import os
    import socket

    identity = args.identity or f"{socket.gethostname()}-{os.getpid()}"
    return LeaderElector(
        store if store is not None else InMemoryLeaseStore(),
        lease_name=(f"{args.leader_election_namespace}/"
                    f"{args.leader_elect_lease_name}"),
        identity=identity,
        lease_duration=args.leader_elect_lease_duration,
        retry_period=args.leader_elect_retry_period,
    )
