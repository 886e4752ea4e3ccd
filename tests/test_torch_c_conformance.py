"""Cross-language conformance against the port: the compiled C client
(native/conformance_client.c, built as tests/test_c_conformance.py builds
it) drives the full wire protocol (HELLO's version skew, the snapshot, state
pushes, delta pushes, a solve, the lease CAS) against the port's
``koord-scheduler`` binary, ``main_koord_scheduler(..., device="cpu")``,
over TCP, with the assertions of ``test_c_client_full_protocol``; and its
result document equals the one it prints against the JAX binary.
"""

import json
import os
import subprocess

import pytest

from tests.torch_parity import reset_observability, set_torch_threads

set_torch_threads()

SRC = os.path.join(os.path.dirname(__file__), "..", "native",
                   "conformance_client.c")


@pytest.fixture(autouse=True)
def _fresh():
    reset_observability()
    yield
    reset_observability()


@pytest.fixture(scope="module")
def client_bin(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cbin") / "conformance_client")
    try:
        proc = subprocess.run(
            ["gcc", "-O2", "-Wall", "-Werror", "-o", out, SRC],
            capture_output=True, text=True, timeout=120)
    except FileNotFoundError:
        pytest.skip("no C toolchain on this machine")
    if proc.returncode != 0:
        pytest.fail(f"C client failed to compile:\n{proc.stderr}")
    return out


def drive(pkg: str, client_bin: str) -> dict:
    """The C client against one package's binary; returns its result
    document after the full-protocol assertions."""
    if pkg == "jax":
        from koordinator_tpu.api.resources import (
            NUM_RESOURCE_DIMS,
            resource_vector,
        )
        from koordinator_tpu.cmd.binaries import main_koord_scheduler

        kw = {}
    else:
        from koordinator_tpu_torch.api.resources import (
            NUM_RESOURCE_DIMS,
            resource_vector,
        )
        from koordinator_tpu_torch.cmd.binaries import main_koord_scheduler

        kw = {"device": "cpu"}
    asm = main_koord_scheduler([
        "--node-capacity", "16",
        "--listen-socket", "tcp://127.0.0.1:0",
        "--disable-leader-election",
    ], **kw)
    sched = asm.component
    try:
        # state that predates the C client: it must arrive via SNAPSHOT
        asm.state_sync.upsert_node("py-node",
                                   resource_vector(cpu=8_000, memory=32_768))
        asm.state_sync.add_pod("py-pod",
                               resource_vector(cpu=1_000, memory=1_024))
        proc = subprocess.run(
            [client_bin, "127.0.0.1", asm.server.address.rsplit(":", 1)[1],
             str(NUM_RESOURCE_DIMS)],
            capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, (
            f"C client failed (stderr):\n{proc.stderr}\n"
            f"stdout:\n{proc.stdout}")
        result = json.loads(proc.stdout)
        assert result["skew_rejected"] is True
        assert result["snapshot_events"] == 2
        assert result["snapshot_rv"] == 2
        assert result["snapshot_arrays_ok"] is True
        assert result["node_rv"] == 3 and result["pod_rv"] == 4
        assert result["deltas_seen"] >= 1
        assert result["c_pod_node"] == "c-node"
        assert "py-pod" in result["assignments"]
        assert result["lease_acquired"] is True
        assert result["stale_cas_refused"] is True
        assert "c-pod" not in sched.pending
        if pkg == "torch":
            assert sched.device.type == "cpu"
    finally:
        asm.stop()
    return result


def test_c_client_full_protocol_against_the_port(client_bin):
    got = drive("torch", client_bin)
    assert got == drive("jax", client_bin)
