"""Plumbing validation for the multi-host scaling-bench artifact.

``python bench.py --sharded D --multihost`` is the BASELINE.md "N hosts"
measurement command, meant to run unchanged (SPMD) in every process of a
multi-host run. This test drives it with 2 real OS processes x 2 CPU
devices (localhost coordinator via the --coordinator/--num-processes/
--process-id options) and asserts
process 0 emits the one-line JSON artifact with a sane per-device
throughput row — so the command is known-good before it sees a cluster.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_multihost_bench_two_processes():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env.update(JAX_PLATFORMS="cpu")
        procs.append(
            subprocess.Popen(
                [sys.executable, BENCH, "--sharded", "4", "--multihost",
                 "--size", "8", "--reps", "1",
                 "--coordinator", f"localhost:{port}", "--num-processes",
                 "2", "--process-id", str(pid), "--cpu-devices", "2"],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
                env=env,
                cwd=ROOT,
            )
        )
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=900)
            assert p.returncode == 0, f"bench worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:  # never orphan the peer blocked in distributed init
            if p.poll() is None:
                p.kill()
                p.wait()

    # exactly one process (0) prints the JSON artifact
    jsons = [
        json.loads(line)
        for out in outs
        for line in out.splitlines()
        if line.startswith("{")
    ]
    assert len(jsons) == 1, outs
    rec = jsons[0]
    assert rec["metric"] == "bn254_msm_2^8_multihost_2hosts_4devices"
    assert rec["unit"] == "field_muls_per_sec_per_device"
    # a CPU run nulls the headline value and flags plumbing_only; the
    # per-shard detail rows still carry the measured plumbing numbers
    assert rec["plumbing_only"] is True
    assert rec["value"] is None
    assert rec["platform"] == "cpu"
    assert rec["detail"][0]["field_muls_per_sec_per_device"] > 0
    assert rec["detail"][0]["shards"] == 4
