"""Multi-host proof: 2 real processes x 2 CPU devices -> 4-device global mesh.

BASELINE.md's "N>=2 hosts" row, validated without a cluster: two actual
OS processes join through ``jax.distributed.initialize`` (localhost
coordinator, gloo CPU collectives), build one global mesh, and run the SPMD
sharded MSM (``run_msm_multihost``). The cross-process window-sum merge uses
the same all_gather + point-add tree a cluster run uses; process-spanning
collectives exercise the exact ``jax.distributed`` glue (coordinator
handshake, global device enumeration, multi-process ``make_array_from_callback``
input sharding) that a real multi-host run depends on.

The reference has no analogue (single-device library, SURVEY §2.5)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from msm_tpu.oracle import best_msm
from msm_tpu.oracle.pyecc import Curve
from msm_tpu.params import BN254

CV = Curve(BN254)
WORKER = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_multihost_two_processes():
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers pin their own device counts
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
            cwd=os.path.dirname(os.path.dirname(WORKER)),
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)

    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("MULTIHOST_RESULT"):
                _, pid, x, y = line.split()
                results[int(pid)] = (int(x), int(y))
    assert set(results) == {0, 1}, f"missing results: {outs}"
    # both processes must hold the SAME replicated result
    assert results[0] == results[1]

    # and it must match the oracle on the same deterministic inputs
    base = [CV.to_affine(p) for p in CV.sample_points(32, seed=5)]
    pts = [base[i % len(base)] for i in range(512)]
    rng = np.random.default_rng(6)
    ks = [
        int.from_bytes(rng.bytes(32), "little") % BN254.order
        for _ in range(512)
    ]
    want = CV.to_affine(best_msm(pts, ks))
    assert results[0] == want
