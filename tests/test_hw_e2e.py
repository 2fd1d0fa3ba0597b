"""Per-size GPU end-to-end gates vs the C++ oracle.

Mirrors the reference's committed per-scale e2e tests —
``tests/test_webgpu_msm_cuzk_16.rs:9-12`` .. ``_20.rs`` (fixed scales
2^16..2^20) and ``tests/test_webgpu_msm_cuzk_random.rs:11-15`` (random
n in [2^16, 2^20)) — so the production-scale claim is reproducible from
the committed suite, not just from manually-run scripts.

These run the REAL production configs (pick_config: chunk 13/14/16) on a
GPU; the CPU backend takes tens of minutes per size at these scales, so
they carry the ``gpu`` marker and skip without one. Run them on a GPU
machine with:

    python -m pytest tests/test_hw_e2e.py -m gpu -q
"""

import numpy as np
import pytest

from msm_tpu.models.cuzk import compute_msm_jpoint
from msm_tpu.oracle import best_msm
from msm_tpu.oracle.pyecc import Curve
from msm_tpu.params import BN254

pytestmark = pytest.mark.gpu

CV = Curve(BN254)


def _inputs(n: int, seed: int):
    """1024 distinct curve points tiled to n (duplicates exercise the
    bucket doubling paths; MSM cost and the oracle check are unaffected)
    + uniform random scalars — the committed-scale analogue of the
    reference's sample_points/sample_scalars (lib.rs:20-42)."""
    base = [CV.to_affine(p) for p in CV.sample_points(min(n, 1024), seed=seed)]
    pts = [base[i % len(base)] for i in range(n)]
    rng = np.random.default_rng(seed + 1)
    ks = [
        int.from_bytes(rng.bytes(32), "little") % BN254.order
        for _ in range(n)
    ]
    return pts, ks


@pytest.mark.parametrize("log_n", [16, 18, 20])
def test_cuzk_msm_hw_fixed_scale(log_n):
    n = 1 << log_n
    pts, ks = _inputs(n, seed=100 + log_n)
    got = compute_msm_jpoint(pts, ks)  # production pick_config(n)
    want = best_msm(pts, ks)
    assert CV.eq(got, want), f"2^{log_n} MSM mismatch vs oracle"


def test_subgroup_validate_hw_2e18_bls12_381():
    """validate=True is a REAL contract at production scale: 2^18
    BLS12-381 points subgroup-checked on the device ladder, with an
    out-of-subgroup needle rejected at its index."""
    import time

    from msm_tpu.models.common import validate_inputs
    from msm_tpu.params import BLS12_381, MsmConfig

    q, b = BLS12_381.modulus, BLS12_381.b
    cv381 = Curve(BLS12_381)
    n = 1 << 18
    base = [cv381.to_affine(p) for p in cv381.sample_points(1024, seed=3)]
    pts = [base[i % 1024] for i in range(n)]
    cfg = MsmConfig(curve=BLS12_381, chunk_size=14)
    t0 = time.time()
    validate_inputs(pts, [1] * n, cfg)  # all in-subgroup: passes
    dt = time.time() - t0
    print(f"[gpu] 2^18 BLS12-381 subgroup validate: {dt:.1f}s")
    assert dt < 120, f"device subgroup check too slow: {dt:.1f}s"
    # needle: smallest-x on-curve point (out of subgroup w.p. 1 - 2^-126)
    pt = None
    for x in range(2, 64):
        y2 = (x * x * x + b) % q
        y = pow(y2, (q + 1) // 4, q)
        if y * y % q == y2:
            pt = (x, y)
            break
    bad = list(pts)
    bad[12345] = pt
    with pytest.raises(ValueError, match="point 12345 is outside"):
        validate_inputs(bad, [1] * n, cfg)


def test_cuzk_msm_hw_random_scale():
    """Random n in [2^16, 2^20) — reference _random.rs:11-15. Fresh entropy
    per run (as in the reference); the failing n is in the assert."""
    n = int(np.random.default_rng().integers(1 << 16, 1 << 20))
    pts, ks = _inputs(n, seed=7)
    got = compute_msm_jpoint(pts, ks)
    want = best_msm(pts, ks)
    assert CV.eq(got, want), f"random n={n} MSM mismatch vs oracle"
